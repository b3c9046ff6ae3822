"""Classifier-guidance decode CLI (``svdd_tpu/cli/decode_classfier.py``,
the file name's typo kept for script parity).

  python -m svdd_tpu_torch.cli.decode_classfier --task dna --device cuda

Adds --guidance_scale (default 1.0); writes
``{out_dir}/{task}-{reward}-classfier.npz`` with the keys 'decoding' and
'baseline' plus a metrics JSONL row. Each step takes the gradient of the
value net with respect to the one-hot of x_t through its differentiable
tower (the conv and pool backward kernels). rna_saluki is rejected.
"""

from __future__ import annotations

import logging
import time

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.decode import run_decode

NPZ_SUFFIX = '-classfier'


def run(args, cfg=None, value_kwargs=None) -> dict:
  """Run one classifier-guided decode. ``cfg`` and ``value_kwargs``
  (EnformerValueModel arguments) replace the full-size DNA models, for
  tests and probes. Returns the quantile report."""
  common.reject_saluki(args, 'decode_classfier')
  common.reject_unported(args)
  common.full_f32()
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)
  vf = common.load_value_function(args, cfg, **(value_kwargs or {}))

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn, algo='classifier', value_fn=vf.as_onehot_fn(),
      gen_batch_num=args.val_batch_num, batch_size=args.batch_size,
      sample_M=args.sample_M, guidance_scale=args.guidance_scale,
      seed=args.seed, skip_best_of_n=args.skip_best_of_n)
  return common.finish_run(args, result, NPZ_SUFFIX, extra_metrics={
      'algo': 'classifier', 'guidance_scale': args.guidance_scale,
      'device': args.device, 'wall_s': time.perf_counter() - t0})


def parser():
  p = common.make_parser('classifier-guidance decoding')
  common.add_guidance_scale(p, 1.0)
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
