"""DPS (gradient guidance) decode CLI (``svdd_tpu/cli/decode_DPS.py``).

  python -m svdd_tpu_torch.cli.decode_DPS --task dna --device cuda

Adds --guidance_scale (default 1e5); writes
``{out_dir}/{task}-{reward}_DPS.npz`` with the keys 'decoding' and
'baseline' plus a metrics JSONL row. Each step takes the gradient of the
reward of the denoiser's softmax with respect to the one-hot input,
through the denoiser layers' backward kernel. rna_saluki is rejected.
"""

from __future__ import annotations

import logging
import time

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.decode import run_decode

NPZ_SUFFIX = '_DPS'


def run(args, cfg=None) -> dict:
  """Run one DPS decode. ``cfg`` replaces the full-size DNA config, for
  tests and probes. Returns the quantile report."""
  common.reject_saluki(args, f'decode{NPZ_SUFFIX}')
  common.reject_unported(args)
  common.full_f32()
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn, algo='dps',
      gen_batch_num=args.val_batch_num, batch_size=args.batch_size,
      sample_M=args.sample_M, guidance_scale=args.guidance_scale,
      seed=args.seed, skip_best_of_n=args.skip_best_of_n)
  return common.finish_run(args, result, NPZ_SUFFIX, extra_metrics={
      'algo': 'dps', 'guidance_scale': args.guidance_scale,
      'device': args.device, 'wall_s': time.perf_counter() - t0})


def parser(description: str = 'DPS gradient-guided decoding'):
  p = common.make_parser(description)
  common.add_guidance_scale(p, 1e5)
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
