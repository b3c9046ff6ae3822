"""SVDD-MC decode CLI (``svdd_tpu/cli/decode.py``).

  python -m svdd_tpu_torch.cli.decode --task dna --device cuda

Writes ``{out_dir}/{task}-{reward}.npz`` with the keys 'decoding' and
'baseline' and appends a metrics row to
``{out_dir}/{run_name}.metrics.jsonl``. Float32 runs turn TF32 off for
both matmuls and cuDNN convolutions, so both nets compute in full f32.
"""

from __future__ import annotations

import logging
import time

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.decode import run_decode


def run(args, cfg=None, value_kwargs=None) -> dict:
  """Run one decode. ``cfg`` and ``value_kwargs`` (EnformerValueModel
  arguments) replace the full-size DNA models, for tests and probes.
  Returns the quantile report."""
  common.reject_unported(args)
  if getattr(args, 'm_schedule', None):
    raise NotImplementedError('--m_schedule: scheduled-M decode is not '
                              'ported yet')
  common.full_f32()
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)
  vf = common.load_value_function(args, cfg, **(value_kwargs or {}))

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn, algo='svdd_mc', value_fn=vf.score_tokens,
      gen_batch_num=args.val_batch_num, batch_size=args.batch_size,
      sample_M=args.sample_M, seed=args.seed,
      skip_best_of_n=args.skip_best_of_n)
  return common.finish_run(args, result, extra_metrics={
      'algo': 'svdd_mc', 'm_schedule': None, 'device': args.device,
      'wall_s': time.perf_counter() - t0})


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  parser = common.make_parser('SVDD-MC reward-guided decoding')
  parser.add_argument('--m_schedule', type=str, default=None,
                      help='scheduled-M decode (not ported yet)')
  run(parser.parse_args())


if __name__ == '__main__':
  main()
