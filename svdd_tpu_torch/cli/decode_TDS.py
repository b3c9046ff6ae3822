"""TDS (sequential Monte Carlo) decode CLI (``svdd_tpu/cli/decode_TDS.py``).

  python -m svdd_tpu_torch.cli.decode_TDS --task dna --device cuda

Adds ``--alpha`` (the importance weights' temperature, default 0.5) and
``--ess_threshold`` (adaptive resampling, off by default); writes
``{out_dir}/{task}-{reward}_TDS.npz`` with the keys 'decoding' and
'baseline' plus a metrics JSONL row holding the ESS summary (min,
median, final) and the per-step ESS trace. rna_saluki is rejected.
"""

from __future__ import annotations

import logging
import time

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.decode import run_decode

NPZ_SUFFIX = '_TDS'


def run(args, cfg=None) -> dict:
  """Run one TDS decode. ``cfg`` replaces the full-size DNA config, for
  tests and probes. Returns the quantile report."""
  common.reject_saluki(args, f'decode{NPZ_SUFFIX}')
  common.reject_unported(args)
  common.full_f32()
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn, algo='tds',
      gen_batch_num=args.val_batch_num, batch_size=args.batch_size,
      sample_M=args.sample_M, alpha=args.alpha, seed=args.seed,
      skip_best_of_n=args.skip_best_of_n,
      ess_threshold=args.ess_threshold)
  extra = {'algo': 'tds', 'alpha': args.alpha,
           'ess_threshold': args.ess_threshold, 'device': args.device,
           'wall_s': time.perf_counter() - t0,
           **common.compute_dtypes(diffusion)}
  if result.diagnostics:
    extra.update({k: v for k, v in result.diagnostics.items()
                  if not hasattr(v, 'ndim')})
    extra['ess_trace'] = [round(float(v), 2)
                          for v in result.diagnostics['ess'].mean(0)]
  return common.finish_run(args, result, NPZ_SUFFIX, extra_metrics=extra)


def parser(description: str = 'TDS twisted-SMC decoding'):
  p = common.make_parser(description)
  p.add_argument('--alpha', type=float, default=0.5,
                 help='importance-weight temperature')
  p.add_argument('--ess_threshold', type=float, default=None,
                 help='adaptive resampling: accumulate particle weights '
                      'and resample only when ESS <= threshold*B (and on '
                      'the last step); default: resample every step')
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
