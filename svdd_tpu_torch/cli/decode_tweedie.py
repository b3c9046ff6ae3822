"""SVDD-PM (Tweedie) decode CLI (``svdd_tpu/cli/decode_tweedie.py``).

  python -m svdd_tpu_torch.cli.decode_tweedie --task dna --device cuda

Scores each step's M candidates by the reward oracle on their posterior
mean (``--tweedie True``, the default) or with their masked positions
zeroed (any other value). ``--m_schedule "96:10,32:4"`` decodes with
scheduled M. Writes ``{out_dir}/{task}-{reward}_tw.npz`` with the keys
'decoding' and 'baseline' plus a metrics JSONL row with the compute
dtypes and the parsed schedule. ``--task rna_saluki`` scores every
step's candidates by the saluki oracle on the saluki input
(``guidance.svdd_pm_step``).
"""

from __future__ import annotations

import logging
import time

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.decode import run_decode
from svdd_tpu_torch.utils import parse_m_schedule

NPZ_SUFFIX = '_tw'


def run(args, cfg=None) -> dict:
  """Run one SVDD-PM decode. ``cfg`` replaces the full-size DNA config,
  for tests and probes. Returns the quantile report."""
  common.reject_unported(args)
  m_schedule = parse_m_schedule(args.m_schedule)
  common.full_f32()
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)

  t0 = time.perf_counter()
  result = run_decode(
      diffusion, reward_fn, algo='svdd_pm',
      gen_batch_num=args.val_batch_num, batch_size=args.batch_size,
      sample_M=args.sample_M, tweedie=str(args.tweedie) == 'True',
      seed=args.seed, skip_best_of_n=args.skip_best_of_n,
      m_schedule=m_schedule, task=cfg.task, **common.saluki_kwargs(args))
  return common.finish_run(args, result, NPZ_SUFFIX, extra_metrics={
      'algo': 'svdd_pm', 'tweedie': str(args.tweedie),
      'm_schedule': m_schedule,
      'device': args.device, 'wall_s': time.perf_counter() - t0,
      **common.compute_dtypes(diffusion)})


def parser(description: str = 'SVDD-PM (Tweedie) decoding'):
  p = common.make_parser(description)
  p.add_argument('--tweedie', type=str, default='True',
                 help="'True': the posterior mean; anything else: the "
                      'mask-to-zero heuristic')
  p.add_argument('--m_schedule', type=str, default=None,
                 help='scheduled-M phases "96:10,32:4" (see decode '
                      '--m_schedule; here both the candidate denoiser and '
                      'reward forwards scale with M)')
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
