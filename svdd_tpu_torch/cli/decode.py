"""SVDD-MC decode CLI (``svdd_tpu/cli/decode.py``).

  python -m svdd_tpu_torch.cli.decode --task dna --device cuda

Writes ``{out_dir}/{task}-{reward}.npz`` with the keys 'decoding' and
'baseline' and appends a metrics row to
``{out_dir}/{run_name}.metrics.jsonl``, which records the nets'
compute dtypes. The denoiser computes in bf16 under SVDD_CNN_BF16=1 and
the value net under SVDD_VALUE_BF16=1, as in svdd_tpu; otherwise in
f32, with TF32 off for both matmuls and cuDNN convolutions.
``--m_schedule "64:4,64:10"`` decodes with scheduled M: 4 candidates a
step for the first 64 steps, 10 for the last 64 (the phase lengths must
sum to the step count); the row records the parsed phases. ``--task
rna_saluki`` scores the guided and baseline samples by the saluki
oracle (``common.load_reward_fn``) on the saluki input, with
``--saluki_body_path`` or ``--saluki_body`` behind each sequence.
"""

from __future__ import annotations

import logging
import time

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.decode import run_decode
from svdd_tpu_torch.utils import parse_m_schedule


def run(args, cfg=None, value_kwargs=None) -> dict:
  """Run one decode. ``cfg`` and ``value_kwargs`` (EnformerValueModel
  arguments) replace the full-size DNA models, for tests and probes.
  Returns the quantile report."""
  common.reject_unported(args)
  m_schedule = parse_m_schedule(getattr(args, 'm_schedule', None))
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
      skip_best_of_n=args.skip_best_of_n, m_schedule=m_schedule,
      task=cfg.task, **common.saluki_kwargs(args))
  return common.finish_run(args, result, extra_metrics={
      'algo': 'svdd_mc', 'm_schedule': m_schedule, 'device': args.device,
      'wall_s': time.perf_counter() - t0,
      **common.compute_dtypes(diffusion, vf)})


def parser(description: str = 'SVDD-MC reward-guided decoding'):
  p = common.make_parser(description)
  p.add_argument('--m_schedule', type=str, default=None,
                 help='scheduled-M decode: comma-separated steps:M phases '
                      'covering the trajectory, e.g. "64:4,64:10" (4 '
                      'candidates for the first 64 steps, 10 for the last '
                      '64). Overrides --sample_M')
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
