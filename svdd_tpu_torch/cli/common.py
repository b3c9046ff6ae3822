"""Shared decode-CLI scaffold (``svdd_tpu/cli/common.py``): the same
flag surface, plus ``--device``, the model builders and the run tail
that writes the npz and one JSONL metrics row.

Checkpoint loading is not ported yet: every checkpoint flag raises
``NotImplementedError``, and the models take random weights drawn from
``--seed`` (diffusion), seed 1 (value net) and the synthetic motif
oracle, as the JAX CLI does without checkpoint flags.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from svdd_tpu_torch import rewards, value as value_lib
from svdd_tpu_torch.config import Config, dna_config
from svdd_tpu_torch.diffusion import Diffusion

LOGGER = logging.getLogger(__name__)

CHECKPOINT_FLAGS = ('load_checkpoint_path', 'pre_model_path',
                    'diffusion_checkpoint_path', 'reward_checkpoint_path',
                    'saluki_body_path', 'saluki_body')


def make_parser(description: str) -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=description)
  p.add_argument('--run_name', type=str, required=False)
  p.add_argument('--debug', action='store_true', default=False)
  p.add_argument('--task', type=str, default='dna',
                 help='dna (rna / rna_saluki are not ported yet)')
  p.add_argument('--saluki_body', type=int, default=0)
  p.add_argument('--saluki_body_path', type=str, default=None)
  p.add_argument('--saluki_final_length', type=int, default=12288)
  p.add_argument('--n_task', type=int, default=1)
  p.add_argument('--model', type=str, default='enformer',
                 help='enformer (the other value models are not ported)')
  p.add_argument('--batch_size', type=int, default=256)
  p.add_argument('--sample_M', type=int, default=5)
  p.add_argument('--val_batch_num', type=int, default=1)
  p.add_argument('--seed', type=int, default=44)
  p.add_argument('--reward_name', type=str, default='HepG2')
  p.add_argument('--load_checkpoint_path', type=str, default=None)
  p.add_argument('--pre_model_path', type=str, default=None)
  p.add_argument('--cdq', action='store_true', default=False)
  p.add_argument('--dist', action='store_true', default=False)
  p.add_argument('--diffusion_checkpoint_path', type=str, default=None)
  p.add_argument('--reward_checkpoint_path', type=str, default=None)
  p.add_argument('--num_steps', type=int, default=None,
                 help='override sampling steps')
  p.add_argument('--length', type=int, default=None,
                 help='override sequence length')
  p.add_argument('--out_dir', type=str, default='./log')
  p.add_argument('--skip_best_of_n', action='store_true', default=False)
  p.add_argument('--device', type=str, default='cuda',
                 help="torch device of the run ('cuda' or 'cpu')")
  return p


def add_guidance_scale(parser: argparse.ArgumentParser,
                       default: float) -> None:
  """``--guidance_scale``, with the JAX CLI's default for the decoder."""
  parser.add_argument('--guidance_scale', type=float, default=default)


def full_f32() -> None:
  """Float32 runs compute in full f32: TF32 off for matmuls and cuDNN
  convolutions."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def reject_saluki(args, cli_name: str) -> None:
  """The gradient-guided decoders take (N, L, 4) one-hots; only the
  tweedie path builds the saluki oracle's input
  (``svdd_tpu/cli/common.py:reject_saluki``)."""
  if args.task == 'rna_saluki':
    raise SystemExit(
        f'{cli_name} does not support --task rna_saluki; use '
        'decode.py (SVDD-MC) or decode_tweedie.py (SVDD-PM)')


def reject_unported(args) -> None:
  """Raise for flags whose machinery is not ported yet."""
  for name in CHECKPOINT_FLAGS:
    if getattr(args, name, None):
      raise NotImplementedError(
          f'--{name}: checkpoint loading is not ported to svdd_tpu_torch '
          'yet; run without it for random weights')
  if args.task != 'dna':
    raise NotImplementedError(f'--task {args.task}: only dna is ported')
  if args.dist:
    raise NotImplementedError('--dist: the parallel paths are not ported')


def task_config(args) -> Config:
  cfg = dna_config()
  if args.length:
    cfg.model.length = args.length
  if args.num_steps:
    cfg.sampling.steps = args.num_steps
  cfg.loader.eval_batch_size = args.batch_size
  return cfg


def load_diffusion(args, cfg: Config) -> Diffusion:
  LOGGER.warning('no --diffusion_checkpoint_path: using randomly '
                 'initialized diffusion model')
  return Diffusion(cfg, device=args.device)


def load_reward_fn(args, cfg: Config):
  LOGGER.warning('no --reward_checkpoint_path: using synthetic motif '
                 'oracle')
  return rewards.synthetic_motif_oracle(cfg.model.length)


def load_value_function(args, cfg: Config,
                        **module_kwargs) -> value_lib.ValueFunction:
  LOGGER.warning('no --load_checkpoint_path: value net is randomly '
                 'initialized')
  gen = torch.Generator(torch.device(args.device)).manual_seed(1)
  return value_lib.ValueFunction.create(
      args.task, cfg.model.length, gen, model=args.model,
      n_tasks=args.n_task, **module_kwargs)


def npz_path(args, suffix: str = '') -> str:
  """'./log/{task}-{reward}{suffix}.npz'."""
  return os.path.join(args.out_dir,
                      f'{args.task}-{args.reward_name}{suffix}.npz')


def quantile_report(rewards_by_algo, quantiles=(0.5, 0.8, 0.9)) -> dict:
  """q50/q80/q90, mean and n of each reward array."""
  report = {}
  for name, r in rewards_by_algo.items():
    r = np.asarray(r).reshape(-1)
    report[name] = {f'q{int(q * 100)}': float(np.quantile(r, q))
                    for q in quantiles}
    report[name]['mean'] = float(r.mean())
    report[name]['n'] = int(r.size)
  return report


def finish_run(args, result, suffix: str = '',
               extra_metrics: Optional[dict] = None) -> dict:
  """Write the npz, then log the quantile report and append one row to
  ``{out_dir}/{run_name}.metrics.jsonl``."""
  path = npz_path(args, suffix)
  result.save_npz(path)
  LOGGER.info('wrote %s', path)
  report = quantile_report({'decoding': result.reward_preds,
                            'baseline': result.baseline_preds,
                            'best_of_n': result.top_k})
  for name, row in report.items():
    LOGGER.info('%s: %s', name, row)
  run_name = args.run_name or f'{args.task}-{args.reward_name}{suffix}'
  row = {'_time': time.time(), 'npz': path,
         'n': int(len(result.reward_preds)),
         'batch_size': args.batch_size, 'sample_M': args.sample_M,
         'seed': args.seed}
  for name, stats in report.items():
    for q, v in stats.items():
      row[f'{name}/{q}'] = float(v)
  row.update(extra_metrics or {})
  os.makedirs(args.out_dir, exist_ok=True)
  with open(os.path.join(args.out_dir, f'{run_name}.metrics.jsonl'),
            'a') as fh:
    fh.write(json.dumps(row) + '\n')
  return report
