#!/usr/bin/env python3
"""The smoke's value-net and oracle training alone, on one card.

  python3 scripts/probe_value_train.py [--random-denoiser] [--no-kernels]
      [--steps-only]

Builds the kernels; unless ``--no-kernels``, holds B7 and B8 against
their plain versions at the value-net trainers' rows (``chip_smoke.py``'s
``conv1d_bwd`` and ``attn_pool_bwd`` kernel checks, f32 and bf16); then
a pretraining checkpoint of the full-width denoiser (the smoke's f32
``main_gosai --mode train`` run, or with ``--random-denoiser`` its random
initial weights saved as one), and ``chip_smoke.value_phase`` on it: the
oracle trainer, ``cli.train`` MC (f32, bf16) and CD-Q, ``cli.eval``,
determinism and resume, the 8-row step against the CPU and the traced
steps (``--steps-only``: the oracle, then the last two alone). One JSON
line per part, then the launches of its runs and the
card's nvidia-smi name and power limit. Needs a CUDA card and nvcc; any
failed check raises.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--random-denoiser', action='store_true')
  ap.add_argument('--no-kernels', action='store_true')
  ap.add_argument('--steps-only', action='store_true')
  args = ap.parse_args()
  sys.path.insert(0, REPO)
  import chip_smoke as smoke
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_value_train: no CUDA device')
  from svdd_tpu_torch import _build
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = smoke.nvidia_smi()
  smoke.emit({'phase': 'build', 'nvcc_build_s': _build.build()})
  if not args.no_kernels:
    gen = torch.Generator('cuda').manual_seed(0)
    for name, check in (('conv1d_bwd', smoke.check_conv1d_bwd),
                        ('attn_pool_bwd', smoke.check_attn_pool_bwd)):
      for dtype in (torch.float32, torch.bfloat16):
        r = check(dtype, gen)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        smoke.emit({'phase': 'kernel', 'kernel': name,
                    'dtype': str(dtype).split('.')[-1],
                    'train_rows': r['train_rows']})
  if args.random_denoiser:
    from svdd_tpu_torch.config import dna_config
    from svdd_tpu_torch.diffusion import Diffusion
    from svdd_tpu_torch.train import diffusion as train_diff
    cfg = dna_config()
    ckpt = os.path.join(smoke._train_dir('probe_denoiser'), 'ckpt')
    train_diff.save_checkpoint(ckpt, train_diff.init_state(
        Diffusion(cfg, device='cuda'), cfg))
  else:
    r = smoke.run_train(False)
    smoke.emit({'phase': 'train', **r})
    ckpt = r['ckpt_dir']
  if args.steps_only:
    oracle = smoke.run_train_oracle(smoke._value_dir('value'), False)['path']
    ref = None
    for _ in range(2):
      r, ref = smoke.check_value_step(ref)
      smoke.emit({'phase': 'value_step_vs_cpu', **r})
    for prof in smoke.profile_value_steps(ckpt, oracle):
      smoke.emit({'phase': 'profile', **prof})
    print(smi, flush=True)
    return
  runs = smoke.value_phase(ckpt)
  smoke.emit({'phase': 'launches', **{k: v['launches'] for k, v in
                                      runs.items()}})
  print(smi, flush=True)


if __name__ == '__main__':
  main()
