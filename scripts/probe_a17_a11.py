#!/usr/bin/env python3
"""The smoke's phase 8 alone, on one card: the reference's checkpoints
and the timed and multisep value models.

  python3 scripts/probe_a17_a11.py [--checks] [--fault-b3 SCALE]

Builds the kernels, writes stand-ins for phase 5's files at full width
(a pretraining checkpoint of the random denoiser, a random 3-task
Enformer oracle and a random value net, in the port's formats, where
phase 8 reads them), then runs ``chip_smoke.a17_a11_phase`` on them:
the reference-layout files read back and decoded from, the timed value
net card vs CPU and its decode, ``cli.train --model multienformer``
twice from one seed, the 2-trunk multisep step card vs CPU. One JSON
line per part, then the card's nvidia-smi name and power limit. Needs a
CUDA card and nvcc; any failed check raises.

``--checks`` runs only the two card-vs-CPU gradient checks (the timed
net, the 2-trunk multisep step; no files). ``--fault-b3 SCALE`` then
runs them once more with B3's backward (the gradient of its reference
form) scaled by SCALE on the card, read with no tolerance: each line
gives the distances the fault leaves and ``passes_grad_tol``, whether
the smoke's GRAD_TOL would let them through.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _ScaleGrad:
  """Identity forward, the gradient scaled (built at first use: torch is
  imported inside main)."""
  fn = None

  @classmethod
  def apply(cls, t, scale: float):
    import torch
    if cls.fn is None:
      class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, s):
          ctx.s = s
          return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
          return g * ctx.s, None
      cls.fn = Fn
    return cls.fn.apply(t, scale)


def faulted_checks(smoke, scale: float) -> None:
  """The two gradient checks with B3's backward scaled by ``scale``."""
  from svdd_tpu_torch.ops import attn_pool as K
  orig = K.pool_prologue_im2col_wlogits_reference
  K.pool_prologue_im2col_wlogits_reference = (
      lambda *a, **k: _ScaleGrad.apply(orig(*a, **k), scale))
  try:
    for name, check, worst in (
        ('timed_model', smoke.check_timed_model,
         'max_weight_grad_rel_norm_err'),
        ('multisep_step_vs_cpu', smoke.check_multisep_step,
         'max_grad_rel_norm_err')):
      r = check(tol=math.inf)
      smoke.emit({'phase': f'{name}_fault_b3', 'scale': scale,
                  'passes_grad_tol': r[worst] <= smoke.GRAD_TOL,
                  **{k: v for k, v in r.items()
                     if k not in ('value_card', 'value_cpu')}})
  finally:
    K.pool_prologue_im2col_wlogits_reference = orig


def main() -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument('--checks', action='store_true')
  ap.add_argument('--fault-b3', type=float, default=None)
  args = ap.parse_args()
  sys.path.insert(0, REPO)
  import chip_smoke as smoke
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_a17_a11: no CUDA device')
  from svdd_tpu_torch import _build
  from svdd_tpu_torch import value as value_lib
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  from svdd_tpu_torch.train import diffusion as train_diff
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = smoke.nvidia_smi()
  smoke.emit({'phase': 'build', 'nvcc_build_s': _build.build()})
  if args.checks:
    smoke.emit({'phase': 'timed_model', **smoke.check_timed_model()})
    smoke.emit({'phase': 'multisep_step_vs_cpu',
                **smoke.check_multisep_step()})
    if args.fault_b3 is not None:
      faulted_checks(smoke, args.fault_b3)
    print(smi, flush=True)
    return
  cfg = dna_config()
  ckpt = os.path.join(smoke._train_dir('probe_denoiser'), 'ckpt')
  train_diff.save_checkpoint(ckpt, train_diff.init_state(
      Diffusion(cfg, device='cuda'), cfg))
  value_dir = smoke._value_dir('value')
  for name, n_tasks, seed in (('train_oracle', 3, 2), ('value_mc', 1, 3)):
    model = EnformerValueModel(
        n_tasks=n_tasks, generator=torch.Generator('cuda').manual_seed(seed))
    value_lib.save_checkpoint(os.path.join(value_dir, f'{name}.pt'), model)
    del model
  runs = smoke.a17_a11_phase(ckpt)
  smoke.emit({'phase': 'launches', **{k: {n: c for n, c in v['launches']
                                         .items() if c}
                                     for k, v in runs.items()}})
  if args.fault_b3 is not None:
    faulted_checks(smoke, args.fault_b3)
  print(smi, flush=True)


if __name__ == '__main__':
  main()
