#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 12 (the parallel paths at world 1 under
NCCL) alone on one CUDA card.

  python3 scripts/probe_parallel.py

Builds the kernels, checks B2's row0 (``check_gumbel_row0``), writes
stand-ins for the files phase 12 reads at full width (a pretraining
checkpoint of the random denoiser and a random 3-task Enformer oracle,
in the port's formats, where phases 5 and 6 leave theirs, and phase 6's
empty data directory), then runs ``chip_smoke.parallel_phase``: the
torchrun worker's DP and FSDP pretraining, ``cli.train --dist`` and
``--dist --fsdp``, SVDD-MC on a 1 x 1 grid with and without the
tensor-parallel value net, each against its twin without a process
group bit for bit, then the A16.3 runs (the pipelined DiT step at M = 4
and V = 2 against the plain step, ``sp_mha`` against ``mha``). Before
phase 12 it runs the smoke's B13 and B11c checks in f32 and bf16 (B13's
L2-flushed time at the training rows, B11c's spread). One JSON line a
part, then the card's nvidia-smi name and power limit. Needs a CUDA card and nvcc; any failed check
raises.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  sys.path.insert(0, REPO)
  import chip_smoke as smoke
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_parallel: no CUDA device')
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
  gen = torch.Generator('cuda').manual_seed(0)
  smoke.emit({'phase': 'kernel_row0', 'kernel': 'gumbel_candidates',
              **smoke.check_gumbel_row0(gen)})
  for name, check in (('rmsnorm', smoke.check_rmsnorm),
                      ('nacdr_im2col', smoke.check_nacdr_im2col)):
    for dtype in (torch.float32, torch.bfloat16):
      r = check(dtype, gen)
      dname = str(dtype).split('.')[-1]
      r['bound_ms'], r['bound_by'] = smoke.bound(r['flops'], r['bytes'],
                                                 dname)
      smoke.emit({'phase': 'kernel', 'kernel': name, 'dtype': dname, **r})
  smoke._no_data_dir()
  cfg = dna_config()
  ckpt = os.path.join(smoke._train_dir('probe_denoiser'), 'ckpt')
  train_diff.save_checkpoint(ckpt, train_diff.init_state(
      Diffusion(cfg, device='cuda'), cfg))
  model = EnformerValueModel(
      n_tasks=3, generator=torch.Generator('cuda').manual_seed(2))
  value_lib.save_checkpoint(os.path.join(smoke._value_dir('value'),
                                         'train_oracle.pt'), model)
  del model
  torch.cuda.empty_cache()
  runs = smoke.parallel_phase(ckpt)
  smoke.emit({'phase': 'launches', **{k: {n: c for n, c in v['launches']
                                         .items() if c}
                                     for k, v in runs.items()}})
  print(smi, flush=True)


if __name__ == '__main__':
  main()
