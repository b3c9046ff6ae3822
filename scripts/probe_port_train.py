#!/usr/bin/env python3
"""The smoke's diffusion-pretraining phase alone, on one card.

  python3 scripts/probe_port_train.py [--no-profile]

Builds the kernels, then runs ``chip_smoke.py``'s phase 5 (the two
full-width ``main_gosai --mode train`` runs at global batch 512 in two
microbatches, f32 and bf16, with their launch counts; resume on the card;
``ppl_eval`` and ``sample_eval`` from the f32 run's checkpoint; one
training step on 8 rows against the CPU, f32 and bf16) and, unless
``--no-profile``, its traced training steps. One JSON line per part,
then the card's nvidia-smi name and power limit. Needs a CUDA card and
nvcc; any failed check raises.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--no-profile', action='store_true')
  args = ap.parse_args()
  sys.path.insert(0, REPO)
  import chip_smoke as smoke
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_port_train: no CUDA device')
  from svdd_tpu_torch import _build
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = smoke.nvidia_smi()
  smoke.emit({'phase': 'build', 'nvcc_build_s': _build.build()})
  runs, _ = smoke.train_phase()
  smoke.emit({'phase': 'launches', **{k: v['launches'] for k, v in
                                      runs.items()}})
  if not args.no_profile:
    smoke.train_profiles()
  print(smi, flush=True)


if __name__ == '__main__':
  main()
