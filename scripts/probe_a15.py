#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11 (the analysis and supporting modules
on the full-width DNA oracle) alone on one CUDA card, after its kernel
points at the analysis rows.

  python3 scripts/probe_a15.py              # build, the points, phase 11
  python3 scripts/probe_a15.py --no-points  # build, phase 11

Phase 11's report reads the npz of a short SVDD-MC decode (B=512, M=10,
8 steps) this script runs first, in place of phase 4's. Prints the
smoke's JSON lines, the launch counts of phase 11's runs and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

DECODE_STEPS = 8


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--no-points', action='store_true',
                 help='skip the kernel points at the analysis rows')
  args = p.parse_args()
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_a15: no CUDA device')
  from svdd_tpu_torch import _build
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = chip_smoke.nvidia_smi()
  chip_smoke.emit({'phase': 'device', 'nvidia_smi': smi,
                   'nvcc_build_s': _build.build()})
  if not args.no_points:
    gen = torch.Generator('cuda').manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
      dname = str(dtype).split('.')[-1]
      for key, points in chip_smoke.check_analysis_rows(dtype, gen).items():
        chip_smoke.emit({'phase': 'kernel_analysis_rows', 'kernel': key,
                         'dtype': dname, 'points': points})
  decode = chip_smoke.run_decode('svdd_mc', steps=DECODE_STEPS)
  chip_smoke.emit({'phase': 'decode', **decode})
  runs = chip_smoke.a15_phase([os.path.join(
      REPO, 'build', 'chip_smoke', 'svdd_mc', decode['npz'])])
  chip_smoke.emit({'phase': 'a15_launches', 'runs': runs})
  print(smi, flush=True)


if __name__ == '__main__':
  main()
