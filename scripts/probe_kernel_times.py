#!/usr/bin/env python3
"""The smoke's kernel checks for a few kernels, alone, on one card.

  python3 scripts/probe_kernel_times.py [--sass] KERNEL ...

Runs ``chip_smoke.py``'s kernel-phase checks of the named kernels
(names of ``chip_smoke.kernel_checks()``, and ``gumbel_candidates``),
each in float32 and bfloat16 (B2 in float32): every check holds the
kernel against its plain version with the smoke's tolerances and times
kernel, plain version and library call by the card's own time for a
call (the profiler), CUDA-event medians beside. ``--sass`` also prints
the smoke's cuobjdump counts (tensor-core mma instructions, registers)
of the build. One JSON line per check, then the card's nvidia-smi name
and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('kernels', nargs='+')
  ap.add_argument('--sass', action='store_true')
  args = ap.parse_args()
  sys.path.insert(0, REPO)
  import chip_smoke as smoke
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_kernel_times: no CUDA device')
  from svdd_tpu_torch import _build
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  checks = dict(smoke.kernel_checks())
  checks['gumbel_candidates'] = lambda dt, g: smoke.check_gumbel_candidates(g)
  unknown = [k for k in args.kernels if k not in checks]
  if unknown:
    raise SystemExit(f'probe_kernel_times: no check named {unknown}')
  smi = smoke.nvidia_smi()
  smoke.emit({'phase': 'build', 'nvcc_build_s': _build.build()})
  if args.sass:
    smoke.emit({'phase': 'sass', **smoke.sass_counts()})
  gen = torch.Generator('cuda').manual_seed(0)
  for name in args.kernels:
    dtypes = ((torch.float32,) if name == 'gumbel_candidates'
              else (torch.float32, torch.bfloat16))
    for dtype in dtypes:
      t0 = time.perf_counter()
      r = checks[name](dtype, gen)
      torch.cuda.synchronize()
      torch.cuda.empty_cache()
      dname = str(dtype).split('.')[-1]
      if 'bound_ms' not in r:
        r['bound_ms'], r['bound_by'] = smoke.bound(r['flops'], r['bytes'],
                                                   dname)
      r['bound_share'] = r['bound_ms'] / r['ms']
      smoke.emit({'phase': 'kernel', 'kernel': name,
                  'dtype': dname, 'check_s': time.perf_counter() - t0, **r})
  print(smi, flush=True)
  print(json.dumps({'ok': True}), flush=True)


if __name__ == '__main__':
  main()
