#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 10 (the MDLM variants in training, the
class-conditioned CNN and its classifier head, B2 on +inf lanes, the
saluki task) alone on one CUDA card, and measure the saluki oracle.

  python3 scripts/probe_a1.py            # build, phase 10, the oracle
  python3 scripts/probe_a1.py --oracle   # build, the oracle alone

The oracle measurement: one call of the six-channel ConvGRU
(``RewardOracle.create_saluki``) on (N, 12288, 6) saluki inputs at the
rows the CLIs give it: 32 x 5 (the smoke's SVDD-PM step), 256 (the CLIs'
default --batch_size, SVDD-MC's final scoring) and 256 x 5 (SVDD-PM's
step at the CLIs' defaults, --sample_M 5), each after a warm-up call: ms
by CUDA events, the peak memory allocated during the call, and the
split between the conv tower and the GRU block. Where a row count does
not fit in the card's memory, the largest multiple of 64 below it that
fits is searched and printed. Prints one JSON line a measurement and the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

ORACLE_ROWS = (32 * 5, 256, 256 * 5)


def _call(oracle, rows: int, body) -> dict:
  """One warmed-up oracle call on ``rows`` rows: ms (CUDA events), peak
  GiB, and the tower's and GRU block's ms."""
  import torch
  x = chip_smoke._saluki_input(rows, body, 2, 'cuda')
  trunk = oracle.module.trunk
  events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
  with torch.inference_mode():
    oracle(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    events[0].record()
    h = trunk.tower(x)
    events[1].record()
    out = oracle.module.head(trunk.gru(h))
    events[2].record()
    torch.cuda.synchronize()
    if out.shape[0] != rows or not bool(torch.isfinite(out).all()):
      raise AssertionError(f'saluki oracle at {rows} rows: {out.shape}')
  return {'rows': rows, 'ms': events[0].elapsed_time(events[2]),
          'tower_ms': events[0].elapsed_time(events[1]),
          'gru_ms': events[1].elapsed_time(events[2]),
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'input_gb': x.numel() * 4 / 2 ** 30, 'base_gb': base / 2 ** 30}


def _fits(oracle, rows: int, body):
  """The call's report, or None where it runs out of the card's memory."""
  import torch
  try:
    return _call(oracle, rows, body)
  except torch.cuda.OutOfMemoryError:
    torch.cuda.empty_cache()
    return None


def measure_oracle(body_path: str) -> None:
  import numpy as np
  import torch
  from svdd_tpu_torch import rewards
  body = torch.from_numpy(np.load(body_path))
  oracle = rewards.RewardOracle(rewards.RewardOracle.create_saluki(
      torch.Generator().manual_seed(0)).module.cuda())
  for rows in ORACLE_ROWS:
    r = _fits(oracle, rows, body)
    if r is not None:
      chip_smoke.emit({'phase': 'saluki_oracle_call', **r})
      continue
    lo, hi = 0, rows        # the largest multiple of 64 that fits
    while hi - lo > 64:
      mid = (lo + hi) // 2 // 64 * 64
      if mid <= lo:
        break
      if _fits(oracle, mid, body) is not None:
        lo = mid
      else:
        hi = mid
    chip_smoke.emit({'phase': 'saluki_oracle_call', 'rows': rows,
                     'out_of_memory': True, 'largest_rows_that_fit': lo,
                     'at_largest': _call(oracle, lo, body) if lo else None})
    torch.cuda.empty_cache()


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--oracle', action='store_true',
                 help='measure the saluki oracle alone')
  args = p.parse_args()
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_a1: no CUDA device')
  from svdd_tpu_torch import _build
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = chip_smoke.nvidia_smi()
  chip_smoke.emit({'phase': 'device', 'nvidia_smi': smi,
                   'nvcc_build_s': _build.build()})
  if not args.oracle:
    runs = chip_smoke.a1_phase()
    chip_smoke.emit({'phase': 'a1_launches', 'runs': runs})
  body = chip_smoke.write_saluki_body(
      os.path.join(REPO, 'build', 'chip_smoke', 'saluki'))
  measure_oracle(body)
  print(smi, flush=True)


if __name__ == '__main__':
  main()
