#!/usr/bin/env python3
"""The bounds of B3, B4, B5 and B8 at the analysis path's rows, from
``chip_smoke.py``'s formulas (``check_analysis_rows``): the larger of
the work over the peak rate of the dtype and the bytes over HBM's rate.
Needs no card.

  python3 scripts/analysis_row_bounds.py

Prints one JSON line: {dtype: {kernel: {rows: [ms, 'bytes' |
'operations']}}}.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def live(k: int, length: int) -> int:
  """The taps of a k-tap conv that reach a row of a length-``length``
  sequence (``ops.kernel_utils.live_offsets``)."""
  sys.path.insert(0, REPO)
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  return len(live_offsets(k, length))


def main() -> None:
  sys.path.insert(0, REPO)
  import chip_smoke as s
  out = {}
  for dtype, es in (('float32', 4), ('bfloat16', 2)):
    rows = {k: {} for k in ('attn_pool_prologue_im2col', 'attn_pool',
                            'attn_l2', 'attn_pool_bwd')}
    for n in s.ANALYSIS_ROWS:
      flops = sum(2 * n * ((l + 1) // 2) * c * c for l, c in s.POOL_SHAPES)
      nbytes = sum(s._pool_bytes(n, l, c, es, live(5, (l + 1) // 2))
                   for l, c in s.POOL_SHAPES)
      rows['attn_pool_prologue_im2col'][n] = s.bound(flops, nbytes, dtype)
      l, c = s.LAST_POOL
      lh = (l + 1) // 2
      rows['attn_pool'][n] = s.bound(2 * n * lh * c * c,
                                     s._pool_bytes(n, l, c, es), dtype)
      rows['attn_pool_bwd'][n] = s.bound(
          3 * 2 * n * lh * c * c,
          (3 * n * l * c + n * lh * c + c * c) * es + c * c * 4, dtype)
      h, dk, dv = s.ATTN_L2_HEADS
      rows['attn_l2'][n] = s.bound(
          n * 2 * h * (6 * dk + 3 * dv),
          (n * 2 * h * (2 * dk + 2 * dv) + 5 * h * dk) * es + n * 2 * h * 4,
          dtype)
    out[dtype] = rows
  print(json.dumps(out))


if __name__ == '__main__':
  main()
