"""Time the pairwise attention-pool kernel of svdd_tpu_torch
(``svdd_attn_pool``, with a residual) built from two source directories,
on the same inputs, in turns: other, this, this, other.

  mkdir -p OTHER && for f in attn_pool.cu common.cuh; do
    git show COMMIT:svdd_tpu_torch/csrc/$f > OTHER/$f; done
  python3 scripts/ab_attn_pool.py OTHER

Needs a CUDA card and nvcc. Prints one JSON line: the median ms of each
turn, per dtype, at the value tower's last pool (5120, 4, 1536), and the
card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from svdd_tpu_torch import _build  # noqa: E402


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('other', help='directory holding the other attn_pool.cu')
  args = p.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('ab_attn_pool: needs a CUDA card')
  _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  other_so = _build.BUILD_DIR / 'libattn_pool-other.so'
  subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-I', args.other,
                  '-o', str(other_so),
                  os.path.join(args.other, 'attn_pool.cu')], check=True)
  libs = {'other': ctypes.CDLL(str(other_so)),
          'this': _build._lib('attn_pool')}
  for lib in libs.values():
    lib.svdd_attn_pool.argtypes = _build.SIGNATURES['svdd_attn_pool'][1]
    lib.svdd_attn_pool.restype = ctypes.c_int
  gen = torch.Generator('cuda').manual_seed(0)
  out = {}
  for dtype in (torch.float32, torch.bfloat16):
    x, res, w = chip_smoke._pool_inputs(*chip_smoke.LAST_POOL, dtype, gen)
    n, l, c = x.shape
    o = torch.empty((n, (l + 1) // 2, c), dtype=dtype, device='cuda')

    def call(lib):
      return lambda: _build.check(lib.svdd_attn_pool(
          x.data_ptr(), res.data_ptr(), w.data_ptr(), o.data_ptr(), n, l,
          c, _build.dtype_code(x), _build.stream_ptr(x)), 'svdd_attn_pool')

    name = str(dtype).split('.')[-1]
    for who in ('other', 'this', 'this', 'other'):
      out.setdefault(f'{who}_{name}', []).append(
          chip_smoke.median_ms(call(libs[who]), iters=20, warmup=3))
  print(json.dumps({'ab_attn_pool_ms': out,
                    'card': chip_smoke.nvidia_smi()}))


if __name__ == '__main__':
  main()
