#!/usr/bin/env python3
"""Where B2's time goes, on one card.

  python3 scripts/probe_gumbel.py

Builds variants of ``svdd_tpu_torch/csrc/gumbel_candidates.cu`` from
patched copies of the sources under ``build/probe_gumbel/`` and times
each, and the kernel as built, at the SVDD-MC step's shape (B, M, L, V) =
(512, 10, 200, 5) with int64 tokens, half of them MASK: the profiler's
device time of the kernel over 20 calls, and CUDA events around the
wrapper. Variants (their draws are wrong; only the time is read):
``fast_inner_log`` (both logarithms as ``__logf``), ``no_logs`` (the
noise is the uniform itself), ``no_philox`` (the counter words stand in
for the Philox output), ``threads_128`` and ``threads_512`` (blocks of
128 or 512 threads for the 256 built), ``tile_64`` and ``tile_128``
(rows split into blocks of 64 or 128 positions) and ``all_masked`` (the
kernel as built with every position MASK). One JSON line per variant,
then the card's nvidia-smi name and power limit. Needs a CUDA card and
nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SRC = 'gumbel_candidates.cu'
VARIANTS = {
    'fast_inner_log': [('-__logf(-logf(u + 1e-20f) + 1e-20f)',
                        '-__logf(-__logf(u + 1e-20f) + 1e-20f)')],
    'no_logs': [('-__logf(-logf(u + 1e-20f) + 1e-20f)', 'u')],
    'no_philox': [('  return Philox{{c0, c1, c2, c3}};',
                   '  return Philox{{c0 ^ k0, c1, c2, c3}};'),
                  ('#pragma unroll\n  for (int r = 0; r < 10; ++r) {',
                   '#pragma unroll\n  for (int r = 0; r < 0; ++r) {')],
    'threads_128': [('constexpr int kThreads = 256;',
                     'constexpr int kThreads = 128;')],
    'threads_512': [('constexpr int kThreads = 256;',
                     'constexpr int kThreads = 512;')],
    'tile_64': [('constexpr int kMaxTile = 2048;',
                 'constexpr int kMaxTile = 64;')],
    'tile_128': [('constexpr int kMaxTile = 2048;',
                  'constexpr int kMaxTile = 128;')],
}
SHAPE = (512, 10, 200, 5)
REPS = 20


def build_variants(build) -> dict:
  """{variant: path of its library}, all nvcc runs at once."""
  procs = {}
  for name, patches in VARIANTS.items():
    src = REPO / 'build' / 'probe_gumbel' / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, src)
    text = (src / SRC).read_text()
    for old, new in patches:
      if old not in text:
        raise RuntimeError(f'{name}: {SRC} no longer holds {old!r}')
      text = text.replace(old, new)
    (src / SRC).write_text(text)
    lib = src / 'libgumbel_candidates.so'
    procs[name] = (lib, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, '-I', str(src), '-o', str(lib),
         str(src / SRC)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
  libs = {}
  for name, (lib, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{name}: nvcc rc {proc.returncode}\n{log}')
    libs[name] = lib
  return libs


def main() -> None:
  import ctypes
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_gumbel: needs a CUDA card')
  import chip_smoke
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import fused_sample as K
  _build.build()
  libs = build_variants(_build)
  b, m, l, v = SHAPE
  gen = torch.Generator('cuda').manual_seed(0)
  log_q = torch.log_softmax(torch.randn(b, l, v, device='cuda',
                                        generator=gen), -1)
  x = torch.randint(0, 4, (b, l), device='cuda', generator=gen)
  half = torch.where(torch.rand(b, l, device='cuda', generator=gen) < 0.5,
                     4, x)
  built = _build._lib('gumbel_candidates')

  def load(path):
    lib = ctypes.CDLL(str(path))
    lib.svdd_error_string.argtypes = [ctypes.c_int]
    lib.svdd_error_string.restype = ctypes.c_char_p
    return lib
  cases = [('as_built', built, half),
           ('all_masked', built, torch.full_like(x, 4))]
  cases += [(name, load(path), half) for name, path in libs.items()]
  for name, lib, tokens in cases:
    _build._LIBS['gumbel_candidates'] = lib
    call = lambda: K.gumbel_candidates(log_q, tokens, m, 4, gen)
    print(json.dumps({
        'variant': name, 'shape': list(SHAPE),
        'masked_share': float((tokens == 4).float().mean()),
        'device_ms': chip_smoke.device_ms(call, REPS,
                                          fragment='gumbel_candidates'),
        'median_ms': chip_smoke.median_ms(call, iters=REPS)}), flush=True)
  _build._LIBS['gumbel_candidates'] = built
  print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == '__main__':
  main()
