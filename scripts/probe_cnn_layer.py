#!/usr/bin/env python3
"""Where B1's time goes, and B6's kernels one by one, on one card.

  python3 scripts/probe_cnn_layer.py

Builds two variants of ``svdd_tpu_torch/csrc/cnn_layer.cu`` from patched
copies of the sources under ``build/probe_cnn_layer/``: ``no_taps`` (the
tap loop left out: the weight prefetch, the LayerNorm prologue and the
epilogue alone) and ``no_mma`` (the loop's loads, splits and barriers
without its mma instructions). Times the kernel as built and each variant
at (512, 200, 128) at every dilation, in float32 and bfloat16, as the
profiler's device time of ``cnn_layer_kernel`` over 10 calls (a variant's
output is wrong; only its time is read). Then profiles one B6 call per
dtype at dilation 1 and prints each of its kernels' device times. One
JSON line per measurement, then the card's nvidia-smi name and power
limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VARIANTS = {
    'no_taps': [('cnn_layer.cuh', '  const int n_stages = k_live * kPerTap;',
                 '  mma::cp_async_wait<0>();\n  return;\n'
                 '  const int n_stages = k_live * kPerTap;')],
    'no_mma': [('mma.cuh', '  asm("mma.sync.aligned.m16n8k16',
                '  if (0) asm("mma.sync.aligned.m16n8k16'),
               ('mma.cuh', '  asm("mma.sync.aligned.m16n8k8',
                '  if (0) asm("mma.sync.aligned.m16n8k8')],
}
SHAPE = (512, 200, 128)
REPS = 10


def build_variants(build) -> dict:
  """{variant: path of its cnn_layer library}, all nvcc runs at once."""
  procs = {}
  for name, patches in VARIANTS.items():
    src = REPO / 'build' / 'probe_cnn_layer' / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, src)
    for f, old, new in patches:
      text = (src / f).read_text()
      if old not in text:
        raise RuntimeError(f'{name}: {f} no longer holds {old!r}')
      (src / f).write_text(text.replace(old, new))
    lib = src / 'libcnn_layer.so'
    procs[name] = (lib, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, '-I', str(src), '-o', str(lib),
         str(src / 'cnn_layer.cu')], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
  libs = {}
  for name, (lib, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{name}: nvcc rc {proc.returncode}\n{log}')
    libs[name] = lib
  return libs


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_cnn_layer: needs a CUDA card')
  import chip_smoke
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import cnn_layer as K
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  _build.build()
  libs = build_variants(_build)
  gen = torch.Generator('cuda').manual_seed(0)
  inputs = {dt: chip_smoke._cnn_inputs(SHAPE[0], SHAPE[1], dt, gen)
            for dt in (torch.float32, torch.bfloat16)}
  own_path = _build._library_path
  for variant in ('as_built', *libs):
    if variant != 'as_built':
      _build._library_path = (lambda name, lib=libs[variant]: lib
                              if name == 'cnn_layer' else own_path(name))
      _build._LIBS.pop('cnn_layer', None)
    for dt, (args, _) in inputs.items():
      for d in (1, 4, 16, 64):
        ms = chip_smoke.device_ms(lambda: K.cnn_layer(*args, dilation=d),
                                  REPS, 'cnn_layer_kernel')
        print(json.dumps({'kernel': 'cnn_layer', 'variant': variant,
                          'dtype': str(dt).split('.')[-1], 'dilation': d,
                          'device_ms': ms}), flush=True)
  _build._library_path = own_path
  _build._LIBS.pop('cnn_layer', None)
  for dt, (args, ct) in inputs.items():
    parts = {frag: chip_smoke.device_ms(
                 lambda: K.cnn_layer_bwd(*args, ct, dilation=1), REPS, frag)
             for frag in ('cnn_bwd_mask', 'cnn_bwd_dgrad_ln', 'cnn_bwd_wgrad',
                          'reduce_partials')}
    print(json.dumps({'kernel': 'cnn_layer_bwd', 'dtype': str(dt).split('.')[-1],
                      'dilation': 1, 'device_ms': parts}), flush=True)
  print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == '__main__':
  main()
