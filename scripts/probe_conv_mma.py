#!/usr/bin/env python3
"""Where the time of B7 (conv1d_bwd.cu) and B14 (fused_conv.cu) goes, on
one card.

  python3 scripts/probe_conv_mma.py

Builds variants of the two libraries from patched copies of the sources
under ``build/probe_conv_mma/``: ``no_mma`` (the tap and weight-gradient
loops' loads, splits and barriers without their mma instructions),
``no_act`` (B14 without its pass that activates each landed slab),
``f32_no_flush`` (the f32 tap routine of conv_mma.cuh in bf16's ring,
32 bytes of k a stage, 3 stages, two blocks an SM, with no per-stage
partial: the mma chains run into the accumulators, as B1's do) and
``wgrad_rows32`` (B7's wgrad with 32 rows a stage). Times each as built
and each variant, as the profiler's device time of each kernel (B7:
dgrad, wgrad, the partial-sum reduce; B14: its one kernel) over 5
calls, at the smoke's shapes (B7: the six value-tower convs at N = 512;
B14: the two 128-lane Basenji convs at (5120, 25)), in float32 and
bfloat16; B7's lines also give dx's largest error against the plain
version as a share of the smoke's tolerance (``tol_share``; above 1
fails; no_mma and no_act compute wrong values and only their time is
read). One JSON line per measurement, then the card's nvidia-smi name
and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LIBS = ('conv1d_bwd', 'fused_conv')
MMA_OFF = [('mma.cuh', '  asm("mma.sync.aligned.m16n8k16',
            '  if (0) asm("mma.sync.aligned.m16n8k16'),
           ('mma.cuh', '  asm("mma.sync.aligned.m16n8k8',
            '  if (0) asm("mma.sync.aligned.m16n8k8')]
VARIANTS = {
    'no_mma': MMA_OFF,
    'no_act': [('conv_mma.cuh', 'if constexpr (kAct) {', 'if constexpr (false) {')],
    'f32_no_flush': [('conv_mma.cuh', 'struct Ring<float> : RingOf<64, 2, 1, true> {};',
                      'struct Ring<float> : RingOf<32, 3, 2, false> {};')],
    'wgrad_rows32': [('conv_wgrad.cuh', 'constexpr int kWRows = 64;',
                      'constexpr int kWRows = 32;')],
}
REPS = 5
B7_PARTS = ('conv_bwd_dgrad', 'conv_bwd_wgrad', 'reduce_partials')


def build_variants(build) -> dict:
  """{(variant, library): path}, all nvcc runs at once."""
  procs = {}
  for name, patches in VARIANTS.items():
    src = REPO / 'build' / 'probe_conv_mma' / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, src)
    for f, old, new in patches:
      text = (src / f).read_text()
      if old not in text:
        raise RuntimeError(f'{name}: {f} no longer holds {old!r}')
      (src / f).write_text(text.replace(old, new))
    for lib_name in LIBS:
      lib = src / f'lib{lib_name}.so'
      procs[name, lib_name] = (lib, subprocess.Popen(
          [build.nvcc_path(), *build.NVCC_FLAGS, '-I', str(src), '-o', str(lib),
           str(src / f'{lib_name}.cu')], stdout=subprocess.PIPE,
          stderr=subprocess.STDOUT, text=True))
  libs = {}
  for key, (lib, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{key}: nvcc rc {proc.returncode}\n{log}')
    libs[key] = lib
  return libs


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_conv_mma: needs a CUDA card')
  import chip_smoke as cs
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import conv1d as C
  from svdd_tpu_torch.ops import fused_conv as F
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  _build.build()
  libs = build_variants(_build)
  gen = torch.Generator('cuda').manual_seed(0)
  own_path = _build._library_path
  for variant in ('as_built', *VARIANTS):
    if variant != 'as_built':
      _build._library_path = (lambda name, v=variant: libs[v, name]
                              if name in LIBS else own_path(name))
    for name in LIBS:
      _build._LIBS.pop(name, None)
    for dt in (torch.float32, torch.bfloat16):
      dn = str(dt).split('.')[-1]
      for l, cin, cout in cs.TOWER_CONVS:
        x, w, ct = cs._conv_bwd_inputs(cs.N_GRAD, l, cin, cout, dt, gen)
        parts = {p: cs.device_ms(lambda: C.conv1d_bwd(x, w, ct), REPS, p)
                 for p in B7_PARTS}
        parts['call'] = cs.device_ms(lambda: C.conv1d_bwd(x, w, ct), REPS)
        flops = 2 * 2 * cs.N_GRAD * cs.live_rows(l) * cin * cout
        got, want = C.conv1d_bwd(x, w, ct)[0].float(), C.conv1d_bwd_plain(x, w, ct)[0].float()
        atol, rtol = cs.TOL[dn]
        share = float(((got - want).abs() / (atol + rtol * want.abs())).max())
        print(json.dumps({'kernel': 'conv1d_bwd', 'variant': variant, 'dtype': dn,
                          'shape': [cs.N_GRAD, l, cin, cout], 'device_ms': parts,
                          'tflops': flops / parts['call'] / 1e9 if parts['call'] else None,
                          'tol_share': share}), flush=True)
        del got, want
        del x, w, ct
      for cin, cout in cs.FUSED_CONVS:
        args = cs._fused_conv_inputs(cs.IM2COL_ROWS, cs.IM2COL_L, cin, cout, dt, gen)
        with torch.no_grad():
          ms = cs.device_ms(lambda: F.fused_conv1d(*args), REPS, 'fused_conv_kernel')
        flops = 2 * cs.IM2COL_ROWS * cs.live_rows(cs.IM2COL_L) * cin * cout
        # (a profile that caught no kernel event reads 0: no rate)
        print(json.dumps({'kernel': 'fused_conv1d', 'variant': variant, 'dtype': dn,
                          'shape': [cs.IM2COL_ROWS, cs.IM2COL_L, cin, cout],
                          'device_ms': ms, 'tflops': flops / ms / 1e9 if ms else None}),
              flush=True)
      torch.cuda.empty_cache()
  _build._library_path = own_path
  print(cs.nvidia_smi(), flush=True)


if __name__ == '__main__':
  main()
