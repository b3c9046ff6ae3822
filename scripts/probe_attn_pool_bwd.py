#!/usr/bin/env python3
"""Where the time of B8 (csrc/attn_pool_bwd.cu) goes, on one card.

  python3 scripts/probe_attn_pool_bwd.py [--check]

Prints what ptxas reports for each kernel of the library as built
(registers, spills), then holds B8 at the classifier's seven tower pools
(N = 512, with the residual) and at the smoke's short points against its
plain version, in float32 and bfloat16 (``--check`` stops there). Then
builds variants of the library from patched copies of the sources under
``build/probe_attn_pool_bwd/``: ``ring_5tap`` (the logits and dgrad
products on the tap routine's own ring, Ring<T>, whose stages of 64
bytes of k in f32 and 32 in bf16 reserve five weight tiles: 2 stages
deep in f32, 3 in bf16), ``ring1_k64`` (Ring1 stages of 64 bytes 4 deep
in f32, 32 bytes 6 deep in bf16), ``ring1_k128`` (f32 128 bytes 4 deep;
bf16 64 bytes 4 deep), ``reduce_strided`` (the partial sums by
reduce.cuh's strided kernel, which B6's sums take, not its 16-byte
one), ``no_epilogue`` (the two products' epilogues skipped: wgt, T(dld)
and dx not written, the products still run) and ``no_mma`` (the loads,
fragment loads and barriers without their mma instructions). Times the
library as built and each variant at the seven pools by the profiler's
device time over 5 calls, kernel by kernel (``diff``: the T(d) pass,
``logits``, ``dgrad``, ``wgrad``, ``reduce``: the partial sums) and the
whole call; the variants compute wrong values, only their time is read.
One JSON line per measurement, then the card's nvidia-smi name and power
limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LIB = 'attn_pool_bwd'
EPILOGUE = '  conv::for_each_pair(acc, m0, n0, rows, [&]'
F32_RING = 'struct Ring1<float> : RingOf<256, 3, 1, true, 1> {};'
BF16_RING = 'struct Ring1<__nv_bfloat16> : RingOf<128, 3, 2, false, 1> {};'
VARIANTS = {
    'ring_5tap': [('attn_pool_bwd.cu', 'conv::Ring1<T>', 'conv::Ring<T>')],
    'ring1_k64': [('conv_mma.cuh', F32_RING, F32_RING.replace('256, 3', '64, 4')),
                  ('conv_mma.cuh', BF16_RING, BF16_RING.replace('128, 3', '32, 6'))],
    'ring1_k128': [('conv_mma.cuh', F32_RING, F32_RING.replace('256, 3', '128, 4')),
                   ('conv_mma.cuh', BF16_RING, BF16_RING.replace('128, 3', '64, 4'))],
    'reduce_strided': [('reduce.cuh', 'if (elems % 4 == 0 && total >= red_vec_outputs() &&',
                        'if (false && total >= red_vec_outputs() &&')],
    'no_epilogue': [('attn_pool_bwd.cu', EPILOGUE, '  if (rows < 0)' + EPILOGUE[1:])],
    'no_mma': [('mma.cuh', '  asm("mma.sync.aligned.m16n8k16',
                '  if (0) asm("mma.sync.aligned.m16n8k16'),
               ('mma.cuh', '  asm("mma.sync.aligned.m16n8k8',
                '  if (0) asm("mma.sync.aligned.m16n8k8')],
}
PARTS = {'diff': 'pool_bwd_diff', 'logits': 'pool_bwd_logits',
         'dgrad': 'pool_bwd_dgrad', 'wgrad': 'pool_bwd_wgrad',
         'reduce': 'reduce_partials'}
REPS = 5


def ptxas_report(build) -> list:
  """ptxas's lines on the kernels of the library as built."""
  out = REPO / 'build' / 'probe_attn_pool_bwd' / 'ptxas.so'
  out.parent.mkdir(parents=True, exist_ok=True)
  log = subprocess.run(
      [build.nvcc_path(), *build.NVCC_FLAGS, '-Xptxas', '-v', '-I',
       str(build.SRC_DIR), '-o', str(out), str(build.SRC_DIR / f'{LIB}.cu')],
      capture_output=True, text=True, check=True).stderr
  return [ln.strip() for ln in log.splitlines()
          if 'registers' in ln or 'spill' in ln or 'Compiling entry' in ln]


def build_variants(build) -> dict:
  """{variant: library path}, all nvcc runs at once."""
  procs = {}
  for name, patches in VARIANTS.items():
    src = REPO / 'build' / 'probe_attn_pool_bwd' / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, src)
    for f, old, new in patches:
      text = (src / f).read_text()
      if old not in text:
        raise RuntimeError(f'{name}: {f} no longer holds {old!r}')
      (src / f).write_text(text.replace(old, new))
    lib = src / f'lib{LIB}.so'
    procs[name] = (lib, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, '-I', str(src), '-o', str(lib),
         str(src / f'{LIB}.cu')], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
  libs = {}
  for name, (lib, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'{name}: nvcc rc {proc.returncode}\n{log}')
    libs[name] = lib
  return libs


def parts_ms(fn) -> dict:
  """The card's time a call of fn, kernel by kernel (PARTS) and in all
  ('call'), over REPS calls after a warm-up (the profiler)."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(REPS):
      fn()
    torch.cuda.synchronize()
  out = dict.fromkeys((*PARTS, 'call'), 0.0)
  for e in prof.events():
    if e.device_type != torch.autograd.DeviceType.CUDA:
      continue
    ms = (e.time_range.end - e.time_range.start) / 1e3 / REPS
    out['call'] += ms
    for part, frag in PARTS.items():
      if frag in e.name:
        out[part] += ms
  return out


def check(cs) -> None:
  """The smoke's comparisons of B8 with its plain version."""
  import torch
  gen = torch.Generator('cuda').manual_seed(0)
  for dt in (torch.float32, torch.bfloat16):
    dn = str(dt).split('.')[-1]
    errs = {}
    for l, c in cs.TOWER_POOLS:
      args = cs._pool_bwd_inputs(cs.N_GRAD, l, c, dt, gen)
      dx, dw = cs._pool_bwd_against_plain(args, dn, f'attn_pool_bwd L={l} C={c}')
      errs[f'L={l} C={c}'] = {'dx': dx[0], 'dW': dw[0]}
      del args
      torch.cuda.empty_cache()
    print(json.dumps({'check': LIB, 'dtype': dn, 'pools': errs,
                      'points': cs._pool_bwd_points(dt)}), flush=True)


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_attn_pool_bwd: needs a CUDA card')
  import chip_smoke as cs
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_pool as K
  torch.backends.cuda.matmul.allow_tf32 = False
  warnings.filterwarnings('ignore', message='.*Profiler clears events')
  _build.build()
  print(json.dumps({'ptxas': ptxas_report(_build)}), flush=True)
  check(cs)
  if '--check' in sys.argv:
    print(cs.nvidia_smi(), flush=True)
    return
  libs = build_variants(_build)
  own_path = _build._library_path
  gen = torch.Generator('cuda').manual_seed(1)
  for variant in ('as_built', *VARIANTS):
    if variant != 'as_built':
      _build._library_path = (lambda name, v=variant: libs[v] if name == LIB
                              else own_path(name))
    _build._LIBS.pop(LIB, None)
    for dt in (torch.float32, torch.bfloat16):
      dn = str(dt).split('.')[-1]
      total = dict.fromkeys((*PARTS, 'call'), 0.0)
      for l, c in cs.TOWER_POOLS:
        args = cs._pool_bwd_inputs(cs.N_GRAD, l, c, dt, gen)
        ms = parts_ms(lambda: K.attn_pool_bwd(*args))
        for k in total:
          total[k] += ms[k]
        flops = 3 * 2 * cs.N_GRAD * ((l + 1) // 2) * c * c
        print(json.dumps({'kernel': LIB, 'variant': variant, 'dtype': dn,
                          'shape': [cs.N_GRAD, l, c], 'device_ms': ms,
                          'tflops': flops / ms['call'] / 1e9}), flush=True)
        del args
        torch.cuda.empty_cache()
      print(json.dumps({'kernel': LIB, 'variant': variant, 'dtype': dn,
                        'pools': 7, 'device_ms': total}), flush=True)
  _build._library_path = own_path
  print(cs.nvidia_smi(), flush=True)


if __name__ == '__main__':
  main()
