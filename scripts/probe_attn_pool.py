#!/usr/bin/env python3
"""Where the time of B3 and B4 (csrc/attn_pool.cu) goes, on one card.

  python3 scripts/probe_attn_pool.py [--check]

Prints what ptxas reports for each build of the pool kernel (registers,
spills), then holds B3 at the six fused tower pools and B4 at the last
one (N = 5120) and at the smoke's short points against their plain
versions, in float32 and bfloat16 (``--check`` stops there). Then builds
variants of the library from patched copies of the sources under
``build/probe_attn_pool/``: ``no_mma`` (the loads, passes, fragment
loads and barriers without their mma instructions), ``no_pass`` (the
landed rows not turned into T(d): the mmas read a stale slab),
``no_stores`` (the epilogue's tile blended and staged but not written
out), ``k32_deeper`` (stages of 32 bytes of k, 4 deep in f32 and 5 in
bf16, not 64 bytes 2 and 3 deep) and ``row_tile_fastest`` (the grid's
row tiles fastest, as the kernel before the tensor-core design ran: the
column tiles of a row tile far apart in time, so each reads the pair
rows from HBM), ``w_k_rows`` (W's tile landed by rows of k, as the
module stores W, its fragments read by ldmatrix.trans in bf16 and by
word loads in f32: the layout that would spare the wrapper its
transpose; it reads the transposed buffer, so only its time is right).
Times each as built and each variant by the profiler's
device time over 5 calls, of the kernel (``kernel``) and of the whole
call with the wrapper's transpose of W (``call``), at the smoke's
shapes (B4 also at the classifier's first pool, N = 512, L = 200), in
float32 and bfloat16, with the call's rate and the bytes a second the
shapes must move (the variants compute wrong values; only their time is
read). Last, for B3 at the six pools, the parts of a two-kernel design
that this kernel was preferred to (``two_kernel``): T(d) written by a
first kernel, then the product run by ``conv_mma.cuh``'s tap routine.
The product is timed as B14's kernel (``csrc/fused_conv.cu``) at one
tap over a random (N, LH, C) T(d), the identity affine and no
activation; the first kernel and the second's extra bytes (x and the
residual read again for the blend, k_live - 1 more slabs written than
B14's one output) are counted at the card's memory rate, so ``est_ms``
is a lower estimate of that design, not a measurement of it. One JSON
line per measurement, then the card's nvidia-smi name and power limit.
Needs a CUDA card and nvcc.
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

LIB = 'attn_pool'
VARIANTS = {
    'no_mma': [('mma.cuh', '  asm("mma.sync.aligned.m16n8k16',
                '  if (0) asm("mma.sync.aligned.m16n8k16'),
               ('mma.cuh', '  asm("mma.sync.aligned.m16n8k8',
                '  if (0) asm("mma.sync.aligned.m16n8k8')],
    'no_pass': [('attn_pool.cu', '    pass(s);\n', '')],
    'no_stores': [('attn_pool.cu', '  // the staged tile out in 16-byte chunks',
                   '  if (N > 0) return;\n  // the staged tile out in 16-byte chunks')],
    'k32_deeper': [('attn_pool.cu', 'static constexpr int kKBytes = 64;',
                    'static constexpr int kKBytes = 32;'),
                   ('attn_pool.cu', 'static constexpr int kStages = sizeof(T) == 4 ? 2 : 3;',
                    'static constexpr int kStages = sizeof(T) == 4 ? 4 : 5;')],
    'row_tile_fastest': [(
        'conv_mma.cuh',
        '  *m0 = static_cast<long long>(blockIdx.x / col_tiles) * kBM;\n'
        '  *n0 = (blockIdx.x % col_tiles) * kBN;',
        '  const int row_tiles = gridDim.x / col_tiles;\n'
        '  *m0 = static_cast<long long>(blockIdx.x % row_tiles) * kBM;\n'
        '  *n0 = (blockIdx.x / row_tiles) * kBN;')],
    'w_k_rows': [
        ('conv_mma.cuh',
         '#pragma unroll\n'
         '    for (int q = 0; q < kNT / 2; ++q) {\n'
         '      uint32_t r[4];\n'
         '      mma::ldsm_x4(r, b_row + 16 * q * Pitch + kk * 32);\n',
         '    if constexpr (!kBf16) {\n'
         '      for (int ni = 0; ni < kNT; ++ni) {\n'
         '        const uint32_t at = b_row + 8 * kk * Pitch + 32 * ni;\n'
         '        asm volatile("ld.shared.b32 %0, [%1];" : "=r"(b[ni][0]) : "r"(at));\n'
         '        asm volatile("ld.shared.b32 %0, [%1];" : "=r"(b[ni][1]) : "r"(at + 4 * Pitch));\n'
         '      }\n'
         '    } else {\n'
         '#pragma unroll\n'
         '    for (int q = 0; q < kNT / 2; ++q) {\n'
         '      uint32_t r[4];\n'
         '      mma::ldsm_x4_trans(r, b_row + 16 * kk * Pitch + 32 * q);\n'),
        ('conv_mma.cuh', '      b[2 * q + 1][1] = r[3];\n    }\n',
         '      b[2 * q + 1][1] = r[3];\n    }\n    }\n'),
        ('attn_pool.cu', 'static constexpr int kStage = 4 * kLand + kBN * kPitch;',
         'static constexpr int kWPitch = kBN * sizeof(T) + (sizeof(T) == 4 ? 32 : 16);\n'
         '  static constexpr int kStage = 4 * kLand + kKE * kWPitch;'),
        ('attn_pool.cu',
         '    const T* wk = wt + static_cast<size_t>(n0) * C + k0;\n'
         '    for (int e = tid; e < kBN * P::kKChunks; e += kThreads) {\n'
         '      const int n = e / P::kKChunks, c = e % P::kKChunks;\n'
         '      mma::cp_async16(st + 4 * P::kLand + n * P::kPitch + c * 16,\n'
         '                      wk + static_cast<size_t>(n) * C + c * P::kE, true);\n',
         '    const T* wk = wt + static_cast<size_t>(k0) * C + n0;\n'
         '    for (int e = tid; e < P::kKE * P::kRowChunks; e += kThreads) {\n'
         '      const int k = e / P::kRowChunks, c = e % P::kRowChunks;\n'
         '      mma::cp_async16(st + 4 * P::kLand + k * P::kWPitch + c * 16,\n'
         '                      wk + static_cast<size_t>(k) * C + c * P::kE, true);\n'),
        ('attn_pool.cu',
         '  const int bn = 32 * wn + (lane >> 4) * 8 + (lane & 7), bc = (lane >> 3) & 1;',
         '  const int bk = sizeof(T) == 2 ? ra : lane & 3;\n'
         '  const int bn = 32 * wn + (sizeof(T) == 2 ? (lane >> 4) * 8 : lane >> 2);'),
        ('attn_pool.cu', 'bn * P::kPitch + bc * 16;', 'bk * P::kWPitch + bn * sizeof(T);'),
        ('attn_pool.cu', 'mma_stage<T, P::kKSteps, P::kPitch>', 'mma_stage<T, P::kKSteps, P::kWPitch>')],
}
REPS = 5


def ptxas_report(build) -> list:
  """ptxas's lines on the pool kernels of the library as built."""
  out = REPO / 'build' / 'probe_attn_pool' / 'ptxas.so'
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
    src = REPO / 'build' / 'probe_attn_pool' / name
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


def check(cs, gen) -> None:
  """The smoke's comparisons of B3 and B4 with their plain versions."""
  import torch
  from svdd_tpu_torch.ops import attn_pool as K
  for dt in (torch.float32, torch.bfloat16):
    dn = str(dt).split('.')[-1]
    for l, c in cs.POOL_SHAPES:
      args = cs._pool_args(l, c, dt, gen)
      err = cs.compare(f'B3 L={l} C={c}', K.pool_prologue_im2col_wlogits(*args),
                       K.pool_prologue_im2col_wlogits_plain(*args), dn)
      print(json.dumps({'check': 'attn_pool_prologue_im2col', 'dtype': dn,
                        'shape': [cs.N_CAND, l, c], 'max_abs_err': err[0]}),
            flush=True)
      del args
      torch.cuda.empty_cache()
    x, res, w = cs._pool_inputs(*cs.LAST_POOL, dt, gen)
    err = cs.compare('B4', K.attn_pool(x, w, res), K.attn_pool_plain(x, w, res), dn)
    print(json.dumps({'check': 'attn_pool', 'dtype': dn,
                      'shape': [cs.N_CAND, *cs.LAST_POOL], 'max_abs_err': err[0],
                      'points_b3': cs._pool_points(dt, True),
                      'points_b4': cs._pool_points(dt, False)}), flush=True)
    torch.cuda.synchronize()


def two_kernel(cs, gen) -> None:
  """The parts of the two-kernel design at B3's six pools (module
  docstring)."""
  import torch
  from svdd_tpu_torch.ops import fused_conv as FC
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  for dt in (torch.float32, torch.bfloat16):
    dn = str(dt).split('.')[-1]
    es = torch.tensor([], dtype=dt).element_size()
    for l, c in cs.POOL_SHAPES:
      lh = (l + 1) // 2
      k_live = len(live_offsets(5, lh))
      td = torch.randn(cs.N_CAND, lh, c, device='cuda', generator=gen).to(dt)
      w = torch.randn(1, c, c, device='cuda', generator=gen) / c ** 0.5
      zero = torch.zeros(c, device='cuda')
      one = torch.ones(c, device='cuda')
      product_ms = cs.device_ms(
          lambda: FC._fused_conv1d_kernel(td, w, zero, one, zero, None), REPS,
          'fused_conv_kernel')
      first = (2 * cs.N_CAND * l * c + cs.N_CAND * lh * c) * es
      extra = (2 * cs.N_CAND * l * c + (k_live - 1) * cs.N_CAND * lh * c) * es
      rate_ms = 1e3 / cs.HBM_BYTES_PER_S
      print(json.dumps({'two_kernel': 'attn_pool_prologue_im2col', 'dtype': dn,
                        'shape': [cs.N_CAND, l, c], 'product_ms': product_ms,
                        'first_kernel_bound_ms': first * rate_ms,
                        'extra_bytes_bound_ms': extra * rate_ms,
                        'est_ms': product_ms + (first + extra) * rate_ms}),
            flush=True)
      del td, w
      torch.cuda.empty_cache()


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_attn_pool: needs a CUDA card')
  import chip_smoke as cs
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_pool as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  torch.backends.cuda.matmul.allow_tf32 = False
  warnings.filterwarnings('ignore', message='.*Profiler clears events')
  _build.build()
  print(json.dumps({'ptxas': ptxas_report(_build)}), flush=True)
  gen = torch.Generator('cuda').manual_seed(0)
  check(cs, gen)
  if '--check' in sys.argv:
    print(cs.nvidia_smi(), flush=True)
    return
  libs = build_variants(_build)
  own_path = _build._library_path

  def parts(fn):
    return {'kernel': cs.device_ms(fn, REPS, 'attn_pool_kernel'),
            'call': cs.device_ms(fn, REPS)}

  for variant in ('as_built', *VARIANTS):
    if variant != 'as_built':
      _build._library_path = (lambda name, v=variant: libs[v] if name == LIB
                              else own_path(name))
    _build._LIBS.pop(LIB, None)
    for dt in (torch.float32, torch.bfloat16):
      dn = str(dt).split('.')[-1]
      for l, c in cs.POOL_SHAPES:
        args = cs._pool_args(l, c, dt, gen)
        lh = (l + 1) // 2
        ms = parts(lambda: K.pool_prologue_im2col_wlogits(*args))
        nbytes = cs._pool_bytes(cs.N_CAND, l, c, args[0].element_size(),
                                len(live_offsets(5, lh)))
        flops = 2 * cs.N_CAND * lh * c * c
        print(json.dumps({'kernel': 'attn_pool_prologue_im2col', 'variant': variant,
                          'dtype': dn, 'shape': [cs.N_CAND, l, c], 'device_ms': ms,
                          'tflops': flops / ms['call'] / 1e9,
                          'tb_s': nbytes / ms['call'] / 1e9}), flush=True)
        del args
        torch.cuda.empty_cache()
      for n, (l, c) in ((cs.N_CAND, cs.LAST_POOL), (cs.N_GRAD, (200, 768))):
        x, res, w = cs._pool_inputs(l, c, dt, gen, n)
        ms = parts(lambda: K.attn_pool(x, w, res))
        flops = 2 * n * ((l + 1) // 2) * c * c
        print(json.dumps({'kernel': 'attn_pool', 'variant': variant, 'dtype': dn,
                          'shape': [n, l, c], 'device_ms': ms,
                          'tflops': flops / ms['call'] / 1e9}), flush=True)
        del x, res, w
        torch.cuda.empty_cache()
  _build._library_path = own_path
  two_kernel(cs, gen)
  print(cs.nvidia_smi(), flush=True)


if __name__ == '__main__':
  main()
