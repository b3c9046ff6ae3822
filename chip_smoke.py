#!/usr/bin/env python3
"""Drive the svdd_tpu_torch port on one CUDA card and check it.

  python3 chip_smoke.py

Phases, each printing one JSON line and ending in
``torch.cuda.synchronize()``; any failed check raises, so the script
exits non-zero and prints no result:
  1. device and build: the card, versions, the nvcc build of every
     kernel under svdd_tpu_torch/csrc (one nvcc per source, in parallel);
  2. every kernel of the SVDD-MC, DPS and classifier-guidance paths at
     its full-size shapes, in float32 and bfloat16, against its plain
     PyTorch version on the same inputs (the candidate draw on the noise
     the kernel reports, and by frequencies; the cnn layer's backward on
     the relu mask the kernel reports), with median times of both, the
     time of one PyTorch call computing the same function where there is
     one, and the least time the card could take for the work;
  3. the full-width denoiser and Enformer value net on a few rows, the
     kernel path on the card against the plain path on the CPU: their
     outputs, then the input gradients the guided decoders take;
  4. the decodes, each through its CLI's ``run`` at --task dna, B=512,
     L=200, 128 steps, full-width random-weight models, with every
     kernel's launch count read around it: SVDD-MC (M=10), DPS and
     classifier guidance;
  5. one step of each decode under torch.profiler: host ms per step,
     the card's busy ms and idle share, and kernel ms by kind;
then the kernels line, the card's ``nvidia-smi`` name and power limit,
and a last line {"ok": true, "device": {...}}.

Float32 phases run with TF32 off for matmuls and cuDNN convolutions.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# name -> (source, the TPU kernel's pallas_call it replaces[, the
# (N, L, C) pallas_call whose function it also computes])
KERNEL_INFO = {
    'cnn_layer': ('svdd_tpu_torch/csrc/cnn_layer.cu',
                  'svdd_tpu/ops/cnn_layer_pallas.py:234'),
    'gumbel_candidates': ('svdd_tpu_torch/csrc/gumbel_candidates.cu',
                          'svdd_tpu/ops/fused_sample.py:63'),
    'attn_pool_prologue_im2col': ('svdd_tpu_torch/csrc/attn_pool.cu',
                                  'svdd_tpu/ops/attn_pool_pallas.py:1071',
                                  'svdd_tpu/ops/attn_pool_pallas.py:721'),
    'attn_pool': ('svdd_tpu_torch/csrc/attn_pool.cu',
                  'svdd_tpu/ops/attn_pool_pallas.py:916',
                  'svdd_tpu/ops/attn_pool_pallas.py:397'),
    'attn_l2': ('svdd_tpu_torch/csrc/attn_l2.cu',
                'svdd_tpu/ops/attn_l2_pallas.py:260',
                'svdd_tpu/ops/attn_l2_pallas.py:141'),
    'cnn_layer_bwd': ('svdd_tpu_torch/csrc/cnn_layer_bwd.cu',
                      'svdd_tpu/ops/cnn_layer_pallas.py:504'),
    'conv1d_bwd': ('svdd_tpu_torch/csrc/conv1d_bwd.cu',
                   'svdd_tpu/ops/conv1d_bwd_pallas.py:141'),
    'attn_pool_bwd': ('svdd_tpu_torch/csrc/attn_pool_bwd.cu',
                      'svdd_tpu/ops/attn_pool_pallas.py:523'),
}
# the kernels each decode must launch
PATH_KERNELS = {
    'svdd_mc': ('cnn_layer', 'gumbel_candidates',
                'attn_pool_prologue_im2col', 'attn_pool', 'attn_l2'),
    'dps': ('cnn_layer', 'cnn_layer_bwd'),
    'classifier': ('cnn_layer', 'attn_pool', 'attn_l2', 'conv1d_bwd',
                   'attn_pool_bwd'),
}
# kernel-vs-plain tolerances |got - want| <= atol + rtol * |want|:
#  * float32: the kernel and PyTorch sum the same f32 products in other
#    orders (TF32 off), ~1e-6 relative per product sum;
#  * bfloat16 (8-bit mantissa, 2^-8 relative): the kernels round to
#    bf16 where their plain versions do, but sum in f32 in another
#    order, so a value rounded to bf16 mid-way (cnn_layer's conv output,
#    attn_l2's q + bias) can land one bf16 ulp apart and carry that
#    into the output: a few bf16 ulps at most.
TOL = {'float32': (1e-4, 1e-4), 'bfloat16': (2 ** -5, 2 ** -5)}
# sums over rows (weight gradients, per-channel and per-sequence sums):
# |got - want| <= RED_TOL * max |want|. f32: the same products summed in
# another order over up to 1e5 rows; bf16: the summed values are rounded
# to bf16 where the plain version rounds them, but an f32 statistic in
# another order can round one of them (a normalised h, a blend weight's
# dld) one bf16 ulp apart, a 2^-8 change of one term of a long sum.
RED_TOL = {'float32': 2e-4, 'bfloat16': 2 ** -7}
# where the cnn layer backward's relu mask (the forward kernel's) and the
# plain version's own disagree, the plain conv output must be within
# rounding of 0: f32 tap sums in another order, or one bf16 ulp of a
# conv output of magnitude below 1
MASK_EDGE = {'float32': 1e-4, 'bfloat16': 2 ** -6}

# the card's published peaks (NVIDIA data sheet, H100 SXM, dense, at its
# 700 W limit): f32 outside the tensor cores, bf16 on them, HBM3
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype: str = 'float32'):
  """(ms, 'operations' | 'bytes'): the least time the card could take,
  the larger of the work over the peak rate and the bytes over HBM's."""
  t_ops = flops / PEAK_FLOPS[dtype]
  t_mem = nbytes / HBM_BYTES_PER_S
  return max(t_ops, t_mem) * 1e3, 'operations' if t_ops >= t_mem else 'bytes'


def emit(obj) -> None:
  print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 5, warmup: int = 1) -> float:
  """Median device time of fn() over iters launches (CUDA events)."""
  import torch
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(iters):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
  times.sort()
  return times[len(times) // 2]


def compare_sum(name: str, got, want, dtype: str) -> tuple[float, float]:
  """(max abs error, max abs error / max |want|) of a sum over rows;
  raises beyond RED_TOL of the largest |want|."""
  import torch
  got, want = got.float(), want.float()
  if got.shape != want.shape or not torch.isfinite(got).all():
    raise AssertionError(f'{name} {dtype}: shape {tuple(got.shape)} vs '
                         f'{tuple(want.shape)} or non-finite values')
  err = float((got - want).abs().max())
  scale = float(want.abs().max())
  if err > RED_TOL[dtype] * scale:
    raise AssertionError(f'{name} {dtype}: max abs err {err} > '
                         f'{RED_TOL[dtype]} * max |plain| {scale}')
  return err, err / scale if scale else 0.0


def compare(name: str, got, want, dtype: str) -> tuple[float, float]:
  """(max abs error, max abs error / max |want|); raises when any
  element is outside the stated tolerance."""
  import torch
  got, want = got.float(), want.float()
  if got.shape != want.shape:
    raise AssertionError(f'{name}: shape {tuple(got.shape)} != '
                         f'{tuple(want.shape)}')
  if not torch.isfinite(got).all():
    raise AssertionError(f'{name} {dtype}: non-finite output')
  atol, rtol = TOL[dtype]
  err = (got - want).abs()
  bad = err > atol + rtol * want.abs()
  if bad.any():
    raise AssertionError(
        f'{name} {dtype}: {int(bad.sum())} of {err.numel()} elements out '
        f'of tolerance (atol {atol}, rtol {rtol}); max abs err '
        f'{float(err.max())}')
  return float(err.max()), float(err.max() / want.abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


# calls per denoiser pass of the 20 layers, by dilation
CNN_CALLS = {1: 8, 4: 4, 16: 4, 64: 4}


def check_cnn_layer(dtype, gen):
  """B1 at the guided-step shape (512, 200, 128), all four dilations."""
  import torch
  from svdd_tpu_torch.ops import cnn_layer as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  n, l, c = 512, 200, 128
  dev = 'cuda'
  x = torch.randn(n, l, c, device=dev, generator=gen).to(dtype)
  br = torch.randn(n, c, device=dev, generator=gen).to(dtype)
  g = 1 + 0.1 * torch.randn(c, device=dev, generator=gen)
  b = 0.1 * torch.randn(c, device=dev, generator=gen)
  w = torch.randn(9, c, c, device=dev, generator=gen) / (9 * c) ** 0.5
  cb = 0.1 * torch.randn(c, device=dev, generator=gen)
  name = str(dtype).split('.')[-1]
  res = {}
  for d in (1, 4, 16, 64):
    args = (x, br, g, b, w.to(dtype), cb)
    got = K.cnn_layer(*args, dilation=d)
    want = K.cnn_layer_plain(*args, dilation=d)
    err, rel = compare(f'cnn_layer d={d}', got, want, name)
    ms = median_ms(lambda: K.cnn_layer(*args, dilation=d))
    plain = median_ms(lambda: K.cnn_layer_plain(*args, dilation=d))
    res[d] = (err, rel, ms, plain)
  # ms: the 20 layers of one denoiser forward, dilations (1,1,4,16,64)x4
  es = x.element_size()
  flops = nbytes = 0
  for d, k in CNN_CALLS.items():
    kl = len(live_offsets(9, l, d))
    flops += k * 2 * n * l * kl * c * c
    nbytes += k * ((2 * n * l * c + n * c + kl * c * c) * es + 3 * c * 4)
  calls = CNN_CALLS
  return {'shape': [n, l, c], 'dilations': [1, 4, 16, 64],
          'flops': flops, 'bytes': nbytes,
          'max_abs_err': max(r[0] for r in res.values()),
          'max_rel_err': max(r[1] for r in res.values()),
          'ms': sum(calls[d] * r[2] for d, r in res.items()),
          'plain_ms': sum(calls[d] * r[3] for d, r in res.items()),
          'per_dilation_ms': {str(d): r[2] for d, r in res.items()},
          'per_dilation_plain_ms': {str(d): r[3] for d, r in res.items()}}


def check_gumbel_candidates(gen):
  """B2 at (512, 200, 5), M=10: every draw equal to the plain version's
  on the noise the kernel used, frequencies vs softmax(log_q) by
  chi-square over 8 distinct rows, unmasked tokens copied exactly."""
  import numpy as np
  import torch
  from scipy import stats as sps
  from svdd_tpu_torch.ops import fused_sample as K
  from svdd_tpu_torch.mdlm import gumbel_noise
  b, l, v, m, mask = 512, 200, 5, 10, 4
  table = torch.log_softmax(
      2 * torch.randn(8, v, device='cuda', generator=gen), -1)
  cls = (torch.arange(b * l, device='cuda') % 8).reshape(b, l)
  log_q = table[cls].contiguous()
  x = torch.randint(0, 4, (b, l), device='cuda', generator=gen)
  x = torch.where(torch.rand(b, l, device='cuda', generator=gen) < 0.5,
                  mask, x)
  out, noise = K.gumbel_candidates(log_q, x, m, mask, gen,
                                   return_noise=True)
  # each draw against the plain version on the kernel's own noise: exact
  err = int((out - K.gumbel_candidates_plain(log_q, x, noise, mask))
            .abs().max())
  if err:
    raise AssertionError(f'gumbel_candidates: draws differ from the plain '
                         f'version on the same noise (max abs err {err})')
  keep = (x != mask)[:, None].expand(-1, m, -1)
  if not torch.equal(out[keep], x[:, None].expand(-1, m, -1)[keep]):
    raise AssertionError('gumbel_candidates: unmasked tokens not copied')
  drawn = ~keep
  cls_m = cls[:, None].expand(-1, m, -1)[drawn].cpu().numpy()
  tok = out[drawn].cpu().numpy()
  p = torch.softmax(table.double(), -1).cpu().numpy()
  worst_p, max_dev = 1.0, 0.0
  for k in range(8):
    counts = np.bincount(tok[cls_m == k], minlength=v)
    total = counts.sum()
    pval = sps.chisquare(counts, total * p[k] / p[k].sum()).pvalue
    worst_p = min(worst_p, float(pval))
    max_dev = max(max_dev, float(np.abs(counts / total - p[k]).max()))
  if worst_p < 1e-4:
    raise AssertionError(f'gumbel_candidates: chi-square p {worst_p}')
  ms = median_ms(lambda: K.gumbel_candidates(log_q, x, m, mask, gen))

  def plain():
    noise = gumbel_noise((b, m, l, v), gen, 'cuda')
    return K.gumbel_candidates_plain(log_q, x, noise, mask)
  return {'shape': [b, m, l, v], 'max_abs_err': err,
          'chi2_min_p': worst_p, 'max_freq_dev': max_dev, 'ms': ms,
          'plain_ms': median_ms(plain),
          # one add and compare per candidate lane; log_q and x in, the
          # candidates out
          'flops': b * m * l * v,
          'bytes': b * l * v * 4 + b * l * 4 + b * m * l * 4}


# (L, C) of the six fused pools and the last one of the full tower
POOL_SHAPES = [(200, 768), (100, 768), (50, 896), (25, 1024), (13, 1152),
               (7, 1280)]
LAST_POOL = (4, 1536)
N_CAND = 5120


def _pool_inputs(l, c, dtype, gen):
  import torch
  x = torch.randn(N_CAND, l, c, device='cuda', generator=gen).to(dtype)
  res = torch.randn(N_CAND, l, c, device='cuda', generator=gen).to(dtype)
  w = (2 * torch.eye(c, device='cuda') + torch.randn(
      c, c, device='cuda', generator=gen) / c ** 0.5).to(dtype)
  return x, res, w


def check_attn_pool_im2col(dtype, gen):
  """B3 at the six fused pools of one value forward (B*M = 5120)."""
  import torch
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  errs, ms, plain_ms, flops, nbytes = [], 0.0, 0.0, 0, 0
  for l, c in POOL_SHAPES:
    x, res, w = _pool_inputs(l, c, dtype, gen)
    lh, es = (l + 1) // 2, x.element_size()
    flops += 2 * N_CAND * lh * c * c
    nbytes += ((2 * N_CAND * l * c + c * c
                + N_CAND * lh * len(live_offsets(5, lh)) * c) * es + 2 * c * 4)
    scale = 1 + 0.2 * torch.randn(c, device='cuda', generator=gen)
    shift = 0.2 * torch.randn(c, device='cuda', generator=gen)
    args = (x, w, scale, shift, 5, 'gelu_enformer', res)
    got = K.pool_prologue_im2col(*args)
    want = K.pool_prologue_im2col_plain(*args)
    errs.append(compare(f'attn_pool_prologue_im2col L={l} C={c}', got,
                        want, name))
    del got, want
    ms += median_ms(lambda: K.pool_prologue_im2col(*args), iters=3)
    plain_ms += median_ms(lambda: K.pool_prologue_im2col_plain(*args),
                          iters=3)
    del x, res, w
    torch.cuda.empty_cache()
  return {'shapes': [[N_CAND, l, c] for l, c in POOL_SHAPES],
          'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          'ms': ms, 'plain_ms': plain_ms, 'flops': flops, 'bytes': nbytes}


def check_attn_pool(dtype, gen):
  """B4 at the last tower pool (5120, 4, 1536) with its residual."""
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  x, res, w = _pool_inputs(*LAST_POOL, dtype, gen)
  err, rel = compare('attn_pool', K.attn_pool(x, w, res),
                     K.attn_pool_plain(x, w, res), name)
  (l, c), lh, es = LAST_POOL, (LAST_POOL[0] + 1) // 2, x.element_size()
  return {'shape': [N_CAND, *LAST_POOL], 'max_abs_err': err,
          'max_rel_err': rel, 'flops': 2 * N_CAND * lh * c * c,
          'bytes': (2 * N_CAND * l * c + N_CAND * lh * c + c * c) * es,
          'ms': median_ms(lambda: K.attn_pool(x, w, res), iters=10),
          'plain_ms': median_ms(lambda: K.attn_pool_plain(x, w, res),
                                iters=10)}


def check_attn_l2(dtype, gen):
  """B5 at (5120, 2, 8 heads x (64 | 192)): one of 11 calls."""
  import torch
  from svdd_tpu_torch.ops import attn_l2 as K
  name = str(dtype).split('.')[-1]
  h, dk, dv = 8, 64, 192
  r = lambda *s: torch.randn(*s, device='cuda', generator=gen)
  q = (r(N_CAND, 2, h * dk) / 8).to(dtype)
  k, v = r(N_CAND, 2, h * dk).to(dtype), r(N_CAND, 2, h * dv).to(dtype)
  bc, bp, relk = r(h * dk).to(dtype), r(h * dk).to(dtype), r(3, h * dk).to(
      dtype)
  args = (q, k, v, bc, bp, relk, h)
  out, w = K.attn_l2(*args)
  out_p, w_p = K.attn_l2_plain(*args)
  errs = (compare('attn_l2 out', out, out_p, name),
          compare('attn_l2 w', w, w_p, 'float32'
                  if dtype == torch.float32 else name))
  es = q.element_size()
  return {'shape': [N_CAND, 2, h * dk, h * dv],
          'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          # per query: two logit terms per dk lane, a blend per dv lane
          'flops': N_CAND * 2 * h * (6 * dk + 3 * dv),
          'bytes': (N_CAND * 2 * h * (2 * dk + 2 * dv) + 5 * h * dk) * es
                   + N_CAND * 2 * h * 4,
          'ms': median_ms(lambda: K.attn_l2(*args), iters=10),
          'plain_ms': median_ms(lambda: K.attn_l2_plain(*args), iters=10)}


def check_cnn_layer_bwd(dtype, gen):
  """B6 at the DPS shape (512, 200, 128), all four dilations. The kernel
  reports the relu mask it rebuilt (the forward kernel's) and the plain
  version runs on that mask; every element where it differs from the
  plain version's own mask must have a plain conv output within rounding
  of 0 (MASK_EDGE)."""
  import torch
  from svdd_tpu_torch.ops import cnn_layer as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  n, l, c = 512, 200, 128
  r = lambda *s: torch.randn(*s, device='cuda', generator=gen)
  x, br, ct = r(n, l, c).to(dtype), r(n, c).to(dtype), r(n, l, c).to(dtype)
  g, b, cb = 1 + 0.1 * r(c), 0.1 * r(c), 0.1 * r(c)
  w = (r(9, c, c) / (9 * c) ** 0.5).to(dtype)
  name = str(dtype).split('.')[-1]
  names = ('dx', 'dbias_row', 'dln_scale', 'dln_bias', 'dkernel',
           'dconv_bias')
  args = (x, br, g, b, w, cb, ct)
  res, flips, flops, nbytes = {}, 0, 0, 0
  es = x.element_size()
  for d in (1, 4, 16, 64):
    *got, mask = K.cnn_layer_bwd(*args, dilation=d, return_mask=True)
    want = K.cnn_layer_bwd_plain(*args, dilation=d, mask=mask)
    y = K.relu_input_plain(*args[:6], dilation=d)
    differ = mask != (y > 0)
    flips += int(differ.sum())
    if differ.any() and float(y[differ].abs().max()) > MASK_EDGE[name]:
      raise AssertionError(f'cnn_layer_bwd d={d} {name}: the kernel relu '
                           f'mask differs where |y| = '
                           f'{float(y[differ].abs().max())}')
    errs = [compare(f'cnn_layer_bwd d={d} dx', got[0], want[0], name)]
    errs += [compare_sum(f'cnn_layer_bwd d={d} {nm}', gt, wt, name)
             for nm, gt, wt in zip(names[1:], got[1:], want[1:])]
    del got, want, mask, y, differ
    ms = median_ms(lambda: K.cnn_layer_bwd(*args, dilation=d))
    plain = median_ms(lambda: K.cnn_layer_bwd_plain(*args, dilation=d),
                      iters=3)
    res[d] = (max(e[0] for e in errs), max(e[1] for e in errs), ms, plain)
    kl = len(live_offsets(9, l, d))
    # recompute, dgrad and wgrad; x, ct in, dx out, the weights in and
    # their gradient out, bias_row in and its gradient out
    flops += CNN_CALLS[d] * 3 * 2 * n * l * kl * c * c
    nbytes += CNN_CALLS[d] * (3 * n * l * c * es + kl * c * c * (es + 4)
                              + n * c * (es + 4))
    torch.cuda.empty_cache()
  return {'shape': [n, l, c], 'dilations': [1, 4, 16, 64],
          'max_abs_err': max(r_[0] for r_ in res.values()),
          'max_rel_err': max(r_[1] for r_ in res.values()),
          'mask_flips': flips,
          # ms: one backward of the 20 layers of the denoiser
          'ms': sum(CNN_CALLS[d] * r_[2] for d, r_ in res.items()),
          'plain_ms': sum(CNN_CALLS[d] * r_[3] for d, r_ in res.items()),
          'per_dilation_ms': {str(d): r_[2] for d, r_ in res.items()},
          'per_dilation_plain_ms': {str(d): r_[3] for d, r_ in res.items()},
          'flops': flops, 'bytes': nbytes, 'library_ms': None}


# (L, Cin, Cout) of the six k=5 tower convs at L=200, and the (L, C) of
# the seven tower pools; the guided decoders take their gradients at
# N = B = 512
TOWER_CONVS = [(100, 768, 768), (50, 768, 896), (25, 896, 1024),
               (13, 1024, 1152), (7, 1152, 1280), (4, 1280, 1536)]
TOWER_POOLS = [(200, 768)] + POOL_SHAPES[1:] + [LAST_POOL]
N_GRAD = 512


def check_conv1d_bwd(dtype, gen):
  """B7 at the six k=5 tower convs, against the plain version and timed
  beside aten.convolution_backward (dgrad and wgrad in one call)."""
  import torch
  from svdd_tpu_torch.ops import conv1d as K
  name = str(dtype).split('.')[-1]
  n = N_GRAD
  errs, ms, plain_ms, lib_ms, flops, nbytes = [], 0.0, 0.0, 0.0, 0, 0
  for l, cin, cout in TOWER_CONVS:
    r = lambda *s: torch.randn(*s, device='cuda', generator=gen)
    x, ct = r(n, l, cin).to(dtype), r(n, l, cout).to(dtype)
    w = (r(5, cin, cout) / (5 * cin) ** 0.5).to(dtype)
    dx, dw = K.conv1d_bwd(x, w, ct)
    want_dx, want_dw = K.conv1d_bwd_plain(x, w, ct)
    errs += [compare(f'conv1d_bwd L={l} {cin}->{cout} dx', dx, want_dx, name),
             compare_sum(f'conv1d_bwd L={l} {cin}->{cout} dkernel', dw,
                         want_dw, name)]
    del dx, dw, want_dx, want_dw
    x_ncl, ct_ncl = x.transpose(1, 2).contiguous(), ct.transpose(1, 2).contiguous()
    w_oik = w.permute(2, 1, 0).contiguous()
    library = lambda: torch.ops.aten.convolution_backward(
        ct_ncl, x_ncl, w_oik, None, [1], [2], [1], False, [0], 1,
        [True, True, False])
    ms += median_ms(lambda: K.conv1d_bwd(x, w, ct))
    plain_ms += median_ms(lambda: K.conv1d_bwd_plain(x, w, ct), iters=3)
    lib_ms += median_ms(library)
    es = x.element_size()
    flops += 2 * 2 * n * l * 5 * cin * cout
    nbytes += (2 * n * l * cin + n * l * cout) * es + 5 * cin * cout * (es + 4)
    del x, ct, w, x_ncl, ct_ncl, w_oik
    torch.cuda.empty_cache()
  return {'shapes': [[n, l, cin, cout] for l, cin, cout in TOWER_CONVS],
          'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          # ms: the six tower convs of one value-net backward
          'ms': ms, 'plain_ms': plain_ms, 'library_ms': lib_ms,
          'library': 'torch.ops.aten.convolution_backward',
          'flops': flops, 'bytes': nbytes}


def check_attn_pool_bwd(dtype, gen):
  """B8 at the seven tower pools with their residuals (odd lengths 25,
  13 and 7 among them), against the plain version."""
  import torch
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  n = N_GRAD
  errs, ms, plain_ms, flops, nbytes = [], 0.0, 0.0, 0, 0
  for l, c in TOWER_POOLS:
    lh = (l + 1) // 2
    x = torch.randn(n, l, c, device='cuda', generator=gen).to(dtype)
    res = torch.randn(n, l, c, device='cuda', generator=gen).to(dtype)
    w = (2 * torch.eye(c, device='cuda') + torch.randn(
        c, c, device='cuda', generator=gen) / c ** 0.5).to(dtype)
    ct = torch.randn(n, lh, c, device='cuda', generator=gen).to(dtype)
    dx, dw = K.attn_pool_bwd(x, w, ct, res)
    want_dx, want_dw = K.attn_pool_bwd_plain(x, w, ct, res)
    errs += [compare(f'attn_pool_bwd L={l} C={c} dx', dx, want_dx, name),
             compare_sum(f'attn_pool_bwd L={l} C={c} dW', dw, want_dw, name)]
    del dx, dw, want_dx, want_dw
    ms += median_ms(lambda: K.attn_pool_bwd(x, w, ct, res))
    plain_ms += median_ms(lambda: K.attn_pool_bwd_plain(x, w, ct, res),
                          iters=3)
    es = x.element_size()
    # the logits recomputed, the dgrad and the wgrad; x, residual, ct and
    # W in, dx and dW out
    flops += 3 * 2 * n * lh * c * c
    nbytes += (3 * n * l * c + n * lh * c + c * c) * es + c * c * 4
    del x, res, w, ct
    torch.cuda.empty_cache()
  return {'shapes': [[n, l, c] for l, c in TOWER_POOLS],
          'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          # ms: the seven pools of one value-net backward
          'ms': ms, 'plain_ms': plain_ms, 'library_ms': None,
          'flops': flops, 'bytes': nbytes}


# ---------------------------------------------------------------------------
# phase 3: full-width models, card vs CPU
# ---------------------------------------------------------------------------


def check_models(gen_seed: int = 0):
  """The full-width denoiser (8 rows) and value net (4 candidates) on the
  card through the kernels, against the plain path on the CPU with the
  same weights. Whole models sum in other orders on each side: 1e-3."""
  import torch
  from svdd_tpu_torch import mdlm
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  cfg = dna_config()
  den = Diffusion(cfg, device='cuda')
  val = EnformerValueModel(
      generator=torch.Generator('cuda').manual_seed(1)).cuda().eval()
  g = torch.Generator().manual_seed(gen_seed)
  x = torch.randint(0, 5, (8, cfg.model.length), generator=g)
  sigma = torch.zeros(8)
  with torch.inference_mode():
    lp_gpu = den.forward(x.cuda(), sigma.cuda()).cpu()
    v_gpu = val(mdlm.transform_samples(x[:4]).cuda()).cpu()
    den.backbone.cpu()
    val.cpu()
    den.device = torch.device('cpu')
    lp_cpu = den.forward(x, sigma)
    v_cpu = val(mdlm.transform_samples(x[:4]))
  finite = torch.isfinite(lp_gpu) | (lp_gpu == mdlm.NEG_INFINITY)
  if not finite.all():
    raise AssertionError('denoiser: non-finite log-probs')
  tol = dict(rtol=1e-3, atol=1e-3)
  if not torch.allclose(lp_gpu, lp_cpu, **tol):
    raise AssertionError(f'denoiser card vs cpu: max abs err '
                         f'{float((lp_gpu - lp_cpu).abs().max())}')
  if not torch.allclose(v_gpu, v_cpu, rtol=1e-3,
                        atol=1e-3 * float(v_cpu.abs().max())):
    raise AssertionError(f'value net card vs cpu: {v_gpu} vs {v_cpu}')
  return {'denoiser_max_abs_err': float((lp_gpu - lp_cpu).abs().max()),
          'value_gpu': v_gpu.tolist(), 'value_cpu': v_cpu.tolist()}


def check_model_grads():
  """The input gradients the guided decoders take, on 8 rows of the
  full-width models: the value net's through its differentiable tower
  (classifier guidance) and the DPS gradient of a fixed linear reward
  through the denoiser's one-hot path, the kernels on the card against
  the plain path on the CPU with the same weights. Whole backward passes
  sum in other orders on each side: 1e-3 of the largest gradient."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  from svdd_tpu_torch.sampling import guidance
  cfg = dna_config()
  den = Diffusion(cfg, device='cuda')
  val = EnformerValueModel(
      generator=torch.Generator('cuda').manual_seed(1)).cuda().eval()
  g = torch.Generator().manual_seed(2)
  x = torch.randint(0, 5, (8, cfg.model.length), generator=g)
  w = torch.randn(cfg.model.length, 4, generator=g)
  sigma = torch.zeros(8)

  def grads(dev):
    wd = w.to(dev)
    reward = lambda p: (p * wd).sum(dim=(-1, -2))
    gv = guidance.classifier_gradient(lambda oh: val(oh, fused=False),
                                      x.to(dev))
    gd = guidance.dps_gradient(den.forward_onehot, reward, x.to(dev),
                               sigma.to(dev), cfg.mask_index)
    return gv.cpu(), gd.cpu()

  _build.reset_launches()
  gv_gpu, gd_gpu = grads('cuda')
  torch.cuda.synchronize()
  launches = _build.launches()
  need = set(PATH_KERNELS['dps'] + PATH_KERNELS['classifier'])
  missing = [k for k in sorted(need) if launches[k] == 0]
  if missing:
    raise AssertionError(f'gradients never launched {missing}')
  den.backbone.cpu()
  den.device = torch.device('cpu')
  val.cpu()
  gv_cpu, gd_cpu = grads('cpu')
  out = {}
  for name, got, want in (('value_grad', gv_gpu, gv_cpu),
                          ('dps_grad', gd_gpu, gd_cpu)):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if scale == 0 or not torch.isfinite(got).all() or not torch.allclose(
        got, want, rtol=1e-3, atol=1e-3 * scale):
      raise AssertionError(f'{name} card vs cpu: max abs err {err}, '
                           f'max |cpu| {scale}')
    out[f'{name}_max_abs_err'] = err
    out[f'{name}_max_abs'] = scale
  out['launches'] = {k: launches[k] for k in sorted(need)}
  return out


# ---------------------------------------------------------------------------
# phase 4: the decode
# ---------------------------------------------------------------------------


DECODE_STEPS = 128


def run_decode(algo: str):
  """One decode through its CLI's ``run``: B=512, 128 steps, L=200,
  float32, --skip_best_of_n; the launch counts are set to 0 just before
  and read just after, and every kernel of the path must have run."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  from svdd_tpu_torch.cli import decode_classfier, decode_DPS
  run, parser, suffix = {
      'svdd_mc': (cli_decode.run, common.make_parser('chip smoke'), ''),
      'dps': (decode_DPS.run, decode_DPS.parser(), decode_DPS.NPZ_SUFFIX),
      'classifier': (decode_classfier.run, decode_classfier.parser(),
                     decode_classfier.NPZ_SUFFIX),
  }[algo]
  out_dir = os.path.join(REPO, 'build', 'chip_smoke')
  argv = ['--task', 'dna', '--batch_size', '512', '--skip_best_of_n',
          '--device', 'cuda', '--num_steps', str(DECODE_STEPS),
          '--out_dir', out_dir, '--run_name', f'chip_smoke_{algo}']
  if algo == 'svdd_mc':
    argv += ['--sample_M', '10']
  args = parser.parse_args(argv)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  report = run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  missing = [k for k in PATH_KERNELS[algo] if launches[k] == 0]
  if missing:
    raise AssertionError(f'{algo} decode never launched {missing}')
  d = np.load(common.npz_path(args, suffix))
  if set(d.files) != {'decoding', 'baseline'}:
    raise AssertionError(f'npz keys {d.files}')
  for key in d.files:
    if d[key].shape != (512,) or not np.isfinite(d[key]).all():
      raise AssertionError(f'npz {key}: shape {d[key].shape} or '
                           'non-finite values')
  out = {'algo': algo, 'task': 'dna', 'batch_size': 512, 'length': 200,
         'steps': DECODE_STEPS, 'npz': os.path.basename(
             common.npz_path(args, suffix))}
  if algo == 'svdd_mc':
    out['sample_M'] = 10
  else:
    out['guidance_scale'] = args.guidance_scale
  out.update({'wall_s': wall,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
              'guided_reward_mean': report['decoding']['mean'],
              'baseline_reward_mean': report['baseline']['mean'],
              'launches': launches, 'npz_keys': sorted(d.files)})
  return out


# ---------------------------------------------------------------------------
# phase 5: where the time of one guided step goes
# ---------------------------------------------------------------------------

# kernel name fragment -> kind, first match wins
KINDS = (('cnn_layer_kernel', 'cnn_layer'), ('cnn_bwd_', 'cnn_layer_bwd'),
         ('conv_bwd_', 'conv1d_bwd'), ('pool_bwd_', 'attn_pool_bwd'),
         ('reduce_partials', 'bwd_partial_sums'), ('attn_pool', 'attn_pool'),
         ('attn_l2', 'attn_l2'), ('gumbel_candidates', 'gumbel_candidates'),
         ('gemm', 'gemm'), ('fprop', 'conv'), ('dgrad', 'conv'),
         ('wgrad', 'conv'), ('conv', 'conv'),
         ('memcpy', 'memcpy_memset'), ('memset', 'memcpy_memset'))


def _kind(name: str) -> str:
  low = name.lower()
  return next((k for frag, k in KINDS if frag in low), 'other')


def profile_step(algo: str):
  """One step of a decode at its shapes (B=512, L=200, M=10 for SVDD-MC,
  the same models) under torch.profiler, from the all-MASK prior at
  t=0.5. host_step_ms: mean host time of 3 synchronised steps after a
  warm-up, unprofiled. device_busy_ms: the union of the card's kernel
  and copy intervals in the profiled step; idle_share = 1 -
  device_busy_ms / profiled_step_ms (host time of the profiled step, to
  its synchronize). by_kind_ms: summed kernel time by kind ('other' is
  PyTorch's elementwise and reduction glue, 'conv' and 'gemm' the
  library's convolutions and matrix products)."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  from svdd_tpu_torch import mdlm
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.sampling import guidance
  args = common.make_parser('chip smoke').parse_args(
      ['--task', 'dna', '--batch_size', '512', '--sample_M', '10',
       '--device', 'cuda'])
  cfg = common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  if algo == 'svdd_mc':
    vf = common.load_value_function(args, cfg)
    step = guidance.svdd_mc_step(diffusion.forward, vf.score_tokens,
                                 diffusion.schedule, cfg.mask_index,
                                 repeats=args.sample_M)
  elif algo == 'dps':
    step = guidance.dps_step(diffusion.forward_onehot,
                             common.load_reward_fn(args, cfg),
                             diffusion.schedule, cfg.mask_index,
                             guidance_scale=1e5)
  else:
    vf = common.load_value_function(args, cfg)
    step = guidance.classifier_step(diffusion.forward, vf.as_onehot_fn(),
                                    diffusion.schedule, cfg.mask_index)
  mode = torch.inference_mode if algo == 'svdd_mc' else torch.no_grad
  gen = torch.Generator('cuda').manual_seed(0)
  x = mdlm.sample_prior((args.batch_size, cfg.model.length),
                        cfg.mask_index, 'cuda')
  t, t_next = torch.tensor(0.5), torch.tensor(0.49)

  def once():
    with mode():
      step(x, t, t_next, gen)
    torch.cuda.synchronize()

  once()
  t0 = time.perf_counter()
  for _ in range(3):
    once()
  host_ms = (time.perf_counter() - t0) / 3 * 1e3
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    once()
    prof_ms = (time.perf_counter() - t0) * 1e3
  dev = [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA]
  spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
  busy_us, end = 0.0, float('-inf')
  for a, b in spans:                   # length of the union of intervals
    if b > end:
      busy_us += b - max(a, end)
      end = b
  by_kind = {}
  for e in dev:
    k = _kind(e.name)
    by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end -
                                        e.time_range.start) / 1e3
  busy_ms = busy_us / 1e3
  return {'algo': algo, 'batch_size': args.batch_size,
          'length': cfg.model.length, 'host_step_ms': host_ms,
          'profiled_step_ms': prof_ms, 'device_events': len(dev),
          'device_busy_ms': busy_ms,
          'idle_share': 1 - busy_ms / prof_ms if dev else None,
          'by_kind_ms': dict(sorted(by_kind.items(),
                                    key=lambda kv: -kv[1]))}


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: no CUDA device; this script checks the '
                     'port on the card and has no CPU path')
  sys.path.insert(0, REPO)
  try:
    from svdd_tpu_torch import _build
  except ImportError as e:
    raise SystemExit(f'chip_smoke: the svdd_tpu_torch package is not '
                     f'beside this script ({e})')

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = nvidia_smi()
  build_s = _build.build()
  torch.cuda.synchronize()
  emit({'phase': 'device', 'nvidia_smi': smi,
        'torch': torch.__version__, 'cuda': torch.version.cuda,
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(), 'nvcc_build_s': build_s})

  gen = torch.Generator('cuda').manual_seed(0)
  results = {}
  checks = [('cnn_layer', check_cnn_layer),
            ('attn_pool_prologue_im2col', check_attn_pool_im2col),
            ('attn_pool', check_attn_pool), ('attn_l2', check_attn_l2),
            ('cnn_layer_bwd', check_cnn_layer_bwd),
            ('conv1d_bwd', check_conv1d_bwd),
            ('attn_pool_bwd', check_attn_pool_bwd)]
  for name, fn in checks:
    for dtype in (torch.float32, torch.bfloat16):
      r = fn(dtype, gen)
      torch.cuda.synchronize()
      torch.cuda.empty_cache()
      dname = str(dtype).split('.')[-1]
      r['bound_ms'], r['bound_by'] = bound(r['flops'], r['bytes'], dname)
      emit({'phase': 'kernel', 'kernel': name, 'dtype': dname, **r})
      results[(name, dname)] = r
  r = check_gumbel_candidates(gen)
  torch.cuda.synchronize()
  r['bound_ms'], r['bound_by'] = bound(r['flops'], r['bytes'])
  emit({'phase': 'kernel', 'kernel': 'gumbel_candidates',
        'dtype': 'float32', **r})
  results[('gumbel_candidates', 'float32')] = r

  r = check_models()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'models', **r})

  r = check_model_grads()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'grads', **r})

  decodes = {}
  for algo in PATH_KERNELS:
    decodes[algo] = run_decode(algo)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'decode', **decodes[algo]})

  for algo in PATH_KERNELS:
    prof = profile_step(algo)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'profile', **prof})

  kernels = []
  for name in _build.KERNELS:
    f32 = results[(name, 'float32')]
    info = KERNEL_INFO[name]
    entry = {'name': name, 'route': 'cuda', 'source': info[0],
             'replaces': info[1],
             'launches': sum(d['launches'][name] for d in decodes.values()),
             'max_abs_err': f32['max_abs_err'], 'ms': f32['ms'],
             'plain_ms': f32['plain_ms'], 'bound_ms': f32['bound_ms'],
             'bound_by': f32['bound_by'],
             'library_ms': f32.get('library_ms')}
    if len(info) > 2:
      entry['also_computes'] = info[2]
    entry['launches_by_decode'] = {a: d['launches'][name]
                                   for a, d in decodes.items()}
    entry.update({k: f32[k] for k in ('chi2_min_p', 'max_freq_dev',
                                      'mask_flips', 'library')
                  if k in f32})
    bf = results.get((name, 'bfloat16'))
    if bf is not None:
      entry.update(max_abs_err_bf16=bf['max_abs_err'], ms_bf16=bf['ms'],
                   plain_ms_bf16=bf['plain_ms'],
                   bound_ms_bf16=bf['bound_ms'])
      if bf.get('library_ms') is not None:
        entry['library_ms_bf16'] = bf['library_ms']
    kernels.append(entry)
  emit({'kernels': kernels})
  print(smi, flush=True)
  emit({'ok': True, 'device': {'platform': 'gpu',
                               'kind': torch.cuda.get_device_name(0),
                               'count': torch.cuda.device_count()}})


if __name__ == '__main__':
  main()
