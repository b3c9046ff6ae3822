"""Pairwise attention pool (pool size 2), alone and fused with the next
conv block's BN affine, activation and im2col.

Kernels in ``csrc/attn_pool.cu``, one source for both:
  * ``attn_pool`` replaces
    ``svdd_tpu/ops/attn_pool_pallas.py:attn_pool_wlogits_lnc_pallas``
    (pallas_call :916);
  * ``pool_prologue_im2col`` replaces
    ``pool_prologue_im2col_wlogits_lnc_pallas`` (pallas_call :1071).

Math, per pair of rows (x0, x1) of s = x + residual (added in x's
dtype): d = x0 - x1 in f32, logits difference ld = d @ W (d cast to
x's dtype, products summed in f32), out = x1 + d * sigmoid(ld). A
pairwise softmax is exactly this sigmoid blend. An odd length L pools
its last row alone: its weight is forced to 1 and out = x0, the
selection the JAX package makes with a -inf logit pad or ``mask_tail``.
The port keeps the (N, L, C) layout and takes odd L directly, so it
needs neither the TPU's pad slabs (``pad_out``) nor a mask flag.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.kernel_utils import ACT_CODES, act, live_offsets


def _pooled_f32(x, w, residual=None):
  """(N, L, C) -> pooled (N, ceil(L/2), C) in f32."""
  s = x if residual is None else x + residual
  l = s.shape[1]
  if l % 2:
    s = F.pad(s, (0, 0, 0, 1))
  x0 = s[:, 0::2].float()
  x1 = s[:, 1::2].float()
  d = x0 - x1
  ld = torch.matmul(d.to(x.dtype).float(), w.to(x.dtype).float())
  wgt = torch.sigmoid(ld)
  if l % 2:
    wgt[:, -1] = 1.0
  return x1 + d * wgt


def attn_pool_plain(x, w, residual=None):
  """x (N, L, C), w (C, C), residual like x -> (N, ceil(L/2), C)."""
  return _pooled_f32(x, w, residual).to(x.dtype)


def im2col(y, k_taps: int):
  """(N, L, C) -> (N, L, k_live*C): slab j holds y shifted by the j-th
  live offset (zero where it reads outside [0, L))."""
  l = y.shape[1]
  slabs = []
  for off in live_offsets(k_taps, l):
    if off >= 0:
      slabs.append(F.pad(y[:, off:], (0, 0, 0, off)))
    else:
      slabs.append(F.pad(y[:, :l + off], (0, 0, -off, 0)))
  return torch.cat(slabs, dim=-1)


def pool_prologue_im2col_plain(x, w, scale, shift, k_taps: int,
                               act_name, residual=None):
  """pool -> act(pooled * scale + shift) -> im2col, (N, LH, k_live*C)."""
  pooled = _pooled_f32(x, w, residual)
  y = act(act_name, pooled * scale.float() + shift.float()).to(x.dtype)
  return im2col(y, k_taps)


def _check(name, x, w, residual):
  n, l, c = x.shape
  if w.shape != (c, c) or c % 128:
    raise ValueError(f'{name}: needs w (C, C) with C % 128 == 0, got '
                     f'x {tuple(x.shape)} w {tuple(w.shape)}')
  if residual is not None and residual.shape != x.shape:
    raise ValueError(f'{name}: residual {tuple(residual.shape)} != '
                     f'x {tuple(x.shape)}')


def _check_aligned(name, *tensors):
  """The kernel reads 4 channels per load: 16-byte aligned bases."""
  for t in tensors:
    if t is not None and t.data_ptr() % 16:
      raise ValueError(f'{name}: tensors must start 16-byte aligned')


def attn_pool(x, w, residual=None):
  """The pool through the CUDA kernel (CUDA tensors) or the plain
  version (CPU tensors)."""
  if x.device.type == 'cpu':
    return attn_pool_plain(x, w, residual)
  _check('attn_pool', x, w, residual)
  n, l, c = x.shape
  x = x.contiguous()
  w = w.to(x.dtype).contiguous()
  res = None if residual is None else residual.to(x.dtype).contiguous()
  _build.require_cuda('attn_pool', x, w, res)
  _check_aligned('attn_pool', x, w, res)
  out = torch.empty((n, (l + 1) // 2, c), dtype=x.dtype, device=x.device)
  rc = _build.entry('svdd_attn_pool')(
      x.data_ptr(), 0 if res is None else res.data_ptr(), w.data_ptr(),
      out.data_ptr(), n, l, c, _build.dtype_code(x),
      _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool')
  _build.LAUNCHES['attn_pool'] += 1
  return out


def pool_prologue_im2col(x, w, scale, shift, k_taps: int, act_name,
                         residual=None):
  """Pool + BN affine + act + im2col through the CUDA kernel (CUDA
  tensors) or the plain version (CPU tensors)."""
  if x.device.type == 'cpu':
    return pool_prologue_im2col_plain(x, w, scale, shift, k_taps,
                                      act_name, residual)
  _check('pool_prologue_im2col', x, w, residual)
  n, l, c = x.shape
  lh = (l + 1) // 2
  offsets = live_offsets(k_taps, lh)
  x = x.contiguous()
  w = w.to(x.dtype).contiguous()
  res = None if residual is None else residual.to(x.dtype).contiguous()
  scale = scale.float().contiguous()
  shift = shift.float().contiguous()
  _build.require_cuda('pool_prologue_im2col', x, w, res, scale, shift)
  _check_aligned('pool_prologue_im2col', x, w, res)
  out = torch.empty((n, lh, len(offsets) * c), dtype=x.dtype,
                    device=x.device)
  offs = _build.int_array(offsets)
  rc = _build.entry('svdd_attn_pool_im2col')(
      x.data_ptr(), 0 if res is None else res.data_ptr(), w.data_ptr(),
      scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
      ctypes.addressof(offs), len(offsets), ACT_CODES[act_name], n, l, c,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool_im2col')
  _build.LAUNCHES['attn_pool_prologue_im2col'] += 1
  return out
