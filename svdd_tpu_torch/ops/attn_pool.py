"""Pairwise attention pool (pool size 2), alone and fused with the next
conv block's BN affine, activation and im2col, and the pool's backward.

Kernels:
  * ``csrc/attn_pool.cu``, one source for the two forwards:
    ``attn_pool`` replaces
    ``svdd_tpu/ops/attn_pool_pallas.py:attn_pool_wlogits_lnc_pallas``
    (pallas_call :916) and computes the function of
    ``attn_pool_wlogits_pallas`` (:397) as well, since the port keeps
    one (N, L, C) layout; ``pool_prologue_im2col`` replaces
    ``pool_prologue_im2col_wlogits_lnc_pallas`` (pallas_call :1071) and
    likewise computes ``pool_prologue_im2col_wlogits_pallas`` (:721);
  * ``csrc/attn_pool_bwd.cu`` replaces ``attn_pool_wlogits_bwd_pallas``
    (pallas_call :523): dx and dW of the pool (the residual's gradient
    is dx).

``attn_pool`` is differentiable: ``_AttnPool`` runs the forward and
backward kernels on CUDA tensors and the plain pair on CPU tensors. The
fused ``pool_prologue_im2col`` serves the eval forward only; a gradient
takes the unfused tower (``models/enformer.py``).

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
  if l % 2:   # not in place: autograd differentiates this version
    wgt = torch.cat([wgt[:, :-1], torch.ones_like(wgt[:, -1:])], dim=1)
  return x1 + d * wgt


def attn_pool_plain(x, w, residual=None):
  """x (N, L, C), w (C, C), residual like x -> (N, ceil(L/2), C)."""
  return _pooled_f32(x, w, residual).to(x.dtype)


def attn_pool_bwd_plain(x, w, ct, residual=None):
  """Gradients of ``attn_pool_plain`` given ct (N, ceil(L/2), C):
  (dx like x, dW (C, C) f32), by the formulas of
  ``attn_pool_pallas.py:417-423``; the residual's gradient is dx. The
  odd tail row pools alone with weight 1: its dld is 0, its dx is ct."""
  dt = x.dtype
  n, l, c = x.shape
  s = x if residual is None else x + residual
  if l % 2:
    s = F.pad(s, (0, 0, 0, 1))
  d = s[:, 0::2].float() - s[:, 1::2].float()
  dq = d.to(dt).float()
  w32 = w.to(dt).float()
  wgt = torch.sigmoid(torch.matmul(dq, w32))
  ct32 = ct.to(dt).float()
  dld = ct32 * d * wgt * (1.0 - wgt)
  if l % 2:
    wgt[:, -1] = 1.0
    dld[:, -1] = 0.0
  dld = dld.to(dt).float()
  dx0 = ct32 * wgt + torch.matmul(dld, w32.T)
  dx = torch.stack([dx0, ct32 - dx0], dim=2).reshape(n, -1, c)[:, :l]
  dw = dq.reshape(-1, c).T @ dld.reshape(-1, c)
  return dx.to(dt), dw


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


def _attn_pool(x, w, residual=None):
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
  _build.require_aligned('attn_pool', x, w, res)
  out = torch.empty((n, (l + 1) // 2, c), dtype=x.dtype, device=x.device)
  rc = _build.entry('svdd_attn_pool')(
      x.data_ptr(), 0 if res is None else res.data_ptr(), w.data_ptr(),
      out.data_ptr(), n, l, c, _build.dtype_code(x),
      _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool')
  _build.LAUNCHES['attn_pool'] += 1
  return out


def attn_pool_bwd(x, w, ct, residual=None):
  """(dx, dW) through the CUDA kernel (CUDA tensors) or
  ``attn_pool_bwd_plain`` (CPU tensors)."""
  if x.device.type == 'cpu':
    return attn_pool_bwd_plain(x, w, ct, residual)
  _check('attn_pool_bwd', x, w, residual)
  n, l, c = x.shape
  lh = (l + 1) // 2
  if ct.shape != (n, lh, c):
    raise ValueError(f'attn_pool_bwd: ct {tuple(ct.shape)} != '
                     f'{(n, lh, c)}')
  dt = x.dtype
  x = x.contiguous()
  wc = w.to(dt).contiguous()
  wtr = wc.T.contiguous()
  res = None if residual is None else residual.to(dt).contiguous()
  ct = ct.to(dt).contiguous()
  _build.require_cuda('attn_pool_bwd', x, wc, wtr, res, ct)
  _build.require_aligned('attn_pool_bwd', x, wc, wtr, res, ct)
  chunks = _build.row_chunks(n * lh, (c // 128) ** 2)
  dx = torch.empty_like(x)
  dw = torch.empty((c, c), dtype=torch.float32, device=x.device)
  scratch_t = torch.empty(n * lh * c, dtype=dt, device=x.device)
  scratch_f = torch.empty(n * lh * c + chunks * c * c,
                          dtype=torch.float32, device=x.device)
  rc = _build.entry('svdd_attn_pool_bwd')(
      x.data_ptr(), 0 if res is None else res.data_ptr(), wc.data_ptr(),
      wtr.data_ptr(), ct.data_ptr(), dx.data_ptr(), dw.data_ptr(),
      scratch_t.data_ptr(), scratch_f.data_ptr(), n, l, c, chunks,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool_bwd')
  _build.LAUNCHES['attn_pool_bwd'] += 1
  return dx, dw


class _AttnPool(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, w, residual):
    ctx.save_for_backward(x, w, residual)
    return _attn_pool(x, w, residual)

  @staticmethod
  def backward(ctx, ct):
    x, w, residual = ctx.saved_tensors
    dx, dw = attn_pool_bwd(x, w, ct, residual)
    # the blend sees only x + residual: both gradients are dx
    return dx, dw.to(w.dtype), None if residual is None else dx


def attn_pool(x, w, residual=None):
  """The pool through the CUDA kernels (CUDA tensors) or the plain
  versions (CPU tensors); differentiable in x, w and the residual."""
  return _AttnPool.apply(x, w, residual)


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
  _build.require_aligned('pool_prologue_im2col', x, w, res)
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
