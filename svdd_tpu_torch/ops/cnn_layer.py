"""Fused CNN denoiser layer: relu(conv(LN(x + bias_row))) + x, and its
backward.

Kernels:
  * ``csrc/cnn_layer.cu`` (B1) replaces
    ``svdd_tpu/ops/cnn_layer_pallas.py:_cnn_layer_pallas_jit``;
  * ``csrc/cnn_layer_bwd.cu`` (B6) replaces ``cnn_layer_bwd_pallas``
    (pallas_call :504).

``cnn_layer`` is differentiable: ``_CNNLayer`` runs both kernels on
CUDA tensors and the plain pair below on CPU tensors.

The plain forward follows ``cnn_layer_reference``: x + bias_row, the
normalised h, the LN scale and bias products, the conv output, the conv
bias add and the residual add are each rounded to the activation type,
with the LN statistics in f32. The forward kernel rounds at the same
points, so in bf16 it differs from the plain version only by the order
of its f32 tap sums (a rounded conv output may land one bf16 ulp
apart). The TPU kernel rounds elsewhere: LN affine in f32 before one
cast, and each tap's product to the activation type
(``cnn_layer_pallas.py:119-124, :149, :169``).

The plain backward follows ``_bwd_kernel`` (``cnn_layer_pallas.py:266``):
the relu mask of the recomputed conv output, the mirrored tap sum and
the per-tap weight gradient of the masked cotangent (rounded to the
activation type, which is exact), and the LayerNorm backward on the f32
normalised rows. The backward kernel rebuilds the mask with the forward
kernel's own code (``csrc/cnn_layer.cuh``), so on the card the mask is
the forward's bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.conv1d import _conv_forward, conv_bwd_f32
from svdd_tpu_torch.ops.kernel_utils import live_offsets, live_taps

TILE_ROWS = 64    # output rows per block of both kernels


def _normalised(x, bias_row, eps: float):
  """(hn, rstd): the f32 normalised rows of T(x + bias_row) and their
  1/std."""
  h32 = (x + bias_row[:, None, :].to(x.dtype)).float()
  mu = h32.mean(-1, keepdim=True)
  var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
  rstd = torch.rsqrt(var + eps)
  return (h32 - mu) * rstd, rstd


def _conv_input(hn, ln_scale, ln_bias, dtype):
  return hn.to(dtype) * ln_scale.to(dtype) + ln_bias.to(dtype)


def relu_input_plain(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
                     dilation: int = 1, eps: float = 1e-6):
  """y, the conv output with its bias, whose sign is the layer's relu
  mask."""
  hn, _ = _normalised(x, bias_row, eps)
  return _conv_forward(_conv_input(hn, ln_scale, ln_bias, x.dtype), kernel,
                       conv_bias, dilation)


def cnn_layer_plain(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
                    dilation: int = 1, eps: float = 1e-6):
  """x (N, L, C); bias_row (N, C); ln_scale/ln_bias/conv_bias (C,);
  kernel (K, C, C) flax layout. SAME padding."""
  return torch.relu(relu_input_plain(x, bias_row, ln_scale, ln_bias, kernel,
                                     conv_bias, dilation, eps)) + x


def cnn_layer_bwd_plain(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
                        ct, dilation: int = 1, eps: float = 1e-6,
                        mask=None):
  """Gradients of ``cnn_layer_plain`` given the output cotangent ct, in
  the order of its arguments, as ``cnn_layer_bwd_pallas`` returns them:
  (dx, dbias_row, dln_scale, dln_bias, dkernel, dconv_bias), each in
  its argument's dtype. ``mask`` (N, L, C), when given, is the relu mask
  in place of this version's own: where a conv output is within
  rounding of 0, the kernel's mask may differ, and the kernel reports
  the one it used (``cnn_layer_bwd(..., return_mask=True)``)."""
  dt = x.dtype
  hn, rstd = _normalised(x, bias_row, eps)
  h = _conv_input(hn, ln_scale, ln_bias, dt)
  if mask is None:
    mask = _conv_forward(h, kernel, conv_bias, dilation) > 0
  ct = ct.to(dt)
  dacc = torch.where(mask.bool(), ct, torch.zeros_like(ct))
  dhs, dkernel = conv_bwd_f32(h, kernel.to(dt), dacc, dilation)
  dacc = dacc.float()
  dhn = dhs * ln_scale.float()
  m1 = dhn.mean(-1, keepdim=True)
  m2 = (dhn * hn).mean(-1, keepdim=True)
  dh0 = rstd * (dhn - m1 - hn * m2)
  return ((dh0.to(dt) + ct),
          dh0.sum(1).to(bias_row.dtype),
          (dhs * hn).sum((0, 1)).to(ln_scale.dtype),
          dhs.sum((0, 1)).to(ln_bias.dtype),
          dkernel.to(kernel.dtype),
          dacc.sum((0, 1)).to(conv_bias.dtype))


def _check(name, x, kernel):
  n, l, c = x.shape
  if kernel.shape[1:] != (c, c) or c != 128:
    raise ValueError(f'{name} kernel takes C=128 square taps, got '
                     f'x {tuple(x.shape)} kernel {tuple(kernel.shape)}')
  # a block holds the sequence and one f32 weight chunk in shared
  # memory, at most 227 KB on an H100
  if l * c * x.element_size() + 16 * c * 4 > 227 * 1024:
    raise ValueError(f'{name} kernel: L={l} does not fit in shared '
                     f'memory for {x.dtype}')


def _cnn_layer(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
               dilation: int, eps: float):
  """The forward through the CUDA kernel (CUDA tensors) or the plain
  version (CPU tensors)."""
  if x.device.type == 'cpu':
    return cnn_layer_plain(x, bias_row, ln_scale, ln_bias, kernel,
                           conv_bias, dilation, eps)
  _check('cnn_layer', x, kernel)
  n, l, c = x.shape
  k_taps = kernel.shape[0]
  offsets = live_offsets(k_taps, l, dilation)
  dt = x.dtype
  x = x.contiguous()
  w = kernel[live_taps(k_taps, l, dilation)].to(dt).contiguous()
  args = (x, bias_row.to(dt).contiguous(),
          ln_scale.float().contiguous(), ln_bias.float().contiguous(),
          w, conv_bias.float().contiguous())
  _build.require_cuda('cnn_layer', *args)
  out = torch.empty_like(x)
  fn = _build.entry('svdd_cnn_layer')
  offs = _build.int_array(offsets)
  rc = fn(*(a.data_ptr() for a in args), out.data_ptr(),
          ctypes.addressof(offs),
          len(offsets), n, l, c, eps, _build.dtype_code(x),
          _build.stream_ptr(x))
  _build.check(rc, 'svdd_cnn_layer')
  _build.LAUNCHES['cnn_layer'] += 1
  return out


def cnn_layer_bwd(x, bias_row, ln_scale, ln_bias, kernel, conv_bias, ct,
                  dilation: int = 1, eps: float = 1e-6, *,
                  return_mask: bool = False):
  """The backward through the CUDA kernel (CUDA tensors) or
  ``cnn_layer_bwd_plain`` (CPU tensors); same outputs. ``return_mask``
  also returns the (N, L, C) relu mask the gradients used (the kernel
  recomputes the forward kernel's, bit for bit), so the kernel can be
  held against the plain version on the same mask."""
  if x.device.type == 'cpu':
    grads = cnn_layer_bwd_plain(x, bias_row, ln_scale, ln_bias, kernel,
                                conv_bias, ct, dilation, eps)
    if not return_mask:
      return grads
    return (*grads, relu_input_plain(x, bias_row, ln_scale, ln_bias,
                                     kernel, conv_bias, dilation, eps) > 0)
  _check('cnn_layer_bwd', x, kernel)
  n, l, c = x.shape
  if ct.shape != x.shape:
    raise ValueError(f'cnn_layer_bwd: ct {tuple(ct.shape)} != '
                     f'x {tuple(x.shape)}')
  k_taps = kernel.shape[0]
  offsets = live_offsets(k_taps, l, dilation)
  taps = live_taps(k_taps, l, dilation)
  k_live = len(offsets)
  dt = x.dtype
  f32 = dict(dtype=torch.float32, device=x.device)
  x = x.contiguous()
  w = kernel[taps].to(dt).contiguous()
  # the dgrad runs the forward's tap loop on flipped, transposed taps
  wt = w.flip(0).transpose(1, 2).contiguous()
  args = (x, bias_row.to(dt).contiguous(),
          ln_scale.float().contiguous(), ln_bias.float().contiguous(),
          w, wt, conv_bias.float().contiguous(), ct.to(dt).contiguous())
  _build.require_cuda('cnn_layer_bwd', *args)
  _build.require_aligned('cnn_layer_bwd', *args)
  tiles = -(-l // TILE_ROWS)
  chunks = _build.row_chunks(n * l, k_live)
  dx = torch.empty_like(x)
  dbr = torch.empty((n, c), **f32)
  dw = torch.empty((k_live, c, c), **f32)
  dg, db, dcb = (torch.empty(c, **f32) for _ in range(3))
  mask = (torch.empty((n, l, c), dtype=torch.uint8, device=x.device)
          if return_mask else None)
  scratch_t = torch.empty(2 * n * l * c, dtype=dt, device=x.device)
  scratch_f = torch.empty(k_live * chunks * c * c + 4 * n * tiles * c,
                          **f32)
  offs = _build.int_array(offsets)
  rc = _build.entry('svdd_cnn_layer_bwd')(
      *(a.data_ptr() for a in args),
      *(o.data_ptr() for o in (dx, dbr, dw, dg, db, dcb)),
      0 if mask is None else mask.data_ptr(), scratch_t.data_ptr(),
      scratch_f.data_ptr(),
      ctypes.addressof(offs), k_live, n, l, c, chunks, eps,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_cnn_layer_bwd')
  _build.LAUNCHES['cnn_layer_bwd'] += 1
  dkernel = torch.zeros(kernel.shape, **f32)
  dkernel[taps] = dw
  grads = (dx, dbr.to(bias_row.dtype), dg.to(ln_scale.dtype),
           db.to(ln_bias.dtype), dkernel.to(kernel.dtype),
           dcb.to(conv_bias.dtype))
  return (*grads, mask.bool()) if return_mask else grads


class _CNNLayer(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
              dilation, eps):
    ctx.save_for_backward(x, bias_row, ln_scale, ln_bias, kernel,
                          conv_bias)
    ctx.dilation, ctx.eps = dilation, eps
    return _cnn_layer(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
                      dilation, eps)

  @staticmethod
  def backward(ctx, ct):
    grads = cnn_layer_bwd(*ctx.saved_tensors, ct, ctx.dilation, ctx.eps)
    return (*grads, None, None)


def cnn_layer(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
              dilation: int = 1, eps: float = 1e-6):
  """The layer through the CUDA kernels for CUDA tensors, through the
  plain versions for CPU tensors; differentiable in every input."""
  return _CNNLayer.apply(x, bias_row, ln_scale, ln_bias, kernel,
                         conv_bias, dilation, eps)
