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

The plain backward follows ``_bwd_kernel`` (``cnn_layer_pallas.py:266``)
where JAX's dispatch takes it, from L = 100 (``pallas_bwd_len_ok``):
the relu mask of the recomputed conv output, the mirrored tap sum and
the per-tap weight gradient of the masked cotangent (rounded to the
activation type, which is exact), and the LayerNorm backward on the f32
normalised rows. Below L = 100 JAX differentiates ``cnn_layer_reference``
instead (``cnn_layer_fused``, ``_fused_bwd``), and in bf16 that VJP
rounds where the reference's bf16 ops round: the tap sum, its products
with the LN scale and with the normalised rows, and the LN input's
gradient, each to the activation type, and the parameter gradients of
the LN scale, LN bias and conv bias (cast to bf16 in the forward) to
bf16 sums. Off the gate (``bwd_rounds_as_reference``) the plain backward
and the backward kernel round there too; the reference sums the taps'
rounded parts, the port rounds their f32 sum once. The backward kernel
rebuilds the mask with the forward kernel's own code
(``csrc/cnn_layer.cuh``), so on the card the mask is the forward's bit
for bit.

Both kernels hold a whole sequence in one block's shared memory
(``kernel_takes``); a CUDA tensor of a longer sequence takes the plain
versions, as ``cnn_layer_fused`` takes ``cnn_layer_reference`` where its
kernel's memory plan does not fit.
"""

from __future__ import annotations

import ctypes

import torch

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.conv1d import _conv_forward, conv_bwd_f32
from svdd_tpu_torch.ops.kernel_utils import live_offsets, live_taps

PASS_ROWS = 240   # output rows per block of both kernels (cnn_layer.cuh)
C = 128           # the channels the kernels are built for
# shared memory of a block (csrc/cnn_layer.cuh smem_bytes): the weight
# ring (2 stages of 8 KB in f32, 3 of 16 KB in bf16), then the sequence
# and one zero row, each row of C values padded by 16 bytes
_RING_BYTES = {torch.float32: 2 * 8192, torch.bfloat16: 3 * 16384}
SMEM_MAX = 232448   # an H100 block's dynamic shared memory
# blocks of the backward's weight-gradient kernel an H100 runs at once
# (two an SM, 132 SMs): its row chunks fill them once, which ran faster
# than two waves, and leaves fewer partial sums to add
WGRAD_SLOTS = 2 * 132


def kernel_takes(l: int, dtype) -> bool:
  """Whether the kernels hold a sequence of ``l`` rows of ``dtype``: the
  shared-memory plan of ``csrc/cnn_layer.cuh`` (``smem_bytes``), up to
  L = 408 in float32 and 672 in bfloat16. A longer sequence takes the
  plain versions, as ``svdd_tpu``'s ``cnn_layer_fused`` takes
  ``cnn_layer_reference`` where ``_pick_tile_n(...) == 0``
  (``svdd_tpu/ops/cnn_layer_pallas.py:662-670``). Raises for a dtype the
  kernels are not built for."""
  if dtype not in _RING_BYTES:
    raise TypeError(f'cnn_layer kernels take float32 or bfloat16, got '
                    f'{dtype}')
  row = C * torch.empty((), dtype=dtype).element_size() + 16
  return _RING_BYTES[dtype] + (l + 1) * row <= SMEM_MAX


# JAX's backward takes the Pallas kernel from this length on, the VJP of
# cnn_layer_reference below it (cnn_layer_pallas.py:_PALLAS_BWD_MIN_L)
PALLAS_BWD_MIN_L = 100


def bwd_rounds_as_reference(l: int) -> bool:
  """Whether the backward of a sequence of ``l`` rows rounds as the VJP of
  ``cnn_layer_reference`` (module docstring), as JAX's dispatch takes
  that VJP below ``pallas_bwd_len_ok``'s length (L = 50, the RNA task);
  else as ``_bwd_kernel``. The two differ in bf16 only: in float32 every
  rounding to the activation type is exact."""
  return l < PALLAS_BWD_MIN_L


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
                    dilation: int = 1, eps: float = 1e-6, residual=None):
  """x (N, L, C); bias_row (N, C); ln_scale/ln_bias/conv_bias (C,);
  kernel (K, C, C) flax layout. SAME padding. ``residual`` (x's shape)
  replaces x in the residual add: training with dropout passes the
  undropped activations (``cnn_layer_reference``'s ``residual``)."""
  return torch.relu(relu_input_plain(x, bias_row, ln_scale, ln_bias, kernel,
                                     conv_bias, dilation, eps)) + (
                                         x if residual is None else residual)


def cnn_layer_bwd_plain(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
                        ct, dilation: int = 1, eps: float = 1e-6,
                        mask=None):
  """Gradients of ``cnn_layer_plain`` given the output cotangent ct, in
  the order of its arguments, as ``cnn_layer_bwd_pallas`` returns them:
  (dx, dbias_row, dln_scale, dln_bias, dkernel, dconv_bias), each in
  its argument's dtype. ``mask`` (N, L, C), when given, is the relu mask
  in place of this version's own: where a conv output is within
  rounding of 0, the kernel's mask may differ, and the kernel reports
  the one it used (``cnn_layer_bwd(..., return_mask=True)``). Below
  ``PALLAS_BWD_MIN_L`` rows it rounds as ``bwd_rounds_as_reference``
  says."""
  dt = x.dtype
  hn, rstd = _normalised(x, bias_row, eps)
  h = _conv_input(hn, ln_scale, ln_bias, dt)
  if mask is None:
    mask = _conv_forward(h, kernel, conv_bias, dilation) > 0
  ct = ct.to(dt)
  dacc = torch.where(mask.bool(), ct, torch.zeros_like(ct))
  dhs, dkernel = conv_bwd_f32(h, kernel.to(dt), dacc, dilation)
  dacc = dacc.float()
  # the reference VJP's roundings (identities in f32)
  r = ((lambda a: a.to(dt).float())
       if bwd_rounds_as_reference(x.shape[1]) else (lambda a: a))
  dhs = r(dhs)
  dhn = r(dhs * r(ln_scale.float()))
  m1 = dhn.mean(-1, keepdim=True)
  m2 = (dhn * hn).mean(-1, keepdim=True)
  dh0 = rstd * (dhn - m1 - hn * m2)
  return ((dh0.to(dt) + ct),
          r(r(dh0).sum(1)).to(bias_row.dtype),
          r(r(dhs * r(hn)).sum((0, 1))).to(ln_scale.dtype),
          r(dhs.sum((0, 1))).to(ln_bias.dtype),
          dkernel.to(kernel.dtype),
          r(dacc.sum((0, 1))).to(conv_bias.dtype))


def _plain(x) -> bool:
  """Whether x takes the plain versions: a CPU tensor, or a sequence
  longer than a block holds (``kernel_takes``). Any other tensor
  launches the kernels or raises."""
  return x.device.type == 'cpu' or not kernel_takes(x.shape[1], x.dtype)


def _check(name, x, kernel):
  c = x.shape[-1]
  if kernel.shape[1:] != (c, c) or c != C:
    raise ValueError(f'{name} kernel takes C={C} square taps, got '
                     f'x {tuple(x.shape)} kernel {tuple(kernel.shape)}')


def _cnn_layer(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
               dilation: int, eps: float):
  """The forward through the CUDA kernel, or the plain version (CPU
  tensors, sequences past ``kernel_takes``)."""
  if _plain(x):
    return cnn_layer_plain(x, bias_row, ln_scale, ln_bias, kernel,
                           conv_bias, dilation, eps)
  _check('cnn_layer', x, kernel)
  n, l, c = x.shape
  k_taps = kernel.shape[0]
  offsets = live_offsets(k_taps, l, dilation)
  dt = x.dtype
  x = x.contiguous()
  # each live tap transposed to [out][in]: the mma's B operand by rows
  w = kernel[live_taps(k_taps, l, dilation)].to(dt).transpose(1, 2)
  args = (x, bias_row.to(dt).contiguous(),
          ln_scale.float().contiguous(), ln_bias.float().contiguous(),
          w.contiguous(), conv_bias.float().contiguous())
  _build.require_cuda('cnn_layer', *args)
  _build.require_aligned('cnn_layer', *args)
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
  """The backward through the CUDA kernel, or ``cnn_layer_bwd_plain``
  (CPU tensors, sequences past ``kernel_takes``); same outputs.
  ``return_mask`` also returns the (N, L, C) relu mask the gradients used
  (the kernel recomputes the forward kernel's, bit for bit), so the
  kernel can be held against the plain version on the same mask. Both
  round as ``bwd_rounds_as_reference`` says for the sequence's length."""
  if _plain(x):
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
  ref = bwd_rounds_as_reference(l)
  f32 = dict(dtype=torch.float32, device=x.device)
  x = x.contiguous()
  w = kernel[taps].to(dt)
  # the mask pass takes the forward's transposed taps; the dgrad runs the
  # same routine on the flipped stack, whose transposed taps are the
  # untransposed weights
  args = (x, bias_row.to(dt).contiguous(),
          ln_scale.float().contiguous(), ln_bias.float().contiguous(),
          w.transpose(1, 2).contiguous(), w.flip(0).contiguous(),
          conv_bias.float().contiguous(), ct.to(dt).contiguous())
  _build.require_cuda('cnn_layer_bwd', *args)
  _build.require_aligned('cnn_layer_bwd', *args)
  tiles = -(-l // PASS_ROWS)
  chunks = max(1, min(WGRAD_SLOTS // k_live, n * l // 256))
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
      int(ref), _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_cnn_layer_bwd')
  _build.LAUNCHES['cnn_layer_bwd'] += 1
  dkernel = torch.zeros(kernel.shape, **f32)
  dkernel[taps] = dw
  # the reference VJP's sums are in T (bwd_rounds_as_reference)
  r = (lambda a: a.to(dt)) if ref else (lambda a: a)
  grads = (dx, r(dbr).to(bias_row.dtype), r(dg).to(ln_scale.dtype),
           r(db).to(ln_bias.dtype), dkernel.to(kernel.dtype),
           r(dcb).to(conv_bias.dtype))
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
  """The layer through the CUDA kernels for CUDA tensors whose sequence
  a block holds (``kernel_takes``), through the plain versions
  otherwise; differentiable in every input."""
  return _CNNLayer.apply(x, bias_row, ln_scale, ln_bias, kernel,
                         conv_bias, dilation, eps)
