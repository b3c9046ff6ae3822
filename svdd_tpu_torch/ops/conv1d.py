"""SAME-padded dilated 1-D convolution (``svdd_tpu/ops/conv1d.py``) and
its backward.

The forward is ``F.conv1d`` with padding half * dilation, exact against
the JAX dead-tap rule: a tap whose |offset| >= L reads only zero
padding and adds nothing. The JAX package leaves the conv forward to
XLA as well (``conv1d_bwd_pallas.py:27-31``).

Backward kernel: ``csrc/conv1d_bwd.cu``, which replaces
``svdd_tpu/ops/conv1d_bwd_pallas.py:conv1d_bwd_pallas`` (pallas_call
:141): dgrad and wgrad of the live taps on the tensor cores (bf16 mma,
f32 as 3xTF32), dead taps getting zero gradients. A conv whose shape
passes ``conv_bwd_ok`` and that autograd records runs through
``_ConvShifted``, whose backward is that kernel on CUDA tensors and
``conv1d_bwd_plain`` on CPU tensors; every other recorded conv through
``_ConvPlainBwd``, products over the live taps summed in a fixed order
on any device, as the JAX package leaves those shapes to XLA (cuDNN's weight
gradient sums with atomics, so two runs would differ). The bias
gradient is PyTorch's reduction in both cases (``conv1d.py:43-46``).

``conv1d_prologue`` is the prologue route of the JAX ``Conv1D``
(``conv1d.py:238-256``): conv(act(x * scale + shift)) + bias at
dilation 1 through kernel B11c and one product (``ops/im2col.py``), or
through kernel B14 (``ops/fused_conv.py``) when
``SVDD_PALLAS_FUSED_CONV=1``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.fused_conv import fused_conv1d, use_pallas_fused_conv
from svdd_tpu_torch.ops.im2col import nacdr_conv1d
from svdd_tpu_torch.ops.kernel_utils import live_offsets, live_taps


def conv_bwd_ok(length: int, c_in: int, c_out: int, k_taps: int,
                dilation: int = 1) -> bool:
  """The one shape rule of the backward kernel: more than one live tap
  (a k=1 conv's backward is two plain matmuls, the JAX gate's own
  reason, ``conv1d_bwd_pallas.py:178-184``) and channel counts that are
  multiples of 128 (the kernel's 128-wide output tiles). Every k=5 conv
  of the value tower passes; its k=15 stem from 4 channels and the
  denoiser's stem from 5 do not, as in the JAX package."""
  return (len(live_offsets(k_taps, length, dilation)) > 1
          and c_in % 128 == 0 and c_out % 128 == 0)


def _conv_forward(x, kernel, bias, dilation: int):
  """The conv, then the bias: in bf16 the conv is rounded before the
  bias is added in bf16, as the JAX package adds it."""
  k_taps = kernel.shape[0]
  w = kernel.to(x.dtype).permute(2, 1, 0)               # (Cout, Cin, K)
  late_bias = bias is not None and x.dtype == torch.bfloat16
  out = F.conv1d(x.transpose(1, 2), w,
                 None if bias is None or late_bias else bias.to(x.dtype),
                 padding=(k_taps - 1) // 2 * dilation, dilation=dilation)
  out = out.transpose(1, 2)
  return out + bias.to(x.dtype) if late_bias else out


def _shifted(a: torch.Tensor, off: int) -> torch.Tensor:
  """out[:, i] = a[:, i + off], zero where i + off is outside [0, L)."""
  if off > 0:
    return F.pad(a[:, off:], (0, 0, 0, off))
  if off < 0:
    return F.pad(a[:, :off], (0, 0, -off, 0))
  return a


def conv_bwd_f32(x, kernel, ct, dilation: int = 1):
  """(dx, dkernel) in f32 for y = conv(x, kernel): per live tap,
  dx += shift(ct @ W_t^T, -off_t) and dW_t = shift(x, off_t)^T @ ct,
  every product of the inputs' values summed in f32. Dead taps keep
  zero rows of dkernel."""
  n, l, c_in = x.shape
  k_taps, _, c_out = kernel.shape
  half = (k_taps - 1) // 2 * dilation
  x32, ct32 = x.float(), ct.float()
  w32 = kernel.float()
  dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
  dw = torch.zeros(kernel.shape, dtype=torch.float32, device=x.device)
  for off in live_offsets(k_taps, l, dilation):
    k = (off + half) // dilation
    dx += _shifted(ct32 @ w32[k].T, -off)
    dw[k] = (_shifted(x32, off).reshape(-1, c_in).T
             @ ct32.reshape(-1, c_out))
  return dx, dw


def conv_bwd_taps_f32(x, kernel, ct, dilation: int = 1,
                      need_dx: bool = True, need_dw: bool = True):
  """``conv_bwd_f32``'s (dx, dkernel) in a few launches, the cotangent
  read once for each: dx sums, over the live taps, the tap slices of
  one product ct @ [W_t^T]_t, each read at its shift through a strided
  view of the product padded once; dW is one product of x's shifted
  copies (a strided view of x padded once) with ct. Sums in a fixed
  order on any device. A gradient not ``need``ed is None."""
  n, l, c_in = x.shape
  k_taps, _, c_out = kernel.shape
  offs = live_offsets(k_taps, l, dilation)
  taps = live_taps(k_taps, l, dilation)
  k_live, lo, hi = len(offs), offs[0], offs[-1]
  ct32 = ct.float().reshape(-1, c_out)
  dx = dw = None
  if need_dx:
    w = kernel[taps].float().permute(2, 0, 1).reshape(c_out, -1)
    y = (ct32 @ w).reshape(n, l, k_live, c_in)
    if k_live == 1:
      dx = y[:, :, 0]
    else:
      # dx[:, i] = sum_t y[:, i - off_t, t]: with y padded by hi rows in
      # front and -lo behind, tap k_live-1-u of row i is row i + u*d
      yp = F.pad(y, (0, 0, 0, 0, hi, -lo))
      sn, sl, sk, sc = yp.stride()
      dx = yp.as_strided((n, l, k_live, c_in),
                         (sn, sl, dilation * sl - sk, sc),
                         yp.storage_offset() + (k_live - 1) * sk).sum(2)
  if need_dw:
    # x's row i + off_t for tap t: x padded by -lo rows in front and hi
    # behind, row i + t*d
    xp = F.pad(x.float(), (0, 0, -lo, hi))
    sn, sl, sc = xp.stride()
    cols = xp.as_strided((n, l, k_live, c_in), (sn, sl, dilation * sl, sc),
                         xp.storage_offset())
    dw_live = (cols.reshape(-1, k_live * c_in).T @ ct32).reshape(
        k_live, c_in, c_out)
    if k_live == k_taps:
      dw = dw_live
    else:
      dw = torch.zeros(kernel.shape, dtype=torch.float32, device=x.device)
      dw[taps] = dw_live
  return dx, dw


def conv1d_bwd_plain(x, kernel, ct, dilation: int = 1):
  """x (N, L, Cin), kernel (K, Cin, Cout), ct (N, L, Cout) -> (dx in
  x's dtype, dkernel (K, Cin, Cout) f32), the kernel's inputs taken in
  x's dtype as the kernel takes them."""
  dt = x.dtype
  dx, dw = conv_bwd_f32(x, kernel.to(dt), ct.to(dt), dilation)
  return dx.to(dt), dw


def conv1d_bwd(x, kernel, ct, dilation: int = 1):
  """(dx, dkernel) through the CUDA kernel (CUDA tensors) or the plain
  version (CPU tensors)."""
  if x.device.type == 'cpu':
    return conv1d_bwd_plain(x, kernel, ct, dilation)
  n, l, c_in = x.shape
  k_taps, _, c_out = kernel.shape
  if kernel.shape[1] != c_in or ct.shape != (n, l, c_out) \
      or not conv_bwd_ok(l, c_in, c_out, k_taps, dilation):
    raise ValueError(f'conv1d_bwd kernel: shapes x {tuple(x.shape)} '
                     f'kernel {tuple(kernel.shape)} ct {tuple(ct.shape)} '
                     f'dilation {dilation} fail conv_bwd_ok')
  dt = x.dtype
  offsets = live_offsets(k_taps, l, dilation)
  taps = live_taps(k_taps, l, dilation)
  k_live = len(offsets)
  x = x.contiguous()
  ct = ct.to(dt).contiguous()
  # the dgrad's B operand: the live taps in reverse order (the mirrored
  # tap sum of csrc/conv1d_bwd.cu), each stored by rows of Cin
  wflip = kernel[taps].to(dt).flip(0).contiguous()
  # the kernel copies rows of x and ct in 16-byte chunks (rows of 128
  # channels are whole chunks: conv_bwd_ok)
  _build.require_aligned('conv1d_bwd', x, ct, wflip)
  _build.require_cuda('conv1d_bwd', x, ct, wflip)
  chunks = _build.row_chunks(n * l, k_live * (c_in // 128) * (c_out // 128))
  dx = torch.empty_like(x)
  dw = torch.empty((k_live, c_in, c_out), dtype=torch.float32,
                   device=x.device)
  # the row chunks' partial sums of dW, where there is more than one
  scratch = torch.empty(chunks * k_live * c_in * c_out if chunks > 1 else 0,
                        dtype=torch.float32, device=x.device)
  offs = _build.int_array(offsets)
  rc = _build.entry('svdd_conv1d_bwd')(
      x.data_ptr(), wflip.data_ptr(), ct.data_ptr(), dx.data_ptr(),
      dw.data_ptr(), scratch.data_ptr(), ctypes.addressof(offs), k_live,
      n, l, c_in, c_out, chunks, _build.dtype_code(x),
      _build.stream_ptr(x))
  _build.check(rc, 'svdd_conv1d_bwd')
  _build.LAUNCHES['conv1d_bwd'] += 1
  dkernel = torch.zeros(kernel.shape, dtype=torch.float32, device=x.device)
  dkernel[taps] = dw
  return dx, dkernel


class _ConvShifted(torch.autograd.Function):
  """The conv without bias: forward ``F.conv1d``, backward
  ``conv1d_bwd`` (the kernel on CUDA tensors, the plain version on CPU
  tensors)."""

  @staticmethod
  def forward(ctx, x, kernel, dilation):
    ctx.save_for_backward(x, kernel)
    ctx.dilation = dilation
    return _conv_forward(x, kernel, None, dilation)

  @staticmethod
  def backward(ctx, ct):
    x, kernel = ctx.saved_tensors
    dx, dkernel = conv1d_bwd(x, kernel, ct, ctx.dilation)
    return dx, dkernel.to(kernel.dtype), None


class _ConvPlainBwd(torch.autograd.Function):
  """The conv with its bias: forward ``_conv_forward``, as an unrecorded
  conv computes it; backward ``conv_bwd_taps_f32``'s products on any
  device, the gradients rounded to x's dtype as a conv in that dtype
  returns them; a gradient its input does not take is not computed.
  The products sum in a fixed order, where cuDNN's weight gradient sums
  with atomics, or, made deterministic, takes FFT algorithms (about 37
  ms and 17 GiB more a step in f32 at the pretraining shapes)."""

  @staticmethod
  def forward(ctx, x, kernel, bias, dilation):
    ctx.save_for_backward(x, kernel)
    ctx.dilation = dilation
    ctx.bias_dtype = None if bias is None else bias.dtype
    return _conv_forward(x, kernel, bias, dilation)

  @staticmethod
  def backward(ctx, ct):
    x, kernel = ctx.saved_tensors
    need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
    dt = x.dtype
    ct = ct.to(dt)
    dx, dw = conv_bwd_taps_f32(x, kernel.to(dt), ct, ctx.dilation, need_dx,
                               need_dw)
    db = (ct.float().sum((0, 1)).to(dt).to(ctx.bias_dtype)
          if need_db and ctx.bias_dtype is not None else None)
    return (None if dx is None else dx.to(dt),
            None if dw is None else dw.to(dt).to(kernel.dtype), db, None)


def conv1d_deterministic(x: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         dilation: int = 1) -> torch.Tensor:
  """``conv1d_shifted``'s value, recorded for autograd with a backward
  that sums in a fixed order on the card (``_ConvPlainBwd``) whatever
  the shape: the CNN denoiser's stem and 1x1 convs in training, whose
  resumed runs must repeat the uninterrupted ones bit for bit."""
  recorded = torch.is_grad_enabled() and (x.requires_grad
                                          or kernel.requires_grad)
  if recorded:
    return _ConvPlainBwd.apply(x, kernel, bias, dilation)
  return _conv_forward(x, kernel, bias, dilation)


def conv1d_shifted(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   dilation: int = 1) -> torch.Tensor:
  """x (N, L, Cin), kernel (K, Cin, Cout) (the flax layout) -> (N, L, Cout).

  Recorded for autograd through ``_ConvShifted`` when the shape passes
  ``conv_bwd_ok``; the bias is then added after the conv, as the JAX
  package adds it. Off that gate through ``_ConvPlainBwd``, whose
  weight gradient sums in a fixed order."""
  k_taps, c_in, c_out = kernel.shape
  recorded = torch.is_grad_enabled() and (x.requires_grad
                                          or kernel.requires_grad)
  if recorded and conv_bwd_ok(x.shape[1], c_in, c_out, k_taps, dilation):
    out = _ConvShifted.apply(x, kernel.to(x.dtype), dilation)
    return out if bias is None else out + bias.to(x.dtype)
  if recorded:
    return _ConvPlainBwd.apply(x, kernel, bias, dilation)
  return _conv_forward(x, kernel, bias, dilation)


def conv1d_prologue(x, kernel, bias, scale, shift, act_name):
  """conv1d(act(x * scale + shift), kernel) + bias, SAME, dilation 1, the
  eval NACDR ConvBlock's conv: ``fused_conv1d`` (B14) with
  ``SVDD_PALLAS_FUSED_CONV=1``, else ``nacdr_conv1d`` (B11c and one
  product)."""
  if use_pallas_fused_conv():
    return fused_conv1d(x, kernel, bias, scale, shift, act_name)
  return nacdr_conv1d(x, kernel, bias, scale, shift, act_name)
