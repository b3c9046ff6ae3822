"""The NACDR prologue and im2col of a k-tap conv, and the conv built on
it (``svdd_tpu/ops/im2col_pallas.py``).

Kernel: ``csrc/im2col.cu`` (B11c), which replaces
``svdd_tpu/ops/im2col_pallas.py:nacdr_im2col_pallas`` (pallas_call
:100): act(x * scale + shift) rounded to x's dtype, written as the
columns of the live taps, (N, L, C) -> (N, L, k_live * C). On the card
it takes every N, L and C: the JAX dispatcher's 128-lane gate
(``im2col_pallas.py:165``) was a Mosaic tiling rule. ``nacdr_conv1d``
follows it with one matrix product against the stacked live-tap weight
and the bias, as the JAX package leaves that product to XLA.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.kernel_utils import (ACT_CODES, act, live_offsets,
                                             live_taps, with_plain_grad)


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


def nacdr_im2col_reference(x, scale, shift, k_taps: int, act_name):
  """act(x * scale + shift) in f32, rounded to x's dtype, then its
  im2col columns (``im2col_pallas.py:nacdr_im2col_reference``)."""
  xg = act(act_name, x.float() * scale.float() + shift.float()).to(x.dtype)
  return im2col(xg, k_taps)


def _nacdr_im2col_kernel(x, scale, shift, k_taps: int, act_name):
  n, l, c = x.shape
  if scale.shape != (c,) or shift.shape != (c,):
    raise ValueError(f'nacdr_im2col: scale {tuple(scale.shape)} and shift '
                     f'{tuple(shift.shape)} must be ({c},)')
  offsets = live_offsets(k_taps, l)
  x = x.contiguous()
  scale = scale.float().contiguous()
  shift = shift.float().contiguous()
  _build.require_cuda('nacdr_im2col', x, scale, shift)
  _build.require_aligned('nacdr_im2col', x)
  out = torch.empty((n, l, len(offsets) * c), dtype=x.dtype, device=x.device)
  offs = _build.int_array(offsets)
  rc = _build.entry('svdd_nacdr_im2col')(
      x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
      ctypes.addressof(offs), len(offsets), ACT_CODES[act_name], n, l, c,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_nacdr_im2col')
  _build.LAUNCHES['nacdr_im2col'] += 1
  return out


def nacdr_im2col(x, scale, shift, k_taps: int, act_name):
  """(N, L, C) -> (N, L, k_live*C) through the CUDA kernel (CUDA tensors;
  differentiable through the plain version, as ``im2col_pallas.py``'s
  custom VJP is) or the plain version (CPU tensors)."""
  if x.device.type == 'cpu':
    return nacdr_im2col_reference(x, scale, shift, k_taps, act_name)
  return with_plain_grad(
      lambda *a: _nacdr_im2col_kernel(*a, k_taps, act_name),
      lambda *a: nacdr_im2col_reference(*a, k_taps, act_name),
      x, scale, shift)


def nacdr_conv1d(x, kernel, bias, scale, shift, act_name):
  """conv1d(act(x * scale + shift), kernel) + bias, SAME, dilation 1:
  the columns of ``nacdr_im2col``, one product with the stacked live
  taps of the (K, Cin, Cout) kernel in x's dtype, then the bias in x's
  dtype (``im2col_pallas.py:nacdr_conv1d``)."""
  k_taps, _, c_out = kernel.shape
  cols = nacdr_im2col(x, scale, shift, k_taps, act_name)
  w = kernel[live_taps(k_taps, x.shape[1])].to(x.dtype)
  return (torch.matmul(cols, w.reshape(-1, c_out))
          + bias.to(x.dtype))
