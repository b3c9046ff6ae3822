"""The NACDR conv in one kernel: BN affine, activation and the k-tap
SAME conv with its bias (``svdd_tpu/ops/fused_conv_pallas.py``).

Kernel: ``csrc/fused_conv.cu`` (B14), which replaces
``svdd_tpu/ops/fused_conv_pallas.py:fused_conv1d_pallas`` (pallas_call
:133). It takes every shape on the card. Like the Pallas body it adds
the bias to the f32 sum and rounds once; the plain version
``fused_conv1d_reference`` copies the jnp reference, which rounds the
conv output to x's dtype and then adds the bias in x's dtype, so the
two differ by up to one ulp of x's dtype. The conv1d prologue route
(``ops/conv1d.py:conv1d_prologue``) takes this kernel in place of
``ops/im2col.py:nacdr_conv1d`` when ``SVDD_PALLAS_FUSED_CONV=1``, the
JAX package's switch, read the same way (default off). The Pallas
kernel has no VJP, so a backward through the CUDA kernel raises; the
eval paths that take it record none.
"""

from __future__ import annotations

import ctypes
import os

import torch

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.im2col import nacdr_im2col_reference
from svdd_tpu_torch.ops.kernel_utils import (ACT_CODES, live_offsets,
                                             live_taps, with_plain_grad)


def use_pallas_fused_conv() -> bool:
  """The switch of ``fused_conv_pallas.py:use_pallas_fused_conv``:
  on only with ``SVDD_PALLAS_FUSED_CONV=1``."""
  return os.environ.get('SVDD_PALLAS_FUSED_CONV') == '1'


def fused_conv1d_reference(x, kernel, bias, scale, shift,
                           act_name='gelu_enformer'):
  """conv1d(act(x * scale + shift) rounded to x's dtype, kernel) + bias:
  the live-tap products summed in f32 and rounded to x's dtype, then the
  bias added in x's dtype (``fused_conv_pallas.py:48-54``)."""
  k_taps, _, c_out = kernel.shape
  cols = nacdr_im2col_reference(x, scale, shift, k_taps, act_name)
  w = kernel[live_taps(k_taps, x.shape[1])].to(x.dtype).float()
  out = torch.matmul(cols.float(), w.reshape(-1, c_out)).to(x.dtype)
  return out + bias.to(x.dtype)


def _fused_conv1d_kernel(x, kernel, bias, scale, shift, act_name):
  n, l, c_in = x.shape
  k_taps, k_in, c_out = kernel.shape
  if (k_in != c_in or bias.shape != (c_out,) or scale.shape != (c_in,)
      or shift.shape != (c_in,)):
    raise ValueError(f'fused_conv1d: x {tuple(x.shape)}, kernel '
                     f'{tuple(kernel.shape)}, bias {tuple(bias.shape)}, '
                     f'scale {tuple(scale.shape)}, shift '
                     f'{tuple(shift.shape)} do not fit')
  offsets = live_offsets(k_taps, l)
  x = x.contiguous()
  w = kernel[live_taps(k_taps, l)].to(x.dtype).contiguous()
  b = bias.to(x.dtype).contiguous()
  scale = scale.float().contiguous()
  shift = shift.float().contiguous()
  _build.require_cuda('fused_conv1d', x, w, b, scale, shift)
  out = torch.empty((n, l, c_out), dtype=x.dtype, device=x.device)
  offs = _build.int_array(offsets)
  rc = _build.entry('svdd_fused_conv1d')(
      x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
      shift.data_ptr(), out.data_ptr(), ctypes.addressof(offs), len(offsets),
      ACT_CODES[act_name], n, l, c_in, c_out, _build.dtype_code(x),
      _build.stream_ptr(x))
  _build.check(rc, 'svdd_fused_conv1d')
  _build.LAUNCHES['fused_conv1d'] += 1
  return out


def fused_conv1d(x, kernel, bias, scale, shift, act_name='gelu_enformer'):
  """x (N, L, Cin), kernel (K, Cin, Cout), bias (Cout,), scale and shift
  (Cin,) -> (N, L, Cout) through the CUDA kernel (CUDA tensors) or the
  plain version (CPU tensors)."""
  if x.device.type == 'cpu':
    return fused_conv1d_reference(x, kernel, bias, scale, shift, act_name)
  return with_plain_grad(lambda *a: _fused_conv1d_kernel(*a, act_name),
                         None, x, kernel, bias, scale, shift)
