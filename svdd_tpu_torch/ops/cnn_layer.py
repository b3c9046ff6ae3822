"""Fused CNN denoiser layer: relu(conv(LN(x + bias_row))) + x.

Kernel: ``csrc/cnn_layer.cu``, which replaces
``svdd_tpu/ops/cnn_layer_pallas.py:_cnn_layer_pallas_jit``. The plain
version below follows ``cnn_layer_reference``: x + bias_row, the
normalised h, the LN scale and bias products, the conv output, the conv
bias add and the residual add are each rounded to the activation type,
with the LN statistics in f32. The kernel rounds at the same points, so
in bf16 it differs from the plain version only by the order of its f32
tap sums (a rounded conv output may land one bf16 ulp apart). The TPU
kernel rounds elsewhere: LN affine in f32 before one cast, and each
tap's product to the activation type (``cnn_layer_pallas.py:119-124,
:149, :169``).
"""

from __future__ import annotations

import ctypes

import torch

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.conv1d import conv1d_shifted
from svdd_tpu_torch.ops.kernel_utils import live_offsets, live_taps


def cnn_layer_plain(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
                    dilation: int = 1, eps: float = 1e-6):
  """x (N, L, C); bias_row (N, C); ln_scale/ln_bias/conv_bias (C,);
  kernel (K, C, C) flax layout. SAME padding."""
  h = x + bias_row[:, None, :].to(x.dtype)
  h32 = h.float()
  mu = h32.mean(-1, keepdim=True)
  var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
  h = ((h32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)
  h = h * ln_scale.to(x.dtype) + ln_bias.to(x.dtype)
  h = conv1d_shifted(h, kernel, conv_bias, dilation)
  return torch.relu(h) + x


def cnn_layer(x, bias_row, ln_scale, ln_bias, kernel, conv_bias,
              dilation: int = 1, eps: float = 1e-6):
  """The layer through the CUDA kernel for CUDA tensors, through
  ``cnn_layer_plain`` for CPU tensors."""
  if x.device.type == 'cpu':
    return cnn_layer_plain(x, bias_row, ln_scale, ln_bias, kernel,
                           conv_bias, dilation, eps)
  n, l, c = x.shape
  k_taps = kernel.shape[0]
  if kernel.shape[1:] != (c, c) or c != 128:
    raise ValueError(f'cnn_layer kernel takes C=128 square taps, got '
                     f'x {tuple(x.shape)} kernel {tuple(kernel.shape)}')
  # the block holds the normalised sequence and one f32 weight chunk in
  # shared memory, at most 227 KB on an H100
  if l * c * x.element_size() + 16 * c * 4 > 227 * 1024:
    raise ValueError(f'cnn_layer kernel: L={l} does not fit in shared '
                     f'memory for {x.dtype}')
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
