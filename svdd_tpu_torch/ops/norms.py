"""Fused residual add + RMSNorm of the DiMamba blocks
(``svdd_tpu/ops/norms.py``).

Kernel: ``csrc/rmsnorm.cu``, which replaces ``_rmsnorm_pallas``. The
plain version is ``_rmsnorm_ref``: the mean of squares in f32, the
reciprocal root rounded to x's type, and each product in x's type. The
launch runs through ``kernel_utils.with_plain_grad``: the JAX package
defines no VJP for the Pallas kernel, so the backward is the gradient of
the plain version.
"""

from __future__ import annotations

import torch

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops import kernel_utils


def rmsnorm_plain(x, residual, scale, eps: float = 1e-5):
  """y = rmsnorm(x + residual) * scale over the last dim."""
  if residual is not None:
    x = x + residual
  var = x.float().square().mean(-1, keepdim=True)
  y = x * torch.rsqrt(var + eps).to(x.dtype)
  return y * scale


def _plain(x) -> bool:
  """The norm takes its plain version on CPU tensors."""
  return x.device.type == 'cpu'


def _launch(x, residual, scale, eps: float):
  """The raw launch: the kernel writes a new tensor of x's shape."""
  d = x.shape[-1]
  x = x.contiguous()
  res = residual.contiguous() if residual is not None else None
  scale = scale.contiguous()
  _build.require_cuda('rmsnorm', x, res, scale)
  out = torch.empty_like(x)
  rc = _build.entry('svdd_rmsnorm')(
      x.data_ptr(), None if res is None else res.data_ptr(),
      scale.data_ptr(), out.data_ptr(), x.numel() // d, d, eps,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_rmsnorm')
  _build.LAUNCHES['rmsnorm'] += 1
  return out


def fused_add_rmsnorm(x, residual, scale, eps: float = 1e-5):
  """rmsnorm(x + residual) * scale through the CUDA kernel (CUDA
  tensors) or the plain version (CPU tensors), differentiable in x, the
  residual and the scale. On the card, the residual and scale must have
  x's dtype, as the backbones pass them."""
  if _plain(x):
    return rmsnorm_plain(x, residual, scale, eps)
  d = x.shape[-1]
  if scale.shape != (d,) or (residual is not None
                             and residual.shape != x.shape):
    raise ValueError(f'fused_add_rmsnorm: x {tuple(x.shape)}, scale '
                     f'{tuple(scale.shape)}, residual '
                     f'{None if residual is None else tuple(residual.shape)}')
  if scale.dtype != x.dtype or (residual is not None
                                and residual.dtype != x.dtype):
    raise TypeError('fused_add_rmsnorm: the residual and scale must have '
                    f"x's dtype {x.dtype}")
  if residual is None:
    return kernel_utils.with_plain_grad(
        lambda x, s: _launch(x, None, s, eps),
        lambda x, s: rmsnorm_plain(x, None, s, eps), x, scale)
  return kernel_utils.with_plain_grad(
      lambda x, r, s: _launch(x, r, s, eps),
      lambda x, r, s: rmsnorm_plain(x, r, s, eps), x, residual, scale)
