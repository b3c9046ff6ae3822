"""Value-net building blocks on the SVDD-MC path
(``svdd_tpu/models/blocks.py``): Dense, LayerNorm, eval BatchNorm, the
pairwise attention pool, the NACDR ConvBlock, the FFN and the ConvHead.

Channel-last (N, L, C). Random initialisation follows flax's defaults
(lecun-normal kernels, zero biases, unit norms, 2*I pool logits), so a
random-weight run has the JAX run's scale. Conv kernels keep the flax
(K, Cin, Cout) layout; Dense weights the torch (out, in) layout.

The eval tower hands each attention pool to the NEXT k=5 ConvBlock as a
``PoolHandoff``: that block runs the pool, its own BN affine and
activation and the im2col in one kernel (``ops/attn_pool.py``), so the
pooled activation never reaches device memory, and its conv is one
matmul over the im2col columns. That fused kernel has no backward. A
ConvBlock given a tensor, with ``defer_pool=False``, runs the plain
differentiable form instead: norm, act, conv (``conv1d_shifted``), then
the pool with the residual absorbed (``attn_pool``), whose backwards
are kernels; the tower selects it with ``fused=False``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.ops import attn_pool as ap
from svdd_tpu_torch.ops.conv1d import conv1d_shifted
from svdd_tpu_torch.ops.kernel_utils import act as activation
from svdd_tpu_torch.ops.kernel_utils import live_taps

# flax's truncated-normal correction: std of N(0,1) cut at +-2
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: torch.Generator
                 ) -> torch.Tensor:
  """flax ``lecun_normal``: truncated normal (+-2 std) with variance
  1 / fan_in."""
  std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
  t = torch.empty(shape, device=generator.device)
  return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                               generator=generator)


def conv_param(k: int, c_in: int, c_out: int,
               generator: torch.Generator) -> nn.Parameter:
  """A (K, Cin, Cout) conv kernel with flax's init."""
  return nn.Parameter(lecun_normal((k, c_in, c_out), k * c_in, generator))


class Dense(nn.Linear):
  """nn.Linear with flax Dense init, computing in the input's dtype."""

  def __init__(self, in_features: int, out_features: int,
               generator: torch.Generator, bias: bool = True):
    super().__init__(in_features, out_features, bias=bias,
                     device=generator.device)
    with torch.no_grad():
      self.weight.copy_(lecun_normal((in_features, out_features),
                                     in_features, generator).T)
      if bias:
        self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, self.weight.to(x.dtype),
                    None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(nn.Module):
  """``FastLayerNorm``/``nn.LayerNorm`` over the last axis: statistics
  and apply in f32, result in the input dtype."""

  def __init__(self, dim: int, device=None, eps: float = 1e-5):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(dim, device=device))
    self.bias = nn.Parameter(torch.zeros(dim, device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                        self.bias.float(), self.eps).to(x.dtype)


class BatchNorm(nn.Module):
  """Eval-mode BatchNorm over channels (flax ``nn.BatchNorm`` with
  ``use_running_average``): a per-channel affine."""

  def __init__(self, dim: int, device=None, eps: float = 1e-5):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(dim, device=device))
    self.bias = nn.Parameter(torch.zeros(dim, device=device))
    self.register_buffer('mean', torch.zeros(dim, device=device))
    self.register_buffer('var', torch.ones(dim, device=device))

  def affine(self):
    """(scale, shift) in f32 with bn(x) = x * scale + shift."""
    scale = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
    return scale, self.bias.float() - self.mean.float() * scale

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    scale, shift = self.affine()
    return (x.float() * scale + shift).to(x.dtype)


class PoolHandoff(NamedTuple):
  """A deferred attention pool: pool(x + residual) with logits weight
  ``w``, run by the consuming ConvBlock's fused kernel."""
  x: torch.Tensor
  residual: Optional[torch.Tensor]
  w: torch.Tensor


class AttentionPool(nn.Module):
  """Pairwise (pool_size 2) attention pool with a C x C logits weight
  initialised at 2*I; an odd-length tail pools to its first row."""

  def __init__(self, dim: int, device=None):
    super().__init__()
    self.w = nn.Parameter(2.0 * torch.eye(dim, device=device))

  def forward(self, x, residual=None, defer: bool = False):
    w = self.w.to(x.dtype)
    if defer:
      return PoolHandoff(x, residual, w)
    return ap.attn_pool(x, w, residual)


class ConvBlock(nn.Module):
  """Eval NACDR ConvBlock: pool(conv(act(bn(x))) [+ x]). Dropout is
  inert at eval. A ``PoolHandoff`` input is pooled inside this block's
  fused prologue kernel; ``defer_pool`` hands this block's own pool to
  the next block the same way."""

  def __init__(self, in_channels: int, out_channels: int,
               kernel_size: int, generator: torch.Generator,
               act_func: Optional[str] = 'gelu_enformer',
               residual: bool = False, pool: bool = False):
    super().__init__()
    dev = generator.device
    if residual and in_channels != out_channels:
      raise NotImplementedError('residual needs equal channels')
    self.act_func = act_func
    self.residual = residual
    self.norm = BatchNorm(in_channels, dev)
    self.kernel = conv_param(kernel_size, in_channels, out_channels,
                             generator)
    self.bias = nn.Parameter(torch.zeros(out_channels, device=dev))
    self.pool = AttentionPool(out_channels, dev) if pool else None

  def forward(self, x, defer_pool: bool = False):
    k_taps = self.kernel.shape[0]
    if isinstance(x, PoolHandoff):
      if self.residual or self.pool is not None:
        raise NotImplementedError('a pooled handoff feeds a plain conv')
      scale, shift = self.norm.affine()
      cols = ap.pool_prologue_im2col(x.x, x.w, scale, shift, k_taps,
                                     self.act_func, x.residual)
      lh = cols.shape[1]
      w = self.kernel[live_taps(k_taps, lh)].to(cols.dtype)
      return (torch.matmul(cols, w.reshape(-1, w.shape[-1]))
              + self.bias.to(cols.dtype))
    t = activation(self.act_func, self.norm(x))
    if k_taps == 1:
      y = (torch.matmul(t, self.kernel[0].to(t.dtype))
           + self.bias.to(t.dtype))
    else:
      y = conv1d_shifted(t, self.kernel, self.bias)
    res = x if self.residual else None
    if self.pool is not None:
      return self.pool(y, residual=res, defer=defer_pool)
    return y if res is None else y + res


class FeedForwardBlock(nn.Module):
  """LN -> Dense(2C) -> relu -> Dense(C)."""

  def __init__(self, dim: int, generator: torch.Generator):
    super().__init__()
    self.norm = LayerNorm(dim, generator.device)
    self.up = Dense(dim, 2 * dim, generator)
    self.down = Dense(2 * dim, dim, generator)

  def forward(self, x):
    return self.down(torch.relu(self.up(self.norm(x))))


class ConvHead(nn.Module):
  """1x1 conv to n_tasks, then the mean over L (no norm, no act)."""

  def __init__(self, n_tasks: int, in_channels: int,
               generator: torch.Generator):
    super().__init__()
    self.kernel = conv_param(1, in_channels, n_tasks, generator)
    self.bias = nn.Parameter(torch.zeros(n_tasks,
                                         device=generator.device))

  def forward(self, x):
    y = torch.matmul(x, self.kernel[0].to(x.dtype)) + self.bias.to(x.dtype)
    return y.mean(dim=1)
