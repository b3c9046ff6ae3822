"""Value-net building blocks (``svdd_tpu/models/blocks.py``): Dense,
LayerNorm, eval BatchNorm, the pairwise attention pool, max and average
pools, ChannelTransform, Stem, the ConvBlock in any op order, the FFN
and the ConvHead.

Channel-last (N, L, C). Random initialisation follows flax's defaults
(lecun-normal kernels, zero biases, unit norms, 2*I pool logits), so a
random-weight run has the JAX run's scale. Conv kernels keep the flax
(K, Cin, Cout) layout; Dense weights the torch (out, in) layout.

The Enformer's eval tower hands each attention pool to the NEXT k=5
ConvBlock as a ``PoolHandoff`` (or, at a width off the 128-lane grid, a
``LogitsHandoff``): that block runs the pool, its own BN affine and
activation and the im2col in one kernel (``ops/attn_pool.py``), so the
pooled activation never reaches device memory, and its conv is one
matmul over the im2col columns. A ConvBlock given a tensor with
``fused=False`` runs the plain differentiable form instead: norm, act,
conv (``conv1d_shifted``), then the pool with the residual absorbed
(``attn_pool``, or ``attn_pool_fused`` off the grid); the tower selects
it with ``fused=False``. Basenji's dilation-1 NACDR convs take the
NACDR eval fast path (``ops/conv1d.py:conv1d_prologue``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.ops import attn_pool as ap
from svdd_tpu_torch.ops.conv1d import conv1d_prologue, conv1d_shifted
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

  def probe_affine(self, dtype: torch.dtype):
    """(scale, shift) in f32 as the JAX NACDR fast path recovers them
    (``blocks.py:396-407``): the norm of 0 and of 1, each rounded to
    ``dtype``, shift = bn(0) and scale = bn(1) - bn(0) in ``dtype``."""
    scale, shift = self.affine()
    b0, b1 = shift.to(dtype), (scale + shift).to(dtype)
    return (b1 - b0).float(), b0.float()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    scale, shift = self.affine()
    return (x.float() * scale + shift).to(x.dtype)


class PoolHandoff(NamedTuple):
  """A deferred attention pool at a width on the 128-lane grid:
  pool(x + residual) with logits weight ``w``, run by the consuming
  ConvBlock's w-logits kernel."""
  x: torch.Tensor
  residual: Optional[torch.Tensor]
  w: torch.Tensor


class LogitsHandoff(NamedTuple):
  """A deferred attention pool at a width off the grid (the JAX module's
  legacy handoff, ``blocks.py:285-288``): x with the residual added and
  its logits x @ W, both padded to an even length; run by the consuming
  ConvBlock's kernel B11b."""
  x: torch.Tensor
  logits: torch.Tensor


class AttentionPool(nn.Module):
  """Pairwise (pool_size 2) attention pool with a C x C logits weight
  initialised at 2*I; an odd-length tail pools to its first row.

  At a width on the 128-lane grid (the JAX module's ``wlogits_pool_ok``)
  the w-logits kernels compute the logits difference themselves, with the
  residual added inside. At other widths it follows the JAX module's
  legacy branch (``blocks.py:288-298``): the residual added up front, the
  logits x @ W as a product in x's dtype, an odd length padded with a
  zero row and a lowest-finite logit, then kernel B11a, or the handoff
  to the next block's kernel B11b."""

  def __init__(self, dim: int, device=None):
    super().__init__()
    self.w = nn.Parameter(2.0 * torch.eye(dim, device=device))

  def forward(self, x, residual=None, defer: bool = False):
    w = self.w.to(x.dtype)
    if x.shape[-1] % 128 == 0:
      if defer:
        return PoolHandoff(x, residual, w)
      return ap.attn_pool(x, w, residual)
    if residual is not None:
      x = x + residual
    logits = torch.matmul(x, w)
    if x.shape[1] % 2:
      x = F.pad(x, (0, 0, 0, 1))
      logits = F.pad(logits, (0, 0, 0, 1),
                     value=torch.finfo(logits.dtype).min)
    if defer:
      return LogitsHandoff(x, logits)
    return ap.attn_pool_fused(x, logits)


def pool(func: Optional[str], size: Optional[int], x):
  """'max' / 'avg' pooling over windows of ``size`` (VALID, stride
  ``size``), or none."""
  if func is None:
    return x
  if func == 'max':
    return F.max_pool1d(x.transpose(1, 2), size, size).transpose(1, 2)
  if func == 'avg':
    return F.avg_pool1d(x.transpose(1, 2), size, size).transpose(1, 2)
  raise NotImplementedError(func)


def adaptive_pool(func: Optional[str], x):
  """Pool the whole length axis: (N, L, C) -> (N, C)."""
  if func is None:
    return x
  if func == 'avg':
    return x.mean(dim=1)
  if func == 'max':
    return x.amax(dim=1)
  raise NotImplementedError(func)


class ChannelTransform(nn.Module):
  """A 1x1 conv channel resize (the JAX module is the identity when the
  channels match; ConvBlock then makes none)."""

  def __init__(self, in_channels: int, out_channels: int,
               generator: torch.Generator):
    super().__init__()
    self.kernel = conv_param(1, in_channels, out_channels, generator)
    self.bias = nn.Parameter(torch.zeros(out_channels,
                                         device=generator.device))

  def forward(self, x):
    return (torch.matmul(x, self.kernel[0].to(x.dtype))
            + self.bias.to(x.dtype))


class Stem(nn.Module):
  """Stem conv and activation (the JAX module's pool is never used)."""

  def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
               generator: torch.Generator, act_func: str = 'relu'):
    super().__init__()
    self.act_func = act_func
    self.kernel = conv_param(kernel_size, in_channels, out_channels,
                             generator)
    self.bias = nn.Parameter(torch.zeros(out_channels,
                                         device=generator.device))

  def forward(self, x):
    return activation(self.act_func,
                      conv1d_shifted(x, self.kernel, self.bias))


class ConvBlock(nn.Module):
  """Conv, dropout, norm, residual and activation in the order of the
  ``order`` string, pooling last (``svdd_tpu/models/blocks.py:359-527``),
  in eval: dropout is inert, norm is the eval BatchNorm. The residual
  goes through a 1x1 ChannelTransform when the channels differ.

  Three forms, as in the JAX module:
  * a ``PoolHandoff`` or ``LogitsHandoff`` input, the previous block's
    deferred pool, is pooled inside this block's prologue kernel (a k>1
    NACDR block without residual or pool), and the conv is one product
    over the im2col columns;
  * the NACDR eval fast path (k > 1, dilation 1, norm on, ``fused``):
    the norm is recovered as an affine (``BatchNorm.probe_affine``) and
    norm, activation and conv run through ``conv1d_prologue`` (kernel
    B11c and one product, or kernel B14);
  * otherwise the ops in order (``fused=False`` is the JAX package's
    ``unfused_guard``, the form a gradient takes).
  ``defer_pool`` hands this block's attention pool to the next block as
  a handoff; a trailing residual (order ending in R) with an attention
  pool rides into the pool."""

  def __init__(self, in_channels: int, out_channels: int,
               kernel_size: int, generator: torch.Generator,
               dilation: int = 1, act_func: Optional[str] = 'relu',
               pool_func: Optional[str] = None,
               pool_size: Optional[int] = None, norm: bool = True,
               residual: bool = False, order: str = 'CDNRA'):
    super().__init__()
    if sorted(order) != list('ACDNR'):
      raise ValueError(f'ConvBlock order {order!r}')
    if pool_func == 'attn' and pool_size != 2:
      raise NotImplementedError('attention pooling takes pool_size 2')
    dev = generator.device
    self.dilation, self.act_func, self.order = dilation, act_func, order
    self.pool_func, self.pool_size = pool_func, pool_size
    self.residual = residual
    norm_dim = (in_channels if order.index('N') < order.index('C')
                else out_channels)
    self.norm = BatchNorm(norm_dim, dev) if norm else None
    self.kernel = conv_param(kernel_size, in_channels, out_channels,
                             generator)
    self.bias = nn.Parameter(torch.zeros(out_channels, device=dev))
    self.channel_transform = (
        ChannelTransform(in_channels, out_channels, generator)
        if residual and in_channels != out_channels else None)
    self.pool = (AttentionPool(out_channels, dev) if pool_func == 'attn'
                 else None)

  def _conv(self, x):
    if self.kernel.shape[0] == 1:
      return (torch.matmul(x, self.kernel[0].to(x.dtype))
              + self.bias.to(x.dtype))
    return conv1d_shifted(x, self.kernel, self.bias, self.dilation)

  def _residual_input(self, x):
    if not self.residual:
      return None
    return x if self.channel_transform is None else self.channel_transform(x)

  def _pool(self, y, residual, defer_pool: bool):
    """Pool y; ``residual`` rides into an attention pool."""
    if self.pool is not None:
      return self.pool(y, residual=residual, defer=defer_pool)
    return pool(self.pool_func, self.pool_size, y)

  def _defer_residual(self) -> bool:
    return self.pool_func == 'attn' and self.order.endswith('R')

  def forward(self, x, defer_pool: bool = False, fused: bool = True):
    k_taps = self.kernel.shape[0]
    nacdr_fast = (self.order == 'NACDR' and self.norm is not None
                  and self.dilation == 1 and k_taps > 1)
    if isinstance(x, (PoolHandoff, LogitsHandoff)):
      if not nacdr_fast or self.residual or self.pool_func is not None:
        raise NotImplementedError('a pooled handoff feeds a plain k>1 '
                                  'NACDR conv')
      scale, shift = self.norm.probe_affine(x.x.dtype)
      if isinstance(x, PoolHandoff):
        cols = ap.pool_prologue_im2col_wlogits(
            x.x, x.w, scale, shift, k_taps, self.act_func, x.residual)
      else:
        cols = ap.pool_prologue_im2col(x.x, x.logits, scale, shift, k_taps,
                                       self.act_func)
      w = self.kernel[live_taps(k_taps, cols.shape[1])].to(cols.dtype)
      return (torch.matmul(cols, w.reshape(-1, w.shape[-1]))
              + self.bias.to(cols.dtype))
    x_input = self._residual_input(x)
    if fused and nacdr_fast:
      scale, shift = self.norm.probe_affine(x.dtype)
      y = conv1d_prologue(x, self.kernel, self.bias, scale, shift,
                          self.act_func)
      if self.residual and not self._defer_residual():
        y, x_input = y + x_input, None
      return self._pool(y, x_input, defer_pool)
    pending = None
    for op in self.order:
      if op == 'C':
        x = self._conv(x)
      elif op == 'N' and self.norm is not None:
        x = self.norm(x)
      elif op == 'R' and self.residual:
        if self._defer_residual():
          pending = x_input
        else:
          x = x + x_input
      elif op == 'A':
        x = activation(self.act_func, x)
    return self._pool(x, pending, defer_pool)


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
