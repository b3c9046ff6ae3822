"""Value-net building blocks (``svdd_tpu/models/blocks.py``): Dense,
LayerNorm, BatchNorm (eval and training), dropout, the pairwise
attention pool, max and average pools, ChannelTransform, Stem, the
ConvBlock in any op order, the FFN and the ConvHead.

Channel-last (N, L, C). Random initialisation follows flax's defaults
(lecun-normal kernels, zero biases, unit norms, 2*I pool logits), so a
random-weight run has the JAX run's scale. Conv kernels keep the flax
(K, Cin, Cout) layout; Dense weights the torch (out, in) layout.

The Enformer's eval tower hands each attention pool to the NEXT k=5
ConvBlock as a ``PoolHandoff`` (or, at a width off the 128-lane grid
but for bf16 in the L-major tower, a ``LogitsHandoff``): that block runs the pool, its own BN affine and
activation and the im2col in one kernel (``ops/attn_pool.py``), so the
pooled activation never reaches device memory, and its conv is one
matmul over the im2col columns. A ConvBlock given a tensor with
``fused=False`` runs the plain differentiable form instead: norm, act,
conv (``conv1d_shifted``), then the pool with the residual absorbed
(``attn_pool``, or ``attn_pool_fused`` off the grid); the tower selects
it with ``fused=False``. Basenji's dilation-1 NACDR convs take the
NACDR eval fast path (``ops/conv1d.py:conv1d_prologue``).

Training (``train=True``) is flax's ``apply(train=True,
mutable=['batch_stats'])``: BatchNorm normalises by the batch's
statistics and moves its running averages, dropout is live with masks
from a ``DropoutMasks``, and a ConvBlock runs its ops in order (the
plain differentiable form; JAX gates its eval fast paths on ``not
train``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.ops import attn_pool as ap
from svdd_tpu_torch.parallel import mesh as mesh_lib
from svdd_tpu_torch.parallel import rows
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
  """nn.Linear with flax Dense init, computing in the input's dtype; in
  bf16 the product is rounded before the bias is added, as flax's
  ``Dense(dtype=bf16)`` adds it."""

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
    w = self.weight.to(x.dtype)
    if self.bias is None:
      return F.linear(x, w)
    if x.dtype == torch.bfloat16:
      return F.linear(x, w) + self.bias.to(x.dtype)
    return F.linear(x, w, self.bias.to(x.dtype))


class LayerNorm(nn.Module):
  """``FastLayerNorm`` over the last axis. float32: statistics and apply
  in f32. bfloat16: statistics in f32 (the mean and E[x^2] - mean^2),
  then mean, rstd, scale and bias cast to bf16 and the apply in bf16
  (``svdd_tpu/models/blocks.py:64-70``)."""

  def __init__(self, dim: int, device=None, eps: float = 1e-5):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(dim, device=device))
    self.bias = nn.Parameter(torch.zeros(dim, device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
      return F.layer_norm(x.float(), x.shape[-1:], self.scale.float(),
                          self.bias.float(), self.eps).to(x.dtype)
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(),
                      min=0.0)
    rstd = torch.rsqrt(var + self.eps)
    dt = x.dtype
    return ((x - mean.to(dt)) * rstd.to(dt) * self.scale.to(dt)
            + self.bias.to(dt))


class DropoutMasks:
  """The dropout masks of one training forward, in the order the dropouts
  are called: drawn from ``generator`` (a ``torch.Generator`` on the
  activations' device; a position is kept where a uniform is below the
  keep rate, as ``jax.random.bernoulli``), or, given ``masks``, taken
  from that list of boolean arrays (the tests inject JAX's)."""

  def __init__(self, generator: Optional[torch.Generator] = None,
               masks=None):
    if (generator is None) == (masks is None):
      raise ValueError('DropoutMasks takes a generator or a list of masks')
    self.generator = generator
    self.masks = None if masks is None else list(masks)
    self.calls = 0

  def __call__(self, shape, keep: float, device) -> torch.Tensor:
    if self.masks is not None:
      mask = torch.as_tensor(np.asarray(self.masks[self.calls], bool),
                             device=device)
      if tuple(mask.shape) != tuple(shape):
        raise ValueError(f'dropout mask {self.calls}: {tuple(mask.shape)} '
                         f'for activations {tuple(shape)}')
    else:
      mask = rows.rand(shape, self.generator, device) < keep
    self.calls += 1
    return mask


def dropout(x: torch.Tensor, rate: float,
            masks: Optional[DropoutMasks]) -> torch.Tensor:
  """flax ``nn.Dropout`` in training: select(mask, x / keep, 0), keep =
  1 - rate rounded to x's dtype as JAX rounds a Python float operand (a
  division, not a product with 1 / keep: the two round differently).
  Inert at rate 0 (no mask is drawn, as flax returns the input) and
  without ``masks`` (eval)."""
  if rate == 0.0 or masks is None:
    return x
  keep = 1.0 - rate
  mask = masks(x.shape, keep, x.device)
  kept = x / float(torch.tensor(keep, dtype=x.dtype))
  return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


class BatchNorm(nn.Module):
  """BatchNorm over channels, flax's ``nn.BatchNorm`` (epsilon 1e-5,
  momentum 0.9). Eval (``use_running_average``): a per-channel affine of
  the running statistics. Training: the batch's statistics over every
  axis but the last, in f32, the variance flax's fast form E[x^2] -
  E[x]^2 clipped at 0 (biased), the normalisation in flax's order
  (``_normalize``) rounded once to x's dtype, and the running averages
  moved in place as ra <- 0.9 ra + 0.1 stat (not
  ``F.batch_norm(training=True)``, which moves the variance by the
  unbiased estimate with the opposite momentum).

  ``data_group`` (set by ``sync_batchnorm``; not saved): a process group
  of more than one process whose rows make the batch, as JAX's mesh
  makes its statistics global. Training then all-reduces the sum, the
  sum of squares and the count, with their gradients, so every process
  normalises by the global batch and moves its running averages alike.
  Without one, the statistics are the local batch's."""

  momentum = 0.9
  data_group = None

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
    (``blocks.py:396-407``): the norm of an f32 0 and 1, shift = bn(0)
    and scale = bn(1) - bn(0). For bf16 activations in flax's order,
    (p - mean) * (rstd * scale) + bias; for float32 ones from
    ``affine()``, the same values to f32 rounding."""
    if dtype == torch.bfloat16:
      b0 = self._flax_norm(torch.zeros_like(self.mean, dtype=torch.float32))
      b1 = self._flax_norm(torch.ones_like(self.mean, dtype=torch.float32))
    else:
      scale, b0 = self.affine()
      b1 = scale + b0
    return b1 - b0, b0

  def _flax_norm(self, x32: torch.Tensor) -> torch.Tensor:
    """flax's order (normalization._normalize) in f32: (x - mean) *
    (rstd * scale) + bias."""
    mul = torch.rsqrt(self.var.float() + self.eps) * self.scale.float()
    return (x32 - self.mean.float()) * mul + self.bias.float()

  def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    """Eval: bf16 in flax's order, rounded once; f32 as ``affine()``.
    ``train``: ``_train``."""
    if train:
      return self._train(x)
    if x.dtype == torch.bfloat16:
      return self._flax_norm(x.float()).to(x.dtype)
    scale, shift = self.affine()
    return (x.float() * scale + shift).to(x.dtype)

  def _train(self, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    dims = tuple(range(x.ndim - 1))
    if self.data_group is None:
      mean = x32.mean(dims)
      var = torch.clamp(x32.square().mean(dims) - mean.square(), min=0.0)
    else:
      c = x.shape[-1]
      count = torch.full((1,), x32.numel() // c, dtype=torch.float32,
                         device=x.device)
      stats = mesh_lib.all_reduce_grad(torch.cat(
          [x32.sum(dims), x32.square().sum(dims), count]), self.data_group)
      mean = stats[:c] / stats[-1]
      var = torch.clamp(stats[c:2 * c] / stats[-1] - mean.square(), min=0.0)
    with torch.no_grad():
      m = self.momentum
      self.mean.copy_(m * self.mean + (1 - m) * mean)
      self.var.copy_(m * self.var + (1 - m) * var)
    mul = torch.rsqrt(var + self.eps) * self.scale.float()
    return ((x32 - mean) * mul + self.bias.float()).to(x.dtype)


def sync_batchnorm(module: nn.Module, group) -> nn.Module:
  """Give every BatchNorm of ``module`` the data ``group`` of its
  training statistics (None: the local batch's); returns ``module``."""
  for m in module.modules():
    if isinstance(m, BatchNorm):
      m.data_group = group
  return module


def defers_bias(dtype: torch.dtype) -> bool:
  """Whether the eval tower defers each conv's bias, as the JAX tower's
  pipeline does (``PendingBias``, ``svdd_tpu/models/blocks.py:73-96``):
  the raw conv output goes on and its bias folds into the next block's
  norm shift or the pool's output. The JAX rounding of that pipeline
  shows in bf16, which follows it; float32 adds each bias in place, the
  same values to f32 rounding."""
  return dtype == torch.bfloat16


class PendingBias(NamedTuple):
  """A conv output whose (C,) f32 channel bias is not added yet."""
  x: torch.Tensor
  bias: torch.Tensor


class PoolHandoff(NamedTuple):
  """A deferred attention pool at a width on the 128-lane grid (or any
  width in bf16 in the L-major eval tower, ``AttentionPool``):
  pool(x + residual) with logits weight ``w``, run by the consuming
  ConvBlock's w-logits kernel or its reference form; ``lnc``: handed on
  in the L-major eval tower (``ops.attn_pool.wlogits_body_takes``);
  ``out_bias``: a deferred
  (C,) f32 bias of the pooled output (``defers_bias``), which the
  consumer folds into its norm shift."""
  x: torch.Tensor
  residual: Optional[torch.Tensor]
  w: torch.Tensor
  lnc: bool = False
  out_bias: Optional[torch.Tensor] = None


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
  to the next block's kernel B11b. The one exception is bf16 in the
  L-major eval tower, where the JAX module takes its ``lnc`` branch at
  every width (``blocks.py:215-234``) and its dispatchers, off their
  gate, the w-logits references (``*_wlogits_lnc_reference``): there the
  pool takes the w-logits path, whose bf16 form off the gate is that
  reference (``ops.attn_pool.pool_rounds_as_reference``), and a deferred
  bias folds into the consumer's norm shift. In float32 the two branches
  agree to f32 rounding and the legacy one stays."""

  def __init__(self, dim: int, device=None):
    super().__init__()
    self.w = nn.Parameter(2.0 * torch.eye(dim, device=device))

  def forward(self, x, residual=None, defer: bool = False,
              lnc: bool = False, out_bias=None):
    """``lnc``: the pool of the L-major eval tower (an even input
    length), which decides JAX's dispatch of the w-logits pool in bf16
    (``ops.attn_pool.pool_rounds_as_reference``). ``out_bias``: a
    deferred (C,) f32 bias of x (``defers_bias``): it passes through the
    blend, added to the output in x's dtype or handed on."""
    w = self.w.to(x.dtype)
    if x.shape[-1] % 128 == 0 or (lnc and x.dtype == torch.bfloat16):
      if defer:
        return PoolHandoff(x, residual, w, lnc, out_bias)
      out = ap.attn_pool(x, w, residual, lnc)
      return out if out_bias is None else out + out_bias.to(out.dtype)
    if residual is not None:
      x = x + residual
    if out_bias is not None:
      x = x + out_bias.to(x.dtype)
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

  def forward(self, x, train: bool = False):
    return activation(self.act_func, conv1d_shifted(x, self.kernel,
                                                    self.bias))


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
    ``unfused_guard``, the form a gradient takes; ``train`` takes it too,
    with the norm on the batch's statistics and ``dropout`` live).
  ``defer_pool`` hands this block's attention pool to the next block as
  a handoff; a trailing residual (order ending in R) with an attention
  pool rides into the pool."""

  def __init__(self, in_channels: int, out_channels: int,
               kernel_size: int, generator: torch.Generator,
               dilation: int = 1, act_func: Optional[str] = 'relu',
               pool_func: Optional[str] = None,
               pool_size: Optional[int] = None, norm: bool = True,
               residual: bool = False, order: str = 'CDNRA',
               dropout: float = 0.0):
    super().__init__()
    if sorted(order) != list('ACDNR'):
      raise ValueError(f'ConvBlock order {order!r}')
    if pool_func == 'attn' and pool_size != 2:
      raise NotImplementedError('attention pooling takes pool_size 2')
    dev = generator.device
    self.dilation, self.act_func, self.order = dilation, act_func, order
    self.dropout = dropout
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

  def _pool(self, y, residual, defer_pool: bool, lnc: bool):
    """Pool y; ``residual`` rides into an attention pool."""
    if self.pool is not None:
      return self.pool(y, residual=residual, defer=defer_pool, lnc=lnc)
    return pool(self.pool_func, self.pool_size, y)

  def _defer_residual(self) -> bool:
    return self.pool_func == 'attn' and self.order.endswith('R')

  def _pending(self, x: PendingBias, defer_pool: bool, lnc: bool):
    """The JAX block's pending branch (``svdd_tpu/models/blocks.py:
    408-440``) for a k=1 NACDR block with an identity residual riding
    into its attention pool: the input's bias folds into the norm shift,
    the affine and activation run in x's dtype, the 1x1 conv on the raw
    input, and both biases go on to the pool as its ``out_bias``."""
    if (self.kernel.shape[0] != 1 or self.order != 'NACDR'
        or self.norm is None or self.channel_transform is not None
        or not self.residual or not self._defer_residual()):
      raise NotImplementedError('a pending bias feeds a pooled k=1 NACDR '
                                'block with an identity residual')
    y_raw, b_in = x
    dt = y_raw.dtype
    scale, shift = self.norm.probe_affine(dt)
    shift = shift + b_in * scale
    t = activation(self.act_func, y_raw * scale.to(dt) + shift.to(dt))
    z_raw = torch.matmul(t, self.kernel[0].to(dt))
    return self.pool(z_raw, residual=y_raw, defer=defer_pool, lnc=lnc,
                     out_bias=self.bias.float() + b_in)

  def forward(self, x, defer_pool: bool = False, fused: bool = True,
              lnc: bool = False, train: bool = False,
              masks: Optional[DropoutMasks] = None):
    """``lnc``: this block's attention pool is in the L-major eval tower
    (``AttentionPool.forward``). ``train``: the ops in order, BatchNorm
    on the batch (moving its running averages) and dropout from
    ``masks``."""
    if train:
      return self._ops(x, train, masks)
    k_taps = self.kernel.shape[0]
    nacdr_fast = (self.order == 'NACDR' and self.norm is not None
                  and self.dilation == 1 and k_taps > 1)
    if isinstance(x, PendingBias):
      return self._pending(x, defer_pool, lnc)
    if isinstance(x, (PoolHandoff, LogitsHandoff)):
      if not nacdr_fast or self.residual or self.pool_func is not None:
        raise NotImplementedError('a pooled handoff feeds a plain k>1 '
                                  'NACDR conv')
      scale, shift = self.norm.probe_affine(x.x.dtype)
      if isinstance(x, PoolHandoff):
        if x.out_bias is not None:
          shift = shift + x.out_bias * scale
        cols = ap.pool_prologue_im2col_wlogits(
            x.x, x.w, scale, shift, k_taps, self.act_func, x.residual,
            x.lnc)
      else:
        cols = ap.pool_prologue_im2col(x.x, x.logits, scale, shift, k_taps,
                                       self.act_func)
      w = self.kernel[live_taps(k_taps, cols.shape[1])].to(cols.dtype)
      out = torch.matmul(cols, w.reshape(-1, w.shape[-1]))
      if defers_bias(out.dtype):
        return PendingBias(out, self.bias.float())
      return out + self.bias.to(cols.dtype)
    if fused and nacdr_fast:
      x_input = self._residual_input(x)
      scale, shift = self.norm.probe_affine(x.dtype)
      y = conv1d_prologue(x, self.kernel, self.bias, scale, shift,
                          self.act_func)
      if self.residual and not self._defer_residual():
        y, x_input = y + x_input, None
      return self._pool(y, x_input, defer_pool, lnc)
    return self._ops(x, False, None, defer_pool, lnc)

  def _ops(self, x, train: bool, masks, defer_pool: bool = False,
           lnc: bool = False):
    """The ops in the order of ``order`` (the JAX block's generic loop,
    ``blocks.py:497-520``), then the pool."""
    x_input = self._residual_input(x)
    pending = None
    for op in self.order:
      if op == 'C':
        x = self._conv(x)
      elif op == 'D':
        x = dropout(x, self.dropout, masks)
      elif op == 'N' and self.norm is not None:
        x = self.norm(x, train)
      elif op == 'R' and self.residual:
        if self._defer_residual():
          pending = x_input
        else:
          x = x + x_input
      elif op == 'A':
        x = activation(self.act_func, x)
    return self._pool(x, pending, defer_pool, lnc)


class FeedForwardBlock(nn.Module):
  """LN -> Dense(2C) -> dropout -> relu -> Dense(C) -> dropout (two flax
  ``LinearBlock``s); the dropouts live only given ``masks`` (training).
  ``tp_group``: the model group of a tensor-parallel copy
  (``models.enformer.tp_shard_value_params``), whose partial outputs the
  block sums after the second Dense."""

  tp_group = None

  def __init__(self, dim: int, generator: torch.Generator,
               dropout: float = 0.0):
    super().__init__()
    self.dropout = dropout
    self.norm = LayerNorm(dim, generator.device)
    self.up = Dense(dim, 2 * dim, generator)
    self.down = Dense(2 * dim, dim, generator)

  def forward(self, x, masks: Optional[DropoutMasks] = None):
    h = torch.relu(dropout(self.up(self.norm(x)), self.dropout, masks))
    y = self.down(h)
    if self.tp_group is not None:
      y = mesh_lib.all_reduce_(y, self.tp_group)
    return dropout(y, self.dropout, masks)


class ConvHead(nn.Module):
  """1x1 conv to n_tasks, then the mean over L (no norm, no act).
  ``tp_group``: as ``FeedForwardBlock``'s, summed before the mean."""

  tp_group = None

  def __init__(self, n_tasks: int, in_channels: int,
               generator: torch.Generator):
    super().__init__()
    self.kernel = conv_param(1, in_channels, n_tasks, generator)
    self.bias = nn.Parameter(torch.zeros(n_tasks,
                                         device=generator.device))

  def forward(self, x):
    y = torch.matmul(x, self.kernel[0].to(x.dtype)) + self.bias.to(x.dtype)
    if self.tp_group is not None:
      y = mesh_lib.all_reduce_(y, self.tp_group)
    return y.mean(dim=1)
