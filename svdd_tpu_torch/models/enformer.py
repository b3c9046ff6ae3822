"""Enformer value trunk for the DNA task (``svdd_tpu/models/enformer.py``).

Conv tower: a k=15 stem conv, then attention-pooled NACDR conv blocks
whose channels grow exponentially to ``channels``. The eval forward
hands each pool to the next k=5 block's fused pool+prologue+im2col
kernel. ``fused=False`` runs every block in its plain differentiable
form instead (norm, act, conv, then the pool kernel with the residual),
the counterpart of the JAX package's ``blocks.unfused_guard``: the
guidance gradients take that form, whose convs and pools have backward
kernels (``ops/conv1d.py``, ``ops/attn_pool.py``). At L=200 the
tower pools 200 -> 100 -> 50 -> 25 -> 13 -> 7 -> 4 -> 2, so the
transformer stack runs at length 2, where the attention goes through
the L=2 kernel (``ops/attn_l2.py``); other lengths take the general
relative-position attention in plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.ops.attn_l2 import attn_l2
from svdd_tpu_torch.ops.conv1d import conv1d_shifted
from svdd_tpu_torch.ops.kernel_utils import gelu_enformer


def exponential_linspace_int(start: int, end: int, num: int,
                             divisible_by: int = 1) -> list[int]:
  """Exponentially spaced channel schedule."""
  def _round(x):
    return int(round(x / divisible_by) * divisible_by)
  base = math.exp(math.log(end / start) / (num - 1))
  return [_round(start * base ** i) for i in range(num)]


# ---------------------------------------------------------------------------
# Relative positional basis (exponential / central-mask / gamma)
# ---------------------------------------------------------------------------


def _pos_feats_exponential(positions, features, seq_len,
                           min_half_life: float = 3.0):
  max_range = math.log(seq_len) / math.log(2.0)
  half_life = 2.0 ** np.linspace(min_half_life, max_range, features)
  return np.exp(-math.log(2.0) / half_life[None, :]
                * np.abs(positions)[:, None])


def _pos_feats_central_mask(positions, features):
  center_widths = 2.0 ** np.arange(1, features + 1) - 1
  return (center_widths[None, :] > np.abs(positions)[:, None]
          ).astype(np.float32)


def _gamma_log_pdf(x, concentration, rate):
  gammaln = np.vectorize(math.lgamma)
  logx = np.where(x > 0, np.log(np.maximum(x, 1e-20)), -np.inf)
  with np.errstate(invalid='ignore'):
    out = (np.log(rate) * concentration
           + np.where(concentration == 1.0, 0.0,
                      logx * (concentration - 1))
           - rate * x - gammaln(concentration))
  return np.where(np.isfinite(out), out, -np.inf)


def _pos_feats_gamma(positions, features, seq_len, eps: float = 1e-8):
  stddev = seq_len / (2 * features)
  start_mean = seq_len / features
  mean = np.linspace(start_mean, seq_len, features)[None, :]
  concentration = (mean / stddev) ** 2
  rate = mean / stddev ** 2
  logp = _gamma_log_pdf(np.abs(positions).astype(np.float64)[:, None],
                        concentration, rate)
  logmax = np.amax(logp, axis=-1, keepdims=True)
  logmax = np.where(np.isfinite(logmax), logmax, 0.0)
  probs = np.exp(logp - logmax) + eps
  return (probs / np.amax(probs, axis=-1, keepdims=True)
          ).astype(np.float32)


def relative_positional_basis(seq_len: int, feature_size: int
                              ) -> np.ndarray:
  """(2L-1, 6 * (feature_size // 6)) basis over distances
  [-(L-1), L-1]: three families, each also mirrored by sign(distance)."""
  distances = np.arange(-seq_len + 1, seq_len)
  n = max(1, feature_size // 6)
  emb = np.concatenate([
      _pos_feats_exponential(distances, n, seq_len),
      _pos_feats_central_mask(distances, n),
      _pos_feats_gamma(distances, n, seq_len),
  ], axis=-1)
  emb = np.concatenate([emb, np.sign(distances)[:, None] * emb], axis=-1)
  return emb.astype(np.float32)


def relative_shift(x: torch.Tensor) -> torch.Tensor:
  """(B, H, L, 2L-1) relative logits -> (B, H, L, L) aligned ones."""
  b, h, l, _ = x.shape
  x = torch.nn.functional.pad(x, (1, 0))
  x = x.reshape(b, h, 2 * l, l)[:, :, 1:, :]
  return x.reshape(b, h, l, 2 * l - 1)[..., :l]


class EnformerAttention(nn.Module):
  """MHA with Enformer's relative positional bias."""

  def __init__(self, dim: int, generator: torch.Generator, heads: int = 8,
               dim_key: int = 64, dim_value: int = 192,
               num_rel_pos_features: int = 192):
    super().__init__()
    dev = generator.device
    self.heads, self.dim_key, self.dim_value = heads, dim_key, dim_value
    self.num_rel_pos_features = num_rel_pos_features
    self.to_q = blocks.Dense(dim, heads * dim_key, generator, bias=False)
    self.to_k = blocks.Dense(dim, heads * dim_key, generator, bias=False)
    self.to_v = blocks.Dense(dim, heads * dim_value, generator, bias=False)
    n_feat = 6 * max(1, num_rel_pos_features // 6)
    self.to_rel_k = blocks.Dense(n_feat, heads * dim_key, generator,
                                 bias=False)
    self.rel_content_bias = nn.Parameter(torch.randn(
        heads * dim_key, generator=generator, device=dev))
    self.rel_pos_bias = nn.Parameter(torch.randn(
        heads * dim_key, generator=generator, device=dev))
    self.to_out = blocks.Dense(heads * dim_value, dim, generator)
    self._positions = {}

  def positions(self, n: int, x: torch.Tensor) -> torch.Tensor:
    key = (n, x.device, x.dtype)
    if key not in self._positions:
      self._positions[key] = torch.as_tensor(
          relative_positional_basis(n, self.num_rel_pos_features),
          dtype=x.dtype, device=x.device)
    return self._positions[key]

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, n, _ = x.shape
    h, dk, dv = self.heads, self.dim_key, self.dim_value
    q = self.to_q(x) / math.sqrt(dk)
    k = self.to_k(x)
    v = self.to_v(x)
    rel_k = self.to_rel_k(self.positions(n, x))            # (2n-1, h*dk)
    bc = self.rel_content_bias.to(x.dtype)
    bp = self.rel_pos_bias.to(x.dtype)
    if n == 2:
      out, _ = attn_l2(q, k, v, bc, bp, rel_k, heads=h)
      return self.to_out(out)
    q = q.reshape(b, n, h, dk).transpose(1, 2)
    k = k.reshape(b, n, h, dk).transpose(1, 2)
    v = v.reshape(b, n, h, dv).transpose(1, 2)
    content = torch.einsum('bhid,bhjd->bhij', q + bc.reshape(h, 1, dk), k)
    rel_k = rel_k.reshape(2 * n - 1, h, dk).transpose(0, 1)
    rel = relative_shift(torch.einsum(
        'bhid,hjd->bhij', q + bp.reshape(h, 1, dk), rel_k))
    attn = torch.softmax((content + rel).float(), dim=-1).to(x.dtype)
    out = torch.einsum('bhij,bhjd->bhid', attn, v)
    return self.to_out(out.transpose(1, 2).reshape(b, n, h * dv))


class EnformerTransformerBlock(nn.Module):
  """Pre-LN attention and FFN, each with a residual."""

  def __init__(self, dim: int, generator: torch.Generator,
               n_heads: int = 8, key_len: int = 64):
    super().__init__()
    self.norm = blocks.LayerNorm(dim, generator.device)
    self.attn = EnformerAttention(
        dim, generator, heads=n_heads, dim_key=key_len,
        dim_value=dim // n_heads, num_rel_pos_features=dim // n_heads)
    self.ffn = blocks.FeedForwardBlock(dim, generator)

  def forward(self, x):
    x = x + self.attn(self.norm(x))
    return x + self.ffn(x)


class EnformerConvTower(nn.Module):
  """Stem conv + attention-pooled conv blocks. (N, L, 4) one-hot ->
  (N, L / 2^n_blocks rounded up, out_channels)."""

  def __init__(self, generator: torch.Generator, n_blocks: int = 7,
               out_channels: int = 1536):
    super().__init__()
    half = out_channels // 2
    self.stem_kernel = blocks.conv_param(15, 4, half, generator)
    self.stem_bias = nn.Parameter(torch.zeros(half,
                                              device=generator.device))
    self.stem_block = blocks.ConvBlock(half, half, 1, generator,
                                       residual=True, pool=True)
    filters = [half] + exponential_linspace_int(
        half, out_channels, num=n_blocks - 1, divisible_by=128)
    self.convs = nn.ModuleList()
    self.pools = nn.ModuleList()
    for i in range(1, n_blocks):
      self.convs.append(blocks.ConvBlock(filters[i - 1], filters[i], 5,
                                         generator))
      self.pools.append(blocks.ConvBlock(filters[i], filters[i], 1,
                                         generator, residual=True,
                                         pool=True))

  def forward(self, x, fused: bool = True):
    x = conv1d_shifted(x, self.stem_kernel, self.stem_bias)
    x = self.stem_block(x, defer_pool=fused and len(self.convs) > 0)
    for i, (conv, pool) in enumerate(zip(self.convs, self.pools)):
      x = pool(conv(x), defer_pool=fused and i < len(self.convs) - 1)
    return x


class EnformerTrunk(nn.Module):
  """Conv tower + transformer stack + pointwise 2x conv.
  (N, L, 4) one-hot -> (N, L', 2 * channels)."""

  def __init__(self, generator: torch.Generator, n_conv: int = 7,
               channels: int = 1536, n_transformers: int = 11,
               n_heads: int = 8, key_len: int = 64):
    super().__init__()
    self.tower = EnformerConvTower(generator, n_blocks=n_conv,
                                   out_channels=channels)
    self.transformers = nn.ModuleList([
        EnformerTransformerBlock(channels, generator, n_heads, key_len)
        for _ in range(n_transformers)])
    self.pointwise = blocks.ConvBlock(channels, 2 * channels, 1,
                                      generator)

  def forward(self, x, fused: bool = True):
    x = self.tower(x, fused)
    for block in self.transformers:
      x = block(x)
    return gelu_enformer(self.pointwise(x))


class EnformerValueModel(nn.Module):
  """Trunk + average-pool ConvHead: (N, L, 4) one-hot -> (N,) value
  (or (N, n_tasks)), in float32. ``fused=False`` takes the
  differentiable tower (module docstring)."""

  def __init__(self, n_tasks: int = 1, n_conv: int = 7,
               channels: int = 1536, n_transformers: int = 11,
               n_heads: int = 8, key_len: int = 64,
               compute_dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None):
    super().__init__()
    if generator is None:
      generator = torch.Generator().manual_seed(1)
    self.n_tasks = n_tasks
    self.compute_dtype = compute_dtype
    self.trunk = EnformerTrunk(generator, n_conv, channels,
                               n_transformers, n_heads, key_len)
    self.head = blocks.ConvHead(n_tasks, 2 * channels, generator)

  def forward(self, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
    x = self.head(self.trunk(x.to(self.compute_dtype), fused)).float()
    return x[..., 0] if self.n_tasks == 1 else x
