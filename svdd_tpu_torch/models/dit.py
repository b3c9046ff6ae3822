"""DiT denoiser backbone (``svdd_tpu/models/dit.py``): rotary adaLN-zero
transformer blocks, the sinusoidal timestep embedder and the zero-init
final layer. Attention runs through ``ops.attention.flash_mha`` (kernel
B12 on the card).

The dtype flow is flax's, op by op. A ``Dense`` without a dtype promotes
its input with the f32 weights, so it returns f32 for a bf16 input; the
LayerNorms return their input's type. At ``compute_dtype=bfloat16`` the
token embedding, the conditioning ``c`` and the rotary tables are
rounded to bf16, block 0's first LayerNorm returns bf16, and ``modulate``
with the f32 shift and scale makes f32 from there on, so the attention
gets f32 q, k and v.

Random init follows flax: lecun-normal Dense kernels, zero biases, unit
LayerNorm scales, kaiming-uniform token embedding, and zeros for the
``adaLN`` layers and the final ``linear`` (so a random DiT's logits are
0 until those are drawn otherwise).

``x_onehot`` (N, L, V) replaces the token lookup by ``x_onehot @
vocab_embed``, differentiable in it (the gradient-guided decoders).
Training (``train=True``) applies flax's dropout at ``model.dropout``
after the attention output and the MLP of each block, its masks from a
``blocks.DropoutMasks`` (drawn from ``generator``, or ``masks``, a list
in call order).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.models.blocks import Dense
from svdd_tpu_torch.ops import attention as attn_ops


class FlaxDense(Dense):
  """flax ``nn.Dense`` without a dtype: input and weights are promoted
  to a common type (f32 for a bf16 input and f32 weights)."""

  def __init__(self, in_features: int, out_features: int,
               generator: torch.Generator, bias: bool = True,
               zero: bool = False):
    super().__init__(in_features, out_features, generator, bias=bias)
    if zero:
      with torch.no_grad():
        self.weight.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, self.weight.dtype)
    return F.linear(x.to(dt), self.weight.to(dt),
                    None if self.bias is None else self.bias.to(dt))


class FlaxLayerNorm(nn.Module):
  """flax ``nn.LayerNorm(use_bias=False, dtype=x.dtype)``: f32
  statistics with the fast variance E[x^2] - E[x]^2, the result in the
  input's type."""

  def __init__(self, dim: int, eps: float, device=None):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(dim, device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0)
    y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.scale.float())
    return y.to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10_000) -> torch.Tensor:
  """Sinusoidal features: [cos | sin] halves."""
  half = dim // 2
  freqs = torch.exp(-math.log(max_period) * torch.arange(
      half, dtype=torch.float32, device=t.device) / half)
  args = t[:, None].float() * freqs[None]
  emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
  if dim % 2:
    emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
  return emb


class TimestepEmbedder(nn.Module):
  """MLP over sinusoidal features (flax ``Dense_0``, ``Dense_1``)."""

  def __init__(self, hidden_size: int, generator: torch.Generator,
               frequency_embedding_size: int = 256):
    super().__init__()
    self.frequency_embedding_size = frequency_embedding_size
    self.dense_0 = FlaxDense(frequency_embedding_size, hidden_size,
                             generator)
    self.dense_1 = FlaxDense(hidden_size, hidden_size, generator)

  def forward(self, t: torch.Tensor) -> torch.Tensor:
    x = timestep_embedding(t, self.frequency_embedding_size)
    return self.dense_1(F.silu(self.dense_0(x)))


def rotary_cos_sin(seq_len: int, head_dim: int, base: float = 10_000.0,
                   device=None):
  """(L, D/2) cos and sin tables in f32."""
  inv_freq = 1.0 / (base ** (torch.arange(
      0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
  t = torch.arange(seq_len, dtype=torch.float32, device=device)
  freqs = torch.outer(t, inv_freq)
  return torch.cos(freqs), torch.sin(freqs)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
  """Rotate the two halves of the head dim; x (B, L, H, D)."""
  d2 = x.shape[-1] // 2
  x1, x2 = x[..., :d2], x[..., d2:]
  cos = cos[None, :, None, :]
  sin = sin[None, :, None, :]
  return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
  """x * (1 + scale) + shift with (B, D) conditioning."""
  return x * (1 + scale[:, None]) + shift[:, None]


def attention(qkv_proj: nn.Module, out_proj: nn.Module, xm: torch.Tensor,
              cos, sin, n_heads: int, causal: bool) -> torch.Tensor:
  """The fused qkv projection, rotary q and k, B12 attention and the
  output projection; xm (B, L, dim). v enters the attention as a view of
  the projection (the kernel reads it by stride)."""
  b, l, dim = xm.shape
  qkv = qkv_proj(xm).view(b, l, 3, n_heads, dim // n_heads)
  q = apply_rotary(qkv[:, :, 0], cos, sin)
  k = apply_rotary(qkv[:, :, 1], cos, sin)
  o = attn_ops.flash_mha(q, k, qkv[:, :, 2], causal=causal)
  return out_proj(o.reshape(b, l, dim))


def embed_tokens(embed: torch.Tensor, indices, x_onehot, dtype):
  """The token embedding, or ``x_onehot @ embed`` given a one-hot input,
  in ``dtype``."""
  x = embed[indices] if x_onehot is None else x_onehot.to(embed.dtype) @ embed
  return x.to(dtype)


def training_masks(train: bool, rate: float, generator, masks):
  """The ``DropoutMasks`` of a forward: None in eval or at rate 0, the
  given list of masks, else drawn from ``generator``."""
  if not train or rate == 0.0:
    return None
  if masks is not None:
    return blocks.DropoutMasks(masks=masks)
  if generator is None:
    raise ValueError('a training forward with dropout needs a generator '
                     'or the masks')
  return blocks.DropoutMasks(generator=generator)


class DDiTBlock(nn.Module):
  """adaLN-zero transformer block."""

  def __init__(self, dim: int, n_heads: int, cond_dim: int,
               generator: torch.Generator, mlp_ratio: int = 4,
               dropout: float = 0.0):
    super().__init__()
    dev = generator.device
    self.n_heads = n_heads
    self.dropout = dropout
    self.adaLN = FlaxDense(cond_dim, 6 * dim, generator, zero=True)
    self.norm_0 = FlaxLayerNorm(dim, 1e-5, dev)
    self.attn_qkv = FlaxDense(dim, 3 * dim, generator, bias=False)
    self.attn_out = FlaxDense(dim, dim, generator, bias=False)
    self.norm_1 = FlaxLayerNorm(dim, 1e-5, dev)
    self.mlp_0 = FlaxDense(dim, mlp_ratio * dim, generator)
    self.mlp_1 = FlaxDense(mlp_ratio * dim, dim, generator)

  def forward(self, x, cos, sin, c, masks=None):
    (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
     gate_mlp) = self.adaLN(c).chunk(6, dim=-1)
    xm = modulate(self.norm_0(x), shift_msa, scale_msa)
    o = attention(self.attn_qkv, self.attn_out, xm, cos, sin,
                  self.n_heads, causal=False)
    x = x + gate_msa[:, None] * blocks.dropout(o, self.dropout, masks)
    xm = modulate(self.norm_1(x), shift_mlp, scale_mlp)
    y = self.mlp_1(F.gelu(self.mlp_0(xm), approximate='tanh'))
    return x + gate_mlp[:, None] * blocks.dropout(y, self.dropout, masks)


class DDitFinalLayer(nn.Module):
  """Zero-init output head with adaLN."""

  def __init__(self, hidden_size: int, out_channels: int, cond_dim: int,
               generator: torch.Generator):
    super().__init__()
    self.adaLN = FlaxDense(cond_dim, 2 * hidden_size, generator, zero=True)
    self.norm = FlaxLayerNorm(hidden_size, 1e-5, generator.device)
    self.linear = FlaxDense(hidden_size, out_channels, generator, zero=True)

  def forward(self, x, c):
    shift, scale = self.adaLN(c).chunk(2, dim=-1)
    return self.linear(modulate(self.norm(x), shift, scale))


class DIT(nn.Module):
  """Rotary adaLN-zero DiT: tokens (B, L) and sigma (B,) -> logits
  (B, L, V) in f32."""

  def __init__(self, config: Config, vocab_size: int,
               compute_dtype: torch.dtype = torch.bfloat16,
               generator: torch.Generator | None = None):
    super().__init__()
    mcfg = config.model
    if generator is None:
      generator = torch.Generator().manual_seed(config.seed)
    dev = generator.device
    dim = mcfg.hidden_size
    self.n_heads = mcfg.n_heads
    self.compute_dtype = compute_dtype
    self.dropout = mcfg.dropout
    # flax kaiming_uniform over (V, dim): fan_in V, variance 2 / V
    bound = math.sqrt(6.0 / vocab_size)
    self.vocab_embed = nn.Parameter(
        torch.empty(vocab_size, dim, device=dev).uniform_(
            -bound, bound, generator=generator))
    self.sigma_map = TimestepEmbedder(mcfg.cond_dim, generator)
    self.blocks = nn.ModuleList(
        DDiTBlock(dim, mcfg.n_heads, mcfg.cond_dim, generator,
                  dropout=mcfg.dropout)
        for _ in range(mcfg.n_blocks))
    self.output_layer = DDitFinalLayer(dim, vocab_size, mcfg.cond_dim,
                                       generator)

  def forward(self, indices: torch.Tensor, sigma: torch.Tensor, *,
              x_onehot: torch.Tensor | None = None, train: bool = False,
              generator: torch.Generator | None = None,
              masks=None, blocks_fn=None) -> torch.Tensor:
    """``blocks_fn(x, c, cos, sin) -> (x, c)`` runs the block stack in
    place of the loop over ``blocks`` (the pipelined forward's schedule,
    ``parallel/pipeline.py``)."""
    cdt = self.compute_dtype
    x = embed_tokens(self.vocab_embed, indices, x_onehot, cdt)
    c = F.silu(self.sigma_map(sigma)).to(cdt)
    cos, sin = rotary_cos_sin(x.shape[1], x.shape[2] // self.n_heads,
                              device=x.device)
    cos, sin = cos.to(cdt), sin.to(cdt)
    if blocks_fn is not None:
      x, c = blocks_fn(x, c, cos, sin)
    else:
      drop = training_masks(train, self.dropout, generator, masks)
      for block in self.blocks:
        x = block(x, cos, sin, c, drop)
    return self.output_layer(x, c).float()
