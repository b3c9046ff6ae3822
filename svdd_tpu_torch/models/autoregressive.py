"""AR (causal transformer) backbone and its decode loops
(``svdd_tpu/models/autoregressive.py``: ``ARBlock``, ``ARModel``,
``ar_sample``, ``ar_sample_kv``).

The repo's own causal LM: the ``parameterization='ar'`` baseline the
trainer fits with its shifted next-token loss, and the scorer of the
generative perplexity (``eval/gen_ppl.py``). Attention is
``flash_mha(causal=True)`` (kernel B12 on the card). The dtype flow is
the DiT's (``models/dit.py``): at bf16 the embedding and the rotary
tables are rounded to bf16, block 0's first LayerNorm returns bf16 and
its Dense layers make f32 from there on. The LayerNorms use flax's
default eps 1e-6. ``x_onehot`` and training dropout as in the DiT.

``ar_sample`` re-runs the whole prefix each position, as JAX's does;
``ar_sample_kv`` runs one token a position against per-block K/V caches
in the dtype flow of JAX's cached loop (its own LayerNorm with the two-
pass variance, every product in the compute dtype, the attention by
einsums over the cache with a position mask: no B12 launch, as JAX's
loop calls no Pallas kernel). Both take the Gumbel noise (B, L - 1, V)
injected, so a decode is pinned to JAX's on the same noise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.config import Config
from svdd_tpu_torch import mdlm
from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.models.dit import (FlaxDense, FlaxLayerNorm, attention,
                                       embed_tokens, rotary_cos_sin,
                                       training_masks)

LN_EPS = 1e-6


class ARBlock(nn.Module):
  """Causal transformer block."""

  def __init__(self, dim: int, n_heads: int, generator: torch.Generator,
               mlp_ratio: int = 4, dropout: float = 0.0):
    super().__init__()
    dev = generator.device
    self.n_heads = n_heads
    self.dropout = dropout
    self.norm_0 = FlaxLayerNorm(dim, LN_EPS, dev)
    self.attn_qkv = FlaxDense(dim, 3 * dim, generator, bias=False)
    self.attn_out = FlaxDense(dim, dim, generator, bias=False)
    self.norm_1 = FlaxLayerNorm(dim, LN_EPS, dev)
    self.mlp_0 = FlaxDense(dim, mlp_ratio * dim, generator)
    self.mlp_1 = FlaxDense(mlp_ratio * dim, dim, generator)

  def forward(self, x, cos, sin, masks=None):
    o = attention(self.attn_qkv, self.attn_out, self.norm_0(x), cos, sin,
                  self.n_heads, causal=True)
    x = x + blocks.dropout(o, self.dropout, masks)
    y = self.mlp_1(F.gelu(self.mlp_0(self.norm_1(x)), approximate='tanh'))
    return x + blocks.dropout(y, self.dropout, masks)


class ARModel(nn.Module):
  """Causal LM: tokens (B, L) -> next-token log-probs (B, L, V) in f32.
  ``sigma`` is accepted and ignored."""

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
    self.vocab_embed = nn.Parameter(0.02 * torch.randn(
        vocab_size, dim, generator=generator, device=dev))
    self.blocks = nn.ModuleList(
        ARBlock(dim, mcfg.n_heads, generator, dropout=mcfg.dropout)
        for _ in range(mcfg.n_blocks))
    self.norm = FlaxLayerNorm(dim, LN_EPS, dev)
    self.lm_head = FlaxDense(dim, vocab_size, generator)

  def forward(self, indices: torch.Tensor,
              sigma: torch.Tensor | None = None, *,
              x_onehot: torch.Tensor | None = None, train: bool = False,
              generator: torch.Generator | None = None,
              masks=None) -> torch.Tensor:
    del sigma
    cdt = self.compute_dtype
    x = embed_tokens(self.vocab_embed, indices, x_onehot, cdt)
    cos, sin = rotary_cos_sin(x.shape[1], x.shape[2] // self.n_heads,
                              device=x.device)
    cos, sin = cos.to(cdt), sin.to(cdt)
    drop = training_masks(train, self.dropout, generator, masks)
    for block in self.blocks:
      x = block(x, cos, sin, drop)
    logits = self.lm_head(self.norm(x))
    return torch.log_softmax(logits.float(), dim=-1)


def _gumbel(model: ARModel, batch_size: int, length: int, generator,
            noise) -> torch.Tensor:
  """The decode's (B, L - 1, V) Gumbel noise: ``noise`` as given, else
  drawn from ``generator`` on the model's device."""
  dev = model.vocab_embed.device
  if noise is not None:
    return torch.as_tensor(noise, dtype=torch.float32, device=dev)
  return mdlm.gumbel_noise((batch_size, length - 1,
                            model.vocab_embed.shape[0]), generator, dev)


def _bos(batch_size: int, length: int, bos_token: int, device):
  x = torch.zeros((batch_size, length), dtype=torch.long, device=device)
  x[:, 0] = bos_token
  return x


@torch.inference_mode()
def ar_sample(model: ARModel, batch_size: int, length: int,
              generator: torch.Generator | None = None, bos_token: int = 0,
              noise=None) -> torch.Tensor:
  """AR ancestral decode (``svdd_tpu/models/autoregressive.py:87-108``):
  position i + 1 is argmax(log p(. | x_<=i) + noise[:, i]), each step a
  forward of the whole length (the positions past i hold zeros, which
  the causal attention does not read)."""
  g = _gumbel(model, batch_size, length, generator, noise)
  x = _bos(batch_size, length, bos_token, g.device)
  sigma = torch.zeros(batch_size, device=g.device)
  for i in range(length - 1):
    logits = model(x, sigma)
    x[:, i + 1] = torch.argmax(logits[:, i] + g[:, i], dim=-1)
  return x


def _ln_kv(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """The cached loop's LayerNorm (eps 1e-6): f32 mean and two-pass
  variance, the normalised row rounded to x's type, then the scale in
  x's type."""
  x32 = x.float()
  mu = x32.mean(-1, keepdim=True)
  var = (x32 - mu).square().mean(-1, keepdim=True)
  out = (x32 - mu) * torch.rsqrt(var + LN_EPS)
  return out.to(x.dtype) * scale.to(x.dtype)


def _dense_kv(layer: FlaxDense, x: torch.Tensor) -> torch.Tensor:
  """x @ kernel (+ bias), the weights cast to x's type."""
  return F.linear(x, layer.weight.to(x.dtype),
                  None if layer.bias is None else layer.bias.to(x.dtype))


def _rot1(x, c, s):
  """Rotary embedding of one position: x (B, H, D), c, s (D/2,)."""
  d2 = x.shape[-1] // 2
  x1, x2 = x[..., :d2], x[..., d2:]
  return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


@torch.inference_mode()
def ar_sample_kv(model: ARModel, batch_size: int, length: int,
                 generator: torch.Generator | None = None,
                 bos_token: int = 0, noise=None) -> torch.Tensor:
  """KV-cached AR decode (``svdd_tpu/models/autoregressive.py:111-214``):
  the sampling rule and noise of ``ar_sample``, one token a position,
  each block's keys and values cached (B, L, H, D) and read under a
  position mask."""
  g = _gumbel(model, batch_size, length, generator, noise)
  dev, dtype, b = g.device, model.compute_dtype, batch_size
  dim = model.vocab_embed.shape[1]
  h = model.n_heads
  hd = dim // h
  cos, sin = rotary_cos_sin(length, hd, device=dev)
  cos, sin = cos.to(dtype), sin.to(dtype)
  ck = [torch.zeros((b, length, h, hd), dtype=dtype, device=dev)
        for _ in model.blocks]
  cv = [torch.zeros_like(c) for c in ck]
  x = _bos(b, length, bos_token, dev)
  pos = torch.arange(length, device=dev)
  for i in range(length - 1):
    xi = model.vocab_embed[x[:, i]].to(dtype)
    for j, blk in enumerate(model.blocks):
      xm = _ln_kv(blk.norm_0.scale, xi)
      qkv = _dense_kv(blk.attn_qkv, xm).reshape(b, 3, h, hd)
      q = _rot1(qkv[:, 0], cos[i], sin[i])
      ck[j][:, i] = _rot1(qkv[:, 1], cos[i], sin[i])
      cv[j][:, i] = qkv[:, 2]
      logits = torch.einsum('bhd,bjhd->bhj', q.float(),
                            ck[j].float()) / math.sqrt(hd)
      logits = logits.masked_fill(pos > i, float('-inf'))
      w = torch.softmax(logits, dim=-1).to(dtype)
      o = torch.einsum('bhj,bjhd->bhd', w, cv[j]).reshape(b, dim)
      xa = xi + _dense_kv(blk.attn_out, o)
      y = F.gelu(_dense_kv(blk.mlp_0, _ln_kv(blk.norm_1.scale, xa)),
                 approximate='tanh')
      xi = xa + _dense_kv(blk.mlp_1, y)
    logits = _dense_kv(model.lm_head, _ln_kv(model.norm.scale, xi)).float()
    logp = torch.log_softmax(logits, dim=-1)
    x[:, i + 1] = torch.argmax(logp + g[:, i], dim=-1)
  return x
