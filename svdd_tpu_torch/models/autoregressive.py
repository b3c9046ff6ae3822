"""AR (causal transformer) backbone, forward only
(``svdd_tpu/models/autoregressive.py``: ``ARBlock``, ``ARModel``).

The repo's own causal LM; here it scores generated samples for the
generative perplexity (``eval/gen_ppl.py``). Attention is
``flash_mha(causal=True)`` (kernel B12 on the card). The dtype flow is
the DiT's (``models/dit.py``): at bf16 the embedding and the rotary
tables are rounded to bf16, block 0's first LayerNorm returns bf16 and
its Dense layers make f32 from there on. The LayerNorms use flax's
default eps 1e-6. ``ar_sample`` and ``ar_sample_kv`` are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models.dit import (FlaxDense, FlaxLayerNorm, attention,
                                       rotary_cos_sin)

LN_EPS = 1e-6


class ARBlock(nn.Module):
  """Causal transformer block."""

  def __init__(self, dim: int, n_heads: int, generator: torch.Generator,
               mlp_ratio: int = 4):
    super().__init__()
    dev = generator.device
    self.n_heads = n_heads
    self.norm_0 = FlaxLayerNorm(dim, LN_EPS, dev)
    self.attn_qkv = FlaxDense(dim, 3 * dim, generator, bias=False)
    self.attn_out = FlaxDense(dim, dim, generator, bias=False)
    self.norm_1 = FlaxLayerNorm(dim, LN_EPS, dev)
    self.mlp_0 = FlaxDense(dim, mlp_ratio * dim, generator)
    self.mlp_1 = FlaxDense(mlp_ratio * dim, dim, generator)

  def forward(self, x, cos, sin):
    x = x + attention(self.attn_qkv, self.attn_out, self.norm_0(x), cos, sin,
                      self.n_heads, causal=True)
    y = self.mlp_1(F.gelu(self.mlp_0(self.norm_1(x)), approximate='tanh'))
    return x + y


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
    self.vocab_embed = nn.Parameter(0.02 * torch.randn(
        vocab_size, dim, generator=generator, device=dev))
    self.blocks = nn.ModuleList(ARBlock(dim, mcfg.n_heads, generator)
                                for _ in range(mcfg.n_blocks))
    self.norm = FlaxLayerNorm(dim, LN_EPS, dev)
    self.lm_head = FlaxDense(dim, vocab_size, generator)

  def forward(self, indices: torch.Tensor,
              sigma: torch.Tensor | None = None) -> torch.Tensor:
    del sigma
    cdt = self.compute_dtype
    x = self.vocab_embed[indices].to(cdt)
    cos, sin = rotary_cos_sin(x.shape[1], x.shape[2] // self.n_heads,
                              device=x.device)
    cos, sin = cos.to(cdt), sin.to(cdt)
    for block in self.blocks:
      x = block(x, cos, sin)
    logits = self.lm_head(self.norm(x))
    return torch.log_softmax(logits.float(), dim=-1)
