"""DiMamba backbone: the bidirectional Mamba MDLM denoiser
(``svdd_tpu/models/dimamba.py``).

Each block is fused add+RMSNorm (kernel B13 on the card), adaLN
modulation, a weight-tied BiMamba mixer and a gated residual. The
selective scan is ``lax.associative_scan`` in the JAX package, not a
Pallas kernel; here it is a loop over L carrying the (B, d_inner,
d_state) state, so the (B, L, d_inner, d_state) factors the parallel
scan builds are never made (at B=512 each would take 3.4 GB in f32).
The tied forward and reverse mixers run as one batch of 2B rows.

dtype flow at ``compute_dtype=bfloat16``: block 0's RMSNorm takes the
bf16 embedding and a bf16 scale and returns bf16; ``modulate`` with the
f32 adaLN shift and scale makes f32, so the mixers, the later blocks'
norms and the final norm run in f32. Random init follows flax, with the
``adaLN`` layers zero (a random block is then the identity).

``x_onehot`` (N, L, V) replaces the token lookup by ``x_onehot @
vocab_embed``, differentiable in it. The model has no dropout, so a
training forward is the eval one; autograd runs through the scan loop,
and B13's backward is the gradient of its plain version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models.blocks import lecun_normal
from svdd_tpu_torch.models.dit import (FlaxDense, TimestepEmbedder,
                                       embed_tokens, modulate)
from svdd_tpu_torch.ops.norms import fused_add_rmsnorm


def selective_scan(u, dt, A, B, C, D):
  """u, dt (b, l, d); A (d, n); B, C (b, l, n); D (d,) -> y (b, l, d).

  h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t;  y_t = C_t . h_t + D u_t,
  step by step over l."""
  b, l, d = u.shape
  h = u.new_zeros(b, d, A.shape[-1])
  ys = []
  for t in range(l):
    dt_t = dt[:, t, :, None]
    h = torch.addcmul(dt_t * B[:, t, None, :] * u[:, t, :, None],
                      torch.exp(dt_t * A), h)
    ys.append(torch.bmm(h, C[:, t, :, None]))
  y = torch.cat(ys, dim=-1).transpose(1, 2)
  return y + u * D


def causal_depthwise_conv(x, kernel, bias):
  """Depthwise causal conv over (b, l, d); kernel (k, d), as k shifted
  multiply-adds."""
  k, l = kernel.shape[0], x.shape[1]
  xp = F.pad(x, (0, 0, k - 1, 0))
  out = None
  for i in range(k):
    tap = xp[:, i:i + l, :] * kernel[i]
    out = tap if out is None else out + tap
  return out + bias


class MambaMixer(nn.Module):
  """One Mamba SSM mixer."""

  def __init__(self, d_model: int, generator: torch.Generator,
               d_state: int = 16, d_conv: int = 4, expand: int = 2):
    super().__init__()
    dev = generator.device
    d_inner = expand * d_model
    self.dt_rank = math.ceil(d_model / 16)
    self.d_state = d_state
    self.in_proj = FlaxDense(d_model, 2 * d_inner, generator, bias=False)
    self.conv_kernel = nn.Parameter(
        lecun_normal((d_conv, d_inner), d_conv, generator))
    self.conv_bias = nn.Parameter(torch.zeros(d_inner, device=dev))
    self.x_proj = FlaxDense(d_inner, self.dt_rank + 2 * d_state, generator,
                            bias=False)
    self.dt_proj = FlaxDense(self.dt_rank, d_inner, generator)
    self.A_log = nn.Parameter(torch.log(torch.arange(
        1, d_state + 1, dtype=torch.float32, device=dev)).repeat(d_inner, 1))
    self.D = nn.Parameter(torch.ones(d_inner, device=dev))
    self.out_proj = FlaxDense(d_inner, d_model, generator, bias=False)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    u, z = self.in_proj(x).chunk(2, dim=-1)
    u = F.silu(causal_depthwise_conv(u, self.conv_kernel.to(u.dtype),
                                     self.conv_bias.to(u.dtype)))
    dt, B, C = self.x_proj(u).split(
        [self.dt_rank, self.d_state, self.d_state], dim=-1)
    dt = F.softplus(self.dt_proj(dt))
    A = -torch.exp(self.A_log).to(u.dtype)
    y = selective_scan(u, dt, A, B, C, self.D.to(u.dtype))
    return self.out_proj(y * F.silu(z))


class BiMambaWrapper(nn.Module):
  """Forward + reverse mixer with tied weights: the reversed rows join
  the forward ones in one batch."""

  def __init__(self, d_model: int, generator: torch.Generator):
    super().__init__()
    self.mixer = MambaMixer(d_model, generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b = x.shape[0]
    out = self.mixer(torch.cat([x, x.flip(1)], dim=0))
    return out[:b] + out[b:].flip(1)


class DiMambaBlock(nn.Module):
  """Fused add+RMSNorm -> adaLN modulation -> BiMamba -> gated
  residual."""

  def __init__(self, d_model: int, cond_dim: int,
               generator: torch.Generator):
    super().__init__()
    self.adaLN = FlaxDense(cond_dim, 3 * d_model, generator, zero=True)
    self.norm_scale = nn.Parameter(torch.ones(d_model,
                                              device=generator.device))
    self.bimamba = BiMambaWrapper(d_model, generator)

  def forward(self, x, c):
    shift, scale, gate = self.adaLN(c).chunk(3, dim=-1)
    h = fused_add_rmsnorm(x, None, self.norm_scale.to(x.dtype))
    h = self.bimamba(modulate(h, shift, scale))
    return x + gate[:, None] * h


class DiMamba(nn.Module):
  """Bidirectional Mamba MDLM denoiser: tokens (B, L) and sigma (B,) ->
  logits (B, L, V) in f32."""

  def __init__(self, config: Config, vocab_size: int,
               compute_dtype: torch.dtype = torch.bfloat16,
               generator: torch.Generator | None = None):
    super().__init__()
    mcfg = config.model
    if generator is None:
      generator = torch.Generator().manual_seed(config.seed)
    dev = generator.device
    d = mcfg.d_model
    self.compute_dtype = compute_dtype
    self.vocab_embed = nn.Parameter(0.02 * torch.randn(
        vocab_size, d, generator=generator, device=dev))
    self.sigma_map = TimestepEmbedder(mcfg.cond_dim, generator)
    self.blocks = nn.ModuleList(DiMambaBlock(d, mcfg.cond_dim, generator)
                                for _ in range(mcfg.n_layer))
    self.final_norm_scale = nn.Parameter(torch.ones(d, device=dev))
    self.lm_head = FlaxDense(d, vocab_size, generator)

  def forward(self, indices: torch.Tensor, sigma: torch.Tensor, *,
              x_onehot: torch.Tensor | None = None, train: bool = False,
              generator: torch.Generator | None = None,
              masks=None) -> torch.Tensor:
    del train, generator, masks     # no dropout, as flax's DiMamba
    cdt = self.compute_dtype
    x = embed_tokens(self.vocab_embed, indices, x_onehot, cdt)
    c = F.silu(self.sigma_map(sigma)).to(cdt)
    for block in self.blocks:
      x = block(x, c)
    x = fused_add_rmsnorm(x, None, self.final_norm_scale.to(x.dtype))
    return self.lm_head(x).float()
