"""CNN denoiser backbone (``svdd_tpu/models/cnn.py:CNNModel``).

Channel-last (N, L, C) throughout. 5 * num_cnn_stacks dilated k=9
layers, dilations (1, 1, 4, 16, 64) each repeated num_cnn_stacks times
consecutively; each layer is relu(conv(LN(x + time_i(emb)))) + x through
the fused kernels of ``ops/cnn_layer.py``, whose backward is a kernel
too. Conv kernels are kept in the flax (K, Cin, Cout) layout, which the
layer kernel reads tap by tap. A one-hot input (``x_onehot``, the
``forward2`` path of DPS guidance) replaces the token one-hot, so a
gradient with respect to it flows through every layer.

Training (``train=True``) with ``model.dropout > 0`` drops each layer's
input and adds the undropped activations as the residual, through the
plain version (no launch), as JAX takes ``cnn_layer_reference`` there;
the keep masks come from the forward's generator. At the default
dropout 0 training runs the kernels, B1 forward and B6 backward; the
stem and the two 1x1 convs, which no kernel computes, then take
``conv1d_deterministic``, whose backward sums in a fixed order. The
JAX package's ``SVDD_REMAT_CNN_LAYERS`` has no counterpart: the layer's
autograd function saves only its inputs, and B6 recomputes the relu mask
from them, which is what JAX's per-layer remat buys.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models.blocks import Dense, conv_param
from svdd_tpu_torch.ops.cnn_layer import cnn_layer, cnn_layer_plain
from svdd_tpu_torch.ops.conv1d import conv1d_deterministic, conv1d_shifted


class GaussianFourierProjection(nn.Module):
  """Random-feature time encoding; W is a frozen buffer."""

  def __init__(self, embed_dim: int, generator: torch.Generator,
               scale: float = 30.0):
    super().__init__()
    self.register_buffer('W', scale * torch.randn(
        embed_dim // 2, generator=generator,
        device=generator.device))

  def forward(self, t: torch.Tensor) -> torch.Tensor:
    x_proj = t[:, None] * self.W[None, :] * 2 * math.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class CNNLayer(nn.Module):
  """Parameters of one dilated layer: the LN, the k=9 conv and the
  per-layer time projection (flax names norm_i, conv_i, time_i)."""

  def __init__(self, hidden: int, dilation: int,
               generator: torch.Generator):
    super().__init__()
    dev = generator.device
    self.dilation = dilation
    self.ln_scale = nn.Parameter(torch.ones(hidden, device=dev))
    self.ln_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    self.kernel = conv_param(9, hidden, hidden, generator)
    self.conv_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    self.time = Dense(hidden, hidden, generator)

  def forward(self, feat, time_emb, keep=None, keep_prob: float = 1.0):
    """``keep`` (feat's shape, bool): a dropout mask with keep
    probability ``keep_prob``; the layer then reads the dropped input and
    adds ``feat`` as the residual, through the plain version."""
    bias_row = self.time(time_emb)
    kernel = self.kernel.to(feat.dtype)
    if keep is None:
      return cnn_layer(feat, bias_row, self.ln_scale, self.ln_bias, kernel,
                       self.conv_bias, dilation=self.dilation)
    h = torch.where(keep, feat / keep_prob, torch.zeros_like(feat))
    return cnn_layer_plain(h, bias_row, self.ln_scale, self.ln_bias, kernel,
                           self.conv_bias, dilation=self.dilation,
                           residual=feat)


class CNNModel(nn.Module):
  """Dilated-conv MDLM denoiser: int tokens (N, L) -> logits (N, L, V)
  in float32."""

  def __init__(self, config: Config, alphabet_size: int = 5,
               compute_dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None):
    super().__init__()
    mcfg = config.model
    if mcfg.cls_free_guidance:
      raise NotImplementedError('classifier-free guidance is not ported')
    if generator is None:
      generator = torch.Generator().manual_seed(config.seed)
    hidden = mcfg.hidden_dim
    dev = generator.device
    self.alphabet_size = alphabet_size
    self.compute_dtype = compute_dtype
    self.dropout = mcfg.dropout
    self.gfp = GaussianFourierProjection(hidden, generator)
    self.time_linear = Dense(hidden, hidden, generator)
    self.stem_kernel = conv_param(9, alphabet_size, hidden, generator)
    self.stem_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    dilations = [d for d in (1, 1, 4, 16, 64)
                 for _ in range(mcfg.num_cnn_stacks)]
    self.layers = nn.ModuleList(
        [CNNLayer(hidden, d, generator) for d in dilations])
    self.final_0_kernel = conv_param(1, hidden, hidden, generator)
    self.final_0_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    self.final_1_kernel = conv_param(1, hidden, alphabet_size, generator)
    self.final_1_bias = nn.Parameter(
        torch.zeros(alphabet_size, device=dev))

  def forward(self, seq: torch.Tensor, sigma: torch.Tensor,
              x_onehot: torch.Tensor | None = None, train: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """``x_onehot`` (N, L, V), when given, is the input in place of the
    one-hot of ``seq``. ``train`` with ``model.dropout > 0`` draws each
    layer's dropout mask from ``generator``."""
    dtype = self.compute_dtype
    if x_onehot is None:
      feat = F.one_hot(seq.long(), self.alphabet_size).to(dtype)
    else:
      feat = x_onehot.to(dtype)
    t_feats = self.gfp(sigma.float())
    time_emb = torch.relu(self.time_linear(t_feats.to(dtype)))
    conv = conv1d_deterministic if train else conv1d_shifted
    feat = torch.relu(conv(feat, self.stem_kernel, self.stem_bias))
    rate = self.dropout if train else 0.0
    for layer in self.layers:
      keep = None
      if rate > 0:
        u = torch.rand(feat.shape, generator=generator, device=feat.device)
        keep = u < 1 - rate
      feat = layer(feat, time_emb, keep, 1 - rate)
    feat = torch.relu(conv(feat, self.final_0_kernel, self.final_0_bias))
    feat = conv(feat, self.final_1_kernel, self.final_1_bias)
    return feat.float()
