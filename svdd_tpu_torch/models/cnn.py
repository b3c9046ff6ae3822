"""CNN denoiser backbone (``svdd_tpu/models/cnn.py:CNNModel``).

Channel-last (N, L, C) throughout. 5 * num_cnn_stacks dilated k=9
layers, dilations (1, 1, 4, 16, 64) each repeated num_cnn_stacks times
consecutively; each layer is relu(conv(LN(x + time_i(emb)))) + x through
the fused kernels of ``ops/cnn_layer.py``, whose backward is a kernel
too.

``model.cls_free_guidance`` conditions on a class (``svdd_tpu/models/
cnn.py:114-122, :137-141``): ``cls_embedder`` embeds it (num_cls + 1
rows; without a class every row takes the null class ``num_cls``) and
each layer adds ``cls_i`` of the embedding to its bias row, which the
layer kernel takes as it takes the time row alone. ``classifier=True``
(which takes no class embedding) makes the net a classifier
(``:171-180``): ``final_1`` maps to ``hidden``, then a mean over L,
``cls_0``, relu and ``cls_1`` give (N, num_cls) logits.

Conv kernels are kept in the flax (K, Cin, Cout) layout, which the
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
from svdd_tpu_torch.models.blocks import Dense, conv_param, lecun_normal
from svdd_tpu_torch.ops.cnn_layer import cnn_layer, cnn_layer_plain
from svdd_tpu_torch.ops.conv1d import conv1d_deterministic, conv1d_shifted
from svdd_tpu_torch.parallel import rows


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
  """Parameters of one dilated layer: the LN, the k=9 conv, the per-layer
  time projection and, class-conditioned, the class projection (flax
  names norm_i, conv_i, time_i, cls_i)."""

  def __init__(self, hidden: int, dilation: int,
               generator: torch.Generator, cls_conditioned: bool = False):
    super().__init__()
    dev = generator.device
    self.dilation = dilation
    self.ln_scale = nn.Parameter(torch.ones(hidden, device=dev))
    self.ln_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    self.kernel = conv_param(9, hidden, hidden, generator)
    self.conv_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    self.time = Dense(hidden, hidden, generator)
    self.cls = Dense(hidden, hidden, generator) if cls_conditioned else None

  def bias_row(self, time_emb, cls_emb=None):
    """The (N, hidden) row added to the layer's input: the time
    projection, plus the class projection of ``cls_emb`` (N, hidden) in a
    class-conditioned net."""
    bias_row = self.time(time_emb)
    if cls_emb is not None:
      bias_row = bias_row + self.cls(cls_emb)
    return bias_row

  def forward(self, feat, time_emb, keep=None, keep_prob: float = 1.0,
              cls_emb=None):
    """``keep`` (feat's shape, bool): a dropout mask with keep
    probability ``keep_prob``; the layer then reads the dropped input and
    adds ``feat`` as the residual, through the plain version.
    ``cls_emb``: as ``bias_row`` takes it."""
    bias_row = self.bias_row(time_emb, cls_emb)
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
  in float32 (a classifier: (N, num_cls) logits)."""

  def __init__(self, config: Config, alphabet_size: int = 5,
               compute_dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None, num_cls: int = 3,
               classifier: bool = False):
    super().__init__()
    mcfg = config.model
    if generator is None:
      generator = torch.Generator().manual_seed(config.seed)
    hidden = mcfg.hidden_dim
    dev = generator.device
    self.alphabet_size = alphabet_size
    self.compute_dtype = compute_dtype
    self.num_cls = num_cls
    self.classifier = classifier
    cls_conditioned = mcfg.cls_free_guidance and not classifier
    self.dropout = mcfg.dropout
    self.gfp = GaussianFourierProjection(hidden, generator)
    self.time_linear = Dense(hidden, hidden, generator)
    self.stem_kernel = conv_param(9, alphabet_size, hidden, generator)
    self.stem_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    dilations = [d for d in (1, 1, 4, 16, 64)
                 for _ in range(mcfg.num_cnn_stacks)]
    self.layers = nn.ModuleList(
        [CNNLayer(hidden, d, generator, cls_conditioned) for d in dilations])
    self.final_0_kernel = conv_param(1, hidden, hidden, generator)
    self.final_0_bias = nn.Parameter(torch.zeros(hidden, device=dev))
    out_dim = hidden if classifier else alphabet_size
    self.final_1_kernel = conv_param(1, hidden, out_dim, generator)
    self.final_1_bias = nn.Parameter(torch.zeros(out_dim, device=dev))
    self.cls_embedder = (nn.Parameter(lecun_normal(
        (num_cls + 1, hidden), hidden, generator)) if cls_conditioned
                         else None)
    if classifier:
      self.cls_0 = Dense(hidden, hidden, generator)
      self.cls_1 = Dense(hidden, num_cls, generator)

  def forward(self, seq: torch.Tensor, sigma: torch.Tensor,
              x_onehot: torch.Tensor | None = None, train: bool = False,
              generator: torch.Generator | None = None,
              cls: torch.Tensor | None = None) -> torch.Tensor:
    """``x_onehot`` (N, L, V), when given, is the input in place of the
    one-hot of ``seq``. ``train`` with ``model.dropout > 0`` draws each
    layer's dropout mask from ``generator``. ``cls`` (N,) int: the class
    of a class-conditioned net (the null class ``num_cls`` without)."""
    dtype = self.compute_dtype
    if x_onehot is None:
      feat = F.one_hot(seq.long(), self.alphabet_size).to(dtype)
    else:
      feat = x_onehot.to(dtype)
    t_feats = self.gfp(sigma.float())
    time_emb = torch.relu(self.time_linear(t_feats.to(dtype)))
    conv = conv1d_deterministic if train else conv1d_shifted
    feat = torch.relu(conv(feat, self.stem_kernel, self.stem_bias))
    cls_emb = None
    if self.cls_embedder is not None:
      if cls is None:
        cls = torch.full((feat.shape[0],), self.num_cls, dtype=torch.long,
                         device=feat.device)
      cls_emb = self.cls_embedder.to(dtype)[cls.long()]
    rate = self.dropout if train else 0.0
    for layer in self.layers:
      keep = None
      if rate > 0:
        u = rows.rand(feat.shape, generator, feat.device)
        keep = u < 1 - rate
      feat = layer(feat, time_emb, keep, 1 - rate, cls_emb)
    feat = torch.relu(conv(feat, self.final_0_kernel, self.final_0_bias))
    feat = conv(feat, self.final_1_kernel, self.final_1_bias)
    if self.classifier:
      feat = torch.relu(self.cls_0(feat.mean(dim=1)))
      feat = self.cls_1(feat)
    return feat.float()
