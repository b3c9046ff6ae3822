"""The ConvGRU value net of the RNA task (``svdd_tpu/models/convgru.py``):
a conv tower (stem conv 4 -> 64, k=15, then five residual BatchNorm
ConvBlocks of order CDNRA at k=5), a bidirectional GRU whose two
directions are summed, a two-layer FFN and an average-pool ConvHead.
The conv tower is the trunk Basenji shares.

The GRU is a plain PyTorch loop over L, as JAX's is a ``lax.scan``:
one bulk input projection of the whole sequence (a single GEMM a
direction), then the recurrence, whose gates follow flax's order r, z,
n with the hidden bias inside the reset product
(n = tanh(W_in x + b_in + r * (W_hn h + b_hn))). The two directions of
a layer step together (step t of the forward scan beside step L-1-t of
the reverse one) in one batched product, so a forward queues half the
launches; the reverse direction's outputs come back in the sequence's
order. No ``torch.nn.GRU``: cuDNN's GRU refuses a backward in eval mode
(the classifier and DPS gradients take one), and rounds otherwise.

Training (``train=True``, with the forward's ``DropoutMasks``): the
tower's BatchNorms on the batch, dropout in JAX's call order (the five
ConvBlocks' D, then the FFN's two; between stacked GRU layers, none at
``n_gru=1``), and the convs of the tower, off B7's gate at 64
channels, recorded through ``ops.conv1d._ConvPlainBwd``, whose backward
sums in a fixed order where cuDNN's weight gradient sums with atomics,
so a resumed run repeats the uninterrupted one bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from svdd_tpu_torch.models import blocks


class ConvTower(nn.Module):
  """Stem and (n_blocks - 1) ConvBlocks in order CDNRA whose widths grow
  from ``channel_init`` by ``channel_mult`` (``convgru.py:95-128``)."""

  def __init__(self, stem_in_channels: int, stem_channels: int,
               stem_kernel_size: int, generator: torch.Generator,
               n_blocks: int = 2, channel_init: int = 16,
               channel_mult: float = 1.0, kernel_size: int = 5,
               act_func: str = 'relu', norm: bool = False,
               pool_func: Optional[str] = None,
               pool_size: Optional[int] = None, residual: bool = False,
               dropout: float = 0.0):
    super().__init__()
    self.stem = blocks.Stem(stem_in_channels, stem_channels,
                            stem_kernel_size, generator, act_func=act_func)
    self.blocks = nn.ModuleList()
    in_ch, out_ch = stem_channels, channel_init
    for _ in range(1, n_blocks):
      self.blocks.append(blocks.ConvBlock(
          in_ch, out_ch, kernel_size, generator, act_func=act_func,
          norm=norm, residual=residual, pool_func=pool_func,
          pool_size=pool_size, dropout=dropout))
      in_ch, out_ch = out_ch, int(out_ch * channel_mult)
    self.out_channels = in_ch

  def forward(self, x, train: bool = False,
              masks: Optional[blocks.DropoutMasks] = None):
    x = self.stem(x, train)
    for block in self.blocks:
      x = block(x, train=train, masks=masks)
    return x


class GRULayer(nn.Module):
  """One bidirectional GRU layer (two flax ``GRUCellScan``s): each
  direction's ``ih`` Dense (3H outputs) and its (H, 3H) hidden kernel
  and bias in flax's layout, gates r, z, n along the 3H axis."""

  def __init__(self, in_features: int, hidden: int,
               generator: torch.Generator):
    super().__init__()
    dev = generator.device
    self.hidden = hidden
    self.ih_fwd = blocks.Dense(in_features, 3 * hidden, generator)
    self.hh_kernel_fwd = nn.Parameter(blocks.lecun_normal(
        (hidden, 3 * hidden), hidden, generator))
    self.hh_bias_fwd = nn.Parameter(torch.zeros(3 * hidden, device=dev))
    self.ih_bwd = blocks.Dense(in_features, 3 * hidden, generator)
    self.hh_kernel_bwd = nn.Parameter(blocks.lecun_normal(
        (hidden, 3 * hidden), hidden, generator))
    self.hh_bias_bwd = nn.Parameter(torch.zeros(3 * hidden, device=dev))

  def forward(self, x: torch.Tensor):
    """x (N, L, C) -> (forward outputs, reverse outputs), each (N, L, H)
    in the sequence's order."""
    n, l, _ = x.shape
    h_size = self.hidden
    # the bulk input projections, stacked (2, L, N, 3H): direction 1
    # walks the sequence backwards, so its step t reads position L-1-t
    xw = torch.stack([self.ih_fwd(x).transpose(0, 1),
                      self.ih_bwd(x).flip(1).transpose(0, 1)])
    w_hh = torch.stack([self.hh_kernel_fwd, self.hh_kernel_bwd])
    b_hh = torch.stack([self.hh_bias_fwd, self.hh_bias_bwd])[:, None, :]
    h = torch.zeros((2, n, h_size), dtype=x.dtype, device=x.device)
    outs = []
    for t in range(l):
      xw_t = xw[:, t]
      gates_h = torch.baddbmm(b_hh, h, w_hh)
      r = torch.sigmoid(xw_t[..., :h_size] + gates_h[..., :h_size])
      z = torch.sigmoid(xw_t[..., h_size:2 * h_size]
                        + gates_h[..., h_size:2 * h_size])
      cand = torch.tanh(xw_t[..., 2 * h_size:] + r * gates_h[..., 2 * h_size:])
      h = (1 - z) * cand + z * h
      outs.append(h)
    ys = torch.stack(outs, dim=2)                  # (2, N, L, H)
    return ys[0], ys[1].flip(1)


class GRUBlock(nn.Module):
  """Bidirectional GRU, the directions summed after the last layer
  (concatenated between layers), then the FFN (``convgru.py:66-92``)."""

  def __init__(self, in_channels: int, generator: torch.Generator,
               n_layers: int = 1, dropout: float = 0.0):
    super().__init__()
    self.dropout = dropout
    self.layers = nn.ModuleList(
        [GRULayer(in_channels if i == 0 else 2 * in_channels, in_channels,
                  generator) for i in range(n_layers)])
    self.ffn = blocks.FeedForwardBlock(in_channels, generator, dropout)

  def forward(self, x, masks: Optional[blocks.DropoutMasks] = None):
    for i, layer in enumerate(self.layers):
      fwd, bwd = layer(x)
      if i == len(self.layers) - 1:
        x = fwd + bwd
      else:
        x = blocks.dropout(torch.cat([fwd, bwd], dim=-1), self.dropout,
                           masks)
    return self.ffn(x, masks)


class ConvGRUTrunk(nn.Module):
  """The RNA trunk with the JAX module's defaults: stem 64 channels at
  k=15, ``n_conv - 1`` residual CDNRA blocks of 64 channels at k=5,
  BatchNorm, relu, no pooling, one GRU layer, dropout 0.1."""

  def __init__(self, generator: torch.Generator,
               stem_in_channels: int = 4, stem_channels: int = 64,
               stem_kernel_size: int = 15, n_conv: int = 6,
               channel_init: int = 64, channel_mult: float = 1.0,
               kernel_size: int = 5, n_gru: int = 1, dropout: float = 0.1):
    super().__init__()
    self.tower = ConvTower(
        stem_in_channels, stem_channels, stem_kernel_size, generator,
        n_blocks=n_conv, channel_init=channel_init,
        channel_mult=channel_mult, kernel_size=kernel_size, norm=True,
        residual=True, dropout=dropout)
    self.gru = GRUBlock(stem_channels, generator, n_layers=n_gru,
                        dropout=dropout)

  def forward(self, x, train: bool = False,
              masks: Optional[blocks.DropoutMasks] = None):
    return self.gru(self.tower(x, train, masks), masks)


class ConvGRUValueModel(nn.Module):
  """Trunk + average-pool ConvHead (``convgru.py:173-192``): (N, L, 4)
  one-hot -> (N,) value (or (N, n_tasks)), in float32 always (the JAX
  factory builds it before reading SVDD_VALUE_BF16). ``in_channels=6``
  is the saluki stability oracle, over (N, 12288, 6) inputs
  (``mdlm.transform_samples_saluki``). ``fused`` is accepted for the
  Enformer's call signature and changes nothing: the ConvGRU has no
  fused eval path. ``train=True`` needs ``masks``."""

  compute_dtype = torch.float32

  def __init__(self, n_tasks: int = 1, dropout: float = 0.1,
               generator: torch.Generator | None = None,
               in_channels: int = 4):
    super().__init__()
    if generator is None:
      generator = torch.Generator().manual_seed(1)
    self.n_tasks = n_tasks
    self.dropout = dropout
    self.in_channels = in_channels
    self.trunk = ConvGRUTrunk(generator, stem_in_channels=in_channels,
                              dropout=dropout)
    self.head = blocks.ConvHead(n_tasks, 64, generator)

  def forward(self, x: torch.Tensor, fused: bool = True,
              train: bool = False,
              masks: blocks.DropoutMasks | None = None) -> torch.Tensor:
    if train and masks is None:
      raise ValueError('a training forward needs the DropoutMasks of its '
                       'dropouts')
    x = self.head(self.trunk(x.float(), train, masks if train else None))
    return x[..., 0] if self.n_tasks == 1 else x

  def config(self) -> dict:
    """The constructor's arguments, which a checkpoint records."""
    return {'n_tasks': self.n_tasks, 'dropout': self.dropout,
            'in_channels': self.in_channels}
