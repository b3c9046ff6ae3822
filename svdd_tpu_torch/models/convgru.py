"""The ConvGRU value net's conv tower (``svdd_tpu/models/convgru.py``):
``ConvTower`` only, the trunk Basenji shares. The GRU and
``ConvGRUValueModel`` wait for the RNA task (ROADMAP A10)."""

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
               pool_size: Optional[int] = None, residual: bool = False):
    super().__init__()
    self.stem = blocks.Stem(stem_in_channels, stem_channels,
                            stem_kernel_size, generator, act_func=act_func)
    self.blocks = nn.ModuleList()
    in_ch, out_ch = stem_channels, channel_init
    for _ in range(1, n_blocks):
      self.blocks.append(blocks.ConvBlock(
          in_ch, out_ch, kernel_size, generator, act_func=act_func,
          norm=norm, residual=residual, pool_func=pool_func,
          pool_size=pool_size))
      in_ch, out_ch = out_ch, int(out_ch * channel_mult)
    self.out_channels = in_ch

  def forward(self, x):
    x = self.stem(x)
    for block in self.blocks:
      x = block(x)
    return x
