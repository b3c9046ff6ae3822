"""Basenji trunk (``svdd_tpu/models/basenji.py``): a conv tower, a
dilated-residual tower, a 1x1 conv head and an average pool, in eval.

Every dilated-residual block holds two NACDR ConvBlocks with the exact
gelu; each one at dilation 1 (the second of every block, and the first
where the dilation rounds to 1) takes the NACDR eval fast path through
kernel B11c and one product, or kernel B14 with
``SVDD_PALLAS_FUSED_CONV=1`` (``ops/conv1d.py:conv1d_prologue``): nine
such convs a forward at the defaults. The conv tower's convs run in
order CDNRA through the library convolution, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.models.convgru import ConvTower


class DilatedResidualBlock(nn.Module):
  """gelu conv (dilated) -> gelu conv (dilation 1) -> residual add."""

  def __init__(self, in_channels: int, channels: int,
               generator: torch.Generator, kernel_size: int = 3,
               dilation: int = 1):
    super().__init__()
    nacdr = dict(act_func='gelu', norm=True, order='NACDR')
    self.conv_0 = blocks.ConvBlock(in_channels, channels, kernel_size,
                                   generator, dilation=dilation, **nacdr)
    self.conv_1 = blocks.ConvBlock(channels, in_channels, kernel_size,
                                   generator, **nacdr)

  def forward(self, x):
    return x + self.conv_1(self.conv_0(x))


class Basenji(nn.Module):
  """(N, L, 4) one-hot -> (N,) (or (N, n_tasks)), with the JAX module's
  defaults; dropout is inert in eval."""

  def __init__(self, n_tasks: int = 1, conv_blocks: int = 4,
               channel_init: int = 256, kernel_size: int = 5,
               pool_func: str = 'max', residual_channels: int = 108,
               residual_blocks: int = 6, conv_channel_mult: float = 1.125,
               dilation_mult: float = 1.2, final_pool_func: str = 'avg',
               generator: torch.Generator | None = None):
    super().__init__()
    if generator is None:
      generator = torch.Generator().manual_seed(1)
    self.n_tasks = n_tasks
    self.final_pool_func = final_pool_func
    self.tower = ConvTower(
        4, channel_init, 15, generator, n_blocks=conv_blocks,
        channel_init=channel_init, channel_mult=conv_channel_mult,
        kernel_size=kernel_size, act_func='gelu', norm=True,
        pool_func=pool_func, pool_size=2, residual=True)
    channels = self.tower.out_channels
    self.residual_blocks = nn.ModuleList()
    dilation = 1.0
    for _ in range(residual_blocks):
      self.residual_blocks.append(DilatedResidualBlock(
          channels, residual_channels, generator, kernel_size,
          dilation=max(1, int(round(dilation)))))
      dilation *= dilation_mult
    self.final_block = blocks.ConvBlock(channels, channels, 1, generator)
    self.head = (blocks.ChannelTransform(channels, n_tasks, generator)
                 if channels != n_tasks else nn.Identity())

  def forward(self, x):
    x = self.tower(x)
    for block in self.residual_blocks:
      x = block(x)
    x = blocks.adaptive_pool(self.final_pool_func,
                             self.head(self.final_block(x)))
    return x[..., 0] if self.n_tasks == 1 else x
