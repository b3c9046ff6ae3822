"""Helpers shared by the kernels and the modules around them
(``svdd_tpu/ops/kernel_utils.py``): the NACDR activations and the
dead-tap rule, the contract between the im2col producer
(``ops/attn_pool.py``) and the stacked conv weight that consumes it."""

from __future__ import annotations

import torch

# activation codes the CUDA kernels take
ACT_CODES = {None: 0, 'gelu_enformer': 1, 'relu': 2}


def gelu_enformer(x: torch.Tensor) -> torch.Tensor:
  """Enformer's sigmoid-approximated GELU: x * sigmoid(1.702 x)."""
  return x * torch.sigmoid(1.702 * x)


def act(name, x: torch.Tensor) -> torch.Tensor:
  if name is None:
    return x
  if name == 'gelu_enformer':
    return gelu_enformer(x)
  if name == 'relu':
    return torch.relu(x)
  raise NotImplementedError(name)


def live_offsets(k_taps: int, length: int, dilation: int = 1
                 ) -> list[int]:
  """Tap offsets with |off| < length; the others read only zero
  padding and are dropped."""
  half = (k_taps - 1) // 2 * dilation
  return [k * dilation - half for k in range(k_taps)
          if -length < k * dilation - half < length]


def live_taps(k_taps: int, length: int, dilation: int = 1) -> slice:
  """The kernel taps of ``live_offsets``, in the same order. They are
  always a contiguous range around the centre, so this is a slice: a
  view of a weight on any device, with no index tensor to copy."""
  half = (k_taps - 1) // 2 * dilation
  offs = live_offsets(k_taps, length, dilation)
  return slice((offs[0] + half) // dilation, (offs[-1] + half) // dilation + 1)
