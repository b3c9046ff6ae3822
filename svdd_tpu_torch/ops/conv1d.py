"""SAME-padded dilated 1-D convolution (``svdd_tpu/ops/conv1d.py``).

Used for the denoiser's stem and heads and the value net's stem, which
the JAX package also leaves to XLA. ``F.conv1d`` with padding
half * dilation is exact against the JAX dead-tap rule: a tap whose
|offset| >= L reads only zero padding and adds nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d_shifted(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   dilation: int = 1) -> torch.Tensor:
  """x (N, L, Cin), kernel (K, Cin, Cout) (the flax layout) -> (N, L, Cout)."""
  k_taps = kernel.shape[0]
  w = kernel.to(x.dtype).permute(2, 1, 0)               # (Cout, Cin, K)
  out = F.conv1d(x.transpose(1, 2), w,
                 None if bias is None else bias.to(x.dtype),
                 padding=(k_taps - 1) // 2 * dilation, dilation=dilation)
  return out.transpose(1, 2)
