"""Noise schedules t -> (sigma(t), dsigma(t)) (``svdd_tpu/schedules.py``).

Only the loglinear schedule, the default of both bio tasks, is ported.
Schedules take float32 tensors; the samplers call them with 0-dim CPU
tensors, which PyTorch treats as scalars next to device tensors, so a
reverse step reads no value back from the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Schedule:
  """A noise schedule: callable t -> (sigma, dsigma)."""

  name: str
  total: Callable[[Tensor], Tensor]
  rate: Callable[[Tensor], Tensor]
  # importance-sampling change of variables u -> t
  importance_transform: Optional[Callable[[Tensor], Tensor]] = None

  def __call__(self, t) -> Tuple[Tensor, Tensor]:
    t = torch.as_tensor(t, dtype=torch.float32)
    return self.total(t), self.rate(t)


def loglinear(eps: float = 1e-3) -> Schedule:
  """sigma(t) = -log1p(-(1-eps) t); masking prob = (1-eps) t."""

  def total(t):
    return -torch.log1p(-(1 - eps) * t)

  def rate(t):
    return (1 - eps) / (1 - (1 - eps) * t)

  sigma_max = -math.log1p(-(1 - eps))
  sigma_min = eps   # the reference's sigma_min is eps + total(0) = eps

  def importance_transform(t):
    f_T = math.log1p(-math.exp(-sigma_max))
    f_0 = math.log1p(-math.exp(-sigma_min))
    sigma_t = -torch.log1p(-torch.exp(t * f_T + (1 - t) * f_0))
    return -torch.expm1(-sigma_t) / (1 - eps)

  return Schedule('loglinear', total, rate, importance_transform)


def get_schedule(noise_type: str, *, sigma_min: float = 1e-4,
                 sigma_max: float = 20.0, eps: float = 1e-3) -> Schedule:
  del sigma_min, sigma_max   # read by schedules not ported yet
  if noise_type == 'loglinear':
    return loglinear(eps)
  raise NotImplementedError(f'noise schedule {noise_type!r} is not '
                            'ported yet')
