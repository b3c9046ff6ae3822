"""Noise schedules t -> (sigma(t), dsigma(t)) (``svdd_tpu/schedules.py``):
loglinear (the default of both bio tasks), cosine, cosinesqr, linear
and geometric, with the reference's importance transforms of loglinear
and linear.

Schedules take float32 tensors; the samplers call them with 0-dim CPU
tensors, which PyTorch treats as scalars next to device tensors, so a
reverse step reads no value back from the card. Every constant is a
Python float, so a schedule of a CPU tensor stays on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Schedule:
  """A noise schedule: callable t -> (sigma, dsigma), plus its extremes."""

  name: str
  total: Callable[[Tensor], Tensor]
  rate: Callable[[Tensor], Tensor]
  # importance-sampling change of variables u -> t
  importance_transform: Optional[Callable[[Tensor], Tensor]] = None

  def __call__(self, t) -> Tuple[Tensor, Tensor]:
    t = torch.as_tensor(t, dtype=torch.float32)
    return self.total(t), self.rate(t)

  @property
  def sigma_max(self) -> Tensor:
    return self.total(torch.tensor(1.0))

  @property
  def sigma_min(self) -> Tensor:
    return self.total(torch.tensor(0.0))


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


def cosine(eps: float = 1e-3) -> Schedule:
  """sigma(t) = -log(eps + (1-eps) cos(pi t / 2))."""

  def total(t):
    return -torch.log(eps + (1 - eps) * torch.cos(t * math.pi / 2))

  def rate(t):
    cos = (1 - eps) * torch.cos(t * math.pi / 2)
    sin = (1 - eps) * torch.sin(t * math.pi / 2)
    return (math.pi / 2) * sin / (cos + eps)

  return Schedule('cosine', total, rate)


def cosinesqr(eps: float = 1e-3) -> Schedule:
  """sigma(t) = -log(eps + (1-eps) cos^2(pi t / 2))."""

  def total(t):
    return -torch.log(eps + (1 - eps) * torch.cos(t * math.pi / 2) ** 2)

  def rate(t):
    cos2 = (1 - eps) * torch.cos(t * math.pi / 2) ** 2
    sin = (1 - eps) * torch.sin(t * math.pi)
    return (math.pi / 2) * sin / (cos2 + eps)

  return Schedule('cosinesqr', total, rate)


def linear(sigma_min: float = 0.0, sigma_max: float = 10.0) -> Schedule:
  """sigma(t) = sigma_min + t (sigma_max - sigma_min); its importance
  transform takes f_0 = -inf where sigma_min is 0."""

  def total(t):
    return sigma_min + t * (sigma_max - sigma_min)

  def rate(t):
    return torch.full_like(torch.as_tensor(t, dtype=torch.float32),
                           sigma_max - sigma_min)

  def importance_transform(t):
    f_T = math.log1p(-math.exp(-sigma_max))
    f_0 = (math.log1p(-math.exp(-sigma_min)) if sigma_min > 0
           else -float('inf'))
    sigma_t = -torch.log1p(-torch.exp(t * f_T + (1 - t) * f_0))
    return (sigma_t - sigma_min) / (sigma_max - sigma_min)

  return Schedule('linear', total, rate, importance_transform)


def geometric(sigma_min: float = 1e-3, sigma_max: float = 1.0) -> Schedule:
  """sigma(t) = sigma_min^(1-t) sigma_max^t (a Python float raised to the
  tensor)."""
  log_ratio = math.log(sigma_max) - math.log(sigma_min)

  def total(t):
    return sigma_min ** (1 - t) * sigma_max ** t

  def rate(t):
    return total(t) * log_ratio

  return Schedule('geometric', total, rate)


def get_schedule(noise_type: str, *, sigma_min: float = 1e-4,
                 sigma_max: float = 20.0, eps: float = 1e-3) -> Schedule:
  """The schedule of ``noise.type``, from the config's noise settings."""
  if noise_type == 'loglinear':
    return loglinear(eps)
  if noise_type == 'cosine':
    return cosine(eps)
  if noise_type == 'cosinesqr':
    return cosinesqr(eps)
  if noise_type == 'linear':
    return linear(sigma_min, sigma_max)
  if noise_type == 'geometric':
    return geometric(sigma_min, sigma_max)
  raise ValueError(f'{noise_type} is not a valid noise schedule')
