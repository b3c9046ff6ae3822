"""Exponential moving average of the trainable parameters
(``svdd_tpu/models/ema.py``).

The state holds an f32 shadow of every trainable parameter, keyed by its
name, and the update count; buffers (the denoiser's frozen Fourier
weights) are not averaged. ``update`` changes the shadow in place, after
each optimizer step, in three multi-tensor ops. The decay follows the JAX module in float32:
min(decay, (1 + n) / (10 + n)) with n counted up first; a negative count
(``use_num_updates=False``) keeps the decay fixed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class EMAState:
  decay: float
  num_updates: int                 # negative: no warmup
  shadow: Dict[str, torch.Tensor]  # name -> f32 tensor


def init(params: Dict[str, torch.Tensor], decay: float,
         use_num_updates: bool = True) -> EMAState:
  """``params``: name -> parameter (e.g. ``dict(module.named_parameters())``)."""
  if not 0.0 <= decay <= 1.0:
    raise ValueError('Decay must be between 0 and 1')
  shadow = {k: p.detach().float().clone() for k, p in params.items()}
  return EMAState(decay, 0 if use_num_updates else -1, shadow)


@torch.no_grad()
def update(state: EMAState, params: Dict[str, torch.Tensor]) -> EMAState:
  """shadow -= (1 - decay) * (shadow - params), in place."""
  decay = np.float32(state.decay)
  if state.num_updates >= 0:
    state.num_updates += 1
    n = np.float32(state.num_updates)
    decay = min(decay, (np.float32(1) + n) / (np.float32(10) + n))
  one_minus = float(np.float32(1) - decay)
  shadow = list(state.shadow.values())
  diff = torch._foreach_sub(shadow, [params[k].detach().float()
                                     for k in state.shadow])
  torch._foreach_mul_(diff, one_minus)
  torch._foreach_sub_(shadow, diff)
  return state


def params(state: EMAState) -> Dict[str, torch.Tensor]:
  """The averaged parameters: name -> f32 tensor."""
  return state.shadow
