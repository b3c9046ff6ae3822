"""SVDD-MC guided reverse step (``svdd_tpu/sampling/guidance.py``).

Per step: the denoiser gives log p(x0|xt), ``log_q_xs`` the step
posterior, the candidate kernel M draws per row, the value net scores
all B*M candidates in ONE batched forward, and each row keeps its
best-scoring candidate.
"""

from __future__ import annotations

from typing import Callable

import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.ops.fused_sample import gumbel_candidates
from svdd_tpu_torch.sampling.sampler import (DenoiseFn, move_chances,
                                             sigma_batch)
from svdd_tpu_torch.schedules import Schedule

ValueFn = Callable[[torch.Tensor], torch.Tensor]


def _draw_candidates(log_q, x, mask_index: int, repeats: int,
                     generator: torch.Generator, gumbel=None):
  """(B, M, L) candidates: Gumbel-max draws, unmasked tokens kept."""
  return gumbel_candidates(log_q, x, repeats, mask_index, generator,
                           gumbel)


def _select_best(candidates: torch.Tensor, scores: torch.Tensor
                 ) -> torch.Tensor:
  """Per-row argmax over the M candidates (first maximum wins)."""
  idx = torch.argmax(scores, dim=1)                          # (B,)
  return torch.gather(
      candidates, 1,
      idx[:, None, None].expand(-1, 1, candidates.shape[-1]))[:, 0]


def svdd_mc_step(denoise_fn: DenoiseFn, value_fn: ValueFn,
                 schedule: Schedule, mask_index: int, repeats: int = 10):
  """SVDD-MC: M candidates -> value net -> argmax select."""

  def step(x, t, t_next, generator, gumbel=None):
    b, l = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(log_q, x, mask_index, repeats,
                                  generator, gumbel)
    scores = value_fn(candidates.reshape(b * repeats, l)).reshape(
        b, repeats)
    return _select_best(candidates, scores)

  return step
