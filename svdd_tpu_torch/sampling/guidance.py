"""Guided reverse steps (``svdd_tpu/sampling/guidance.py``).

SVDD-MC, per step: the denoiser gives log p(x0|xt), ``log_q_xs`` the
step posterior, the candidate kernel M draws per row, the value net
scores all B*M candidates in ONE batched forward, and each row keeps
its best-scoring candidate.

DPS and classifier guidance tilt the step posterior by a gradient with
respect to the one-hot input, ``torch.autograd.grad`` in place of
``jax.grad``; the models' parameters take no gradient. Every step
accepts injected Gumbel noise, so it can be pinned against the JAX step.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

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


def _draw(log_probs, generator, gumbel=None):
  if gumbel is None:
    gumbel = mdlm.gumbel_noise(log_probs.shape, generator, log_probs.device)
  return mdlm.sample_categorical(log_probs, gumbel)


def dps_gradient(denoise_onehot_fn, reward_fn, x, sigma,
                 mask_index: int) -> torch.Tensor:
  """d mean(reward(softmax(E[x0|xt])[..., :4])) / d onehot(x), with
  respect to the full 5-channel one-hot: through the copy/merge of the
  unmasked positions and a softmax over all 5 channels
  (``guidance.py:375-387``)."""
  copy = (x != mask_index).float()[..., None]
  with torch.enable_grad():
    onehot = F.one_hot(x.long(), mask_index + 1).float().requires_grad_(True)
    expected = denoise_onehot_fn(onehot, x, sigma)
    expected = copy * onehot + (1 - copy) * expected
    probs = torch.softmax(expected, dim=-1)
    (grad,) = torch.autograd.grad(reward_fn(probs[..., :4]).mean(), onehot)
  return grad


def dps_step(denoise_onehot_fn, reward_fn, schedule: Schedule,
             mask_index: int, guidance_scale: float = 1.0):
  """DPS: ``dps_gradient`` at sigma(t_next), recentred by the mask
  column, scaled and added to log q_xs (``guidance.py:359-396``).
  ``denoise_onehot_fn(onehot, x, sigma)`` is the denoiser's one-hot
  path; ``reward_fn`` maps (N, L, 4) to (N,) differentiably."""

  def step(x, t, t_next, generator, gumbel=None):
    b, _ = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    x_grad = dps_gradient(denoise_onehot_fn, reward_fn, x,
                          sigma_batch(schedule, t_next, b, x.device),
                          mask_index)
    log_p0 = denoise_onehot_fn(F.one_hot(x.long(), mask_index + 1).float(),
                               x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p0, mct, mcs, mask_index)
    guidance = guidance_scale * (
        x_grad - x_grad[..., mask_index:mask_index + 1])
    draw = _draw(log_q + guidance, generator, gumbel)
    return torch.where(x != mask_index, x, draw)

  return step


def classifier_gradient(value_fn_onehot, x) -> torch.Tensor:
  """d mean(value(onehot4(x))) / d onehot4(x), padded with a zero MASK
  channel to (N, L, 5) (``guidance.py:415-421``)."""
  with torch.enable_grad():
    onehot = mdlm.transform_samples(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(value_fn_onehot(onehot).mean(), onehot)
  return F.pad(grad, (0, 1))


def classifier_step(denoise_fn: DenoiseFn, value_fn_onehot,
                    schedule: Schedule, mask_index: int,
                    guidance_scale: float = 1.0):
  """Classifier guidance: ``classifier_gradient``, the gradient of the
  value net with respect to the one-hot of x_t, added to q_xs in
  probability space and clamped at 1e-35 before the log
  (``guidance.py:399-430``).
  ``value_fn_onehot`` maps (N, L, 4) to (N,) differentiably."""

  def step(x, t, t_next, generator, gumbel=None):
    b, _ = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    q_tilted = torch.exp(log_q) + guidance_scale * classifier_gradient(
        value_fn_onehot, x)
    draw = _draw(torch.log(torch.clamp(q_tilted, min=1e-35)), generator,
                 gumbel)
    return torch.where(x != mask_index, x, draw)

  return step
