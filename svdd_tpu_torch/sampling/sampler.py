"""The reverse process as a Python loop (``svdd_tpu/sampling/sampler.py``).

step_fn(x, t, t_next, generator) -> x_next, with t and t_next 0-dim
float32 CPU tensors. Schedules and move chances are computed on the
host from them and enter device ops as scalars, and each draw takes its
noise from ``generator``, so a step reads nothing back from the card and
the loop queues its work without waiting.

The loop runs under ``torch.inference_mode()``; a loop of gradient
steps (DPS, classifier guidance) runs under ``torch.no_grad()`` instead,
since tensors made in inference mode cannot enter autograd, and each
step turns gradients on around its own gradient.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.schedules import Schedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SampleResult(NamedTuple):
  samples: torch.Tensor        # (B, L) final tokens (mask-free)


def timestep_grid(num_steps: int, eps: float) -> torch.Tensor:
  """linspace(1, eps, num_steps + 1) in float32, on the host."""
  return torch.linspace(1.0, eps, num_steps + 1, dtype=torch.float32)


def sigma_batch(schedule: Schedule, t, batch: int, device) -> torch.Tensor:
  """Broadcast the scalar sigma(t) to per-row conditioning (B,)."""
  sigma, _ = schedule(t)
  return torch.full((batch,), float(sigma), dtype=torch.float32,
                    device=device)


def move_chances(schedule: Schedule, t, t_next):
  """(sigma_t, mct, mcs) with mc = 1 - exp(-sigma)."""
  sigma_t, _ = schedule(t)
  sigma_s, _ = schedule(t_next)
  return sigma_t, 1 - torch.exp(-sigma_t), 1 - torch.exp(-sigma_s)


def ddpm_step(denoise_fn: DenoiseFn, schedule: Schedule,
              mask_index: int):
  """Uncontrolled ddpm ancestral step."""

  def step(x, t, t_next, generator, gumbel=None):
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, x.shape[0], x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    if gumbel is None:
      gumbel = mdlm.gumbel_noise(log_q.shape, generator, log_q.device)
    draw = mdlm.sample_categorical(log_q, gumbel)
    return torch.where(x != mask_index, x, draw)

  return step


def argmax_noise_removal(denoise_fn: DenoiseFn, schedule: Schedule,
                         x: torch.Tensor, t) -> torch.Tensor:
  """Final forward + argmax over the non-mask vocabulary."""
  logits = denoise_fn(x, sigma_batch(schedule, t, x.shape[0], x.device))
  return torch.argmax(logits[..., :-1], dim=-1)


def reverse_process(step_fn, denoise_fn: DenoiseFn, schedule: Schedule,
                    *, batch_size: int, length: int, mask_index: int,
                    num_steps: int, eps: float = 1e-5,
                    noise_removal: bool = True, device='cuda',
                    grad_steps: bool = False):
  """prior -> num_steps steps -> final argmax noise removal.
  Returns sample(generator) -> SampleResult. ``grad_steps``: the steps
  take gradients, so the loop runs outside inference mode."""
  timesteps = timestep_grid(num_steps, eps)

  def sample(generator: torch.Generator) -> SampleResult:
    with torch.no_grad() if grad_steps else torch.inference_mode():
      x = mdlm.sample_prior((batch_size, length), mask_index, device)
      for i in range(num_steps):
        x = step_fn(x, timesteps[i], timesteps[i + 1], generator)
      if noise_removal:
        x = argmax_noise_removal(denoise_fn, schedule, x, timesteps[-1])
    return SampleResult(samples=x)

  return sample
