"""Small helpers (``svdd_tpu/utils.py``): the scheduled-M parser of the
decode CLIs, the pretraining learning-rate schedules, the value-net
trainer's token schedule, the NaN reporter and the reference's
straight-through and relaxed samplers.

Where the JAX samplers take a PRNG key, these take the noise itself
(``gumbel``, ``gamma``, ``noise``) or a ``torch.Generator`` to draw it
from; JAX's ``stop_gradient`` is ``detach()``."""

from __future__ import annotations

import math
from typing import Optional

import torch

from svdd_tpu_torch.mdlm import gumbel_noise


def parse_m_schedule(spec):
  """Parse a scheduled-M spec "96:10,32:4" into ((96, 10), (32, 4)):
  phases of (steps, M), steps and M at least 1. None or '' -> None. The
  phase lengths must also sum to the step count, which
  ``sampling.sampler.reverse_process`` checks."""
  if not spec:
    return None
  phases = []
  for part in str(spec).split(','):
    pieces = part.split(':')
    if len(pieces) != 2:
      raise ValueError(
          f'm_schedule phase {part!r} must be "steps:M" (got {spec!r})')
    n, m = (int(v) for v in pieces)
    if n < 1 or m < 1:
      raise ValueError(f'm_schedule phase {part!r}: steps and M must '
                       'be >= 1')
    phases.append((n, m))
  return tuple(phases)


# --- learning-rate schedules: count (updates already made) -> lr --------
# Plain-float copies of optax's linear_schedule, cosine_decay_schedule
# and join_schedules, which ``svdd_tpu/utils.py`` composes.


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
  """optax.linear_schedule: init -> end over ``transition_steps``
  updates, then end; a non-positive length is the constant init."""
  if transition_steps <= 0:
    return lambda count: init_value

  def schedule(count):
    frac = 1 - min(max(count, 0), transition_steps) / transition_steps
    return (init_value - end_value) * frac + end_value
  return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
  """optax.cosine_decay_schedule (exponent 1): init * ((1 - alpha) *
  (1 + cos(pi * count / decay_steps)) / 2 + alpha), constant past
  ``decay_steps``."""
  if decay_steps <= 0:
    raise ValueError(f'cosine_decay_schedule needs positive decay_steps, '
                     f'got {decay_steps}')

  def schedule(count):
    count = min(count, decay_steps)
    cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
    return init_value * ((1 - alpha) * cosine + alpha)
  return schedule


def join_schedules(schedules, boundaries):
  """optax.join_schedules: schedule i+1, counted from its boundary, from
  boundary i on."""

  def schedule(count):
    out = schedules[0](count)
    for boundary, fn in zip(boundaries, schedules[1:]):
      if count >= boundary:
        out = fn(count - boundary)
    return out
  return schedule


def constant_warmup_schedule(lr: float, warmup_steps: int):
  """Linear warmup from 0 to lr over ``warmup_steps`` updates, then lr."""
  return join_schedules([linear_schedule(0.0, lr, warmup_steps),
                         lambda count: lr], [warmup_steps])


def cosine_decay_warmup_schedule(lr: float, warmup_steps: int,
                                 total_steps: int, lr_min: float = 1e-6,
                                 warmup_lr_init: float = 1e-6):
  """Linear warmup from ``warmup_lr_init`` to lr, then a cosine decay to
  ``lr_min`` by ``total_steps``."""
  return join_schedules(
      [linear_schedule(warmup_lr_init, lr, warmup_steps),
       cosine_decay_schedule(lr, max(total_steps - warmup_steps, 1),
                             alpha=lr_min / lr)],
      [warmup_steps])


def token_cosine_lr_mult(tokens: float, warmup_tokens: float,
                         final_tokens: float) -> float:
  """The value-net trainer's learning-rate multiplier at ``tokens``
  tokens seen (``svdd_tpu/utils.py:116-125``): a linear warmup to 1, then
  a cosine decay floored at 0.1."""
  if tokens < warmup_tokens:
    return tokens / max(warmup_tokens, 1.0)
  progress = (tokens - warmup_tokens) / max(final_tokens - warmup_tokens,
                                            1.0)
  return max(0.1, 0.5 * (1.0 + math.cos(math.pi * progress)))


def print_nans(x: torch.Tensor, name: str) -> torch.Tensor:
  """Prints '<name> contains NaNs' when ``x`` holds a NaN (a host read of
  the flag); returns ``x``."""
  if bool(torch.isnan(x).any()):
    print(f'{name} contains NaNs')
  return x


# --- straight-through / relaxed samplers (``svdd_tpu/utils.py:131-190``) ---


def _noise(noise, shape, generator, device, draw):
  if noise is not None:
    return noise
  if generator is None:
    raise ValueError('pass the noise or a torch.Generator to draw it from')
  return draw(shape, generator, device)


def _normal(shape, generator, device):
  return torch.randn(shape, generator=generator, device=device)


def gumbel_softmax(logits: torch.Tensor, temperature: float = 1.0,
                   hard: bool = True, gumbel: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
  """Gumbel-softmax: softmax((logits + g) / temperature); with ``hard``
  the one-hot of its argmax forward and the soft sample's gradient."""
  g = _noise(gumbel, logits.shape, generator, logits.device, gumbel_noise)
  y_soft = torch.softmax((logits + g) / temperature, dim=-1)
  if not hard:
    return y_soft
  y_hard = torch.nn.functional.one_hot(
      y_soft.argmax(-1), logits.shape[-1]).to(y_soft.dtype)
  return y_soft + (y_hard - y_soft).detach()


def topk_mask_st(logits: torch.Tensor, k: int) -> torch.Tensor:
  """Straight-through top-k mask: 1 where a logit is at least the k-th
  largest of its row, with sigmoid(logits)'s gradient."""
  kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
  hard = (logits >= kth).to(logits.dtype)
  soft = torch.sigmoid(logits)
  return soft + (hard - soft).detach()


def binary_discretization_st(z: torch.Tensor) -> torch.Tensor:
  """sign(z) forward, the gradient of z / ||z|| over the last axis."""
  z_soft = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
  return z_soft + (torch.sign(z) - z_soft).detach()


def topk_gamma_noise(shape, k: int, gamma_tau: float = 1.0,
                     num_betas: int = 10,
                     gamma: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
  """Sum-of-scaled-Gammas perturbation of relaxed top-k sampling, for a
  2-D ``shape``: ``gamma`` (num_betas, *shape) draws of Gamma(1/k, 1),
  divided by k / i for i = 1..num_betas, summed, less log 10, times
  gamma_tau / k."""
  def draw(full, gen, dev):
    return torch._standard_gamma(torch.full(full, 1.0 / k, device=dev),
                                 generator=gen)
  g = _noise(gamma, (num_betas,) + tuple(shape), generator, device, draw)
  beta = k / torch.arange(1, num_betas + 1, dtype=torch.float32,
                          device=g.device)
  s = (g / beta[:, None, None]).sum(0) - math.log(10.0)
  return gamma_tau * (s / k)


def binary_sample_st(probs: torch.Tensor,
                     gumbels: Optional[tuple] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
  """Relaxed Bernoulli: ``gumbels`` = (pos, neg), two Gumbel draws of
  ``probs``'s shape; the hard sample forward, the relaxed one's
  gradient."""
  if gumbels is None:
    gumbels = tuple(_noise(None, probs.shape, generator, probs.device,
                           gumbel_noise) for _ in range(2))
  pos, neg = gumbels
  del_noise_exp = torch.exp(neg - pos)
  hard = (probs * (1 + del_noise_exp) > 1).to(probs.dtype)
  soft = probs / (probs + (1 - probs) * del_noise_exp)
  return soft + (hard - soft).detach()


def gaussian_sample(x: torch.Tensor, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
  """Reparameterised Gaussian from the last axis's halves (mu, v):
  mu + sqrt(softplus(v)) * noise, ``noise`` standard normal of mu's
  shape."""
  n = x.shape[-1] // 2
  mu = x[..., :n]
  sigma = torch.sqrt(torch.nn.functional.softplus(x[..., n:]))
  return mu + sigma * _noise(noise, mu.shape, generator, x.device, _normal)
