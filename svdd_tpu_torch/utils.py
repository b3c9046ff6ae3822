"""Small helpers (``svdd_tpu/utils.py``): the scheduled-M parser of the
decode CLIs, the pretraining learning-rate schedules and the value-net
trainer's token schedule."""

from __future__ import annotations

import math


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
