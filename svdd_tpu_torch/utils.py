"""Small helpers shared by the decode CLIs (``svdd_tpu/utils.py``)."""

from __future__ import annotations


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
