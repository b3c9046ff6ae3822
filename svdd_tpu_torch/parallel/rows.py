"""Global rows of a batch split over processes, for the noise.

JAX draws every random number of a step for the global batch, and
GSPMD places the rows on the devices. A process of the port holds a
contiguous block of those rows, so it draws the noise of the whole batch
from a generator that every process seeds alike and keeps its own rows:
a batch split over N processes then draws what one process draws for it.

``global_rows(row0, total)`` marks a block in which the local tensors'
first axis holds rows [row0, row0 + n) of ``total``; ``rand`` is
``torch.rand`` that, inside such a block, draws ``total`` rows and keeps
the local ones. Every draw of the samplers, the training losses and the
dropout masks goes through it; outside a block it is ``torch.rand``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

_ROWS: contextvars.ContextVar = contextvars.ContextVar('svdd_rows',
                                                       default=None)


@contextlib.contextmanager
def global_rows(row0: int, total: int):
  """Local first-axis rows are rows [row0, row0 + n) of ``total``."""
  if not 0 <= row0 < total:
    raise ValueError(f'row0 {row0} outside a batch of {total} rows')
  token = _ROWS.set((int(row0), int(total)))
  try:
    yield
  finally:
    _ROWS.reset(token)


def current() -> Optional[Tuple[int, int]]:
  """(row0, total) of the enclosing ``global_rows``, or None."""
  return _ROWS.get()


def row0() -> int:
  """The global index of the local row 0 (0 outside ``global_rows``)."""
  ctx = _ROWS.get()
  return 0 if ctx is None else ctx[0]


def rand(shape, generator: Optional[torch.Generator], device=None,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
  """U[0, 1) of ``shape`` from ``generator``: the local rows of a draw of
  the global batch inside ``global_rows``, else a plain draw."""
  shape = tuple(shape)
  ctx = _ROWS.get()
  if ctx is None or not shape:
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)
  start, total = ctx
  if start + shape[0] > total:
    raise ValueError(f'rows [{start}, {start + shape[0]}) outside a batch '
                     f'of {total}')
  full = torch.rand((total,) + shape[1:], generator=generator,
                    device=device, dtype=dtype)
  return full[start:start + shape[0]]
