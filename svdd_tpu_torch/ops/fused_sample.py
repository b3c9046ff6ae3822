"""Gumbel candidate draw for the SVDD guided step: M Gumbel-max draws
per row from log_q, already-unmasked tokens copied through.

Kernel: ``csrc/gumbel_candidates.cu``, which replaces
``svdd_tpu/ops/fused_sample.py:gumbel_candidates_pallas``. The kernel
makes its noise with an in-kernel Philox generator keyed by the seed of
the caller's ``torch.Generator`` at its current Philox offset, which the
wrapper advances past the call on the host (no launch draws a seed); the
plain version takes injected Gumbel noise, so a step can be pinned
exactly against the JAX formula (``fused_sample.py:91-95``). Each draw
of the kernel equals the plain version's on the noise the kernel
reports (``return_noise``); the noise itself is held to the Gumbel law
by the frequencies of the draws. For a batch split over processes
(``parallel/rows.py``) the wrapper hands the kernel ``row0``, the global
index of the call's first row, from the enclosing ``rows.global_rows``
block (0 outside one): the kernel keys each row's draws by it, and the
plain version draws the noise of the global batch and keeps the call's
rows, so calls on the blocks of a batch, each from the same generator
state, draw what one call on the whole batch draws. The kernel reads
log_q in float32 (JAX casts it so, ``fused_sample.py:77``) and x in its
own integer type, and writes the candidates in x's type. A failed launch
raises; there is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from svdd_tpu_torch import _build
from svdd_tpu_torch.mdlm import gumbel_noise
from svdd_tpu_torch.parallel import rows as rows_lib

# Philox offsets one kernel call takes from its generator (a multiple of
# 4, as the CUDA generator's offsets are)
_OFFSET_STEP = 4


def gumbel_candidates_plain(log_q, x, gumbel, mask_index: int):
  """log_q (B, L, V), x (B, L), gumbel (B, M, L, V) -> (B, M, L)."""
  draws = torch.argmax(log_q[:, None] + gumbel, dim=-1)
  return torch.where((x != mask_index)[:, None], x[:, None],
                     draws.to(x.dtype))


def _check_kernel_args(log_q, x, mask_index: int,
                       generator: torch.Generator) -> None:
  b, l, v = log_q.shape
  if x.shape != (b, l) or x.dtype not in (torch.int32, torch.int64):
    raise ValueError(f'gumbel_candidates: x must be ({b}, {l}) int32 or '
                     f'int64, got {tuple(x.shape)} {x.dtype}')
  if not 0 <= mask_index <= v:
    raise ValueError(f'gumbel_candidates: mask_index {mask_index} outside '
                     f'[0, {v}]')
  gd, td = generator.device, log_q.device
  if gd.type != td.type or gd.index not in (None, td.index):
    raise ValueError(f'gumbel_candidates: the generator is on '
                     f'{generator.device}, the tensors on {log_q.device}')


def gumbel_candidates(log_q, x, repeats: int, mask_index: int,
                      generator: torch.Generator,
                      gumbel: Optional[torch.Tensor] = None, *,
                      return_noise: bool = False):
  """(B, M, L) candidates in x's dtype, for rows [row0, row0 + B) of a
  batch, row0 that of the enclosing ``rows.global_rows`` block (0
  outside one; module docstring). CPU tensors take the plain version, with
  ``gumbel`` noise injected or drawn from ``generator``; CUDA tensors the
  kernel, seeded from ``generator`` (a generator on the tensors' device;
  x int32 or int64, mask_index in [0, V]). ``return_noise`` also returns
  the (B, M, L, V) Gumbel noise of the draws (the kernel's zeroes it
  where x is not MASK), so a kernel draw can be held against the plain
  version."""
  b, l, v = log_q.shape
  if log_q.device.type == 'cpu':
    if gumbel is None:
      gumbel = gumbel_noise((b, repeats, l, v), generator, log_q.device)
    out = gumbel_candidates_plain(log_q, x, gumbel, mask_index)
    return (out, gumbel) if return_noise else out
  if gumbel is not None:
    raise ValueError('gumbel_candidates: the kernel makes its own noise; '
                     'injected noise is for the plain version on CPU')
  _check_kernel_args(log_q, x, mask_index, generator)
  lq = log_q.float().contiguous()
  xc = x.contiguous()
  _build.require_cuda('gumbel_candidates', lq, xc)
  out = torch.empty((b, repeats, l), dtype=x.dtype, device=log_q.device)
  noise = (torch.empty((b, repeats, l, v), dtype=torch.float32,
                       device=log_q.device) if return_noise else None)
  offset = generator.get_offset()
  generator.set_offset(offset + _OFFSET_STEP)
  rc = _build.entry('svdd_gumbel_candidates')(
      lq.data_ptr(), xc.data_ptr(), out.data_ptr(),
      None if noise is None else noise.data_ptr(),
      b, repeats, l, v, mask_index, 8 * x.element_size(), rows_lib.row0(),
      generator.initial_seed(), offset, _build.stream_ptr(lq))
  _build.check(rc, 'svdd_gumbel_candidates')
  _build.LAUNCHES['gumbel_candidates'] += 1
  return (out, noise) if return_noise else out
