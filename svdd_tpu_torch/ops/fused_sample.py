"""Gumbel candidate draw for the SVDD guided step: M Gumbel-max draws
per row from log_q, already-unmasked tokens copied through.

Kernel: ``csrc/gumbel_candidates.cu``, which replaces
``svdd_tpu/ops/fused_sample.py:gumbel_candidates_pallas``. The kernel
makes its noise with an in-kernel Philox generator keyed by a seed drawn
from the caller's ``torch.Generator``; the plain version takes injected
Gumbel noise, so a step can be pinned exactly against the JAX formula
(``fused_sample.py:91-95``). Each draw of the kernel equals the plain
version's on the noise the kernel reports (``return_noise``); the noise
itself is held to the Gumbel law by the frequencies of the draws. A
failed launch raises; there is no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from svdd_tpu_torch import _build
from svdd_tpu_torch.mdlm import gumbel_noise


def gumbel_candidates_plain(log_q, x, gumbel, mask_index: int):
  """log_q (B, L, V), x (B, L), gumbel (B, M, L, V) -> (B, M, L)."""
  draws = torch.argmax(log_q[:, None] + gumbel, dim=-1)
  return torch.where((x != mask_index)[:, None], x[:, None],
                     draws.to(x.dtype))


def gumbel_candidates(log_q, x, repeats: int, mask_index: int,
                      generator: torch.Generator,
                      gumbel: Optional[torch.Tensor] = None, *,
                      return_noise: bool = False):
  """(B, M, L) candidates. CPU tensors take the plain version, with
  ``gumbel`` noise injected or drawn from ``generator``; CUDA tensors
  the kernel, whose seed comes from ``generator`` (a generator on the
  tensors' device). ``return_noise`` also returns the (B, M, L, V)
  Gumbel noise of the draws (the kernel's zeroes it where x is not
  MASK), so a kernel draw can be held against the plain version."""
  b, l, v = log_q.shape
  if log_q.device.type == 'cpu':
    if gumbel is None:
      gumbel = gumbel_noise((b, repeats, l, v), generator, log_q.device)
    out = gumbel_candidates_plain(log_q, x, gumbel, mask_index)
    return (out, gumbel) if return_noise else out
  if gumbel is not None:
    raise ValueError('gumbel_candidates: the kernel makes its own noise; '
                     'injected noise is for the plain version on CPU')
  lq = log_q.float().contiguous()
  xi = x.to(torch.int32).contiguous()
  seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64,
                       device=log_q.device, generator=generator)
  _build.require_cuda('gumbel_candidates', lq, xi, seed)
  out = torch.empty((b, repeats, l), dtype=torch.int32,
                    device=log_q.device)
  noise = (torch.empty((b, repeats, l, v), dtype=torch.float32,
                       device=log_q.device) if return_noise else None)
  rc = _build.entry('svdd_gumbel_candidates')(
      lq.data_ptr(), xi.data_ptr(), seed.data_ptr(), out.data_ptr(),
      None if noise is None else noise.data_ptr(),
      b, repeats, l, v, mask_index, _build.stream_ptr(lq))
  _build.check(rc, 'svdd_gumbel_candidates')
  _build.LAUNCHES['gumbel_candidates'] += 1
  out = out.to(x.dtype)
  return (out, noise) if return_noise else out
