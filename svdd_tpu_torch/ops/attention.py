"""Multi-head attention for the DiT and AR backbones
(``svdd_tpu/ops/attention.py``).

Two plain versions, one for each rounding JAX's dispatch takes on a TPU:
``mha`` (XLA's einsums: an f32 softmax, the normalised probabilities
cast to v's type) and ``attention_body_plain`` (the Pallas body,
``svdd_tpu/ops/flash_attention_pallas.py:_attn_kernel``: p = exp(s - m)
cast to v's type before p.v, the division by the f32 row sum last).
JAX takes the body where ``flash_attention.body_rounds(L, D)`` holds (L
a multiple of 128, D of 64) and ``mha`` elsewhere.

``flash_mha`` is the dispatcher the backbones call: kernel B12
(``ops/flash_attention.py``) on CUDA tensors whose head dim is a multiple
of 64, rounding as JAX's dispatch does at the shape; on CPU tensors and
at other head dims the plain version of that rounding.

``sp_mha`` is the sequence-parallel attention over a process grid
(``svdd_tpu/ops/attention.py:49``): JAX computes it with einsums, not a
Pallas kernel, and so does the port.
"""

from __future__ import annotations

import math

import torch

from svdd_tpu_torch.ops import flash_attention as fa
from svdd_tpu_torch.parallel import mesh as mesh_lib


def _scores(q, k, causal: bool, row0: int = 0) -> torch.Tensor:
  """(B, H, L, M) f32 scores q.k / sqrt(D); when causal, -inf where the
  key lies past the query, the queries being rows row0, row0 + 1, ... of
  the keys' sequence."""
  d = q.shape[-1]
  logits = torch.einsum('blhd,bmhd->bhlm', q.float(), k.float())
  logits = logits / math.sqrt(d)
  if causal:
    l, m = logits.shape[-2:]
    keep = torch.ones(l, m, dtype=torch.bool,
                      device=q.device).tril(diagonal=row0)
    logits = logits.masked_fill(~keep, float('-inf'))
  return logits


def mha(q, k, v, causal: bool = False, row0: int = 0):
  """(B, L, H, D) attention by einsums; f32 softmax, the probabilities
  rounded to v's type; ``row0`` the first query's row in the keys'
  sequence (the causal mask's offset)."""
  probs = torch.softmax(_scores(q, k, causal, row0), dim=-1).to(v.dtype)
  return torch.einsum('bhlm,bmhd->blhd', probs, v)


def sp_mha(q, k, v, mesh, axis: str = mesh_lib.MODEL_AXIS,
           causal: bool = False):
  """Sequence-parallel attention: (B, L, H, D) with L split over the
  grid's ``axis`` (a ``parallel.mesh.Mesh``): each process holds its
  L/N block of q, k and v, in rank order; k and v are all-gathered along
  L and the local queries attend to every key, the causal mask on global
  rows (the local row plus the process's index times L/N). The softmax
  in f32, the result in v's type, as ``mha``. Differentiable: the
  gather's backward reduce-scatters (JAX's transpose)."""
  if axis == mesh_lib.MODEL_AXIS:
    group, index = mesh.model_group, mesh.model_index
  elif axis == mesh_lib.DATA_AXIS:
    group, index = mesh.data_group, mesh.data_index
  else:
    raise ValueError(f'sp_mha: no axis {axis!r} on the grid')
  k_full = mesh_lib.all_gather_grad(k, group, 1)
  v_full = mesh_lib.all_gather_grad(v, group, 1)
  return mha(q, k_full, v_full, causal, row0=index * q.shape[1])


def attention_body_plain(q, k, v, causal: bool = False):
  """(B, L, H, D) attention as the Pallas body rounds it: p = exp(s - m)
  in f32, rounded to v's type, p.v summed in f32, divided by the f32 row
  sum, the result in q's type."""
  s = _scores(q, k, causal)
  p = torch.exp(s - s.amax(-1, keepdim=True))
  den = p.sum(-1, keepdim=True)
  o = torch.einsum('bhlm,bmhd->bhld', p.to(v.dtype).float(), v.float())
  return (o / den).to(q.dtype).transpose(1, 2)


def plain_for(l: int, d: int):
  """The plain version of the rounding JAX's dispatch takes at (L, D)."""
  return attention_body_plain if fa.body_rounds(l, d) else mha


def flash_mha(q, k, v, causal: bool = False):
  """(B, L, H, D) attention through kernel B12 (CUDA tensors, D a
  multiple of 64) or the plain version of the same rounding (CPU
  tensors, other D)."""
  if q.device.type == 'cpu' or q.shape[-1] % 64:
    return plain_for(q.shape[1], q.shape[-1])(q, k, v, causal)
  return fa.flash_attention(q, k, v, causal)
