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
"""

from __future__ import annotations

import math

import torch

from svdd_tpu_torch.ops import flash_attention as fa


def _scores(q, k, causal: bool) -> torch.Tensor:
  """(B, H, L, L) f32 scores q.k / sqrt(D), -inf above the diagonal
  when causal."""
  d = q.shape[-1]
  logits = torch.einsum('blhd,bmhd->bhlm', q.float(), k.float())
  logits = logits / math.sqrt(d)
  if causal:
    l, m = logits.shape[-2:]
    keep = torch.ones(l, m, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~keep, float('-inf'))
  return logits


def mha(q, k, v, causal: bool = False):
  """(B, L, H, D) attention by einsums; f32 softmax, the probabilities
  rounded to v's type."""
  probs = torch.softmax(_scores(q, k, causal), dim=-1).to(v.dtype)
  return torch.einsum('bhlm,bmhd->blhd', probs, v)


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
