"""Multi-head attention for the DiT and AR backbones
(``svdd_tpu/ops/attention.py``).

``mha`` is the plain version: einsums with an f32 softmax, the
probabilities cast to v's type. ``flash_mha`` is the dispatcher the
backbones call: kernel B12 (``ops/flash_attention.py``) on CUDA tensors
whose head dim is a multiple of 64, ``mha`` on CPU tensors and at other
head dims, as the JAX dispatcher takes XLA's ``mha`` there
(``svdd_tpu/ops/attention.py:flash_mha``). The TPU dispatcher's
``L % 128`` gate was a Mosaic tiling rule; the kernel takes every L.
"""

from __future__ import annotations

import math

import torch

from svdd_tpu_torch.ops import flash_attention as fa


def mha(q, k, v, causal: bool = False):
  """(B, L, H, D) attention by einsums; f32 softmax."""
  d = q.shape[-1]
  logits = torch.einsum('blhd,bmhd->bhlm', q.float(), k.float())
  logits = logits / math.sqrt(d)
  if causal:
    l, m = logits.shape[-2:]
    keep = torch.ones(l, m, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~keep, float('-inf'))
  probs = torch.softmax(logits, dim=-1).to(v.dtype)
  return torch.einsum('bhlm,bmhd->blhd', probs, v)


def flash_mha(q, k, v, causal: bool = False):
  """(B, L, H, D) attention through kernel B12 (CUDA tensors, D a
  multiple of 64) or the plain version (CPU tensors, other D)."""
  if q.device.type == 'cpu' or q.shape[-1] % 64:
    return mha(q, k, v, causal)
  return fa.flash_attention(q, k, v, causal)
