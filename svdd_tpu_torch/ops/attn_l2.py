"""Enformer relative-position attention at sequence length 2.

Kernel: ``csrc/attn_l2.cu``, which replaces
``svdd_tpu/ops/attn_l2_pallas.py:attn_l2_lnc_pallas``. The port keeps
the (N, 2, H*d) layout; the plain version follows
``attn_l2_reference``: the two logits of each query differ only
elementwise, so their difference is reduced per head and the 2-way
softmax is the sigmoid of it.
"""

from __future__ import annotations

import torch

from svdd_tpu_torch import _build


def _relk_rows(relk):
  """relk (3, H*dk) rows are distances [-1, 0, +1]. Returns the rows
  the j=0 and j=1 logits use, each (2, H*dk) indexed by query i
  (logit[i, j] uses distance j - i)."""
  return (torch.stack([relk[1], relk[0]]),
          torch.stack([relk[2], relk[1]]))


def attn_l2_plain(q, k, v, bc, bp, relk, heads: int):
  """q, k (N, 2, H*dk) with q pre-scaled; v (N, 2, H*dv); bc, bp
  (H*dk,); relk (3, H*dk). Returns (out (N, 2, H*dv) in v's dtype,
  w (N, 2, H) f32: the weight of key 0)."""
  n = q.shape[0]
  r0, r1 = _relk_rows(relk.float())
  qc = (q + bc).float()
  qp = (q + bp).float()
  k32 = k.float()
  diff = qc * (k32[:, 0:1] - k32[:, 1:2]) + qp * (r0 - r1)[None]
  w = torch.sigmoid(diff.reshape(n, 2, heads, -1).sum(-1))   # (N, 2, H)
  v32 = v.float().reshape(n, 2, heads, -1)
  wv = w[..., None]
  out = wv * v32[:, 0:1] + (1.0 - wv) * v32[:, 1:2]
  return out.reshape(v.shape).to(v.dtype), w


def attn_l2(q, k, v, bc, bp, relk, heads: int):
  """The attention through the CUDA kernel (CUDA tensors) or the plain
  version (CPU tensors)."""
  if q.device.type == 'cpu':
    return attn_l2_plain(q, k, v, bc, bp, relk, heads)
  n, two, hdk = q.shape
  hdv = v.shape[-1]
  if two != 2 or k.shape != q.shape or v.shape[:2] != (n, 2) \
      or hdk % heads or hdv % heads:
    raise ValueError(f'attn_l2: bad shapes q {tuple(q.shape)} '
                     f'k {tuple(k.shape)} v {tuple(v.shape)}')
  dt = v.dtype
  args = [t.to(dt).contiguous() for t in (q, k, v, bc, bp, relk)]
  _build.require_cuda('attn_l2', *args)
  out = torch.empty((n, 2, hdv), dtype=dt, device=v.device)
  w = torch.empty((n, 2, heads), dtype=torch.float32, device=v.device)
  rc = _build.entry('svdd_attn_l2')(
      *(a.data_ptr() for a in args), out.data_ptr(), w.data_ptr(),
      n, heads, hdk // heads, hdv // heads, _build.dtype_code(out),
      _build.stream_ptr(out))
  _build.check(rc, 'svdd_attn_l2')
  _build.LAUNCHES['attn_l2'] += 1
  return out, w
