"""Launcher of kernel B12, softmax attention over (B, L, H, D),
optionally causal: ``csrc/flash_attention.cu``, which replaces
``svdd_tpu/ops/flash_attention_pallas.py:flash_attention``.

The backbones call it through ``ops.attention.flash_mha``, which takes
the plain version (``ops.attention.mha``) on CPU tensors. The kernel
computes as the TPU kernel's body does: f32 scores scaled after the
product, f32 row maxima and sums, p rounded to v's type before the p.v
product and the division by the f32 sum last. ``mha`` rounds the
normalised probabilities instead, so in bfloat16 the two differ by up to
a bf16 ulp of each term of the p.v sum. Both products run on the tensor
cores: bf16 mma, and for float32 3xTF32 (each operand split into two
TF32 halves, about 2^-20 relative error a product), summed in another
order than ``mha``.

q, k and v are read by stride, so views such as the slices of a fused
qkv projection go in as they are. Each needs unit stride over D, a
16-byte aligned start and strides that are multiples of 16 bytes (the
kernel copies rows in 16-byte chunks): the DiT's qkv slices have
strides 3·H·D and offsets H·D.
"""

from __future__ import annotations

import math

import torch

from svdd_tpu_torch import _build

# head dims the kernel is built for: the DiT and AR presets' 64, and 128
# (the text preset at 6 heads). ``ops.attention.flash_mha`` sends a head
# dim that is no multiple of 64 to the plain version, as the JAX
# dispatcher does; a multiple of 64 that is not built raises here.
KERNEL_HEAD_DIMS = (64, 128)


def flash_attention(q, k, v, causal: bool = False):
  """(B, L, H, D) CUDA tensors q, k, v of one dtype (f32 or bf16) ->
  (B, L, H, D) contiguous, through the kernel. Raises on anything the
  kernel does not take."""
  b, l, h, d = q.shape
  if k.shape != q.shape or v.shape != q.shape:
    raise ValueError(f'flash_attention: q {tuple(q.shape)}, k '
                     f'{tuple(k.shape)}, v {tuple(v.shape)} differ')
  if d not in KERNEL_HEAD_DIMS:
    raise ValueError(f'flash_attention: head dim {d} not in '
                     f'{KERNEL_HEAD_DIMS}')
  if k.dtype != q.dtype or v.dtype != q.dtype:
    raise TypeError('flash_attention: q, k and v must share a dtype')
  # the kernel copies 16-byte chunks of each row with cp.async
  _build.require_aligned('flash_attention', q, k, v)
  chunk = 16 // q.element_size()
  for t in (q, k, v):
    if t.stride(3) != 1:
      raise ValueError('flash_attention: q, k and v need unit stride '
                       'over the head dim')
    if any(s % chunk for s in t.stride()[:3]):
      raise ValueError(f'flash_attention: strides {tuple(t.stride())} '
                       'are not multiples of 16 bytes')
    if t.device.type != 'cuda':
      raise ValueError(f'flash_attention: tensors must be on a CUDA '
                       f'device, got {t.device}')
  out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
  strides = [s for t in (q, k, v) for s in t.stride()[:3]]
  rc = _build.entry('svdd_flash_attention')(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, h, d,
      *strides, 1.0 / math.sqrt(d), int(causal), _build.dtype_code(q),
      _build.stream_ptr(q))
  _build.check(rc, 'svdd_flash_attention')
  _build.LAUNCHES['flash_attention_causal' if causal
                  else 'flash_attention'] += 1
  return out
