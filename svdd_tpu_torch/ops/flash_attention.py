"""Launcher of kernel B12, softmax attention over (B, L, H, D),
optionally causal: ``csrc/flash_attention.cu``, which replaces
``svdd_tpu/ops/flash_attention_pallas.py:flash_attention``.

The backbones call it through ``ops.attention.flash_mha``, which takes
the plain versions on CPU tensors. The kernel rounds as JAX's dispatch
does on a TPU (``body_rounds``): where JAX takes the Pallas body (L a
multiple of 128, D of 64) it computes as that body does, f32 scores
scaled after the product, f32 row maxima and sums, p rounded to v's type
before the p.v product and the division by the f32 sum last (plain form
``ops.attention.attention_body_plain``); elsewhere (the DNA DiT and AR
at L = 200, the RNA ones at L = 50) it rounds as XLA's ``mha`` does, the
probabilities normalised before they are rounded to v's type (plain form
``ops.attention.mha``), from a first pass over the keys for each row's
maximum and sum. That second pass is taken in bf16 alone
(``kernel_rounds_as_body``): in float32 the rounding to v's type does
nothing, so the two roundings are one function and the single pass
computes it. Both products run on the tensor cores: bf16 mma, and
for float32 3xTF32 (each operand split into two TF32 halves, about
2^-20 relative error a product), summed in another order than the plain
forms.

The launch runs through ``kernel_utils.with_plain_grad``: the JAX package
defines no VJP for the Pallas kernel, and differentiates XLA's ``mha``
off the gate; here the backward of either rounding is the gradient of
its plain form.

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
from svdd_tpu_torch.ops import kernel_utils

# head dims the kernel is built for: the DiT and AR presets' 64, and 128
# (the text preset at 6 heads). ``ops.attention.flash_mha`` sends a head
# dim that is no multiple of 64 to the plain version, as the JAX
# dispatcher does; a multiple of 64 that is not built raises here.
KERNEL_HEAD_DIMS = (64, 128)


def body_rounds(l: int, d: int) -> bool:
  """Whether JAX's dispatch (``svdd_tpu/ops/attention.py:flash_mha``)
  takes the Pallas body on a TPU at sequence length ``l`` and head dim
  ``d``: the body's rounding there, ``mha``'s elsewhere."""
  return l % 128 == 0 and d % 64 == 0


def kernel_rounds_as_body(l: int, d: int, dtype: torch.dtype) -> bool:
  """Whether the kernel takes its single pass (the body's rounding) for
  q, k, v of ``dtype`` at (``l``, ``d``): on JAX's gate, and in float32
  at every shape, where ``mha``'s rounding is the same function. Only
  bf16 off the gate takes the two-pass ``mha`` rounding."""
  return body_rounds(l, d) or dtype == torch.float32


def _launch(q, k, v, causal: bool, body: bool):
  """The raw launch: checks, then the kernel writes a new (B, L, H, D)
  tensor."""
  b, l, h, d = q.shape
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
      *strides, 1.0 / math.sqrt(d), int(causal), int(not body),
      _build.dtype_code(q), _build.stream_ptr(q))
  _build.check(rc, 'svdd_flash_attention')
  _build.LAUNCHES['flash_attention_causal' if causal
                  else 'flash_attention'] += 1
  return out


def flash_attention(q, k, v, causal: bool = False):
  """(B, L, H, D) CUDA tensors q, k, v of one dtype (f32 or bf16) ->
  (B, L, H, D) contiguous, through the kernel, rounding as
  ``kernel_rounds_as_body`` says; differentiable through the plain form
  of that rounding. Raises on anything the kernel does not take."""
  from svdd_tpu_torch.ops import attention
  l, d = q.shape[1], q.shape[3]
  if k.shape != q.shape or v.shape != q.shape:
    raise ValueError(f'flash_attention: q {tuple(q.shape)}, k '
                     f'{tuple(k.shape)}, v {tuple(v.shape)} differ')
  if d not in KERNEL_HEAD_DIMS:
    raise ValueError(f'flash_attention: head dim {d} not in '
                     f'{KERNEL_HEAD_DIMS}')
  if k.dtype != q.dtype or v.dtype != q.dtype:
    raise TypeError('flash_attention: q, k and v must share a dtype')
  body = kernel_rounds_as_body(l, d, q.dtype)
  plain = attention.attention_body_plain if body else attention.mha
  return kernel_utils.with_plain_grad(
      lambda q, k, v: _launch(q, k, v, causal, body),
      lambda q, k, v: plain(q, k, v, causal), q, k, v)
