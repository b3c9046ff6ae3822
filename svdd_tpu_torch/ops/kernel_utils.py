"""Helpers shared by the kernels and the modules around them
(``svdd_tpu/ops/kernel_utils.py``): the NACDR activations and the
dead-tap rule, the contract between the im2col producers
(``ops/attn_pool.py``, ``ops/im2col.py``) and the stacked conv weight
that consumes them; and the row count the bf16 rounding gates read
(``rows_as_vmapped``)."""

from __future__ import annotations

import contextlib
import math

import torch

# the rows the bf16 rounding gates count inside rows_as_vmapped()
_GATE_ROWS: int | None = None


@contextlib.contextmanager
def rows_as_vmapped():
  """Inside, the bf16 rounding gates that count rows (the w-logits
  pools' ``attn_pool.pool_rounds_as_reference``, B5's
  ``attn_l2.attn_l2_body_rounds``) count one: the rows of a batched
  forward stand for the examples of a JAX ``vmap`` over a one-row
  function (the attributions' path points and references), whose
  dispatchers see one row each and so take their references. Launches,
  and every float32 result, are as outside."""
  global _GATE_ROWS
  saved, _GATE_ROWS = _GATE_ROWS, 1
  try:
    yield
  finally:
    _GATE_ROWS = saved


def gate_rows(n: int) -> int:
  """The row count a bf16 rounding gate reads for n rows."""
  return n if _GATE_ROWS is None else _GATE_ROWS


# activation codes the CUDA kernels take (csrc/common.cuh activate)
ACT_CODES = {None: 0, 'gelu_enformer': 1, 'relu': 2, 'gelu': 3}


# 1.702 in each activation dtype, as JAX rounds a Python float operand
# (1.703125 in bf16)
_GELU_K: dict = {}


def gelu_enformer(x: torch.Tensor) -> torch.Tensor:
  """Enformer's sigmoid-approximated GELU: x * sigmoid(1.702 x), the
  constant rounded to x's dtype."""
  k = _GELU_K.get(x.dtype)
  if k is None:
    k = _GELU_K[x.dtype] = float(torch.tensor(1.702, dtype=x.dtype))
  return x * torch.sigmoid(x * k)


def gelu(x: torch.Tensor) -> torch.Tensor:
  """The exact GELU as ``jax.nn.gelu(approximate=False)`` writes it:
  0.5 x erfc(-x / sqrt 2), in x's dtype."""
  return 0.5 * x * torch.special.erfc(-x * math.sqrt(0.5))


def act(name, x: torch.Tensor) -> torch.Tensor:
  if name is None:
    return x
  if name == 'gelu_enformer':
    return gelu_enformer(x)
  if name == 'relu':
    return torch.relu(x)
  if name == 'gelu':
    return gelu(x)
  raise NotImplementedError(name)


def live_offsets(k_taps: int, length: int, dilation: int = 1
                 ) -> list[int]:
  """Tap offsets with |off| < length; the others read only zero
  padding and are dropped."""
  half = (k_taps - 1) // 2 * dilation
  return [k * dilation - half for k in range(k_taps)
          if -length < k * dilation - half < length]


def live_taps(k_taps: int, length: int, dilation: int = 1) -> slice:
  """The kernel taps of ``live_offsets``, in the same order. They are
  always a contiguous range around the centre, so this is a slice: a
  view of a weight on any device, with no index tensor to copy."""
  half = (k_taps - 1) // 2 * dilation
  offs = live_offsets(k_taps, length, dilation)
  return slice((offs[0] + half) // dilation, (offs[-1] + half) // dilation + 1)


class _PlainGrad(torch.autograd.Function):
  """A kernel's forward whose backward differentiates its plain version,
  as the JAX package's custom VJPs around its forward-only Pallas kernels
  differentiate their jnp references; with no plain version the backward
  raises, as differentiating a Pallas call without a VJP fails in JAX."""

  @staticmethod
  def forward(ctx, kernel_fn, plain_fn, *inputs):
    ctx.plain_fn = plain_fn
    ctx.save_for_backward(*inputs)
    return kernel_fn(*inputs)

  @staticmethod
  def backward(ctx, ct):
    if ctx.plain_fn is None:
      raise NotImplementedError('this kernel has no backward, as its TPU '
                                'kernel has no VJP')
    need = ctx.needs_input_grad[2:]
    inputs = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, need)]
    with torch.enable_grad():
      out = ctx.plain_fn(*inputs)
    grads = iter(torch.autograd.grad(
        out, [t for t in inputs if t.requires_grad], ct, allow_unused=True))
    return (None, None, *[next(grads) if n else None for n in need])


def with_plain_grad(kernel_fn, plain_fn, *inputs: torch.Tensor):
  """``kernel_fn(*inputs)``, differentiable through ``plain_fn``, or
  recorded so that a backward raises where ``plain_fn`` is None."""
  return _PlainGrad.apply(kernel_fn, plain_fn, *inputs)
