"""Pairwise attention pool (pool size 2), alone and fused with the next
conv block's BN affine, activation and im2col, and the pool's backward.

W-logits kernels, for widths C on the 128-lane grid (where the JAX
module's ``wlogits_pool_ok`` holds): the logits difference is computed
in the kernel from the pool weight W.
  * ``csrc/attn_pool.cu``, one kernel template for the two forwards,
    on the tensor cores (bf16 mma, f32 as 3xTF32): ``attn_pool``
    replaces
    ``svdd_tpu/ops/attn_pool_pallas.py:attn_pool_wlogits_lnc_pallas``
    (pallas_call :916) and computes the function of
    ``attn_pool_wlogits_pallas`` (:397) as well, since the port keeps
    one (N, L, C) layout; ``pool_prologue_im2col_wlogits`` replaces
    ``pool_prologue_im2col_wlogits_lnc_pallas`` (pallas_call :1071) and
    likewise computes ``pool_prologue_im2col_wlogits_pallas`` (:721);
  * ``csrc/attn_pool_bwd.cu`` replaces ``attn_pool_wlogits_bwd_pallas``
    (pallas_call :523): dx and dW of the pool (the residual's gradient
    is dx), on the tensor cores: T(d) by an elementwise pass, the
    recomputed logits and the dgrad on ``conv_mma.cuh``'s tap routine at
    one tap, the wgrad on B7's template (``conv_wgrad.cuh``).

Logits kernels, for the other widths, where the module computes the
logits x @ W first (the JAX module's legacy branch,
``svdd_tpu/models/blocks.py:288-298``): ``csrc/attn_pool_logits.cu``.
  * ``attn_pool_fused`` (B11a) replaces ``attn_pool_pallas``
    (pallas_call :81), plain version ``attn_pool_reference`` (:37);
  * ``pool_prologue_im2col`` (B11b) replaces
    ``pool_prologue_im2col_pallas`` (pallas_call :203), plain version
    ``pool_prologue_im2col_reference`` (:138).
  Both take an even L (the module pads an odd one with a zero row of x
  and a lowest-finite logit) and any C, and are differentiable through
  their plain versions, as the JAX custom VJPs (:112-117, :243-247) are.

The kernels' one shape term, C a multiple of 128 (their column tile and
k chunks), is stated once in ``attn_pool_kernel_takes``: a CUDA shape it
takes launches the kernel or raises, any other takes the plain version,
forward and backward. They take any N and L (ragged row tiles, odd L).

One rounding follows JAX's dispatch. On a TPU the w-logits dispatchers
run their Pallas bodies (the blend above) only on their gate: an even
padded L, C % 128 == 0 and a tile over N that fits the kernel's VMEM
plan, N % 8 == 0 in the L-major eval tower (``attn_pool_pallas.py:
979-980``, ``:1137-1139``, ``:815-820``); elsewhere they take
``attn_pool_wlogits_reference`` (:308-322), which rounds each row's
logits s @ W to the activation type before a pairwise softmax. In f32
the two agree to f32 rounding and the port keeps the blend everywhere;
in bf16 ``pool_rounds_as_reference`` states the gate and a shape off it
takes the reference form on CPU and card alike (no launch), forward and
backward, as JAX differentiates the reference there.

``attn_pool`` is differentiable: ``_AttnPool`` runs the forward and
backward kernels on CUDA tensors and the plain pair on CPU tensors. The
fused ``pool_prologue_im2col_wlogits`` is differentiable too, through
its plain version (``kernel_utils.with_plain_grad``), as JAX's custom
VJPs differentiate their jnp references: the guided decoders' gradients
take the unfused tower (``models/enformer.py``), but the multisep
trainer differentiates the fused eval tower, as JAX's does.

Math of the w-logits pool, per pair of rows (x0, x1) of s = x +
residual (added in x's dtype): d = x0 - x1 in f32, logits difference
ld = d @ W (d cast to x's dtype, products summed in f32), out = x1 + d *
sigmoid(ld). A pairwise softmax is exactly this sigmoid blend. An odd
length L pools its last row alone: its weight is forced to 1 and out =
x0, the selection the JAX package makes with a -inf logit pad or
``mask_tail``. The port keeps the (N, L, C) layout and takes odd L
directly, so it needs neither the TPU's pad slabs (``pad_out``) nor a
mask flag.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from svdd_tpu_torch import _build
from svdd_tpu_torch.ops.im2col import im2col, nacdr_im2col_reference
from svdd_tpu_torch.ops.kernel_utils import (ACT_CODES, act, gate_rows,
                                             live_offsets, with_plain_grad)


def _pooled_f32(x, w, residual=None):
  """(N, L, C) -> pooled (N, ceil(L/2), C) in f32."""
  s = x if residual is None else x + residual
  l = s.shape[1]
  if l % 2:
    s = F.pad(s, (0, 0, 0, 1))
  x0 = s[:, 0::2].float()
  x1 = s[:, 1::2].float()
  d = x0 - x1
  ld = torch.matmul(d.to(x.dtype).float(), w.to(x.dtype).float())
  wgt = torch.sigmoid(ld)
  if l % 2:   # not in place: autograd differentiates this version
    wgt = torch.cat([wgt[:, :-1], torch.ones_like(wgt[:, -1:])], dim=1)
  return x1 + d * wgt


def attn_pool_plain(x, w, residual=None):
  """x (N, L, C), w (C, C), residual like x -> (N, ceil(L/2), C)."""
  return _pooled_f32(x, w, residual).to(x.dtype)


def attn_pool_bwd_plain(x, w, ct, residual=None):
  """Gradients of ``attn_pool_plain`` given ct (N, ceil(L/2), C):
  (dx like x, dW (C, C) f32), by the formulas of
  ``attn_pool_pallas.py:417-423``; the residual's gradient is dx. The
  odd tail row pools alone with weight 1: its dld is 0, its dx is ct."""
  dt = x.dtype
  n, l, c = x.shape
  s = x if residual is None else x + residual
  if l % 2:
    s = F.pad(s, (0, 0, 0, 1))
  d = s[:, 0::2].float() - s[:, 1::2].float()
  dq = d.to(dt).float()
  w32 = w.to(dt).float()
  wgt = torch.sigmoid(torch.matmul(dq, w32))
  ct32 = ct.to(dt).float()
  dld = ct32 * d * wgt * (1.0 - wgt)
  if l % 2:
    wgt[:, -1] = 1.0
    dld[:, -1] = 0.0
  dld = dld.to(dt).float()
  dx0 = ct32 * wgt + torch.matmul(dld, w32.T)
  dx = torch.stack([dx0, ct32 - dx0], dim=2).reshape(n, -1, c)[:, :l]
  dw = dq.reshape(-1, c).T @ dld.reshape(-1, c)
  return dx.to(dt), dw


def pool_prologue_im2col_wlogits_plain(x, w, scale, shift, k_taps: int,
                               act_name, residual=None):
  """pool -> act(pooled * scale + shift) -> im2col, (N, LH, k_live*C)."""
  pooled = _pooled_f32(x, w, residual)
  y = act(act_name, pooled * scale.float() + shift.float()).to(x.dtype)
  return im2col(y, k_taps)


def attn_pool_wlogits_reference(x, w, residual=None):
  """The jnp reference of the w-logits pool (``attn_pool_pallas.py:
  attn_pool_wlogits_reference``): s = x + residual in x's dtype, an odd
  L padded with a zero row, the logits s @ W summed in f32 and rounded to
  x's dtype, the padded row's logits the lowest value (its pair pools
  its first row alone), then ``attn_pool_reference``."""
  s = x if residual is None else x + residual
  dt = s.dtype
  l = s.shape[1]
  if l % 2:
    s = F.pad(s, (0, 0, 0, 1))
  logits = torch.matmul(s.float(), w.to(dt).float()).to(dt)
  if l % 2:   # f32's lowest value, in dt as JAX casts it (bf16: -inf)
    low = torch.full(logits[:, -1:].shape, torch.finfo(torch.float32).min,
                     device=logits.device).to(dt)
    logits = torch.cat([logits[:, :-1], low], dim=1)
  return attn_pool_reference(s, logits)


def pool_prologue_im2col_wlogits_reference(x, w, scale, shift, k_taps: int,
                                           act_name, residual=None):
  """The jnp reference of the fused pool (``attn_pool_pallas.py:
  pool_prologue_im2col_wlogits_reference``): ``attn_pool_wlogits_reference``
  rounded to x's dtype, then ``nacdr_im2col_reference``."""
  return nacdr_im2col_reference(attn_pool_wlogits_reference(x, w, residual),
                                scale, shift, k_taps, act_name)


# the VMEM budget of JAX's w-logits tile pickers (attn_pool_pallas.py:
# _pick_tile_n_wl, _pick_tile_n_wl_mega, _pick_tile_n_lnc)
_VMEM_BUDGET = 60 * 2 ** 20


def wlogits_body_takes(n: int, l: int, c: int, *, lnc: bool,
                       k_live: int = 0, has_res: bool = False) -> bool:
  """Whether JAX's w-logits dispatcher, with Pallas on (a TPU), runs
  its Pallas body for x (N, L, C), L padded to even: C % 128 == 0 and
  the smallest tile over N fits the VMEM plan of its tile picker. ``lnc``:
  the L-major eval tower (an even input length), whose tiles are
  multiples of 8 that divide N; otherwise (an odd input length, or the
  differentiable tower) any tile. ``k_live``: the live taps of the
  fused im2col, 0 for the pool alone; ``has_res``: a residual rides in."""
  l += l % 2
  tile = 8 if lnc else 1
  if c % 128 or n % tile:
    return False
  rows = tile * l * c
  est = ((4 if has_res else 2) * rows * 2 + 4 * (rows // 2) * 4
         + c * c * 2 + (rows // 2 * 2 if k_live else 0)
         + 2 * (rows // 2) * max(k_live, 1) * 2)
  return est <= _VMEM_BUDGET


def pool_rounds_as_reference(x, *, lnc: bool, k_live: int = 0,
                             has_res: bool = False) -> bool:
  """bf16 x on a shape JAX's dispatcher sends to its reference
  (``wlogits_body_takes`` false): the pool takes the reference's
  rounding. float32 keeps the blend."""
  n, l, c = x.shape
  return x.dtype == torch.bfloat16 and not wlogits_body_takes(
      gate_rows(n), l, c, lnc=lnc, k_live=k_live, has_res=has_res)


def attn_pool_kernel_takes(c: int) -> bool:
  """The widths the w-logits kernels (forwards and backward) take: C a
  multiple of 128, their column tile and k chunks. Any N and L."""
  return c >= 128 and c % 128 == 0


def _check(name, x, w, residual):
  c = x.shape[2]
  if w.shape != (c, c):
    raise ValueError(f'{name}: needs w (C, C), got x {tuple(x.shape)} '
                     f'w {tuple(w.shape)}')
  if residual is not None and residual.shape != x.shape:
    raise ValueError(f'{name}: residual {tuple(residual.shape)} != '
                     f'x {tuple(x.shape)}')


def _kernel_operands(name, x, w, residual):
  """Checks and contiguous operands of the forward kernels: x, W^T (the
  product's B operand, stored by rows of output columns; landing W's
  tile by rows of k instead ran no faster, PERF.md §6) and the
  residual, all in x's dtype."""
  _check(name, x, w, residual)
  x = x.contiguous()
  wt = w.to(x.dtype).t().contiguous()
  res = None if residual is None else residual.to(x.dtype).contiguous()
  _build.require_cuda(name, x, wt, res)
  _build.require_aligned(name, x, wt, res)
  return x, wt, res


def _plain(x) -> bool:
  """The pool takes its plain versions on CPU tensors and on widths
  ``attn_pool_kernel_takes`` refuses."""
  return x.device.type == 'cpu' or not attn_pool_kernel_takes(x.shape[2])


def _attn_pool(x, w, residual=None):
  """The pool through the CUDA kernel, or the plain version (CPU
  tensors, widths off ``attn_pool_kernel_takes``)."""
  if _plain(x):
    return attn_pool_plain(x, w, residual)
  x, wt, res = _kernel_operands('attn_pool', x, w, residual)
  n, l, c = x.shape
  out = torch.empty((n, (l + 1) // 2, c), dtype=x.dtype, device=x.device)
  rc = _build.entry('svdd_attn_pool')(
      x.data_ptr(), 0 if res is None else res.data_ptr(), wt.data_ptr(),
      out.data_ptr(), n, l, c, _build.dtype_code(x),
      _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool')
  _build.LAUNCHES['attn_pool'] += 1
  return out


def attn_pool_bwd(x, w, ct, residual=None):
  """(dx, dW) through the CUDA kernel, or ``attn_pool_bwd_plain`` (CPU
  tensors, widths off ``attn_pool_kernel_takes``)."""
  if _plain(x):
    return attn_pool_bwd_plain(x, w, ct, residual)
  _check('attn_pool_bwd', x, w, residual)
  n, l, c = x.shape
  lh = (l + 1) // 2
  if ct.shape != (n, lh, c):
    raise ValueError(f'attn_pool_bwd: ct {tuple(ct.shape)} != '
                     f'{(n, lh, c)}')
  dt = x.dtype
  x = x.contiguous()
  wc = w.to(dt).contiguous()
  wtr = wc.T.contiguous()
  res = None if residual is None else residual.to(dt).contiguous()
  ct = ct.to(dt).contiguous()
  _build.require_cuda('attn_pool_bwd', x, wc, wtr, res, ct)
  _build.require_aligned('attn_pool_bwd', x, wc, wtr, res, ct)
  chunks = _build.row_chunks(n * lh, (c // 128) ** 2)
  dx = torch.empty_like(x)
  dw = torch.empty((c, c), dtype=torch.float32, device=x.device)
  # T(d) and T(dld); wgt and, over more than one row chunk, dW's partials
  scratch_t = torch.empty(2 * n * lh * c, dtype=dt, device=x.device)
  scratch_f = torch.empty(n * lh * c + (chunks * c * c if chunks > 1 else 0),
                          dtype=torch.float32, device=x.device)
  rc = _build.entry('svdd_attn_pool_bwd')(
      x.data_ptr(), 0 if res is None else res.data_ptr(), wc.data_ptr(),
      wtr.data_ptr(), ct.data_ptr(), dx.data_ptr(), dw.data_ptr(),
      scratch_t.data_ptr(), scratch_f.data_ptr(), n, l, c, chunks,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool_bwd')
  _build.LAUNCHES['attn_pool_bwd'] += 1
  return dx, dw


class _AttnPool(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, w, residual):
    ctx.save_for_backward(x, w, residual)
    return _attn_pool(x, w, residual)

  @staticmethod
  def backward(ctx, ct):
    x, w, residual = ctx.saved_tensors
    dx, dw = attn_pool_bwd(x, w, ct, residual)
    # the blend sees only x + residual: both gradients are dx
    return dx, dw.to(w.dtype), None if residual is None else dx


def attn_pool(x, w, residual=None, lnc: bool = False):
  """The pool through the CUDA kernels (CUDA tensors) or the plain
  versions (CPU tensors); differentiable in x, w and the residual. In
  bf16 off JAX's gate (``pool_rounds_as_reference``; ``lnc`` as there)
  the reference form, differentiated by autograd."""
  if pool_rounds_as_reference(x, lnc=lnc, has_res=residual is not None):
    return attn_pool_wlogits_reference(x, w, residual)
  return _AttnPool.apply(x, w, residual)


def pool_prologue_im2col_wlogits(x, w, scale, shift, k_taps: int,
                                 act_name, residual=None, lnc: bool = False):
  """Pool + BN affine + act + im2col through the CUDA kernel, or the
  plain version (CPU tensors, widths off ``attn_pool_kernel_takes``).
  In bf16 off JAX's gate (``pool_rounds_as_reference``; ``lnc`` as
  there) the reference form: the pool rounded to x's dtype, then
  ``nacdr_im2col_reference``."""
  k_live = len(live_offsets(k_taps, (x.shape[1] + 1) // 2))
  if pool_rounds_as_reference(x, lnc=lnc, k_live=k_live,
                              has_res=residual is not None):
    return pool_prologue_im2col_wlogits_reference(x, w, scale, shift, k_taps,
                                                  act_name, residual)
  if _plain(x):
    return pool_prologue_im2col_wlogits_plain(x, w, scale, shift, k_taps,
                                              act_name, residual)
  # the kernel writes its output outside autograd: its backward is the
  # gradient of the reference form, as JAX's custom VJPs
  # (attn_pool_pallas.py:740-787, :1080-1125) take the reference's VJP
  # (in f32 the plain version's to f32 rounding)
  plain = lambda *a: pool_prologue_im2col_wlogits_reference(
      *a[:4], k_taps, act_name, *a[4:])
  kernel = lambda *a: _pool_prologue_im2col_kernel(*a[:4], k_taps, act_name,
                                                   *a[4:])
  inputs = (x, w, scale, shift) + (() if residual is None else (residual,))
  return with_plain_grad(kernel, plain, *inputs)


def _pool_prologue_im2col_kernel(x, w, scale, shift, k_taps: int, act_name,
                                 residual=None):
  """The launch of kernel B3: (N, LH, k_live*C) in x's dtype."""
  x, wt, res = _kernel_operands('pool_prologue_im2col_wlogits', x, w,
                                residual)
  n, l, c = x.shape
  lh = (l + 1) // 2
  offsets = live_offsets(k_taps, lh)
  scale = scale.float().contiguous()
  shift = shift.float().contiguous()
  if scale.shape != (c,) or shift.shape != (c,):
    raise ValueError(f'pool_prologue_im2col_wlogits: scale and shift must '
                     f'be ({c},)')
  _build.require_cuda('pool_prologue_im2col_wlogits', scale, shift)
  # the epilogue reads them two floats at a time
  _build.require_aligned('pool_prologue_im2col_wlogits', scale, shift)
  out = torch.empty((n, lh, len(offsets) * c), dtype=x.dtype,
                    device=x.device)
  offs = _build.int_array(offsets)
  rc = _build.entry('svdd_attn_pool_im2col')(
      x.data_ptr(), 0 if res is None else res.data_ptr(), wt.data_ptr(),
      scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
      ctypes.addressof(offs), len(offsets), ACT_CODES[act_name], n, l, c,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool_im2col')
  _build.LAUNCHES['attn_pool_prologue_im2col'] += 1
  return out


# ---------------------------------------------------------------------------
# the pool from given logits: widths off the 128-lane grid
# ---------------------------------------------------------------------------


def attn_pool_reference(x, logits):
  """x, logits (N, L, C), L even -> (N, L/2, C): per pair of rows, the
  softmax of the two logits in f32, the weighted sum of the two rows in
  f32, rounded to x's dtype (``attn_pool_pallas.py:37-43``)."""
  n, l, c = x.shape
  xg = x.float().reshape(n, l // 2, 2, c)
  attn = torch.softmax(logits.float().reshape(n, l // 2, 2, c), dim=2)
  return (xg * attn).sum(dim=2).to(x.dtype)


def pool_prologue_im2col_reference(x, logits, scale, shift, k_taps: int,
                                   act_name):
  """``attn_pool_reference``, rounded to x's dtype, then
  ``nacdr_im2col_reference`` over the pooled length
  (``attn_pool_pallas.py:138-149``): (N, L/2, k_live*C)."""
  return nacdr_im2col_reference(attn_pool_reference(x, logits), scale,
                                shift, k_taps, act_name)


def _check_logits(name, x, logits):
  n, l, c = x.shape
  if logits.shape != x.shape or l % 2:
    raise ValueError(f'{name}: needs x and logits of one (N, L, C) shape '
                     f'with L even, got x {tuple(x.shape)} logits '
                     f'{tuple(logits.shape)}')


def _attn_pool_logits_kernel(x, logits):
  _check_logits('attn_pool_fused', x, logits)
  n, l, c = x.shape
  x = x.contiguous()
  logits = logits.to(x.dtype).contiguous()
  _build.require_cuda('attn_pool_fused', x, logits)
  _build.require_aligned('attn_pool_fused', x, logits)
  out = torch.empty((n, l // 2, c), dtype=x.dtype, device=x.device)
  rc = _build.entry('svdd_attn_pool_logits')(
      x.data_ptr(), logits.data_ptr(), out.data_ptr(), n, l, c,
      _build.dtype_code(x), _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool_logits')
  _build.LAUNCHES['attn_pool_logits'] += 1
  return out


def attn_pool_fused(x, logits):
  """The pool from given logits through kernel B11a (CUDA tensors) or
  ``attn_pool_reference`` (CPU tensors); L even."""
  if x.device.type == 'cpu':
    return attn_pool_reference(x, logits)
  return with_plain_grad(_attn_pool_logits_kernel, attn_pool_reference,
                         x, logits)


def _attn_pool_logits_im2col_kernel(x, logits, scale, shift, k_taps: int,
                                    act_name):
  _check_logits('pool_prologue_im2col', x, logits)
  n, l, c = x.shape
  lh = l // 2
  offsets = live_offsets(k_taps, lh)
  x = x.contiguous()
  logits = logits.to(x.dtype).contiguous()
  scale = scale.float().contiguous()
  shift = shift.float().contiguous()
  if scale.shape != (c,) or shift.shape != (c,):
    raise ValueError(f'pool_prologue_im2col: scale and shift must be '
                     f'({c},)')
  _build.require_cuda('pool_prologue_im2col', x, logits, scale, shift)
  _build.require_aligned('pool_prologue_im2col', x, logits)
  out = torch.empty((n, lh, len(offsets) * c), dtype=x.dtype,
                    device=x.device)
  offs = _build.int_array(offsets)
  rc = _build.entry('svdd_attn_pool_logits_im2col')(
      x.data_ptr(), logits.data_ptr(), scale.data_ptr(), shift.data_ptr(),
      out.data_ptr(), ctypes.addressof(offs), len(offsets),
      ACT_CODES[act_name], n, l, c, _build.dtype_code(x),
      _build.stream_ptr(x))
  _build.check(rc, 'svdd_attn_pool_logits_im2col')
  _build.LAUNCHES['attn_pool_logits_im2col'] += 1
  return out


def pool_prologue_im2col(x, logits, scale, shift, k_taps: int, act_name):
  """The pool from given logits, then the next block's BN affine,
  activation and im2col, through kernel B11b (CUDA tensors) or
  ``pool_prologue_im2col_reference`` (CPU tensors); L even."""
  if x.device.type == 'cpu':
    return pool_prologue_im2col_reference(x, logits, scale, shift, k_taps,
                                          act_name)
  return with_plain_grad(
      lambda *a: _attn_pool_logits_im2col_kernel(*a, k_taps, act_name),
      lambda *a: pool_prologue_im2col_reference(*a, k_taps, act_name),
      x, logits, scale, shift)
