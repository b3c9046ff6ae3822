"""svdd_tpu_torch's w-logits attention pool (B4), its fusion with the
next block's BN affine, activation and im2col (B3) and its backward (B8)
vs svdd_tpu: the plain versions at two column tiles and in bfloat16,
and the gate that sends shapes to the kernels.

Inputs are made with numpy from a seed and fed to both packages, in the
JAX package's (L, N, C) layout and the port's (N, L, C); an odd length
is the JAX input's last row a zero pad with ``mask_tail``, which the
port takes directly. The JAX functions are the Pallas kernels in
interpret mode, as tests/test_ops.py runs them. Tolerances: float32
with TF32 off, 3e-5 (C products summed in another order before a
sigmoid); bfloat16, inputs rounded to bf16 in both packages and the
Pallas kernel run op by op (``jax.disable_jit()``: compiled, XLA fuses
bf16 chains and skips roundings the kernel body makes), one bf16 ulp
(2^-7 relative and absolute: an f32 value near a rounding boundary can
round either way).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.ops import attn_pool_pallas as jap

from svdd_tpu_torch.ops import attn_pool as tap
from svdd_tpu_torch.ops.kernel_utils import live_offsets

torch.backends.cuda.matmul.allow_tf32 = False

F32_TOL = dict(rtol=3e-5, atol=3e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _case(l, c, residual, seed, n=8):
  """JAX (L_pad, N, C) inputs, mask_tail, and the port's (N, L, C)
  x and residual; W near 2 I as the module initialises it."""
  rs = np.random.default_rng(seed)
  l_pad = l + l % 2
  x = rs.normal(size=(l_pad, n, c)).astype(np.float32)
  res = rs.normal(size=x.shape).astype(np.float32) if residual else None
  if l % 2:
    x[-1] = 0.0
    if res is not None:
      res[-1] = 0.0
  w = (2 * np.eye(c) + rs.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
  scale = (1 + 0.2 * rs.normal(size=c)).astype(np.float32)
  shift = (0.2 * rs.normal(size=c)).astype(np.float32)
  nlc = lambda a: None if a is None else a[:l].transpose(1, 0, 2)
  return dict(x=x, res=res, w=w, scale=scale, shift=shift, mask_tail=bool(l % 2),
              xp=nlc(x), rp=nlc(res))


def _jax_pool(k, dtype, im2col):
  cast = lambda a: None if a is None else jnp.asarray(a).astype(dtype)
  if im2col:
    out = jap.pool_prologue_im2col_wlogits_lnc_pallas(
        cast(k['x']), cast(k['w']), jnp.asarray(k['scale']),
        jnp.asarray(k['shift']), 5, 'gelu_enformer', k['mask_tail'],
        residual=cast(k['res']), interpret=True)
  else:
    out = jap.attn_pool_wlogits_lnc_pallas(
        cast(k['x']), cast(k['w']), k['mask_tail'], residual=cast(k['res']),
        interpret=True)
  return np.asarray(out.astype(jnp.float32)).transpose(1, 0, 2)


def _port_pool(k, dtype, im2col):
  cast = lambda a: None if a is None else _t(a).to(dtype)
  if im2col:
    out = tap.pool_prologue_im2col_wlogits(
        cast(k['xp']), cast(k['w']), _t(k['scale']), _t(k['shift']), 5,
        'gelu_enformer', cast(k['rp']))
  else:
    out = tap.attn_pool(cast(k['xp']), cast(k['w']), cast(k['rp']))
  assert out.dtype == dtype
  return out.float().numpy()


@pytest.mark.parametrize('im2col', [False, True])
@pytest.mark.parametrize('l', [8, 7])
def test_pool_plain_two_column_tiles_matches_pallas_kernel(l, im2col):
  """C = 256, the kernels' two column tiles, with the residual; an odd
  length pools its tail alone."""
  k = _case(l, 256, True, 200 + l)
  got = _port_pool(k, torch.float32, im2col)
  want = _jax_pool(k, jnp.float32, im2col)
  lh = (l + 1) // 2
  assert got.shape == (8, lh, (len(live_offsets(5, lh)) if im2col else 1) * 256)
  np.testing.assert_allclose(got, want[:, :lh], **F32_TOL)


@pytest.mark.parametrize('im2col', [False, True])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('l', [8, 5])
def test_pool_plain_bf16_matches_pallas_kernel_op_by_op(l, residual, im2col):
  """bfloat16: the plain versions round where the Pallas bodies do (the
  residual add in bf16, d cast to bf16 for the product, f32 sums and
  blend, one rounding after the blend or the activation)."""
  k = _case(l, 128, residual, 300 + 10 * l + residual)
  for key in ('x', 'res', 'w', 'xp', 'rp'):  # the same bf16 values in both
    if k[key] is not None:
      k[key] = _t(k[key]).to(torch.bfloat16).float().numpy()
  got = _port_pool(k, torch.bfloat16, im2col)
  with jax.disable_jit():
    want = _jax_pool(k, jnp.bfloat16, im2col)
  np.testing.assert_allclose(got, want[:, :(l + 1) // 2], **BF16_TOL)


# (N, L, C) of the seven tower pools at the tests' N = 8, and shapes off
# the JAX gate: N not a multiple of 8 (the port's kernels take it), C off
# the 128-lane grid (neither package's kernels take it)
GATE_CASES = {f'tower_{l}_{c}': (8, l, c) for l, c in
              [(200, 768), (100, 768), (50, 896), (25, 1024), (13, 1152),
               (7, 1280), (4, 1536)]}
GATE_CASES.update(n_not_8=(6, 8, 128), c_off_grid=(8, 8, 192))


@pytest.mark.parametrize('im2col', [False, True])
@pytest.mark.parametrize('case', sorted(GATE_CASES))
def test_attn_pool_kernel_takes_against_jax_gate(case, im2col, monkeypatch):
  """The port's ``attn_pool_kernel_takes`` takes every shape for which
  svdd_tpu's LNC dispatchers (``attn_pool_wlogits_lnc`` /
  ``pool_prologue_im2col_wlogits_lnc`` with ``use_pallas=True``, their
  Pallas cores replaced by recorders) take their kernel, and N % 8 != 0
  besides (the TPU's tile over N is not the port's), and no width off the
  128-lane grid; off the CPU the port's wrapper sends exactly those
  shapes to the kernel (which on 'meta' tensors stops at its device
  check: no card here) and every other shape to the plain version."""
  n, l, c = GATE_CASES[case]
  l_pad = l + l % 2
  pallas = []
  monkeypatch.setattr(jap, '_wl_lnc_core',
                      lambda x, *a: pallas.append(x.shape) or x)
  monkeypatch.setattr(jap, '_wl_mega_lnc_core',
                      lambda x, *a: pallas.append(x.shape) or x)
  z = lambda *s: jnp.zeros(s, jnp.float32)
  if im2col:
    jap.pool_prologue_im2col_wlogits_lnc(
        z(l_pad, n, c), z(c, c), z(c), z(c), 5, 'gelu_enformer', bool(l % 2),
        residual=z(l_pad, n, c), use_pallas=True)
  else:
    jap.attn_pool_wlogits_lnc(z(l_pad, n, c), z(c, c), bool(l % 2),
                              residual=z(l_pad, n, c), use_pallas=True)
  takes = tap.attn_pool_kernel_takes(c)
  assert (pallas == [(l_pad, n, c)]) is (takes and n % 8 == 0)
  assert takes is (case != 'c_off_grid')
  plain = []
  name = ('pool_prologue_im2col_wlogits_plain' if im2col
          else 'attn_pool_plain')
  monkeypatch.setattr(tap, name,
                      lambda x, *a: plain.append(tuple(x.shape)) or x)
  m = lambda *s: torch.empty(s, device='meta')
  x, w, res = m(n, l, c), m(c, c), m(n, l, c)
  run = ((lambda: tap.pool_prologue_im2col_wlogits(
      x, w, m(c), m(c), 5, 'gelu_enformer', res)) if im2col
         else (lambda: tap.attn_pool(x, w, res)))
  if takes:
    with pytest.raises(ValueError, match='CUDA device'):
      run()
    assert plain == []
  else:
    run()
    assert plain == [(n, l, c)]


@pytest.mark.parametrize('n', [512, 5120])
def test_attn_pool_kernel_takes_every_tower_pool(n):
  """The kernels take every pool of the value tower at the guided
  decoders' N (the classifier's B = 512, SVDD-MC's B * M = 5120), as the
  JAX dispatchers' tile over N does there."""
  for l, c in [(200, 768), (100, 768), (50, 896), (25, 1024), (13, 1152),
               (7, 1280), (4, 1536)]:
    l_pad = l + l % 2
    k_live = len(live_offsets(5, l_pad // 2))
    assert jap._pick_tile_n_lnc(n, l_pad, c, k_live=k_live, has_res=True) > 0
    assert tap.attn_pool_kernel_takes(c)


@pytest.mark.parametrize('case', sorted(GATE_CASES))
def test_attn_pool_bwd_follows_the_gate(case, monkeypatch):
  """The backward goes where the forward does: off the CPU a width
  ``attn_pool_kernel_takes`` takes (every tower pool, N % 8 != 0
  included) reaches the kernel, stopping at its device check on 'meta'
  tensors, and another width the plain version."""
  n, l, c = GATE_CASES[case]
  plain = []
  monkeypatch.setattr(tap, 'attn_pool_bwd_plain',
                      lambda x, *a: plain.append(tuple(x.shape)) or (x, None))
  m = lambda *s: torch.empty(s, device='meta')
  args = (m(n, l, c), m(c, c), m(n, (l + 1) // 2, c), m(n, l, c))
  if tap.attn_pool_kernel_takes(c):
    with pytest.raises(ValueError, match='CUDA device'):
      tap.attn_pool_bwd(*args)
    assert plain == []
  else:
    tap.attn_pool_bwd(*args)
    assert plain == [(n, l, c)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attn_pool_off_gate_against_jax_dispatch(dtype):
  """Off the JAX gate (N % 8 != 0) the JAX dispatcher takes its
  reference, which rounds each row's logits s @ W to x's dtype before a
  pairwise softmax, where the port (its kernel on the card, its plain
  version here) follows the Pallas body's sigmoid(T(d) @ W): the same in
  f32 to the order of the sums, and up to one bf16 ulp apart in bf16
  (ROADMAP C, for A19)."""
  k = _case(8, 128, True, 600, n=6)
  jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'float32'
              else (jnp.bfloat16, torch.bfloat16))
  for key in ('x', 'res', 'w', 'xp', 'rp'):
    k[key] = _t(k[key]).to(tdt).float().numpy()
  cast = lambda a: jnp.asarray(a).astype(jdt)
  with jax.disable_jit():
    want = jap.attn_pool_wlogits_lnc(cast(k['x']), cast(k['w']), False,
                                     residual=cast(k['res']),
                                     use_pallas=True)
  want = np.asarray(want.astype(jnp.float32)).transpose(1, 0, 2)
  got = _port_pool(k, tdt, False)
  np.testing.assert_allclose(got, want,
                             **(F32_TOL if dtype == 'float32' else BF16_TOL))


def _bwd_case(l, residual, seed, n=6, c=256):
  """bf16-exact inputs of the pool's backward: the port's (N, L, C) x and
  residual, JAX's even-padded (N, L_pad, C) copies (an odd length's pad
  row zero, with mask_tail), W and the cotangent."""
  rs = np.random.default_rng(seed)
  bf = lambda a: _t(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
  x = bf(rs.normal(size=(n, l, c)))
  res = bf(rs.normal(size=(n, l, c))) if residual else None
  w = bf(2 * np.eye(c) + rs.normal(size=(c, c)) / np.sqrt(c))
  ct = bf(rs.normal(size=(n, (l + 1) // 2, c)))
  pad = lambda a: (None if a is None else
                   np.pad(a, ((0, 0), (0, l % 2), (0, 0))))
  return x, res, w, ct, pad(x), pad(res)


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('l', [1, 7, 8])
def test_attn_pool_bwd_plain_bf16_matches_pallas_kernel_op_by_op(l, residual):
  """B8 in bfloat16 at C = 256 (two column tiles of the kernel), N = 6:
  the plain version against ``attn_pool_wlogits_bwd_pallas`` run under
  ``jax.disable_jit()``, an odd length against JAX's even-padded input
  with mask_tail (L = 1: the tail alone, whose dx is ct and dW zero).
  dx within one bf16 ulp (BF16_TOL): both round the residual sum, T(d),
  T(dld) and dx where the Pallas body does, and sum in f32 in other
  orders. dW within 2^-7 of its largest value: interpret mode evaluates
  the body as one XLA computation on the CPU, which may skip a bf16
  rounding the body writes before an f32 product (T(dld)), 2^-9 relative
  a term of a sum over N*ceil(L/2) rows."""
  x, res, w, ct, xj, rj = _bwd_case(l, residual, 700 + 10 * l + residual)
  cast = lambda a: None if a is None else jnp.asarray(a).astype(jnp.bfloat16)
  with jax.disable_jit():
    want_dx, want_dw = jap.attn_pool_wlogits_bwd_pallas(
        cast(xj), cast(w), cast(ct), bool(l % 2), residual=cast(rj),
        interpret=True)
  want_dx = np.asarray(want_dx.astype(jnp.float32))[:, :l]
  want_dw = np.asarray(want_dw)
  bf = lambda a: None if a is None else _t(a).to(torch.bfloat16)
  dx, dw = tap.attn_pool_bwd_plain(bf(x), bf(w), bf(ct), bf(res))
  assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
  np.testing.assert_allclose(dx.float().numpy(), want_dx, **BF16_TOL)
  scale = np.abs(want_dw).max()
  if l == 1:   # the tail pools alone: no pair, no weight gradient
    assert scale == 0 and not dw.abs().max()
    np.testing.assert_array_equal(dx.float().numpy()[:, 0], ct[:, 0])
  else:
    assert np.abs(dw.numpy() - want_dw).max() <= 2 ** -7 * scale

