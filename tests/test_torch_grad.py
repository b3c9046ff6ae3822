"""Gradient-guided decoding in svdd_tpu_torch vs svdd_tpu: the backward
kernels' plain versions (B6 cnn layer, B7 shifted conv, B8 attention
pool) and the (N, L, C) forwards that the port's kernels cover (B9a,
B9b, B10) against the JAX kernels in interpret mode; B5's plain version
in bfloat16 and its gate against JAX's dispatcher; each
``torch.autograd.Function`` against autograd through the plain ops; the
value net's input gradient; the DPS and classifier steps pinned to the
JAX steps given the same Gumbel noise; whole decodes in distribution;
the three CLIs on the CPU.

Float32 with TF32 off. Tolerances: 2e-4 abs and rel for per-element
gradients, 2e-3 abs for weight gradients summed over rows, as
tests/test_ops_bwd.py holds the JAX kernels to their references.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats as sps

from svdd_tpu import rewards as jrewards
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models.blocks import unfused_guard
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer
from svdd_tpu.ops import attn_l2_pallas as jl2
from svdd_tpu.ops import attn_pool_pallas as jap
from svdd_tpu.ops import cnn_layer_pallas as jcnn
from svdd_tpu.ops import conv1d_bwd_pallas as jconv
from svdd_tpu.sampling import guidance as jguidance

from svdd_tpu_torch import mdlm, rewards
from svdd_tpu_torch.cli import decode_classfier, decode_DG, decode_DPS
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.ops import attn_l2 as tl2
from svdd_tpu_torch.ops import attn_pool as tap
from svdd_tpu_torch.ops import cnn_layer as tcnn
from svdd_tpu_torch.ops import conv1d as tconv
from svdd_tpu_torch.ops.kernel_utils import live_offsets
from svdd_tpu_torch.sampling import guidance, sampler
from svdd_tpu_torch.weights import cnn_from_jax, enformer_value_from_jax
from torch_port_helpers import random_cnn_variables, random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DX_TOL = dict(rtol=2e-4, atol=2e-4)
DW_TOL = dict(rtol=2e-4, atol=2e-3)
B, L, STEPS = 256, 16, 8
KS_PVAL = 1e-3


def _t(a):
  return torch.from_numpy(np.array(a))


def _normal(rs, shape, scale=1.0):
  return (scale * rs.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# backward kernels' plain versions vs the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('dilation', [1, 64])
def test_cnn_layer_bwd_plain_matches_pallas_kernel(dilation):
  """B6, all six cotangents; at L=40 dilation 64 leaves one live tap."""
  rs = np.random.default_rng(dilation)
  n, l, c = 8, 40, 128
  args = (_normal(rs, (n, l, c)), _normal(rs, (n, c), 0.5),
          1 + _normal(rs, c, 0.1), _normal(rs, c, 0.1),
          _normal(rs, (9, c, c), 0.05), _normal(rs, c, 0.1),
          _normal(rs, (n, l, c)))
  want = jcnn.cnn_layer_bwd_pallas(*map(jnp.asarray, args),
                                   dilation=dilation, interpret=True)
  got = tcnn.cnn_layer_bwd_plain(*map(_t, args), dilation=dilation)
  names = ('dx', 'dbias_row', 'dln_scale', 'dln_bias', 'dkernel',
           'dconv_bias')
  for name, g, w in zip(names, got, want):
    tol = DX_TOL if name == 'dx' else DW_TOL
    np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                               **tol)


@pytest.mark.parametrize('l,dilation,c_in,c_out', [
    (20, 1, 128, 256),     # a tower conv shape: k=5, Cin != Cout
    (8, 4, 128, 128),      # offsets +-8 are dead at L=8
    (4, 1, 128, 256),      # the tower's last lengths: a sequence shorter
    (7, 1, 128, 256),      # than the kernel's row tiles, all five taps live
])
def test_conv1d_bwd_plain_matches_pallas_kernel(l, dilation, c_in, c_out):
  """B7: dgrad and wgrad; dead taps get zero weight gradients."""
  rs = np.random.default_rng(l)
  x = _normal(rs, (8, l, c_in))
  w = _normal(rs, (5, c_in, c_out), 0.1)
  ct = _normal(rs, (8, l, c_out))
  want_dx, want_dw = jconv.conv1d_bwd_pallas(
      *map(jnp.asarray, (x, w, ct)), dilation=dilation, interpret=True)
  got_dx, got_dw = tconv.conv1d_bwd_plain(*map(_t, (x, w, ct)), dilation)
  np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), **DX_TOL)
  np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), **DW_TOL)
  assert tconv.conv_bwd_ok(l, c_in, c_out, 5, dilation)
  if dilation == 4:
    assert len(live_offsets(5, l, dilation)) == 3
    assert not got_dw[0].any() and not got_dw[4].any()


BF16_SUM = 2 ** -7


def test_conv1d_bwd_plain_bf16_matches_pallas_kernel():
  """B7 in bf16, inputs rounded to bf16 and fed to both: dgrad and wgrad
  sum exact bf16 products in f32 in both packages, dx rounded to bf16 once
  and the JAX kernel's dkernel rounded to bf16 (the kernel's dtype), so
  they agree to the bf16 sums' rule, 2^-7 of the largest value (and 2^-7
  relative per element for dx)."""
  rs = np.random.default_rng(77)
  x, w, ct = (_t(_normal(rs, s, sc)).to(torch.bfloat16)
              for s, sc in (((8, 13, 128), 1.0), ((5, 128, 256), 0.1),
                            ((8, 13, 256), 1.0)))
  as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
  want_dx, want_dw = (np.asarray(a.astype(jnp.float32)) for a in
                      jconv.conv1d_bwd_pallas(as_jax(x), as_jax(w), as_jax(ct),
                                              interpret=True))
  got_dx, got_dw = tconv.conv1d_bwd_plain(x, w, ct)
  assert got_dx.dtype == torch.bfloat16 and got_dw.dtype == torch.float32
  np.testing.assert_allclose(got_dx.float().numpy(), want_dx, rtol=BF16_SUM,
                             atol=BF16_SUM * np.abs(want_dx).max())
  np.testing.assert_allclose(got_dw.numpy(), want_dw, rtol=0,
                             atol=BF16_SUM * np.abs(want_dw).max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['start', 'off_grid', 'aligned'])
def test_conv1d_bwd_wrapper_needs_16_byte_rows(case, dtype):
  """B7's kernels copy rows of x and ct in 16-byte chunks into shared
  memory, so the wrapper refuses, before any launch, an x that starts off
  a 16-byte boundary and a shape ``conv_bwd_ok`` refuses (channels off
  the 128-lane grid: rows that are not whole chunks); an aligned on-grid
  x reaches the device check. Shown on 'meta' tensors (no card here)."""
  c = 108 if case == 'off_grid' else 128
  m = lambda *s: torch.empty(s, device='meta', dtype=dtype)
  x = m(8, 7, c)
  if case == 'start':
    x = m(8 * 7 * c + 1)[1:].view(8, 7, c)
    assert x.data_ptr() % 16
  match = {'start': 'start 16-byte aligned', 'off_grid': 'fail conv_bwd_ok',
           'aligned': 'CUDA device'}[case]
  with pytest.raises(ValueError, match=match):
    tconv.conv1d_bwd(x, m(5, c, 256), m(8, 7, 256))


def _pool_case(odd, residual, seed):
  """Port inputs (N, L, C) and the JAX kernel's even-padded form."""
  rs = np.random.default_rng(seed)
  n, l, c = 4, 9 if odd else 10, 128
  x = _normal(rs, (n, l, c))
  res = _normal(rs, (n, l, c)) if residual else None
  w = (2 * np.eye(c) + _normal(rs, (c, c), 0.1)).astype(np.float32)
  pad = (lambda a: None if a is None else
         np.pad(a, ((0, 0), (0, 1), (0, 0))) if odd else a)
  return x, res, w, pad(x), pad(res), rs


@pytest.mark.parametrize('odd', [False, True])
@pytest.mark.parametrize('residual', [False, True])
def test_attn_pool_bwd_plain_matches_pallas_kernel(residual, odd):
  """B8; an odd port length against JAX's even-padded input with
  mask_tail, whose pad row is dropped."""
  x, res, w, xj, rj, rs = _pool_case(odd, residual, 2 * residual + odd)
  ct = _normal(rs, (4, 5, 128))
  want_dx, want_dw = jap.attn_pool_wlogits_bwd_pallas(
      jnp.asarray(xj), jnp.asarray(w), jnp.asarray(ct), odd,
      residual=None if rj is None else jnp.asarray(rj), interpret=True)
  got_dx, got_dw = tap.attn_pool_bwd_plain(
      _t(x), _t(w), _t(ct), None if res is None else _t(res))
  np.testing.assert_allclose(got_dx.numpy(),
                             np.asarray(want_dx)[:, :x.shape[1]], **DX_TOL)
  np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), **DW_TOL)
  if odd:   # the tail row pools alone: its gradient is the cotangent
    np.testing.assert_array_equal(got_dx[:, -1].numpy(), ct[:, -1])


# ---------------------------------------------------------------------------
# the (N, L, C) forwards the port's kernels cover: B9a, B9b, B10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('odd', [False, True])
def test_attn_pool_plain_matches_nlc_pallas_kernel(odd):
  """B9a, covered by the attn_pool kernel, with a residual."""
  x, res, w, xj, rj, _ = _pool_case(odd, True, 10 + odd)
  want = jap.attn_pool_wlogits_pallas(jnp.asarray(xj), jnp.asarray(w), odd,
                                      residual=jnp.asarray(rj),
                                      interpret=True)
  got = tap.attn_pool_plain(_t(x), _t(w), _t(res))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **DX_TOL)


def test_pool_prologue_im2col_plain_matches_nlc_pallas_kernel():
  """B9b, covered by the attn_pool_prologue_im2col kernel: k=5 at a
  pooled length of 5."""
  x, res, w, xj, rj, rs = _pool_case(False, True, 12)
  scale, shift = 1 + _normal(rs, 128, 0.2), _normal(rs, 128, 0.2)
  want = jap.pool_prologue_im2col_wlogits_pallas(
      *map(jnp.asarray, (xj, w, scale, shift)), 5, 'gelu_enformer', False,
      residual=jnp.asarray(rj), interpret=True)
  got = tap.pool_prologue_im2col_wlogits_plain(
      _t(x), _t(w), _t(scale), _t(shift), 5, 'gelu_enformer', _t(res))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                             atol=3e-5)


def test_attn_l2_plain_matches_nlc_pallas_kernel():
  """B10, covered by the attn_l2 kernel: 2 heads, dk 64, dv 64."""
  rs = np.random.default_rng(13)
  n, h, dk, dv = 8, 2, 64, 64
  q = _normal(rs, (n, 2, h * dk), 1 / 8)
  k, v = _normal(rs, (n, 2, h * dk)), _normal(rs, (n, 2, h * dv))
  bc, bp = _normal(rs, h * dk), _normal(rs, h * dk)
  relk = _normal(rs, (3, h * dk))
  out_j, w_j = jl2.attn_l2_pallas(
      *map(jnp.asarray, (q, k, v, bc, bp, relk)),
      jnp.asarray(jl2.head_selector(h, dk)),
      jnp.asarray(jl2.head_expander(h, dv)), interpret=True)
  out, w = tl2.attn_l2_plain(*map(_t, (q, k, v, bc, bp, relk)), heads=h)
  np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-5,
                             atol=1e-5)


def _attn_l2_bf16_case(seed, exact_relk, n=8, h=2, dk=64, dv=64):
  """bf16 inputs of B5 in JAX's (2, N, H*d) layout, dqk = dv = 128: q
  (pre-scaled), bc and bp on a grid where q + bc and q + bp are exact in
  bf16 (multiples of 2^-6 under 2); relk on a grid where its row
  differences are exact too (multiples of 2^-4 under 2), or normal."""
  rs = np.random.default_rng(seed)
  grid = lambda shape, step, top: (
      step * rs.integers(-top, top + 1, size=shape)).astype(np.float32)
  bf = lambda a: _t(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
  q = grid((2, n, h * dk), 2 ** -6, 32)
  k, v = bf(rs.normal(size=(2, n, h * dk))), bf(rs.normal(size=(2, n, h * dv)))
  bc, bp = grid((2, h * dk), 2 ** -6, 64)
  relk = grid((3, h * dk), 2 ** -4, 16) if exact_relk else bf(
      rs.normal(size=(3, h * dk)))
  return (q, k, v, bc, bp, relk), h, dk, dv


def _attn_l2_bf16(case):
  """(the Pallas kernel's out and w under jax.disable_jit(), the port's
  plain out and w, the inputs), all (N, 2, .) in f32."""
  (q, k, v, bc, bp, relk), h, dk, dv = case
  cast = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
  sel = jnp.asarray(jl2.head_selector(h, dk))
  exp = jnp.asarray(jl2.head_expander(h, dv))
  with jax.disable_jit():
    out_j, w_j = jl2.attn_l2_lnc_pallas(
        *map(cast, (q, k, v, bc, bp, relk)), sel, exp, interpret=True)
  bf = lambda a: _t(np.ascontiguousarray(a)).to(torch.bfloat16)
  nlc = lambda a: bf(a.transpose(1, 0, 2))
  out, w = tl2.attn_l2_plain(nlc(q), nlc(k), nlc(v), bf(bc), bf(bp), bf(relk),
                             heads=h)
  assert out.dtype == torch.bfloat16 and w.dtype == torch.float32
  back = lambda a: np.asarray(a.astype(jnp.float32)).transpose(1, 0, 2)
  return back(out_j), back(w_j), out.float().numpy(), w.numpy()


def test_attn_l2_plain_bf16_matches_pallas_kernel_op_by_op():
  """B5 in bfloat16, 2 heads, dqk = dv = 128, on inputs whose bf16 sums
  and differences are exact (``_attn_l2_bf16_case``): the plain version
  against ``attn_l2_lnc_pallas`` under ``jax.disable_jit()``. w within
  1e-5 (the f32 logit sums in other orders), out within one bf16 ulp
  (2^-7 relative and absolute: the f32 blend, rounded once)."""
  out_j, w_j, out, w = _attn_l2_bf16(_attn_l2_bf16_case(21, exact_relk=True))
  np.testing.assert_allclose(w, w_j, rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(out, out_j, rtol=2 ** -7, atol=2 ** -7)


def test_attn_l2_pallas_kernel_rounds_the_relk_difference_in_bf16():
  """Where relk's row differences are not exact in bf16, the Pallas body
  (``_kernel_lnc``: ``r0_ref[:] - r1_ref[:]`` on bf16 refs) rounds them
  to bf16, and its jnp reference (``attn_l2_lnc_reference``) and the
  port's plain version (and kernel) take them in f32: the body equals
  the plain arithmetic with that rounding added (w within 1e-5), the
  port equals the reference (w within 1e-6, out exactly). ROADMAP C
  records the difference for A19, which brings bf16 paths to the port."""
  case = _attn_l2_bf16_case(22, exact_relk=False)
  out_j, w_j, out, w = _attn_l2_bf16(case)
  (q, k, v, bc, bp, relk), h, dk, dv = case
  cast = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
  sel = jnp.asarray(jl2.head_selector(h, dk))
  exp = jnp.asarray(jl2.head_expander(h, dv))
  with jax.disable_jit():
    out_r, w_r = jl2.attn_l2_lnc_reference(
        *map(cast, (q, k, v, bc, bp, relk)), sel, exp)
  np.testing.assert_allclose(w, np.asarray(w_r).transpose(1, 0, 2), rtol=1e-6,
                             atol=1e-6)
  np.testing.assert_array_equal(
      out, np.asarray(out_r.astype(jnp.float32)).transpose(1, 0, 2))
  # the body's arithmetic: the relk difference rounded to bf16
  rb = _t(relk).to(torch.bfloat16)
  rd = torch.stack([rb[1] - rb[2], rb[0] - rb[1]]).float()    # by query
  qt = _t(q.transpose(1, 0, 2))
  diff = ((qt + _t(bc)) * _t(k[0] - k[1])[:, None]
          + (qt + _t(bp)) * rd[None])
  w_body = torch.sigmoid(diff.reshape(q.shape[1], 2, h, dk).sum(-1)).numpy()
  np.testing.assert_allclose(w_j, w_body, rtol=1e-5, atol=1e-5)
  assert np.abs(w - w_j).max() > 1e-4   # the difference is real


# shapes (N, heads, dqk, dv) of B5, each of which the port's kernel takes:
# the value net's widths at the guided decoders' N, at N = 6 (off JAX's
# tile over N) and at channels=1152 (dv 1152); 6 heads (groups of 4
# lanes, 8 lanes idle); dqk 4096; a head's dk 2 (under a 16-byte chunk:
# 8-byte loads in f32, 4-byte in bf16); a head's dv 4; 64 heads (two
# passes of a lane a head); and 128 heads of dk 1 (one element a load)
L2_SHAPES = {'value_512': (512, 8, 512, 1536),
             'value_5120': (5120, 8, 512, 1536),
             'n_not_8': (6, 8, 512, 1536),
             'channels_1152': (5120, 8, 512, 1152),
             'heads_6': (8, 6, 384, 384),
             'dqk_4096': (8, 8, 4096, 1536),
             'dk_2': (8, 8, 16, 1536),
             'dv_4': (8, 8, 512, 32),
             'heads_64': (8, 64, 8192, 8192),
             'heads_128': (8, 128, 128, 384)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', sorted(L2_SHAPES))
def test_attn_l2_kernel_takes_against_jax_gate(case, dtype, monkeypatch):
  """The port's B5 kernel takes every shape, so it takes every shape for
  which svdd_tpu's LNC dispatcher (``attn_l2_lnc`` with
  ``use_pallas=True``, its Pallas core replaced by a recorder) takes its
  kernel, and those JAX sends to its reference besides: off the CPU the
  port's wrapper sends each shape to the kernel (which on 'meta' tensors
  stops at its device check: no card here), none to the plain
  version."""
  n, h, dqk, dv = L2_SHAPES[case]
  pallas = []
  monkeypatch.setattr(jl2, '_lnc_core',
                      lambda q, *a: pallas.append(q.shape) or (q, q))
  z = lambda *s: jnp.zeros(s, jnp.float32)
  jl2.attn_l2_lnc(z(2, n, dqk), z(2, n, dqk), z(2, n, dv), z(dqk), z(dqk),
                  z(3, dqk), h, use_pallas=True)
  assert bool(pallas) is (dqk % 128 == 0 and dv % 128 == 0 and n % 8 == 0)
  plain = []
  monkeypatch.setattr(tl2, 'attn_l2_plain',
                      lambda q, *a: plain.append(tuple(q.shape)) or (q, q))
  m = lambda *s: torch.empty(s, device='meta', dtype=dtype)
  args = (m(n, 2, dqk), m(n, 2, dqk), m(n, 2, dv), m(dqk), m(dqk), m(3, dqk))
  with pytest.raises(ValueError, match='CUDA device'):
    tl2.attn_l2(*args, heads=h)
  assert plain == []


# ---------------------------------------------------------------------------
# autograd Functions on CPU tensors vs autograd through the plain ops
# ---------------------------------------------------------------------------


def _cnn_case(rs):
  n, l, c = 4, 24, 128
  return ((_normal(rs, (n, l, c)), _normal(rs, (n, c), 0.5),
           1 + _normal(rs, c, 0.1), _normal(rs, c, 0.1),
           _normal(rs, (9, c, c), 0.05), _normal(rs, c, 0.1)),
          lambda *a: tcnn.cnn_layer(*a, dilation=4),
          lambda *a: tcnn.cnn_layer_plain(*a, dilation=4))


def _conv_case(rs):
  return ((_normal(rs, (4, 12, 128)), _normal(rs, (5, 128, 256), 0.1),
           _normal(rs, 256, 0.1)),
          tconv.conv1d_shifted,
          lambda x, k, b: tconv._conv_forward(x, k, b, 1))


def _pool_fn_case(rs):
  return ((_normal(rs, (4, 9, 128)),
           (2 * np.eye(128) + _normal(rs, (128, 128), 0.1)).astype(
               np.float32), _normal(rs, (4, 9, 128))),
          tap.attn_pool, tap.attn_pool_plain)


def _attn_l2_case(rs):
  h = 2
  return ((_normal(rs, (4, 2, 128), 1 / 8), _normal(rs, (4, 2, 128)),
           _normal(rs, (4, 2, 128)), _normal(rs, 128), _normal(rs, 128),
           _normal(rs, (3, 128))),
          lambda *a: tl2.attn_l2(*a, heads=h),
          lambda *a: tl2.attn_l2_plain(*a, heads=h))


@pytest.mark.parametrize('case', [_cnn_case, _conv_case, _pool_fn_case,
                                  _attn_l2_case],
                         ids=['cnn_layer', 'conv1d', 'attn_pool', 'attn_l2'])
def test_autograd_function_matches_plain_autograd(case):
  inputs, fn, plain = case(np.random.default_rng(21))
  grads = []
  for f in (fn, plain):
    ts = [_t(a).requires_grad_(True) for a in inputs]
    out = f(*ts)
    out = out if isinstance(out, tuple) else (out,)
    cts = [_t(_normal(np.random.default_rng(22 + i), o.shape))
           for i, o in enumerate(out)]
    grads.append(torch.autograd.grad(out, ts, cts))
  for i, (g, w) in enumerate(zip(*grads)):
    tol = DX_TOL if g.shape == grads[0][0].shape else DW_TOL
    np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f'input {i}',
                               **tol)


# ---------------------------------------------------------------------------
# the value net's input gradient; the oracles on one-hots
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def value_pair():
  """A tiny Enformer value net (L=16 pools 16 -> 8 -> 4 -> 2, so its
  transformer runs at length 2) in both packages on the same weights."""
  jmodel = JaxEnformer(channels=256, n_conv=3, n_transformers=1, n_heads=2)
  variables = random_variables(jmodel.init, jnp.zeros((1, L, 4)),
                               rs=np.random.default_rng(30))
  return (lambda oh: jmodel.apply(variables, oh),
          enformer_value_from_jax(variables).eval())


def _jax_value_grad(jval, onehot):
  with unfused_guard():
    return np.asarray(jax.jit(jax.grad(lambda oh: jval(oh).mean()))(
        jnp.asarray(onehot)))


def test_value_net_input_gradient_matches_svdd_tpu(value_pair):
  """d mean(value) / d one-hot through the port's differentiable tower
  (the conv, pool and L=2 attention Functions) vs jax.grad under
  unfused_guard."""
  jval, tmodel = value_pair
  tokens = np.random.default_rng(31).integers(0, 5, (4, L))
  onehot = mdlm.transform_samples(torch.from_numpy(tokens))
  want = _jax_value_grad(jval, onehot.numpy())
  got = guidance.classifier_gradient(
      lambda oh: tmodel(oh, fused=False), torch.from_numpy(tokens))
  assert got.shape == (4, L, 5) and not got[..., 4].any()
  np.testing.assert_allclose(got[..., :4].numpy(), want, rtol=2e-4,
                             atol=2e-4 * np.abs(want).max())


def test_reward_oracles_differentiable_on_onehots():
  """The motif oracle's gradient equals jax.grad of the JAX oracle; the
  Enformer oracle's unfused form gives the gradient of its task-0
  output. The probabilities are peaked on sequences that carry
  the oracle's GCGC motif, so its relu'd window scores are not all 0."""
  rs = np.random.default_rng(32)
  tokens = rs.integers(0, 4, (4, 14))
  tokens[:, 3:7] = tokens[:, 9:13] = [2, 1, 2, 1]
  logits = 3 * np.eye(4, dtype=np.float32)[tokens] + _normal(rs, (4, 14, 4))
  probs = torch.softmax(_t(logits), -1)
  want = jax.grad(lambda p: jrewards.synthetic_motif_oracle(14)(p).sum())(
      jnp.asarray(probs.numpy()))
  p = probs.clone().requires_grad_(True)
  (got,) = torch.autograd.grad(
      rewards.synthetic_motif_oracle(14)(p).sum(), p)
  assert got.abs().max() > 0.01
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)
  oracle = rewards.RewardOracle.create_dna(
      torch.Generator().manual_seed(0), channels=256, n_conv=3,
      n_transformers=1, n_heads=2)
  p = probs.clone().requires_grad_(True)
  (got,) = torch.autograd.grad(oracle(p, fused=False).sum(), p)
  p2 = probs.clone().requires_grad_(True)
  (want,) = torch.autograd.grad(oracle.module(p2, False)[:, 0].sum(), p2)
  assert got.abs().max() > 0
  np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# guided steps pinned to svdd_tpu; decodes in distribution
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def denoisers():
  """A tiny JAX denoiser (L=16) and the port holding its weights,
  sharpened so p(x0|xt) is peaked, as test_torch_decode does."""
  cfg = jax_tiny_config('dna')
  cfg.model.length = L
  cfg.sampling.steps = STEPS
  variables = random_cnn_variables(cfg, np.random.default_rng(0))
  variables['params']['final_1']['kernel'] = (
      3.0 * variables['params']['final_1']['kernel'])
  tcfg = tiny_test_config('dna')
  tcfg.model.length = L
  tcfg.sampling.steps = STEPS
  return (JaxDiffusion(cfg, variables=variables),
          Diffusion(tcfg, device='cpu', backbone=cnn_from_jax(variables)))


def _partly_masked(seed, b=8):
  rs = np.random.default_rng(seed)
  return np.where(rs.random((b, L)) < 0.6, 4,
                  rs.integers(0, 4, (b, L))).astype(np.int32)


def _jax_dps_gradient(jdiff, jreward, x, sigma):
  """jax.grad of guidance.py:375-387's score_mean."""
  copy = (x != 4).astype(jnp.float32)[..., None]

  def score_mean(onehot):
    expected = jdiff.forward_onehot(jdiff.variables, onehot, x, sigma)
    expected = copy * onehot + (1 - copy) * expected
    return jreward(jax.nn.softmax(expected, axis=-1)[..., :4]).mean()

  return jax.jit(jax.grad(score_mean))(jax.nn.one_hot(x, 5))


def _pinned(jstep, tstep, x, t, t_next, seed):
  key = jax.random.key(seed)
  _, want = jax.jit(jstep)((), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (x.shape[0], L, 5), jnp.float32))
  with torch.no_grad():
    got = tstep(torch.from_numpy(x).long(), torch.tensor(t),
                torch.tensor(t_next), None, gumbel=torch.from_numpy(noise))
  return got.numpy(), np.asarray(want)


def test_dps_step_pinned_to_svdd_tpu(denoisers):
  """The DPS gradient through the denoiser's one-hot path and the
  softmax, then the step's draws exactly, given the JAX key's noise. A
  linear reward keeps the gradient off zero (the motif oracle's relu is
  0 on most soft inputs)."""
  jdiff, tdiff = denoisers
  w = _normal(np.random.default_rng(44), (L, 4))
  x = _partly_masked(40)
  t, t_next = np.float32(0.6), np.float32(0.55)
  sigma = np.full((8,), float(jdiff.schedule(jnp.asarray(t_next))[0]),
                  np.float32)
  want = np.asarray(_jax_dps_gradient(jdiff, _linear(w, jnp),
                                      jnp.asarray(x), jnp.asarray(sigma)))
  got = guidance.dps_gradient(tdiff.forward_onehot, _linear(w, torch),
                              torch.from_numpy(x).long(),
                              torch.from_numpy(sigma), 4).numpy()
  assert np.abs(want).max() > 1e-3
  np.testing.assert_allclose(got, want, rtol=2e-4,
                             atol=2e-4 * np.abs(want).max())
  scale = 1.0 / np.abs(want).max()     # guidance of order log q's spread
  got, want = _pinned(
      jguidance.dps_step(jdiff.denoise_onehot_fn(), _linear(w, jnp),
                         jdiff.schedule, 4, guidance_scale=scale),
      guidance.dps_step(tdiff.forward_onehot, _linear(w, torch),
                        tdiff.schedule, 4, guidance_scale=scale),
      x, t, t_next, 41)
  np.testing.assert_array_equal(got, want)


def test_classifier_step_pinned_to_svdd_tpu(denoisers, value_pair):
  """Classifier guidance through the tiny Enformer value net: the
  gradient, then the step's draws exactly."""
  jdiff, tdiff = denoisers
  jval, tmodel = value_pair
  x = _partly_masked(42)
  want = _jax_value_grad(jval, np.asarray(
      mdlm.transform_samples(torch.from_numpy(x))))
  tval = lambda oh: tmodel(oh, fused=False)
  got = guidance.classifier_gradient(tval, torch.from_numpy(x).long())
  np.testing.assert_allclose(got[..., :4].numpy(), want, rtol=2e-4,
                             atol=2e-4 * np.abs(want).max())
  # probability mass per lane of q_xs is about (mct - mcs): a scale that
  # makes the gradient term of that order tilts the draws
  scale = 0.05 / np.abs(want).max()
  got, want = _pinned(
      jguidance.classifier_step(jdiff.denoise_fn(), jval, jdiff.schedule,
                                4, guidance_scale=scale),
      guidance.classifier_step(tdiff.forward, tval, tdiff.schedule, 4,
                               guidance_scale=scale),
      x, np.float32(0.6), np.float32(0.55), 43)
  np.testing.assert_array_equal(got, want)


def _linear(w, lib):
  """A linear reward on (N, L, 4) one-hots or probabilities."""
  if lib is jnp:
    return lambda p: (p * jnp.asarray(w)).sum(axis=(-1, -2))
  return lambda p: (p * torch.from_numpy(w)).sum(dim=(-1, -2))


def _assert_distributions_agree(got, want, q_tol_scale: float = 0.35):
  """The rule of test_torch_decode: a two-sample KS test and q50/q80
  within 0.35 of the pooled standard deviation."""
  ks = sps.ks_2samp(got, want)
  scale = max(np.std(np.concatenate([got, want])), 1e-6)
  assert ks.pvalue > KS_PVAL, (ks.statistic, ks.pvalue)
  np.testing.assert_allclose(np.quantile(got, [0.5, 0.8]),
                             np.quantile(want, [0.5, 0.8]),
                             atol=q_tol_scale * scale)


@pytest.mark.parametrize('algo', ['dps', 'classifier'])
def test_guided_decode_matches_svdd_tpu_in_distribution(denoisers, algo):
  """256 rows, 8 steps, a linear reward on the one-hot: the port's decode
  against the JAX decode by the rewards of their samples, and the
  guidance lifts the reward over the port's unguided sampler."""
  jdiff, tdiff = denoisers
  w = _normal(np.random.default_rng(3), (L, 4))
  # guidance of order one per row: the gradients are means over B rows
  scale = {'dps': 100.0 * B, 'classifier': 0.1 * B}[algo]
  jsampler = getattr(jdiff, f'{algo}_sampler')
  tsampler = getattr(tdiff, f'{algo}_sampler')
  jtok = np.asarray(jsampler(_linear(w, jnp), B, guidance_scale=scale,
                             num_steps=STEPS)(jax.random.key(5)).samples)
  ttok = tsampler(_linear(w, torch), B, guidance_scale=scale,
                  num_steps=STEPS)(torch.Generator().manual_seed(5)
                                   ).samples.numpy()
  assert (jtok != 4).all() and (ttok != 4).all()
  reward = lambda tok: (np.eye(4)[tok] * w).sum(axis=(-1, -2))
  _assert_distributions_agree(reward(ttok), reward(jtok))
  base = tdiff.sampler(B, num_steps=STEPS)(
      torch.Generator().manual_seed(6)).samples.numpy()
  assert reward(ttok).mean() > reward(base).mean()


# ---------------------------------------------------------------------------
# the CLIs on the CPU; the default device
# ---------------------------------------------------------------------------


def _args(parser, tmp_path):
  return parser.parse_args(
      ['--device', 'cpu', '--batch_size', '4', '--num_steps', '3',
       '--skip_best_of_n', '--out_dir', str(tmp_path)])


@pytest.mark.parametrize('cli', ['DPS', 'DG', 'classfier'])
def test_guided_cli_writes_npz_on_cpu(tmp_path, cli):
  cfg = tiny_test_config('dna')
  if cli == 'classfier':
    args = _args(decode_classfier.parser(), tmp_path)
    decode_classfier.run(args, cfg=cfg, value_kwargs=dict(
        channels=256, n_conv=3, n_transformers=1, n_heads=2))
    name, algo, default = 'dna-HepG2-classfier', 'classifier', 1.0
  else:
    module = decode_DPS if cli == 'DPS' else decode_DG
    args = _args(module.parser(), tmp_path)
    decode_DPS.run(args, cfg=cfg)
    name, algo, default = 'dna-HepG2_DPS', 'dps', 1e5
  assert args.guidance_scale == default
  d = np.load(tmp_path / f'{name}.npz')
  assert set(d.files) == {'decoding', 'baseline'}
  assert d['decoding'].shape == d['baseline'].shape == (4,)
  row = json.loads((tmp_path / f'{name}.metrics.jsonl').read_text()
                   .splitlines()[-1])
  assert row['algo'] == algo and row['guidance_scale'] == default


def test_entry_points_default_to_the_card():
  """Without a device argument the decode bundle and the reverse loop
  run on the card, and raise where there is none: nothing falls back to
  the CPU."""
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default device works')
  with pytest.raises((RuntimeError, AssertionError)):
    Diffusion(tiny_test_config('dna'))
  sample = sampler.reverse_process(
      lambda x, *a: x, None, None, batch_size=2, length=4, mask_index=4,
      num_steps=1, noise_removal=False)
  with pytest.raises((RuntimeError, AssertionError)):
    sample(torch.Generator())
