"""svdd_tpu_torch kernels' plain versions and core math vs svdd_tpu.

Inputs are made with numpy from a seed and fed to both packages. Where
the JAX function reaches a Pallas kernel it runs in interpret mode, as
tests/test_ops.py runs it. Tolerances are for float32 with TF32 off:
the two packages sum in different orders, so single ops agree to about
1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats as sps

from svdd_tpu import mdlm as jmdlm
from svdd_tpu import schedules as jschedules
from svdd_tpu.ops import attn_l2_pallas as jl2
from svdd_tpu.ops import attn_pool_pallas as jap
from svdd_tpu.ops import cnn_layer_pallas as jcnn
from svdd_tpu.ops import fused_sample as jfs

from svdd_tpu_torch import mdlm, schedules
from svdd_tpu_torch.ops import attn_l2 as tl2
from svdd_tpu_torch.ops import attn_pool as tap
from svdd_tpu_torch.ops import cnn_layer as tcnn
from svdd_tpu_torch.ops import fused_sample as tfs
from svdd_tpu_torch.ops.kernel_utils import live_offsets
from torch_port_helpers import few_torch_threads  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
  return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('dilation', [1, 4, 16, 64])
def test_cnn_layer_plain_matches_pallas_kernel(dilation):
  """B1 at L=24: dilations 16 and 64 leave only 3 and 1 live taps."""
  rs = np.random.default_rng(dilation)
  n, l, c = 8, 24, 32
  x = rs.normal(size=(n, l, c)).astype(np.float32)
  br = rs.normal(size=(n, c)).astype(np.float32)
  g = (1 + 0.1 * rs.normal(size=c)).astype(np.float32)
  b = (0.1 * rs.normal(size=c)).astype(np.float32)
  w = (rs.normal(size=(9, c, c)) / np.sqrt(9 * c)).astype(np.float32)
  cb = (0.1 * rs.normal(size=c)).astype(np.float32)
  want = jcnn.cnn_layer_pallas(*map(jnp.asarray, (x, br, g, b, w, cb)),
                               dilation=dilation, interpret=True)
  ref = jcnn.cnn_layer_reference(*map(jnp.asarray, (x, br, g, b, w, cb)),
                                 dilation=dilation)
  got = tcnn.cnn_layer(*map(_t, (x, br, g, b, w, cb)), dilation=dilation)
  assert len(live_offsets(9, l, dilation)) == {1: 9, 4: 9, 16: 3,
                                               64: 1}[dilation]
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('dtype,l,takes', [
    (torch.float32, 50, True), (torch.float32, 200, True),
    (torch.float32, 408, True), (torch.float32, 409, False),
    (torch.bfloat16, 50, True), (torch.bfloat16, 200, True),
    (torch.bfloat16, 672, True), (torch.bfloat16, 673, False)])
def test_cnn_layer_kernel_takes(dtype, l, takes):
  """B1/B6 take a sequence a block's shared memory holds (just below and
  above the limit; the f32 limit stays at least 400); a tensor off the
  CPU past it takes the plain versions, any other launches the kernels."""
  assert tcnn.kernel_takes(l, dtype) is takes
  assert tcnn.kernel_takes(400, torch.float32)
  x = torch.empty((2, l, 128), dtype=dtype, device='meta')
  assert tcnn._plain(x) is not takes
  assert tcnn._plain(torch.empty((2, l, 128), dtype=dtype))


@pytest.mark.parametrize('dilation', [1, 64])
def test_cnn_layer_long_sequence_matches_reference(dilation):
  """At L=512, past what a block holds, the port's layer and its plain
  backward against svdd_tpu's cnn_layer_reference and its VJP: 1e-5
  relative, and 1e-5 of the largest |value| absolute, since a weight
  gradient sums 1024 products per element in another order."""
  rs = np.random.default_rng(512 + dilation)
  n, l, c = 2, 512, 128
  args = (rs.normal(size=(n, l, c)), rs.normal(size=(n, c)),
          1 + 0.1 * rs.normal(size=c), 0.1 * rs.normal(size=c),
          rs.normal(size=(9, c, c)) / np.sqrt(9 * c), 0.1 * rs.normal(size=c))
  args = tuple(a.astype(np.float32) for a in args)
  ct = rs.normal(size=(n, l, c)).astype(np.float32)
  assert not tcnn.kernel_takes(l, torch.float32)
  ref = lambda *a: jcnn.cnn_layer_reference(*a, dilation=dilation)
  want, vjp = jax.vjp(ref, *map(jnp.asarray, args))
  got = tcnn.cnn_layer(*map(_t, args), dilation=dilation)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  grads = tcnn.cnn_layer_bwd_plain(*map(_t, args), _t(ct), dilation=dilation)
  names = ('dx', 'dbias_row', 'dln_scale', 'dln_bias', 'dkernel',
           'dconv_bias')
  for name, g, w in zip(names, grads, vjp(jnp.asarray(ct))):
    w = np.asarray(w)
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                               atol=1e-5 * np.abs(w).max(), err_msg=name)


def _pool_inputs(lh, residual, seed):
  """JAX LNC inputs (2*lh, N, C) and their port (N, L, C) form."""
  rs = np.random.default_rng(seed)
  n, c = 8, 128
  x = rs.normal(size=(2 * lh, n, c)).astype(np.float32)
  res = rs.normal(size=x.shape).astype(np.float32) if residual else None
  w = (0.2 * rs.normal(size=(c, c))).astype(np.float32)
  scale = (1 + rs.normal(size=c)).astype(np.float32)
  shift = rs.normal(size=c).astype(np.float32)
  return x, res, w, scale, shift


def _port_form(x, res, mask_tail):
  """mask_tail: the JAX input's last row is a zero pad; the port takes
  the odd length directly."""
  if mask_tail:
    x = x.copy()
    x[-1] = 0.0
    if res is not None:
      res = res.copy()
      res[-1] = 0.0
  l = x.shape[0] - (1 if mask_tail else 0)
  to_nlc = lambda a: None if a is None else _t(
      np.ascontiguousarray(a[:l].transpose(1, 0, 2)))
  return x, res, to_nlc(x), to_nlc(res)


@pytest.mark.parametrize('pad_out', [False, True])
@pytest.mark.parametrize('mask_tail', [False, True])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('lh', [2, 4])
def test_pool_prologue_im2col_plain_matches_pallas_kernel(
    lh, residual, mask_tail, pad_out):
  """B3, k=5: at pooled length 2 only offsets -1, 0, +1 are live."""
  x, res, w, scale, shift = _pool_inputs(lh, residual, 10 * lh + 1)
  x, res, xp, rp = _port_form(x, res, mask_tail)
  want = np.asarray(jap.pool_prologue_im2col_wlogits_lnc_pallas(
      jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
      jnp.asarray(shift), 5, 'gelu_enformer', mask_tail,
      residual=None if res is None else jnp.asarray(res),
      pad_out=pad_out, interpret=True))
  got = tap.pool_prologue_im2col_wlogits(xp, _t(w), _t(scale), _t(shift),
                                         5, 'gelu_enformer', rp).numpy()
  assert got.shape == (8, lh, len(live_offsets(5, lh)) * 128)
  if pad_out:
    assert want.shape[0] == lh + 1 and not want[lh].any()
  np.testing.assert_allclose(got, want[:lh].transpose(1, 0, 2),
                             rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize('mask_tail', [False, True])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('lh', [2, 4])
def test_attn_pool_plain_matches_pallas_kernel(lh, residual, mask_tail):
  """B4, the pooled output alone."""
  x, res, w, _, _ = _pool_inputs(lh, residual, 10 * lh + 2)
  x, res, xp, rp = _port_form(x, res, mask_tail)
  want = np.asarray(jap.attn_pool_wlogits_lnc_pallas(
      jnp.asarray(x), jnp.asarray(w), mask_tail,
      residual=None if res is None else jnp.asarray(res),
      interpret=True))
  got = tap.attn_pool(xp, _t(w), rp).numpy()
  np.testing.assert_allclose(got, want.transpose(1, 0, 2),
                             rtol=3e-5, atol=3e-5)
  if mask_tail:   # the odd tail pools to its first row
    s = xp if rp is None else xp + rp
    np.testing.assert_array_equal(got[:, -1], s[:, -1].numpy())


def test_attn_l2_plain_matches_pallas_kernel():
  """B5 with 2 heads (dk 64, dv 64)."""
  rs = np.random.default_rng(5)
  n, h, dk, dv = 8, 2, 64, 64
  q = (rs.normal(size=(2, n, h * dk)) / 8).astype(np.float32)
  k = rs.normal(size=(2, n, h * dk)).astype(np.float32)
  v = rs.normal(size=(2, n, h * dv)).astype(np.float32)
  bc, bp = rs.normal(size=(2, h * dk)).astype(np.float32)
  relk = rs.normal(size=(3, h * dk)).astype(np.float32)
  sel = jnp.asarray(jl2.head_selector(h, dk))
  exp = jnp.asarray(jl2.head_expander(h, dv))
  out_j, w_j = jl2.attn_l2_lnc_pallas(
      *map(jnp.asarray, (q, k, v, bc, bp, relk)), sel, exp, interpret=True)
  nlc = lambda a: _t(np.ascontiguousarray(a.transpose(1, 0, 2)))
  out, w = tl2.attn_l2(nlc(q), nlc(k), nlc(v), _t(bc), _t(bp), _t(relk),
                       heads=h)
  np.testing.assert_allclose(out.numpy(),
                             np.asarray(out_j).transpose(1, 0, 2), **TOL)
  np.testing.assert_allclose(w.numpy(),
                             np.asarray(w_j).transpose(1, 0, 2), **TOL)


def _log_q(rs, b, l, v=5):
  logits = rs.normal(size=(b, l, v)).astype(np.float32)
  return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def test_gumbel_candidates_exact_given_noise():
  """B2's plain version == the JAX XLA branch (fused_sample.py:91-95)
  fed the same Gumbel noise."""
  rs = np.random.default_rng(0)
  b, m, l, mask = 4, 6, 16, 4
  log_q = _log_q(rs, b, l)
  x = np.where(rs.random((b, l)) < 0.5, mask,
               rs.integers(0, 4, (b, l))).astype(np.int32)
  key = jax.random.key(3)
  want = jfs.gumbel_candidates(key, jnp.asarray(log_q), jnp.asarray(x), m,
                               mask, use_pallas=False)
  noise = jax.random.gumbel(key, (b, m, l, 5), dtype=jnp.float32)
  got = tfs.gumbel_candidates(_t(log_q), _t(x).long(), m, mask, None,
                              gumbel=_t(noise))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_candidates_frequencies():
  """B2 with its own generator: draws follow softmax(log_q) (chi-square)
  and unmasked tokens are copied exactly."""
  rs = np.random.default_rng(1)
  b, l, m, mask = 2, 3, 4000, 4
  log_q = _log_q(rs, b, l)
  x = np.full((b, l), mask, np.int64)
  x[1, 2] = 3
  gen = torch.Generator().manual_seed(1)
  got = tfs.gumbel_candidates(_t(log_q), _t(x), m, mask, gen).numpy()
  assert (got[1, :, 2] == 3).all()
  p = np.exp(log_q.astype(np.float64))
  p /= p.sum(-1, keepdims=True)
  for bi, li in [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]:
    counts = np.bincount(got[bi, :, li], minlength=5)
    assert sps.chisquare(counts, m * p[bi, li]).pvalue > 1e-3


def test_gumbel_candidates_returns_the_noise_it_drew():
  """return_noise gives the noise behind each draw: the plain version on
  it reproduces the draws, as the card's kernel is checked."""
  rs = np.random.default_rng(4)
  b, l, m, mask = 3, 8, 5, 4
  log_q = _log_q(rs, b, l)
  x = np.where(rs.random((b, l)) < 0.5, mask,
               rs.integers(0, 4, (b, l))).astype(np.int64)
  got, noise = tfs.gumbel_candidates(_t(log_q), _t(x), m, mask,
                                     torch.Generator().manual_seed(2),
                                     return_noise=True)
  assert noise.shape == (b, m, l, 5)
  np.testing.assert_array_equal(
      got.numpy(),
      tfs.gumbel_candidates_plain(_t(log_q), _t(x), noise, mask).numpy())


def test_core_math_matches_svdd_tpu():
  """schedule, subs parameterization, log_q_xs, the one-hot transform
  and the ddpm move chances."""
  rs = np.random.default_rng(2)
  b, l, mask = 4, 12, 4
  logits = rs.normal(size=(b, l, 5)).astype(np.float32)
  x = np.where(rs.random((b, l)) < 0.5, mask,
               rs.integers(0, 4, (b, l))).astype(np.int64)
  jsched = jschedules.get_schedule('loglinear')
  tsched = schedules.get_schedule('loglinear')
  for t in (1.0, 0.5, 1e-5):
    for a, b_ in zip(jsched(jnp.float32(t)), tsched(t)):
      np.testing.assert_allclose(b_.numpy(), np.asarray(a), rtol=1e-6)
  want = jmdlm.subs_parameterization(jnp.asarray(logits), jnp.asarray(x),
                                     mask)
  got = mdlm.subs_parameterization(_t(logits), _t(x), mask)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
  lq_j = jmdlm.log_q_xs(want, 0.6, 0.4, mask)
  lq_t = mdlm.log_q_xs(got, torch.tensor(0.6), torch.tensor(0.4), mask)
  np.testing.assert_allclose(lq_t.numpy(), np.asarray(lq_j), **TOL)
  np.testing.assert_array_equal(
      mdlm.transform_samples(_t(x)).numpy(),
      np.asarray(jmdlm.transform_samples(jnp.asarray(x))))
  assert (mdlm.sample_prior((2, 3), mask) == mask).all()
