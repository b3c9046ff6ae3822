"""svdd_tpu_torch's attention pool at widths off the 128-lane grid: the
plain versions of kernels B11a (the pool from given logits) and B11b (the
pool, the next block's BN affine, activation and im2col) vs the JAX
references, and an Enformer value net whose stem width is off the grid
vs svdd_tpu's module.

Inputs and weights are made with numpy from a seed and fed to both
packages. The JAX module takes its LNC pipeline (SVDD_TOWER_LNC=1, even
L), whose off-grid kernels fall back to their w-logits references, or
its NLC pipeline (SVDD_TOWER_LNC=0 or odd L), whose off-grid pool is the
legacy branch the port follows. Tolerances: 1e-5 in f32 for one op;
bf16 against the JAX references run op by op, one bf16 ulp (2^-7
relative covers values near a rounding boundary); whole models 1e-4 of
the largest value or gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.models.blocks import unfused_guard
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer
from svdd_tpu.ops import attn_pool_pallas as jap

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.ops import attn_pool as tap
from svdd_tpu_torch.ops.kernel_utils import with_plain_grad
from svdd_tpu_torch.sampling import guidance
from svdd_tpu_torch.weights import enformer_value_from_jax
from torch_port_helpers import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OP_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _t(a):
  return torch.from_numpy(np.array(a))


def _pool_case(l, c, seed):
  """x and logits (4, L, C), an odd L padded as the module pads it: a zero
  row of x, the lowest finite logit."""
  rs = np.random.default_rng(seed)
  x = rs.normal(size=(4, l, c)).astype(np.float32)
  logits = (2 * rs.normal(size=(4, l, c))).astype(np.float32)
  if l % 2:
    x = np.pad(x, ((0, 0), (0, 1), (0, 0)))
    logits = np.pad(logits, ((0, 0), (0, 1), (0, 0)),
                    constant_values=np.finfo(np.float32).min)
  return x, logits, rs


@pytest.mark.parametrize('l', [8, 7])
def test_attn_pool_plain_matches_reference(l):
  """B11a's plain version; at odd L the padded tail pair pools to exactly
  its first row."""
  x, logits, _ = _pool_case(l, 72, l)
  want = np.asarray(jap.attn_pool_reference(jnp.asarray(x),
                                            jnp.asarray(logits)))
  got = tap.attn_pool_fused(_t(x), _t(logits)).numpy()
  np.testing.assert_allclose(got, want, **OP_TOL)
  if l % 2:
    np.testing.assert_array_equal(got[:, -1], x[:, -2])


@pytest.mark.parametrize('l', [10, 9])
def test_pool_prologue_im2col_plain_matches_reference(l):
  """B11b's plain version, k=5 over the pooled length (3 live taps at a
  pooled length of 5)."""
  x, logits, rs = _pool_case(l, 72, l)
  scale = (1 + 0.2 * rs.normal(size=72)).astype(np.float32)
  shift = (0.2 * rs.normal(size=72)).astype(np.float32)
  want = np.asarray(jap.pool_prologue_im2col_reference(
      *map(jnp.asarray, (x, logits, scale, shift)), 5, 'gelu_enformer'))
  got = tap.pool_prologue_im2col(*map(_t, (x, logits, scale, shift)), 5,
                                 'gelu_enformer').numpy()
  np.testing.assert_allclose(got, want, **OP_TOL)


@pytest.mark.parametrize('l', [10, 9])
def test_offgrid_pool_plain_bf16_matches_reference(l):
  """bf16: the pooled value rounded to bf16 where attn_pool_reference
  rounds it, before the affine and the activation."""
  x, logits, rs = _pool_case(l, 72, 20 + l)
  scale = (1 + 0.2 * rs.normal(size=72)).astype(np.float32)
  shift = (0.2 * rs.normal(size=72)).astype(np.float32)
  xt, lt = (_t(a).to(torch.bfloat16) for a in (x, logits))
  xj, lj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
            for t in (xt, lt))
  with jax.disable_jit():
    want_pool = jap.attn_pool_reference(xj, lj)
    want_cols = jap.pool_prologue_im2col_reference(
        xj, lj, jnp.asarray(scale), jnp.asarray(shift), 5, 'gelu_enformer')
  got_pool = tap.attn_pool_reference(xt, lt)
  got_cols = tap.pool_prologue_im2col_reference(xt, lt, _t(scale), _t(shift),
                                                5, 'gelu_enformer')
  assert got_pool.dtype == got_cols.dtype == torch.bfloat16
  for got, want in ((got_pool, want_pool), (got_cols, want_cols)):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_plain_grad_function_matches_autograd():
  """The autograd Function the CUDA wrappers of B11a-c and B14 take: its
  backward differentiates the plain version, as the JAX custom VJPs do
  (here around the plain pool on both sides), or raises where there is
  none."""
  x, logits, _ = _pool_case(8, 40, 3)
  ct = torch.from_numpy(np.random.default_rng(4).normal(
      size=(4, 4, 40)).astype(np.float32))
  grads = []
  for wrap in (True, False):
    xt, lt = _t(x).requires_grad_(True), _t(logits).requires_grad_(True)
    out = (with_plain_grad(tap.attn_pool_reference, tap.attn_pool_reference,
                           xt, lt) if wrap
           else tap.attn_pool_reference(xt, lt))
    grads.append(torch.autograd.grad(out, (xt, lt), ct))
  for got, want in zip(*grads):
    np.testing.assert_allclose(got.numpy(), want.numpy(), **OP_TOL)
  # with no plain version (B14, whose Pallas kernel has no VJP) the
  # forward runs and a backward raises
  xt = _t(x).requires_grad_(True)
  out = with_plain_grad(lambda a: 2 * a, None, xt)
  np.testing.assert_array_equal(out.detach().numpy(), 2 * x)
  with pytest.raises(NotImplementedError, match='no backward'):
    out.sum().backward()


@pytest.fixture(scope='module', params=[32, 31], ids=['L32', 'L31'])
def offgrid_value_pair(request):
  """An Enformer value net with channels=384, n_conv 3, one transformer,
  2 heads: stem width 192 (off the grid), tower widths 192 -> 256 -> 384.
  (channels=192 would make no such net: the JAX module rounds its last
  width to 256 and fails.) L=31 pads the stem pool's odd tail."""
  l = request.param
  jmodel = JaxEnformer(channels=384, n_conv=3, n_transformers=1, n_heads=2)
  rs = np.random.default_rng(40 + l)
  variables = random_variables(jmodel.init, jnp.zeros((1, l, 4)), rs=rs)
  tokens = rs.integers(0, 5, (4, l))
  return jmodel, variables, enformer_value_from_jax(variables), tokens


@pytest.mark.parametrize('lnc', ['1', '0'])
def test_offgrid_value_net_matches_svdd_tpu(offgrid_value_pair, lnc,
                                            monkeypatch):
  """The fused eval forward (the stem pool handed to conv_1's B11b) and
  the differentiable tower (the stem pool through B11a), on the JAX
  module's weights, against its forward and its input gradient under
  unfused_guard, with SVDD_TOWER_LNC at 1 and 0."""
  monkeypatch.setenv('SVDD_TOWER_LNC', lnc)
  jmodel, variables, model, tokens = offgrid_value_pair
  onehot = mdlm.transform_samples(torch.from_numpy(tokens))
  oh = jnp.asarray(onehot.numpy())
  want = np.asarray(jax.jit(jmodel.apply)(variables, oh))
  with torch.no_grad():
    got = model(onehot).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-4,
                             atol=1e-4 * np.abs(want).max())
  with unfused_guard():
    want_g = np.asarray(jax.jit(jax.grad(
        lambda o: jmodel.apply(variables, o).mean()))(oh))
  got_g = guidance.classifier_gradient(lambda o: model(o, fused=False),
                                       torch.from_numpy(tokens))
  np.testing.assert_allclose(got_g[..., :4].numpy(), want_g, rtol=1e-4,
                             atol=1e-4 * np.abs(want_g).max())
