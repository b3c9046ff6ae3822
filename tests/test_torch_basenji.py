"""svdd_tpu_torch's Basenji trunk and its NACDR conv kernels' plain
versions (B11c im2col, B14 fused conv) vs svdd_tpu.

Inputs and weights are made with numpy from a seed and fed to both
packages; every bias, norm and batch stat is drawn non-zero
(tests/torch_port_helpers.py). Where the JAX function reaches a Pallas
kernel it runs in interpret mode, as tests/test_ops.py and
tests/test_fused_conv.py run it. Tolerances, float32 with TF32 off:
1e-5 where both packages compute one op (the same products summed in
another order), 1e-4 for a conv's sums over k * Cin products and for
whole models. bfloat16 plain versions hold the JAX references (run op
by op) to one bf16 ulp (2^-8 relative, 2^-7 where an activation's f32
value sits near a rounding boundary).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.models import blocks as jblocks
from svdd_tpu.models.basenji import Basenji as JaxBasenji
from svdd_tpu.ops import fused_conv_pallas as jfc
from svdd_tpu.ops import im2col_pallas as jic

from svdd_tpu_torch import weights
from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.models.basenji import Basenji
from svdd_tpu_torch.ops import conv1d as tconv
from svdd_tpu_torch.ops import fused_conv as tfc
from svdd_tpu_torch.ops import im2col as tic
from torch_port_helpers import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OP_TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _t(a):
  return torch.from_numpy(np.array(a))


def _normal(rs, shape, scale=1.0):
  return (scale * rs.normal(size=shape)).astype(np.float32)


def _nacdr_inputs(n, l, c, seed):
  rs = np.random.default_rng(seed)
  return (_normal(rs, (n, l, c)), 1 + _normal(rs, c, 0.2),
          _normal(rs, c, 0.2), rs)


def _bf16(a):
  """float32 values rounded to bfloat16, in both packages' bf16 type."""
  t = _t(a).to(torch.bfloat16)
  return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(a):
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize('act', ['gelu', 'gelu_enformer', 'relu'])
@pytest.mark.parametrize('l,c', [(25, 108), (2, 36), (7, 3)])
def test_nacdr_im2col_plain_matches_reference(l, c, act):
  """B11c's plain version: widths off the 128-lane grid (the JAX
  dispatcher takes this reference there), a length shorter than the taps
  (only three live at L=2) and a width that is no multiple of 4."""
  x, scale, shift, _ = _nacdr_inputs(4, l, c, l + c)
  want = jic.nacdr_im2col_reference(*map(jnp.asarray, (x, scale, shift)), 5,
                                    act)
  got = tic.nacdr_im2col(_t(x), _t(scale), _t(shift), 5, act)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_nacdr_im2col_plain_matches_pallas_kernel():
  """B11c against the Pallas kernel in interpret mode (C = 128)."""
  x, scale, shift, _ = _nacdr_inputs(8, 16, 128, 0)
  want = jic.nacdr_im2col_pallas(*map(jnp.asarray, (x, scale, shift)), 5,
                                 'gelu', interpret=True)
  got = tic.nacdr_im2col_reference(_t(x), _t(scale), _t(shift), 5, 'gelu')
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_nacdr_im2col_plain_bf16_matches_reference():
  """bf16: the affine and the gelu in f32, rounded to bf16 once."""
  x, scale, shift, _ = _nacdr_inputs(4, 25, 108, 3)
  xt, xj = _bf16(x)
  with jax.disable_jit():
    want = jic.nacdr_im2col_reference(xj, jnp.asarray(scale),
                                      jnp.asarray(shift), 5, 'gelu')
  got = tic.nacdr_im2col_reference(xt, _t(scale), _t(shift), 5, 'gelu')
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16_TOL)


def _conv_case(n, l, cin, cout, seed, k=5):
  x, scale, shift, rs = _nacdr_inputs(n, l, cin, seed)
  w = _normal(rs, (k, cin, cout), 1 / np.sqrt(k * cin))
  b = _normal(rs, cout, 0.1)
  return x, w, b, scale, shift


@pytest.mark.parametrize('l,cin,cout', [(25, 324, 108), (25, 108, 324),
                                        (3, 40, 24)])
def test_nacdr_conv1d_and_fused_conv1d_match_reference(l, cin, cout):
  """The two routes of the NACDR conv, B11c plus one product
  (nacdr_conv1d) and B14's plain version, against the JAX reference both
  dispatchers fall back to, at Basenji's default widths."""
  x, w, b, scale, shift = _conv_case(4, l, cin, cout, l + cin)
  want = np.asarray(jfc.fused_conv1d_reference(
      *map(jnp.asarray, (x, w, b, scale, shift)), act='gelu'))
  args = tuple(map(_t, (x, w, b, scale, shift))) + ('gelu',)
  np.testing.assert_allclose(tic.nacdr_conv1d(*args).numpy(), want,
                             **CONV_TOL)
  np.testing.assert_allclose(tfc.fused_conv1d(*args).numpy(), want,
                             **CONV_TOL)


@pytest.mark.parametrize('n,l,cin,cout,k', [(16, 25, 128, 256, 5),
                                            (8, 4, 128, 128, 3)])
def test_fused_conv1d_plain_matches_pallas_kernel(n, l, cin, cout, k):
  """B14's plain version against the Pallas kernel in interpret mode, as
  tests/test_fused_conv.py holds it (the kernel adds the bias to its f32
  sum; in f32 that changes nothing beyond the summation order)."""
  x, w, b, scale, shift = _conv_case(n, l, cin, cout, n + l, k)
  want = jfc.fused_conv1d_pallas(*map(jnp.asarray, (x, w, b, scale, shift)),
                                 act='gelu', interpret=True)
  got = tfc.fused_conv1d_reference(*map(_t, (x, w, b, scale, shift)), 'gelu')
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def test_fused_conv1d_plain_bf16_matches_reference():
  """bf16: the plain version rounds where the jnp reference rounds (the
  activated input, the conv output, then the bias added in bf16)."""
  x, w, b, scale, shift = _conv_case(4, 25, 108, 64, 5)
  (xt, xj), (wt, wj), (bt, bj) = _bf16(x), _bf16(w), _bf16(b)
  with jax.disable_jit():
    want = jfc.fused_conv1d_reference(xj, wj, bj, jnp.asarray(scale),
                                      jnp.asarray(shift), act='gelu')
  got = tfc.fused_conv1d_reference(xt, wt, bt, _t(scale), _t(shift), 'gelu')
  np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16_TOL)


# (N, L, Cin, Cout, K) around B14's gate: on the 128-lane grid, then one
# term of JAX's gate broken at a time (Basenji's default residual width
# 108 on either side, N % 8 != 0, an even K)
GATE_CASES = {'on_grid': (8, 4, 128, 256, 5), 'cin_off_grid': (8, 4, 108, 128, 5),
              'cout_off_grid': (8, 4, 128, 108, 5), 'n_not_8': (6, 4, 128, 128, 5),
              'even_k': (8, 4, 128, 128, 4)}


@pytest.mark.parametrize('case', sorted(GATE_CASES))
def test_fused_conv_kernel_takes_matches_jax_gate(case, monkeypatch):
  """B14's dispatch follows svdd_tpu's ``fused_conv1d`` gate: the port's
  ``fused_conv_kernel_takes`` agrees with the branch the JAX dispatcher
  takes with ``use_pallas=True`` (its Pallas call replaced by a recorder),
  and off the CPU the port's ``fused_conv1d`` sends exactly those shapes
  to the kernel wrapper (which on 'meta' tensors stops at its device
  check: no card here) and every other shape to the plain version."""
  n, l, cin, cout, k = GATE_CASES[case]
  pallas = []
  monkeypatch.setattr(jfc, 'fused_conv1d_pallas',
                      lambda x, *a, **kw: pallas.append(x.shape) or x)
  z = lambda *s: jnp.zeros(s, jnp.float32)
  jfc.fused_conv1d(z(n, l, cin), z(k, cin, cout), z(cout), z(cin), z(cin),
                   act='gelu', use_pallas=True)
  takes = tfc.fused_conv_kernel_takes(n, k, cin, cout)
  assert takes is (pallas == [(n, l, cin)])
  plain = []
  monkeypatch.setattr(tfc, 'fused_conv1d_reference',
                      lambda x, *a: plain.append(tuple(x.shape)) or x)
  m = lambda *s: torch.empty(s, device='meta')
  args = (m(n, l, cin), m(k, cin, cout), m(cout), m(cin), m(cin), 'gelu')
  if takes:
    with pytest.raises(ValueError, match='CUDA device'):
      tfc.fused_conv1d(*args)
    assert plain == []
  else:
    tfc.fused_conv1d(*args)
    assert plain == [(n, l, cin)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['start', 'off_grid', 'aligned'])
def test_fused_conv_wrapper_needs_16_byte_rows(case, dtype):
  """B14's kernel copies rows of x in 16-byte chunks into shared memory,
  so its wrapper refuses, before any launch, an x that starts off a
  16-byte boundary, and a shape off the 128-lane grid (rows that are not
  whole chunks, which ``fused_conv1d`` never sends it); an aligned
  on-grid x reaches the device check. Shown on 'meta' tensors (no card
  here)."""
  c = 108 if case == 'off_grid' else 128
  m = lambda *s: torch.empty(s, device='meta', dtype=dtype)
  x = m(8, 4, c)
  if case == 'start':
    x = m(8 * 4 * c + 1)[1:].view(8, 4, c)
    assert x.data_ptr() % 16
  match = {'start': 'start 16-byte aligned', 'off_grid':
           'fail fused_conv_kernel_takes', 'aligned': 'CUDA device'}[case]
  f = lambda *s: torch.empty(s, device='meta')
  with pytest.raises(ValueError, match=match):
    tfc._fused_conv1d_kernel(x, m(5, c, 128), m(128), f(c), f(c), 'gelu')


def _port_block(jblock, variables, x):
  """The port's ConvBlock with the JAX block's fields and variables."""
  block = blocks.ConvBlock(
      jblock.in_channels, jblock.out_channels, jblock.kernel_size,
      torch.Generator().manual_seed(0), dilation=jblock.dilation,
      act_func=jblock.act_func, pool_func=jblock.pool_func,
      pool_size=jblock.pool_size, norm=jblock.norm,
      residual=jblock.residual, order=jblock.order).eval()
  weights._conv_block(block, variables['params'], variables['batch_stats'])
  with torch.no_grad():
    return block(_t(x)).numpy()


@pytest.mark.parametrize('order,dilation,pool,residual,cin,cout', [
    ('CDNRA', 1, 'max', True, 24, 36),    # Basenji's tower blocks
    ('CDNRA', 2, None, False, 24, 24),
    ('NACDR', 2, None, False, 36, 12),    # a dilated residual-tower conv
    ('NACDR', 1, None, True, 12, 36),     # the NACDR fast path
    ('NACDR', 1, 'avg', False, 36, 36),
])
def test_conv_block_matches_svdd_tpu(order, dilation, pool, residual, cin,
                                     cout):
  """The general ConvBlock in eval: both op orders, dilation 2, max and
  average pooling, a residual through ChannelTransform; odd length 15."""
  jblock = jblocks.ConvBlock(
      in_channels=cin, out_channels=cout, kernel_size=5, dilation=dilation,
      act_func='gelu', pool_func=pool, pool_size=2 if pool else None,
      residual=residual, order=order)
  rs = np.random.default_rng(cin + cout + dilation)
  x = _normal(rs, (4, 15, cin))
  variables = random_variables(jblock.init, jnp.zeros((1, 15, cin)), rs=rs)
  want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
  np.testing.assert_allclose(_port_block(jblock, variables, x), want,
                             **CONV_TOL)


BASENJI_CONFIGS = {
    # the published defaults' shape cut to size: widths 16, 18, 20 (no
    # multiple of 128), residual 12, dilations 1, 1, 1, 2
    'default_shaped': dict(channel_init=16, residual_channels=12,
                           residual_blocks=4),
    # on the 128-lane grid, where the JAX package runs its kernels
    '128_lane': dict(channel_init=128, conv_channel_mult=1.0,
                     residual_channels=128, residual_blocks=2),
}


@pytest.fixture(scope='module', params=sorted(BASENJI_CONFIGS))
def basenji_pair(request):
  cfg = BASENJI_CONFIGS[request.param]
  jmodel = JaxBasenji(**cfg)
  rs = np.random.default_rng(len(request.param))
  x = np.eye(4, dtype=np.float32)[rs.integers(0, 4, (8, 32))]
  variables = random_variables(jmodel.init, jnp.zeros((1, 32, 4)), rs=rs)
  return jmodel, variables, weights.basenji_from_jax(variables, **cfg), x


@pytest.mark.parametrize('fused_conv', [False, True],
                         ids=['im2col', 'fused_conv'])
def test_basenji_matches_svdd_tpu(basenji_pair, fused_conv, monkeypatch):
  """The Basenji trunk on the JAX module's weights, with
  SVDD_PALLAS_FUSED_CONV unset and set. Set, the JAX module runs the
  Pallas kernel where its gate holds (the 128-lane config), here in
  interpret mode; the port routes every dilation-1 NACDR conv to B14's
  wrapper, and unset to B11c's (counted on the CPU, where both take
  their plain versions)."""
  jmodel, variables, model, x = basenji_pair
  if fused_conv:
    monkeypatch.setenv('SVDD_PALLAS_FUSED_CONV', '1')
    monkeypatch.setattr(jfc, 'fused_conv1d_pallas', functools.partial(
        jfc.fused_conv1d_pallas, interpret=True))
  else:
    monkeypatch.delenv('SVDD_PALLAS_FUSED_CONV', raising=False)
  calls = {'fused_conv1d': 0, 'nacdr_conv1d': 0}

  def counted(name):
    fn = getattr(tconv, name)

    def wrapper(*a, **k):
      calls[name] += 1
      return fn(*a, **k)
    return wrapper
  for name in calls:
    monkeypatch.setattr(tconv, name, counted(name))
  want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
  with torch.no_grad():
    got = model(_t(x)).numpy()
  assert got.shape == (8,)
  np.testing.assert_allclose(got, want, rtol=1e-4,
                             atol=1e-4 * np.abs(want).max())
  n_fast = sum(1 for b in model.residual_blocks
               for blk in (b.conv_0, b.conv_1) if blk.dilation == 1)
  route = 'fused_conv1d' if fused_conv else 'nacdr_conv1d'
  assert calls == {route: n_fast,
                   ('nacdr_conv1d' if fused_conv else 'fused_conv1d'): 0}
