"""The bf16 compute switches (SVDD_CNN_BF16, SVDD_VALUE_BF16) in
svdd_tpu_torch vs svdd_tpu, and the bf16 roundings in which the port
follows JAX's dispatch: the w-logits pool's two forms, B5's relk
difference, LayerNorm's and BatchNorm's apply order, the tower's deferred
biases.

JAX runs op by op (``jax.disable_jit()``): compiled, XLA fuses bf16
chains and skips roundings its ops make one at a time. XLA's CPU bf16
logistic rounds its exp, sum and reciprocal to bf16 (up to two bf16 ulps
from the f32 sigmoid rounded once, which a TPU's f32 vector unit and the
port compute), so the model tests patch ``jax.nn.sigmoid`` to that f32
form. Where JAX's dispatcher takes a Pallas body (on its gate, with
Pallas on as on a TPU), the test runs it in interpret mode.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import build_backbone as jax_build_backbone
from svdd_tpu.models import blocks as jblocks
from svdd_tpu.models.cnn import CNNModel as JaxCNN
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer
from svdd_tpu.ops import attn_l2_pallas as jl2
from svdd_tpu.ops import attn_pool_pallas as jap
from svdd_tpu.value import build_value_module as jax_build_value_module

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.cli import decode as cli_decode
from svdd_tpu_torch.cli import decode_classfier, decode_DG, decode_DPS
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import build_backbone
from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.ops import attn_l2 as tl2
from svdd_tpu_torch.ops import attn_pool as tap
from svdd_tpu_torch.ops import fused_sample as tfs
from svdd_tpu_torch.ops.kernel_utils import live_offsets
from svdd_tpu_torch.value import build_value_module
from svdd_tpu_torch.weights import cnn_from_jax, enformer_value_from_jax
from torch_port_helpers import (few_torch_threads,  # noqa: F401
                                random_variables)

BF16_SWITCHES = ('SVDD_CNN_BF16', 'SVDD_VALUE_BF16')
TINY_VALUE = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _bf(a):
  """float32 values rounded to bf16, as (torch bf16, jax bf16)."""
  t = _t(np.asarray(a, np.float32)).to(torch.bfloat16)
  return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(a):
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture
def f32_sigmoid(monkeypatch):
  """jax.nn.sigmoid of bf16 computed in f32 and rounded once."""
  sig = jax.nn.sigmoid
  monkeypatch.setattr(jax.nn, 'sigmoid',
                      lambda x: sig(x.astype(jnp.float32)).astype(x.dtype))


# ---------------------------------------------------------------------------
# the models in bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('onehot', [False, True])
def test_cnn_bf16_matches_svdd_tpu_op_by_op(onehot):
  """The bf16 CNN denoiser on the JAX module's weights, from tokens and
  from a one-hot (DPS's input): the one-hot, time embedding, stem, bias
  rows, layers and final convs round where the JAX module's ops do
  (Dense and Conv1D round the product, then add the bias in bf16), and
  the logits return in f32. Within 2^-8 of the largest logit: the f32
  sums of a product in other orders can round one bf16 ulp apart."""
  cfg = jax_tiny_config('dna')
  jm = JaxCNN(config=cfg, alphabet_size=cfg.vocab_size,
              compute_dtype=jnp.bfloat16)
  rs = np.random.default_rng(11)
  x = rs.integers(0, 5, (4, cfg.model.length)).astype(np.int32)
  sigma = rs.uniform(0, 2, 4).astype(np.float32)
  variables = random_variables(jm.init, jnp.asarray(x), jnp.asarray(sigma),
                               rs=rs)
  oh = np.eye(cfg.vocab_size, dtype=np.float32)[x]
  with jax.disable_jit():
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(sigma),
                               x_onehot=jnp.asarray(oh) if onehot else None))
  model = cnn_from_jax(variables, torch.bfloat16)
  with torch.no_grad():
    got = model(_t(x).long(), _t(sigma),
                x_onehot=_t(oh) if onehot else None)
  assert got.dtype == torch.float32
  assert {p.dtype for p in model.parameters()} == {torch.float32}
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=2 ** -8 * np.abs(want).max())


# (batch N, input length L, JAX's Pallas pools and B5 on): 16 -> 8 -> 4 ->
# 2 in the L-major tower, N % 8 != 0 (JAX's references everywhere, as on
# its CPU), then N = 8 on the gate in the L-major tower and, at an odd
# input length, in the (N, L, C) one (15 -> 8 -> 4 -> 2)
ENFORMER_CASES = {'off_gate': (6, 16, False), 'on_gate_lnc': (8, 16, True),
                  'on_gate_nlc': (8, 15, True)}


def _pallas_in_interpret_mode(monkeypatch):
  """JAX's pool and B5 dispatchers take their Pallas bodies on their
  gates (Pallas on, as on a TPU), run in interpret mode."""
  monkeypatch.setenv('SVDD_PALLAS_ATTN_POOL', '1')
  monkeypatch.setenv('SVDD_PALLAS_ATTN_L2', '1')
  for mod, name in ((jap, '_wl_lnc_core'), (jap, '_wl_mega_lnc_core'),
                    (jap, '_wl_core'), (jap, '_wl_res_core'),
                    (jap, '_wl_mega_core'), (jap, '_wl_mega_res_core'),
                    (jl2, '_lnc_core'), (jl2, '_fused_core')):
    core = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, _c=core: _c(*a[:-1], True))


@pytest.mark.parametrize('case', sorted(ENFORMER_CASES))
def test_enformer_bf16_matches_svdd_tpu_op_by_op(case, monkeypatch,
                                                 f32_sigmoid):
  """The bf16 Enformer value net (channels 256, 3 tower blocks, the L=2
  attention) on the JAX module's weights: the deferred biases of the
  JAX tower, the pool's and B5's rounding as JAX's dispatch takes them,
  LayerNorm's bf16 apply, the value in f32. Off the gate (N = 6) both
  take the references: within 2^-8 of the largest value (a product's
  f32 sum in another order can round one ulp apart). On it, JAX's Pallas
  bodies in interpret mode: within 2^-6, since interpret mode skips the
  bf16 rounding of the residual sum the body makes on a TPU (ROADMAP,
  Numerics). The port's pools take the reference form exactly off the
  gate."""
  n, length, pallas = ENFORMER_CASES[case]
  if pallas:
    _pallas_in_interpret_mode(monkeypatch)
  jm = JaxEnformer(channels=256, n_conv=3, n_transformers=1, n_heads=2,
                   compute_dtype=jnp.bfloat16)
  rs = np.random.default_rng(30 + length)
  onehot = mdlm.transform_samples(_t(rs.integers(0, 5, (n, length))))
  variables = random_variables(jm.init, jnp.zeros((1, length, 4)), rs=rs)
  with jax.disable_jit():
    want = np.asarray(jm.apply(variables, jnp.asarray(onehot.numpy())))
  refs = []
  ref = tap.attn_pool_wlogits_reference
  monkeypatch.setattr(tap, 'attn_pool_wlogits_reference',
                      lambda x, *a: refs.append(x.shape) or ref(x, *a))
  model = enformer_value_from_jax(variables, torch.bfloat16)
  with torch.no_grad():
    got = model(onehot).numpy()
  assert got.shape == want.shape == (n,)
  assert len(refs) == (0 if pallas else 3)
  tol = 2 ** -6 if pallas else 2 ** -8
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=tol * np.abs(want).max())


# the off-grid tower: channels 384, stem width 192 (off the 128-lane grid),
# N = 6; an even input length takes the L-major tower, an odd one the
# (N, L, C) one, in both packages
OFFGRID_LENGTHS = (16, 15)


def _offgrid_enformer(length, jdtype, seed=50):
  jm = JaxEnformer(channels=384, n_conv=3, n_transformers=1, n_heads=2,
                   compute_dtype=jdtype)
  rs = np.random.default_rng(seed + length)
  onehot = mdlm.transform_samples(_t(rs.integers(0, 5, (6, length))))
  variables = random_variables(jm.init, jnp.zeros((1, length, 4)), rs=rs)
  return jm, variables, onehot


def _stem_handoff(model, onehot):
  """The port's value on onehot and the type of the stem pool's handoff."""
  seen = []
  hook = model.trunk.tower.stem_block.register_forward_hook(
      lambda m, i, out: seen.append(type(out).__name__))
  with torch.no_grad():
    got = model(onehot)
  hook.remove()
  return got, seen[0]


@pytest.mark.parametrize('length', OFFGRID_LENGTHS)
def test_offgrid_enformer_bf16_matches_svdd_tpu_op_by_op(length, monkeypatch,
                                                        f32_sigmoid):
  """The bf16 Enformer with its stem pool off the grid, JAX run op by op
  with its dispatchers as on a TPU (Pallas bodies on their gates, in
  interpret mode). At an even length JAX's L-major tower takes its
  ``lnc`` branch at every width, whose dispatchers fall back to the
  w-logits references off the gate: s = x + residual, the logits and the
  pool rounded, the deferred bias folded into the next norm's shift. The
  port's pool hands on a ``PoolHandoff`` there; at an odd length both
  take the legacy branch (``LogitsHandoff``). Within 2^-8 of the
  largest value at both."""
  _pallas_in_interpret_mode(monkeypatch)
  jm, variables, onehot = _offgrid_enformer(length, jnp.bfloat16)
  with jax.disable_jit():
    want = np.asarray(jm.apply(variables, jnp.asarray(onehot.numpy())))
  got, handoff = _stem_handoff(enformer_value_from_jax(variables,
                                                       torch.bfloat16),
                               onehot)
  assert handoff == ('PoolHandoff' if length % 2 == 0 else 'LogitsHandoff')
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=2 ** -8 * np.abs(want).max())


def test_offgrid_enformer_f32_keeps_the_legacy_branch(monkeypatch):
  """In float32 the off-grid pool of the L-major tower stays on the
  legacy branch (a ``LogitsHandoff`` to kernel B11b's plain version),
  bit for bit what the tower computes with ``lnc`` off for every pool,
  and within 1e-5 of the JAX module's largest value."""
  jm, variables, onehot = _offgrid_enformer(16, jnp.float32)
  want = np.asarray(jax.jit(jm.apply)(variables,
                                      jnp.asarray(onehot.numpy())))
  model = enformer_value_from_jax(variables, torch.float32)
  got, handoff = _stem_handoff(model, onehot)
  assert handoff == 'LogitsHandoff'
  fwd = blocks.AttentionPool.forward
  monkeypatch.setattr(blocks.AttentionPool, 'forward',
                      lambda self, *a, **k: fwd(self, *a, **dict(k, lnc=False)))
  legacy, _ = _stem_handoff(model, onehot)
  assert torch.equal(got, legacy)
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the bf16 faults: the gates and the norms (the pool's and B5's smallest
# inputs are in tests/test_torch_pool.py and tests/test_torch_grad.py)
# ---------------------------------------------------------------------------


# (N, L, C): the tower's widths, N off 8, C off the grid, and inputs past
# the 60 MiB VMEM plan of JAX's tile pickers (an L-major tile of 8 rows,
# an (N, L, C) tile of 1)
POOL_GATE_CASES = {'tower_stem': (8, 200, 768), 'tower_last': (5120, 4, 1536),
                   'n_not_8': (6, 8, 128), 'odd_l': (8, 7, 384),
                   'c_off_grid': (8, 8, 192), 'vmem_lnc': (8, 512, 1536),
                   'vmem_nlc': (1, 4096, 2048)}


@pytest.mark.parametrize('im2col', [False, True])
@pytest.mark.parametrize('lnc', [False, True])
@pytest.mark.parametrize('case', sorted(POOL_GATE_CASES))
def test_pool_rounding_gate_against_jax_dispatch(case, lnc, im2col,
                                                 monkeypatch):
  """``wlogits_body_takes`` is true exactly where svdd_tpu's w-logits
  dispatchers (L-major and (N, L, C), pool alone and fused with the
  im2col, ``use_pallas=True``, cores and references replaced by
  recorders) take their Pallas bodies; in bf16 the port's pool takes the
  reference form off it, in f32 never."""
  n, l, c = POOL_GATE_CASES[case]
  l_pad = l + l % 2
  taken = []
  rec = lambda kind: (lambda x, *a, **k: taken.append(kind) or x)
  names = (('_wl_lnc_core', '_wl_mega_lnc_core') if lnc else
           ('_wl_res_core', '_wl_mega_res_core'))
  for name in names:
    monkeypatch.setattr(jap, name, rec('body'))
  for name in ('attn_pool_wlogits_lnc_reference',
               'pool_prologue_im2col_wlogits_lnc_reference',
               'attn_pool_wlogits_reference',
               'pool_prologue_im2col_wlogits_reference'):
    monkeypatch.setattr(jap, name, rec('reference'))
  s = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.bfloat16)
  x = s(l_pad, n, c) if lnc else s(n, l_pad, c)
  w, v = s(c, c), s(c)
  if im2col:
    fn = (jap.pool_prologue_im2col_wlogits_lnc if lnc
          else jap.pool_prologue_im2col_wlogits)
    fn(x, w, v, v, 5, 'gelu_enformer', bool(l % 2), residual=x,
       use_pallas=True)
  else:
    fn = jap.attn_pool_wlogits_lnc if lnc else jap.attn_pool_wlogits
    fn(x, w, bool(l % 2), residual=x, use_pallas=True)
  k_live = len(live_offsets(5, l_pad // 2)) if im2col else 0
  body = tap.wlogits_body_takes(n, l, c, lnc=lnc, k_live=k_live,
                                has_res=True)
  assert taken == ['body' if body else 'reference']
  m = lambda dt: torch.empty((n, l, c), device='meta', dtype=dt)
  assert tap.pool_rounds_as_reference(m(torch.bfloat16), lnc=lnc,
                                      k_live=k_live, has_res=True) is not body
  assert not tap.pool_rounds_as_reference(m(torch.float32), lnc=lnc,
                                          k_live=k_live, has_res=True)


def test_attn_l2_bf16_backward_differentiates_the_reference(monkeypatch):
  """On the gate B5's forward rounds as the Pallas body, but its
  backward differentiates the reference, as JAX's ``_lnc_bwd`` does: the
  port's input gradients in bf16 against ``jax.vjp`` through the
  dispatcher (Pallas on, interpret mode), within 2^-6 of each largest
  gradient (bf16 cotangents summed in f32 in other orders)."""
  _pallas_in_interpret_mode(monkeypatch)
  rs = np.random.default_rng(23)
  h, dk, dv = 2, 64, 64
  bf = lambda shape, s=1.0: _bf(s * rs.normal(size=shape))
  grid = lambda shape, top: _bf(2 ** -6 * rs.integers(-top, top + 1,
                                                      size=shape))
  ins = [grid((8, 2, h * dk), 32), bf((8, 2, h * dk)), bf((8, 2, h * dv)),
         grid(h * dk, 64), grid(h * dk, 64), bf((3, h * dk))]
  ct, ctj = bf((8, 2, h * dv))
  lnc = lambda a: jnp.transpose(a, (1, 0, 2)) if a.ndim == 3 else a
  with jax.disable_jit():
    _, vjp = jax.vjp(lambda *a: jl2.attn_l2_lnc(*a, heads=h)[0],
                     *[lnc(j) for _, j in ins])
    want = vjp(lnc(ctj))
  tins = [t.clone().requires_grad_(True) for t, _ in ins]
  out, _ = tl2.attn_l2(*tins, heads=h)
  grads = torch.autograd.grad(out, tins, ct)
  for got, wj in zip(grads, want):
    wnp = _f32(lnc(wj))
    np.testing.assert_allclose(got.float().numpy(), wnp, rtol=0,
                               atol=2 ** -6 * np.abs(wnp).max())


def test_layernorm_bf16_matches_fast_layernorm():
  """LayerNorm's fault at its smallest input, one row of 8 channels in
  bf16: statistics in f32, then mean, rstd, scale and bias cast to bf16
  and the apply in bf16, as ``FastLayerNorm``; bit for bit. In f32 the
  port's LayerNorm is ``F.layer_norm`` as before."""
  rs = np.random.default_rng(5)
  x, xj = _bf(rs.normal(size=(1, 8)) * 3 + 1)
  scale = (1 + 0.3 * rs.normal(size=8)).astype(np.float32)
  bias = (0.3 * rs.normal(size=8)).astype(np.float32)
  jln = jblocks.FastLayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
  with jax.disable_jit():
    want = jln.apply({'params': {'scale': scale, 'bias': bias}}, xj)
  ln = blocks.LayerNorm(8)
  with torch.no_grad():
    ln.scale.copy_(_t(scale))
    ln.bias.copy_(_t(bias))
    got = ln(x)
    f32 = ln(x.float())
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.float().numpy(), _f32(want))
  assert torch.equal(f32, torch.nn.functional.layer_norm(
      x.float(), (8,), ln.scale, ln.bias, 1e-5))


def test_batchnorm_bf16_matches_flax():
  """Eval BatchNorm in bf16 as flax's ``nn.BatchNorm(dtype=bf16)``
  applies it, (x - mean) * (rstd * scale) + bias in f32 rounded once,
  bit for bit; and the NACDR probe's scale and shift from f32 zeros and
  ones, as the JAX fast path takes them in a bf16 tower."""
  rs = np.random.default_rng(6)
  c = 16
  x, xj = _bf(rs.normal(size=(2, 3, c)))
  p = {'scale': (1 + 0.3 * rs.normal(size=c)).astype(np.float32),
       'bias': (0.3 * rs.normal(size=c)).astype(np.float32)}
  st = {'mean': (0.3 * rs.normal(size=c)).astype(np.float32),
        'var': rs.uniform(0.5, 1.5, c).astype(np.float32)}
  jbn = jblocks.Norm('batch')
  v = {'params': {'BatchNorm_0': p}, 'batch_stats': {'BatchNorm_0': st}}
  probe = jnp.concatenate([jnp.zeros((1, 1, c)), jnp.ones((1, 1, c))], 1)
  with jax.disable_jit():
    want = jbn.apply(v, xj)
    pj = _f32(jbn.apply(v, probe))
  bn = blocks.BatchNorm(c)
  with torch.no_grad():
    for name, val in {**p, **st}.items():
      getattr(bn, name).copy_(_t(val))
    got = bn(x)
    scale, shift = bn.probe_affine(torch.bfloat16)
  np.testing.assert_array_equal(got.float().numpy(), _f32(want))
  np.testing.assert_allclose(shift.numpy(), pj[0, 0], rtol=1e-7, atol=1e-7)
  np.testing.assert_allclose(scale.numpy(), pj[0, 1] - pj[0, 0], rtol=1e-6,
                             atol=1e-6)


# ---------------------------------------------------------------------------
# the switches, the builders and the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('var', BF16_SWITCHES)
def test_bf16_switches_build_bf16_modules(var, monkeypatch):
  """SVDD_CNN_BF16=1 builds the CNN denoiser in bf16 and
  SVDD_VALUE_BF16=1 the Enformer value net (when no compute_dtype is
  given), as svdd_tpu's builders do; the parameters stay f32."""
  for other in BF16_SWITCHES:
    monkeypatch.delenv(other, raising=False)
  monkeypatch.setenv(var, '1')
  gen = torch.Generator().manual_seed(0)
  if var == 'SVDD_CNN_BF16':
    assert jax_build_backbone(jax_tiny_config('dna')).compute_dtype == \
        jnp.bfloat16
    model = build_backbone(tiny_test_config('dna'), gen)
    assert build_value_module('dna', generator=gen, **TINY_VALUE
                              ).compute_dtype == torch.float32
  else:
    assert jax_build_value_module('dna').compute_dtype == jnp.bfloat16
    model = build_value_module('dna', generator=gen, **TINY_VALUE)
    assert build_backbone(tiny_test_config('dna'), gen).compute_dtype == \
        torch.float32
  assert model.compute_dtype == torch.bfloat16
  assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize('cli', ['decode', 'DPS', 'DG', 'classfier'])
def test_cli_bf16_writes_npz_on_cpu(cli, monkeypatch, tmp_path):
  """Each decode CLI under both switches: the same npz keys as
  svdd_tpu's, finite rewards, and the nets' compute dtypes in the
  metrics row."""
  for var in BF16_SWITCHES:
    monkeypatch.setenv(var, '1')
  cfg = tiny_test_config('dna')
  cfg.sampling.steps = 3
  argv = ['--device', 'cpu', '--batch_size', '4', '--num_steps', '3',
          '--skip_best_of_n', '--out_dir', str(tmp_path)]
  if cli == 'decode':
    args = common.make_parser('test').parse_args(argv + ['--sample_M', '2'])
    cli_decode.run(args, cfg=cfg, value_kwargs=TINY_VALUE)
    name, value = 'dna-HepG2', True
  elif cli == 'classfier':
    args = decode_classfier.parser().parse_args(argv)
    decode_classfier.run(args, cfg=cfg, value_kwargs=TINY_VALUE)
    name, value = 'dna-HepG2-classfier', True
  else:
    args = (decode_DPS if cli == 'DPS' else decode_DG).parser().parse_args(
        argv)
    decode_DPS.run(args, cfg=cfg)
    name, value = 'dna-HepG2_DPS', False
  d = np.load(tmp_path / f'{name}.npz')
  assert set(d.files) == {'decoding', 'baseline'}
  assert d['decoding'].shape == d['baseline'].shape == (4,)
  assert np.isfinite(d['decoding']).all()
  row = json.loads((tmp_path / f'{name}.metrics.jsonl').read_text()
                   .splitlines()[-1])
  assert row['denoiser_dtype'] == 'bfloat16'
  assert row.get('value_dtype') == ('bfloat16' if value else None)


# ---------------------------------------------------------------------------
# B2's wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('bad', ['generator', 'mask_index', 'x_dtype'])
def test_gumbel_candidates_refuses_before_launch(bad):
  """Off the CPU B2's wrapper refuses a generator on another device, a
  mask index outside [0, V] and tokens that are not int32 or int64 with
  a ValueError naming them, before any launch (shown on 'meta' tensors:
  no card here)."""
  m = lambda *s, dt=torch.float32: torch.empty(s, device='meta', dtype=dt)
  gen = torch.Generator().manual_seed(0)
  log_q = m(2, 8, 5)
  x = m(2, 8, dt=torch.float32 if bad == 'x_dtype' else torch.int64)
  mask = 6 if bad == 'mask_index' else 4
  match = {'generator': 'generator is on cpu', 'mask_index': 'mask_index 6',
           'x_dtype': 'int32 or int64'}[bad]
  with pytest.raises(ValueError, match=match):
    tfs.gumbel_candidates(log_q, x, 3, mask, gen)
