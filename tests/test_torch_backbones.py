"""svdd_tpu_torch's DiT, AR and DiMamba backbones and their kernels'
plain versions (B12 attention, B13 RMSNorm) vs svdd_tpu.

Inputs and weights are made with numpy from a seed and fed to both
packages. The Pallas kernels run in interpret mode, as tests/test_ops.py
runs them. Every layer flax zero-initialises (adaLN, the DiT's final
linear) is drawn non-zero here, so the attention and the norm reach the
outputs. Tolerances are stated per test.
"""

import math
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from svdd_tpu.config import Config as JaxConfig
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.models.autoregressive import ARModel as JaxAR
from svdd_tpu.models.dimamba import DiMamba as JaxDiMamba
from svdd_tpu.models.dit import DIT as JaxDIT
from svdd_tpu.ops import attention as jattn
from svdd_tpu.ops import flash_attention_pallas as jfap
from svdd_tpu.ops import norms as jnorms

from svdd_tpu_torch.config import Config, text_mdlm_config, tiny_test_config
from svdd_tpu_torch.ops import attention as tattn
from svdd_tpu_torch.ops import flash_attention as tfa
from svdd_tpu_torch.ops import norms as tnorms
from svdd_tpu_torch.weights import ar_from_jax, dimamba_from_jax, dit_from_jax
from torch_port_helpers import (few_torch_threads,  # noqa: F401
                                random_variables)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_CONFIGS = tuple(os.path.join(REPO, pkg, 'configs', 'text_mdlm.yaml')
                     for pkg in ('svdd_tpu', 'svdd_tpu_torch'))


def _t(a):
  return torch.from_numpy(np.array(a))


def _interpret(fn):
  """Run fn with every pallas_call in interpret mode."""
  orig = pl.pallas_call

  def interp_call(*args, **kwargs):
    kwargs['interpret'] = True
    return orig(*args, **kwargs)

  pl.pallas_call = interp_call
  try:
    return fn()
  finally:
    pl.pallas_call = orig


# ---------------------------------------------------------------------------
# B12 and B13: plain versions vs the Pallas kernels and the jnp references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_plain_matches_pallas_kernel(causal):
  """B12's plain version (``mha``) at (2, 128, 2, 64) f32: the same
  scores, maxima, sums and products in another order, so 1e-5."""
  rs = np.random.default_rng(int(causal))
  q, k, v = (rs.normal(size=(2, 128, 2, 64)).astype(np.float32)
             for _ in range(3))
  jfap.flash_attention._clear_cache()
  try:
    want = _interpret(lambda: jfap.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
  finally:
    jfap.flash_attention._clear_cache()
  got = tattn.flash_mha(_t(q), _t(k), _t(v), causal=causal)
  assert got.shape == (2, 128, 2, 64)
  np.testing.assert_allclose(got.numpy(), np.asarray(want),
                             rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('causal,shape,seed', [
    pytest.param(False, (2, 200, 3, 64), 2, id='False'),
    pytest.param(True, (2, 200, 3, 64), 3, id='True'),
    pytest.param(False, (1, 1024, 2, 64), 4, id='False-L1024'),
    pytest.param(True, (1, 1024, 2, 64), 5, id='True-L1024'),
    pytest.param(False, (1, 1024, 1, 128), 6, id='False-L1024-d128'),
    pytest.param(True, (1, 1024, 1, 128), 7, id='True-L1024-d128'),
])
def test_attention_plain_version_matches_mha(causal, shape, seed):
  """B12's plain version (``mha``, which the dispatcher takes on CPU
  tensors and the card's check holds the kernel to) against svdd_tpu's
  ``mha`` at each (L, D) the smoke times: L=200, a length the TPU kernel
  does not tile, and L=1024 at head dims 64 and 128; f32: 1e-5."""
  rs = np.random.default_rng(seed)
  q, k, v = (rs.normal(size=shape).astype(np.float32) for _ in range(3))
  want = np.asarray(jattn.mha(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal))
  for got in (tattn.mha(_t(q), _t(k), _t(v), causal),
              tattn.flash_mha(_t(q), _t(k), _t(v), causal)):
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('d', [16, 96])
def test_attention_dispatch_takes_mha_off_the_kernel_head_dims(d,
                                                               monkeypatch):
  """B12's dispatch on the head dim: D % 64 != 0 goes to the plain
  ``mha`` on any device, as svdd_tpu's ``flash_mha`` takes XLA's ``mha``
  there; D = 64 and 128 go to the kernel; a multiple of 64 the kernel is
  not built for (192) raises. The device branch is shown on 'meta'
  tensors (no card here); the values at D = 16 and 96 against svdd_tpu's
  dispatcher in f32: 1e-5."""
  launched = []
  monkeypatch.setattr(tattn.fa, 'flash_attention',
                      lambda q, k, v, causal: launched.append(q.shape[-1]))
  for dim in (d, 64, 128):
    q = torch.empty(1, 8, 2, dim, device='meta')
    tattn.flash_mha(q, q, q)
  assert launched == [64, 128]
  monkeypatch.undo()
  q = torch.empty(1, 8, 2, 192, device='meta')
  with pytest.raises(ValueError, match='head dim 192'):
    tattn.flash_mha(q, q, q)
  rs = np.random.default_rng(d)
  q, k, v = (rs.normal(size=(2, 24, 2, d)).astype(np.float32)
             for _ in range(3))
  want = np.asarray(jattn.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v)))
  got = tattn.flash_mha(_t(q), _t(k), _t(v))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['start', 'row_stride', 'head_stride',
                                  'qkv_slices'])
def test_flash_attention_wrapper_needs_16_byte_rows(case, dtype):
  """B12's kernel copies q, k and v rows in 16-byte chunks, so its
  wrapper refuses, before any launch, a view that starts off a 16-byte
  boundary or whose batch, position or head stride is no multiple of 16
  bytes. The DiT's fused-qkv slices (strides 3·H·D, offsets H·D) pass
  those checks and reach the device check. Shown on 'meta' tensors (no
  card here)."""
  chunk = 16 // torch.empty(0, dtype=dtype).element_size()
  shape, d = (2, 8, 2, 64), 64

  def strided(row, head):
    base = torch.empty(2 * 8 * row, device='meta', dtype=dtype)
    return base.as_strided(shape, (8 * row, row, head, 1))

  if case == 'start':
    base = torch.empty(2 * 8 * 2 * d + 1, device='meta', dtype=dtype)
    q = base[1:].view(shape)
    match = 'start 16-byte aligned'
  elif case == 'row_stride':
    q = strided(2 * d + chunk // 2, d)
    match = 'not multiples of 16 bytes'
  elif case == 'head_stride':
    q = strided(2 * (d + chunk // 2), d + chunk // 2)
    match = 'not multiples of 16 bytes'
  else:
    q = torch.empty(2, 8, 3, 2, d, device='meta', dtype=dtype).unbind(2)[1]
    assert q.data_ptr() % 16 == 0 and q.stride() == (3072, 384, 64, 1)
    match = 'CUDA device'
  with pytest.raises(ValueError, match=match):
    tfa.flash_attention(q, q, q)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('residual', [False, True])
def test_rmsnorm_plain_matches_pallas_kernel(dtype, residual):
  """B13 at (64, 256) rows (one block of the Pallas grid). f32: 1e-6
  against both. bf16: against ``_rmsnorm_ref`` run op by op, which
  rounds where the port rounds, one bf16 ulp (2^-8 relative: the f32
  mean of squares in another order may round rsqrt apart); against the
  Pallas kernel, which XLA compiles with fused bf16 ops that may keep
  the residual sum and the first product in f32, 2^-6 (up to two ulps
  of the rounding the port does and the compiled kernel skips)."""
  rs = np.random.default_rng(4 + int(residual))
  jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
  tdt = getattr(torch, dtype)
  x = rs.normal(size=(64, 256)).astype(np.float32)
  r = rs.normal(size=(64, 256)).astype(np.float32) if residual else None
  s = rs.uniform(0.5, 1.5, 256).astype(np.float32)
  jx, js = jnp.asarray(x, jdt), jnp.asarray(s, jdt)
  jr = None if r is None else jnp.asarray(r, jdt)
  kernel = _interpret(lambda: jnorms._rmsnorm_pallas(jx, jr, js))
  ref = jnorms._rmsnorm_ref(jx, jr, js)            # eager: op by op
  tx, ts = _t(x).to(tdt), _t(s).to(tdt)
  tr = None if r is None else _t(r).to(tdt)
  got = tnorms.fused_add_rmsnorm(tx, tr, ts)
  assert got.dtype == tdt
  f32 = dtype == 'float32'
  for want, tol in ((ref, 1e-6 if f32 else 2 ** -8),
                    (kernel, 1e-6 if f32 else 2 ** -6)):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the backbones on shared weights
# ---------------------------------------------------------------------------

L = 128
VOCAB = 28   # the text8 alphabet + MASK


def _configs(precision, **model):
  """The JAX and port configs of one tiny backbone."""
  jcfg = jax_tiny_config('dna')
  tcfg = tiny_test_config('dna')
  for cfg in (jcfg, tcfg):
    cfg.model.length = L
    for k, v in model.items():
      setattr(cfg.model, k, v)
    cfg.parallel.precision = precision
  return jcfg, tcfg


def _inputs(seed, vocab, b=2):
  rs = np.random.default_rng(seed)
  x = rs.integers(0, vocab, (b, L)).astype(np.int32)
  sigma = rs.uniform(0, 2, b).astype(np.float32)
  return rs, x, sigma


def _run_both(jmodel, convert, tcfg, tdt, x, sigma, rs):
  """The JAX model runs op by op (``disable_jit``): compiled, XLA fuses
  bf16 chains and may skip roundings (DiMamba's bf16 RMSNorm moved a
  logit by 0.043 so), where both packages run op by op round alike."""
  variables = random_variables(jmodel.init, jnp.asarray(x),
                               jnp.asarray(sigma), rs=rs)
  with jax.disable_jit():
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   jnp.asarray(sigma)))
  model = convert(variables, tcfg, tdt)
  with torch.no_grad():
    got = model(_t(x).long(), _t(sigma)).numpy()
  return got, want, model


# f32: every layer sums in another order in each package, ~1e-5 relative
# per layer. bf16: the embedding, c, the rotary tables and block 0's
# LayerNorm/RMSNorm output are rounded to bf16 at the same points in
# both; a value within f32 summation noise of a bf16 boundary can round
# one ulp (2^-8 relative) apart and move the logits by about 1e-3
TOL = {'fp32': dict(rtol=2e-4, atol=2e-4), 'bf16': dict(rtol=2e-3, atol=2e-3)}
DTYPE = {'fp32': (jnp.float32, torch.float32),
         'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_dit_matches_svdd_tpu(precision):
  """hidden 128, 2 heads (D=64), 2 blocks, L=128, adaLN and the final
  linear drawn non-zero."""
  jcfg, tcfg = _configs(precision, hidden_size=128, n_heads=2, n_blocks=2)
  jdt, tdt = DTYPE[precision]
  rs, x, sigma = _inputs(6, VOCAB)
  got, want, _ = _run_both(JaxDIT(config=jcfg, vocab_size=VOCAB,
                               compute_dtype=jdt),
                        dit_from_jax, tcfg, tdt, x, sigma, rs)
  assert got.shape == (2, L, VOCAB) and np.abs(want).max() > 0.1
  np.testing.assert_allclose(got, want, **TOL[precision])


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_ar_matches_svdd_tpu(precision):
  """The causal AR model's log-probs, same widths as the DiT test."""
  jcfg, tcfg = _configs(precision, hidden_size=128, n_heads=2, n_blocks=2)
  jdt, tdt = DTYPE[precision]
  rs, x, sigma = _inputs(7, VOCAB)
  got, want, model = _run_both(JaxAR(config=jcfg, vocab_size=VOCAB,
                                     compute_dtype=jdt),
                               ar_from_jax, tcfg, tdt, x, sigma, rs)
  np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)
  np.testing.assert_allclose(got, want, **TOL[precision])
  # causal: changing the last token leaves every earlier position alone
  x2 = x.copy()
  x2[:, -1] = (x2[:, -1] + 1) % VOCAB
  with torch.no_grad():
    a, b = (model(_t(xx).long()).numpy() for xx in (x, x2))
  np.testing.assert_array_equal(a[:, :-1], b[:, :-1])


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_dimamba_matches_svdd_tpu(precision):
  """d_model 64, 2 layers, L=128 over the DNA vocab, adaLN non-zero so
  each block's RMSNorm reaches the output."""
  jcfg, tcfg = _configs(precision, d_model=64, n_layer=2)
  jdt, tdt = DTYPE[precision]
  rs, x, sigma = _inputs(8, 5)
  got, want, _ = _run_both(JaxDiMamba(config=jcfg, vocab_size=5,
                                   compute_dtype=jdt),
                        dimamba_from_jax, tcfg, tdt, x, sigma, rs)
  assert got.shape == (2, L, 5) and np.isfinite(got).all()
  np.testing.assert_allclose(got, want, **TOL[precision])


def test_text_mdlm_preset_matches_the_jax_yaml():
  """``text_mdlm_config()`` equals svdd_tpu's yaml preset field for
  field, and the port's copy of the yaml is the same file."""
  texts = [open(p).read() for p in REPO_CONFIGS]
  assert texts[0] == texts[1]
  want = JaxConfig.from_dict(yaml.safe_load(texts[0])).to_dict()
  got = text_mdlm_config().to_dict()
  for section, fields in got.items():
    if isinstance(fields, dict):
      for k, v in fields.items():
        assert want[section][k] == v, (section, k)
    else:
      assert want[section] == fields, section
  assert Config.from_yaml(REPO_CONFIGS[1]).to_dict() == got
  assert math.isclose(got['noise']['eps'], 1e-3)


# ---------------------------------------------------------------------------
# B12's rounding gate: where JAX's dispatch takes the Pallas body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('d', [16, 64, 96, 128])
def test_body_rounds_gate_against_jax_dispatch(d, monkeypatch):
  """``flash_attention.body_rounds(L, D)`` holds exactly where
  svdd_tpu's ``flash_mha``, on a TPU, takes the Pallas kernel rather
  than XLA's ``mha``, over L in 1..520 (traced, no values: the TPU
  check patched true, the kernel replaced by a recorder)."""
  taken = []

  def kernel(q, k, v, causal=False):
    taken.append(q.shape[1])
    return q

  monkeypatch.setattr(jattn, '_is_tpu', lambda: True)
  monkeypatch.setattr(jfap, 'flash_attention', kernel)
  lengths = list(range(1, 257)) + [384, 400, 512, 520]
  jattn.flash_mha._clear_cache()
  try:
    for l in lengths:
      spec = jax.ShapeDtypeStruct((1, l, 2, d), jnp.float32)
      jax.eval_shape(jattn.flash_mha, spec, spec, spec)
  finally:
    jattn.flash_mha._clear_cache()
  assert taken == [l for l in lengths if tfa.body_rounds(l, d)]
  assert taken == ([128, 256, 384, 512] if d % 64 == 0 else [])


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('l', [200, 256])
def test_attention_roundings_match_jax_in_bf16(l, causal):
  """bf16 q, k, v at (2, L, 2, 64): off the gate (L = 200) the port's
  ``mha`` against svdd_tpu's ``mha`` run op by op, on it (L = 256) the
  port's ``attention_body_plain`` against the Pallas body in interpret
  mode; each within one bf16 ulp of the output's scale (2^-8: the f32
  sums in another order may round an output apart). The dispatcher on
  CPU tensors takes that form bit for bit, and the other rounding lies
  farther from JAX's at the same shape."""
  rs = np.random.default_rng(l + int(causal))
  q, k, v = (rs.normal(size=(2, l, 2, 64)).astype(np.float32)
             for _ in range(3))
  jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
  tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
  if l % 128:
    with jax.disable_jit():
      want = jattn.mha(jq, jk, jv, causal=causal)
    mine, other = tattn.mha, tattn.attention_body_plain
  else:
    jfap.flash_attention._clear_cache()
    try:
      want = _interpret(lambda: jfap.flash_attention(jq, jk, jv,
                                                     causal=causal))
    finally:
      jfap.flash_attention._clear_cache()
    mine, other = tattn.attention_body_plain, tattn.mha
  want = np.asarray(want, np.float32)
  scale = np.abs(want).max()
  got = mine(tq, tk, tv, causal)
  assert got.dtype == torch.bfloat16
  err = np.abs(got.float().numpy() - want).max()
  assert err <= 2 ** -8 * scale, err
  np.testing.assert_array_equal(
      tattn.flash_mha(tq, tk, tv, causal).float().numpy(),
      got.float().numpy())
  err_other = np.abs(other(tq, tk, tv, causal).float().numpy() - want)
  assert err_other.mean() > np.abs(got.float().numpy() - want).mean()
