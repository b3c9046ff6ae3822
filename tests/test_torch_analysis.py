"""svdd_tpu_torch.analysis against svdd_tpu.analysis on the same numpy
inputs and carried weights: ISM, the four attribution methods (expected
gradients on JAX's own draws, reproduced from its key splits), the
Enformer's attention maps on its L=2 (B5) branch and on the general
softmax branch, directed evolution, Ledidi's loss trace and result on
JAX's Gumbel draws, seqlets, clustering, the MEME file and the
motif-discovery fallback; ISM and the attributions in bf16 at 1 and 20
rows against JAX run op by op; the fused eval tower under the
attributions' gradient, as JAX's dispatch takes it; the plots; the
format converters.

Float32 with TF32 off. Tolerances: forwards rtol 3e-5 (of the largest
value), gradients rtol 2e-4 and atol 2e-4 of the largest value
(tests/test_torch_grad.py:54-55); bf16 forwards 2^-8 of the largest
value, bf16 gradients 2^-5 of the largest (a bf16 ulp of an
intermediate carried through the backward, as in
tests/test_torch_bf16.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import rewards as jrewards
from svdd_tpu.analysis import design as jdesign
from svdd_tpu.analysis import formats as jformats
from svdd_tpu.analysis import interpret as jinterp
from svdd_tpu.models import blocks as jblocks
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer

from svdd_tpu_torch import rewards
from svdd_tpu_torch.analysis import design, formats, interpret, visualize
from svdd_tpu_torch.models import enformer
from svdd_tpu_torch.ops import attn_pool as tap
from svdd_tpu_torch.ops import conv1d as tconv
from svdd_tpu_torch.weights import enformer_value_from_jax
from torch_port_helpers import (few_torch_threads,  # noqa: F401
                                random_variables)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L = 16                      # 16 -> 8 -> 4 -> 2: the L=2 attention (B5)
TINY = dict(channels=256, n_conv=3, n_transformers=2, n_heads=2)


def _t(a):
  return torch.from_numpy(np.array(a))


def _onehot(rs, length=L, n=None):
  shape = (length,) if n is None else (n, length)
  return np.eye(4, dtype=np.float32)[rs.integers(0, 4, shape)]


def _close_fwd(got, want, rtol=3e-5):
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=rtol * np.abs(want).max())


def _close_grad(got, want, rtol=2e-4):
  assert np.abs(want).max() > 0
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=rtol * np.abs(want).max())


@pytest.fixture(scope='module')
def jax_net():
  """A tiny flax Enformer value net and its variables."""
  jm = JaxEnformer(**TINY)
  return jm, random_variables(jm.init, jnp.zeros((1, L, 4)),
                              rs=np.random.default_rng(40))


@pytest.fixture(scope='module')
def pair(jax_net):
  """The net in both packages on one set of weights: (JAX's jitted
  predict_fn, the port's RewardOracle of the carried net)."""
  jm, variables = jax_net
  jfn = jax.jit(lambda oh: jm.apply(variables, oh))
  return jfn, rewards.RewardOracle(enformer_value_from_jax(variables))


# ---------------------------------------------------------------------------
# ISM and the attributions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('batch_size', [512, 24])
def test_ism_predict_matches_svdd_tpu(pair, batch_size):
  """All 64 mutants in one batch, or in batches of 24, 24 and 16."""
  jfn, oracle = pair
  x = _onehot(np.random.default_rng(batch_size))
  want = jinterp.ism_predict(jfn, jnp.asarray(x), batch_size=batch_size)
  got = interpret.ism_predict(oracle, _t(x), batch_size=batch_size)
  assert got.shape == (L, 4)
  _close_fwd(got, want)


def _jax_eg_draws(key, n_refs: int, length: int = L):
  """The permutations and weights JAX's expected_gradients draws from
  ``key`` (``interpret.py:72-81``)."""
  perms, alphas = [], []
  for k in jax.random.split(key, n_refs):
    k1, k2 = jax.random.split(k)
    perms.append(np.asarray(jax.random.permutation(k1, length)))
    alphas.append(float(jax.random.uniform(k2)))
  return _t(np.stack(perms)), torch.tensor(alphas)


ATTRIBUTIONS = {'ism': {}, 'inputxgradient': {},
                'integratedgradients': {}, 'integratedgradients_5': {
                    'steps': 5}, 'deepshap': {}, 'deepshap_4': {'n_refs': 4}}


@pytest.mark.parametrize('case', sorted(ATTRIBUTIONS))
def test_get_attributions_matches_svdd_tpu(pair, case):
  """Each method through get_attributions; expected gradients on the
  permutations and weights JAX draws from its key."""
  jfn, oracle = pair
  method, kwargs = case.split('_')[0], ATTRIBUTIONS[case]
  x = _onehot(np.random.default_rng(len(case)))
  key = jax.random.key(3)
  want = jinterp.get_attributions(jfn, jnp.asarray(x), method, key=key,
                                  **kwargs)
  tkw = dict(kwargs)
  if method == 'deepshap':
    tkw['perms'], tkw['alphas'] = _jax_eg_draws(key, kwargs.get('n_refs', 20))
  got = interpret.get_attributions(oracle, _t(x), method, **tkw)
  assert got.shape == (L, 4) and got.dtype == np.float32
  if method == 'ism':
    # each base's own entry, the sequence's score less itself: rounding
    # noise in both packages, held to the scores' scale
    scale = np.abs(np.asarray(jfn(jnp.asarray(x[None])))).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * scale)
  else:
    _close_grad(got, want)


def test_expected_gradients_draws_from_a_generator(pair):
  """Without injected draws: repeatable from a seed, the default
  generator seeded 0."""
  _, oracle = pair
  x = _t(_onehot(np.random.default_rng(5)))
  a = interpret.expected_gradients(oracle, x, 3, generator=torch.Generator(
  ).manual_seed(0))
  b = interpret.get_attributions(oracle, x, 'deepshap', n_refs=3)
  np.testing.assert_array_equal(a.detach().numpy(), b)


FEW_POINTS = {'integratedgradients': {'steps': 2}, 'deepshap': {'n_refs': 2}}


@pytest.mark.parametrize('method', ['inputxgradient', 'integratedgradients',
                                    'deepshap'])
def test_attributions_take_the_fused_tower(jax_net, pair, method,
                                           monkeypatch):
  """JAX differentiates its fused eval tower here: no unfused_guard, so
  every trace of its gradient sees the fused NACDR switch on. The port's
  gradient runs through B3's fused pool + im2col (the stem pool's and
  the first conv block's handoffs) and never through the unfused
  tower's conv backward (B7's plain version on the CPU)."""
  jm, variables = jax_net
  _, oracle = pair
  seen = []
  fused = jblocks.use_fused_nacdr
  monkeypatch.setattr(jblocks, 'use_fused_nacdr',
                      lambda: seen.append(fused()) or seen[-1])
  x = _onehot(np.random.default_rng(6))
  kwargs = FEW_POINTS.get(method, {})
  jinterp.get_attributions(jax.jit(lambda oh: jm.apply(variables, oh)),
                           jnp.asarray(x), method, key=jax.random.key(0),
                           **kwargs)                   # a fresh trace
  assert seen and all(seen)
  calls = {'b3': 0, 'b7': 0}

  def counted(name, fn):
    def call(*a, **k):
      calls[name] += 1
      return fn(*a, **k)
    return call

  monkeypatch.setattr(tap, 'pool_prologue_im2col_wlogits',
                      counted('b3', tap.pool_prologue_im2col_wlogits))
  monkeypatch.setattr(tconv, 'conv1d_bwd_plain',
                      counted('b7', tconv.conv1d_bwd_plain))
  interpret.get_attributions(oracle, _t(x), method, **kwargs)
  assert calls == {'b3': 2, 'b7': 0}


# ---------------------------------------------------------------------------
# bf16: ISM and the attributions at 1, 8 and 20 rows, JAX op by op
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def bf16_pair():
  """A bf16 net (one transformer block: JAX runs it op by op) in both
  packages."""
  jm = JaxEnformer(**dict(TINY, n_transformers=1), compute_dtype=jnp.bfloat16)
  variables = random_variables(jm.init, jnp.zeros((1, L, 4)),
                               rs=np.random.default_rng(41))
  return (lambda oh: jm.apply(variables, oh),
          rewards.RewardOracle(enformer_value_from_jax(variables,
                                                       torch.bfloat16)))


@pytest.fixture
def f32_sigmoid(monkeypatch):
  """jax.nn.sigmoid of bf16 computed in f32 and rounded once, as the
  port and a TPU compute it (tests/test_torch_bf16.py)."""
  sig = jax.nn.sigmoid
  monkeypatch.setattr(jax.nn, 'sigmoid',
                      lambda x: sig(x.astype(jnp.float32)).astype(x.dtype))


@pytest.mark.parametrize('method', ['ism', 'inputxgradient', 'deepshap'])
def test_bf16_attributions_match_svdd_tpu_op_by_op(bf16_pair, method,
                                                   f32_sigmoid):
  """The bf16 net off the pools' and B5's gates: ISM in batches of 20
  rows (20, 20, 20, 4) and its one-row reference, input x gradient on one
  row, expected gradients on 20 references. ISM within 2^-6 of the
  largest score (a bf16 chain summed in another order lands a few ulps
  apart), gradients within 2^-5 of the largest."""
  jfn, oracle = bf16_pair
  x = _onehot(np.random.default_rng(50 + len(method)))
  key = jax.random.key(4)
  with jax.disable_jit():
    if method == 'ism':
      want = jinterp.ism_predict(jfn, jnp.asarray(x), batch_size=20)
      want_ref = np.asarray(jfn(jnp.asarray(x[None])))
    else:
      want = jinterp.get_attributions(jfn, jnp.asarray(x), method, key=key)
  if method == 'ism':
    got = interpret.ism_predict(oracle, _t(x), batch_size=20)
    with torch.no_grad():
      got_ref = oracle(_t(x[None])).numpy()
    for g, w in ((got_ref, want_ref), (got, want)):
      np.testing.assert_allclose(g, w, rtol=0, atol=2 ** -6 * np.abs(w).max())
    return
  kwargs = ({} if method != 'deepshap'
            else dict(zip(('perms', 'alphas'), _jax_eg_draws(key, 20))))
  got = interpret.get_attributions(oracle, _t(x), method, **kwargs)
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=2 ** -5 * np.abs(want).max())


def test_vmapped_rows_round_as_one_row(jax_net, monkeypatch):
  """JAX's IG vmaps a one-row gradient: its tower's L-major pool
  dispatcher sees (L, 1, C) at each of 8 points, off its gate (tiles of 8
  rows), where a batched forward of 8 rows would sit on it. Inside
  ``rows_as_vmapped`` the port's gates read one row: bf16 takes the
  pools' references and B5's unrounded relk at 8 rows; float32 is
  unchanged."""
  from svdd_tpu.ops import attn_pool_pallas as jap
  from svdd_tpu_torch.ops import attn_l2 as tl2
  from svdd_tpu_torch.ops.kernel_utils import rows_as_vmapped
  jm, variables = jax_net
  rows = []
  dispatch = jap.attn_pool_wlogits_lnc
  monkeypatch.setattr(jap, 'attn_pool_wlogits_lnc',
                      lambda x, *a, **k: rows.append(x.shape[1])
                      or dispatch(x, *a, **k))
  jinterp.integrated_gradients(jax.jit(lambda oh: jm.apply(variables, oh)),
                               jnp.asarray(_onehot(np.random.default_rng(7))),
                               steps=8)
  assert rows and set(rows) == {1}
  xb = torch.ones(8, 4, 128, dtype=torch.bfloat16)
  assert not tap.pool_rounds_as_reference(xb, lnc=True)
  assert tl2.attn_l2_body_rounds(8, 128, 128)
  g = torch.Generator().manual_seed(0)
  r = lambda *shape: (torch.randn(*shape, generator=g) / 8).bfloat16()
  args = (r(8, 2, 128), r(8, 2, 128), r(8, 2, 128), r(128), r(128),
          r(3, 128))
  with rows_as_vmapped():
    assert tap.pool_rounds_as_reference(xb, lnc=True)
    assert not tap.pool_rounds_as_reference(xb.float(), lnc=True)
    got = tl2.attn_l2(*args, heads=1)
  want = tl2.attn_l2_plain(*args, 1, round_relk=False)
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  assert not torch.equal(tl2.attn_l2(*args, heads=1)[1], want[1])


class _Jitted:
  """A flax module whose ``apply`` (with the sown intermediates) runs
  compiled: JAX's get_attention_scores calls it eagerly otherwise."""

  def __init__(self, module):
    self._apply = jax.jit(lambda v, x: module.apply(
        v, x, mutable=['intermediates']))

  def apply(self, variables, x, mutable):
    assert mutable == ['intermediates']
    return self._apply(variables, x)


@pytest.mark.parametrize('block_idx', [None, 1])
def test_attention_scores_l2_branch_match_svdd_tpu(jax_net, pair, block_idx):
  """At L' = 2 (B5's branch): (layers, heads, 2, 2) from B5's weights,
  one row squeezed, rows summing to 1; JAX sows [w, 1 - w] too."""
  jm, variables = jax_net
  _, oracle = pair
  x = _onehot(np.random.default_rng(60))
  want = jinterp.get_attention_scores(_Jitted(jm), variables,
                                      jnp.asarray(x), block_idx=block_idx)
  got = interpret.get_attention_scores(oracle.module, _t(x),
                                       block_idx=block_idx)
  assert got.shape == want.shape == ((2, 2, 2, 2) if block_idx is None
                                     else (2, 2, 2))
  np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
  _close_fwd(got, want)


@pytest.mark.parametrize('rows', [1, 2])
def test_attention_scores_general_branch_match_svdd_tpu(rows):
  """At L' = 4 (n_conv 3, L = 32, three transformer blocks, key width 8):
  the softmax maps of JAX's general branch (tests/test_extras.py:259),
  the batch axis kept for two rows."""
  jm = JaxEnformer(n_tasks=1, n_conv=3, channels=256, n_transformers=3,
                   n_heads=2, key_len=8)
  rs = np.random.default_rng(61 + rows)
  variables = random_variables(jm.init, jnp.zeros((1, 32, 4)), rs=rs)
  x = _onehot(rs, 32, rows)
  want = jinterp.get_attention_scores(_Jitted(jm), variables,
                                      jnp.asarray(x))
  model = enformer_value_from_jax(variables)
  got = interpret.get_attention_scores(model, _t(x))
  assert got.shape == want.shape == ((3, 2, 4, 4) if rows == 1
                                     else (3, rows, 2, 4, 4))
  _close_fwd(got, want)
  np.testing.assert_array_equal(
      interpret.get_attention_scores(model, _t(x), block_idx=2), got[2])


def test_attention_capture_is_opt_in(pair):
  """Outside ``capture_attention`` a forward keeps no map; nested
  captures each see their own forwards."""
  _, oracle = pair
  x = _t(_onehot(np.random.default_rng(62), n=3))
  assert enformer._ATTENTION_MAPS is None
  with torch.no_grad(), enformer.capture_attention() as outer:
    oracle(x)
    with enformer.capture_attention() as inner:
      oracle(x[:1])
  assert enformer._ATTENTION_MAPS is None
  assert [tuple(m.shape) for m in outer] == [(3, 2, 2, 2)] * 2
  assert [tuple(m.shape) for m in inner] == [(1, 2, 2, 2)] * 2
  with pytest.raises(ValueError, match='no attention maps'):
    interpret.get_attention_scores(lambda oh: oh.sum(), x)


# ---------------------------------------------------------------------------
# design: evolve and Ledidi
# ---------------------------------------------------------------------------


def test_evolve_matches_svdd_tpu_on_enformer(pair):
  """Four rounds on the carried net: the same substitutions and scores
  (the scores are continuous there, so no near ties)."""
  jfn, oracle = pair
  x = _onehot(np.random.default_rng(70))
  want_seq, want_hist = jdesign.evolve(jfn, jnp.asarray(x), rounds=4)
  got_seq, got_hist = design.evolve(oracle, _t(x), rounds=4)
  assert len(got_hist) == len(want_hist) == 5
  np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
  _close_fwd(np.array(got_hist), np.array(want_hist))


def test_evolve_contract_on_the_motif_oracle():
  """On the synthetic motif oracle, whose scores tie exactly, JAX's
  contract: the history rises strictly, each step takes the first best
  substitution, and the run stops when none beats the last score."""
  length = 12
  oracle = rewards.synthetic_motif_oracle(length)
  seed = np.zeros(length, np.int64)
  seed[:3] = [2, 1, 2]
  x = torch.eye(4)[seed]
  seq, hist = design.evolve(oracle, x, rounds=6)
  assert all(b > a for a, b in zip(hist, hist[1:])) and len(hist) > 1
  cur = x
  for score in hist[1:]:
    flat = interpret.ism_predict(oracle, cur).reshape(-1)
    l, b = divmod(int(np.flatnonzero(flat == flat.max())[0]), 4)
    cur = cur.clone()
    cur[l] = torch.eye(4)[b]
    assert flat.max() == score
  assert torch.equal(cur, seq)
  if len(hist) < 7:
    assert interpret.ism_predict(oracle, seq).max() <= hist[-1]
  jseq, jhist = jdesign.evolve(jrewards.synthetic_motif_oracle(length),
                               jnp.asarray(x.numpy()), rounds=6)
  assert jhist[0] == hist[0] and len(jhist) > 1


def _jax_ledidi_gumbels(key, steps: int, shape):
  """The Gumbel draw of each of JAX's Ledidi steps: key, sub =
  split(key), then gumbel(sub) (``design.py:56-58``, ``:79``)."""
  out = []
  for _ in range(steps):
    key, sub = jax.random.split(key)
    out.append(np.asarray(jax.random.gumbel(sub, shape)))
  return _t(np.stack(out))


@pytest.mark.parametrize('oracle_name', ['enformer', 'motif'])
def test_ledidi_matches_svdd_tpu(pair, oracle_name):
  """Ten steps on JAX's Gumbel draws: the loss of every step and the
  designed sequence."""
  if oracle_name == 'enformer':
    jfn, oracle = pair
    x, target = _onehot(np.random.default_rng(71)), 2.0
  else:
    jfn, oracle = (jrewards.synthetic_motif_oracle(L),
                   rewards.synthetic_motif_oracle(L))
    x, target = _onehot(np.random.default_rng(72)), 0.5
  key = jax.random.key(5)
  want_seq, want_hist = jdesign.ledidi(jfn, jnp.asarray(x), target, key,
                                       steps=10)
  got_seq, got_hist = design.ledidi(oracle, _t(x), target, steps=10,
                                    gumbel=_jax_ledidi_gumbels(key, 10,
                                                               x.shape))
  assert len(got_hist) == 10
  np.testing.assert_allclose(got_hist, want_hist, rtol=1e-4)
  np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))


def test_ledidi_draws_from_a_generator(pair):
  _, oracle = pair
  x = _t(_onehot(np.random.default_rng(73)))
  run = lambda seed: design.ledidi(oracle, x, 1.0, steps=3,
                                   generator=torch.Generator().manual_seed(
                                       seed))[1]
  assert run(0) == run(0) and run(0) != run(1)


# ---------------------------------------------------------------------------
# motif discovery
# ---------------------------------------------------------------------------


def _planted(n=24, length=40, motif='TTAGGC', seed=0):
  """One-hots with ``motif`` planted once a row, attributions on it plus
  noise (tests/test_extras.py:281)."""
  rs = np.random.default_rng(seed)
  toks = rs.integers(0, 4, (n, length))
  starts = rs.integers(0, length - len(motif), n)
  for i, s in enumerate(starts):
    toks[i, s:s + len(motif)] = ['ACGT'.index(c) for c in motif]
  onehot = np.eye(4)[toks]
  attr = 0.05 * rs.normal(size=onehot.shape)
  for i, s in enumerate(starts):
    attr[i, s:s + len(motif)] += onehot[i, s:s + len(motif)]
  return attr, onehot


@pytest.mark.parametrize('window', [6, 8])
def test_seqlets_and_clusters_match_svdd_tpu(window):
  attr, onehot = _planted()
  want = jinterp.extract_seqlets(attr, onehot, window=window)
  got = interpret.extract_seqlets(attr, onehot, window=window)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  wm = jinterp.cluster_seqlets(want[0], want[2])
  gm = interpret.cluster_seqlets(got[0], got[2])
  assert [(m['n'], m['score']) for m in gm] == \
      [(m['n'], m['score']) for m in wm]
  for g, w in zip(gm, wm):
    np.testing.assert_array_equal(g['pwm'], w['pwm'])


def test_seqlets_of_flat_attributions_are_empty():
  attr, onehot = _planted()
  got = interpret.extract_seqlets(np.zeros_like(attr), onehot)
  want = jinterp.extract_seqlets(np.zeros_like(attr), onehot)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)


def test_run_modisco_fallback_matches_svdd_tpu(tmp_path):
  """modiscolite is absent: the fallback's motifs, MEME file, report and
  logos equal JAX's, and the planted motif is found."""
  attr, onehot = _planted()
  want = jinterp.run_modisco(attr, onehot, out_dir=str(tmp_path / 'jax'),
                             window=6)
  got = interpret.run_modisco(attr, onehot, out_dir=str(tmp_path / 'port'),
                              window=6)
  assert len(got) == len(want) and got[0]['n'] >= 12
  for name in ('motifs.meme', 'report.json'):
    assert (tmp_path / 'port' / name).read_text() == \
        (tmp_path / 'jax' / name).read_text()
  assert json.loads((tmp_path / 'port' / 'report.json').read_text())[0][
      'consensus'] == 'TTAGGC'
  logos = sorted(f for f in os.listdir(tmp_path / 'port')
                 if f.endswith('.png'))
  assert logos == sorted(f for f in os.listdir(tmp_path / 'jax')
                         if f.endswith('.png')) and logos


def test_write_meme_matches_svdd_tpu(tmp_path):
  motifs = [{'pwm': np.random.default_rng(i).dirichlet(np.ones(4), 5),
             'n': i + 2, 'score': 1.0} for i in range(3)]
  interpret.write_meme(motifs, str(tmp_path / 'a.meme'))
  jinterp.write_meme(motifs, str(tmp_path / 'b.meme'))
  assert (tmp_path / 'a.meme').read_text() == \
      (tmp_path / 'b.meme').read_text()


# ---------------------------------------------------------------------------
# plots and formats
# ---------------------------------------------------------------------------


def _plots():
  rng = np.random.default_rng(0)
  vals = rng.normal(size=60)
  return {
      'reward_distributions': lambda V, p: V.plot_reward_distributions(
          {'a': vals, 'b': vals + 1}, save_path=p),
      'pred_scatter': lambda V, p: V.plot_pred_scatter(vals, vals * 0.5,
                                                       save_path=p),
      'calibration': lambda V, p: V.plot_calibration(vals, vals + 0.1,
                                                     save_path=p),
      'timestep_curves': lambda V, p: V.plot_timestep_curves(
          vals[:10], vals[10:20], save_path=p),
      'attributions': lambda V, p: V.plot_attributions(
          rng.normal(size=(20, 4)), save_path=p),
      'kmer_comparison': lambda V, p: V.plot_kmer_comparison(
          {'AAA': 3, 'ACG': 1}, {'AAA': 1, 'CCC': 2}, save_path=p),
      'distribution_density': lambda V, p: V.plot_distribution(
          vals, method='density', save_path=p),
      'pred_distribution': lambda V, p: V.plot_pred_distribution(
          rng.normal(size=(50, 2)), rng.normal(size=(50, 2)), save_path=p),
      'binary_preds': lambda V, p: V.plot_binary_preds(
          vals, rng.integers(0, 2, 60), save_path=p),
      'evolution': lambda V, p: V.plot_evolution(
          {'iter': np.repeat([0, 1, 2], 20), 'score': vals}, save_path=p),
      'gc_match': lambda V, p: V.plot_gc_match(['ACGT', 'GGGG'],
                                               ['AAAA', 'ATAT'], save_path=p),
      'sequence_logo': lambda V, p: V.plot_sequence_logo(
          rng.normal(size=(20, 4)), save_path=p),
      'ism_heatmap': lambda V, p: V.plot_ISM(rng.normal(size=(20, 4)),
                                             save_path=p),
      'ism_logo': lambda V, p: V.plot_ISM(rng.normal(size=(20, 4)),
                                          method='logo', save_path=p),
      'tracks': lambda V, p: V.plot_tracks(
          rng.random((3, 50)), highlight_intervals=[(10, 20)], save_path=p),
      'attention_matrix': lambda V, p: V.plot_attention_matrix(
          rng.random((8, 8)), highlight_intervals=[(2, 4)], save_path=p),
  }


@pytest.mark.parametrize('name', sorted(_plots()))
def test_plot_writes_its_file(name, tmp_path):
  """Each plot renders and saves a PNG, as the JAX package's does."""
  import matplotlib.pyplot as plt
  path = tmp_path / f'{name}.png'
  fig = _plots()[name](visualize, str(path))
  assert os.path.getsize(path) > 0 and fig is not None
  plt.close('all')


FORMATS = ('strings', 'indices', 'one_hot')


@pytest.mark.parametrize('src', FORMATS)
def test_convert_input_type_matches_svdd_tpu(src):
  """Every conversion from ``src`` to each form, masked rows included."""
  seqs = ['ACGTTGCA', 'TTAAGGCC']
  x = {'strings': seqs, 'indices': jformats.convert_input_type(
      seqs, 'indices'), 'one_hot': jformats.convert_input_type(
          seqs, 'one_hot')}[src]
  if src == 'one_hot':
    x = x.copy()
    x[1, 3] = 0                       # a masked position -> 4 -> 'N'
  assert formats.get_input_type(x) == jformats.get_input_type(x) == src
  for dst in FORMATS:
    got = formats.convert_input_type(x, dst)
    want = jformats.convert_input_type(x, dst)
    if dst == 'strings':
      assert got == want
    else:
      np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_format_checks_match_svdd_tpu():
  """The checks on good and bad inputs, and the interval helpers."""
  cases = [np.array([[0, 1, 4]]), np.array([0, 5]), np.zeros((0,), int),
           np.zeros((2, 4), np.float32), np.zeros((2, 3, 4)),
           np.zeros((2, 4), np.int32)]
  for c in cases:
    assert formats.check_indices(c) == jformats.check_indices(c)
    assert formats.check_one_hot(c) == jformats.check_one_hot(c)
  with pytest.raises(ValueError, match='invalid characters'):
    formats.check_strings(['ACGX'])
  formats.check_strings(['acgtn'])
  import pandas as pd
  df = formats.strings_to_intervals(['ACG', 'TTTT'], chrom='c1')
  pd.testing.assert_frame_equal(df, jformats.strings_to_intervals(
      ['ACG', 'TTTT'], chrom='c1'))
  assert formats.check_intervals(df) and not formats.check_intervals(
      df[['start', 'chrom', 'end']])
  genome = {'c1': 'ACGTTTTA'}
  df = pd.DataFrame({'chrom': ['c1', 'c1'], 'start': [0, 3], 'end': [3, 7],
                     'strand': ['+', '-']})
  assert formats.intervals_to_strings(df, genome) == \
      jformats.intervals_to_strings(df, genome) == ['ACG', 'AAAA']
  with pytest.raises(KeyError, match='chr9'):
    formats.intervals_to_strings(df.assign(chrom='chr9'), genome)
