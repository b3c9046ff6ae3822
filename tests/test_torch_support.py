"""The supporting modules of svdd_tpu_torch against svdd_tpu on the same
numpy inputs: the streaming R2 and NLL states, the embedding-PCA
Wasserstein distance, the quantile table and the npz report, the
validation hook's embedding branch, the step timer, the NaN guards, the
straight-through samplers on JAX's noise (values and gradients), the
k-mer counter, the detokenizer, the artifact registry, the
``SVDD_AOT_CACHE`` notice; and a guard that no module of the port
imports JAX or the JAX package.

Float32. Tolerances: 1e-6 relative for the streaming states and the
samplers' values (the same float32 ops), 1e-5 for the PCA distances (the
port's SVD in float64, sklearn's on the float32 input), 1e-6 for the
samplers' gradients.
"""

import json
import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import artifacts as jartifacts
from svdd_tpu import observability as jobs
from svdd_tpu import rewards as jrewards
from svdd_tpu import utils as jutils
from svdd_tpu.data import gosai as jgosai
from svdd_tpu.eval import metrics as jmetrics
from svdd_tpu.eval import report as jreport
from svdd_tpu.eval import validation as jvalidation

from svdd_tpu_torch import artifacts, decode, observability, rewards, utils
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.data import gosai
from svdd_tpu_torch.eval import metrics, report, validation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIGHT = dict(rtol=1e-6, atol=1e-6)


def _t(a):
  return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# streaming states, PCA distance, quantiles, the report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('targets', [1, 3])
def test_r2_state_matches_svdd_tpu(targets):
  """Three updates of uneven sizes, then compute, and every field."""
  rs = np.random.default_rng(targets)
  js, ts = jmetrics.R2State.init(targets), metrics.R2State.init(targets)
  for n in (5, 8, 3):
    y = rs.normal(size=(n, targets)).astype(np.float32)
    p = (y + 0.3 * rs.normal(size=y.shape)).astype(np.float32)
    js = js.update(jnp.asarray(y), jnp.asarray(p))
    ts = ts.update(_t(y), p)            # a tensor, then an array
  for got, want in zip(ts, js):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
  np.testing.assert_allclose(float(ts.compute()), float(js.compute()),
                             **TIGHT)


def test_nll_state_matches_svdd_tpu():
  """Masked NLL sums over two updates: nll, bpd and ppl."""
  rs = np.random.default_rng(2)
  js, ts = jmetrics.NLLState.init(), metrics.NLLState.init()
  for _ in range(2):
    nll = rs.uniform(0, 3, (4, 16)).astype(np.float32)
    mask = (rs.random((4, 16)) < 0.7).astype(np.float32)
    js = js.update(jnp.asarray(nll), jnp.asarray(mask))
    ts = ts.update(_t(nll), _t(mask))
  for name in ('nll', 'bpd', 'ppl'):
    np.testing.assert_allclose(float(getattr(ts, name)()),
                               float(getattr(js, name)()), rtol=1e-6)


@pytest.mark.parametrize('n,d,k', [(64, 16, 10), (40, 8, 10), (12, 20, 10)])
def test_embedding_pca_wasserstein_matches_svdd_tpu(n, d, k):
  """Against sklearn's PCA at sizes its exact solver takes: 10
  components, capped by the width (8) and by the rows less one (11)."""
  rs = np.random.default_rng(n)
  a = (rs.normal(size=(n, d)) * np.linspace(3, 0.5, d)).astype(np.float32)
  b = (rs.normal(size=(n + 7, d)) + 0.2).astype(np.float32)
  want = jmetrics.embedding_pca_wasserstein(a, b, k)
  got = metrics.embedding_pca_wasserstein(a, b, k)
  assert want > 0
  np.testing.assert_allclose(got, want, rtol=1e-5)


def test_quantile_report_matches_svdd_tpu_and_moved():
  """The table, and cli.common and pipeline reading it from eval.metrics."""
  rs = np.random.default_rng(4)
  rows = {'decoding': rs.normal(size=37), 'baseline': rs.normal(size=(4, 5))}
  assert metrics.quantile_report(rows) == jmetrics.quantile_report(rows)
  assert common.quantile_report is metrics.quantile_report
  from svdd_tpu_torch import pipeline
  assert pipeline.quantile_report is metrics.quantile_report


@pytest.mark.parametrize('name', ['dna-HepG2.npz', 'rna-MRL_tw.npz',
                                  'dna-other.npz'])
def test_report_file_text_matches_svdd_tpu(name, tmp_path):
  """The same text as JAX's report, with the reference's quantiles beside
  the runs it published."""
  rs = np.random.default_rng(5)
  path = tmp_path / name
  np.savez(path, decoding=rs.normal(2, 1, 64).astype(np.float32),
           baseline=rs.normal(0, 1, 64).astype(np.float32))
  assert report.report_file(str(path)) == jreport.report_file(str(path))
  assert report.REFERENCE_BASELINES == jreport.REFERENCE_BASELINES


def test_report_main_prints_and_plots(tmp_path, capsys):
  """``python -m svdd_tpu_torch.eval.report a.npz b.npz --plot P``."""
  rs = np.random.default_rng(6)
  paths = []
  for name in ('dna-HepG2.npz', 'dna-HepG2_tw.npz'):
    paths.append(str(tmp_path / name))
    np.savez(paths[-1], decoding=rs.normal(size=16), baseline=rs.normal(
        size=16))
  plot = str(tmp_path / 'box.png')
  report.main([*paths, '--plot', plot])
  out = capsys.readouterr().out
  assert out == '\n'.join(map(report.report_file, paths)) + \
      f'\nwrote {plot}\n'
  assert os.path.getsize(plot) > 0


# ---------------------------------------------------------------------------
# the validation hook's embedding branch
# ---------------------------------------------------------------------------


class _Split:
  """A split as both hooks read it: seqs, clss and its length."""

  def __init__(self, seqs, clss):
    self.seqs, self.clss = seqs, clss

  def __len__(self):
    return len(self.seqs)


def test_validation_embed_fn_matches_svdd_tpu(monkeypatch):
  """Both hooks on the same samples (each package's sampler replaced by
  the same tokens) and the same splits, with one embedding function: the
  k-mer correlation and the embedding-PCA distance over the same train
  subset, and the oracle's distances."""
  rs = np.random.default_rng(7)
  samples = rs.integers(0, 4, (24, 20)).astype(np.int32)
  proj = rs.normal(size=(20 * 4, 12)).astype(np.float32)
  datasets = {s: _Split(rs.integers(0, 4, (40, 20)).astype(np.int32),
                       rs.normal(size=(40, 3)).astype(np.float32))
              for s in ('train', 'val')}
  embed_np = lambda oh: np.asarray(oh).reshape(len(oh), -1) @ proj
  oracle_np = lambda oh: np.asarray(oh)[..., :3].sum(1)
  monkeypatch.setattr(jvalidation, 'sample_sequences',
                      lambda *a, **k: samples)
  monkeypatch.setattr(validation, 'sample_sequences',
                      lambda *a, **k: samples)
  want = jvalidation.distribution_eval(
      None, None, datasets, None, oracle_fn=oracle_np, embed_fn=embed_np,
      subset_size=16)
  got = validation.distribution_eval(
      types.SimpleNamespace(device='cpu'), datasets, None,
      oracle_fn=lambda oh: _t(oracle_np(oh.numpy())),
      embed_fn=lambda oh: _t(embed_np(oh.numpy())), subset_size=16)
  assert set(got) == set(want) and 'emb_pca_ws' in got
  for key in want:
    np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# observability and the NaN reporters
# ---------------------------------------------------------------------------


def test_step_timer_summary():
  """stop() times from start() (the result's CPU tensors need no wait);
  the summary's keys are JAX's."""
  timer, jtimer = observability.StepTimer(), jobs.StepTimer()
  for _ in range(3):
    timer.start()
    dt = timer.stop({'x': torch.ones(4), 'y': [torch.zeros(2)]})
    assert dt >= 0
    jtimer.start()
    jtimer.stop(jnp.ones(4))
  assert timer.summary().keys() == jtimer.summary().keys()
  assert timer.summary()['steps'] == 3
  assert observability.StepTimer().summary() == {}


def test_profile_trace_writes_a_trace(tmp_path):
  with observability.profile_trace(str(tmp_path)):
    (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
  files = [f for f in os.listdir(tmp_path) if f.endswith('.pt.trace.json')]
  assert len(files) == 1
  with open(tmp_path / files[0]) as f:
    assert json.load(f)['traceEvents']


@pytest.mark.parametrize('bad', [None, np.nan, np.inf])
def test_nan_guard_matches_svdd_tpu(bad, capsys):
  """The flag and the printed line of a nested structure, int leaves
  skipped."""
  a = np.arange(6, dtype=np.float32).reshape(2, 3)
  if bad is not None:
    a[1, 2] = bad
  tree = {'loss': np.float32(1.5), 'grads': [a, np.ones(3, np.int32)]}
  jtree = jax.tree.map(jnp.asarray, tree)
  want = bool(jobs.nan_guard(jtree, 'grads'))
  jax.effects_barrier()
  want_out = capsys.readouterr().out
  got = observability.nan_guard(jax.tree.map(_t, tree), 'grads')
  assert got.dtype == torch.bool and bool(got) == want == (bad is not None)
  assert capsys.readouterr().out == want_out


@pytest.mark.parametrize('nan', [False, True])
def test_print_nans_matches_svdd_tpu(nan, capsys):
  x = np.ones(5, np.float32)
  if nan:
    x[2] = np.nan
  jutils.print_nans(jnp.asarray(x), 'logits')
  jax.effects_barrier()
  want = capsys.readouterr().out
  x_t = _t(x)
  assert utils.print_nans(x_t, 'logits') is x_t
  assert capsys.readouterr().out == want
  assert want == ('logits contains NaNs\n' if nan else '')


# ---------------------------------------------------------------------------
# the straight-through samplers on JAX's noise
# ---------------------------------------------------------------------------


def _values_and_grads(jfn, tfn, x, w):
  """JAX's and the port's output and d sum(out * w) / dx."""
  jx, jw = jnp.asarray(x), jnp.asarray(w)
  want = np.asarray(jfn(jx))
  want_g = np.asarray(jax.grad(lambda v: (jfn(v) * jw).sum())(jx))
  tx = _t(x).requires_grad_(True)
  got = tfn(tx)
  (got_g,) = torch.autograd.grad((got * _t(w)).sum(), tx)
  return got.detach().numpy(), want, got_g.numpy(), want_g


SAMPLERS = ('gumbel_softmax_hard', 'gumbel_softmax_soft', 'topk_mask_st',
            'binary_discretization_st', 'binary_sample_st',
            'gaussian_sample')


@pytest.mark.parametrize('name', SAMPLERS)
def test_straight_through_samplers_match_svdd_tpu(name):
  """Each sampler's output and input gradient against the JAX sampler,
  the port given the noise JAX draws from its key (the Gumbel of the key,
  binary_sample_st's two Gumbels of its split, the normal of the key)."""
  rs = np.random.default_rng(SAMPLERS.index(name))
  key = jax.random.key(SAMPLERS.index(name))
  x = rs.normal(size=(3, 8)).astype(np.float32)
  w = rs.normal(size=(3, 8)).astype(np.float32)
  gumbel = _t(jax.random.gumbel(key, x.shape))
  if name.startswith('gumbel_softmax'):
    hard = name.endswith('hard')
    jfn = lambda v: jutils.gumbel_softmax(key, v, 0.7, hard)
    tfn = lambda v: utils.gumbel_softmax(v, 0.7, hard, gumbel=gumbel)
  elif name == 'topk_mask_st':
    jfn = lambda v: jutils.topk_mask_st(v, 3)
    tfn = lambda v: utils.topk_mask_st(v, 3)
  elif name == 'binary_discretization_st':
    jfn, tfn = jutils.binary_discretization_st, utils.binary_discretization_st
  elif name == 'binary_sample_st':
    x = rs.uniform(0.05, 0.95, x.shape).astype(np.float32)
    k1, k2 = jax.random.split(key)
    pair = tuple(_t(jax.random.gumbel(k, x.shape)) for k in (k1, k2))
    jfn = lambda v: jutils.binary_sample_st(key, v)
    tfn = lambda v: utils.binary_sample_st(v, gumbels=pair)
  else:
    noise = _t(jax.random.normal(key, (3, 4)))
    w = w[:, :4]
    jfn = lambda v: jutils.gaussian_sample(key, v)
    tfn = lambda v: utils.gaussian_sample(v, noise=noise)
  got, want, got_g, want_g = _values_and_grads(jfn, tfn, x, w)
  np.testing.assert_allclose(got, want, **TIGHT)
  np.testing.assert_allclose(got_g, want_g, **TIGHT)


def test_topk_gamma_noise_matches_svdd_tpu():
  """On the Gamma(1/k) draws of JAX's key; and drawn from a generator,
  the shape and the mean of JAX's draws' law."""
  key = jax.random.key(9)
  shape, k = (4, 6), 3
  gamma = _t(jax.random.gamma(key, 1.0 / k, (10,) + shape))
  want = np.asarray(jutils.topk_gamma_noise(key, shape, k, gamma_tau=0.5))
  got = utils.topk_gamma_noise(shape, k, gamma_tau=0.5, gamma=gamma)
  np.testing.assert_allclose(got.numpy(), want, **TIGHT)
  drawn = utils.topk_gamma_noise((400, 50), k, generator=torch.Generator(
  ).manual_seed(0))
  # E[sum_i Gamma(1/k) i / k] = sum_i i / k^2 = 55 / 9, less log 10, / k
  assert drawn.shape == (400, 50)
  assert abs(float(drawn.mean()) - (55 / 9 - np.log(10)) / k) < 0.02


def test_samplers_draw_from_a_generator():
  """Without injected noise each sampler draws from its generator:
  repeatable from a seed, and a fresh seed gives another draw."""
  x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
  p = torch.rand(4, 6, generator=torch.Generator().manual_seed(1))
  calls = (lambda g: utils.gumbel_softmax(x, hard=False, generator=g),
           lambda g: utils.binary_sample_st(p, generator=g),
           lambda g: utils.gaussian_sample(x, generator=g))
  seeded = lambda seed: torch.Generator().manual_seed(seed)
  for call in calls:
    assert torch.equal(call(seeded(3)), call(seeded(3)))
    assert not torch.equal(call(seeded(3)), call(seeded(4)))
  with pytest.raises(ValueError, match='Generator'):
    utils.gumbel_softmax(x)


# ---------------------------------------------------------------------------
# k-mers, detokenizer, artifacts, the AOT notice
# ---------------------------------------------------------------------------


def test_count_kmers_matches_svdd_tpu():
  seqs = jgosai.batch_dna_detokenize(
      np.random.default_rng(10).integers(0, 4, (6, 30)))
  for k in (1, 3, 5):
    assert rewards.count_kmers(seqs, k) == jrewards.count_kmers(seqs, k)


def test_dna_detokenize_matches_svdd_tpu():
  """Ids 0-3 as JAX's; any other id 'N', as the batch detokenizer."""
  tokens = np.random.default_rng(11).integers(0, 4, 40)
  assert gosai.dna_detokenize(tokens) == jgosai.dna_detokenize(tokens)
  assert gosai.dna_detokenize(_t(tokens)) == jgosai.dna_detokenize(tokens)
  odd = np.array([0, 4, 3, 7])
  assert gosai.dna_detokenize(odd) == 'ANTN' == \
      gosai.batch_dna_detokenize(odd[None])[0]


def test_artifact_registry_under_its_directory(tmp_path, monkeypatch):
  """The names and paths of JAX's registry; a file placed under
  SVDD_ARTIFACTS_DIR resolves, a missing one raises naming the
  directory and the port's importers, an unknown name a KeyError."""
  monkeypatch.setenv('SVDD_ARTIFACTS_DIR', str(tmp_path))
  monkeypatch.setattr(jartifacts, 'ARTIFACTS_DIR', str(tmp_path))
  assert artifacts.REGISTRY == jartifacts.REGISTRY
  assert artifacts.available_artifacts() == {n: False
                                             for n in artifacts.REGISTRY}
  with pytest.raises(FileNotFoundError, match='svdd_tpu_torch.importers'):
    artifacts.artifact_path('DNA_Value')
  for name, version in (('DNA_Value', 'v0'), ('RNA_evaluation', 'v3')):
    path = os.path.join(str(tmp_path), f'{name}:{version}')
    os.makedirs(path)
    fname = os.path.basename(artifacts.REGISTRY[name][0])
    open(os.path.join(path, fname), 'w').close()
    assert artifacts.artifact_path(name, version) == \
        jartifacts.artifact_path(name, version) == os.path.join(path, fname)
  assert artifacts.available_artifacts() == jartifacts.available_artifacts()
  assert artifacts.available_artifacts()['DNA_Value']
  with pytest.raises(KeyError, match='unknown artifact'):
    artifacts.artifact_path('DNA_Oracle')


def test_aot_cache_variable_is_noticed_once(monkeypatch, caplog):
  """With SVDD_AOT_CACHE set, the first decode of the process logs that
  the port ignores it, and later ones do not; unset, nothing is logged."""
  monkeypatch.setattr(decode, '_aot_noticed', False)
  bogus = dict(diffusion=types.SimpleNamespace(device='cpu'),
               reward_fn=None, algo='bogus')
  with caplog.at_level(logging.WARNING, logger=decode.__name__):
    monkeypatch.delenv('SVDD_AOT_CACHE', raising=False)
    with pytest.raises(NotImplementedError):
      decode.run_decode(**bogus)
    assert not caplog.records
    monkeypatch.setenv('SVDD_AOT_CACHE', '/nonexistent/aot')
    for _ in range(2):
      with pytest.raises(NotImplementedError):
        decode.run_decode(**bogus)
  assert [r.getMessage() for r in caplog.records] == [decode._AOT_NOTICE]
  assert 'ignored' in decode._AOT_NOTICE


def test_no_port_module_imports_jax():
  """Every module of svdd_tpu_torch, the analysis and support modules
  among them, and chip_smoke.py and the phase 11 probe import neither JAX
  nor the JAX package."""
  code = ('import importlib, pkgutil, sys, svdd_tpu_torch; '
          'mods = [m.name for m in pkgutil.walk_packages('
          "svdd_tpu_torch.__path__, 'svdd_tpu_torch.')]; "
          '[importlib.import_module(m) for m in mods]; '
          'import chip_smoke; '
          "sys.path.insert(0, 'scripts'); import probe_a15; "
          "assert 'svdd_tpu_torch.analysis.interpret' in mods, mods; "
          "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'svdd_tpu') "
          'if m in sys.modules]; '
          'assert not bad, bad')
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
