"""SVDD-PM (Tweedie), TDS and scheduled-M decoding in svdd_tpu_torch vs
svdd_tpu.

One reverse step of each is pinned token for token against the JAX step
on the same denoiser weights and the same noise: the Gumbel noise JAX
draws from the step's key (TDS: from k_draw) and, for TDS's resample,
the uniforms ``jax.random.choice`` draws from k_resample. The resample's
cumulative weights are summed in another order by torch and by XLA, so a
uniform within f32 rounding of a boundary could take the neighbouring
particle: the resample test holds such rows to the window of indices
that rounding allows (``_resample_window``), and the step tests, at eight
particles, assert that none of their rows is at a boundary. Whole decodes are held
to the JAX decodes by distribution (different random streams): the KS
and quantile rule of ``tests/test_torch_decode.py`` at 256 samples a
side.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats as sps

from svdd_tpu import utils as jutils
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.sampling import guidance as jguidance

from svdd_tpu_torch import utils
from svdd_tpu_torch.cli import decode as cli_decode
from svdd_tpu_torch.cli import decode_TDS, decode_tweedie
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.sampling import guidance
from svdd_tpu_torch.weights import cnn_from_jax
from torch_port_helpers import random_cnn_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, STEPS, M = 256, 16, 8, 4
STEP_B = 8
KS_PVAL = 1e-3
# the TDS decodes' temperature: the reward of a (L, 4) normal-weight
# linear function differs by units between particles, so alpha = 4 keeps
# the particle set from collapsing to a handful of ancestors, where two
# samples of 256 from different random streams could not agree in
# distribution
TDS_ALPHA = 4.0


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
  """The port's tensors here are tiny: one intra-op thread keeps torch
  from spinning its threads against the other test workers' (slower by
  up to 100x under the parallel run otherwise)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pair():
  """A tiny JAX denoiser, the port holding its weights, and a fixed
  linear reward on the (N, L, 4) one-hot (numpy weights)."""
  cfg = jax_tiny_config('dna')
  cfg.model.length = L
  cfg.sampling.steps = STEPS
  variables = random_cnn_variables(cfg, np.random.default_rng(0))
  variables['params']['final_1']['kernel'] = (
      3.0 * variables['params']['final_1']['kernel'])
  jdiff = JaxDiffusion(cfg, variables=variables)
  tcfg = tiny_test_config('dna')
  tcfg.model.length = L
  tcfg.sampling.steps = STEPS
  tdiff = Diffusion(tcfg, device='cpu', backbone=cnn_from_jax(variables))
  w = np.random.default_rng(3).normal(size=(L, 4)).astype(np.float32)
  return jdiff, tdiff, w


def _jax_reward(w):
  wj = jnp.asarray(w)
  return lambda onehot: (onehot * wj).sum(axis=(-1, -2))


def _torch_reward(w):
  wt = torch.from_numpy(w)
  return lambda onehot: (onehot * wt).sum(dim=(-1, -2))


def _onehot_np(tokens):
  keep = tokens != 4
  return np.eye(4, dtype=np.float32)[np.clip(tokens, 0, 3)] * keep[..., None]


def _partly_masked(seed, b=STEP_B):
  rs = np.random.default_rng(seed)
  return np.where(rs.random((b, L)) < 0.6, 4,
                  rs.integers(0, 4, (b, L))).astype(np.int32)


def _t(a):
  return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# SVDD-PM: one step
# ---------------------------------------------------------------------------


PM_CASES = {'tweedie': (True, False), 'heuristic': (False, False),
            'tweedie_valid_carry': (True, True)}


@pytest.mark.parametrize('case', sorted(PM_CASES))
def test_svdd_pm_step_pinned_to_svdd_tpu(pair, case):
  """Both scoring modes, and the posterior carry given a valid carry
  (the step reads it instead of its (B,) forward and returns the
  winner's candidate forward, which must match JAX's to f32 rounding)."""
  tweedie, carry = PM_CASES[case]
  jdiff, tdiff, w = pair
  x = _partly_masked(0)
  t, t_next = np.float32(0.6), np.float32(0.55)
  key = jax.random.key(7)
  if carry:
    # any log_p stands in for the carry: both steps must read it
    cache = np.asarray(jdiff.denoise_fn()(jnp.asarray(_partly_masked(5)),
                                          jnp.zeros((STEP_B,))))
    jaux, taux = (jnp.asarray(cache), jnp.asarray(True)), (_t(cache), True)
  else:
    jaux = taux = ()
  jstep = jguidance.svdd_pm_step(jdiff.denoise_fn(), _jax_reward(w),
                                 jdiff.schedule, 4, repeats=M,
                                 tweedie=tweedie, carry_posterior=carry)
  jaux_next, want = jax.jit(jstep)(jaux, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (STEP_B, M, L, 5), jnp.float32))
  tstep = guidance.svdd_pm_step(tdiff.forward, _torch_reward(w),
                                tdiff.schedule, 4, repeats=M,
                                tweedie=tweedie, carry_posterior=carry)
  with torch.no_grad():
    taux_next, got = tstep(taux, _t(x).long(), torch.tensor(t),
                           torch.tensor(t_next), None, gumbel=_t(noise))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert (got.numpy() != 4).sum() > (x != 4).sum()
  if carry:
    assert taux_next[1] is True and bool(jaux_next[1])
    np.testing.assert_allclose(taux_next[0].numpy(),
                               np.asarray(jaux_next[0]), rtol=1e-5,
                               atol=1e-5)
  else:
    assert taux_next == ()


def test_svdd_pm_step_takes_the_saluki_task(pair):
  """``task='rna_saluki'`` with the posterior carry (the decode's
  default): the winners' tokens rebuilt from the Tweedie one-hot score
  through the saluki input (a 4-row body, padded to 32 rows) under a
  linear reward; the same winners and carried forward as JAX's step on
  JAX's Gumbel noise (``tests/test_torch_saluki.py`` holds both scoring
  modes without the carry)."""
  jdiff, tdiff, _ = pair
  rs = np.random.default_rng(4)
  w6 = rs.normal(size=(32, 6)).astype(np.float32)
  body = rs.normal(size=(4, 6)).astype(np.float32)
  x = _partly_masked(1)
  t, t_next = np.float32(0.6), np.float32(0.55)
  key = jax.random.key(8)
  wj, wt = jnp.asarray(w6), torch.from_numpy(w6)
  jstep = jguidance.svdd_pm_step(
      jdiff.denoise_fn(), lambda oh: (oh * wj).sum(axis=(-1, -2)),
      jdiff.schedule, 4, repeats=M, task='rna_saluki',
      saluki_body=jnp.asarray(body), saluki_final_length=32,
      carry_posterior=True)
  cache = np.asarray(jdiff.denoise_fn()(jnp.asarray(x),
                                        jnp.zeros((STEP_B,))))
  jaux, want = jax.jit(jstep)((jnp.asarray(cache), jnp.asarray(False)),
                              jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (STEP_B, M, L, 5), jnp.float32))
  tstep = guidance.svdd_pm_step(
      tdiff.forward, lambda oh: (oh * wt).sum(dim=(-1, -2)), tdiff.schedule,
      4, repeats=M, task='rna_saluki', saluki_body=_t(body),
      saluki_final_length=32, carry_posterior=True)
  with torch.no_grad():
    taux, got = tstep((None, False), _t(x).long(), torch.tensor(t),
                      torch.tensor(t_next), None, gumbel=_t(noise))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert taux[1] is True
  np.testing.assert_allclose(taux[0].numpy(), np.asarray(jaux[0]),
                             rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# TDS: the resample and one step
# ---------------------------------------------------------------------------


def _resample_window(w, u):
  """Per row, the indices [lo, hi] a resample may take when the
  cumulative weights are summed in any order: the target's search over
  cumsum(w) moved by the f32 error bound of a b-term sum, b 2^-24 of the
  total. lo == hi on every row but those at a boundary."""
  cum = np.cumsum(np.asarray(w, np.float64))
  target = cum[-1] * (1 - np.asarray(u, np.float64))
  slack = len(cum) * 2.0 ** -24 * cum[-1]
  return (np.searchsorted(cum, target - slack, side='left'),
          np.searchsorted(cum, target + slack, side='left'))


def _assert_resampled_alike(got, want, w, u):
  """Equal indices on every row away from a boundary; at one, both
  within its window. At least 90% of the rows are compared exactly."""
  lo, hi = _resample_window(w, u)
  edge = lo != hi
  assert edge.mean() <= 0.1, f'{edge.sum()} rows at a boundary'
  np.testing.assert_array_equal(got[~edge], want[~edge])
  for idx in (got, want):
    assert ((lo <= idx) & (idx <= hi)).all()
  return edge


@pytest.mark.parametrize('b', [8, 512])
def test_resample_indices_match_jax_random_choice(b):
  """``resample_indices`` on JAX's uniforms equals
  ``jax.random.choice(key, b, (b,), p=w)`` index for index, the rows at a
  boundary aside (``_assert_resampled_alike``)."""
  rs = np.random.default_rng(b)
  log_w = 2 * rs.normal(size=b)                      # TDS-like weights
  w = (np.exp(log_w) / np.exp(log_w).sum()).astype(np.float32)
  key = jax.random.key(b)
  want = np.asarray(jax.random.choice(key, b, shape=(b,), p=jnp.asarray(w)))
  u = np.asarray(jax.random.uniform(key, (b,), jnp.float32))
  got = guidance.resample_indices(_t(w), _t(u)).numpy()
  _assert_resampled_alike(got, want, w, u)
  assert len(np.unique(got)) < b        # a real resample, not the identity


def _record_resample(monkeypatch):
  calls = []
  fn = guidance.resample_indices
  monkeypatch.setattr(guidance, 'resample_indices',
                      lambda w, u: calls.append((w.numpy(), u.numpy()))
                      or fn(w, u))
  return calls


# (carry_posterior with a valid carry, track_ess, ess_threshold, step i)
TDS_CASES = {'plain': (False, False, None, 3),
             'carry_track_ess': (True, True, None, 3),
             'threshold': (False, True, 0.5, 3),
             'threshold_last_step': (False, True, 1e-9, STEPS - 1)}


@pytest.mark.parametrize('case', sorted(TDS_CASES))
def test_tds_step_pinned_to_svdd_tpu(pair, case, monkeypatch):
  """``tds_step`` against JAX's on JAX's Gumbel noise from k_draw and
  uniforms from k_resample: the tokens, the ESS written into the trace,
  the carried posterior, the accumulated log-weights. Under
  ``threshold_last_step`` the ESS never reaches the threshold, yet the
  last step resamples."""
  carry, track, thr, i = TDS_CASES[case]
  jdiff, tdiff, w = pair
  x = _partly_masked(1)
  t, t_next = np.float32(0.4), np.float32(0.3)
  key = jax.random.key(9)
  k_draw, k_resample = jax.random.split(key)
  rs = np.random.default_rng(4)
  cache = np.asarray(jdiff.denoise_fn()(jnp.asarray(x),
                                        jnp.zeros((STEP_B,))))
  log_w = rs.normal(size=STEP_B).astype(np.float32)
  jpost = (jnp.asarray(cache), jnp.asarray(True)) if carry else ()
  tpost = (_t(cache), True) if carry else ()
  jaux = jguidance.tds_aux_init(STEP_B, jpost, track_ess=track,
                                num_steps=STEPS, ess_threshold=thr)
  taux = guidance.tds_aux_init(STEP_B, tpost, track_ess=track,
                               num_steps=STEPS, ess_threshold=thr,
                               device='cpu')
  if isinstance(jaux, dict):
    jaux['i'] = jnp.asarray(i, jnp.int32)
    taux['i'] = i
    if thr is not None:
      jaux['log_w'] = jnp.asarray(log_w)
      taux['log_w'] = _t(log_w)
  kwargs = dict(alpha=0.5, carry_posterior=carry, track_ess=track,
                num_steps=STEPS, ess_threshold=thr)
  jstep = jguidance.tds_step(jdiff.denoise_fn(), _jax_reward(w),
                             jdiff.schedule, 4, **kwargs)
  jaux_next, want = jax.jit(jstep)(jaux, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(t_next), key)
  gumbel = np.array(jax.random.gumbel(k_draw, (STEP_B, L, 5), jnp.float32))
  uniform = np.array(jax.random.uniform(k_resample, (STEP_B,), jnp.float32))
  calls = _record_resample(monkeypatch)
  tstep = guidance.tds_step(tdiff.forward, _torch_reward(w), tdiff.schedule,
                            4, **kwargs)
  with torch.no_grad():
    taux_next, got = tstep(taux, _t(x).long(), torch.tensor(t),
                           torch.tensor(t_next), None, gumbel=_t(gumbel),
                           uniform=_t(uniform))
  (wt, ut), = calls
  lo, hi = _resample_window(wt, ut)
  assert (lo == hi).all(), 'a resample target at a boundary'
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  post = taux_next['post'] if isinstance(taux_next, dict) else taux_next
  jpost_next = (jaux_next['post'] if isinstance(jaux_next, dict)
                else jaux_next)
  if carry:
    assert post[1] is True
    np.testing.assert_allclose(post[0].numpy(), np.asarray(jpost_next[0]),
                               rtol=1e-5, atol=1e-5)
  else:
    assert post == ()
  if track:
    assert taux_next['i'] == i + 1
    ess = taux_next['ess'].numpy()
    np.testing.assert_allclose(ess, np.asarray(jaux_next['ess']), rtol=1e-5)
    assert 1 <= ess[i] <= STEP_B and (np.delete(ess, i) == 0).all()
  if thr is not None:
    np.testing.assert_allclose(taux_next['log_w'].numpy(),
                               np.asarray(jaux_next['log_w']),
                               rtol=1e-5, atol=1e-5)
  if case == 'threshold_last_step':
    # resampled: all log-weights reset, and not the identity
    assert (taux_next['log_w'].numpy() == 0).all()


def test_tds_terminal_resample_fires_only_on_the_last_step(pair):
  """With a threshold no ESS reaches, a step before the last keeps its
  particles in place (the draw alone moves them) and the last step
  resamples exactly as the always-resample step does on the same
  noise."""
  _, tdiff, w = pair
  x = _t(_partly_masked(2)).long()
  rs = np.random.default_rng(6)
  gumbel = _t(rs.gumbel(size=(STEP_B, L, 5)).astype(np.float32))
  uniform = _t(rs.random(STEP_B).astype(np.float32))
  t, t_next = torch.tensor(0.4), torch.tensor(0.3)
  args = (tdiff.forward, _torch_reward(w), tdiff.schedule, 4)
  plain = guidance.tds_step(*args, alpha=0.5)
  never = guidance.tds_step(*args, alpha=0.5, num_steps=STEPS,
                            ess_threshold=1e-9)
  with torch.no_grad():
    _, resampled = plain((), x, t, t_next, None, gumbel, uniform)
    outs = {}
    for i in (0, STEPS - 2, STEPS - 1):
      aux = guidance.tds_aux_init(STEP_B, (), num_steps=STEPS,
                                  ess_threshold=1e-9, device='cpu')
      aux['i'] = i
      outs[i] = never(aux, x, t, t_next, None, gumbel, uniform)
  assert torch.equal(outs[STEPS - 1][1], resampled)
  assert not torch.equal(resampled, outs[0][1])
  for i in (0, STEPS - 2):
    aux_next, x_next = outs[i]
    # kept in place: every row holds its own draw
    assert ((x_next == x) | (x == 4)).all()
  assert (outs[STEPS - 1][0]['log_w'] == 0).all()


# ---------------------------------------------------------------------------
# samplers: reuse exactness, schedules, TDS options
# ---------------------------------------------------------------------------

SMALL_B = 32


def test_svdd_pm_posterior_reuse_exact(pair):
  """The carried posterior is an exact reuse: identical samples with and
  without it (``tests/test_sampler.py:95-106`` for the JAX package)."""
  _, tdiff, w = pair
  samples = [tdiff.tweedie_sampler(_torch_reward(w), SMALL_B, sample_M=M,
                                   reuse_posterior=reuse)(
                                       torch.Generator().manual_seed(21)
                                   ).samples for reuse in (True, False)]
  assert torch.equal(*samples)


def test_tds_posterior_reuse_exact(pair):
  _, tdiff, w = pair
  samples = [tdiff.tds_sampler(_torch_reward(w), SMALL_B, alpha=0.5,
                               reuse_posterior=reuse)(
                                   torch.Generator().manual_seed(22)
                               ).samples for reuse in (True, False)]
  assert torch.equal(*samples)


@pytest.mark.parametrize('algo', ['svdd_mc', 'svdd_pm'])
def test_single_phase_m_schedule_is_the_plain_sampler(pair, algo):
  """A one-phase schedule draws as the plain sampler, bit for bit; a
  two-phase one scores M=2 candidates a row for 3 steps, then M=4."""
  _, tdiff, w = pair
  widths = []
  reward = _torch_reward(w)
  if algo == 'svdd_mc':
    score = lambda tok: reward(torch.nn.functional.one_hot(
        torch.where(tok == 4, 0, tok).long(), 4) * (tok != 4)[..., None])
    make = lambda **kw: tdiff.controlled_sampler(
        lambda tok: widths.append(tok.shape[0]) or score(tok), SMALL_B, **kw)
  else:
    make = lambda **kw: tdiff.tweedie_sampler(
        lambda oh: widths.append(oh.shape[0]) or reward(oh), SMALL_B, **kw)
  run = lambda **kw: make(**kw)(torch.Generator().manual_seed(23)).samples
  plain = run(sample_M=M)
  assert torch.equal(plain, run(m_schedule=((STEPS, M),)))
  widths.clear()
  run(m_schedule=((3, 2), (STEPS - 3, M)))
  assert widths == [SMALL_B * 2] * 3 + [SMALL_B * M] * (STEPS - 3)


@pytest.mark.parametrize('phases', [((3, M), (4, M)), ((0, M), (STEPS, M)),
                                    ((-1, M), (STEPS + 1, M))])
def test_bad_phase_lengths_raise(pair, phases):
  _, tdiff, w = pair
  with pytest.raises(ValueError, match='phase lengths'):
    tdiff.tweedie_sampler(_torch_reward(w), SMALL_B, m_schedule=phases)


@pytest.mark.parametrize('spec', [None, '', '64:4,64:10', '128:10', 'a:b',
                                  '64:4:1', '0:4', '4:0', '64'])
def test_parse_m_schedule_matches_svdd_tpu(spec):
  try:
    want = jutils.parse_m_schedule(spec)
  except ValueError as e:
    with pytest.raises(ValueError) as got:
      utils.parse_m_schedule(spec)
    assert str(got.value) == str(e)
  else:
    assert utils.parse_m_schedule(spec) == want


def test_tds_threshold_one_is_the_default_and_ess_trace(pair):
  """ess_threshold = 1.0 fires at every step (ESS <= B always) and draws
  as the default, token for token; the ESS trace has a value in [1, B]
  for every step; an ess_threshold run resamples on its last step."""
  _, tdiff, w = pair
  run = lambda **kw: tdiff.tds_sampler(_torch_reward(w), SMALL_B, alpha=0.5,
                                       **kw)(torch.Generator().manual_seed(24))
  default, one = run(), run(ess_threshold=1.0)
  assert torch.equal(default.samples, one.samples)
  for res in (default, one, run(ess_threshold=0.5)):
    ess = res.extra['ess'].numpy()
    assert ess.shape == (STEPS,) and res.extra['i'] == STEPS
    assert (ess >= 1 - 1e-4).all() and (ess <= SMALL_B + 1e-3).all()
  np.testing.assert_array_equal(default.extra['ess'].numpy(),
                                one.extra['ess'].numpy())


# ---------------------------------------------------------------------------
# whole decodes, by distribution
# ---------------------------------------------------------------------------


def _assert_distributions_agree(got, want, q_tol_scale: float = 0.35):
  ks = sps.ks_2samp(got, want)
  scale = max(np.std(np.concatenate([got, want])), 1e-6)
  q_got = np.quantile(got, [0.5, 0.8])
  q_want = np.quantile(want, [0.5, 0.8])
  assert ks.pvalue > KS_PVAL, (
      f'KS stat {ks.statistic:.3f} p {ks.pvalue:.2g}; q50/q80 port '
      f'{q_got} vs svdd_tpu {q_want}')
  np.testing.assert_allclose(q_got, q_want, atol=q_tol_scale * scale)


@pytest.mark.parametrize('algo', ['svdd_pm', 'tds'])
def test_decode_matches_svdd_tpu_in_distribution(pair, algo):
  """PM (M = 4) and TDS (alpha TDS_ALPHA) at B = 256: the rewards of the
  port's samples and JAX's agree in distribution, and guidance lifts
  the reward over the port's unguided sampler."""
  jdiff, tdiff, w = pair
  if algo == 'svdd_pm':
    jres = jdiff.tweedie_sampler(_jax_reward(w), B, sample_M=M)(
        jax.random.key(5))
    tres = tdiff.tweedie_sampler(_torch_reward(w), B, sample_M=M)(
        torch.Generator().manual_seed(5))
  else:
    jres = jdiff.tds_sampler(_jax_reward(w), B, alpha=TDS_ALPHA)(
        jax.random.key(5))
    tres = tdiff.tds_sampler(_torch_reward(w), B, alpha=TDS_ALPHA)(
        torch.Generator().manual_seed(5))
    ess = tres.extra['ess'].numpy()
    assert np.median(ess) > 0.1 * B, ess
  jtok, ttok = np.asarray(jres.samples), tres.samples.numpy()
  assert (jtok != 4).all() and (ttok != 4).all()
  reward = lambda tok: (_onehot_np(tok) * w).sum(axis=(-1, -2))
  _assert_distributions_agree(reward(ttok), reward(jtok))
  base = tdiff.sampler(B)(torch.Generator().manual_seed(6)).samples.numpy()
  assert reward(ttok).mean() > reward(base).mean()


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------


def _cli_args(parser, tmp_path, *extra):
  return parser.parse_args(
      ['--device', 'cpu', '--batch_size', '4', '--sample_M', '2',
       '--num_steps', '4', '--skip_best_of_n', '--out_dir',
       str(tmp_path), *extra])


def _row(tmp_path, name):
  return json.loads((tmp_path / f'{name}.metrics.jsonl').read_text()
                    .splitlines()[-1])


def _tiny_cfg():
  cfg = tiny_test_config('dna')
  cfg.sampling.steps = 4
  return cfg


@pytest.mark.parametrize('extra', [[], ['--tweedie', 'False'],
                                   ['--m_schedule', '1:1,3:2']])
def test_cli_decode_tweedie_writes_npz_on_cpu(tmp_path, extra):
  decode_tweedie.run(_cli_args(decode_tweedie.parser(), tmp_path, *extra),
                     cfg=_tiny_cfg())
  d = np.load(tmp_path / 'dna-HepG2_tw.npz')
  assert set(d.files) == {'decoding', 'baseline'}
  assert d['decoding'].shape == d['baseline'].shape == (4,)
  row = _row(tmp_path, 'dna-HepG2_tw')
  assert row['algo'] == 'svdd_pm' and row['n'] == 4
  assert row['denoiser_dtype'] == 'float32'
  assert row['tweedie'] == ('False' if '--tweedie' in extra else 'True')
  assert row['m_schedule'] == ([[1, 1], [3, 2]] if '--m_schedule' in extra
                               else None)


@pytest.mark.parametrize('extra', [[], ['--ess_threshold', '0.5']])
def test_cli_decode_tds_writes_npz_and_ess_on_cpu(tmp_path, extra):
  decode_TDS.run(_cli_args(decode_TDS.parser(), tmp_path, *extra),
                 cfg=_tiny_cfg())
  d = np.load(tmp_path / 'dna-HepG2_TDS.npz')
  assert set(d.files) == {'decoding', 'baseline'}
  assert d['decoding'].shape == d['baseline'].shape == (4,)
  row = _row(tmp_path, 'dna-HepG2_TDS')
  assert row['algo'] == 'tds' and row['alpha'] == 0.5
  assert row['ess_threshold'] == (0.5 if extra else None)
  assert len(row['ess_trace']) == 4
  assert 1 <= row['ess_min'] <= row['ess_median'] <= 4 + 1e-3
  assert 'ess_final' in row


def test_cli_decode_m_schedule_on_cpu(tmp_path):
  cli_decode.run(_cli_args(cli_decode.parser(), tmp_path, '--m_schedule',
                           '2:1,2:2'),
                 cfg=_tiny_cfg(), value_kwargs=dict(
                     channels=256, n_conv=3, n_transformers=1, n_heads=2))
  d = np.load(tmp_path / 'dna-HepG2.npz')
  assert d['decoding'].shape == (4,)
  assert _row(tmp_path, 'dna-HepG2')['m_schedule'] == [[2, 1], [2, 2]]
  with pytest.raises(ValueError, match='phase lengths'):
    cli_decode.run(_cli_args(cli_decode.parser(), tmp_path, '--m_schedule',
                             '2:1,3:2'), cfg=_tiny_cfg(),
                   value_kwargs=dict(channels=256, n_conv=3,
                                     n_transformers=1, n_heads=2))


def test_new_port_modules_import_no_jax():
  code = ('import sys, svdd_tpu_torch.cli.decode_tweedie, '
          'svdd_tpu_torch.cli.decode_TDS, svdd_tpu_torch.utils; '
          "bad = [m for m in ('jax', 'flax', 'svdd_tpu') if m in sys.modules]; "
          'assert not bad, bad')
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
