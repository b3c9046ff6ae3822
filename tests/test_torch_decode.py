"""SVDD-MC decoding in svdd_tpu_torch vs svdd_tpu.

One reverse step is pinned exactly given the same denoiser weights and
the same injected Gumbel noise. A whole tiny decode is held to the JAX
decode by distribution (the two packages draw from different random
streams): a two-sample KS test plus q50/q80 agreement within 0.35 of
the pooled standard deviation at 256 samples per side.
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

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.diffusion import build_backbone as jax_build_backbone
from svdd_tpu.sampling import guidance as jguidance
from svdd_tpu.sampling import sampler as jsampler

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.cli import decode as cli_decode
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion, build_backbone
from svdd_tpu_torch.sampling import guidance, sampler
from svdd_tpu_torch.value import build_value_module
from svdd_tpu_torch.weights import cnn_from_jax
from torch_port_helpers import random_cnn_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, STEPS, M = 256, 16, 8, 4
KS_PVAL = 1e-3


@pytest.fixture(scope='module')
def pair():
  """A tiny JAX denoiser, the port holding its weights, and a fixed
  linear value on the one-hot (identical in numpy, torch and jax)."""
  cfg = jax_tiny_config('dna')
  cfg.model.length = L
  cfg.sampling.steps = STEPS
  variables = random_cnn_variables(cfg, np.random.default_rng(0))
  # sharpen the random denoiser so p(x0|xt) is peaked and the decode
  # dynamics (carry-over, the q_xs mass split) matter
  variables['params']['final_1']['kernel'] = (
      3.0 * variables['params']['final_1']['kernel'])
  jdiff = JaxDiffusion(cfg, variables=variables)
  tcfg = tiny_test_config('dna')
  tcfg.model.length = L
  tcfg.sampling.steps = STEPS
  tdiff = Diffusion(tcfg, device='cpu', backbone=cnn_from_jax(variables))
  w = np.random.default_rng(3).normal(size=(L, 4)).astype(np.float32)
  return jdiff, tdiff, w


def _onehot_np(tokens):
  keep = tokens != 4
  return np.eye(4, dtype=np.float32)[np.clip(tokens, 0, 3)] * keep[..., None]


def _jax_value(w):
  wj = jnp.asarray(w)
  return lambda tok: (jax.nn.one_hot(jnp.where(tok == 4, 0, tok), 4)
                      * (tok != 4)[..., None] * wj).sum(axis=(-1, -2))


def _torch_value(w):
  wt = torch.from_numpy(w)
  return lambda tok: (torch.nn.functional.one_hot(
      torch.where(tok == 4, 0, tok).long(), 4)
                      * (tok != 4)[..., None] * wt).sum(dim=(-1, -2))


def _partly_masked(seed, b):
  rs = np.random.default_rng(seed)
  return np.where(rs.random((b, L)) < 0.6, 4,
                  rs.integers(0, 4, (b, L))).astype(np.int32)


def test_svdd_mc_step_pinned_to_svdd_tpu(pair):
  jdiff, tdiff, w = pair
  x = _partly_masked(0, 8)
  t, t_next = np.float32(0.6), np.float32(0.55)
  key = jax.random.key(7)
  jstep = jguidance.svdd_mc_step(jdiff.denoise_fn(), _jax_value(w),
                                 jdiff.schedule, 4, repeats=M)
  _, want = jax.jit(jstep)((), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (8, M, L, 5), jnp.float32))
  tstep = guidance.svdd_mc_step(tdiff.forward, _torch_value(w),
                                tdiff.schedule, 4, repeats=M)
  with torch.no_grad():
    got = tstep(torch.from_numpy(x).long(), torch.tensor(t),
                torch.tensor(t_next), None, gumbel=torch.from_numpy(noise))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ddpm_step_and_noise_removal_pinned_to_svdd_tpu(pair):
  jdiff, tdiff, _ = pair
  x = _partly_masked(1, 8)
  t, t_next = np.float32(0.3), np.float32(0.2)
  key = jax.random.key(8)
  jstep = jsampler.ddpm_step(jdiff.denoise_fn(), jdiff.schedule, 4)
  _, want = jax.jit(jstep)((), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (8, L, 5), jnp.float32))
  tstep = sampler.ddpm_step(tdiff.forward, tdiff.schedule, 4)
  xt = torch.from_numpy(x).long()
  with torch.no_grad():
    got = tstep(xt, torch.tensor(t), torch.tensor(t_next), None,
                gumbel=torch.from_numpy(noise))
    got_rm = sampler.argmax_noise_removal(tdiff.forward, tdiff.schedule,
                                          xt, torch.tensor(t))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  # jitted: eager dispatch compiles every op on its own
  want_rm = jax.jit(lambda xj, tj: jsampler.argmax_noise_removal(
      jdiff.denoise_fn(), jdiff.schedule, xj, tj))(jnp.asarray(x),
                                                   jnp.asarray(t))
  np.testing.assert_array_equal(got_rm.numpy(), np.asarray(want_rm))


def _assert_distributions_agree(got, want, q_tol_scale: float = 0.35):
  ks = sps.ks_2samp(got, want)
  scale = max(np.std(np.concatenate([got, want])), 1e-6)
  q_got = np.quantile(got, [0.5, 0.8])
  q_want = np.quantile(want, [0.5, 0.8])
  assert ks.pvalue > KS_PVAL, (
      f'KS stat {ks.statistic:.3f} p {ks.pvalue:.2g}; q50/q80 port '
      f'{q_got} vs svdd_tpu {q_want}')
  np.testing.assert_allclose(q_got, q_want, atol=q_tol_scale * scale)


def test_svdd_mc_decode_matches_svdd_tpu_in_distribution(pair):
  jdiff, tdiff, w = pair
  jtok = np.asarray(jdiff.controlled_sampler(
      _jax_value(w), B, sample_M=M, num_steps=STEPS)(
          jax.random.key(5)).samples)
  ttok = tdiff.controlled_sampler(_torch_value(w), B, sample_M=M,
                                  num_steps=STEPS)(
                                      torch.Generator().manual_seed(5)
                                  ).samples.numpy()
  assert (jtok != 4).all() and (ttok != 4).all()
  reward = lambda tok: (_onehot_np(tok) * w).sum(axis=(-1, -2))
  _assert_distributions_agree(reward(ttok), reward(jtok))
  # guidance lifts the value over the unguided port sampler
  base = tdiff.sampler(B, num_steps=STEPS)(
      torch.Generator().manual_seed(6)).samples.numpy()
  assert reward(ttok).mean() > reward(base).mean()


def _cli_args(tmp_path, *extra):
  return common.make_parser('test').parse_args(
      ['--device', 'cpu', '--batch_size', '4', '--sample_M', '2',
       '--num_steps', '4', '--skip_best_of_n', '--out_dir',
       str(tmp_path), *extra])


def test_cli_decode_writes_npz_on_cpu(tmp_path):
  cfg = tiny_test_config('dna')
  cfg.sampling.steps = 4
  cli_decode.run(_cli_args(tmp_path), cfg=cfg, value_kwargs=dict(
      channels=256, n_conv=3, n_transformers=1, n_heads=2))
  d = np.load(tmp_path / 'dna-HepG2.npz')
  assert set(d.files) == {'decoding', 'baseline'}
  assert d['decoding'].shape == d['baseline'].shape == (4,)
  rows = (tmp_path / 'dna-HepG2.metrics.jsonl').read_text().splitlines()
  row = json.loads(rows[-1])
  assert row['algo'] == 'svdd_mc' and row['n'] == 4
  assert 'decoding/q50' in row and 'baseline/mean' in row


def test_cli_rejects_checkpoint_flags(tmp_path):
  args = _cli_args(tmp_path, '--load_checkpoint_path', 'value.pt')
  with pytest.raises(NotImplementedError, match='checkpoint'):
    cli_decode.run(args)


TINY_VALUE = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2)
BF16_SWITCHES = ('SVDD_CNN_BF16', 'SVDD_VALUE_BF16')


@pytest.mark.parametrize('value', [None, '0'])
def test_bf16_switches_unset_or_zero_build_f32(value, monkeypatch):
  """Unset or '0', the switches leave both builders in float32, as
  svdd_tpu builds its modules then; an explicit compute_dtype wins over
  SVDD_VALUE_BF16=1, as in svdd_tpu."""
  for var in BF16_SWITCHES:
    if value is None:
      monkeypatch.delenv(var, raising=False)
    else:
      monkeypatch.setenv(var, value)
  assert jax_build_backbone(jax_tiny_config('dna')).compute_dtype == \
      jnp.float32
  gen = torch.Generator().manual_seed(0)
  models = [build_backbone(tiny_test_config('dna'), gen),
            build_value_module('dna', generator=gen, **TINY_VALUE)]
  assert models[1].compute_dtype == torch.float32
  monkeypatch.setenv('SVDD_VALUE_BF16', '1')
  models.append(build_value_module('dna', generator=gen,
                                   compute_dtype=torch.float32,
                                   **TINY_VALUE))
  for model in models:
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_port_imports_no_jax():
  code = ('import sys, chip_smoke, svdd_tpu_torch.cli.decode, '
          'svdd_tpu_torch.cli.decode_DPS, svdd_tpu_torch.cli.decode_DG, '
          'svdd_tpu_torch.cli.decode_classfier, svdd_tpu_torch.weights, '
          'svdd_tpu_torch.cli.main_gosai, svdd_tpu_torch.models.dit, '
          'svdd_tpu_torch.models.autoregressive, '
          'svdd_tpu_torch.models.dimamba, svdd_tpu_torch.ops.attention, '
          'svdd_tpu_torch.ops.flash_attention, svdd_tpu_torch.ops.norms, '
          'svdd_tpu_torch.eval.gen_ppl, svdd_tpu_torch.data.gosai, '
          'svdd_tpu_torch.ops.im2col, svdd_tpu_torch.ops.fused_conv, '
          'svdd_tpu_torch.models.convgru, svdd_tpu_torch.models.basenji, '
          'svdd_tpu_torch.train.diffusion, svdd_tpu_torch.models.ema, '
          'svdd_tpu_torch.eval.validation, svdd_tpu_torch.eval.metrics, '
          'svdd_tpu_torch.observability, svdd_tpu_torch.utils, '
          'svdd_tpu_torch.checkpoint, svdd_tpu_torch.importers, '
          'svdd_tpu_torch.models.multisep, svdd_tpu_torch.cli.train, '
          'svdd_tpu_torch.sampling.semi_ar, svdd_tpu_torch.data.text, '
          'svdd_tpu_torch.diffusion; '
          "bad = [m for m in ('jax', 'flax', 'optax', 'orbax', 'svdd_tpu') "
          'if m in sys.modules]; '
          'assert not bad, bad')
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
