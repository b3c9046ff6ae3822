"""The RNA saluki stability task (``--task rna_saluki``) of svdd_tpu_torch
against svdd_tpu on the CPU: the padded six-channel input builder, the
six-channel ConvGRU oracle (through ``convgru_from_jax``, and as an
export of the JAX package's checkpoint through
``--reward_checkpoint_path``), the saluki branch of ``svdd_pm_step`` on
JAX's Gumbel noise, the reward transform and the trainers' saluki
targets, ``load_saluki_body``, and the CLIs under ``--task rna_saluki``.

Tiny sizes: L=16, the saluki input padded to 40 rows (64 for the
oracle), batch <= 8, steps <= 4; the oracle and value nets at the
ConvGRU's own widths. Float32 with TF32 off. Tolerances: the input
builder bit for bit; the oracle and the targets 1e-4 relative, 1e-5
absolute; the PM step's chosen tokens exactly.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import mdlm as jmdlm
from svdd_tpu import value as jvalue
from svdd_tpu.checkpoint import save_pytree
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.rewards import RewardOracle as JaxOracle
from svdd_tpu.sampling import guidance as jguidance

from svdd_tpu_torch import mdlm, rewards
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import (common, decode, decode_classfier, decode_DG,
                                decode_DPS, decode_TDS, decode_tweedie)
from svdd_tpu_torch.cli import train as cli_train
from svdd_tpu_torch.cli import train_oracle
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.sampling import guidance
from svdd_tpu_torch.train import value as train_value
from svdd_tpu_torch.weights import cnn_from_jax, convgru_from_jax
from torch_port_helpers import jax_cli_common, perturb, random_cnn_variables

jcommon = jax_cli_common()

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, F, F_ORACLE, LB, M, B = 16, 40, 64, 12, 3, 6
OUT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
  """Tiny tensors: one intra-op thread keeps torch from spinning its
  threads against the other test workers'."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.array(a))


def _tokens(seed, n=B, length=L, p_mask=0.3):
  rs = np.random.default_rng(seed)
  return np.where(rs.random((n, length)) < p_mask, 4,
                  rs.integers(0, 4, (n, length))).astype(np.int32)


def _body(seed=0, rows=LB):
  return np.random.default_rng(seed).normal(size=(rows, 6)).astype(
      np.float32)


# ---------------------------------------------------------------------------
# the input builder and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('body_rows,final', [(None, F), (LB, F), (LB, 20)],
                         ids=['no_body', 'body', 'cut'])
def test_transform_samples_saluki_matches_svdd_tpu(body_rows, final):
  """One-hot (MASK rows zero), two zero channels, the body behind, zeros
  to ``final`` rows or cut there: bit for bit JAX's."""
  x = _tokens(0)
  body = None if body_rows is None else _body(rows=body_rows)
  want = jmdlm.transform_samples_saluki(
      jnp.asarray(x), None if body is None else jnp.asarray(body),
      final_length=final)
  got = mdlm.transform_samples_saluki(
      _t(x), None if body is None else _t(body), final_length=final)
  assert got.shape == (B, final, 6) and got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transform_samples_saluki_at_full_length():
  """At the oracle's 12,288 rows: the sequence, then the body, then
  zeros."""
  x = _tokens(1, n=2, length=50)
  body = _body(rows=300)
  got = mdlm.transform_samples_saluki(_t(x), _t(body)).numpy()
  assert got.shape == (2, 12288, 6)
  np.testing.assert_array_equal(got[:, :50, :4],
                                mdlm.transform_samples(_t(x)).numpy())
  assert (got[:, :50, 4:] == 0).all()
  np.testing.assert_array_equal(got[:, 50:350], np.broadcast_to(
      body, (2, 300, 6)))
  assert (got[:, 350:] == 0).all()


@pytest.fixture(scope='module')
def oracle_pair():
  """JAX's saluki oracle (``RewardOracle.create_saluki`` at 64 rows, its
  biases, scales and batch statistics perturbed) and its variables."""
  joracle = JaxOracle.create_saluki(jax.random.key(0), final_length=F_ORACLE)
  variables = perturb(jax.tree.map(np.asarray, joracle.variables),
                      np.random.default_rng(1))
  joracle.variables = jax.tree.map(jnp.asarray, variables)
  return joracle, variables


def _oracle_input(seed, n=4):
  return mdlm.transform_samples_saluki(_t(_tokens(seed, n=n)),
                                       _t(_body(seed)),
                                       final_length=F_ORACLE)


def test_saluki_oracle_matches_svdd_tpu(oracle_pair):
  """The six-channel ConvGRU through ``convgru_from_jax`` (its stem's
  input channels read from the kernel) on saluki inputs; the port's own
  ``create_saluki`` builds the same architecture."""
  joracle, variables = oracle_pair
  x = _oracle_input(2)
  model = convgru_from_jax(variables)
  assert model.in_channels == 6
  oracle = rewards.RewardOracle(model)
  with torch.no_grad():
    got = oracle(x)
  np.testing.assert_allclose(got.numpy(), np.asarray(joracle(jnp.asarray(
      x.numpy()))), **OUT_TOL)
  fresh = rewards.RewardOracle.create_saluki(torch.Generator().manual_seed(0))
  assert fresh.module.in_channels == 6
  assert {k: v.shape for k, v in fresh.module.state_dict().items()} == {
      k: v.shape for k, v in model.state_dict().items()}


def _saluki_args(*extra):
  return decode.parser().parse_args(['--task', 'rna_saluki', '--device',
                                     'cpu', *extra])


def test_saluki_oracle_export_reads_through_the_flag(oracle_pair, tmp_path):
  """JAX's saluki oracle saved with ``save_pytree`` and exported by
  ``scripts/export_jax_checkpoint.py`` unchanged: ``--reward_checkpoint
  _path`` gives the six-channel ConvGRU with JAX's outputs; a
  four-channel ConvGRU file (``cli.train_oracle --task rna_saluki``'s)
  is refused naming the six channels."""
  joracle, variables = oracle_pair
  spec = importlib.util.spec_from_file_location(
      'export_jax_checkpoint',
      os.path.join(REPO, 'scripts', 'export_jax_checkpoint.py'))
  export = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(export)
  src, out = str(tmp_path / 'oracle'), str(tmp_path / 'oracle.npz')
  save_pytree(src, joracle.variables)
  assert export.main([src, out]) == 0
  oracle = common.load_reward_fn(
      _saluki_args('--reward_checkpoint_path', out), None)
  x = _oracle_input(3)
  with torch.no_grad():
    got = oracle(x)
  np.testing.assert_allclose(got.numpy(), np.asarray(joracle(jnp.asarray(
      x.numpy()))), **OUT_TOL)
  four = str(tmp_path / 'four.pt')
  value_lib.save_checkpoint(four, rewards.RewardOracle.create_rna(
      torch.Generator().manual_seed(0)).module)
  with pytest.raises(ValueError, match='saluki oracle takes 6'):
    common.load_reward_fn(_saluki_args('--reward_checkpoint_path', four),
                          None)


# ---------------------------------------------------------------------------
# the SVDD-PM step's saluki branch
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def pm_pair():
  """A tiny JAX denoiser at L=16, the port holding its weights, and a
  fixed linear reward on the (N, F, 6) saluki input."""
  cfg = jax_tiny_config('dna')
  cfg.model.length = L
  variables = random_cnn_variables(cfg, np.random.default_rng(0))
  variables['params']['final_1']['kernel'] = (
      3.0 * variables['params']['final_1']['kernel'])
  jdiff = JaxDiffusion(cfg, variables=variables)
  tcfg = tiny_test_config('dna')
  tcfg.model.length = L
  tdiff = Diffusion(tcfg, device='cpu', backbone=cnn_from_jax(variables))
  w = np.random.default_rng(3).normal(size=(F, 6)).astype(np.float32)
  return jdiff, tdiff, w


@pytest.mark.parametrize('tweedie', [True, False],
                         ids=['tweedie', 'heuristic'])
def test_svdd_pm_step_saluki_matches_svdd_tpu(pm_pair, tweedie):
  """The step rebuilds tokens from the (Tweedie-merged, or masked-zeroed)
  one-hot, a zero row being MASK, and scores their saluki input with the
  body: the same winners as JAX's on JAX's Gumbel noise."""
  jdiff, tdiff, w = pm_pair
  x = _tokens(4, p_mask=0.6)
  body = _body(5)
  t, t_next = np.float32(0.6), np.float32(0.55)
  key = jax.random.key(7)
  wj, wt = jnp.asarray(w), torch.from_numpy(w)
  jstep = jguidance.svdd_pm_step(
      jdiff.denoise_fn(), lambda oh: (oh * wj).sum(axis=(-1, -2)),
      jdiff.schedule, 4, repeats=M, tweedie=tweedie, task='rna_saluki',
      saluki_body=jnp.asarray(body), saluki_final_length=F)
  _, want = jax.jit(jstep)((), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (B, M, L, 5), jnp.float32))
  seen = []

  def reward(oh):
    seen.append(tuple(oh.shape))
    return (oh * wt).sum(dim=(-1, -2))

  tstep = guidance.svdd_pm_step(tdiff.forward, reward, tdiff.schedule, 4,
                                repeats=M, tweedie=tweedie,
                                task='rna_saluki', saluki_body=_t(body),
                                saluki_final_length=F)
  with torch.no_grad():
    _, got = tstep((), _t(x).long(), torch.tensor(t), torch.tensor(t_next),
                   None, gumbel=_t(noise))
  assert seen == [(B * M, F, 6)]
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the reward transform and the trainers' targets
# ---------------------------------------------------------------------------


def _linear_reward(w, lib):
  if lib is torch:
    wt = torch.from_numpy(w)
    return lambda oh: (oh * wt).sum(dim=(-1, -2))
  wj = jnp.asarray(w)
  return lambda oh: (oh * wj).sum(axis=(-1, -2))


def test_reward_transform_and_targets_match_svdd_tpu():
  """``make_reward_transform('rna_saluki', body, F)`` is JAX's builder;
  the MC and CD-Q targets route the final reward through it while the
  value-net states stay (N, L, 4) one-hots."""
  body = _body(6)
  w = np.random.default_rng(7).normal(size=(F, 6)).astype(np.float32)
  wv = np.random.default_rng(8).normal(size=(L, 4)).astype(np.float32)
  samples = _tokens(9, p_mask=0.0)
  mid_x = np.stack([_tokens(10 + s) for s in range(3)])
  cands = np.stack([_tokens(20 + s, n=B * 2).reshape(B, 2, L)
                    for s in range(4)])
  jt = jvalue.make_reward_transform('rna_saluki', jnp.asarray(body), F)
  tt = value_lib.make_reward_transform('rna_saluki', _t(body), F)
  np.testing.assert_array_equal(tt(_t(samples)).numpy(),
                                np.asarray(jt(jnp.asarray(samples))))
  want = jvalue.mc_targets(jnp.asarray(samples), jnp.asarray(mid_x),
                           _linear_reward(w, jnp), reward_transform=jt)
  got = value_lib.mc_targets(_t(samples), _t(mid_x),
                             _linear_reward(w, torch), reward_transform=tt)
  assert got.onehots.shape == ((3 + 1) * B, L, 4)
  np.testing.assert_array_equal(got.onehots.numpy(),
                                np.asarray(want.onehots))
  np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                             **OUT_TOL)
  want = jvalue.cdq_targets(jnp.asarray(samples), jnp.asarray(mid_x),
                            jnp.asarray(cands), _linear_reward(w, jnp),
                            _linear_reward(wv, jnp), reward_transform=jt)
  got = value_lib.cdq_targets(_t(samples), _t(mid_x), _t(cands),
                              _linear_reward(w, torch),
                              _linear_reward(wv, torch), tt)
  np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                             **OUT_TOL)


def test_value_trainer_routes_saluki_targets(pm_pair):
  """``ValueTrainer`` (MC and CD-Q) and ``build_eval_timestep_batches``
  at ``task='rna_saluki'`` hand the oracle the saluki input of the final
  samples (its body and ``saluki_final_length``) and the value net the
  four-channel states."""
  _, tdiff, w = pm_pair
  body = _t(_body(11))
  seen = []

  def reward(oh):
    seen.append(tuple(oh.shape))
    return _linear_reward(w, torch)(oh)

  vf = value_lib.ValueFunction.create('rna_saluki', L,
                                      torch.Generator().manual_seed(0))
  assert vf.module.in_channels == 4
  samples, mid_x = _t(_tokens(12, p_mask=0.0)).long(), _t(
      np.stack([_tokens(13 + s) for s in range(3)])).long()
  for cdq in (False, True):
    tcfg = train_value.ValueTrainerConfig(task='rna_saluki', cdq=cdq,
                                          batch_size=B,
                                          saluki_final_length=F)
    trainer = train_value.ValueTrainer(tdiff, vf, reward, tcfg, body)
    state = trainer.init_state(0)
    cands = (torch.stack([samples[:, None].expand(B, 10, L)] * 4)
             if cdq else None)
    batch = trainer.targets(state, samples, mid_x, cands)
    assert batch.onehots.shape[1:] == (L, 4)
    want = reward(mdlm.transform_samples_saluki(samples, body,
                                                final_length=F))
    torch.testing.assert_close(batch.targets[-B:], want)
  gen = torch.Generator().manual_seed(0)
  batches, targets = train_value.build_eval_timestep_batches(
      tdiff, reward, B, 1, gen, task='rna_saluki', saluki_body=body,
      saluki_final_length=F)
  assert batches[-1].shape == (B, L, 4) and targets[-1].shape == (B,)
  assert set(seen) == {(B, F, 6)}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case', ['path', 'index', 'none'])
def test_load_saluki_body_matches_svdd_tpu(case, tmp_path, monkeypatch):
  """``--saluki_body_path`` wins over ``--saluki_body``; the index reads
  ``saluki_body_{N}.npy`` under ``$SVDD_DATA_DIR``; neither gives None.
  The values are JAX's, as float32."""
  body = _body(14)
  np.save(tmp_path / 'saluki_body_2.npy', body)
  np.save(tmp_path / 'other.npy', 2 * body)
  monkeypatch.setenv('SVDD_DATA_DIR', str(tmp_path))
  argv = {'path': ['--saluki_body', '2', '--saluki_body_path',
                   str(tmp_path / 'other.npy')],
          'index': ['--saluki_body', '2'], 'none': []}[case]
  got = common.load_saluki_body(_saluki_args(*argv))
  want = jcommon.load_saluki_body(jcommon.make_parser('x').parse_args(
      ['--task', 'rna_saluki', *argv]))
  if case == 'none':
    assert got is None and want is None
    return
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  np.testing.assert_array_equal(got.numpy(),
                                2 * body if case == 'path' else body)


def test_saluki_flags_and_task_config_match_svdd_tpu():
  """The saluki flags' defaults are JAX's; ``task_config`` takes the RNA
  preset (L=50) with the task rna_saluki."""
  got, want = _saluki_args(), jcommon.make_parser('x').parse_args(
      ['--task', 'rna_saluki'])
  for k in ('saluki_body', 'saluki_body_path', 'saluki_final_length'):
    assert getattr(got, k) == getattr(want, k), k
  cfg, jcfg = common.task_config(got), jcommon.task_config(want)
  assert (cfg.task, cfg.model.length) == (jcfg.task, jcfg.model.length) == (
      'rna_saluki', 50)


@pytest.mark.parametrize('cli', ['dps', 'dg', 'tds', 'classifier'])
def test_gradient_and_smc_decoders_refuse_saluki(cli):
  """DPS, DG, TDS and classifier guidance exit with JAX's message, before
  any model is built."""
  run, p = {'dps': (decode_DPS.run, decode_DPS.parser()),
            'dg': (decode_DPS.run, decode_DG.parser()),
            'tds': (decode_TDS.run, decode_TDS.parser()),
            'classifier': (decode_classfier.run,
                           decode_classfier.parser())}[cli]
  with pytest.raises(SystemExit, match='does not support --task rna_saluki'):
    run(p.parse_args(['--task', 'rna_saluki', '--device', 'cpu']))


def _cfg(steps=4):
  cfg = tiny_test_config('rna_saluki')
  cfg.model.length = L
  cfg.sampling.steps = steps
  return cfg


@pytest.fixture(scope='module')
def body_path(tmp_path_factory):
  path = tmp_path_factory.mktemp('saluki') / 'body.npy'
  np.save(path, _body(15))
  return str(path)


@pytest.mark.parametrize('cli', ['decode', 'decode_tweedie'])
def test_saluki_decodes_write_the_npz(cli, body_path, tmp_path, caplog):
  """``cli.decode`` (SVDD-MC, the ConvGRU value net) and
  ``cli.decode_tweedie`` (SVDD-PM) at ``--task rna_saluki``: the saluki
  oracle, random with JAX's warning, scores the saluki input; the npz is
  JAX's ``rna_saluki-<reward>[_tw].npz`` with 'decoding' and
  'baseline'."""
  run, p, suffix = {'decode': (decode.run, decode.parser(), ''),
                    'decode_tweedie': (decode_tweedie.run,
                                       decode_tweedie.parser(), '_tw')}[cli]
  args = p.parse_args(
      ['--task', 'rna_saluki', '--device', 'cpu', '--batch_size', '4',
       '--sample_M', '2', '--num_steps', '4', '--skip_best_of_n',
       '--saluki_body_path', body_path, '--saluki_final_length',
       str(F_ORACLE), '--out_dir', str(tmp_path)])
  with caplog.at_level('WARNING'):
    report = run(args, cfg=_cfg())
  assert 'saluki oracle is randomly initialized' in caplog.text
  path = tmp_path / f'rna_saluki-HepG2{suffix}.npz'
  with np.load(path) as z:
    assert sorted(z.files) == ['baseline', 'decoding']
    assert z['decoding'].shape == (4,) and np.isfinite(z['decoding']).all()
  assert report['decoding']['n'] == 4


def test_saluki_value_training_and_oracle_cli(body_path, tmp_path):
  """``cli.train --task rna_saluki`` (MC, 2 iterations, an evaluation)
  trains the four-channel ConvGRU on the saluki oracle's targets;
  ``cli.train_oracle --task rna_saluki`` trains the four-channel
  ConvGRU, as JAX's CLI builds it (at ``--length 16`` here; its default
  L=50 is held in ``tests/test_torch_value_cli.py``)."""
  out = cli_train.run(cli_train.parser().parse_args(
      ['--task', 'rna_saluki', '--device', 'cpu', '--batch_size', '2',
       '--max_iters', '2', '--eval_every', '2', '--val_batch_num', '1',
       '--saluki_body_path', body_path, '--saluki_final_length',
       str(F_ORACLE), '--out_dir', str(tmp_path), '--save_path',
       str(tmp_path / 'value.pt')]), cfg=_cfg())
  assert out['state'].step == 2 and out['state'].module.in_channels == 4
  assert value_lib.load_checkpoint(str(tmp_path / 'value.pt'),
                                   task='rna_saluki')['task'] == 'rna'
  no_data = tmp_path / 'no_data'
  no_data.mkdir()
  res = train_oracle.run(train_oracle.parser().parse_args(
      ['--task', 'rna_saluki', '--length', str(L), '--batch_size', '4',
       '--max_iters', '2', '--device', 'cpu', '--data_dir', str(no_data),
       '--save_path', str(tmp_path / 'oracle.pt')]))
  assert res['module'].in_channels == 4
  assert np.isfinite(res['val_pearson'])
  ckpt = value_lib.load_checkpoint(str(tmp_path / 'oracle.pt'))
  assert ckpt['config']['in_channels'] == 4
