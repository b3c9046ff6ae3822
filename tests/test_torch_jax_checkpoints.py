"""The JAX package's orbax checkpoints in svdd_tpu_torch, through
``scripts/export_jax_checkpoint.py``'s ``.npz``.

JAX writes each kind at a tiny size (its own ``save_checkpoint``,
``save_pytree`` and trainers' ``save_state``), the script exports it, the
port reads the export through its checkpoint flags, and its models'
outputs are held to JAX's on the same inputs (f32, the tolerances
stated per test). An orbax directory itself still raises, naming the
script.
"""

import importlib.util
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.checkpoint import save_pytree
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.eval import gen_ppl as jgen
from svdd_tpu.models.autoregressive import ARModel as JaxAR
from svdd_tpu.models.convgru import ConvGRUValueModel as JaxConvGRU
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer
from svdd_tpu.train import diffusion as jtrain
from svdd_tpu.train import value as jtrain_value

from svdd_tpu_torch import checkpoint as ckpt_lib
from svdd_tpu_torch import weights
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.cli import decode as cli_decode
from svdd_tpu_torch.cli import main_gosai
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.eval import gen_ppl as tgen
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import random_cnn_variables, random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 16
TINY = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2)
# the tiny DNA config's fields as main_gosai's --set takes them (the
# export builds its state template from them, as main_gosai builds it)
TINY_SET = ['model.length=16', 'model.hidden_dim=32', 'model.num_cnn_stacks=1',
            'model.hidden_size=32', 'model.cond_dim=16', 'model.n_blocks=2',
            'model.n_heads=2', 'parallel.precision=fp32']


def _export_script():
  spec = importlib.util.spec_from_file_location(
      'export_jax_checkpoint',
      os.path.join(REPO, 'scripts', 'export_jax_checkpoint.py'))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


EXPORT = _export_script()


def _t(a):
  return torch.from_numpy(np.array(a))


def _configs(backbone):
  jcfg, cfg = jax_tiny_config('dna'), tiny_test_config('dna')
  for c in (jcfg, cfg):
    c.model.length = L
    c.backbone = backbone
    c.optim.warmup_steps = 0
  return jcfg, cfg


@pytest.mark.parametrize('backbone', ['cnn', 'dit'])
def test_pretraining_state_exports_to_the_denoiser_flags(backbone,
                                                         tmp_path):
  """A JAX pretraining run's ``--ckpt_dir`` (one compiled train step, so
  the EMA shadow differs from the parameters): the export holds the EMA
  weights and extras; ``--diffusion_checkpoint_path`` and a
  ``main_gosai --ckpt_dir`` holding the export give the denoiser whose
  log-probs equal JAX's forward on those weights (f32, 1e-5); sample_eval
  and ppl_eval run from it and a train run refuses it."""
  jcfg, cfg = _configs(backbone)
  rs = np.random.default_rng(0)
  if backbone == 'cnn':
    variables = random_cnn_variables(jcfg, rs)
  else:
    shapes_model = JaxDiffusion(jcfg, variables={})
    variables = random_variables(shapes_model.backbone.init,
                                 jnp.zeros((1, L), jnp.int32),
                                 jnp.zeros((1,)), rs=rs)
  jmodel = JaxDiffusion(jcfg, variables=jax.tree.map(jnp.asarray, variables))
  state = jtrain.init_state(jmodel, jcfg, jax.random.key(1))
  batch = {'seqs': jnp.asarray(rs.integers(0, 4, (8, L)), jnp.int32)}
  state, _ = jax.jit(jtrain.make_train_step(jmodel, jcfg))(state, batch)
  ckpt_dir = str(tmp_path / 'jax_ckpt')
  jtrain.save_checkpoint(ckpt_dir, state)
  out = str(tmp_path / 'export' / 'denoiser.npz')
  set_ = TINY_SET + [f'backbone={backbone}']
  assert EXPORT.main([ckpt_dir, out, '--task', 'dna', '--set', *set_]) == 0
  e = ckpt_lib.load_export(out)
  assert e.kind == 'diffusion' and e.meta['step'] == 1
  assert e.meta['config']['backbone'] == backbone
  ema = {'params': state.ema.shadow, **state.extras}
  x = rs.integers(0, 5, (3, L)).astype(np.int32)
  sigma = rs.uniform(0, 2, 3).astype(np.float32)
  want = np.asarray(jmodel.forward(ema, jnp.asarray(x), jnp.asarray(sigma)))
  args = cli_decode.parser().parse_args(
      ['--device', 'cpu', '--diffusion_checkpoint_path', out])
  common.reject_unported(args)
  model = common.load_diffusion(args, cfg)
  with torch.no_grad():
    got = model.forward(_t(x).long(), _t(sigma)).numpy()
  fin = np.isfinite(want)
  assert (np.isfinite(got) == fin).all()
  np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
  assert not all(np.allclose(a, b) for a, b in zip(
      jax.tree.leaves(state.params), jax.tree.leaves(state.ema.shadow)))
  # main_gosai reads the export held in its --ckpt_dir
  cfg.loader.eval_batch_size = 4
  cfg.sampling.num_sample_batches = 1
  cfg.sampling.steps = 4
  export_dir = os.path.dirname(out)
  base = ['--device', 'cpu', '--ckpt_dir', export_dir]
  res = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', *base]), cfg)
  assert res['tokens'].shape == (4, L)
  ppl = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'ppl_eval', *base]), cfg)
  assert np.isfinite(ppl['nll'])
  with pytest.raises(ValueError, match='trainer state'):
    main_gosai.run(main_gosai.parser().parse_args(
        ['--mode', 'train', '--max_steps', '1', *base]), cfg)


def _enformer(seed, n_tasks=1):
  jm = JaxEnformer(n_tasks=n_tasks, **TINY)
  return jm, random_variables(jm.init, jnp.zeros((1, L, 4)),
                              rs=np.random.default_rng(seed))


def _onehots(seed, n=4):
  rs = np.random.default_rng(seed)
  return np.eye(4, dtype=np.float32)[rs.integers(0, 4, (n, L))]


def _export(tmp_path, name, tree_or_dir, *extra, save=True):
  src = str(tmp_path / name)
  if save:
    save_pytree(src, tree_or_dir)
  out = str(tmp_path / f'{name}.npz')
  assert EXPORT.main([src, out, *extra]) == 0
  return out


def test_value_net_and_oracle_exports_read_through_the_flags(tmp_path):
  """A ``cli.train --save_path`` tree (the Enformer's params and batch
  stats) through ``--load_checkpoint_path``, a 3-task oracle through
  ``--reward_checkpoint_path``: the port's nets at the file's widths
  give JAX's outputs (f32, 1e-5 relative to the largest); the other
  task's flag refuses them."""
  jm, variables = _enformer(1)
  path = _export(tmp_path, 'value', variables)
  assert ckpt_lib.load_export(path).kind == 'variables'
  x = _onehots(2)
  want = np.asarray(jm.apply(variables, jnp.asarray(x)))
  args = cli_decode.parser().parse_args(['--device', 'cpu',
                                         '--load_checkpoint_path', path])
  common.reject_unported(args)
  cfg = tiny_test_config('dna')
  cfg.model.length = L
  vf = common.load_value_function(args, cfg)
  with torch.no_grad():
    got = vf.module(_t(x)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())
  jo, ovars = _enformer(3, n_tasks=3)
  opath = _export(tmp_path, 'oracle', ovars)
  args = cli_decode.parser().parse_args(['--device', 'cpu',
                                         '--reward_checkpoint_path', opath])
  oracle = common.load_reward_fn(args, cfg)
  want = np.asarray(jo.apply(ovars, jnp.asarray(x)))[:, 0]
  with torch.no_grad():
    got = oracle(_t(x)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())
  args = cli_decode.parser().parse_args(
      ['--device', 'cpu', '--task', 'rna', '--load_checkpoint_path', path])
  with pytest.raises(ValueError, match='dna value net'):
    common.reject_unported(args)


def test_convgru_oracle_export_for_the_rna_task(tmp_path):
  """The RNA task's ConvGRU oracle tree through ``--reward_checkpoint_path
  --task rna`` (and main_gosai's ``--eval_oracle_checkpoint_path``
  check): JAX's outputs, f32 1e-5."""
  jm = JaxConvGRU()
  variables = random_variables(jm.init, jnp.zeros((1, L, 4)),
                               rs=np.random.default_rng(4))
  path = _export(tmp_path, 'gru', variables)
  x = _onehots(5)
  want = np.asarray(jm.apply(variables, jnp.asarray(x))).reshape(-1)
  args = cli_decode.parser().parse_args(
      ['--device', 'cpu', '--task', 'rna', '--reward_checkpoint_path', path])
  common.reject_unported(args)
  cfg = tiny_test_config('rna')
  oracle = common.load_reward_fn(args, cfg)
  with torch.no_grad():
    got = oracle(_t(x)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())


def test_trainer_states_export_their_nets(tmp_path):
  """A ``ValueTrainer.save_state`` tree exports as its net's variables
  (step and tokens in the meta), read by ``--load_checkpoint_path``; a
  ``MultiSepTrainer.save_state`` tree and a stacked multisep model export
  their stacked variables, each trunk through
  ``weights.multisep_from_jax`` equal to JAX's trunk (f32, 1e-5)."""
  jm, variables = _enformer(6)
  params = variables['params']
  extras = {k: v for k, v in variables.items() if k != 'params'}
  opt = optax.adamw(1e-3)
  vstate = jtrain_value.ValueTrainState(
      jnp.asarray(7), params, extras, opt.init(params), jax.random.key(0),
      jnp.asarray(1234))
  src = str(tmp_path / 'vstate')
  jtrain_value.ValueTrainer.save_state(None, src, vstate)
  path = _export(tmp_path, 'vstate', None, save=False)
  e = ckpt_lib.load_export(path)
  assert e.kind == 'value_state' and e.meta['step'] == 7
  assert e.meta['tokens'] == 1234
  x = _onehots(7)
  want = np.asarray(jm.apply(variables, jnp.asarray(x)))
  args = cli_decode.parser().parse_args(['--device', 'cpu',
                                         '--load_checkpoint_path', path])
  cfg = tiny_test_config('dna')
  cfg.model.length = L
  with torch.no_grad():
    got = common.load_value_function(args, cfg).module(_t(x)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())
  _, other = _enformer(8)
  stacked = jax.tree.map(lambda a, b: np.stack([a, b]), variables, other)
  mstate = (jnp.asarray(3), stacked, opt.init(stacked['params']),
            jax.random.key(1))
  jtrain_value.MultiSepTrainer.save_state(None, str(tmp_path / 'mstate'),
                                          mstate)
  for name, kind, extra in (('mstate', 'multisep_state', ()),
                            ('msep', 'multisep', ('--kind', 'multisep'))):
    if name == 'msep':
      save_pytree(str(tmp_path / name), stacked)
    e = ckpt_lib.load_export(_export(tmp_path, name, None, *extra,
                                     save=False))
    assert e.kind == kind
    trunks = weights.multisep_from_jax(e.tree)
    for trunk, v in zip(trunks, (variables, other)):
      want = np.asarray(jm.apply(v, jnp.asarray(x)))
      with torch.no_grad():
        got = trunk(_t(x)).numpy()
      np.testing.assert_allclose(got, want, rtol=1e-5,
                                 atol=1e-5 * np.abs(want).max())


def test_ar_scorer_export_matches_jax_gen_ppl(tmp_path):
  """The AR scorer's variables, saved as JAX's ``ar_fallback_scorer``
  reads them (``save_pytree``), exported and read by
  ``--gen_ppl_ar_checkpoint``: the port's log-probs and perplexity
  against JAX's scorer on the orbax tree itself (bf16 compute, as both
  scorers run: JAX compiled, the port op by op; log-probs within 0.05,
  perplexity 1e-2 relative)."""
  jcfg, cfg = _configs('dit')
  jm = JaxAR(config=jcfg, vocab_size=jcfg.vocab_size)
  variables = random_variables(jm.init, jnp.zeros((1, L), jnp.int32),
                               jnp.zeros((1,)), rs=np.random.default_rng(9))
  src = str(tmp_path / 'ar')
  save_pytree(src, variables)
  path = _export(tmp_path, 'ar', None, save=False)
  toks = np.random.default_rng(10).integers(0, 4, (6, L))
  jscore = jgen.ar_fallback_scorer(jcfg, src)
  want_lp = np.asarray(jscore(toks), np.float32)
  model = tgen.load_ar_scorer(path, cfg, 'cpu')
  got_lp = tgen.ar_fallback_scorer(cfg, device='cpu', model=model)(toks)
  np.testing.assert_allclose(got_lp, want_lp, atol=0.05)
  want = jgen.compute_generative_perplexity_local(toks, jscore)
  got = tgen.compute_generative_perplexity_local(
      toks, tgen.ar_fallback_scorer(cfg, path, device='cpu'))
  np.testing.assert_allclose(got, want, rtol=1e-2)
  tgen.ar_checkpoint(path)


def test_orbax_directories_raise_naming_the_script(tmp_path):
  """Every flag refuses the orbax directory itself, naming the export
  script and A17."""
  jm, variables = _enformer(11)
  src = str(tmp_path / 'orbax_value')
  save_pytree(src, variables)
  assert ckpt_lib.is_orbax_dir(src)
  for flag in ('load_checkpoint_path', 'reward_checkpoint_path',
               'diffusion_checkpoint_path'):
    args = cli_decode.parser().parse_args(['--device', 'cpu', f'--{flag}',
                                           src])
    with pytest.raises(NotImplementedError,
                       match='A17.*export_jax_checkpoint.py'):
      common.reject_unported(args)
  with pytest.raises(NotImplementedError, match='export_jax_checkpoint.py'):
    tgen.ar_checkpoint(src)
  with pytest.raises(NotImplementedError, match='export_jax_checkpoint.py'):
    main_gosai.run(main_gosai.parser().parse_args(
        ['--mode', 'sample_eval', '--device', 'cpu', '--ckpt_dir', src]),
        tiny_test_config('dna'))


def test_export_format_round_trips_without_pickle(tmp_path):
  """``save_export`` / ``load_export``: nested leaves under '/' paths,
  the kind and meta back as written, read with ``allow_pickle=False``;
  a plain ``.npz`` is no export."""
  tree = {'params': {'a': {'kernel': np.ones((2, 3), np.float32)},
                     'b': np.arange(4)}, 'batch_stats': {'m': np.zeros(2)}}
  path = str(tmp_path / 'x.npz')
  ckpt_lib.save_export(path, 'variables', tree, {'step': 5})
  e = ckpt_lib.load_export(path)
  assert e.kind == 'variables' and e.meta == {'step': 5}
  assert ckpt_lib.flatten(e.tree).keys() == ckpt_lib.flatten(tree).keys()
  np.testing.assert_array_equal(e.tree['params']['a']['kernel'],
                                tree['params']['a']['kernel'])
  assert ckpt_lib.is_export_file(path)
  assert ckpt_lib.export_in(str(tmp_path), ('variables',)) == path
  assert ckpt_lib.export_in(str(tmp_path), ('diffusion',)) is None
  np.savez(str(tmp_path / 'plain.npz'), a=np.ones(2))
  assert not ckpt_lib.is_export_file(str(tmp_path / 'plain.npz'))
  with pytest.raises(ValueError, match='export'):
    ckpt_lib.load_export(str(tmp_path / 'plain.npz'))


def _leaves(tree):
  return [x for v in tree.values()
          for x in (_leaves(v) if isinstance(v, dict) else [v])]


def test_export_headers_read_no_leaf_and_a_run_loads_its_export_once(
    tmp_path, monkeypatch):
  """Finding the export in a ``--ckpt_dir`` and checking the flags read
  the entries ``__format__``, ``__kind__`` and ``__meta__`` alone (the
  leaves stay in the zip); ``main_gosai --mode sample_eval`` and
  ``--mode ppl_eval`` on a directory of two denoiser exports then read
  the leaves of the newest step's once."""
  from svdd_tpu_torch.diffusion import Diffusion
  cfg = tiny_test_config('dna')
  cfg.model.length = L
  cfg.loader.eval_batch_size = 4
  cfg.sampling.num_sample_batches = 1
  cfg.sampling.steps = 4
  den = Diffusion(cfg, device='cpu').backbone
  d = tmp_path / 'ckpt'
  for step in (3, 7):
    ckpt_lib.save_export(str(d / f'denoiser_{step}.npz'), 'diffusion',
                         weights.cnn_to_jax(den),
                         {'step': step, 'config': {'backbone': 'cnn'}})
  newest = str(d / 'denoiser_7.npz')
  read = []
  getitem = np.lib.npyio.NpzFile.__getitem__

  def recording(self, key):
    read.append((self.fid.name if hasattr(self.fid, 'name') else '', key))
    return getitem(self, key)

  monkeypatch.setattr(np.lib.npyio.NpzFile, '__getitem__', recording)
  assert ckpt_lib.export_in(str(d), common.DENOISER_EXPORTS) == newest
  header = ckpt_lib.export_header(newest, common.DENOISER_EXPORTS)
  assert header.kind == 'diffusion' and header.meta['step'] == 7
  assert all(v is None for v in _leaves(header.tree))
  assert {k for _, k in read} <= {'__format__', '__kind__', '__meta__'}
  n_leaves = len(ckpt_lib.flatten(weights.cnn_to_jax(den)))
  for mode in ('sample_eval', 'ppl_eval'):
    read.clear()
    main_gosai.run(main_gosai.parser().parse_args(
        ['--mode', mode, '--device', 'cpu', '--ckpt_dir', str(d)]), cfg)
    leaves = [(f, k) for f, k in read
              if k not in ('__format__', '__kind__', '__meta__')]
    assert len(leaves) == n_leaves, mode
    assert {f for f, _ in leaves} == {newest}, mode
