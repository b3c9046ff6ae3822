"""Reading the reference's torch checkpoints in svdd_tpu_torch vs
svdd_tpu (tiny sizes: the Enformer at channels 384, 3 conv blocks (the
reference sizes its relative-position features dim // heads, which the
flax model rounds down to a multiple of 6: 192 at two heads); the
ConvGRU at its own widths; the CNN and DiT at the tiny test configs).

The state dicts come from ``tests/torch_mirrors.py`` (the Enformer, the
timed Enformer, the ConvGRU and the DiT, in the reference's key layouts)
and, for the CNN denoiser, are written from the names of
``svdd_tpu/importers/cnn.py``. Each port importer's tree, carried into a
port module by ``weights.*_from_jax``, equals bit for bit the module
that ``weights.*_from_jax`` makes of the JAX importer's tree. The files
are written with ``torch.save`` in the reference's containers
(Lightning's 'state_dict', the trainer's 'model_state_dict', a raw
dict) under its prefixes, and read by the CLIs' checkpoint flags.
"""

import json

import numpy as np
import pytest
import torch

import jax

import torch_mirrors as tm
from svdd_tpu import checkpoint as jcheckpoint
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.importers import cnn as jcnn_imp
from svdd_tpu.importers import convgru as jconvgru_imp
from svdd_tpu.importers import dit as jdit_imp
from svdd_tpu.importers import enformer as jenformer_imp

from svdd_tpu_torch import checkpoint, importers, rewards
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.cli import decode as cli_decode
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.weights import (cnn_from_jax, convgru_from_jax,
                                    dit_from_jax, enformer_value_from_jax)
from torch_port_helpers import (few_torch_threads,  # noqa: F401
                                jax_cli_common, random_cnn_variables)

jcommon = jax_cli_common()

L = 16
ENFORMER = dict(n_conv=3, channels=384, n_transformers=2, n_heads=2,
                key_len=8)


def _np_tree(tree):
  return jax.tree.map(np.asarray, tree)


def _sd(module) -> dict:
  """A torch module's state dict as numpy (what the importers read)."""
  return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _assert_same_module(a, b):
  sa, sb = a.state_dict(), b.state_dict()
  assert sa.keys() == sb.keys()
  for k in sa:
    assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _enformer_mirror(seed, timed=False, n_tasks=1, **kw):
  torch.manual_seed(seed)
  widths = {**ENFORMER, **kw}
  if n_tasks == 1:
    mirror = tm.make_dna_value_mirror(timed=timed, **widths)
  else:
    trunk = tm.EnformerTrunk(**widths)
    mirror = tm.BaseModelMirror(trunk, tm.ConvHead(
        n_tasks=n_tasks, in_channels=2 * widths['channels'],
        pool_func='avg'))
  tm.randomize_state_dict(mirror, seed=seed + 1)
  return mirror.eval()


def _rna_mirror(seed):
  torch.manual_seed(seed)
  mirror = tm.make_rna_value_mirror()
  tm.randomize_state_dict(mirror, seed=seed + 1)
  return mirror.eval()


def _dit_cfg():
  cfg = tiny_test_config('dna')
  cfg.model.hidden_size, cfg.model.cond_dim = 32, 24
  cfg.model.n_heads, cfg.model.n_blocks = 2, 2
  return cfg


def _dit_mirror(seed):
  torch.manual_seed(seed)
  cfg = _dit_cfg()
  mirror = tm.DIT(hidden_size=cfg.model.hidden_size,
                  cond_dim=cfg.model.cond_dim, n_heads=cfg.model.n_heads,
                  n_blocks=cfg.model.n_blocks, vocab_size=5, dropout=0.0)
  tm.randomize_state_dict(mirror, seed=seed + 1)
  return mirror


def _cnn_cfg(task='dna'):
  cfg = tiny_test_config(task)
  cfg.model.length = L
  cfg.sampling.steps = 4
  return cfg


def _cnn_state_dict(seed, task='dna') -> dict:
  """A reference CNNModel state dict (``svdd_tpu/importers/cnn.py``'s
  names: ``linear``, ``time_embedder.{0.W,1}``, ``convs.{i}``,
  ``time_layers.{i}.dense``, ``norms.{i}``, ``final_conv.{0,2}``), the
  torch layouts of a random flax CNN's variables."""
  jcfg = jax_tiny_config(task)
  jcfg.model.length = L
  v = random_cnn_variables(jcfg, np.random.default_rng(seed))
  p = v['params']
  conv = lambda t: np.ascontiguousarray(np.transpose(t['kernel'], (2, 1, 0)))
  dense = lambda t: np.ascontiguousarray(np.transpose(t['kernel']))
  sd = {'linear.weight': conv(p['stem']), 'linear.bias': p['stem']['bias'],
        'time_embedder.0.W': v['buffers']['GaussianFourierProjection_0']['W'],
        'time_embedder.1.weight': dense(p['time_linear']),
        'time_embedder.1.bias': p['time_linear']['bias'],
        'final_conv.0.weight': conv(p['final_0']),
        'final_conv.0.bias': p['final_0']['bias'],
        'final_conv.2.weight': conv(p['final_1']),
        'final_conv.2.bias': p['final_1']['bias']}
  rs = np.random.default_rng(seed + 1)
  for i in range(sum(1 for k in p if k.startswith('conv_'))):
    sd[f'convs.{i}.weight'] = conv(p[f'conv_{i}'])
    sd[f'convs.{i}.bias'] = 0.1 * rs.normal(size=p[f'conv_{i}']['bias'].shape)
    sd[f'time_layers.{i}.dense.weight'] = dense(p[f'time_{i}'])
    sd[f'time_layers.{i}.dense.bias'] = p[f'time_{i}']['bias']
    sd[f'norms.{i}.weight'] = rs.uniform(0.7, 1.3, size=p[f'norm_{i}'][
        'scale'].shape)
    sd[f'norms.{i}.bias'] = p[f'norm_{i}']['bias']
  return {k: np.asarray(a, np.float32) for k, a in sd.items()}


# ---------------------------------------------------------------------------
# the importers against JAX's, layout by layout
# ---------------------------------------------------------------------------


def test_cnn_importer_matches_svdd_tpu():
  sd = _cnn_state_dict(0)
  layers = 5 * tiny_test_config('dna').model.num_cnn_stacks
  got = cnn_from_jax(importers.import_cnn_params(sd, layers))
  want = cnn_from_jax(_np_tree(jcnn_imp.import_cnn_params(sd, layers)))
  _assert_same_module(got, want)


@pytest.mark.parametrize('timed', [False, True])
@pytest.mark.parametrize('n_transformers', [1, 2])
def test_enformer_importer_matches_svdd_tpu(timed, n_transformers):
  """Unrolled (one block) and stacked transformer layouts, timed and
  not; the depths, counted from the keys, are JAX's given ones."""
  sd = _sd(_enformer_mirror(3, timed=timed, n_transformers=n_transformers))
  got = enformer_value_from_jax(importers.import_enformer_value_model(
      sd, timed=timed))
  want = enformer_value_from_jax(_np_tree(
      jenformer_imp.import_enformer_value_model(
          sd, n_conv=3, n_transformers=n_transformers, timed=timed)))
  assert got.timed == timed
  _assert_same_module(got, want)


def test_convgru_importer_matches_svdd_tpu():
  sd = _sd(_rna_mirror(5))
  got = convgru_from_jax(importers.import_convgru_value_model(sd))
  want = convgru_from_jax(_np_tree(
      jconvgru_imp.import_convgru_value_model(sd)))
  _assert_same_module(got, want)


def test_dit_importer_matches_svdd_tpu():
  sd = _sd(_dit_mirror(7))
  cfg = _dit_cfg()
  got = dit_from_jax(importers.import_dit_params(sd, 2), cfg,
                     torch.float32)
  want = dit_from_jax(_np_tree(jdit_imp.import_dit_params(sd, 2)), cfg,
                      torch.float32)
  _assert_same_module(got, want)


@pytest.mark.parametrize('prefix', ['', 'module.'])
def test_importer_prefixes_match_svdd_tpu(prefix):
  """A DataParallel 'module.' prefix (and none) taken off the keys, as
  the JAX importers take it."""
  sd = {prefix + k: v for k, v in _sd(_enformer_mirror(9)).items()}
  got = enformer_value_from_jax(importers.import_enformer_value_model(
      sd, prefix=prefix))
  want = enformer_value_from_jax(_np_tree(
      jenformer_imp.import_enformer_value_model(
          sd, n_conv=3, n_transformers=2, prefix=prefix)))
  _assert_same_module(got, want)
  rna = {prefix + k: v for k, v in _sd(_rna_mirror(10)).items()}
  _assert_same_module(
      convgru_from_jax(importers.import_convgru_value_model(
          rna, prefix=prefix)),
      convgru_from_jax(_np_tree(jconvgru_imp.import_convgru_value_model(
          rna, prefix=prefix))))


# ---------------------------------------------------------------------------
# the pickle reader and the prefix rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('container', ['state_dict', 'model_state_dict',
                                       'raw'])
def test_import_torch_state_dict_matches_svdd_tpu(tmp_path, container):
  """Lightning's 'state_dict', the trainer's 'model_state_dict' or a raw
  dict, with non-tensor entries beside them: the same {name: array} as
  JAX's reader, and with ``key`` given."""
  sd = {'a.weight': torch.randn(3, 2), 'a.b.bias': torch.randn(3),
        'steps': torch.tensor(4)}
  obj = sd if container == 'raw' else {container: sd, 'epoch': 3,
                                       'hyper_parameters': {'lr': 1e-3}}
  path = str(tmp_path / 'ref.ckpt')
  torch.save(obj, path)
  for key in (None, '') if container == 'raw' else (None, container):
    got = checkpoint.import_torch_state_dict(path, key)
    want = jcheckpoint.import_torch_state_dict(path, key)
    assert got.keys() == want.keys() == sd.keys()
    for k in got:
      assert got[k].dtype == want[k].dtype
      np.testing.assert_array_equal(got[k], want[k])


def test_torch_prefix_and_suffixes_match_svdd_tpu():
  for keys in (['backbone.a', 'x'], ['module.backbone.a'], ['model.h'],
               ['module.x', 'model.y'], ['a.b'], []):
    sd = dict.fromkeys(keys)
    for cands in (('backbone.', 'module.backbone.'),
                  ('model.', 'module.', ''), ('module.',)):
      assert checkpoint.torch_prefix(sd, cands) == jcommon._torch_prefix(
          sd, cands)
  for path in ('a.pt', 'b.pth', 'c.ckpt', 'd.npz', 'dir', 'e.pt.tmp'):
    assert checkpoint.is_torch_ckpt(path) == jcommon._is_torch_ckpt(path)


def test_port_files_are_not_reference_files(tmp_path):
  """A file this package wrote (its ``format`` tag) is read by the
  port's own loaders; a torch file without the tag, or one that pickles
  objects, is a reference file; a directory or a missing path neither."""
  own = tmp_path / 'own.pt'
  torch.save({'format': 'svdd_tpu_torch.value/1', 'model': {}}, own)
  ref = tmp_path / 'ref.pt'
  torch.save({'state_dict': {'a': torch.zeros(2)}}, ref)
  pickled = tmp_path / 'obj.ckpt'
  torch.save({'state_dict': {'a': torch.zeros(2)},
              'cfg': argparse_namespace()}, pickled)
  assert checkpoint.port_format(str(own)) == 'svdd_tpu_torch.value/1'
  assert not checkpoint.is_reference_file(str(own))
  assert checkpoint.is_reference_file(str(ref))
  assert checkpoint.is_reference_file(str(pickled))
  assert not checkpoint.is_reference_file(str(tmp_path))
  assert not checkpoint.is_reference_file(str(tmp_path / 'missing.pt'))
  assert list(checkpoint.import_torch_state_dict(str(pickled))) == ['a']


def test_damaged_port_file_raises_its_load_error(tmp_path):
  """A truncated file of this package is no zip archive: it goes to the
  importers, whose load raises the archive reader's error (not a
  missing reference key); a file rewritten in place is read anew."""
  own = tmp_path / 'own.pt'
  torch.save({'format': 'svdd_tpu_torch.value/1',
              'model': {'w': torch.zeros(4096)}}, own)
  assert checkpoint.port_format(str(own)) == 'svdd_tpu_torch.value/1'
  data = own.read_bytes()
  own.write_bytes(data[:len(data) // 2])
  assert checkpoint.port_format(str(own)) is None
  with pytest.raises((RuntimeError, OSError)):   # torch.load's own
    checkpoint.import_torch_state_dict(str(own))
  legacy = tmp_path / 'legacy.pt'
  torch.save({'state_dict': {'a': torch.zeros(2)}}, legacy,
             _use_new_zipfile_serialization=False)
  assert checkpoint.is_reference_file(str(legacy))
  assert list(checkpoint.import_torch_state_dict(str(legacy))) == ['a']


def argparse_namespace():
  import argparse
  return argparse.Namespace(lr=1e-3)


# ---------------------------------------------------------------------------
# the CLIs' checkpoint flags on reference files
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def reference_files(tmp_path_factory):
  """The reference's three DNA files: a Lightning diffusion checkpoint
  ('state_dict', keys under 'backbone.'), a grelu oracle checkpoint
  ('state_dict', keys under 'model.', 3 tasks) and a value-net trainer
  dict ('model_state_dict', keys under 'module.'); and the RNA oracle
  and value net (ConvGRU) in the same containers."""
  root = tmp_path_factory.mktemp('reference')
  t = lambda sd, prefix: {prefix + k: torch.as_tensor(np.asarray(v))
                          for k, v in sd.items()}
  files = {}
  for task in ('dna', 'rna'):
    den = _cnn_state_dict(20, task)
    if task == 'dna':
      oracle, value = (_sd(_enformer_mirror(21, n_tasks=3)),
                       _sd(_enformer_mirror(22)))
    else:
      oracle, value = _sd(_rna_mirror(23)), _sd(_rna_mirror(24))
    paths = {k: str(root / f'{task}_{k}') for k in
             ('diffusion.ckpt', 'oracle.ckpt', 'value.pt')}
    torch.save({'state_dict': t(den, 'backbone.'), 'epoch': 7,
                'global_step': 1000}, paths['diffusion.ckpt'])
    torch.save({'state_dict': t(oracle, 'model.')}, paths['oracle.ckpt'])
    torch.save({'model_state_dict': t(value, 'module.'), 'epoch': 2,
                'tokens': 123.0}, paths['value.pt'])
    files[task] = {'paths': paths, 'diffusion': den, 'oracle': oracle,
                   'value': value}
  return root, files


def _args(task, paths, out_dir, *extra):
  return cli_decode.parser().parse_args(
      ['--task', task, '--device', 'cpu', '--batch_size', '4',
       '--sample_M', '2', '--num_steps', '4', '--skip_best_of_n',
       '--out_dir', str(out_dir),
       '--diffusion_checkpoint_path', paths['diffusion.ckpt'],
       '--reward_checkpoint_path', paths['oracle.ckpt'],
       '--load_checkpoint_path', paths['value.pt'], *extra])


@pytest.mark.parametrize('task', ['dna', 'rna'])
def test_cli_loaders_import_reference_files(reference_files, task):
  """``load_diffusion``, ``load_reward_fn`` and ``load_value_function``
  on the reference files: the denoiser, the oracle (task 0 of the DNA
  oracle's three) and the value net equal the modules the JAX
  importers' trees make (the JAX CLI's prefix rules)."""
  root, files = reference_files
  f = files[task]
  args = _args(task, f['paths'], root)
  common.reject_unported(args)
  cfg = _cnn_cfg(task)
  diff = common.load_diffusion(args, cfg)
  _assert_same_module(diff.backbone, cnn_from_jax(_np_tree(
      jcnn_imp.import_cnn_params(f['diffusion'],
                                 5 * cfg.model.num_cnn_stacks))))
  oracle = common.load_reward_fn(args, cfg)
  assert isinstance(oracle, rewards.RewardOracle) and oracle.task_index == 0
  vf = common.load_value_function(args, cfg)
  assert not vf.timed and vf.length == L
  if task == 'dna':
    want_o = enformer_value_from_jax(_np_tree(
        jenformer_imp.import_enformer_value_model(f['oracle'], 3, 2)))
    want_v = enformer_value_from_jax(_np_tree(
        jenformer_imp.import_enformer_value_model(f['value'], 3, 2)))
    assert oracle.module.n_tasks == 3
  else:
    want_o = convgru_from_jax(_np_tree(
        jconvgru_imp.import_convgru_value_model(f['oracle'])))
    want_v = convgru_from_jax(_np_tree(
        jconvgru_imp.import_convgru_value_model(f['value'])))
  _assert_same_module(oracle.module, want_o)
  _assert_same_module(vf.module, want_v)


@pytest.mark.parametrize('task', ['dna', 'rna'])
def test_cli_decode_runs_from_reference_files(reference_files, task,
                                              tmp_path):
  """``cli.decode.run`` (SVDD-MC) reading the three reference files
  writes the npz keys and a metrics row."""
  _, files = reference_files
  args = _args(task, files[task]['paths'], tmp_path)
  cli_decode.run(args, cfg=_cnn_cfg(task))
  d = np.load(tmp_path / f'{task}-HepG2.npz')
  assert set(d.files) == {'decoding', 'baseline'}
  assert d['decoding'].shape == (4,) and np.isfinite(d['decoding']).all()
  row = json.loads((tmp_path / f'{task}-HepG2.metrics.jsonl').read_text()
                   .splitlines()[-1])
  assert row['n'] == 4


def test_reference_dit_denoiser_loads(tmp_path):
  """A Lightning checkpoint of the DiT ('backbone.' prefix) gives
  ``--diffusion_checkpoint_path``'s denoiser the JAX importer's weights
  at the config's compute dtype."""
  sd = _sd(_dit_mirror(30))
  path = str(tmp_path / 'dit.ckpt')
  torch.save({'state_dict': {f'backbone.{k}': torch.as_tensor(v)
                             for k, v in sd.items()}}, path)
  cfg = _dit_cfg()
  cfg.backbone = 'dit'
  args = cli_decode.parser().parse_args(
      ['--device', 'cpu', '--diffusion_checkpoint_path', path])
  diff = common.load_diffusion(args, cfg)
  want = dit_from_jax(_np_tree(jdit_imp.import_dit_params(sd, 2)), cfg,
                      diff.backbone.compute_dtype)
  _assert_same_module(diff.backbone, want)


def test_reference_files_of_other_layouts_raise(tmp_path):
  """A reference file without the layout's keys raises the importer's
  ``KeyError``, as JAX's importers do; a denoiser of a backbone no
  importer maps raises ``NotImplementedError`` as JAX's loader does."""
  path = str(tmp_path / 'model.pt')
  torch.save({'model.conv.weight': torch.zeros(2, 2)}, path)
  args = cli_decode.parser().parse_args(
      ['--device', 'cpu', '--diffusion_checkpoint_path', path,
       '--reward_checkpoint_path', path, '--load_checkpoint_path', path])
  common.reject_unported(args)
  cfg = _cnn_cfg()
  for load in (common.load_diffusion, common.load_reward_fn,
               common.load_value_function):
    with pytest.raises(KeyError):
      load(args, cfg)
  cfg.backbone = 'dimamba'
  with pytest.raises(NotImplementedError, match='dimamba'):
    common.load_diffusion(args, cfg)


@pytest.mark.parametrize('flag', ['diffusion_checkpoint_path',
                                  'reward_checkpoint_path',
                                  'load_checkpoint_path'])
def test_orbax_directory_still_raises_a17(tmp_path, flag):
  path = tmp_path / 'orbax'
  (path / 'default').mkdir(parents=True)
  (path / 'default' / '_METADATA').write_text('{}')
  args = cli_decode.parser().parse_args(['--device', 'cpu', f'--{flag}',
                                         str(path)])
  with pytest.raises(NotImplementedError, match='A17'):
    common.reject_unported(args)


@pytest.mark.parametrize('timed', [False, True])
def test_smoke_reference_writers_round_trip(timed):
  """``chip_smoke.py``'s inverse name maps (it writes the full-width
  models in the reference's layouts on the card): a port Enformer
  (timed or not, the transformer stack stacked) and CNN written by them
  and read back by the port's importers equal their sources bit for
  bit, and the JAX importers read the same dicts to the same trees."""
  import chip_smoke
  from svdd_tpu_torch.diffusion import build_backbone
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  gen = torch.Generator().manual_seed(40)
  src = EnformerValueModel(n_tasks=3, generator=gen, timed=timed,
                           **{**ENFORMER, 'channels': 256})
  with torch.no_grad():
    for t in list(src.parameters()) + list(src.buffers()):
      t.add_(0.1 * torch.rand(t.shape, generator=gen))
  sd = {k: v.numpy() for k, v in
        chip_smoke.reference_enformer_dict(src).items()}
  got = enformer_value_from_jax(importers.import_enformer_value_model(
      sd, timed=timed))
  _assert_same_module(got, src)
  _assert_same_module(got, enformer_value_from_jax(_np_tree(
      jenformer_imp.import_enformer_value_model(sd, 3, 2, timed=timed))))
  cfg = _cnn_cfg()
  cnn = build_backbone(cfg, torch.Generator().manual_seed(41))
  csd = {k: v.numpy() for k, v in chip_smoke.reference_cnn_dict(cnn).items()}
  layers = 5 * cfg.model.num_cnn_stacks
  _assert_same_module(cnn_from_jax(importers.import_cnn_params(csd, layers)),
                      cnn)
