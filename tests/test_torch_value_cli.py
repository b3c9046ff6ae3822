"""Value-net and oracle training's CLIs, data and checkpoints in
svdd_tpu_torch vs svdd_tpu, and the two repairs of this slice (tiny
sizes: the Enformer at channels 256, 3 conv blocks, one transformer
block; L=16).

* The Gosai data directory defaults to JAX's (``SVDD_DATA_DIR``, else
  ``/data/svdd``): both packages read the same CSV with no
  ``--data_dir``.
* DPS differentiates an Enformer reward oracle through its unfused
  tower, as JAX traces it under ``unfused_guard``.

Tolerances, f32 with TF32 off: the oracle step's loss 1e-5 relative, its
gradients 5e-5 of their norm plus 1e-6 of the largest (the biases ahead
of a training BatchNorm have a zero gradient in exact arithmetic, and
the pools' and the attention's sums run in another order), its update as
optax's AdamW makes it on the port's gradients to 1e-6; the DPS gradient
2e-4 (as ``tests/test_torch_grad.py`` holds the input gradients); the
streaming Pearson correlation 1e-6; data exactly.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.data import gosai as jgosai
from svdd_tpu.data import regression as jregression
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.eval.metrics import PearsonState as JaxPearson
from svdd_tpu.models.blocks import unfused_guard
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer
from svdd_tpu.ops import attn_pool_pallas as jap
from svdd_tpu.ops import conv1d_bwd_pallas as jconv

from svdd_tpu_torch import rewards
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.cli import decode as cli_decode
from svdd_tpu_torch.cli import eval as cli_eval
from svdd_tpu_torch.cli import train as cli_train
from svdd_tpu_torch.cli import train_oracle
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.data import gosai
from svdd_tpu_torch.data import regression
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.eval.metrics import PearsonState
from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.ops import attn_pool as tap
from svdd_tpu_torch.ops import conv1d as tconv
from svdd_tpu_torch.sampling import guidance
from svdd_tpu_torch.train import diffusion as train_diff
from svdd_tpu_torch.weights import (cnn_from_jax, enformer_params_to_jax,
                                    enformer_to_jax, enformer_value_from_jax)
from torch_port_helpers import (FlaxMasks, dropout_masks,  # noqa: F401
                                few_torch_threads, random_cnn_variables,
                                random_variables)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 16
TINY = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2)


def _t(a):
  return torch.from_numpy(np.array(a))


def _flat(tree, path=''):
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flat(v, f'{path}/{k}'))
    return out
  return {path: np.asarray(tree, np.float64)}


def _assert_tree_close(got, want, rtol=1e-5, floor=1e-6):
  got, want = _flat(got), _flat(want)
  assert set(got) == set(want), set(got) ^ set(want)
  norm = np.linalg.norm
  top = max(norm(v) for v in want.values())
  bad = {k: (norm(got[k] - want[k]), norm(want[k])) for k in want
         if not norm(got[k] - want[k]) <= rtol * norm(want[k]) + floor * top}
  assert not bad, bad


def _tiny_cfg(steps=4):
  cfg = tiny_test_config('dna')
  cfg.model.length = L
  cfg.sampling.steps = steps
  return cfg


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------


def _write_gosai_csv(path, n=6, length=L, seed=0):
  rs = np.random.default_rng(seed)
  with open(path, 'w', newline='') as f:
    w = csv.writer(f)
    w.writerow(['seq', 'hepg2', 'k562', 'sknsh'])
    for _ in range(n):
      w.writerow([''.join(rs.choice(list('ACGT'), length))]
                 + [f'{v:.4f}' for v in rs.normal(size=3)])


def test_gosai_data_dir_defaults_to_jax_default(tmp_path, monkeypatch):
  """With no ``data_dir`` and no SVDD_DATA_DIR both packages read
  ``gosai_val.csv`` under their module default (JAX's ``DATA_DIR``,
  '/data/svdd'; here both pointed at a temporary directory): the same
  rows, not the synthetic split."""
  _write_gosai_csv(tmp_path / 'gosai_val.csv')
  monkeypatch.delenv('SVDD_DATA_DIR', raising=False)
  monkeypatch.setattr(jgosai, 'DATA_DIR', str(tmp_path))
  monkeypatch.setattr(gosai, 'DATA_DIR', str(tmp_path))
  want = jgosai.GosaiDataset('val', length=L)
  got = gosai.GosaiDataset('val', length=L)
  assert not want.synthetic and not got.synthetic
  np.testing.assert_array_equal(got.seqs, want.seqs)
  np.testing.assert_array_equal(got.clss, want.clss)


def test_gosai_data_dir_default_reads_the_environment(monkeypatch):
  """The module default is SVDD_DATA_DIR when it is set, else
  '/data/svdd', as in JAX (read when the module is imported)."""
  code = ('import svdd_tpu_torch.data.gosai as g, svdd_tpu.data.gosai as j; '
          'print(g.DATA_DIR == j.DATA_DIR, g.DATA_DIR)')
  for env, want in (({'SVDD_DATA_DIR': '/tmp/x'}, '/tmp/x'),
                    ({}, '/data/svdd')):
    e = {k: v for k, v in os.environ.items() if k != 'SVDD_DATA_DIR'}
    e.update(env, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=REPO, env=e, timeout=300)
    assert out.stdout.split() == ['True', want], out.stderr[-2000:]


@pytest.fixture(scope='module')
def denoisers():
  cfg = jax_tiny_config('dna')
  cfg.model.length = L
  variables = random_cnn_variables(cfg, np.random.default_rng(0))
  return (JaxDiffusion(cfg, variables=variables),
          Diffusion(_tiny_cfg(), device='cpu',
                    backbone=cnn_from_jax(variables)))


@pytest.fixture(scope='module')
def oracle_vars():
  jm = JaxEnformer(n_tasks=3, **TINY)
  return jm, random_variables(jm.init, jnp.zeros((1, L, 4)),
                              rs=np.random.default_rng(20))


def test_dps_gradient_through_enformer_oracle_is_unfused(denoisers,
                                                         oracle_vars,
                                                         monkeypatch):
  """``dps_gradient`` with an Enformer ``RewardOracle`` (task 0 of three)
  takes the oracle's unfused tower, as JAX's ``dps_gradient`` traces it
  under ``unfused_guard``: the fused eval pipeline's prologue kernel is
  never called, and the gradient equals jax.grad's to 2e-4."""
  jdiff, diff = denoisers
  jm, variables = oracle_vars
  rs = np.random.default_rng(21)
  x = np.where(rs.random((4, L)) < 0.6, 4,
               rs.integers(0, 4, (4, L))).astype(np.int32)
  sigma = np.full((4,), 0.7, np.float32)
  copy = (x != 4).astype(np.float32)[..., None]

  def score_mean(onehot):
    expected = jdiff.forward_onehot(jdiff.variables, onehot, jnp.asarray(x),
                                    jnp.asarray(sigma))
    expected = copy * onehot + (1 - copy) * expected
    probs = jax.nn.softmax(expected, axis=-1)[..., :4]
    return jm.apply(variables, probs)[:, 0].mean()

  with unfused_guard():
    want = np.asarray(jax.jit(jax.grad(score_mean))(
        jax.nn.one_hot(jnp.asarray(x), 5)))

  def fused(*args, **kwargs):
    raise AssertionError('the fused eval pipeline took the DPS gradient')

  monkeypatch.setattr(tap, 'pool_prologue_im2col_wlogits', fused)
  oracle = rewards.RewardOracle(enformer_value_from_jax(variables))
  got = guidance.dps_gradient(diff.forward_onehot, oracle,
                              _t(x).long(), _t(sigma), 4)
  assert np.abs(want).max() > 0
  np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                             atol=2e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the oracle trainer's step
# ---------------------------------------------------------------------------


def test_train_oracle_step_matches_svdd_tpu(oracle_vars, monkeypatch):
  """One step of ``cli.train_oracle`` (the 3-task Enformer in training
  mode, the MSE over all tasks, ``optax.adamw(lr)``: weight decay 1e-4,
  no clipping) against ``svdd_tpu/cli/train_oracle.py``'s step on the
  same weights, batch and dropout masks: the loss, the gradients, the
  running statistics, and the update as optax's AdamW makes it on the
  port's gradients (which weight decay 1e-2, torch's default, would miss
  by about 1e-5 of each parameter)."""
  jm, variables = oracle_vars
  rs = np.random.default_rng(22)
  seqs = rs.integers(0, 4, (8, L))
  labels = rs.normal(size=(8, 3)).astype(np.float32)
  masks = dropout_masks(rs, 8, TINY['channels'])
  FlaxMasks().install(monkeypatch).set(masks)
  params = variables['params']
  lr = 1e-3

  def loss_fn(p):
    preds, upd = jm.apply({'params': p, 'batch_stats':
                           variables['batch_stats']},
                          jax.nn.one_hot(jnp.asarray(seqs), 4), train=True,
                          mutable=['batch_stats'],
                          rngs={'dropout': jax.random.key(0)})
    return jnp.mean((preds - jnp.asarray(labels)) ** 2), upd

  (jloss, upd), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      params)
  opt = optax.adamw(lr)
  module = enformer_value_from_jax(variables)
  optimizer = train_oracle.make_optimizer(module, lr)
  assert optimizer.adamw.param_groups[0]['weight_decay'] == 1e-4
  loss = train_oracle.train_step(module, optimizer, _t(seqs).long(),
                                 _t(labels),
                                 blocks.DropoutMasks(masks=masks))
  np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
  named = dict(module.named_parameters())
  grads = enformer_params_to_jax({k: p.grad for k, p in named.items()},
                                 module)
  _assert_tree_close(grads, jgrads, rtol=5e-5)
  updates, _ = opt.update(jax.tree.map(jnp.asarray, grads),
                          opt.init(params), params)
  got = enformer_to_jax(module)
  _assert_tree_close(got['params'], optax.apply_updates(params, updates),
                     rtol=1e-6, floor=1e-9)
  _assert_tree_close(got['batch_stats'], upd['batch_stats'])


# ---------------------------------------------------------------------------
# metrics and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('targets', [1, 3])
def test_pearson_state_matches_svdd_tpu(targets):
  """The streaming Pearson correlation over three updates."""
  rs = np.random.default_rng(30 + targets)
  js, ts = JaxPearson.init(targets), PearsonState.init(targets)
  for _ in range(3):
    y = rs.normal(size=(5, targets)).astype(np.float32)
    p = (y + 0.5 * rs.normal(size=y.shape)).astype(np.float32)
    js = js.update(jnp.asarray(y), jnp.asarray(p))
    ts = ts.update(_t(y), _t(p))
  np.testing.assert_allclose(float(ts.compute()), float(js.compute()),
                             rtol=1e-6)
  assert float(ts.count[0]) == 15


@pytest.mark.parametrize('mode', ['one_hot', 'tokens'])
def test_regression_data_matches_svdd_tpu(mode, tmp_path):
  """``data/regression.py`` copied: the tokenizer (encode, decode, vocab
  file) and ``DNARegressionDataset.from_csv`` (the port reads the CSV with
  the csv module, JAX with pandas) give the same items."""
  path = tmp_path / 'reg.csv'
  rows = [('ACGTNACG', '1.5'), ('acgtacgtacgtac', '-0.25'), ('GGC', '2')]
  with open(path, 'w', newline='') as f:
    w = csv.writer(f)
    w.writerow(['seq', 'hepg2'])
    w.writerows(rows)
  want = jregression.DNARegressionDataset.from_csv(str(path), 10, mode=mode)
  got = regression.DNARegressionDataset.from_csv(str(path), 10, mode=mode)
  assert len(got) == len(want) == 3
  np.testing.assert_array_equal(got.labels, want.labels)
  np.testing.assert_array_equal(got.token_ids, want.token_ids)
  for i in range(3):
    for k in ('seqs', 'labels'):
      np.testing.assert_array_equal(got[i][k], want[i][k])
  tok, jtok = got.tokenizer, want.tokenizer
  assert tok.vocab == jtok.vocab and tok.pad_id == jtok.pad_id
  assert tok.decode(tok.encode('ACXG')) == jtok.decode(jtok.encode('ACXG'))
  tok.save_vocab(str(tmp_path / 'vocab.json'))
  other = regression.SimpleDNATokenizer(4)
  other.load_vocab(str(tmp_path / 'vocab.json'))
  assert other.vocab == tok.vocab and other.inv == tok.inv


# ---------------------------------------------------------------------------
# the backward kernels' gates at the trainers' rows
# ---------------------------------------------------------------------------

# (L, Cin, Cout) of the six k=5 tower convs and (L, C) of the seven pools
# of the full-width value net at L=200
TOWER_CONVS = [(100, 768, 768), (50, 768, 896), (25, 896, 1024),
               (13, 1024, 1152), (7, 1152, 1280), (4, 1280, 1536)]
TOWER_POOLS = [(200, 768), (100, 768), (50, 896), (25, 1024), (13, 1152),
               (7, 1280), (4, 1536)]


@pytest.mark.parametrize('n', [1024, 64])
def test_backward_gates_at_training_rows(n):
  """At the MC grad step's 1,024 rows (batch 8 x 128 states) and the
  oracle step's 64, every tower conv and pool goes to the kernels the
  JAX dispatchers take on a TPU: B7 where ``conv1d_bwd_pallas.conv_bwd_ok``
  holds (its tile over N fits, f32 and bf16), the pools' forward (B4) and
  backward (B8) where the (N, L, C) w-logits dispatcher and
  ``_pool_bwd_ok`` take their Pallas kernels; in bf16 the pool keeps the
  kernel's rounding there. On 'meta' tensors (no card here) the port's
  wrappers stop at the kernel's device check."""
  m = lambda *s: torch.empty(s, device='meta')
  for l, cin, cout in TOWER_CONVS:
    takes = tconv.conv_bwd_ok(l, cin, cout, 5)
    for itemsize in (4, 2):
      assert takes is jconv.conv_bwd_ok(n, l, cin, cout, 5, 1, itemsize)
    assert takes
    with pytest.raises(ValueError, match='CUDA device'):
      tconv.conv1d_bwd(m(n, l, cin), m(5, cin, cout), m(n, l, cout))
  for l, c in TOWER_POOLS:
    l_pad = l + l % 2
    takes = tap.attn_pool_kernel_takes(c)
    assert takes and jap.wlogits_pool_ok(l_pad, c)
    assert jap._pick_tile_n_wl(n, l_pad, c, has_res=True) > 0
    for itemsize in (4, 2):
      assert jap._pool_bwd_ok(n, l_pad, c, itemsize, has_res=True)
    assert not tap.pool_rounds_as_reference(
        m(n, l, c).to(torch.bfloat16), lnc=False, has_res=True)
    for run in (lambda: tap.attn_pool(m(n, l, c), m(c, c), m(n, l, c)),
                lambda: tap.attn_pool_bwd(m(n, l, c), m(c, c),
                                          m(n, (l + 1) // 2, c),
                                          m(n, l, c))):
      with pytest.raises(ValueError, match='CUDA device'):
        run()


# ---------------------------------------------------------------------------
# the checkpoint flags
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def port_files(tmp_path_factory):
  """The port's own files at tiny widths: a pretraining checkpoint
  (``step_<n>.pt``, its EMA shadow moved off the weights), an oracle and a
  value net as ``cli.train_oracle`` and ``cli.train`` save them."""
  root = tmp_path_factory.mktemp('ckpt')
  cfg = _tiny_cfg()
  state = train_diff.init_state(Diffusion(cfg, device='cpu'), cfg)
  g = torch.Generator().manual_seed(2)
  with torch.no_grad():
    for v in state.ema.shadow.values():
      v.add_(0.05 * torch.randn(v.shape, generator=g))
  ckpt_dir = str(root / 'pretrain')
  train_diff.save_checkpoint(ckpt_dir, state)
  oracle = rewards.RewardOracle.create_dna(torch.Generator().manual_seed(3),
                                           **TINY).module
  value = value_lib.build_value_module('dna', generator=torch.Generator()
                                       .manual_seed(4), **TINY)
  with torch.no_grad():
    value.trunk.pointwise.norm.mean.add_(0.5)
  paths = {'oracle': str(root / 'oracle.pt'), 'value': str(root / 'value.pt')}
  value_lib.save_checkpoint(paths['oracle'], oracle)
  value_lib.save_checkpoint(paths['value'], value)
  return dict(paths, ckpt_dir=ckpt_dir, shadow=state.ema.shadow,
              oracle_module=oracle, value_module=value,
              step_file=train_diff.latest_checkpoint(ckpt_dir))


def _same_module(a, b):
  sa, sb = a.state_dict(), b.state_dict()
  return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize('diffusion', ['file', 'dir'])
@pytest.mark.parametrize('value_flag',
                         ['load_checkpoint_path', 'pre_model_path'])
def test_checkpoint_flags_read_the_ports_files(port_files, diffusion,
                                               value_flag):
  """``--diffusion_checkpoint_path`` (a ``step_<n>.pt`` or its directory)
  gives the denoiser the checkpoint's EMA weights;
  ``--reward_checkpoint_path`` the Enformer oracle ``cli.train_oracle``
  saved (task 0 of three read); ``--load_checkpoint_path`` or
  ``--pre_model_path`` the value net ``cli.train`` saved, its running
  statistics included."""
  f = port_files
  path = f['step_file'] if diffusion == 'file' else f['ckpt_dir']
  args = cli_decode.parser().parse_args(
      ['--device', 'cpu', '--diffusion_checkpoint_path', path,
       '--reward_checkpoint_path', f['oracle'], f'--{value_flag}',
       f['value']])
  common.reject_unported(args)
  cfg = _tiny_cfg()
  diff = common.load_diffusion(args, cfg)
  for name, p in diff.backbone.named_parameters():
    assert torch.equal(p, f['shadow'][name])
  oracle = common.load_reward_fn(args, cfg)
  assert isinstance(oracle, rewards.RewardOracle) and oracle.task_index == 0
  assert _same_module(oracle.module, f['oracle_module'])
  assert oracle.module.compute_dtype == torch.float32
  vf = common.load_value_function(args, cfg)
  assert _same_module(vf.module, f['value_module'])
  oh = value_lib.mdlm.transform_samples(torch.randint(0, 5, (3, L)))
  with torch.no_grad():
    assert torch.equal(vf.score_onehot(oh), f['value_module'](oh))


@pytest.mark.parametrize('kind', ['reference_pt', 'orbax_dir', 'missing'])
@pytest.mark.parametrize('flag', ['diffusion_checkpoint_path',
                                  'reward_checkpoint_path',
                                  'load_checkpoint_path', 'pre_model_path'])
def test_checkpoint_flags_refuse_foreign_files(tmp_path, port_files, flag,
                                               kind):
  """A file the port did not write (an orbax directory, a missing path)
  raises naming ROADMAP A17 before any model is built; so does the other
  kind of the port's files. A reference-style ``.pt`` state dict goes to
  the importers (``tests/test_torch_importers.py``), which raise the
  ``KeyError`` of the first key of their layout it lacks, as JAX's do."""
  path = tmp_path / 'foreign'
  if kind == 'reference_pt':
    path = tmp_path / 'model.pt'
    torch.save({'model.conv.weight': torch.zeros(2, 2)}, path)
  elif kind == 'orbax_dir':
    os.makedirs(path / 'default')
    (path / 'default' / '_METADATA').write_text('{}')
  args = cli_decode.parser().parse_args(['--device', 'cpu', f'--{flag}',
                                         str(path)])
  if kind == 'reference_pt':
    common.reject_unported(args)
    load = (common.load_diffusion if flag == 'diffusion_checkpoint_path'
            else common.load_reward_fn if flag == 'reward_checkpoint_path'
            else common.load_value_function)
    with pytest.raises(KeyError):
      load(args, _tiny_cfg())
  else:
    with pytest.raises(NotImplementedError, match='A17'):
      common.reject_unported(args)
  swapped = (port_files['value'] if flag == 'diffusion_checkpoint_path'
             else port_files['step_file'])
  args = cli_decode.parser().parse_args(['--device', 'cpu', f'--{flag}',
                                         swapped])
  with pytest.raises(NotImplementedError, match='A17'):
    common.reject_unported(args)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def trained(tmp_path_factory, port_files):
  """``cli.train_oracle --small`` at L=16, then ``cli.train`` (MC) from
  the pretraining checkpoint and that oracle, on the CPU."""
  root = tmp_path_factory.mktemp('trained')
  oracle_path = str(root / 'oracle.pt')
  out = train_oracle.run(train_oracle.parser().parse_args(
      ['--task', 'dna', '--small', '--length', str(L), '--batch_size', '8',
       '--max_iters', '3', '--log_every', '1', '--device', 'cpu',
       '--save_path', oracle_path]))
  argv = ['--task', 'dna', '--device', 'cpu', '--batch_size', '2',
          '--max_iters', '3', '--eval_every', '2', '--val_batch_num', '1',
          '--diffusion_checkpoint_path', port_files['ckpt_dir'],
          '--reward_checkpoint_path', oracle_path, '--out_dir', str(root),
          '--save_path', str(root / 'value.pt'),
          '--save_state_path', str(root / 'state.pt')]
  train = cli_train.run(cli_train.parser().parse_args(argv), cfg=_tiny_cfg(),
                        value_kwargs=TINY)
  return {'root': root, 'oracle': out, 'oracle_path': oracle_path,
          'train': train, 'argv': argv}


def test_cli_train_oracle_runs_on_cpu(trained):
  """``cli.train_oracle --task dna --small``: finite losses at every log
  step, a finite validation Pearson on the synthetic split's first 512
  rows, and an oracle file the checkpoint flag reads (3 tasks, key_len
  8)."""
  out = trained['oracle']
  assert sorted(out['losses']) == [1, 2, 3] and out['synthetic']
  assert np.isfinite(list(out['losses'].values())).all()
  assert np.isfinite(out['val_pearson'])
  ckpt = value_lib.load_checkpoint(trained['oracle_path'])
  assert ckpt['config'] == dict(n_tasks=3, n_conv=3, channels=256,
                                n_transformers=1, n_heads=2, key_len=8)


def test_cli_train_runs_on_cpu(trained):
  """``cli.train`` (MC): an evaluation row at iterations 2 and 3 with
  finite per-timestep MSE and Pearson, the value net and trainer state
  saved; resuming from the state runs 3 more iterations (JAX's loop
  counts this run's iterations from 0) from step 3."""
  import json
  t = trained['train']
  rows = [json.loads(r) for r in open(t['metrics_path'])]
  assert [r['_step'] for r in rows] == [2, 3]
  assert all(np.isfinite(v) for r in rows for k, v in r.items()
             if k.startswith('eval/'))
  assert t['state'].step == 3
  ckpt = value_lib.load_checkpoint(str(trained['root'] / 'value.pt'))
  assert ckpt['config']['channels'] == 256
  saved = t['state'].module.state_dict()
  assert ckpt['model'].keys() == saved.keys()
  assert all(torch.equal(ckpt['model'][k], saved[k]) for k in saved)
  args = cli_train.parser().parse_args(
      trained['argv'] + ['--resume_state_path',
                         str(trained['root'] / 'state.pt'),
                         '--val_batch_num', '0'])
  again = cli_train.run(args, cfg=_tiny_cfg(), value_kwargs=TINY)
  assert again['state'].step == 6


def test_cli_train_cdq_runs_on_cpu(trained, tmp_path):
  """``cli.train --cdq``: CD-Q targets from the 10-candidate sampler."""
  argv = [a if a != str(trained['root']) else str(tmp_path)
          for a in trained['argv']] + ['--cdq', '--max_iters', '2']
  out = cli_train.run(cli_train.parser().parse_args(argv), cfg=_tiny_cfg(),
                      value_kwargs=TINY)
  assert out['trainer'].tcfg.cdq and out['state'].step == 2
  assert out['trainer']._sampler(torch.Generator()).extra.shape == (
      4, 2, 10, L)


def test_cli_eval_runs_on_cpu(trained, port_files):
  """``cli.eval`` on the trained value net and oracle: a finite Pearson
  and MSE over its rows, and a metrics row."""
  root = trained['root']
  args = cli_eval.parser().parse_args(
      ['--task', 'dna', '--device', 'cpu', '--batch_size', '4',
       '--val_batch_num', '2', '--out_dir', str(root),
       '--diffusion_checkpoint_path', port_files['ckpt_dir'],
       '--reward_checkpoint_path', trained['oracle_path'],
       '--load_checkpoint_path', str(root / 'value.pt')])
  out = cli_eval.run(args, cfg=_tiny_cfg())
  assert out['n'] == 8 and np.isfinite([out['pearson'], out['mse']]).all()
  assert (root / 'dna-HepG2-eval.metrics.jsonl').exists()


@pytest.mark.parametrize('extra,item', [
    (['--model', 'multienformer', '--dist', '--fsdp'], 'multienformer'),
    (['--fsdp', '--batch_size', '3'], 'requires --dist'),
    (['--fsdp'], 'requires --dist')])
def test_cli_train_refuses_unported(extra, item):
  """The flag combinations JAX's CLI exits on exit here too, before
  any process group or model is made (``--dist`` itself runs:
  tests/test_torch_parallel_value.py)."""
  args = cli_train.parser().parse_args(['--device', 'cpu', *extra])
  with pytest.raises(SystemExit, match=item):
    cli_train.run(args, cfg=_tiny_cfg())


@pytest.fixture(scope='module')
def saluki_train(tmp_path_factory):
  """``cli.train --task rna_saluki --saluki_body_path body.npy`` (MC, one
  iteration, batch 2, the saluki input padded to 32 rows) on the CPU."""
  root = tmp_path_factory.mktemp('saluki_train')
  body = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
  np.save(root / 'body.npy', body)
  cfg = tiny_test_config('rna_saluki')
  cfg.model.length, cfg.sampling.steps = L, 4
  out = cli_train.run(cli_train.parser().parse_args(
      ['--task', 'rna_saluki', '--device', 'cpu', '--batch_size', '2',
       '--max_iters', '1', '--eval_every', '1', '--val_batch_num', '0',
       '--saluki_body_path', str(root / 'body.npy'),
       '--saluki_final_length', '32', '--out_dir', str(root)]), cfg=cfg)
  return out, body


def test_cli_train_reads_the_saluki_body(saluki_train):
  """``--saluki_body_path``: the trainer's reward input carries that
  body behind each sequence, padded to ``--saluki_final_length``."""
  out, body = saluki_train
  six = out['trainer']._reward_transform(torch.zeros(1, L,
                                                     dtype=torch.long))
  assert six.shape == (1, 32, 6)
  np.testing.assert_array_equal(six[0, L:L + 5].numpy(), body)
  assert (six[0, L + 5:] == 0).all()


def test_cli_train_takes_the_saluki_task(saluki_train):
  """``--task rna_saluki`` trains the four-channel ConvGRU value net one
  step with the random saluki oracle's targets."""
  out, _ = saluki_train
  assert out['trainer'].tcfg.task == 'rna_saluki'
  assert out['state'].step == 1 and out['state'].module.in_channels == 4


@pytest.mark.parametrize('task', ['rna_saluki'])
def test_cli_train_oracle_trains_rna_saluki(task, tmp_path, monkeypatch):
  """``--task rna_saluki`` trains the four-channel ConvGRU on splits of
  L=50, as JAX's CLI builds it (``svdd_tpu/cli/train_oracle.py:31-41``):
  not the six-channel saluki oracle. The 512-row validation pass is
  stubbed here (``tests/test_torch_saluki.py`` runs it)."""
  lengths = []
  dataset = train_oracle.GosaiDataset

  def recorded(split, length, data_dir=None):
    lengths.append(length)
    return dataset(split, length=length, data_dir=data_dir)

  monkeypatch.setattr(train_oracle, 'GosaiDataset', recorded)
  monkeypatch.setattr(train_oracle, 'val_pearson', lambda *a: 0.0)
  no_data = tmp_path / 'no_data'
  no_data.mkdir()
  out = train_oracle.run(train_oracle.parser().parse_args(
      ['--task', task, '--device', 'cpu', '--batch_size', '2',
       '--max_iters', '1', '--log_every', '1', '--data_dir', str(no_data)]))
  assert lengths == [50, 50] and out['module'].in_channels == 4
  assert np.isfinite(out['losses'][1])


def test_cli_defaults_match_svdd_tpu():
  """cli.train keeps JAX's defaults (batch 256, rate 2e-4, 50,000
  iterations, evaluation every 200); cli.train_oracle JAX's (batch 64,
  rate 1e-3, 2,000 iterations, task rna)."""
  a = cli_train.parser().parse_args([])
  assert (a.batch_size, a.learning_rate, a.max_iters, a.eval_every,
          a.grad_norm_clip, a.device) == (256, 2e-4, 50_000, 200, 1.0, 'cuda')
  o = train_oracle.parser().parse_args([])
  assert (o.batch_size, o.learning_rate, o.max_iters, o.task, o.device) == (
      64, 1e-3, 2000, 'rna', 'cuda')


def test_value_training_modules_import_no_jax():
  code = ('import sys, svdd_tpu_torch.train.value, svdd_tpu_torch.cli.train, '
          'svdd_tpu_torch.cli.train_oracle, svdd_tpu_torch.cli.eval, '
          'svdd_tpu_torch.data.regression; '
          "bad = [m for m in ('jax', 'flax', 'svdd_tpu') if m in sys.modules]; "
          'assert not bad, bad')
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
