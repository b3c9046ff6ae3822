"""The port's process grid, data shards and DP / FSDP pretraining
(``svdd_tpu_torch/parallel``) against the JAX package's mesh and against
the port's own single-process step.

One module fixture starts four gloo processes on the CPU
(``torch_parallel_worker.py``, suite 'train'): DP and FSDP at a 2 x 1
grid (processes 0 and 1) and at 4 x 1, each two steps with
``accum_steps=2`` on a global batch of 8 whose attention masks give
every row, and so every process and microbatch, another token count;
process 0 also runs the single-process steps and resumes the grid's
checkpoints at world 1. JAX's DP ``Trainer`` on a 2-device mesh takes
the same batches from the same weights; its uniforms are fed to the
port's world-2 step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.data import gosai as jgosai
from svdd_tpu.data import text as jtext
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.parallel import mesh as JM
from svdd_tpu.train import diffusion as jtrain

from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.data import gosai, text as ttext
from svdd_tpu_torch.diffusion import build_backbone
from svdd_tpu_torch.parallel import fsdp
from svdd_tpu_torch.parallel import mesh as M
from svdd_tpu_torch.value import build_value_module
from svdd_tpu_torch.weights import (cnn_from_jax, cnn_params_to_jax,
                                    enformer_params_to_jax)
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import random_cnn_variables
import torch_parallel_worker as W

N, L, STEPS, ACCUM = 8, 16, 3, 2
REL = dict(rtol=1e-6, atol=1e-7)       # world N against world 1, f32


def _jax_cfg():
  cfg = jax_tiny_config('dna')
  cfg.model.length = L
  cfg.training.accum_steps = ACCUM
  cfg.optim.warmup_steps = 1
  return cfg


def _batches():
  rs = np.random.default_rng(4)
  seqs = rs.integers(0, 4, (STEPS, N, L))
  lengths = L - (np.arange(N)[None] * 3 + np.arange(STEPS)[:, None]) % 7
  mask = (np.arange(L)[None, None] < lengths[..., None]).astype(np.float32)
  return seqs, mask


def _step_noise(rng):
  """The uniforms JAX's step draws from ``state.rng``: one (t, mask)
  pair a microbatch (``tests/test_torch_train.py``)."""
  _, loss_key, _ = jax.random.split(rng, 3)
  out = []
  for k in jax.random.split(loss_key, ACCUM):
    kt, kq = jax.random.split(k)
    out.append((torch.tensor(np.asarray(jax.random.uniform(kt, (N // ACCUM,)))),
                torch.tensor(np.asarray(jax.random.uniform(kq, (N // ACCUM,
                                                                L))))))
  return out


@pytest.fixture(scope='module')
def grid(tmp_path_factory):
  """(each rank's results, JAX's DP losses). The processes start first
  and run while JAX trains: the uniforms of JAX's steps follow from its
  key alone (each step's state.rng is the first of a 3-way split)."""
  out = tmp_path_factory.mktemp('parallel_train')
  jcfg = _jax_cfg()
  variables = random_cnn_variables(jcfg, np.random.default_rng(0))
  torch.save(cnn_from_jax(variables), out / 'backbone.pt')
  seqs, mask = _batches()
  rng, noise = jax.random.key(11), []
  for _ in range(2):
    noise.append(_step_noise(rng))
    rng = jax.random.split(rng, 3)[0]
  torch.save({'backbone': str(out / 'backbone.pt'),
              'batches': {'seqs': torch.as_tensor(seqs),
                          'attention_mask': torch.as_tensor(mask)},
              'noise': noise}, out / 'inputs.pt')
  procs = W.start('train', 4, str(out))
  jmodel = JaxDiffusion(jcfg, variables=variables)
  mesh = JM.make_mesh(data=2, model=1, devices=jax.devices()[:2])
  trainer = jtrain.Trainer(jmodel, jcfg, mesh=mesh)
  state = trainer.init_or_restore(jax.random.key(11))
  jlosses = []
  for s in range(2):
    torch.testing.assert_close(_step_noise(state.rng)[0][0], noise[s][0][0])
    state, loss = trainer.train_step(state, trainer._put(
        {'seqs': jnp.asarray(seqs[s]),
         'attention_mask': jnp.asarray(mask[s])}))
    jlosses.append(float(loss))
  return W.collect(procs, str(out)), jlosses


def _assert_run(got, want, tol=REL):
  np.testing.assert_allclose(got['losses'], want['losses'], **tol)
  for part in ('params', 'ema'):
    assert list(got[part]) == list(want[part])
    for k in want[part]:
      np.testing.assert_allclose(got[part][k].numpy(), want[part][k].numpy(),
                                 **tol, err_msg=f'{part} {k}')


@pytest.mark.parametrize('kind', ['dp', 'fsdp'])
@pytest.mark.parametrize('shape,ranks', [('2x1', 2), ('4x1', 4)])
def test_grid_step_matches_world1(grid, kind, shape, ranks):
  """Two steps at world 2 and 4, DP and FSDP, with unequal masks and two
  microbatches (which straddle processes at world 4): every process's
  losses, parameters and EMA shadow equal the single-process steps."""
  results, _ = grid
  want = W.find(results, 'world1')
  for r in range(ranks):
    _assert_run(results[r][kind + shape], want)


@pytest.mark.parametrize('shape,ranks', [('2x1', 2), ('4x1', 4)])
def test_fsdp_holds_shards_between_steps(grid, shape, ranks):
  """Between FSDP steps a process holds its parts of the sharded
  parameters, 1/ranks of them, and the replicated ones once: the
  module's sharded parameters are empty and no gradient is kept."""
  results, _ = grid
  for r in range(ranks):
    held = results[r]['fsdp' + shape]['held']
    assert held['module'] == held['replicated']
    assert held['parts'] * ranks == held['whole'] > held['replicated']
    assert held['grads'] == 0


def test_dp_loss_matches_jax_dp_trainer(grid):
  """The world-2 step on JAX's uniforms has the losses of JAX's DP
  Trainer on a 2-device mesh (``tests/test_parallel.py:38-86``)."""
  results, jlosses = grid
  np.testing.assert_allclose(results[0]['jax_noise_dp2x1']['losses'],
                             jlosses, rtol=1e-5)
  np.testing.assert_allclose(W.find(results, 'world1_jax_noise')['losses'],
                             jlosses, rtol=1e-5)


@pytest.mark.parametrize('kind', ['dp', 'fsdp'])
def test_grid_checkpoint_resumes_at_world1(grid, kind):
  """A world-2 checkpoint (FSDP's gathered whole) resumed by one process
  continues as the uninterrupted single-process run."""
  results, _ = grid
  want = W.find(results, 'world1_3')
  got = dict(W.find(results, f'resumed_{kind}'))
  got['losses'] = want['losses'][:2] + got['losses']
  _assert_run(got, want)


def test_grid_issues_collectives(grid):
  """The grid step sums gradients in one all-reduce with the loss, after
  an all-reduce of each microbatch's token count."""
  results, _ = grid
  assert results[0]['dp2x1']['collectives'] == {'all_reduce': 2 * (ACCUM + 1)}


def test_train_grid_clamps_data_axis(grid):
  """main_gosai's grid: 4 processes and a global batch of 6 take a 3 x 1
  grid, the fourth process outside it (JAX's clamp to a divisor of the
  batch, ``svdd_tpu/cli/main_gosai.py:117-132``)."""
  results, _ = grid
  assert [r['grid_6rows'] for r in results] == (
      [{'data': 3, 'model': 1}] * 3 + [None])


def test_initialize_multihost_without_environment_is_world_of_one():
  assert 'WORLD_SIZE' not in os.environ
  assert M.initialize_multihost(device='cpu') is False
  assert M.local_shard_info(None) == (1, 0)


# ---------------------------------------------------------------------------
# fsdp_spec against JAX's
# ---------------------------------------------------------------------------


def _ids(module):
  """name -> a tensor of the parameter's shape holding its index + 1."""
  return {k: torch.full(p.shape, float(i + 1))
          for i, (k, p) in enumerate(module.named_parameters())}


def _leaves(tree, path=()):
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaves(v, path + (k,))
  else:
    yield path, np.asarray(tree)


def _models():
  cnn = build_backbone(tiny_test_config('dna'), torch.Generator())
  enf = build_value_module('dna', 'enformer', 1, torch.Generator(),
                           **W.VALUE_KW)
  return {'cnn': (cnn, cnn_params_to_jax(_ids(cnn)), 64),
          'enformer': (enf, enformer_params_to_jax(_ids(enf), enf), 4096)}


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('name', ['cnn', 'enformer'])
def test_fsdp_spec_matches_jax(name, n):
  """Every leaf of the CNN denoiser's and the Enformer value net's
  variables (the Enformer's two transformer blocks stacked as JAX's
  nn.scan stacks them) takes the axis, or the replication, that JAX's
  fsdp_spec gives it on an n-device mesh."""
  module, tree, min_size = _models()[name]
  jmesh = JM.make_mesh(data=n, model=1, devices=jax.devices()[:n])
  names = list(dict(module.named_parameters()))
  plan = fsdp.plan(module, n, min_size)
  key_of = {nm: k for k, (nms, _, _) in plan.items() for nm in nms}
  seen = set()
  for path, arr in _leaves(tree):
    spec = JM.fsdp_spec(arr, jmesh, min_size)
    want = next((i for i, a in enumerate(spec) if a == JM.DATA_AXIS), None)
    key = key_of[names[int(arr.flat[0]) - 1]]
    _, shape, axis = plan[key]
    assert (shape, axis) == (arr.shape, want), (path, key)
    seen.add(key)
  assert seen == set(plan)
  assert any(a is not None for _, _, a in plan.values())


# ---------------------------------------------------------------------------
# Data shards against JAX's
# ---------------------------------------------------------------------------


def _take(gen, k):
  """The next k batches' tokens of a running iterator."""
  return [next(gen)['seqs'] for _ in range(k)]


@pytest.mark.parametrize('num_shards,shard_index', [(2, 0), (2, 1), (4, 3)])
def test_strided_shards_match_jax(num_shards, shard_index):
  """The strided shard of each epoch's permutation, over two epochs and
  across a state_dict resume, as JAX's FaultTolerantIterator."""
  ds = gosai.GosaiDataset('train', length=L, synthetic_size=40)
  jds = jgosai.GosaiDataset('train', length=L, synthetic_size=40)
  np.testing.assert_array_equal(ds.seqs, jds.seqs)
  kw = dict(shuffle=True, seed=3, num_shards=num_shards,
            shard_index=shard_index)
  per_epoch = 40 // num_shards // 4
  it, jit = (gosai.FaultTolerantIterator(ds, 4, **kw),
             jgosai.FaultTolerantIterator(jds, 4, **kw))
  gen, jgen = iter(it), iter(jit)
  for a, b in zip(_take(gen, 2 * per_epoch + 1), _take(jgen, 2 * per_epoch + 1)):
    np.testing.assert_array_equal(a, b)
  state = it.state_dict()
  assert state == jit.state_dict() and state['epoch'] == 2
  it2 = gosai.FaultTolerantIterator(ds, 4, **kw)
  it2.load_state_dict(state)
  for a, b in zip(_take(iter(it2), 3), _take(jgen, 3)):
    np.testing.assert_array_equal(a, b)


def _write_csv(path):
  rs = np.random.default_rng(8)
  lines = ['id,note,seq,hepg2,k562,sknsh']
  for i in range(30):
    n = L if i % 7 else L - 1                    # some rows skipped
    seq = ''.join(rs.choice(list('ACGT'), n))
    lines.append(f'{i},n{i},{seq},{rs.normal():.4f},{i * 0.5},')
  path.write_text('\n'.join(lines) + '\n')


@pytest.mark.parametrize('shard_data', [False, True])
@pytest.mark.parametrize('shard_index', [0, 1])
def test_get_dataloaders_shards_match_jax(tmp_path, shard_data, shard_index):
  """get_dataloaders at 2 shards on a CSV: the strided shards, or under
  shard_data each shard's contiguous raw lines of the file, read and
  batched as JAX's loaders read them (its native row-range reader)."""
  for split in ('train', 'val', 'test'):
    _write_csv(tmp_path / f'gosai_{split}.csv')
  assert gosai.csv_count_rows(str(tmp_path / 'gosai_train.csv')) == 30
  cfg, jcfg = tiny_test_config('dna'), jax_tiny_config('dna')
  for c in (cfg, jcfg):
    c.model.length = L
  kw = dict(num_shards=2, shard_index=shard_index, data_dir=str(tmp_path),
            shard_data=shard_data)
  got = gosai.get_dataloaders(cfg, **kw)
  want = jgosai.get_dataloaders(jcfg, **kw)
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a.dataset.seqs, b.dataset.seqs)
    np.testing.assert_array_equal(a.dataset.clss, b.dataset.clss)
    assert a.batch_size == b.batch_size == 4
    for x, y in zip(_take(iter(a), 5), _take(iter(b), 5)):
      np.testing.assert_array_equal(x, y)


def test_text_shards_match_jax(tmp_path):
  """The text loaders' strided shards over a local text file."""
  path = tmp_path / 'corpus.txt'
  path.write_text(' '.join(['alpha beta gamma delta epsilon'] * 120))
  cfg, jcfg = tiny_test_config('dna'), jax_tiny_config('dna')
  for c in (cfg, jcfg):
    c.model.length = L
  for i in range(2):
    got = ttext.get_text_dataloaders(cfg, path=str(path), num_shards=2,
                                     shard_index=i)
    want = jtext.get_text_dataloaders(jcfg, path=str(path), num_shards=2,
                                      shard_index=i)
    for a, b in zip(got[:2], want[:2]):
      for x, y in zip(_take(iter(a), 4), _take(iter(b), 4)):
        np.testing.assert_array_equal(x, y)


def test_no_port_message_names_the_ported_parallel_paths():
  """The port's texts no longer call the parallel paths unported: none
  names A16 without its item (A16.1-A16.3, the pipeline included, are
  ported), the sharded loaders' docstring describes them, and
  ``cli.train --fsdp`` says what it does."""
  import pathlib
  import re
  from svdd_tpu_torch.cli import train as cli_train
  root = pathlib.Path(gosai.__file__).parents[1]
  stale = [f'{p.relative_to(root)}:{i + 1}'
           for p in sorted(root.rglob('*.py'))
           for i, line in enumerate(p.read_text().splitlines())
           if re.search(r'A16(?![.\d])', line)]
  assert stale == []
  assert 'not ported' not in gosai.__doc__
  fsdp_help = next(a.help for a in cli_train.parser()._actions
                   if '--fsdp' in a.option_strings)
  assert 'not ported' not in fsdp_help and 'shard' in fsdp_help
