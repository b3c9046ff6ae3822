"""The RNA task through svdd_tpu_torch's CLIs on the CPU (tiny sizes: the
RNA preset cut to hidden 32 and one CNN stack, L=16, 4 steps; the
ConvGRU at its own widths).

``main_gosai --task rna`` trains, evaluates and samples (the analytic
predictor too); ``cli.train_oracle --task rna`` trains the ConvGRU MRL
oracle; ``cli.train --task rna`` trains the ConvGRU value net (MC and
CD-Q) and resumes; ``cli.eval --task rna`` reads it; the six decoders
write the JAX CLIs' ``rna-<reward>*.npz`` files and keys from those
files; a checkpoint of the other task raises naming both. SVDD-MC and
SVDD-PM on the same ConvGRU and denoiser weights are held to JAX's by
the KS and quantile rule of ``tests/test_e2e_reference_parity.py:
103-116`` at 256 samples a side.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats as sps

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models import convgru as jconvgru
from svdd_tpu.rewards import RewardOracle as JaxOracle

from svdd_tpu_torch import mdlm, rewards
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import (common, decode, decode_classfier, decode_DG,
                                decode_DPS, decode_TDS, decode_tweedie)
from svdd_tpu_torch.cli import eval as cli_eval
from svdd_tpu_torch.cli import main_gosai
from svdd_tpu_torch.cli import train as cli_train
from svdd_tpu_torch.cli import train_oracle
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.weights import cnn_from_jax, convgru_from_jax
from torch_port_helpers import (few_torch_threads,  # noqa: F401
                                jax_cli_common, random_cnn_variables,
                                random_variables)

jcommon = jax_cli_common()

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L, STEPS, B_DIST, M, KS_PVAL = 16, 4, 256, 4, 1e-3


def _cfg(steps=STEPS):
  cfg = tiny_test_config('rna')
  cfg.sampling.steps = steps
  return cfg


@pytest.fixture(scope='module')
def rna_files(tmp_path_factory):
  """``main_gosai --mode train --task rna`` (6 steps, a checkpoint),
  ``cli.train_oracle --task rna`` (3 iterations) and ``cli.train --task
  rna`` (MC, 3 iterations, its state saved) on the CPU."""
  root = tmp_path_factory.mktemp('rna')
  no_data = root / 'no_data'
  no_data.mkdir()
  cfg = _cfg()
  cfg.eval.val_check_interval = 3
  cfg.checkpointing.every_n_steps = 3
  args = main_gosai.parser().parse_args(
      ['--mode', 'train', '--task', 'rna', '--device', 'cpu', '--ckpt_dir',
       str(root / 'ckpt'), '--log_dir', str(root), '--max_steps', '6',
       '--data_dir', str(no_data), '--no_sample_eval'])
  pretrain = main_gosai.run(args, cfg)
  oracle_path = str(root / 'oracle.pt')
  oracle = train_oracle.run(train_oracle.parser().parse_args(
      ['--task', 'rna', '--length', str(L), '--batch_size', '8',
       '--max_iters', '3', '--log_every', '1', '--device', 'cpu',
       '--data_dir', str(no_data), '--save_path', oracle_path]))
  argv = ['--task', 'rna', '--device', 'cpu', '--batch_size', '2',
          '--max_iters', '3', '--eval_every', '2', '--val_batch_num', '1',
          '--reward_name', 'MRL', '--out_dir', str(root),
          '--diffusion_checkpoint_path', str(root / 'ckpt'),
          '--reward_checkpoint_path', oracle_path]
  train = cli_train.run(cli_train.parser().parse_args(
      argv + ['--save_path', str(root / 'value.pt'),
              '--save_state_path', str(root / 'state.pt')]), cfg=_cfg())
  return {'root': root, 'no_data': str(no_data), 'pretrain': pretrain,
          'oracle': oracle, 'oracle_path': oracle_path, 'train': train,
          'argv': argv, 'value_path': str(root / 'value.pt')}


def test_main_gosai_trains_the_rna_task(rna_files):
  """``--task rna`` takes the RNA preset (length 50, the task 'rna'),
  trains with finite losses and writes ``rna-pretrain.metrics.jsonl``."""
  args = main_gosai.parser().parse_args(['--task', 'rna'])
  cfg = main_gosai.build_config(args)
  assert (cfg.task, cfg.model.length) == ('rna', 50)
  state = rna_files['pretrain']['state']
  assert state.step == 6
  rows = [json.loads(line) for line in
          open(rna_files['pretrain']['metrics_path'])]
  assert rows and all(np.isfinite(r['val/nll']) for r in rows
                      if 'val/nll' in r)
  assert os.path.basename(rna_files['pretrain']['metrics_path']) == (
      'rna-pretrain.metrics.jsonl')


@pytest.mark.parametrize('predictor', ['ddpm', 'analytic'])
def test_main_gosai_rna_ppl_and_sample_eval(rna_files, predictor):
  """``ppl_eval`` and ``sample_eval`` read the RNA checkpoint's EMA
  weights; sample_eval draws mask-free RNA tokens with the ddpm and the
  analytic predictor (``--set sampling.predictor=analytic``)."""
  root = rna_files['root']
  base = ['--task', 'rna', '--device', 'cpu', '--ckpt_dir',
          str(root / 'ckpt'), '--data_dir', rna_files['no_data']]
  out = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'ppl_eval', *base]), _cfg())
  assert np.isfinite(out['nll']) and out['ppl'] > 1
  cfg = _cfg()
  cfg.sampling.predictor = predictor
  cfg.sampling.num_sample_batches = 1
  out = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', *base]), cfg)
  assert out['tokens'].shape == (cfg.loader.eval_batch_size, L)
  assert set(np.unique(out['tokens'])) <= {0, 1, 2, 3}


def test_main_gosai_sample_quality_hook_reads_the_rna_oracle(rna_files):
  """``--eval_oracle_checkpoint_path``: the in-training sample-quality
  hook scores with the ConvGRU oracle of a ``cli.train_oracle --task
  rna`` file; a DNA (Enformer) oracle file raises naming both."""
  root = rna_files['root']
  cfg = _cfg()
  args = main_gosai.parser().parse_args(
      ['--task', 'rna', '--device', 'cpu', '--data_dir',
       rna_files['no_data'], '--eval_oracle_checkpoint_path',
       rna_files['oracle_path']])
  hook = main_gosai._sample_eval_hook(cfg, args)
  model = Diffusion(cfg, device='cpu')
  metrics = hook(model, torch.Generator().manual_seed(0))
  assert metrics and all(np.isfinite(v) for v in metrics.values())
  dna_oracle = str(root / 'dna_oracle.pt')
  value_lib.save_checkpoint(dna_oracle, rewards.RewardOracle.create_dna(
      torch.Generator().manual_seed(0), n_conv=3, channels=256,
      n_transformers=1, n_heads=2).module)
  bad = main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--task', 'rna', '--device', 'cpu',
       '--ckpt_dir', str(root / 'ckpt'), '--eval_oracle_checkpoint_path',
       dna_oracle])
  with pytest.raises(ValueError, match='Enformer.*ConvGRU'):
    main_gosai.run(bad, _cfg())


def test_cli_train_oracle_rna_trains_the_convgru(rna_files):
  """``cli.train_oracle --task rna``: the one-task ConvGRU at the given
  length, finite losses and Pearson, and a file marked 'rna' that
  ``--reward_checkpoint_path`` reads back."""
  out = rna_files['oracle']
  assert out['synthetic'] and np.isfinite(out['val_pearson'])
  assert all(np.isfinite(v) for v in out['losses'].values())
  ckpt = value_lib.load_checkpoint(rna_files['oracle_path'], task='rna')
  assert ckpt['task'] == 'rna' and ckpt['config']['n_tasks'] == 1
  args = argparse.Namespace(task='rna', device='cpu',
                            reward_checkpoint_path=rna_files['oracle_path'])
  oracle = common.load_reward_fn(args, _cfg())
  sd = out['module'].state_dict()
  assert all(torch.equal(v, sd[k])
             for k, v in oracle.module.state_dict().items())
  x = mdlm.transform_samples(torch.randint(0, 4, (3, L)))
  with torch.inference_mode():
    assert oracle(x).shape == (3,)


def test_cli_train_rna_mc_cdq_and_resume(rna_files):
  """``cli.train --task rna``: the ConvGRU value net in f32, finite
  per-timestep evaluations; CD-Q runs; a resume from the saved state
  repeats another resume bit for bit."""
  root = rna_files['root']
  train = rna_files['train']
  assert train['state'].step == 3
  assert isinstance(train['state'].module,
                    value_lib.ConvGRUValueModel)
  rows = [json.loads(line) for line in open(train['metrics_path'])]
  assert rows and all(np.isfinite(r['eval/mse_head']) for r in rows)
  cdq = cli_train.run(cli_train.parser().parse_args(
      rna_files['argv'] + ['--cdq', '--max_iters', '2']), cfg=_cfg())
  assert cdq['state'].step == 2
  resumed = []
  for _ in range(2):
    out = cli_train.run(cli_train.parser().parse_args(
        rna_files['argv'] + ['--max_iters', '2', '--val_batch_num', '0',
                             '--resume_state_path', str(root / 'state.pt')]),
        cfg=_cfg())
    resumed.append(out['state'].module.state_dict())
  assert all(torch.equal(resumed[0][k], resumed[1][k]) for k in resumed[0])


def test_cli_eval_rna_reads_the_value_net(rna_files):
  root = rna_files['root']
  args = cli_eval.parser().parse_args(
      ['--task', 'rna', '--device', 'cpu', '--batch_size', '4',
       '--val_batch_num', '2', '--reward_name', 'MRL', '--out_dir',
       str(root), '--diffusion_checkpoint_path', str(root / 'ckpt'),
       '--reward_checkpoint_path', rna_files['oracle_path'],
       '--load_checkpoint_path', rna_files['value_path']])
  out = cli_eval.run(args, cfg=_cfg())
  assert out['n'] == 8 and np.isfinite([out['pearson'], out['mse']]).all()
  assert (root / 'rna-MRL-eval.metrics.jsonl').exists()


DECODERS = {'decode': (decode.parser, decode.run, ''),
            'decode_tweedie': (decode_tweedie.parser, decode_tweedie.run,
                               '_tw'),
            'decode_TDS': (decode_TDS.parser, decode_TDS.run, '_TDS'),
            'decode_DPS': (decode_DPS.parser, decode_DPS.run, '_DPS'),
            'decode_DG': (decode_DG.parser, decode_DPS.run, '_DPS'),
            'decode_classfier': (decode_classfier.parser,
                                 decode_classfier.run, '-classfier')}


@pytest.mark.parametrize('name', list(DECODERS))
def test_rna_decoders_write_jax_npz(rna_files, tmp_path, name):
  """Each decoder at ``--task rna --reward_name MRL`` from the trained
  files writes the JAX CLI's path (``svdd_tpu.cli.common.npz_path``)
  with exactly the keys 'decoding' and 'baseline', finite rewards."""
  root = rna_files['root']
  argv = ['--task', 'rna', '--device', 'cpu', '--batch_size', '4',
          '--sample_M', '2', '--reward_name', 'MRL', '--skip_best_of_n',
          '--out_dir', str(tmp_path),
          '--diffusion_checkpoint_path', str(root / 'ckpt'),
          '--reward_checkpoint_path', rna_files['oracle_path'],
          '--load_checkpoint_path', rna_files['value_path']]
  make_parser, run, suffix = DECODERS[name]
  args = make_parser().parse_args(argv)
  run(args, cfg=_cfg())
  path = jcommon.npz_path(argparse.Namespace(
      out_dir=str(tmp_path), task='rna', reward_name='MRL'), suffix)
  assert path == common.npz_path(args, suffix)
  with np.load(path) as z:
    assert set(z.files) == {'decoding', 'baseline'}
    assert z['decoding'].shape == (4,) and np.isfinite(z['decoding']).all()


def test_rna_checkpoint_of_the_other_task_raises(rna_files, tmp_path):
  """The RNA value net handed to ``--task dna``, and a DNA (Enformer)
  value net to ``--task rna``: the checkpoint flags raise naming both
  architectures, before any model is built."""
  dna_value = str(tmp_path / 'dna_value.pt')
  value_lib.save_checkpoint(dna_value, value_lib.build_value_module(
      'dna', generator=torch.Generator().manual_seed(0), n_conv=3,
      channels=256, n_transformers=1, n_heads=2))
  for task, path in (('dna', rna_files['value_path']), ('rna', dna_value)):
    args = decode.parser().parse_args(
        ['--task', task, '--device', 'cpu', '--load_checkpoint_path', path])
    with pytest.raises(ValueError, match='Enformer|ConvGRU') as e:
      common.reject_unported(args)
    assert 'Enformer' in str(e.value) and 'ConvGRU' in str(e.value)


# ---------------------------------------------------------------------------
# whole decodes, by distribution
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def dist_pair():
  """A tiny RNA denoiser and a ConvGRU (the value net and the oracle) in
  both packages on the same weights."""
  jcfg = jax_tiny_config('rna')
  jcfg.sampling.steps = STEPS
  den = random_cnn_variables(jcfg, np.random.default_rng(20))
  den['params']['final_1']['kernel'] = 3.0 * den['params']['final_1'][
      'kernel']
  jm = jconvgru.ConvGRUValueModel()
  gvars = random_variables(jm.init, jnp.zeros((1, L, 4)),
                           rs=np.random.default_rng(21))
  gp = gvars['params']['ConvGRUTrunk_0']['GRUBlock_0']
  for cell in ('gru_fwd_0', 'gru_bwd_0'):
    gp[cell]['hh_kernel'] = (gp[cell]['hh_kernel'] / 8).astype(np.float32)
    gp[cell]['hh_bias'] = np.zeros(192, np.float32)
  return (JaxDiffusion(jcfg, variables=den), jm, gvars,
          Diffusion(_cfg(), device='cpu', backbone=cnn_from_jax(den)),
          convgru_from_jax(gvars))


@pytest.mark.parametrize('algo', ['svdd_mc', 'svdd_pm'])
def test_rna_decode_matches_svdd_tpu_in_distribution(dist_pair, algo):
  """SVDD-MC (the ConvGRU value net scoring M = 4 candidates) and
  SVDD-PM (the ConvGRU oracle on their posterior means) at B = 256: the
  ConvGRU rewards of the port's samples and JAX's agree by KS and q50/q80,
  and guidance lifts the reward over the port's unguided sampler."""
  jdiff, jm, gvars, diff, model = dist_pair
  joracle = JaxOracle(jm, gvars)
  oracle = rewards.RewardOracle(model)
  if algo == 'svdd_mc':
    value_fn = lambda tok: jm.apply(gvars, jax.nn.one_hot(tok, 4) * (
        tok != 4)[..., None])
    jres = jdiff.controlled_sampler(value_fn, B_DIST, sample_M=M)(
        jax.random.key(5))
    vf = value_lib.ValueFunction(model, L)
    tres = diff.controlled_sampler(vf.score_tokens, B_DIST, sample_M=M)(
        torch.Generator().manual_seed(5))
  else:
    jres = jdiff.tweedie_sampler(joracle.as_pair(), B_DIST, sample_M=M)(
        jax.random.key(5))
    tres = diff.tweedie_sampler(oracle, B_DIST, sample_M=M)(
        torch.Generator().manual_seed(5))
  jtok, ttok = np.asarray(jres.samples), tres.samples
  assert (jtok != 4).all() and (ttok != 4).all()
  with torch.inference_mode():
    score = lambda tok: oracle(mdlm.transform_samples(
        torch.as_tensor(np.array(tok)))).numpy()
    got, want = score(ttok), score(jtok)
    base = score(diff.sampler(B_DIST)(
        torch.Generator().manual_seed(6)).samples)
  ks = sps.ks_2samp(got, want)
  scale = max(np.std(np.concatenate([got, want])), 1e-6)
  assert ks.pvalue > KS_PVAL, (ks, np.quantile(got, [0.5, 0.8]),
                               np.quantile(want, [0.5, 0.8]))
  np.testing.assert_allclose(np.quantile(got, [0.5, 0.8]),
                             np.quantile(want, [0.5, 0.8]),
                             atol=0.35 * scale)
  assert got.mean() > base.mean()
