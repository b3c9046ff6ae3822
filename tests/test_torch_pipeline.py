"""The reward-lift pipelines of svdd_tpu_torch (``svdd_tpu_torch/pipeline.py``):
the stage functions chained at tiny widths on the CPU, and the committed
card runs of ``scripts/torch_demo_{dna,rna}_pipeline.py`` held to the
bands ``tests/test_quality_regression.py:80-150`` holds the JAX
package's committed runs to.

The bands. DNA: the q50 lifts over each run's baseline, pooled over the
three runs ('', .run2 with seed offset 100, .run3 with 200), within 0.7
to 1.4 times the JAX runs' pooled means (SVDD-MC 10.96, SVDD-PM 8.25);
the scheduled-M lift of run 2 (96:12,32:4) above 0.85 times its
constant-M lift. RNA: SVDD-MC's q50 above the baseline's by more than
3.5, SVDD-PM's by more than 5.0.
"""

import json
import os

import numpy as np
import pytest
import torch

from svdd_tpu_torch import pipeline
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.utils import parse_m_schedule
from torch_port_helpers import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(REPO, 'log')
TINY = pipeline.Recipe(pretrain_steps=3, train_batch=8, oracle_steps=2,
                       value_steps=2, decode_batch=8, sample_M=2)
ENFORMER = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2)
JAX_DNA_KEYS = {'diffusion_loss_last', 'oracle_val_pearson_hepg2',
                'value_mse_first', 'value_mse_last', 'report'}
JAX_RNA_KEYS = {'diffusion_loss_first', 'diffusion_loss_last',
                'kmer_pearson', 'oracle_val_pearson', 'value_mse_first',
                'value_mse_last', 'report'}
ROWS = ('baseline (pretrained)', 'SVDD-MC', 'SVDD-PM', 'best-of-N')


def _cfg(task):
  cfg = tiny_test_config(task)
  cfg.sampling.steps = 4
  return cfg


def _check(results, decodes, keys):
  assert keys <= set(results)
  assert set(ROWS) <= set(results['report'])
  assert set(results['stage_seconds']) >= {'pretrain', 'oracle', 'value',
                                           'decode'}
  assert results['card'] is None                 # no card on the CPU
  for res in decodes.values():
    assert res.reward_preds.shape == (TINY.decode_batch,)
    assert np.isfinite(res.reward_preds).all()
  assert np.isfinite([results['value_mse_first'], results['value_mse_last'],
                      results['diffusion_loss_last']]).all()


def test_rna_pipeline_stages_chain_on_the_cpu(tmp_path):
  """Pretrain, the ConvGRU oracle, ``ValueTrainer`` and the two decodes
  at L=16 with the JAX script's keys, plus each stage's seconds."""
  torch.manual_seed(0)
  results, decodes = pipeline.rna(_cfg('rna'), str(tmp_path), 'cpu', TINY)
  _check(results, decodes, JAX_RNA_KEYS)
  assert set(decodes) == {'mc', 'pm'}


def test_dna_pipeline_stages_chain_on_the_cpu(tmp_path):
  """The DNA pipeline with bf16 Enformers at test widths and a
  scheduled-M decode beside the constant-M ones."""
  results, decodes = pipeline.dna(
      _cfg('dna'), str(tmp_path), 'cpu', TINY, seed_offset=100,
      m_schedule=parse_m_schedule('3:2,1:1'), sched_label='3:2,1:1',
      oracle_kwargs=ENFORMER, value_kwargs=ENFORMER)
  _check(results, decodes, JAX_DNA_KEYS)
  assert set(decodes) == {'mc', 'pm', 'sched'}
  assert results['m_schedule'] == '3:2,1:1'
  assert 'SVDD-MC sched 3:2,1:1' in results['report']


def _q50(a):
  return float(np.quantile(np.asarray(a), 0.5))


def _load(name):
  return np.load(os.path.join(LOG, name))


@pytest.mark.parametrize('suffix', ['', '.run2', '.run3'])
def test_torch_demo_dna_json_records_the_card(suffix):
  """Each committed DNA run's JSON: the JAX script's keys, the stage
  seconds and the card's name and power limit; its report's q50s are
  the npz files' (run 2 with its scheduled-M row)."""
  with open(os.path.join(LOG, f'torch_demo_dna_pipeline{suffix}.json')) as f:
    results = json.load(f)
  assert JAX_DNA_KEYS <= set(results)
  assert 'H100' in results['card'] and ' W' in results['card']
  assert all(v > 0 for v in results['stage_seconds'].values())
  mc = _load(f'torch-demo-dna-HepG2{suffix}.npz')
  pm = _load(f'torch-demo-dna-HepG2_tw{suffix}.npz')
  assert set(mc.files) == set(pm.files) == {'decoding', 'baseline'}
  rep = results['report']
  assert rep['SVDD-MC']['q50'] == pytest.approx(_q50(mc['decoding']))
  assert rep['SVDD-PM']['q50'] == pytest.approx(_q50(pm['decoding']))
  assert rep['baseline (pretrained)']['q50'] == pytest.approx(
      _q50(mc['baseline']))
  if suffix == '.run2':
    assert results['m_schedule'] == '96:12,32:4'


def test_torch_demo_dna_lifts_hold_the_jax_bands():
  """The pooled q50 lifts of the three committed DNA runs within
  0.7-1.4 times the JAX runs' pooled means; run 2's scheduled-M lift
  above 0.85 times its constant-M lift."""
  mc_lifts, pm_lifts = [], []
  for suffix in ('', '.run2', '.run3'):
    mc = _load(f'torch-demo-dna-HepG2{suffix}.npz')
    pm = _load(f'torch-demo-dna-HepG2_tw{suffix}.npz')
    base = _q50(mc['baseline'])
    mc_lifts.append(_q50(mc['decoding']) - base)
    pm_lifts.append(_q50(pm['decoding']) - base)
  mc_lift, pm_lift = float(np.mean(mc_lifts)), float(np.mean(pm_lifts))
  assert 0.7 * 10.96 < mc_lift < 1.4 * 10.96, (mc_lifts, pm_lifts)
  assert 0.7 * 8.25 < pm_lift < 1.4 * 8.25, (mc_lifts, pm_lifts)
  mc = _load('torch-demo-dna-HepG2.run2.npz')
  sched = _load('torch-demo-dna-HepG2_sched.run2.npz')
  base = _q50(mc['baseline'])
  assert _q50(sched['decoding']) - base > 0.85 * (_q50(mc['decoding'])
                                                  - base)


def test_torch_demo_rna_lifts_hold_the_jax_bands():
  """The committed RNA run: SVDD-MC's q50 above the baseline's by more
  than 3.5, SVDD-PM's by more than 5.0; its JSON records the card."""
  mc = _load('torch-demo-rna-MRL.npz')
  pm = _load('torch-demo-rna-MRL_tw.npz')
  base = _q50(mc['baseline'])
  assert _q50(mc['decoding']) > base + 3.5, (base, _q50(mc['decoding']))
  assert _q50(pm['decoding']) > base + 5.0, (base, _q50(pm['decoding']))
  with open(os.path.join(LOG, 'torch_demo_rna_pipeline.json')) as f:
    results = json.load(f)
  assert JAX_RNA_KEYS <= set(results)
  assert 'H100' in results['card'] and ' W' in results['card']
