"""The reward-lift pipelines of the DNA and RNA tasks, stage by stage
(``scripts/demo_dna_pipeline.py`` and ``scripts/demo_rna_pipeline.py``
of the JAX package, which stay as they are): pretrain the denoiser on
the Gosai training split, train the reward oracle on its labels, train
the value net against the frozen denoiser with the oracle's rewards as
MC targets, decode SVDD-MC and SVDD-PM, and report the reward quantiles
of the guided batches beside the unguided baseline and best-of-N.

Each stage is a function of its step counts and widths, so a test runs
them at tiny sizes on the CPU and ``scripts/torch_demo_{dna,rna}_pipeline.py``
run them with the JAX scripts' recipe on the card. The oracles and the
DNA value net train with optax's ``adamw`` at its defaults (betas (0.9,
0.999), eps 1e-8, weight decay 1e-4; torch's AdamW defaults to 1e-2)
and no clipping, the RNA value net with ``ValueTrainer``'s defaults
(clip 1.0, betas (0.9, 0.95), weight decay 0.1), as in the JAX scripts;
both value nets through ``ValueTrainer``. Randomness comes from
generators seeded as the JAX scripts seed their keys (key(k) -> seed
k), in other streams.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import time
from typing import Callable, Optional

import torch

from svdd_tpu_torch import rewards
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import train_oracle
from svdd_tpu_torch.cli.common import full_f32
from svdd_tpu_torch.config import Config
from svdd_tpu_torch.data.gosai import (FaultTolerantIterator, GosaiDataset,
                                       batch_dna_detokenize)
from svdd_tpu_torch.decode import DecodeResult, run_decode
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.eval.metrics import kmer_pearson, quantile_report
from svdd_tpu_torch.models.blocks import DropoutMasks
from svdd_tpu_torch.models.convgru import ConvGRUValueModel
from svdd_tpu_torch.models.enformer import EnformerValueModel
from svdd_tpu_torch.train import diffusion as train_diff
from svdd_tpu_torch.train import value as train_value

LOGGER = logging.getLogger(__name__)
ADAMW_DECAY = train_oracle.WEIGHT_DECAY   # optax.adamw's default


@dataclasses.dataclass
class Clock:
  """Wall seconds of each stage, the device's queue drained at each
  mark."""
  device: torch.device
  seconds: dict = dataclasses.field(default_factory=dict)
  _t0: float = dataclasses.field(default_factory=time.perf_counter)

  def mark(self, stage: str) -> float:
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)
    now = time.perf_counter()
    self.seconds[stage] = now - self._t0
    self._t0 = now
    LOGGER.info('stage %s: %.1f s', stage, self.seconds[stage])
    return self.seconds[stage]


def card() -> Optional[str]:
  """The card's ``name, power.limit`` as nvidia-smi prints them, or None
  without one."""
  if not torch.cuda.is_available():
    return None
  try:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
  except (OSError, subprocess.TimeoutExpired):
    return None
  return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def datasets(length: int, data_dir: str):
  """The Gosai train and val splits at ``length`` (the synthetic split
  where ``data_dir`` holds no CSV)."""
  return (GosaiDataset('train', length=length, data_dir=data_dir),
          GosaiDataset('val', length=length, data_dir=data_dir))


# ---------------------------------------------------------------------------
# stage 1: pretraining
# ---------------------------------------------------------------------------


def pretrain(cfg: Config, train: GosaiDataset, steps: int, device,
             seed_offset: int = 0, log_every: int = 250):
  """``steps`` MDLM steps of the CNN denoiser at ``cfg.loader.batch_size``
  on ``train`` (the iterator seeded ``seed_offset``, the weights
  ``seed_offset``, the noise ``1 + seed_offset``). Returns the denoiser
  holding the EMA weights, and the losses read every ``log_every`` steps
  and at the last."""
  cfg = cfg.override(seed=seed_offset)
  model = Diffusion(cfg, device=device)
  trainer = train_diff.Trainer(model, cfg)
  state = train_diff.init_state(
      model, cfg, torch.Generator(model.device).manual_seed(1 + seed_offset))
  it = iter(FaultTolerantIterator(train, cfg.loader.batch_size,
                                  seed=seed_offset))
  losses = {}
  for i in range(steps):
    loss = train_diff.train_step(state, next(it), cfg)
    if i % log_every == 0 or i == steps - 1:
      losses[i] = float(loss)
      LOGGER.info('diffusion step %d loss %.4f', i, losses[i])
  ema = trainer.eval_model(state)
  return Diffusion(cfg, device=device, backbone=ema.backbone), losses


def kmer_quality(model: Diffusion, train: GosaiDataset, n: int = 256,
                 seed: int = 7) -> float:
  """3-mer Pearson correlation of ``n`` unguided samples with the first
  1,024 training sequences."""
  samples = model.sampler(n)(
      torch.Generator(model.device).manual_seed(seed)).samples
  return kmer_pearson(batch_dna_detokenize(samples.cpu().numpy()),
                      batch_dna_detokenize(train.seqs[:1024]))


# ---------------------------------------------------------------------------
# stage 2: the reward oracle
# ---------------------------------------------------------------------------


def train_oracle_net(module: torch.nn.Module, train: GosaiDataset,
                     val: GosaiDataset, steps: int, learning_rate: float,
                     device, batch_size: int = 16, iter_seed: int = 3,
                     dropout_seed: int = 4):
  """``steps`` steps of ``cli.train_oracle``'s step (AdamW at optax's
  defaults, the MSE over the module's tasks) on batches of ``train``.
  Returns the oracle (task 0 read), the last loss and the Pearson
  correlation of task 0 on the first 512 validation rows."""
  module = module.to(device)
  optimizer = train_oracle.make_optimizer(module, learning_rate)
  gen = torch.Generator(device).manual_seed(dropout_seed)
  it = iter(FaultTolerantIterator(train, batch_size, seed=iter_seed))
  loss = None
  for _ in range(steps):
    b = next(it)
    loss = train_oracle.train_step(
        module, optimizer, torch.as_tensor(b['seqs'], device=device).long(),
        torch.as_tensor(b['clss'], device=device), DropoutMasks(generator=gen))
  oracle = rewards.RewardOracle(module)
  r = train_oracle.val_pearson(module, val, device)
  return oracle, float(loss), r


# ---------------------------------------------------------------------------
# stage 3: the value net
# ---------------------------------------------------------------------------


def fit_value_net(vf: value_lib.ValueFunction, diffusion: Diffusion,
                  oracle: Callable, steps: int,
                  tcfg: train_value.ValueTrainerConfig, seed: int = 6):
  """``steps`` iterations of ``ValueTrainer`` (each a trajectory of the
  frozen denoiser, its MC targets from the oracle's reward of the final
  samples, one grad step). Returns the value function and the first and
  last losses."""
  trainer = train_value.ValueTrainer(diffusion, vf, oracle, tcfg)
  state = trainer.init_state(seed)
  losses = [trainer.train_step(state) for _ in range(steps)]
  return (trainer.updated_value_function(state), float(losses[0]),
          float(losses[-1]))


# ---------------------------------------------------------------------------
# stage 4: decoding and the report
# ---------------------------------------------------------------------------


def decode(diffusion: Diffusion, oracle: Callable,
           vf: value_lib.ValueFunction, batch_size: int = 256,
           sample_M: int = 10, seed: int = 44, m_schedule=None):
  """SVDD-MC (with its baseline and best-of-N), SVDD-PM and, given
  ``m_schedule``, scheduled-M SVDD-MC, on the trained nets."""
  kw = dict(gen_batch_num=1, batch_size=batch_size, sample_M=sample_M,
            seed=seed)
  out = {'mc': run_decode(diffusion, oracle, algo='svdd_mc',
                          value_fn=vf.score_tokens, **kw),
         'pm': run_decode(diffusion, oracle, algo='svdd_pm',
                          skip_best_of_n=True, **kw)}
  if m_schedule is not None:
    out['sched'] = run_decode(diffusion, oracle, algo='svdd_mc',
                              value_fn=vf.score_tokens, skip_best_of_n=True,
                              m_schedule=m_schedule, **kw)
  return out


def report(results: dict, sched_label: Optional[str] = None) -> dict:
  """The quantile report of the JAX scripts' rows."""
  mc: DecodeResult = results['mc']
  rows = {'baseline (pretrained)': mc.baseline_preds,
          'SVDD-MC': mc.reward_preds,
          'SVDD-PM': results['pm'].reward_preds,
          'best-of-N': mc.top_k}
  if 'sched' in results:
    rows[f'SVDD-MC sched {sched_label}'] = results['sched'].reward_preds
  return quantile_report(rows)


def q50_lifts(rep: dict) -> dict:
  """Each guided row's q50 over the baseline's."""
  base = rep['baseline (pretrained)']['q50']
  return {name: row['q50'] - base for name, row in rep.items()
          if name.startswith('SVDD')}


def synthetic_dir(root: str) -> str:
  """An empty directory under ``root``'s ``build/``: the data directory
  of a run that must draw the synthetic split whatever the host holds
  under $SVDD_DATA_DIR or /data/svdd."""
  path = os.path.join(root, 'build', 'pipeline_no_data')
  os.makedirs(path, exist_ok=True)
  if os.listdir(path):
    raise ValueError(f'{path} is not empty')
  return path


# ---------------------------------------------------------------------------
# the two pipelines
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Recipe:
  """Step counts and sizes of a pipeline; the defaults are the JAX
  scripts' (``demo_dna_pipeline.py:55-210``, ``demo_rna_pipeline.py:
  55-182``)."""
  pretrain_steps: int = 1200
  train_batch: int = 16
  oracle_steps: int = 400
  value_steps: int = 300
  decode_batch: int = 256
  sample_M: int = 10


def _pretrained(cfg: Config, train, recipe: Recipe, device,
                seed_offset: int, results: dict, clock: Clock) -> Diffusion:
  cfg = cfg.override(optim={'warmup_steps': 50, 'lr': 1e-3},
                     loader={'batch_size': recipe.train_batch})
  model, losses = pretrain(cfg, train, recipe.pretrain_steps, device,
                           seed_offset)
  results['diffusion_loss_first'] = losses[min(losses)]
  results['diffusion_loss_last'] = losses[max(losses)]
  clock.mark('pretrain')
  return model


def dna(cfg: Config, data_dir: str, device='cuda', recipe: Recipe = Recipe(),
        seed_offset: int = 0, m_schedule=None, sched_label=None,
        oracle_kwargs=None, value_kwargs=None):
  """The DNA pipeline: pretrain; the 3-task Enformer oracle in bf16
  (AdamW 3e-4, ``recipe.oracle_steps`` steps at 16); the Enformer value
  net in bf16 (AdamW 3e-4, each step a batch-8 trajectory and 3 mid
  states); SVDD-MC and SVDD-PM at M=10 with seed 44 + ``seed_offset``,
  and scheduled-M SVDD-MC given ``m_schedule``. ``oracle_kwargs`` and
  ``value_kwargs`` replace the full Enformer widths (tests). Returns
  (the JSON's results, the decodes)."""
  full_f32()
  device = torch.device(device)
  clock = Clock(device)
  results = {}
  train, val = datasets(cfg.model.length, data_dir)
  model = _pretrained(cfg, train, recipe, device, seed_offset, results,
                      clock)
  bf16 = torch.bfloat16
  gen = torch.Generator(device).manual_seed(2 + seed_offset)
  oracle, oloss, r = train_oracle_net(
      EnformerValueModel(n_tasks=3, compute_dtype=bf16, generator=gen,
                         **(oracle_kwargs or {})),
      train, val, recipe.oracle_steps, 3e-4, device, recipe.train_batch,
      iter_seed=3 + seed_offset, dropout_seed=4 + seed_offset)
  results['oracle_mse_last'] = oloss
  results['oracle_val_pearson_hepg2'] = r
  clock.mark('oracle')
  gen = torch.Generator(device).manual_seed(5 + seed_offset)
  vf = value_lib.ValueFunction(
      EnformerValueModel(n_tasks=1, compute_dtype=bf16, generator=gen,
                         **(value_kwargs or {})).to(device),
      cfg.model.length)
  # optax.adamw(3e-4) at its defaults, no clipping; 3 mid states a step
  vf, first, last = fit_value_net(
      vf, model, oracle, recipe.value_steps, train_value.ValueTrainerConfig(
          learning_rate=3e-4, betas=(0.9, 0.999), grad_norm_clip=None,
          weight_decay=ADAMW_DECAY, batch_size=8, mc_subsample=3),
      seed=6 + seed_offset)
  results['value_mse_first'], results['value_mse_last'] = first, last
  clock.mark('value')
  decodes = decode(model, oracle, vf, recipe.decode_batch, recipe.sample_M,
                   44 + seed_offset, m_schedule)
  clock.mark('decode')
  if m_schedule is not None:
    results['m_schedule'] = sched_label
  results['report'] = report(decodes, sched_label)
  results['q50_lift'] = q50_lifts(results['report'])
  results['stage_seconds'] = clock.seconds
  results['card'] = card()
  return results, decodes


def rna(cfg: Config, data_dir: str, device='cuda',
        recipe: Recipe = Recipe(oracle_steps=800)):
  """The RNA pipeline: pretrain (and the 3-mer Pearson of
  ``recipe.decode_batch`` samples, 256);
  the ConvGRU MRL oracle (AdamW 1e-3, ``recipe.oracle_steps`` steps at
  16); the ConvGRU value net through ``ValueTrainer`` (batch 16, rate
  1e-3); SVDD-MC and SVDD-PM at M=10 with seed 44. Returns (the JSON's
  results, the decodes)."""
  full_f32()
  device = torch.device(device)
  clock = Clock(device)
  results = {}
  train, val = datasets(cfg.model.length, data_dir)
  model = _pretrained(cfg, train, recipe, device, 0, results, clock)
  results['kmer_pearson'] = kmer_quality(model, train, recipe.decode_batch)
  clock.mark('kmer_pearson')
  oracle, oloss, r = train_oracle_net(
      ConvGRUValueModel(n_tasks=1, generator=torch.Generator(device)
                        .manual_seed(2)),
      train, val, recipe.oracle_steps, 1e-3, device, recipe.train_batch)
  results['oracle_mse_last'] = oloss
  results['oracle_val_pearson'] = r
  clock.mark('oracle')
  vf = value_lib.ValueFunction.create(
      'rna', cfg.model.length, torch.Generator(device).manual_seed(5))
  # the JAX script's first (compiling) step, then value_steps more
  vf, first, last = fit_value_net(
      vf, model, oracle, recipe.value_steps + 1,
      train_value.ValueTrainerConfig(batch_size=recipe.train_batch,
                                     learning_rate=1e-3, task='rna'))
  results['value_mse_first'], results['value_mse_last'] = first, last
  clock.mark('value')
  decodes = decode(model, oracle, vf, recipe.decode_batch, recipe.sample_M,
                   44)
  clock.mark('decode')
  results['report'] = report(decodes)
  results['q50_lift'] = q50_lifts(results['report'])
  results['stage_seconds'] = clock.seconds
  results['card'] = card()
  return results, decodes
