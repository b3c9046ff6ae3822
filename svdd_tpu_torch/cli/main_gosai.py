"""Diffusion pretraining entry (``svdd_tpu/cli/main_gosai.py``): the
``train``, ``ppl_eval`` and ``sample_eval`` modes, with the same flags and
defaults, plus ``--device``.

  python -m svdd_tpu_torch.cli.main_gosai --mode train --task dna \
      --max_steps 1000 --set training.accum_steps=2
  python -m svdd_tpu_torch.cli.main_gosai --mode train --task rna
  python -m svdd_tpu_torch.cli.main_gosai --mode ppl_eval
  python -m svdd_tpu_torch.cli.main_gosai --mode sample_eval \
      --set backbone=dimamba
  python -m svdd_tpu_torch.cli.main_gosai --mode sample_eval \
      --config svdd_tpu_torch/configs/text_mdlm.yaml --gen_ppl_model ar

``--task rna`` takes the RNA preset (L=50, ``rna_config``). ``--set``
reaches every MDLM variant of the config: ``parameterization=d3pm`` (with
``subs_masking=true`` to zero the MASK lane) or ``sedd``, ``T=128`` for
discrete-time training (D3PM adds its reconstruction term, a second
denoiser forward a microbatch), ``noise.type=cosine``, ``cosinesqr``,
``linear`` (with ``training.importance_sampling=true``) or
``geometric``, and ``model.cls_free_guidance=true`` for the
class-conditioned CNN (sampled at the null class). Under D3PM a reverse
step may draw MASK (4) again, so a state before the final noise removal
(which argmaxes over the other tokens) may hold it, as JAX's does.
``train`` trains the config's backbone (``--set backbone=dit``,
``dimamba``, or ``backbone=ar parameterization=ar`` for the AR
baseline) on the Gosai splits (the synthetic
split where no CSV is found, ``data/gosai.py``), logs to
``<log_dir>/<task>-pretrain.metrics.jsonl`` (train/loss every 100 steps;
val/nll and the sample-quality metrics of the EMA weights every
``eval.val_check_interval``, scored by the oracle of
``--eval_oracle_checkpoint_path``, a ``cli.train_oracle --save_path``
file of the task (the Enformer for dna, the ConvGRU for rna), or the
synthetic motif oracle without one) and
checkpoints into ``--ckpt_dir``, resuming from the newest checkpoint
there. ``ppl_eval`` reports the validation NLL, bits per token
and perplexity of the checkpoint's EMA weights; ``sample_eval`` draws
``sampling.num_sample_batches`` batches of ``loader.eval_batch_size``
unguided samples from them (the ``sampling.predictor``, ddpm,
ddpm_cache or analytic), logs the first four of each batch through the DNA
detokenizer and, with ``--gen_ppl_model``, their generative perplexity:
under that Hugging Face model, loaded from local files only, falling
back to the repo's AR backbone where it cannot be loaded
(``load_eval_model`` raises ``RuntimeError``, on which the JAX CLI falls
back; a fault while the model scores propagates here), or under the AR
backbone at once for ``ar``; the AR
net reads ``--gen_ppl_ar_checkpoint`` (``eval/gen_ppl.load_ar_scorer``).
With ``sampling.semi_ar`` it samples block-wise instead
(``sampling/semi_ar.py``: ``num_strides`` strides of ``stride_length``)
and scores nothing. Without a checkpoint the model takes random weights
from ``seed``. A ``--ckpt_dir`` may hold an export of the JAX package's
pretraining checkpoint (``scripts/export_jax_checkpoint.py``), whose EMA
weights ppl_eval and sample_eval read (train raises: an export holds no
trainer state). A ``--ckpt_dir`` holding other files and no checkpoint
of the port nor an export (an orbax directory, a reference ``.pt``)
raises, as do an oracle file that is neither this package's nor an
export, and such an AR-scorer file (ROADMAP A17).

Under ``torchrun`` ``train`` runs on the process grid of every process
(one a card, NCCL; ``svdd_tpu/cli/main_gosai.py:106-140``), at any world
size, one included: ``parallel.model_axis`` processes a model group, the
data axis what is left, cut down to a divisor of
``loader.global_batch_size`` (the processes past the grid idle, with a
warning); each data shard reads its rows of the splits (``--shard_data``:
its contiguous rows of the CSVs) and ``parallel.fsdp=true`` shards the
state (``train/diffusion.py``):

  torchrun --nproc_per_node=1 -m svdd_tpu_torch.cli.main_gosai \
      --mode train --set training.accum_steps=2 parallel.fsdp=true

With ``parallel.pipeline_stages=S`` > 1 ``train`` pipelines the DiT's
blocks over the first S processes instead (a pipe grid, JAX's
``svdd_tpu/cli/main_gosai.py:109-118``; ``parallel/pipeline.py``): each
process a stage, each reading the whole batch (the data is not sharded
over the stages), ``model.dropout=0``; ``pipeline_microbatches`` (4 S at
0) and ``pipeline_virtual`` (the interleaved schedule) as JAX's. The
pipelined DiT runs in f32: at the default bf16 precision its blocks
return f32 where the schedule hands on bf16, and the first step raises
JAX's TypeError, as JAX's does. One H100 holds one stage (NCCL puts one
process on a card):

  torchrun --nproc_per_node=S -m svdd_tpu_torch.cli.main_gosai \
      --mode train --set backbone=dit parallel.pipeline_stages=S \
      model.dropout=0 parallel.precision=fp32

``sample_eval`` ignores the pipeline settings, as JAX's; ``ppl_eval``
raises JAX's ValueError for them (no pipe grid: JAX's builds its
trainer's pipelined step, which needs one).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from svdd_tpu_torch import checkpoint as ckpt_lib
from svdd_tpu_torch import rewards
from svdd_tpu_torch.cli import common
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.config import Config, dna_config, rna_config
from svdd_tpu_torch.data import gosai
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.eval import gen_ppl, validation
from svdd_tpu_torch.observability import MetricsLogger
from svdd_tpu_torch.parallel import mesh as mesh_lib
from svdd_tpu_torch.sampling.semi_ar import semi_ar_sample
from svdd_tpu_torch.train import diffusion as train_diff

LOGGER = logging.getLogger(__name__)


def parse_overrides(pairs):
  """['a.b=1', ...] -> {'a': {'b': 1}}, values parsed as JSON where
  they are JSON."""
  out = {}
  for pair in pairs or []:
    k, v = pair.split('=', 1)
    cur = out
    parts = k.split('.')
    for p in parts[:-1]:
      cur = cur.setdefault(p, {})
    try:
      v = json.loads(v)
    except json.JSONDecodeError:
      pass
    cur[parts[-1]] = v
  return out


def build_config(args) -> Config:
  if args.config:
    cfg = Config.from_yaml(args.config)
  else:
    cfg = rna_config() if args.task == 'rna' else dna_config()
  overrides = parse_overrides(args.set)
  return cfg.override(**overrides) if overrides else cfg


def _reject_unported(args, cfg: Config):
  """Raise for what this package cannot read (before any model is built);
  returns the export of a denoiser that ``--ckpt_dir`` holds in place of
  the port's checkpoints, or None."""
  oracle = args.eval_oracle_checkpoint_path
  if ckpt_lib.is_export_file(oracle):
    common.check_value_export(oracle, cfg.task, leaves=False)
  elif oracle:
    value_lib.load_checkpoint(oracle, mmap=True, task=cfg.task)
  if args.gen_ppl_ar_checkpoint:
    gen_ppl.ar_checkpoint(args.gen_ppl_ar_checkpoint)
  d = args.ckpt_dir
  export = None
  if d and os.path.exists(d) and not train_diff.has_checkpoint(d):
    export = ckpt_lib.export_in(d, common.DENOISER_EXPORTS)
    if export is not None:
      if args.mode == 'train':
        raise ValueError(f'--ckpt_dir {d}: an export holds the EMA weights '
                         'of a JAX pretraining state, not the trainer state '
                         'a training run resumes from')
    elif not os.path.isdir(d) or os.listdir(d):
      if ckpt_lib.is_orbax_dir(d):
        raise NotImplementedError(ckpt_lib.orbax_message('--ckpt_dir', d))
      raise NotImplementedError(
          f'--ckpt_dir {d}: holds no checkpoint of this package nor an '
          "export of the JAX package's (ROADMAP A17: "
          'scripts/export_jax_checkpoint.py writes one)')
  return export


def _sample_eval_hook(cfg: Config, args):
  """The in-training sample-quality hook: 2 batches of up to 64 samples
  from the EMA weights against the train and val splits, scored by the
  task's oracle of ``--eval_oracle_checkpoint_path`` (the RNA ConvGRU or
  the DNA Enformer) or the synthetic motif oracle."""
  datasets = {split: gosai.GosaiDataset(split, length=cfg.model.length,
                                        data_dir=args.data_dir)
              for split in ('train', 'val')}
  if args.eval_oracle_checkpoint_path:
    oracle_fn = common.load_oracle(args.eval_oracle_checkpoint_path,
                                   cfg.task, args.device)
  else:
    oracle_fn = rewards.synthetic_motif_oracle(cfg.model.length)
    LOGGER.warning('sample-eval: no --eval_oracle_checkpoint_path, using '
                   'the synthetic motif oracle')
  bs = min(cfg.loader.eval_batch_size, 64)

  def hook(ema_model, generator):
    return validation.distribution_eval(ema_model, datasets, generator,
                                        oracle_fn=oracle_fn, n_batches=2,
                                        batch_size=bs)
  return hook


def train_mesh(cfg: Config, device: str):
  """The training grid under torchrun (module docstring), or None
  without a process group. A process past the grid gets None too. With
  ``parallel.pipeline_stages`` > 1, the pipe grid of the first S
  processes."""
  stages = cfg.parallel.pipeline_stages
  if not mesh_lib.initialize_multihost(device=device):
    if stages > 1:
      raise ValueError(f'pipeline_stages={stages} but only 1 devices')
    return None
  world = torch.distributed.get_world_size()
  if stages > 1:
    if world < stages:
      raise ValueError(f'pipeline_stages={stages} but only {world} devices')
    mesh = mesh_lib.make_pipe_mesh(stages)
    LOGGER.info('pipeline grid: %s', None if mesh is None else mesh.shape)
    return mesh
  model_axis = max(1, cfg.parallel.model_axis)
  if world % model_axis:
    raise ValueError(f'{world} processes not divisible by '
                     f'parallel.model_axis={model_axis}')
  data_axis = world // model_axis
  while data_axis > 1 and cfg.loader.global_batch_size % data_axis:
    data_axis -= 1
  used = data_axis * model_axis
  if used < world:
    LOGGER.warning('global batch %d not divisible by %d processes; using a '
                   '%dx%d grid on %d of them', cfg.loader.global_batch_size,
                   world, data_axis, model_axis, used)
  mesh = mesh_lib.make_mesh(data_axis, model_axis, list(range(used)))
  LOGGER.info('grid: %s', None if mesh is None else mesh.shape)
  return mesh


def _train(cfg: Config, args, backbone) -> dict:
  mesh = train_mesh(cfg, args.device)
  if mesh is None and torch.distributed.is_initialized():
    return {'state': None, 'metrics_path': None}    # past the grid
  num_shards, shard_index = mesh_lib.local_shard_info(mesh)
  train_it, valid_it, _ = gosai.get_dataloaders(
      cfg, num_shards=num_shards, shard_index=shard_index,
      data_dir=args.data_dir, shard_data=args.shard_data)
  model = Diffusion(cfg, device=args.device, backbone=backbone)
  lead = mesh is None or mesh.rank == 0
  logger = MetricsLogger(log_dir=args.log_dir,
                         run_name=f'{cfg.task}-pretrain') if lead else None
  hook = None if args.no_sample_eval else _sample_eval_hook(cfg, args)
  trainer = train_diff.Trainer(model, cfg, ckpt_dir=args.ckpt_dir,
                               logger=logger, sample_eval_fn=hook, mesh=mesh)
  try:
    state = trainer.init_or_restore(train_it)
    state = trainer.fit(state, train_it, valid_it, num_steps=args.max_steps)
    if args.ckpt_dir:
      train_diff.save_checkpoint(args.ckpt_dir, state, train_it.state_dict())
  finally:
    if lead:
      logger.finish()
  return {'state': state, 'metrics_path': logger.path if lead else None}


def _exported(cfg: Config, args, backbone, export):
  """``backbone``, or, where ``--ckpt_dir`` holds no checkpoint of the
  port but an export (``export``, from ``_reject_unported``), the
  denoiser holding the export's weights."""
  if backbone is not None or export is None:
    return backbone
  LOGGER.info('read the exported diffusion checkpoint %s', export)
  return common.export_denoiser(export, cfg, args.device)


def _restored(cfg: Config, args, backbone, export=None) -> Diffusion:
  """The model, holding the EMA weights of the newest checkpoint under
  ``--ckpt_dir`` where there is one (the port's, else ``export``)."""
  exported = _exported(cfg, args, backbone, export)
  model = Diffusion(cfg, device=args.device, backbone=exported)
  if args.ckpt_dir and train_diff.has_checkpoint(args.ckpt_dir):
    train_diff.load_ema_weights(model,
                                train_diff.checkpoint_file(args.ckpt_dir))
  elif args.ckpt_dir and exported is backbone:   # no export read
    LOGGER.warning('no checkpoint under --ckpt_dir %s: a randomly '
                   'initialized model', args.ckpt_dir)
  return model


def _ppl_eval(cfg: Config, args, backbone, export) -> dict:
  """NLL, bits per token and perplexity over 16 validation batches, on
  the EMA weights of the newest checkpoint under ``--ckpt_dir``."""
  _, valid_it, _ = gosai.get_dataloaders(cfg, skip_train=True,
                                         data_dir=args.data_dir)
  # an export's weights are the fresh state's, and so its EMA's
  model = Diffusion(cfg, device=args.device,
                    backbone=_exported(cfg, args, backbone, export))
  trainer = train_diff.Trainer(model, cfg, ckpt_dir=args.ckpt_dir)
  nll = trainer.evaluate(trainer.init_or_restore(), valid_it, max_batches=16)
  out = {'nll': nll, 'bpd': nll / np.log(2), 'ppl': float(np.exp(nll))}
  LOGGER.info('val/nll %.4f bpd %.4f ppl %.4f', out['nll'], out['bpd'],
              out['ppl'])
  return out


def _sample_eval(cfg: Config, args, backbone, ar_model, export) -> dict:
  model = _restored(cfg, args, backbone, export)
  if cfg.sampling.semi_ar:
    steps, _, full = semi_ar_sample(
        model, cfg.loader.eval_batch_size, cfg.sampling.stride_length,
        cfg.sampling.num_strides,
        torch.Generator(model.device).manual_seed(0))
    LOGGER.info('semi-AR: %d denoiser calls, samples %s', steps,
                full.shape)
    for s in gosai.batch_dna_detokenize(full[:4]):
      LOGGER.info('sample: %s', s)
    return {'tokens': full, 'gen_ppl': None, 'sampling_steps': steps}
  sampler = model.sampler(cfg.loader.eval_batch_size)
  all_tokens = []
  for i in range(cfg.sampling.num_sample_batches):
    res = sampler(torch.Generator(model.device).manual_seed(i))
    tokens = res.samples.cpu().numpy()
    all_tokens.append(tokens)
    for s in gosai.batch_dna_detokenize(tokens[:4]):
      LOGGER.info('sample: %s', s)
  tokens = np.concatenate(all_tokens)
  ppl = None

  def ar_fallback() -> float:
    if ar_model is None and not args.gen_ppl_ar_checkpoint:
      LOGGER.warning('gen_ppl AR fallback: no --gen_ppl_ar_checkpoint, '
                     'scoring with a randomly initialized AR net')
    scorer = gen_ppl.ar_fallback_scorer(cfg, args.gen_ppl_ar_checkpoint,
                                        device=model.device, model=ar_model)
    out = gen_ppl.compute_generative_perplexity_local(tokens, scorer)
    LOGGER.info('val/gen_ppl (local ar backbone): %.4f', out)
    return out

  if args.gen_ppl_model == 'ar':
    ppl = ar_fallback()
  elif args.gen_ppl_model:
    # only a model that cannot be loaded falls back; a fault while it
    # scores (on the card) propagates
    try:
      eval_model, tokenizer = gen_ppl.load_eval_model(args.gen_ppl_model)
    except RuntimeError as exc:
      LOGGER.warning('gen_ppl: HF model unavailable (%s); falling back to '
                     'the local AR backbone', exc)
      return {'tokens': tokens, 'gen_ppl': ar_fallback()}
    ppl = gen_ppl.compute_generative_perplexity(
        gosai.batch_dna_detokenize(tokens), eval_model=eval_model,
        tokenizer=tokenizer, max_length=cfg.model.length,
        device=model.device)
    LOGGER.info('val/gen_ppl (%s): %.4f', args.gen_ppl_model, ppl)
  return {'tokens': tokens, 'gen_ppl': ppl}


def run(args, cfg: Config | None = None, backbone=None, ar_model=None
        ) -> dict:
  """Run ``args.mode``. ``cfg`` replaces the config the flags build;
  ``backbone`` and ``ar_model`` replace the randomly initialised
  denoiser and gen-ppl scorer (tests). Returns, for ``train``,
  {'state': the TrainState, 'metrics_path'}; ``ppl_eval``, {'nll', 'bpd',
  'ppl'}; ``sample_eval``, {'tokens': (N, L) int array of every batch,
  'gen_ppl': float or None}."""
  cfg = cfg or build_config(args)
  export = _reject_unported(args, cfg)
  LOGGER.info('config:\n%s', json.dumps(cfg.to_dict(), indent=2,
                                        default=str))
  common.full_f32()
  if args.mode == 'train':
    return _train(cfg, args, backbone)
  if args.mode == 'ppl_eval':
    return _ppl_eval(cfg, args, backbone, export)
  return _sample_eval(cfg, args, backbone, ar_model, export)


def parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description='MDLM diffusion pretraining')
  p.add_argument('--task', default='dna', choices=['dna', 'rna'])
  p.add_argument('--mode', default='train',
                 choices=['train', 'ppl_eval', 'sample_eval'])
  p.add_argument('--config', default=None,
                 help='yaml config overlay (needs PyYAML)')
  p.add_argument('--set', nargs='*', default=None,
                 help='dotted overrides, e.g. sampling.steps=64')
  p.add_argument('--ckpt_dir', default='./checkpoints',
                 help="this package's checkpoints: train writes and resumes "
                      'from them, ppl_eval and sample_eval read the EMA '
                      "weights (or those of an export of the JAX package's "
                      'checkpoint held there); a directory holding other '
                      'files raises')
  p.add_argument('--data_dir', default=None,
                 help='directory of gosai_{train,val,test}.csv (default '
                      '$SVDD_DATA_DIR, else /data/svdd; the synthetic '
                      'split without one)')
  p.add_argument('--max_steps', type=int, default=None,
                 help='training steps of this run (optim.max_steps)')
  p.add_argument('--shard_data', action='store_true', default=False,
                 help='on a grid of several data shards: each reads its '
                      'contiguous rows of the CSVs (no effect on one)')
  p.add_argument('--log_dir', default='./log',
                 help='metrics JSONL output directory')
  p.add_argument('--no_sample_eval', action='store_true', default=False,
                 help='skip the in-training sample-quality validation')
  p.add_argument('--eval_oracle_checkpoint_path', default=None,
                 help='a cli.train_oracle --save_path file of the task, '
                      'the sample-quality oracle (other files raise)')
  p.add_argument('--gen_ppl_model', default=None,
                 help='a Hugging Face causal LM name or path for the '
                      'generative perplexity in sample_eval mode, from '
                      "local files only, or 'ar' to score with the repo's "
                      'own AR backbone (also the fallback where the named '
                      'model cannot be loaded)')
  p.add_argument('--gen_ppl_ar_checkpoint', default=None,
                 help='the AR scorer: a pretraining checkpoint of this '
                      'package of the ar backbone, or an export of the '
                      "JAX package's (random init and a warning without "
                      'one)')
  p.add_argument('--device', type=str, default='cuda',
                 help="torch device of the run ('cuda' or 'cpu')")
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
