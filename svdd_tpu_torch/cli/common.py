"""Shared CLI scaffold (``svdd_tpu/cli/common.py``): the same flag
surface, plus ``--device``, the model loaders and the run tail that
writes the npz and one JSONL metrics row.

The checkpoint flags read the port's own files:
``--diffusion_checkpoint_path`` a pretraining checkpoint of
``main_gosai --mode train`` (a ``step_<n>.pt``, or its ``--ckpt_dir``),
whose EMA weights the denoiser takes; ``--reward_checkpoint_path`` a
``cli.train_oracle --save_path`` file, the Enformer reward oracle;
``--load_checkpoint_path`` and ``--pre_model_path`` a ``cli.train
--save_path`` file, the value net. A file of the other task (an
Enformer for ``--task rna``, a ConvGRU for ``--task dna``) raises
``ValueError``.

They also import the reference's torch pickles, as the JAX CLIs do
(``svdd_tpu/cli/common.py:105-241``): any ``.pt``, ``.pth`` or
``.ckpt`` file this package did not write (``checkpoint.
is_reference_file``) is read with ``checkpoint.import_torch_state_dict``,
its prefix found among JAX's candidates ('backbone.' or
'module.backbone.' for the denoiser, 'model.' or 'module.' for an
oracle, 'module.' for a value net), mapped to the flax layout by
``importers/`` and into the port's modules by ``weights.*_from_jax``:
the CNN or DiT denoiser, the Enformer (DNA) or ConvGRU (RNA) oracle and
value net at the file's widths.

The JAX package's own checkpoints come as exports
(``scripts/export_jax_checkpoint.py``, run where JAX runs, writes an
orbax directory as one ``.npz``; ``checkpoint.load_export``): every flag
reads one, through ``weights.*_from_jax`` at the run's config (the
denoiser of ``cfg.backbone``) or the file's widths (the Enformer or
ConvGRU, by the tree). An orbax directory itself, or any other file,
raises ``NotImplementedError`` naming ROADMAP A17 and the script.
Without the flags
the models take random weights drawn from the config's seed (diffusion)
and seed 1 (value net), and the reward is the synthetic motif oracle,
as the JAX CLI does without checkpoint flags.

``--task rna`` is the RNA 5'UTR task: L=50 (``rna_config``), the
ConvGRU value net and MRL oracle. ``--task rna_saluki`` is the saluki
stability task at the same length: the four-channel ConvGRU value net,
and the six-channel ConvGRU oracle over the padded (N,
``--saluki_final_length``, 6) input (``mdlm.transform_samples_saluki``)
with the constant body of ``load_saluki_body`` behind each sequence.
Without ``--reward_checkpoint_path`` that oracle is randomly initialised
(with JAX's warning), not the motif oracle. DPS, DG, TDS and classifier
guidance refuse the task with JAX's ``SystemExit`` (``reject_saluki``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from svdd_tpu_torch import checkpoint as ckpt_lib
from svdd_tpu_torch import diffusion as diffusion_lib
from svdd_tpu_torch import importers, rewards, weights
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.config import Config, dna_config, rna_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.eval.metrics import quantile_report
from svdd_tpu_torch.train import diffusion as train_diff

LOGGER = logging.getLogger(__name__)

VALUE_CHECKPOINT_FLAGS = ('load_checkpoint_path', 'pre_model_path',
                          'reward_checkpoint_path')
TASKS = ('dna', 'rna', 'rna_saluki')


def make_parser(description: str) -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=description)
  p.add_argument('--run_name', type=str, required=False)
  p.add_argument('--debug', action='store_true', default=False)
  p.add_argument('--task', type=str, default='dna',
                 help='dna / rna / rna_saluki')
  p.add_argument('--saluki_body', type=int, default=0,
                 help='selects saluki_body_{N}.npy inside $SVDD_DATA_DIR '
                      '(the current directory without it)')
  p.add_argument('--saluki_body_path', type=str, default=None,
                 help=".npy file of the saluki constant 'body' (Lb, 6) "
                      'appended behind each sequence (rna_saluki task); '
                      'wins over --saluki_body')
  p.add_argument('--saluki_final_length', type=int, default=12288,
                 help='padded saluki oracle input length')
  p.add_argument('--n_task', type=int, default=1)
  p.add_argument('--model', type=str, default='enformer',
                 help="enformer; cli.train also takes multienformer (the "
                      "CLIs raise for timedenformer, as JAX's do)")
  p.add_argument('--batch_size', type=int, default=256)
  p.add_argument('--sample_M', type=int, default=5)
  p.add_argument('--val_batch_num', type=int, default=1)
  p.add_argument('--seed', type=int, default=44)
  p.add_argument('--reward_name', type=str, default='HepG2')
  p.add_argument('--load_checkpoint_path', type=str, default=None)
  p.add_argument('--pre_model_path', type=str, default=None)
  p.add_argument('--cdq', action='store_true', default=False)
  p.add_argument('--dist', action='store_true', default=False,
                 help="value training: shard the self-generated batch over "
                      "a 'data' grid of every process (cli.train; the "
                      'decoders take no grid, as in svdd_tpu)')
  p.add_argument('--diffusion_checkpoint_path', type=str, default=None)
  p.add_argument('--reward_checkpoint_path', type=str, default=None)
  p.add_argument('--num_steps', type=int, default=None,
                 help='override sampling steps')
  p.add_argument('--length', type=int, default=None,
                 help='override sequence length')
  p.add_argument('--out_dir', type=str, default='./log')
  p.add_argument('--skip_best_of_n', action='store_true', default=False)
  p.add_argument('--device', type=str, default='cuda',
                 help="torch device of the run ('cuda' or 'cpu')")
  return p


def add_guidance_scale(parser: argparse.ArgumentParser,
                       default: float) -> None:
  """``--guidance_scale``, with the JAX CLI's default for the decoder."""
  parser.add_argument('--guidance_scale', type=float, default=default)


def full_f32() -> None:
  """Float32 runs compute in full f32: TF32 off for matmuls and cuDNN
  convolutions."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def reject_saluki(args, cli_name: str) -> None:
  """The gradient-guided decoders take (N, L, 4) one-hots; only the
  tweedie path builds the saluki oracle's input
  (``svdd_tpu/cli/common.py:reject_saluki``)."""
  if args.task == 'rna_saluki':
    raise SystemExit(
        f'{cli_name} does not support --task rna_saluki; use '
        'decode.py (SVDD-MC) or decode_tweedie.py (SVDD-PM)')


DENOISER_EXPORTS = ('diffusion', 'variables')
VALUE_EXPORTS = ('variables', 'value_state')


def _foreign(flag: str, path: str, what: str) -> NotImplementedError:
  """The error of a checkpoint flag given a file it cannot read."""
  if ckpt_lib.is_orbax_dir(path):
    return NotImplementedError(ckpt_lib.orbax_message(flag, path))
  return NotImplementedError(
      f'{flag} {path}: not {what} of this package nor a reference torch '
      "pickle nor an export of the JAX package's checkpoints (ROADMAP "
      'A17: scripts/export_jax_checkpoint.py writes one)')


def diffusion_checkpoint(path: str) -> str:
  """The port's pretraining checkpoint at ``path``: the file itself, or
  the newest ``step_<n>.pt`` of a directory (at its top, else under
  ``best/``). Any other file or directory raises naming A17."""
  found = train_diff.checkpoint_file(path)
  ckpt = None
  if found is not None:
    try:
      ckpt = torch.load(found, map_location='cpu', weights_only=True,
                        mmap=True)
    except Exception:   # not a torch file, or pickled objects
      ckpt = None
  if not isinstance(ckpt, dict) or ckpt.get('format') != train_diff.FORMAT:
    raise _foreign('--diffusion_checkpoint_path', path,
                   f'a pretraining checkpoint ({train_diff.FORMAT})')
  return found


def export_task(tree: dict) -> str:
  """The task whose value-net architecture an exported tree holds."""
  return 'rna' if 'ConvGRUTrunk_0' in tree.get('params', {}) else 'dna'


def check_value_export(path: str, task: str,
                       leaves: bool = True) -> ckpt_lib.Export:
  """The value-net export at ``path``, of ``task``'s architecture (without
  its leaves, ``ckpt_lib.export_header``, where ``leaves`` is false)."""
  read = ckpt_lib.load_export if leaves else ckpt_lib.export_header
  e = read(path, VALUE_EXPORTS)
  want, held = value_lib.checkpoint_task(task), export_task(e.tree)
  if held != want:
    raise ValueError(f'{path}: an export of a {held} value net handed to '
                     f'a {want} run')
  return e


def export_value_net(path: str, task: str, device,
                     compute_dtype=torch.float32):
  """The Enformer (DNA, computing in ``compute_dtype``) or ConvGRU (RNA)
  of an export, on ``device``."""
  tree = check_value_export(path, task).tree
  if export_task(tree) == 'rna':
    head = tree['params']['ConvHead_0']['ChannelTransformBlock_0'][
        'ChannelTransform_0']['Conv1D_0']['kernel']
    return weights.convgru_from_jax(tree, n_tasks=int(head.shape[-1]),
                                    device=device)
  return weights.enformer_value_from_jax(tree, compute_dtype, device)


def export_denoiser(path: str, cfg: Config, device):
  """The denoiser of ``cfg.backbone`` holding an export's variables (a
  pretraining state's EMA weights), at ``cfg``'s widths, on ``device``."""
  e = ckpt_lib.load_export(path, DENOISER_EXPORTS)
  held = e.meta.get('config', {}).get('backbone')
  if held is not None and held != cfg.backbone:
    raise ValueError(f'{path}: an export of a {held} denoiser handed to a '
                     f'{cfg.backbone} run')
  if cfg.backbone == 'cnn':
    return weights.cnn_from_jax(e.tree, diffusion_lib.cnn_compute_dtype(),
                                device)
  convert = {'dit': weights.dit_from_jax, 'dimamba': weights.dimamba_from_jax,
             'ar': weights.ar_from_jax}[cfg.backbone]
  return convert(e.tree, cfg, diffusion_lib.compute_dtype(cfg), device)


def reject_unported(args) -> None:
  """Raise for flags whose machinery is not ported yet, and for
  checkpoint files this package did not write (before any model is
  built)."""
  if args.task not in TASKS:
    raise NotImplementedError(f'--task {args.task}: the tasks are '
                              f'{", ".join(TASKS)}')
  for name in VALUE_CHECKPOINT_FLAGS:
    path = getattr(args, name, None)
    if ckpt_lib.is_export_file(path):
      check_value_export(path, args.task, leaves=False)
    elif path and not ckpt_lib.is_reference_file(path):
      value_lib.load_checkpoint(path, mmap=True, task=args.task)
  path = getattr(args, 'diffusion_checkpoint_path', None)
  if ckpt_lib.is_export_file(path):
    ckpt_lib.export_header(path, DENOISER_EXPORTS)
  elif path and not ckpt_lib.is_reference_file(path):
    diffusion_checkpoint(path)


def task_config(args) -> Config:
  """The task's preset (``rna_config`` for rna and rna_saluki, L=50) with
  the task, length, step and batch flags."""
  cfg = rna_config() if args.task in value_lib.RNA_TASKS else dna_config()
  cfg.task = args.task
  if args.length:
    cfg.model.length = args.length
  if args.num_steps:
    cfg.sampling.steps = args.num_steps
  cfg.loader.eval_batch_size = args.batch_size
  return cfg


def _reference_state_dict(path: str, prefixes) -> dict:
  """The reference pickle's state dict, the first of ``prefixes`` that
  starts a key taken off (``svdd_tpu/cli/common.py:_torch_prefix``)."""
  sd = ckpt_lib.import_torch_state_dict(path)
  return ckpt_lib.strip_prefix(sd, ckpt_lib.torch_prefix(sd, prefixes))


def import_denoiser(path: str, cfg: Config, device):
  """The reference Lightning checkpoint's denoiser (the CNN or the DiT
  of ``cfg.backbone``, its layers counted by ``cfg``), on ``device``."""
  sd = _reference_state_dict(path, ('backbone.', 'module.backbone.'))
  if cfg.backbone == 'cnn':
    return weights.cnn_from_jax(
        importers.import_cnn_params(sd, 5 * cfg.model.num_cnn_stacks),
        diffusion_lib.cnn_compute_dtype(), device)
  if cfg.backbone == 'dit':
    return weights.dit_from_jax(
        importers.import_dit_params(sd, cfg.model.n_blocks), cfg,
        diffusion_lib.compute_dtype(cfg), device)
  raise NotImplementedError(f'torch import for backbone {cfg.backbone}')


def import_value_net(path: str, task: str, prefixes, device,
                     compute_dtype=torch.float32):
  """The reference pickle's Enformer (DNA, computing in
  ``compute_dtype``) or ConvGRU (RNA), on ``device``."""
  sd = _reference_state_dict(path, prefixes)
  if value_lib.checkpoint_task(task) == 'rna':
    return weights.convgru_from_jax(importers.import_convgru_value_model(sd),
                                    device=device)
  return weights.enformer_value_from_jax(
      importers.import_enformer_value_model(sd), compute_dtype, device)


def load_diffusion(args, cfg: Config) -> Diffusion:
  """The denoiser: the EMA weights of ``--diffusion_checkpoint_path``, the
  weights of a reference checkpoint, or random ones."""
  path = getattr(args, 'diffusion_checkpoint_path', None)
  if ckpt_lib.is_reference_file(path):
    model = Diffusion(cfg, device=args.device,
                      backbone=import_denoiser(path, cfg, args.device))
    LOGGER.info('imported torch diffusion ckpt %s', path)
    return model
  if ckpt_lib.is_export_file(path):
    model = Diffusion(cfg, device=args.device,
                      backbone=export_denoiser(path, cfg, args.device))
    LOGGER.info('read the exported diffusion checkpoint %s', path)
    return model
  model = Diffusion(cfg, device=args.device)
  if path:
    train_diff.load_ema_weights(model, diffusion_checkpoint(path))
    LOGGER.info('loaded diffusion checkpoint %s', path)
  else:
    LOGGER.warning('no --diffusion_checkpoint_path: using randomly '
                   'initialized diffusion model')
  return model


def load_oracle(path: str, task: str, device) -> rewards.RewardOracle:
  """The reward oracle a ``cli.train_oracle --save_path`` file (or an
  export of the JAX package's oracle) holds: the Enformer (DNA, float32,
  task 0 read) or the ConvGRU (the RNA tasks; the saluki oracle's stem
  takes six channels)."""
  if ckpt_lib.is_export_file(path):
    return rewards.RewardOracle(export_value_net(path, task, device),
                                task_index=0)
  ckpt = value_lib.load_checkpoint(path, task=task)
  gen = torch.Generator(torch.device(device)).manual_seed(0)
  create = (rewards.RewardOracle.create_rna
            if value_lib.checkpoint_task(task) == 'rna'
            else rewards.RewardOracle.create_dna)
  oracle = create(gen, **ckpt['config'])
  oracle.module.load_state_dict(ckpt['model'])
  return oracle


def load_saluki_body(args, device='cpu') -> Optional[torch.Tensor]:
  """The constant saluki 'body' (coding region and tracks, (Lb, 6)) that
  goes behind each 5'UTR (``svdd_tpu/cli/common.py:150-163``):
  ``--saluki_body_path`` wins; else ``--saluki_body N`` reads
  ``saluki_body_{N}.npy`` under ``$SVDD_DATA_DIR`` (the current
  directory without it); else None (zero padding alone). A float32
  tensor on ``device``."""
  path = args.saluki_body_path
  if not path and args.saluki_body:
    data_dir = os.environ.get('SVDD_DATA_DIR', '.')
    path = os.path.join(data_dir, f'saluki_body_{args.saluki_body}.npy')
  if not path:
    return None
  body = np.load(path)
  LOGGER.info('loaded saluki body %s %s', path, body.shape)
  return torch.as_tensor(body, dtype=torch.float32, device=device)


def saluki_kwargs(args) -> dict:
  """The saluki input's arguments of ``decode.run_decode`` and the
  trainers: the body (read for ``--task rna_saluki`` alone, as
  ``svdd_tpu/cli/train.py:77-78`` reads it) and the padded length."""
  body = (load_saluki_body(args, args.device) if args.task == 'rna_saluki'
          else None)
  return {'saluki_body': body,
          'saluki_final_length': args.saluki_final_length}


def _saluki_oracle(args) -> rewards.RewardOracle:
  """The saluki stability oracle (``svdd_tpu/cli/common.py:169-182``):
  the six-channel ConvGRU of ``--reward_checkpoint_path`` (an export of
  the JAX package's, this package's file, or a reference pickle), or a
  random one drawn from seed 0, with JAX's warning."""
  path = args.reward_checkpoint_path
  if not path:
    LOGGER.warning('no --reward_checkpoint_path: saluki oracle is randomly '
                   'initialized')
    return rewards.RewardOracle.create_saluki(
        torch.Generator(torch.device(args.device)).manual_seed(0))
  if ckpt_lib.is_reference_file(path):
    oracle = rewards.RewardOracle(import_value_net(
        path, args.task, ('model.', 'module.', ''), args.device))
  else:
    oracle = load_oracle(path, args.task, args.device)
  if oracle.module.in_channels != 6:
    raise ValueError(f'--reward_checkpoint_path {path}: a ConvGRU of '
                     f'{oracle.module.in_channels} input channels; the '
                     'saluki oracle takes 6')
  LOGGER.info('loaded reward oracle %s', path)
  return oracle


def load_reward_fn(args, cfg: Config):
  """The oracle of ``--reward_checkpoint_path`` (``load_oracle``), or the
  synthetic motif oracle at the task's length; for ``rna_saluki`` the
  saluki oracle (``_saluki_oracle``)."""
  if args.task == 'rna_saluki':
    return _saluki_oracle(args)
  path = getattr(args, 'reward_checkpoint_path', None)
  if ckpt_lib.is_reference_file(path):
    # grelu LightningModel oracles carry the value nets' layouts under
    # 'model.'
    module = import_value_net(path, args.task, ('model.', 'module.', ''),
                              args.device)
    LOGGER.info('imported torch reward oracle %s', path)
    return rewards.RewardOracle(module, task_index=0)
  if ckpt_lib.is_export_file(path):
    LOGGER.info('read the exported reward oracle %s', path)
    return load_oracle(path, args.task, args.device)
  if path:
    oracle = load_oracle(path, args.task, args.device)
    LOGGER.info('loaded reward oracle %s', path)
    return oracle
  LOGGER.warning('no --reward_checkpoint_path: using synthetic motif '
                 'oracle')
  return rewards.synthetic_motif_oracle(cfg.model.length)


def load_value_function(args, cfg: Config,
                        **module_kwargs) -> value_lib.ValueFunction:
  """The value net of ``--load_checkpoint_path`` (or ``--pre_model_path``),
  at the checkpoint's widths, or a random one of ``module_kwargs``'s
  widths (the full width by default): the Enformer for DNA, the ConvGRU
  for RNA."""
  gen = torch.Generator(torch.device(args.device)).manual_seed(1)
  path = args.load_checkpoint_path or args.pre_model_path
  if ckpt_lib.is_reference_file(path):
    # the JAX CLI creates the value function before it imports
    value_lib.check_value_model(args.task, args.model)
    module = import_value_net(path, args.task, ('module.',), args.device,
                              value_lib.value_compute_dtype())
    LOGGER.info('imported torch value net %s', path)
    return value_lib.ValueFunction(module, cfg.model.length)
  if ckpt_lib.is_export_file(path):
    value_lib.check_value_model(args.task, args.model)
    module = export_value_net(path, args.task, args.device,
                              value_lib.value_compute_dtype())
    LOGGER.info('read the exported value net %s', path)
    return value_lib.ValueFunction(module, cfg.model.length)
  if path:
    ckpt = value_lib.load_checkpoint(path, task=args.task)
    vf = value_lib.ValueFunction.create(args.task, cfg.model.length, gen,
                                        model=args.model, **ckpt['config'])
    vf.module.load_state_dict(ckpt['model'])
    LOGGER.info('loaded value net %s', path)
    return vf
  LOGGER.warning('no --load_checkpoint_path: value net is randomly '
                 'initialized')
  return value_lib.ValueFunction.create(
      args.task, cfg.model.length, gen, model=args.model,
      n_tasks=args.n_task, **module_kwargs)


def compute_dtypes(diffusion: Diffusion,
                   vf: Optional[value_lib.ValueFunction] = None) -> dict:
  """The metrics row's record of the compute dtypes of the run's
  denoiser and value net (SVDD_CNN_BF16, SVDD_VALUE_BF16)."""
  name = lambda dt: str(dt).split('.')[-1]
  row = {'denoiser_dtype': name(diffusion.backbone.compute_dtype)}
  if vf is not None:
    row['value_dtype'] = name(vf.module.compute_dtype)
  return row


def npz_path(args, suffix: str = '') -> str:
  """'./log/{task}-{reward}{suffix}.npz'."""
  return os.path.join(args.out_dir,
                      f'{args.task}-{args.reward_name}{suffix}.npz')


def finish_run(args, result, suffix: str = '',
               extra_metrics: Optional[dict] = None) -> dict:
  """Write the npz, then log the quantile report and append one row to
  ``{out_dir}/{run_name}.metrics.jsonl``."""
  path = npz_path(args, suffix)
  result.save_npz(path)
  LOGGER.info('wrote %s', path)
  report = quantile_report({'decoding': result.reward_preds,
                            'baseline': result.baseline_preds,
                            'best_of_n': result.top_k})
  for name, row in report.items():
    LOGGER.info('%s: %s', name, row)
  run_name = args.run_name or f'{args.task}-{args.reward_name}{suffix}'
  row = {'_time': time.time(), 'npz': path,
         'n': int(len(result.reward_preds)),
         'batch_size': args.batch_size, 'sample_M': args.sample_M,
         'seed': args.seed}
  for name, stats in report.items():
    for q, v in stats.items():
      row[f'{name}/{q}'] = float(v)
  row.update(extra_metrics or {})
  os.makedirs(args.out_dir, exist_ok=True)
  with open(os.path.join(args.out_dir, f'{run_name}.metrics.jsonl'),
            'a') as fh:
    fh.write(json.dumps(row) + '\n')
  return report
