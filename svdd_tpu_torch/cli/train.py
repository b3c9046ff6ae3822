"""Value-net training CLI, MC and CD-Q (``svdd_tpu/cli/train.py``).

  python -m svdd_tpu_torch.cli.train --task dna --batch_size 8 \
      --max_iters 1000 --diffusion_checkpoint_path ckpt/step_40.pt \
      --reward_checkpoint_path oracle.pt --save_path value.pt

Trains the value net (the Enformer, ``--model enformer``, for ``--task
dna``; the ConvGRU for ``--task rna`` and ``rna_saluki``, in f32
always; the saluki task's targets are the saluki oracle's rewards on
the saluki input) against the frozen
denoiser of ``--diffusion_checkpoint_path`` (the EMA weights of a
``main_gosai --mode train`` checkpoint) with the targets of
``--reward_checkpoint_path``'s oracle (``cli.train_oracle --save_path``;
the synthetic motif oracle without it): MC targets, or CD-Q with
``--cdq``. Every ``--eval_every`` iterations it logs the per-timestep
MSE and Pearson correlation on ``--val_batch_num`` pre-sampled
trajectories to ``{out_dir}/{run_name}.metrics.jsonl`` and writes
``--save_path`` (the value net, which ``--load_checkpoint_path`` of the
decoders and ``cli.eval`` read) and ``--save_state_path`` (the trainer
state, which ``--resume_state_path`` resumes). The value net computes
in bf16 under SVDD_VALUE_BF16=1 and the denoiser under SVDD_CNN_BF16=1;
otherwise in f32 with TF32 off. ``--batch_size`` keeps JAX's default of
256, whose MC step regresses 128 x 256 states: pass a small one.

``--model multienformer`` trains the time-binned multisep model instead
(``_run_multisep``): ten trunks, each regressing its bin of a
trajectory's states, through their eval forward as JAX trains them.
``--model timedenformer`` raises JAX's ``ValueError`` (its value
function cannot be created without time indices).

``--dist`` trains data-parallel over every process of the group
(``svdd_tpu/cli/train.py:21-82``): under ``torchrun`` its processes, one
a card (NCCL), else a group of this one process; ``--fsdp`` also shards
the value net's parameters and AdamW's moments over them:

  torchrun --nproc_per_node=1 -m svdd_tpu_torch.cli.train --dist --fsdp \
      --task dna --batch_size 8 ...

As in JAX, ``--fsdp`` without ``--dist``, ``--fsdp`` with ``--model
multienformer``, and a ``--batch_size`` that does not divide over the
processes exit.
"""

from __future__ import annotations

import logging
import os
import tempfile

import torch

from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.models import multisep
from svdd_tpu_torch.observability import MetricsLogger
from svdd_tpu_torch.parallel import fsdp
from svdd_tpu_torch.parallel import mesh as mesh_lib
from svdd_tpu_torch.train import value as train_val

LOGGER = logging.getLogger(__name__)
MULTISEP_MODELS = 10     # the JAX CLI's n_models


def _reject(args) -> None:
  if args.fsdp and not args.dist:
    raise SystemExit('--fsdp requires --dist (param sharding lives on '
                     "the 'data' mesh axis)")
  if args.fsdp and args.model == 'multienformer':
    raise SystemExit('--fsdp is not supported with --model multienformer '
                     '(the time-binned trunk stack trains replicated; drop '
                     '--fsdp)')
  common.reject_unported(args)


def build_mesh(args):
  """``--dist``: a data-parallel grid of every process
  (``svdd_tpu/cli/train.py:_build_mesh``): torchrun's, or, without one, a
  group of this process alone; None without ``--dist``."""
  if not args.dist:
    return None
  if not mesh_lib.initialize_multihost(device=args.device):
    store = os.path.join(tempfile.mkdtemp(), 'store')
    mesh_lib.initialize_multihost(f'file://{store}', 1, 0, args.device)
  mesh = mesh_lib.make_mesh()
  if args.batch_size % mesh.data:
    raise SystemExit(
        f'--batch_size {args.batch_size} must divide over the {mesh.data}-'
        "process 'data' axis (the reference enforces the same global-batch "
        'divisibility, dataloader_gosai.py:104-114)')
  LOGGER.info('--dist: value training over a %s grid%s', mesh.shape,
              ' with FSDP param sharding' if args.fsdp else '')
  return mesh


def run(args, cfg=None, value_kwargs=None) -> dict:
  """Train. ``cfg`` and ``value_kwargs`` (the value module's arguments)
  replace the full-size models, for tests. Returns the trainer, its
  final state and the metrics file's path."""
  _reject(args)
  mesh = build_mesh(args)
  common.full_f32()
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)
  if args.model == 'multienformer':
    return _run_multisep(args, cfg, diffusion, reward_fn, value_kwargs, mesh)
  vf = common.load_value_function(args, cfg, **(value_kwargs or {}))
  tcfg = train_val.ValueTrainerConfig(
      learning_rate=args.learning_rate, grad_norm_clip=args.grad_norm_clip,
      max_iter=args.max_iters, cdq=args.cdq, batch_size=args.batch_size,
      lr_decay=args.lr_decay, task=args.task,
      saluki_final_length=args.saluki_final_length)
  saluki = common.saluki_kwargs(args)
  trainer = train_val.ValueTrainer(diffusion, vf, reward_fn, tcfg,
                                   saluki['saluki_body'], mesh=mesh,
                                   fsdp=args.fsdp)
  if args.resume_state_path:
    state = trainer.restore_state(args.resume_state_path, args.seed)
    LOGGER.info('resumed trainer state at step %d (tokens %.3g)',
                state.step, state.tokens)
  else:
    state = trainer.init_state(args.seed)

  eval_batches = eval_targets = None
  if args.val_batch_num > 0:
    gen = torch.Generator(diffusion.device).manual_seed(args.seed + 1)
    eval_batches, eval_targets = train_val.build_eval_timestep_batches(
        diffusion, reward_fn, args.batch_size, args.val_batch_num, gen,
        task=args.task, **saluki)

  lead = mesh is None or mesh.rank == 0      # logs and writes
  logger = MetricsLogger(log_dir=args.out_dir, run_name=args.run_name or
                         f'{args.task}-{args.reward_name}-valuetrain'
                         ) if lead else None
  iters_done = 0
  try:
    while iters_done < tcfg.max_iter:
      chunk = min(args.eval_every, tcfg.max_iter - iters_done)
      state = trainer.train(state, chunk)
      iters_done += chunk
      if eval_batches is not None:
        losses, pearsons = trainer.evaluate_seq_step(state, eval_batches,
                                                     eval_targets)
        mid = len(losses) // 2
        LOGGER.info('it %d per-timestep MSE head/mid/tail: %.4f / %.4f / '
                    '%.4f  pearson: %.3f / %.3f / %.3f', iters_done,
                    losses[0], losses[mid], losses[-1], pearsons[0],
                    pearsons[mid], pearsons[-1])
        if lead:
          logger.log({'eval/mse_head': losses[0],
                      'eval/mse_mid': losses[mid],
                      'eval/mse_tail': losses[-1],
                      'eval/pearson_head': pearsons[0],
                      'eval/pearson_mid': pearsons[mid],
                      'eval/pearson_tail': pearsons[-1]}, step=iters_done)
      if args.save_path:
        with fsdp.gathered(state.sharded):     # every process gathers
          if lead:
            value_lib.save_checkpoint(args.save_path, state.module)
            LOGGER.info('saved value net to %s', args.save_path)
      if args.save_state_path:
        trainer.save_state(args.save_state_path, state)
        LOGGER.info('saved full trainer state to %s', args.save_state_path)
  finally:
    if lead:
      logger.finish()
  return {'trainer': trainer, 'state': state,
          'metrics_path': logger.path if lead else None}


def _run_multisep(args, cfg, diffusion, reward_fn, value_kwargs=None,
                  mesh=None) -> dict:
  """``--model multienformer`` (``svdd_tpu/cli/train.py:136-160``): ten
  trunks binned over ``cfg.sampling.steps`` (the task's value net: the
  Enformer, or the ConvGRU for ``--task rna``), drawn from ``--seed``,
  ``--max_iters`` steps of ``MultiSepTrainer`` at ``--learning_rate``,
  logged every ``--eval_every``; ``--save_path`` gets the trained
  model (``models.multisep.save_checkpoint``). As in JAX, the value-net
  checkpoint flags, the evaluation and the trainer-state flags are not
  read. Returns the trainer and its final state."""
  gen = torch.Generator(diffusion.device).manual_seed(args.seed)
  msm = multisep.MultiSepValueModel.create(
      lambda g: value_lib.build_value_module(
          args.task, 'enformer', args.n_task, g, **(value_kwargs or {})),
      n_models=MULTISEP_MODELS, num_steps=cfg.sampling.steps, generator=gen)
  tcfg = train_val.ValueTrainerConfig(
      learning_rate=args.learning_rate, batch_size=args.batch_size,
      max_iter=args.max_iters, task=args.task,
      saluki_final_length=args.saluki_final_length)
  trainer = train_val.MultiSepTrainer(
      diffusion, msm, reward_fn, tcfg,
      common.saluki_kwargs(args)['saluki_body'], mesh=mesh)
  state = trainer.train(trainer.init_state(args.seed), tcfg.max_iter,
                        log_every=args.eval_every)
  if args.save_path and (mesh is None or mesh.rank == 0):
    multisep.save_checkpoint(args.save_path, state.msm)
    LOGGER.info('saved multisep value net to %s', args.save_path)
  return {'trainer': trainer, 'state': state}


def parser():
  p = common.make_parser('value-network training (MC / CD-Q)')
  p.add_argument('--max_iters', type=int, default=50_000)
  p.add_argument('--learning_rate', type=float, default=2e-4)
  p.add_argument('--grad_norm_clip', type=float, default=1.0)
  p.add_argument('--lr_decay', action='store_true', default=False)
  p.add_argument('--eval_every', type=int, default=200)
  p.add_argument('--save_path', type=str, default=None)
  p.add_argument('--save_state_path', type=str, default=None,
                 help='full trainer state (value net, optimizer, token '
                      'counter, generator) for exact resume')
  p.add_argument('--resume_state_path', type=str, default=None)
  p.add_argument('--fsdp', action='store_true', default=False,
                 help="with --dist: shard the value net's parameters and "
                      "optimizer state over the 'data' axis, the "
                      'parameters gathered at use (FSDP)')
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
