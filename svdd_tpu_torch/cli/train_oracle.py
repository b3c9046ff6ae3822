"""Reward-oracle training CLI (``svdd_tpu/cli/train_oracle.py``).

  python -m svdd_tpu_torch.cli.train_oracle --task rna --save_path oracle.pt
  python -m svdd_tpu_torch.cli.train_oracle --task dna --batch_size 64 \
      --max_iters 2000 --save_path oracle.pt

Trains the reward oracle on the Gosai training split
(``gosai_train.csv`` under ``--data_dir``, ``$SVDD_DATA_DIR`` or
``/data/svdd``; the synthetic planted-motif split without one): for
``--task rna`` (the default, as in JAX) the one-task ConvGRU MRL oracle
at L=50 on the first label column (``--task rna_saluki`` trains the same
four-channel ConvGRU at L=50, as JAX's CLI does: not the six-channel
saluki oracle the decoders read); for ``--task dna`` the 3-task
Enformer (hepg2, k562, sknsh; ``--small``: 256 channels, 3 conv blocks,
one transformer block) on all three. AdamW at a constant rate
(optax.adamw's defaults: betas (0.9, 0.999), weight decay 1e-4; no
clipping) on the MSE, in training mode (BatchNorm on the batch, dropout
live). Then it logs the Pearson correlation of task 0 on the first 512
validation rows and writes ``--save_path``, which
``--reward_checkpoint_path`` of the decoders and trainers reads.
Float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import logging
import time

import torch

from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.data.gosai import FaultTolerantIterator, GosaiDataset
from svdd_tpu_torch.models.blocks import DropoutMasks
from svdd_tpu_torch.models.convgru import ConvGRUValueModel
from svdd_tpu_torch.models.enformer import EnformerValueModel
from svdd_tpu_torch.train.diffusion import Optimizer

LOGGER = logging.getLogger(__name__)
SMALL = dict(n_conv=3, channels=256, n_transformers=1, n_heads=2, key_len=8)
WEIGHT_DECAY = 1e-4   # optax.adamw's default; torch.optim.AdamW's is 1e-2
VAL_ROWS = 512


def build_module(small: bool, generator: torch.Generator,
                 task: str = 'dna'):
  """The task's oracle: the one-task four-channel ConvGRU (rna and
  rna_saluki; ``small`` changes nothing, as in JAX), or the 3-task
  Enformer, full width or ``SMALL``."""
  if task in value_lib.RNA_TASKS:
    return ConvGRUValueModel(n_tasks=1, generator=generator)
  return EnformerValueModel(n_tasks=3, generator=generator,
                            **(SMALL if small else {}))


def onehot4(seqs: torch.Tensor) -> torch.Tensor:
  """jax.nn.one_hot(seqs, 4): a token past 3 is a zero row."""
  return (seqs[..., None] == torch.arange(4, device=seqs.device)).float()


def train_step(module, optimizer: Optimizer, seqs, labels,
               masks: DropoutMasks) -> torch.Tensor:
  """One AdamW step on the MSE over the module's tasks (a one-task
  module against the first label column); the module's running
  statistics move. Returns the loss (0-dim, on the device)."""
  for p in optimizer.params:
    p.grad = None
  preds = module(onehot4(seqs), train=True, masks=masks)
  if preds.ndim == 1:
    labels = labels[:, 0]
  loss = ((preds - labels) ** 2).mean()
  loss.backward()
  optimizer.step()
  return loss.detach()


def make_optimizer(module, learning_rate: float) -> Optimizer:
  return Optimizer(module.parameters(), lambda count: learning_rate, None,
                   weight_decay=WEIGHT_DECAY)


def val_pearson(module, val: GosaiDataset, device) -> float:
  """Pearson correlation of task 0 on the first 512 validation rows,
  the eval forward's float32 predictions in numpy."""
  with torch.inference_mode():
    seqs = torch.as_tensor(val.seqs[:VAL_ROWS], device=device).long()
    preds = module(onehot4(seqs)).float().cpu().numpy()
  p0 = preds if preds.ndim == 1 else preds[:, 0]
  l0 = val.clss[:VAL_ROWS, 0]
  denom = p0.std() * l0.std()
  return (float(((p0 - p0.mean()) * (l0 - l0.mean())).mean() / denom)
          if denom > 0 else 0.0)


def run(args) -> dict:
  """Train; returns the module, the losses read at the log steps and the
  validation Pearson correlation."""
  common.full_f32()
  device = torch.device(args.device)
  length = args.length or (50 if args.task.startswith('rna') else 200)
  ds = GosaiDataset('train', length=length, data_dir=args.data_dir)
  val = GosaiDataset('val', length=length, data_dir=args.data_dir)
  if ds.synthetic:
    LOGGER.warning('no CSV found: training oracle on the synthetic '
                   'planted-motif dataset')
  it = iter(FaultTolerantIterator(ds, args.batch_size, seed=args.seed))
  module = build_module(args.small,
                        torch.Generator(device).manual_seed(args.seed),
                        args.task)
  optimizer = make_optimizer(module, args.learning_rate)
  # the dropout masks' generator, JAX's key(seed + 1)
  gen = torch.Generator(device).manual_seed(args.seed + 1)
  losses = {}
  t0 = time.time()
  for i in range(args.max_iters):
    batch = next(it)
    loss = train_step(module, optimizer,
                      torch.as_tensor(batch['seqs'], device=device).long(),
                      torch.as_tensor(batch['clss'], device=device),
                      DropoutMasks(generator=gen))
    if (i + 1) % args.log_every == 0:
      losses[i + 1] = float(loss)
      LOGGER.info('oracle it %d MSE %.5f (%.1f it/s)', i + 1, losses[i + 1],
                  args.log_every / (time.time() - t0))
      t0 = time.time()
  r = val_pearson(module, val, device)
  LOGGER.info('val pearson (task 0): %.4f', r)
  if args.save_path:
    value_lib.save_checkpoint(args.save_path, module)
    LOGGER.info('saved oracle to %s', args.save_path)
  return {'module': module, 'losses': losses, 'val_pearson': r,
          'synthetic': ds.synthetic}


def parser():
  p = argparse.ArgumentParser(description='reward-oracle training')
  p.add_argument('--task', default='rna',
                 choices=['dna', 'rna', 'rna_saluki'])
  p.add_argument('--length', type=int, default=None)
  p.add_argument('--batch_size', type=int, default=64)
  p.add_argument('--max_iters', type=int, default=2000)
  p.add_argument('--learning_rate', type=float, default=1e-3)
  p.add_argument('--log_every', type=int, default=100)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--data_dir', default=None)
  p.add_argument('--save_path', default=None)
  p.add_argument('--small', action='store_true', default=False)
  p.add_argument('--device', type=str, default='cuda',
                 help="torch device of the run ('cuda' or 'cpu')")
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
