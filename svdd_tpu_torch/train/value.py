"""Value-net training, MC and CD-Q (``svdd_tpu/train/value.py``).

Each iteration samples a full trajectory from the frozen diffusion
model (the unguided sampler with ``collect_mid``, or the CD-Q sampler of
10 candidates a step), builds the regression targets from it (MC: the
final reward for every state; CD-Q: the mean value of the next step's
candidates under the current value net), and takes one optimizer step
on the value net's MSE in training mode (BatchNorm on the batch, its
running averages moved; dropout live). The optimizer is optax's
clip_by_global_norm then AdamW (betas (0.9, 0.95), weight decay 0.1),
the learning rate constant or, with ``lr_decay``, the token schedule at
the update count (``utils.token_cosine_lr_mult``); A12's ``Optimizer``,
its clip and ``torch.optim.AdamW`` path.

Randomness follows the JAX trainer's keys. The state's ``generator``
(JAX's ``state.rng``, seeded from the run's seed) draws the MC
subsample's steps and the dropout masks, and is saved with the state.
The trajectories come from the trainer's own generator, seeded 0 in
every trainer and never saved, as JAX's ``_sample_key = key(0)``
(``train/value.py:126, 257-264``): a run resumed from a saved state
draws other trajectories than the uninterrupted run would have.

On the card every gradient sums in a fixed order (kernels B7 and B8,
``ops.conv1d._ConvPlainBwd`` for the stem, cuBLAS products elsewhere), so two runs from one seed, and two resumes from one saved
state, agree bit for bit.

The trainer state is one ``torch.save`` dict (``save_state``): the
value net's parameters and running statistics, AdamW's state and update
count, the generator, the step and the token counter.

On a process grid (``mesh``; ``svdd_tpu/train/value.py:85-150, 310-322``)
the trajectory batch is sampled over the ``data`` axis and gathered
(``Diffusion.sampler(mesh=)``); the oracle's targets and CD-Q's
bootstrap values are computed on each process's block of their rows and
gathered; each process regresses its contiguous block of the
regression rows, its dropout masks the global batch's rows
(``parallel/rows.py``) and BatchNorm on the global batch's statistics
(``blocks.sync_batchnorm``), and the gradients and the loss are summed
over ``data`` in one all-reduce. ``fsdp`` shards the value net's
parameters and AdamW's moments (``parallel/fsdp.py``): the parameters
are gathered for a step's bootstrap, forward and backward, and for an
evaluation or a save, and freed after. Process 0 writes
the trainer state, whole. ``MultiSepTrainer(mesh=)`` splits each
trajectory's batch the same way and keeps its trunks replicated.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from svdd_tpu_torch import mdlm, utils
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.models.blocks import DropoutMasks, sync_batchnorm
from svdd_tpu_torch.models.multisep import MultiSepValueModel, bin_losses
from svdd_tpu_torch.parallel import fsdp as fsdp_lib
from svdd_tpu_torch.parallel import mesh as mesh_lib
from svdd_tpu_torch.parallel import rows as rows_lib
from svdd_tpu_torch.parallel.fsdp import ShardedParams
from svdd_tpu_torch.train.diffusion import Optimizer, write_atomic

LOGGER = logging.getLogger(__name__)
FORMAT = 'svdd_tpu_torch.train.value/1'


@dataclasses.dataclass
class ValueTrainerConfig:
  """``svdd_tpu/train/value.py:44-67``, less the settings no MC or
  CD-Q step reads (the evaluation period is ``cli.train``'s). ``task``
  'dna', 'rna' or 'rna_saluki': the saluki task routes the reward's
  target through the (N, saluki_final_length, 6) saluki input while the
  value net keeps reading (N, L, 4) states (``make_reward_transform``)."""
  learning_rate: float = 3e-4
  betas: tuple = (0.9, 0.95)
  grad_norm_clip: Optional[float] = 1.0     # None: no clipping
  weight_decay: float = 0.1
  lr_decay: bool = False
  warmup_tokens: float = 375e2
  final_tokens: float = 260e7
  max_iter: int = 50_000
  cdq: bool = False
  batch_size: int = 32
  mc_subsample: Optional[int] = None
  tokens_per_iter: float = 32 * 128 * 200 * 4
  task: str = 'dna'
  saluki_final_length: int = 12288


@dataclasses.dataclass
class ValueTrainState:
  """The value net being trained (its parameters and BatchNorm running
  statistics, JAX's params and extras), the optimizer, the generator of
  the dropout masks and subsample draws, the step and the tokens seen."""
  step: int
  module: torch.nn.Module           # an EnformerValueModel or ConvGRU
  optimizer: Optimizer
  generator: torch.Generator
  tokens: float = 0.0
  sharded: Optional[ShardedParams] = None


def _by_rows(fn, x: torch.Tensor, mesh) -> torch.Tensor:
  """``fn`` on x's rows: at once, or on a grid each process's
  contiguous block of them, gathered over ``data``."""
  if mesh is None:
    return fn(x)
  row0, n = mesh.rows(x.shape[0])
  return mesh_lib.all_gather(fn(x[row0:row0 + n]), mesh.data_group)


def _write(path: str, obj: dict, mesh) -> None:
  """Process 0 writes; on a grid every process waits for the file."""
  if mesh is None or mesh.rank == 0:
    write_atomic(path, obj)
  if mesh is not None:
    torch.distributed.barrier(mesh.group)


class ValueTrainer:
  """Fits a value net against a frozen ``Diffusion`` (``svdd_tpu/train/
  value.py:70-298``). ``reward_fn``: the oracle's input -> (N,) rewards
  (a ``RewardOracle`` or the synthetic motif oracle), the input built by
  ``make_reward_transform(tcfg.task, saluki_body, ...)``; the value net an
  Enformer (DNA) or a ConvGRU (the RNA tasks)."""

  def __init__(self, diffusion: Diffusion, vf: value_lib.ValueFunction,
               reward_fn, tcfg: ValueTrainerConfig, saluki_body=None,
               mesh: Optional[mesh_lib.Mesh] = None, fsdp: bool = False,
               fsdp_min_size: int = 2 ** 14):
    if fsdp and mesh is None:
      raise ValueError('fsdp shards over a process grid: pass mesh')
    self.diffusion = diffusion
    self.vf = vf
    self.tcfg = tcfg
    self.mesh = mesh
    self.fsdp = fsdp
    self.fsdp_min_size = fsdp_min_size
    self._reward_fn = lambda x: _by_rows(reward_fn, x, mesh)
    self._reward_transform = value_lib.make_reward_transform(
        tcfg.task, saluki_body, tcfg.saluki_final_length)
    if tcfg.cdq:
      self._sampler = diffusion.cdq_sampler(tcfg.batch_size, repeats=10,
                                            mesh=mesh)
    else:
      self._sampler = diffusion.sampler(tcfg.batch_size, collect_mid=True,
                                        mesh=mesh)
    # the trajectories' generator: seeded 0 in every trainer, not saved
    # with the state (JAX's _sample_key, module docstring)
    self._sample_gen = torch.Generator(diffusion.device).manual_seed(0)

  def learning_rate(self, count: int) -> float:
    """The rate of update ``count`` (updates already made)."""
    t = self.tcfg
    if not t.lr_decay:
      return t.learning_rate
    return t.learning_rate * utils.token_cosine_lr_mult(
        count * t.tokens_per_iter, t.warmup_tokens, t.final_tokens)

  def init_state(self, seed: int) -> ValueTrainState:
    """A fresh state on a copy of the value function's module (the value
    function itself stays as it is); its generator seeded ``seed``."""
    module = copy.deepcopy(self.vf.module)
    t = self.tcfg
    sharded = None
    if self.mesh is not None and self.mesh.data > 1:
      sync_batchnorm(module, self.mesh.data_group)
    if self.fsdp:
      sharded = ShardedParams(module, self.mesh, self.fsdp_min_size)
    params = (module.parameters() if sharded is None
              else sharded.local.values())
    opt = Optimizer(params, self.learning_rate, t.grad_norm_clip, t.betas,
                    weight_decay=t.weight_decay, sharded=sharded)
    gen = torch.Generator(self.diffusion.device).manual_seed(seed)
    return ValueTrainState(0, module, opt, gen, 0.0, sharded)

  def trajectory(self):
    """One trajectory of the frozen model: (samples (B, L), mid_x (S-1,
    B, L), the CD-Q candidates (S, B, 10, L) or None), as normal
    tensors (the sampler runs in inference mode)."""
    res = self._sampler(self._sample_gen)
    cands = res.extra.clone() if self.tcfg.cdq else None
    return res.samples.clone(), res.mid_x.clone(), cands

  def targets(self, state: ValueTrainState, samples, mid_x,
              cdq_candidates=None, subsample_idx=None
              ) -> value_lib.ValueBatch:
    """The iteration's regression batch; CD-Q bootstraps from the current
    value net in eval mode (its running statistics, no gradient)."""
    with torch.no_grad():
      if self.tcfg.cdq:
        with fsdp_lib.gathered(state.sharded):
          return value_lib.cdq_targets(
              samples, mid_x, cdq_candidates, self._reward_fn,
              lambda oh: _by_rows(state.module, oh, self.mesh),
              self._reward_transform)
      return value_lib.mc_targets(
          samples, mid_x, self._reward_fn, generator=state.generator,
          num_subsample=self.tcfg.mc_subsample, subsample_idx=subsample_idx,
          reward_transform=self._reward_transform)

  def grad_step(self, state: ValueTrainState, samples, mid_x,
                cdq_candidates=None, masks: Optional[DropoutMasks] = None,
                subsample_idx=None) -> torch.Tensor:
    """The grad step on one trajectory (``train/value.py:155-233``): the
    targets, the MSE of the training forward, one update; the state
    changes in place. ``masks``, ``subsample_idx``: injected in place of
    the state generator's draws (tests). Returns the loss (a 0-dim device
    tensor; nothing is read back)."""
    with fsdp_lib.gathered(state.sharded):
      batch = self.targets(state, samples, mid_x, cdq_candidates,
                           subsample_idx)
      if masks is None:
        masks = DropoutMasks(generator=state.generator)
      total = batch.targets.shape[0]
      row0, n = (0, total) if self.mesh is None else self.mesh.rows(total)
      batch = value_lib.ValueBatch(*(None if t is None
                                     else t[row0:row0 + n] for t in batch))
      # a timed net takes each state's step (``train/value.py:196-215``)
      extra = ({'time_indices': batch.time_indices}
               if self.vf.timed and batch.time_indices is not None else {})
      for p in state.module.parameters():
        p.grad = None
      with (contextlib.nullcontext() if self.mesh is None
            else rows_lib.global_rows(row0, total)):
        loss = value_lib.value_loss(
            lambda oh: state.module(oh, train=True, masks=masks, **extra),
            batch, total)
      loss.backward()
      loss = loss.detach()
      if state.sharded is not None:
        loss = state.sharded.reduce_grads(loss)
      elif self.mesh is not None:
        loss = mesh_lib.sum_gradients_(state.module.parameters(),
                                       self.mesh.data_group, loss)
    state.optimizer.step()
    state.step += 1
    state.tokens += self.tcfg.tokens_per_iter
    return loss

  def train_step(self, state: ValueTrainState) -> torch.Tensor:
    """One iteration: a trajectory, then the grad step on it."""
    return self.grad_step(state, *self.trajectory())

  def train(self, state: ValueTrainState, num_iters: int,
            log_every: int = 50) -> ValueTrainState:
    t0 = time.time()
    for _ in range(num_iters):
      loss = self.train_step(state)
      if state.step % log_every == 0:
        LOGGER.info('value step %d MSE %.5f (%.2f it/s)', state.step,
                    float(loss), log_every / max(time.time() - t0, 1e-9))
        t0 = time.time()
    return state

  def updated_value_function(self, state: ValueTrainState
                             ) -> value_lib.ValueFunction:
    """The trained value net (under FSDP a whole copy, a collective)."""
    module = state.module
    if state.sharded is not None:
      with state.sharded.gathered():
        module = copy.deepcopy(module)
    return value_lib.ValueFunction(module, self.vf.length, self.vf.timed)

  # -- the full trainer state ----------------------------------------------

  def state_dict(self, state: ValueTrainState) -> dict:
    """The whole state, as ``save_state`` writes it (under FSDP
    gathered; every process calls it)."""
    return {'format': FORMAT, 'step': state.step,
            'model': (state.module.state_dict() if state.sharded is None
                      else state.sharded.state_dict()),
            'optimizer': state.optimizer.state_dict(),
            'generator': state.generator.get_state(),
            'tokens': state.tokens}

  def save_state(self, path: str, state: ValueTrainState) -> None:
    """Write the whole state (on a grid every process calls it)."""
    _write(path, self.state_dict(state), self.mesh)

  def restore_state(self, path: str, seed: int) -> ValueTrainState:
    """Resume: parameters, running statistics, AdamW's moments and count
    (the schedule's position) and the generator continue."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if ckpt.get('format') != FORMAT:
      raise ValueError(f'{path} is not a {FORMAT} trainer state')
    state = self.init_state(seed)
    if state.sharded is None:
      state.module.load_state_dict(ckpt['model'])
    else:
      state.sharded.load_state_dict(ckpt['model'])
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.generator.set_state(ckpt['generator'])
    state.step = int(ckpt['step'])
    state.tokens = float(ckpt['tokens'])
    return state

  # -- per-timestep evaluation ---------------------------------------------

  def evaluate_seq_step(self, state: ValueTrainState, eval_batches,
                        eval_targets):
    """Per-timestep MSE and Pearson correlation of the value net (eval
    mode) over the pre-generated batches, in float32 numpy as the JAX
    trainer computes them."""
    losses, pearsons = [], []
    with fsdp_lib.gathered(state.sharded), torch.inference_mode():
      for onehots, target in zip(eval_batches, eval_targets):
        p = state.module(onehots).float().cpu().numpy().reshape(-1)
        y = target.float().cpu().numpy().reshape(-1)
        losses.append(float(np.mean((p - y) ** 2)))
        denom = p.std() * y.std()
        pearsons.append(float(np.mean((p - p.mean()) * (y - y.mean()))
                              / denom) if denom > 0 else 0.0)
    return losses, pearsons


MULTISEP_FORMAT = 'svdd_tpu_torch.train.multisep/1'


@dataclasses.dataclass
class MultiSepTrainState:
  """The multisep model being trained (every trunk's parameters and
  running statistics, JAX's stacked variables), AdamW, the generator of
  the trajectories (JAX's state rng) and the step."""
  step: int
  msm: MultiSepValueModel
  optimizer: Optimizer
  generator: torch.Generator


class MultiSepTrainer:
  """Trains the time-binned multisep value model (``svdd_tpu/train/
  value.py:301-395``). Each iteration samples a trajectory of the frozen
  denoiser (the generator's draw, JAX's key split from the state's rng),
  regresses every bin's trunk on its bin's states onto the final
  reward (``models.multisep.bin_losses``, the bins of
  ``multisep_losses``) and takes one AdamW step (optax's defaults:
  betas (0.9, 0.999), eps 1e-8, weight decay 1e-4, no clipping) on the
  mean of the bins' losses.

  As in JAX, the trunks score in their eval form and every leaf of the
  stacked variables takes a gradient and an update: the parameters and
  the BatchNorm running means and variances, which the eval forward
  reads (``svdd_tpu/train/value.py:337-368``). The bins are
  differentiated one at a time (each bin's loss over n_models), so one
  bin's activations are alive at a time; the convs off B7's gate sum
  their weight gradients in a fixed order (``ops.conv1d._ConvPlainBwd``),
  so two runs from one seed agree bit for bit on the card. The state
  trains ``msm`` in place."""

  def __init__(self, diffusion: Diffusion, msm: MultiSepValueModel,
               reward_fn, tcfg: ValueTrainerConfig, saluki_body=None,
               mesh: Optional[mesh_lib.Mesh] = None):
    self.diffusion = diffusion
    self.msm = msm
    self.tcfg = tcfg
    self.mesh = mesh
    self._reward_fn = reward_fn
    self._transform = value_lib.make_reward_transform(
        tcfg.task, saluki_body, tcfg.saluki_final_length)
    self._sampler = diffusion.sampler(tcfg.batch_size, collect_mid=True,
                                      mesh=mesh)

  def init_state(self, seed: int) -> MultiSepTrainState:
    """A fresh state training ``msm`` in place, its generator seeded
    ``seed``."""
    leaves = self.msm.leaves()
    for t in leaves:
      t.requires_grad_(True)
    opt = Optimizer(leaves, lambda _: self.tcfg.learning_rate, None)
    gen = torch.Generator(self.diffusion.device).manual_seed(seed)
    return MultiSepTrainState(0, self.msm, opt, gen)

  def trajectory(self, state: MultiSepTrainState):
    """One trajectory of the frozen denoiser from the state's generator:
    (samples (B, L), mid_x (S-1, B, L)) as normal tensors."""
    res = self._sampler(state.generator)
    return res.samples.clone(), res.mid_x.clone()

  def grad_step(self, state: MultiSepTrainState, samples, mid_x):
    """The step on one trajectory (``train/value.py:339-370``): the
    per-bin losses and one update; the state changes in place. Returns
    (mean loss, per-bin losses), device tensors (nothing is read
    back)."""
    total = samples.shape[0]
    row0, n = (0, total) if self.mesh is None else self.mesh.rows(total)
    with torch.no_grad():
      states = torch.cat([mid_x, samples[None]], dim=0)           # (S, B, L)
      onehots = mdlm.transform_samples(states[:, row0:row0 + n])  # (S, b, L, 4)
      targets = self._reward_fn(self._transform(samples[row0:row0 + n]))
    msm = state.msm
    for t in state.optimizer.params:
      t.grad = None
    losses = []
    for loss in bin_losses(msm, onehots, targets, total):
      (loss / msm.n_models).backward()
      losses.append(loss.detach())
    losses = torch.stack(losses)
    if self.mesh is not None:
      losses = mesh_lib.sum_gradients_(state.optimizer.params,
                                       self.mesh.data_group, losses)
    state.optimizer.step()
    state.step += 1
    return losses.mean(), losses

  def train_step(self, state: MultiSepTrainState):
    """One iteration: a trajectory, then the step on it."""
    return self.grad_step(state, *self.trajectory(state))

  def train(self, state: MultiSepTrainState, num_iters: int,
            log_every: int = 50) -> MultiSepTrainState:
    for _ in range(num_iters):
      loss, losses = self.train_step(state)
      if state.step % log_every == 0:
        LOGGER.info('multisep step %d mean MSE %.5f (per-bin %s)',
                    state.step, float(loss),
                    np.round(losses.cpu().numpy(), 4).tolist())
    return state

  def save_state(self, path: str, state: MultiSepTrainState) -> None:
    _write(path, {
        'format': MULTISEP_FORMAT, 'step': state.step,
        'model': state.msm.state_dict(),
        'optimizer': state.optimizer.state_dict(),
        'generator': state.generator.get_state()}, self.mesh)

  def restore_state(self, path: str, seed: int) -> MultiSepTrainState:
    """Resume: every leaf, AdamW's moments and count, and the generator
    continue."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if ckpt.get('format') != MULTISEP_FORMAT:
      raise ValueError(f'{path} is not a {MULTISEP_FORMAT} trainer state')
    state = self.init_state(seed)
    with torch.no_grad():
      state.msm.load_state_dict(ckpt['model'])
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.generator.set_state(ckpt['generator'])
    state.step = int(ckpt['step'])
    return state


def build_eval_timestep_batches(diffusion: Diffusion, reward_fn,
                                batch_size: int, val_batch_num: int,
                                generator: torch.Generator,
                                task: str = 'dna', saluki_body=None,
                                saluki_final_length: int = 12288):
  """Per-timestep eval batches from ``val_batch_num`` full trajectories
  (``svdd_tpu/train/value.py:397-425``): (eval_batches[t],
  eval_targets[t]) for t in 0..S-1, the one-hots of every trajectory's
  state after step t (the last: the final samples) and the final
  samples' rewards (the reward's input ``make_reward_transform(task,
  saluki_body, saluki_final_length)``)."""
  transform = value_lib.make_reward_transform(task, saluki_body,
                                              saluki_final_length)
  sampler = diffusion.sampler(batch_size, collect_mid=True)
  steps = diffusion.config.sampling.steps
  all_samples = [[] for _ in range(steps)]
  all_targets = [[] for _ in range(steps)]
  for _ in range(val_batch_num):
    res = sampler(generator)
    with torch.inference_mode():
      target = reward_fn(transform(res.samples))
    for t, s in enumerate(list(res.mid_x) + [res.samples]):
      all_samples[t].append(mdlm.transform_samples(s))
      all_targets[t].append(target)
  return ([torch.cat(s) for s in all_samples],
          [torch.cat(t) for t in all_targets])
