"""MDLM diffusion pretraining of the denoiser (``svdd_tpu/train/diffusion.py``):
any backbone of ``Diffusion`` (the CNN, DiT, DiMamba, or the AR baseline
under ``parameterization='ar'``).

One optimizer step: the batch split into ``training.accum_steps``
microbatches, each with its own times, masks and dropout; their losses
and gradients averaged; the gradients clipped to ``optim.grad_clip`` by
their global norm (optax's rule: unchanged below the norm, else scaled
by max_norm / norm, no epsilon); AdamW (``torch.optim.AdamW``, its
default implementation) at the schedule's rate for the number of updates
already made, so the first update of a warmup has rate 0; then the EMA.
The parameters, the optimizer's moments and the EMA shadow are updated
in place.

The state's ``generator`` draws every random number of training; a
checkpoint holds it with the parameters, buffers, optimizer state, EMA
and the data iterator's position, so a run resumed from one continues
as the uninterrupted run does, bit for bit: on the card every gradient
of the denoiser sums in a fixed order (the layers' backward kernel B6,
and ``ops.conv1d.conv1d_deterministic`` for the stem and 1x1 convs), so
the trainer needs no process-wide cuDNN setting.

Checkpoints are ``<ckpt_dir>/step_<n>.pt``, written to a temporary file
and renamed, the newest three kept; the best by validation NLL is kept
under ``<ckpt_dir>/best/``. They are read with ``torch.load(...,
weights_only=True)``.

On a process grid (``mesh``, ``svdd_tpu/train/diffusion.py:100-150``)
each process holds its rows of the global batch, every process of a
model group the same ones. A microbatch is ``accum_steps``' share of the
global batch's contiguous rows, as JAX reshapes it, so it may straddle
processes: each process runs its rows of it, the noise its rows of the
global microbatch's draws (``parallel/rows.py``, every generator seeded
alike), the loss its rows' NLL over the microbatch's global token count
(all-reduced), and the gradients are summed over ``data`` in one
all-reduce with the loss. Under ``parallel.fsdp`` the parameters,
AdamW's moments and the EMA shadow are shards (``parallel/fsdp.py``):
the parameters gathered for a step's forward and backward and freed
after it, the gradients reduce-scattered, the clip's norm the whole
gradient's. On a pipe grid (``parallel.pipeline_stages`` > 1, the DiT;
JAX's ``_pipeline_apply_fn``, ``svdd_tpu/train/diffusion.py:78-97``)
every process holds the whole state and the whole global batch, draws
the same noise, and runs the loss through the pipelined forward
(``parallel/pipeline.py``), whose backward leaves the whole gradient on
every process, so the updates agree on every process. Process 0 writes
the checkpoints, gathered whole and in the single-process format, so a
checkpoint resumes at any grid size; every process reads them.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import os
import re
import time
from typing import Any, Callable, Optional

import torch

from svdd_tpu_torch import utils
from svdd_tpu_torch.config import Config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.models import ema as ema_lib
from svdd_tpu_torch.parallel import mesh as mesh_lib
from svdd_tpu_torch.parallel import fsdp as fsdp_lib
from svdd_tpu_torch.parallel import rows as rows_lib
from svdd_tpu_torch.parallel.fsdp import ShardedParams
from svdd_tpu_torch.parallel.pipeline import (PIPE_AXIS,
                                              pipelined_backbone_apply)

LOGGER = logging.getLogger(__name__)
FORMAT = 'svdd_tpu_torch.train.diffusion/1'
KEEP = 3
_CKPT = re.compile(r'step_(\d+)\.pt$')


def make_schedule(config: Config):
  """count -> learning rate, from ``optim.lr_schedule``."""
  o = config.optim
  if o.lr_schedule == 'cosine_decay_warmup':
    return utils.cosine_decay_warmup_schedule(o.lr, o.warmup_steps,
                                              o.max_steps, o.lr_min)
  return utils.constant_warmup_schedule(o.lr, o.warmup_steps)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
  """optax.clip_by_global_norm in place: every gradient becomes
  (g / ||g||) * max_norm where the global norm ||g|| is at least
  max_norm, and stays as it is below. Returns the norm, on the
  gradients' device (nothing is read back); a few multi-tensor ops, not
  a handful per tensor. ``norm``: the global norm where the gradients
  are shards of it (FSDP)."""
  grads = list(grads)
  if norm is None:
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
  keep = norm < max_norm
  torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
  torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
  return norm


class Optimizer:
  """optax.chain(clip_by_global_norm(max_norm), adamw(schedule)) over
  ``params`` (no clipping where ``max_norm`` is None); ``schedule``:
  count -> learning rate; ``count`` is the number of updates made.
  ``sharded``: the ``ShardedParams`` whose parts ``params`` are (FSDP),
  which gives the clip the whole gradient's norm."""

  def __init__(self, params, schedule, max_norm: Optional[float],
               betas=(0.9, 0.999), eps: float = 1e-8,
               weight_decay: float = 1e-4, sharded=None):
    self.params = list(params)
    self.schedule = schedule
    self.max_norm = max_norm
    self.sharded = sharded
    self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=tuple(betas),
                                   eps=eps, weight_decay=weight_decay)
    self.count = 0

  def step(self) -> None:
    """One update from the parameters' ``.grad``."""
    if self.max_norm is not None:
      norm = None if self.sharded is None else self.sharded.global_norm()
      clip_by_global_norm_([p.grad for p in self.params], self.max_norm,
                           norm)
    for group in self.adamw.param_groups:
      group['lr'] = self.schedule(self.count)
    self.adamw.step()
    self.count += 1

  def state_dict(self) -> dict:
    """The single-process state (FSDP: gathered, a collective)."""
    state = {'adamw': self.adamw.state_dict(), 'count': self.count}
    if self.sharded is None:
      return state
    return self.sharded.full_optimizer_state(state)

  def load_state_dict(self, state: dict) -> None:
    """A single-process state (FSDP: this process's shards of it)."""
    if self.sharded is not None:
      state = self.sharded.shard_optimizer_state(state)
    self.adamw.load_state_dict(state['adamw'])
    self.count = int(state['count'])


def make_optimizer(config: Config, params, sharded=None) -> Optimizer:
  o = config.optim
  return Optimizer(params, make_schedule(config), o.grad_clip,
                   (o.beta1, o.beta2), o.eps, o.weight_decay, sharded)


@dataclasses.dataclass
class TrainState:
  """The trained model (its backbone's parameters and buffers), the
  optimizer, the EMA of the parameters and the generator of the noise;
  ``step`` counts the optimizer updates. On a grid, ``mesh`` (a
  ``Mesh``, or a ``PipeMesh``), and under FSDP ``sharded``, whose parts
  the optimizer and the EMA hold; ``apply_fn``, the denoiser's forward in
  the loss where it is not the backbone's own (the pipelined DiT's)."""
  step: int
  model: Diffusion
  optimizer: Optimizer
  ema: ema_lib.EMAState
  generator: torch.Generator
  mesh: Any = None
  sharded: Optional[ShardedParams] = None
  apply_fn: Optional[Callable] = None

  def trained(self) -> dict:
    """name -> the tensors the optimizer and the EMA update: the
    backbone's parameters, or under FSDP this process's parts."""
    if self.sharded is not None:
      return self.sharded.local
    return dict(self.model.backbone.named_parameters())


def _data_mesh(mesh):
  """The grid's data axis: ``mesh``, or None on a pipe grid (every stage
  holds the whole batch) and without one."""
  return (mesh if mesh is not None and mesh_lib.DATA_AXIS in mesh.shape
          else None)


def _pipeline_apply_fn(model: Diffusion, config: Config, mesh):
  """The pipelined denoiser forward where ``parallel.pipeline_stages`` >
  1 (``svdd_tpu/train/diffusion.py:78``), else None: the DiT's blocks
  over ``mesh``'s pipe axis."""
  stages = config.parallel.pipeline_stages
  if stages <= 1:
    return None
  if config.backbone != 'dit':
    raise ValueError('pipeline_stages>1 supports the dit backbone '
                     f'only (got {config.backbone!r})')
  if mesh is None or PIPE_AXIS not in mesh.shape:
    raise ValueError("pipeline_stages>1 needs a mesh with a 'pipe' "
                     'axis (parallel.pipeline.PIPE_AXIS)')
  if mesh.shape[PIPE_AXIS] != stages:
    raise ValueError(f"mesh 'pipe' axis {mesh.shape[PIPE_AXIS]} != "
                     f'pipeline_stages {stages}')
  return pipelined_backbone_apply(
      model.backbone, mesh=mesh,
      num_microbatches=config.parallel.pipeline_microbatches,
      virtual=config.parallel.pipeline_virtual)


def init_state(model: Diffusion, config: Config,
               generator: Optional[torch.Generator] = None,
               mesh=None) -> TrainState:
  """A fresh state on ``model``'s backbone (trained in place); the
  generator is seeded from ``config.seed`` unless given. ``mesh``: the
  process grid (``parallel.fsdp`` shards the state over it), or a pipe
  grid, over which the pipelined forward runs."""
  if generator is None:
    generator = torch.Generator(model.device).manual_seed(config.seed)
  apply_fn = _pipeline_apply_fn(model, config, mesh)
  sharded = None
  if mesh is not None and config.parallel.fsdp:
    if mesh_lib.DATA_AXIS not in mesh.shape:
      raise ValueError(
          "parallel.fsdp needs a 'data' mesh axis (pipe-only "
          'meshes replicate params; stage weights are already '
          'split by the GPipe shard_map)')
    sharded = ShardedParams(model.backbone, mesh,
                            config.parallel.fsdp_min_size)
  params = (sharded.local if sharded is not None
            else dict(model.backbone.named_parameters()))
  return TrainState(0, model, make_optimizer(config, params.values(),
                                             sharded),
                    ema_lib.init(params, config.training.ema), generator,
                    mesh, sharded, apply_fn)


def _batch_to(batch, device) -> dict:
  """The batch's tokens (int64) and attention mask as device tensors."""
  out = {'seqs': torch.as_tensor(batch['seqs']).to(device, torch.long)}
  if batch.get('attention_mask') is not None:
    out['attention_mask'] = torch.as_tensor(batch['attention_mask']).to(
        device, torch.float32)
  return out


def _data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
  """x summed over the data axis (in float32); x itself without a
  grid."""
  return x if mesh is None else mesh_lib.all_reduce_(x.float(),
                                                     mesh.data_group)


def train_step(state: TrainState, batch, config: Config, noise=None,
               masks=None) -> torch.Tensor:
  """One optimizer step on ``batch`` (numpy arrays or device tensors;
  on a grid, this process's rows of the global batch); returns the mean
  loss (a 0-dim device tensor). ``noise``: one (t_uniforms,
  mask_uniforms) pair per microbatch, and ``masks`` one list of dropout
  masks per microbatch (the DiT's and AR's), in place of the generator's
  draws (tests; on a grid, the global microbatch's). The local rows of
  microbatch i are its global rows [lo, hi) that this process holds
  (module docstring); with none, the process still draws the
  microbatch's noise (a forward on no rows), so every generator stays in
  step. Without a grid the process holds every row and no collective
  runs; on a pipe grid too, but for the pipelined forward's
  (``state.apply_fn``)."""
  mesh = _data_mesh(state.mesh)
  accum = max(1, config.training.accum_steps)
  model = state.model
  b = _batch_to(batch, model.device)
  n = b['seqs'].shape[0]
  row0, total = ((0, n) if mesh is None
                 else (mesh.data_index * n, n * mesh.data))
  if total % accum:
    raise ValueError(f'batch {total} does not split into {accum} '
                     'microbatches')
  mb = total // accum
  backbone = model.backbone
  mask = b.get('attention_mask')
  loss = None
  with fsdp_lib.gathered(state.sharded):
    for p in backbone.parameters():
      p.grad = None
    for i in range(accum):
      lo, hi = max(i * mb, row0), min((i + 1) * mb, row0 + n)
      hi = max(hi, lo)
      start = lo - i * mb if hi > lo else 0
      nz = None if noise is None else tuple(t[start:start + hi - lo]
                                            for t in noise[i])
      mk = None if masks is None else [m[start:start + hi - lo]
                                       for m in masks[i]]
      with (contextlib.nullcontext() if mesh is None
            else rows_lib.global_rows(start, mb)):
        out = model.loss(b['seqs'][lo - row0:hi - row0],
                         None if mask is None else mask[lo - row0:hi - row0],
                         train=True, generator=state.generator, noise=nz,
                         masks=mk, apply_fn=state.apply_fn)
      part = out.nlls.sum() / _data_sum(out.token_mask.sum(), mesh)
      if hi > lo:
        part.backward()
      part = part.detach()
      loss = part if loss is None else loss + part
    grads = [p.grad for p in backbone.parameters() if p.grad is not None]
    if accum > 1:
      with torch.no_grad():
        torch._foreach_div_(grads, accum)
    if state.sharded is not None:
      loss = state.sharded.reduce_grads(loss)
    elif mesh is not None:
      loss = mesh_lib.sum_gradients_(backbone.parameters(), mesh.data_group,
                                     loss)
  if accum > 1:
    loss = loss / accum
  state.optimizer.step()
  ema_lib.update(state.ema, state.trained())
  state.step += 1
  return loss


def eval_step(model: Diffusion, batch, generator=None, noise=None,
              apply_fn=None):
  """(sum of the masked token NLLs, token count), 0-dim device tensors,
  of ``model`` (the EMA weights, as the trainer passes it) on ``batch``;
  ``apply_fn``: the pipelined forward of ``model``'s backbone
  (``svdd_tpu/train/diffusion.py:153``)."""
  b = _batch_to(batch, model.device)
  with torch.inference_mode():
    out = model.loss(b['seqs'], b.get('attention_mask'),
                     generator=generator, noise=noise, apply_fn=apply_fn)
  return out.nlls.sum(), out.token_mask.sum()


@dataclasses.dataclass
class Trainer:
  """Trains, validates and checkpoints. ``logger``: a
  ``observability.MetricsLogger``; ``sample_eval_fn``: (diffusion holding
  the EMA weights, generator) -> dict of sample-quality metrics, run after
  each validation."""
  model: Diffusion
  config: Config
  ckpt_dir: Optional[str] = None
  logger: Any = None
  sample_eval_fn: Any = None
  mesh: Any = None

  def __post_init__(self):
    self._ema_model = None
    self._best_nll = None

  @property
  def lead(self) -> bool:
    """Whether this process logs and writes (process 0 of a grid)."""
    return self.mesh is None or self.mesh.rank == 0

  def eval_model(self, state: TrainState) -> Diffusion:
    """A Diffusion holding the EMA weights (the live model when
    ``eval.disable_ema``, under FSDP a copy of it); one copy of the
    backbone, refreshed each call (under FSDP a collective)."""
    if self.config.eval.disable_ema and state.sharded is None:
      return state.model
    if self._ema_model is None:
      with fsdp_lib.gathered(state.sharded):
        backbone = copy.deepcopy(state.model.backbone)
      self._ema_model = Diffusion(self.config, device=state.model.device,
                                  backbone=backbone)
    weights = (model_params(state) if self.config.eval.disable_ema
               else ema_shadow(state))
    with torch.no_grad():
      for name, p in self._ema_model.backbone.named_parameters():
        p.copy_(weights[name])
    return self._ema_model

  def init_or_restore(self, train_iter=None) -> TrainState:
    state = init_state(self.model, self.config, mesh=self.mesh)
    if self.ckpt_dir and self.config.checkpointing.resume_from_ckpt:
      restore_checkpoint(self.ckpt_dir, state, train_iter)
    return state

  def fit(self, state: TrainState, train_iter, valid_iter=None,
          num_steps: Optional[int] = None, log_every: int = 100,
          eval_every: Optional[int] = None,
          ckpt_every: Optional[int] = None) -> TrainState:
    """``num_steps`` more steps (``optim.max_steps`` by default). Every
    ``log_every`` steps the loss is read back and logged; every
    ``eval_every`` the validation NLL (with the best checkpoint and the
    sample-quality hook); every ``ckpt_every`` a checkpoint.
    ``SVDD_CRASH_AT_STEP=n`` raises after step n's checkpoint, as a
    worker dying between checkpoints would."""
    num_steps = num_steps or self.config.optim.max_steps
    eval_every = eval_every or self.config.eval.val_check_interval
    ckpt_every = ckpt_every or self.config.checkpointing.every_n_steps
    iter_state = getattr(train_iter, 'state_dict', lambda: {})
    it = iter(train_iter)
    t0 = time.time()
    for _ in range(num_steps):
      loss = train_step(state, next(it), self.config)
      step = state.step
      if step % log_every == 0:
        loss = float(loss)
        steps_per_s = log_every / max(time.time() - t0, 1e-9)
        LOGGER.info('step %d loss %.4f (%.2f steps/s)', step, loss,
                    steps_per_s)
        if self.logger is not None and self.lead:
          self.logger.log({'train/loss': loss,
                           'train/steps_per_s': steps_per_s}, step=step)
        t0 = time.time()
      if valid_iter is not None and step % eval_every == 0:
        nll = self.evaluate(state, valid_iter)
        LOGGER.info('step %d val/nll %.4f', step, nll)
        if self.logger is not None and self.lead:
          self.logger.log({'val/nll': nll}, step=step)
        if self.ckpt_dir:
          self.save_best(state, nll, iter_state())
        if self.sample_eval_fn is not None:
          ema_model = self.eval_model(state)    # a collective under FSDP
          if self.lead:
            gen = torch.Generator(state.model.device).manual_seed(17 + step)
            qmetrics = self.sample_eval_fn(ema_model, gen)
            LOGGER.info('step %d sample-quality: %s', step,
                        {k: round(float(v), 4) for k, v in qmetrics.items()})
            if self.logger is not None:
              self.logger.log(qmetrics, step=step)
      if self.ckpt_dir and step % ckpt_every == 0:
        save_checkpoint(self.ckpt_dir, state, iter_state())
      crash_at = os.environ.get('SVDD_CRASH_AT_STEP')
      if crash_at and step >= int(crash_at):
        raise RuntimeError(f'SVDD_CRASH_AT_STEP fault injection: dying at '
                           f'step {step}')
    return state

  def evaluate(self, state: TrainState, valid_iter, max_batches: int = 8,
               noise=None) -> float:
    """Token-mean NLL over ``max_batches`` validation batches on the EMA
    weights, the noise from a generator seeded 0 (or ``noise``, a pair a
    batch). On a grid each process holds its rows of the global batches,
    draws their noise and sums with the others; on a pipe grid each
    process holds the whole batches, through the pipelined forward."""
    model = self.eval_model(state)
    apply_fn = _pipeline_apply_fn(model, self.config, self.mesh)
    gen = torch.Generator(model.device).manual_seed(0)
    total, count = 0.0, 0.0
    for i, batch in zip(range(max_batches), iter(valid_iter)):
      nz = None if noise is None else noise[i]
      if _data_mesh(self.mesh) is None:
        nll, n = eval_step(model, batch, gen, nz, apply_fn)
      else:
        rows = len(batch['seqs'])
        with rows_lib.global_rows(self.mesh.data_index * rows,
                                  self.mesh.data * rows):
          nll, n = eval_step(model, batch, gen, nz)
        nll, n = mesh_lib.all_reduce_(torch.stack([nll.float(), n.float()]),
                                      self.mesh.data_group)
      total += float(nll)
      count += float(n)
    return total / max(count, 1.0)

  def save_best(self, state: TrainState, val_nll: float,
                iterator_state: Optional[dict] = None) -> None:
    """Keep ``state`` under ``<ckpt_dir>/best/`` if its validation NLL is
    the lowest so far (the one checkpoint there)."""
    best_dir = os.path.join(self.ckpt_dir, 'best')
    if self._best_nll is None:
      kept = latest_checkpoint(best_dir)
      self._best_nll = (float('inf') if kept is None
                        else _load(kept).get('val_nll', float('inf')))
    better = val_nll < self._best_nll
    if self.mesh is not None:       # process 0's reading decides for all
      better = bool(mesh_lib.all_reduce_(torch.tensor(
          [float(better and self.lead)], device=state.model.device),
          self.mesh.group))
    if better:
      self._best_nll = val_nll
      save_checkpoint(best_dir, state, iterator_state, keep=1,
                      val_nll=val_nll)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def checkpoint_paths(ckpt_dir: str) -> list:
  """The port's checkpoints under ``ckpt_dir``, oldest step first."""
  if not os.path.isdir(ckpt_dir):
    return []
  found = [(int(m.group(1)), os.path.join(ckpt_dir, name))
           for name in os.listdir(ckpt_dir) if (m := _CKPT.match(name))]
  return [p for _, p in sorted(found)]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
  paths = checkpoint_paths(ckpt_dir)
  return paths[-1] if paths else None


def has_checkpoint(ckpt_dir: str) -> bool:
  """Whether ``ckpt_dir`` holds one of the port's checkpoints, at its top
  or under ``best/``."""
  return bool(checkpoint_paths(ckpt_dir)
              or checkpoint_paths(os.path.join(ckpt_dir, 'best')))


def model_params(state: TrainState) -> dict:
  """name -> each trained parameter, whole (FSDP: gathered, a
  collective)."""
  if state.sharded is None:
    return dict(state.model.backbone.named_parameters())
  with torch.no_grad():
    return state.sharded.full(state.sharded.local)


def ema_shadow(state: TrainState) -> dict:
  """name -> the EMA of each parameter, whole (FSDP: gathered, a
  collective)."""
  shadow = ema_lib.params(state.ema)
  return shadow if state.sharded is None else state.sharded.full(shadow)


def state_dict(state: TrainState, iterator_state: Optional[dict] = None,
               **extra) -> dict:
  """The checkpoint's dict, in the single-process format whatever the
  grid (FSDP: gathered; every process calls it)."""
  it = {'epoch': 0, 'counter': 0, 'seed': 0}
  it.update(iterator_state or {})
  return {'format': FORMAT, 'step': state.step,
          'model': (state.model.backbone.state_dict()
                    if state.sharded is None
                    else state.sharded.state_dict()),
          'optimizer': state.optimizer.state_dict(),
          'ema': {'decay': state.ema.decay,
                  'num_updates': state.ema.num_updates,
                  'shadow': ema_shadow(state)},
          'generator': state.generator.get_state(),
          'iterator': it, **extra}


def write_atomic(path: str, obj: dict) -> None:
  """``torch.save`` of one dict to a temporary file, renamed to ``path``,
  so a reader never sees a partial file."""
  tmp = path + '.tmp'
  torch.save(obj, tmp)
  os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    iterator_state: Optional[dict] = None, keep: int = KEEP,
                    **extra) -> str:
  """Write ``step_<n>.pt`` through a temporary file and a rename, then
  delete all but the newest ``keep``. Returns its path. On a grid every
  process calls it, process 0 writes, and all wait for the file."""
  path = os.path.join(ckpt_dir, f'step_{state.step}.pt')
  obj = state_dict(state, iterator_state, **extra)
  if state.mesh is None or state.mesh.rank == 0:
    os.makedirs(ckpt_dir, exist_ok=True)
    write_atomic(path, obj)
    for old in checkpoint_paths(ckpt_dir)[:-keep]:
      os.remove(old)
  if state.mesh is not None:
    torch.distributed.barrier(state.mesh.group)
  return path


def _load(path: str) -> dict:
  ckpt = torch.load(path, map_location='cpu', weights_only=True)
  if ckpt.get('format') != FORMAT:
    raise ValueError(f'{path} is not a {FORMAT} checkpoint')
  return ckpt


def load_state(state: TrainState, ckpt: dict, train_iter=None) -> TrainState:
  """Load a checkpoint's dict into ``state`` in place (and the iterator's
  position into ``train_iter``)."""
  state.step = int(ckpt['step'])
  shadow = ckpt['ema']['shadow']
  if state.sharded is None:
    state.model.backbone.load_state_dict(ckpt['model'])
  else:                                 # this process's shards
    state.sharded.load_state_dict(ckpt['model'])
    shadow = state.sharded.shard(shadow)
  state.optimizer.load_state_dict(ckpt['optimizer'])
  state.ema.num_updates = int(ckpt['ema']['num_updates'])
  with torch.no_grad():
    for k, s in state.ema.shadow.items():
      s.copy_(shadow[k])
  state.generator.set_state(ckpt['generator'])
  if train_iter is not None:
    train_iter.load_state_dict(ckpt['iterator'])
  return state


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       train_iter=None) -> TrainState:
  """The newest checkpoint under ``ckpt_dir`` into ``state``; the state
  as it is where there is none."""
  path = latest_checkpoint(ckpt_dir)
  if path is None:
    return state
  load_state(state, _load(path), train_iter)
  LOGGER.info('restored checkpoint at step %d', state.step)
  return state


def checkpoint_file(path: str) -> Optional[str]:
  """The checkpoint ``path`` names: a file itself, or the newest
  ``step_<n>.pt`` of a directory (at its top, else under ``best/``);
  None where there is none."""
  if os.path.isdir(path):
    return (latest_checkpoint(path)
            or latest_checkpoint(os.path.join(path, 'best')))
  return path if os.path.isfile(path) else None


def load_ema_weights(model: Diffusion, path: str) -> Diffusion:
  """``model`` holding the EMA weights of the checkpoint file ``path``."""
  shadow = _load(path)['ema']['shadow']
  with torch.no_grad():
    for name, p in model.backbone.named_parameters():
      p.copy_(shadow[name])
  return model


def restore_best_checkpoint(ckpt_dir: str, state: TrainState) -> TrainState:
  """The lowest-validation-NLL checkpoint (``best/``), else the newest."""
  best_dir = os.path.join(ckpt_dir, 'best')
  if latest_checkpoint(best_dir) is not None:
    return restore_checkpoint(best_dir, state)
  return restore_checkpoint(ckpt_dir, state)
