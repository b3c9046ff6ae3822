"""The time-binned multi-trunk value model (``svdd_tpu/models/
multisep.py``): ``n_models`` separate value nets (Enformer or ConvGRU
trunks with their heads), each owning a contiguous bin of diffusion
steps.

JAX stacks the trunks' variables along a leading axis and vmaps one
module over them; the port keeps a list of modules, one a bin, which
``multisep_losses`` runs bin by bin (the same losses and gradients, one
bin's activations alive at a time). Both of JAX's binning rules are
kept as they are: ``model_index`` maps step // (num_steps // n_models),
clipped to the last bin (at 128 steps and 10 bins, steps 108-127 all go
to bin 9), and ``multisep_losses`` slices S // n_models states a bin
from the trajectory's S (with ``jax.lax.dynamic_slice``'s clamp of a
start past S - size), so at S = 128 states 120-127 train no bin.

The trunks score in their eval form (fused tower, BatchNorm on its
running statistics), as JAX's ``module.apply(model_vars, flat)`` does,
also when the trainer differentiates them (``train/value.py:
MultiSepTrainer``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
from torch import nn


class MultiSepValueModel(nn.Module):
  """``trunks``: one value net a bin, in bin order, over ``num_steps``
  diffusion steps."""

  def __init__(self, trunks, num_steps: int = 128):
    super().__init__()
    self.trunks = nn.ModuleList(trunks)
    self.n_models = len(self.trunks)
    self.num_steps = num_steps

  @classmethod
  def create(cls, build: Callable[[torch.Generator], nn.Module],
             n_models: int = 10, num_steps: int = 128,
             generator: torch.Generator | None = None
             ) -> 'MultiSepValueModel':
    """``n_models`` trunks of ``build(generator)``, drawn in turn from
    ``generator`` (``multisep.py:init``)."""
    if generator is None:
      generator = torch.Generator().manual_seed(0)
    return cls([build(generator) for _ in range(n_models)], num_steps)

  def model_index(self, step: int) -> int:
    """step in [0, num_steps) -> its bin (``multisep.py:39-42``)."""
    bin_size = self.num_steps // self.n_models
    return min(max(int(step) // bin_size, 0), self.n_models - 1)

  def apply_at_step(self, onehot4: torch.Tensor, step: int) -> torch.Tensor:
    """Score with the trunk owning ``step``."""
    return self.trunks[self.model_index(step)](onehot4)

  def apply_all(self, onehot4: torch.Tensor) -> torch.Tensor:
    """(n_models, N) scores, every trunk on the same rows."""
    return torch.stack([trunk(onehot4) for trunk in self.trunks])

  def leaves(self):
    """Every tensor JAX's stacked variables hold: the parameters and the
    BatchNorm running statistics (``named_buffers``), which the trainer
    differentiates and updates alike."""
    return list(self.parameters()) + list(self.buffers())


def bin_slices(s: int, n_models: int):
  """The (start, size) of each bin's states out of S: size S // n_models
  (at least 1), the start clamped to S - size as ``jax.lax.
  dynamic_slice_in_dim`` clamps it."""
  size = max(1, s // n_models)
  return [(min(i * size, s - size), size) for i in range(n_models)]


def bin_loss(trunk: nn.Module, states_by_step: torch.Tensor,
             targets: torch.Tensor, start: int, size: int,
             batch: Optional[int] = None) -> torch.Tensor:
  """The MSE of ``trunk`` on its bin's states, every state of a
  trajectory regressing onto its final reward (``multisep.py:61-67``):
  the squared errors' sum over size x ``batch`` (the trajectories held
  by default; a process's share of a batch split over processes takes
  the global batch)."""
  sl = states_by_step[start:start + size]
  preds = trunk(sl.reshape((-1,) + tuple(sl.shape[2:])))
  t = targets.repeat(size)
  sq = (preds.reshape(-1) - t) ** 2
  return sq.sum() / (sq.numel() if batch is None else size * batch)


def bin_losses(msm: MultiSepValueModel, states_by_step: torch.Tensor,
               targets: torch.Tensor, batch: Optional[int] = None):
  """Each bin's MSE in bin order, computed as it is drawn: the trainer
  differentiates one before the next is built."""
  for trunk, (start, size) in zip(
      msm.trunks, bin_slices(states_by_step.shape[0], msm.n_models)):
    yield bin_loss(trunk, states_by_step, targets, start, size, batch)


def multisep_losses(msm: MultiSepValueModel, states_by_step: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
  """Per-bin MSE (``svdd_tpu/models/multisep.py:multisep_losses``):
  states_by_step (S, B, L, 4) one-hots, targets (B,) -> (n_models,)."""
  return torch.stack(list(bin_losses(msm, states_by_step, targets)))


FORMAT = 'svdd_tpu_torch.multisep/1'


def save_checkpoint(path: str, msm: MultiSepValueModel) -> None:
  """Write the trained multisep model (its trunks' task, widths, bins and
  state) to ``path``, through a temporary file and a rename. No decoder
  of either package reads it: JAX's value-net factory refuses
  'multienformer'."""
  from svdd_tpu_torch.models.convgru import ConvGRUValueModel
  from svdd_tpu_torch.train.diffusion import write_atomic
  if os.path.dirname(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
  trunk = msm.trunks[0]
  write_atomic(path, {
      'format': FORMAT,
      'task': 'rna' if isinstance(trunk, ConvGRUValueModel) else 'dna',
      'config': trunk.config(), 'n_models': msm.n_models,
      'num_steps': msm.num_steps, 'model': msm.state_dict()})
