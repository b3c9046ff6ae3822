"""Reward oracles (``svdd_tpu/rewards.py``): the frozen Enformer oracle
(DNA), the ConvGRU MRL oracle (RNA), the six-channel ConvGRU saluki
stability oracle (``--task rna_saluki``, over the padded (N, 12288, 6)
input of ``mdlm.transform_samples_saluki``) and the synthetic motif
oracle that stands in without trained weights."""

from __future__ import annotations

from typing import Callable

import torch

from svdd_tpu_torch.eval.metrics import kmer_counts
from svdd_tpu_torch.models.convgru import ConvGRUValueModel
from svdd_tpu_torch.models.enformer import EnformerValueModel

RewardFn = Callable[[torch.Tensor], torch.Tensor]   # (N, L, 4) -> (N,)


class RewardOracle:
  """A frozen scoring model; the DNA oracle predicts (hepg2, k562,
  sknsh) and decoding reads index ``task_index``."""

  def __init__(self, module: torch.nn.Module, task_index: int = 0):
    self.module = module.eval()
    self.task_index = task_index

  @classmethod
  def create_dna(cls, generator: torch.Generator, n_tasks: int = 3,
                 **kwargs) -> 'RewardOracle':
    return cls(EnformerValueModel(n_tasks=n_tasks, generator=generator,
                                  **kwargs), task_index=0)

  @classmethod
  def create_rna(cls, generator: torch.Generator, n_tasks: int = 1,
                 **kwargs) -> 'RewardOracle':
    """The RNA MRL oracle: a one-task ConvGRU."""
    return cls(ConvGRUValueModel(n_tasks=n_tasks, generator=generator,
                                 **kwargs), task_index=0)

  @classmethod
  def create_saluki(cls, generator: torch.Generator, n_tasks: int = 1,
                    **kwargs) -> 'RewardOracle':
    """The saluki stability oracle: a one-task ConvGRU whose stem takes
    six channels. Its input's length (``final_length``) is the caller's:
    the ConvGRU has no pooling, so any length runs."""
    kwargs['in_channels'] = 6
    return cls(ConvGRUValueModel(n_tasks=n_tasks, generator=generator,
                                 **kwargs), task_index=0)

  def __call__(self, onehot4: torch.Tensor,
               fused: bool = True) -> torch.Tensor:
    """(N, L, 4) -> (N,); ``fused=False`` takes the Enformer's
    differentiable tower, the form a gradient (DPS) needs (the ConvGRU
    has one form)."""
    out = self.module(onehot4, fused)
    return out[:, self.task_index] if out.ndim == 2 else out


def synthetic_motif_oracle(length: int, motif: str = 'GCGC',
                           weight: float = 1.0) -> RewardFn:
  """Deterministic reward: summed relu'd PWM match score of a fixed
  motif over all windows, divided by the length. Plain ops, so it is
  differentiable on one-hots and probabilities alike (DPS)."""
  alphabet = {'A': 0, 'C': 1, 'G': 2, 'T': 3}
  k = len(motif)
  pwm = torch.full((k, 4), -0.5)
  for i, ch in enumerate(motif):
    pwm[i, alphabet[ch]] = 1.0
  pwm = pwm * weight

  def reward(onehot4: torch.Tensor) -> torch.Tensor:
    p = pwm.to(device=onehot4.device, dtype=onehot4.dtype)
    windows = torch.stack(
        [onehot4[:, i:length - k + 1 + i, :] for i in range(k)],
        dim=2)                                     # (N, L-k+1, k, 4)
    scores = torch.einsum('nlka,ka->nl', windows, p)
    return torch.relu(scores).sum(dim=-1) / length

  return reward


# the reference oracle module's k-mer counter (``svdd_tpu/rewards.py:108-115``)
count_kmers = kmer_counts
