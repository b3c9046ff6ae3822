"""Value-function API (``svdd_tpu/value.py``): the value-net factory
and the bundle whose ``score_tokens`` the guided samplers call."""

from __future__ import annotations

import os

import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.models.enformer import EnformerValueModel


def build_value_module(task: str, model: str = 'enformer',
                       n_tasks: int = 1,
                       generator: torch.Generator | None = None,
                       **kwargs) -> EnformerValueModel:
  """Value-net factory; only the DNA Enformer is ported. Without a
  ``compute_dtype`` it computes in bfloat16 under SVDD_VALUE_BF16=1, else
  in float32 (``svdd_tpu/value.py:build_value_module``)."""
  if task != 'dna' or model != 'enformer':
    raise NotImplementedError(f'value model {model!r} for task {task!r} '
                              'is not ported yet')
  if ('compute_dtype' not in kwargs
      and os.environ.get('SVDD_VALUE_BF16') == '1'):
    kwargs['compute_dtype'] = torch.bfloat16
  return EnformerValueModel(n_tasks=n_tasks, generator=generator,
                            **kwargs)


class ValueFunction:
  """A value module in eval mode, scoring token sequences."""

  def __init__(self, module: EnformerValueModel, length: int):
    self.module = module.eval()
    self.length = length

  @classmethod
  def create(cls, task: str, length: int, generator: torch.Generator,
             model: str = 'enformer', n_tasks: int = 1,
             **kwargs) -> 'ValueFunction':
    return cls(build_value_module(task, model, n_tasks, generator,
                                  **kwargs), length)

  def score_onehot(self, onehot4: torch.Tensor,
                   fused: bool = True) -> torch.Tensor:
    """(N, L, 4) one-hot -> (N,) value; ``fused=False`` takes the
    differentiable tower."""
    return self.module(onehot4, fused)

  def score_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
    """(N, L) tokens (MASK rows zeroed in the one-hot) -> (N,)."""
    return self.score_onehot(mdlm.transform_samples(tokens))

  def as_onehot_fn(self):
    """The value on (N, L, 4) one-hots, differentiable with respect to
    them: classifier guidance takes its gradient
    (``svdd_tpu/value.py:as_onehot_fn``)."""
    return lambda onehot4: self.score_onehot(onehot4, fused=False)
