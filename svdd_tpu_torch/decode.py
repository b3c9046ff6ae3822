"""Reward-guided decode pipeline (``svdd_tpu/decode.py``): run the
guided sampler, score its outputs with the value net and the reward
oracle, draw the unguided baseline and best-of-N, and write
``log/{task}-{reward}.npz`` with the keys ``decoding`` and ``baseline``.

Ported branches: ``svdd_mc``, ``dps``, ``classifier`` and ``none``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.diffusion import Diffusion

# the baseline folds its unguided batches into calls of at most this
# many rows (the JAX package's SVDD_BASELINE_MAX_BATCH default)
BASELINE_FOLD_CAP = 4096


@dataclasses.dataclass
class DecodeResult:
  samples: np.ndarray          # (N, L) guided tokens
  value_preds: np.ndarray      # (N,) value-net scores of guided seqs
  reward_preds: np.ndarray     # (N,) oracle scores of guided seqs
  top_k: np.ndarray            # best-of-N baseline scores
  baseline_preds: np.ndarray   # (N,) unguided oracle scores

  def save_npz(self, path: str) -> None:
    """Keys 'decoding' and 'baseline', as the reference writes them."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez(path, decoding=self.reward_preds,
             baseline=self.baseline_preds)


@torch.inference_mode()
def _score(reward_fn, samples: torch.Tensor) -> np.ndarray:
  """Oracle score of token samples."""
  return reward_fn(mdlm.transform_samples(samples)).float().cpu().numpy()


def _baseline(diffusion: Diffusion, reward_fn, batch_size: int,
              gen_batch_num: int, sample_M: int,
              generator: torch.Generator, skip_best_of_n: bool = False):
  """Unguided baseline + best-of-N: draw gen_batch_num*sample_M batches
  worth of sequences in balanced folds of at most BASELINE_FOLD_CAP
  rows, keep the first gen_batch_num*batch_size as the baseline and
  the top len/sample_M as best-of-N."""
  total = (gen_batch_num if skip_best_of_n
           else gen_batch_num * sample_M) * batch_size
  n_calls = max(1, -(-total // BASELINE_FOLD_CAP))
  big = -(-total // n_calls)
  sampler = diffusion.sampler(big)
  all_preds = np.concatenate(
      [_score(reward_fn, sampler(generator).samples)
       for _ in range(n_calls)])[:total]
  baseline = all_preds[:gen_batch_num * batch_size]
  k = max(1, len(all_preds) // sample_M)
  top_k = np.sort(all_preds)[-k:][::-1].copy()
  return baseline, top_k


def run_decode(diffusion: Diffusion, reward_fn: Callable, *,
               algo: str = 'svdd_mc',
               value_fn: Optional[Callable] = None,
               gen_batch_num: int = 1, batch_size: int = 256,
               sample_M: int = 10, guidance_scale: float = 1.0,
               seed: int = 44,
               skip_best_of_n: bool = False) -> DecodeResult:
  """One controlled decode run. algo: svdd_mc | dps | classifier | none.
  ``dps`` guides by ``reward_fn``'s gradient; ``classifier`` needs a
  differentiable one-hot ``value_fn`` (``ValueFunction.as_onehot_fn``)."""
  dev = diffusion.device
  guided_gen = torch.Generator(dev).manual_seed(seed)
  base_gen = torch.Generator(dev).manual_seed(seed + 1)
  if algo == 'svdd_mc':
    if value_fn is None:
      raise ValueError('svdd_mc needs a value_fn')
    sampler = diffusion.controlled_sampler(value_fn, batch_size,
                                           sample_M=sample_M)
  elif algo == 'dps':
    sampler = diffusion.dps_sampler(reward_fn, batch_size,
                                    guidance_scale=guidance_scale)
  elif algo == 'classifier':
    if value_fn is None:
      raise ValueError('classifier guidance needs a value_fn (one-hot)')
    sampler = diffusion.classifier_sampler(value_fn, batch_size,
                                           guidance_scale=guidance_scale)
  elif algo == 'none':
    sampler = diffusion.sampler(batch_size)
  else:
    raise NotImplementedError(f'algo {algo!r} is not ported yet')

  samples, value_preds, reward_preds = [], [], []
  for _ in range(gen_batch_num):
    res = sampler(guided_gen)
    samples.append(res.samples.cpu().numpy())
    reward_preds.append(_score(reward_fn, res.samples))
    if value_fn is not None and algo == 'svdd_mc':
      with torch.inference_mode():
        value_preds.append(value_fn(res.samples).float().cpu().numpy())
    else:
      value_preds.append(reward_preds[-1])

  baseline, top_k = _baseline(diffusion, reward_fn, batch_size,
                              gen_batch_num, sample_M, base_gen,
                              skip_best_of_n)
  return DecodeResult(
      samples=np.concatenate(samples),
      value_preds=np.concatenate(value_preds),
      reward_preds=np.concatenate(reward_preds),
      top_k=top_k, baseline_preds=baseline)
