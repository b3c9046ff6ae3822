"""Reward-guided decode pipeline (``svdd_tpu/decode.py``): run the
guided sampler, score its outputs with the value net and the reward
oracle, draw the unguided baseline and best-of-N, and write
``log/{task}-{reward}.npz`` with the keys ``decoding`` and ``baseline``.

Ported branches: ``svdd_mc`` (with scheduled M), ``svdd_pm``, ``tds``,
``dps``, ``classifier`` and ``none``. A TDS run reads its ESS trace back
once, after the loop, into ``DecodeResult.diagnostics``. Under
``task='rna_saluki'`` the oracle scores the saluki input
(``mdlm.transform_samples_saluki``) of the guided samples, of the
baseline's and of SVDD-PM's candidates.

``SVDD_AOT_CACHE``, which makes the JAX decode serve its sampler from a
compiled XLA executable on disk, has no counterpart: the port's sampler
runs eagerly and its one compile step, the kernels' nvcc build, is cached
under ``build/svdd_tpu_torch/`` already. Where the variable is set, the
first decode of the process logs that it is ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.diffusion import Diffusion

LOGGER = logging.getLogger(__name__)
_AOT_NOTICE = ('SVDD_AOT_CACHE is set, and ignored: the port compiles no '
               'sampler ahead of time (it runs eagerly; its CUDA kernels '
               'are built once by nvcc and cached under build/)')
_aot_noticed = False


def _notice_aot_cache() -> None:
  """Log ``_AOT_NOTICE`` once a process where SVDD_AOT_CACHE is set."""
  global _aot_noticed
  if os.environ.get('SVDD_AOT_CACHE') and not _aot_noticed:
    _aot_noticed = True
    LOGGER.warning(_AOT_NOTICE)

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
  diagnostics: Optional[dict] = None   # TDS: the per-step ESS traces

  def save_npz(self, path: str) -> None:
    """Keys 'decoding' and 'baseline', as the reference writes them."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savez(path, decoding=self.reward_preds,
             baseline=self.baseline_preds)


@torch.inference_mode()
def _score(reward_fn, samples: torch.Tensor, task: str = 'dna',
           saluki_body=None, saluki_final_length: int = 12288
           ) -> np.ndarray:
  """Oracle score of token samples; ``rna_saluki`` through the saluki
  input builder (``svdd_tpu/decode.py:58-66``)."""
  if task == 'rna_saluki':
    onehot = mdlm.transform_samples_saluki(samples, saluki_body,
                                           final_length=saluki_final_length)
  else:
    onehot = mdlm.transform_samples(samples)
  return reward_fn(onehot).float().cpu().numpy()


def _baseline(diffusion: Diffusion, reward_fn, batch_size: int,
              gen_batch_num: int, sample_M: int,
              generator: torch.Generator, skip_best_of_n: bool = False,
              **saluki):
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
      [_score(reward_fn, sampler(generator).samples, **saluki)
       for _ in range(n_calls)])[:total]
  baseline = all_preds[:gen_batch_num * batch_size]
  k = max(1, len(all_preds) // sample_M)
  top_k = np.sort(all_preds)[-k:][::-1].copy()
  return baseline, top_k


def _ess_diagnostics(ess_traces, batch_size: int) -> Optional[dict]:
  """The ESS traces (batches, num_steps), their min, median and mean
  final value, with a warning when the median is below 5% of B
  (``svdd_tpu/decode.py:253-271``)."""
  if not ess_traces:
    return None
  ess = np.stack(ess_traces)
  diagnostics = {'ess': ess, 'ess_min': float(ess.min()),
                 'ess_median': float(np.median(ess)),
                 'ess_final': float(ess[:, -1].mean())}
  LOGGER.info('TDS ESS: min %.1f / median %.1f / final %.1f (B=%d '
              'particles)', diagnostics['ess_min'],
              diagnostics['ess_median'], diagnostics['ess_final'],
              batch_size)
  if diagnostics['ess_median'] < 0.05 * batch_size:
    LOGGER.warning(
        'TDS particle set is DEGENERATE (median ESS %.1f of B=%d): the '
        'resampled batch is dominated by a handful of ancestors and the '
        'output distribution is unreliable. Raise --alpha or enable '
        'adaptive resampling with --ess_threshold (e.g. 0.5).',
        diagnostics['ess_median'], batch_size)
  return diagnostics


def run_decode(diffusion: Diffusion, reward_fn: Callable, *,
               algo: str = 'svdd_mc',
               value_fn: Optional[Callable] = None,
               gen_batch_num: int = 1, batch_size: int = 256,
               sample_M: int = 10, alpha: float = 1.0,
               guidance_scale: float = 1.0, tweedie: bool = True,
               seed: int = 44, skip_best_of_n: bool = False,
               ess_threshold: Optional[float] = None,
               m_schedule=None, task: str = 'dna', saluki_body=None,
               saluki_final_length: int = 12288) -> DecodeResult:
  """One controlled decode run. algo: svdd_mc | svdd_pm | tds | dps |
  classifier | none. ``dps`` guides by ``reward_fn``'s gradient;
  ``classifier`` needs a differentiable one-hot ``value_fn``
  (``ValueFunction.as_onehot_fn``); ``svdd_pm`` and ``tds`` score with
  ``reward_fn`` on (N, L, 4) one-hots, and their value_preds are the
  reward's. ``m_schedule`` (svdd_mc, svdd_pm): ((n_steps, M), ...).
  ``task``, ``saluki_body``, ``saluki_final_length``: the saluki task's
  oracle input (module docstring)."""
  _notice_aot_cache()
  saluki = dict(task=task, saluki_body=saluki_body,
                saluki_final_length=saluki_final_length)
  dev = diffusion.device
  guided_gen = torch.Generator(dev).manual_seed(seed)
  base_gen = torch.Generator(dev).manual_seed(seed + 1)
  if algo == 'svdd_mc':
    if value_fn is None:
      raise ValueError('svdd_mc needs a value_fn')
    sampler = diffusion.controlled_sampler(value_fn, batch_size,
                                           sample_M=sample_M,
                                           m_schedule=m_schedule)
  elif algo == 'svdd_pm':
    sampler = diffusion.tweedie_sampler(reward_fn, batch_size,
                                        sample_M=sample_M, tweedie=tweedie,
                                        m_schedule=m_schedule, **saluki)
  elif algo == 'tds':
    sampler = diffusion.tds_sampler(reward_fn, batch_size, alpha=alpha,
                                    ess_threshold=ess_threshold)
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

  samples, value_preds, reward_preds, ess_traces = [], [], [], []
  for _ in range(gen_batch_num):
    res = sampler(guided_gen)
    samples.append(res.samples.cpu().numpy())
    reward_preds.append(_score(reward_fn, res.samples, **saluki))
    if value_fn is not None and algo == 'svdd_mc':
      with torch.inference_mode():
        value_preds.append(value_fn(res.samples).float().cpu().numpy())
    else:
      value_preds.append(reward_preds[-1])
    if algo == 'tds' and isinstance(res.extra, dict) and 'ess' in res.extra:
      ess_traces.append(res.extra['ess'].cpu().numpy())

  baseline, top_k = _baseline(diffusion, reward_fn, batch_size,
                              gen_batch_num, sample_M, base_gen,
                              skip_best_of_n, **saluki)
  return DecodeResult(
      samples=np.concatenate(samples),
      value_preds=np.concatenate(value_preds),
      reward_preds=np.concatenate(reward_preds),
      top_k=top_k, baseline_preds=baseline,
      diagnostics=_ess_diagnostics(ess_traces, batch_size))
