"""Generative perplexity under the repo's own AR backbone
(``svdd_tpu/eval/gen_ppl.py``: ``PerplexityAggregate``,
``ar_fallback_scorer``, ``compute_generative_perplexity_local``).

The Hugging Face path of the JAX module (an external causal LM loaded by
name, which needs a local model cache) is not ported; the sample_eval
CLI falls back to the AR scorer with a warning, as the JAX CLI does when
that model is unavailable.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models.autoregressive import ARModel


@dataclass
class PerplexityAggregate:
  """exp(sum nll / count) over masked token NLLs."""
  total_nll: float = 0.0
  total_count: float = 0.0

  def update(self, nlls, mask) -> None:
    nlls = np.asarray(nlls, dtype=np.float64)
    mask = np.asarray(mask, dtype=np.float64)
    self.total_nll += float((nlls * mask).sum())
    self.total_count += float(mask.sum())

  def compute(self) -> float:
    if self.total_count == 0:
      return float('nan')
    return math.exp(self.total_nll / self.total_count)


def ar_fallback_scorer(cfg: Config, checkpoint_path: Optional[str] = None,
                       device='cuda', model: Optional[ARModel] = None):
  """``log_prob_fn(tokens) -> (B, L, V)`` log-probs (numpy) of the AR
  backbone over the task vocab, at ``cfg``'s widths and bf16 compute
  (the JAX scorer's ARModel default). Without ``model`` the net is drawn
  at random from seed 0; ``checkpoint_path`` is not ported yet (A17)."""
  if checkpoint_path:
    raise NotImplementedError('--gen_ppl_ar_checkpoint: checkpoint loading '
                              'is not ported to svdd_tpu_torch yet (ROADMAP '
                              'A17)')
  device = torch.device(device)
  if model is None:
    model = ARModel(cfg, cfg.vocab_size,
                    generator=torch.Generator(device).manual_seed(0))
  model = model.to(device).eval()

  def log_prob_fn(tokens):
    with torch.inference_mode():
      toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=device)
      return model(toks).cpu().numpy()

  return log_prob_fn


def compute_generative_perplexity_local(
    token_samples, log_prob_fn, eos_token_id: Optional[int] = None,
    batch_size: int = 64,
    metric: Optional[PerplexityAggregate] = None) -> float:
  """Generative perplexity under a local causal LM returning (B, L, V)
  log-probs, scored in chunks of ``batch_size`` rows: the next-token
  NLLs, every position counted when ``eos_token_id`` is None (the DNA
  vocab has no EOS), else the non-EOS tokens plus the first EOS."""
  tokens = np.asarray(token_samples)
  metric = metric if metric is not None else PerplexityAggregate()
  for s in range(0, tokens.shape[0], batch_size):
    chunk = tokens[s:s + batch_size]
    logp = np.asarray(log_prob_fn(chunk), dtype=np.float64)
    nll = -np.take_along_axis(
        logp[:, :-1], chunk[:, 1:, None], axis=-1)[..., 0]
    if eos_token_id is None:
      mask = np.ones_like(nll)
    else:
      first_eos = np.cumsum(chunk == eos_token_id, axis=-1) == 1
      token_mask = chunk != eos_token_id
      mask = (first_eos | token_mask)[:, 1:]
    metric.update(nll, mask)
  return metric.compute()
