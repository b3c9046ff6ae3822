"""Metrics (``svdd_tpu/eval/metrics.py``): the streaming Pearson
correlation of ``cli.eval`` and the streaming R2 and NLL/BPD/perplexity
aggregates; the sample-quality metrics of the pretraining validation
hook, the 1-D Wasserstein distance, the k-mer spectra's Pearson
correlation and the embedding-PCA Wasserstein distance; and the reward
quantile table of the decode CLIs and ``eval.report``.

The streaming states are NamedTuples of float32 tensors on the caller's
device, updated functionally as the JAX package's pytree states are."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch


class PearsonState(NamedTuple):
  """Streaming Pearson correlation per target (``metrics.py:32-62``): the
  count and the sums of y, y^2, p, p^2 and y*p, float32 tensors of
  (num_targets,) on the device of the first update's values."""
  count: torch.Tensor
  product: torch.Tensor
  true_sum: torch.Tensor
  true_sumsq: torch.Tensor
  pred_sum: torch.Tensor
  pred_sumsq: torch.Tensor

  @staticmethod
  def init(num_targets: int = 1, device='cpu') -> 'PearsonState':
    z = torch.zeros((num_targets,), device=device)
    return PearsonState(z, z, z, z, z, z)

  def update(self, y_true, y_pred) -> 'PearsonState':
    t, p, s = _targets(self, y_true, y_pred)
    return PearsonState(s[0] + t.shape[0], s[1] + (t * p).sum(0),
                        s[2] + t.sum(0), s[3] + (t ** 2).sum(0),
                        s[4] + p.sum(0), s[5] + (p ** 2).sum(0))

  def compute(self) -> torch.Tensor:
    """The mean over targets of the correlations."""
    tm = self.true_sum / self.count
    pm = self.pred_sum / self.count
    cov = (self.product - tm * self.pred_sum - pm * self.true_sum
           + self.count * tm * pm)
    tv = self.true_sumsq - self.count * tm ** 2
    pv = self.pred_sumsq - self.count * pm ** 2
    return (cov / torch.sqrt(tv * pv)).mean()


def _targets(state, y_true, y_pred):
  """(values, predictions) as float32 (rows, num_targets) tensors on
  ``y_true``'s device (the CPU for arrays), and the state moved there."""
  k = state.count.shape[0]
  dev = y_true.device if isinstance(y_true, torch.Tensor) else 'cpu'
  t = torch.as_tensor(y_true, device=dev).float().reshape(-1, k)
  p = torch.as_tensor(y_pred, device=dev).float().reshape(-1, k)
  return t, p, [v.to(dev) for v in state]


class R2State(NamedTuple):
  """Streaming coefficient of determination per target
  (``metrics.py:67-97``): the count, the sums of y and y^2 and the
  residuals' sum of squares."""
  count: torch.Tensor
  true_sum: torch.Tensor
  true_sumsq: torch.Tensor
  resid_sumsq: torch.Tensor

  @staticmethod
  def init(num_targets: int = 1, device='cpu') -> 'R2State':
    z = torch.zeros((num_targets,), device=device)
    return R2State(z, z, z, z)

  def update(self, y_true, y_pred) -> 'R2State':
    t, p, s = _targets(self, y_true, y_pred)
    return R2State(s[0] + t.shape[0], s[1] + t.sum(0),
                   s[2] + (t ** 2).sum(0), s[3] + ((t - p) ** 2).sum(0))

  def compute(self) -> torch.Tensor:
    """The mean over targets of 1 - SS_res / SS_tot."""
    tm = self.true_sum / self.count
    total = self.true_sumsq - self.count * tm ** 2
    return (1.0 - self.resid_sumsq / total).mean()


class NLLState(NamedTuple):
  """Masked NLL aggregate (``metrics.py:99-120``): the summed NLL and the
  summed mask, each a float32 scalar tensor."""
  total: torch.Tensor
  weight: torch.Tensor

  @staticmethod
  def init(device='cpu') -> 'NLLState':
    return NLLState(torch.zeros((), device=device),
                    torch.zeros((), device=device))

  def update(self, nlls, mask) -> 'NLLState':
    nlls = torch.as_tensor(nlls, device=self.total.device).float()
    mask = torch.as_tensor(mask, device=self.total.device).float()
    return NLLState(self.total + (nlls * mask).sum(),
                    self.weight + mask.sum())

  def nll(self) -> torch.Tensor:
    return self.total / self.weight

  def bpd(self) -> torch.Tensor:
    return self.nll() / math.log(2)

  def ppl(self) -> torch.Tensor:
    return torch.exp(self.nll())


def wasserstein_1d(u, v) -> float:
  """scipy.stats.wasserstein_distance of two samples."""
  from scipy.stats import wasserstein_distance
  return float(wasserstein_distance(np.asarray(u), np.asarray(v)))


def kmer_counts(seqs: Sequence[str], k: int = 3) -> Dict[str, int]:
  """Counts of every k-mer over the sequences' windows."""
  counts: Dict[str, int] = {}
  for seq in seqs:
    for i in range(len(seq) - k + 1):
      sub = seq[i:i + k]
      counts[sub] = counts.get(sub, 0) + 1
  return counts


def kmer_pearson(seqs_a: Sequence[str], seqs_b: Sequence[str],
                 k: int = 3) -> float:
  """Pearson correlation of the two sets' normalised k-mer spectra; 0
  where either is constant."""
  ca, cb = kmer_counts(seqs_a, k), kmer_counts(seqs_b, k)
  keys = sorted(set(ca) | set(cb))
  a = np.array([ca.get(x, 0) for x in keys], np.float64)
  b = np.array([cb.get(x, 0) for x in keys], np.float64)
  a = a / a.sum()
  b = b / b.sum()
  denom = a.std() * b.std()
  if denom == 0:
    return 0.0
  return float(((a - a.mean()) * (b - b.mean())).mean() / denom)


def embedding_pca_wasserstein(emb_a, emb_b, n_components: int = 10
                              ) -> float:
  """Sum over PCA components of the 1-D Wasserstein distance between the
  two sets' projections, the PCA fit on ``emb_a`` (``metrics.py:162-174``)
  with min(n_components, D, N_a - 1) components: the centred SVD's
  leading right singular vectors, as sklearn's exact solver computes them
  up to each component's sign, which does not change its distance."""
  emb_a = np.asarray(emb_a, np.float64)
  emb_b = np.asarray(emb_b, np.float64)
  k = min(n_components, emb_a.shape[1], len(emb_a) - 1)
  mean = emb_a.mean(0)
  comps = np.linalg.svd(emb_a - mean, full_matrices=False)[2][:k]
  pa, pb = (emb_a - mean) @ comps.T, (emb_b - mean) @ comps.T
  return float(sum(wasserstein_1d(pa[:, i], pb[:, i]) for i in range(k)))


def quantile_report(rewards_by_algo, quantiles=(0.5, 0.8, 0.9)
                    ) -> Dict[str, Dict[str, float]]:
  """q50/q80/q90, mean and n of each reward array (the reference's
  evaluation-notebook quantile table)."""
  report = {}
  for name, r in rewards_by_algo.items():
    r = np.asarray(r).reshape(-1)
    report[name] = {f'q{int(q * 100)}': float(np.quantile(r, q))
                    for q in quantiles}
    report[name]['mean'] = float(r.mean())
    report[name]['n'] = int(r.size)
  return report
