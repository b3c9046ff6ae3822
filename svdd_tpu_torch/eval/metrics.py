"""Metrics (``svdd_tpu/eval/metrics.py``): the streaming Pearson
correlation of ``cli.eval``, and the sample-quality metrics of the
pretraining validation hook, the 1-D Wasserstein distance and the k-mer
spectra's Pearson correlation."""

from __future__ import annotations

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
    k = self.count.shape[0]
    dev = y_true.device if isinstance(y_true, torch.Tensor) else 'cpu'
    t = torch.as_tensor(y_true, device=dev).float().reshape(-1, k)
    p = torch.as_tensor(y_pred, device=dev).float().reshape(-1, k)
    s = [v.to(dev) for v in self]
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
