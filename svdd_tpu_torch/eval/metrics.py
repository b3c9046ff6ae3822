"""Sample-quality metrics of the pretraining validation hook
(``svdd_tpu/eval/metrics.py``): the 1-D Wasserstein distance and the
k-mer spectra's Pearson correlation."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


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
