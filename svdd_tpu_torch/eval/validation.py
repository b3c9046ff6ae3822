"""Sample-quality validation of diffusion pretraining
(``svdd_tpu/eval/validation.py``): sample from a denoiser (the trainer
passes one holding the EMA weights) through the port's unguided sampler,
then compare the samples with held-out data: the 1-D Wasserstein
distances of the oracle's predictions against each split's labels and
its predictions on the split, and, against the train split, the 3-mer
Pearson correlation and (with an ``embed_fn``) the embedding-PCA
Wasserstein distance."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.data import gosai
from svdd_tpu_torch.eval import metrics

TASK_NAMES = ('hepg2', 'k562', 'sknsh')


def sample_sequences(diffusion, n_batches: int, batch_size: int,
                     generator: torch.Generator) -> np.ndarray:
  """(n_batches * batch_size, L) int tokens from ``diffusion``'s
  unguided sampler (``sampling.predictor``), every batch drawing from
  ``generator``."""
  sampler = diffusion.sampler(batch_size)
  return np.concatenate([sampler(generator).samples.cpu().numpy()
                         for _ in range(n_batches)])


def _apply(fn, tokens: np.ndarray, device) -> np.ndarray:
  """``fn``'s output on the one-hots of ``tokens``, as float32 numpy."""
  onehot = mdlm.transform_samples(torch.as_tensor(tokens, device=device))
  with torch.inference_mode():
    return fn(onehot).float().cpu().numpy()


def _predict(oracle_fn, tokens: np.ndarray, device) -> np.ndarray:
  """The oracle's (N, T) predictions on the one-hots of ``tokens``."""
  preds = _apply(oracle_fn, tokens, device)
  return preds[:, None] if preds.ndim == 1 else preds


def distribution_eval(diffusion, datasets: Dict[str, gosai.GosaiDataset],
                      generator: torch.Generator, *, oracle_fn=None,
                      embed_fn=None, n_batches: int = 2,
                      batch_size: int = 64,
                      subset_size: int = 2048) -> Dict[str, float]:
  """The reference's validation metrics, flattened: 'ws/<split>_truth_<task>',
  'ws/<split>_pred_<task>' (with ``oracle_fn``: (N, L, 4) -> (N,) or
  (N, T)), 'kmer_pearson' and, with ``embed_fn`` ((N, L, 4) -> (N, D)),
  'emb_pca_ws' (both with a 'train' split). Each split's rows are a
  subset drawn with numpy from seed 0 (the train split's for the k-mers
  and embeddings from seed 1, its first as many as there are samples
  embedded), as in the JAX function."""
  samples = sample_sequences(diffusion, n_batches, batch_size, generator)
  gen_seqs = gosai.batch_dna_detokenize(samples)
  results: Dict[str, float] = {}
  gen_preds = (None if oracle_fn is None
               else _predict(oracle_fn, samples, diffusion.device))
  for split, ds in datasets.items():
    sub = np.random.default_rng(0).choice(
        len(ds), min(subset_size, len(ds)), replace=False)
    if gen_preds is None:
      continue
    for t, name in enumerate(TASK_NAMES[:ds.clss.shape[1]]):
      if t < gen_preds.shape[1]:
        results[f'ws/{split}_truth_{name}'] = metrics.wasserstein_1d(
            gen_preds[:, t], ds.clss[sub, t])
    data_preds = _predict(oracle_fn, ds.seqs[sub], diffusion.device)
    for t in range(min(data_preds.shape[1], gen_preds.shape[1])):
      name = TASK_NAMES[t] if t < 3 else str(t)
      results[f'ws/{split}_pred_{name}'] = metrics.wasserstein_1d(
          gen_preds[:, t], data_preds[:, t])
  if 'train' in datasets:
    train_ds = datasets['train']
    sub = np.random.default_rng(1).choice(
        len(train_ds), min(subset_size, len(train_ds)), replace=False)
    results['kmer_pearson'] = metrics.kmer_pearson(
        gen_seqs, gosai.batch_dna_detokenize(train_ds.seqs[sub]))
    if embed_fn is not None:
      dev = diffusion.device
      gen_emb = _apply(embed_fn, samples, dev)
      data_emb = _apply(embed_fn, train_ds.seqs[sub[:len(samples)]], dev)
      results['emb_pca_ws'] = metrics.embedding_pca_wasserstein(
          data_emb, gen_emb)
  return results
