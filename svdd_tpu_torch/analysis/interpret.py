"""Interpretability (``svdd_tpu/analysis/interpret.py``): in-silico
mutagenesis (ISM), gradient attributions, attention maps and motif
discovery.

``predict_fn`` maps (N, L, 4) one-hots to (N,) scores: a
``rewards.RewardOracle`` (its fused eval tower: B3, B4 and B5 forward,
the gradient of B3's reference form and B8 backward, as JAX
differentiates its fused tower here), a value net's one-hot function or
any differentiable callable. ISM runs all 4L single-base mutants in
batches of ``batch_size`` rows without a gradient. Where JAX vmaps
``jax.grad`` over points, the port takes one batched forward and
backward: a row's output depends on that row alone, so the gradient of
the rows' summed outputs is each row's own gradient (IG's path points
and EG's references are the rows). Those rows are JAX's vmapped
examples, each a one-row forward to its dispatchers, so in bf16 they
round as one row does (``kernel_utils.rows_as_vmapped``: off the pools'
and B5's gates, the references). Expected gradients take their
permutations and interpolation weights injected, or draw them from a
``torch.Generator``.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from svdd_tpu_torch.ops.kernel_utils import rows_as_vmapped

PredictFn = Callable[[torch.Tensor], torch.Tensor]   # (N, L, 4) -> (N,)


def _numpy(t: torch.Tensor) -> np.ndarray:
  return t.detach().float().cpu().numpy()


def ism_predict(predict_fn: PredictFn, onehot: torch.Tensor,
                batch_size: int = 512) -> np.ndarray:
  """(L, 4) predictions of ``onehot`` (L, 4) with base b put at position
  l, all 4L mutants in batches of ``batch_size`` rows."""
  length = onehot.shape[0]
  mutants = onehot[None, None].repeat(length, 4, 1, 1)     # (L, 4, L, 4)
  idx = torch.arange(length, device=onehot.device)[:, None]
  mutants[idx, torch.arange(4, device=onehot.device)[None, :], idx] = \
      torch.eye(4, dtype=onehot.dtype, device=onehot.device)[None]
  flat = mutants.reshape(length * 4, length, 4)
  preds = []
  with torch.no_grad():
    for i in range(0, length * 4, batch_size):
      preds.append(_numpy(predict_fn(flat[i:i + batch_size])))
  return np.concatenate(preds).reshape(length, 4)


def _row_grads(predict_fn: PredictFn, points: torch.Tensor) -> torch.Tensor:
  """d predict_fn(points)[i] / d points[i] for every row i (N, L, 4)."""
  with torch.enable_grad():
    x = points.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(predict_fn(x).sum(), x)
  return grad


def input_x_gradient(predict_fn: PredictFn, onehot: torch.Tensor
                     ) -> torch.Tensor:
  """The input times the gradient of its score (one row)."""
  return _row_grads(predict_fn, onehot[None])[0] * onehot


def integrated_gradients(predict_fn: PredictFn, onehot: torch.Tensor,
                         steps: int = 32,
                         baseline: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
  """(onehot - baseline) times the mean gradient over ``steps`` points on
  the straight path from ``baseline`` (default all 0.25) to ``onehot``,
  ends included: one forward and backward of ``steps`` rows."""
  if baseline is None:
    baseline = torch.full_like(onehot, 0.25)
  alphas = torch.linspace(0.0, 1.0, steps, device=onehot.device)
  path = baseline[None] + alphas[:, None, None] * (onehot - baseline)[None]
  with rows_as_vmapped():
    grads = _row_grads(predict_fn, path)
  return (onehot - baseline) * grads.mean(0)


def expected_gradients(predict_fn: PredictFn, onehot: torch.Tensor,
                       n_refs: int = 20,
                       perms: Optional[torch.Tensor] = None,
                       alphas: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
  """GradientShap-style attribution against position-shuffled references:
  the mean over references r of (onehot - r) times the gradient at
  r + alpha (onehot - r). ``perms`` (n_refs, L) are the shuffles and
  ``alphas`` (n_refs,) the weights (JAX draws them from its key,
  ``interpret.py:72-81``); absent, they are drawn from ``generator``. One
  forward and backward of n_refs rows."""
  length, dev = onehot.shape[0], onehot.device
  if perms is None:
    perms = torch.stack([torch.randperm(length, generator=generator,
                                        device=generator.device)
                         for _ in range(n_refs)])
  if alphas is None:
    alphas = torch.rand(len(perms), generator=generator,
                        device=generator.device)
  refs = onehot[perms.to(dev)]                                # (R, L, 4)
  alphas = alphas.to(device=dev, dtype=onehot.dtype)[:, None, None]
  with rows_as_vmapped():
    grads = _row_grads(predict_fn, refs + alphas * (onehot - refs))
  return ((onehot - refs) * grads).mean(0)


def get_attributions(predict_fn: PredictFn, onehot: torch.Tensor,
                     method: str = 'deepshap',
                     generator: Optional[torch.Generator] = None,
                     **kwargs) -> np.ndarray:
  """(L, 4) attributions of ``onehot`` (L, 4) by ``method``: 'deepshap'
  (expected gradients; ``generator`` defaults to one seeded 0 on the
  input's device), 'integratedgradients', 'inputxgradient' or 'ism' (each
  mutant's score less the sequence's, on the sequence's bases)."""
  if method == 'deepshap':
    if generator is None and 'perms' not in kwargs:
      generator = torch.Generator(onehot.device).manual_seed(0)
    out = expected_gradients(predict_fn, onehot, generator=generator,
                             **kwargs)
  elif method == 'integratedgradients':
    out = integrated_gradients(predict_fn, onehot, **kwargs)
  elif method == 'inputxgradient':
    out = input_x_gradient(predict_fn, onehot)
  elif method == 'ism':
    ism = ism_predict(predict_fn, onehot)
    with torch.no_grad():
      ref = float(predict_fn(onehot[None])[0])
    out = torch.from_numpy(ism - ref) * onehot.float().cpu()
  else:
    raise NotImplementedError(method)
  return _numpy(out)


def extract_seqlets(attributions: np.ndarray, onehots: np.ndarray,
                    window: int = 8, per_seq: int = 3,
                    min_frac: float = 0.3):
  """High-attribution windows ("seqlets") of (N, L, 4) attributions on
  their one-hots: per sequence up to ``per_seq`` non-overlapping windows
  by their summed attribution on the sequence's bases, each at least
  ``min_frac`` of the best. Returns (windows (M, window, 4) one-hot,
  attribution windows (M, window, 4), scores (M,))."""
  attributions = np.asarray(attributions, np.float64)
  onehots = np.asarray(onehots, np.float64)
  proj = (attributions * onehots).sum(-1)            # (N, L)
  kern = np.ones(window)
  wins, awins, scores = [], [], []
  for i in range(proj.shape[0]):
    sliding = np.convolve(proj[i], kern, mode='valid')  # (L-w+1,)
    cutoff = min_frac * max(sliding.max(), 1e-12)
    taken: list[int] = []
    for start in np.argsort(sliding)[::-1]:
      if len(taken) >= per_seq or sliding[start] < cutoff:
        break
      if any(abs(start - t) < window for t in taken):
        continue
      taken.append(int(start))
      wins.append(onehots[i, start:start + window])
      awins.append(attributions[i, start:start + window])
      scores.append(float(sliding[start]))
  if not wins:
    z = np.zeros((0, window, 4))
    return z, z, np.zeros((0,))
  return np.stack(wins), np.stack(awins), np.asarray(scores)


def _best_shift_similarity(pwm: np.ndarray, win: np.ndarray,
                           max_shift: int = 2):
  """(similarity, shift): the best normalised correlation of ``win``
  against ``pwm`` (both (w, 4)) over offsets up to ``max_shift``."""
  def ncc(a, b):
    a = a - a.mean()
    b = b - b.mean()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float((a * b).sum() / denom) if denom > 0 else 0.0
  best, best_s = -1.0, 0
  w = pwm.shape[0]
  for s in range(-max_shift, max_shift + 1):
    lo, hi = max(0, s), min(w, w + s)
    if hi - lo < w // 2:
      continue
    sim = ncc(pwm[lo:hi], win[lo - s:hi - s])
    if sim > best:
      best, best_s = sim, s
  return best, best_s


def cluster_seqlets(windows: np.ndarray, scores: np.ndarray,
                    sim_threshold: float = 0.6, max_shift: int = 2):
  """Greedy clustering of seqlets, best first, by shifted correlation
  with each cluster's running PWM. Returns dicts {'pwm' (w, 4)
  frequencies, 'n', 'score'}, best score first."""
  clusters: list[dict] = []
  for idx in np.argsort(scores)[::-1]:
    win = windows[idx]
    placed = False
    for c in clusters:
      pwm = c['sum'] / max(c['n'], 1)
      sim, shift = _best_shift_similarity(pwm, win, max_shift)
      if sim >= sim_threshold:
        w = pwm.shape[0]
        lo, hi = max(0, shift), min(w, w + shift)
        c['sum'][lo:hi] += win[lo - shift:hi - shift]
        c['n'] += 1
        c['score'] += float(scores[idx])
        placed = True
        break
    if not placed:
      clusters.append({'sum': win.copy(), 'n': 1,
                       'score': float(scores[idx])})
  out = []
  for c in sorted(clusters, key=lambda c: -c['score']):
    pwm = c['sum'] / c['n']
    pwm = pwm / np.maximum(pwm.sum(-1, keepdims=True), 1e-9)
    out.append({'pwm': pwm, 'n': c['n'], 'score': c['score']})
  return out


def write_meme(motifs, path: str) -> None:
  """The motifs as a minimal MEME (version 4) file, uniform background."""
  with open(path, 'w') as f:
    f.write('MEME version 4\n\nALPHABET= ACGT\n\n'
            'strands: + -\n\n'
            'Background letter frequencies\n'
            'A 0.25 C 0.25 G 0.25 T 0.25\n\n')
    for i, m in enumerate(motifs):
      pwm = m['pwm']
      f.write(f'MOTIF motif_{i}\n')
      f.write(f'letter-probability matrix: alength= 4 w= {pwm.shape[0]}'
              f' nsites= {m["n"]}\n')
      for row in pwm:
        f.write(' '.join(f'{v:.6f}' for v in row) + '\n')
      f.write('\n')


def run_modisco(attributions: np.ndarray, onehots: np.ndarray,
                out_dir: str = './modisco', window: int = 8,
                sim_threshold: float = 0.6, **kwargs):
  """Motif discovery over (N, L, 4) attributions and one-hots into
  ``out_dir``. With ``modiscolite`` installed: TF-MoDISco, writing
  modisco_report.h5 and returning (positive, negative) patterns.
  Otherwise the fallback: seqlets, greedy clustering, ``motifs.meme``,
  ``report.json`` (motif, seqlet count, score, consensus) and a logo PNG
  of each of the first eight motifs' information content (skipped,
  silently, where plotting fails); returns the motif list."""
  os.makedirs(out_dir, exist_ok=True)
  try:
    import modiscolite
    pos_patterns, neg_patterns = modiscolite.tfmodisco.TFMoDISco(
        hypothetical_contribs=np.asarray(attributions).transpose(
            0, 2, 1).astype('float32'),
        one_hot=np.asarray(onehots).transpose(0, 2, 1).astype(
            'float32'), **kwargs)
    h5 = os.path.join(out_dir, 'modisco_report.h5')
    modiscolite.io.save_hdf5(h5, pos_patterns, neg_patterns,
                             window_size=20)
    return pos_patterns, neg_patterns
  except ImportError:
    pass
  wins, _, scores = extract_seqlets(attributions, onehots, window=window)
  motifs = cluster_seqlets(wins, scores, sim_threshold=sim_threshold)
  write_meme(motifs, os.path.join(out_dir, 'motifs.meme'))
  report = [{'motif': f'motif_{i}', 'n_seqlets': m['n'],
             'score': m['score'],
             'consensus': ''.join('ACGT'[b]
                                  for b in m['pwm'].argmax(-1))}
            for i, m in enumerate(motifs)]
  with open(os.path.join(out_dir, 'report.json'), 'w') as f:
    json.dump(report, f, indent=2)
  try:
    from svdd_tpu_torch.analysis.visualize import plot_sequence_logo
    for i, m in enumerate(motifs[:8]):
      # per-position information content: IC = sum_b p_b log2(p_b/q)
      ic = (m['pwm'] * np.log2(np.maximum(m['pwm'], 1e-9) / 0.25)).sum(
          -1, keepdims=True).clip(min=0)
      plot_sequence_logo(
          m['pwm'] * ic, save_path=os.path.join(out_dir, f'motif_{i}.png'))
  except Exception:                                  # noqa: BLE001
    pass
  return motifs


def get_attention_scores(module, onehot: torch.Tensor,
                         block_idx: Optional[int] = None) -> np.ndarray:
  """The attention maps of an Enformer value net (or any callable that
  runs EnformerAttention blocks) on ``onehot`` (L, 4) or (B, L, 4):
  (layers, B, heads, L', L') in block order, the batch axis dropped when
  B is 1; with ``block_idx``, that layer's maps alone."""
  from svdd_tpu_torch.models.enformer import capture_attention
  if onehot.ndim == 2:
    onehot = onehot[None]
  with torch.no_grad(), capture_attention() as maps:
    module(onehot)
  if not maps:
    raise ValueError('no attention maps captured: the module has no '
                     'EnformerAttention layers')
  attn = np.stack([_numpy(m) for m in maps])      # (layers, B, H, L, L)
  if attn.shape[1] == 1:
    attn = attn[:, 0]
  return attn[block_idx] if block_idx is not None else attn
