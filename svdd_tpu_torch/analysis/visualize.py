"""Plotting (``svdd_tpu/analysis/visualize.py``): reward-distribution
boxen plots, prediction scatters and calibration, per-timestep curves,
attribution bars and letter-glyph sequence logos, k-mer and GC-content
comparisons, metric and prediction densities, binary-label boxes,
directed-evolution trajectories, ISM heatmaps and logos, coverage tracks
with interval highlights and attention matrices. matplotlib (Agg) and
seaborn are imported inside each function, so the module imports where
they are absent; the functions take numpy arrays."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _plt():
  import matplotlib
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt
  return plt


def plot_reward_distributions(rewards_by_algo: Dict[str, np.ndarray],
                              ylabel: str = 'reward',
                              save_path: Optional[str] = None):
  """Boxen-style comparison of decode algorithms (eval_simple.ipynb)."""
  plt = _plt()
  import seaborn as sns
  fig, ax = plt.subplots(figsize=(1.6 * len(rewards_by_algo) + 2, 4))
  names = list(rewards_by_algo)
  data = [np.asarray(rewards_by_algo[n]).reshape(-1) for n in names]
  sns.boxenplot(data=data, ax=ax)
  ax.set_xticks(range(len(names)), names, rotation=20)
  ax.set_ylabel(ylabel)
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_pred_scatter(y_true: np.ndarray, y_pred: np.ndarray,
                      save_path: Optional[str] = None):
  """Value-net pred vs oracle scatter (eval.py:114-131)."""
  plt = _plt()
  fig, ax = plt.subplots(figsize=(4, 4))
  ax.scatter(np.asarray(y_true), np.asarray(y_pred), s=6, alpha=0.5)
  lo = min(y_true.min(), y_pred.min())
  hi = max(y_true.max(), y_pred.max())
  ax.plot([lo, hi], [lo, hi], 'k--', lw=1)
  ax.set_xlabel('oracle reward')
  ax.set_ylabel('value-net prediction')
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_calibration(y_true: np.ndarray, y_pred: np.ndarray,
                     n_bins: int = 10, save_path: Optional[str] = None):
  """Binned calibration curve (visualize.py plot_calibration)."""
  plt = _plt()
  order = np.argsort(y_pred)
  yt, yp = np.asarray(y_true)[order], np.asarray(y_pred)[order]
  bins = np.array_split(np.arange(len(yt)), n_bins)
  xs = [yp[b].mean() for b in bins if len(b)]
  ys = [yt[b].mean() for b in bins if len(b)]
  fig, ax = plt.subplots(figsize=(4, 4))
  ax.plot(xs, ys, 'o-')
  ax.plot([min(xs), max(xs)], [min(xs), max(xs)], 'k--', lw=1)
  ax.set_xlabel('mean predicted')
  ax.set_ylabel('mean observed')
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_timestep_curves(losses: Sequence[float],
                         pearsons: Sequence[float],
                         save_path: Optional[str] = None):
  """Per-timestep value-net MSE / Pearson (trainer eval logs)."""
  plt = _plt()
  fig, (a1, a2) = plt.subplots(1, 2, figsize=(9, 3.5))
  a1.plot(losses)
  a1.set_xlabel('timestep')
  a1.set_ylabel('MSE')
  a2.plot(pearsons)
  a2.set_xlabel('timestep')
  a2.set_ylabel('PearsonR')
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_attributions(attr: np.ndarray, save_path: Optional[str] = None):
  """Sequence-logo-style attribution plot (visualize.py attribution
  plots; logomaker replaced by a signed stacked bar)."""
  plt = _plt()
  attr = np.asarray(attr)               # (L, 4)
  fig, ax = plt.subplots(figsize=(max(6, attr.shape[0] / 8), 2.5))
  colors = {'A': '#109648', 'C': '#255C99', 'G': '#F7B32B',
            'T': '#D62839'}
  for b, base in enumerate('ACGT'):
    ax.bar(np.arange(attr.shape[0]), attr[:, b],
           color=colors[base], label=base, width=1.0,
           bottom=np.clip(attr[:, :b], 0, None).sum(-1))
  ax.set_xlabel('position')
  ax.set_ylabel('attribution')
  ax.legend(ncol=4, fontsize=7)
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_kmer_comparison(counts_a: Dict[str, int],
                         counts_b: Dict[str, int],
                         labels=('generated', 'data'),
                         save_path: Optional[str] = None):
  """k-mer frequency scatter between two sequence sets
  (visualize.py kmer plots / diffusion_gosai.py:522-539 metric)."""
  plt = _plt()
  keys = sorted(set(counts_a) | set(counts_b))
  a = np.array([counts_a.get(k, 0) for k in keys], float)
  b = np.array([counts_b.get(k, 0) for k in keys], float)
  a /= max(a.sum(), 1)
  b /= max(b.sum(), 1)
  fig, ax = plt.subplots(figsize=(4, 4))
  ax.scatter(a, b, s=8)
  hi = max(a.max(), b.max())
  ax.plot([0, hi], [0, hi], 'k--', lw=1)
  ax.set_xlabel(f'{labels[0]} k-mer freq')
  ax.set_ylabel(f'{labels[1]} k-mer freq')
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


# ---------------------------------------------------------------------------
# Reference long-tail (visualize.py:106-772) — matplotlib-native rebuilds
# ---------------------------------------------------------------------------

BASE_COLORS = {'A': '#109648', 'C': '#255C99', 'G': '#F7B32B',
               'T': '#D62839'}


def plot_distribution(values, title: str = 'metric',
                      method: str = 'histogram', bins: int = 30,
                      save_path: Optional[str] = None):
  """Histogram / density of a 1-D metric (visualize.py:106-144)."""
  plt = _plt()
  values = np.asarray(values, float).reshape(-1)
  fig, ax = plt.subplots(figsize=(4, 3))
  if method == 'histogram':
    ax.hist(values, bins=bins)
  elif method == 'density':
    from scipy.stats import gaussian_kde
    xs = np.linspace(values.min(), values.max(), 200)
    ys = gaussian_kde(values)(xs)
    ax.plot(xs, ys)
    ax.fill_between(xs, ys, alpha=0.3)
  else:
    raise ValueError(method)
  ax.set_xlabel(title)
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_pred_distribution(preds: np.ndarray, labels: np.ndarray,
                           tasks: Optional[Sequence[str]] = None,
                           save_path: Optional[str] = None):
  """Overlaid density of predictions vs regression labels per task
  (visualize.py:147-183)."""
  plt = _plt()
  from scipy.stats import gaussian_kde
  preds = np.atleast_2d(np.asarray(preds, float).T).T
  labels = np.atleast_2d(np.asarray(labels, float).T).T
  n_tasks = preds.shape[1]
  tasks = tasks or [f'task{i}' for i in range(n_tasks)]
  fig, axes = plt.subplots(1, n_tasks,
                           figsize=(4 * n_tasks, 3), squeeze=False)
  for t, ax in enumerate(axes[0]):
    for arr, name in ((preds[:, t], 'prediction'),
                      (labels[:, t], 'label')):
      xs = np.linspace(arr.min(), arr.max(), 200)
      ax.plot(xs, gaussian_kde(arr)(xs), label=name)
    ax.set_title(tasks[t])
    ax.legend(fontsize=7)
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_binary_preds(preds: np.ndarray, labels: np.ndarray,
                      tasks: Optional[Sequence[str]] = None,
                      save_path: Optional[str] = None):
  """Box plot of predictions per binary label per task
  (visualize.py:236-270)."""
  plt = _plt()
  preds = np.atleast_2d(np.asarray(preds, float).T).T
  labels = np.atleast_2d(np.asarray(labels).T).T
  n_tasks = preds.shape[1]
  tasks = tasks or [f'task{i}' for i in range(n_tasks)]
  fig, axes = plt.subplots(1, n_tasks,
                           figsize=(3 * n_tasks, 3), squeeze=False)
  for t, ax in enumerate(axes[0]):
    groups = sorted(set(labels[:, t].tolist()))
    ax.boxplot([preds[labels[:, t] == g, t] for g in groups],
               tick_labels=[str(g) for g in groups])
    ax.set_title(tasks[t])
    ax.set_xlabel('label')
    ax.set_ylabel('prediction')
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_evolution(df, save_path: Optional[str] = None):
  """Score trajectories over directed-evolution rounds
  (visualize.py:384-418). ``df``: the analysis.design.evolve result —
  a pandas DataFrame with 'iter' plus score columns, or a dict of
  arrays with the same keys."""
  plt = _plt()
  if not isinstance(df, dict):
    df = {c: np.asarray(df[c]) for c in df.columns}
  iters = np.asarray(df['iter'])
  score_cols = [k for k in df if k != 'iter'
                and np.issubdtype(np.asarray(df[k]).dtype, np.number)]
  fig, axes = plt.subplots(1, len(score_cols),
                           figsize=(3.2 * len(score_cols), 3),
                           squeeze=False)
  uniq = sorted(set(iters.tolist()))
  for ax, col in zip(axes[0], score_cols):
    vals = np.asarray(df[col], float)
    ax.boxplot([vals[iters == it] for it in uniq],
               tick_labels=[str(it) for it in uniq])
    ax.set_title(col)
    ax.set_xlabel('Iteration')
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def gc_content(seqs: Sequence[str]) -> np.ndarray:
  """Per-sequence GC fraction (asset-free core of grelu's
  gc_distribution used by visualize.py:420-467)."""
  return np.array([(s.count('G') + s.count('C')) / max(len(s), 1)
                   for s in seqs])


def plot_gc_match(positives: Sequence[str], negatives: Sequence[str],
                  binwidth: float = 0.1,
                  save_path: Optional[str] = None):
  """GC-content histogram comparison between two sequence sets
  (takes sequence strings; resolve genome intervals first with
  ``analysis.formats.intervals_to_strings``)."""
  plt = _plt()
  edges = np.arange(0.0, 1.0 + binwidth, binwidth)
  centers = (edges[:-1] + edges[1:]) / 2
  pos, _ = np.histogram(gc_content(positives), bins=edges)
  neg, _ = np.histogram(gc_content(negatives), bins=edges)
  fig, ax = plt.subplots(figsize=(4, 3))
  w = binwidth * 0.42
  ax.bar(centers - w / 2, pos, width=w, label='positives')
  ax.bar(centers + w / 2, neg, width=w, label='negatives')
  ax.set_xlabel('GC fraction')
  ax.set_ylabel('count')
  ax.legend(fontsize=8)
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_sequence_logo(matrix: np.ndarray, ax=None,
                       save_path: Optional[str] = None):
  """Real letter-glyph sequence logo from an (L, 4) signed matrix —
  the logomaker replacement behind the reference's attribution/ISM
  logo plots (visualize.py:470-545, 599-611). Letters scale with
  |value|; negative values hang below the axis."""
  plt = _plt()
  from matplotlib.textpath import TextPath
  from matplotlib.patches import PathPatch
  from matplotlib.transforms import Affine2D
  from matplotlib.font_manager import FontProperties

  matrix = np.asarray(matrix, float)
  own_fig = ax is None
  if own_fig:
    fig, ax = plt.subplots(
        figsize=(max(6, matrix.shape[0] / 8), 2.2))
  fp = FontProperties(family='DejaVu Sans', weight='bold')
  for pos in range(matrix.shape[0]):
    col = matrix[pos]
    order = np.argsort(np.abs(col))
    y_up, y_dn = 0.0, 0.0
    for b in order:
      v = col[b]
      if v == 0:
        continue
      base = 'ACGT'[b]
      tp = TextPath((0, 0), base, size=1.0, prop=fp)
      bb = tp.get_extents()
      h = abs(v)
      if v > 0:
        y0, y_up = y_up, y_up + h
      else:
        y_dn, y0 = y_dn - h, y_dn - h
      tr = (Affine2D()
            .translate(-bb.x0, -bb.y0)
            .scale(0.9 / bb.width, h / bb.height)
            .translate(pos, y0))
      ax.add_patch(PathPatch(tp.transformed(tr),
                             facecolor=BASE_COLORS[base], lw=0))
  ax.set_xlim(-0.5, matrix.shape[0] + 0.5)
  lo = min(matrix.clip(max=0).sum(1).min(), 0)
  hi = max(matrix.clip(min=0).sum(1).max(), 1e-9)
  ax.set_ylim(lo * 1.05 - 1e-9, hi * 1.05)
  ax.axhline(0, color='k', lw=0.5)
  ax.set_xlabel('position')
  if own_fig:
    ax.figure.tight_layout()
    if save_path:
      ax.figure.savefig(save_path, dpi=150)
  return ax.figure


def plot_ISM(ism: np.ndarray, start_pos: int = 0,
             end_pos: Optional[int] = None, method: str = 'heatmap',
             save_path: Optional[str] = None):
  """ISM heatmap/logo (visualize.py:548-611). ``ism``: the (L, 4)
  matrix from analysis.interpret.ism_predict."""
  plt = _plt()
  ism = np.asarray(ism, float)
  end_pos = end_pos or ism.shape[0]
  ism = ism[start_pos:end_pos]
  if method == 'heatmap':
    import seaborn as sns
    fig, ax = plt.subplots(figsize=(max(6, ism.shape[0] / 8), 2.2))
    sns.heatmap(ism.T, cmap='vlag', center=0.0, ax=ax,
                yticklabels=list('ACGT'))
    ax.set_xlabel('position')
  elif method == 'logo':
    centered = ism - ism.mean(axis=1, keepdims=True)
    return plot_sequence_logo(centered, save_path=save_path)
  else:
    raise ValueError(method)
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def add_highlights(ax, intervals: Sequence[Tuple[int, int]],
                   facecolor: str = 'yellow',
                   edgecolor: Optional[str] = None,
                   alpha: float = 0.15) -> None:
  """Shade (start, end) intervals on an axis (visualize.py:330-381)."""
  for start, end in intervals:
    ax.axvspan(start, end, facecolor=facecolor, edgecolor=edgecolor,
               alpha=alpha)


def plot_tracks(tracks: np.ndarray, start_pos: int = 0,
                end_pos: Optional[int] = None,
                titles: Optional[List[str]] = None,
                highlight_intervals: Optional[
                    Sequence[Tuple[int, int]]] = None,
                save_path: Optional[str] = None):
  """Coverage tracks (T, L) as stacked filled line plots with optional
  interval highlights (visualize.py:614-716; pygenomeviz annotation
  lanes omitted — genome assets)."""
  plt = _plt()
  tracks = np.atleast_2d(np.asarray(tracks, float))
  n = tracks.shape[0]
  track_len = tracks.shape[1]
  end_pos = end_pos or start_pos + track_len
  # the FULL track maps onto [start_pos, end_pos] (reference
  # visualize.py:614-716 semantics), not a truncation
  xs = np.linspace(start_pos, end_pos, num=track_len)
  titles = titles or [''] * n
  fig, axes = plt.subplots(n, 1, figsize=(12, 1.4 * n), sharex=True,
                           squeeze=False)
  for t, ax in enumerate(axes[:, 0]):
    ax.fill_between(xs, tracks[t], lw=0.6)
    ax.set_ylabel(titles[t], rotation=0, ha='right', fontsize=8)
    if highlight_intervals is not None:
      add_highlights(ax, highlight_intervals)
  axes[-1, 0].set_xlabel('position')
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig


def plot_attention_matrix(attn: np.ndarray, start_pos: int = 0,
                          end_pos: Optional[int] = None,
                          highlight_intervals: Optional[
                              Sequence[Tuple[int, int]]] = None,
                          save_path: Optional[str] = None):
  """Bin x bin attention-weight heatmap (visualize.py:719-772); pair
  with analysis.interpret.get_attention_scores."""
  plt = _plt()
  import seaborn as sns
  attn = np.asarray(attn, float)
  end_pos = end_pos or attn.shape[0]
  bin_size = max(1, (end_pos - start_pos) // attn.shape[0])
  coords = np.arange(start_pos, end_pos, bin_size)[:attn.shape[0]]
  fig, ax = plt.subplots(figsize=(5, 4))
  sns.heatmap(attn, ax=ax,
              xticklabels=[str(c) for c in coords],
              yticklabels=[str(c) for c in coords])
  if highlight_intervals is not None:
    for start, end in highlight_intervals:
      ax.axvspan((start - start_pos) / bin_size,
                 (end - start_pos) / bin_size,
                 facecolor='yellow', alpha=0.15)
  fig.tight_layout()
  if save_path:
    fig.savefig(save_path, dpi=150)
  return fig
