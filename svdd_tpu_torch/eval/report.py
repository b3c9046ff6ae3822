"""Reward-quantile report over decode outputs (``svdd_tpu/eval/report.py``).

Reads the ``.npz`` files the decode CLIs write (keys ``decoding`` and
``baseline``) and prints each array's q50/q80/q90 and mean, with the
reference's shipped quantiles beside the runs it published, in the same
text as the JAX package's report.

Usage:
  python -m svdd_tpu_torch.eval.report log/dna-HepG2.npz log/dna-HepG2_tw.npz
  python -m svdd_tpu_torch.eval.report log/*.npz --plot rewards.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from svdd_tpu_torch.eval.metrics import quantile_report

# the reference's shipped quantiles (q50, q80, q90) of its log/*.npz files
REFERENCE_BASELINES = {
    'dna-HepG2.npz': {'decoding': (5.074, 5.493, 5.639),
                      'baseline': (0.092, 0.614, 1.104)},
    'dna-HepG2_tw.npz': {'decoding': (5.353, 6.510, 6.980)},
    'dna-HepG2_TDS.npz': {'decoding': (4.281, 5.350, 5.949)},
    'dna-HepG2_DPS.npz': {'decoding': (3.782, 4.648, 4.879)},
    'dna-HepG2-classfier.npz': {'decoding': (0.130, 0.566, 1.239)},
    'rna-MRL.npz': {'decoding': (1.042, 1.087, 1.117),
                    'baseline': (0.425, 0.786, 0.875)},
    'rna-MRL_tw.npz': {'decoding': (1.214, 1.340, 1.383)},
    'rna-MRL_TDS.npz': {'decoding': (0.750, 0.892, 0.905)},
    'rna-MRL_DPS.npz': {'decoding': (0.426, 0.894, 0.981)},
}


def report_file(path: str) -> str:
  """The report of one npz: a header line, then a line per array."""
  data = np.load(path)
  rep = quantile_report({k: data[k] for k in data.files})
  name = os.path.basename(path)
  lines = [f'== {name} ==']
  ref = REFERENCE_BASELINES.get(name, {})
  for key, row in rep.items():
    line = (f"  {key:10s} n={row['n']:<5d} "
            f"q50={row['q50']:7.3f} q80={row['q80']:7.3f} "
            f"q90={row['q90']:7.3f} mean={row['mean']:7.3f}")
    if key in ref:
      r = ref[key]
      line += f'   [reference: {r[0]:.3f} / {r[1]:.3f} / {r[2]:.3f}]'
    lines.append(line)
  return '\n'.join(lines)


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description='reward quantile report')
  p.add_argument('files', nargs='+', help='decode .npz outputs')
  p.add_argument('--plot', default=None,
                 help='write a boxen comparison figure to this path')
  args = p.parse_args(argv)
  all_rewards = {}
  for path in args.files:
    print(report_file(path))
    data = np.load(path)
    stem = os.path.basename(path).replace('.npz', '')
    for key in data.files:
      all_rewards[f'{stem}:{key}'] = data[key]
  if args.plot:
    from svdd_tpu_torch.analysis.visualize import plot_reward_distributions
    plot_reward_distributions(all_rewards, save_path=args.plot)
    print(f'wrote {args.plot}')


if __name__ == '__main__':
  main()
