"""The RNA reward-lift pipeline of svdd_tpu_torch on the card, with
``scripts/demo_rna_pipeline.py``'s recipe: pretrain the denoiser at L=50
(1,200 steps at batch 16, warm-up 50, rate 1e-3) on the synthetic Gosai
split, train the ConvGRU MRL oracle (800 steps at 16, AdamW 1e-3) and
the ConvGRU value net through ``ValueTrainer`` (batch 16, rate 1e-3,
301 steps), then decode SVDD-MC and SVDD-PM at B=256, M=10, seed 44
(``svdd_tpu_torch/pipeline.py``).

  python3 scripts/torch_demo_rna_pipeline.py

Writes log/torch-demo-rna-MRL{,_tw}.npz (keys 'decoding' and
'baseline') and log/torch_demo_rna_pipeline.json: the JAX script's
keys, each stage's wall seconds and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from svdd_tpu_torch import pipeline  # noqa: E402
from svdd_tpu_torch.config import rna_config  # noqa: E402


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--device', default='cuda')
  ap.add_argument('--out_dir', default=os.path.join(ROOT, 'log'))
  args = ap.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  results, decodes = pipeline.rna(rna_config(), pipeline.synthetic_dir(ROOT),
                                  args.device)
  os.makedirs(args.out_dir, exist_ok=True)
  decodes['mc'].save_npz(os.path.join(args.out_dir, 'torch-demo-rna-MRL.npz'))
  decodes['pm'].save_npz(os.path.join(args.out_dir,
                                      'torch-demo-rna-MRL_tw.npz'))
  path = os.path.join(args.out_dir, 'torch_demo_rna_pipeline.json')
  with open(path, 'w') as fh:
    json.dump(results, fh, indent=2)
  for name, row in results['report'].items():
    print(f"{name:24s} q50={row['q50']:.3f} q80={row['q80']:.3f} "
          f"q90={row['q90']:.3f} (n={row['n']})", flush=True)
  print(f'wrote {path}', flush=True)
  return results


if __name__ == '__main__':
  main()
