"""The DNA reward-lift pipeline of svdd_tpu_torch on the card, with
``scripts/demo_dna_pipeline.py``'s recipe: pretrain the denoiser (1,200
steps at batch 16, warm-up 50, rate 1e-3) on the synthetic Gosai split,
train the 3-task Enformer oracle in bf16 (400 steps at 16, AdamW 3e-4)
and the Enformer value net in bf16 (300 steps, each a batch-8 trajectory
and 3 mid states), then decode SVDD-MC and SVDD-PM at B=256, M=10, seed
44 + --seed_offset (``svdd_tpu_torch/pipeline.py``).

  python3 scripts/torch_demo_dna_pipeline.py
  python3 scripts/torch_demo_dna_pipeline.py --suffix .run2 \\
      --seed_offset 100 --m_schedule 96:12,32:4
  python3 scripts/torch_demo_dna_pipeline.py --suffix .run3 --seed_offset 200

Writes log/torch-demo-dna-HepG2{,_tw,_sched}{suffix}.npz (keys
'decoding' and 'baseline') and log/torch_demo_dna_pipeline{suffix}.json:
the JAX script's keys, each stage's wall seconds and the card's name
and power limit.
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
from svdd_tpu_torch.config import dna_config  # noqa: E402
from svdd_tpu_torch.utils import parse_m_schedule  # noqa: E402


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--suffix', default='')
  ap.add_argument('--seed_offset', type=int, default=0)
  ap.add_argument('--m_schedule', default=None)
  ap.add_argument('--device', default='cuda')
  ap.add_argument('--out_dir', default=os.path.join(ROOT, 'log'))
  args = ap.parse_args(argv)
  logging.basicConfig(level=logging.INFO)
  results, decodes = pipeline.dna(
      dna_config(), pipeline.synthetic_dir(ROOT), args.device,
      seed_offset=args.seed_offset,
      m_schedule=parse_m_schedule(args.m_schedule),
      sched_label=args.m_schedule)
  os.makedirs(args.out_dir, exist_ok=True)
  for key, tag in (('mc', ''), ('pm', '_tw'), ('sched', '_sched')):
    if key in decodes:
      decodes[key].save_npz(os.path.join(
          args.out_dir, f'torch-demo-dna-HepG2{tag}{args.suffix}.npz'))
  path = os.path.join(args.out_dir,
                      f'torch_demo_dna_pipeline{args.suffix}.json')
  with open(path, 'w') as fh:
    json.dump(results, fh, indent=2)
  for name, row in results['report'].items():
    print(f"{name:24s} q50={row['q50']:.3f} q80={row['q80']:.3f} "
          f"q90={row['q90']:.3f} (n={row['n']})", flush=True)
  print(f'wrote {path}', flush=True)
  return results


if __name__ == '__main__':
  main()
