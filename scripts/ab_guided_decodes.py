#!/usr/bin/env python3
"""A/B the guided decodes of two checkouts on one card, in turns.

  python scripts/ab_guided_decodes.py PARENT_DIR CHANGE_DIR [ALGO ...]

Each turn runs, in a fresh process from the checkout's root, that
checkout's ``chip_smoke.run_decode`` for every ALGO (default svdd_mc,
dps, classifier: the CLI runs at --task dna, B=512, 128 steps; an ALGO
named rna_<algo> runs <algo> at --task rna), after
building the checkout's kernels (outside the timed decodes). The turns
go parent, change, change, parent, change, parent, parent, change.
Prints one JSON line per turn with the decode wall seconds, then one
summary line {algo: {"parent": [...], "change": [...]}}. Needs a CUDA
card; every checkout builds its own kernels under its build/
directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

TURN = '''
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke
from svdd_tpu_torch import _build
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {}
for algo in sys.argv[1:]:
  task, name = (('rna', algo[4:]) if algo.startswith('rna_')
                else ('dna', algo))
  out[algo] = chip_smoke.run_decode(name, algo, task=task)['wall_s']
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main() -> None:
  if len(sys.argv) < 3:
    raise SystemExit(__doc__)
  trees = {'parent': sys.argv[1], 'change': sys.argv[2]}
  algos = sys.argv[3:] or ['svdd_mc', 'dps', 'classifier']
  walls = {a: {'parent': [], 'change': []} for a in algos}
  for side in ('parent', 'change', 'change', 'parent',
               'change', 'parent', 'parent', 'change'):
    res = subprocess.run([sys.executable, '-c', TURN, *algos],
                         cwd=os.path.abspath(trees[side]), check=True,
                         capture_output=True, text=True)
    turn = json.loads(res.stdout.strip().splitlines()[-1])
    print(json.dumps({'side': side, **turn}), flush=True)
    for a in algos:
      walls[a][side].append(turn[a])
  print(json.dumps(walls), flush=True)


if __name__ == '__main__':
  main()
