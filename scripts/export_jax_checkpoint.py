#!/usr/bin/env python3
"""Export one of the JAX package's orbax checkpoints as one ``.npz`` that
svdd_tpu_torch reads without JAX (``svdd_tpu_torch/checkpoint.py:
load_export``).

Run it where JAX, orbax and ``svdd_tpu`` import (it is the one place the
PyTorch port's checkpoints meet JAX):

  # a main_gosai --ckpt_dir: the newest step's EMA weights and extras,
  # as cli/main_gosai.py:_sample_eval decodes with them (--best: the
  # best/ manager's); the config builds the state template, as
  # main_gosai builds it
  python scripts/export_jax_checkpoint.py ./checkpoints denoiser.npz \
      --task dna --set backbone=dit
  # a save_pytree tree: a cli.train / cli.train_oracle --save_path, a
  # value or multisep trainer state (--save_state_path), the AR scorer
  python scripts/export_jax_checkpoint.py ./value_ckpt value.npz
  python scripts/export_jax_checkpoint.py ./multisep multisep.npz \
      --kind multisep

The ``.npz`` holds the flax leaves under '/'-joined paths and three
string entries: ``__format__`` ('svdd_tpu.export/1'), ``__kind__``
(diffusion, variables, value_state, multisep, multisep_state) and
``__meta__`` (JSON: the step, where the source has one, the source path
and, given ``--task``/``--config``/``--set``, the config). A value or
multisep trainer state is written as its net's variables (params and
extras, or the stacked tree); its optimizer state and key are left out.
Pass the ``.npz`` to the port's checkpoint flags
(``--diffusion_checkpoint_path``, ``--load_checkpoint_path``,
``--reward_checkpoint_path``, ``--eval_oracle_checkpoint_path``,
``--gen_ppl_ar_checkpoint``, or a ``main_gosai --ckpt_dir`` holding it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMAT = 'svdd_tpu.export/1'
KINDS = ('diffusion', 'variables', 'value_state', 'multisep',
         'multisep_state')


def _flatten(tree, prefix: str = '') -> dict:
  import numpy as np
  out = {}
  for k, v in tree.items():
    key = f'{prefix}{k}'
    if isinstance(v, dict):
      out.update(_flatten(v, key + '/'))
    else:
      out[key] = np.asarray(v)
  return out


def _to_dict(tree):
  """Nested mappings as plain dicts of numpy arrays."""
  import numpy as np
  if hasattr(tree, 'items'):
    return {str(k): _to_dict(v) for k, v in tree.items()}
  return np.asarray(tree)


def write(path: str, kind: str, tree: dict, meta: dict) -> None:
  import numpy as np
  flat = _flatten(tree)
  if os.path.dirname(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
  tmp = path + '.tmp.npz'
  np.savez(tmp, __format__=np.asarray(FORMAT), __kind__=np.asarray(kind),
           __meta__=np.asarray(json.dumps(meta, default=str)), **flat)
  os.replace(tmp, path)


def _is_manager_dir(path: str) -> bool:
  """A CheckpointManager directory: step subdirectories (or best/)."""
  return os.path.isdir(path) and any(
      name.isdigit() or name == 'best' for name in os.listdir(path))


def build_config(args):
  from svdd_tpu.cli.main_gosai import build_config as jax_build_config
  return jax_build_config(argparse.Namespace(config=args.config,
                                             task=args.task, set=args.set))


def export_pretraining(args, meta: dict):
  """The newest (or the --best) pretraining state of a main_gosai
  --ckpt_dir: {'params': EMA shadow, **extras}."""
  import jax
  from svdd_tpu.diffusion import Diffusion
  from svdd_tpu.train import diffusion as train_diff
  cfg = build_config(args)
  model = Diffusion(cfg, rng=jax.random.key(cfg.seed))
  template = train_diff.init_state(model, cfg, jax.random.key(0))
  ckpt_dir = os.path.abspath(args.src)
  if args.best:
    ckpt_dir = os.path.join(ckpt_dir, 'best')
  state = train_diff.restore_checkpoint(ckpt_dir, template)
  meta.update(step=int(state.step), weights='ema',
              config=cfg.to_dict())
  return {'params': _to_dict(state.ema.shadow), **_to_dict(state.extras)}


def export_pytree(args, meta: dict):
  """A save_pytree tree, by its keys (or --kind)."""
  import orbax.checkpoint as ocp
  tree = _to_dict(ocp.StandardCheckpointer().restore(
      os.path.abspath(args.src)))
  kind = args.kind
  if kind is None:
    if 'stacked' in tree and 'opt_state' in tree:
      kind = 'multisep_state'
    elif 'params' in tree and 'opt_state' in tree:
      kind = 'value_state'
    else:
      kind = 'variables'
  if kind == 'multisep_state':
    meta['step'] = int(tree['step'])
    return kind, tree['stacked']
  if kind == 'value_state':
    meta.update(step=int(tree['step']), tokens=int(tree['tokens']))
    return kind, {'params': tree['params'], **tree.get('extras', {})}
  return kind, tree


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('src', help='an orbax directory the JAX package wrote')
  p.add_argument('out', help='the .npz to write')
  p.add_argument('--kind', default=None, choices=KINDS,
                 help='what the source holds (found from it by default; '
                      'a multisep model must be named)')
  p.add_argument('--task', default='dna', choices=['dna', 'rna'])
  p.add_argument('--config', default=None, help='yaml config overlay')
  p.add_argument('--set', nargs='*', default=None,
                 help='dotted config overrides, as main_gosai takes them')
  p.add_argument('--best', action='store_true',
                 help="a pretraining directory's best/ checkpoint")
  args = p.parse_args(argv)
  if not args.out.endswith('.npz'):
    p.error('the output must be a .npz')
  sys.path.insert(0, REPO)
  meta = {'source': os.path.abspath(args.src)}
  if args.kind in (None, 'diffusion') and _is_manager_dir(args.src):
    kind, tree = 'diffusion', export_pretraining(args, meta)
  else:
    kind, tree = export_pytree(args, meta)
    if args.config or args.set:
      meta['config'] = build_config(args).to_dict()
  write(args.out, kind, tree, meta)
  print(json.dumps({'out': args.out, 'kind': kind,
                    'leaves': len(_flatten(tree)),
                    'step': meta.get('step')}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
