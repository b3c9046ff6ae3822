"""Reading the reference's torch pickles (``svdd_tpu/checkpoint.py``'s
``import_torch_state_dict`` and ``svdd_tpu/cli/common.py``'s
``_is_torch_ckpt`` and ``_torch_prefix``).

The reference ships three torch-pickle formats: Lightning diffusion
checkpoints (the state dict under 'state_dict', keys under
'backbone.'), grelu LightningModel reward oracles (under 'state_dict',
keys under 'model.') and the value-net trainer's dicts (under
'model_state_dict', keys under 'module.' when saved from DataParallel).
``import_torch_state_dict`` reads any of them to a flat ``{name:
np.ndarray}`` dict; the importers under ``importers/`` map such a dict
onto the flax layout, and ``weights.*_from_jax`` onto the port's
modules.

The port's own files (``torch.save`` dicts with a ``format`` tag of this
package) are told apart by ``port_format``: a checkpoint flag reads its
own files as before, and any other ``.pt``, ``.pth`` or ``.ckpt`` file
through the importers. A Lightning checkpoint that pickles OmegaConf
objects needs ``omegaconf`` to unpickle, in the JAX package's loader as
here.

The JAX package's own checkpoints are orbax directories, which need JAX
to read. ``scripts/export_jax_checkpoint.py``, run where JAX runs, writes
each as one ``.npz`` (``EXPORT_FORMAT``): the flax leaves under their
'/'-joined paths, and three string entries, ``__format__``, ``__kind__``
(``EXPORT_KINDS``) and ``__meta__`` (JSON: the step, the config fields
the port's model constructors need). ``load_export`` reads it with
numpy, no pickle, back into the nested flax tree that
``weights.*_from_jax`` maps.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

TORCH_SUFFIXES = ('.pt', '.pth', '.ckpt')
PORT_PREFIX = 'svdd_tpu_torch.'


def is_torch_ckpt(path: str) -> bool:
  """A path the JAX CLIs read as a torch pickle (by its suffix)."""
  return path.endswith(TORCH_SUFFIXES)


def torch_prefix(sd: dict, candidates: tuple[str, ...]) -> str:
  """The submodule prefix a torch state dict was saved under: the first
  of ``candidates`` that starts some key, else '' (Lightning prepends
  'backbone.', DataParallel 'module.')."""
  for p in candidates:
    if any(k.startswith(p) for k in sd):
      return p
  return ''


def strip_prefix(sd: dict, prefix: str) -> dict:
  """The entries of ``sd`` under ``prefix``, the prefix taken off."""
  return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def import_torch_state_dict(path: str, key: Optional[str] = None) -> dict:
  """A torch pickle checkpoint as a flat {name: np.ndarray} dict: the
  dict under 'state_dict' or 'model_state_dict' (``key`` None), under
  ``key``, or the whole object (``key`` ''); entries that are not
  tensors are dropped. The pickle is read with ``weights_only=False``,
  as the JAX package reads it: load only files you trust."""
  obj = torch.load(path, map_location='cpu', weights_only=False)
  if key is None:
    for k in ('state_dict', 'model_state_dict'):
      if isinstance(obj, dict) and k in obj:
        obj = obj[k]
        break
  elif key:
    obj = obj[key]
  return {name: t.detach().cpu().numpy() for name, t in obj.items()
          if isinstance(t, torch.Tensor)}


def port_format(path: str) -> Optional[str]:
  """The ``format`` tag of a file this package wrote, else None (no such
  file, not a zip archive, pickled objects, or a dict without the tag).
  Any other error of the load (a damaged archive) propagates. Read once
  a file and version of it."""
  if not os.path.isfile(path):
    return None
  st = os.stat(path)
  return _port_format(os.path.abspath(path), st.st_size, st.st_mtime_ns)


@functools.lru_cache(maxsize=64)
def _port_format(path: str, size: int, mtime_ns: int) -> Optional[str]:
  # every file this package writes is torch.save's zip archive; a
  # truncated one is no archive either, and the importers' load then
  # raises the archive reader's own error
  if not zipfile.is_zipfile(path):
    return None
  try:
    obj = torch.load(path, map_location='cpu', weights_only=True, mmap=True)
  except pickle.UnpicklingError:   # pickled objects: not this package's
    return None
  tag = obj.get('format') if isinstance(obj, dict) else None
  return tag if isinstance(tag, str) and tag.startswith(PORT_PREFIX) else None


def is_reference_file(path: Optional[str]) -> bool:
  """A torch pickle (by suffix, as the JAX CLIs tell them) that this
  package did not write: the importers read it."""
  return (bool(path) and is_torch_ckpt(path) and os.path.isfile(path)
          and port_format(path) is None)


# ---------------------------------------------------------------------------
# The JAX package's orbax checkpoints, exported as .npz
# ---------------------------------------------------------------------------

EXPORT_FORMAT = 'svdd_tpu.export/1'
# diffusion: a pretraining state's EMA weights with its extras (the flax
# variables sample_eval decodes with); variables: a save_pytree tree of
# flax variables (a value net, an oracle, the AR scorer); value_state: a
# value trainer's state, its params and extras as variables; multisep,
# multisep_state: the stacked variables of a multisep model (every leaf
# with a leading n_models axis)
EXPORT_KINDS = ('diffusion', 'variables', 'value_state', 'multisep',
                'multisep_state')
_RESERVED = ('__format__', '__kind__', '__meta__')


class Export(NamedTuple):
  """An exported checkpoint: its kind, its meta (step, config fields)
  and its flax tree (nested dicts of numpy arrays)."""
  kind: str
  meta: dict
  tree: dict


def is_export_file(path: Optional[str]) -> bool:
  """A ``.npz`` the export script wrote (its ``__format__`` entry)."""
  if not path or not path.endswith('.npz') or not os.path.isfile(path):
    return False
  try:
    with np.load(path, allow_pickle=False) as z:
      return ('__format__' in z.files
              and str(z['__format__']) == EXPORT_FORMAT)
  except (ValueError, OSError, zipfile.BadZipFile):
    return False


def unflatten(flat: dict) -> dict:
  """{'a/b/c': x} -> {'a': {'b': {'c': x}}}."""
  tree: dict = {}
  for key, value in flat.items():
    node = tree
    parts = key.split('/')
    for part in parts[:-1]:
      node = node.setdefault(part, {})
    node[parts[-1]] = value
  return tree


def flatten(tree: dict, prefix: str = '') -> dict:
  """The inverse of ``unflatten``: leaves under '/'-joined paths."""
  out = {}
  for k, v in tree.items():
    key = f'{prefix}{k}'
    if isinstance(v, dict):
      out.update(flatten(v, key + '/'))
    else:
      out[key] = np.asarray(v)
  return out


def save_export(path: str, kind: str, tree: dict, meta: Optional[dict] = None
                ) -> None:
  """Write ``tree`` as an export of ``kind`` (the layout the export
  script writes)."""
  if kind not in EXPORT_KINDS:
    raise ValueError(f'export kind {kind!r} not in {EXPORT_KINDS}')
  flat = flatten(tree)
  clash = [k for k in flat if k in _RESERVED]
  if clash:
    raise ValueError(f'leaf names {clash} are reserved')
  if os.path.dirname(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
  tmp = path + '.tmp.npz'
  np.savez(tmp, __format__=np.asarray(EXPORT_FORMAT),
           __kind__=np.asarray(kind),
           __meta__=np.asarray(json.dumps(meta or {})), **flat)
  os.replace(tmp, path)


def _read_export(path: str, kinds: Optional[tuple], leaves: bool) -> Export:
  with np.load(path, allow_pickle=False) as z:
    if '__format__' not in z.files or str(z['__format__']) != EXPORT_FORMAT:
      raise ValueError(f'{path}: not an {EXPORT_FORMAT} export (write one '
                       'with scripts/export_jax_checkpoint.py)')
    kind = str(z['__kind__'])
    if kinds is not None and kind not in kinds:
      raise ValueError(f'{path}: a {kind!r} export where {kinds} is needed')
    meta = json.loads(str(z['__meta__']))
    # NpzFile reads a member only where it is indexed
    flat = {k: z[k] if leaves else None
            for k in z.files if k not in _RESERVED}
  return Export(kind, meta, unflatten(flat))


def load_export(path: str, kinds: Optional[tuple] = None) -> Export:
  """The export at ``path`` (read with ``allow_pickle=False``); raises
  ``ValueError`` for a file of another format, or of a kind not in
  ``kinds``."""
  return _read_export(path, kinds, leaves=True)


def export_header(path: str, kinds: Optional[tuple] = None) -> Export:
  """``load_export`` without the leaves: the kind, the meta and the tree's
  paths, each leaf None. Reads the three string entries and the zip's
  directory alone, whatever the export's size."""
  return _read_export(path, kinds, leaves=False)


def export_in(path: Optional[str], kinds: tuple) -> Optional[str]:
  """The export a flag names: ``path`` itself, or, for a directory, the
  one export of ``kinds`` at its top (the newest step where there are
  several); None where there is none. Reads each file's header alone."""
  if not path:
    return None
  if is_export_file(path):
    return path
  if not os.path.isdir(path):
    return None
  found = []
  for name in sorted(os.listdir(path)):
    full = os.path.join(path, name)
    if is_export_file(full):
      e = export_header(full)
      if e.kind in kinds:
        found.append((int(e.meta.get('step', 0)), full))
  return max(found)[1] if found else None


def is_orbax_dir(path: Optional[str]) -> bool:
  """A directory orbax wrote (a StandardCheckpointer tree, or a
  CheckpointManager's step directories): the export script reads it."""
  if not path or not os.path.isdir(path):
    return False
  for root, _, files in os.walk(path):
    if any(f in ('_CHECKPOINT_METADATA', '_METADATA', 'manifest.ocdbt')
           or f.startswith('_sharding') for f in files):
      return True
  return False


def orbax_message(flag: str, path: str) -> str:
  """The error a checkpoint flag raises for an orbax directory."""
  return (f'{flag} {path}: an orbax checkpoint of the JAX package, which '
          'this package reads only as an export (ROADMAP A17): run python '
          'scripts/export_jax_checkpoint.py ' + path + ' OUT.npz where JAX '
          'runs, and pass OUT.npz')
