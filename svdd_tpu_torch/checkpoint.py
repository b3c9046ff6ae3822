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
"""

from __future__ import annotations

import functools
import os
import pickle
import zipfile
from typing import Optional

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
