"""Model-artifact registry (``svdd_tpu/artifacts.py``): the reference's
published checkpoints by name, resolved under a local directory, the
``SVDD_ARTIFACTS_DIR`` environment variable (read at each call, default
``./artifacts``), as ``<dir>/<name>:<version>/<file>``. Nothing is
fetched: a missing file raises, naming where to put it. The reference's
torch pickles load through the checkpoint flags, whose readers are
``svdd_tpu_torch/importers/``."""

from __future__ import annotations

import os
from typing import Dict

DEFAULT_DIR = './artifacts'

# name -> (the file's path under the reference's layout, kind)
REGISTRY: Dict[str, tuple] = {
    'DNA_Diffusion': ('DNA_Diffusion/last.ckpt', 'diffusion'),
    'RNA_Diffusion': ('RNA_Diffusion/best.ckpt', 'diffusion'),
    'DNA_Value': ('DNA_Value/model.pt', 'value'),
    'RNA_Value': ('RNA_Value/model.pt', 'value'),
    'RNA_Stability_Value': ('RNA_Stability_Value/model.pt', 'value'),
    'DNA_evaluation': ('DNA_evaluation/model.ckpt', 'oracle'),
    'RNA_evaluation': ('RNA_evaluation/model.ckpt', 'oracle'),
    'RNA_Stability_oracle': ('RNA_Stability_oracle/model.pt', 'oracle'),
}


def artifact_path(name: str, version: str = 'v0') -> str:
  """The local path of artifact ``name``; KeyError for an unknown name,
  FileNotFoundError where the file is absent."""
  if name not in REGISTRY:
    raise KeyError(f'unknown artifact {name!r}; known: {sorted(REGISTRY)}')
  rel, _ = REGISTRY[name]
  root = os.environ.get('SVDD_ARTIFACTS_DIR', DEFAULT_DIR)
  path = os.path.join(root, f'{name}:{version}',
                      os.path.basename(rel))
  if not os.path.exists(path):
    raise FileNotFoundError(
        f'artifact {name}:{version} not found at {path}. Nothing is '
        'downloaded: place the reference checkpoint there (set '
        'SVDD_ARTIFACTS_DIR to choose the directory); the checkpoint flags '
        'read it through svdd_tpu_torch.importers.')
  return path


def available_artifacts() -> Dict[str, bool]:
  """{name: whether its file is present}."""
  out = {}
  for name in REGISTRY:
    try:
      artifact_path(name)
      out[name] = True
    except (FileNotFoundError, KeyError):
      out[name] = False
  return out
