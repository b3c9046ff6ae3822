"""Metrics logging (``svdd_tpu/observability.py:MetricsLogger``): an
append-only JSONL file, one row per ``log`` call with its wall time
(``_time``) and step (``_step``). The JAX logger's optional wandb mirror
is not ported."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _plain(v):
  if isinstance(v, torch.Tensor):
    v = v.detach().cpu().numpy()
  if isinstance(v, (np.ndarray, np.generic)):
    v = np.asarray(v)
    return v.item() if v.size == 1 else v.tolist()
  return v


class MetricsLogger:
  """Writes ``<log_dir>/<run_name>.metrics.jsonl``, appending."""

  def __init__(self, log_dir: str = './log', run_name: str = 'run'):
    os.makedirs(log_dir, exist_ok=True)
    self.path = os.path.join(log_dir, f'{run_name}.metrics.jsonl')
    self._fh = open(self.path, 'a')

  def log(self, metrics: Dict[str, Any], step: Optional[int] = None
          ) -> None:
    row = {'_time': time.time()}
    if step is not None:
      row['_step'] = int(step)
    row.update({k: _plain(v) for k, v in metrics.items()})
    self._fh.write(json.dumps(row) + '\n')
    self._fh.flush()

  def finish(self) -> None:
    self._fh.close()
