"""Observability (``svdd_tpu/observability.py``):

  MetricsLogger  an append-only JSONL file, one row per ``log`` call with
                 its wall time (``_time``) and step (``_step``); the JAX
                 logger's optional wandb mirror is not ported;
  StepTimer      wall-clock step times with a percentile summary, each
                 stop waiting for its result's device work;
  profile_trace  a ``torch.profiler`` context writing a TensorBoard trace
                 file under its directory;
  nan_guard      a device bool: any floating tensor of a nested structure
                 holds a NaN or Inf, reported on stdout.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


def _plain(v):
  if isinstance(v, torch.Tensor):
    v = v.detach().cpu().numpy()
  if isinstance(v, (np.ndarray, np.generic)):
    v = np.asarray(v)
    return v.item() if v.size == 1 else v.tolist()
  return v


def _tensors(tree: Any) -> list:
  """The tensors of a nested structure of dicts, lists and tuples, in
  order (dict values in insertion order)."""
  if isinstance(tree, torch.Tensor):
    return [tree]
  if isinstance(tree, dict):
    tree = list(tree.values())
  if isinstance(tree, (list, tuple)):
    return [t for leaf in tree for t in _tensors(leaf)]
  return []


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


class StepTimer:
  """Wall-clock step timing with a percentile summary."""

  def __init__(self):
    self.samples = []
    self._t0 = None

  def start(self) -> None:
    self._t0 = time.perf_counter()

  def stop(self, result: Any = None) -> float:
    """Seconds since ``start``, after the work that makes ``result``'s
    tensors is done: each CUDA device they lie on is synchronised (what
    ``jax.block_until_ready`` waits for); CPU tensors need no wait."""
    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
      torch.cuda.synchronize(dev)
    dt = time.perf_counter() - self._t0
    self.samples.append(dt)
    return dt

  def summary(self) -> Dict[str, float]:
    arr = np.asarray(self.samples)
    if arr.size == 0:
      return {}
    return {'mean_s': float(arr.mean()),
            'p50_s': float(np.percentile(arr, 50)),
            'p90_s': float(np.percentile(arr, 90)),
            'steps': int(arr.size)}


@contextlib.contextmanager
def profile_trace(log_dir: str = './profile') -> Iterator[Any]:
  """Profile the enclosed work (the host, and the card when there is
  one) and write its trace, ``<host>_<pid>.<ms>.pt.trace.json``, under
  ``log_dir`` for TensorBoard's profiler plugin or chrome://tracing.
  Yields the ``torch.profiler.profile``."""
  from torch.profiler import (ProfilerActivity, profile,
                              tensorboard_trace_handler)
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities,
               on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
    yield prof


def nan_guard(tree: Any, name: str = 'tree') -> torch.Tensor:
  """A bool tensor (on the first tensor's device): whether any floating
  tensor of ``tree`` holds a NaN or an Inf. When one does, prints
  ``[nan_guard] non-finite values detected in <name>`` (a host read of
  the flag)."""
  flags = [torch.logical_not(torch.isfinite(t)).any()
           for t in _tensors(tree) if t.is_floating_point()]
  if not flags:
    return torch.tensor(False)
  dev = flags[0].device
  any_bad = torch.stack([f.to(dev) for f in flags]).any()
  if bool(any_bad):
    print(f'[nan_guard] non-finite values detected in {name}')
  return any_bad
