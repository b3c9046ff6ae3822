"""CNN denoiser importer (``svdd_tpu/importers/cnn.py``): the reference
CNNModel's state dict (``linear.*``, ``time_embedder.*``, ``convs.{i}.*``,
``time_layers.{i}.dense.*``, ``norms.{i}.*``, ``final_conv.{0,2}.*``) ->
the flax CNNModel's ``{'params', 'buffers'}``.

  torch Conv1d weight (out, in, k) -> flax Conv kernel (k, in, out)
  torch Linear weight (out, in)    -> flax Dense kernel (in, out)
  GaussianFourierProjection.W      -> the 'buffers' collection's W
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np(t) -> np.ndarray:
  return np.asarray(t, dtype=np.float32)


def _conv(w, b) -> Dict:
  return {'kernel': np.transpose(_np(w), (2, 1, 0)), 'bias': _np(b)}


def _dense(w, b) -> Dict:
  return {'kernel': np.transpose(_np(w)), 'bias': _np(b)}


def import_cnn_params(state_dict: Dict[str, np.ndarray],
                      num_layers: int) -> Dict:
  """torch CNNModel state dict -> {'params': ..., 'buffers': ...}."""
  sd = state_dict
  params = {
      'stem': _conv(sd['linear.weight'], sd['linear.bias']),
      'time_linear': _dense(sd['time_embedder.1.weight'],
                            sd['time_embedder.1.bias']),
      'final_0': _conv(sd['final_conv.0.weight'], sd['final_conv.0.bias']),
      'final_1': _conv(sd['final_conv.2.weight'], sd['final_conv.2.bias']),
  }
  for i in range(num_layers):
    params[f'conv_{i}'] = _conv(sd[f'convs.{i}.weight'],
                                sd[f'convs.{i}.bias'])
    params[f'time_{i}'] = _dense(sd[f'time_layers.{i}.dense.weight'],
                                 sd[f'time_layers.{i}.dense.bias'])
    params[f'norm_{i}'] = {'scale': _np(sd[f'norms.{i}.weight']),
                           'bias': _np(sd[f'norms.{i}.bias'])}
  buffers = {'GaussianFourierProjection_0': {
      'W': _np(sd['time_embedder.0.W'])}}
  return {'params': params, 'buffers': buffers}
