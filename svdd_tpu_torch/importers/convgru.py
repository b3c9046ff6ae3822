"""ConvGRU importer (``svdd_tpu/importers/convgru.py``): the reference
RNA value net's and MRL oracle's state dict (BaseModel(ConvGRUTrunk,
ConvHead): ``embedding.conv_tower.blocks.{i}.*``,
``embedding.gru_tower.*``, ``head.channel_transform.*``) -> the flax
ConvGRUValueModel's ``{'params', 'batch_stats'}``.

torch.nn.GRU's ``weight_ih_l0`` is (3H, in) with the gates stacked
[r | z | n], the order the flax cell computes; the reverse direction
lives in the ``*_reverse`` keys.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from svdd_tpu_torch.checkpoint import strip_prefix


def _np(t) -> np.ndarray:
  return np.asarray(t, dtype=np.float32)


def import_gru_cell(sd: Dict[str, np.ndarray], prefix: str = '',
                    reverse: bool = False) -> Dict:
  """torch nn.GRU layer-0 weights -> the flax GRUCellScan params."""
  suffix = '_reverse' if reverse else ''
  w_ih = sd[f'{prefix}weight_ih_l0{suffix}']   # (3H, in)
  w_hh = sd[f'{prefix}weight_hh_l0{suffix}']   # (3H, H)
  return {
      'ih': {'kernel': np.transpose(w_ih),
             'bias': sd[f'{prefix}bias_ih_l0{suffix}']},
      'hh_kernel': np.transpose(w_hh),
      'hh_bias': sd[f'{prefix}bias_hh_l0{suffix}'],
  }


def import_bidirectional_gru(sd: Dict[str, np.ndarray],
                             prefix: str = '') -> Dict:
  """torch bidirectional GRU -> {gru_fwd_0, gru_bwd_0} params."""
  return {'gru_fwd_0': import_gru_cell(sd, prefix, reverse=False),
          'gru_bwd_0': import_gru_cell(sd, prefix, reverse=True)}


def _conv(sd: Dict, prefix: str) -> Dict:
  return {'kernel': np.transpose(_np(sd[f'{prefix}.weight']), (2, 1, 0)),
          'bias': _np(sd[f'{prefix}.bias'])}


def _dense(sd: Dict, prefix: str) -> Dict:
  return {'kernel': np.transpose(_np(sd[f'{prefix}.weight'])),
          'bias': _np(sd[f'{prefix}.bias'])}


def import_convgru_value_model(state_dict: Dict, n_conv: int = 6,
                               prefix: str = '') -> Dict:
  """The reference ConvGRU value net's state dict -> the flax
  ConvGRUValueModel's ``{'params', 'batch_stats'}``. Ignored reference
  keys: the Stem's unused layer norm and the FFN's dead '.dense.'
  LinearBlock."""
  sd = strip_prefix(state_dict, prefix)
  tower_p = {'Stem_0': {'Conv1D_0':
                        _conv(sd, 'embedding.conv_tower.blocks.0.conv')}}
  tower_s = {}
  for i in range(1, n_conv):
    base = f'embedding.conv_tower.blocks.{i}'
    tower_p[f'ConvBlock_{i - 1}'] = {
        'Conv1D_0': _conv(sd, f'{base}.conv'),
        'Norm_0': {'BatchNorm_0': {
            'scale': _np(sd[f'{base}.norm.layer.weight']),
            'bias': _np(sd[f'{base}.norm.layer.bias'])}},
    }
    tower_s[f'ConvBlock_{i - 1}'] = {'Norm_0': {'BatchNorm_0': {
        'mean': _np(sd[f'{base}.norm.layer.running_mean']),
        'var': _np(sd[f'{base}.norm.layer.running_var'])}}}
  gru_p = import_bidirectional_gru(sd, 'embedding.gru_tower.gru.')
  ffn = 'embedding.gru_tower.ffn'
  gru_p['FeedForwardBlock_0'] = {
      'LinearBlock_0': {
          'Norm_0': {'LayerNorm_0': {
              'scale': _np(sd[f'{ffn}.dense1.norm.layer.weight']),
              'bias': _np(sd[f'{ffn}.dense1.norm.layer.bias'])}},
          'Dense_0': _dense(sd, f'{ffn}.dense1.linear'),
      },
      'LinearBlock_1': {'Dense_0': _dense(sd, f'{ffn}.dense2.linear')},
  }
  params = {
      'ConvGRUTrunk_0': {'ConvTower_0': tower_p, 'GRUBlock_0': gru_p},
      'ConvHead_0': {'ChannelTransformBlock_0': {'ChannelTransform_0': {
          'Conv1D_0': _conv(sd, 'head.channel_transform.conv.layer')}}},
  }
  return {'params': params,
          'batch_stats': {'ConvGRUTrunk_0': {'ConvTower_0': tower_s}}}
