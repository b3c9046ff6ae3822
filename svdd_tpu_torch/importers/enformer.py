"""Enformer value-net importer (``svdd_tpu/importers/enformer.py``): the
reference DNA value net's or reward oracle's state dict
(BaseModel(EnformerTrunk, ConvHead): ``embedding.conv_tower.blocks.{i}.
{0,1}.*``, ``embedding.transformer_tower.blocks.{j}.*``,
``embedding.pointwise_conv.*``, ``head.channel_transform.*``, and the
timed trunk's ``embedding.time_embedding.time_embedding.weight``) -> the
flax EnformerValueModel's ``{'params', 'batch_stats'}``.

Beyond the layout transposes, the transformer blocks are stacked along
a leading axis (the flax trunk's ``nn.scan`` layout; one block stays
unrolled as ``transformer_0``), and each torch BatchNorm splits into
params (scale, bias) and batch stats (mean, var).

  torch Conv1d weight (out, in, k)  -> Conv1D kernel (k, in, out)
  torch Linear weight (out, in)     -> Dense kernel (in, out)
  AttentionPool Conv2d (C, C, 1, 1) -> (C, C) logits matrix, transposed
  nn.Embedding weight               -> TimeEmbedding 'embedding' table
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from svdd_tpu_torch.checkpoint import strip_prefix


def _np(t) -> np.ndarray:
  return np.asarray(t, dtype=np.float32)


def _conv(sd: Dict, prefix: str) -> Dict:
  return {'kernel': np.transpose(_np(sd[f'{prefix}.weight']), (2, 1, 0)),
          'bias': _np(sd[f'{prefix}.bias'])}


def _dense(sd: Dict, prefix: str, bias: bool = True) -> Dict:
  out = {'kernel': np.transpose(_np(sd[f'{prefix}.weight']))}
  if bias:
    out['bias'] = _np(sd[f'{prefix}.bias'])
  return out


def _layernorm(sd: Dict, prefix: str) -> Dict:
  return {'scale': _np(sd[f'{prefix}.weight']),
          'bias': _np(sd[f'{prefix}.bias'])}


def _conv_block(sd: Dict, prefix: str, attn_pool: bool = False):
  """A reference ConvBlock -> the flax ConvBlock's (params, stats):
  Conv1D_0, Norm_0/BatchNorm_0[, Pool_0/AttentionPool_0][,
  ChannelTransform_0]."""
  bn = f'{prefix}.norm.layer'
  params = {'Conv1D_0': _conv(sd, f'{prefix}.conv'),
            'Norm_0': {'BatchNorm_0': {'scale': _np(sd[f'{bn}.weight']),
                                       'bias': _np(sd[f'{bn}.bias'])}}}
  if attn_pool:
    # Conv2d (C_out, C_in, 1, 1) acting channelwise == x @ W^T
    w = _np(sd[f'{prefix}.pool.layer.to_attn_logits.weight'])[:, :, 0, 0]
    params['Pool_0'] = {'AttentionPool_0': {'to_attn_logits': w.T}}
  if f'{prefix}.channel_transform.layer.weight' in sd:
    params['ChannelTransform_0'] = {
        'Conv1D_0': _conv(sd, f'{prefix}.channel_transform.layer')}
  stats = {'Norm_0': {'BatchNorm_0': {
      'mean': _np(sd[f'{bn}.running_mean']),
      'var': _np(sd[f'{bn}.running_var'])}}}
  return params, stats


def _transformer_block(sd: Dict, prefix: str) -> Dict:
  """A reference EnformerTransformerBlock -> the flax block's params; the
  FFN's dead '.dense.' LinearBlock is ignored."""
  mha = f'{prefix}.mha'
  return {
      'LayerNorm_0': _layernorm(sd, f'{prefix}.norm.layer'),
      'EnformerAttention_0': {
          'to_q': _dense(sd, f'{mha}.to_q', bias=False),
          'to_k': _dense(sd, f'{mha}.to_k', bias=False),
          'to_v': _dense(sd, f'{mha}.to_v', bias=False),
          'to_rel_k': _dense(sd, f'{mha}.to_rel_k', bias=False),
          'to_out': _dense(sd, f'{mha}.to_out'),
          'rel_content_bias': _np(sd[f'{mha}.rel_content_bias']),
          'rel_pos_bias': _np(sd[f'{mha}.rel_pos_bias']),
      },
      'FeedForwardBlock_0': {
          'LinearBlock_0': {
              'Norm_0': {'LayerNorm_0':
                         _layernorm(sd, f'{prefix}.ffn.dense1.norm.layer')},
              'Dense_0': _dense(sd, f'{prefix}.ffn.dense1.linear'),
          },
          'LinearBlock_1': {
              'Dense_0': _dense(sd, f'{prefix}.ffn.dense2.linear'),
          },
      },
  }


def _stack(trees):
  """Stack same-structured trees leaf by leaf along a new leading axis."""
  if isinstance(trees[0], dict):
    return {k: _stack([t[k] for t in trees]) for k in trees[0]}
  return np.stack(trees)


def _count(sd: Dict, pattern: str) -> int:
  """1 + the largest index a key of ``sd`` matches ``pattern`` with."""
  found = [int(m.group(1)) for k in sd for m in [re.match(pattern, k)] if m]
  return 1 + max(found) if found else 0


def import_enformer_value_model(
    state_dict: Dict, n_conv: Optional[int] = None,
    n_transformers: Optional[int] = None, timed: bool = False,
    prefix: str = '') -> Dict:
  """The reference BaseModel(EnformerTrunk, ConvHead) state dict -> the
  flax EnformerValueModel's ``{'params', 'batch_stats'}``. ``n_conv`` and
  ``n_transformers``: the tower's and the transformer stack's depths,
  counted from the keys where not given (the reference's value net and
  oracle: 7 and 11, the JAX importer's defaults). ``prefix``: e.g.
  'module.' for DataParallel-saved dicts."""
  sd = strip_prefix(state_dict, prefix)
  if n_conv is None:
    n_conv = _count(sd, r'embedding\.conv_tower\.blocks\.(\d+)\.')
  if n_transformers is None:
    n_transformers = _count(sd, r'embedding\.transformer_tower\.blocks\.'
                                r'(\d+)\.')
  tower_p, tower_s = {}, {}
  tower_p['stem_conv'] = _conv(sd, 'embedding.conv_tower.blocks.0.0')
  tower_p['stem_block'], tower_s['stem_block'] = _conv_block(
      sd, 'embedding.conv_tower.blocks.0.1', attn_pool=True)
  for i in range(1, n_conv):
    base = f'embedding.conv_tower.blocks.{i}'
    tower_p[f'conv_{i}'], tower_s[f'conv_{i}'] = _conv_block(sd, f'{base}.0')
    tower_p[f'pool_{i}'], tower_s[f'pool_{i}'] = _conv_block(
        sd, f'{base}.1', attn_pool=True)
  layers = [_transformer_block(sd, f'embedding.transformer_tower.blocks.{j}')
            for j in range(n_transformers)]
  if n_transformers > 1:
    tr_p = {'transformer_stack': {'EnformerTransformerBlock_0':
                                  _stack(layers)}}
  else:
    tr_p = {'transformer_0': layers[0]}
  pw_p, pw_s = _conv_block(sd, 'embedding.pointwise_conv')
  params = {
      'EnformerTrunk_0': {'EnformerConvTower_0': tower_p, 'pointwise': pw_p,
                          **tr_p},
      'ConvHead_0': {'ChannelTransformBlock_0': {'ChannelTransform_0': {
          'Conv1D_0': _conv(sd, 'head.channel_transform.conv.layer')}}},
  }
  if timed:
    params['TimeEmbedding_0'] = {'embedding': _np(
        sd['embedding.time_embedding.time_embedding.weight'])}
  stats = {'EnformerTrunk_0': {'EnformerConvTower_0': tower_s,
                               'pointwise': pw_s}}
  return {'params': params, 'batch_stats': stats}
