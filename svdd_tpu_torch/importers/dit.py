"""DiT importer (``svdd_tpu/importers/dit.py``): the reference DIT's
state dict (``vocab_embed.embedding``, ``sigma_map.mlp.{0,2}.*``,
``blocks.{i}.{norm1,attn_qkv,attn_out,norm2,mlp.0,mlp.2,
adaLN_modulation}.*``, ``output_layer.*``) -> the flax DIT's
``{'params'}``. The ``rotary_emb.inv_freq`` buffer is ignored (the
model recomputes its rotary tables). torch Linear (out, in) -> Dense
kernel (in, out); the weight-only LayerNorms -> {'scale'}.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from svdd_tpu_torch.checkpoint import strip_prefix


def _np(t) -> np.ndarray:
  return np.asarray(t, dtype=np.float32)


def _dense(sd: Dict, prefix: str, bias: bool = True) -> Dict:
  out = {'kernel': np.transpose(_np(sd[f'{prefix}.weight']))}
  if bias:
    out['bias'] = _np(sd[f'{prefix}.bias'])
  return out


def import_dit_params(state_dict: Dict, n_blocks: int,
                      prefix: str = '') -> Dict:
  """torch DIT state dict -> {'params': ...} of the flax DIT."""
  sd = strip_prefix(state_dict, prefix)
  params = {
      'vocab_embed': _np(sd['vocab_embed.embedding']),
      'TimestepEmbedder_0': {
          'Dense_0': _dense(sd, 'sigma_map.mlp.0'),
          'Dense_1': _dense(sd, 'sigma_map.mlp.2'),
      },
      'DDitFinalLayer_0': {
          'adaLN': _dense(sd, 'output_layer.adaLN_modulation'),
          'LayerNorm_0': {'scale': _np(sd['output_layer.norm_final.weight'])},
          'linear': _dense(sd, 'output_layer.linear'),
      },
  }
  for i in range(n_blocks):
    base = f'blocks.{i}'
    params[f'block_{i}'] = {
        'adaLN': _dense(sd, f'{base}.adaLN_modulation'),
        'LayerNorm_0': {'scale': _np(sd[f'{base}.norm1.weight'])},
        'attn_qkv': _dense(sd, f'{base}.attn_qkv', bias=False),
        'attn_out': _dense(sd, f'{base}.attn_out', bias=False),
        'LayerNorm_1': {'scale': _np(sd[f'{base}.norm2.weight'])},
        'mlp_0': _dense(sd, f'{base}.mlp.0'),
        'mlp_1': _dense(sd, f'{base}.mlp.2'),
    }
  return {'params': params}
