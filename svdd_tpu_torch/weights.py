"""Carry svdd_tpu (flax) variables into the port's modules.

``variables`` are the flax trees as nested dicts of numpy arrays
(``params`` plus ``buffers`` or ``batch_stats``), e.g. from
``jax.tree.map(np.asarray, variables)``. Layouts: conv kernels stay
(K, Cin, Cout); Dense kernels (in, out) become torch (out, in); the
(1, h, 1, dk) relative biases flatten to (h*dk,); BatchNorm carries
scale/bias and the running mean/var; the ``nn.scan``-stacked
``transformer_stack`` params are split along their leading axis. The
DiT, AR and DiMamba converters also take the model's widths (a port
``Config``) and its compute dtype, which flax keeps outside the
variables.
"""

from __future__ import annotations

import numpy as np
import torch

from svdd_tpu_torch.config import Config, dna_config
from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.models.autoregressive import ARModel
from svdd_tpu_torch.models.basenji import Basenji
from svdd_tpu_torch.models.cnn import CNNModel
from svdd_tpu_torch.models.convgru import ConvGRUValueModel, ConvTower
from svdd_tpu_torch.models.dimamba import DiMamba
from svdd_tpu_torch.models.dit import DIT
from svdd_tpu_torch.models.enformer import EnformerValueModel


def _copy(dst: torch.Tensor, src) -> None:
  src = torch.as_tensor(np.array(src), dtype=dst.dtype)
  if tuple(src.shape) != tuple(dst.shape):
    raise ValueError(f'shape mismatch: port {tuple(dst.shape)} vs '
                     f'flax {tuple(src.shape)}')
  with torch.no_grad():
    dst.copy_(src)


def _dense(mod: torch.nn.Linear, p) -> None:
  _copy(mod.weight, np.asarray(p['kernel']).T)
  if mod.bias is not None:
    _copy(mod.bias, p['bias'])


def _norm(mod, p, stats=None) -> None:
  _copy(mod.scale, p['scale'])
  _copy(mod.bias, p['bias'])
  if stats is not None:
    _copy(mod.mean, stats['mean'])
    _copy(mod.var, stats['var'])


def _generator(device='cpu'):
  """The generator the converters build their modules from (their draws
  are then overwritten): on ``device``, where the module is built."""
  return torch.Generator(device).manual_seed(0)


def cnn_from_jax(variables, compute_dtype: torch.dtype = torch.float32,
                 device='cpu') -> CNNModel:
  """A CNN denoiser (on ``device``, computing in ``compute_dtype``)
  holding the flax CNNModel's variables; a tree with ``cls_embedder``
  builds the class-conditioned net, one with a ``cls_0``/``cls_1`` head
  and no embedding the classifier (its classes from ``cls_1``'s
  width)."""
  p = variables['params']
  hidden = np.asarray(p['time_linear']['kernel']).shape[0]
  n_layers = sum(1 for k in p if k.startswith('norm_'))
  # a classifier's head is cls_0, cls_1; a class-conditioned net's layer
  # projections cls_i sit beside its cls_embedder
  classifier = 'cls_1' in p and 'cls_embedder' not in p
  if classifier:
    num_cls = np.asarray(p['cls_1']['kernel']).shape[-1]
  elif 'cls_embedder' in p:
    num_cls = np.asarray(p['cls_embedder']['embedding']).shape[0] - 1
  else:
    num_cls = 3
  alphabet = np.asarray(p['stem']['kernel']).shape[1]
  cfg = dna_config()
  cfg.model.hidden_dim = hidden
  cfg.model.num_cnn_stacks = n_layers // 5
  cfg.model.cls_free_guidance = 'cls_embedder' in p
  model = CNNModel(cfg, alphabet_size=alphabet, compute_dtype=compute_dtype,
                   generator=_generator(device), num_cls=int(num_cls),
                   classifier=classifier)
  _copy(model.gfp.W, variables['buffers']['GaussianFourierProjection_0']['W'])
  _dense(model.time_linear, p['time_linear'])
  _copy(model.stem_kernel, p['stem']['kernel'])
  _copy(model.stem_bias, p['stem']['bias'])
  for i, layer in enumerate(model.layers):
    _copy(layer.ln_scale, p[f'norm_{i}']['scale'])
    _copy(layer.ln_bias, p[f'norm_{i}']['bias'])
    _copy(layer.kernel, p[f'conv_{i}']['kernel'])
    _copy(layer.conv_bias, p[f'conv_{i}']['bias'])
    _dense(layer.time, p[f'time_{i}'])
    if layer.cls is not None:
      _dense(layer.cls, p[f'cls_{i}'])
  for j in (0, 1):
    _copy(getattr(model, f'final_{j}_kernel'), p[f'final_{j}']['kernel'])
    _copy(getattr(model, f'final_{j}_bias'), p[f'final_{j}']['bias'])
  if model.cls_embedder is not None:
    _copy(model.cls_embedder, p['cls_embedder']['embedding'])
  if classifier:
    _dense(model.cls_0, p['cls_0'])
    _dense(model.cls_1, p['cls_1'])
  return model.eval()


def _np(t: torch.Tensor) -> np.ndarray:
  return t.detach().float().cpu().numpy()


def cnn_params_to_jax(tensors) -> dict:
  """The flax CNNModel ``params`` tree (numpy arrays) of a mapping from
  the port's CNN parameter names (``named_parameters()``) to tensors of
  their shapes: the parameters themselves, or per-parameter state such
  as an EMA shadow or Adam's moments. The class embedding, the layers'
  class projections and the classifier head map where present."""
  t = {k: _np(v) for k, v in tensors.items()}
  n_layers = sum(1 for k in t if k.endswith('.ln_scale'))
  dense = lambda pre: {'kernel': t[pre + 'weight'].T, 'bias': t[pre + 'bias']}
  p = {'time_linear': dense('time_linear.'),
       'stem': {'kernel': t['stem_kernel'], 'bias': t['stem_bias']}}
  for i in range(n_layers):
    pre = f'layers.{i}.'
    p[f'norm_{i}'] = {'scale': t[pre + 'ln_scale'], 'bias': t[pre + 'ln_bias']}
    p[f'conv_{i}'] = {'kernel': t[pre + 'kernel'],
                      'bias': t[pre + 'conv_bias']}
    p[f'time_{i}'] = dense(pre + 'time.')
    if pre + 'cls.weight' in t:
      p[f'cls_{i}'] = dense(pre + 'cls.')
  for j in (0, 1):
    p[f'final_{j}'] = {'kernel': t[f'final_{j}_kernel'],
                       'bias': t[f'final_{j}_bias']}
  if 'cls_embedder' in t:
    p['cls_embedder'] = {'embedding': t['cls_embedder']}
  for name in ('cls_0', 'cls_1'):
    if f'{name}.weight' in t:
      p[name] = dense(f'{name}.')
  return p


def cnn_to_jax(model: CNNModel) -> dict:
  """The inverse of ``cnn_from_jax``: the flax CNNModel variables
  (``params`` and the Fourier ``buffers``) of the port's model, as
  nested dicts of float32 numpy arrays."""
  return {'params': cnn_params_to_jax(dict(model.named_parameters())),
          'buffers': {'GaussianFourierProjection_0': {
              'W': _np(model.gfp.W)}}}


def _conv(mod, p) -> None:
  """A module holding a flax Conv1D's ``kernel`` and ``bias``."""
  _copy(mod.kernel, p['Conv1D_0']['kernel'])
  _copy(mod.bias, p['Conv1D_0']['bias'])


def _conv_block(block: blocks.ConvBlock, p, stats) -> None:
  _conv(block, p)
  if block.norm is not None:
    _norm(block.norm, p['Norm_0']['BatchNorm_0'],
          stats['Norm_0']['BatchNorm_0'])
  if block.channel_transform is not None:
    _conv(block.channel_transform, p['ChannelTransform_0'])
  if block.pool is not None:
    _copy(block.pool.w, p['Pool_0']['AttentionPool_0']['to_attn_logits'])


def _transformer_trees(trunk_p):
  """Per-block param trees, from the scan stack or transformer_{i}."""
  if 'transformer_stack' in trunk_p:
    stack = trunk_p['transformer_stack']['EnformerTransformerBlock_0']
    n = np.asarray(stack['LayerNorm_0']['scale']).shape[0]

    def take(tree, i):
      if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
      return np.asarray(tree)[i]
    return [take(stack, i) for i in range(n)]
  n = sum(1 for k in trunk_p if k.startswith('transformer_'))
  return [trunk_p[f'transformer_{i}'] for i in range(n)]


def _transformer(block, p) -> None:
  _norm(block.norm, p['LayerNorm_0'])
  a, ap = block.attn, p['EnformerAttention_0']
  for name in ('to_q', 'to_k', 'to_v', 'to_rel_k', 'to_out'):
    _dense(getattr(a, name), ap[name])
  _copy(a.rel_content_bias, np.asarray(ap['rel_content_bias']).reshape(-1))
  _copy(a.rel_pos_bias, np.asarray(ap['rel_pos_bias']).reshape(-1))
  fp = p['FeedForwardBlock_0']
  _norm(block.ffn.norm, fp['LinearBlock_0']['Norm_0']['LayerNorm_0'])
  _dense(block.ffn.up, fp['LinearBlock_0']['Dense_0'])
  _dense(block.ffn.down, fp['LinearBlock_1']['Dense_0'])


def enformer_value_from_jax(
    variables, compute_dtype: torch.dtype = torch.float32, device='cpu'
) -> EnformerValueModel:
  """An Enformer value model (on ``device``, computing in ``compute_dtype``)
  holding the flax EnformerValueModel's variables; timed where they hold
  a ``TimeEmbedding_0`` table."""
  p = variables['params']
  stats = variables['batch_stats']['EnformerTrunk_0']
  trunk_p = p['EnformerTrunk_0']
  tower_p = trunk_p['EnformerConvTower_0']
  tower_s = stats['EnformerConvTower_0']
  channels = np.asarray(trunk_p['pointwise']['Conv1D_0']['kernel']).shape[1]
  n_conv = 1 + sum(1 for k in tower_p if k.startswith('conv_'))
  trees = _transformer_trees(trunk_p)
  n_heads, dk = (np.asarray(trees[0]['EnformerAttention_0']
                            ['rel_content_bias']).shape[i] for i in (1, 3))
  head_p = (p['ConvHead_0']['ChannelTransformBlock_0']
            ['ChannelTransform_0']['Conv1D_0'])
  n_tasks = np.asarray(head_p['kernel']).shape[-1]
  model = EnformerValueModel(
      n_tasks=n_tasks, n_conv=n_conv, channels=channels,
      n_transformers=len(trees), n_heads=n_heads, key_len=dk,
      compute_dtype=compute_dtype, generator=_generator(device),
      timed='TimeEmbedding_0' in p)
  if model.timed:
    _copy(model.time_embedding.embedding, p['TimeEmbedding_0']['embedding'])
  tower = model.trunk.tower
  _copy(tower.stem_kernel, tower_p['stem_conv']['kernel'])
  _copy(tower.stem_bias, tower_p['stem_conv']['bias'])
  _conv_block(tower.stem_block, tower_p['stem_block'],
              tower_s['stem_block'])
  for i, (conv, pool) in enumerate(zip(tower.convs, tower.pools), 1):
    _conv_block(conv, tower_p[f'conv_{i}'], tower_s[f'conv_{i}'])
    _conv_block(pool, tower_p[f'pool_{i}'], tower_s[f'pool_{i}'])
  for block, tree in zip(model.trunk.transformers, trees):
    _transformer(block, tree)
  _conv_block(model.trunk.pointwise, trunk_p['pointwise'],
              stats['pointwise'])
  _copy(model.head.kernel, head_p['kernel'])
  _copy(model.head.bias, head_p['bias'])
  return model.eval()


def _block_to_jax(t, pre: str, stats: bool = False) -> dict:
  """A ConvBlock's flax tree from ``t`` ({port name: array}) under the
  port prefix ``pre``: its params, or (``stats``) its batch stats."""
  if stats:
    return {'Norm_0': {'BatchNorm_0': {'mean': t[pre + 'norm.mean'],
                                       'var': t[pre + 'norm.var']}}}
  out = {'Conv1D_0': {'kernel': t[pre + 'kernel'], 'bias': t[pre + 'bias']}}
  if pre + 'norm.scale' in t:
    out['Norm_0'] = {'BatchNorm_0': {'scale': t[pre + 'norm.scale'],
                                     'bias': t[pre + 'norm.bias']}}
  if pre + 'channel_transform.kernel' in t:
    out['ChannelTransform_0'] = {'Conv1D_0': {
        'kernel': t[pre + 'channel_transform.kernel'],
        'bias': t[pre + 'channel_transform.bias']}}
  if pre + 'pool.w' in t:
    out['Pool_0'] = {'AttentionPool_0': {'to_attn_logits': t[pre + 'pool.w']}}
  return out


def _transformer_to_jax(t, pre: str, heads: int) -> dict:
  dense = lambda name, bias=True: dict(
      {'kernel': t[f'{pre}{name}.weight'].T},
      **({'bias': t[f'{pre}{name}.bias']} if bias else {}))
  rel = lambda name: t[pre + name].reshape(1, heads, 1, -1)
  attn = {name: dense('attn.' + name, False)
          for name in ('to_q', 'to_k', 'to_v', 'to_rel_k')}
  attn.update(to_out=dense('attn.to_out'),
              rel_content_bias=rel('attn.rel_content_bias'),
              rel_pos_bias=rel('attn.rel_pos_bias'))
  return {'LayerNorm_0': {'scale': t[pre + 'norm.scale'],
                          'bias': t[pre + 'norm.bias']},
          'EnformerAttention_0': attn,
          'FeedForwardBlock_0': {
              'LinearBlock_0': {
                  'Norm_0': {'LayerNorm_0': {
                      'scale': t[pre + 'ffn.norm.scale'],
                      'bias': t[pre + 'ffn.norm.bias']}},
                  'Dense_0': dense('ffn.up')},
              'LinearBlock_1': {'Dense_0': dense('ffn.down')}}}


def enformer_params_to_jax(tensors, model: EnformerValueModel,
                           stats: bool = False) -> dict:
  """The flax EnformerValueModel ``params`` tree (numpy float32 arrays)
  of a mapping from the port's parameter names (``named_parameters()``)
  to tensors of their shapes: the parameters, their gradients or Adam's
  moments; with ``stats``, the ``batch_stats`` tree of the mapping's
  BatchNorm buffers (``named_buffers()``). ``model`` gives the widths;
  more than one transformer block is stacked as JAX's ``nn.scan``
  stacks it."""
  t = {k: _np(v) for k, v in tensors.items()}
  cfg = model.config()
  tower = {}
  blocks_of = [('stem_block', 'trunk.tower.stem_block.')]
  for i in range(1, cfg['n_conv']):
    blocks_of += [(f'conv_{i}', f'trunk.tower.convs.{i - 1}.'),
                  (f'pool_{i}', f'trunk.tower.pools.{i - 1}.')]
  for name, pre in blocks_of:
    tower[name] = _block_to_jax(t, pre, stats)
  trunk = {'EnformerConvTower_0': tower,
           'pointwise': _block_to_jax(t, 'trunk.pointwise.', stats)}
  if stats:
    return {'EnformerTrunk_0': trunk}
  tower['stem_conv'] = {'kernel': t['trunk.tower.stem_kernel'],
                        'bias': t['trunk.tower.stem_bias']}
  layers = [_transformer_to_jax(t, f'trunk.transformers.{j}.',
                                cfg['n_heads'])
            for j in range(cfg['n_transformers'])]
  if len(layers) == 1:
    trunk['transformer_0'] = layers[0]
  else:
    def stack(*trees):
      if isinstance(trees[0], dict):
        return {k: stack(*(tr[k] for tr in trees)) for k in trees[0]}
      return np.stack(trees)
    trunk['transformer_stack'] = {'EnformerTransformerBlock_0':
                                  stack(*layers)}
  out = {'EnformerTrunk_0': trunk, 'ConvHead_0': {
      'ChannelTransformBlock_0': {'ChannelTransform_0': {'Conv1D_0': {
          'kernel': t['head.kernel'], 'bias': t['head.bias']}}}}}
  if 'time_embedding.embedding' in t:
    out['TimeEmbedding_0'] = {'embedding': t['time_embedding.embedding']}
  return out


def enformer_to_jax(model: EnformerValueModel) -> dict:
  """The inverse of ``enformer_value_from_jax``: the flax variables
  (``params`` and ``batch_stats``) of the port's model."""
  return {'params': enformer_params_to_jax(dict(model.named_parameters()),
                                           model),
          'batch_stats': enformer_params_to_jax(dict(model.named_buffers()),
                                                model, stats=True)}


def multisep_from_jax(stacked, from_jax=enformer_value_from_jax, **kwargs):
  """The port's list of trunks of a flax multisep model's stacked
  variables (every leaf with a leading ``n_models`` axis,
  ``svdd_tpu/models/multisep.py``): trunk i from the leaves' slice i,
  through ``from_jax`` (``enformer_value_from_jax`` or
  ``convgru_from_jax``, with ``kwargs``)."""
  def take(tree, i):
    if isinstance(tree, dict):
      return {k: take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]

  first = stacked['params']
  while isinstance(first, dict):
    first = next(iter(first.values()))
  return [from_jax(take(stacked, i), **kwargs)
          for i in range(np.asarray(first).shape[0])]


def _conv_tower(tower: ConvTower, tp, ts) -> None:
  """A ConvTower from the flax ConvTower's params and batch stats."""
  _conv(tower.stem, tp['Stem_0'])
  for i, block in enumerate(tower.blocks):
    _conv_block(block, tp[f'ConvBlock_{i}'], ts[f'ConvBlock_{i}'])


def _gru_cell(layer, suffix: str, p) -> None:
  _dense(getattr(layer, f'ih_{suffix}'), p['ih'])
  _copy(getattr(layer, f'hh_kernel_{suffix}'), p['hh_kernel'])
  _copy(getattr(layer, f'hh_bias_{suffix}'), p['hh_bias'])


def convgru_from_jax(variables, n_tasks: int = 1, dropout: float = 0.1,
                     device='cpu') -> ConvGRUValueModel:
  """A ConvGRU value model (on ``device``, float32) holding the flax
  ConvGRUValueModel's variables (params and ``batch_stats``); the
  tower maps as Basenji's does. The stem's input channels come from its
  kernel: 4, or 6 for the saluki oracle."""
  p, stats = variables['params'], variables['batch_stats']
  tp, ts = p['ConvGRUTrunk_0'], stats['ConvGRUTrunk_0']
  stem = tp['ConvTower_0']['Stem_0']['Conv1D_0']['kernel']
  model = ConvGRUValueModel(n_tasks=n_tasks, dropout=dropout,
                            in_channels=int(np.asarray(stem).shape[1]),
                            generator=_generator(device))
  _conv_tower(model.trunk.tower, tp['ConvTower_0'], ts['ConvTower_0'])
  gp = tp['GRUBlock_0']
  for i, layer in enumerate(model.trunk.gru.layers):
    _gru_cell(layer, 'fwd', gp[f'gru_fwd_{i}'])
    _gru_cell(layer, 'bwd', gp[f'gru_bwd_{i}'])
  fp, ffn = gp['FeedForwardBlock_0'], model.trunk.gru.ffn
  _norm(ffn.norm, fp['LinearBlock_0']['Norm_0']['LayerNorm_0'])
  _dense(ffn.up, fp['LinearBlock_0']['Dense_0'])
  _dense(ffn.down, fp['LinearBlock_1']['Dense_0'])
  _conv(model.head, p['ConvHead_0']['ChannelTransformBlock_0'][
      'ChannelTransform_0'])
  return model.eval()


def basenji_from_jax(variables, **config) -> Basenji:
  """A Basenji trunk (on CPU, float32) holding the flax Basenji's
  variables, params and ``batch_stats`` of every block; ``config`` are
  the keyword arguments the flax module was built with (its widths,
  depths, pools and multipliers, which flax keeps outside the
  variables), the JAX defaults where left out."""
  p, stats = variables['params'], variables['batch_stats']
  tp, ts = p['ConvTower_0'], stats['ConvTower_0']
  model = Basenji(**config, generator=_generator())
  _conv_tower(model.tower, tp, ts)
  for i, block in enumerate(model.residual_blocks):
    key = f'DilatedResidualBlock_{i}'
    _conv_block(block.conv_0, p[key]['ConvBlock_0'],
                stats[key]['ConvBlock_0'])
    _conv_block(block.conv_1, p[key]['ConvBlock_1'],
                stats[key]['ConvBlock_1'])
  _conv_block(model.final_block, p['ConvBlock_0'], stats['ConvBlock_0'])
  if 'ChannelTransform_0' in p:
    _conv(model.head, p['ChannelTransform_0'])
  return model.eval()


def _timestep_embedder(mod, p) -> None:
  _dense(mod.dense_0, p['Dense_0'])
  _dense(mod.dense_1, p['Dense_1'])


def _transformer_body(block, p) -> None:
  """The layers a DDiTBlock and an ARBlock share."""
  _copy(block.norm_0.scale, p['LayerNorm_0']['scale'])
  _copy(block.norm_1.scale, p['LayerNorm_1']['scale'])
  for name in ('attn_qkv', 'attn_out', 'mlp_0', 'mlp_1'):
    _dense(getattr(block, name), p[name])


def dit_from_jax(variables, config: Config,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device='cpu') -> DIT:
  """A DiT (on ``device``) holding the flax DIT's variables; ``config`` gives
  its widths (``model.hidden_size``, ``n_blocks``, ``n_heads``,
  ``cond_dim``)."""
  p = variables['params']
  vocab = np.asarray(p['vocab_embed']).shape[0]
  model = DIT(config, vocab, compute_dtype, generator=_generator(device))
  _copy(model.vocab_embed, p['vocab_embed'])
  _timestep_embedder(model.sigma_map, p['TimestepEmbedder_0'])
  for i, block in enumerate(model.blocks):
    bp = p[f'block_{i}']
    _dense(block.adaLN, bp['adaLN'])
    _transformer_body(block, bp)
  fp = p['DDitFinalLayer_0']
  _dense(model.output_layer.adaLN, fp['adaLN'])
  _copy(model.output_layer.norm.scale, fp['LayerNorm_0']['scale'])
  _dense(model.output_layer.linear, fp['linear'])
  return model.eval()


def ar_from_jax(variables, config: Config,
                compute_dtype: torch.dtype = torch.bfloat16,
                device='cpu') -> ARModel:
  """An AR model (on ``device``) holding the flax ARModel's variables."""
  p = variables['params']
  vocab = np.asarray(p['vocab_embed']).shape[0]
  model = ARModel(config, vocab, compute_dtype,
                  generator=_generator(device))
  _copy(model.vocab_embed, p['vocab_embed'])
  for i, block in enumerate(model.blocks):
    _transformer_body(block, p[f'block_{i}'])
  _copy(model.norm.scale, p['LayerNorm_0']['scale'])
  _dense(model.lm_head, p['lm_head'])
  return model.eval()


def dimamba_from_jax(variables, config: Config,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     device='cpu') -> DiMamba:
  """A DiMamba (on ``device``) holding the flax DiMamba's variables."""
  p = variables['params']
  vocab = np.asarray(p['vocab_embed']).shape[0]
  model = DiMamba(config, vocab, compute_dtype,
                  generator=_generator(device))
  _copy(model.vocab_embed, p['vocab_embed'])
  _timestep_embedder(model.sigma_map, p['TimestepEmbedder_0'])
  for i, block in enumerate(model.blocks):
    bp = p[f'block_{i}']
    _dense(block.adaLN, bp['adaLN'])
    _copy(block.norm_scale, bp['norm_scale'])
    mp, mixer = bp['BiMambaWrapper_0']['mixer'], block.bimamba.mixer
    for name in ('in_proj', 'x_proj', 'dt_proj', 'out_proj'):
      _dense(getattr(mixer, name), mp[name])
    for name in ('conv_kernel', 'conv_bias', 'A_log', 'D'):
      _copy(getattr(mixer, name), mp[name])
  _copy(model.final_norm_scale, p['final_norm_scale'])
  _dense(model.lm_head, p['lm_head'])
  return model.eval()
