"""Enformer value trunk for the DNA task (``svdd_tpu/models/enformer.py``).

Conv tower: a k=15 stem conv, then attention-pooled NACDR conv blocks
whose channels grow exponentially to ``channels``. The eval forward
hands each pool to the next k=5 block's fused pool+prologue+im2col
kernel. ``fused=False`` runs every block in its plain differentiable
form instead (norm, act, conv, then the pool kernel with the residual),
the counterpart of the JAX package's ``blocks.unfused_guard``: the
guidance gradients take that form, whose convs and pools have backward
kernels (``ops/conv1d.py``, ``ops/attn_pool.py``). At L=200 the
tower pools 200 -> 100 -> 50 -> 25 -> 13 -> 7 -> 4 -> 2, so the
transformer stack runs at length 2, where the attention goes through
the L=2 kernel (``ops/attn_l2.py``); other lengths take the general
relative-position attention in plain torch. Under ``capture_attention()``
each attention block also appends its (N, H, L', L') map to the list the
context yields (``analysis.interpret.get_attention_scores``): at L' = 2
built from B5's key-0 weights ``w`` as [w, 1 - w], else the softmax.
Outside the context no map is kept.

``train=True`` is the JAX module's ``apply(train=True,
mutable=['batch_stats'])``: the tower's blocks in their plain form (the
k=5 convs' backward on kernel B7, the pools on B4 forward and B8
backward, never the L-major eval pipeline, ``enformer.py:273,294,356``)
with BatchNorm on the batch's statistics, whose running averages the
forward moves in the module's buffers; the stem conv's backward summed
in a fixed order (``ops.conv1d._ConvPlainBwd``, as every recorded conv
off B7's gate), so that no weight gradient of training sums with
atomics; and the three dropouts of each transformer block live at
``ff_dropout`` (after the attention and in the FFN's two linear blocks),
their masks from a ``blocks.DropoutMasks``. The pointwise block's
dropout is ``ff_dropout // 8`` = 0.0, as in JAX, so inert.

``tp_shard_value_params`` splits a value net over the ``model`` axis of a
process grid, Megatron-style, as JAX's ``tp_value_spec`` shards it
(``svdd_tpu/parallel/mesh.py:135``): each process keeps H/m heads of
every attention (to_q, to_k, to_v, to_rel_k and the relative biases) and
the matching rows of to_out, a column block of the FFN's first Dense and
the rows of its second, a column block of the pointwise conv and the
rows of the head's 1x1 conv; an all-reduce over ``model`` follows each
attention, each FFN and the head, whose biases process 0 alone adds. The
conv tower stays whole. Forward only: JAX splits the net at decode.
"""

from __future__ import annotations

import contextlib
import copy
import math

import numpy as np
import torch
from torch import nn

from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.ops.attn_l2 import attn_l2
from svdd_tpu_torch.ops.conv1d import conv1d_shifted
from svdd_tpu_torch.ops.kernel_utils import gelu_enformer
from svdd_tpu_torch.parallel import mesh as mesh_lib


def exponential_linspace_int(start: int, end: int, num: int,
                             divisible_by: int = 1) -> list[int]:
  """Exponentially spaced channel schedule."""
  def _round(x):
    return int(round(x / divisible_by) * divisible_by)
  base = math.exp(math.log(end / start) / (num - 1))
  return [_round(start * base ** i) for i in range(num)]


# ---------------------------------------------------------------------------
# Relative positional basis (exponential / central-mask / gamma)
# ---------------------------------------------------------------------------


def _pos_feats_exponential(positions, features, seq_len,
                           min_half_life: float = 3.0):
  max_range = math.log(seq_len) / math.log(2.0)
  half_life = 2.0 ** np.linspace(min_half_life, max_range, features)
  return np.exp(-math.log(2.0) / half_life[None, :]
                * np.abs(positions)[:, None])


def _pos_feats_central_mask(positions, features):
  center_widths = 2.0 ** np.arange(1, features + 1) - 1
  return (center_widths[None, :] > np.abs(positions)[:, None]
          ).astype(np.float32)


def _gamma_log_pdf(x, concentration, rate):
  gammaln = np.vectorize(math.lgamma)
  logx = np.where(x > 0, np.log(np.maximum(x, 1e-20)), -np.inf)
  with np.errstate(invalid='ignore'):
    out = (np.log(rate) * concentration
           + np.where(concentration == 1.0, 0.0,
                      logx * (concentration - 1))
           - rate * x - gammaln(concentration))
  return np.where(np.isfinite(out), out, -np.inf)


def _pos_feats_gamma(positions, features, seq_len, eps: float = 1e-8):
  stddev = seq_len / (2 * features)
  start_mean = seq_len / features
  mean = np.linspace(start_mean, seq_len, features)[None, :]
  concentration = (mean / stddev) ** 2
  rate = mean / stddev ** 2
  logp = _gamma_log_pdf(np.abs(positions).astype(np.float64)[:, None],
                        concentration, rate)
  logmax = np.amax(logp, axis=-1, keepdims=True)
  logmax = np.where(np.isfinite(logmax), logmax, 0.0)
  probs = np.exp(logp - logmax) + eps
  return (probs / np.amax(probs, axis=-1, keepdims=True)
          ).astype(np.float32)


def relative_positional_basis(seq_len: int, feature_size: int
                              ) -> np.ndarray:
  """(2L-1, 6 * (feature_size // 6)) basis over distances
  [-(L-1), L-1]: three families, each also mirrored by sign(distance)."""
  distances = np.arange(-seq_len + 1, seq_len)
  n = max(1, feature_size // 6)
  emb = np.concatenate([
      _pos_feats_exponential(distances, n, seq_len),
      _pos_feats_central_mask(distances, n),
      _pos_feats_gamma(distances, n, seq_len),
  ], axis=-1)
  emb = np.concatenate([emb, np.sign(distances)[:, None] * emb], axis=-1)
  return emb.astype(np.float32)


def relative_shift(x: torch.Tensor) -> torch.Tensor:
  """(B, H, L, 2L-1) relative logits -> (B, H, L, L) aligned ones."""
  b, h, l, _ = x.shape
  x = torch.nn.functional.pad(x, (1, 0))
  x = x.reshape(b, h, 2 * l, l)[:, :, 1:, :]
  return x.reshape(b, h, l, 2 * l - 1)[..., :l]


# the list the attention blocks append their maps to, under
# capture_attention() alone
_ATTENTION_MAPS: list | None = None


@contextlib.contextmanager
def capture_attention():
  """Collect the attention maps of every EnformerAttention that runs in
  the block, in call order: yields the list they are appended to, each
  (N, H, L', L') with rows summing to 1."""
  global _ATTENTION_MAPS
  saved, _ATTENTION_MAPS = _ATTENTION_MAPS, []
  try:
    yield _ATTENTION_MAPS
  finally:
    _ATTENTION_MAPS = saved


class EnformerAttention(nn.Module):
  """MHA with Enformer's relative positional bias. ``tp_group``: the
  model group of a tensor-parallel copy (``tp_shard_value_params``),
  whose partial outputs this block sums."""

  tp_group = None

  def __init__(self, dim: int, generator: torch.Generator, heads: int = 8,
               dim_key: int = 64, dim_value: int = 192,
               num_rel_pos_features: int = 192):
    super().__init__()
    dev = generator.device
    self.heads, self.dim_key, self.dim_value = heads, dim_key, dim_value
    self.num_rel_pos_features = num_rel_pos_features
    self.to_q = blocks.Dense(dim, heads * dim_key, generator, bias=False)
    self.to_k = blocks.Dense(dim, heads * dim_key, generator, bias=False)
    self.to_v = blocks.Dense(dim, heads * dim_value, generator, bias=False)
    n_feat = 6 * max(1, num_rel_pos_features // 6)
    self.to_rel_k = blocks.Dense(n_feat, heads * dim_key, generator,
                                 bias=False)
    self.rel_content_bias = nn.Parameter(torch.randn(
        heads * dim_key, generator=generator, device=dev))
    self.rel_pos_bias = nn.Parameter(torch.randn(
        heads * dim_key, generator=generator, device=dev))
    self.to_out = blocks.Dense(heads * dim_value, dim, generator)
    self._positions = {}

  def positions(self, n: int, x: torch.Tensor) -> torch.Tensor:
    key = (n, x.device, x.dtype)
    if key not in self._positions:
      # a normal tensor even when first made under inference mode, so a
      # later gradient through this module may save it
      with torch.inference_mode(False):
        self._positions[key] = torch.as_tensor(
            relative_positional_basis(n, self.num_rel_pos_features),
            dtype=x.dtype, device=x.device)
    return self._positions[key]

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, n, _ = x.shape
    h, dk, dv = self.heads, self.dim_key, self.dim_value
    q = self.to_q(x) / math.sqrt(dk)
    k = self.to_k(x)
    v = self.to_v(x)
    rel_k = self.to_rel_k(self.positions(n, x))            # (2n-1, h*dk)
    bc = self.rel_content_bias.to(x.dtype)
    bp = self.rel_pos_bias.to(x.dtype)
    if n == 2:
      out, w = attn_l2(q, k, v, bc, bp, rel_k, heads=h)
      if _ATTENTION_MAPS is not None:       # (N, 2, H) -> (N, H, 2, 2)
        _ATTENTION_MAPS.append(torch.stack([w, 1.0 - w], -1).transpose(1, 2))
      return self._reduce(self.to_out(out))
    q = q.reshape(b, n, h, dk).transpose(1, 2)
    k = k.reshape(b, n, h, dk).transpose(1, 2)
    v = v.reshape(b, n, h, dv).transpose(1, 2)
    content = torch.einsum('bhid,bhjd->bhij', q + bc.reshape(h, 1, dk), k)
    rel_k = rel_k.reshape(2 * n - 1, h, dk).transpose(0, 1)
    rel = relative_shift(torch.einsum(
        'bhid,hjd->bhij', q + bp.reshape(h, 1, dk), rel_k))
    attn = torch.softmax((content + rel).float(), dim=-1).to(x.dtype)
    if _ATTENTION_MAPS is not None:
      _ATTENTION_MAPS.append(attn)
    out = torch.einsum('bhij,bhjd->bhid', attn, v)
    return self._reduce(self.to_out(out.transpose(1, 2).reshape(b, n, h * dv)))

  def _reduce(self, y: torch.Tensor) -> torch.Tensor:
    if self.tp_group is None:
      return y
    return mesh_lib.all_reduce_(y, self.tp_group)


class EnformerTransformerBlock(nn.Module):
  """Pre-LN attention and FFN, each with a residual; in training the
  attention's output and the FFN's two linear blocks take dropout at
  ``ff_dropout`` (``masks``)."""

  def __init__(self, dim: int, generator: torch.Generator,
               n_heads: int = 8, key_len: int = 64,
               ff_dropout: float = 0.4):
    super().__init__()
    self.ff_dropout = ff_dropout
    self.norm = blocks.LayerNorm(dim, generator.device)
    self.attn = EnformerAttention(
        dim, generator, heads=n_heads, dim_key=key_len,
        dim_value=dim // n_heads, num_rel_pos_features=dim // n_heads)
    self.ffn = blocks.FeedForwardBlock(dim, generator, dropout=ff_dropout)

  def forward(self, x, masks: blocks.DropoutMasks | None = None):
    x = x + blocks.dropout(self.attn(self.norm(x)), self.ff_dropout, masks)
    return x + self.ffn(x, masks)


class EnformerConvTower(nn.Module):
  """Stem conv + attention-pooled conv blocks. (N, L, 4) one-hot ->
  (N, L / 2^n_blocks rounded up, out_channels)."""

  def __init__(self, generator: torch.Generator, n_blocks: int = 7,
               out_channels: int = 1536):
    super().__init__()
    half = out_channels // 2
    self.stem_kernel = blocks.conv_param(15, 4, half, generator)
    self.stem_bias = nn.Parameter(torch.zeros(half,
                                              device=generator.device))
    nacdr = dict(act_func='gelu_enformer', order='NACDR')
    pooled = dict(residual=True, pool_func='attn', pool_size=2, **nacdr)
    self.stem_block = blocks.ConvBlock(half, half, 1, generator, **pooled)
    filters = [half] + exponential_linspace_int(
        half, out_channels, num=n_blocks - 1, divisible_by=128)
    self.convs = nn.ModuleList()
    self.pools = nn.ModuleList()
    for i in range(1, n_blocks):
      self.convs.append(blocks.ConvBlock(filters[i - 1], filters[i], 5,
                                         generator, **nacdr))
      self.pools.append(blocks.ConvBlock(filters[i], filters[i], 1,
                                         generator, **pooled))

  def forward(self, x, fused: bool = True, train: bool = False,
              masks: blocks.DropoutMasks | None = None):
    """``train``: the plain form with BatchNorm on the batch (module
    docstring); ``fused`` is then ignored."""
    fused = fused and not train
    # the JAX tower's L-major pipeline: the eval tower at an even input
    # length (its default SVDD_TOWER_LNC=1), where the pools' dispatch
    # tiles N by 8 (ops.attn_pool.wlogits_body_takes)
    defer = fused and len(self.convs) > 0
    lnc = defer and x.shape[1] % 2 == 0
    if fused and blocks.defers_bias(x.dtype):
      x = blocks.PendingBias(conv1d_shifted(x, self.stem_kernel),
                             self.stem_bias.float())
    else:
      x = conv1d_shifted(x, self.stem_kernel, self.stem_bias)
    mode = dict(train=train, masks=masks)
    x = self.stem_block(x, defer_pool=defer, lnc=lnc, **mode)
    for i, (conv, pool) in enumerate(zip(self.convs, self.pools)):
      x = pool(conv(x, fused=fused, **mode),
               defer_pool=fused and i < len(self.convs) - 1, lnc=lnc, **mode)
    return x


class EnformerTrunk(nn.Module):
  """Conv tower + transformer stack + pointwise 2x conv.
  (N, L, 4) one-hot -> (N, L', 2 * channels)."""

  def __init__(self, generator: torch.Generator, n_conv: int = 7,
               channels: int = 1536, n_transformers: int = 11,
               n_heads: int = 8, key_len: int = 64,
               ff_dropout: float = 0.4):
    super().__init__()
    self.tower = EnformerConvTower(generator, n_blocks=n_conv,
                                   out_channels=channels)
    self.transformers = nn.ModuleList([
        EnformerTransformerBlock(channels, generator, n_heads, key_len,
                                 ff_dropout)
        for _ in range(n_transformers)])
    # the JAX trunk's floor division: 0.4 // 8 == 0.0
    self.pointwise = blocks.ConvBlock(channels, 2 * channels, 1,
                                      generator, act_func='gelu_enformer',
                                      order='NACDR',
                                      dropout=ff_dropout // 8)

  def forward(self, x, fused: bool = True, train: bool = False,
              masks: blocks.DropoutMasks | None = None):
    x = self.tower(x, fused, train, masks)
    for block in self.transformers:
      x = block(x, masks if train else None)
    return gelu_enformer(self.pointwise(x, train=train, masks=masks))


class TimeEmbedding(nn.Module):
  """The timed value net's per-step additive embedding
  (``svdd_tpu/models/enformer.py:TimeEmbedding``): a (128, 4) float32
  table, normal(1.0) at init, read at each position's step index."""

  def __init__(self, generator: torch.Generator, max_time_steps: int = 128,
               embedding_size: int = 4):
    super().__init__()
    self.embedding = nn.Parameter(torch.randn(
        max_time_steps, embedding_size, generator=generator,
        device=generator.device))

  def forward(self, time_indices: torch.Tensor) -> torch.Tensor:
    return self.embedding[time_indices.long()]


class EnformerValueModel(nn.Module):
  """Trunk + average-pool ConvHead: (N, L, 4) one-hot -> (N,) value
  (or (N, n_tasks)), in float32. ``fused=False`` takes the
  differentiable tower; ``train=True`` the training forward, which needs
  ``masks`` for its dropouts (module docstring).

  ``timed=True`` is the timed variant: x + 0.01 * table[time_indices]
  before the trunk (``time_indices`` (N, L), each state's step). As in
  JAX, the one-hot is cast to ``compute_dtype`` first and the float32
  table promotes the sum, so a timed net's trunk computes in float32
  even with a bf16 ``compute_dtype`` (``enformer.py:438-442``)."""

  def __init__(self, n_tasks: int = 1, n_conv: int = 7,
               channels: int = 1536, n_transformers: int = 11,
               n_heads: int = 8, key_len: int = 64,
               compute_dtype: torch.dtype = torch.float32,
               generator: torch.Generator | None = None,
               timed: bool = False):
    super().__init__()
    if generator is None:
      generator = torch.Generator().manual_seed(1)
    self.n_tasks = n_tasks
    self.compute_dtype = compute_dtype
    self.trunk = EnformerTrunk(generator, n_conv, channels,
                               n_transformers, n_heads, key_len)
    self.head = blocks.ConvHead(n_tasks, 2 * channels, generator)
    self.time_embedding = TimeEmbedding(generator) if timed else None

  @property
  def timed(self) -> bool:
    return self.time_embedding is not None

  def forward(self, x: torch.Tensor, fused: bool = True,
              train: bool = False,
              masks: blocks.DropoutMasks | None = None,
              time_indices: torch.Tensor | None = None) -> torch.Tensor:
    if train and masks is None:
      raise ValueError('a training forward needs the DropoutMasks of its '
                       'dropouts')
    x = x.to(self.compute_dtype)
    if self.timed:
      if time_indices is None:
        raise ValueError('timed model requires time_indices')
      x = x + 0.01 * self.time_embedding(time_indices)
    x = self.trunk(x, fused, train, masks)
    x = self.head(x).float()
    return x[..., 0] if self.n_tasks == 1 else x

  def config(self) -> dict:
    """The constructor's widths (and the timed flag), which a checkpoint
    records."""
    trunk = self.trunk
    attn = trunk.transformers[0].attn if trunk.transformers else None
    return {'n_tasks': self.n_tasks, 'n_conv': len(trunk.tower.convs) + 1,
            'channels': trunk.pointwise.kernel.shape[1],
            'n_transformers': len(trunk.transformers),
            'n_heads': attn.heads if attn else 8,
            'key_len': attn.dim_key if attn else 64,
            **({'timed': True} if self.timed else {})}


def tp_shard_value_params(module: EnformerValueModel,
                          mesh: mesh_lib.Mesh) -> EnformerValueModel:
  """A copy of ``module`` holding this process's tensor-parallel share
  over ``mesh``'s model axis (module docstring), ``mesh_lib.
  tp_value_spec``'s split of each parameter; with one model rank, the
  module's own weights. The head count and every split axis must divide
  by the model axis."""
  m, j = mesh.model, mesh.model_index
  out = copy.deepcopy(module)
  heads = [blk.attn.heads for blk in out.trunk.transformers]
  h = heads[0] if heads else None
  if h is not None and h % m:
    raise ValueError(f'tensor parallelism over {m} processes needs a head '
                     f'count it divides, not {h}')
  with torch.no_grad():
    for name, p in list(out.named_parameters()):
      axis = mesh_lib.tp_value_spec(name, p.shape, m, heads=h)
      if axis is None:
        if m > 1 and any(name.endswith(s) for s, _, _ in mesh_lib._TP_TABLE):
          raise ValueError(f'{name} {tuple(p.shape)} does not split over '
                           f'{m} processes')
        continue
      p.data = p.data.chunk(m, dim=axis)[j].clone()
    for blk in out.trunk.transformers:
      blk.attn.heads //= m
      blk.attn.tp_group = blk.ffn.tp_group = mesh.model_group
      if j:       # the row-split layers' biases, added once
        blk.attn.to_out.bias.zero_()
        blk.ffn.down.bias.zero_()
    out.head.tp_group = mesh.model_group
    if j:
      out.head.bias.zero_()
  return out
