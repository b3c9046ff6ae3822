"""The process grid of the parallel paths (``svdd_tpu/parallel/mesh.py``)
on ``torch.distributed``: one process a device, the processes laid out
as a (data, model) grid with ``model`` innermost, as JAX lays out its
device mesh.

JAX runs one program over a device mesh and GSPMD inserts the
collectives; here each process runs its share and calls them itself:

  data parallel         the batch's rows over ``data``; the gradients
                        summed over it (``all_reduce``);
  FSDP                  parameters, AdamW moments and the EMA shadow as
                        shards over ``data`` (``fsdp_spec``; ``parallel/
                        fsdp.py``), gathered after each update, the
                        gradients reduce-scattered;
  candidate sharding    the folded B*M candidate rows of a guided step
                        over every process (``candidate_rows``), the
                        (B/d, M) scores gathered over ``model``;
  tensor parallel       the Enformer value net's transformer stack and
                        head split Megatron-style over ``model``
                        (``tp_value_spec``, ``models.enformer.
                        tp_shard_value_params``): one all-reduce after
                        each attention, each FFN and the head;
  sequence parallel     attention's keys and values gathered along the
                        sequence over an axis (``all_gather_grad``,
                        ``ops.attention.sp_mha``);
  pipeline              the DiT's blocks split into stages over a
                        ``pipe`` grid of its own (``make_pipe_mesh``,
                        ``parallel/pipeline.py``): activations handed on
                        by ``ring_permute``, the last stage's output
                        replicated by ``broadcast``.

A world of one process is a grid of one, and its collectives are still
issued. ``COLLECTIVES`` counts the collectives issued through this
module, by kind, so a run can show that it took the parallel path.

The process group comes from ``initialize_multihost``: torchrun's
environment (or an explicit ``init_method``), NCCL for CUDA and gloo for
the CPU. NCCL does not put two processes on one device, so on one card
the grid is 1 x 1; the CPU runs any grid under gloo.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
PIPE_AXIS = 'pipe'

COLLECTIVES: collections.Counter = collections.Counter()


def reset_collectives() -> None:
  COLLECTIVES.clear()


def collectives() -> dict:
  """The collectives issued since the last reset, by kind."""
  return dict(COLLECTIVES)


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         device: str = 'cuda') -> bool:
  """Join the process group (``svdd_tpu/parallel/mesh.py:213``): NCCL
  for ``device='cuda'`` (each process on the card of its LOCAL_RANK),
  gloo for the CPU. The arguments, or torchrun's environment (WORLD_SIZE,
  RANK, MASTER_ADDR, MASTER_PORT), say where; with neither the process
  is a world of one with no group, and this returns False. An explicit
  request that cannot join raises. Already joined: True."""
  if dist.is_initialized():
    return True
  explicit = (init_method is not None or world_size is not None
              or rank is not None)
  if not explicit and 'WORLD_SIZE' not in os.environ:
    return False
  world_size = int(os.environ['WORLD_SIZE'] if world_size is None
                   else world_size)
  rank = int(os.environ.get('RANK', 0) if rank is None else rank)
  backend = 'gloo'
  if torch.device(device).type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError('initialize_multihost: NCCL needs a card, and '
                         'torch sees none')
    torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    backend = 'nccl'
  dist.init_process_group(backend, init_method=init_method or 'env://',
                          world_size=world_size, rank=rank)
  return True


@dataclasses.dataclass(frozen=True)
class Mesh:
  """This process's place in a (data, model) grid of processes. ``rank``
  is its index in ``ranks`` (the grid's global ranks, row-major), the
  data index ``rank // model``, the model index ``rank % model``.
  ``group`` holds the grid, ``data_group`` the processes of this one's
  model index (they hold different rows), ``model_group`` those of its
  data index (they hold the same rows)."""
  data: int
  model: int
  rank: int
  ranks: tuple
  group: object
  data_group: object
  model_group: object

  @property
  def data_index(self) -> int:
    return self.rank // self.model

  @property
  def model_index(self) -> int:
    return self.rank % self.model

  @property
  def shape(self) -> dict:
    return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

  def rows(self, total: int) -> tuple:
    """(row0, n): this process's block of ``total`` rows split over
    ``data``; ``total`` must divide."""
    if total % self.data:
      raise ValueError(f'{total} rows do not split over the {self.data} '
                       "processes of the 'data' axis")
    n = total // self.data
    return self.data_index * n, n


def make_mesh(data: int = -1, model: int = 1,
              ranks: Optional[list] = None) -> Optional[Mesh]:
  """A (data, model) grid over ``ranks`` (every process by default;
  ``svdd_tpu/parallel/mesh.py:36``); data=-1 takes what the model axis
  leaves. Every process of the group calls it (the sub-groups are made
  collectively); a process outside ``ranks`` gets None."""
  if not dist.is_initialized():
    raise RuntimeError('make_mesh: no process group (initialize_multihost)')
  ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
  n = len(ranks)
  if data == -1:
    if n % model:
      raise ValueError(f'{n} processes not divisible by model={model}')
    data = n // model
  if data * model != n:
    raise ValueError(f'mesh {data}x{model} != {n} processes')
  me = dist.get_rank()
  group = dist.new_group(ranks)
  data_groups = [dist.new_group(ranks[j::model]) for j in range(model)]
  model_groups = [dist.new_group(ranks[d * model:(d + 1) * model])
                  for d in range(data)]
  if me not in ranks:
    return None
  r = ranks.index(me)
  return Mesh(data, model, r, tuple(ranks), group, data_groups[r % model],
              model_groups[r // model])


@dataclasses.dataclass(frozen=True)
class PipeMesh:
  """This process's place in a pipe-only grid of ``stages`` processes,
  JAX's ``Mesh(devices[:s], ('pipe',))`` (``svdd_tpu/cli/main_gosai.py:117``):
  ``rank`` is its stage index, the index of its global rank in ``ranks``;
  ``group`` holds the stages."""
  stages: int
  rank: int
  ranks: tuple
  group: object

  @property
  def stage(self) -> int:
    return self.rank

  @property
  def shape(self) -> dict:
    return {PIPE_AXIS: self.stages}


def make_pipe_mesh(stages: int, ranks: Optional[list] = None
                   ) -> Optional[PipeMesh]:
  """A pipe grid of ``stages`` processes over ``ranks`` (the first
  ``stages`` processes by default). Every process of the group calls it;
  a process outside ``ranks`` gets None."""
  if not dist.is_initialized():
    raise RuntimeError('make_pipe_mesh: no process group '
                       '(initialize_multihost)')
  ranks = list(range(stages) if ranks is None else ranks)
  if len(ranks) != stages:
    raise ValueError(f'a pipe grid of {stages} stages over {len(ranks)} '
                     'processes')
  group = dist.new_group(ranks)
  me = dist.get_rank()
  if me not in ranks:
    return None
  return PipeMesh(stages, ranks.index(me), tuple(ranks), group)


def local_shard_info(mesh=None) -> tuple:
  """(num_shards, shard_index) of the data iterator
  (``svdd_tpu/parallel/mesh.py:207``): one shard a data index (the
  processes of a model group read the same rows); (1, 0) without a
  grid, and on a pipe grid, whose every stage reads the whole batch."""
  if mesh is None or DATA_AXIS not in mesh.shape:
    return 1, 0
  return mesh.data, mesh.data_index


# ---------------------------------------------------------------------------
# Collectives, counted
# ---------------------------------------------------------------------------


def _group_size(group) -> int:
  return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
  """Sum (or ``op``) ``t`` over ``group`` in place; returns it."""
  COLLECTIVES['all_reduce'] += 1
  dist.all_reduce(t, op=op, group=group)
  return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
  """The group's tensors concatenated along ``dim`` in rank order."""
  COLLECTIVES['all_gather'] += 1
  t = t.contiguous()
  parts = [torch.empty_like(t) for _ in range(_group_size(group))]
  dist.all_gather(parts, t, group=group)
  return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
  """This rank's chunk (along axis 0) of the group's sum of ``t``."""
  COLLECTIVES['reduce_scatter'] += 1
  n = _group_size(group)
  if t.shape[0] % n:
    raise ValueError(f'reduce_scatter: {tuple(t.shape)} does not split {n} '
                     'ways')
  out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype,
                    device=t.device)
  dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
  return out


class _AllReduceSum(torch.autograd.Function):
  """The group's sum with a gradient: the backward sums the gradients
  over the group, since every rank's loss reads the sum."""

  @staticmethod
  def forward(ctx, t, group):
    ctx.group = group
    return all_reduce_(t.clone(), group)

  @staticmethod
  def backward(ctx, grad):
    return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
  """The sum of ``t`` over ``group``, differentiable."""
  return _AllReduceSum.apply(t, group)


class _AllGatherGrad(torch.autograd.Function):
  """The group's tensors concatenated along ``dim`` with a gradient: the
  backward reduce-scatters, each rank keeping the summed gradient of its
  own block (JAX's transpose of a tiled ``all_gather``)."""

  @staticmethod
  def forward(ctx, t, group, dim):
    ctx.group, ctx.dim = group, dim
    return all_gather(t, group, dim)

  @staticmethod
  def backward(ctx, grad):
    n = _group_size(ctx.group)
    parts = torch.stack(grad.chunk(n, ctx.dim))
    return reduce_scatter(parts, ctx.group)[0], None, None


def all_gather_grad(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
  """``all_gather`` along ``dim``, differentiable."""
  return _AllGatherGrad.apply(t, group, dim)


def broadcast(t: torch.Tensor, mesh: PipeMesh, stage: int) -> torch.Tensor:
  """``t`` as the process of ``stage`` holds it, on every process of the
  pipe grid (in place; returns it)."""
  COLLECTIVES['broadcast'] += 1
  dist.broadcast(t, src=mesh.ranks[stage], group=mesh.group)
  return t


def _permute(t: torch.Tensor, mesh: PipeMesh, shift: int) -> torch.Tensor:
  """What the stage ``shift`` places before this one holds of ``t``."""
  COLLECTIVES['permute'] += 1
  s = mesh.stages
  if s == 1:
    return t.clone()
  t = t.contiguous()
  out = torch.empty_like(t)
  ops = [dist.P2POp(dist.isend, t, mesh.ranks[(mesh.rank + shift) % s],
                    mesh.group),
         dist.P2POp(dist.irecv, out, mesh.ranks[(mesh.rank - shift) % s],
                    mesh.group)]
  for req in dist.batch_isend_irecv(ops):
    req.wait()
  return out


class _RingPermute(torch.autograd.Function):

  @staticmethod
  def forward(ctx, t, mesh, shift):
    ctx.mesh, ctx.shift = mesh, shift
    return _permute(t, mesh, shift)

  @staticmethod
  def backward(ctx, grad):
    return _permute(grad, ctx.mesh, -ctx.shift), None, None


def ring_permute(t: torch.Tensor, mesh: PipeMesh,
                 shift: int = 1) -> torch.Tensor:
  """JAX's ``lax.ppermute`` over the pipe ring: stage i sends ``t`` to
  stage (i + shift) mod S and returns what stage (i - shift) mod S sent
  (every stage calls it with a tensor of one shape and type). One send
  and one receive in a ``batch_isend_irecv``, which neither gloo nor NCCL
  can deadlock. Differentiable: the backward is the reverse permute. At
  one stage the permute maps the stage to itself and is a copy (no
  send: a process does not send to itself), counted all the same."""
  return _RingPermute.apply(t, mesh, shift)


def sum_gradients_(params, group, extra: Optional[torch.Tensor] = None):
  """Sum the ``.grad`` of ``params`` (every parameter with one) over
  ``group`` in one collective, with ``extra`` (a small tensor, e.g. the
  loss) packed alongside; returns the summed ``extra``."""
  grads = [p.grad for p in params if p.grad is not None]
  parts = [g.reshape(-1) for g in grads]
  if extra is not None:
    parts.append(extra.reshape(-1).to(grads[0].dtype if grads
                                      else extra.dtype))
  flat = all_reduce_(torch.cat(parts), group)
  sizes = [g.numel() for g in grads]
  pieces = torch.split(flat, sizes + [flat.numel() - sum(sizes)])
  with torch.no_grad():
    torch._foreach_copy_(grads, [p.view_as(g) for p, g in zip(pieces, grads)])
  if extra is None:
    return None
  return pieces[-1].view_as(extra).to(extra.dtype)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def fsdp_spec(shape, n_data: int, min_size: int = 2 ** 14) -> Optional[int]:
  """JAX's FSDP rule (``svdd_tpu/parallel/mesh.py:70``) on a leaf's shape
  in JAX's layout: the first axis that ``n_data`` divides, for leaves of
  at least ``min_size`` elements; None (replicated) otherwise."""
  shape = tuple(shape)
  size = 1
  for d in shape:
    size *= d
  if not shape or size < min_size:
    return None
  for i, d in enumerate(shape):
    if d % n_data == 0:
      return i
  return None


def candidate_rows(mesh: Mesh, n: int) -> slice:
  """This process's rows of a data block's ``n`` folded candidate rows:
  the B*M rows split over every process (JAX's ``candidate_sharding``,
  ``mesh.py:114``, P(('data', 'model'))): a data block's rows over its
  model group."""
  if n % mesh.model:
    raise ValueError(f'{n} candidate rows do not split over the '
                     f"{mesh.model} processes of the 'model' axis")
  k = n // mesh.model
  return slice(mesh.model_index * k, (mesh.model_index + 1) * k)


# JAX's Megatron table (``mesh.py:135``) on the port's parameter names:
# (name suffix, the JAX rule, the port's axis). A Dense weight is (out,
# in), the transpose of flax's (in, out) kernel, so JAX's column (its
# last axis) is the port's axis 0 and its row (axis -2) the port's 1;
# conv kernels keep flax's (K, Cin, Cout) layout; the relative biases
# (h * dk) are flax's (1, h, 1, dk) split on h, a contiguous block of
# heads.
_TP_TABLE = (
    ('attn.to_q.weight', 'col', 0), ('attn.to_k.weight', 'col', 0),
    ('attn.to_v.weight', 'col', 0), ('attn.to_rel_k.weight', 'col', 0),
    ('attn.to_out.weight', 'row', 1),
    ('ffn.up.weight', 'col', 0), ('ffn.up.bias', 'col', 0),
    ('ffn.down.weight', 'row', 1),
    ('trunk.pointwise.kernel', 'col', -1), ('trunk.pointwise.bias', 'col', 0),
    ('head.kernel', 'row', -2),
    ('attn.rel_content_bias', 'heads', 0), ('attn.rel_pos_bias', 'heads', 0),
)


def tp_value_spec(name: str, shape, n_model: int,
                  heads: Optional[int] = None) -> Optional[int]:
  """The axis of the port's Enformer value-net parameter ``name`` that
  tensor parallelism splits over ``n_model`` processes, or None
  (replicated): JAX's ``tp_value_spec`` mapped onto the port's names and
  layouts, with its divisibility rule (a split axis that ``n_model`` does
  not divide, or for the relative biases a head count it does not,
  replicates). ``heads``: the attention's head count."""
  shape = tuple(shape)
  if n_model <= 1 or not shape:
    return None
  for suffix, rule, axis in _TP_TABLE:
    if name == suffix or name.endswith('.' + suffix):
      if rule == 'heads':
        return 0 if heads is not None and heads % n_model == 0 else None
      axis %= len(shape)
      return axis if shape[axis] % n_model == 0 else None
  return None


# ---------------------------------------------------------------------------
# A batch's rows over the grid, for the samplers
# ---------------------------------------------------------------------------


class RowShard:
  """A sampler's batch of ``total`` rows over ``mesh``: this process
  holds rows [row0, row0 + local) (its data index), and with ``tp`` the
  value net is split over ``model`` so the candidates stay whole on each
  model rank."""

  def __init__(self, mesh: Mesh, total: int, tp: bool = False):
    self.mesh = mesh
    self.total = total
    self.row0, self.local = mesh.rows(total)
    self.tp = tp

  def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global tensor of the data blocks along ``dim``."""
    return all_gather(t, self.mesh.data_group, dim)

  def candidates(self, n: int) -> slice:
    """This process's rows of the block's ``n`` folded candidates: every
    row under ``tp``, else its model rank's share."""
    if self.tp:
      return slice(0, n)
    return candidate_rows(self.mesh, n)

  def scores(self, local: torch.Tensor) -> torch.Tensor:
    """The block's scores from this process's (its ``candidates``):
    gathered over ``model``; under ``tp`` every model rank has them
    all."""
    if self.tp:
      return local
    return all_gather(local, self.mesh.model_group)

  def score_rows(self, fn, flat: torch.Tensor) -> torch.Tensor:
    """``fn`` on this process's share of the block's flat rows, the
    results gathered back to the block's (n,) scores."""
    return self.scores(fn(flat[self.candidates(flat.shape[0])]))
