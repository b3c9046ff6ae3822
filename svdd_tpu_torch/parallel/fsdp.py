"""FSDP of a module's parameters over the ``data`` axis, with the port's
own collectives: the counterpart of JAX's ``fsdp_shard`` of the
parameters, the optimizer state and the EMA shadow
(``svdd_tpu/train/diffusion.py:250-290``, ``svdd_tpu/train/value.py:
85-150``).

Each leaf takes JAX's rule (``mesh.fsdp_spec``) on its shape in JAX's
layout: a Dense weight is the transpose of the port's (out, in), the
Enformer's relative biases are (1, h, 1, dk), and the Enformer's
transformer blocks, which JAX stacks under ``nn.scan`` when there are
several, are one leaf with a leading layer axis. A leaf of fewer than
``min_size`` elements, or with no axis the data axis divides, is
replicated. A split on the layer axis gives each process whole layers;
any other split gives each process a contiguous chunk of every layer's
parameter along the matching axis of the port's tensor.

Between steps a process holds only its parts (``local``, in the
module's parameter order; the optimizer and the EMA hold their state for
them): the module's sharded parameters are empty tensors, and a
replicated leaf is the module's own parameter, not a copy. ``gathered``
gathers the whole parameters into the module for the span of a forward
and backward (or a read of the whole state) and frees them, and their
gradients, on leaving; ``reduce_grads``, inside it, reduce-scatters the
full gradients onto the parts (and sums the replicated ones), and
``global_norm`` is the norm of the whole gradient. The sharded leaves
travel together, one flat buffer a collective (as XLA combines its
collectives), so a step issues one all-gather and one reduce-scatter
whatever the number of leaves. In a grid of one the parts are the
parameters, and every number is the one the unsharded step computes.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Optional

import torch
from torch import nn

from svdd_tpu_torch.parallel import mesh as M

_STACKED = re.compile(r'^(trunk\.transformers)\.(\d+)\.(.+)$')
_REL = ('rel_content_bias', 'rel_pos_bias')


def _layout(module: nn.Module):
  """{name: (kind, heads)}: 'T' for a Dense weight, 'rel' for a relative
  bias (with its head count), 'same' otherwise."""
  out = {}
  for mname, mod in module.named_modules():
    pre = mname + '.' if mname else ''
    for pname, p in mod.named_parameters(recurse=False):
      kind, heads = 'same', None
      if isinstance(mod, nn.Linear) and pname == 'weight' and p.ndim == 2:
        kind = 'T'
      elif pname in _REL:
        kind, heads = 'rel', mod.heads
      out[pre + pname] = (kind, heads)
  return out


def jax_shape(shape, kind: str, heads: Optional[int]) -> tuple:
  """A port parameter's shape in JAX's layout."""
  shape = tuple(shape)
  if kind == 'T':
    return shape[::-1]
  if kind == 'rel':
    return (1, heads, 1, shape[0] // heads)
  return shape


def _port_axis(jax_axis: int, kind: str, n_data: int) -> int:
  if kind == 'T':
    return 1 - jax_axis
  if kind == 'rel':
    if jax_axis == 1 or n_data == 1:
      return 0      # a block of heads is a contiguous block
    raise NotImplementedError('FSDP of a relative bias along its key axis')
  return jax_axis


def plan(module: nn.Module, n_data: int, min_size: int = 2 ** 14) -> dict:
  """{leaf: (names, JAX-layout shape, JAX axis or None)}, a leaf named by
  its first parameter's name, or by 'trunk.transformers.*.<rest>' for a
  stacked one."""
  layout = _layout(module)
  params = dict(module.named_parameters())
  groups = {}
  for name in params:
    m = _STACKED.match(name)
    key = f'{m.group(1)}.*.{m.group(3)}' if m else name
    groups.setdefault(key, []).append(name)
  out = {}
  for key, names in groups.items():
    kind, heads = layout[names[0]]
    shape = jax_shape(params[names[0]].shape, kind, heads)
    stacked = '*' in key and len(names) > 1
    if stacked:
      shape = (len(names),) + shape
    elif '*' in key:
      key = names[0]
    out[key] = (names, shape, M.fsdp_spec(shape, n_data, min_size))
  return out


class ShardedParams:
  """The FSDP state of ``module``'s parameters over ``mesh.data_group``
  (module docstring)."""

  def __init__(self, module: nn.Module, mesh: M.Mesh,
               min_size: int = 2 ** 14):
    self.module = module
    self.group = mesh.data_group
    self.n = mesh.data
    self.r = mesh.data_index
    layout = _layout(module)
    self.params = dict(module.named_parameters())
    self.spec = {}          # name -> ('rep',) | ('axis', a) | ('owner', key, i)
    self.stacks = {}        # key -> names (whole layers over the processes)
    for key, (names, _, axis) in plan(module, self.n, min_size).items():
      stacked = len(names) > 1
      if axis is None:
        for nm in names:
          self.spec[nm] = ('rep',)
      elif stacked and axis == 0:
        self.stacks[key] = names
        for i, nm in enumerate(names):
          self.spec[nm] = ('owner', key, i)
      else:
        kind = layout[names[0]][0]
        a = _port_axis(axis - (1 if stacked else 0), kind, self.n)
        for nm in names:
          self.spec[nm] = ('axis', a)
    # the sharded leaves in the module's order: (names, split axis of the
    # port's tensor, or None for a stack of whole layers on axis 0, and
    # the stack's key)
    self.leaves, done = [], set()
    for nm in self.params:
      spec = self.spec[nm]
      if spec[0] == 'axis':
        self.leaves.append(([nm], spec[1], None))
      elif spec[0] == 'owner' and spec[1] not in done:
        done.add(spec[1])
        self.leaves.append((self.stacks[spec[1]], None, spec[1]))
    self.sharded = [nm for nm in self.params if self.spec[nm][0] != 'rep']
    self.shapes = {nm: self.params[nm].shape for nm in self.sharded}
    self._depth = 0
    with torch.no_grad():
      self.local = {}
      for nm, p in self.params.items():
        if self.spec[nm][0] == 'rep':
          self.local[nm] = p          # the module's own parameter
          continue
        part = self._part(nm, p.detach())
        if part is not None:
          self.local[nm] = nn.Parameter(part.clone().contiguous())
    self._release()

  def _owned(self, key: str, i: int) -> bool:
    per = len(self.stacks[key]) // self.n
    return self.r * per <= i < (self.r + 1) * per

  def _part(self, name: str, full: torch.Tensor) -> Optional[torch.Tensor]:
    """This process's part of a full tensor of parameter ``name``."""
    spec = self.spec[name]
    if spec[0] == 'rep':
      return full
    if spec[0] == 'owner':
      return full if self._owned(spec[1], spec[2]) else None
    return full.chunk(self.n, dim=spec[1])[self.r]

  def shard(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This process's parts of a full per-parameter mapping (no
    collective)."""
    out = {}
    for nm, t in full.items():
      part = self._part(nm, t)
      if part is not None:
        out[nm] = part.clone().contiguous()
    return out

  def _mine(self, leaf, parts) -> torch.Tensor:
    """A leaf's part of a mapping of this process's parts, split axis
    first: its chunk of the parameter, or its owned layers stacked."""
    names, axis, key = leaf
    if axis is not None:
      return parts[names[0]].movedim(axis, 0)
    return torch.stack([parts[nm] for i, nm in enumerate(names)
                        if self._owned(key, i)])

  def full(self, parts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The whole tensors of a per-parameter mapping of this process's
    parts (the parameters, a moment, the EMA shadow), in the module's
    parameter order, the sharded leaves in one all-gather; every process
    calls it."""
    out = {nm: parts[nm] for nm in self.params if self.spec[nm][0] == 'rep'}
    if self.leaves:
      mine = [self._mine(leaf, parts) for leaf in self.leaves]
      every = M.all_gather(torch.cat([m.reshape(-1) for m in mine]),
                           self.group).view(self.n, -1)
      off = 0
      for (names, axis, _), m in zip(self.leaves, mine):
        whole = every[:, off:off + m.numel()].reshape(
            (self.n * m.shape[0],) + tuple(m.shape[1:]))
        off += m.numel()
        if axis is None:
          out.update(zip(names, whole))
        else:
          out[names[0]] = whole.movedim(0, axis)
    return {nm: out[nm] for nm in self.params}

  def _release(self) -> None:
    """Free the module's sharded parameters and their gradients."""
    for nm in self.sharded:
      p = self.params[nm]
      p.grad = None
      p.data = p.data.new_empty(0)

  def _gather(self) -> None:
    """The module's sharded parameters, whole, from the parts (one
    all-gather)."""
    with torch.inference_mode(False), torch.no_grad():
      full = self.full({nm: t.detach() for nm, t in self.local.items()})
      bufs = [torch.empty(self.shapes[nm], dtype=full[nm].dtype,
                          device=full[nm].device) for nm in self.sharded]
      torch._foreach_copy_(bufs, [full[nm] for nm in self.sharded])
    for nm, buf in zip(self.sharded, bufs):
      self.params[nm].data = buf

  @contextlib.contextmanager
  def gathered(self):
    """Inside, the module holds its whole parameters, gathered on entry
    (every process enters together); on leaving, its sharded parameters
    and their gradients are freed. Nested blocks gather once."""
    if self._depth == 0 and self.sharded:
      self._gather()
    self._depth += 1
    try:
      yield self.module
    finally:
      self._depth -= 1
      if self._depth == 0:
        self._release()

  def state_dict(self) -> dict:
    """The module's whole ``state_dict()`` (a collective)."""
    with self.gathered():
      return self.module.state_dict()

  @torch.no_grad()
  def load_state_dict(self, state: dict) -> None:
    """Load a whole ``module.state_dict()``: the buffers and the
    replicated parameters into the module, this process's parts of the
    others into ``local`` (a collective)."""
    with self.gathered():
      self.module.load_state_dict(state)
      parts = self.shard({nm: self.params[nm] for nm in self.sharded})
      for nm, part in parts.items():
        self.local[nm].copy_(part)

  @torch.no_grad()
  def reduce_grads(self, extra: Optional[torch.Tensor] = None):
    """Inside ``gathered``: sum the module's full gradients over the data
    axis onto the parts' ``.grad``: the replicated ones in place, with
    ``extra`` packed alongside, in one all-reduce, the sharded leaves in
    one reduce-scatter; returns the summed ``extra``."""
    rep = [self.params[nm] for nm in self.params
           if self.spec[nm][0] == 'rep']
    total = M.sum_gradients_(rep, self.group, extra)
    if not self.leaves:
      return total
    grads = {nm: p.grad for nm, p in self.params.items()}
    chunks = []
    for names, axis, _ in self.leaves:
      whole = (grads[names[0]].movedim(axis, 0) if axis is not None
               else torch.stack([grads[nm] for nm in names]))
      chunks.append(whole.reshape(self.n, -1))     # row r: rank r's chunk
    mine = M.reduce_scatter(torch.cat(chunks, dim=1).reshape(-1), self.group)
    off = 0
    for leaf in self.leaves:
      names, axis, key = leaf
      shape = self._mine(leaf, self.local).shape
      seg = mine[off:off + shape.numel()].view(shape)
      off += shape.numel()
      if axis is not None:
        self.local[names[0]].grad = seg.movedim(0, axis).contiguous()
      else:
        owned = [nm for i, nm in enumerate(names) if self._owned(key, i)]
        for nm, g in zip(owned, seg):
          self.local[nm].grad = g
    return total

  @torch.no_grad()
  def global_norm(self) -> torch.Tensor:
    """The norm of the whole gradient from the parts' ``.grad``: each
    parameter's norm (its one holder's, or the norm of its chunks'
    norms), then the norm of those, as the unsharded clip takes it."""
    names = list(self.params)
    local = [nm for nm in names if nm in self.local]
    norms = torch._foreach_norm([self.local[nm].grad for nm in local])
    dev = norms[0].device
    vec = torch.zeros(len(names), dtype=norms[0].dtype, device=dev)
    idx = torch.tensor([names.index(nm) for nm in local], device=dev)
    vec[idx] = torch.stack(norms)
    table = M.all_gather(vec[None], self.group)        # (n, params)
    per = []
    for j, nm in enumerate(names):
      spec = self.spec[nm]
      if spec[0] == 'rep':
        per.append(table[self.r, j])
      elif spec[0] == 'owner':
        per.append(table[spec[2] // (len(self.stacks[spec[1]]) // self.n),
                         j])
      elif self.n == 1:
        per.append(table[0, j])
      else:
        per.append(torch.linalg.vector_norm(table[:, j]))
    return torch.linalg.vector_norm(torch.stack(per))

  def full_optimizer_state(self, state: dict) -> dict:
    """The unsharded ``Optimizer.state_dict()`` (keyed by the module's
    parameter order) of this process's sharded one; every process calls
    it."""
    adamw = state['adamw']
    local = list(self.local)
    names = list(self.params)
    out_state = {}
    if adamw['state']:
      slots = sorted({k for s in adamw['state'].values() for k in s
                      if k != 'step'})   # one order in every process
      step = next(iter(adamw['state'].values()))['step']
      full = {k: self.full({nm: adamw['state'][i][k]
                            for i, nm in enumerate(local)}) for k in slots}
      for j, nm in enumerate(names):
        out_state[j] = {'step': step.clone(),
                        **{k: full[k][nm] for k in slots}}
    groups = [dict(g, params=list(range(len(names))))
              for g in adamw['param_groups']]
    return {'adamw': {'state': out_state, 'param_groups': groups},
            'count': state['count']}

  def shard_optimizer_state(self, state: dict) -> dict:
    """This process's sharded ``Optimizer.state_dict()`` of an unsharded
    one (``full_optimizer_state``'s inverse; no collective)."""
    adamw = state['adamw']
    names = list(self.params)
    local = list(self.local)
    out_state = {}
    if adamw['state']:
      slots = sorted({k for s in adamw['state'].values() for k in s
                      if k != 'step'})   # one order in every process
      parts = {k: self.shard({nm: adamw['state'][j][k]
                              for j, nm in enumerate(names)}) for k in slots}
      step = next(iter(adamw['state'].values()))['step']
      for i, nm in enumerate(local):
        out_state[i] = {'step': step.clone(),
                        **{k: parts[k][nm] for k in slots}}
    groups = [dict(g, params=list(range(len(local))))
              for g in adamw['param_groups']]
    return {'adamw': {'state': out_state, 'param_groups': groups},
            'count': state['count']}


def gathered(sharded: Optional[ShardedParams]):
  """``sharded.gathered()``; without FSDP the module is whole already."""
  return contextlib.nullcontext() if sharded is None else sharded.gathered()
