"""Pipeline parallelism (``svdd_tpu/parallel/pipeline.py``): the GPipe and
the interleaved schedules over a pipe grid of processes
(``mesh.PipeMesh``), and the DiT's pipelined forward.

A stack of blocks is split into S stages, one a process; the batch into
M microbatches, which stream through the stages, each stage handing its
output to the next by ``mesh.ring_permute``. JAX runs the schedule as one
``lax.scan`` inside a ``shard_map`` and differentiates it; here each
process runs its stage's ticks itself and skips the bubble ticks, whose
stage calls JAX computes and throws away.

Gradients, as JAX's SPMD program gives them: the state is replicated (as
JAX's on its pipe mesh), the inputs of the schedule (the activations,
the per-microbatch arguments such as the DiT's conditioning, the
broadcast ones, and every block's parameters) enter it replicated, and
its output leaves it replicated (the last stage's, broadcast). The
backward runs the ticks in reverse: each stage backpropagates its own
calls (autograd on the graph it recorded in the forward) and hands the
input's cotangent back by the reverse permute; then one all-reduce a
dtype over the grid sums the inputs' and the parameters' cotangents (the
transpose of their replication), so every process holds the whole
gradient of every input and parameter. The output's cotangent is the
same on every process (what follows the schedule is replicated) and is
taken once, on the last stage. A per-microbatch argument is also handed
out again (``gpipe``'s second result in ``_schedule``): the cotangent
that its users after the schedule give it is taken once, on stage 0,
as the seed of the sum of the stages' cotangents, so that at one stage
the sum runs in the order of the unpipelined backward (the later user
first, then the blocks from the last), and the pipelined step equals the
plain step bit for bit where the microbatching leaves the ops alone.

``stage_params`` is a list, one entry a stage, of lists of blocks
(``stack_stage_params``; the interleaved schedule's, one list a chunk,
``stack_stage_params_interleaved``); a block is an ``nn.Module`` or a
dict of tensors. ``stacked_leaves`` lays their leaves out as JAX stacks
them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from svdd_tpu_torch.parallel import mesh as mesh_lib

PIPE_AXIS = mesh_lib.PIPE_AXIS


def stack_stage_params(per_block: list, blocks_per_stage: int) -> list:
  """[L blocks] -> S lists of ``blocks_per_stage`` consecutive blocks
  (JAX's stage-major (S, k, ...) stacking), L = S * k."""
  n, k = len(per_block), blocks_per_stage
  if n % k:
    raise ValueError(f'{n} blocks do not split into stages of {k}')
  return [list(per_block[i:i + k]) for i in range(0, n, k)]


def stack_stage_params_interleaved(per_block: list, blocks_per_chunk: int,
                                   virtual: int) -> list:
  """[L blocks] -> S lists of ``virtual`` chunks for
  ``gpipe_interleaved``: virtual stage j = v * S + d holds blocks
  [j * k, (j + 1) * k), process d's chunk v (JAX's (S, V, k, ...))."""
  n, k = len(per_block), blocks_per_chunk
  if n % (k * virtual):
    raise ValueError(f'{n} blocks do not split into {virtual} chunks of {k}'
                     ' a stage')
  s = n // (k * virtual)
  return [[list(per_block[(v * s + d) * k:(v * s + d + 1) * k])
           for v in range(virtual)] for d in range(s)]


def _leaves(block) -> dict:
  return (dict(block.named_parameters()) if isinstance(block, nn.Module)
          else dict(block))


def stacked_leaves(stacked: list) -> dict:
  """name -> the leaves of a stacking, stacked as JAX lays them out:
  (S, k, ...) for ``stack_stage_params``, (S, V, k, ...) for the
  interleaved one."""
  if not isinstance(stacked, list):
    return _leaves(stacked)
  parts = [stacked_leaves(x) for x in stacked]
  return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


# ---------------------------------------------------------------------------
# The schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Work:
  m: int              # the microbatch
  chunk: int          # the stage's chunk that runs it
  inject: bool        # its input is x's microbatch (else the permute's)
  deposit: bool       # its output is the schedule's


@dataclasses.dataclass(frozen=True)
class _GPipe:
  """GPipe (``pipeline.py:49-124``): M + S - 1 ticks; stage d runs
  microbatch t - d at tick t."""
  s: int
  m: int

  @property
  def ticks(self) -> int:
    return self.m + self.s - 1

  def work(self, t: int, d: int) -> Optional[_Work]:
    m = t - d
    if not 0 <= m < self.m:
      return None
    return _Work(m, 0, d == 0, d == self.s - 1)


@dataclasses.dataclass(frozen=True)
class _Interleaved:
  """The interleaved schedule (``pipeline.py:145-228``): M = S
  microbatches, V * S + S - 1 ticks; at tick t stage d runs microbatch
  (t - d) mod S on its chunk (t - d) // S; every microbatch goes round
  the ring V times."""
  s: int
  v: int

  @property
  def m(self) -> int:
    return self.s

  @property
  def ticks(self) -> int:
    return self.v * self.s + self.s - 1

  def work(self, t: int, d: int) -> Optional[_Work]:
    rel = t - d
    if not 0 <= rel < self.v * self.s:
      return None
    chunk = rel // self.s
    return _Work(rel % self.s, chunk, d == 0 and rel < self.s,
                 d == self.s - 1 and chunk == self.v - 1)


def _params(block) -> list:
  return [p for p in _leaves(block).values() if p.requires_grad]


@dataclasses.dataclass
class _Run:
  """One schedule on this process: its stage's chunks of blocks, the
  arguments' counts, and every block's trained parameters (``params``,
  all stages', the schedule's parameter inputs)."""
  sched: object
  stage_fn: Callable
  chunks: list
  mesh: mesh_lib.PipeMesh
  n_mb: int
  params: list

  def consumed(self, t: int, d: int) -> bool:
    """Whether stage d uses at tick t what the permute of tick t - 1
    brought it."""
    w = self.sched.work(t, d % self.mesh.stages)
    return w is not None and not w.inject

  def forward(self, x, mb_args, bcast, record: bool):
    """The output (every process's copy) and, with ``record``, each
    active tick's (tick, work, graph inputs, output, links)."""
    mesh, sched = self.mesh, self.sched
    d, m_count = mesh.stage, sched.m
    b = x.shape[0]
    if b % m_count:
      raise ValueError(f'batch {b} does not split into {m_count} '
                       'microbatches')
    x_mbs = x.chunk(m_count)
    mb_mbs = [a.chunk(m_count) for a in mb_args]
    carry = (b // m_count,) + tuple(x.shape[1:])
    cdt = x.dtype
    outs, recs, cur = [None] * m_count, [], None
    for t in range(sched.ticks):
      w = sched.work(t, d)
      out = None
      if w is not None:
        inp = x_mbs[w.m] if w.inject else cur
        args = [a[w.m] for a in mb_mbs]
        blocks = self.chunks[w.chunk]
        if record:
          with torch.enable_grad():
            inp = inp.detach().requires_grad_(
                x.requires_grad if w.inject else True)
            args = [a.detach().requires_grad_(o.requires_grad)
                    for a, o in zip(args, mb_args)]
            out = self.stage_fn(blocks, inp, *args, *bcast)
            # created after the stage's ops: in the backward their seeds
            # reach the arguments first
            links = [a.view_as(a) for a in args]
          recs.append((t, w, inp, args, out, links))
        else:
          out = self.stage_fn(blocks, inp, *args, *bcast)
        if out.dtype != cdt or tuple(out.shape) != carry:
          # JAX's scan refuses a carry that changes type, in these words
          raise TypeError(
              'scan body function carry input and carry output must have '
              'equal types, but they differ: the input carry has type '
              f'{cdt}{list(carry)} but the output has type '
              f'{out.dtype}{list(out.shape)}')
        if w.deposit:
          outs[w.m] = out.detach()
      if t < sched.ticks - 1:
        send = (out.detach() if out is not None else
                torch.zeros(carry, dtype=cdt, device=x.device))
        cur = mesh_lib.ring_permute(send, mesh)
    last = mesh.stages - 1
    y = (torch.cat(outs) if d == last else
         torch.empty((b,) + carry[1:], dtype=cdt, device=x.device))
    return mesh_lib.broadcast(y, mesh, last), recs

  def backward(self, recs, x, mb_args, bcast, d_y, d_mb):
    """The cotangents of x, the per-microbatch and broadcast arguments and
    ``params``, summed over the grid (None where an input needs none); x
    and the arguments are ``_Meta``s of the inputs."""
    mesh, sched = self.mesh, self.sched
    d, s, m_count = mesh.stage, mesh.stages, sched.m
    d_outs = (d_y.chunk(m_count) if d == s - 1 and d_y is not None
              else [None] * m_count)
    # the users after the schedule give their cotangents once, on stage 0
    acc = [list(g.chunk(m_count)) if g is not None and d == 0
           else [None] * m_count for g in d_mb]
    d_x = [None] * m_count
    d_bc = [None] * len(bcast)
    own = {id(p): i for i, p in enumerate(self.params)}
    d_p = [None] * len(self.params)
    by_tick = {t: r for t, *r in recs}
    carry = (x.shape[0] // m_count,) + tuple(x.shape[1:])
    g_send = None
    for t in reversed(range(sched.ticks)):
      g_next = None
      if t < sched.ticks - 1:
        back = (g_send if g_send is not None else
                torch.zeros(carry, dtype=x.dtype, device=x.device))
        g_next = mesh_lib.ring_permute(back, mesh, -1)
        if not self.consumed(t + 1, d + 1):
          g_next = None
      g_send = None
      if t not in by_tick:
        continue
      w, inp, args, out, links = by_tick.pop(t)
      g_out = d_outs[w.m] if w.deposit else None
      if g_next is not None:
        g_out = g_next if g_out is None else g_out + g_next
      if g_out is None:
        continue
      outputs, seeds = [out], [g_out]
      for i, link in enumerate(links):
        if acc[i][w.m] is not None:
          outputs.append(link)
          seeds.append(acc[i][w.m])
      blocks = self.chunks[w.chunk]
      ps = [p for blk in blocks for p in _params(blk)]
      wrt = ([inp] if inp.requires_grad else []) + [
          a for a in args if a.requires_grad] + [
              a for a in bcast if a.requires_grad] + ps
      grads = list(torch.autograd.grad(outputs, wrt, seeds,
                                       allow_unused=True))
      if inp.requires_grad:
        g_in = grads.pop(0)
        if w.inject:
          d_x[w.m] = g_in
        else:
          g_send = g_in
      for i, a in enumerate(args):
        if a.requires_grad:
          g = grads.pop(0)
          if g is not None:
            acc[i][w.m] = g
      for i, a in enumerate(bcast):
        if a.requires_grad:
          g = grads.pop(0)
          if g is not None:
            d_bc[i] = g if d_bc[i] is None else d_bc[i] + g
      for p, g in zip(ps, grads):
        if g is not None:
          j = own[id(p)]
          d_p[j] = g if d_p[j] is None else d_p[j] + g

    def whole(parts, like):
      if not like.requires_grad:
        return None
      rows = like.shape[0] // m_count
      parts = [like.zeros((rows,) + like.shape[1:]) if g is None else g
               for g in parts]
      return parts[0] if m_count == 1 else torch.cat(parts)

    out = ([whole(d_x, x)] + [whole(a, o) for a, o in zip(acc, mb_args)]
           + [g if g is not None or not a.requires_grad
              else a.zeros(a.shape) for g, a in zip(d_bc, bcast)]
           + [torch.zeros_like(p) if g is None else g
              for g, p in zip(d_p, self.params)])
    return _sum_over_grid(out, mesh)


def _sum_over_grid(grads: list, mesh) -> list:
  """Each tensor of ``grads`` summed over the grid: one all-reduce of a
  flat buffer a dtype (None entries kept)."""
  by_dtype = {}
  for i, g in enumerate(grads):
    if g is not None:
      by_dtype.setdefault(g.dtype, []).append(i)
  out = list(grads)
  for idx in by_dtype.values():
    flat = torch.cat([grads[i].reshape(-1) for i in idx])
    mesh_lib.all_reduce_(flat, mesh.group)
    for i, piece in zip(idx, torch.split(flat, [grads[i].numel()
                                                for i in idx])):
      out[i] = piece.view_as(grads[i])
  return out


@dataclasses.dataclass(frozen=True)
class _Meta:
  """What the backward needs of an input: its shape, type, device and
  whether it needs a gradient (the tensor itself is not kept)."""
  shape: tuple
  dtype: torch.dtype
  device: torch.device
  requires_grad: bool

  @classmethod
  def of(cls, t: torch.Tensor) -> '_Meta':
    return cls(tuple(t.shape), t.dtype, t.device, t.requires_grad)

  def zeros(self, shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=self.dtype, device=self.device)


class _Schedule(torch.autograd.Function):
  """The schedule as one differentiable function of (x, the
  per-microbatch arguments, the broadcast ones, the blocks' parameters):
  the output and the per-microbatch arguments handed out again."""

  @staticmethod
  def forward(ctx, run, n_bcast, x, *tensors):
    n_mb = run.n_mb
    mb, bcast = tensors[:n_mb], tensors[n_mb:n_mb + n_bcast]
    y, recs = run.forward(x, mb, bcast, record=True)
    ctx.run, ctx.recs = run, recs
    ctx.args = (_Meta.of(x), [_Meta.of(a) for a in mb],
                [_Meta.of(a) for a in bcast])
    ctx.set_materialize_grads(False)
    return (y, *[a.clone() for a in mb])

  @staticmethod
  def backward(ctx, d_y, *d_mb):
    x, mb, bcast = ctx.args
    grads = ctx.run.backward(ctx.recs, x, mb, bcast, d_y, d_mb)
    ctx.recs = ctx.args = None
    return (None, None, *grads)


def _schedule(sched, stage_fn, chunks, x, mb_args, bcast_args, mesh,
              all_blocks) -> tuple:
  """(the output, the per-microbatch arguments handed out again) of the
  schedule on this process, its stages handing on x's type (a stage whose
  output has another type raises JAX's TypeError); differentiable where
  grad mode is on and an input needs a gradient."""
  params = [p for blk in all_blocks for p in _params(blk)]
  run = _Run(sched, stage_fn, chunks, mesh, len(mb_args), params)
  tensors = (x, *mb_args, *bcast_args)
  if not (torch.is_grad_enabled()
          and any(t.requires_grad for t in (*tensors, *params))):
    return (run.forward(x, mb_args, bcast_args, record=False)[0],
            *mb_args)
  return _Schedule.apply(run, len(bcast_args), x, *mb_args, *bcast_args,
                         *params)


def _flat(stage_params: list) -> list:
  out = []
  for x in stage_params:
    out.extend(_flat(x) if isinstance(x, list) else [x])
  return out


def gpipe(stage_fn: Callable, stage_params: list, x: torch.Tensor,
          mb_args: tuple = (), bcast_args: tuple = (), *,
          mesh: mesh_lib.PipeMesh, num_microbatches: int) -> torch.Tensor:
  """x run through the S stages of ``mesh`` (``svdd_tpu/parallel/
  pipeline.py:49``): ``stage_fn(blocks, x_mb, *mb_args_mb, *bcast_args)``
  -> y_mb of x_mb's shape; ``stage_params[d]`` is stage d's list of
  blocks (every process passes every stage's); x (B, ...) is split into
  ``num_microbatches`` microbatches (which must divide B), ``mb_args``
  like x, ``bcast_args`` go whole to every call; the stages hand on x's
  type. Returns (B, ...) on every process; differentiable (module
  docstring)."""
  sched = _GPipe(mesh.stages, num_microbatches)
  return _schedule(sched, stage_fn, [stage_params[mesh.stage]], x,
                   tuple(mb_args), tuple(bcast_args), mesh,
                   _flat(stage_params))[0]


def gpipe_interleaved(stage_fn: Callable, stage_params: list,
                      x: torch.Tensor, mb_args: tuple = (),
                      bcast_args: tuple = (), *, mesh: mesh_lib.PipeMesh,
                      virtual: int) -> torch.Tensor:
  """The interleaved schedule (``svdd_tpu/parallel/pipeline.py:145``):
  ``stage_params[d][v]`` is process d's chunk v
  (``stack_stage_params_interleaved``), the microbatch count the stage
  count, every microbatch round the ring ``virtual`` times; otherwise as
  ``gpipe``."""
  sched = _Interleaved(mesh.stages, virtual)
  return _schedule(sched, stage_fn, stage_params[mesh.stage], x,
                   tuple(mb_args), tuple(bcast_args), mesh,
                   _flat(stage_params))[0]


# ---------------------------------------------------------------------------
# The DiT
# ---------------------------------------------------------------------------


def _dit_stage(blocks, h, c, cos, sin):
  for block in blocks:
    h = block(h, cos, sin, c)
  return h


def pipeline_dit_forward(dit, indices: torch.Tensor, sigma: torch.Tensor, *,
                         mesh: mesh_lib.PipeMesh, num_microbatches: int,
                         virtual: int = 1) -> torch.Tensor:
  """``dit(indices, sigma)`` (eval mode) with its blocks pipelined over
  ``mesh`` (``svdd_tpu/parallel/pipeline.py:231``): ``DIT.forward`` with
  the schedule in place of its block loop, so the embedding, the timestep
  conditioning and the final layer run on every process, and the
  n_blocks ``DDiTBlock``s split into the grid's stages (``virtual`` > 1:
  the interleaved schedule, whose microbatch count is the stage count).
  The stages hand on the compute dtype, as JAX's; a bf16 DiT's blocks
  return f32, and it raises JAX's TypeError."""
  blocks = list(dit.blocks)
  s = mesh.stages
  if len(blocks) % s:
    raise ValueError(f'n_blocks={len(blocks)} does not split into {s} '
                     'stages')
  if virtual > 1:
    sched = _Interleaved(s, virtual)
    chunks = stack_stage_params_interleaved(
        blocks, len(blocks) // (s * virtual), virtual)[mesh.stage]
  else:
    sched = _GPipe(s, num_microbatches)
    chunks = [stack_stage_params(blocks, len(blocks) // s)[mesh.stage]]

  def blocks_fn(x, c, cos, sin):
    return _schedule(sched, _dit_stage, chunks, x, (c,), (cos, sin), mesh,
                     blocks)

  return dit(indices, sigma, blocks_fn=blocks_fn)


def pipelined_backbone_apply(dit, *, mesh: mesh_lib.PipeMesh,
                             num_microbatches: int = 0, virtual: int = 1):
  """The DiT's forward with its blocks pipelined, in place of
  ``dit(x, sigma, ...)`` as ``Diffusion.loss``'s ``apply_fn``
  (``svdd_tpu/parallel/pipeline.py:289``): deterministic (the dropout
  must be 0), for a pipe-only grid; ``num_microbatches <= 0`` means 4 *
  S."""
  s = mesh.stages
  n_blocks = len(dit.blocks)
  if n_blocks % (s * virtual):
    raise ValueError(f'n_blocks={n_blocks} must divide '
                     f'stages*virtual={s}*{virtual}')
  if dit.dropout:
    raise ValueError('pipelined training forward is deterministic; '
                     'set model.dropout=0 to use pipeline_stages>1')
  if num_microbatches <= 0:
    num_microbatches = 4 * s    # (S-1)/(M+S-1) bubble < 20%

  def apply_fn(x, sigma, train=False, generator=None, masks=None):
    del train, generator, masks    # deterministic forward (checked above)
    return pipeline_dit_forward(dit, x, sigma, mesh=mesh,
                                num_microbatches=num_microbatches,
                                virtual=virtual)

  return apply_fn
