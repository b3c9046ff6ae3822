"""One process of the port's parallel-path tests on the CPU (gloo).

  python tests/torch_parallel_worker.py SUITE RANK WORLD STORE_DIR OUT_DIR

joins a gloo group of WORLD processes through a FileStore under
STORE_DIR, runs SUITE ('train', 'value', 'decode' or 'pipe') and writes its
results to OUT_DIR/rank<RANK>.pt; the test files start the processes and
compare. It imports torch and the port only: the parent computes the
JAX references, and reads its inputs from OUT_DIR/inputs.pt.
"""

import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from svdd_tpu_torch.config import tiny_test_config  # noqa: E402
from svdd_tpu_torch.diffusion import Diffusion  # noqa: E402
from svdd_tpu_torch.parallel import mesh as M  # noqa: E402

VALUE_KW = dict(channels=256, n_conv=3, n_transformers=2, n_heads=4)


def _np(x):
  return x.detach().cpu().clone()


# ---------------------------------------------------------------------------
# DP and FSDP pretraining
# ---------------------------------------------------------------------------


def _train_cfg(fsdp=False):
  cfg = tiny_test_config('dna')
  cfg.model.length = 16
  cfg.training.accum_steps = 2
  cfg.optim.warmup_steps = 1
  cfg.parallel.fsdp = fsdp
  cfg.parallel.fsdp_min_size = 64
  return cfg


def _train_run(inp, mesh, fsdp, steps, noise=False, ckpt=None,
               resume=None):
  """``steps`` optimizer steps on the global batches (this process's
  rows on a grid); the losses, parameters and EMA after."""
  from svdd_tpu_torch.train import diffusion as T
  cfg = _train_cfg(fsdp)
  backbone = torch.load(inp['backbone'], weights_only=False)
  model = Diffusion(cfg, device='cpu', backbone=backbone)
  state = T.init_state(model, cfg, mesh=mesh)
  if resume is not None:
    T.restore_checkpoint(resume, state)
  losses = []
  for s in range(state.step, steps):
    batch = {k: v[s] for k, v in inp['batches'].items()}
    if mesh is not None:
      row0, n = mesh.rows(batch['seqs'].shape[0])
      batch = {k: v[row0:row0 + n] for k, v in batch.items()}
    nz = inp['noise'][s] if noise else None
    losses.append(float(T.train_step(state, batch, cfg, nz)))
  if ckpt is not None:
    T.save_checkpoint(ckpt, state)
  res = {'losses': losses,
         'params': {k: _np(p) for k, p in T.model_params(state).items()},
         'ema': {k: _np(v) for k, v in T.ema_shadow(state).items()}}
  if state.sharded is not None:
    res['held'] = _held(state.sharded)
  return res


def _held(sh):
  """Parameter elements a process holds between FSDP steps: the
  module's (its sharded parameters emptied), the parts of the sharded
  ones, the sharded ones whole, and the sharded parameters' gradients
  kept in the module."""
  sharded = set(sh.sharded)
  return {'module': sum(p.numel() for p in sh.module.parameters()),
          'replicated': sum(p.numel() for nm, p in sh.params.items()
                            if nm not in sharded),
          'parts': sum(sh.local[nm].numel() for nm in sharded
                       if nm in sh.local),
          'whole': sum(int(np.prod(sh.shapes[nm])) for nm in sharded),
          'grads': sum(sh.params[nm].grad is not None for nm in sharded)}


def suite_train(rank, world, out):
  inp = torch.load(os.path.join(out, 'inputs.pt'), weights_only=False)
  meshes = {'2x1': M.make_mesh(2, 1, [0, 1]), '4x1': M.make_mesh(4, 1)}
  ck = lambda name: os.path.join(out, name)
  # the single-process runs, spread over the processes: processes 2 and 3
  # run theirs while 0 and 1 run the 2 x 1 grid, and 0 and 1 resume that
  # grid's checkpoints after the 4 x 1 runs
  first = {2: {'world1': dict(steps=2)},
           3: {'world1_jax_noise': dict(steps=2, noise=True)}}
  last = {0: {'resumed_fsdp': dict(steps=3, resume=ck('fsdp2x1'))},
          1: {'world1_3': dict(steps=3),
              'resumed_dp': dict(steps=3, resume=ck('dp2x1'))}}
  res = {key: _train_run(inp, None, False, **kw)
         for key, kw in first.get(rank, {}).items()}
  for name, mesh in meshes.items():
    if mesh is None:
      continue
    M.reset_collectives()
    res[f'dp{name}'] = _train_run(inp, mesh, False, 2,
                                  ckpt=ck(f'dp{name}') if name == '2x1'
                                  else None)
    res[f'dp{name}']['collectives'] = M.collectives()
    res[f'fsdp{name}'] = _train_run(inp, mesh, True, 2,
                                    ckpt=ck(f'fsdp{name}') if name == '2x1'
                                    else None)
  if meshes['2x1'] is not None:
    res['jax_noise_dp2x1'] = _train_run(inp, meshes['2x1'], False, 2,
                                        noise=True)
  # the training grid's clamp of the data axis to a divisor of the batch
  from svdd_tpu_torch.cli import main_gosai
  cfg = _train_cfg()
  cfg.loader.global_batch_size = cfg.loader.eval_global_batch_size = 6
  grid = main_gosai.train_mesh(cfg, 'cpu')
  res['grid_6rows'] = None if grid is None else grid.shape
  for key, kw in last.get(rank, {}).items():
    res[key] = _train_run(inp, None, False, **kw)
  return res


# ---------------------------------------------------------------------------
# Value training
# ---------------------------------------------------------------------------


def _value_setup(cdq=False, fsdp=False, mesh=None, multisep=False):
  from svdd_tpu_torch import rewards
  from svdd_tpu_torch.train import value as V
  from svdd_tpu_torch.value import ValueFunction, build_value_module
  cfg = tiny_test_config('dna')
  cfg.model.length = 16
  cfg.sampling.steps = 4
  diff = Diffusion(cfg, device='cpu')
  reward = rewards.synthetic_motif_oracle(16)
  tcfg = V.ValueTrainerConfig(batch_size=4, cdq=cdq, max_iter=2)
  if multisep:
    from svdd_tpu_torch.models import multisep
    msm = multisep.MultiSepValueModel.create(
        lambda g: build_value_module('dna', 'enformer', 1, g, **VALUE_KW),
        n_models=2, num_steps=4, generator=torch.Generator().manual_seed(3))
    return V.MultiSepTrainer(diff, msm, reward, tcfg, mesh=mesh)
  vf = ValueFunction.create('dna', 16, torch.Generator().manual_seed(3),
                            **VALUE_KW)
  return V.ValueTrainer(diff, vf, reward, tcfg, mesh=mesh, fsdp=fsdp,
                        fsdp_min_size=4096)


def _value_run(mesh, cdq=False, fsdp=False, state_path=None):
  trainer = _value_setup(cdq, fsdp, mesh)
  state = trainer.init_state(7)
  losses = [float(trainer.train_step(state)) for _ in range(2)]
  if state_path is not None:
    trainer.save_state(state_path, state)
  res = {'losses': losses,
         'state': {k: _np(v) for k, v in
                   trainer.state_dict(state)['model'].items()}}
  if state.sharded is not None:
    res['held'] = _held(state.sharded)
  return res


def _same(a, b) -> bool:
  """Whether two nested dicts of tensors and numbers are equal, bit for
  bit."""
  if isinstance(a, dict):
    return (isinstance(b, dict) and list(a) == list(b)
            and all(_same(a[k], b[k]) for k in a))
  if torch.is_tensor(a):
    return torch.is_tensor(b) and torch.equal(a.cpu(), b.cpu())
  return a == b


def _restored_fsdp(mesh, path):
  """Whether an FSDP trainer restored from a saved (whole) trainer state
  gives that state back whole."""
  trainer = _value_setup(cdq=True, fsdp=True, mesh=mesh)
  state = trainer.restore_state(path, 7)
  return _same(trainer.state_dict(state),
               torch.load(path, map_location='cpu', weights_only=True))


def _multisep_run(mesh):
  trainer = _value_setup(multisep=True, mesh=mesh)
  state = trainer.init_state(7)
  losses = [_np(trainer.train_step(state)[1]) for _ in range(2)]
  return {'losses': losses,
          'state': {k: _np(v) for k, v in state.msm.state_dict().items()}}


def _bn_step(mesh, local_stats=False):
  """One value-net grad step's loss, gradients and running statistics on
  the same 8 states; on a grid each process takes its rows, with global
  BatchNorm statistics, or with ``local_stats`` its own rows'."""
  from svdd_tpu_torch.models.blocks import DropoutMasks, sync_batchnorm
  from svdd_tpu_torch.parallel import rows
  from svdd_tpu_torch.value import build_value_module
  module = build_value_module('dna', 'enformer', 1,
                              torch.Generator().manual_seed(3), **VALUE_KW)
  g = torch.Generator().manual_seed(5)
  x = torch.nn.functional.one_hot(torch.randint(0, 4, (8, 16), generator=g),
                                  4).float()
  y = torch.randn(8, generator=g)
  row0, n = (0, 8) if mesh is None else mesh.rows(8)
  if mesh is not None and not local_stats:
    sync_batchnorm(module, mesh.data_group)
  masks = DropoutMasks(generator=torch.Generator().manual_seed(9))
  with rows.global_rows(row0, 8):
    pred = module(x[row0:row0 + n], train=True, masks=masks)
  loss = ((pred - y[row0:row0 + n]) ** 2).sum() / 8
  loss.backward()
  loss = loss.detach()
  if mesh is not None:
    loss = M.sum_gradients_(module.parameters(), mesh.data_group, loss)
  return {'loss': float(loss),
          'grads': {k: _np(p.grad) for k, p in module.named_parameters()},
          'stats': {k: _np(b) for k, b in module.named_buffers()}}


def suite_value(rank, world, out):
  mesh = M.make_mesh()
  res = {'mc': _value_run(mesh), 'cdq': _value_run(mesh, cdq=True),
         'mc_fsdp': _value_run(mesh, fsdp=True),
         'cdq_fsdp': _value_run(mesh, cdq=True, fsdp=True,
                                state_path=os.path.join(out, 'vstate.pt')),
         'multisep': _multisep_run(mesh),
         'restored_fsdp': _restored_fsdp(mesh, os.path.join(out, 'vstate.pt')),
         'bn': _bn_step(mesh), 'bn_local': _bn_step(mesh, local_stats=True)}
  # the single-process runs, half on each process
  res['world1'] = ({'mc': _value_run(None), 'bn': _bn_step(None)} if rank == 0
                   else {'cdq': _value_run(None, True),
                         'multisep': _multisep_run(None)})
  # the CLI: --dist and --dist --fsdp, and a batch that does not divide
  from svdd_tpu_torch.cli import train as cli_train
  cfg = tiny_test_config('dna')
  cfg.model.length = 16
  cfg.sampling.steps = 4
  base = ['--device', 'cpu', '--batch_size', '2', '--max_iters', '1',
          '--eval_every', '1', '--val_batch_num', '0', '--out_dir', out]
  for name, extra in (('cli_dist', ['--dist']),
                      ('cli_fsdp', ['--dist', '--fsdp'])):
    M.reset_collectives()
    r = cli_train.run(cli_train.parser().parse_args(base + extra), cfg=cfg,
                      value_kwargs=VALUE_KW)
    res[name] = {'step': r['state'].step, 'collectives': M.collectives()}
  try:
    cli_train.run(cli_train.parser().parse_args(
        base[:2] + ['--batch_size', '3', '--dist']), cfg=cfg,
        value_kwargs=VALUE_KW)
    res['cli_batch3'] = 'ran'
  except SystemExit as e:
    res['cli_batch3'] = str(e)
  return res


# ---------------------------------------------------------------------------
# Guided decodes
# ---------------------------------------------------------------------------


def _decode_models():
  from svdd_tpu_torch.value import ValueFunction
  cfg = tiny_test_config('dna')
  cfg.model.length = 16
  cfg.sampling.steps = 4
  diff = Diffusion(cfg, device='cpu')
  vf = ValueFunction.create('dna', 16, torch.Generator().manual_seed(3),
                            **VALUE_KW)
  return diff, vf


def _decodes(diff, vf, mesh, tp_vf=None):
  """Every guided decoder at B=8 on the same seed: the samples (and TDS's
  ESS trace)."""
  from svdd_tpu_torch import rewards
  oracle = rewards.synthetic_motif_oracle(16)
  onehot_value = vf.as_onehot_fn()
  run = lambda s: s(torch.Generator().manual_seed(11))
  b = 8
  out = {
      'mc': run(diff.controlled_sampler(vf.score_tokens, b, sample_M=3,
                                        mesh=mesh)).samples,
      'mc_sched': run(diff.controlled_sampler(
          vf.score_tokens, b, m_schedule=((2, 2), (2, 4)),
          mesh=mesh)).samples,
      'pm': run(diff.tweedie_sampler(oracle, b, sample_M=2,
                                     mesh=mesh)).samples,
      'dps': run(diff.dps_sampler(oracle, b, guidance_scale=5.0,
                                  mesh=mesh)).samples,
      'classifier': run(diff.classifier_sampler(
          onehot_value, b, guidance_scale=5.0, mesh=mesh)).samples}
  tds = run(diff.tds_sampler(oracle, b, alpha=0.5, ess_threshold=0.5,
                             mesh=mesh))
  out['tds'], out['tds_ess'] = tds.samples, tds.extra['ess']
  if tp_vf is not None:
    out['mc_tp'] = run(diff.controlled_sampler(
        tp_vf.score_tokens, b, sample_M=3, mesh=mesh, tp=True)).samples
  return {k: _np(v) for k, v in out.items()}


def suite_decode(rank, world, out):
  from svdd_tpu_torch.models.enformer import tp_shard_value_params
  from svdd_tpu_torch.value import ValueFunction
  diff, vf = _decode_models()
  meshes = {'2x1': M.make_mesh(2, 1, [0, 1]), '1x2': M.make_mesh(1, 2, [0, 1]),
            '2x2': M.make_mesh(2, 2), '4x1': M.make_mesh(4, 1)}
  probe = torch.nn.functional.one_hot(
      torch.randint(0, 4, (6, 16), generator=torch.Generator().manual_seed(1)),
      4).float()
  res = {}
  # the single-process decodes on processes 2 and 3, while 0 and 1 run
  # the grids of two
  if rank == 2:
    res['world1'] = _decodes(diff, vf, None)
  if rank == 3:
    with torch.inference_mode():
      res['scores'] = _np(vf.module(probe))
  for name, mesh in meshes.items():
    if mesh is None:
      continue
    tp_vf = None
    if mesh.model > 1:
      tp_vf = ValueFunction(tp_shard_value_params(vf.module, mesh), 16)
      with torch.inference_mode():
        res[f'tp_scores{name}'] = _np(tp_vf.module(probe))
    M.reset_collectives()
    res[name] = _decodes(diff, vf, mesh, tp_vf)
    res[name]['collectives'] = M.collectives()
  return res


# ---------------------------------------------------------------------------
# Pipeline parallelism and sequence-parallel attention
# ---------------------------------------------------------------------------


def _tanh_stage(params, h, c=None):
  for p in params:
    h = h @ p['w'] + p['b'] if 'b' in p else h @ p['w']
    if c is not None:
      h = h + c[:, None, :]
    h = torch.tanh(h)
  return h


def _leaf_blocks(per_block):
  return [{k: torch.as_tensor(v).clone().requires_grad_()
           for k, v in blk.items()} for blk in per_block]


def _pipe_grads(run, blocks, *inputs):
  """The output of ``run(blocks, *inputs)`` and the gradients of
  sum(out ** 2) with respect to the inputs and every block's leaves."""
  inputs = [t.clone().requires_grad_() for t in inputs]
  out = run(blocks, *inputs)
  (out ** 2).sum().backward()
  return {'out': _np(out), 'inputs': [_np(t.grad) for t in inputs],
          'blocks': [{k: _np(v.grad) for k, v in b.items()} for b in blocks]}


def _pipe_generic(inp, mesh, stages):
  """gpipe with conditioning as a per-microbatch argument at each
  microbatch count, and the interleaved schedule at V=2."""
  from svdd_tpu_torch.parallel import pipeline as P
  g = inp['gpipe']
  res = {}
  for m in g['microbatches']:
    blocks = _leaf_blocks(g['blocks'])
    res[f'gpipe_m{m}'] = _pipe_grads(
        lambda bl, x, c: P.gpipe(_tanh_stage, P.stack_stage_params(
            bl, len(bl) // stages), x, (c,), mesh=mesh, num_microbatches=m),
        blocks, g['x'], g['cond'])
  it = inp['interleaved']
  k = len(it['blocks']) // (stages * 2)
  blocks = _leaf_blocks(it['blocks'])
  res['interleaved'] = _pipe_grads(
      lambda bl, x: P.gpipe_interleaved(
          _tanh_stage, P.stack_stage_params_interleaved(bl, k, 2), x,
          mesh=mesh, virtual=2), blocks, it['x'])
  return res


def _pipe_dit(inp, mesh):
  """Real DDiTBlocks through gpipe (c per microbatch, the rotary tables
  broadcast), and ``pipeline_dit_forward`` at M=4 and V=2."""
  from svdd_tpu_torch.models.dit import rotary_cos_sin
  from svdd_tpu_torch.parallel import pipeline as P
  dit = torch.load(inp['dit'], weights_only=False)
  d = inp['dit_inputs']
  cos, sin = rotary_cos_sin(d['h'].shape[1],
                            d['h'].shape[2] // dit.n_heads)
  blocks = list(dit.blocks)
  with torch.no_grad():
    res = {'blocks': _np(P.gpipe(
        P._dit_stage, P.stack_stage_params(blocks, len(blocks) //
                                           mesh.stages),
        d['h'], (d['c'],), (cos, sin), mesh=mesh, num_microbatches=4))}
    for name, kw in (('forward_m4', dict(num_microbatches=4)),
                     ('forward_v2', dict(num_microbatches=0, virtual=2))):
      res[name] = _np(P.pipeline_dit_forward(dit, d['idx'], d['sigma'],
                                             mesh=mesh, **kw))
  return res


def _pipe_cfg(virtual=1, stages=4):
  cfg = tiny_test_config('dna')
  cfg.backbone = 'dit'
  cfg.model.length = 16
  cfg.model.n_blocks = 8
  cfg.model.dropout = 0.0
  cfg.optim.warmup_steps = 0
  cfg.optim.lr = 1e-3
  cfg.parallel.pipeline_stages = stages
  cfg.parallel.pipeline_microbatches = 4
  cfg.parallel.pipeline_virtual = virtual
  return cfg


def _adam(state, name):
  return {k: _np(state.optimizer.adamw.state[p][name])
          for k, p in state.model.backbone.named_parameters()}


def _pipe_train(inp, mesh, virtual):
  """One pipelined step on JAX's uniforms, then the eval step on the
  updated EMA weights: loss, parameters, EMA, Adam's moments, eval sums;
  and the step's collectives."""
  from svdd_tpu_torch.train import diffusion as T
  t = inp['train']
  cfg = _pipe_cfg(virtual)
  model = Diffusion(cfg, device='cpu',
                    backbone=torch.load(t['backbone'], weights_only=False))
  state = T.init_state(model, cfg, mesh=mesh)
  M.reset_collectives()
  loss = float(T.train_step(state, {'seqs': t['seqs']}, cfg, [t['noise']]))
  collectives = M.collectives()
  ema = Diffusion(cfg, device='cpu', backbone=torch.load(
      t['backbone'], weights_only=False))
  with torch.no_grad():
    for k, p in ema.backbone.named_parameters():
      p.copy_(state.ema.shadow[k])
  nll, n = T.eval_step(ema, {'seqs': t['seqs']}, noise=t['eval_noise'],
                       apply_fn=T._pipeline_apply_fn(ema, cfg, mesh))
  return {'loss': loss, 'collectives': collectives,
          'params': {k: _np(p) for k, p in
                     model.backbone.named_parameters()},
          'ema': {k: _np(v) for k, v in state.ema.shadow.items()},
          'mu': _adam(state, 'exp_avg'), 'nu': _adam(state, 'exp_avg_sq'),
          'eval': (float(nll), float(n))}


def _world1_bitwise(inp, mesh):
  """Three steps of the pipelined DiT on a one-stage grid against the
  plain step on the same weights and batches: at M=1 (V=1 and V=2)
  the same ops, so the losses and every parameter, EMA and moment bit for
  bit; at M=4 the largest differences."""
  from svdd_tpu_torch.parallel import pipeline as P
  from svdd_tpu_torch.train import diffusion as T
  t = inp['train']
  cfg = _pipe_cfg(stages=1)

  def run(apply):
    model = Diffusion(cfg, device='cpu', backbone=torch.load(
        t['backbone'], weights_only=False))
    state = T.init_state(model, cfg)
    if apply is not None:
      state.apply_fn = P.pipelined_backbone_apply(model.backbone, mesh=mesh,
                                                  **apply)
    losses = [float(T.train_step(state, {'seqs': t['seqs'][i::2]}, cfg))
              for i in range(2)]
    return losses, {'params': {k: _np(p) for k, p in
                               model.backbone.named_parameters()},
                    'ema': {k: _np(v) for k, v in state.ema.shadow.items()},
                    'mu': _adam(state, 'exp_avg'),
                    'nu': _adam(state, 'exp_avg_sq')}

  plain = run(None)
  res = {}
  for name, apply in (('m1', dict(num_microbatches=1)),
                      ('v2', dict(virtual=2)),
                      ('m4', dict(num_microbatches=4))):
    losses, tree = run(apply)
    res[name] = {'bitwise': losses == plain[0] and _same(tree, plain[1]),
                 'loss_rel': max(abs(a - b) / abs(b)
                                 for a, b in zip(losses, plain[0])),
                 'max_abs': max(float((tree[part][k] - v).abs().max())
                                for part in tree
                                for k, v in plain[1][part].items())}
  return res


def _sp_attention(inp, mesh):
  """sp_mha on this process's sequence block: the output block and the
  input gradients of sum(out * w), causal and not."""
  from svdd_tpu_torch.ops.attention import sp_mha
  a = inp['sp']
  n, idx = mesh.model, mesh.model_index
  blk = a['q'].shape[1] // n
  sl = slice(idx * blk, (idx + 1) * blk)
  res = {}
  for causal in (False, True):
    q, k, v = (a[x][:, sl].clone().requires_grad_() for x in 'qkv')
    out = sp_mha(q, k, v, mesh, axis='model', causal=causal)
    (out * a['w'][:, sl]).sum().backward()
    res[causal] = {'out': _np(out), 'grads': [_np(x.grad) for x in (q, k, v)],
                   'slice': (sl.start, sl.stop)}
  return res


def _permute(mesh):
  """ring_permute of a tensor holding the stage's index, and its
  gradient: what each stage received, and the gradient of its input
  under the loss sum(received * (stage + 1))."""
  t = torch.full((3,), float(mesh.stage), requires_grad=True)
  got = M.ring_permute(t, mesh)
  (got * (mesh.stage + 1)).sum().backward()
  return {'received': _np(got), 'grad': _np(t.grad)}


def _pipe_cli(out, rank):
  """``main_gosai --mode train`` with pipeline_stages=2 over the world of
  four: processes 0 and 1 the stages, 2 and 3 past the grid."""
  from svdd_tpu_torch.cli import main_gosai
  from svdd_tpu_torch.train import diffusion as T
  cfg = _pipe_cfg(stages=2)
  cfg.parallel.pipeline_microbatches = 2
  cfg.eval.val_check_interval = 2
  cfg.checkpointing.every_n_steps = 1000
  ckpt = os.path.join(out, 'pipe_ckpt')
  args = main_gosai.parser().parse_args(
      ['--mode', 'train', '--device', 'cpu', '--max_steps', '2',
       '--ckpt_dir', ckpt, '--log_dir', os.path.join(out, 'pipe_log'),
       '--no_sample_eval', '--data_dir', os.path.join(out, 'no_data')])
  M.reset_collectives()
  r = main_gosai.run(args, cfg)
  state = r['state']
  if state is None:
    return {'past_grid': True}
  return {'mesh': state.mesh.shape, 'stage': state.mesh.stage,
          'step': state.step, 'collectives': M.collectives(),
          'params': {k: _np(p) for k, p in T.model_params(state).items()},
          'ema': {k: _np(v) for k, v in T.ema_shadow(state).items()},
          'mu': _adam(state, 'exp_avg'),
          'ckpt': T.latest_checkpoint(ckpt)}


def suite_pipe(rank, world, out):
  inp = torch.load(os.path.join(out, 'inputs.pt'), weights_only=False)
  pipes = {4: M.make_pipe_mesh(4), 2: M.make_pipe_mesh(2, [0, 1]),
           1: M.make_pipe_mesh(1, [3])}
  grids = {'1x4': M.make_mesh(1, 4), '2x2': M.make_mesh(2, 2)}
  res = {'permute': _permute(pipes[4]),
         'generic4': _pipe_generic(inp, pipes[4], 4),
         'dit4': _pipe_dit(inp, pipes[4])}
  for v in (1, 2):
    res[f'train_v{v}'] = _pipe_train(inp, pipes[4], v)
  for name, grid in grids.items():
    res[f'sp{name}'] = _sp_attention(inp, grid)
  if pipes[2] is not None:
    res['generic2'] = _pipe_generic(inp, pipes[2], 2)
  if pipes[1] is not None:
    res['world1'] = _world1_bitwise(inp, pipes[1])
  res['cli'] = _pipe_cli(out, rank)
  return res


SUITES = {'train': suite_train, 'value': suite_value, 'decode': suite_decode,
          'pipe': suite_pipe}


def start(suite: str, world: int, out: str) -> list:
  """Start SUITE in WORLD processes (this file as a script) with OUT as
  their directory; ``collect`` waits for them."""
  import subprocess
  store = tempfile.mkdtemp(dir=out)
  env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
  env.pop('WORLD_SIZE', None)
  return [subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), suite, str(r), str(world),
       store, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
      text=True, cwd=REPO, env=env) for r in range(world)]


def collect(procs: list, out: str, timeout: float = 240.0) -> list:
  """Each rank's results. A process that fails or outlives ``timeout``
  seconds fails the call (every process is ended)."""
  logs = []
  try:
    for p in procs:
      logs.append(p.communicate(timeout=timeout)[0])
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  for r, (p, log) in enumerate(zip(procs, logs)):
    if p.returncode != 0:
      raise RuntimeError(f'rank {r} exited {p.returncode}:\n{log[-4000:]}')
  return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
          for r in range(len(procs))]


def spawn(suite: str, world: int, out: str, timeout: float = 240.0) -> list:
  """``collect(start(...))``."""
  return collect(start(suite, world, out), out, timeout)


def find(results: list, key: str):
  """The result ``key`` of whichever process ran it."""
  return next(r[key] for r in results if key in r)


def main():
  suite, rank, world, store, out = sys.argv[1:6]
  rank, world = int(rank), int(world)
  torch.set_num_threads(1)
  tempfile.tempdir = out
  M.initialize_multihost(f'file://{os.path.join(store, "store")}', world,
                         rank, device='cpu')
  res = SUITES[suite](rank, world, out)
  torch.distributed.barrier()
  torch.save(res, os.path.join(out, f'rank{rank}.pt'))
  torch.distributed.destroy_process_group()


if __name__ == '__main__':
  np.seterr(all='ignore')
  main()
