"""The port's pipeline parallelism and sequence-parallel attention
(``svdd_tpu_torch/parallel/pipeline.py``, ``ops/attention.sp_mha``)
against the JAX package's (``svdd_tpu/parallel/pipeline.py``,
``tests/test_parallel.py:244-540``).

One module fixture starts four gloo processes on the CPU
(``torch_parallel_worker.py``, suite 'pipe'): pipe grids of four
processes, of two (processes 0 and 1) and of one (process 3), and
(data, model) grids of 1 x 4 and 2 x 2 for ``sp_mha``; then
``main_gosai --mode train`` with ``pipeline_stages=2``. JAX runs the same
functions on its virtual CPU devices in this process while they do.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models.dit import DDiTBlock as JaxDDiTBlock
from svdd_tpu.models.dit import rotary_cos_sin as jax_rotary
from svdd_tpu.ops.attention import mha as jax_mha
from svdd_tpu.parallel import pipeline as JP
from svdd_tpu.train import diffusion as jtrain

from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.parallel import mesh as M
from svdd_tpu_torch.parallel import pipeline as P
from svdd_tpu_torch.train import diffusion as train_diff
from svdd_tpu_torch.weights import dit_from_jax
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import random_variables
import torch_parallel_worker as W

N, L = 8, 16                        # the DiT's batch and length
GP_BLOCKS, GP_D, GP_B = 8, 8, 24     # the generic gpipe stack
MICROBATCHES = (1, 4, 8)            # M = 1, M = S, M > S at four stages
TOL = dict(rtol=1e-5, atol=1e-5)    # JAX's gpipe tests' forward tolerance
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
  return torch.from_numpy(np.array(a))


def _pipe_mesh(s):
  return JaxMesh(np.asarray(jax.devices()[:s]), ('pipe',))


def _dit_cfgs(virtual=1, stages=4):
  """(port, JAX) tiny DiT configs of the pipelined step: 8 blocks,
  dropout 0, f32, a warmup-free AdamW at 1e-3."""
  cfgs = W._pipe_cfg(virtual, stages), jax_tiny_config('dna')
  jc = cfgs[1]
  jc.backbone = 'dit'
  jc.model.length = L
  jc.model.n_blocks = 8
  jc.model.dropout = 0.0
  jc.optim.warmup_steps = 0
  jc.optim.lr = 1e-3
  jc.parallel.pipeline_stages = stages
  jc.parallel.pipeline_microbatches = 4
  jc.parallel.pipeline_virtual = virtual
  return cfgs


def _loss_uniforms(key, n, length):
  kt, kq = jax.random.split(key)
  return (_t(jax.random.uniform(kt, (n,))),
          _t(jax.random.uniform(kq, (n, length))))


def _tanh_stage(params_k, h, c=None):
  def block(h, p):
    h = h @ p['w'] + p['b'] if 'b' in p else h @ p['w']
    if c is not None:
      h = h + c[:, None, :]
    return jnp.tanh(h), None
  return jax.lax.scan(block, h, params_k)[0]


def _jax_generic(inputs, stages):
  """JAX's gpipe (at each microbatch count) and gpipe_interleaved: the
  outputs and the gradients of sum(out ** 2) with respect to the inputs
  and the stacked parameters; the sequential stack's beside them."""
  g = inputs['gpipe']
  blocks = [{k: jnp.asarray(v) for k, v in b.items()} for b in g['blocks']]
  x, c = jnp.asarray(g['x']), jnp.asarray(g['cond'])
  mesh = _pipe_mesh(stages)
  out = {}
  k = GP_BLOCKS // stages
  for m in MICROBATCHES:
    def loss(sp, x, c, m=m):
      y = JP.gpipe(_tanh_stage, sp, x, mb_args=(c,), mesh=mesh,
                   num_microbatches=m)
      return (y ** 2).sum(), y
    (_, y), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            JP.stack_stage_params(blocks, k), x, c)
    out[f'gpipe_m{m}'] = (y, grads)

  def seq(bl, x, c):
    h = x
    for p in bl:
      h = jnp.tanh(h @ p['w'] + p['b'] + c[:, None, :])
    return (h ** 2).sum(), h
  (_, y), grads = jax.value_and_grad(seq, argnums=(0, 1, 2),
                                     has_aux=True)(blocks, x, c)
  out['sequential'] = (y, grads)
  it = inputs['interleaved']
  ws = [{'w': jnp.asarray(b['w'])} for b in it['blocks']]
  xi = jnp.asarray(it['x'])
  kc = GP_BLOCKS // (stages * 2)

  def iloss(sp, x):
    y = JP.gpipe_interleaved(_tanh_stage, sp, x, mesh=mesh, virtual=2)
    return (y ** 2).sum(), y
  (_, y), grads = jax.jit(jax.value_and_grad(
      iloss, argnums=(0, 1), has_aux=True))(
          JP.stack_stage_params_interleaved(ws, kc, 2), xi)
  out['interleaved'] = (y, grads)
  return out


def _jax_dit(variables, jcfg, d):
  """JAX's sequential DDiTBlock stack on (h, c), and its pipelined DiT
  forward at M=4 and V=2 beside ``dit.apply``."""
  from svdd_tpu.models.dit import DIT
  p = variables['params']
  m = jcfg.model
  blk = JaxDDiTBlock(m.hidden_size, m.n_heads, m.cond_dim, dropout=0.0)
  cos, sin = jax_rotary(L, m.hidden_size // m.n_heads)
  h, c = jnp.asarray(d['h']), jnp.asarray(d['c'])
  for i in range(m.n_blocks):
    h = blk.apply({'params': p[f'block_{i}']}, h, cos, sin, c)
  dit = DIT(jcfg, vocab_size=5, compute_dtype=jnp.float32)
  idx, sigma = jnp.asarray(d['idx']), jnp.asarray(d['sigma'])
  mesh = _pipe_mesh(4)
  return {'blocks': h, 'apply': dit.apply(variables, idx, sigma),
          'forward_m4': jax.jit(lambda v: JP.pipeline_dit_forward(
              dit, v, idx, sigma, mesh=mesh, num_microbatches=4))(variables),
          'forward_v2': jax.jit(lambda v: JP.pipeline_dit_forward(
              dit, v, idx, sigma, mesh=mesh, num_microbatches=4,
              virtual=2))(variables)}


def _jax_train(jmodel, jcfg, seqs, key):
  """JAX's pipelined train step on a 4-stage pipe mesh and its eval
  step on the updated state (EMA weights)."""
  mesh = _pipe_mesh(4)
  state = jtrain.init_state(jmodel, jcfg, jax.random.key(6))
  batch = {'seqs': jnp.asarray(seqs)}
  new, loss = jax.jit(jtrain.make_train_step(jmodel, jcfg, mesh))(state,
                                                                   batch)
  nll, n = jax.jit(jtrain.make_eval_step(jmodel, jcfg, mesh))(new, batch,
                                                              key)
  return {'loss': float(loss), 'params': new.params,
          'ema': new.ema.shadow, 'mu': new.opt_state[1][0].mu,
          'nu': new.opt_state[1][0].nu, 'eval': (float(nll), float(n))}


@pytest.fixture(scope='module')
def pipe(tmp_path_factory):
  """(each rank's results, JAX's references, the port's DiT config). The
  processes start first and run while JAX computes."""
  out = tmp_path_factory.mktemp('parallel_pipe')
  os.makedirs(out / 'no_data')
  rs = np.random.default_rng(0)
  gp_blocks = [{'w': (0.3 * rs.normal(size=(GP_D, GP_D))).astype(np.float32),
                'b': (0.1 * rs.normal(size=GP_D)).astype(np.float32)}
               for _ in range(GP_BLOCKS)]
  it_blocks = [{'w': (rs.normal(size=(16, 16)) / 4).astype(np.float32)}
               for _ in range(GP_BLOCKS)]
  cfg, jcfg = _dit_cfgs()
  jmodel = JaxDiffusion(jcfg, variables={})
  variables = random_variables(
      jmodel.backbone.init, jnp.zeros((1, L), jnp.int32), jnp.zeros((1,)),
      rs=rs)
  jmodel.variables = jax.tree.map(jnp.asarray, variables)
  torch.save(dit_from_jax(variables, cfg, torch.float32), out / 'dit.pt')
  seqs = rs.integers(0, 4, (N, L))
  rng = jax.random.key(6)
  _, loss_key, _ = jax.random.split(rng, 3)
  eval_key = jax.random.key(5)
  d = {'h': rs.normal(size=(N, L, 32)).astype(np.float32),
       'c': rs.normal(size=(N, 16)).astype(np.float32),
       'idx': rs.integers(0, 5, (N, L)),
       'sigma': np.linspace(0.1, 0.9, N).astype(np.float32)}
  sp = {x: rs.normal(size=(2, 32, 2, 8)).astype(np.float32)
        for x in ('q', 'k', 'v', 'w')}
  inputs = {
      'gpipe': {'blocks': gp_blocks, 'microbatches': MICROBATCHES,
                'x': rs.normal(size=(GP_B, 5, GP_D)).astype(np.float32),
                'cond': rs.normal(size=(GP_B, GP_D)).astype(np.float32)},
      'interleaved': {'blocks': it_blocks,
                      'x': rs.normal(size=(8, 16)).astype(np.float32)},
      'dit': str(out / 'dit.pt'),
      'dit_inputs': {k: _t(v) for k, v in d.items()},
      'train': {'backbone': str(out / 'dit.pt'), 'seqs': _t(seqs),
                'noise': _loss_uniforms(loss_key, N, L),
                'eval_noise': _loss_uniforms(eval_key, N, L)},
      'sp': {k: _t(v) for k, v in sp.items()}}
  for k in ('x', 'cond'):
    inputs['gpipe'][k] = _t(inputs['gpipe'][k])
  inputs['interleaved']['x'] = _t(inputs['interleaved']['x'])
  torch.save(inputs, out / 'inputs.pt')
  procs = W.start('pipe', 4, str(out))
  ref = {'generic4': _jax_generic(inputs, 4),
         'generic2': _jax_generic(inputs, 2),
         'dit': _jax_dit(variables, jcfg, d)}
  for v in (1, 2):
    jc = _dit_cfgs(v)[1]
    jm = JaxDiffusion(jc, variables=jmodel.variables)
    ref[f'train_v{v}'] = _jax_train(jm, jc, seqs, eval_key)
  q, k, v, w = (jnp.asarray(sp[x]) for x in 'qkvw')
  for causal in (False, True):
    out_, vjp = jax.vjp(lambda q, k, v: jax_mha(q, k, v, causal=causal),
                        q, k, v)
    ref[f'sp_{causal}'] = (out_, vjp(w))
  return W.collect(procs, str(out)), ref, cfg


def _close(got, want, tol, msg=''):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), **tol,
                             err_msg=msg)


# ---------------------------------------------------------------------------
# the ring permute, the stacking layouts
# ---------------------------------------------------------------------------


def test_ring_permute_and_its_reverse(pipe):
  """Stage i receives stage i - 1's tensor (mod 4); the gradient of its
  input is the reverse permute of the cotangents, stage i + 1's (i + 2)."""
  results, _, _ = pipe
  for s, r in enumerate(results):
    got = r['permute']
    np.testing.assert_array_equal(got['received'].numpy(),
                                  np.full(3, (s - 1) % 4, np.float32))
    np.testing.assert_array_equal(got['grad'].numpy(),
                                  np.full(3, (s + 1) % 4 + 1, np.float32))


def test_ring_permute_at_one_stage_is_a_copy():
  """At one stage the permute is the stage's own tensor, copied (no
  group needed), its gradient passed back unchanged, the permute
  counted."""
  mesh = M.PipeMesh(1, 0, (0,), None)
  t = torch.arange(4.0, requires_grad=True)
  M.reset_collectives()
  got = M.ring_permute(t, mesh)
  assert torch.equal(got, t) and got.data_ptr() != t.data_ptr()
  (got * 3).sum().backward()
  assert torch.equal(t.grad, torch.full((4,), 3.0))
  assert M.collectives() == {'permute': 2}


@pytest.mark.parametrize('interleaved', [False, True])
def test_stacking_layouts_match_jax(interleaved):
  """``stack_stage_params`` and the interleaved stacking, laid out by
  ``stacked_leaves``, equal JAX's stacked leaves: (S, k, ...) and (S, V,
  k, ...)."""
  rs = np.random.default_rng(1)
  blocks = [{'w': rs.normal(size=(3, 2)).astype(np.float32),
             'b': rs.normal(size=2).astype(np.float32)} for _ in range(12)]
  tblocks = [{k: _t(v) for k, v in b.items()} for b in blocks]
  jblocks = [{k: jnp.asarray(v) for k, v in b.items()} for b in blocks]
  if interleaved:
    got = P.stacked_leaves(P.stack_stage_params_interleaved(tblocks, 2, 2))
    want = JP.stack_stage_params_interleaved(jblocks, 2, 2)
    assert got['w'].shape == (3, 2, 2, 3, 2)
  else:
    got = P.stacked_leaves(P.stack_stage_params(tblocks, 3))
    want = JP.stack_stage_params(jblocks, 3)
    assert got['w'].shape == (4, 3, 3, 2)
  for k in want:
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# gpipe, gpipe_interleaved, the DiT's blocks and forward
# ---------------------------------------------------------------------------


def _stacked_grads(blocks, k):
  return P.stacked_leaves(P.stack_stage_params(blocks, k))


@pytest.mark.parametrize('m', MICROBATCHES)
def test_gpipe_matches_jax_and_sequential(pipe, m):
  """gpipe over 4 stages with the conditioning as a per-microbatch
  argument, M = 1, 4 and 8: on every process the output and the
  gradients of sum(out ** 2) with respect to x, the conditioning and
  every block's parameters equal JAX's gpipe (and its sequential stack)."""
  results, ref, _ = pipe
  y, (g_sp, g_x, g_c) = ref['generic4'][f'gpipe_m{m}']
  ys, (gs_bl, gs_x, gs_c) = ref['generic4']['sequential']
  _close(y, ys, TOL)
  for rank, r in enumerate(results):
    got = r['generic4'][f'gpipe_m{m}']
    _close(got['out'], y, TOL, f'rank {rank}')
    _close(got['out'], ys, TOL, f'rank {rank}')
    for g, want, seq in zip(got['inputs'], (g_x, g_c), (gs_x, gs_c)):
      _close(g, want, GRAD_TOL, f'rank {rank}')
      _close(g, seq, GRAD_TOL, f'rank {rank}')
    stacked = _stacked_grads(got['blocks'], GP_BLOCKS // 4)
    for k in g_sp:
      _close(stacked[k], g_sp[k], GRAD_TOL, f'rank {rank} {k}')


@pytest.mark.parametrize('stages', [2, 4])
def test_gpipe_interleaved_matches_jax(pipe, stages):
  """The interleaved schedule at V = 2 over 2 and 4 stages: the output
  and the gradients with respect to the input and the parameters equal
  JAX's gpipe_interleaved on every process of the grid; at 2 stages also
  gpipe at each microbatch count."""
  results, ref, _ = pipe
  y, (g_sp, g_x) = ref[f'generic{stages}']['interleaved']
  k = GP_BLOCKS // (stages * 2)
  for rank, r in enumerate(results[:stages]):
    got = r[f'generic{stages}']
    _close(got['interleaved']['out'], y, TOL, f'rank {rank}')
    _close(got['interleaved']['inputs'][0], g_x, GRAD_TOL, f'rank {rank}')
    stacked = P.stacked_leaves(P.stack_stage_params_interleaved(
        got['interleaved']['blocks'], k, 2))
    assert stacked['w'].shape == g_sp['w'].shape
    _close(stacked['w'], g_sp['w'], GRAD_TOL, f'rank {rank}')
    if stages == 2:
      for m in MICROBATCHES:
        y2, (_, g_x2, g_c2) = ref['generic2'][f'gpipe_m{m}']
        _close(got[f'gpipe_m{m}']['out'], y2, TOL, f'rank {rank} m {m}')
        _close(got[f'gpipe_m{m}']['inputs'][1], g_c2, GRAD_TOL)


def test_gpipe_dit_blocks_match_sequential(pipe):
  """Real DDiTBlocks (weights from JAX's through ``dit_from_jax``) in
  gpipe over 4 stages, c per microbatch and the rotary tables broadcast,
  equal JAX's sequential block stack (2e-4, JAX's test's)."""
  results, ref, _ = pipe
  for rank, r in enumerate(results):
    _close(r['dit4']['blocks'], ref['dit']['blocks'],
           dict(rtol=2e-4, atol=2e-4), f'rank {rank}')


@pytest.mark.parametrize('kind', ['forward_m4', 'forward_v2'])
def test_pipeline_dit_forward_matches_jax(pipe, kind):
  """``pipeline_dit_forward`` over 4 stages (M = 4; V = 2) equals JAX's
  pipelined forward and ``dit.apply`` on the carried weights (2e-5,
  JAX's test's)."""
  results, ref, _ = pipe
  tol = dict(rtol=2e-5, atol=2e-5)
  _close(ref['dit'][kind], ref['dit']['apply'], tol)
  for rank, r in enumerate(results):
    _close(r['dit4'][kind], ref['dit'][kind], tol, f'rank {rank}')


@pytest.mark.parametrize('virtual', [1, 2])
def test_pipeline_dit_forward_at_bf16_raises_as_jax(virtual):
  """A bf16 DiT's blocks return f32, so its pipelined forward raises the
  TypeError of JAX's scan over a carry that changes type, on a one-stage
  grid, GPipe (M = 2) and interleaved (V = 2) alike; the plain forward
  runs."""
  from svdd_tpu.models.dit import DIT as JaxDIT
  from svdd_tpu_torch.models.dit import DIT
  cfg, jcfg = _dit_cfgs(stages=1)
  cfg.model.n_blocks = jcfg.model.n_blocks = 2
  idx = np.zeros((4, L), np.int32)
  sigma = np.full(4, 0.5, np.float32)
  jdit = JaxDIT(jcfg, vocab_size=5, compute_dtype=jnp.bfloat16)
  variables = jdit.init(jax.random.key(0), idx, sigma)
  with pytest.raises(TypeError) as want:
    JP.pipeline_dit_forward(jdit, variables, idx, sigma, mesh=_pipe_mesh(1),
                            num_microbatches=2, virtual=virtual)
  dit = DIT(cfg, vocab_size=5, compute_dtype=torch.bfloat16)
  assert dit(_t(idx), _t(sigma)).dtype == torch.float32
  with pytest.raises(TypeError) as got:
    P.pipeline_dit_forward(dit, _t(idx), _t(sigma),
                           mesh=M.PipeMesh(1, 0, (0,), None),
                           num_microbatches=2, virtual=virtual)
  head = ('scan body function carry input and carry output must have '
          'equal types, but they differ')
  assert str(want.value).startswith(head)
  assert str(got.value).startswith(head)
  assert 'bfloat16' in str(got.value) and 'float32' in str(got.value)


# ---------------------------------------------------------------------------
# the pipelined train and eval steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('virtual', [1, 2])
def test_pipelined_train_step_matches_jax(pipe, virtual):
  """One pipelined step at S = 4, M = 4 (V = 1) and V = 2 on JAX's
  uniforms, against JAX's ``make_train_step(model, cfg, mesh)``: on every
  process the loss (1e-5), the parameters, the EMA shadow and Adam's first
  moment (JAX's test's 2e-5 + 2e-4 |x|), Adam's second moment (2e-4
  relative to its largest); then the eval step on the EMA weights (the
  NLL sum 1e-5, the token count exactly). Every process holds the same
  state; the step issued the permutes, one broadcast and the all-reduce
  of the backward."""
  results, ref, cfg = pipe
  want = ref[f'train_v{virtual}']

  def port(tree):
    return dict(dit_from_jax({'params': tree}, cfg,
                             torch.float32).named_parameters())
  trees = {part: port(want[part]) for part in ('params', 'ema', 'mu', 'nu')}
  for rank, r in enumerate(results):
    got = r[f'train_v{virtual}']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    for part, tree in trees.items():
      assert sorted(got[part]) == sorted(tree)
      for k, w in tree.items():
        w = w.detach().numpy()
        tol = (dict(rtol=2e-4, atol=2e-4 * float(np.abs(w).max()))
               if part == 'nu' else dict(rtol=2e-4, atol=2e-5))
        _close(got[part][k], w, tol, f'rank {rank} {part} {k}')
      for k in tree:
        assert torch.equal(got[part][k], results[0][f'train_v{virtual}'][
            part][k]), (rank, part, k)
    np.testing.assert_allclose(got['eval'][0], want['eval'][0], rtol=1e-5)
    assert got['eval'][1] == want['eval'][1]
    col = got['collectives']
    assert col['broadcast'] == 1 and col['all_reduce'] == 1
    assert col['permute'] == 2 * ((4 if virtual == 1 else 8) + 4 - 2)


def test_world1_pipe_step_is_the_plain_step_bit_for_bit(pipe):
  """On a one-stage pipe grid (process 3), two steps of the pipelined
  DiT at M = 1, V = 1 and V = 2 (one microbatch: the plain ops) equal the
  plain step bit for bit, losses, parameters, EMA and moments; at M = 4
  within JAX's tolerances."""
  results, _, _ = pipe
  r = results[3]['world1']
  assert r['m1']['bitwise'] and r['v2']['bitwise'], r
  assert r['m4']['loss_rel'] <= 1e-5 and r['m4']['max_abs'] <= 2e-5, r


# ---------------------------------------------------------------------------
# sequence-parallel attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('causal', [False, True])
def test_sp_mha_matches_jax_mha(pipe, causal):
  """``sp_mha`` with L split over the model axis of a 1 x 4 and a 2 x 2
  grid equals JAX's ``mha`` on the whole sequence, each process's block
  of the output and of the input gradients of sum(out * w) (1e-5, JAX's
  test's)."""
  results, ref, _ = pipe
  want, grads = ref[f'sp_{causal}']
  for grid in ('1x4', '2x2'):
    for rank, r in enumerate(results):
      got = r[f'sp{grid}'][causal]
      sl = slice(*got['slice'])
      _close(got['out'], np.asarray(want)[:, sl], TOL, f'{grid} {rank}')
      for g, w in zip(got['grads'], grads):
        _close(g, np.asarray(w)[:, sl], TOL, f'{grid} {rank}')


# ---------------------------------------------------------------------------
# the CLI and JAX's guard rails
# ---------------------------------------------------------------------------


def test_main_gosai_trains_on_two_stages(pipe):
  """``main_gosai --mode train`` with ``parallel.pipeline_stages=2`` on
  four processes: processes 0 and 1 are the stages (2 and 3 past the
  grid), two steps with a pipelined validation; both hold the same state,
  and process 0's checkpoint loads into a single-process trainer state
  with that state's parameters, EMA and moments."""
  results, _, cfg = pipe
  a, b = results[0]['cli'], results[1]['cli']
  assert results[2]['cli'] == results[3]['cli'] == {'past_grid': True}
  assert a['mesh'] == b['mesh'] == {'pipe': 2}
  assert (a['stage'], b['stage'], a['step']) == (0, 1, 2)
  assert a['collectives']['permute'] > 0
  for part in ('params', 'ema', 'mu'):
    for k in a[part]:
      assert torch.equal(a[part][k], b[part][k]), (part, k)
  single = cfg.override()
  single.parallel.pipeline_stages = 1
  state = train_diff.init_state(Diffusion(single, device='cpu'), single)
  train_diff.restore_checkpoint(os.path.dirname(a['ckpt']), state)
  assert state.step == 2 and state.mesh is None
  for k, p in state.model.backbone.named_parameters():
    assert torch.equal(p.detach(), a['params'][k]), k
    assert torch.equal(state.ema.shadow[k], a['ema'][k]), k
    assert torch.equal(state.optimizer.adamw.state[p]['exp_avg'],
                       a['mu'][k]), k


def _guard_cases():
  return {
      'backbone': dict(set={'backbone': 'cnn'}),
      'no_pipe_axis': dict(mesh=None),
      'pipe_size': dict(stages=2),
      'dropout': dict(set={'model.dropout': 0.1}),
      'n_blocks': dict(stages=3, pipeline_stages=3),
      'fsdp': dict(set={'parallel.fsdp': True}),
  }


@pytest.mark.parametrize('case', list(_guard_cases()))
def test_pipeline_guard_rails_raise_as_jax(case):
  """Each misconfiguration raises JAX's ValueError with JAX's words: a
  backbone other than the DiT, a grid without a pipe axis, a pipe size
  other than ``pipeline_stages``, dropout, ``n_blocks`` not dividing
  stages * virtual, FSDP on a pipe-only grid."""
  spec = _guard_cases()[case]
  cfg, jcfg = _dit_cfgs()
  for c in (cfg, jcfg):
    c.parallel.pipeline_stages = spec.get('pipeline_stages', 4)
    for key, value in spec.get('set', {}).items():
      obj = c
      *path, last = key.split('.')
      for part in path:
        obj = getattr(obj, part)
      setattr(obj, last, value)
  stages = spec.get('stages', cfg.parallel.pipeline_stages)
  mesh = spec.get('mesh', M.PipeMesh(stages, 0, tuple(range(stages)), None))
  jmesh = None if mesh is None else _pipe_mesh(stages)
  # the FSDP check comes after make_train_step, in init_or_restore, which
  # reads the variables
  jmodel = (JaxDiffusion(jcfg, rng=jax.random.key(0)) if case == 'fsdp'
            else JaxDiffusion(jcfg, variables={}))
  with pytest.raises(ValueError) as want:
    trainer = jtrain.Trainer(jmodel, jcfg, mesh=jmesh)
    trainer.init_or_restore(jax.random.key(0))
  with pytest.raises(ValueError) as got:
    train_diff.init_state(Diffusion(cfg, device='cpu'), cfg, mesh=mesh)
  assert str(got.value) == str(want.value)


def test_ppl_eval_and_sample_eval_with_pipeline_settings_as_jax(tmp_path):
  """``pipeline_stages=2`` reaches the trainer alone: sample_eval runs
  (JAX's never reads it), ppl_eval raises the ValueError JAX's does (its
  ``Trainer`` builds the pipelined step, which needs a pipe grid)."""
  from svdd_tpu_torch.cli import main_gosai
  cfg, jcfg = _dit_cfgs(stages=2)
  args = lambda mode: main_gosai.parser().parse_args(
      ['--mode', mode, '--device', 'cpu', '--ckpt_dir',
       str(tmp_path / 'none'), '--data_dir', str(tmp_path)])
  cfg.sampling.num_sample_batches = 1
  out = main_gosai.run(args('sample_eval'), cfg)
  assert out['tokens'].shape == (8, L)
  with pytest.raises(ValueError) as want:
    jtrain.Trainer(JaxDiffusion(jcfg, variables={}), jcfg)
  with pytest.raises(ValueError) as got:
    main_gosai.run(args('ppl_eval'), cfg)
  assert str(got.value) == str(want.value)
