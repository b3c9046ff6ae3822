"""The timed and multisep value models and their trainers in
svdd_tpu_torch vs svdd_tpu (tiny sizes: the Enformer at channels 256,
3 conv blocks, one transformer block, 2 heads; the ConvGRU at its own
widths; L=16, batch 4, 8 steps), and the backward of the fused eval
tower's pool kernel (B3).

The timed Enformer's forward and gradients (f32, and bf16, whose trunk
computes in f32 as JAX promotes it), the timed step index at every one
of 128 steps and the multisep bins, one timed SVDD-MC step on JAX's
Gumbel noise, ``multisep_losses`` with the gradients of every stacked
leaf (the BatchNorm running statistics included) for Enformer and
ConvGRU trunks, one ``MultiSepTrainer`` step and one timed
``ValueTrainer`` step against JAX's on the same trajectory, the trainer
state's round trip and the CLIs.

Tolerances (``tests/test_torch_value_train.py``'s). f32 with TF32 off:
outputs and losses 1e-5 relative; a gradient's distance by norm 5e-5 of
its own norm plus 1e-6 of the largest gradient's; an update as optax's
AdamW makes it from the same state on the port's gradients, to 1e-6
(AdamW's first update moves an element whose gradient lies within
rounding of 0 by the full rate, so the two packages' own updates are
not compared element by element).
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import value as jvalue
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models import multisep as jmultisep
from svdd_tpu.models.convgru import ConvGRUValueModel as JaxConvGRU
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer
from svdd_tpu.rewards import synthetic_motif_oracle as jax_motif_oracle
from svdd_tpu.sampling import guidance as jguidance
from svdd_tpu.train import value as jtrain_value

from svdd_tpu_torch import mdlm, rewards
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import decode as cli_decode
from svdd_tpu_torch.cli import train as cli_train
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.models import blocks, multisep
from svdd_tpu_torch.ops import attn_pool as ap
from svdd_tpu_torch.ops import conv1d
from svdd_tpu_torch.sampling import guidance, sampler
from svdd_tpu_torch.train import value as train_value
from svdd_tpu_torch.weights import (cnn_from_jax, convgru_from_jax,
                                    enformer_value_from_jax,
                                    multisep_from_jax)
from torch_port_helpers import (FlaxMasks, dropout_masks,  # noqa: F401
                                few_torch_threads, random_cnn_variables,
                                random_variables)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L, B, STEPS = 16, 4, 8
TINY = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2, key_len=8)
LR = 2e-4
N_MODELS = 2          # the multisep tests' bins


def _t(a):
  return torch.from_numpy(np.array(a))


def _np(a):
  return np.asarray(jnp.asarray(a, jnp.float32))


def _onehots(seed, n=B):
  tokens = np.random.default_rng(seed).integers(0, 5, (n, L))
  return mdlm.transform_samples(torch.from_numpy(tokens)).numpy()


def _leaves(module) -> dict:
  """{name: float64 array} of a port module's parameters and buffers."""
  named = list(module.named_parameters()) + list(module.named_buffers())
  return {k: t.detach().double().numpy() for k, t in named}


def _grads(module) -> dict:
  named = list(module.named_parameters()) + list(module.named_buffers())
  return {k: t.grad.double().numpy() for k, t in named}


def _assert_named_close(got: dict, want: dict, rtol=5e-5, floor=1e-6,
                        skip=()):
  """Each array within rtol of its norm plus ``floor`` of the largest
  one's norm, by norm; names containing an entry of ``skip`` left out."""
  assert set(got) == set(want), set(got) ^ set(want)
  norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
  top = max(norm(v) for v in want.values())
  bad = {k: (norm(got[k] - want[k]), norm(want[k])) for k in want
         if not any(s in k for s in skip)
         and not norm(got[k] - want[k]) <= rtol * norm(want[k]) + floor * top}
  assert not bad, bad


def _as_port(tree, from_jax=enformer_value_from_jax) -> dict:
  """A flax variables tree (parameters, gradients or moments) under the
  port's names."""
  return _leaves(from_jax(jax.tree.map(np.asarray, tree)))


# ---------------------------------------------------------------------------
# B3's backward: the fused pool's kernel branch carries the gradient
# ---------------------------------------------------------------------------


def _launch_as_kernel(x, w, scale, shift, k_taps, act_name, residual=None):
  """What the CUDA launch does, on the CPU: the function's value written
  outside autograd."""
  with torch.no_grad():
    return ap.pool_prologue_im2col_wlogits_plain(
        x.detach(), w.detach(), scale.detach(), shift.detach(), k_taps,
        act_name, None if residual is None else residual.detach())


def _handoff_block_grads(residual: bool):
  """One fused eval tower block (a k=5 NACDR ConvBlock consuming the
  previous block's deferred pool) at C=128, L=12: its output and the
  gradients of a fixed linear function of it in x, the residual, the
  pool weight and every leaf of the block (BatchNorm statistics
  included)."""
  gen = torch.Generator().manual_seed(3)
  block = blocks.ConvBlock(128, 128, 5, gen, act_func='gelu_enformer',
                           order='NACDR')
  rs = np.random.default_rng(4)
  with torch.no_grad():
    block.norm.scale.copy_(_t(rs.uniform(0.7, 1.3, 128)))
    block.norm.bias.copy_(_t(0.1 * rs.normal(size=128)))
    block.norm.mean.copy_(_t(0.1 * rs.normal(size=128)))
    block.norm.var.copy_(_t(rs.uniform(0.5, 1.5, 128)))
  for b in block.buffers():
    b.requires_grad_(True)
  x = _t(rs.normal(size=(3, 12, 128)).astype(np.float32)).requires_grad_()
  res = (_t(rs.normal(size=(3, 12, 128)).astype(np.float32)).requires_grad_()
         if residual else None)
  w = _t((np.eye(128) + 0.1 * rs.normal(size=(128, 128))).astype(
      np.float32)).requires_grad_()
  out = block(blocks.PoolHandoff(x, res, w))
  ct = _t(rs.normal(size=tuple(out.shape)).astype(np.float32))
  (out * ct).sum().backward()
  grads = {'x': x.grad, 'w': w.grad, **{k: t.grad for k, t in
                                        list(block.named_parameters())
                                        + list(block.named_buffers())}}
  if residual:
    grads['residual'] = res.grad
  return out.detach(), grads


@pytest.mark.parametrize('residual', [False, True])
def test_fused_pool_kernel_branch_carries_gradients(residual, monkeypatch):
  """The B3 wrapper's kernel branch (forced on the CPU: ``_plain`` False,
  the launch replaced by the plain function run outside autograd, as the
  real launch writes its output) gives the block the same output and the
  same gradients as the plain branch: its backward is the gradient of
  the reference form, as JAX's custom VJP. A launch that autograd does
  not see leaves x, the residual, the pool weight and the norm without
  gradients."""
  want_out, want = _handoff_block_grads(residual)
  monkeypatch.setattr(ap, '_plain', lambda x: False)
  monkeypatch.setattr(ap, '_pool_prologue_im2col_kernel', _launch_as_kernel)
  got_out, got = _handoff_block_grads(residual)
  np.testing.assert_array_equal(got_out.numpy(), want_out.numpy())
  assert set(got) == set(want)
  for k in want:
    assert got[k] is not None, k
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5,
                               atol=1e-5 * float(want[k].abs().max()),
                               err_msg=k)


@pytest.mark.parametrize('n,l,cin,cout,k,d', [
    (3, 24, 4, 16, 15, 1), (2, 3, 4, 8, 15, 1), (2, 8, 6, 8, 5, 4),
    (2, 7, 64, 64, 5, 2)])
def test_off_gate_convs_record_the_fixed_order_backward(n, l, cin, cout, k,
                                                        d, monkeypatch):
  """A recorded ``conv1d_shifted`` off B7's gate (the Enformer's stem from
  4 channels, dead taps at L=3, a dilation, the ConvGRU's 64 channels)
  takes ``_ConvPlainBwd`` whoever records it, with no flag: its gradients
  equal autograd through PyTorch's own conv (f32, 1e-5 relative) and
  ``conv_bwd_f32``'s per-tap products; where the input takes no gradient
  (the multisep trainer's one-hot), dx is not computed."""
  rs = np.random.default_rng(31)
  x, w, ct = (_t(rs.normal(size=s).astype(np.float32)) for s in
              ((n, l, cin), (k, cin, cout), (n, l, cout)))
  b = _t(rs.normal(size=cout).astype(np.float32))
  assert not conv1d.conv_bwd_ok(l, cin, cout, k, d)
  asked = []
  orig = conv1d.conv_bwd_taps_f32
  monkeypatch.setattr(conv1d, 'conv_bwd_taps_f32',
                      lambda *a: asked.append(a[4:]) or orig(*a))
  grads = []
  for conv in (conv1d.conv1d_shifted, conv1d._conv_forward):
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    conv(xs, ws, bs, d).backward(ct)
    grads.append([t.grad for t in (xs, ws, bs)])
  assert asked == [(True, True)]
  for got, want in zip(*grads):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
  dx, dw = conv1d.conv_bwd_f32(x, w, ct, d)
  np.testing.assert_allclose(grads[0][0].numpy(), dx.numpy(), rtol=1e-6,
                             atol=1e-6 * float(dx.abs().max()))
  np.testing.assert_allclose(grads[0][1].numpy(), dw.numpy(), rtol=1e-6,
                             atol=1e-6 * float(dw.abs().max()))
  ws = w.clone().requires_grad_()
  conv1d.conv1d_shifted(x, ws, None, d).backward(ct)
  assert asked[-1] == (False, True)
  np.testing.assert_allclose(ws.grad.numpy(), grads[0][1].numpy(),
                             rtol=1e-6, atol=1e-6 * float(dw.abs().max()))


# ---------------------------------------------------------------------------
# the timed Enformer
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def timed_vars():
  jm = JaxEnformer(**TINY, timed=True)
  return jm, random_variables(jm.init, jnp.zeros((1, L, 4)),
                              jnp.zeros((1, L), jnp.int32),
                              rs=np.random.default_rng(10))


def _time_indices(seed, n=B):
  return np.random.default_rng(seed).integers(0, 128, (n, L)).astype(
      np.int32)


@pytest.fixture(scope='module')
def timed_jax_grads(timed_vars):
  """JAX's timed net on 4 rows: the output and the gradients of
  mean(out^2) in the parameters and the one-hot input."""
  jm, variables = timed_vars
  x, ti = _onehots(11), _time_indices(12)

  def loss(params, xx):
    out = jm.apply({'params': params,
                    'batch_stats': variables['batch_stats']}, xx,
                   jnp.asarray(ti))
    return (out ** 2).mean(), out

  (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
      loss, argnums=(0, 1), has_aux=True))(variables['params'],
                                           jnp.asarray(x))
  return x, ti, _np(out), gp, _np(gx)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_timed_enformer_matches_svdd_tpu(timed_vars, timed_jax_grads, dtype):
  """The timed net, x + 0.01 * table[time_indices] before the trunk: its
  output and the gradients of mean(out^2) in the input and every
  parameter (the time table included) against JAX's f32 net. With a bf16
  compute dtype the f32 table promotes the sum, so the trunk computes in
  f32, as JAX's does (``enformer.py:438-442``): the port's bf16 timed net
  gives the f32 net's output bit for bit, and JAX's bf16 timed net
  gives its own f32 output."""
  jm, variables = timed_vars
  x, ti, want, gp, gx = timed_jax_grads
  model = enformer_value_from_jax(variables, getattr(torch, dtype))
  assert model.timed and model.compute_dtype == getattr(torch, dtype)
  xt = _t(x).requires_grad_(True)
  out = model(xt, time_indices=_t(ti))
  assert out.dtype == torch.float32
  (out ** 2).mean().backward()
  np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())
  # bf16: the gradient reaches the input through its cast to bf16
  tol = 5e-5 if dtype == 'float32' else 2 ** -8
  np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=tol,
                             atol=tol * np.abs(gx).max())
  got = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
  want_g = {k: v for k, v in _as_port(
      {'params': gp, 'batch_stats': variables['batch_stats']}).items()
            if k in got}
  _assert_named_close(got, want_g)
  if dtype == 'bfloat16':
    f32 = enformer_value_from_jax(variables)
    with torch.no_grad():
      assert torch.equal(model(_t(x), time_indices=_t(ti)),
                         f32(_t(x), time_indices=_t(ti)))
    j16 = JaxEnformer(**TINY, timed=True, compute_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(
        _np(j16.apply(variables, jnp.asarray(x), jnp.asarray(ti))),
        _np(jm.apply(variables, jnp.asarray(x), jnp.asarray(ti))))


def _timed_fn(vf):
  """(tokens, step) -> the timed net's scores with every position at
  ``step`` (the reference's timed loop feeds ``torch.full((B, L), i)``)."""
  return lambda tok, step: vf.score_tokens(
      tok, time_indices=torch.full(tok.shape, step, dtype=torch.int32))


def test_timed_value_function_needs_time_indices(timed_vars):
  """A timed net without time indices raises JAX's ``ValueError``; the
  value function passes them on to the module, as JAX's ``score_tokens``
  does."""
  jm, variables = timed_vars
  vf = value_lib.ValueFunction(enformer_value_from_jax(variables), L,
                               timed=True)
  tokens = np.random.default_rng(13).integers(0, 5, (B, L))
  with pytest.raises(ValueError, match='timed model requires time_indices'):
    vf.score_tokens(torch.from_numpy(tokens))
  jvf = jvalue.ValueFunction(jm, jax.tree.map(jnp.asarray, variables), L,
                             timed=True)
  ti = np.full((B, L), 17, np.int32)
  want = _np(jax.jit(lambda t, i: jvf.score_tokens(t, time_indices=i))(
      jnp.asarray(tokens), jnp.asarray(ti)))
  with torch.no_grad():
    got = vf.score_tokens(torch.from_numpy(tokens),
                          time_indices=torch.from_numpy(ti))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())


def test_timedenformer_raises_as_svdd_tpu(tmp_path):
  """``ValueFunction.create(model='timedenformer')`` with ``timed`` left
  False raises JAX's ``ValueError`` in both packages, so the CLIs that
  build a value net raise it for ``--model timedenformer``;
  ``timed=True`` builds the timed net; 'multienformer' raises
  ``NotImplementedError`` in both factories."""
  with pytest.raises(ValueError, match='timed model requires time_indices'):
    jvalue.ValueFunction.create('dna', L, jax.random.key(0),
                                model='timedenformer')
  gen = torch.Generator().manual_seed(0)
  with pytest.raises(ValueError, match='timed model requires time_indices'):
    value_lib.ValueFunction.create('dna', L, gen, model='timedenformer',
                                   **TINY)
  vf = value_lib.ValueFunction.create('dna', L, gen, model='timedenformer',
                                      timed=True, **TINY)
  assert vf.timed and vf.module.timed
  cfg = tiny_test_config('dna')
  cfg.sampling.steps = 4
  argv = ['--device', 'cpu', '--model', 'timedenformer', '--batch_size', '2',
          '--num_steps', '4', '--out_dir', str(tmp_path)]
  for cli in (cli_train, cli_decode):
    with pytest.raises(ValueError, match='timed model requires'):
      cli.run(cli.parser().parse_args(argv), cfg=cfg, value_kwargs=TINY)
  with pytest.raises(NotImplementedError):
    jvalue.build_value_module('dna', 'multienformer')
  with pytest.raises(NotImplementedError):
    value_lib.build_value_module('dna', 'multienformer')


# ---------------------------------------------------------------------------
# step indices and the timed SVDD-MC step
# ---------------------------------------------------------------------------


def test_timed_step_index_and_bins_match_svdd_tpu():
  """At 128 steps: the step index the timed step recovers from each
  step's time equals JAX's (JAX's grid and computation; the port's grid
  and ``timed_step_index``) and runs 0..127; ``model_index`` at 10 bins
  equals JAX's at every step (steps 108-127 all in bin 9)."""
  steps, eps = 128, 1e-5
  jgrid = jnp.linspace(1.0, eps, steps + 1)
  want = np.asarray(jax.vmap(lambda t: jnp.round(
      (1.0 - t) * steps / (1.0 - eps)).astype(jnp.int32))(jgrid[:-1]))
  grid = sampler.timestep_grid(steps, eps)
  got = [guidance.timed_step_index(grid[i], steps, eps) for i in range(steps)]
  np.testing.assert_array_equal(got, want)
  assert got == list(range(steps))
  jmsm = jmultisep.MultiSepValueModel(None, n_models=10, num_steps=steps)
  msm = multisep.MultiSepValueModel([torch.nn.Identity()] * 10, steps)
  want_bins = np.asarray(jmsm.model_index(jnp.arange(steps)))
  np.testing.assert_array_equal([msm.model_index(s) for s in range(steps)],
                                want_bins)
  assert set(want_bins[108:]) == {9}


@pytest.fixture(scope='module')
def denoisers():
  """A tiny JAX denoiser (L=16, 8 steps) and the port holding its
  weights, sharpened so p(x0|xt) is peaked."""
  cfg = jax_tiny_config('dna')
  cfg.model.length = L
  cfg.sampling.steps = STEPS
  variables = random_cnn_variables(cfg, np.random.default_rng(0))
  variables['params']['final_1']['kernel'] = (
      3.0 * variables['params']['final_1']['kernel'])
  tcfg = tiny_test_config('dna')
  tcfg.model.length = L
  tcfg.sampling.steps = STEPS
  return (JaxDiffusion(cfg, variables=variables),
          Diffusion(tcfg, device='cpu', backbone=cnn_from_jax(variables)))


def _linear_value(w, xp):
  """A value of (tokens, step) that changes its sign with the step: the
  one-hot's product with w, times (step % 5) - 2."""
  def fn(tok, step):
    if xp is jnp:
      oh = jax.nn.one_hot(jnp.where(tok == 4, 0, tok), 4) * (
          tok != 4)[..., None]
      return (oh * jnp.asarray(w)).sum(axis=(-1, -2)) * (step % 5 - 2)
    oh = torch.nn.functional.one_hot(torch.where(tok == 4, 0, tok).long(),
                                     4) * (tok != 4)[..., None]
    return (oh * torch.from_numpy(w)).sum(dim=(-1, -2)) * (step % 5 - 2)
  return fn


@pytest.mark.parametrize('t', [0.6, 0.3])
def test_svdd_mc_step_timed_pinned_to_svdd_tpu(denoisers, t):
  """One timed SVDD-MC step of each package on JAX's Gumbel noise, with a
  value that depends on the step index: the same candidates win."""
  jdiff, tdiff = denoisers
  rs = np.random.default_rng(20)
  x = np.where(rs.random((8, L)) < 0.6, 4,
               rs.integers(0, 4, (8, L))).astype(np.int32)
  w = rs.normal(size=(L, 4)).astype(np.float32)
  t, t_next = np.float32(t), np.float32(t - 0.05)
  key = jax.random.key(21)
  jstep = jguidance.svdd_mc_step_timed(jdiff.denoise_fn(),
                                       _linear_value(w, jnp), jdiff.schedule,
                                       4, STEPS, repeats=4)
  _, want = jax.jit(jstep)((), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (8, 4, L, 5), jnp.float32))
  tstep = guidance.svdd_mc_step_timed(tdiff.forward, _linear_value(w, torch),
                                      tdiff.schedule, 4, STEPS, repeats=4)
  with torch.no_grad():
    got = tstep(torch.from_numpy(x).long(), torch.tensor(t),
                torch.tensor(t_next), None, gumbel=torch.from_numpy(noise))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_controlled_sampler_timed_scores_every_step(denoisers):
  """``controlled_sampler_timed`` with the timed net's token function:
  every step scores its B*M candidates at its own step index, 0 to
  STEPS-1, and the result is mask-free."""
  _, tdiff = denoisers
  seen = []
  gen = torch.Generator().manual_seed(30)
  vf = value_lib.ValueFunction.create('dna', L, gen, timed=True, **TINY)
  fn = _timed_fn(vf)
  res = tdiff.controlled_sampler_timed(
      lambda tok, step: seen.append((tok.shape[0], step)) or fn(tok, step),
      B, sample_M=3)(torch.Generator().manual_seed(31))
  assert seen == [(B * 3, s) for s in range(STEPS)]
  assert res.samples.shape == (B, L) and (res.samples != 4).all()


# ---------------------------------------------------------------------------
# multisep losses and the trainers
# ---------------------------------------------------------------------------


def _stacked(jm, seed, n=N_MODELS):
  """n variable sets of ``jm`` drawn as the single-net tests draw them,
  stacked along a leading axis (JAX's multisep layout)."""
  sets = [random_variables(jm.init, jnp.zeros((1, L, 4)),
                           rs=np.random.default_rng(seed + i))
          for i in range(n)]
  for i, variables in enumerate(sets):
    if 'ConvGRUTrunk_0' in variables['params']:
      # the GRU's hidden kernels and biases at a trained net's scale
      # (``tests/test_torch_rna.py``'s)
      rs = np.random.default_rng(seed + 100 + i)
      gp = variables['params']['ConvGRUTrunk_0']['GRUBlock_0']
      for cell in ('gru_fwd_0', 'gru_bwd_0'):
        gp[cell]['hh_kernel'] = (gp[cell]['hh_kernel'] / 8).astype(
            np.float32)
        gp[cell]['hh_bias'] = (0.1 * rs.normal(size=192)).astype(np.float32)
  return jax.tree.map(lambda *xs: np.stack(xs), *sets)


KINDS = {'enformer': (lambda: JaxEnformer(**TINY), enformer_value_from_jax),
         'convgru': (lambda: JaxConvGRU(), convgru_from_jax)}


def _states(seed, s=STEPS):
  rs = np.random.default_rng(seed)
  tokens = np.where(rs.random((s, B, L)) < 0.4, 4,
                    rs.integers(0, 4, (s, B, L)))
  return mdlm.transform_samples(torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize('kind', list(KINDS))
def test_multisep_losses_and_gradients_match_svdd_tpu(kind):
  """``multisep_losses`` at 2 bins over 8 states (4 a bin) with its
  gradients in every stacked leaf: the parameters and the BatchNorm
  running means and variances, which the eval forward reads and JAX
  differentiates (the Enformer at C=256, on the 128-lane grid, through
  the fused eval tower); then ``apply_all`` and ``apply_at_step``."""
  make, from_jax = KINDS[kind]
  jm = make()
  stacked = _stacked(jm, 40)
  onehots = _states(41)
  targets = np.random.default_rng(42).normal(size=B).astype(np.float32)
  jmsm = jmultisep.MultiSepValueModel(jm, n_models=N_MODELS,
                                      num_steps=STEPS)

  def loss(sv):
    losses = jmultisep.multisep_losses(jmsm, sv, jnp.asarray(onehots),
                                       jnp.asarray(targets))
    return losses.mean(), losses

  (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
      jax.tree.map(jnp.asarray, stacked))
  msm = multisep.MultiSepValueModel(multisep_from_jax(stacked, from_jax),
                                    STEPS)
  for t in msm.leaves():
    t.requires_grad_(True)
  losses = multisep.multisep_losses(msm, _t(onehots), _t(targets))
  losses.mean().backward()
  np.testing.assert_allclose(losses.detach().numpy(), _np(jlosses),
                             rtol=1e-5)
  for trunk, want in zip(msm.trunks, multisep_from_jax(
      jax.tree.map(np.asarray, jgrads), from_jax)):
    got = _grads(trunk)
    assert any('mean' in k for k in got)
    _assert_named_close(got, _leaves(want))
  # every trunk on the same rows, and the trunk owning a step
  x = onehots[-1]
  jstacked = jax.tree.map(jnp.asarray, stacked)
  with torch.no_grad():
    np.testing.assert_allclose(
        msm.apply_all(_t(x)).numpy(),
        _np(jmsm.apply_all(jstacked, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    for step in (0, STEPS - 1):
      np.testing.assert_allclose(
          msm.apply_at_step(_t(x), step).numpy(),
          _np(jmsm.apply_at_step(jstacked, jnp.asarray(x), step)),
          rtol=1e-5, atol=1e-6)


def test_multisep_bins_clamp_as_dynamic_slice():
  """Fewer states than bins: each bin takes one state, those past the
  last clamped to it, as ``jax.lax.dynamic_slice_in_dim`` clamps."""
  assert multisep.bin_slices(4, 10) == [(0, 1), (1, 1), (2, 1), (3, 1)] + [
      (3, 1)] * 6
  assert multisep.bin_slices(128, 10) == [(12 * i, 12) for i in range(10)]


def _trajectory(seed):
  rs = np.random.default_rng(seed)
  samples = rs.integers(0, 4, (B, L))
  mid = np.where(rs.random((STEPS - 1, B, L)) < 0.5, 4,
                 rs.integers(0, 4, (STEPS - 1, B, L)))
  return samples, mid


class _Trajectory:
  """A JAX sampler returning one given trajectory."""

  def __init__(self, samples, mid):
    self.samples, self.mid_x = jnp.asarray(samples), jnp.asarray(mid)

  def __call__(self, key):
    return self


@pytest.fixture(scope='module')
def multisep_step(denoisers):
  """One step of JAX's ``MultiSepTrainer`` (2 Enformer bins, its jitted
  step on a given trajectory) and the port's on the same trajectory from
  the same stacked variables."""
  jdiff, diff = denoisers
  jm = JaxEnformer(**TINY)
  stacked = _stacked(jm, 50)
  samples, mid = _trajectory(51)
  tcfg = dict(learning_rate=LR, batch_size=B)
  jtrainer = jtrain_value.MultiSepTrainer(
      jdiff, jmultisep.MultiSepValueModel(jm, N_MODELS, STEPS),
      jax_motif_oracle(L), jtrain_value.ValueTrainerConfig(**tcfg))
  jtrainer._sampler = _Trajectory(samples, mid)
  jstacked = jax.tree.map(jnp.asarray, stacked)
  j0 = (jnp.asarray(0), jstacked, jtrainer.opt.init(jstacked),
        jax.random.key(52))
  j1, (jloss, jlosses) = jtrainer._train_step(j0, jtrainer._reward_vars)
  msm = multisep.MultiSepValueModel(multisep_from_jax(stacked), STEPS)
  trainer = train_value.MultiSepTrainer(
      diff, msm, rewards.synthetic_motif_oracle(L),
      train_value.ValueTrainerConfig(**tcfg))
  state = trainer.init_state(0)
  loss, losses = trainer.grad_step(state, _t(samples), _t(mid))
  return {'jtrainer': jtrainer, 'stacked': stacked, 'j1': j1,
          'jloss': jloss, 'jlosses': jlosses, 'state': state, 'loss': loss,
          'losses': losses, 'trainer': trainer}


def test_multisep_trainer_step_matches_svdd_tpu(multisep_step):
  """One step of ``MultiSepTrainer`` (AdamW at optax's defaults, no
  clipping) against JAX's on the same trajectory and stacked variables:
  the mean and per-bin losses, each leaf's gradient (JAX's recovered
  from Adam's first moment), and every updated leaf (parameters and
  running statistics) and Adam moment as optax's AdamW makes them from
  the same start on the port's gradients."""
  r = multisep_step
  np.testing.assert_allclose(float(r['loss']), float(r['jloss']), rtol=1e-5)
  np.testing.assert_allclose(r['losses'].numpy(), _np(r['jlosses']),
                             rtol=1e-5)
  state = r['state']
  assert state.step == int(r['j1'][0]) == 1 and state.optimizer.count == 1
  jadam = r['j1'][2][0]
  # Adam's first moment after one update from zero is (1 - b1) g
  jgrads = multisep_from_jax(jax.tree.map(
      lambda m: np.asarray(m) / 0.1, jadam.mu))
  grads = {}
  for i, (trunk, want) in enumerate(zip(state.msm.trunks, jgrads)):
    got = _grads(trunk)
    _assert_named_close(got, _leaves(want))
    grads[i] = got
  # the update optax makes from the start on the port's gradients
  port_tree = _port_tree(state.msm, lambda t: t.grad)
  tx = optax.adamw(LR)
  start = jax.tree.map(jnp.asarray, r['stacked'])
  upd, adam = tx.update(port_tree, tx.init(start), start)
  want_after = multisep_from_jax(jax.tree.map(
      np.asarray, optax.apply_updates(start, upd)))
  want_mu = multisep_from_jax(jax.tree.map(np.asarray, adam[0].mu))
  st = state.optimizer.adamw.state
  for trunk, after, mu in zip(state.msm.trunks, want_after, want_mu):
    _assert_named_close(_leaves(trunk), _leaves(after), rtol=1e-6,
                        floor=1e-9)
    named = list(trunk.named_parameters()) + list(trunk.named_buffers())
    _assert_named_close({k: st[t]['exp_avg'].double().numpy()
                         for k, t in named}, _leaves(mu), rtol=1e-6,
                        floor=1e-9)


def _port_tree(msm, of):
  """The flax stacked tree (jnp) of ``of(leaf)`` over the port's trunks,
  through each trunk's module layout."""
  from svdd_tpu_torch.weights import enformer_params_to_jax
  trees = []
  for trunk in msm.trunks:
    params = enformer_params_to_jax(
        {k: of(p) for k, p in trunk.named_parameters()}, trunk)
    stats = enformer_params_to_jax(
        {k: of(b) for k, b in trunk.named_buffers()}, trunk, stats=True)
    trees.append({'params': params, 'batch_stats': stats})
  return jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *trees)


def test_multisep_state_round_trip(multisep_step, tmp_path):
  """``save_state`` then ``restore_state``: every leaf, AdamW's moments
  and count, the generator and the step come back bit for bit."""
  r = multisep_step
  trainer, state = r['trainer'], r['state']
  path = str(tmp_path / 'multisep_state.pt')
  trainer.save_state(path, state)
  before = {k: v.copy() for k, v in _leaves(state.msm).items()}
  restored = trainer.restore_state(path, 99)
  assert restored.step == 1 and restored.optimizer.count == 1
  assert torch.equal(restored.generator.get_state(),
                     state.generator.get_state())
  got = _leaves(restored.msm)
  assert all(np.array_equal(got[k], before[k]) for k in before)
  ckpt = torch.load(path, weights_only=True)
  st = restored.optimizer.adamw.state_dict()
  for i, saved in ckpt['optimizer']['adamw']['state'].items():
    assert torch.equal(st['state'][i]['exp_avg'], saved['exp_avg'])


@pytest.fixture
def flax_masks(monkeypatch):
  return FlaxMasks().install(monkeypatch)


def test_timed_value_trainer_step_matches_svdd_tpu(denoisers, timed_vars,
                                                   flax_masks):
  """One MC grad step of ``ValueTrainer`` with the timed net (JAX's
  ``time_indices`` branch: each state's step into the module) on the
  same trajectory and dropout masks: the loss, the clipped gradients
  (JAX's from Adam's first moment) with the time table's, the tower's
  zero-gradient biases aside."""
  jdiff, diff = denoisers
  jm, variables = timed_vars
  kw = dict(learning_rate=LR, batch_size=B)
  jtrainer = jtrain_value.ValueTrainer(
      jdiff, jvalue.ValueFunction(jm, variables, L, timed=True),
      jax_motif_oracle(L), jtrain_value.ValueTrainerConfig(**kw))
  trainer = train_value.ValueTrainer(
      diff, value_lib.ValueFunction(enformer_value_from_jax(variables), L,
                                    timed=True),
      rewards.synthetic_motif_oracle(L), train_value.ValueTrainerConfig(**kw))
  samples, mid = _trajectory(60)
  masks = dropout_masks(np.random.default_rng(61), STEPS * B, 256)
  jstate = jtrainer.init_state(jax.random.key(62))
  flax_masks.set(masks)
  j1, jloss = jtrainer._grad_step(jstate, jnp.asarray(samples),
                                  jnp.asarray(mid), (), jtrainer._reward_vars)
  state = trainer.init_state(0)
  loss = trainer.grad_step(state, _t(samples), _t(mid),
                           masks=blocks.DropoutMasks(masks=masks))
  np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
  jgrads = jax.tree.map(lambda m: np.asarray(m) / 0.1, j1.opt_state[1][0].mu)
  got = {k: p.grad.double().numpy()
         for k, p in state.module.named_parameters()}
  want = {k: v for k, v in _as_port(
      {'params': jgrads, 'batch_stats': variables['batch_stats']}).items()
          if k in got}
  assert np.abs(got['time_embedding.embedding']).max() > 0
  # the tower's conv biases ahead of a training BatchNorm (zero in exact
  # arithmetic): the stem's and the first blocks'
  _assert_named_close(got, want, skip=(
      'tower.stem_bias', 'stem_block.bias', 'convs.0.bias', 'pools.0.bias'))


# ---------------------------------------------------------------------------
# cli.train --model multienformer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('task', ['dna', 'rna'])
def test_cli_train_multienformer_runs_on_cpu(task, tmp_path):
  """``cli.train --model multienformer``: ten trunks (the Enformer for
  dna, the ConvGRU for rna) binned over the trajectory's steps, two
  iterations, a finite loss, and the saved model file."""
  cfg = tiny_test_config(task)
  cfg.model.length = L
  cfg.sampling.steps = 12
  path = tmp_path / 'multisep.pt'
  args = cli_train.parser().parse_args(
      ['--task', task, '--device', 'cpu', '--model', 'multienformer',
       '--batch_size', '2', '--max_iters', '2', '--eval_every', '1',
       '--save_path', str(path)])
  out = cli_train.run(args, cfg=cfg,
                      value_kwargs=TINY if task == 'dna' else None)
  state = out['state']
  assert state.step == 2 and state.msm.n_models == 10
  assert state.msm.num_steps == 12
  loss, losses = out['trainer'].train_step(state)
  assert losses.shape == (10,) and torch.isfinite(losses).all()
  ckpt = torch.load(path, weights_only=True)
  assert ckpt['format'] == multisep.FORMAT and ckpt['task'] == task
  assert ckpt['n_models'] == 10 and ckpt['num_steps'] == 12
  json.dumps(ckpt['config'])
