"""The RNA 5'UTR task in svdd_tpu_torch vs svdd_tpu (tiny sizes: the
ConvGRU at its own widths, 64 channels; L=16, batch 4, 8 steps).

The ConvGRU value net and oracle (the GRU scan forward and reversed, the
trunk in eval and in training on JAX's injected dropout masks, the
input and parameter gradients), ``convgru_from_jax``, the analytic
sampler's mdlm functions and its step, noise removal and whole sampler
on JAX's Gumbel noise, one oracle step and one value-trainer step of
each package from the same weights, and the bf16 CNN layer's backward
at an RNA length against JAX's dispatch there.

Tolerances. f32 (TF32 off): outputs 1e-5 relative; gradients by norm,
5e-5 of their own norm plus 1e-6 of the largest leaf's (the ConvBlocks'
conv biases, ahead of a training BatchNorm, have a zero gradient in
exact arithmetic and rounding noise in f32, and are left out); running
statistics 1e-5; sampled tokens exact.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import mdlm as jmdlm
from svdd_tpu import value as jvalue
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models import convgru as jconvgru
from svdd_tpu.ops import cnn_layer_pallas as jcnn
from svdd_tpu.ops import conv1d_bwd_pallas as jconv_bwd
from svdd_tpu.rewards import synthetic_motif_oracle as jax_motif_oracle
from svdd_tpu.sampling import sampler as jsampler
from svdd_tpu.train import value as jtrain_value

from svdd_tpu_torch import mdlm, rewards
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import train_oracle
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.models import blocks, convgru
from svdd_tpu_torch.ops import cnn_layer, conv1d
from svdd_tpu_torch.sampling import sampler
from svdd_tpu_torch.train import value as train_value
from svdd_tpu_torch.weights import cnn_from_jax, convgru_from_jax
from torch_port_helpers import (FlaxMasks, few_torch_threads,  # noqa: F401
                                random_cnn_variables, random_variables)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L, B, STEPS = 16, 4, 8
KEEP = 0.9             # 1 - the ConvGRU's dropout


def _t(a):
  return torch.from_numpy(np.array(a))


def _np(a):
  return np.asarray(jnp.asarray(a, jnp.float32))


def _onehots(seed, n=B):
  tokens = np.random.default_rng(seed).integers(0, 5, (n, L))
  return mdlm.transform_samples(torch.from_numpy(tokens)).numpy()


def _zero_grad(name: str) -> bool:
  """The ConvBlocks' conv biases, which a training BatchNorm follows."""
  return name.startswith('trunk.tower.blocks.') and name.endswith('.bias') \
      and '.norm.' not in name


def _assert_named_close(got: dict, want: dict, rtol=5e-5, floor=1e-6,
                        skip_zero=False):
  """Each tensor within rtol of its norm plus ``floor`` of the largest
  one's norm, by norm."""
  assert set(got) == set(want), set(got) ^ set(want)
  norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
  top = max(norm(v) for v in want.values())
  bad = {k: (norm(got[k] - want[k]), norm(want[k])) for k in want
         if not (skip_zero and _zero_grad(k))
         and not norm(got[k] - want[k]) <= rtol * norm(want[k]) + floor * top}
  assert not bad, bad


@pytest.fixture
def flax_masks(monkeypatch):
  return FlaxMasks().install(monkeypatch)


@pytest.fixture(scope='module')
def gru_vars():
  """The flax ConvGRUValueModel's variables, drawn with numpy, the GRU's
  hidden kernels and biases at the scale of a trained net."""
  jm = jconvgru.ConvGRUValueModel()
  variables = random_variables(jm.init, jnp.zeros((1, L, 4)),
                               rs=np.random.default_rng(0))
  rs = np.random.default_rng(1)
  gp = variables['params']['ConvGRUTrunk_0']['GRUBlock_0']
  for cell in ('gru_fwd_0', 'gru_bwd_0'):
    gp[cell]['hh_kernel'] = (gp[cell]['hh_kernel'] / 8).astype(np.float32)
    gp[cell]['hh_bias'] = (0.1 * rs.normal(size=192)).astype(np.float32)
  return jm, variables


def _masks(rs, n, keep=KEEP):
  """The dropout masks of one ConvGRU training forward, in JAX's call
  order: the five ConvBlocks' D, then the FFN's up and down."""
  return ([rs.random((n, L, 64)) < keep for _ in range(5)]
          + [rs.random((n, L, 128)) < keep, rs.random((n, L, 64)) < keep])


def _grads_as_port(grads, variables) -> dict:
  """A JAX gradient tree as the port's {name: array}."""
  m = convgru_from_jax({'params': jax.tree.map(np.asarray, grads),
                        'batch_stats': variables['batch_stats']})
  return {k: p.detach().numpy() for k, p in m.named_parameters()}


# ---------------------------------------------------------------------------
# the GRU and the ConvGRU value net
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('c_in,hidden', [(8, 8), (6, 10)])
def test_gru_layer_matches_flax_scans(c_in, hidden):
  """``GRULayer``'s two directions against two flax ``GRUCellScan``s
  (reverse False and True) on their weights: flax's gate order r, z, n,
  the hidden bias inside the reset product, the reverse scan's outputs
  in the sequence's order."""
  rs = np.random.default_rng(2)
  x = rs.normal(size=(B, L, c_in)).astype(np.float32)
  layer = convgru.GRULayer(c_in, hidden, torch.Generator().manual_seed(0))
  for suffix, reverse in (('fwd', False), ('bwd', True)):
    cell = jconvgru.GRUCellScan(hidden, reverse=reverse)
    p = {'ih': {'kernel': rs.normal(size=(c_in, 3 * hidden)) / 3,
                'bias': 0.1 * rs.normal(size=3 * hidden)},
         'hh_kernel': rs.normal(size=(hidden, 3 * hidden)) / 3,
         'hh_bias': 0.1 * rs.normal(size=3 * hidden)}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    want = _np(cell.apply({'params': p}, jnp.asarray(x)))
    getattr(layer, f'ih_{suffix}').weight.data.copy_(_t(p['ih']['kernel'].T))
    getattr(layer, f'ih_{suffix}').bias.data.copy_(_t(p['ih']['bias']))
    getattr(layer, f'hh_kernel_{suffix}').data.copy_(_t(p['hh_kernel']))
    getattr(layer, f'hh_bias_{suffix}').data.copy_(_t(p['hh_bias']))
    got = layer(_t(x))[0 if suffix == 'fwd' else 1]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_convgru_eval_matches_svdd_tpu(gru_vars):
  """The eval forward and the input gradient of mean(out^2) (the
  classifier's and DPS's gradient) on the same weights."""
  jm, variables = gru_vars
  x = _onehots(3)
  loss = lambda xx: (jm.apply(variables, xx) ** 2).mean()
  want = _np(jm.apply(variables, jnp.asarray(x)))
  want_gx = _np(jax.grad(loss)(jnp.asarray(x)))
  model = convgru_from_jax(variables)
  xt = _t(x).requires_grad_(True)
  out = model(xt, fused=False)
  (out ** 2).mean().backward()
  assert out.shape == (B,) and out.dtype == torch.float32
  np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())
  np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=5e-5,
                             atol=1e-5 * np.abs(want_gx).max())
  with torch.inference_mode():
    np.testing.assert_array_equal(model(_t(x)).numpy(),
                                  model(_t(x), fused=False).numpy())


@pytest.mark.parametrize('dropout', ['on', 'off'])
def test_convgru_train_matches_svdd_tpu(gru_vars, dropout, flax_masks):
  """The training forward against ``apply(train=True,
  mutable=['batch_stats'])`` on the same weights and masks (all kept
  for 'off'): output, input gradient, every parameter's gradient and
  the moved running statistics."""
  jm, variables = gru_vars
  x = _onehots(4)
  masks = _masks(np.random.default_rng(5), B,
                 keep=KEEP if dropout == 'on' else 1.1)

  def loss(params, xx):
    out, upd = jm.apply({'params': params,
                         'batch_stats': variables['batch_stats']}, xx,
                        train=True, mutable=['batch_stats'],
                        rngs={'dropout': jax.random.key(0)})
    return (out ** 2).mean(), (out, upd)

  flax_masks.set(masks)
  (_, (want, upd)), (gp, gx) = jax.value_and_grad(
      loss, argnums=(0, 1), has_aux=True)(variables['params'],
                                          jnp.asarray(x))
  model = convgru_from_jax(variables)
  xt = _t(x).requires_grad_(True)
  source = blocks.DropoutMasks(masks=masks)
  out = model(xt, train=True, masks=source)
  (out ** 2).mean().backward()
  assert source.calls == 7
  np.testing.assert_allclose(out.detach().numpy(), _np(want), rtol=1e-5,
                             atol=1e-5 * np.abs(_np(want)).max())
  np.testing.assert_allclose(xt.grad.numpy(), _np(gx), rtol=5e-5,
                             atol=1e-5 * np.abs(_np(gx)).max())
  _assert_named_close({k: p.grad.numpy()
                       for k, p in model.named_parameters()},
                      _grads_as_port(gp, variables), skip_zero=True)
  moved = convgru_from_jax({'params': variables['params'],
                            'batch_stats': jax.tree.map(
                                np.asarray, upd['batch_stats'])})
  _assert_named_close({k: b.numpy() for k, b in model.named_buffers()},
                      {k: b.numpy() for k, b in moved.named_buffers()},
                      rtol=1e-5)


def test_convgru_train_forward_needs_masks(gru_vars):
  model = convgru_from_jax(gru_vars[1])
  with pytest.raises(ValueError, match='DropoutMasks'):
    model(_t(_onehots(6)), train=True)


def test_convgru_from_jax_copies_every_leaf(gru_vars):
  """Every flax parameter and statistic lands in one port tensor: the
  counts of values agree and the named leaves hold the flax values."""
  _, variables = gru_vars
  model = convgru_from_jax(variables)
  n_flax = sum(np.size(v) for v in jax.tree.leaves(variables))
  n_port = (sum(p.numel() for p in model.parameters())
            + sum(b.numel() for b in model.buffers()))
  assert n_port == n_flax
  p = variables['params']['ConvGRUTrunk_0']
  layer = model.trunk.gru.layers[0]
  np.testing.assert_array_equal(
      layer.hh_kernel_bwd.detach().numpy(),
      p['GRUBlock_0']['gru_bwd_0']['hh_kernel'])
  np.testing.assert_array_equal(
      model.trunk.tower.blocks[4].norm.var.numpy(),
      variables['batch_stats']['ConvGRUTrunk_0']['ConvTower_0'][
          'ConvBlock_4']['Norm_0']['BatchNorm_0']['var'])


@pytest.mark.parametrize('length', [16, 50])
def test_convgru_convs_take_the_plain_path_as_jax(length, monkeypatch):
  """The ConvGRU's k=5 convs at 64 channels are off JAX's Pallas conv
  backward gate and its im2col gate (C % 128), so JAX leaves them to
  XLA; the port's backward-kernel gate (B7) refuses them too, and a
  training conv records the fixed-order backward (``_ConvPlainBwd``)."""
  assert not jconv_bwd.conv_bwd_ok(B, length, 64, 64, 5, 1, 4)
  assert not conv1d.conv_bwd_ok(length, 64, 64, 5)
  assert conv1d.conv_bwd_ok(length, 128, 128, 5)
  calls = []
  orig = conv1d._ConvPlainBwd.apply
  monkeypatch.setattr(conv1d._ConvPlainBwd, 'apply',
                      lambda *a: calls.append(1) or orig(*a))
  model = convgru.ConvGRUValueModel(generator=torch.Generator()
                                    .manual_seed(0))
  x = torch.zeros(2, length, 4).requires_grad_(True)
  model(x, train=True, masks=blocks.DropoutMasks(
      generator=torch.Generator().manual_seed(1))).sum().backward()
  assert len(calls) == 6                    # the stem and five blocks


def test_value_factory_and_oracle_build_the_convgru(monkeypatch):
  """``build_value_module('rna')`` is the ConvGRU in f32 under
  SVDD_VALUE_BF16=1 (JAX returns it before reading the switch);
  ``RewardOracle.create_rna`` a one-task ConvGRU taking ``fused``; the
  RNA reward input is the one-hot. The saluki task's value net is the
  same four-channel ConvGRU, its oracle (``create_saluki``) takes six
  channels, and its reward input is the padded saluki tensor."""
  monkeypatch.setenv('SVDD_VALUE_BF16', '1')
  gen = torch.Generator().manual_seed(0)
  module = value_lib.build_value_module('rna', generator=gen)
  assert isinstance(module, convgru.ConvGRUValueModel)
  assert module.compute_dtype == torch.float32
  assert isinstance(jvalue.build_value_module('rna'),
                    jconvgru.ConvGRUValueModel)
  oracle = rewards.RewardOracle.create_rna(gen)
  x = _t(_onehots(7))
  with torch.inference_mode():
    assert torch.equal(oracle(x, fused=False), oracle(x))
  assert value_lib.make_reward_transform('rna') is mdlm.transform_samples
  saluki = value_lib.build_value_module('rna_saluki', generator=gen)
  assert isinstance(saluki, convgru.ConvGRUValueModel)
  assert saluki.in_channels == 4 and saluki.compute_dtype == torch.float32
  assert rewards.RewardOracle.create_saluki(gen).module.in_channels == 6
  tokens = torch.full((3, 7), 4)
  assert value_lib.make_reward_transform('rna_saluki', None, 16)(
      tokens).shape == (3, 16, 6)


# ---------------------------------------------------------------------------
# the analytic sampler
# ---------------------------------------------------------------------------


def _analytic_inputs(seed):
  rs = np.random.default_rng(seed)
  logits = rs.normal(size=(B, L, 5)).astype(np.float32)
  x = np.where(rs.random((B, L)) < 0.5, 4, rs.integers(0, 4, (B, L)))
  log_p = _np(jmdlm.subs_parameterization(jnp.asarray(logits),
                                          jnp.asarray(x), 4))
  sigma = rs.uniform(0.1, 2.0, B).astype(np.float32)
  return log_p, x, sigma


@pytest.mark.parametrize('sigma_2d', [False, True])
def test_get_score_matches_svdd_tpu(sigma_2d):
  log_p, x, sigma = _analytic_inputs(8)
  s = sigma[:, None] if sigma_2d else sigma
  want = _np(jmdlm.get_score(jnp.asarray(log_p), jnp.asarray(x),
                             jnp.asarray(s), 4))
  got = mdlm.get_score(_t(log_p), _t(x), _t(s), 4)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-30)


def test_staggered_score_and_transp_transition_match_svdd_tpu():
  log_p, x, sigma = _analytic_inputs(9)
  score = _np(jmdlm.get_score(jnp.asarray(log_p), jnp.asarray(x),
                              jnp.asarray(sigma), 4))
  dsigma = (sigma / 7).astype(np.float32)
  for ds in (dsigma, dsigma[:, None]):
    np.testing.assert_allclose(
        mdlm.staggered_score(_t(score), _t(ds), 4).numpy(),
        _np(jmdlm.staggered_score(jnp.asarray(score), jnp.asarray(ds), 4)),
        rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(
        mdlm.transp_transition(_t(x), _t(ds), 5, 4).numpy(),
        _np(jmdlm.transp_transition(jnp.asarray(x), jnp.asarray(ds), 5, 4)),
        rtol=1e-6, atol=0)


def test_sample_categorical_probs_matches_svdd_tpu():
  """On JAX's Gumbel noise of the key: the same tokens, zero
  probabilities never drawn."""
  rs = np.random.default_rng(10)
  probs = rs.random((B, L, 5)).astype(np.float32)
  probs[..., 4] = 0
  key = jax.random.key(11)
  want = np.asarray(jmdlm.sample_categorical_probs(key, jnp.asarray(probs)))
  gumbel = _np(jax.random.gumbel(key, probs.shape, jnp.float32))
  got = mdlm.sample_categorical_probs(_t(probs), _t(gumbel))
  np.testing.assert_array_equal(got.numpy(), want)
  assert (want != 4).all()


@pytest.fixture(scope='module')
def rna_denoisers():
  """A tiny RNA denoiser (L=16, 8 steps, the analytic predictor) in both
  packages on the same weights."""
  cfg = jax_tiny_config('rna')
  cfg.sampling.steps = STEPS
  cfg.sampling.predictor = 'analytic'
  variables = random_cnn_variables(cfg, np.random.default_rng(12))
  tcfg = tiny_test_config('rna')
  tcfg.sampling.steps = STEPS
  tcfg.sampling.predictor = 'analytic'
  assert tcfg.model.length == cfg.model.length == L
  return (JaxDiffusion(cfg, variables=variables),
          Diffusion(tcfg, device='cpu', backbone=cnn_from_jax(variables)))


def test_analytic_step_and_denoiser_final_match_svdd_tpu(rna_denoisers):
  """One analytic step and the analytic noise removal on JAX's Gumbel
  noise: the same tokens."""
  jdiff, diff = rna_denoisers
  rs = np.random.default_rng(13)
  x = np.where(rs.random((B, L)) < 0.6, 4, rs.integers(0, 4, (B, L)))
  t, t_next = jnp.float32(0.6), jnp.float32(0.5)
  key = jax.random.key(14)
  jden = lambda xx, s: jdiff.forward(jdiff.variables, xx, s)
  jstep = jsampler.analytic_step(jden, jdiff.schedule, 4, 5)
  _, want = jstep((), jnp.asarray(x), t, t_next, key)
  gumbel = _t(_np(jax.random.gumbel(key, (B, L, 5), jnp.float32)))
  step = sampler.analytic_step(diff.forward, diff.schedule, 4, 5)
  got = step(_t(x), torch.tensor(0.6), torch.tensor(0.5), None, gumbel)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  want = jsampler.denoiser_final(jden, jdiff.schedule, 4, 5, jnp.asarray(x),
                                 jnp.float32(1e-5), key)
  got = sampler.denoiser_final(diff.forward, diff.schedule, 4, 5, _t(x),
                               torch.tensor(1e-5), None, gumbel)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  assert (got != 4).all()


def test_analytic_sampler_matches_svdd_tpu(rna_denoisers, monkeypatch):
  """``sampling.predictor='analytic'``: the whole sampler, its steps and
  its ``denoiser_final`` removal, on the noise JAX's loop draws from its
  key (scan_key split a step, then final_key)."""
  jdiff, diff = rna_denoisers
  key = jax.random.key(15)
  want = jdiff.sampler(B)(key)
  _, k, final_key = jax.random.split(key, 3)
  noise = []
  for _ in range(STEPS):
    k, sub = jax.random.split(k)
    noise.append(_t(_np(jax.random.gumbel(sub, (B, L, 5), jnp.float32))))
  noise.append(_t(_np(jax.random.gumbel(final_key, (B, L, 5),
                                        jnp.float32))))
  monkeypatch.setattr(mdlm, 'gumbel_noise',
                      lambda shape, generator, device=None: noise.pop(0))
  got = diff.sampler(B)(torch.Generator())
  assert not noise
  np.testing.assert_array_equal(got.samples.numpy(),
                                np.asarray(want.samples))


# ---------------------------------------------------------------------------
# one oracle step and one value step of each package
# ---------------------------------------------------------------------------


def test_oracle_step_matches_svdd_tpu(gru_vars, flax_masks):
  """``cli.train_oracle``'s step for the RNA oracle against the JAX
  CLI's (optax.adamw(1e-3) at its defaults, the MSE against the first
  label column): the loss, the parameters after the update (the
  zero-gradient conv biases left out: AdamW's first update moves an
  element by the full rate whatever its gradient's size) and the
  running statistics, from the same weights and masks."""
  jm, variables = gru_vars
  rs = np.random.default_rng(16)
  seqs = rs.integers(0, 4, (B, L))
  labels = rs.normal(size=(B, 3)).astype(np.float32)
  masks = _masks(rs, B)
  opt = optax.adamw(1e-3)
  params = variables['params']
  opt_state = opt.init(params)

  def loss_fn(p):
    preds, upd = jm.apply({'params': p,
                           'batch_stats': variables['batch_stats']},
                          jax.nn.one_hot(jnp.asarray(seqs), 4), train=True,
                          mutable=['batch_stats'],
                          rngs={'dropout': jax.random.key(0)})
    return jnp.mean((preds - jnp.asarray(labels)[:, 0]) ** 2), upd

  flax_masks.set(masks)
  (jloss, upd), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
  u, _ = opt.update(g, opt_state, params)
  new = convgru_from_jax({'params': jax.tree.map(
      np.asarray, optax.apply_updates(params, u)), 'batch_stats':
      jax.tree.map(np.asarray, upd['batch_stats'])})

  module = convgru_from_jax(variables).train()
  optimizer = train_oracle.make_optimizer(module, 1e-3)
  loss = train_oracle.train_step(module, optimizer, _t(seqs), _t(labels),
                                 blocks.DropoutMasks(masks=masks))
  np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
  got = {k: p.detach().numpy() for k, p in module.named_parameters()}
  want = {k: p.detach().numpy() for k, p in new.named_parameters()}
  _assert_named_close(got, want, rtol=1e-5, floor=1e-7, skip_zero=True)
  _assert_named_close({k: b.numpy() for k, b in module.named_buffers()},
                      {k: b.numpy() for k, b in new.named_buffers()},
                      rtol=1e-5)


def test_value_trainer_step_matches_svdd_tpu(gru_vars, rna_denoisers,
                                             flax_masks):
  """One MC grad step of ``ValueTrainer(task='rna')`` from the same
  ConvGRU weights, trajectory and masks as JAX's (clip 1.0, AdamW betas
  (0.9, 0.95), weight decay 0.1, rate 1e-3, the synthetic motif oracle):
  the loss, the clipped gradients (JAX's recovered from Adam's first
  moment), the running statistics and the counts."""
  jm, variables = gru_vars
  jdiff, diff = rna_denoisers
  kw = dict(learning_rate=1e-3, batch_size=B, task='rna')
  jtrainer = jtrain_value.ValueTrainer(
      jdiff, jvalue.ValueFunction(jm, variables, L), jax_motif_oracle(L),
      jtrain_value.ValueTrainerConfig(**kw))
  trainer = train_value.ValueTrainer(
      diff, value_lib.ValueFunction(convgru_from_jax(variables), L),
      rewards.synthetic_motif_oracle(L), train_value.ValueTrainerConfig(**kw))
  rs = np.random.default_rng(17)
  samples = rs.integers(0, 4, (B, L))
  mid = np.where(rs.random((STEPS - 1, B, L)) < 0.5, 4,
                 rs.integers(0, 4, (STEPS - 1, B, L)))
  masks = _masks(rs, STEPS * B)
  jstate = jtrainer.init_state(jax.random.key(18))
  flax_masks.set(masks)
  jstate, jloss = jtrainer._grad_step(jstate, jnp.asarray(samples),
                                      jnp.asarray(mid), (),
                                      jtrainer._reward_vars)
  state = trainer.init_state(0)
  loss = trainer.grad_step(state, _t(samples), _t(mid),
                           masks=blocks.DropoutMasks(masks=masks))
  np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
  assert state.step == int(jstate.step) == 1
  assert state.optimizer.count == int(jstate.opt_state[1][0].count) == 1
  jgrads = jax.tree.map(lambda m: np.asarray(m, np.float64) / 0.1,
                        jstate.opt_state[1][0].mu)
  _assert_named_close({k: p.grad.numpy()
                       for k, p in state.module.named_parameters()},
                      _grads_as_port(jgrads, variables), skip_zero=True)
  moved = convgru_from_jax({'params': variables['params'],
                            'batch_stats': jax.tree.map(
                                np.asarray,
                                jstate.extras['batch_stats'])})
  _assert_named_close({k: b.numpy() for k, b in
                       state.module.named_buffers()},
                      {k: b.numpy() for k, b in moved.named_buffers()},
                      rtol=1e-5)


# ---------------------------------------------------------------------------
# the bf16 CNN layer's backward at an RNA length
# ---------------------------------------------------------------------------


def _layer_inputs(seed, n, l):
  rs = np.random.default_rng(seed)
  c = 128
  return (rs.normal(size=(n, l, c)), 0.3 * rs.normal(size=(n, c)),
          rs.uniform(0.7, 1.3, c), 0.1 * rs.normal(size=c),
          rs.normal(size=(9, c, c)) / np.sqrt(9 * c), 0.1 * rs.normal(size=c),
          rs.normal(size=(n, l, c)))


def _is_bf16(a) -> bool:
  a = np.asarray(a, np.float32)
  return np.array_equal(a, _np(jnp.asarray(a, jnp.bfloat16)))


@pytest.mark.parametrize('dilation', [1, 4, 16])
def test_cnn_layer_bwd_bf16_at_rna_length_rounds_as_jax_dispatch(dilation):
  """Below L = 100 JAX's dispatch differentiates ``cnn_layer_reference``
  (``pallas_bwd_len_ok``), whose bf16 VJP returns the LN scale, LN bias
  and conv bias gradients as bf16 values (those parameters are cast to
  bf16 in the forward) and rounds the tap sum and its products before
  the LN backward. At L = 50 the port's plain backward (the rounding B6
  makes on the card) returns every gradient as a bf16 value as JAX's
  VJP does, and each within 2^-8 by norm of JAX's (2^-6 for the sums
  over rows, the bias row's and the parameters': XLA's CPU reduces bf16
  sums in another order than the f32 sum the port rounds once); the
  weight gradient is JAX's, one f32
  sum rounded once, to 2^-12. From L = 100, where JAX takes the Pallas
  backward, the LN and conv-bias gradients stay f32 sums."""
  assert cnn_layer.PALLAS_BWD_MIN_L == jcnn._PALLAS_BWD_MIN_L
  assert cnn_layer.bwd_rounds_as_reference(50)
  assert not cnn_layer.bwd_rounds_as_reference(100)
  assert jcnn.pallas_bwd_len_ok(100) and not jcnn.pallas_bwd_len_ok(50)
  inputs = _layer_inputs(dilation, 4, 50)
  bf = jnp.bfloat16
  jargs = [jnp.asarray(a, bf if i in (0, 1, 4, 6) else jnp.float32)
           for i, a in enumerate(inputs)]
  with jax.disable_jit():
    _, vjp = jax.vjp(lambda *a: jcnn.cnn_layer_reference(
        *a, dilation=dilation), *jargs[:6])
    want = [_np(g) for g in vjp(jargs[6])]
  targs = [_t(_np(a)) for a in jargs]
  for i in (0, 1, 4, 6):
    targs[i] = targs[i].bfloat16()
  got = [g.float().numpy() for g in cnn_layer.cnn_layer_bwd_plain(
      *targs[:6], targs[6], dilation)]
  names = ('dx', 'dbias_row', 'dln_scale', 'dln_bias', 'dkernel',
           'dconv_bias')
  for name, g, w in zip(names, got, want):
    assert _is_bf16(g) and _is_bf16(w), name
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    tol = {'dx': 2 ** -8, 'dkernel': 2 ** -12}.get(name, 2 ** -6)
    assert rel <= tol, (name, rel)

  long_args = [_t(a).float() for a in _layer_inputs(dilation, 2, 100)]
  for i in (0, 1, 4, 6):
    long_args[i] = long_args[i].bfloat16()
  grads = cnn_layer.cnn_layer_bwd_plain(*long_args[:6], long_args[6],
                                        dilation)
  assert not any(_is_bf16(grads[i].numpy()) for i in (2, 3, 5))
