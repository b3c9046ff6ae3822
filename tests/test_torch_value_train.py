"""Value-net training in svdd_tpu_torch vs svdd_tpu (tiny sizes: the
Enformer at channels 256, 3 conv blocks, one transformer block, 2 heads;
L=16, batch 4, 8 steps).

The random parts are pinned: JAX's dropout masks are injected into both
(flax's ``nn.Dropout.__call__`` patched, in this file only, to take them
in call order from a list made with numpy; the port's forward takes the
same list), and the samplers' Gumbel noise is JAX's, drawn from the keys
its reverse loop splits. Float32 with TF32 off.

Tolerances. f32: forwards and targets 1e-5 relative; a gradient's
distance by norm 5e-5 of its own norm plus 1e-6 of the largest
gradient's (the L=2 attention's gradient and the pools' sums run in
another order than XLA's, about 1e-5 relative, and the tower's biases
ahead of a training BatchNorm, which subtracts the batch mean, have a
zero gradient in exact arithmetic, rounding noise in f32); the running
statistics 1e-5 relative. Trainer steps are each taken from JAX's state
(parameters, statistics, Adam's moments and count): the loss 1e-5
relative, the clipped gradients as above, and the update as optax's
AdamW makes it from JAX's state on the port's gradients, to 1e-6 (AdamW's
first update, lr * g / (|g| + eps), turns an element whose gradient lies
within rounding of 0 by the full rate, so the updates of the two
packages' own gradients are not compared element by element). bf16
(SVDD_VALUE_BF16's compute dtype) by ROADMAP's
rule: within twice JAX's own bf16-to-f32 distance plus 2^-8 of the f32
result's size, JAX compiled with ``xla_allow_excess_precision`` off.
"""

import numpy as np
import optax
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from svdd_tpu import utils as jutils
from svdd_tpu import value as jvalue
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer
from svdd_tpu.rewards import synthetic_motif_oracle as jax_motif_oracle
from svdd_tpu.train import value as jtrain_value

from svdd_tpu_torch import mdlm, rewards, utils
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.models import blocks
from svdd_tpu_torch.ops import fused_sample
from svdd_tpu_torch.sampling import guidance
from svdd_tpu_torch.train import value as train_value
from svdd_tpu_torch.weights import (cnn_from_jax, enformer_params_to_jax,
                                    enformer_to_jax, enformer_value_from_jax)
from torch_port_helpers import (FlaxMasks, dropout_masks,  # noqa: F401
                                few_torch_threads, random_cnn_variables,
                                random_variables)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L, B, STEPS = 16, 4, 8
TINY = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2)
KEEP = 0.6            # 1 - ff_dropout
LR = 2e-4
# the tower biases ahead of a training BatchNorm (every tower bias before
# the last conv block's; their gradient is 0 in exact arithmetic)
ZERO_GRAD_JAX = ('stem_conv', 'stem_block/Conv1D_0', 'conv_1/Conv1D_0',
                 'pool_1/Conv1D_0')


def _t(a):
  return torch.from_numpy(np.array(a))


def _flat(tree, path=''):
  """{'/a/b': float64 array} of a nested dict of arrays."""
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flat(v, f'{path}/{k}'))
    return out
  return {path: np.asarray(tree, np.float64)}


def _zero_grad(leaf: str) -> bool:
  return any(f'/{name}/bias' in leaf for name in ZERO_GRAD_JAX)


def _assert_tree_close(got, want, rtol=1e-5, floor=1e-6, skip_zero=False):
  """Each leaf within rtol of its norm plus ``floor`` of the largest
  leaf's norm, by norm (``skip_zero``: the ZERO_GRAD biases left out)."""
  got, want = _flat(got), _flat(want)
  assert set(got) == set(want), set(got) ^ set(want)
  norm = np.linalg.norm
  top = max(norm(v) for v in want.values())
  bad = {k: (norm(got[k] - want[k]), norm(want[k])) for k in want
         if not (skip_zero and _zero_grad(k))
         and not norm(got[k] - want[k]) <= rtol * norm(want[k]) + floor * top}
  assert not bad, bad


# ---------------------------------------------------------------------------
# JAX's dropout masks, injected
# ---------------------------------------------------------------------------


@pytest.fixture
def flax_masks(monkeypatch):
  return FlaxMasks().install(monkeypatch)


def _masks(rs, n, keep=KEEP):
  return dropout_masks(rs, n, TINY['channels'], keep=keep)


@pytest.fixture(scope='module')
def value_vars():
  jm = JaxEnformer(**TINY)
  return jm, random_variables(jm.init, jnp.zeros((1, L, 4)),
                              rs=np.random.default_rng(40))


def _onehots(seed, n=B):
  tokens = np.random.default_rng(seed).integers(0, 5, (n, L))
  return mdlm.transform_samples(torch.from_numpy(tokens)).numpy()


# ---------------------------------------------------------------------------
# BatchNorm, dropout and the training forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batchnorm_train_matches_flax(dtype):
  """flax's BatchNorm(use_running_average=False, momentum 0.9): the
  output (f32 statistics, its normalisation order, one rounding to the
  activation dtype) and the moved running averages (biased variance).
  f32 1e-5 relative; bf16 one ulp (the f32 means sum in another order)."""
  rs = np.random.default_rng(1)
  c = 16
  x = (rs.normal(size=(4, 8, c)) * 2 + 1).astype(np.float32)
  params = {'scale': rs.uniform(0.5, 1.5, c).astype(np.float32),
            'bias': rs.normal(size=c).astype(np.float32)}
  stats = {'mean': rs.normal(size=c).astype(np.float32),
           'var': rs.uniform(0.5, 1.5, c).astype(np.float32)}
  jdt = getattr(jnp, dtype)
  bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                    dtype=jdt)
  want, upd = bn.apply({'params': params, 'batch_stats': stats},
                       jnp.asarray(x).astype(jdt), mutable=['batch_stats'])
  norm = blocks.BatchNorm(c)
  for name, v in {**params, **stats}.items():
    getattr(norm, name).data.copy_(_t(v))
  tdt = getattr(torch, dtype)
  got = norm(_t(x).to(tdt), train=True)
  assert got.dtype == tdt
  want = np.asarray(want.astype(jnp.float32))
  tol = 1e-5 if dtype == 'float32' else 2 ** -8
  np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                             atol=tol * np.abs(want).max())
  for name in ('mean', 'var'):
    np.testing.assert_allclose(getattr(norm, name).numpy(),
                               np.asarray(upd['batch_stats'][name]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dropout_matches_flax(dtype, flax_masks):
  """flax's Dropout(0.4) on the same mask bit for bit: x / keep in the
  activation dtype (bf16: keep rounded to bf16, as JAX rounds the Python
  float), zeros elsewhere; rate 0 returns the input and takes no mask."""
  rs = np.random.default_rng(2)
  x = rs.normal(size=(4, 2, 32)).astype(np.float32)
  mask = rs.random(x.shape) < KEEP
  jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
  flax_masks.set([mask])
  want = nn.Dropout(0.4, deterministic=False).apply(
      {}, jnp.asarray(x).astype(jdt))
  source = blocks.DropoutMasks(masks=[mask])
  got = blocks.dropout(_t(x).to(tdt), 0.4, source)
  np.testing.assert_array_equal(got.float().numpy(),
                                np.asarray(want.astype(jnp.float32)))
  y = _t(x).to(tdt)
  assert blocks.dropout(y, 0.0, source) is y and source.calls == 1


def _jax_train(jm, variables, x, masks, flax_masks, excess_precision=True):
  """JAX's training forward of the value model: (output, d mean(out^2) /
  d params, d .. / d x, updated batch_stats)."""

  def loss(params, xx):
    out, upd = jm.apply({'params': params,
                         'batch_stats': variables['batch_stats']}, xx,
                        train=True, mutable=['batch_stats'],
                        rngs={'dropout': jax.random.key(0)})
    return (out.astype(jnp.float32) ** 2).mean(), (out, upd)

  flax_masks.set(masks)
  fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
  args = (variables['params'], jnp.asarray(x))
  if not excess_precision:
    fn = fn.lower(*args).compile({'xla_allow_excess_precision': False})
  (_, (out, upd)), (gp, gx) = fn(*args)
  return (np.asarray(out.astype(jnp.float32)), gp,
          np.asarray(gx.astype(jnp.float32)), upd['batch_stats'])


def _port_train(model, x, masks):
  xt = _t(x).requires_grad_(True)
  out = model(xt, train=True, masks=blocks.DropoutMasks(masks=masks))
  (out.float() ** 2).mean().backward()
  named = dict(model.named_parameters())
  return (out.detach().float().numpy(),
          enformer_params_to_jax({k: p.grad for k, p in named.items()},
                                 model),
          xt.grad.numpy(), enformer_to_jax(model)['batch_stats'])


@pytest.mark.parametrize('dropout', ['on', 'off'])
def test_train_enformer_matches_svdd_tpu(value_vars, dropout, flax_masks):
  """The training forward against ``apply(train=True,
  mutable=['batch_stats'])`` on the same weights and masks (all kept for
  'off'): the output, the input gradient, every parameter's gradient and
  the updated running statistics, f32. The tower takes its plain form
  (every pool B4 / B8, every k=5 conv B7 on the card)."""
  jm, variables = value_vars
  x = _onehots(41)
  rs = np.random.default_rng(42)
  masks = _masks(rs, B, keep=KEEP if dropout == 'on' else 1.1)
  want = _jax_train(jm, variables, x, masks, flax_masks)
  got = _port_train(enformer_value_from_jax(variables), x, masks)
  np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                             atol=1e-5 * np.abs(want[0]).max())
  np.testing.assert_allclose(got[2], want[2], rtol=5e-5,
                             atol=1e-5 * np.abs(want[2]).max())
  _assert_tree_close(got[1], want[1], rtol=5e-5)
  _assert_tree_close(got[3], want[3])


def test_train_enformer_bf16_matches_svdd_tpu(value_vars, flax_masks,
                                              monkeypatch):
  """The same in bf16, JAX compiled with ``xla_allow_excess_precision``
  off (it then rounds where its ops do one at a time, as the port does)
  and ``jax.nn.sigmoid`` of bf16 computed in f32 and rounded once (XLA's
  CPU bf16 logistic rounds three intermediates): the output, the input
  gradient, the parameter gradients and the statistics within twice
  JAX's own bf16-to-f32 distance plus 2^-8 of the f32 result's size."""
  jm, variables = value_vars
  x = _onehots(43)
  masks = _masks(np.random.default_rng(44), B)
  f32 = _jax_train(jm, variables, x, masks, flax_masks)
  sig = jax.nn.sigmoid
  monkeypatch.setattr(jax.nn, 'sigmoid',
                      lambda v: sig(v.astype(jnp.float32)).astype(v.dtype))
  jm16 = JaxEnformer(**TINY, compute_dtype=jnp.bfloat16)
  want = _jax_train(jm16, variables, x, masks, flax_masks,
                    excess_precision=False)
  got = _port_train(enformer_value_from_jax(variables, torch.bfloat16), x,
                    masks)
  norm = np.linalg.norm
  for i in (0, 2):
    assert (norm(got[i] - want[i])
            <= 2 * norm(want[i] - f32[i]) + 2 ** -8 * norm(f32[i]))
  for g, w, f in ((got[1], want[1], f32[1]), (got[3], want[3], f32[3])):
    g, w, f = _flat(g), _flat(w), _flat(f)
    bad = [k for k in w if not _zero_grad(k)
           and not norm(g[k] - w[k]) <= 2 * norm(w[k] - f[k])
           + 2 ** -8 * norm(f[k])]
    assert not bad, bad


def test_enformer_to_jax_inverts_from_jax(value_vars):
  _, variables = value_vars
  _assert_tree_close(enformer_to_jax(enformer_value_from_jax(variables)),
                     variables, rtol=0, floor=0)


def test_train_forward_needs_masks(value_vars):
  """A training forward without its dropout masks raises; the eval
  forward is unchanged by the training one's existence."""
  _, variables = value_vars
  model = enformer_value_from_jax(variables)
  with pytest.raises(ValueError, match='DropoutMasks'):
    model(_t(_onehots(45)), train=True)


# ---------------------------------------------------------------------------
# the targets
# ---------------------------------------------------------------------------


def _trajectory(seed, steps=STEPS):
  rs = np.random.default_rng(seed)
  samples = rs.integers(0, 4, (B, L))
  mid = np.where(rs.random((steps - 1, B, L)) < 0.5, 4,
                 rs.integers(0, 4, (steps - 1, B, L)))
  return samples, mid


@pytest.mark.parametrize('subsample', [None, 3])
def test_mc_targets_match_svdd_tpu(subsample):
  """``mc_targets`` on the motif oracle: one-hots, targets and time
  indices; with ``num_subsample`` the steps JAX draws from its key,
  injected."""
  samples, mid = _trajectory(50)
  key = jax.random.key(51)
  want = jvalue.mc_targets(jnp.asarray(samples), jnp.asarray(mid),
                           jax_motif_oracle(L), subsample_key=key,
                           num_subsample=subsample)
  idx = (None if subsample is None else np.array(
      jax.random.choice(key, STEPS - 1, (subsample,), replace=False)))
  got = value_lib.mc_targets(_t(samples), _t(mid),
                             rewards.synthetic_motif_oracle(L),
                             num_subsample=subsample, subsample_idx=idx)
  np.testing.assert_array_equal(got.onehots.numpy(),
                                np.asarray(want.onehots))
  np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                             rtol=1e-6)
  np.testing.assert_array_equal(got.time_indices.numpy(),
                                np.asarray(want.time_indices))


def test_cdq_targets_match_svdd_tpu(value_vars):
  """``cdq_targets``: the next step's candidates' mean value (the value
  net in eval mode) for the mid states, the reward for the final ones."""
  jm, variables = value_vars
  samples, mid = _trajectory(52)
  rs = np.random.default_rng(53)
  cands = rs.integers(0, 5, (STEPS, B, 3, L))
  want = jvalue.cdq_targets(jnp.asarray(samples), jnp.asarray(mid),
                            jnp.asarray(cands), jax_motif_oracle(L),
                            lambda oh: jm.apply(variables, oh))
  model = enformer_value_from_jax(variables)
  got = value_lib.cdq_targets(_t(samples), _t(mid), _t(cands),
                              rewards.synthetic_motif_oracle(L), model)
  np.testing.assert_array_equal(got.onehots.numpy(),
                                np.asarray(want.onehots))
  np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                             rtol=1e-5, atol=1e-6)


def test_value_loss_and_reward_transform():
  """``value_loss`` is the MSE; the DNA oracle's input is the one-hot of
  ``mdlm.transform_samples``, and the RNA (MRL) oracle's too; the saluki
  oracle's is the padded six-channel input of
  ``mdlm.transform_samples_saluki``."""
  batch = value_lib.ValueBatch(torch.zeros(3, L, 4), torch.tensor([1., 2, 3]))
  assert float(value_lib.value_loss(lambda oh: torch.ones(3), batch)) == (
      pytest.approx(5 / 3))
  assert value_lib.make_reward_transform('dna') is mdlm.transform_samples
  assert value_lib.make_reward_transform('rna') is mdlm.transform_samples
  tokens = torch.tensor([[0, 4, 3]])
  six = value_lib.make_reward_transform('rna_saluki', torch.ones(2, 6),
                                        8)(tokens)
  assert six.shape == (1, 8, 6)
  torch.testing.assert_close(six, mdlm.transform_samples_saluki(
      tokens, torch.ones(2, 6), final_length=8))


# ---------------------------------------------------------------------------
# the samplers, on JAX's noise
# ---------------------------------------------------------------------------


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


def _step_noise(key, shape):
  """The Gumbel noise each step of JAX's reverse loop draws from ``key``
  (``reverse_process``: scan_key, then one split a step)."""
  _, k, _ = jax.random.split(key, 3)
  out = []
  for _ in range(STEPS):
    k, sub = jax.random.split(k)
    out.append(_t(np.array(jax.random.gumbel(sub, shape, jnp.float32))))
  return out


def _inject(monkeypatch, noises):
  """The port's draws take ``noises`` in order."""
  queue = list(noises)
  take = lambda shape, generator, device=None: queue.pop(0)
  monkeypatch.setattr(mdlm, 'gumbel_noise', take)
  monkeypatch.setattr(fused_sample, 'gumbel_noise', take)
  return queue


def test_collect_mid_and_eval_batches_match_svdd_tpu(denoisers, monkeypatch):
  """``sampler(collect_mid=True)``: the samples and ``mid_x`` (every
  state but the last) equal JAX's on its noise; then
  ``build_eval_timestep_batches`` over two trajectories: each step's
  one-hots and the final rewards."""
  jdiff, diff = denoisers
  key = jax.random.key(60)
  want = jdiff.sampler(B, collect_mid=True)(key)
  queue = _inject(monkeypatch, _step_noise(key, (B, L, 5)))
  got = diff.sampler(B, collect_mid=True)(torch.Generator())
  assert not queue and got.mid_x.shape == (STEPS - 1, B, L)
  np.testing.assert_array_equal(got.mid_x.numpy(), np.asarray(want.mid_x))
  np.testing.assert_array_equal(got.samples.numpy(), np.asarray(want.samples))

  key = jax.random.key(61)
  wb, wt = jtrain_value.build_eval_timestep_batches(
      jdiff, jax_motif_oracle(L), B, 2, key)
  noises = []
  for _ in range(2):
    key, sub = jax.random.split(key)
    noises += _step_noise(sub, (B, L, 5))
  _inject(monkeypatch, noises)
  gb, gt = train_value.build_eval_timestep_batches(
      diff, rewards.synthetic_motif_oracle(L), B, 2, torch.Generator())
  assert len(gb) == len(wb) == STEPS
  for g, w in zip(gb + gt, wb + wt):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_cdq_sampler_matches_svdd_tpu(denoisers, monkeypatch):
  """``cdq_sampler``: every step's 10 candidates (the aux, stacked), the
  trajectory (the last candidate) and ``mid_x`` equal JAX's on its
  noise."""
  jdiff, diff = denoisers
  key = jax.random.key(62)
  want = jdiff.cdq_sampler(B)(key)
  queue = _inject(monkeypatch, _step_noise(key, (B, 10, L, 5)))
  got = diff.cdq_sampler(B)(torch.Generator())
  assert not queue and got.extra.shape == (STEPS, B, 10, L)
  for g, w in ((got.extra, want.extra), (got.mid_x, want.mid_x),
               (got.samples, want.samples)):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  np.testing.assert_array_equal(got.extra[:-1, :, -1].numpy(),
                                got.mid_x.numpy())


def test_cdq_step_draws_through_the_candidate_kernel(denoisers, monkeypatch):
  """``cdq_step`` draws its candidates with ``_draw_candidates`` (B2 on
  the card) and keeps the last."""
  _, diff = denoisers
  seen = []
  draw = guidance._draw_candidates
  monkeypatch.setattr(guidance, '_draw_candidates',
                      lambda *a, **k: seen.append(a[3]) or draw(*a, **k))
  step = guidance.cdq_step(diff.forward, diff.schedule, diff.mask_index, 3)
  x = torch.full((B, L), 4)
  cands, x_next = step(None, x, torch.tensor(0.5), torch.tensor(0.4),
                       torch.Generator().manual_seed(0))
  assert seen == [3] and cands.shape == (B, 3, L)
  assert torch.equal(x_next, cands[:, -1])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _load_jax_state(state, jstate):
  """The JAX trainer state's parameters, statistics, Adam moments and
  counts into the port's state."""
  stats = jax.tree.map(np.asarray, jstate.extras['batch_stats'])
  as_module = lambda tree: dict(enformer_value_from_jax(
      {'params': jax.tree.map(np.asarray, tree),
       'batch_stats': stats}).named_parameters())
  src = enformer_value_from_jax({'params': jax.tree.map(np.asarray,
                                                        jstate.params),
                                 'batch_stats': stats})
  state.module.load_state_dict(src.state_dict())
  adam = jstate.opt_state[1][0]
  mu, nu = as_module(adam.mu), as_module(adam.nu)
  opt = state.optimizer
  count = int(adam.count)
  for k, p in state.module.named_parameters():
    opt.adamw.state[p] = {'step': torch.tensor(float(count)),
                          'exp_avg': mu[k].detach().clone(),
                          'exp_avg_sq': nu[k].detach().clone()}
  opt.count = count
  state.step = int(jstate.step)


def _adam(state, which):
  named = dict(state.module.named_parameters())
  st = state.optimizer.adamw.state
  return enformer_params_to_jax({k: st[p][which] for k, p in named.items()},
                                state.module)


def _trainers(denoisers, value_vars, lr_decay=False, dtype=torch.float32):
  jdiff, diff = denoisers
  jm, variables = value_vars
  kw = dict(learning_rate=LR, batch_size=B, lr_decay=lr_decay)
  if dtype == torch.bfloat16:
    jm = JaxEnformer(**TINY, compute_dtype=jnp.bfloat16)
  jtrainer = jtrain_value.ValueTrainer(
      jdiff, jvalue.ValueFunction(jm, variables, L), jax_motif_oracle(L),
      jtrain_value.ValueTrainerConfig(**kw))
  trainer = train_value.ValueTrainer(
      diff, value_lib.ValueFunction(enformer_value_from_jax(variables, dtype),
                                    L),
      rewards.synthetic_motif_oracle(L), train_value.ValueTrainerConfig(**kw))
  return jtrainer, trainer


def _check_step(state, jstate, jprev, jtrainer):
  """The port's state after a step from JAX's ``jprev`` against JAX's
  ``jstate`` after the same step. The clipped gradients (the port's
  ``.grad``, JAX's recovered from Adam's first moment) within 5e-5 by
  norm; the update as optax's AdamW makes it from ``jprev`` on the
  port's gradients (parameters and moments to 1e-6); the running
  statistics 1e-5."""
  named = dict(state.module.named_parameters())
  grads = enformer_params_to_jax({k: p.grad for k, p in named.items()},
                                 state.module)
  b1 = 0.9
  mu, mu_prev = jstate.opt_state[1][0].mu, jprev.opt_state[1][0].mu
  jgrads = jax.tree.map(lambda m, mp: (np.asarray(m, np.float64)
                                       - b1 * np.asarray(mp)) / (1 - b1),
                        mu, mu_prev)
  _assert_tree_close(grads, jgrads, rtol=5e-5)
  t = jtrainer.tcfg
  tx = optax.adamw(jtrainer._token_schedule() if t.lr_decay
                   else t.learning_rate, b1=t.betas[0], b2=t.betas[1],
                   weight_decay=t.weight_decay)
  upd, adam = tx.update(jax.tree.map(jnp.asarray, grads), jprev.opt_state[1],
                        jprev.params)
  got = enformer_to_jax(state.module)
  _assert_tree_close(got['params'], optax.apply_updates(jprev.params, upd),
                     rtol=1e-6, floor=1e-9)
  _assert_tree_close(_adam(state, 'exp_avg'), adam[0].mu, 1e-6, 1e-9)
  _assert_tree_close(_adam(state, 'exp_avg_sq'), adam[0].nu, 1e-6, 1e-9)
  _assert_tree_close(got['batch_stats'], jstate.extras['batch_stats'])


@pytest.mark.parametrize('lr_decay', [False, True],
                         ids=['constant', 'lr_decay'])
def test_value_trainer_steps_match_svdd_tpu(denoisers, value_vars, lr_decay,
                                            flax_masks):
  """Two MC grad steps of ``ValueTrainer``, each from JAX's state, on the
  same trajectories and dropout masks: the loss, the parameters, the
  running statistics and Adam's moments and counts (clip 1.0, AdamW
  betas (0.9, 0.95), weight decay 0.1; ``lr_decay``: the token schedule
  at the update count, rate 0 at the first update)."""
  jtrainer, trainer = _trainers(denoisers, value_vars, lr_decay)
  jstate = jtrainer.init_state(jax.random.key(70))
  state = trainer.init_state(0)
  masks = _masks(np.random.default_rng(71), STEPS * B)
  for s in range(2):
    samples, mid = _trajectory(72 + s)
    _load_jax_state(state, jstate)
    flax_masks.set(masks)
    jprev = jstate
    jstate, jloss = jtrainer._grad_step(jstate, jnp.asarray(samples),
                                        jnp.asarray(mid), (),
                                        jtrainer._reward_vars)
    loss = trainer.grad_step(state, _t(samples), _t(mid),
                             masks=blocks.DropoutMasks(masks=masks))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == int(jstate.step) == s + 1
    assert state.optimizer.count == int(jstate.opt_state[1][0].count)
    assert state.tokens == pytest.approx(float(jstate.tokens))
    _check_step(state, jstate, jprev, jtrainer)


def test_value_trainer_bf16_step_matches_svdd_tpu(denoisers, value_vars,
                                                  flax_masks, monkeypatch):
  """One MC grad step with the value net in bf16 on both sides, from
  JAX's state: JAX's step compiled with ``xla_allow_excess_precision``
  off (it then rounds where its ops do one at a time, as the port does),
  its bf16 sigmoid rounded once, and its pool and L=2 attention
  dispatched as on a TPU (their Pallas bodies, forward and backward, in
  interpret mode), whose rounding the port follows. The loss, the
  clipped gradients and the running statistics within twice JAX's own
  bf16-to-f32 distance plus 2^-8 of the f32 step's size (the
  zero-gradient biases aside, whose gradient is rounding noise in either
  dtype); the update as optax's AdamW makes it on the port's gradients,
  to 1e-6."""
  samples, mid = _trajectory(80)
  masks = _masks(np.random.default_rng(81), STEPS * B)
  args = (jnp.asarray(samples), jnp.asarray(mid), ())
  jtrainer32, _ = _trainers(denoisers, value_vars)
  j0 = jtrainer32.init_state(jax.random.key(82))
  flax_masks.set(masks)
  j32, jloss32 = jtrainer32._grad_step(j0, *args, jtrainer32._reward_vars)
  sig = jax.nn.sigmoid
  monkeypatch.setattr(jax.nn, 'sigmoid',
                      lambda v: sig(v.astype(jnp.float32)).astype(v.dtype))
  from svdd_tpu.ops import attn_l2_pallas as jl2, attn_pool_pallas as jap
  monkeypatch.setenv('SVDD_PALLAS_ATTN_POOL', '1')
  monkeypatch.setenv('SVDD_PALLAS_ATTN_L2', '1')
  for mod, name in ((jap, '_wl_res_core'), (jl2, '_fused_core')):
    core = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, _c=core: _c(*a[:-1], True))
  jtrainer, trainer = _trainers(denoisers, value_vars, dtype=torch.bfloat16)
  flax_masks.set(masks)
  step = jax.jit(jtrainer._make_grad_step()).lower(
      j0, *args, jtrainer._reward_vars).compile(
          {'xla_allow_excess_precision': False})
  j16, jloss16 = step(j0, *args, jtrainer._reward_vars)
  state = trainer.init_state(0)
  _load_jax_state(state, j0)
  loss = trainer.grad_step(state, _t(samples), _t(mid),
                           masks=blocks.DropoutMasks(masks=masks))
  assert state.module.compute_dtype == torch.bfloat16
  assert (abs(float(loss) - float(jloss16))
          <= 2 * abs(float(jloss16) - float(jloss32))
          + 2 ** -8 * abs(float(jloss32)))
  b1 = 0.9
  mu0 = j0.opt_state[1][0].mu
  jgrad = lambda js: jax.tree.map(
      lambda m, mp: (np.asarray(m, np.float64) - b1 * np.asarray(mp))
      / (1 - b1), js.opt_state[1][0].mu, mu0)
  named = dict(state.module.named_parameters())
  grads = enformer_params_to_jax({k: p.grad for k, p in named.items()},
                                 state.module)
  norm = np.linalg.norm
  got = enformer_to_jax(state.module)
  for g, w, f in ((grads, jgrad(j16), jgrad(j32)),
                  (got['batch_stats'], j16.extras['batch_stats'],
                   j32.extras['batch_stats'])):
    g, w, f = _flat(g), _flat(w), _flat(f)
    bad = [k for k in w if not _zero_grad(k)
           and not norm(g[k] - w[k]) <= 2 * norm(w[k] - f[k])
           + 2 ** -8 * norm(f[k])]
    assert not bad, bad
  t = jtrainer.tcfg
  tx = optax.adamw(t.learning_rate, b1=t.betas[0], b2=t.betas[1],
                   weight_decay=t.weight_decay)
  upd, _ = tx.update(jax.tree.map(jnp.asarray, grads), j0.opt_state[1],
                     j0.params)
  _assert_tree_close(got['params'], optax.apply_updates(j0.params, upd),
                     rtol=1e-6, floor=1e-9)


def test_evaluate_seq_step_matches_svdd_tpu(denoisers, value_vars):
  """Per-timestep MSE and Pearson correlation of the value net (eval
  mode) over the same pre-sampled batches, 1e-5 relative."""
  jtrainer, trainer = _trainers(denoisers, value_vars)
  jstate = jtrainer.init_state(jax.random.key(90))
  state = trainer.init_state(0)
  rs = np.random.default_rng(91)
  batches = [_onehots(92 + t) for t in range(3)]
  targets = [rs.normal(size=B).astype(np.float32) for _ in range(3)]
  want = jtrainer.evaluate_seq_step(jstate, [jnp.asarray(b) for b in batches],
                                    [jnp.asarray(t) for t in targets])
  got = trainer.evaluate_seq_step(state, [_t(b) for b in batches],
                                  [_t(t) for t in targets])
  for g, w in zip(got, want):
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_value_trainer_resume_on_cpu(denoisers, value_vars, tmp_path):
  """A saved trainer state restores bit for bit (parameters, statistics,
  Adam's state and count, generator, step, tokens); two trainers resumed
  from it take the same next iteration bit for bit (their trajectories
  restart at seed 0, as JAX's sample key does)."""
  _, trainer = _trainers(denoisers, value_vars)
  state = trainer.init_state(3)
  trainer.train(state, 2)
  path = str(tmp_path / 'state.pt')
  trainer.save_state(path, state)

  def same(a, b):
    sa, sb = a.module.state_dict(), b.module.state_dict()
    oa = a.optimizer.adamw.state_dict()['state']
    ob = b.optimizer.adamw.state_dict()['state']
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(oa[i][k], ob[i][k]) for i in oa
                    for k in ('step', 'exp_avg', 'exp_avg_sq'))
            and a.step == b.step and a.tokens == b.tokens
            and a.optimizer.count == b.optimizer.count
            and torch.equal(a.generator.get_state(), b.generator.get_state()))

  assert same(trainer.restore_state(path, 0), state)
  resumed = []
  for _ in range(2):
    _, t = _trainers(denoisers, value_vars)
    s = t.restore_state(path, 0)
    t.train(s, 1)
    resumed.append(s)
  assert same(*resumed) and resumed[0].step == 3


def test_token_cosine_lr_mult_matches_svdd_tpu():
  """The token schedule's multiplier: warmup, decay and the 0.1 floor,
  to f32 rounding (JAX evaluates it in float32)."""
  for tokens in (0.0, 1e4, 37500.0, 3.3e6, 1.3e9, 2.6e9, 5e9):
    want = float(jutils.token_cosine_lr_mult(jnp.float32(tokens), 375e2,
                                             260e7))
    assert utils.token_cosine_lr_mult(tokens, 375e2, 260e7) == (
        pytest.approx(want, rel=1e-6, abs=1e-7))


def test_multisep_trainer_waits_for_a11(denoisers):
  """A11 is ported: ``MultiSepTrainer`` builds on a diffusion model, a
  multisep model and a reward (its steps are held to JAX's in
  ``tests/test_torch_timed_multisep.py``); at the saluki task its
  targets' input is the padded saluki tensor with the given body."""
  from svdd_tpu_torch.models import multisep
  _, diff = denoisers
  gen = torch.Generator().manual_seed(0)
  msm = multisep.MultiSepValueModel.create(
      lambda g: value_lib.build_value_module('dna', generator=g, **TINY),
      n_models=2, num_steps=STEPS, generator=gen)
  tcfg = train_value.ValueTrainerConfig(batch_size=B)
  trainer = train_value.MultiSepTrainer(
      diff, msm, rewards.synthetic_motif_oracle(L), tcfg)
  assert trainer.init_state(0).msm is msm
  saluki = train_value.MultiSepTrainer(
      diff, msm, None, train_value.ValueTrainerConfig(
          task='rna_saluki', saluki_final_length=L + 3),
      saluki_body=torch.ones(2, 6))
  assert saluki._transform(torch.zeros(1, L, dtype=torch.long)).shape == (
      1, L + 3, 6)
