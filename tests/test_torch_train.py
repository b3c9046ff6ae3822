"""Diffusion pretraining in svdd_tpu_torch vs svdd_tpu (tiny DNA config:
L=24, hidden 32, one stack of five layers, batch 8).

The random parts are pinned: the port's loss, train and eval steps take
the uniforms JAX draws from its keys (``t`` from kt and the masking from
kq of each microbatch's loss key). Float32 with TF32 off. Tolerances:
the loss 1e-6 relative; after three AdamW steps the parameters, the EMA
shadow and Adam's first moment to 1e-5 relative and 1e-7 absolute, its
second to 1e-5 relative and 1e-5 of each tensor's largest (optax and
torch compute the same update in another rounding order, and the
gradients differ by the plain layer backward's summation order, about
1e-6 relative); the learning rates to 1e-6 of the peak rate (optax
evaluates its schedules in float32, where (init - end) * frac + end
cancels near the warmup's start; the port in double). In bf16 the three
steps are held against JAX's compiled with ``xla_allow_excess_precision``
off (it then rounds where its ops do one at a time, as the port does):
the losses, parameters and Adam's first moment within twice JAX's own
bf16-to-f32 distance plus 2^-8 of the f32 run's size, as
``chip_smoke.py``'s ``bf16_close``. Resume on the CPU is bit for bit.
"""

import csv
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import mdlm as jmdlm
from svdd_tpu import schedules as jschedules
from svdd_tpu import utils as jutils
from svdd_tpu.config import dna_config as jax_dna_config
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.data import gosai as jgosai
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models import ema as jema
from svdd_tpu.ops import cnn_layer_pallas as jcnn
from svdd_tpu.train import diffusion as jtrain

from svdd_tpu_torch import mdlm, schedules, utils
from svdd_tpu_torch.cli import main_gosai
from svdd_tpu_torch.config import dna_config, tiny_test_config
from svdd_tpu_torch.data import gosai
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.models import ema
from svdd_tpu_torch.models.cnn import CNNLayer
from svdd_tpu_torch.ops import cnn_layer as tcnn
from svdd_tpu_torch.train import diffusion as train_diff
from svdd_tpu_torch.weights import (cnn_from_jax, cnn_params_to_jax,
                                    cnn_to_jax)
from torch_port_helpers import (few_torch_threads,  # noqa: F401
                                perturb, random_cnn_variables)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
STATE_TOL = dict(rtol=1e-5, atol=1e-7)
LR_TOL = dict(rtol=0, atol=3e-10)   # 1e-6 of the 3e-4 peak
N, STEPS = 8, 3
BF16_NOISE_MULT = 2.0


def _t(a):
  return torch.from_numpy(np.array(a))


def _configs(**training):
  """(port, JAX) tiny DNA configs with a 2-step warmup at lr 1e-3."""
  cfgs = tiny_test_config('dna'), jax_tiny_config('dna')
  for c in cfgs:
    c.optim.warmup_steps = 2
    c.optim.lr = 1e-3
    for k, v in training.items():
      setattr(c.training, k, v)
  return cfgs


def _variables(jcfg, seed=0):
  rs = np.random.default_rng(seed)
  return perturb(random_cnn_variables(jcfg, rs), rs)


def _models(cfg, jcfg, variables):
  jmodel = JaxDiffusion(jcfg, variables=jax.tree.map(jnp.asarray, variables))
  model = Diffusion(cfg, device='cpu', backbone=cnn_from_jax(variables))
  return model, jmodel


def _batch(seed, n=N, length=24):
  rs = np.random.default_rng(seed)
  return {'seqs': rs.integers(0, 4, (n, length)).astype(np.int32),
          'attention_mask': np.ones((n, length), np.float32)}


def _loss_uniforms(key, n, length):
  """The (t, mask) uniforms ``Diffusion.loss`` draws from ``key``."""
  kt, kq = jax.random.split(key)
  return (_t(jax.random.uniform(kt, (n,))),
          _t(jax.random.uniform(kq, (n, length))))


def _step_noise(rng, n, length, accum):
  """The uniforms JAX's train step draws from ``state.rng``: one
  (t, mask) pair per microbatch."""
  _, loss_key, _ = jax.random.split(rng, 3)
  if accum == 1:
    return [_loss_uniforms(loss_key, n, length)]
  return [_loss_uniforms(k, n // accum, length)
          for k in jax.random.split(loss_key, accum)]


def _assert_tree_close(got, want, tol=STATE_TOL, path='', of_max=0.0):
  """Leaf by leaf; ``of_max`` adds that fraction of the leaf's largest
  magnitude to the absolute tolerance."""
  if isinstance(want, dict):
    assert set(got) == set(want), path
    for k in want:
      _assert_tree_close(got[k], want[k], tol, f'{path}/{k}', of_max)
    return
  want = np.asarray(want)
  tol = dict(tol, atol=tol['atol'] + of_max * np.abs(want).max())
  np.testing.assert_allclose(np.asarray(got), want, **tol, err_msg=path)


# ---------------------------------------------------------------------------
# config, schedules, MDLM math, optimizer pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('section', ['training', 'optim', 'eval',
                                     'checkpointing', 'parallel'])
def test_dna_config_sections_match_svdd_tpu(section):
  assert (getattr(dna_config(), section).__dict__
          == getattr(jax_dna_config(), section).__dict__)


@pytest.mark.parametrize('field,value', [
    ('pipeline_stages', 2), ('fsdp', True), ('model_axis', 2),
    ('data_axis', 4), ('pipeline_virtual', 2)])
def test_parallel_settings_past_one_device_raise_a16(field, value):
  """Each parallel setting past one device meets the trainer as JAX's
  does (``_pipeline_apply_fn`` without a grid): the data and model axes,
  FSDP and ``pipeline_virtual`` at one stage give the plain apply (None);
  ``pipeline_stages=2`` on the CNN raises JAX's ValueError, with its
  words (the pipeline runs the DiT alone,
  tests/test_torch_parallel_pipe.py)."""
  cfg, jcfg = dna_config(), jax_dna_config()
  for c in (cfg, jcfg):
    setattr(c.parallel, field, value)
  if field == 'pipeline_stages':
    with pytest.raises(ValueError) as want:
      jtrain._pipeline_apply_fn(None, jcfg, None)
    with pytest.raises(ValueError) as got:
      train_diff._pipeline_apply_fn(None, cfg, None)
    assert str(got.value) == str(want.value)
  else:
    assert jtrain._pipeline_apply_fn(None, jcfg, None) is None
    assert train_diff._pipeline_apply_fn(None, cfg, None) is None


def test_q_xt_matches_svdd_tpu():
  key = jax.random.key(3)
  x0 = jax.random.randint(jax.random.key(4), (N, 24), 0, 4)
  mc = jnp.linspace(0.05, 0.95, N)[:, None]
  want = jmdlm.q_xt(key, x0, mc, 4)
  got = mdlm.q_xt(_t(x0).long(), _t(mc), 4,
                  _t(jax.random.uniform(key, x0.shape)))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('antithetic', [True, False])
def test_sample_t_matches_svdd_tpu(antithetic):
  key = jax.random.key(5)
  want = jmdlm.sample_t(key, 16, 1e-3, antithetic)
  got = mdlm.sample_t(_t(jax.random.uniform(key, (16,))), 1e-3, antithetic)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize('masked', [False, True])
def test_nelbo_subs_matches_svdd_tpu(masked):
  rs = np.random.default_rng(6)
  logits = rs.normal(size=(N, 24, 5)).astype(np.float32)
  log_p = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
  x0 = rs.integers(0, 4, (N, 24)).astype(np.int32)
  sigma = rs.uniform(0.1, 3, N).astype(np.float32)
  dsigma = rs.uniform(0.5, 2, N).astype(np.float32)
  am = (rs.random((N, 24)) < 0.8).astype(np.float32) if masked else None
  want = jmdlm.nelbo_subs(jnp.asarray(log_p), jnp.asarray(x0),
                          jnp.asarray(sigma), jnp.asarray(dsigma),
                          None if am is None else jnp.asarray(am))
  got = mdlm.nelbo_subs(_t(log_p), _t(x0).long(), _t(sigma), _t(dsigma),
                        None if am is None else _t(am))
  np.testing.assert_allclose(float(got.loss), float(want.loss), **LOSS_TOL)
  np.testing.assert_allclose(got.nlls.numpy(), np.asarray(want.nlls),
                             **LOSS_TOL)


def test_loglinear_importance_transform_matches_svdd_tpu():
  t = np.linspace(0, 1, 33, dtype=np.float32)
  want = jschedules.loglinear(1e-3).importance_transform(jnp.asarray(t))
  got = schedules.loglinear(1e-3).importance_transform(_t(t))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize('kind', ['constant_warmup', 'cosine_decay_warmup'])
@pytest.mark.parametrize('warmup', [0, 5])
def test_lr_schedules_match_optax(kind, warmup):
  if kind == 'constant_warmup':
    want = jutils.constant_warmup_schedule(3e-4, warmup)
    got = utils.constant_warmup_schedule(3e-4, warmup)
  else:
    want = jutils.cosine_decay_warmup_schedule(3e-4, warmup, 20, 1e-6)
    got = utils.cosine_decay_warmup_schedule(3e-4, warmup, 20, 1e-6)
  for count in range(26):
    np.testing.assert_allclose(got(count), float(want(jnp.asarray(count))),
                               **LR_TOL, err_msg=str(count))


@pytest.mark.parametrize('scale', [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
  """Below max_norm the gradients stay as they are (no epsilon); above,
  they scale to it."""
  rs = np.random.default_rng(7)
  grads = [scale * rs.normal(size=s).astype(np.float32) / 10
           for s in ((9, 4, 4), (4,), (3, 5))]
  want, _ = optax.clip_by_global_norm(1.0).update(
      [jnp.asarray(g) for g in grads], optax.EmptyState())
  got = [_t(g) for g in grads]
  train_diff.clip_by_global_norm_(got, 1.0)
  for g, w, g0 in zip(got, want, grads):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOSS_TOL)
    if scale < 1:
      np.testing.assert_array_equal(g.numpy(), g0)


@pytest.mark.parametrize('use_num_updates', [True, False])
def test_ema_matches_svdd_tpu(use_num_updates):
  rs = np.random.default_rng(8)
  params = {'a': rs.normal(size=(3, 4)).astype(np.float32),
            'b': rs.normal(size=(5,)).astype(np.float32)}
  jstate = jema.init({k: jnp.asarray(v) for k, v in params.items()}, 0.99,
                     use_num_updates)
  state = ema.init({k: _t(v) for k, v in params.items()}, 0.99,
                   use_num_updates)
  for i in range(4):
    params = {k: v + rs.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()}
    jstate = jema.update(jstate, {k: jnp.asarray(v)
                                  for k, v in params.items()})
    ema.update(state, {k: _t(v) for k, v in params.items()})
  assert state.num_updates == int(jstate.num_updates)
  _assert_tree_close({k: v.numpy() for k, v in ema.params(state).items()},
                     jema.params(jstate), LOSS_TOL)


def test_cnn_to_jax_inverts_cnn_from_jax():
  jcfg = jax_tiny_config('dna')
  variables = _variables(jcfg)
  _assert_tree_close(cnn_to_jax(cnn_from_jax(variables)), variables,
                     dict(rtol=0, atol=0))


# ---------------------------------------------------------------------------
# the loss, the train step and evaluation against svdd_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('training', [
    {}, {'antithetic_sampling': False}, {'importance_sampling': True}])
def test_diffusion_loss_matches_svdd_tpu(training):
  cfg, jcfg = _configs(**training)
  model, jmodel = _models(cfg, jcfg, _variables(jcfg))
  b = _batch(9)
  key = jax.random.key(10)
  want = jmodel.loss(jmodel.variables, key, jnp.asarray(b['seqs']),
                     jnp.asarray(b['attention_mask']), train=True)
  got = model.loss(_t(b['seqs']).long(), _t(b['attention_mask']),
                   train=True, noise=_loss_uniforms(key, N, 24))
  np.testing.assert_allclose(float(got.loss.detach()), float(want.loss),
                             **LOSS_TOL)
  np.testing.assert_allclose(got.nlls.detach().numpy(),
                             np.asarray(want.nlls), rtol=1e-5, atol=1e-6)


def _adam_moments(state):
  """Adam's (mu, nu) of the port's state as flax param trees."""
  named = dict(state.model.backbone.named_parameters())
  st = state.optimizer.adamw.state
  return tuple(cnn_params_to_jax({k: st[p][m] for k, p in named.items()})
               for m in ('exp_avg', 'exp_avg_sq'))


@pytest.fixture(scope='module', params=[1, 2], ids=['accum1', 'accum2'])
def three_steps(request):
  """Three optimizer steps of both packages from the same weights on the
  same batches and noise: (port state, JAX state, port losses, JAX
  losses, configs)."""
  accum = request.param
  cfg, jcfg = _configs(accum_steps=accum)
  model, jmodel = _models(cfg, jcfg, _variables(jcfg, seed=1))
  jstate = jtrain.init_state(jmodel, jcfg, jax.random.key(11))
  jstep = jax.jit(jtrain.make_train_step(jmodel, jcfg))
  state = train_diff.init_state(model, cfg)
  losses, jlosses = [], []
  for s in range(STEPS):
    b = _batch(20 + s)
    noise = _step_noise(jstate.rng, N, 24, accum)
    jstate, jloss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    jlosses.append(float(jloss))
    losses.append(float(train_diff.train_step(state, b, cfg, noise)))
  return state, jstate, losses, jlosses, (cfg, jcfg)


def test_three_train_steps_match_svdd_tpu(three_steps):
  """Losses, parameters, EMA shadow and Adam's moments after three steps
  (warmup 2, so rates 0, lr/2, lr), with gradient accumulation 1 and 2."""
  state, jstate, losses, jlosses, _ = three_steps
  np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
  assert state.step == int(jstate.step) == STEPS
  assert state.optimizer.count == STEPS
  _assert_tree_close(cnn_to_jax(state.model.backbone)['params'],
                     jstate.params)
  _assert_tree_close(cnn_params_to_jax(ema.params(state.ema)),
                     jstate.ema.shadow)
  assert state.ema.num_updates == int(jstate.ema.num_updates)
  adam = jstate.opt_state[1][0]
  mu, nu = _adam_moments(state)
  _assert_tree_close(mu, adam.mu)
  # nu is g^2: where g is small its relative error doubles g's
  _assert_tree_close(nu, adam.nu, dict(rtol=1e-5, atol=0), of_max=1e-5)
  # the update moved the parameters
  assert not np.allclose(jstate.params['conv_0']['kernel'],
                         jstate.ema.shadow['conv_0']['kernel'])


def _flat(tree, path=''):
  """{'/a/b': float64 array} of a nested dict of arrays."""
  if isinstance(tree, dict):
    out = {}
    for k, v in tree.items():
      out.update(_flat(v, f'{path}/{k}'))
    return out
  return {path: np.asarray(tree, np.float64)}


def _bf16_close(got, want, f32, start=None):
  """The leaves of ``got`` (the port in bf16) whose distance by norm to
  ``want`` (JAX in bf16) exceeds BF16_NOISE_MULT times JAX's own
  bf16-to-f32 distance (to ``f32``) plus 2^-8 of the f32 run's size, or
  of its change from ``start`` where given: {leaf: (err, noise)}."""
  got, want, f32 = _flat(got), _flat(want), _flat(f32)
  start = None if start is None else _flat(start)
  norm = np.linalg.norm
  bad = {}
  for k in want:
    err, noise = norm(got[k] - want[k]), norm(want[k] - f32[k])
    scale = norm(f32[k] - (0 if start is None else start[k]))
    if not err <= BF16_NOISE_MULT * noise + 2 ** -8 * scale:
      bad[k] = (err, noise)
  return bad


def test_bf16_train_steps_match_svdd_tpu(three_steps):
  """The three steps again with the denoiser in bf16 (SVDD_CNN_BF16=1 on
  both sides), on the same weights, batches and noise: the losses, the
  parameters and Adam's first moment (a sum of the clipped gradients)
  within BF16_NOISE_MULT times JAX's own bf16-to-f32 distance (the f32
  run of ``three_steps``) plus 2^-8 of the f32 run's size (of the
  parameters' change, for the parameters). JAX's step is compiled with
  ``xla_allow_excess_precision`` off, so that it rounds where its ops
  do one at a time, as the port does (XLA would otherwise keep fused
  bf16 chains in f32)."""
  _, jstate32, _, jlosses32, (cfg, jcfg) = three_steps
  accum = cfg.training.accum_steps
  variables = _variables(jcfg, seed=1)
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('SVDD_CNN_BF16', '1')
    jmodel = JaxDiffusion(jcfg, variables=jax.tree.map(jnp.asarray,
                                                       variables))
  assert jmodel.backbone.compute_dtype == jnp.bfloat16
  model = Diffusion(cfg, device='cpu',
                    backbone=cnn_from_jax(variables, torch.bfloat16))
  jstate = jtrain.init_state(jmodel, jcfg, jax.random.key(11))
  jstep = jax.jit(jtrain.make_train_step(jmodel, jcfg)).lower(
      jstate, {k: jnp.asarray(v) for k, v in _batch(20).items()}).compile(
          {'xla_allow_excess_precision': False})
  state = train_diff.init_state(model, cfg)
  losses, jlosses = [], []
  for s in range(STEPS):
    b = _batch(20 + s)
    noise = _step_noise(jstate.rng, N, 24, accum)
    jstate, jloss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    jlosses.append(float(jloss))
    losses.append(float(train_diff.train_step(state, b, cfg, noise)))
  noise = np.abs(np.subtract(jlosses, jlosses32))
  assert (np.abs(np.subtract(losses, jlosses))
          <= BF16_NOISE_MULT * noise + 2 ** -8 * np.abs(jlosses32)).all()
  assert not _bf16_close(cnn_to_jax(state.model.backbone)['params'],
                         jstate.params, jstate32.params,
                         start=variables['params'])
  assert not _bf16_close(_adam_moments(state)[0], jstate.opt_state[1][0].mu,
                         jstate32.opt_state[1][0].mu)


def test_bf16_gradients_return_as_the_casts_backward_gives_them():
  """In bf16 each layer's conv weights, the stem, the 1x1 convs and the
  Dense layers are cast to bf16 in the forward, so their f32 gradients
  are bf16 values (the product's gradient in bf16, returned through the
  cast), as JAX's are; the layer's LN and conv-bias gradients are the
  layer backward's f32 sums, as ``cnn_layer_bwd_pallas`` returns them,
  from L = 100, and below it (here L = 24) bf16 sums, as the VJP of
  ``cnn_layer_reference`` that JAX's dispatch takes there returns them
  (``ops.cnn_layer.bwd_rounds_as_reference``)."""
  cfg, jcfg = _configs()
  model = Diffusion(cfg, device='cpu', backbone=cnn_from_jax(
      _variables(jcfg), torch.bfloat16))
  b = _batch(9)
  model.loss(_t(b['seqs']).long(), train=True,
             noise=_loss_uniforms(jax.random.key(10), N, 24)).loss.backward()
  for name, p in model.backbone.named_parameters():
    assert p.grad.dtype == torch.float32, name
    as_bf16 = torch.equal(p.grad, p.grad.bfloat16().float())
    summed = (name.endswith(('ln_scale', 'ln_bias', 'conv_bias'))
              and not tcnn.bwd_rounds_as_reference(24))
    assert as_bf16 != summed, name


def test_evaluate_matches_svdd_tpu(three_steps):
  """Validation NLL on the EMA weights, three batches, JAX's eval keys."""
  state, jstate, _, _, (cfg, jcfg) = three_steps
  jmodel = JaxDiffusion(jcfg, variables={'params': jstate.params,
                                         **jstate.extras})
  jtrainer = jtrain.Trainer(jmodel, jcfg)
  ds = jgosai.GosaiDataset('val', length=24)
  want = jtrainer.evaluate(jstate, jgosai.FaultTolerantIterator(
      ds, N, shuffle=False), max_batches=3)
  key, noise = jax.random.key(0), []
  for _ in range(3):
    key, sub = jax.random.split(key)
    noise.append(_loss_uniforms(sub, N, 24))
  trainer = train_diff.Trainer(state.model, cfg)
  got = trainer.evaluate(state, gosai.FaultTolerantIterator(
      gosai.GosaiDataset('val', length=24), N, shuffle=False),
      max_batches=3, noise=noise)
  np.testing.assert_allclose(got, want, **LOSS_TOL)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('split', ['train', 'val', 'test'])
def test_synthetic_split_matches_svdd_tpu(split):
  got = gosai.GosaiDataset(split, length=200)
  want = jgosai.GosaiDataset(split, length=200,
                             data_dir='/nonexistent/gosai')
  assert got.synthetic and want.synthetic
  np.testing.assert_array_equal(got.seqs, want.seqs)
  np.testing.assert_array_equal(got.clss, want.clss)


def _batches(it, n):
  out = []
  for _, b in zip(range(n), iter(it)):
    out.append(b['seqs'].copy())
  return out


def test_iterator_order_and_mid_epoch_resume_match_svdd_tpu():
  """Three epochs and a bit (shuffled from seed + epoch) batch for batch
  as JAX's iterator; then a fresh iterator loading the position after 25
  batches, mid-epoch, goes on as the uninterrupted one, as JAX's does."""
  ds, jds = (gosai.GosaiDataset('val', length=24),
             jgosai.GosaiDataset('val', length=24, data_dir='/nonexistent'))
  straight = _batches(gosai.FaultTolerantIterator(ds, 48, seed=5), 31)
  jstraight = _batches(jgosai.FaultTolerantIterator(jds, 48, seed=5), 31)
  for a, b in zip(straight, jstraight):
    np.testing.assert_array_equal(a, b)
  it = gosai.FaultTolerantIterator(ds, 48, seed=5)
  jit_ = jgosai.FaultTolerantIterator(jds, 48, seed=5)
  _batches(it, 25)
  _batches(jit_, 25)
  saved = it.state_dict()
  assert saved == jit_.state_dict() and 0 < saved['counter'] < 512
  resumed = gosai.FaultTolerantIterator(ds, 48, seed=0)
  jresumed = jgosai.FaultTolerantIterator(jds, 48, seed=0)
  resumed.load_state_dict(saved)
  jresumed.load_state_dict(saved)
  for a, b, c in zip(_batches(resumed, 6), _batches(jresumed, 6),
                     straight[25:]):
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_csv_reader_matches_svdd_tpu(tmp_path):
  """A CSV with an empty note field, an empty class field (read as 0), a
  row with a field too many and a sequence of the wrong length (both
  skipped)."""
  rows = [('0', '', 'ACGTACGT', '1.5', '2.5', '3.5'),
          ('1', 'x', 'TTTTAAAA', '4.5', '', '6.5e-1'),
          ('2', '', 'ACGTAC', '9.0', '9.0', '9.0'),
          ('3', 'y', 'CCCCGGGG', '7.5', '8.5', '9.5', 'extra'),
          ('4', 'z', 'GGGGCCCA', '-1', '2', '+3.25')]
  with open(tmp_path / 'gosai_train.csv', 'w', newline='') as f:
    w = csv.writer(f)
    w.writerow(['id', 'note', 'seq', 'hepg2', 'k562', 'sknsh'])
    w.writerows(rows)
  got = gosai.GosaiDataset('train', length=8, data_dir=str(tmp_path))
  want = jgosai.GosaiDataset('train', length=8, data_dir=str(tmp_path))
  assert not got.synthetic and not want.synthetic
  np.testing.assert_array_equal(got.seqs, want.seqs)
  np.testing.assert_array_equal(got.clss, want.clss)
  np.testing.assert_array_equal(got.clss[1], np.float32([4.5, 0.0, 0.65]))
  assert got.seqs.shape == (3, 8)


def test_get_dataloaders_rejects_shards():
  """A shard count that does not divide the global batches raises JAX's
  ValueError; one that does gives each shard its share of the batch."""
  cfg = tiny_test_config('dna')
  cfg.loader.global_batch_size = cfg.loader.eval_global_batch_size = 8
  with pytest.raises(ValueError, match='not divisible by 3 shards'):
    gosai.get_dataloaders(cfg, num_shards=3)
  with pytest.raises(ValueError, match='not divisible by 3 shards'):
    jgosai.get_dataloaders(cfg, num_shards=3)
  train, _, _ = gosai.get_dataloaders(cfg, num_shards=2, shard_index=1)
  assert next(iter(train))['seqs'].shape[0] == 4


# ---------------------------------------------------------------------------
# the CNN's dropout path
# ---------------------------------------------------------------------------


def test_dropout_layer_matches_cnn_layer_reference_with_residual():
  """A dropped layer input with the mask injected: the port's layer
  against ``cnn_layer_reference`` on the dropped input with the undropped
  activations as the residual."""
  rs = np.random.default_rng(12)
  layer = CNNLayer(32, 4, torch.Generator().manual_seed(0))
  with torch.no_grad():
    for p in layer.parameters():
      p.add_(0.1 * torch.from_numpy(rs.normal(size=p.shape).astype(
          np.float32)))
  feat = rs.normal(size=(4, 24, 32)).astype(np.float32)
  emb = rs.normal(size=(4, 32)).astype(np.float32)
  keep = rs.random((4, 24, 32)) < 0.7
  got = layer(_t(feat), _t(emb), _t(keep), 0.7)
  with torch.no_grad():
    bias_row = layer.time(_t(emb)).numpy()
  h = np.where(keep, feat / np.float32(0.7), 0).astype(np.float32)
  want = jcnn.cnn_layer_reference(
      jnp.asarray(h), jnp.asarray(bias_row),
      *(jnp.asarray(p.detach().numpy()) for p in (
          layer.ln_scale, layer.ln_bias, layer.kernel, layer.conv_bias)),
      dilation=4, residual=jnp.asarray(feat))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=2e-5, atol=2e-5)


def test_dropout_trains_through_the_plain_path():
  """With model.dropout > 0 a training loss draws masks from the
  generator (two draws differ) and is differentiable; without train it
  equals the dropout-free loss."""
  cfg, jcfg = _configs()
  model, _ = _models(cfg, jcfg, _variables(jcfg))
  ref, _ = _models(cfg, jcfg, _variables(jcfg))
  model.backbone.dropout = 0.3
  b = _t(_batch(13)['seqs']).long()
  noise = _loss_uniforms(jax.random.key(1), N, 24)
  gen = torch.Generator().manual_seed(0)
  a = model.loss(b, train=True, generator=gen, noise=noise).loss
  c = model.loss(b, train=True, generator=gen, noise=noise).loss
  assert float(a.detach()) != float(c.detach())
  a.backward()
  assert model.backbone.layers[0].kernel.grad.abs().sum() > 0
  with torch.no_grad():
    assert float(model.loss(b, noise=noise).loss) == float(
        ref.loss(b, noise=noise).loss)


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------


class _Rows:
  def __init__(self):
    self.rows = []

  def log(self, metrics, step=None):
    self.rows.append((step, dict(metrics)))


def _trainer(tmp_path, name, cfg, jcfg, variables, logger=None):
  model, _ = _models(cfg, jcfg, variables)
  return train_diff.Trainer(model, cfg, ckpt_dir=str(tmp_path / name),
                            logger=logger)


def _train_iter():
  return gosai.FaultTolerantIterator(gosai.GosaiDataset('train', length=24),
                                     N, seed=1)


def _losses(rows):
  return {s: m['train/loss'] for s, m in rows if 'train/loss' in m}


def test_resume_is_exact(tmp_path):
  """Six straight steps against three, a checkpoint, a fresh trainer
  restoring it, and three more: losses, parameters, EMA and moments bit
  for bit."""
  cfg, jcfg = _configs(accum_steps=2)
  variables = _variables(jcfg, seed=2)
  straight = _Rows()
  t = _trainer(tmp_path, 'a', cfg, jcfg, variables, straight)
  it = _train_iter()
  s1 = t.fit(t.init_or_restore(it), it, num_steps=6, log_every=1,
             ckpt_every=100)
  split = _Rows()
  t = _trainer(tmp_path, 'b', cfg, jcfg, variables, split)
  it = _train_iter()
  t.fit(t.init_or_restore(it), it, num_steps=3, log_every=1, ckpt_every=3)
  t = _trainer(tmp_path, 'b', cfg, jcfg, variables, split)
  it = _train_iter()
  state = t.init_or_restore(it)
  assert state.step == 3
  s2 = t.fit(state, it, num_steps=3, log_every=1, ckpt_every=100)
  assert _losses(split.rows) == _losses(straight.rows)
  assert len(_losses(straight.rows)) == 6
  for (k, a), b in zip(s1.model.backbone.state_dict().items(),
                       s2.model.backbone.state_dict().values()):
    assert torch.equal(a, b), k
  for k, a in s1.ema.shadow.items():
    assert torch.equal(a, s2.ema.shadow[k]), k
  for got, want in zip(_adam_moments(s2), _adam_moments(s1)):
    _assert_tree_close(got, want, dict(rtol=0, atol=0))
  assert torch.equal(s1.generator.get_state(), s2.generator.get_state())


def test_best_checkpoint_keeps_lowest_val_nll(tmp_path):
  cfg, jcfg = _configs()
  t = _trainer(tmp_path, 'c', cfg, jcfg, _variables(jcfg))
  state = t.init_or_restore()
  for step, nll in ((1, 2.0), (2, 1.5), (3, 1.8)):
    state.step = step
    t.save_best(state, nll)
  best = tmp_path / 'c' / 'best'
  assert os.listdir(best) == ['step_2.pt']
  t = _trainer(tmp_path, 'c', cfg, jcfg, _variables(jcfg))
  state.step = 4
  t.save_best(state, 1.6)            # the kept 1.5 is read back
  assert os.listdir(best) == ['step_2.pt']
  restored = train_diff.restore_best_checkpoint(
      str(tmp_path / 'c'), train_diff.init_state(t.model, cfg))
  assert restored.step == 2


def test_checkpoints_keep_the_newest_three(tmp_path):
  cfg, jcfg = _configs()
  t = _trainer(tmp_path, 'd', cfg, jcfg, _variables(jcfg))
  state = t.init_or_restore()
  for step in range(1, 6):
    state.step = step
    train_diff.save_checkpoint(t.ckpt_dir, state)
  assert sorted(os.listdir(t.ckpt_dir)) == ['step_3.pt', 'step_4.pt',
                                            'step_5.pt']


def test_cli_train_writes_metrics_and_a_checkpoint_that_evals_read(tmp_path):
  """``--mode train`` logs train/loss (every 100 steps, as the JAX
  package's ``fit``), val/nll and the sample-quality metrics and leaves
  checkpoints; ``ppl_eval`` and ``sample_eval`` read the EMA weights
  from them."""
  cfg, jcfg = _configs(accum_steps=2)
  cfg.eval.val_check_interval = 50
  cfg.checkpointing.every_n_steps = 50
  ckpt, logs = str(tmp_path / 'ckpt'), str(tmp_path / 'log')
  common = ['--device', 'cpu', '--ckpt_dir', ckpt]
  args = main_gosai.parser().parse_args(
      ['--mode', 'train', '--max_steps', '100', '--log_dir', logs, *common])
  out = main_gosai.run(args, cfg, backbone=cnn_from_jax(_variables(jcfg)))
  rows = [json.loads(line) for line in open(out['metrics_path'])]
  keys = set().union(*rows)
  assert {'train/loss', 'val/nll', 'kmer_pearson', 'ws/val_truth_hepg2',
          'ws/train_pred_hepg2'} <= keys
  assert [r['_step'] for r in rows if 'train/loss' in r] == [100]
  assert [r['_step'] for r in rows if 'val/nll' in r] == [50, 100]
  assert all(np.isfinite(r['val/nll']) for r in rows if 'val/nll' in r)
  assert sorted(os.listdir(ckpt)) == ['best', 'step_100.pt', 'step_50.pt']
  shadow = out['state'].ema.shadow
  model = main_gosai._restored(cfg, main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', *common]), None)
  for name, p in model.backbone.named_parameters():
    assert torch.equal(p, shadow[name]), name
  ppl = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'ppl_eval', *common]), cfg)
  assert np.isfinite(ppl['nll']) and ppl['ppl'] == pytest.approx(
      np.exp(ppl['nll']))
  toks = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', *common]), cfg)['tokens']
  assert toks.shape == (16, 24) and set(np.unique(toks)) <= {0, 1, 2, 3}


@pytest.mark.parametrize('k,cin,cout,dtype', [
    (9, 5, 32, torch.float32), (1, 32, 32, torch.float32),
    (1, 32, 5, torch.bfloat16), (9, 5, 32, torch.bfloat16)])
def test_conv1d_deterministic_matches_autograd_conv(k, cin, cout, dtype):
  """The training path's stem and 1x1 convs: the forward equals
  ``conv1d_shifted``'s bit for bit; the gradients equal autograd through
  PyTorch's own convolution (f32: 1e-5 relative; bf16: within a bf16
  ulp of the result)."""
  from svdd_tpu_torch.ops.conv1d import (_conv_forward, conv1d_deterministic,
                                         conv1d_shifted)
  rs = np.random.default_rng(14)
  x = _t(rs.normal(size=(4, 24, cin)).astype(np.float32)).to(dtype)
  w = _t(rs.normal(size=(k, cin, cout)).astype(np.float32) / 3)
  b = _t(rs.normal(size=(cout,)).astype(np.float32))
  ct = _t(rs.normal(size=(4, 24, cout)).astype(np.float32)).to(dtype)
  outs, grads = [], []
  for conv in (conv1d_deterministic, lambda *a: _conv_forward(*a, 1)):
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    out = conv(xs, ws, bs)
    out.backward(ct)
    outs.append(out.detach())
    grads.append([t.grad.float() for t in (xs, ws, bs)])
  with torch.no_grad():
    assert torch.equal(outs[0], conv1d_shifted(x, w, b))
  assert torch.equal(outs[0], outs[1])
  tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
         else dict(rtol=2 ** -7, atol=2 ** -7))
  for a, c in zip(*grads):
    scale = float(c.abs().max())
    np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=tol['rtol'],
                               atol=tol['atol'] * scale)
