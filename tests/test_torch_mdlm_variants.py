"""The MDLM variants of svdd_tpu_torch against svdd_tpu on the CPU: the
five noise schedules and their importance transforms, the D3PM and SEDD
parameterizations and losses, ``Diffusion.loss`` and its gradients for
D3PM with T > 0, SEDD and SUBS with T > 0, the class-conditioned CNN and
the classifier head, and ``main_gosai`` under ``--set
parameterization=d3pm T=8``.

Tiny sizes: batch 8, L=24, hidden 32, five layers. The random parts are
pinned: the port's loss takes the uniforms JAX draws from its keys.
Float32 with TF32 off. Tolerances: schedules 2e-6 relative (1e-6
absolute); the parameterizations and the D3PM and SEDD terms 1e-5
relative, 1e-5 absolute; losses 1e-5 relative; each gradient 1e-4
relative plus 1e-5 of its largest element; the CNN outputs 1e-5
relative, 1e-5 absolute.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import mdlm as jmdlm
from svdd_tpu import schedules as jschedules
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.models.cnn import CNNModel as JaxCNN
from svdd_tpu.sampling import sampler as jsampler

from svdd_tpu_torch import mdlm, schedules
from svdd_tpu_torch.cli import main_gosai
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.models.cnn import CNNModel
from svdd_tpu_torch.sampling import sampler
from svdd_tpu_torch.weights import cnn_from_jax, cnn_params_to_jax, cnn_to_jax
from torch_port_helpers import perturb, random_cnn_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCHED_TOL = dict(rtol=2e-6, atol=1e-6)
TERM_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
N, L, V = 8, 24, 5


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
  """Tiny tensors: one intra-op thread keeps torch from spinning its
  threads against the other test workers'."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _t(a):
  return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('noise', ['loglinear', 'cosine', 'cosinesqr',
                                   'linear', 'geometric'])
def test_schedule_matches_svdd_tpu(noise):
  """sigma and dsigma on a grid of t, sigma_max and sigma_min, and the
  importance transform where the schedule has one (loglinear, linear:
  its f_0 is -inf at the factory's sigma_min of 0 only when passed 0, so
  both sigma_min 1e-4 and 0 are held). A 0-dim CPU t gives CPU
  tensors: the samplers read nothing from the card."""
  j, p = jschedules.get_schedule(noise), schedules.get_schedule(noise)
  t = np.linspace(0.0, 1.0, 33, dtype=np.float32)
  for got, want in zip(p(_t(t)), j(jnp.asarray(t))):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCHED_TOL)
  np.testing.assert_allclose(float(p.sigma_max), float(j.sigma_max),
                             **SCHED_TOL)
  np.testing.assert_allclose(float(p.sigma_min), float(j.sigma_min),
                             **SCHED_TOL)
  assert all(v.device.type == 'cpu' and v.ndim == 0
             for v in p(torch.tensor(0.5)))
  assert (p.importance_transform is None) == (j.importance_transform is None)
  pairs = [(p, j)]
  if noise == 'linear':
    pairs.append((schedules.linear(0.0, 20.0), jschedules.linear(0.0, 20.0)))
  u = np.linspace(0.02, 0.98, 17, dtype=np.float32)
  for ps, js in pairs:
    if ps.importance_transform is not None:
      np.testing.assert_allclose(
          ps.importance_transform(_t(u)).numpy(),
          np.asarray(js.importance_transform(jnp.asarray(u))), **SCHED_TOL)


def test_get_schedule_refuses_an_unknown_type():
  with pytest.raises(ValueError, match='not a valid noise schedule'):
    schedules.get_schedule('sqrt')


# ---------------------------------------------------------------------------
# parameterizations and loss terms
# ---------------------------------------------------------------------------


def _logits_xt(seed):
  rs = np.random.default_rng(seed)
  logits = (3 * rs.normal(size=(N, L, V))).astype(np.float32)
  xt = np.where(rs.random((N, L)) < 0.5, 4,
                rs.integers(0, 4, (N, L))).astype(np.int32)
  x0 = np.where(xt == 4, rs.integers(0, 4, (N, L)), xt).astype(np.int32)
  return logits, xt, x0


@pytest.mark.parametrize('subs_masking', [False, True])
def test_d3pm_parameterization_matches_svdd_tpu(subs_masking):
  logits, _, _ = _logits_xt(0)
  want = jmdlm.d3pm_parameterization(jnp.asarray(logits), 4, subs_masking)
  got = mdlm.d3pm_parameterization(_t(logits), 4, subs_masking)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TERM_TOL)


def test_sedd_parameterization_matches_svdd_tpu():
  """Rows on both sides of sigma = 0.5 and a zero sigma, where every lane
  but the current token's is +inf in both packages (the sampler's
  processed sigma under time_conditioning=False)."""
  logits, xt, _ = _logits_xt(1)
  sigma = np.array([0.0, 0.1, 0.49, 0.5, 0.7, 2.0, 5.0, 0.0], np.float32)
  want = np.asarray(jmdlm.sedd_parameterization(
      jnp.asarray(logits), jnp.asarray(xt), jnp.asarray(sigma)))
  got = mdlm.sedd_parameterization(_t(logits), _t(xt).long(),
                                   _t(sigma)).numpy()
  np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
  off_token = xt[0][:, None] != np.arange(V)
  assert np.isposinf(got[0][off_token]).all()
  assert (got[0][~off_token] == 0).all()
  finite = np.isfinite(want)
  np.testing.assert_allclose(got[finite], want[finite], **TERM_TOL)


def test_d3pm_loss_and_score_entropy_match_svdd_tpu():
  """The discrete-time VLB term on D3PM log-probs (t on the grid and
  past 1 - 1e-4, which it clips) and SEDD's score entropy on finite log
  scores."""
  logits, xt, x0 = _logits_xt(2)
  lp = np.asarray(jmdlm.d3pm_parameterization(jnp.asarray(logits), 4))
  t = np.array([0.125, 0.25, 0.5, 0.625, 0.875, 1.0, 1.0, 0.375],
               np.float32)
  want = jmdlm.d3pm_loss(jnp.asarray(lp), jnp.asarray(xt), jnp.asarray(x0),
                         jnp.asarray(t), 4, 8)
  got = mdlm.d3pm_loss(_t(lp), _t(xt).long(), _t(x0).long(), _t(t), 4, 8)
  # t = 1/T: NaN at the masked positions of row 0 in both, 0 elsewhere
  assert np.isnan(got[0].numpy()[xt[0] == 4]).all()
  assert (got[0].numpy()[xt[0] != 4] == 0).all()
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TERM_TOL)
  sigma = np.linspace(0.05, 3.0, N).astype(np.float32)
  ls = np.asarray(jmdlm.sedd_parameterization(
      jnp.asarray(logits), jnp.asarray(xt), jnp.asarray(sigma)))
  for s in (sigma, sigma[:, None]):
    want = jmdlm.score_entropy(jnp.asarray(ls), jnp.asarray(s),
                               jnp.asarray(xt), jnp.asarray(x0), 4)
    got = mdlm.score_entropy(_t(ls), _t(s), _t(xt).long(), _t(x0).long(), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TERM_TOL)


# ---------------------------------------------------------------------------
# Diffusion.loss and its gradients
# ---------------------------------------------------------------------------


VARIANTS = {'d3pm_T8': dict(parameterization='d3pm', T=8),
            'd3pm_T8_subs_masking': dict(parameterization='d3pm', T=8,
                                         subs_masking=True),
            'sedd': dict(parameterization='sedd'),
            'subs_T8': dict(T=8)}
# with T > 0, every t below 1/T snaps to 1/T, where the VLB is NaN in
# both packages (``test_discrete_time_loss_is_nan_at_the_first_grid_
# point``); from this sampling_eps every snapped t is at least 2/T
FINITE_EPS = 0.2


def _pair(variant, seed=0, sampling_eps=None, **model):
  """(port, JAX) tiny DNA diffusion models of ``variant`` on the same
  perturbed random weights."""
  cfg, jcfg = tiny_test_config('dna'), jax_tiny_config('dna')
  for c in (cfg, jcfg):
    for k, v in VARIANTS.get(variant, {}).items():
      setattr(c, k, v)
    for k, v in model.items():
      setattr(c.model, k, v)
    if sampling_eps is not None:
      c.training.sampling_eps = sampling_eps
  rs = np.random.default_rng(seed)
  variables = perturb(random_cnn_variables(jcfg, rs), rs)
  jmodel = JaxDiffusion(jcfg, variables=jax.tree.map(jnp.asarray, variables))
  model = Diffusion(cfg, device='cpu', backbone=cnn_from_jax(variables))
  return model, jmodel, variables


def _loss_inputs(seed):
  rs = np.random.default_rng(seed)
  x0 = rs.integers(0, 4, (N, L)).astype(np.int32)
  mask = np.ones((N, L), np.float32)
  key = jax.random.key(seed)
  kt, kq = jax.random.split(key)
  noise = (_t(jax.random.uniform(kt, (N,))),
           _t(jax.random.uniform(kq, (N, L))))
  return x0, mask, key, noise


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_diffusion_loss_and_gradients_match_svdd_tpu(variant):
  """The loss, the per-token NLLs and every parameter's gradient of one
  training microbatch, JAX's ``jax.value_and_grad`` of its loss against
  the port's backward, on JAX's uniforms. D3PM with T > 0 runs its
  reconstruction forward at t = 0 too. The times start at FINITE_EPS,
  where the discrete-time loss is finite."""
  model, jmodel, variables = _pair(variant, sampling_eps=FINITE_EPS)
  x0, mask, key, noise = _loss_inputs(3)

  def jloss(params):
    out = jmodel.loss({**jmodel.variables, 'params': params}, key,
                      jnp.asarray(x0), jnp.asarray(mask), train=True)
    return out.loss, out.nlls

  grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
  (want, want_nlls), want_g = grad_fn(jmodel.variables['params'])
  calls = []
  hook = model.backbone.register_forward_hook(
      lambda *a: calls.append(1))
  got = model.loss(_t(x0).long(), _t(mask), train=True, noise=noise)
  hook.remove()
  got.loss.backward()
  assert len(calls) == (2 if variant.startswith('d3pm') else 1)
  assert np.isfinite(float(want))
  np.testing.assert_allclose(float(got.loss.detach()), float(want),
                             **LOSS_TOL)
  np.testing.assert_allclose(got.nlls.detach().numpy(),
                             np.asarray(want_nlls), rtol=1e-5, atol=1e-6)
  grads = cnn_params_to_jax({k: p.grad for k, p in
                             model.backbone.named_parameters()})
  flat_w = jax.tree_util.tree_leaves_with_path(want_g)
  for path, w in flat_w:
    g = grads
    for k in path:
      g = g[k.key]
    w = np.asarray(w)
    np.testing.assert_allclose(
        g, w, rtol=1e-4, atol=1e-5 * max(np.abs(w).max(), 1e-12),
        err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('variant', ['d3pm_T8', 'subs_T8'])
def test_discrete_time_loss_is_nan_at_the_first_grid_point(variant):
  """At the default sampling_eps the antithetic draw puts row 0's t below
  1/T, which snaps to 1/T: the VLB's second term is 0 x inf there, so
  that row's masked positions are NaN, and so is the loss, in JAX and in
  the port alike; every other position matches."""
  model, jmodel, _ = _pair(variant)
  x0, mask, key, noise = _loss_inputs(3)
  want = jmodel.loss(jmodel.variables, key, jnp.asarray(x0),
                     jnp.asarray(mask), train=True)
  with torch.no_grad():
    got = model.loss(_t(x0).long(), _t(mask), train=True, noise=noise)
  nlls, want_nlls = got.nlls.numpy(), np.asarray(want.nlls)
  assert np.isnan(float(got.loss)) and np.isnan(float(want.loss))
  assert np.isnan(nlls[0]).any() and not np.isnan(nlls[1:]).any()
  np.testing.assert_allclose(nlls, want_nlls, rtol=1e-5, atol=1e-6)


def test_sedd_forward_is_inf_off_the_token_without_time_conditioning():
  """The bio tasks' time_conditioning=False: the forward hands SEDD's
  parameterization the zeroed sigma, as JAX does, so every lane off the
  current token is +inf; with time conditioning the log scores are
  finite and match JAX's."""
  model, jmodel, _ = _pair('sedd')
  x = _logits_xt(4)[1]
  sigma = np.full((N,), 0.7, np.float32)
  got = model.forward(_t(x).long(), _t(sigma)).detach().numpy()
  want = np.asarray(jmodel.forward(jmodel.variables, jnp.asarray(x),
                                   jnp.asarray(sigma)))
  np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
  assert np.isposinf(got).sum() == N * L * (V - 1)
  model.time_conditioning = jmodel.time_conditioning = True
  got = model.forward(_t(x).long(), _t(sigma)).detach().numpy()
  want = np.asarray(jmodel.forward(jmodel.variables, jnp.asarray(x),
                                   jnp.asarray(sigma)))
  assert np.isfinite(got).all()
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('time_conditioning', [False, True],
                         ids=['no_time_conditioning', 'time_conditioning'])
def test_sedd_ddpm_step_matches_svdd_tpu(time_conditioning):
  """One unguided ddpm step under SEDD on JAX's Gumbel noise: without time
  conditioning every masked position's log q is +inf off the MASK lane,
  and both packages draw its first lane (token 0, ``argmax``'s first
  maximum); with it the log scores are finite and the draws JAX's."""
  model, jmodel, _ = _pair('sedd')
  model.time_conditioning = jmodel.time_conditioning = time_conditioning
  x = _logits_xt(7)[1]
  t, t_next = np.float32(0.6), np.float32(0.55)
  key = jax.random.key(9)
  jstep = jsampler.ddpm_step(jmodel.denoise_fn(), jmodel.schedule, 4)
  _, want = jax.jit(jstep)((), jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(t_next), key)
  noise = np.array(jax.random.gumbel(key, (N, L, V), jnp.float32))
  step = sampler.ddpm_step(model.forward, model.schedule, 4)
  with torch.no_grad():
    got = step(_t(x).long(), torch.tensor(t), torch.tensor(t_next), None,
               gumbel=_t(noise)).numpy()
  np.testing.assert_array_equal(got, np.asarray(want))
  if not time_conditioning:
    assert (got[x == 4] == 0).all()
  else:
    assert len(np.unique(got[x == 4])) > 1


# ---------------------------------------------------------------------------
# class conditioning and the classifier head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('cls', [None, [0, 1, 2, 3, 2, 1, 0, 3]],
                         ids=['default_class', 'explicit_class'])
def test_class_conditioned_cnn_matches_svdd_tpu(cls):
  """``model.cls_free_guidance``: the class embedding and each layer's
  class projection, through ``cnn_from_jax``, at the null class and at
  explicit classes (num_cls = 3 and the null class 3); ``cnn_to_jax``
  gives the flax tree back."""
  model, jmodel, variables = _pair('cls', cls_free_guidance=True)
  assert 'cls_embedder' in variables['params']
  assert 'cls_0' in variables['params']
  x, sigma = _logits_xt(5)[1], np.zeros((N,), np.float32)
  kw = {} if cls is None else {'cls': np.array(cls, np.int32)}
  want = jmodel.backbone.apply(jmodel.variables, jnp.asarray(x),
                               jnp.asarray(sigma),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
  with torch.no_grad():
    got = model.backbone(_t(x).long(), _t(sigma),
                         **{k: _t(v) for k, v in kw.items()})
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
  back = cnn_to_jax(model.backbone)
  for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
    b = back
    for k in path:
      b = b[k.key]
    np.testing.assert_array_equal(b, np.asarray(leaf),
                                  err_msg=jax.tree_util.keystr(path))


def test_classifier_head_matches_svdd_tpu():
  """``classifier=True``: final_1 to hidden, the mean over L, cls_0, relu
  and cls_1 give (N, num_cls) logits; no class embedding."""
  jcfg = jax_tiny_config('dna')
  jcfg.model.cls_free_guidance = True      # the classifier takes none
  jnet = JaxCNN(config=jcfg, alphabet_size=V, num_cls=3, classifier=True)
  x, sigma = _logits_xt(6)[1], np.zeros((N,), np.float32)
  rs = np.random.default_rng(6)
  variables = perturb(jax.tree.map(np.asarray, jnet.init(
      jax.random.key(0), jnp.asarray(x), jnp.asarray(sigma))), rs)
  assert 'cls_embedder' not in variables['params']
  want = jnet.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x),
                    jnp.asarray(sigma))
  model = cnn_from_jax(variables)
  assert model.classifier and model.cls_embedder is None
  with torch.no_grad():
    got = model(_t(x).long(), _t(sigma))
  assert got.shape == (N, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
  assert set(cnn_to_jax(model)['params']) == set(variables['params'])


def test_class_parameters_appear_only_where_asked():
  """The default CNN's parameter names are unchanged; the
  class-conditioned one adds the embedding and one projection a layer."""
  cfg = tiny_test_config('dna')
  a = CNNModel(cfg, generator=torch.Generator().manual_seed(3))
  assert not any('cls' in k for k, _ in a.named_parameters())
  cfg.model.cls_free_guidance = True
  b = CNNModel(cfg, generator=torch.Generator().manual_seed(3))
  names = {k for k, _ in b.named_parameters()}
  assert names - {k for k, _ in a.named_parameters()} == (
      {'cls_embedder'} | {f'layers.{i}.cls.{w}' for i in range(5)
                          for w in ('weight', 'bias')})


# ---------------------------------------------------------------------------
# main_gosai under --set
# ---------------------------------------------------------------------------


TINY_SET = ['model.hidden_dim=32', 'model.num_cnn_stacks=1',
            'model.length=24', 'loader.global_batch_size=8',
            'loader.batch_size=8', 'loader.eval_global_batch_size=8',
            'loader.eval_batch_size=8', 'sampling.steps=8',
            'eval.val_check_interval=2', 'checkpointing.every_n_steps=2',
            'sampling.num_sample_batches=1']


def test_main_gosai_d3pm_trains_and_samples(tmp_path):
  """``main_gosai --mode train --set parameterization=d3pm T=8`` (tiny
  widths and FINITE_EPS through ``--set`` too) trains two steps with
  validation and
  checkpoints, and ``--mode ppl_eval`` and ``--mode sample_eval`` read
  its EMA weights: finite NLLs, (8, 24) tokens."""
  ckpt, logs = str(tmp_path / 'ckpt'), str(tmp_path / 'log')
  common = ['--device', 'cpu', '--ckpt_dir', ckpt, '--data_dir',
            str(tmp_path / 'no_data'), '--set', 'parameterization=d3pm',
            'T=8', f'training.sampling_eps={FINITE_EPS}', *TINY_SET]
  out = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'train', '--max_steps', '2', '--log_dir', logs,
       '--no_sample_eval', *common]))
  cfg = out['state'].model.config
  assert (cfg.parameterization, cfg.T, out['state'].step) == ('d3pm', 8, 2)
  rows = [json.loads(line) for line in open(out['metrics_path'])]
  assert [r['_step'] for r in rows if 'val/nll' in r] == [2]
  assert all(np.isfinite(r['val/nll']) for r in rows if 'val/nll' in r)
  assert 'step_2.pt' in os.listdir(ckpt)
  ppl = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'ppl_eval', *common]))
  assert np.isfinite(ppl['nll'])
  toks = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', *common]))['tokens']
  assert toks.shape == (8, 24) and toks.min() >= 0 and toks.max() <= 3
