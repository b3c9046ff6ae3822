"""Training the DiT, DiMamba and AR backbones in svdd_tpu_torch against
svdd_tpu: B12's and B13's wrappers carrying gradients, the AR baseline's
next-token loss, one optimizer step of each backbone from the same
weights on the same noise and dropout masks, and the gradients of the
``x_onehot`` forwards the gradient-guided decoders take.

Weights are the JAX modules' variables drawn with numpy
(``torch_port_helpers.random_variables``: every zero-initialised layer
non-zero), mapped into the port by ``weights.*_from_jax``. JAX's dropout
masks are injected by patching ``flax.linen.Dropout`` (``FlaxMasks``);
the port's forwards take the same list. Everything runs in f32 with TF32
off; tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.train import diffusion as jtrain

from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.ops import attention as tattn
from svdd_tpu_torch.ops import flash_attention as tfa
from svdd_tpu_torch.ops import norms as tnorms
from svdd_tpu_torch.train import diffusion as train_diff
from svdd_tpu_torch.weights import ar_from_jax, dimamba_from_jax, dit_from_jax
from torch_port_helpers import FlaxMasks, few_torch_threads  # noqa: F401
from torch_port_helpers import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N, L = 4, 24
CONVERT = {'dit': dit_from_jax, 'dimamba': dimamba_from_jax,
           'ar': ar_from_jax}
# model widths of each backbone: the DiT and AR at head dim 64 (B12's
# head dims), DiMamba narrow
WIDTHS = {'dit': dict(hidden_size=128, n_heads=2, n_blocks=2, cond_dim=16,
                      dropout=0.1),
          'ar': dict(hidden_size=128, n_heads=2, n_blocks=2, dropout=0.1),
          'dimamba': dict(d_model=32, n_layer=2, cond_dim=16)}


def _t(a):
  return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# B12 and B13: the kernel branch carries gradients
# ---------------------------------------------------------------------------


def _grads(fn, *xs):
  xs = [x.clone().requires_grad_() for x in xs]
  out = fn(*xs)
  ct = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
  (out * ct).sum().backward()
  return out.detach(), [x.grad for x in xs]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('l', [24, 128])
@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_kernel_branch_carries_gradients(l, causal, dtype,
                                                         monkeypatch):
  """B12's wrapper (``flash_attention``), its launch replaced by the
  plain form of its rounding run outside autograd (as the real launch
  writes its output), gives q, k and v the gradients of that plain form:
  ``mha`` for bf16 off JAX's gate (L = 24), the Pallas body's single pass
  on it (L = 128) and in float32 at every L, where the two roundings are
  one function. float32 within 1e-6 of each gradient's largest
  magnitude; bf16 exact, the backward being that plain form's own. A
  launch autograd does not see leaves them none."""
  rs = np.random.default_rng(l + int(causal))
  q, k, v = (_t(rs.normal(size=(2, l, 2, 64)).astype(np.float32))
             .to(getattr(torch, dtype)) for _ in range(3))
  single = l == 128 or dtype == 'float32'
  assert tfa.kernel_rounds_as_body(l, 64, q.dtype) is single
  plain = tattn.attention_body_plain if single else tattn.mha

  def launch(q, k, v, causal, body):
    assert body is single
    with torch.no_grad():
      return plain(q, k, v, causal).contiguous()

  monkeypatch.setattr(tfa, '_launch', launch)
  want_out, want = _grads(lambda *a: plain(*a, causal), q, k, v)
  got_out, got = _grads(lambda *a: tfa.flash_attention(*a, causal), q, k, v)
  np.testing.assert_array_equal(got_out.float().numpy(),
                                want_out.float().numpy())
  tol = 1e-6 if dtype == 'float32' else 0.0
  for name, g, w in zip('qkv', got, want):
    assert g is not None, name
    g, w = g.float(), w.float()
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol,
                               atol=tol * float(w.abs().max()), err_msg=name)


@pytest.mark.parametrize('residual', [False, True])
def test_rmsnorm_kernel_branch_carries_gradients(residual, monkeypatch):
  """B13's wrapper, its kernel branch forced on the CPU and the launch
  replaced by the plain version run outside autograd, gives x, the
  residual and the scale the plain version's gradients (f32, 1e-6)."""
  rs = np.random.default_rng(int(residual))
  x, r = (_t(rs.normal(size=(6, 5, 32)).astype(np.float32))
          for _ in range(2))
  s = _t(rs.uniform(0.5, 1.5, 32).astype(np.float32))

  def launch(x, residual, scale, eps):
    with torch.no_grad():
      return tnorms.rmsnorm_plain(x, residual, scale, eps)

  args = (x, r, s) if residual else (x, s)
  fn = ((lambda x, r, s: tnorms.fused_add_rmsnorm(x, r, s)) if residual
        else (lambda x, s: tnorms.fused_add_rmsnorm(x, None, s)))
  plain = ((lambda x, r, s: tnorms.rmsnorm_plain(x, r, s)) if residual
           else (lambda x, s: tnorms.rmsnorm_plain(x, None, s)))
  want_out, want = _grads(plain, *args)
  monkeypatch.setattr(tnorms, '_plain', lambda x: False)
  monkeypatch.setattr(tnorms, '_launch', launch)
  got_out, got = _grads(fn, *args)
  np.testing.assert_array_equal(got_out.numpy(), want_out.numpy())
  for g, w in zip(got, want):
    assert g is not None
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                               atol=1e-6 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# the backbones on shared weights
# ---------------------------------------------------------------------------


def _configs(backbone, **training):
  """(port, JAX) tiny DNA configs of ``backbone`` (the AR one under
  parameterization 'ar'), f32, a one-step warmup-free AdamW at 1e-3."""
  cfgs = tiny_test_config('dna'), jax_tiny_config('dna')
  for c in cfgs:
    c.backbone = backbone
    c.parameterization = 'ar' if backbone == 'ar' else 'subs'
    c.model.length = L
    for k, v in WIDTHS[backbone].items():
      setattr(c.model, k, v)
    c.optim.warmup_steps = 0
    c.optim.lr = 1e-3
    for k, v in training.items():
      setattr(c.training, k, v)
  return cfgs


def _models(backbone, seed):
  cfg, jcfg = _configs(backbone)
  jmodel = JaxDiffusion(jcfg, variables={})
  rs = np.random.default_rng(seed)
  variables = random_variables(
      jmodel.backbone.init, jnp.zeros((1, L), jnp.int32), jnp.zeros((1,)),
      rs=rs)
  jmodel.variables = jax.tree.map(jnp.asarray, variables)
  model = Diffusion(cfg, device='cpu', backbone=CONVERT[backbone](
      variables, cfg, torch.float32))
  return model, jmodel, variables, (cfg, jcfg)


def _batch(seed, vocab=4):
  rs = np.random.default_rng(seed)
  return {'seqs': rs.integers(0, vocab, (N, L)).astype(np.int32),
          'attention_mask': np.ones((N, L), np.float32)}


def _dropout_masks(backbone, rs, n=N, l=L):
  """One training forward's masks, in call order: a DiT or AR block's
  attention output and MLP output (keep 0.9); DiMamba has none."""
  if backbone == 'dimamba':
    return []
  w = WIDTHS[backbone]
  length = l - 1 if backbone == 'ar' else l
  return [rs.random((n, length, w['hidden_size'])) < 0.9
          for _ in range(2 * w['n_blocks'])]


def _rel(a, b):
  return float((a - b).norm() / max(float(b.norm()), 1e-30))


def test_ar_loss_matches_svdd_tpu(monkeypatch):
  """The AR baseline's shifted next-token NLL with dropout (JAX's masks)
  and an attention mask with zeros: loss and per-token NLLs, f32,
  1e-5."""
  model, jmodel, _, _ = _models('ar', 0)
  b = _batch(1)
  b['attention_mask'][:, -3:] = 0
  rs = np.random.default_rng(2)
  masks = _dropout_masks('ar', rs)
  FlaxMasks().set(masks).install(monkeypatch)
  want = jmodel.loss(jmodel.variables, jax.random.key(0),
                     jnp.asarray(b['seqs']), jnp.asarray(b['attention_mask']),
                     train=True, dropout_rng=jax.random.key(1))
  got = model.loss(_t(b['seqs']).long(), _t(b['attention_mask']), train=True,
                   masks=masks)
  np.testing.assert_allclose(float(got.loss.detach()), float(want.loss),
                             rtol=1e-5)
  np.testing.assert_allclose(got.nlls.detach().numpy(), np.asarray(want.nlls),
                             rtol=1e-5, atol=1e-6)
  assert got.nlls.shape == (N, L - 1)


def _loss_uniforms(key, n, length):
  kt, kq = jax.random.split(key)
  return (_t(jax.random.uniform(kt, (n,))),
          _t(jax.random.uniform(kq, (n, length))))


@pytest.mark.parametrize('backbone', ['dit', 'dimamba', 'ar'])
def test_train_step_matches_svdd_tpu(backbone, monkeypatch):
  """One optimizer step of ``train_diff.train_step`` against JAX's
  ``make_train_step`` (compiled) from the same weights, on JAX's time
  and mask uniforms and dropout masks: the loss (1e-5 relative), Adam's
  first moment, 0.1 times each clipped gradient (relative by norm,
  1e-4), and how far the update moved every parameter and the EMA
  shadow (relative by norm, 1e-3): AdamW's first update moves an
  element by g / (|g| + 1e-8) times the rate, about the rate whatever
  the gradient's size, so an element whose gradient is near the 1e-8
  moves apart by a share of the rate where the gradients differ in f32
  noise (one of 49,152 in the DiT's qkv kernel by 1.2e-5; one of
  DiMamba's 64 dt_proj biases put that leaf's update 4.8e-4 apart by
  norm). A wrong gradient flips the sign of many elements' updates, a
  distance of order 1."""
  model, jmodel, _, (cfg, jcfg) = _models(backbone, 3)
  b = _batch(4)
  masks = _dropout_masks(backbone, np.random.default_rng(5))
  FlaxMasks().set(masks).install(monkeypatch)
  jstate = jtrain.init_state(jmodel, jcfg, jax.random.key(6))
  _, loss_key, _ = jax.random.split(jstate.rng, 3)
  jstate, jloss = jax.jit(jtrain.make_train_step(jmodel, jcfg))(
      jstate, {k: jnp.asarray(v) for k, v in b.items()})
  state = train_diff.init_state(model, cfg)
  start = {k: p.detach().clone()
           for k, p in model.backbone.named_parameters()}
  noise = None if backbone == 'ar' else [_loss_uniforms(loss_key, N, L)]
  loss = train_diff.train_step(state, b, cfg, noise, masks=[masks])
  np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

  def port_tree(tree):
    return dict(CONVERT[backbone]({'params': tree}, cfg,
                                  torch.float32).named_parameters())

  mu = port_tree(jstate.opt_state[1][0].mu)
  for k, p in model.backbone.named_parameters():
    got = state.optimizer.adamw.state[p]['exp_avg']
    assert float(mu[k].abs().max()) > 0, k
    assert _rel(got, mu[k].detach()) <= 1e-4, k
  for got, want in ((dict(model.backbone.named_parameters()),
                     jstate.params),
                    (state.ema.shadow, jstate.ema.shadow)):
    want = port_tree(want)
    for k, p in got.items():
      moved, jmoved = p.detach() - start[k], want[k].detach() - start[k]
      assert float(jmoved.abs().max()) > 0, k
      assert _rel(moved, jmoved) <= 1e-3, k


@pytest.mark.parametrize('backbone', ['dit', 'dimamba', 'ar'])
def test_onehot_forward_gradient_matches_svdd_tpu(backbone):
  """``Diffusion.forward_onehot`` (``x_onehot @ vocab_embed``) and its
  gradient in the one-hot input against JAX's ``forward_onehot`` under
  ``jax.grad``, on partly masked tokens; f32: outputs 1e-4, the
  gradient relative by norm 1e-4."""
  model, jmodel, _, (cfg, _) = _models(backbone, 7)
  rs = np.random.default_rng(8)
  v = cfg.vocab_size
  x = rs.integers(0, v, (N, L)).astype(np.int32)
  onehot = np.eye(v, dtype=np.float32)[x]
  sigma = rs.uniform(0, 2, N).astype(np.float32)
  w = rs.normal(size=(N, L, v)).astype(np.float32)

  def jfn(oh):
    out = jmodel.forward_onehot(jmodel.variables, oh, jnp.asarray(x),
                                jnp.asarray(sigma))
    return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * w), out

  (_, jout), jgrad = jax.value_and_grad(jfn, has_aux=True)(
      jnp.asarray(onehot))
  oh = _t(onehot).requires_grad_()
  out = model.forward_onehot(oh, _t(x).long(), _t(sigma))
  torch.where(torch.isfinite(out), out, 0.0).mul(_t(w)).sum().backward()
  jout = np.asarray(jout)
  fin = np.isfinite(jout)
  assert (np.isfinite(out.detach().numpy()) == fin).all()
  np.testing.assert_allclose(out.detach().numpy()[fin], jout[fin],
                             rtol=1e-4, atol=1e-4)
  assert _rel(oh.grad, _t(jgrad)) <= 1e-4
  assert float(oh.grad.abs().max()) > 0


def test_dps_with_a_dit_denoiser_runs_through_the_onehot_gradient():
  """DPS with a DiT denoiser (``dps_sampler``, the synthetic motif
  oracle) decodes on the CPU: the one-hot gradient path the guidance
  step takes runs, and every sample is a token."""
  from svdd_tpu_torch import rewards
  model, _, _, (cfg, _) = _models('dit', 9)
  res = model.dps_sampler(rewards.synthetic_motif_oracle(L), 4,
                          guidance_scale=10.0, num_steps=4)(
                              torch.Generator().manual_seed(0))
  assert res.samples.shape == (4, L)
  assert int(res.samples.max()) < 4 and int(res.samples.min()) >= 0
