"""The Diffusion bundle (``svdd_tpu/diffusion.py``): backbone (CNN, DiT,
DiMamba or the AR transformer) + schedule + parameterization (SUBS,
D3PM, SEDD, or, for ``parameterization='ar'``, the backbone's next-token
log-probs as they are) + the unguided (ddpm, ddpm_cache), SVDD-MC (with
scheduled M, and with a step-indexed value function), SVDD-PM (Tweedie),
TDS, DPS and classifier-guidance samplers, the CD-Q trajectory sampler
of value-net training, and the training loss of every backbone: the
continuous-time SUBS NELBO, the discrete-time (``T > 0``) D3PM VLB with
D3PM's reconstruction term, SEDD's score entropy, or the AR baseline's
shifted next-token NLL.

As in JAX, a forward hands the parameterization the processed sigma
(zero under ``time_conditioning=False``, the bio tasks' default), the
training loss the raw one: SEDD's log score is then +inf off the current
token in every sampler, and a Gumbel-max draw takes the first lane.

The samplers run under ``torch.inference_mode`` (``torch.no_grad`` for
the gradient-guided ones); ``loss`` runs under autograd, and with
``train=True`` it is the training mode (the denoiser's dropout).

Every sampler takes ``mesh`` (a ``parallel.mesh.Mesh``;
``svdd_tpu/diffusion.py:252-290``): ``batch_size`` is then the global
batch, each process runs its rows of it (``sampling/sampler.py``) and
returns the global result; SVDD-MC's and SVDD-PM's candidate rows split
over every process, or, for SVDD-MC with ``tp=True``, stay whole on each
model rank while the value net (``models.enformer.
tp_shard_value_params``) splits over ``model``."""

from __future__ import annotations

import os

import torch

from svdd_tpu_torch import mdlm, schedules
from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models.autoregressive import ARModel
from svdd_tpu_torch.models.cnn import CNNModel
from svdd_tpu_torch.models.dimamba import DiMamba
from svdd_tpu_torch.models.dit import DIT
from svdd_tpu_torch.parallel.mesh import RowShard
from svdd_tpu_torch.sampling import guidance as G
from svdd_tpu_torch.sampling import sampler as S


def compute_dtype(config: Config) -> torch.dtype:
  """The dit/dimamba compute dtype, from ``parallel.precision``."""
  return (torch.bfloat16 if config.parallel.precision == 'bf16'
          else torch.float32)


def cnn_compute_dtype() -> torch.dtype:
  """The CNN denoiser's compute dtype: bfloat16 under SVDD_CNN_BF16=1,
  else float32 (``svdd_tpu/diffusion.py:build_backbone``)."""
  return (torch.bfloat16 if os.environ.get('SVDD_CNN_BF16') == '1'
          else torch.float32)


def build_backbone(config: Config, generator: torch.Generator):
  """Backbone factory. The CNN denoiser computes in
  ``cnn_compute_dtype()``, the DiT, DiMamba and AR in
  ``compute_dtype(config)``."""
  if config.backbone == 'cnn':
    return CNNModel(config, alphabet_size=config.vocab_size,
                    compute_dtype=cnn_compute_dtype(), generator=generator)
  if config.backbone == 'dit':
    return DIT(config, config.vocab_size, compute_dtype(config), generator)
  if config.backbone == 'dimamba':
    return DiMamba(config, config.vocab_size, compute_dtype(config),
                   generator)
  if config.backbone == 'ar':
    return ARModel(config, config.vocab_size, compute_dtype(config),
                   generator)
  raise ValueError(f'unknown backbone {config.backbone}')


class Diffusion:
  """Denoiser bundle on one device, the card unless ``device`` says
  otherwise. Without ``backbone`` the weights are drawn from
  ``config.seed``."""

  def __init__(self, config: Config, device='cuda', backbone=None):
    self.config = config
    self.device = torch.device(device)
    self.vocab_size = config.vocab_size
    self.mask_index = config.mask_index
    self.parameterization = config.parameterization
    self.time_conditioning = config.time_conditioning
    self.schedule = schedules.get_schedule(
        config.noise.type, sigma_min=config.noise.sigma_min,
        sigma_max=config.noise.sigma_max, eps=config.noise.eps)
    if backbone is None:
      gen = torch.Generator(self.device).manual_seed(config.seed)
      backbone = build_backbone(config, gen)
    self.backbone = backbone.to(self.device).eval()

  def _process_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
    """time_conditioning=False zeroes sigma (both bio tasks)."""
    if sigma.ndim > 1:
      sigma = sigma.squeeze(-1)
    if not self.time_conditioning:
      sigma = torch.zeros_like(sigma)
    return sigma

  def _parameterize(self, logits, xt, sigma):
    if self.parameterization == 'subs':
      return mdlm.subs_parameterization(logits, xt, self.mask_index)
    if self.parameterization == 'sedd':
      return mdlm.sedd_parameterization(logits, xt, sigma)
    if self.parameterization == 'd3pm':
      return mdlm.d3pm_parameterization(logits, self.mask_index,
                                        self.config.subs_masking)
    return logits   # 'ar'

  def forward(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """log p(x0 | xt) (SEDD: the log score), the parameterization given
    the processed sigma."""
    sigma = self._process_sigma(sigma)
    return self._parameterize(self.backbone(x, sigma), x, sigma)

  def forward_onehot(self, x_onehot: torch.Tensor, x: torch.Tensor,
                     sigma: torch.Tensor) -> torch.Tensor:
    """'forward2': log p(x0 | xt) from a (N, L, V) one-hot input in place
    of the tokens' own, differentiable with respect to it (DPS)."""
    sigma = self._process_sigma(sigma)
    logits = self.backbone(x, sigma, x_onehot=x_onehot)
    return self._parameterize(logits, x, sigma)

  def loss(self, x0: torch.Tensor, attention_mask=None, *,
           train: bool = False, generator: torch.Generator | None = None,
           noise=None, masks=None, apply_fn=None) -> mdlm.LossOutput:
    """The training loss of the clean tokens x0 (B, L)
    (``svdd_tpu/diffusion.py:137-215``): times from
    ``training.sampling_eps`` (antithetic, optionally through the
    schedule's importance transform; with ``T > 0`` snapped to the grid,
    (t T) truncated to an integer, over T, plus 1/T), x0 masked to x_t,
    the denoiser on x_t, then SEDD's dsigma-weighted score entropy, the
    D3PM VLB for ``T > 0`` (D3PM adds its reconstruction term, a second
    denoiser forward on x0 at t = 0), else the continuous-time SUBS
    NELBO. ``noise`` = (t_uniforms (B,), mask_uniforms (B, L)) in place
    of the draws from ``generator``, which also draws the dropout masks
    when ``train``; ``masks`` (DiT, AR) the list of dropout masks in call
    order in place of those draws (D3PM's second forward takes the same
    list, as JAX's takes the same dropout key). Under
    ``parameterization='ar'``, the shifted next-token NLL of x0
    (``svdd_tpu/diffusion.py:152-172``), which draws no noise.
    Differentiable in the backbone's parameters. ``apply_fn`` replaces
    the backbone's forward (``svdd_tpu/diffusion.py:137-150``): the
    pipelined DiT (``parallel.pipeline.pipelined_backbone_apply``)
    computes the same logits with its blocks split over a pipe grid."""
    cfg = self.config
    backbone = self.backbone if apply_fn is None else apply_fn
    drop = {} if masks is None else {'masks': masks}
    if self.parameterization == 'ar':
      if x0.shape[1] > cfg.model.length:
        raise NotImplementedError('sub-sampling not implemented '
                                  '(reference parity)')
      if attention_mask is None:
        attention_mask = torch.ones(x0.shape, device=x0.device)
      mask = attention_mask[:, 1:]
      logprobs = backbone(x0[:, :-1], None, train=train,
                               generator=generator, **drop)
      nll = -logprobs.gather(-1, x0[:, 1:, None].long())[..., 0]
      nlls = nll * mask
      return mdlm.LossOutput(nlls.sum() / mask.sum(), nlls, mask)
    if noise is None:
      noise = (mdlm.uniforms(x0.shape[:1], generator, self.device),
               mdlm.uniforms(tuple(x0.shape), generator, self.device))
    t_u, q_u = noise
    t = mdlm.sample_t(t_u, cfg.training.sampling_eps,
                      cfg.training.antithetic_sampling)
    if cfg.training.importance_sampling:
      t = self.schedule.importance_transform(t)
    if cfg.T > 0:
      t = (t * cfg.T).to(torch.int32).to(torch.float32) / cfg.T + 1.0 / cfg.T
    sigma, dsigma = self.schedule(t)
    move_chance = (1 - torch.exp(-sigma))[:, None]
    xt = mdlm.q_xt(x0, move_chance, self.mask_index, q_u)
    logits = backbone(xt, self._process_sigma(sigma), train=train,
                      generator=generator, **drop)
    model_output = self._parameterize(logits, xt, sigma)
    if self.parameterization == 'sedd':
      loss = dsigma[:, None] * mdlm.score_entropy(
          model_output, sigma[:, None], xt, x0, self.mask_index)
    elif cfg.T > 0:
      loss = mdlm.d3pm_loss(model_output, xt, x0, t, self.mask_index, cfg.T)
      if self.parameterization == 'd3pm':
        sigma_t0 = self.schedule.total(torch.zeros(x0.shape[0],
                                                   device=x0.device))
        logits0 = backbone(x0, self._process_sigma(sigma_t0), train=train,
                           generator=generator, **drop)
        out0 = self._parameterize(logits0, x0, sigma_t0)
        loss = loss - torch.gather(out0, -1, x0[..., None].long())[..., 0]
    else:
      return mdlm.nelbo_subs(model_output, x0, sigma, dsigma, attention_mask)
    if attention_mask is None:
      attention_mask = torch.ones_like(loss)
    nlls = loss * attention_mask
    return mdlm.LossOutput(nlls.sum() / attention_mask.sum(), nlls,
                           attention_mask)

  def denoise_fn(self) -> S.DenoiseFn:
    return self.forward

  def denoise_onehot_fn(self):
    return self.forward_onehot

  def _reverse(self, step_fn, batch_size: int, num_steps, eps: float,
               grad_steps: bool = False, aux_init=None,
               removal_from_aux: bool = False, collect_mid: bool = False,
               collect_aux: bool = False, shard=None):
    cfg = self.config
    return S.reverse_process(
        step_fn, self.forward, self.schedule, batch_size=batch_size,
        length=cfg.model.length, mask_index=self.mask_index,
        num_steps=num_steps or cfg.sampling.steps, eps=eps,
        noise_removal=cfg.sampling.noise_removal, device=self.device,
        grad_steps=grad_steps, aux_init=aux_init,
        removal_from_aux=removal_from_aux, collect_mid=collect_mid,
        collect_aux=collect_aux,
        analytic_removal=cfg.sampling.predictor == 'analytic',
        vocab_size=self.vocab_size, shard=shard)

  @staticmethod
  def _shard(mesh, batch_size: int, tp: bool = False):
    """The batch's rows over ``mesh`` (None without one)."""
    return None if mesh is None else RowShard(mesh, batch_size, tp)

  @staticmethod
  def _phased(make_step, sample_M: int, m_schedule):
    """One step of ``sample_M`` candidates, or the phase list of
    ``m_schedule`` ((n_steps, M), ...)."""
    if m_schedule is None:
      return make_step(sample_M)
    return [(make_step(int(m)), int(n)) for n, m in m_schedule]

  def sampler(self, batch_size: int, *, num_steps: int | None = None,
              eps: float = 1e-5, collect_mid: bool = False, mesh=None):
    """Uncontrolled sampler, ``sampling.predictor`` 'ddpm', 'ddpm_cache'
    or 'analytic': generator -> SampleResult; ``collect_mid`` fills its
    ``mid_x`` (the value-net trainer's states). Under 'analytic' every
    sampler's noise removal is ``denoiser_final``
    (``svdd_tpu/diffusion.py:249``)."""
    pred = self.config.sampling.predictor
    shard = self._shard(mesh, batch_size)
    if pred == 'ddpm':
      step = S.ddpm_step(self.forward, self.schedule, self.mask_index)
      return self._reverse(step, batch_size, num_steps, eps,
                           collect_mid=collect_mid, shard=shard)
    if pred == 'ddpm_cache':
      step = S.ddpm_cache_step(self.forward, self.schedule, self.mask_index)
      return self._reverse(step, batch_size, num_steps, eps,
                           aux_init=(None, False), collect_mid=collect_mid,
                           shard=shard)
    if pred == 'analytic':
      step = S.analytic_step(self.forward, self.schedule, self.mask_index,
                             self.vocab_size)
      return self._reverse(step, batch_size, num_steps, eps,
                           collect_mid=collect_mid, shard=shard)
    raise NotImplementedError(f'predictor {pred!r} is not ported yet')

  def cdq_sampler(self, batch_size: int, *, repeats: int = 10,
                  num_steps: int | None = None, eps: float = 1e-5,
                  mesh=None):
    """CD-Q trajectory collection (``svdd_tpu/diffusion.py:335-353``):
    generator -> SampleResult whose ``extra`` stacks every step's
    candidates (steps, B, repeats, L) and whose ``mid_x`` the
    trajectory's states."""
    step = G.cdq_step(self.forward, self.schedule, self.mask_index, repeats)
    shard = self._shard(mesh, batch_size)
    local = batch_size if shard is None else shard.local
    aux_init = torch.zeros((local, repeats, self.config.model.length),
                           dtype=torch.long, device=self.device)
    return self._reverse(step, batch_size, num_steps, eps, aux_init=aux_init,
                         collect_mid=True, collect_aux=True, shard=shard)

  def controlled_sampler(self, value_fn, batch_size: int, *,
                         sample_M: int = 10,
                         num_steps: int | None = None,
                         eps: float = 1e-5, m_schedule=None, mesh=None,
                         tp: bool = False):
    """SVDD-MC sampler; ``value_fn``: (N, L) tokens -> (N,) scores.
    ``m_schedule``: scheduled-M phases ((n_steps, M), ...) covering the
    trajectory, in place of ``sample_M``. ``mesh``, ``tp``: the module
    docstring (with ``tp``, ``value_fn`` is the tensor-parallel net's)."""
    shard = self._shard(mesh, batch_size, tp)
    step = self._phased(
        lambda m: G.svdd_mc_step(self.forward, value_fn, self.schedule,
                                 self.mask_index, repeats=m, shard=shard),
        sample_M, m_schedule)
    return self._reverse(step, batch_size, num_steps, eps, shard=shard)

  def controlled_sampler_timed(self, value_fn_timed, batch_size: int, *,
                               sample_M: int = 10,
                               num_steps: int | None = None,
                               eps: float = 1e-5, mesh=None):
    """SVDD-MC with a step-indexed value function, the timed and
    multisep value models (``svdd_tpu/diffusion.py:392-410``):
    ``value_fn_timed(tokens (N, L), step)`` -> (N,): a timed
    ``ValueFunction``'s ``score_tokens`` with every position at ``step``
    (the reference's timed loop feeds ``torch.full((B, L), i)``), or a
    multisep model's ``apply_at_step`` on the one-hots."""
    steps = num_steps or self.config.sampling.steps
    shard = self._shard(mesh, batch_size)
    step = G.svdd_mc_step_timed(self.forward, value_fn_timed, self.schedule,
                                self.mask_index, steps, eps,
                                repeats=sample_M, shard=shard)
    return self._reverse(step, batch_size, num_steps, eps, shard=shard)

  def tweedie_sampler(self, reward_fn, batch_size: int, *,
                      sample_M: int = 10, tweedie: bool = True,
                      task: str = 'dna', saluki_body=None,
                      saluki_final_length: int = 12288,
                      num_steps: int | None = None, eps: float = 1e-5,
                      reuse_posterior: bool = True, m_schedule=None,
                      mesh=None):
    """SVDD-PM sampler (``svdd_tpu/diffusion.py:422-463``); ``reward_fn``:
    (N, L, 4) -> (N,), or, for ``task='rna_saluki'``, the saluki input
    (``saluki_body``, ``saluki_final_length``) -> (N,).
    ``reuse_posterior`` (tweedie only): carry the winner's candidate
    forward across steps and into noise removal. ``m_schedule`` as in
    ``controlled_sampler``."""
    reuse = reuse_posterior and tweedie
    shard = self._shard(mesh, batch_size)
    step = self._phased(
        lambda m: G.svdd_pm_step(self.forward, reward_fn, self.schedule,
                                 self.mask_index, repeats=m,
                                 tweedie=tweedie, task=task,
                                 saluki_body=saluki_body,
                                 saluki_final_length=saluki_final_length,
                                 carry_posterior=reuse, shard=shard),
        sample_M, m_schedule)
    aux_init = (None, False) if reuse else ()   # no posterior yet
    return self._reverse(step, batch_size, num_steps, eps,
                         aux_init=aux_init, removal_from_aux=reuse,
                         shard=shard)

  def tds_sampler(self, reward_fn, batch_size: int, *, alpha: float = 1.0,
                  num_steps: int | None = None, eps: float = 1e-5,
                  reuse_posterior: bool = True, track_ess: bool = True,
                  ess_threshold: float | None = None, mesh=None):
    """TDS sampler (``svdd_tpu/diffusion.py:465-503``); ``reward_fn``:
    (N, L, 4) -> (N,). ``reuse_posterior``: carry the resampled
    particles' forward, which drops one of the three forwards a step and
    the removal forward. ``track_ess``: the result's ``extra['ess']``
    holds each step's effective sample size. ``ess_threshold``: adaptive
    resampling (``guidance.tds_step``)."""
    steps = num_steps or self.config.sampling.steps
    shard = self._shard(mesh, batch_size)
    post_init = (None, False) if reuse_posterior else ()
    aux_init = G.tds_aux_init(batch_size, post_init, track_ess=track_ess,
                              num_steps=steps, ess_threshold=ess_threshold,
                              device=self.device)
    step = G.tds_step(self.forward, reward_fn, self.schedule,
                      self.mask_index, alpha=alpha,
                      carry_posterior=reuse_posterior, track_ess=track_ess,
                      num_steps=steps, ess_threshold=ess_threshold,
                      shard=shard)
    return self._reverse(step, batch_size, num_steps, eps,
                         aux_init=aux_init,
                         removal_from_aux=reuse_posterior, shard=shard)

  def dps_sampler(self, reward_fn, batch_size: int, *,
                  guidance_scale: float = 1.0,
                  num_steps: int | None = None, eps: float = 1e-5,
                  mesh=None):
    """DPS sampler; ``reward_fn``: (N, L, 4) -> (N,), differentiable."""
    shard = self._shard(mesh, batch_size)
    step = G.dps_step(self.forward_onehot, reward_fn, self.schedule,
                      self.mask_index, guidance_scale=guidance_scale,
                      shard=shard)
    return self._reverse(step, batch_size, num_steps, eps, grad_steps=True,
                         shard=shard)

  def classifier_sampler(self, value_fn_onehot, batch_size: int, *,
                         guidance_scale: float = 1.0,
                         num_steps: int | None = None, eps: float = 1e-5,
                         mesh=None):
    """Classifier-guidance sampler; ``value_fn_onehot``: (N, L, 4) ->
    (N,), differentiable (``ValueFunction.as_onehot_fn``)."""
    shard = self._shard(mesh, batch_size)
    step = G.classifier_step(self.forward, value_fn_onehot, self.schedule,
                             self.mask_index, guidance_scale=guidance_scale,
                             shard=shard)
    return self._reverse(step, batch_size, num_steps, eps, grad_steps=True,
                         shard=shard)
