"""The Diffusion bundle's decode half (``svdd_tpu/diffusion.py``):
backbone + schedule + SUBS parameterization + the unguided, SVDD-MC,
DPS and classifier-guidance samplers."""

from __future__ import annotations

import torch

from svdd_tpu_torch import mdlm, schedules
from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models.cnn import CNNModel
from svdd_tpu_torch.sampling import guidance as G
from svdd_tpu_torch.sampling import sampler as S


def build_backbone(config: Config, generator: torch.Generator,
                   compute_dtype: torch.dtype = torch.float32):
  """Backbone factory; the CNN denoiser computes in float32 by default,
  as the JAX package does without SVDD_CNN_BF16."""
  if config.backbone != 'cnn':
    raise NotImplementedError(f'backbone {config.backbone!r} is not '
                              'ported yet')
  return CNNModel(config, alphabet_size=config.vocab_size,
                  compute_dtype=compute_dtype, generator=generator)


class Diffusion:
  """Denoiser bundle on one device, the card unless ``device`` says
  otherwise. Without ``backbone`` the weights are drawn from
  ``config.seed``."""

  def __init__(self, config: Config, device='cuda', backbone=None,
               compute_dtype: torch.dtype = torch.float32):
    self.config = config
    self.device = torch.device(device)
    self.vocab_size = config.vocab_size
    self.mask_index = config.mask_index
    self.parameterization = config.parameterization
    self.time_conditioning = config.time_conditioning
    if self.parameterization != 'subs':
      raise NotImplementedError(f'parameterization '
                                f'{self.parameterization!r} is not ported')
    self.schedule = schedules.get_schedule(
        config.noise.type, sigma_min=config.noise.sigma_min,
        sigma_max=config.noise.sigma_max, eps=config.noise.eps)
    if backbone is None:
      gen = torch.Generator(self.device).manual_seed(config.seed)
      backbone = build_backbone(config, gen, compute_dtype)
    self.backbone = backbone.to(self.device).eval()

  def _process_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
    """time_conditioning=False zeroes sigma (both bio tasks)."""
    if sigma.ndim > 1:
      sigma = sigma.squeeze(-1)
    if not self.time_conditioning:
      sigma = torch.zeros_like(sigma)
    return sigma

  def _parameterize(self, logits, xt):
    return mdlm.subs_parameterization(logits, xt, self.mask_index)

  def forward(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """log p(x0 | xt)."""
    logits = self.backbone(x, self._process_sigma(sigma))
    return self._parameterize(logits, x)

  def forward_onehot(self, x_onehot: torch.Tensor, x: torch.Tensor,
                     sigma: torch.Tensor) -> torch.Tensor:
    """'forward2': log p(x0 | xt) from a (N, L, V) one-hot input in place
    of the tokens' own, differentiable with respect to it (DPS)."""
    logits = self.backbone(x, self._process_sigma(sigma), x_onehot=x_onehot)
    return self._parameterize(logits, x)

  def denoise_fn(self) -> S.DenoiseFn:
    return self.forward

  def denoise_onehot_fn(self):
    return self.forward_onehot

  def _reverse(self, step_fn, batch_size: int, num_steps, eps: float,
               grad_steps: bool = False):
    cfg = self.config
    return S.reverse_process(
        step_fn, self.forward, self.schedule, batch_size=batch_size,
        length=cfg.model.length, mask_index=self.mask_index,
        num_steps=num_steps or cfg.sampling.steps, eps=eps,
        noise_removal=cfg.sampling.noise_removal, device=self.device,
        grad_steps=grad_steps)

  def sampler(self, batch_size: int, *, num_steps: int | None = None,
              eps: float = 1e-5):
    """Uncontrolled ddpm sampler: generator -> SampleResult."""
    if self.config.sampling.predictor != 'ddpm':
      raise NotImplementedError(f'predictor '
                                f'{self.config.sampling.predictor!r}')
    step = S.ddpm_step(self.forward, self.schedule, self.mask_index)
    return self._reverse(step, batch_size, num_steps, eps)

  def controlled_sampler(self, value_fn, batch_size: int, *,
                         sample_M: int = 10,
                         num_steps: int | None = None,
                         eps: float = 1e-5):
    """SVDD-MC sampler; ``value_fn``: (N, L) tokens -> (N,) scores."""
    step = G.svdd_mc_step(self.forward, value_fn, self.schedule,
                          self.mask_index, repeats=sample_M)
    return self._reverse(step, batch_size, num_steps, eps)

  def dps_sampler(self, reward_fn, batch_size: int, *,
                  guidance_scale: float = 1.0,
                  num_steps: int | None = None, eps: float = 1e-5):
    """DPS sampler; ``reward_fn``: (N, L, 4) -> (N,), differentiable."""
    step = G.dps_step(self.forward_onehot, reward_fn, self.schedule,
                      self.mask_index, guidance_scale=guidance_scale)
    return self._reverse(step, batch_size, num_steps, eps, grad_steps=True)

  def classifier_sampler(self, value_fn_onehot, batch_size: int, *,
                         guidance_scale: float = 1.0,
                         num_steps: int | None = None, eps: float = 1e-5):
    """Classifier-guidance sampler; ``value_fn_onehot``: (N, L, 4) ->
    (N,), differentiable (``ValueFunction.as_onehot_fn``)."""
    step = G.classifier_step(self.forward, value_fn_onehot, self.schedule,
                             self.mask_index, guidance_scale=guidance_scale)
    return self._reverse(step, batch_size, num_steps, eps, grad_steps=True)
