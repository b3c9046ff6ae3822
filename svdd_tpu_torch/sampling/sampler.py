"""The reverse process as a Python loop (``svdd_tpu/sampling/sampler.py``).

step_fn(x, t, t_next, generator) -> x_next, with t and t_next 0-dim
float32 CPU tensors. Schedules and move chances are computed on the
host from them and enter device ops as scalars, and each draw takes its
noise from ``generator``, so a step reads nothing back from the card and
the loop queues its work without waiting. The one exception is the
ddpm_cache step, which carries an aux state
(step_fn(aux, x, t, t_next, generator) -> (aux, x_next)) and reads one
flag back per step to decide whether the next step may skip its forward.

The guided steps of SVDD-PM and TDS carry an aux too: the winner's or
the resampled particles' posterior (log_p, valid), and TDS's ESS trace
and log-weights. Their ``valid`` flag is known on the host (False on
step 0, True after), and TDS keeps its weights, its resampling decision
and its ESS on the card, so these loops read nothing back.

``step_fn`` may also be a phase list [(step_fn, n_steps), ...] whose
lengths sum to num_steps (scheduled-M decoding); one generator flows
through the phases, so a one-phase list draws as the plain form.

``collect_mid`` keeps the state after every step but the last (the
result's ``mid_x``, (num_steps - 1, B, L)), ``collect_aux`` the aux
after every step stacked (the CD-Q candidates), as the value-net
trainer's targets read them (``svdd_tpu/sampling/sampler.py:199,
236-238``).

``shard`` (a ``parallel.mesh.RowShard``) runs the loop on this
process's rows of the batch (``svdd_tpu/sampling/sampler.py:187``,
JAX's ``shard_constraint``): the prior, the steps and the noise removal
on the local rows, every draw the global batch's rows
(``parallel/rows.py``), and the result gathered over the ``data`` axis,
so every process returns the global samples, states and aux.

The loop runs under ``torch.inference_mode()``; a loop of gradient
steps (DPS, classifier guidance) runs under ``torch.no_grad()`` instead,
since tensors made in inference mode cannot enter autograd, and each
step turns gradients on around its own gradient.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.parallel import rows
from svdd_tpu_torch.schedules import Schedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class SampleResult(NamedTuple):
  samples: torch.Tensor        # (B, L) final tokens (mask-free)
  extra: Any = None            # the final aux of a step that carries one,
                               # or every step's aux stacked (collect_aux)
  mid_x: Any = None            # (num_steps - 1, B, L) with collect_mid


def timestep_grid(num_steps: int, eps: float) -> torch.Tensor:
  """linspace(1, eps, num_steps + 1) in float32, on the host."""
  return torch.linspace(1.0, eps, num_steps + 1, dtype=torch.float32)


def sigma_batch(schedule: Schedule, t, batch: int, device) -> torch.Tensor:
  """Broadcast the scalar sigma(t) to per-row conditioning (B,)."""
  sigma, _ = schedule(t)
  return torch.full((batch,), float(sigma), dtype=torch.float32,
                    device=device)


def move_chances(schedule: Schedule, t, t_next):
  """(sigma_t, mct, mcs) with mc = 1 - exp(-sigma)."""
  sigma_t, _ = schedule(t)
  sigma_s, _ = schedule(t_next)
  return sigma_t, 1 - torch.exp(-sigma_t), 1 - torch.exp(-sigma_s)


def ddpm_step(denoise_fn: DenoiseFn, schedule: Schedule,
              mask_index: int):
  """Uncontrolled ddpm ancestral step."""

  def step(x, t, t_next, generator, gumbel=None):
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, x.shape[0], x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    if gumbel is None:
      gumbel = mdlm.gumbel_noise(log_q.shape, generator, log_q.device)
    draw = mdlm.sample_categorical(log_q, gumbel)
    return torch.where(x != mask_index, x, draw)

  return step


def ddpm_cache_step(denoise_fn: DenoiseFn, schedule: Schedule,
                    mask_index: int):
  """Caching variant of the ddpm step: reuse log p(x0 | xt) while x is
  unchanged. aux is (log_p_cache, valid). For the loglinear schedule the
  move chances are t and t_next themselves (not 1 - exp(-sigma)).

  Whether the next step may reuse the cache depends on this step's draw,
  so the step reads one flag (did any token change?) back from the card,
  as the reference's loop checks it on the host
  (diffusion_gosai.py:874-879)."""

  def step(aux, x, t, t_next, generator, gumbel=None):
    log_p_cache, valid = aux
    if valid:
      log_p = log_p_cache
    else:
      log_p = denoise_fn(x, sigma_batch(schedule, t, x.shape[0], x.device))
    log_q = mdlm.log_q_xs(log_p, t, t_next, mask_index)
    if gumbel is None:
      gumbel = mdlm.gumbel_noise(log_q.shape, generator, log_q.device)
    draw = mdlm.sample_categorical(log_q, gumbel)
    x_next = torch.where(x != mask_index, x, draw)
    return (log_p, bool(torch.equal(x_next, x))), x_next

  return step


def analytic_step(denoise_fn: DenoiseFn, schedule: Schedule,
                  mask_index: int, vocab_size: int):
  """The analytic (score-based) update (``svdd_tpu/sampling/sampler.py:
  93-110``): the denoiser's score, staggered by dsigma = sigma(t) -
  sigma(t_next), times the transposed transition, drawn by Gumbel-max
  over every token (unmasked ones included)."""

  def step(x, t, t_next, generator, gumbel=None):
    curr_sigma, _ = schedule(t)
    next_sigma, _ = schedule(t_next)
    b = x.shape[0]
    dsigma = torch.full((b,), float(curr_sigma - next_sigma),
                        dtype=torch.float32, device=x.device)
    sigma_b = sigma_batch(schedule, t, b, x.device)
    log_p = denoise_fn(x, sigma_b)
    score = mdlm.get_score(log_p, x, sigma_b, mask_index)
    stag = mdlm.staggered_score(score, dsigma, mask_index)
    probs = stag * mdlm.transp_transition(x, dsigma, vocab_size, mask_index)
    if gumbel is None:
      gumbel = mdlm.gumbel_noise(probs.shape, generator, probs.device)
    return mdlm.sample_categorical_probs(probs, gumbel)

  return step


def denoiser_final(denoise_fn: DenoiseFn, schedule: Schedule,
                   mask_index: int, vocab_size: int, x: torch.Tensor, t,
                   generator: torch.Generator, gumbel=None) -> torch.Tensor:
  """The analytic sampler's noise removal (``svdd_tpu/sampling/sampler.py:
  113-124``): the step at sigma(t) with the MASK lane's probability
  zeroed."""
  sigma_b = sigma_batch(schedule, t, x.shape[0], x.device)
  log_p = denoise_fn(x, sigma_b)
  score = mdlm.get_score(log_p, x, sigma_b, mask_index)
  stag = mdlm.staggered_score(score, sigma_b, mask_index)
  probs = stag * mdlm.transp_transition(x, sigma_b, vocab_size, mask_index)
  probs = torch.where(
      torch.arange(vocab_size, device=x.device) == mask_index, 0.0, probs)
  if gumbel is None:
    gumbel = mdlm.gumbel_noise(probs.shape, generator, probs.device)
  return mdlm.sample_categorical_probs(probs, gumbel)


def argmax_noise_removal(denoise_fn: DenoiseFn, schedule: Schedule,
                         x: torch.Tensor, t) -> torch.Tensor:
  """Final forward + argmax over the non-mask vocabulary."""
  logits = denoise_fn(x, sigma_batch(schedule, t, x.shape[0], x.device))
  return torch.argmax(logits[..., :-1], dim=-1)


def _phases(step_fn, num_steps: int):
  """[(step_fn, n), ...] of a phase list or one step function, with the
  JAX package's checks (``svdd_tpu/sampling/sampler.py:171-182``)."""
  phases = (list(step_fn) if isinstance(step_fn, (list, tuple))
            else [(step_fn, num_steps)])
  lengths = [n for _, n in phases]
  if any(n < 1 for n in lengths):
    raise ValueError(f'phase lengths must be >= 1: {lengths}')
  if sum(lengths) != num_steps:
    raise ValueError(f'phase lengths {lengths} do not sum to '
                     f'num_steps={num_steps}')
  return phases


def reverse_process(step_fn, denoise_fn: DenoiseFn, schedule: Schedule,
                    *, batch_size: int, length: int, mask_index: int,
                    num_steps: int, eps: float = 1e-5,
                    noise_removal: bool = True, device='cuda',
                    grad_steps: bool = False, aux_init=None,
                    removal_from_aux: bool = False,
                    collect_mid: bool = False, collect_aux: bool = False,
                    analytic_removal: bool = False, vocab_size: int = 0,
                    shard=None):
  """prior -> num_steps steps -> final noise removal: the argmax, or,
  with ``analytic_removal`` (the analytic predictor; it takes precedence
  over ``removal_from_aux``, as in JAX), ``denoiser_final`` over
  ``vocab_size`` tokens.
  Returns sample(generator) -> SampleResult. ``step_fn``: one step
  function or a phase list [(step_fn, n_steps), ...] (lengths >= 1,
  summing to num_steps). ``grad_steps``: the steps take gradients, so
  the loop runs outside inference mode. ``aux_init``: the first aux of
  a step that carries one (ddpm_cache, SVDD-PM, TDS); None for the steps
  that do not. ``removal_from_aux``: the carry (log_p, valid) holds the
  denoiser's forward of the final x at sigma(t_last) (the guided steps'
  carry_posterior; TDS's dict nests it under 'post'), so noise removal
  argmaxes it over the non-mask vocabulary instead of running that
  forward. ``collect_mid``, ``collect_aux``, ``shard``: the module
  docstring (``batch_size`` is then the global batch)."""
  timesteps = timestep_grid(num_steps, eps)
  phases = _phases(step_fn, num_steps)
  local = batch_size if shard is None else shard.local

  def sample(generator: torch.Generator) -> SampleResult:
    if shard is None:
      return run(generator)
    with rows.global_rows(shard.row0, shard.total):
      res = run(generator)
    return SampleResult(
        samples=shard.gather(res.samples),
        extra=_gather_extra(shard, res.extra, collect_aux),
        mid_x=None if res.mid_x is None else shard.gather(res.mid_x, 1))

  def run(generator: torch.Generator) -> SampleResult:
    with torch.no_grad() if grad_steps else torch.inference_mode():
      x = mdlm.sample_prior((local, length), mask_index, device)
      aux = aux_init
      mids, auxs = [], []
      start = 0
      for fn, n in phases:
        for i in range(start, start + n):
          if aux is None:
            x = fn(x, timesteps[i], timesteps[i + 1], generator)
          else:
            aux, x = fn(aux, x, timesteps[i], timesteps[i + 1], generator)
          if collect_mid:
            mids.append(x)
          if collect_aux:
            auxs.append(aux)
        start += n
      if noise_removal and analytic_removal:
        x = denoiser_final(denoise_fn, schedule, mask_index, vocab_size, x,
                           timesteps[-1], generator)
      elif noise_removal and removal_from_aux:
        post = aux['post'] if isinstance(aux, dict) else aux
        x = torch.argmax(post[0][..., :-1], dim=-1)
      elif noise_removal:
        x = argmax_noise_removal(denoise_fn, schedule, x, timesteps[-1])
      mid_x = torch.stack(mids[:-1]) if collect_mid else None
      extra = torch.stack(auxs) if collect_aux else aux
    return SampleResult(samples=x, extra=extra, mid_x=mid_x)

  return sample


def _gather_extra(shard, extra, collect_aux: bool):
  """The global aux of a sharded loop: the stacked aux's rows (axis 1),
  or the row-wise tensor of a carry ((log_p, valid), TDS's dict under
  'post'); TDS's ESS trace and log-weights are global already."""
  if extra is None or (isinstance(extra, tuple) and not extra):
    return extra
  if collect_aux:
    return shard.gather(extra, 1)
  if isinstance(extra, dict):
    return dict(extra, post=_gather_extra(shard, extra['post'], False))
  if isinstance(extra, tuple) and torch.is_tensor(extra[0]):
    return (shard.gather(extra[0]),) + tuple(extra[1:])
  return extra
