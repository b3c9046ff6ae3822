"""Guided reverse steps (``svdd_tpu/sampling/guidance.py``).

SVDD-MC, per step: the denoiser gives log p(x0|xt), ``log_q_xs`` the
step posterior, the candidate kernel M draws per row, the value net
scores all B*M candidates in ONE batched forward, and each row keeps
its best-scoring candidate.

SVDD-PM scores the candidates by the reward of their posterior mean
(Tweedie): a second denoiser forward on the B*M candidates at the next
step's sigma, its argmax filling the masked positions. TDS is sequential
Monte Carlo: one draw per particle, importance weights from the rewards
of the posterior means before and after, and a resample of the batch
from those weights, on the card (``resample_indices``). Both can carry
the next step's denoiser forward of the chosen rows (``carry_posterior``),
which makes the per-step (B,) forward and the removal forward exact
reuses.

DPS and classifier guidance tilt the step posterior by a gradient with
respect to the one-hot input, ``torch.autograd.grad`` in place of
``jax.grad``; the models' parameters take no gradient. Every step
accepts injected Gumbel noise, so it can be pinned against the JAX step.

``shard`` (a ``parallel.mesh.RowShard``): the step runs on this
process's rows of a batch split over the grid's ``data`` axis
(``svdd_tpu/sampling/sampler.py:187``), its noise the global batch's
rows (``parallel/rows.py``). The folded candidate rows of SVDD-MC and
SVDD-PM split further over ``model`` and their scores are gathered
before the argmax (JAX's ``shard_flat``, ``guidance.py:86-87``); under
``shard.tp`` the value net is split instead and every model rank scores
every candidate. TDS gathers the log-weights, the particles and their
carry over ``data`` and draws the same ancestors in every process; DPS
and classifier guidance take the gradient of the global batch's mean.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.ops.fused_sample import gumbel_candidates
from svdd_tpu_torch.parallel import rows
from svdd_tpu_torch.rewards import RewardOracle
from svdd_tpu_torch.sampling.sampler import (DenoiseFn, move_chances,
                                             sigma_batch)
from svdd_tpu_torch.schedules import Schedule

ValueFn = Callable[[torch.Tensor], torch.Tensor]
RewardFn = Callable[[torch.Tensor], torch.Tensor]    # (N, L, 4) -> (N,)


def _draw_candidates(log_q, x, mask_index: int, repeats: int,
                     generator: torch.Generator, gumbel=None):
  """(B, M, L) candidates: Gumbel-max draws, unmasked tokens kept; the
  rows of a split batch draw as the global batch's rows."""
  return gumbel_candidates(log_q, x, repeats, mask_index, generator,
                           gumbel)


def _select_best(candidates: torch.Tensor, scores: torch.Tensor
                 ) -> torch.Tensor:
  """Per-row argmax over the M candidates (first maximum wins)."""
  idx = torch.argmax(scores, dim=1)                          # (B,)
  return torch.gather(
      candidates, 1,
      idx[:, None, None].expand(-1, 1, candidates.shape[-1]))[:, 0]


def _scores(value_fn, flat, shard):
  """The value of every folded candidate row: one forward, or, on a
  grid, this process's share and a gather (module docstring)."""
  if shard is None:
    return value_fn(flat)
  return shard.score_rows(value_fn, flat)


def svdd_mc_step(denoise_fn: DenoiseFn, value_fn: ValueFn,
                 schedule: Schedule, mask_index: int, repeats: int = 10,
                 shard=None):
  """SVDD-MC: M candidates -> value net -> argmax select."""

  def step(x, t, t_next, generator, gumbel=None):
    b, l = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(log_q, x, mask_index, repeats,
                                  generator, gumbel)
    scores = _scores(value_fn, candidates.reshape(b * repeats, l),
                     shard).reshape(b, repeats)
    return _select_best(candidates, scores)

  return step


def timed_step_index(t, num_steps: int, eps: float = 1e-5) -> int:
  """The step index of time t on the grid t_i = 1 - i (1 - eps) /
  num_steps: round((1 - t) num_steps / (1 - eps)) in float32, halves to
  even (``guidance.py:124-125``); t a host scalar, so nothing is read
  from the card."""
  t32 = torch.as_tensor(t, dtype=torch.float32)
  return int(torch.round((1.0 - t32) * num_steps / (1.0 - eps)))


def svdd_mc_step_timed(denoise_fn: DenoiseFn, value_fn_timed,
                       schedule: Schedule, mask_index: int, num_steps: int,
                       eps: float = 1e-5, repeats: int = 10, shard=None):
  """SVDD-MC with a step-indexed value function (``guidance.py:105-132``),
  for the timed and multisep value models: ``value_fn_timed(tokens (N,
  L), step)`` -> (N,), ``step`` the ``timed_step_index`` of the step's
  time."""

  def step(x, t, t_next, generator, gumbel=None):
    b, l = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(log_q, x, mask_index, repeats,
                                  generator, gumbel)
    step_idx = timed_step_index(t, num_steps, eps)
    scores = _scores(lambda c: value_fn_timed(c, step_idx),
                     candidates.reshape(b * repeats, l),
                     shard).reshape(b, repeats)
    return _select_best(candidates, scores)

  return step


def cdq_step(denoise_fn: DenoiseFn, schedule: Schedule, mask_index: int,
             repeats: int = 10):
  """CD-Q trajectory collection (``guidance.py:433-450``): ``repeats``
  candidate next states a row by the candidate draw (B2); the step
  returns them all as its aux (the reverse loop stacks them with
  ``collect_aux``) and keeps the last as the trajectory."""

  def step(aux, x, t, t_next, generator, gumbel=None):
    b, _ = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(log_q, x, mask_index, repeats,
                                  generator, gumbel)
    return candidates, candidates[:, -1]

  return step


def _onehot4(index: torch.Tensor) -> torch.Tensor:
  """jax.nn.one_hot(index, 4) in float32: an index past 3 gives a zero
  row."""
  return (index[..., None] == torch.arange(4, device=index.device)).float()


def _posterior_onehot(log_p, samples, mask_index: int) -> torch.Tensor:
  """The reward's input r(E[x0|x]): the argmax of the denoiser posterior
  at still-masked positions, the tokens elsewhere, (N, L, 4) float32
  (``guidance.py:135-143``)."""
  posterior = _onehot4(torch.argmax(log_p, dim=-1))       # never MASK
  actual = _onehot4(torch.clamp(samples, 0, 3))
  return torch.where((samples != mask_index)[..., None], actual, posterior)


def _tweedie_posterior_onehot(denoise_fn: DenoiseFn, samples, sigma_s,
                              mask_index: int) -> torch.Tensor:
  return _posterior_onehot(denoise_fn(samples, sigma_s), samples,
                           mask_index)


def _cached_or_fresh(denoise_fn: DenoiseFn, schedule: Schedule, aux, x, t):
  """log p(x0 | x) at sigma(t): the carried posterior when it is valid,
  else a fresh forward (``guidance.py:152-163``). The carry holds the
  previous step's forward of the chosen rows at its sigma_s, which is
  this step's sigma_t: an exact reuse. ``valid`` is a host bool (False
  on step 0 only), so the branch reads nothing from the card."""
  log_p_cache, valid = aux
  if valid:
    return log_p_cache
  return denoise_fn(x, sigma_batch(schedule, t, x.shape[0], x.device))


def svdd_pm_step(denoise_fn: DenoiseFn, reward_fn: RewardFn,
                 schedule: Schedule, mask_index: int, repeats: int = 10,
                 tweedie: bool = True, task: str = 'dna',
                 saluki_body=None, saluki_final_length: int = 12288,
                 carry_posterior: bool = False, shard=None):
  """SVDD-PM: M candidates -> reward of their posterior mean -> argmax
  select (``guidance.py:166-226``). ``tweedie=False`` scores the
  candidates with their masked positions zeroed instead
  (``mdlm.transform_samples``). ``task='rna_saluki'`` rebuilds the tokens
  from that one-hot (a zero row is MASK) and scores the saluki input
  (``mdlm.transform_samples_saluki`` with ``saluki_body``, padded to
  ``saluki_final_length``). ``carry_posterior`` (tweedie only): the
  winner's candidate forward at sigma_s is carried in aux (log_p, valid)
  and replaces the next step's (B,) forward and the removal forward.
  The step takes and returns an aux; without the carry it is passed
  through."""
  carry_posterior = carry_posterior and tweedie

  def step(aux, x, t, t_next, generator, gumbel=None):
    b, l = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    if carry_posterior:
      log_p = _cached_or_fresh(denoise_fn, schedule, aux, x, t)
    else:
      log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    candidates = _draw_candidates(log_q, x, mask_index, repeats,
                                  generator, gumbel)
    flat = candidates.reshape(b * repeats, l)
    if shard is not None:
      flat = flat[shard.candidates(flat.shape[0])]
    if tweedie:
      log_p_cand = denoise_fn(flat, sigma_batch(schedule, t_next,
                                                flat.shape[0], x.device))
      onehot = _posterior_onehot(log_p_cand, flat, mask_index)
    else:
      onehot = mdlm.transform_samples(flat)
    if task == 'rna_saluki':
      toks = torch.where(onehot.sum(-1) > 0, torch.argmax(onehot, dim=-1),
                         mask_index)
      onehot = mdlm.transform_samples_saluki(
          toks, saluki_body, final_length=saluki_final_length)
    scores = reward_fn(onehot)
    if shard is not None:
      scores = shard.scores(scores)
    scores = scores.reshape(b, repeats)
    if not carry_posterior:
      return aux, _select_best(candidates, scores)
    if shard is not None:
      log_p_cand = shard.scores(log_p_cand)
    idx = torch.argmax(scores, dim=1)
    ar = torch.arange(b, device=x.device)
    picked = log_p_cand.reshape(b, repeats, l, -1)[ar, idx]
    return (picked, True), candidates[ar, idx]

  return step


def resample_indices(w: torch.Tensor, uniform: torch.Tensor
                     ) -> torch.Tensor:
  """B ancestor indices drawn from the weights w (B,) with replacement,
  as JAX 0.9's ``jax.random.choice(key, B, (B,), p=w)`` computes them
  from its uniforms u: the first index whose cumulative weight reaches
  cumsum(w)[-1] * (1 - u). On the card, so the loop reads nothing."""
  cum = torch.cumsum(w, dim=0)
  return torch.searchsorted(cum, cum[-1] * (1 - uniform), right=False)


def tds_step(denoise_fn: DenoiseFn, reward_fn: RewardFn,
             schedule: Schedule, mask_index: int, alpha: float = 1.0,
             carry_posterior: bool = False, track_ess: bool = False,
             num_steps: int | None = None,
             ess_threshold: float | None = None, shard=None):
  """TDS (``guidance.py:229-340``): one draw per particle, importance
  weights softmax((r(E[x0|x_s]) - r(E[x0|x_t])) / alpha), both posterior
  means at sigma_s as in the reference, and a resample of the batch from
  them (``resample_indices``). ``carry_posterior``: the resampled rows of
  the numerator's forward are carried in aux (log_p, valid).
  ``track_ess`` (needs ``num_steps``): the ESS 1/sum(w^2) of each step
  into a (num_steps,) buffer. ``ess_threshold`` (a fraction of B):
  log-weights accumulate across steps and the batch resamples only where
  ESS <= ess_threshold * B, and always on the last step, which then
  resets them. The uniforms are drawn every step either way, so the
  random stream does not depend on the mode. With track_ess or
  ess_threshold the aux is a dict (``tds_aux_init``) whose step counter
  'i' is a host int; the weights, the ESS and the resampling decision
  stay on the card. ``gumbel`` (B, L, V) and ``uniform`` (B,) inject the
  draw's and the resample's noise."""
  use_dict = track_ess or ess_threshold is not None
  if use_dict and num_steps is None:
    raise ValueError('track_ess / ess_threshold require num_steps '
                     '(ESS buffer size + terminal-resample index)')

  def step(aux, x, t, t_next, generator, gumbel=None, uniform=None):
    b, _ = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    sigma_s = sigma_batch(schedule, t_next, b, x.device)
    post = aux['post'] if use_dict else aux
    if carry_posterior:
      log_p = _cached_or_fresh(denoise_fn, schedule, post, x, t)
    else:
      log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    sample = torch.where(x != mask_index, x,
                         _draw(log_q, generator, gumbel))
    n = b if shard is None else shard.total      # the particles, globally
    if uniform is None:                 # the global batch's, whole
      uniform = torch.rand((n,), generator=generator, device=x.device)

    log_p_sample = denoise_fn(sample, sigma_s)
    reward_num = reward_fn(_posterior_onehot(log_p_sample, sample,
                                             mask_index))
    reward_den = reward_fn(_tweedie_posterior_onehot(denoise_fn, x,
                                                     sigma_s, mask_index))
    log_ratio = (reward_num - reward_den) / alpha
    if shard is not None:
      log_ratio = shard.gather(log_ratio)
      sample = shard.gather(sample)
      if carry_posterior:
        log_p_sample = shard.gather(log_p_sample)
    log_w = log_ratio if ess_threshold is None else aux['log_w'] + log_ratio
    w = torch.softmax(log_w, dim=0)
    ess = 1.0 / torch.sum(w * w)
    take = resample_indices(w, uniform)
    if ess_threshold is not None:
      fire = ess <= ess_threshold * n
      if aux['i'] >= num_steps - 1:     # the weights must be realised
        fire = torch.ones_like(fire)
      take = torch.where(fire, take, torch.arange(n, device=x.device))
    mine = take if shard is None else take[shard.row0:shard.row0 + b]
    x_next = sample[mine]
    post_next = (log_p_sample[mine], True) if carry_posterior else post
    if not use_dict:
      return post_next, x_next
    aux_next = dict(aux, post=post_next, i=aux['i'] + 1)
    if track_ess:                       # the buffer is carried, not copied
      aux['ess'][aux['i']] = ess
    if ess_threshold is not None:       # every process keeps all of them
      aux_next['log_w'] = torch.where(fire, torch.zeros_like(log_w),
                                      log_w)[take]
    return aux_next, x_next

  return step


def tds_aux_init(batch_size: int, posterior_init, track_ess: bool = False,
                 num_steps: int | None = None,
                 ess_threshold: float | None = None, device='cuda'):
  """The first aux of ``tds_step`` (``guidance.py:343-356``): the
  posterior carry alone, or, with track_ess or ess_threshold, a dict
  {'post', 'i' (host int), 'ess' (num_steps,), 'log_w' (B,)}."""
  if not (track_ess or ess_threshold is not None):
    return posterior_init
  aux = {'post': posterior_init, 'i': 0}
  if track_ess:
    aux['ess'] = torch.zeros((num_steps,), dtype=torch.float32,
                             device=device)
  if ess_threshold is not None:
    aux['log_w'] = torch.zeros((batch_size,), dtype=torch.float32,
                               device=device)
  return aux


def _draw(log_probs, generator, gumbel=None):
  if gumbel is None:
    gumbel = mdlm.gumbel_noise(log_probs.shape, generator, log_probs.device)
  return mdlm.sample_categorical(log_probs, gumbel)


def _mean(values: torch.Tensor, rows_total) -> torch.Tensor:
  """The mean over a batch of ``rows_total`` rows (this process's
  share of it on a grid; the batch itself by default)."""
  return values.sum() / (values.shape[0] if rows_total is None
                         else rows_total)


def dps_gradient(denoise_onehot_fn, reward_fn, x, sigma,
                 mask_index: int, rows_total=None) -> torch.Tensor:
  """d mean(reward(softmax(E[x0|xt])[..., :4])) / d onehot(x), with
  respect to the full 5-channel one-hot: through the copy/merge of the
  unmasked positions and a softmax over all 5 channels
  (``guidance.py:375-387``). A ``RewardOracle`` is differentiated through
  its unfused tower (``fused=False``), as JAX traces this gradient under
  ``unfused_guard``. ``rows_total``: the global batch's rows, where x
  is a process's share of it."""
  if isinstance(reward_fn, RewardOracle):
    reward_fn = functools.partial(reward_fn, fused=False)
  copy = (x != mask_index).float()[..., None]
  with torch.enable_grad():
    onehot = F.one_hot(x.long(), mask_index + 1).float().requires_grad_(True)
    expected = denoise_onehot_fn(onehot, x, sigma)
    expected = copy * onehot + (1 - copy) * expected
    probs = torch.softmax(expected, dim=-1)
    (grad,) = torch.autograd.grad(_mean(reward_fn(probs[..., :4]),
                                        rows_total), onehot)
  return grad


def dps_step(denoise_onehot_fn, reward_fn, schedule: Schedule,
             mask_index: int, guidance_scale: float = 1.0, shard=None):
  """DPS: ``dps_gradient`` at sigma(t_next), recentred by the mask
  column, scaled and added to log q_xs (``guidance.py:359-396``).
  ``denoise_onehot_fn(onehot, x, sigma)`` is the denoiser's one-hot
  path; ``reward_fn`` maps (N, L, 4) to (N,) differentiably."""

  def step(x, t, t_next, generator, gumbel=None):
    b, _ = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    x_grad = dps_gradient(denoise_onehot_fn, reward_fn, x,
                          sigma_batch(schedule, t_next, b, x.device),
                          mask_index, None if shard is None else shard.total)
    log_p0 = denoise_onehot_fn(F.one_hot(x.long(), mask_index + 1).float(),
                               x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p0, mct, mcs, mask_index)
    guidance = guidance_scale * (
        x_grad - x_grad[..., mask_index:mask_index + 1])
    draw = _draw(log_q + guidance, generator, gumbel)
    return torch.where(x != mask_index, x, draw)

  return step


def classifier_gradient(value_fn_onehot, x, rows_total=None) -> torch.Tensor:
  """d mean(value(onehot4(x))) / d onehot4(x), padded with a zero MASK
  channel to (N, L, 5) (``guidance.py:415-421``); ``rows_total`` as in
  ``dps_gradient``."""
  with torch.enable_grad():
    onehot = mdlm.transform_samples(x).requires_grad_(True)
    (grad,) = torch.autograd.grad(_mean(value_fn_onehot(onehot), rows_total),
                                  onehot)
  return F.pad(grad, (0, 1))


def classifier_step(denoise_fn: DenoiseFn, value_fn_onehot,
                    schedule: Schedule, mask_index: int,
                    guidance_scale: float = 1.0, shard=None):
  """Classifier guidance: ``classifier_gradient``, the gradient of the
  value net with respect to the one-hot of x_t, added to q_xs in
  probability space and clamped at 1e-35 before the log
  (``guidance.py:399-430``).
  ``value_fn_onehot`` maps (N, L, 4) to (N,) differentiably."""

  def step(x, t, t_next, generator, gumbel=None):
    b, _ = x.shape
    _, mct, mcs = move_chances(schedule, t, t_next)
    log_p = denoise_fn(x, sigma_batch(schedule, t, b, x.device))
    log_q = mdlm.log_q_xs(log_p, mct, mcs, mask_index)
    q_tilted = torch.exp(log_q) + guidance_scale * classifier_gradient(
        value_fn_onehot, x, None if shard is None else shard.total)
    draw = _draw(torch.log(torch.clamp(q_tilted, min=1e-35)), generator,
                 gumbel)
    return torch.where(x != mask_index, x, draw)

  return step
