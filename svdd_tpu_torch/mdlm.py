"""Core MDLM math on tensors (``svdd_tpu/mdlm.py``): the SUBS, D3PM and
SEDD parameterizations, the reverse-step density, the all-MASK prior, the
Gumbel-max categorical draw (from log-probabilities or probabilities),
the analytic sampler's score, staggered score and transposed transition,
the value nets' one-hot transform, and the saluki stability oracle's
padded six-channel input, and the training half: the forward masking
``q_xt``, the (antithetic) time draw ``sample_t``, the continuous-time
SUBS NELBO, the discrete-time D3PM term and SEDD's score entropy.

Each random function takes its uniforms as an argument, or draws them
from a ``torch.Generator``, so a test can pin it to the JAX function on
the uniforms JAX drew."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from svdd_tpu_torch.parallel import rows

Tensor = torch.Tensor

NEG_INFINITY = -1_000_000.0


def gumbel_noise(shape: Tuple[int, ...], generator: torch.Generator,
                 device=None) -> Tensor:
  """Gumbel(0, 1) noise as ``fused_sample.py:46-48`` makes it:
  -log(-log(u + 1e-20) + 1e-20) with u ~ U[0, 1)."""
  u = rows.rand(shape, generator, device)
  return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def sample_categorical(log_probs: Tensor, gumbel: Tensor) -> Tensor:
  """Gumbel-max draw: argmax(log_probs + gumbel) over the last axis.
  ``gumbel`` is injected so a step can be pinned against the JAX one."""
  return torch.argmax(log_probs + gumbel, dim=-1)


def sample_categorical_probs(probs: Tensor, gumbel: Tensor) -> Tensor:
  """Gumbel-max draw from (possibly unnormalized) probabilities:
  ``sample_categorical`` of log(max(probs, 1e-35))."""
  return sample_categorical(torch.log(torch.clamp(probs, min=1e-35)), gumbel)


def _lane(x: Tensor, index: int) -> Tensor:
  """A boolean of x's shape, true on the last axis's lane ``index``."""
  return torch.arange(x.shape[-1], device=x.device) == index


def subs_parameterization(logits: Tensor, xt: Tensor,
                          mask_index: int) -> Tensor:
  """SUBS: p(MASK) = 0 and unmasked positions pinned to their token."""
  vocab = logits.shape[-1]
  lane = torch.arange(vocab, device=logits.device)
  logits = logits + torch.where(lane == mask_index, NEG_INFINITY, 0.0)
  logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
  onehot = F.one_hot(xt.long(), vocab).bool()
  onehot_loglik = torch.where(onehot, 0.0, NEG_INFINITY)
  unmasked = (xt != mask_index)[..., None]
  return torch.where(unmasked, onehot_loglik, logits)


def d3pm_parameterization(logits: Tensor, mask_index: int,
                          subs_masking: bool = False) -> Tensor:
  """D3PM: a plain log-softmax; ``subs_masking`` first adds NEG_INFINITY
  to the MASK lane."""
  if subs_masking:
    logits = logits + torch.where(_lane(logits, mask_index), NEG_INFINITY,
                                  0.0)
  return logits - torch.logsumexp(logits, dim=-1, keepdim=True)


def sedd_parameterization(logits: Tensor, xt: Tensor,
                          sigma: Tensor) -> Tensor:
  """SEDD log score: logits - log(e^sigma - 1) - log(V - 1), 0 at the
  current token. sigma (B,). A zero sigma (``time_conditioning=False``
  hands the forward a zeroed one, as JAX does) gives log(0) = -inf, so
  every other lane is +inf."""
  esigm1_log = torch.log(torch.where(sigma < 0.5, torch.expm1(sigma),
                                     torch.exp(sigma) - 1)).to(logits.dtype)
  vocab = logits.shape[-1]
  logits = (logits - esigm1_log[:, None, None]
            - torch.log(torch.tensor(vocab - 1, dtype=logits.dtype)))
  onehot = F.one_hot(xt.long(), vocab).bool()
  return torch.where(onehot, 0.0, logits)


def log_q_xs(log_p_x0: Tensor, move_chance_t, move_chance_s,
             mask_index: int) -> Tensor:
  """Unnormalized reverse-transition log-density of the ddpm step:
  log p_x0 + log(mct - mcs), with the MASK lane set to log(mcs).

  The move chances are host scalars; their logs are taken in float32
  on the host and enter the device ops as Python numbers, so nothing
  is copied to the device (a pageable copy would wait for the stream)."""
  mct = torch.as_tensor(move_chance_t, dtype=torch.float32)
  mcs = torch.as_tensor(move_chance_s, dtype=torch.float32)
  log_qs = log_p_x0 + float(torch.log(mct - mcs))
  lane = torch.arange(log_qs.shape[-1], device=log_qs.device)
  return torch.where(lane == mask_index, float(torch.log(mcs)), log_qs)


def get_score(log_p_x0: Tensor, x: Tensor, sigma: Tensor,
              mask_index: int) -> Tensor:
  """The SUBS score exp(log p_t(y) / p_t(x)) of the analytic sampler
  (``svdd_tpu/mdlm.py:get_score``). sigma: (B,) or (B, 1)."""
  if sigma.ndim > 1:
    sigma = sigma.squeeze(-1)
  log_k = -torch.log(torch.expm1(sigma))                 # (B,)
  lane = _lane(log_p_x0, mask_index)
  masked_score = torch.where(lane, 0.0, log_p_x0 + log_k[:, None, None])
  onehot = F.one_hot(x.long(), log_p_x0.shape[-1]).bool()
  unmasked_score = torch.where(onehot, 0.0, NEG_INFINITY)
  unmasked_score = torch.where(
      lane, (-log_k[:, None] * torch.ones_like(x, dtype=torch.float32))[
          ..., None], unmasked_score)
  masked = (x == mask_index)[..., None]
  return torch.exp(torch.where(masked, masked_score, unmasked_score))


def staggered_score(score: Tensor, dsigma: Tensor, mask_index: int
                    ) -> Tensor:
  """``svdd_tpu/mdlm.py:staggered_score``. dsigma: (B,) or (B, 1)."""
  if dsigma.ndim == 1:
    dsigma = dsigma[:, None]
  extra_const = (1 - torch.exp(dsigma)) * score.sum(dim=-1)   # (B, L)
  score = score * torch.exp(dsigma)[..., None]
  return torch.where(_lane(score, mask_index),
                     score + extra_const[..., None], score)


def transp_transition(i: Tensor, sigma: Tensor, vocab_size: int,
                      mask_index: int) -> Tensor:
  """``svdd_tpu/mdlm.py:transp_transition``. i: (B, L) tokens; sigma
  (B,) or (B, 1)."""
  if sigma.ndim == 1:
    sigma = sigma[:, None]
  sigma = sigma[..., None]                                    # (B, 1, 1)
  edge = torch.exp(-sigma) * F.one_hot(i.long(), vocab_size).float()
  return edge + torch.where(i == mask_index, 1 - torch.exp(-sigma)[..., 0],
                            0.0)[..., None]


def sample_prior(batch_dims: Tuple[int, ...], mask_index: int,
                 device=None) -> Tensor:
  """All-MASK prior x_1."""
  return torch.full(batch_dims, mask_index, dtype=torch.int64,
                    device=device)


def transform_samples(samples: Tensor, num_classes: int = 4,
                      dtype: Optional[torch.dtype] = torch.float32
                      ) -> Tensor:
  """Tokens -> one-hot with MASK rows zeroed (values == num_classes
  are MASK)."""
  keep = samples != num_classes
  onehot = F.one_hot(torch.where(keep, samples, 0).long(), num_classes)
  return (onehot * keep[..., None]).to(dtype)


def transform_samples_saluki(samples: Tensor,
                             saluki_body: Optional[Tensor] = None,
                             num_classes: int = 4,
                             final_length: int = 12288) -> Tensor:
  """The saluki stability oracle's input (``svdd_tpu/mdlm.py:291-315``):
  the one-hot with MASK rows zeroed, two zero channels (the coding-frame
  and splice tracks), the constant ``saluki_body`` (Lb, 6) behind each
  sequence where given, then zeros to ``final_length`` rows, cut there:
  (N, final_length, 6) float32."""
  onehot = transform_samples(samples, num_classes)
  n, l, _ = onehot.shape
  six = torch.cat([onehot, onehot.new_zeros((n, l, 2))], dim=-1)
  if saluki_body is not None:
    body = torch.as_tensor(saluki_body, dtype=six.dtype, device=six.device)
    six = torch.cat([six, body[None].expand((n,) + tuple(body.shape))],
                    dim=1)
  pad = final_length - six.shape[1]
  if pad > 0:
    six = torch.cat([six, six.new_zeros((n, pad, 6))], dim=1)
  return six[:, :final_length]


def uniforms(shape: Tuple[int, ...], generator: torch.Generator,
             device=None) -> Tensor:
  """U[0, 1) float32 noise of ``shape`` from ``generator`` (the local
  rows of the global batch's inside ``parallel.rows.global_rows``)."""
  return rows.rand(shape, generator, device)


def q_xt(x0: Tensor, move_chance: Tensor, mask_index: int,
         u: Tensor) -> Tensor:
  """Forward masking: a token becomes MASK where its uniform ``u`` (the
  shape of x0) is below ``move_chance`` (broadcast against x0, e.g.
  (B, 1))."""
  return torch.where(u < move_chance, mask_index, x0)


def sample_t(u: Tensor, sampling_eps: float,
             antithetic: bool = True) -> Tensor:
  """Training times from the (n,) uniforms ``u``; antithetic: row i's
  time lies in [i/n, (i+1)/n), (u/n + i/n) mod 1. Inside
  ``parallel.rows.global_rows`` the rows are rows [row0, row0 + n) of the
  global batch, and i and n are global."""
  if antithetic:
    row0, n = rows.current() or (0, u.shape[0])
    offset = (torch.arange(u.shape[0], dtype=torch.float32, device=u.device)
              + row0) / n
    u = (u / n + offset) % 1
  return (1 - sampling_eps) * u + sampling_eps


class LossOutput(NamedTuple):
  loss: Tensor        # scalar token-mean NLL
  nlls: Tensor        # (B, L) per-token NLL * mask
  token_mask: Tensor  # (B, L)


def nelbo_subs(log_p_x0: Tensor, x0: Tensor, sigma: Tensor,
               dsigma: Tensor,
               attention_mask: Optional[Tensor] = None) -> LossOutput:
  """Continuous-time SUBS NELBO: -log p_theta(x0) * dsigma / expm1(sigma),
  averaged over the tokens of ``attention_mask``."""
  log_p_theta = torch.gather(log_p_x0, -1, x0[..., None].long())[..., 0]
  loss = -log_p_theta * (dsigma / torch.expm1(sigma))[:, None]
  if attention_mask is None:
    attention_mask = torch.ones_like(loss)
  nlls = loss * attention_mask
  return LossOutput(nlls.sum() / attention_mask.sum(), nlls, attention_mask)


def d3pm_loss(model_output: Tensor, xt: Tensor, x0: Tensor, t: Tensor,
              mask_index: int, T: int) -> Tensor:
  """The discrete-time D3PM VLB term, (B, L) per token, on the masked
  positions (``svdd_tpu/mdlm.py:166-192``), 0 elsewhere; t (B,), clipped
  to 1 - 1e-4. At t = 1/T (the grid's first point, where training puts
  every t below 1/T) t - dt is 0 and the second term is 0 x inf: NaN at
  that row's masked positions, in JAX as here. JAX multiplies by the
  mask, which XLA turns into a select; so does this."""
  dt = 1.0 / T
  t = torch.clamp(t[:, None], 0.0, 1.0 - 1e-4)
  alpha_t = 1 - t
  alpha_s = 1 - (t - dt)
  log_x_theta_at_x0 = torch.gather(model_output, -1,
                                   x0[..., None].long())[..., 0]
  x_theta_at_m = torch.exp(model_output[..., mask_index])
  term_1_coef = dt / t
  term_1_log_nr = torch.log(alpha_t * x_theta_at_m / t + 1)
  term_1_log_dr = log_x_theta_at_x0
  term_2_coef = 1 - dt / t
  term_2_log_nr = term_1_log_nr
  term_2_log_dr = torch.log(alpha_s * x_theta_at_m / (t - dt) + 1)
  l_vb_masked = (term_1_coef * (term_1_log_nr - term_1_log_dr)
                 + term_2_coef * (term_2_log_nr - term_2_log_dr))
  return torch.where(xt == mask_index, T * l_vb_masked, 0.0)


def score_entropy(log_score: Tensor, sigma: Tensor, xt: Tensor, x0: Tensor,
                  mask_index: int) -> Tensor:
  """SEDD's score entropy on the masked positions, (B, L)
  (``svdd_tpu/mdlm.py:195-217``); sigma (B,) or (B, 1)."""
  masked = xt == mask_index
  expsig_minus_1 = torch.expm1(sigma)
  if expsig_minus_1.ndim == 1:
    expsig_minus_1 = expsig_minus_1[:, None]
  q_ratio = 1.0 / expsig_minus_1
  neg_term = q_ratio * torch.gather(log_score, -1,
                                    x0[..., None].long())[..., 0]
  not_mask_col = ~_lane(log_score, mask_index)
  pos_term = torch.sum(torch.exp(log_score) * not_mask_col, dim=-1)
  const = q_ratio * (torch.log(q_ratio) - 1)
  entropy = pos_term - neg_term + const
  return torch.where(masked, entropy, 0.0)
