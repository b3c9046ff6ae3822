"""Core MDLM math on tensors (``svdd_tpu/mdlm.py``): the SUBS
parameterization, the reverse-step density, the all-MASK prior, the
Gumbel-max categorical draw and the value nets' one-hot transform."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

NEG_INFINITY = -1_000_000.0


def gumbel_noise(shape: Tuple[int, ...], generator: torch.Generator,
                 device=None) -> Tensor:
  """Gumbel(0, 1) noise as ``fused_sample.py:46-48`` makes it:
  -log(-log(u + 1e-20) + 1e-20) with u ~ U[0, 1)."""
  u = torch.rand(shape, generator=generator, device=device,
                 dtype=torch.float32)
  return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def sample_categorical(log_probs: Tensor, gumbel: Tensor) -> Tensor:
  """Gumbel-max draw: argmax(log_probs + gumbel) over the last axis.
  ``gumbel`` is injected so a step can be pinned against the JAX one."""
  return torch.argmax(log_probs + gumbel, dim=-1)


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
