"""Semi-autoregressive strided sampling (``svdd_tpu/sampling/semi_ar.py``).

Long sequences are generated block-wise: each stride runs the reverse
process on a window whose prefix is pinned to the tokens the previous
stride generated past its first ``stride_length``, then the window slides
by ``stride_length``. A stride is ``1/dt + 1`` caching ddpm steps at
move chances t = 1 - i·dt and max(t - dt, 1e-9) (the loglinear
schedule's), the denoiser called only where the tokens changed since its
last call (a miss), then a denoise at sigma 0 and the argmax over the
non-MASK tokens. The misses are counted, as JAX counts them.

The Gumbel noise of every step is drawn from ``generator``, or taken
from ``noise(stride, step)`` -> (N, L, V), so a run is pinned to JAX's on
the same noise.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from svdd_tpu_torch import mdlm


@torch.inference_mode()
def _run_stride(diffusion, x: torch.Tensor, dt: float,
                draw: Callable[[int, tuple], torch.Tensor]
                ) -> Tuple[torch.Tensor, int]:
  """One stride from ``x`` (N, L): (tokens, denoiser misses).
  ``draw(step, shape)`` gives the step's Gumbel noise."""
  mask = diffusion.mask_index
  n = x.shape[0]
  num_steps = int(1 / dt)
  log_p, valid, misses = None, False, 0
  f32 = np.float32
  for i in range(num_steps + 1):
    # f32 as JAX computes them: t = 1 - i * dt, s = max(t - dt, 1e-9)
    t = f32(1.0) - f32(i) * f32(dt)
    s = max(f32(t - f32(dt)), f32(1e-9))
    if not valid:
      sigma_t, _ = diffusion.schedule(torch.tensor(t))
      log_p = diffusion.forward(x, sigma_t.to(x.device).expand(n))
      misses += 1
    log_q = mdlm.log_q_xs(log_p, t, s, mask)
    drawn = mdlm.sample_categorical(log_q, draw(i, tuple(log_q.shape)))
    x_next = torch.where(x != mask, x, drawn)
    valid = bool((x_next == x).all())
    x = x_next
  logits = diffusion.forward(x, torch.zeros(n, device=x.device))
  return torch.argmax(logits[..., :-1], dim=-1), misses


def semi_ar_sample(diffusion, n_samples: int, stride_length: int,
                   num_strides: int,
                   generator: Optional[torch.Generator] = None,
                   dt: float = 0.001,
                   noise: Optional[Callable[[int, int], torch.Tensor]] = None
                   ) -> Tuple[int, List[np.ndarray], np.ndarray]:
  """(sampling_steps, the per-stride token blocks, the full samples
  (n_samples, L + num_strides·stride_length)): ``num_strides + 1``
  strides, each from the all-MASK prior with its first L - stride_length
  positions set to the previous stride's last ones."""
  cfg = diffusion.config
  length = cfg.model.length
  dev = diffusion.device
  target = None
  blocks: List[np.ndarray] = []
  sampling_steps = 0
  for j in range(num_strides + 1):
    x = mdlm.sample_prior((n_samples, length), diffusion.mask_index, dev)
    if target is not None:
      x[:, :length - stride_length] = target

    def draw(step, shape, j=j):
      if noise is not None:
        return torch.as_tensor(noise(j, step), dtype=torch.float32,
                               device=dev)
      return mdlm.gumbel_noise(shape, generator, dev)

    x, misses = _run_stride(diffusion, x, dt, draw)
    sampling_steps += misses
    blocks.append(x[:, :stride_length].cpu().numpy())
    target = x[:, stride_length:]
  blocks.append(target.cpu().numpy())
  return sampling_steps, blocks, np.concatenate(blocks, axis=1)
