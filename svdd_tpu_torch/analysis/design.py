"""Sequence design (``svdd_tpu/analysis/design.py``): greedy directed
evolution over ISM scores and Ledidi, a relaxation of the sequence
optimised by Adam.

Each evolution round scores every single-base mutant (``ism_predict``)
and keeps the best one. Ledidi optimises logits over the sequence so that
a straight-through categorical draw scores near a target while few
positions leave the seed sequence; each step takes one Gumbel tensor,
injected or drawn from a ``torch.Generator``. ``torch.optim.Adam`` steps
as optax's ``adam`` does: lr m_hat / (sqrt(v_hat) + 1e-8).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from svdd_tpu_torch.analysis.interpret import ism_predict
from svdd_tpu_torch.mdlm import gumbel_noise

PredictFn = Callable[[torch.Tensor], torch.Tensor]


def evolve(predict_fn: PredictFn, onehot: torch.Tensor, rounds: int = 10,
           maximize: bool = True) -> Tuple[torch.Tensor, List[float]]:
  """Greedy directed evolution: each round takes the single-base
  substitution with the best score (the first on a tie) and stops when
  it does not beat the last score. Returns (the sequence (L, 4), the
  scores, the seed's first)."""
  with torch.no_grad():
    history = [float(predict_fn(onehot[None])[0])]
  best = onehot
  for _ in range(rounds):
    flat = ism_predict(predict_fn, best).reshape(-1)
    idx = int(flat.argmax() if maximize else flat.argmin())
    l, b = divmod(idx, 4)
    cand_score = flat[idx]
    if maximize and cand_score <= history[-1]:
      break
    if not maximize and cand_score >= history[-1]:
      break
    best = best.clone()
    best[l] = F.one_hot(torch.tensor(b), 4).to(best)
    history.append(float(cand_score))
  return best, history


def ledidi(predict_fn: PredictFn, onehot: torch.Tensor, target: float,
           steps: int = 200, lr: float = 0.1, l: float = 0.01,
           gumbel: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, List[float]]:
  """Ledidi-style design from ``onehot`` (L, 4): logits start at 10 x
  onehot; each step draws x = the straight-through one-hot of
  softmax(logits + g) and takes an Adam step on

    loss = (predict_fn(x) - target)^2 + l * sum((1 - onehot) * softmax(logits))

  ``gumbel`` (steps, L, 4) holds each step's g; absent, it is drawn from
  ``generator``. Returns (the one-hot argmax of the final logits, each
  step's loss)."""
  logits = (10.0 * onehot).detach().clone().requires_grad_(True)
  opt = torch.optim.Adam([logits], lr=lr)
  history = []
  for i in range(steps):
    g = (gumbel[i].to(onehot.device) if gumbel is not None
         else gumbel_noise(onehot.shape, generator, onehot.device))
    with torch.enable_grad():
      soft = torch.softmax(logits + g, -1)
      hard = F.one_hot(soft.argmax(-1), 4).to(soft.dtype)
      x = soft + (hard - soft).detach()
      pred = predict_fn(x[None])[0]
      edits = ((1 - onehot) * torch.softmax(logits, -1)).sum()
      loss = (pred - target) ** 2 + l * edits
      opt.zero_grad()
      loss.backward()
    opt.step()
    history.append(float(loss.detach()))
  final = F.one_hot(logits.detach().argmax(-1), 4).to(onehot.dtype)
  return final, history
