#!/usr/bin/env python3
"""Where the card's f32 training gradient departs from float64, on one card.

  python3 scripts/probe_train_f64.py

Takes ``chip_smoke.check_train_step``'s 8-row step (full-width denoiser,
two microbatches of 4, injected noise) and holds its clipped gradients
and loss, relative by norm, against the same step in float64 on the CPU
by plain autograd (``chip_smoke._f64_denoiser``, on float64's own relu
masks): on the card as the trainer runs it, with B1 and B6 replaced by
their plain versions (both, or one at a time), and on the CPU. Then each
layer kernel alone at 4 and 256 rows of (L=200, C=128), all four
dilations, against the layer in float64 (B1's output and its change to
the residual, each of B6's six gradients), beside the plain versions on
the card. One JSON line each, then the card's nvidia-smi name and power
limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  sys.path.insert(0, REPO)
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_train_f64: no CUDA device')
  import chip_smoke as smoke
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.models.cnn import CNNModel
  from svdd_tpu_torch.ops import cnn_layer as K
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = smoke.nvidia_smi()
  smoke.emit({'phase': 'build', 'nvcc_build_s': _build.build()})
  norm = torch.linalg.vector_norm
  rel = lambda a, b: float(norm(a.double().cpu() - b)
                           / max(float(norm(b)), 1e-300))

  # check_train_step's model, batch and noise (f32)
  cfg = dna_config()
  cfg.training.accum_steps = 2
  cfg.optim.warmup_steps = 0
  g = torch.Generator().manual_seed(3)
  model = CNNModel(cfg, generator=torch.Generator().manual_seed(1))
  with torch.no_grad():
    for p in model.parameters():
      p.add_(0.05 * torch.randn(p.shape, generator=g))
  seqs = torch.randint(0, 4, (8, 200), generator=g)
  noise = (seqs, [(torch.rand(4, generator=g), torch.rand(4, 200,
                                                          generator=g))
                  for _ in range(2)])
  ref = smoke._train_once(smoke._f64_denoiser(model), cfg, noise, 'cpu')
  cpu = smoke._train_once(model, cfg, noise, 'cpu')

  def report(mode, res, launches=None):
    err = {k: rel(res[1][k], w) for k, w in ref[1].items()}
    worst = max(err, key=err.get)
    smoke.emit({'phase': 'step_vs_f64', 'mode': mode, 'launches': launches,
                'loss': abs(res[0] - ref[0]) / abs(ref[0]),
                'max_grad': err[worst], 'worst': worst,
                'cpu_at_worst': rel(cpu[1][worst], ref[1][worst])})

  plain_fwd = lambda x, br, gs, gb, w, cb, d, eps: K.cnn_layer_plain(
      x, br, gs, gb, w, cb, d, eps)
  saved = K._plain, K._cnn_layer, K.cnn_layer_bwd
  for mode in ('kernels', 'plain', 'b1_plain', 'b6_plain'):
    if mode == 'plain':
      K._plain = lambda x: True
    elif mode == 'b1_plain':
      K._cnn_layer = plain_fwd
    elif mode == 'b6_plain':
      K.cnn_layer_bwd = K.cnn_layer_bwd_plain
    try:
      _build.reset_launches()
      res = smoke._train_once(model, cfg, noise, 'cuda')
      launches = {k: v for k, v in _build.launches().items() if v}
    finally:
      K._plain, K._cnn_layer, K.cnn_layer_bwd = saved
    report(mode, res, launches)
  report('cpu', cpu)

  def layer_f64(x, br, gs, gb, w, cb, d):
    h = x + br[:, None]
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + 1e-6) * gs + gb
    return torch.relu(smoke._conv_f64(h, w, cb, d)) + x

  names = ('dx', 'dbias_row', 'dln_scale', 'dln_bias', 'dkernel',
           'dconv_bias')
  gen = torch.Generator('cuda').manual_seed(9)
  for n in (4, 256):
    args, ct = smoke._cnn_inputs(n, 200, torch.float32, gen)
    for d in (1, 4, 16, 64):
      a64 = [a.detach().double().cpu().requires_grad_() for a in args]
      out64 = layer_f64(*a64, d)
      out64.backward(ct.double().cpu())
      out64, delta64 = out64.detach(), (out64 - a64[0]).detach()
      kout = K.cnn_layer(*args, dilation=d)
      pout = K.cnn_layer_plain(*args, dilation=d)
      smoke.emit({
          'phase': 'layer_vs_f64', 'rows': n, 'dilation': d,
          'b1_out': rel(kout, out64), 'plain_out': rel(pout, out64),
          'b1_delta': rel(kout - args[0], delta64),
          'plain_delta': rel(pout - args[0], delta64),
          'b6': dict(zip(names, (rel(k, a.grad) for k, a in zip(
              K.cnn_layer_bwd(*args, ct, dilation=d), a64)))),
          'plain_bwd': dict(zip(names, (rel(k, a.grad) for k, a in zip(
              K.cnn_layer_bwd_plain(*args, ct, dilation=d), a64))))})
  print(smi, flush=True)


if __name__ == '__main__':
  main()
