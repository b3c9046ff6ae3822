#!/usr/bin/env python3
"""Time the backward of the convs off kernel B7's gate, as the guided
decoders' input gradients and the multisep trainer take them, on one
card.

  python3 scripts/probe_stem_bwd.py

The shapes: the Enformer stem (4 -> 768 channels, k=15) at 512 x 200
rows, and the ConvGRU's stem (4 -> 64, k=15) and k=5 convs (64 -> 64)
at 512 x 50 rows, in float32 and bfloat16. For each: the conv's
forward and backward recorded by PyTorch's own convolution (cuDNN; the
input gradient alone, as ``torch.autograd.grad`` in the input asks it)
against ``ops.conv1d._ConvPlainBwd`` (the fixed-order backward) with
the input gradient alone, the weight gradient alone (the multisep
trainer's stem, whose one-hot input takes none) and both. One JSON
line a shape and dtype (median ms of CUDA events over 20 calls), then
the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (('enformer_stem', 512, 200, 4, 768, 15),
          ('convgru_stem', 512, 50, 4, 64, 15),
          ('convgru_k5', 512, 50, 64, 64, 5))


def main() -> None:
  sys.path.insert(0, REPO)
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_stem_bwd: no CUDA device')
  import chip_smoke as smoke
  from svdd_tpu_torch.ops import conv1d as C
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gen = torch.Generator('cuda').manual_seed(0)
  for name, n, l, cin, cout, k in SHAPES:
    for dtype in (torch.float32, torch.bfloat16):
      x = torch.randn(n, l, cin, device='cuda', generator=gen).to(dtype)
      w = torch.randn(k, cin, cout, device='cuda', generator=gen) / (k * cin) ** .5
      b = torch.zeros(cout, device='cuda')
      ct = torch.randn(n, l, cout, device='cuda', generator=gen).to(dtype)

      def run(fwd, wrt_x: bool, wrt_w: bool):
        xs = x.detach().requires_grad_(wrt_x)
        ws = w.detach().requires_grad_(True)
        out = fwd(xs, ws)
        wanted = [t for t, on in ((xs, wrt_x), (ws, wrt_w)) if on]
        return torch.autograd.grad(out, wanted, ct)

      cudnn = lambda xs, ws: C._conv_forward(xs, ws, b, 1)
      plain = lambda xs, ws: C._ConvPlainBwd.apply(xs, ws, b, 1)
      r = {'shape': name, 'rows': [n, l, cin, cout, k],
           'dtype': str(dtype).split('.')[-1]}
      for label, fwd, wx, ww in (('cudnn_dx', cudnn, True, False),
                                 ('fixed_dx', plain, True, False),
                                 ('cudnn_dw', cudnn, False, True),
                                 ('fixed_dw', plain, False, True),
                                 ('fixed_dx_dw', plain, True, True)):
        r[label + '_ms'] = smoke.median_ms(
            lambda: run(fwd, wx, ww), iters=20, warmup=2)
      print(json.dumps(r), flush=True)
  print(smoke.nvidia_smi(), flush=True)


if __name__ == '__main__':
  main()
