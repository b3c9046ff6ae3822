#!/usr/bin/env python3
"""The smoke's phase 9 alone, on one card: the DiT, DiMamba and AR
backbones trained, sampled and scored, and the export reader; with B12's
and B13's kernel checks first.

  python3 scripts/probe_backbones.py [--kernels-only] [--roundings]
      [--sass ROOT ...]

Builds the kernels, runs the smoke's B12 checks (both roundings: L =
1024 on the Pallas body's gate, L = 200 off it; causal and not; head
dims 64 and 128) and B13's in f32 and bf16, then writes stand-ins for
phase 5's files at full width (a pretraining checkpoint of the random
CNN denoiser and a random Enformer value net, where phase 9 reads them)
and runs ``chip_smoke.backbones_phase`` on them. One JSON line per
part, then the card's nvidia-smi name and power limit. Needs a CUDA
card and nvcc; any failed check raises.

``--roundings`` times B12's two roundings at the same shapes instead:
the launch (``ops.flash_attention._launch``) forced to the Pallas body's
rounding and, in bf16 (the one type it is built for), to ``mha``'s at
L = 200 (the smoke's 8 rows and the DiT training batch's 64; 12 heads
of 64) and L = 1024 (64 rows), causal and not, f32 and bf16, by
CUDA-event medians (``chip_smoke.median_ms``).
``--sass ROOT ...`` compiles each repository root's
``svdd_tpu_torch/csrc/flash_attention.cu`` as the kernel build does and
prints, for every kernel in it, cuobjdump's registers, stack and shared
bytes and its SASS instruction count with the HMMA and MUFU ones (to
tell two trees' builds of a kernel apart).
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ROUNDING_SHAPES = ((8, 200, 12, 64), (64, 200, 12, 64), (64, 1024, 12, 64))


def flash_sass(smoke, roots) -> None:
  """cuobjdump's counts of every kernel of each root's B12 build."""
  import re
  import subprocess
  from svdd_tpu_torch import _build
  nvcc = _build.nvcc_path()
  cuobjdump = os.path.join(os.path.dirname(nvcc), 'cuobjdump')
  out_dir = os.path.join(REPO, 'build', 'probe_sass')
  os.makedirs(out_dir, exist_ok=True)
  for i, root in enumerate(roots):
    src = os.path.join(os.path.abspath(root), 'svdd_tpu_torch', 'csrc')
    lib = os.path.join(out_dir, f'flash_attention_{i}.so')
    subprocess.run([nvcc, *_build.NVCC_FLAGS, '-I', src, '-o', lib,
                    os.path.join(src, 'flash_attention.cu')], check=True,
                   timeout=600)
    dump = lambda flag: subprocess.run(
        [cuobjdump, flag, lib], capture_output=True, text=True, check=True,
        timeout=120).stdout
    counts, fn = {}, None
    for line in dump('-sass').splitlines():
      if 'Function :' in line:
        fn = line.split('Function :')[1].strip()
        counts[fn] = {'instructions': 0, 'HMMA': 0, 'MUFU': 0}
      elif fn is not None and re.match(r'\s+/\*[0-9a-f]{4,}\*/', line):
        counts[fn]['instructions'] += 1
        for op in ('HMMA', 'MUFU'):
          counts[fn][op] += op in line
    fn = None
    for line in dump('-res-usage').splitlines():
      m = re.match(r'\s*Function (\S+):', line)
      if m:
        fn = m.group(1)
      elif fn in counts and 'REG:' in line:
        for key in ('REG', 'STACK', 'SHARED'):
          hit = re.search(key + r':(\d+)', line)
          counts[fn][key] = int(hit.group(1)) if hit else None
    smoke.emit({'phase': 'flash_sass', 'root': os.path.abspath(root),
                'kernels': counts})


def time_roundings(smoke) -> None:
  """B12 forced to each rounding at each of ROUNDING_SHAPES."""
  import torch
  from svdd_tpu_torch.ops import flash_attention as K
  gen = torch.Generator('cuda').manual_seed(0)
  for shape in ROUNDING_SHAPES:
    for dtype in (torch.float32, torch.bfloat16):
      b, l, h, d = shape
      qkv = torch.randn(b, l, 3, h, d, device='cuda',
                        generator=gen).to(dtype)
      q, k, v = qkv.unbind(2)
      for causal in (False, True):
        # the mha rounding's second pass is built for bf16 alone
        roundings = (('pallas_body', True),) + (
            (('mha', False),) if dtype == torch.bfloat16 else ())
        ms = {name: smoke.median_ms(
            lambda body=body: K._launch(q, k, v, causal, body), iters=20)
              for name, body in roundings}
        smoke.emit({'phase': 'b12_roundings', 'shape': list(shape),
                    'dtype': str(dtype).split('.')[-1], 'causal': causal,
                    'gate_rounding': ('pallas_body' if K.body_rounds(l, d)
                                      else 'mha'),
                    'ms': ms, 'mha_over_body': (ms['mha'] / ms['pallas_body']
                                                if 'mha' in ms else None)})
      del qkv, q, k, v
      torch.cuda.empty_cache()


def main() -> None:
  ap = argparse.ArgumentParser()
  ap.add_argument('--kernels-only', action='store_true')
  ap.add_argument('--roundings', action='store_true')
  ap.add_argument('--sass', nargs='+', default=None, metavar='ROOT')
  args = ap.parse_args()
  sys.path.insert(0, REPO)
  import chip_smoke as smoke
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_backbones: no CUDA device')
  from svdd_tpu_torch import _build
  from svdd_tpu_torch import value as value_lib
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  from svdd_tpu_torch.train import diffusion as train_diff
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = smoke.nvidia_smi()
  if args.sass:
    flash_sass(smoke, args.sass)
    print(smi, flush=True)
    return
  smoke.emit({'phase': 'build', 'nvcc_build_s': _build.build()})
  if args.roundings:
    time_roundings(smoke)
    print(smi, flush=True)
    return
  gen = torch.Generator('cuda').manual_seed(0)
  for name, fn in smoke.kernel_checks():
    if not name.startswith(('flash_attention', 'rmsnorm')):
      continue
    for dtype in (torch.float32, torch.bfloat16):
      r = fn(dtype, gen)
      dname = str(dtype).split('.')[-1]
      if 'bound_ms' not in r:
        r['bound_ms'], r['bound_by'] = smoke.bound(r['flops'], r['bytes'],
                                                   dname)
      torch.cuda.synchronize()
      smoke.emit({'phase': 'kernel', 'kernel': name, 'dtype': dname, **r})
  if not args.kernels_only:
    cfg = dna_config()
    ckpt = os.path.join(smoke._train_dir('probe_denoiser'), 'ckpt')
    train_diff.save_checkpoint(ckpt, train_diff.init_state(
        Diffusion(cfg, device='cuda'), cfg))
    value_dir = smoke._value_dir('value')
    model = EnformerValueModel(
        generator=torch.Generator('cuda').manual_seed(3))
    value_lib.save_checkpoint(os.path.join(value_dir, 'value_mc.pt'), model)
    del model
    runs = smoke.backbones_phase(ckpt)
    smoke.emit({'phase': 'launches', **{k: {n: c for n, c in v['launches']
                                           .items() if c}
                                       for k, v in runs.items()}})
  print(smi, flush=True)


if __name__ == '__main__':
  main()
