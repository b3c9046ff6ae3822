#!/usr/bin/env python3
"""Where a full-width pretraining step's time goes, on one card.

  python3 scripts/probe_train_step.py [--cudnn-backward]

For f32 (TF32 off) and bf16 (``SVDD_CNN_BF16=1``), one optimizer step of
``chip_smoke.py``'s training configuration (global batch 512 of the
synthetic split as two microbatches of 256, L=200, hidden 128, 20
layers) with the trainer's settings (cuDNN's defaults): the host mean
of 3 synchronised steps from a host batch (``step_ms``, the batch copied
to the card each step, as ``Trainer.fit`` does), the peak memory, the
host time to enqueue one step whose batch is already on the card
(``enqueue_ms``) and to its end (``enqueue_to_sync_ms``), the operations
that synchronise the host with the card in that step
(``torch.cuda.set_sync_debug_mode``), and the card's kernels by total
time (the profiler). ``--cudnn-backward`` also runs each dtype with the
stem and 1x1 convs differentiated by cuDNN (``conv1d_shifted``, as the
decoders do) in place of ``conv1d_deterministic``, with cuDNN
deterministic and not. One JSON line and one kernel table per run, then
the card's nvidia-smi name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(bf16: bool, cudnn_backward: bool, deterministic: bool) -> None:
  import torch
  from torch.profiler import ProfilerActivity, profile
  import chip_smoke as smoke
  from svdd_tpu_torch.cli import main_gosai
  from svdd_tpu_torch.data import gosai
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models import cnn
  from svdd_tpu_torch.ops import conv1d
  from svdd_tpu_torch.train import diffusion as train_diff
  cfg = main_gosai.build_config(main_gosai.parser().parse_args(
      ['--set', *smoke.TRAIN_SET]))
  batch = next(iter(gosai.get_dataloaders(
      cfg, skip_valid=True, data_dir=smoke._no_data_dir())[0]))
  saved = cnn.conv1d_deterministic
  if cudnn_backward:
    cnn.conv1d_deterministic = conv1d.conv1d_shifted
  try:
    with smoke.bf16_switches(bf16):
      trainer = train_diff.Trainer(Diffusion(cfg, device='cuda'), cfg)
    torch.backends.cudnn.deterministic = deterministic
    state = trainer.init_or_restore()
    step = lambda b: train_diff.train_step(state, b, cfg)
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
      step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    on_card = {k: torch.as_tensor(v).cuda() for k, v in batch.items()
               if k != 'clss'}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(on_card)
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    to_sync = (time.perf_counter() - t0) * 1e3
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      torch.cuda.set_sync_debug_mode('warn')
      try:
        step(on_card)
      finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sites = collections.Counter(f'{os.path.relpath(w.filename, REPO)}:'
                                f'{w.lineno}' for w in caught)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      step(on_card)
      torch.cuda.synchronize()
  finally:
    cnn.conv1d_deterministic = saved
  smoke.emit({'bf16': bf16, 'cudnn_backward': cudnn_backward,
              'cudnn_deterministic': deterministic, 'step_ms': step_ms,
              'peak_gib': peak, 'enqueue_ms': enqueue,
              'enqueue_to_sync_ms': to_sync,
              'sync_sites': sites.most_common(8)})
  print(prof.key_averages().table(sort_by='cuda_time_total', row_limit=12,
                                  max_name_column_width=70), flush=True)


def main() -> None:
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--cudnn-backward', action='store_true')
  args = ap.parse_args()
  sys.path.insert(0, REPO)
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('probe_train_step: no CUDA device')
  import chip_smoke as smoke
  from svdd_tpu_torch import _build
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = smoke.nvidia_smi()
  smoke.emit({'phase': 'build', 'nvcc_build_s': _build.build()})
  for bf16 in (False, True):
    run(bf16, False, False)
    if args.cudnn_backward:
      run(bf16, True, True)
      run(bf16, True, False)
    torch.cuda.empty_cache()
  print(smi, flush=True)


if __name__ == '__main__':
  main()
