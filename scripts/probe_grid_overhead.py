#!/usr/bin/env python3
"""Where a pretraining step on a one-process NCCL grid spends its extra
host time, on one CUDA card.

  torchrun --standalone --nproc_per_node=1 scripts/probe_grid_overhead.py

Builds the full-width denoiser (hidden 128, 20 layers) at phase 6's
configuration (batch 512, accum 2, f32), then in one process: the
synchronised host ms of the plain step (no grid) and of the DP and FSDP
grid steps (``train/diffusion.py:train_step``), 5 each after 2 warm-up
steps, turn and turn about; the host ms of one scalar all-reduce and of
``sum_gradients_`` on the denoiser's gradients, enqueued and
synchronised; and torch.profiler's CPU time by op of one step of each
(the top ops). One JSON line a part, then the card's nvidia-smi name
and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
  sys.path.insert(0, REPO)
  import torch
  import chip_smoke as smoke
  from torch.profiler import ProfilerActivity, profile
  from svdd_tpu_torch.cli import common, main_gosai
  from svdd_tpu_torch.data import gosai
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.parallel import mesh as M
  from svdd_tpu_torch.train import diffusion as T
  if not M.initialize_multihost(device='cuda'):
    raise SystemExit('probe_grid_overhead: run it under torchrun')
  common.full_f32()
  mesh = M.make_mesh(1, 1)
  smoke._no_data_dir()              # the smoke's empty data directory
  emit = lambda o: print(json.dumps(o), flush=True)

  def state_of(grid, fsdp):
    cfg = main_gosai.build_config(main_gosai.parser().parse_args(
        ['--set', *smoke.PAR_TRAIN_SET] + (['parallel.fsdp=true']
                                           if fsdp else [])))
    st = T.init_state(Diffusion(cfg, device='cuda'), cfg,
                      mesh=mesh if grid else None)
    batch = next(iter(gosai.get_dataloaders(cfg, skip_valid=True,
                                            data_dir=smoke.PAR_DATA_DIR)[0]))
    return st, batch, cfg

  runs = {'plain': state_of(False, False), 'dp': state_of(True, False),
          'fsdp': state_of(True, True)}

  def step(name):
    st, batch, cfg = runs[name]
    T.train_step(st, batch, cfg)
    torch.cuda.synchronize()

  for name in runs:
    for _ in range(2):
      step(name)
  times = {name: [] for name in runs}
  for _ in range(5):
    for name in runs:
      t0 = time.perf_counter()
      step(name)
      times[name].append((time.perf_counter() - t0) * 1e3)
  emit({'part': 'step_ms', **{k: sorted(v) for k, v in times.items()}})

  x = torch.ones((), device='cuda')
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(100):
    M.all_reduce_(x, mesh.data_group)
  enq = (time.perf_counter() - t0) * 10
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(100):
    M.all_reduce_(x, mesh.data_group)
    torch.cuda.synchronize()
  synced = (time.perf_counter() - t0) * 10
  st = runs['dp'][0]
  params = list(st.model.backbone.parameters())
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(10):
    M.sum_gradients_(params, mesh.data_group, x)
  sg_enq = (time.perf_counter() - t0) * 100
  torch.cuda.synchronize()
  sg = (time.perf_counter() - t0) * 100
  emit({'part': 'collectives_ms', 'scalar_all_reduce_enqueue': enq,
        'scalar_all_reduce_synced': synced,
        'sum_gradients_enqueue': sg_enq, 'sum_gradients_synced': sg,
        'env': {k: v for k, v in os.environ.items() if 'NCCL' in k}})

  for name in runs:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
      step(name)
    top = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                  for e in prof.key_averages()), key=lambda r: -r[1])[:12]
    emit({'part': 'host_ops', 'run': name,
          'top_self_cpu_ms': [[k, round(ms, 3), n] for k, ms, n in top]})
  print(smoke.nvidia_smi(), flush=True)
  torch.distributed.destroy_process_group()


if __name__ == '__main__':
  main()
