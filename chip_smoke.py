#!/usr/bin/env python3
"""Drive the svdd_tpu_torch port on one CUDA card and check it.

  python3 chip_smoke.py

Phases, each printing one JSON line and ending in
``torch.cuda.synchronize()``; any failed check raises, so the script
exits non-zero and prints no result:
  1. device and build: the card, versions, the nvcc build of every
     kernel under svdd_tpu_torch/csrc (one nvcc per source, in parallel);
     the tensor-core mma instructions and registers of B1's, B6's, B7's,
     B14's, B3/B4's and B8's product kernels as built (cuobjdump);
  2. every kernel of the SVDD-MC, DPS, classifier-guidance and
     sample_eval paths, of the Basenji trunk and of the off-grid Enformer
     pool at its full-size shapes (B12 also at head dim 128 and at
     L = 200, each against the plain form of the rounding JAX's dispatch
     takes there), in float32 and bfloat16, against its plain PyTorch
     version on the same inputs (the candidate draw on the noise the
     kernel reports, and by frequencies, its bound by its bytes and its
     logarithms and Philox multiplies; B5 with the relk rounding JAX's
     dispatch takes at the shape; the cnn layer's backward on the
     relu mask the kernel reports; B14's and B5's wrappers on shapes off
     their gates, which must take the plain version bit for bit; B3, B4
     and B8 also at short points, N = 6 and 8, B4 at the classifier's
     seven N = 512 pools, B5 at its N = 512, B1 also at SVDD-PM's
     5120 candidate rows, B7 and B8 also at the value-net trainers'
     1,024 and 64 rows, dx and dW, and B3, B4, B5 and B8 at the
     analysis path's 1, 20, 32 and 288 rows, the
     ``kernel_analysis_rows`` lines), with the times of both, the
     time of one PyTorch call computing the same function where there is
     one, and the least time the card could take for the work; times are
     the card's own for a call (the profiler), CUDA-event medians beside
     them, but B12's and the plain and library times of the multi-ms
     B3, B4, B7 and B14, which are CUDA-event medians;
  3. the full-width denoiser and Enformer value net on a few rows, the
     kernel path on the card against the plain path on the CPU: their
     outputs, then the input gradients the guided decoders take, in
     float32 and then in bf16 (SVDD_CNN_BF16=1, SVDD_VALUE_BF16=1), then
     the full-width DiT, AR and DiMamba backbones' outputs, then the DiT
     at head dims 128 (the kernel) and 16 (the plain attention); then the
     models of the Basenji and off-grid paths at 512 rows, L=200, with
     launch counts: the Basenji trunk at its published defaults and on
     the 128-lane grid (SVDD_PALLAS_FUSED_CONV unset and set), and an
     Enformer value net with channels=1152 (stem width 576, off the
     grid) forward and input gradient;
  4. the decodes, each through its CLI's ``run`` with every kernel's
     launch count read around it: SVDD-MC (M=10), DPS, classifier
     guidance, SVDD-PM (decode_tweedie, M=10) and TDS (decode_TDS, alpha
     0.5, its ESS trace) at --task dna, B=512, L=200, 32 steps (the
     CLIs' 128 cut in depth), in float32 and again under the bf16
     switches (the ``*_bf16`` runs), and SVDD-MC with --m_schedule
     16:4,16:10 in bf16; SVDD-PM and TDS
     through ``decode.run_decode`` scored by the full-width Enformer
     reward oracle (f32, 16 steps); ``main_gosai
     --mode sample_eval`` for the text preset's DiT (64 rows, L=1024,
     ddpm_cache, 32 steps, scored by the AR backbone) and DiMamba
     (--task dna, 512 rows, 32 steps); all full-width random-weight
     models; and SVDD-MC for 8 steps with the channels=1152 value net;
  5. diffusion pretraining of the full-width denoiser: ``main_gosai
     --mode train --task dna`` at global batch 512 in two microbatches,
     40 steps with validation, the sample-quality hook and checkpoints,
     in f32 and under the bf16 switches (B6 launched exactly 20 x 2 x 40
     times); resume on the card (a run dying after step 30, its resume
     from step 20's checkpoint and a clean run, equal bit for bit);
     ``--mode ppl_eval`` and ``--mode sample_eval`` reading the f32 run's
     checkpoint; one training step on 8 rows on the card against the
     CPU (loss, every gradient, every updated parameter), f32 and bf16;
     then value-net and oracle training at full width: ``cli.train_oracle
     --task dna`` (the 3-task Enformer, batch 64, and ``--small``) with
     its validation Pearson; ``cli.train --task dna`` at batch 8 (1,024
     states a grad step) from the f32 pretraining checkpoint and that
     oracle, MC in f32 and under the bf16 switches and CD-Q in f32, each
     with exact launch counts (B4 x 7, B5 x 11, B7 x 6, B8 x 7 a grad
     step); ``cli.eval`` on the MC value net; two runs from one seed,
     a restored state and two resumes from it, each equal bit for bit;
     one 8-row grad step on the card against the CPU (loss, gradients,
     updated parameters and running statistics; in f32 also against the
     step in float64 on the card's relu masks), f32 and bf16; traced MC
     grad steps (f32, bf16), a CD-Q iteration and an oracle step;
  6. one step of each decode (the guided ones in bf16 too, and the RNA
     task's in f32; PM and TDS with a valid posterior carry, as after
     their first step) under torch.profiler: host ms per step,
     the card's busy ms and idle share, and kernel ms by kind; one
     DiT forward at the text preset's 512 rows; and one training step
     (batch 512, f32 and bf16) with its tokens per second;
  7. the RNA task (L=50; phase 2 also holds B1 at 512 and 5,120 rows, B6
     at 512 and B2 at (512, 10, 50, 5) against their plain versions at
     L=50, the ``kernel_rna`` lines; in bf16 B6 rounds as JAX's
     reference VJP below L=100): the ConvGRU value net and oracle on 512
     rows on the card against the CPU, eval and training forwards with
     their gradients; the six decoders at --task rna, B=512, 32 steps,
     f32 and under the bf16 switches (the ConvGRU stays f32), with exact
     launch counts; sample_eval with the analytic predictor;
     ``cli.train_oracle --task rna``, ``main_gosai --mode train --task
     rna`` (B6 exactly 20 x 2 x steps, the sample-quality hook scored by
     that oracle), ``cli.train --task rna`` (MC) and ``cli.eval``, runs
     and resumes bit for bit; and the stages of
     ``svdd_tpu_torch/pipeline.py`` for both tasks, a few steps each;
  8. the reference's torch checkpoints and the timed and multisep value
     models: phase 5's denoiser, oracle and MC value net written in the
     reference's layouts (Lightning 'state_dict' under 'backbone.', grelu
     under 'model.', the value trainer's 'model_state_dict' under
     'module.'; the inverse name maps are this script's) and read back
     by the CLIs' checkpoint flags bit for bit, then ``cli.decode``
     (SVDD-MC, B=512, M=10, 8 steps) from those files with exact launch
     counts; the full-width timed value net on 4 rows, card vs CPU: its
     output and its fused eval tower's input and weight gradients (B3's
     backward, the gradient of its reference form); its SVDD-MC decode
     (``controlled_sampler_timed``, B=512, M=10, 16 steps) with exact
     launch counts; ``cli.train --model multienformer --task dna`` (ten
     full-width trunks, batch 8, 2 iterations) from phase 5's
     checkpoint and oracle with exact launch counts, twice from one seed,
     equal bit for bit; one 2-trunk multisep step card vs CPU (losses,
     every leaf's gradient and update, the running statistics'
     included);
  9. the DiT, DiMamba and AR backbones: ``main_gosai --mode train`` at
     full width (the DNA DiT, hidden 768, 12 blocks, 12 heads, L=200, in
     bf16 and f32; DiMamba, d_model 256, 4 layers; the AR baseline) for a
     few steps of 64 rows with validation and a checkpoint, B12/B13
     launched exactly once a block a forward (their backward the plain
     forms' gradients); one training step of each card vs CPU (loss,
     every gradient, every update); traced training steps; semi-AR
     sample_eval from the DiT's checkpoint; the AR net's cached and full
     decode loops; DPS and DG with the DiT as denoiser; gen-ppl from the
     AR run's checkpoint (the Hugging Face name falling back on its
     RuntimeError, as JAX's CLI does); phase 5's denoiser and value net
     written as exports of the JAX package's checkpoints and read back
     through the flags bit for bit;
 10. the rest of A1: ``main_gosai --mode train --task dna`` at full width
     (batch 512, accum 2, 4 steps, f32) under ``parameterization=d3pm
     T=128``, ``sedd``, ``T=128`` (SUBS), ``noise.type`` cosine,
     cosinesqr, linear (importance sampling) and geometric, and
     ``model.cls_free_guidance=true``, each with exact B1 and B6 counts
     (D3PM with T > 0: 40 a microbatch, its reconstruction forward);
     ppl_eval and sample_eval from the D3PM and class-conditioned
     checkpoints; one 8-row step of D3PM, SEDD and the class-conditioned
     CNN card vs CPU, f32 and bf16, as phase 5's; traced steps of those
     three; the classifier-head CNN card vs CPU; B2 against its plain
     version on a log q with +inf lanes (SEDD's zero-sigma log score);
     the saluki task: the six-channel ConvGRU oracle on (4, 12288, 6)
     card vs CPU, ``cli.decode`` (SVDD-MC) and ``cli.decode_tweedie``
     (SVDD-PM) at --task rna_saluki (B=32, M=5, 4 steps, a body written
     from a seed) with exact B1 and B2 counts and one oracle call's ms
     and peak memory, ``cli.train`` (MC) and ``cli.train_oracle`` at
     --task rna_saluki;
 11. the supporting modules (A15) on the full-width 3-task DNA oracle
     (Enformer, 1536 channels, random weights from a seed), in f32 and
     again in bf16 (the value net's SVDD_VALUE_BF16 compute) for the first
     three: ISM of one sequence through ``get_attributions`` (800 mutants
     in batches of 512 and 288, then the sequence; 8 mutants and the
     sequence card vs CPU), input x gradient, integrated gradients (4
     points) and expected gradients (4 references) card vs CPU, then at
     their defaults (32, 20) on the card, and the attention maps (11, 8,
     2, 2) card vs CPU, each with exact launch counts (B3, B4, B5 a
     forward, B8 a backward; in bf16 the pools below JAX's gate take
     their references); in f32: ``evolve`` (4 rounds) and ``ledidi`` (50
     steps, its first 3 losses card vs CPU), motif discovery over the IG
     attributions of 64 sequences, the reward report over phase 4's npz
     files, the validation hook's embedding branch (the oracle trunk's
     mean over length), StepTimer around SVDD-MC steps with the oracle
     as value (B=64, M=10), ``profile_trace`` and ``nan_guard``;
 12. the parallel paths (A16.1-A16.3) on ``torch.distributed``: B2's
     row0 (two launches on the row halves of (512, 10, 200, 5) equal to
     the full launch bit for bit, the row0 form timed at rows 512-1023,
     the ``kernel_row0`` line); then a worker under ``torchrun
     --nproc_per_node=1`` (NCCL, a world of one: ``parallel_worker``)
     runs ``main_gosai --mode train`` DP and with ``parallel.fsdp=true``
     (full width, batch 512, accum 2, 4 steps), ``cli.train --dist`` (MC)
     and ``--dist --fsdp`` (CD-Q) from phase 6's checkpoint and phase 5's
     oracle (batch 8, 16 steps, one iteration), and SVDD-MC on a 1 x 1
     grid with and without the tensor-parallel value net (B=512, M=10, 4
     steps), each with its collectives counted; this process runs the
     same without a process group, and each pair must agree bit for bit
     (losses, checkpoints and trainer states by ``fingerprint``,
     samples), each grid run having issued collectives and launched its
     kernels; the DP and FSDP steps traced beside their twin's, each
     decode's host ms a step (the ``parallel`` line); then in the worker
     the pipelined DiT (phase 9's DNA DiT, 64 rows, dropout 0, f32) on a
     one-stage pipe grid, 4 steps through ``train_step`` at M = 4
     (within JAX's tolerances of the plain step) and V = 2 (bit for bit
     the plain step), B12 exactly once a block a microbatch forward, the
     permutes, broadcast and all-reduce counted, each step traced beside
     the plain one's (the ``parallel_pipe`` lines); ``sp_mha`` on a 1 x 1
     grid at (64, 1024, 12, 64), causal and not, bit for bit ``mha`` with
     its input gradients (the ``parallel_sp`` lines);
then the kernels line (launches summed over the runs of phases 3-5 and
7-12; B1's, B6's and B2's RNA points under ``rna``, B3's, B4's, B5's and
B8's analysis rows under ``analysis_rows``),
the card's ``nvidia-smi`` name and power limit, and a last line
{"ok": true, "device": {...}}.

Float32 phases run with TF32 off for matmuls and cuDNN convolutions.
It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# name -> (source, the TPU kernel's pallas_call it replaces[, the
# (N, L, C) pallas_call whose function it also computes])
KERNEL_INFO = {
    'cnn_layer': ('svdd_tpu_torch/csrc/cnn_layer.cu',
                  'svdd_tpu/ops/cnn_layer_pallas.py:234'),
    'gumbel_candidates': ('svdd_tpu_torch/csrc/gumbel_candidates.cu',
                          'svdd_tpu/ops/fused_sample.py:63'),
    'attn_pool_prologue_im2col': ('svdd_tpu_torch/csrc/attn_pool.cu',
                                  'svdd_tpu/ops/attn_pool_pallas.py:1071',
                                  'svdd_tpu/ops/attn_pool_pallas.py:721'),
    'attn_pool': ('svdd_tpu_torch/csrc/attn_pool.cu',
                  'svdd_tpu/ops/attn_pool_pallas.py:916',
                  'svdd_tpu/ops/attn_pool_pallas.py:397'),
    'attn_l2': ('svdd_tpu_torch/csrc/attn_l2.cu',
                'svdd_tpu/ops/attn_l2_pallas.py:260',
                'svdd_tpu/ops/attn_l2_pallas.py:141'),
    'cnn_layer_bwd': ('svdd_tpu_torch/csrc/cnn_layer_bwd.cu',
                      'svdd_tpu/ops/cnn_layer_pallas.py:504'),
    'conv1d_bwd': ('svdd_tpu_torch/csrc/conv1d_bwd.cu',
                   'svdd_tpu/ops/conv1d_bwd_pallas.py:141'),
    'attn_pool_bwd': ('svdd_tpu_torch/csrc/attn_pool_bwd.cu',
                      'svdd_tpu/ops/attn_pool_pallas.py:523'),
    'flash_attention': ('svdd_tpu_torch/csrc/flash_attention.cu',
                        'svdd_tpu/ops/flash_attention_pallas.py:66'),
    'flash_attention_causal': ('svdd_tpu_torch/csrc/flash_attention.cu',
                               'svdd_tpu/ops/flash_attention_pallas.py:66'),
    'rmsnorm': ('svdd_tpu_torch/csrc/rmsnorm.cu', 'svdd_tpu/ops/norms.py:75'),
    'nacdr_im2col': ('svdd_tpu_torch/csrc/im2col.cu',
                     'svdd_tpu/ops/im2col_pallas.py:100'),
    'fused_conv1d': ('svdd_tpu_torch/csrc/fused_conv.cu',
                     'svdd_tpu/ops/fused_conv_pallas.py:133'),
    'attn_pool_logits': ('svdd_tpu_torch/csrc/attn_pool_logits.cu',
                         'svdd_tpu/ops/attn_pool_pallas.py:81'),
    'attn_pool_logits_im2col': ('svdd_tpu_torch/csrc/attn_pool_logits.cu',
                                'svdd_tpu/ops/attn_pool_pallas.py:203'),
}
# the kernels each decode must launch
PATH_KERNELS = {
    'svdd_mc': ('cnn_layer', 'gumbel_candidates',
                'attn_pool_prologue_im2col', 'attn_pool', 'attn_l2'),
    'dps': ('cnn_layer', 'cnn_layer_bwd'),
    'classifier': ('cnn_layer', 'attn_pool', 'attn_l2', 'conv1d_bwd',
                   'attn_pool_bwd'),
    'svdd_pm': ('cnn_layer', 'gumbel_candidates'),
    'tds': ('cnn_layer',),
    'text_mdlm': ('flash_attention', 'flash_attention_causal'),
    'dimamba': ('rmsnorm',),
}
GUIDED = ('svdd_mc', 'dps', 'classifier', 'svdd_pm', 'tds')
# SVDD-PM and TDS scored by the full-width Enformer reward oracle (f32,
# its fused eval tower), as the JAX package's bench scores them
# (bench.py:211-234), at 16 steps for the smoke's time: the oracle's
# kernels run at B*M = 5120 rows (PM) or 512 (TDS)
ORACLE_STEPS = 16
ORACLE_RUNS = {
    'svdd_pm_enformer': PATH_KERNELS['svdd_pm'] + (
        'attn_pool_prologue_im2col', 'attn_pool', 'attn_l2'),
    'tds_enformer': PATH_KERNELS['tds'] + (
        'attn_pool_prologue_im2col', 'attn_pool', 'attn_l2'),
}
# one SVDD-MC decode with scheduled M (bench.py's example), in bf16
M_SCHEDULE = '16:4,16:10'
# the JAX package's bf16 compute switches, which its bench sets: the CNN
# denoiser and the Enformer value net compute in bf16 (the reward oracle
# stays f32); the guided decodes run once in f32 and once under them
BF16_SWITCHES = ('SVDD_CNN_BF16', 'SVDD_VALUE_BF16')
BF16_RUNS = {f'{algo}_bf16': PATH_KERNELS[algo] for algo in GUIDED}
BF16_RUNS['svdd_mc_m_schedule_bf16'] = PATH_KERNELS['svdd_mc']
# card vs CPU tolerance of the full-width models in bf16: both round to
# bf16 at the same points, but the kernels and cuBLAS sum in other
# orders, so a value can round one bf16 ulp apart, and a random-weight
# net carries that through its 20 denoiser layers, or 7 tower blocks and
# 11 transformer blocks, and their backward: on the CPU alone the bf16
# nets' outputs and input gradients lie several percent from the f32
# ones (the value net's gradient 12% by norm). So the card's bf16 result
# must lie within BF16_NOISE_MULT times the CPU's own bf16-to-f32
# distance of the CPU's bf16 result (max abs for outputs, the norm for
# gradients), plus 2^-8 of the CPU value
BF16_NOISE_MULT = 2.0


def bf16_close(err: float, noise: float, scale: float) -> bool:
  """The bf16 card-vs-CPU rule: err <= BF16_NOISE_MULT * noise + 2^-8 *
  scale, noise the CPU's bf16-to-f32 distance."""
  return err <= BF16_NOISE_MULT * noise + 2 ** -8 * scale


@contextlib.contextmanager
def bf16_switches(on: bool):
  """SVDD_CNN_BF16 and SVDD_VALUE_BF16 set to '1' (on) or '0' for the
  enclosed runs, restored after."""
  saved = {k: os.environ.get(k) for k in BF16_SWITCHES}
  os.environ.update({k: '1' if on else '0' for k in BF16_SWITCHES})
  try:
    yield
  finally:
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
# the runs of the Basenji trunk and the off-grid Enformer value net
# (models phase, N=512) and the SVDD-MC decode with that value net (decode
# phase), and the kernels each must launch
OFFGRID_KERNELS = {
    'basenji': ('nacdr_im2col',),
    'basenji_128': ('nacdr_im2col',),
    'basenji_128_fused_conv': ('fused_conv1d',),
    'enformer_1152': ('attn_pool_logits_im2col', 'attn_pool_prologue_im2col',
                      'attn_pool', 'attn_l2'),
    'enformer_1152_grad': ('attn_pool_logits', 'attn_pool', 'attn_l2',
                           'conv1d_bwd', 'attn_pool_bwd'),
    'svdd_mc_1152': ('cnn_layer', 'gumbel_candidates', 'attn_pool_logits_im2col',
                     'attn_pool_prologue_im2col', 'attn_pool', 'attn_l2'),
}
# kernel-vs-plain tolerances |got - want| <= atol + rtol * |want|:
#  * float32: the kernel and PyTorch sum the same f32 products in other
#    orders (TF32 off), ~1e-6 relative per product sum;
#  * bfloat16 (8-bit mantissa, 2^-8 relative): the kernels round to
#    bf16 where their plain versions do, but sum in f32 in another
#    order, so a value rounded to bf16 mid-way (cnn_layer's conv output,
#    attn_l2's q + bias) can land one bf16 ulp apart and carry that
#    into the output: a few bf16 ulps at most. flash_attention rounds p
#    against a running row maximum where its plain version (mha) rounds
#    the normalised probabilities: one bf16 ulp of a term of its sum.
#    Its float32 products are 3xTF32, about 2^-20 relative each.
TOL = {'float32': (1e-4, 1e-4), 'bfloat16': (2 ** -5, 2 ** -5)}
# sums over rows (weight gradients, per-channel and per-sequence sums):
# |got - want| <= RED_TOL * max |want|. f32: the same products summed in
# another order over up to 1e5 rows; bf16: the summed values are rounded
# to bf16 where the plain version rounds them, but an f32 statistic in
# another order can round one of them (a normalised h, a blend weight's
# dld) one bf16 ulp apart, a 2^-8 change of one term of a long sum.
RED_TOL = {'float32': 2e-4, 'bfloat16': 2 ** -7}
# where the cnn layer backward's relu mask (the forward kernel's) and the
# plain version's own disagree, the plain conv output must be within
# rounding of 0: f32 tap sums in another order, or one bf16 ulp of a
# conv output of magnitude below 1
MASK_EDGE = {'float32': 1e-4, 'bfloat16': 2 ** -6}

# the card's published peaks (NVIDIA data sheet, H100 SXM, dense, at its
# 700 W limit): f32 outside the tensor cores, bf16 on them, HBM3; and f32
# products as 3xTF32 (three TF32 tensor-core products, 495/3 TFLOP/s),
# the bound of a kernel that computes f32 that way (B12)
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12, 'tf32x3': 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# device_ms: traces taken before a call falls back to CUDA events, and the
# calls that fell back in this run
PROFILE_TRIES = 3
PROFILER_MISSES = []


def bound(flops: float, nbytes: float, dtype: str = 'float32'):
  """(ms, 'operations' | 'bytes'): the least time the card could take,
  the larger of the work over the peak rate and the bytes over HBM's."""
  t_ops = flops / PEAK_FLOPS[dtype]
  t_mem = nbytes / HBM_BYTES_PER_S
  return max(t_ops, t_mem) * 1e3, 'operations' if t_ops >= t_mem else 'bytes'


def emit(obj) -> None:
  print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 5, warmup: int = 1) -> float:
  """Median device time of fn() over iters launches (CUDA events)."""
  import torch
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(iters):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
  times.sort()
  return times[len(times) // 2]


def device_ms(fn, reps: int = 10, fragment: str | None = None) -> float:
  """The card's time for one call of fn: the summed durations of the
  kernels and copies the calls launched (torch.profiler), over reps
  calls after a warm-up, divided by reps; with a fragment, only the
  kernels whose name holds it. Host time between kernels is not
  counted: a call shorter than its wrapper's host time (a bf16 CNN
  layer) is timed by the card's work alone, where CUDA events around it
  would time the host.

  The profiler can return a trace with no device event at all (it did
  once, for B14, in a whole smoke run on an H100). Such a trace is taken
  again, up to PROFILE_TRIES times in all. If every try comes back empty,
  the call is timed by CUDA events (median_ms) instead, and the miss is
  recorded in PROFILER_MISSES and emitted on a line of its own."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  for _ in range(PROFILE_TRIES):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if dev:
      return sum((e.time_range.end - e.time_range.start) / 1e3
                 for e in dev
                 if fragment is None or fragment in e.name) / reps
  ms = median_ms(fn, iters=reps)
  miss = {'phase': 'profiler_miss', 'tries': PROFILE_TRIES,
          'fragment': fragment, 'fallback': 'cuda_events_median_ms',
          'ms': ms}
  PROFILER_MISSES.append(miss)
  emit(miss)
  return ms


def timed(call, plain, library=None, reps: int = 10, iters: int = 10) -> dict:
  """The times of a kernel call, its plain version and, where there is
  one, the PyTorch call computing the same function: each the card's
  time for a call (device_ms, the profiler: every kernel and copy the
  call launched) as ms, plain_ms and library_ms, and each CUDA-event
  median beside it (median_ms, ...), which for a call under a
  millisecond times mostly the wrapper's host work."""
  r = {'ms': device_ms(call, reps), 'median_ms': median_ms(call, iters),
       'plain_ms': device_ms(plain, reps),
       'plain_median_ms': median_ms(plain, iters), 'library_ms': None}
  if library is not None:
    r.update(library_ms=device_ms(library, reps),
             library_median_ms=median_ms(library, iters))
  return r


def compare_sum(name: str, got, want, dtype: str) -> tuple[float, float]:
  """(max abs error, max abs error / max |want|) of a sum over rows;
  raises beyond RED_TOL of the largest |want|."""
  import torch
  got, want = got.float(), want.float()
  if got.shape != want.shape or not torch.isfinite(got).all():
    raise AssertionError(f'{name} {dtype}: shape {tuple(got.shape)} vs '
                         f'{tuple(want.shape)} or non-finite values')
  err = float((got - want).abs().max())
  scale = float(want.abs().max())
  if err > RED_TOL[dtype] * scale:
    raise AssertionError(f'{name} {dtype}: max abs err {err} > '
                         f'{RED_TOL[dtype]} * max |plain| {scale}')
  return err, err / scale if scale else 0.0


def compare(name: str, got, want, dtype: str) -> tuple[float, float]:
  """(max abs error, max abs error / max |want|); raises when any
  element is outside the stated tolerance."""
  import torch
  got, want = got.float(), want.float()
  if got.shape != want.shape:
    raise AssertionError(f'{name}: shape {tuple(got.shape)} != '
                         f'{tuple(want.shape)}')
  if not torch.isfinite(got).all():
    raise AssertionError(f'{name} {dtype}: non-finite output')
  atol, rtol = TOL[dtype]
  err = (got - want).abs()
  bad = err > atol + rtol * want.abs()
  if bad.any():
    raise AssertionError(
        f'{name} {dtype}: {int(bad.sum())} of {err.numel()} elements out '
        f'of tolerance (atol {atol}, rtol {rtol}); max abs err '
        f'{float(err.max())}')
  return float(err.max()), float(err.max() / want.abs().max())


# the kernels whose work is tap, weight-gradient or pool products, by
# library: B1, B6, B7, B14, B3 with B4 (one template), and B8
MMA_KERNELS = {'cnn_layer': ('cnn_layer_kernel',),
               'cnn_layer_bwd': ('cnn_bwd_mask_kernel', 'cnn_bwd_dgrad_ln_kernel',
                                 'cnn_bwd_wgrad_kernel'),
               'conv1d_bwd': ('conv_bwd_dgrad_kernel', 'conv_bwd_wgrad_kernel'),
               'fused_conv': ('fused_conv_kernel',),
               'attn_pool': ('attn_pool_kernel',),
               'attn_pool_bwd': ('pool_bwd_logits_kernel',
                                 'pool_bwd_dgrad_kernel',
                                 'pool_bwd_wgrad_kernel')}


def sass_counts() -> dict:
  """{library: {kernel dtype: {HMMA, FFMA, REG, STACK}}} of the libraries
  of MMA_KERNELS as built, read by cuobjdump: tensor-core mma and f32 FMA
  instructions in each kernel's SASS, its registers and stack bytes; a
  kernel built more than once for a type (B3/B4's flags) is counted once
  per build, the later ones labelled '#2', '#3', .... Raises if a build
  of a kernel of MMA_KERNELS has no HMMA."""
  import re
  from svdd_tpu_torch import _build
  cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), 'cuobjdump')
  names = [k for ks in MMA_KERNELS.values() for k in ks]

  def label(mangled):
    kind = next((k for k in (*names, 'reduce_partials_kernel')
                 if k in mangled), mangled)
    return f'{kind} {"bfloat16" if "bfloat16" in mangled else "float32"}'

  out = {}
  for lib, kernels in MMA_KERNELS.items():
    path = str(_build._library_path(lib))
    dump = lambda flag: subprocess.run(
        [cuobjdump, flag, path], capture_output=True, text=True, check=True,
        timeout=120).stdout
    counts, labels, fn = {}, {}, None
    for line in dump('-sass').splitlines():
      if 'Function :' in line:
        mangled = line.split('Function :')[1].strip()
        fn = kind = label(mangled)
        if kind in counts:
          fn = f'{kind} #{sum(k.startswith(kind) for k in counts) + 1}'
        labels[mangled] = fn
        counts[fn] = {'HMMA': 0, 'FFMA': 0}
      elif fn is not None:
        for op in ('HMMA', 'FFMA'):
          counts[fn][op] += op in line
    fn = None
    for line in dump('-res-usage').splitlines():
      m = re.match(r'\s*Function (\S+):', line)
      if m:
        fn = labels.get(m.group(1))
      elif fn in counts and 'REG:' in line:
        for key in ('REG', 'STACK'):
          counts[fn][key] = int(re.search(key + r':(\d+)', line).group(1))
    for kernel in kernels:
      for dt in ('float32', 'bfloat16'):
        kind = f'{kernel} {dt}'
        builds = [v for k, v in counts.items()
                  if k == kind or k.startswith(kind + ' #')]
        if not builds or not all(v['HMMA'] for v in builds):
          raise AssertionError(f'{lib}: a build of {kind} has no '
                               'tensor-core mma')
    out[lib] = counts
  return out


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


# calls per denoiser pass of the 20 layers, by dilation
CNN_CALLS = {1: 8, 4: 4, 16: 4, 64: 4}
CNN_SHAPE = (512, 200, 128)
# SVDD-PM's candidate forward: B1 at B*M rows
CNN_PM_ROWS = 5120
# B1 and B6 are also held at N = 8 at a short sequence and at the longest
# one a block holds (ops/cnn_layer.kernel_takes)
CNN_SMALL_N, CNN_SHORT_L = 8, 50
# the other row counts at which pretraining runs B1 and B6 at L = 200: a
# microbatch of 256 rows (global batch 512 in two), forward and backward,
# and the sample-quality hook's batches of 64, forward. Each is held
# against the plain version at all four dilations, one launch a point
CNN_TRAIN_ROWS = {'cnn_layer': (256, 64), 'cnn_layer_bwd': (256,)}


def live_rows(l: int, k: int = 5, d: int = 1) -> int:
  """Rows of tap products one sequence needs: the sum over the live taps
  of L - |offset| (a row whose source lies in the SAME padding multiplies
  zeros and is not counted)."""
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  return sum(l - abs(o) for o in live_offsets(k, l, d))


def cnn_rows(l: int, d: int) -> int:
  """live_rows of a k=9 CNN denoiser layer at dilation d."""
  return live_rows(l, 9, d)


def cnn_longest(dtype) -> int:
  """The longest sequence the B1 and B6 kernels take."""
  from svdd_tpu_torch.ops.cnn_layer import kernel_takes
  l = CNN_SHORT_L
  while kernel_takes(l + 1, dtype):
    l += 1
  return l


def _cnn_inputs(n, l, dtype, gen):
  """(x, bias_row, ln_scale, ln_bias, kernel, conv_bias) and a cotangent."""
  import torch
  r = lambda *s: torch.randn(*s, device='cuda', generator=gen)
  c = CNN_SHAPE[2]
  x, br, ct = r(n, l, c).to(dtype), r(n, c).to(dtype), r(n, l, c).to(dtype)
  g, b, cb = 1 + 0.1 * r(c), 0.1 * r(c), 0.1 * r(c)
  w = (r(9, c, c) / (9 * c) ** 0.5).to(dtype)
  return (x, br, g, b, w, cb), ct


def _cnn_bwd_against_plain(args, ct, d, name, label):
  """B6 on args against its plain version on the mask the kernel reports;
  every element where that mask differs from the plain version's own must
  have a plain conv output within MASK_EDGE of 0. Then the bit-for-bit
  mask check against B1 on the same inputs: where the mask is 0, B1's
  output is x exactly; where B1's output differs from x, the mask is 1.
  Returns (max abs err, max rel err, mask flips)."""
  from svdd_tpu_torch.ops import cnn_layer as K
  *got, mask = K.cnn_layer_bwd(*args, ct, dilation=d, return_mask=True)
  want = K.cnn_layer_bwd_plain(*args, ct, dilation=d, mask=mask)
  y = K.relu_input_plain(*args, dilation=d)
  differ = mask != (y > 0)
  flips = int(differ.sum())
  if flips and float(y[differ].abs().max()) > MASK_EDGE[name]:
    raise AssertionError(f'{label} {name}: the kernel relu mask differs '
                         f'where |y| = {float(y[differ].abs().max())}')
  del y, differ
  errs = [compare(f'{label} dx', got[0], want[0], name)]
  errs += [compare_sum(f'{label} {nm}', gt, wt, name)
           for nm, gt, wt in zip(('dbias_row', 'dln_scale', 'dln_bias',
                                  'dkernel', 'dconv_bias'), got[1:], want[1:])]
  del got, want
  out, x = K.cnn_layer(*args, dilation=d), args[0]
  if not bool((out[~mask] == x[~mask]).all()):
    raise AssertionError(f'{label} {name}: B6 mask 0 where B1 output != x')
  if not bool(mask[out != x].all()):
    raise AssertionError(f'{label} {name}: B1 output != x where B6 mask 0')
  return max(e[0] for e in errs), max(e[1] for e in errs), flips


def _cnn_points(dtype, gen, bwd: bool, points) -> list:
  """Max abs error against the plain version at each (N, L) point, all
  four dilations (B6 with the mask checks), each call one launch of the
  kernel."""
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import cnn_layer as K
  name = str(dtype).split('.')[-1]
  counter = 'cnn_layer_bwd' if bwd else 'cnn_layer'
  res = []
  for n, l in points:
    args, ct = _cnn_inputs(n, l, dtype, gen)
    errs = []
    for d in (1, 4, 16, 64):
      label = f'{counter} N={n} L={l} d={d}'
      before = _build.LAUNCHES[counter]
      if bwd:
        errs.append(_cnn_bwd_against_plain(args, ct, d, name, label)[0])
      else:
        errs.append(compare(label, K.cnn_layer(*args, dilation=d),
                            K.cnn_layer_plain(*args, dilation=d), name)[0])
      if _build.LAUNCHES[counter] != before + 1:
        raise AssertionError(f'{label}: '
                             f'{_build.LAUNCHES[counter] - before} launches')
    res.append(max(errs))
    del args, ct
  return res


def _cnn_lengths(dtype, gen, bwd: bool) -> dict:
  """``_cnn_points`` at N = 8, L = 50 and the longest L: {L: error}."""
  lengths = (CNN_SHORT_L, cnn_longest(dtype))
  return dict(zip(map(str, lengths), _cnn_points(
      dtype, gen, bwd, [(CNN_SMALL_N, l) for l in lengths])))


def _cnn_train_rows(dtype, gen, bwd: bool) -> dict:
  """``_cnn_points`` at CNN_TRAIN_ROWS' row counts, L = 200: {N: error}."""
  rows = CNN_TRAIN_ROWS['cnn_layer_bwd' if bwd else 'cnn_layer']
  return dict(zip(map(str, rows), _cnn_points(
      dtype, gen, bwd, [(n, CNN_SHAPE[1]) for n in rows])))


def _cnn_rates(r: dict, dtype_name: str) -> dict:
  """The bound on the peak the kernel computes at (3xTF32, 495/3 TFLOP/s,
  in f32; bf16 989), the f32 FMA bound beside it, the achieved TFLOP/s
  and the share of each bound, from r's flops, bytes and ms."""
  peak = 'tf32x3' if dtype_name == 'float32' else dtype_name
  r['peak'] = peak
  r['bound_ms'], r['bound_by'] = bound(r['flops'], r['bytes'], peak)
  r['tflops'] = r['flops'] / r['ms'] / 1e9
  r['bound_share'] = r['bound_ms'] / r['ms']
  if dtype_name == 'float32':
    r['fma_bound_ms'] = bound(r['flops'], r['bytes'], 'float32')[0]
    r['fma_bound_share'] = r['fma_bound_ms'] / r['ms']
  return r


def _cnn_library_operands(args, d):
  """The conv's input (the normalised h) and weight in F.conv1d's layout."""
  from svdd_tpu_torch.ops import cnn_layer as K
  x, br, g, b, w, _ = args
  hn, _ = K._normalised(x, br, 1e-6)
  h = K._conv_input(hn, g, b, x.dtype).transpose(1, 2).contiguous()
  return h, w.permute(2, 1, 0).contiguous()


def check_cnn_layer(dtype, gen):
  """B1 at the guided-step shape (512, 200, 128), all four dilations,
  against the plain version, timed beside F.conv1d of the already
  normalised input at the same dilation and SAME padding (the conv alone,
  a yardstick; TF32 off in f32), then at N = 8 at L = 50 and the longest
  L a block holds, and again as at 512 rows at SVDD-PM's candidate
  forward, N = B*M = 5120 (``n5120``), and at pretraining's other row
  counts (CNN_TRAIN_ROWS, one launch each). ms, plain_ms and library_ms
  are one denoiser forward, the 20 layers, each layer's the card's time
  for a call (device_ms, every kernel the call launched); flops count
  the rows the live taps need (cnn_rows)."""
  r = _cnn_forward(CNN_SHAPE[0], dtype, gen)
  r['max_abs_err_by_length'] = _cnn_lengths(dtype, gen, bwd=False)
  r['n5120'] = _cnn_forward(CNN_PM_ROWS, dtype, gen)
  r['max_abs_err_train_rows'] = _cnn_train_rows(dtype, gen, bwd=False)
  return r


def _cnn_forward(n: int, dtype, gen, l: int = CNN_SHAPE[1]):
  """B1 against its plain version at (n, l, 128) (L = 200 by default),
  all four dilations, and the times of one 20-layer forward
  (``check_cnn_layer``), with the rates of ``_cnn_rates``."""
  import torch.nn.functional as F
  from svdd_tpu_torch.ops import cnn_layer as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  c = CNN_SHAPE[2]
  name = str(dtype).split('.')[-1]
  args, _ = _cnn_inputs(n, l, dtype, gen)
  res = {}
  for d in (1, 4, 16, 64):
    err, rel = compare(f'cnn_layer d={d}', K.cnn_layer(*args, dilation=d),
                       K.cnn_layer_plain(*args, dilation=d), name)
    ms = device_ms(lambda: K.cnn_layer(*args, dilation=d))
    plain = device_ms(lambda: K.cnn_layer_plain(*args, dilation=d))
    h, w_oik = _cnn_library_operands(args, d)
    lib = device_ms(lambda: F.conv1d(h, w_oik, padding=4 * d, dilation=d))
    res[d] = (err, rel, ms, plain, lib)
  es = args[0].element_size()
  flops = nbytes = 0
  for d, k in CNN_CALLS.items():
    kl = len(live_offsets(9, l, d))
    flops += k * 2 * n * cnn_rows(l, d) * c * c
    nbytes += k * ((2 * n * l * c + n * c + kl * c * c) * es + 3 * c * 4)
  total = lambda i: sum(CNN_CALLS[d] * r[i] for d, r in res.items())
  r = {'shape': [n, l, c], 'dilations': [1, 4, 16, 64],
       'flops': flops, 'bytes': nbytes,
       'max_abs_err': max(r[0] for r in res.values()),
       'max_rel_err': max(r[1] for r in res.values()),
       'ms': total(2), 'plain_ms': total(3), 'library_ms': total(4),
       'library': 'torch.nn.functional.conv1d of the normalised input, same '
                  'dilation and SAME padding: the conv alone, a yardstick',
       'per_dilation_ms': {str(d): r[2] for d, r in res.items()},
       'per_dilation_plain_ms': {str(d): r[3] for d, r in res.items()},
       'per_dilation_library_ms': {str(d): r[4] for d, r in res.items()}}
  del args
  return _cnn_rates(r, name)


# (B, M, L, V) points of B2 besides the step's shape: a row longer than
# a block's tile (1609 positions at V = 5), V = 12 (three Philox calls a draw),
# M = 300 (past the 256 threads), a row of one position
GUMBEL_POINTS = ((3, 4, 5000, 5), (4, 3, 40, 12), (2, 300, 7, 5),
                 (5, 2, 1, 4))
# the card's rates for B2's work, beside PEAK_FLOPS: per-SM results a
# clock of compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput: 16 for log2/exp2/rcp on the SFU, 64
# for 32-bit integer multiplies) times 132 SMs at the 1.98 GHz boost
# clock of the H100 SXM
SFU_OPS_PER_S = 16 * 132 * 1.98e9
IMUL_OPS_PER_S = 64 * 132 * 1.98e9
# Philox4x32-10: 10 rounds of two 32-bit multiplies, each as mul.hi and
# mul.lo; one call holds five 24-bit uniforms
PHILOX_IMULS, PHILOX_VALUES = 40, 5


def gumbel_bound(n_drawn: int, v: int, nbytes: float):
  """(ms, 'operations' | 'bytes', detail) of B2: the larger of its bytes
  over HBM's rate and its work, n_drawn masked draws of two logarithms
  a value on the SFU and ceil(v / 5) Philox calls on the integer
  multipliers (the two pipes run side by side)."""
  lg2 = n_drawn * 2 * v
  imul = n_drawn * -(-v // PHILOX_VALUES) * PHILOX_IMULS
  t = {'bytes': nbytes / HBM_BYTES_PER_S, 'sfu': lg2 / SFU_OPS_PER_S,
       'imul': imul / IMUL_OPS_PER_S}
  worst = max(t, key=t.get)
  return (t[worst] * 1e3, 'bytes' if worst == 'bytes' else 'operations',
          {'lg2': lg2, 'imul': imul, 'bytes': nbytes,
           **{f'{k}_ms': ms * 1e3 for k, ms in t.items()}})


def check_gumbel_candidates(gen):
  """B2 at (512, 200, 5), M=10, int64 tokens as the decode passes them:
  every draw equal to the plain version's on the noise the kernel used,
  frequencies vs softmax(log_q) by chi-square over 8 distinct rows,
  unmasked tokens copied exactly, the candidates in x's dtype (int32 too
  at a short point), exact at GUMBEL_POINTS too; a generator on another
  device and a mask index
  outside [0, V] refused before any launch. Bound: the bytes and the
  work of this run's masked positions (``gumbel_bound``)."""
  import numpy as np
  import torch
  from scipy import stats as sps
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import fused_sample as K
  from svdd_tpu_torch.mdlm import gumbel_noise
  b, l, v, m, mask = 512, 200, 5, 10, 4
  table = torch.log_softmax(
      2 * torch.randn(8, v, device='cuda', generator=gen), -1)
  cls = (torch.arange(b * l, device='cuda') % 8).reshape(b, l)
  log_q = table[cls].contiguous()
  x = torch.randint(0, 4, (b, l), device='cuda', generator=gen)
  x = torch.where(torch.rand(b, l, device='cuda', generator=gen) < 0.5,
                  mask, x)
  out, noise = K.gumbel_candidates(log_q, x, m, mask, gen,
                                   return_noise=True)
  if out.dtype != x.dtype:
    raise AssertionError(f'gumbel_candidates: {out.dtype} out of {x.dtype}')
  # each draw against the plain version on the kernel's own noise: exact
  err = int((out - K.gumbel_candidates_plain(log_q, x, noise, mask))
            .abs().max())
  if err:
    raise AssertionError(f'gumbel_candidates: draws differ from the plain '
                         f'version on the same noise (max abs err {err})')
  keep = (x != mask)[:, None].expand(-1, m, -1)
  if not torch.equal(out[keep], x[:, None].expand(-1, m, -1)[keep]):
    raise AssertionError('gumbel_candidates: unmasked tokens not copied')
  drawn = ~keep
  cls_m = cls[:, None].expand(-1, m, -1)[drawn].cpu().numpy()
  tok = out[drawn].cpu().numpy()
  p = torch.softmax(table.double(), -1).cpu().numpy()
  worst_p, max_dev = 1.0, 0.0
  for k in range(8):
    counts = np.bincount(tok[cls_m == k], minlength=v)
    total = counts.sum()
    pval = sps.chisquare(counts, total * p[k] / p[k].sum()).pvalue
    worst_p = min(worst_p, float(pval))
    max_dev = max(max_dev, float(np.abs(counts / total - p[k]).max()))
  if worst_p < 1e-4:
    raise AssertionError(f'gumbel_candidates: chi-square p {worst_p}')
  # int32 tokens: int32 candidates, exact on the kernel's noise
  x32 = x[:8].to(torch.int32)
  o32, n32 = K.gumbel_candidates(log_q[:8], x32, m, mask, gen,
                                 return_noise=True)
  if o32.dtype != torch.int32 or not torch.equal(
      o32, K.gumbel_candidates_plain(log_q[:8], x32, n32, mask)):
    raise AssertionError('gumbel_candidates: int32 tokens')
  # GUMBEL_POINTS: rows split over blocks, V past one Philox call, M past
  # the block's threads; exact on the kernel's noise, a launch each
  for pb, pm, pl, pv in GUMBEL_POINTS:
    lq = torch.log_softmax(torch.randn(pb, pl, pv, device='cuda',
                                       generator=gen), -1)
    xp = torch.randint(0, pv, (pb, pl), device='cuda', generator=gen)
    xp = torch.where(torch.rand(pb, pl, device='cuda', generator=gen) < 0.5,
                     pv - 1, xp)
    before = _build.LAUNCHES['gumbel_candidates']
    op, npt = K.gumbel_candidates(lq, xp, pm, pv - 1, gen,
                                  return_noise=True)
    if (_build.LAUNCHES['gumbel_candidates'] != before + 1
        or not torch.equal(op, K.gumbel_candidates_plain(lq, xp, npt,
                                                         pv - 1))):
      raise AssertionError(f'gumbel_candidates {(pb, pm, pl, pv)}: draws '
                           'differ from the plain version on their noise')
  before = _build.LAUNCHES['gumbel_candidates']
  for bad in (dict(generator=torch.Generator().manual_seed(0)),
              dict(mask_index=v + 1)):
    kw = {'mask_index': mask, 'generator': gen, **bad}
    try:
      K.gumbel_candidates(log_q, x, m, kw['mask_index'], kw['generator'])
    except ValueError:
      continue
    raise AssertionError(f'gumbel_candidates: {sorted(bad)} not refused')
  if _build.LAUNCHES['gumbel_candidates'] != before:
    raise AssertionError('gumbel_candidates: a refused call launched')

  def plain():
    noise = gumbel_noise((b, m, l, v), gen, 'cuda')
    return K.gumbel_candidates_plain(log_q, x, noise, mask)
  es = x.element_size()
  nbytes = b * l * v * 4 + b * l * es + b * m * l * es
  n_drawn = int(drawn.sum())
  bound_ms, bound_by, work = gumbel_bound(n_drawn, v, nbytes)
  return {'shape': [b, m, l, v], 'index_dtype': str(x.dtype).split('.')[-1],
          'points': [list(pt) for pt in GUMBEL_POINTS],
          'max_abs_err': err, 'chi2_min_p': worst_p,
          'max_freq_dev': max_dev, 'masked_draws': n_drawn,
          **timed(lambda: K.gumbel_candidates(log_q, x, m, mask, gen),
                  plain),
          'bound_ms': bound_ms, 'bound_by': bound_by, 'work': work}


# (L, C) of the six fused pools and the last one of the full tower
POOL_SHAPES = [(200, 768), (100, 768), (50, 896), (25, 1024), (13, 1152),
               (7, 1280)]
LAST_POOL = (4, 1536)
N_CAND = 5120
# B3 and B4 are also held at short points: (N, L, C, residual): one
# pooled row (L = 1, the tail alone), odd tails with the residual, three
# and five column tiles, 264 rows (three row tiles, the last partial),
# and N = 6 (off the JAX dispatchers' N % 8: the kernels take it)
POOL_POINTS = [(8, 1, 128, False), (8, 3, 256, True), (8, 7, 384, True),
               (8, 65, 640, True), (6, 8, 128, True)]
# the row counts besides B*M = 5120 at which a decode runs the value net's
# or the oracle's tower: B = 512 (TDS's oracle scores its particles) and
# B*4 = 2048 (the first phase of the scheduled-M SVDD-MC decode). B3 at
# the six fused pools, B4 at the last pool and B5 at the value net's heads
# are held at both, one launch a point
PATH_ROWS = (512, 2048)
# the rows of one bin's forward in cli.train --model multienformer at
# --batch_size 8: 128 // 10 = 12 states of 8 trajectories
# (run_multisep_train checks it). B3 at the six fused pools, B4 at the
# last pool, B5 at the value net's heads and B8 at the last pool's
# backward are held and timed there (``multisep_rows``)
MULTISEP_ROWS = 96


def _pool_inputs(l, c, dtype, gen, n=N_CAND):
  import torch
  x = torch.randn(n, l, c, device='cuda', generator=gen).to(dtype)
  res = torch.randn(n, l, c, device='cuda', generator=gen).to(dtype)
  w = (2 * torch.eye(c, device='cuda') + torch.randn(
      c, c, device='cuda', generator=gen) / c ** 0.5).to(dtype)
  return x, res, w


def _pool_args(l, c, dtype, gen, n=N_CAND, residual=True):
  """Operands of pool_prologue_im2col_wlogits: x, W, the BN affine, k=5,
  gelu_enformer, the residual."""
  import torch
  x, res, w = _pool_inputs(l, c, dtype, gen, n)
  scale = 1 + 0.2 * torch.randn(c, device='cuda', generator=gen)
  shift = 0.2 * torch.randn(c, device='cuda', generator=gen)
  return (x, w, scale, shift, 5, 'gelu_enformer', res if residual else None)


def _pool_bytes(n, l, c, es, k_live=None):
  """x and the residual read once, W read once, and the pooled rows (B4)
  or the k_live im2col slabs and the affine (B3) written or read once."""
  lh = (l + 1) // 2
  if k_live is None:
    return (2 * n * l * c + n * lh * c + c * c) * es
  return (2 * n * l * c + c * c + n * lh * k_live * c) * es + 2 * c * 4


def _pool_points(dtype, im2col: bool, points=POOL_POINTS) -> dict:
  """(N, L, C, residual) points through the wrapper on the card, each
  one launch, against the plain version: {label: max abs err}."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  gen = torch.Generator('cuda').manual_seed(8)
  counter = 'attn_pool_prologue_im2col' if im2col else 'attn_pool'
  errs = {}
  for n, l, c, residual in points:
    args = _pool_args(l, c, dtype, gen, n=n, residual=residual)
    label = f'N={n} L={l} C={c}{" residual" if residual else ""}'
    before = _build.LAUNCHES[counter]
    if im2col:
      got = K.pool_prologue_im2col_wlogits(*args)
      want = K.pool_prologue_im2col_wlogits_plain(*args)
    else:
      x, w, res = args[0], args[1], args[-1]
      got, want = K.attn_pool(x, w, res), K.attn_pool_plain(x, w, res)
    if _build.LAUNCHES[counter] != before + 1:
      raise AssertionError(f'{counter} {label}: no launch')
    errs[label] = compare(f'{counter} {label}', got, want, name)[0]
    del args, got, want
  torch.cuda.empty_cache()
  return errs


def _pool_im2col_tower(n, dtype, gen, reps: int = 5, iters: int = 3):
  """B3 at the six fused pools of one value forward at N = n, each one
  launch against the plain version and timed by the card's own time for
  a call (device_ms, the profiler: the kernel and the wrapper's
  transpose of W) and by CUDA events (median_ms); ms is the six pools,
  device time; achieved_tb_s the bytes they must move over it."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_pool as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  errs, per_pool, flops, nbytes = [], [], 0, 0
  for l, c in POOL_SHAPES:
    args = _pool_args(l, c, dtype, gen, n=n)
    lh = (l + 1) // 2
    flops += 2 * n * lh * c * c
    nbytes += _pool_bytes(n, l, c, args[0].element_size(),
                          len(live_offsets(5, lh)))
    before = _build.LAUNCHES['attn_pool_prologue_im2col']
    got = K.pool_prologue_im2col_wlogits(*args)
    if _build.LAUNCHES['attn_pool_prologue_im2col'] != before + 1:
      raise AssertionError(f'attn_pool_prologue_im2col N={n} L={l}: '
                           'no launch')
    want = K.pool_prologue_im2col_wlogits_plain(*args)
    errs.append(compare(f'attn_pool_prologue_im2col N={n} L={l} C={c}',
                        got, want, name))
    del got, want
    call = lambda: K.pool_prologue_im2col_wlogits(*args)
    per_pool.append({
        'shape': [n, l, c], 'ms': device_ms(call, reps=reps),
        'median_ms': median_ms(call, iters=iters),
        'plain_ms': median_ms(
            lambda: K.pool_prologue_im2col_wlogits_plain(*args),
            iters=iters)})
    del args
    torch.cuda.empty_cache()
  total = lambda k: sum(p[k] for p in per_pool)
  r = {'shapes': [p['shape'] for p in per_pool],
       'max_abs_err': max(e[0] for e in errs),
       'max_rel_err': max(e[1] for e in errs),
       'ms': total('ms'),
       'median_ms': total('median_ms'), 'plain_ms': total('plain_ms'),
       'library_ms': None, 'per_pool': per_pool, 'flops': flops,
       'bytes': nbytes, 'achieved_tb_s': nbytes / total('ms') / 1e9}
  return _cnn_rates(r, name)


def check_attn_pool_im2col(dtype, gen):
  """B3 at the six fused pools of one value forward (B*M = 5120,
  ``_pool_im2col_tower``); then at POOL_POINTS, at the six pools at
  PATH_ROWS, and at MULTISEP_ROWS, timed (``multisep_rows``)."""
  name = str(dtype).split('.')[-1]
  r = _pool_im2col_tower(N_CAND, dtype, gen)
  r.update(max_abs_err_points=_pool_points(dtype, True),
           max_abs_err_path_rows=_pool_points(
               dtype, True, [(n, l, c, True) for n in PATH_ROWS
                             for l, c in POOL_SHAPES]),
           multisep_rows=_train_rows_entry(_pool_im2col_tower(
               MULTISEP_ROWS, dtype, gen, reps=10, iters=10)))
  return r


def _attn_pool_at(n, shapes, dtype, gen):
  """B4 with its residual at each (L, C) of shapes at N = n, against the
  plain version (one launch each): errors, and ms (device), median_ms,
  plain_ms, flops and bytes summed over the shapes."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  errs, r = [], {'ms': 0.0, 'median_ms': 0.0, 'plain_ms': 0.0, 'flops': 0,
                 'bytes': 0}
  for l, c in shapes:
    x, res, w = _pool_inputs(l, c, dtype, gen, n)
    before = _build.LAUNCHES['attn_pool']
    got = K.attn_pool(x, w, res)
    if _build.LAUNCHES['attn_pool'] != before + 1:
      raise AssertionError(f'attn_pool N={n} L={l}: no launch')
    errs.append(compare(f'attn_pool N={n} L={l} C={c}', got,
                        K.attn_pool_plain(x, w, res), name))
    del got
    call = lambda: K.attn_pool(x, w, res)
    r['ms'] += device_ms(call)
    r['median_ms'] += median_ms(call, iters=10)
    r['plain_ms'] += median_ms(lambda: K.attn_pool_plain(x, w, res), iters=10)
    r['flops'] += 2 * n * ((l + 1) // 2) * c * c
    r['bytes'] += _pool_bytes(n, l, c, x.element_size())
    del x, res, w
    torch.cuda.empty_cache()
  r.update(max_abs_err=max(e[0] for e in errs),
           max_rel_err=max(e[1] for e in errs))
  return r


def check_attn_pool(dtype, gen):
  """B4 at the last tower pool (5120, 4, 1536) with its residual, timed
  by the card's own time for a call (device_ms) and by CUDA events
  (median_ms); then at the seven tower pools of the classifier's gradient
  tower at N = 512 (classifier_pools), at POOL_POINTS, at the last
  pool at PATH_ROWS, and at the last pool at MULTISEP_ROWS, timed
  (``multisep_rows``)."""
  name = str(dtype).split('.')[-1]
  r = _attn_pool_at(N_CAND, [LAST_POOL], dtype, gen)
  r.update(shape=[N_CAND, *LAST_POOL], library_ms=None,
           max_abs_err_points=_pool_points(dtype, False),
           max_abs_err_path_rows=_pool_points(
               dtype, False, [(n, *LAST_POOL, True) for n in PATH_ROWS]))
  r = _cnn_rates(r, name)
  r['multisep_rows'] = {'shape': [MULTISEP_ROWS, *LAST_POOL],
                        **_train_rows_entry(_cnn_rates(_attn_pool_at(
                            MULTISEP_ROWS, [LAST_POOL], dtype, gen), name))}
  cls = _cnn_rates(_attn_pool_at(N_GRAD, TOWER_POOLS, dtype, gen), name)
  r['classifier_pools'] = {
      'shapes': [[N_GRAD, l, c] for l, c in TOWER_POOLS],
      **{k: cls[k] for k in ('max_abs_err', 'ms', 'median_ms', 'plain_ms',
                             'flops', 'bytes', 'bound_ms', 'bound_by',
                             'tflops', 'bound_share', 'fma_bound_ms')
         if k in cls}}
  return r


# B5's heads at the value net's widths: 8 heads, dk 64, dv 192. It is also
# held at points of one launch each: N = 6 (off JAX's N % 8), 6 heads
# (groups of 4 lanes, 8 lanes idle), 64 heads of dk = dv = 2 (two passes
# of a lane a head; 8-byte loads in f32, 4-byte in bf16) and 128 heads of
# dk 1, dv 3 (one element a load): (N, heads, dk, dv)
ATTN_L2_HEADS = (8, 64, 192)
ATTN_L2_POINTS = ((6, 8, 64, 192), (6, 6, 64, 64), (6, 64, 2, 2),
                  (6, 128, 1, 3))


def _attn_l2_args(n, h, dk, dv, dtype, gen):
  import torch
  r = lambda *s: torch.randn(*s, device='cuda', generator=gen)
  return ((r(n, 2, h * dk) / 8).to(dtype), r(n, 2, h * dk).to(dtype),
          r(n, 2, h * dv).to(dtype), r(h * dk).to(dtype), r(h * dk).to(dtype),
          r(3, h * dk).to(dtype), h)


def _attn_l2_plain(args):
  """B5's plain version with the relk rounding JAX's dispatch takes at
  the shape (``attn_l2_body_rounds``)."""
  from svdd_tpu_torch.ops import attn_l2 as K
  q, _, v, *_, h = args
  return K.attn_l2_plain(*args, round_relk=K.attn_l2_body_rounds(
      q.shape[0], q.shape[-1], v.shape[-1]))


def _attn_l2_at(n, dtype, gen):
  """B5 at (n, 2, 8 heads x (64 | 192)) against the plain version, timed
  (one of the 11 calls of a value forward). On JAX's gate (these widths,
  N % 8 == 0) the kernel rounds the relk differences as the Pallas body
  does; ``relk_rounding_w_diff``: how far the plain version without that
  rounding (the jnp reference's form) lies from the kernel's w."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_l2 as K
  name = str(dtype).split('.')[-1]
  h, dk, dv = ATTN_L2_HEADS
  args = _attn_l2_args(n, h, dk, dv, dtype, gen)
  before = _build.LAUNCHES['attn_l2']
  out, w = K.attn_l2(*args)
  if _build.LAUNCHES['attn_l2'] != before + 1:
    raise AssertionError(f'attn_l2 N={n}: no launch')
  out_p, w_p = _attn_l2_plain(args)
  ref_w = K.attn_l2_plain(*args, round_relk=False)[1]
  errs = (compare('attn_l2 out', out, out_p, name),
          compare('attn_l2 w', w, w_p, 'float32'
                  if dtype == torch.float32 else name))
  es = args[0].element_size()
  return {'shape': [n, 2, h * dk, h * dv],
          'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          'round_relk': K.attn_l2_body_rounds(n, h * dk, h * dv),
          'relk_rounding_w_diff': float((w - ref_w).abs().max()),
          # per query: two logit terms per dk lane, a blend per dv lane
          'flops': n * 2 * h * (6 * dk + 3 * dv),
          # q, k, v read once, the bias rows once, out and w written once
          'bytes': (n * 2 * h * (2 * dk + 2 * dv) + 5 * h * dk) * es
                   + n * 2 * h * 4,
          **timed(lambda: K.attn_l2(*args), lambda: _attn_l2_plain(args),
                  reps=20, iters=20)}


def check_attn_l2(dtype, gen):
  """B5 at SVDD-MC's N = B*M = 5120, then at the classifier's N = 512
  (classifier_n512), each timed by the card's own time for a call; then
  at MULTISEP_ROWS, timed (``multisep_rows``); then at ATTN_L2_POINTS
  and at the value net's heads at PATH_ROWS (one launch each)."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_l2 as K
  name = str(dtype).split('.')[-1]
  r = _attn_l2_at(N_CAND, dtype, gen)
  small = _attn_l2_at(N_GRAD, dtype, gen)
  small['bound_ms'], small['bound_by'] = bound(small['flops'], small['bytes'],
                                               name)
  small['bound_share'] = small['bound_ms'] / small['ms']
  r['classifier_n512'] = small
  rows = _attn_l2_at(MULTISEP_ROWS, dtype, gen)
  rows['bound_ms'], rows['bound_by'] = bound(rows['flops'], rows['bytes'],
                                             name)
  rows['bound_share'] = rows['bound_ms'] / rows['ms']
  r['multisep_rows'] = _train_rows_entry(rows)
  r['max_abs_err_points'] = {}
  for point in ATTN_L2_POINTS + tuple((n, *ATTN_L2_HEADS)
                                      for n in PATH_ROWS):
    args = _attn_l2_args(*point, dtype, gen)
    before = _build.LAUNCHES['attn_l2']
    got, want = K.attn_l2(*args), _attn_l2_plain(args)
    if _build.LAUNCHES['attn_l2'] != before + 1:
      raise AssertionError(f'attn_l2 {point}: no launch')
    r['max_abs_err_points'][str(point)] = max(
        compare(f'attn_l2 {point} out', got[0], want[0], name)[0],
        compare(f'attn_l2 {point} w', got[1], want[1], 'float32'
                if dtype == torch.float32 else name)[0])
  return r


def check_cnn_layer_bwd(dtype, gen):
  """B6 at the DPS shape (512, 200, 128), all four dilations, against the
  plain version on the relu mask the kernel reports, with the mask checks
  of _cnn_bwd_against_plain (bit for bit against B1); timed beside
  aten.convolution_backward of B1's conv for its input and weight
  gradients (a yardstick; TF32 off in f32); then at N = 8 at L = 50 and
  the longest L a block holds, and at pretraining's microbatch
  (CNN_TRAIN_ROWS, one launch each). ms is one backward of the 20
  layers, each layer's the card's time for a call (device_ms)."""
  r = _cnn_backward(*CNN_SHAPE[:2], dtype, gen)
  r['max_abs_err_by_length'] = _cnn_lengths(dtype, gen, bwd=True)
  r['max_abs_err_train_rows'] = _cnn_train_rows(dtype, gen, bwd=True)
  return r


def _cnn_backward(n: int, l: int, dtype, gen):
  """B6 against its plain version at (n, l, 128), all four dilations, on
  the kernel's relu mask with ``_cnn_bwd_against_plain``'s checks, and
  the times of one 20-layer backward (``check_cnn_layer_bwd``), with the
  rates of ``_cnn_rates``."""
  import torch
  from svdd_tpu_torch.ops import cnn_layer as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  c = CNN_SHAPE[2]
  name = str(dtype).split('.')[-1]
  args, ct = _cnn_inputs(n, l, dtype, gen)
  res, flips, flops, nbytes = {}, 0, 0, 0
  es = args[0].element_size()
  ct_ncl = ct.transpose(1, 2).contiguous()
  for d in (1, 4, 16, 64):
    err, rel, fl = _cnn_bwd_against_plain(args, ct, d, name,
                                          f'cnn_layer_bwd d={d}')
    flips += fl
    ms = device_ms(lambda: K.cnn_layer_bwd(*args, ct, dilation=d))
    plain = device_ms(lambda: K.cnn_layer_bwd_plain(*args, ct, dilation=d),
                      reps=2)
    h, w_oik = _cnn_library_operands(args, d)
    lib = device_ms(lambda: torch.ops.aten.convolution_backward(
        ct_ncl, h, w_oik, None, [1], [4 * d], [d], False, [0], 1,
        [True, True, False]))
    del h, w_oik
    res[d] = (err, rel, ms, plain, lib)
    kl = len(live_offsets(9, l, d))
    # recompute, dgrad and wgrad; x, ct in, dx out, the weights in and
    # their gradient out, bias_row in and its gradient out
    flops += CNN_CALLS[d] * 3 * 2 * n * cnn_rows(l, d) * c * c
    nbytes += CNN_CALLS[d] * (3 * n * l * c * es + kl * c * c * (es + 4)
                              + n * c * (es + 4))
    torch.cuda.empty_cache()
  total = lambda i: sum(CNN_CALLS[d] * r[i] for d, r in res.items())
  r = {'shape': [n, l, c], 'dilations': [1, 4, 16, 64],
       'max_abs_err': max(r_[0] for r_ in res.values()),
       'max_rel_err': max(r_[1] for r_ in res.values()),
       'mask_flips': flips, 'mask_bitwise': True,
       # ms: one backward of the 20 layers of the denoiser
       'ms': total(2), 'plain_ms': total(3), 'library_ms': total(4),
       'library': 'torch.ops.aten.convolution_backward of the conv alone '
                  '(input and weight gradients), a yardstick',
       'per_dilation_ms': {str(d): r_[2] for d, r_ in res.items()},
       'per_dilation_plain_ms': {str(d): r_[3] for d, r_ in res.items()},
       'per_dilation_library_ms': {str(d): r_[4] for d, r_ in res.items()},
       'flops': flops, 'bytes': nbytes,
       'rounds_as_reference': K.bwd_rounds_as_reference(l)}
  return _cnn_rates(r, name)


def check_cnn_layer_past_limit():
  """cnn_layer and its gradients in every input at one row past the
  longest f32 sequence a block holds, N = 2, dilation 4: on the card
  (the plain versions, as svdd_tpu takes cnn_layer_reference where its
  kernel's memory plan does not fit) against the CPU, with no launch of
  B1 or B6. The CPU's backward runs on the card's relu mask; where that
  differs from the CPU's own, the CPU's conv output must lie within
  MASK_EDGE of 0."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import cnn_layer as K
  n, l, c, d = 2, cnn_longest(torch.float32) + 1, CNN_SHAPE[2], 4
  rs = np.random.default_rng(l)
  cpu = [torch.from_numpy(a.astype(np.float32)) for a in (
      rs.normal(size=(n, l, c)), rs.normal(size=(n, c)),
      1 + 0.1 * rs.normal(size=c), 0.1 * rs.normal(size=c),
      rs.normal(size=(9, c, c)) / (9 * c) ** 0.5, 0.1 * rs.normal(size=c))]
  ct = torch.from_numpy(rs.normal(size=(n, l, c)).astype(np.float32))
  card = [t.cuda().requires_grad_() for t in cpu]
  _build.reset_launches()
  out = K.cnn_layer(*card, dilation=d)
  got = [out.detach(), *torch.autograd.grad(out, card, ct.cuda())]
  with torch.no_grad():
    mask = (K.relu_input_plain(*card, dilation=d) > 0).cpu()
  torch.cuda.synchronize()
  launched = _build.launches()
  if launched['cnn_layer'] or launched['cnn_layer_bwd']:
    raise AssertionError(f'L={l} launched a kernel: {launched}')
  y = K.relu_input_plain(*cpu, dilation=d)
  differ = mask != (y > 0)
  if differ.any() and float(y[differ].abs().max()) > MASK_EDGE['float32']:
    raise AssertionError(f'L={l}: the card relu mask differs where |y| = '
                         f'{float(y[differ].abs().max())}')
  want = [K.cnn_layer_plain(*cpu, dilation=d),
          *K.cnn_layer_bwd_plain(*cpu, ct, dilation=d, mask=mask)]
  names = ('out', 'dx', 'dbias_row', 'dln_scale', 'dln_bias', 'dkernel',
           'dconv_bias')
  errs = {nm: _card_vs_cpu(f'cnn_layer L={l} {nm}', a.cpu(), b)[0]
          for nm, a, b in zip(names, got, want)}
  return {'shape': [n, l, c], 'dilation': d, 'launches': 0,
          'mask_flips': int(differ.sum()), 'max_abs_err': errs}


# (L, Cin, Cout) of the six k=5 tower convs at L=200, and the (L, C) of
# the seven tower pools; the guided decoders take their gradients at
# N = B = 512
TOWER_CONVS = [(100, 768, 768), (50, 768, 896), (25, 896, 1024),
               (13, 1024, 1152), (7, 1152, 1280), (4, 1280, 1536)]
TOWER_POOLS = [(200, 768)] + POOL_SHAPES[1:] + [LAST_POOL]
N_GRAD = 512


# B7 is also held at N = 8 at the first and last tower convs, and at a
# dilated conv whose outer taps are dead (L = 8, dilation 4: offsets -4,
# 0, 4 live, +-8 dead): (N, L, Cin, Cout, dilation)
CONV_BWD_POINTS = [(8, 100, 768, 768, 1), (8, 4, 1280, 1536, 1),
                   (8, 8, 128, 128, 4)]


def _conv_bwd_inputs(n, l, cin, cout, dtype, gen):
  import torch
  r = lambda *s: torch.randn(*s, device='cuda', generator=gen)
  return (r(n, l, cin).to(dtype), (r(5, cin, cout) / (5 * cin) ** 0.5).to(dtype),
          r(n, l, cout).to(dtype))


def _conv_bwd_against_plain(x, w, ct, d, name, label):
  from svdd_tpu_torch.ops import conv1d as K
  dx, dw = K.conv1d_bwd(x, w, ct, d)
  want_dx, want_dw = K.conv1d_bwd_plain(x, w, ct, d)
  return [compare(f'{label} dx', dx, want_dx, name),
          compare_sum(f'{label} dkernel', dw, want_dw, name)]


# the rows the value-net trainers' grad steps give B7 and B8: an MC (or
# CD-Q) step at --batch_size 8 regresses 128 x 8 states, the oracle
# trainer's step 64 sequences
VALUE_TRAIN_ROWS = (1024, 64)


def _conv_bwd_tower(n, dtype, gen):
  """B7 at the six k=5 tower convs at N rows against the plain version,
  dx and dkernel, each conv timed by the card's own time for a call
  (device_ms, the profiler: the kernels and the wrapper's copies) and by
  CUDA events around it (median_ms), beside aten.convolution_backward
  (dgrad and wgrad in one call; TF32 off in f32). ms is the six convs of
  one value-net backward, device time; flops count the live rows
  (live_rows)."""
  import torch
  from svdd_tpu_torch.ops import conv1d as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  errs, per_conv, flops, nbytes = [], [], 0, 0
  for l, cin, cout in TOWER_CONVS:
    x, w, ct = _conv_bwd_inputs(n, l, cin, cout, dtype, gen)
    errs += _conv_bwd_against_plain(x, w, ct, 1, name, f'conv1d_bwd L={l} {cin}->{cout}')
    x_ncl, ct_ncl = x.transpose(1, 2).contiguous(), ct.transpose(1, 2).contiguous()
    w_oik = w.permute(2, 1, 0).contiguous()
    library = lambda: torch.ops.aten.convolution_backward(
        ct_ncl, x_ncl, w_oik, None, [1], [2], [1], False, [0], 1,
        [True, True, False])
    es = x.element_size()
    k_live = len(live_offsets(5, l))
    fl = 2 * 2 * n * live_rows(l) * cin * cout
    flops += fl
    nbytes += (2 * n * l * cin + n * l * cout) * es + k_live * cin * cout * (es + 4)
    ms = device_ms(lambda: K.conv1d_bwd(x, w, ct))
    per_conv.append({'shape': [n, l, cin, cout], 'ms': ms,
                     'median_ms': median_ms(lambda: K.conv1d_bwd(x, w, ct)),
                     'plain_ms': median_ms(lambda: K.conv1d_bwd_plain(x, w, ct),
                                           iters=3),
                     'library_ms': median_ms(library),
                     'tflops': fl / ms / 1e9})
    del x, ct, w, x_ncl, ct_ncl, w_oik
    torch.cuda.empty_cache()
  total = lambda k: sum(c[k] for c in per_conv)
  r = {'shapes': [c['shape'] for c in per_conv],
       'max_abs_err': max(e[0] for e in errs),
       'max_rel_err': max(e[1] for e in errs),
       'max_abs_err_dx': max(e[0] for e in errs[0::2]),
       'max_abs_err_dkernel': max(e[0] for e in errs[1::2]),
       # the six tower convs of one value-net backward
       'ms': total('ms'),
       'median_ms': total('median_ms'), 'plain_ms': total('plain_ms'),
       'library_ms': total('library_ms'),
       'library': 'torch.ops.aten.convolution_backward',
       'per_conv': per_conv, 'flops': flops, 'bytes': nbytes}
  return _cnn_rates(r, name)


def _train_rows_entry(r: dict) -> dict:
  """A point at a trainer's rows as the kernels line keeps it."""
  return {k: r[k] for k in ('shape', 'shapes', 'max_abs_err',
                            'max_abs_err_dx',
                            'max_abs_err_dkernel', 'max_abs_err_dW', 'ms',
                            'median_ms', 'plain_ms', 'library_ms',
                            'bound_ms', 'bound_by', 'peak', 'tflops',
                            'bound_share') if k in r}


def check_conv1d_bwd(dtype, gen):
  """B7 at the six tower convs at the guided decoders' N = 512
  (``_conv_bwd_tower``), then at the value-net trainers' rows
  (VALUE_TRAIN_ROWS, ``train_rows``) and at CONV_BWD_POINTS."""
  name = str(dtype).split('.')[-1]
  r = _conv_bwd_tower(N_GRAD, dtype, gen)
  r['train_rows'] = {str(n): _train_rows_entry(_conv_bwd_tower(n, dtype, gen))
                     for n in VALUE_TRAIN_ROWS}
  points = {}
  for n_, l, cin, cout, d in CONV_BWD_POINTS:
    x, w, ct = _conv_bwd_inputs(n_, l, cin, cout, dtype, gen)
    label = f'conv1d_bwd N={n_} L={l} {cin}->{cout} d={d}'
    dx_err, dw_err = _conv_bwd_against_plain(x, w, ct, d, name, label)
    points[label] = {'dx': dx_err[0], 'dkernel': dw_err[0]}
  r['max_abs_err_points'] = points
  return r


# B8 is also held at short points, (N, L, C, residual): N = 6 (off the
# JAX dispatchers' N % 8), one pooled row (L = 1, the tail alone), odd
# tails, one and three column tiles, and 264 rows (8 x 33: three row
# tiles, the last partial; the shorter points are one partial tile)
POOL_BWD_POINTS = [(6, 1, 128, False), (6, 3, 384, True), (6, 7, 128, True),
                   (6, 7, 384, False), (8, 65, 256, True)]


def _pool_bwd_inputs(n, l, c, dtype, gen):
  """x, W (near 2 I, as the module initialises it), the cotangent and the
  residual of one pool."""
  import torch
  x, res, w = _pool_inputs(l, c, dtype, gen, n)
  ct = torch.randn(n, (l + 1) // 2, c, device='cuda', generator=gen).to(dtype)
  return x, w, ct, res


def _pool_bwd_against_plain(args, name, label):
  """B8's dx (within TOL) and dW (within RED_TOL of its largest value)
  against the plain version."""
  from svdd_tpu_torch.ops import attn_pool as K
  dx, dw = K.attn_pool_bwd(*args)
  want_dx, want_dw = K.attn_pool_bwd_plain(*args)
  return [compare(f'{label} dx', dx, want_dx, name),
          compare_sum(f'{label} dW', dw, want_dw, name)]


def _pool_bwd_points(dtype) -> dict:
  """POOL_BWD_POINTS through the wrapper on the card, each one launch,
  against the plain version: {label: {dx, dW: max abs err}}."""
  import torch
  from svdd_tpu_torch import _build
  name = str(dtype).split('.')[-1]
  gen = torch.Generator('cuda').manual_seed(12)
  points = {}
  for n, l, c, residual in POOL_BWD_POINTS:
    x, w, ct, res = _pool_bwd_inputs(n, l, c, dtype, gen)
    label = f'attn_pool_bwd N={n} L={l} C={c}{" residual" if residual else ""}'
    before = _build.LAUNCHES['attn_pool_bwd']
    dx_err, dw_err = _pool_bwd_against_plain(
        (x, w, ct, res if residual else None), name, label)
    if _build.LAUNCHES['attn_pool_bwd'] != before + 1:
      raise AssertionError(f'{label}: no launch')
    points[label[len('attn_pool_bwd '):]] = {'dx': dx_err[0], 'dW': dw_err[0]}
  return points


def _pool_bwd_tower(n, dtype, gen, shapes=TOWER_POOLS):
  """B8 at the seven tower pools with their residuals (odd lengths 25,
  13 and 7 among them), or at ``shapes``, at N rows, against the plain
  version, dx and dW (one launch each), each timed by the card's own
  time for a call (device_ms) and by CUDA events (median_ms); ms is the
  pools of one value-net backward, device time."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  errs, per_pool, flops, nbytes = [], [], 0, 0
  for l, c in shapes:
    lh = (l + 1) // 2
    x, w, ct, res = _pool_bwd_inputs(n, l, c, dtype, gen)
    before = _build.LAUNCHES['attn_pool_bwd']
    errs += _pool_bwd_against_plain((x, w, ct, res), name,
                                    f'attn_pool_bwd N={n} L={l} C={c}')
    if _build.LAUNCHES['attn_pool_bwd'] != before + 1:
      raise AssertionError(f'attn_pool_bwd N={n} L={l}: no launch')
    per_pool.append({'shape': [n, l, c], **timed(
        lambda: K.attn_pool_bwd(x, w, ct, res),
        lambda: K.attn_pool_bwd_plain(x, w, ct, res), reps=5, iters=5)})
    es = x.element_size()
    # the logits recomputed, the dgrad and the wgrad; x, residual, ct and
    # W in, dx and dW out
    flops += 3 * 2 * n * lh * c * c
    nbytes += (3 * n * l * c + n * lh * c + c * c) * es + c * c * 4
    del x, res, w, ct
    torch.cuda.empty_cache()
  total = lambda k: sum(p[k] for p in per_pool)
  r = {'shapes': [p['shape'] for p in per_pool],
       'max_abs_err': max(e[0] for e in errs),
       'max_rel_err': max(e[1] for e in errs),
       'max_abs_err_dx': max(e[0] for e in errs[0::2]),
       'max_abs_err_dW': max(e[0] for e in errs[1::2]),
       # the seven pools of one value-net backward
       'ms': total('ms'),
       'median_ms': total('median_ms'), 'plain_ms': total('plain_ms'),
       'plain_median_ms': total('plain_median_ms'), 'library_ms': None,
       'per_pool': per_pool, 'flops': flops, 'bytes': nbytes}
  return _cnn_rates(r, name)


def check_attn_pool_bwd(dtype, gen):
  """B8 at the seven tower pools at the classifier's N = 512
  (``_pool_bwd_tower``), then at the value-net trainers' rows
  (VALUE_TRAIN_ROWS, ``train_rows``), at the multisep trainer's last
  pool (MULTISEP_ROWS, ``multisep_rows``) and at POOL_BWD_POINTS."""
  r = _pool_bwd_tower(N_GRAD, dtype, gen)
  r['train_rows'] = {str(n): _train_rows_entry(_pool_bwd_tower(n, dtype, gen))
                     for n in VALUE_TRAIN_ROWS}
  r['multisep_rows'] = _train_rows_entry(_pool_bwd_tower(
      MULTISEP_ROWS, dtype, gen, [LAST_POOL]))
  r['max_abs_err_points'] = _pool_bwd_points(dtype)
  return r


# the rows the analysis path (phase 11) gives the value net's kernels: one
# sequence (input x gradient, Ledidi, ISM's reference row), expected
# gradients' 20 references, integrated gradients' 32 path points and ISM's
# tail batch (800 mutants = 512 + 288). B3 at the six fused pools, B4 and
# B8 at the last pool and B5 at the value net's heads are held against
# their plain versions and timed there in both dtypes (``analysis_rows``).
# In bf16 the eval tower sends 1 and 20 rows (off JAX's gate, N % 8) and
# the attributions' vmapped rows to the pools' reference forms, so phase 11
# launches B3, B4 and B8 at those rows in f32 alone; the kernels are held
# there in bf16 all the same
ANALYSIS_ROWS = (1, 20, 32, 288)


def _analysis_point(name, n, calls, plains, flops, nbytes, dtype_name,
                    counter):
  """Each call once against its plain version (one launch each), then
  the calls' summed device time and the plain versions' (the profiler)
  with the bound of ``flops`` and ``nbytes``."""
  from svdd_tpu_torch import _build
  errs = []
  for call, plain in zip(calls, plains):
    before = _build.LAUNCHES[counter]
    got = call()
    if _build.LAUNCHES[counter] != before + 1:
      raise AssertionError(f'{name} N={n}: no launch')
    want = plain()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for i, (g, w) in enumerate(pairs):       # B8's dW is a sum over rows
      check = compare_sum if name == 'attn_pool_bwd' and i == 1 else compare
      errs.append(check(f'{name} N={n}', g, w, dtype_name)[0])
  ms = device_ms(lambda: [c() for c in calls])
  plain_ms = device_ms(lambda: [p() for p in plains])
  bound_ms, bound_by = bound(flops, nbytes, dtype_name)
  return {'rows': n, 'max_abs_err': max(errs), 'ms': ms,
          'plain_ms': plain_ms, 'library_ms': None, 'bound_ms': bound_ms,
          'bound_by': bound_by, 'bound_share': bound_ms / ms,
          'kernel_vs_plain': ms / plain_ms}


def check_analysis_rows(dtype, gen) -> dict:
  """B3, B4, B5 and B8 at ANALYSIS_ROWS: {kernel: {rows: point}}."""
  import torch
  from svdd_tpu_torch.ops import attn_l2 as L2
  from svdd_tpu_torch.ops import attn_pool as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  out = {k: {} for k in ('attn_pool_prologue_im2col', 'attn_pool',
                         'attn_l2', 'attn_pool_bwd')}
  for n in ANALYSIS_ROWS:
    pools = [_pool_args(l, c, dtype, gen, n=n) for l, c in POOL_SHAPES]
    es = pools[0][0].element_size()
    flops = sum(2 * n * ((l + 1) // 2) * c * c for l, c in POOL_SHAPES)
    nbytes = sum(_pool_bytes(n, l, c, es, len(live_offsets(5, (l + 1) // 2)))
                 for l, c in POOL_SHAPES)
    out['attn_pool_prologue_im2col'][str(n)] = _analysis_point(
        'attn_pool_prologue_im2col', n,
        [lambda a=a: K._pool_prologue_im2col_kernel(*a) for a in pools],
        [lambda a=a: K.pool_prologue_im2col_wlogits_plain(*a) for a in pools],
        flops, nbytes, name, 'attn_pool_prologue_im2col')
    del pools
    l, c = LAST_POOL
    lh = (l + 1) // 2
    x, res, w = _pool_inputs(l, c, dtype, gen, n)
    out['attn_pool'][str(n)] = _analysis_point(
        'attn_pool', n, [lambda: K._attn_pool(x, w, res)],
        [lambda: K.attn_pool_plain(x, w, res)], 2 * n * lh * c * c,
        _pool_bytes(n, l, c, es), name, 'attn_pool')
    ct = torch.randn(n, lh, c, device='cuda', generator=gen).to(dtype)
    out['attn_pool_bwd'][str(n)] = _analysis_point(
        'attn_pool_bwd', n, [lambda: K.attn_pool_bwd(x, w, ct, res)],
        [lambda: K.attn_pool_bwd_plain(x, w, ct, res)],
        3 * 2 * n * lh * c * c,
        (3 * n * l * c + n * lh * c + c * c) * es + c * c * 4, name,
        'attn_pool_bwd')
    del x, res, w, ct
    h, dk, dv = ATTN_L2_HEADS
    args = _attn_l2_args(n, h, dk, dv, dtype, gen)
    out['attn_l2'][str(n)] = _analysis_point(
        'attn_l2', n, [lambda: L2.attn_l2(*args)],
        [lambda: _attn_l2_plain(args)], n * 2 * h * (6 * dk + 3 * dv),
        (n * 2 * h * (2 * dk + 2 * dv) + 5 * h * dk) * es + n * 2 * h * 4,
        name, 'attn_l2')
    del args
    torch.cuda.empty_cache()
  return out


# B12 at the text preset's DiT and AR shapes: the 64-row decode batch,
# L=1024, 12 heads of 64; B13 at DiMamba's 512 x 200 rows of 256
ATTN_SHAPE = (64, 1024, 12, 64)
RMS_SHAPE = (512 * 200, 256)


def check_flash_attention(dtype, gen, causal: bool, shape=ATTN_SHAPE):
  """B12 on q, k, v sliced from one (B, L, 3, H, D) projection, as the
  backbones pass them (the kernel reads them by stride), against the
  plain form of the rounding JAX's dispatch takes at (L, D) (the Pallas
  body's at L % 128 == 0, ``mha``'s elsewhere: ``body_rounds``; in
  float32 the kernel computes both in its single pass,
  ``kernel_rounds_as_body``), and
  timed beside F.scaled_dot_product_attention on contiguous (B, H, L, D)
  copies. The kernel's mean distance to the other rounding's plain form
  is reported beside (``mean_abs_err_other_rounding``); in bf16 off the
  gate, where the kernel rounds as ``mha``, it must exceed the mean
  distance to its own. The flops count the causal half. The
  float32 kernel runs its products as 3xTF32, so its bound is the work
  at 495/3 TFLOP/s; the FMA bound (67 TFLOP/s) is reported beside it.
  Achieved TFLOP/s and the share of each bound are in the result."""
  import torch
  import torch.nn.functional as F
  from svdd_tpu_torch.ops import attention as A
  from svdd_tpu_torch.ops import flash_attention as K
  name = str(dtype).split('.')[-1]
  b, l, h, d = shape
  body = K.body_rounds(l, d)
  plain = A.plain_for(l, d)
  other = A.mha if body else A.attention_body_plain
  qkv = torch.randn(b, l, 3, h, d, device='cuda', generator=gen).to(dtype)
  q, k, v = qkv.unbind(2)
  got = K.flash_attention(q, k, v, causal)
  err, rel = compare(f'flash_attention causal={causal}', got,
                     plain(q, k, v, causal), name)
  own_mean = float((got.float() - plain(q, k, v, causal).float()).abs().mean())
  other_mean = float((got.float() - other(q, k, v, causal).float()).abs()
                     .mean())
  if name == 'bfloat16' and not body and not other_mean > own_mean:
    raise AssertionError(f'flash_attention L={l} bf16: mean distance to mha '
                         f'{own_mean}, to the body rounding {other_mean}')
  del got
  ms = median_ms(lambda: K.flash_attention(q, k, v, causal), iters=10)
  plain_ms = median_ms(lambda: plain(q, k, v, causal), iters=3)
  qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
  lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
      qt, kt, vt, is_causal=causal), iters=10)
  # the q.k and p.v products; q, k, v in, out written
  flops = 4 * b * h * l * l * d // (2 if causal else 1)
  nbytes = 4 * b * h * l * d * qkv.element_size()
  peak = 'tf32x3' if name == 'float32' else name
  bound_ms, bound_by = bound(flops, nbytes, peak)
  r = {'shape': list(shape), 'causal': causal,
       'rounding': 'pallas_body' if body else 'mha',
       'kernel_passes': 1 if K.kernel_rounds_as_body(l, d, dtype) else 2,
       'max_abs_err': err, 'max_rel_err': rel,
       'mean_abs_err': own_mean, 'mean_abs_err_other_rounding': other_mean,
       'ms': ms,
       'plain_ms': plain_ms, 'library_ms': lib_ms,
       'library': 'torch.nn.functional.scaled_dot_product_attention',
       'flops': flops, 'bytes': nbytes, 'peak': peak,
       'bound_ms': bound_ms, 'bound_by': bound_by,
       'tflops': flops / ms / 1e9, 'bound_share': bound_ms / ms}
  if name == 'float32':
    r['fma_bound_ms'] = bound(flops, nbytes, 'float32')[0]
    r['fma_bound_share'] = r['fma_bound_ms'] / ms
  return r


def check_rmsnorm(dtype, gen):
  """B13 at DiMamba's rows, without a residual (the path's call) and
  with one, against the plain version; timed without the residual beside
  F.rms_norm (which rounds only once, so it is a yardstick of time); and
  at the rows of phase 9's DiMamba training batch (``train_rows``), whose
  26 MB in and out fit the 50 MB L2: there also the kernel alone with
  L2 flushed before each call (``ms_l2_flushed``, a 128 MB write between
  calls, the profiler counting the kernel only), which the HBM bound
  holds."""
  import torch
  import torch.nn.functional as F
  from svdd_tpu_torch.ops import norms as K
  name = str(dtype).split('.')[-1]
  rows, d = RMS_SHAPE
  x = torch.randn(rows, d, device='cuda', generator=gen).to(dtype)
  res = torch.randn(rows, d, device='cuda', generator=gen).to(dtype)
  s = (1 + 0.2 * torch.randn(d, device='cuda', generator=gen)).to(dtype)
  errs = [compare(f'rmsnorm residual={r is not None}',
                  K.fused_add_rmsnorm(x, r, s), K.rmsnorm_plain(x, r, s),
                  name) for r in (None, res)]
  es = x.element_size()
  xt = x[:BB_TRAIN_ROWS * 200]
  err_t = compare('rmsnorm train rows', K.fused_add_rmsnorm(xt, None, s),
                  K.rmsnorm_plain(xt, None, s), name)
  t = timed(lambda: K.fused_add_rmsnorm(xt, None, s),
            lambda: K.rmsnorm_plain(xt, None, s),
            lambda: F.rms_norm(xt, (d,), s, 1e-5), reps=20, iters=20)
  n_t = xt.shape[0]
  t_bound = bound(4 * n_t * d, 2 * n_t * d * es + d * es, name)
  flush = torch.empty(2 ** 25, device='cuda')
  flushed = device_ms(lambda: (flush.zero_(),
                               K.fused_add_rmsnorm(xt, None, s)),
                      reps=20, fragment='rmsnorm_kernel')
  del flush
  return {'shape': list(RMS_SHAPE), 'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          **timed(lambda: K.fused_add_rmsnorm(x, None, s),
                  lambda: K.rmsnorm_plain(x, None, s),
                  lambda: F.rms_norm(x, (d,), s, 1e-5), reps=20, iters=20),
          'library': 'torch.nn.functional.rms_norm',
          'train_rows': {'rows': n_t, 'max_abs_err': err_t[0],
                         'ms': t['ms'], 'ms_l2_flushed': flushed,
                         'plain_ms': t['plain_ms'],
                         'library_ms': t['library_ms'],
                         'bound_ms': t_bound[0], 'bound_by': t_bound[1]},
          # square-add, the root, two products per element; x in, out
          'flops': 4 * rows * d, 'bytes': 2 * rows * d * es + d * es}


# B12 at the text preset with 6 heads of 128 (the head dim built beside 64),
# and at a ragged length, 200, which no tile divides
ATTN_SHAPE_D128 = (64, 1024, 6, 128)
ATTN_SHAPE_L200 = (8, 200, 12, 64)

# B11c at Basenji's dilation-1 NACDR convs at N = 5120 rows of L = 25 (the
# residual tower after three max pools of L = 200): input widths 324 and
# 108 at the published defaults, 256 and 128 when built on the 128-lane
# grid; k = 5, the exact gelu. B14 at the 128-lane convs.
IM2COL_ROWS, IM2COL_L = 5120, 25
IM2COL_WIDTHS = (324, 108, 256, 128)
FUSED_CONVS = ((256, 128), (128, 256))
# B11a and B11b at the off-grid stem pool of an Enformer value net built
# with channels=1152 (stem width 576), L = 200, N = B*M = 5120
OFFGRID_POOL = (5120, 200, 576)


def _affine(c, gen):
  import torch
  return (1 + 0.2 * torch.randn(c, device='cuda', generator=gen),
          0.2 * torch.randn(c, device='cuda', generator=gen))


IM2COL_SPREAD_CALLS = 7


def check_nacdr_im2col(dtype, gen):
  """B11c at the four widths, against the plain version; ms is one call
  at each width. ``spread``: IM2COL_SPREAD_CALLS timings of that call
  (each the card's time, the profiler, of one call at each width), their
  median, lowest and highest."""
  import torch
  from svdd_tpu_torch.ops import im2col as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  n, l = IM2COL_ROWS, IM2COL_L
  k_live = len(live_offsets(5, l))
  errs, per_width, flops, nbytes, calls = [], {}, 0, 0, []
  for c in IM2COL_WIDTHS:
    x = torch.randn(n, l, c, device='cuda', generator=gen).to(dtype)
    scale, shift = _affine(c, gen)
    args = (x, scale, shift, 5, 'gelu')
    errs.append(compare(f'nacdr_im2col C={c}', K.nacdr_im2col(*args),
                        K.nacdr_im2col_reference(*args), name))
    per_width[str(c)] = timed(lambda: K.nacdr_im2col(*args),
                              lambda: K.nacdr_im2col_reference(*args))
    es = x.element_size()
    # the affine's product and sum per element (the activation besides)
    flops += 2 * n * l * c
    nbytes += n * l * c * es * (1 + k_live) + 2 * c * 4
    calls.append(args)
  times = sorted(sum(device_ms(lambda a=a: K.nacdr_im2col(*a), reps=1)
                     for a in calls) for _ in range(IM2COL_SPREAD_CALLS))
  del calls
  torch.cuda.empty_cache()
  total = lambda k: sum(p[k] for p in per_width.values())
  return {'shapes': [[n, l, c] for c in IM2COL_WIDTHS], 'k': 5,
          'act': 'gelu', 'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          **{k: total(k) for k in ('ms', 'median_ms', 'plain_ms',
                                   'plain_median_ms')},
          'per_width': per_width, 'library_ms': None, 'flops': flops,
          'bytes': nbytes,
          'spread': {'calls': len(times), 'median_ms': times[len(times) // 2],
                     'min_ms': times[0], 'max_ms': times[-1]}}


def _fused_conv_inputs(n, l, cin, cout, dtype, gen):
  import torch
  r = lambda *s: torch.randn(*s, device='cuda', generator=gen)
  scale, shift = _affine(cin, gen)
  return (r(n, l, cin).to(dtype), (r(5, cin, cout) / (5 * cin) ** 0.5).to(dtype),
          (0.1 * r(cout)).to(dtype), scale, shift, 'gelu')


# B14 is also held at a ragged point on the 128-lane grid (N = 8, L = 3:
# one row tile, most of it past the last row), launching the kernel
FUSED_RAGGED = (8, 3, 128, 256)
# the repair of ROADMAP C: shapes off JAX's gate (Basenji's default
# widths 324 -> 108, and 128 -> 108) take the plain version on the card
FUSED_OFF_GATE = ((8, 25, 324, 108), (8, 25, 128, 108))


def check_fused_conv1d(dtype, gen):
  """B14 at the two 128-lane residual convs, against the plain version
  (which rounds the conv output before its bias: one ulp of the type at
  most, inside TOL), timed by the card's own time for a call (device_ms)
  and by CUDA events (median_ms), beside F.conv1d on the already activated
  input, the conv alone, as a yardstick; ms is one call of each, device
  time; flops count the live rows. Then the ragged point, with a launch,
  and the off-gate shapes through fused_conv1d on the card: each equal to
  fused_conv1d_reference bit for bit, with no launch."""
  import torch
  import torch.nn.functional as F
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import fused_conv as K
  from svdd_tpu_torch.ops.kernel_utils import act, live_offsets
  name = str(dtype).split('.')[-1]
  n, l = IM2COL_ROWS, IM2COL_L
  k_live = len(live_offsets(5, l))
  errs, per_conv, flops, nbytes = [], [], 0, 0
  for cin, cout in FUSED_CONVS:
    args = _fused_conv_inputs(n, l, cin, cout, dtype, gen)
    x, w, b, scale, shift, _ = args
    with torch.no_grad():
      errs.append(compare(f'fused_conv1d {cin}->{cout}', K.fused_conv1d(*args),
                          K.fused_conv1d_reference(*args), name))
      xg = act('gelu', x.float() * scale + shift).to(dtype).transpose(
          1, 2).contiguous()
      w_oik = w.permute(2, 1, 0).contiguous()
      fl = 2 * n * live_rows(l) * cin * cout
      ms = device_ms(lambda: K.fused_conv1d(*args))
      per_conv.append({
          'shape': [n, l, cin, cout], 'ms': ms,
          'median_ms': median_ms(lambda: K.fused_conv1d(*args), iters=10),
          'plain_ms': median_ms(lambda: K.fused_conv1d_reference(*args), iters=5),
          'library_ms': median_ms(lambda: F.conv1d(xg, w_oik, b, padding=2),
                                  iters=10),
          'tflops': fl / ms / 1e9})
    es = x.element_size()
    flops += fl
    nbytes += (n * l * (cin + cout) + k_live * cin * cout + cout) * es + 2 * cin * 4
    del x, xg, args
    torch.cuda.empty_cache()
  with torch.no_grad():
    args = _fused_conv_inputs(*FUSED_RAGGED, dtype, gen)
    before = _build.LAUNCHES['fused_conv1d']
    ragged = compare(f'fused_conv1d {FUSED_RAGGED}', K.fused_conv1d(*args),
                     K.fused_conv1d_reference(*args), name)[0]
    if _build.LAUNCHES['fused_conv1d'] != before + 1:
      raise AssertionError(f'fused_conv1d {FUSED_RAGGED}: no launch')
    off_gate = {}
    for shape in FUSED_OFF_GATE:
      args = _fused_conv_inputs(*shape, dtype, gen)
      before = _build.LAUNCHES['fused_conv1d']
      got, want = K.fused_conv1d(*args), K.fused_conv1d_reference(*args)
      launched = _build.LAUNCHES['fused_conv1d'] - before
      if launched or not torch.equal(got, want):
        raise AssertionError(f'fused_conv1d {shape} {name}: {launched} '
                             'launches or not the plain value bit for bit')
      off_gate[str(shape)] = {'launches': launched, 'bitwise': True}
  total = lambda k: sum(c[k] for c in per_conv)
  r = {'shapes': [c['shape'] for c in per_conv], 'k': 5,
       'act': 'gelu', 'max_abs_err': max(e[0] for e in errs),
       'max_rel_err': max(e[1] for e in errs),
       'max_abs_err_points': {str(FUSED_RAGGED): ragged}, 'off_gate': off_gate,
       'ms': total('ms'),
       'median_ms': total('median_ms'), 'plain_ms': total('plain_ms'),
       'library_ms': total('library_ms'),
       'library': 'torch.nn.functional.conv1d on act(affine(x)): the '
                  'conv alone, a yardstick',
       'per_conv': per_conv, 'flops': flops, 'bytes': nbytes}
  return _cnn_rates(r, name)


def _offgrid_pool_inputs(dtype, gen):
  import torch
  n, l, c = OFFGRID_POOL
  x = torch.randn(n, l, c, device='cuda', generator=gen).to(dtype)
  logits = (2 * torch.randn(n, l, c, device='cuda', generator=gen)).to(dtype)
  return x, logits


def _check_pad_pair(fn, x, logits, name):
  """The last pair of an odd length padded as the module pads it (a zero
  row of x, the lowest finite logit) pools to exactly its first row."""
  import torch
  xp, lp = x[:8].clone(), logits[:8].clone()
  xp[:, -1] = 0
  lp[:, -1] = torch.finfo(lp.dtype).min
  out = fn(xp, lp)
  if not torch.equal(out[:, -1], xp[:, -2]):
    raise AssertionError(f'{name}: the padded tail pair is not its first row')


def check_attn_pool_logits(dtype, gen):
  """B11a at the off-grid stem pool (5120, 200, 576), against the plain
  version; the padded tail pair exactly."""
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  x, logits = _offgrid_pool_inputs(dtype, gen)
  err, rel = compare('attn_pool_logits', K.attn_pool_fused(x, logits),
                     K.attn_pool_reference(x, logits), name)
  _check_pad_pair(K.attn_pool_fused, x, logits, 'attn_pool_logits')
  n, l, c = OFFGRID_POOL
  es = x.element_size()
  return {'shape': list(OFFGRID_POOL), 'max_abs_err': err, 'max_rel_err': rel,
          **timed(lambda: K.attn_pool_fused(x, logits),
                  lambda: K.attn_pool_reference(x, logits), reps=5, iters=5),
          # per output: the logit difference, the sigmoid's exp, sum and
          # reciprocal, the row difference, product and sum
          'flops': 7 * n * (l // 2) * c,
          'bytes': (2 * n * l * c + n * (l // 2) * c) * es}


def check_attn_pool_logits_im2col(dtype, gen):
  """B11b at the off-grid stem pool handed to conv_1 (k = 5 over the
  pooled 100 rows, gelu_enformer), against the plain version."""
  import torch
  from svdd_tpu_torch.ops import attn_pool as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  x, logits = _offgrid_pool_inputs(dtype, gen)
  n, l, c = OFFGRID_POOL
  scale, shift = _affine(c, gen)
  args = (x, logits, scale, shift, 5, 'gelu_enformer')
  err, rel = compare('attn_pool_logits_im2col', K.pool_prologue_im2col(*args),
                     K.pool_prologue_im2col_reference(*args), name)
  torch.cuda.empty_cache()
  k_live = len(live_offsets(5, l // 2))
  es = x.element_size()
  return {'shape': list(OFFGRID_POOL), 'k': 5, 'act': 'gelu_enformer',
          'max_abs_err': err, 'max_rel_err': rel,
          **timed(lambda: K.pool_prologue_im2col(*args),
                  lambda: K.pool_prologue_im2col_reference(*args), reps=5,
                  iters=5),
          # the blend's 7 and the affine's 2 per pooled element
          'flops': 9 * n * (l // 2) * c,
          'bytes': (2 * n * l * c + n * (l // 2) * k_live * c) * es + 2 * c * 4}


# ---------------------------------------------------------------------------
# phase 3: full-width models, card vs CPU
# ---------------------------------------------------------------------------


def check_models(f32_cpu=None, gen_seed: int = 0):
  """The full-width denoiser (8 rows) and value net (4 candidates) on the
  card through the kernels, against the plain path on the CPU with the
  same weights. Whole models sum in other orders on each side: 1e-3 in
  f32. Given ``f32_cpu``, the f32 run's CPU outputs, both nets are built
  as the bf16 switches build them and held by ``bf16_close``. Returns
  the report and the CPU outputs."""
  bf16 = f32_cpu is not None
  import torch
  from svdd_tpu_torch import mdlm
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  cfg = dna_config()
  with bf16_switches(bf16):
    den = Diffusion(cfg, device='cuda')
  val = EnformerValueModel(
      compute_dtype=torch.bfloat16 if bf16 else torch.float32,
      generator=torch.Generator('cuda').manual_seed(1)).cuda().eval()
  g = torch.Generator().manual_seed(gen_seed)
  x = torch.randint(0, 5, (8, cfg.model.length), generator=g)
  sigma = torch.zeros(8)
  with torch.inference_mode():
    lp_gpu = den.forward(x.cuda(), sigma.cuda()).cpu()
    v_gpu = val(mdlm.transform_samples(x[:4]).cuda()).cpu()
    den.backbone.cpu()
    val.cpu()
    den.device = torch.device('cpu')
    lp_cpu = den.forward(x, sigma)
    v_cpu = val(mdlm.transform_samples(x[:4]))
  finite = torch.isfinite(lp_gpu) | (lp_gpu == mdlm.NEG_INFINITY)
  if not finite.all() or not torch.isfinite(v_gpu).all():
    raise AssertionError('models: non-finite outputs')
  # the log-probs SUBS pins near NEG_INFINITY (the MASK column, the
  # unmasked rows' other tokens) are compared as a pattern
  live = lp_cpu > mdlm.NEG_INFINITY / 2
  if not torch.equal(live, lp_gpu > mdlm.NEG_INFINITY / 2):
    raise AssertionError('denoiser card vs cpu: the -inf entries differ')
  lp_err = float((lp_gpu[live] - lp_cpu[live]).abs().max())
  v_err = float((v_gpu - v_cpu).abs().max())
  lp_max, v_max = float(lp_cpu[live].abs().max()), float(v_cpu.abs().max())
  r = {'compute_dtype': 'bfloat16' if bf16 else 'float32',
       'denoiser_max_abs_err': lp_err, 'denoiser_max_abs': lp_max,
       'value_max_abs_err': v_err,
       'value_gpu': v_gpu.tolist(), 'value_cpu': v_cpu.tolist()}
  if bf16:
    lp_noise = float((lp_cpu[live] - f32_cpu['lp'][live]).abs().max())
    v_noise = float((v_cpu - f32_cpu['v']).abs().max())
    r.update(denoiser_cpu_bf16_vs_f32=lp_noise, value_cpu_bf16_vs_f32=v_noise)
    ok = (bf16_close(lp_err, lp_noise, lp_max)
          and bf16_close(v_err, v_noise, v_max))
  else:
    ok = (torch.allclose(lp_gpu, lp_cpu, rtol=1e-3, atol=1e-3)
          and torch.allclose(v_gpu, v_cpu, rtol=1e-3, atol=1e-3 * v_max))
  if not ok:
    raise AssertionError(f'models card vs cpu: {r}')
  return r, {'lp': lp_cpu, 'v': v_cpu}


def check_model_grads(f32_cpu=None):
  """The input gradients the guided decoders take, on 8 rows of the
  full-width models: the value net's through its differentiable tower
  (classifier guidance) and the DPS gradient of a fixed linear reward
  through the denoiser's one-hot path, the kernels on the card against
  the plain path on the CPU with the same weights. Whole backward passes
  sum in other orders on each side: 1e-3 of the largest gradient in f32.
  Given ``f32_cpu``, the f32 run's CPU gradients, both nets are built as
  the bf16 switches build them and the norm of each difference is held
  by ``bf16_close``. Returns the report and the CPU gradients."""
  bf16 = f32_cpu is not None
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  from svdd_tpu_torch.sampling import guidance
  cfg = dna_config()
  with bf16_switches(bf16):
    den = Diffusion(cfg, device='cuda')
  val = EnformerValueModel(
      compute_dtype=torch.bfloat16 if bf16 else torch.float32,
      generator=torch.Generator('cuda').manual_seed(1)).cuda().eval()
  g = torch.Generator().manual_seed(2)
  x = torch.randint(0, 5, (8, cfg.model.length), generator=g)
  w = torch.randn(cfg.model.length, 4, generator=g)
  sigma = torch.zeros(8)

  def grads(dev):
    wd = w.to(dev)
    reward = lambda p: (p * wd).sum(dim=(-1, -2))
    gv = guidance.classifier_gradient(lambda oh: val(oh, fused=False),
                                      x.to(dev))
    gd = guidance.dps_gradient(den.forward_onehot, reward, x.to(dev),
                               sigma.to(dev), cfg.mask_index)
    return gv.cpu(), gd.cpu()

  _build.reset_launches()
  gv_gpu, gd_gpu = grads('cuda')
  torch.cuda.synchronize()
  launches = _build.launches()
  need = set(PATH_KERNELS['dps'] + PATH_KERNELS['classifier'])
  missing = [k for k in sorted(need) if launches[k] == 0]
  if missing:
    raise AssertionError(f'gradients never launched {missing}')
  den.backbone.cpu()
  den.device = torch.device('cpu')
  val.cpu()
  gv_cpu, gd_cpu = grads('cpu')
  out = {'compute_dtype': 'bfloat16' if bf16 else 'float32'}
  norm = torch.linalg.vector_norm
  cpu = {'value_grad': gv_cpu, 'dps_grad': gd_cpu}
  for name, got, want in (('value_grad', gv_gpu, gv_cpu),
                          ('dps_grad', gd_gpu, gd_cpu)):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    rel = float(norm(got - want) / norm(want))
    out.update({f'{name}_max_abs_err': err, f'{name}_max_abs': scale,
                f'{name}_rel_norm_err': rel})
    if bf16:
      noise = float(norm(want - f32_cpu[name]) / norm(want))
      out[f'{name}_cpu_bf16_vs_f32_rel_norm'] = noise
      close = bf16_close(rel, noise, 1.0)
    else:
      close = torch.allclose(got, want, rtol=1e-3, atol=1e-3 * scale)
    if scale == 0 or not torch.isfinite(got).all() or not close:
      raise AssertionError(f'{name} card vs cpu: {out}')
  out['launches'] = {k: launches[k] for k in sorted(need)}
  return out, cpu


def nonzero_init(model, seed: int):
  """Draw the layers flax zero-initialises (the adaLN layers, the DiT's
  final linear) from normal(0, 0.02), so a random model's attention and
  norms reach its output."""
  import torch
  gen = torch.Generator(next(model.parameters()).device).manual_seed(seed)
  with torch.no_grad():
    for name, p in model.named_parameters():
      if 'adaLN' in name or name.startswith('output_layer.linear'):
        p.normal_(0.0, 0.02, generator=gen)
  return model


def sample_eval_backbone(which: str, device='cuda'):
  """(config, backbone) of a sample_eval path: the text preset's DiT
  (hidden 768, 12 blocks, 12 heads, L=1024) or DiMamba on the DNA task
  (d_model 256, 4 layers, L=200), bf16 precision as their configs set
  it, random weights from the config's seed with ``nonzero_init``."""
  import torch
  from svdd_tpu_torch.config import dna_config, text_mdlm_config
  from svdd_tpu_torch.diffusion import build_backbone
  cfg = text_mdlm_config() if which == 'text_mdlm' else dna_config(
      backbone='dimamba')
  gen = torch.Generator(device).manual_seed(cfg.seed)
  return cfg, nonzero_init(build_backbone(cfg, gen).eval(), 1)


# card vs CPU for the bf16-precision backbones: besides the summation
# order, block 0's bf16 norm output holds values within f32 noise of a
# bf16 rounding boundary, which round one ulp (2^-8) apart on the two
# sides: |err| <= 2e-3 * max |cpu| + 2e-3 * |cpu|
BACKBONE_TOL = 2e-3


def check_backbones():
  """The full-width DiT (2 rows, L=1024), the AR scorer at the same
  widths (2 rows) and DiMamba (4 rows, L=200), each on the card through
  B12/B13 against the plain path on the CPU with the same weights."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.models.autoregressive import ARModel
  g = torch.Generator().manual_seed(3)
  out, launches = {}, {}
  for which in ('text_mdlm', 'ar', 'dimamba'):
    if which == 'ar':
      cfg, _ = sample_eval_backbone('text_mdlm')
      model = ARModel(cfg, cfg.vocab_size, generator=torch.Generator(
          'cuda').manual_seed(0)).eval()
      rows = 2
    else:
      cfg, model = sample_eval_backbone(which)
      rows = 2 if which == 'text_mdlm' else 4
    x = torch.randint(0, cfg.vocab_size, (rows, cfg.model.length),
                      generator=g)
    sigma = torch.rand(rows, generator=g)
    _build.reset_launches()
    with torch.inference_mode():
      got = model(x.cuda(), sigma.cuda()).cpu()
      torch.cuda.synchronize()
      launches[which] = {k: v for k, v in _build.launches().items() if v}
      want = model.cpu()(x, sigma)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.allclose(
        got, want, rtol=BACKBONE_TOL, atol=BACKBONE_TOL * scale):
      raise AssertionError(f'{which} card vs cpu: max abs err {err}, max '
                           f'|cpu| {scale}')
    out[which] = {'rows': rows, 'length': cfg.model.length,
                  'max_abs_err': err, 'max_abs': scale,
                  'launches': launches[which]}
    del model
    torch.cuda.empty_cache()
  for which, need in (('text_mdlm', 'flash_attention'),
                      ('ar', 'flash_attention_causal'),
                      ('dimamba', 'rmsnorm')):
    if not launches[which].get(need):
      raise AssertionError(f'{which} forward never launched {need}')
  return out


def check_head_dims():
  """B12's head dims through the DiT: the text preset at 6 heads (D=128,
  2 rows, L=1024, bf16 precision) launches the kernel; a tiny DiT with
  2 heads of 16 (hidden 32, L=32, f32) takes the plain attention, as the
  JAX dispatcher does below a multiple of 64; each on the card against
  the CPU with the same weights."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.config import text_mdlm_config
  from svdd_tpu_torch.diffusion import build_backbone
  out = {}
  for which, rows in (('d128', 2), ('d16', 4)):
    cfg = text_mdlm_config()
    if which == 'd128':
      cfg.model.n_heads = 6
    else:
      cfg.model.length, cfg.model.hidden_size = 32, 32
      cfg.model.n_heads, cfg.model.n_blocks, cfg.model.cond_dim = 2, 2, 16
      cfg.parallel.precision = 'fp32'
    model = nonzero_init(build_backbone(
        cfg, torch.Generator('cuda').manual_seed(cfg.seed)).eval(), 1)
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, cfg.vocab_size, (rows, cfg.model.length), generator=g)
    sigma = torch.rand(rows, generator=g)
    _build.reset_launches()
    with torch.inference_mode():
      got = model(x.cuda(), sigma.cuda()).cpu()
      torch.cuda.synchronize()
      launched = _build.launches()['flash_attention']
      want = model.cpu()(x, sigma)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.allclose(
        got, want, rtol=BACKBONE_TOL, atol=BACKBONE_TOL * scale):
      raise AssertionError(f'DiT {which} card vs cpu: max abs err {err}, '
                           f'max |cpu| {scale}')
    d = cfg.model.hidden_size // cfg.model.n_heads
    if (launched > 0) != (d % 64 == 0):
      raise AssertionError(f'DiT head dim {d}: {launched} B12 launches')
    out[which] = {'head_dim': d, 'rows': rows, 'length': cfg.model.length,
                  'precision': cfg.parallel.precision, 'max_abs_err': err,
                  'max_abs': scale, 'flash_attention_launches': launched}
    del model
    torch.cuda.empty_cache()
  return out


# Basenji at its published defaults, and built on the 128-lane grid
BASENJI = {'basenji': {},
           'basenji_128': dict(channel_init=256, conv_channel_mult=1.0,
                               residual_channels=128)}
MODEL_ROWS, MODEL_L = 512, 200
# rows of the models phase also run on the CPU (eval rows are independent)
CPU_ROWS = 64


def _onehot_rows(n, l, seed):
  import torch
  import torch.nn.functional as F
  g = torch.Generator().manual_seed(seed)
  return F.one_hot(torch.randint(0, 4, (n, l), generator=g), 4).float()


def _card_vs_cpu(name, got, want, tol=1e-3):
  import torch
  scale = float(want.abs().max())
  err = float((got - want).abs().max())
  if scale == 0 or not torch.isfinite(got).all() or not torch.allclose(
      got, want, rtol=tol, atol=tol * scale):
    raise AssertionError(f'{name} card vs cpu: max abs err {err}, max |cpu| '
                         f'{scale}')
  return err, scale


def _launched(run: str, launches: dict) -> dict:
  missing = [k for k in OFFGRID_KERNELS[run] if launches[k] == 0]
  if missing:
    raise AssertionError(f'{run} never launched {missing}')
  return {k: v for k, v in launches.items() if v}


def check_basenji():
  """The Basenji trunk at its published defaults and built on the 128-lane
  grid (channel_init 256, mult 1.0, residual 128), the latter with
  SVDD_PALLAS_FUSED_CONV unset and set: 512 rows at L=200 on the card,
  float32, the launch counts set to 0 just before each forward and read
  just after; the first 64 rows against the plain path on the CPU with
  the same weights, 1e-3 of the largest output."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.models.basenji import Basenji
  x = _onehot_rows(MODEL_ROWS, MODEL_L, 6)
  out = {}
  for run, fused_conv in (('basenji', False), ('basenji_128', False),
                          ('basenji_128_fused_conv', True)):
    cfg = BASENJI[run.replace('_fused_conv', '')]
    model = Basenji(**cfg, generator=torch.Generator('cuda').manual_seed(7))
    model = model.cuda().eval()
    if fused_conv:
      os.environ['SVDD_PALLAS_FUSED_CONV'] = '1'
    try:
      torch.cuda.synchronize()
      _build.reset_launches()
      t0 = time.perf_counter()
      with torch.inference_mode():
        got = model(x.cuda())
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
      launches = _launched(run, _build.launches())
      with torch.inference_mode():
        want = model.cpu()(x[:CPU_ROWS])
    finally:
      os.environ.pop('SVDD_PALLAS_FUSED_CONV', None)
    if got.shape != (MODEL_ROWS,):
      raise AssertionError(f'{run}: output {tuple(got.shape)}')
    err, scale = _card_vs_cpu(run, got[:CPU_ROWS].cpu(), want)
    out[run] = {'config': cfg, 'fused_conv': fused_conv, 'rows': MODEL_ROWS,
                'length': MODEL_L, 'forward_s': wall, 'max_abs_err': err,
                'max_abs': scale, 'launches': launches}
    del model
    torch.cuda.empty_cache()
  return out


# an Enformer value net whose stem width (channels // 2 = 576) is off the
# 128-lane grid: the stem pool takes kernel B11b in the fused forward and
# B11a in the differentiable tower
OFFGRID_CHANNELS = 1152


# An FFN relu input within this of 0 may take the other side of the relu on
# the card than on the CPU (their f32 sums differ in order; the inputs
# that flipped in chip runs were under 4e-6): the input gradient is
# discontinuous there and differs in that row by up to ~1e-2 of its
# largest value.
RELU_EDGE = 1e-4


def _relu_inputs(model, store):
  """Hooks recording the FFN relu inputs of every transformer block."""
  return [b.ffn.up.register_forward_hook(
      lambda mod, i, o: store.append(o.detach()[:CPU_ROWS].cpu()))
          for b in model.trunk.transformers]


def check_offgrid_enformer():
  """The channels=1152 value net at full depth (7 conv blocks, 11
  transformers), 512 rows at L=200, float32, on the card: the fused
  forward, then the input gradient of the summed value through the
  differentiable tower (fused=False), each with the launch counts set to
  0 just before and read just after; the first 64 rows of each against
  the plain path on the CPU with the same weights, 1e-3 of the largest
  value or gradient. A row where an FFN relu input took the other side
  of 0 on the two sides is left out of the gradient comparison, once
  every such input is checked to lie within RELU_EDGE of 0."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  model = EnformerValueModel(
      channels=OFFGRID_CHANNELS,
      generator=torch.Generator('cuda').manual_seed(1)).cuda().eval()
  x = _onehot_rows(MODEL_ROWS, MODEL_L, 8)

  def grad(oh, relu_in):
    hooks = _relu_inputs(model, relu_in)
    oh = oh.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(model(oh, fused=False).sum(), oh)
    for h in hooks:
      h.remove()
    return g

  out = {}
  torch.cuda.synchronize()
  _build.reset_launches()
  t0 = time.perf_counter()
  with torch.inference_mode():
    v_gpu = model(x.cuda())
  torch.cuda.synchronize()
  fwd_s = time.perf_counter() - t0
  out['forward_launches'] = _launched('enformer_1152', _build.launches())
  relu_gpu, relu_cpu = [], []
  _build.reset_launches()
  t0 = time.perf_counter()
  g_gpu = grad(x.cuda(), relu_gpu)
  torch.cuda.synchronize()
  grad_s = time.perf_counter() - t0
  out['grad_launches'] = _launched('enformer_1152_grad', _build.launches())
  model.cpu()
  with torch.inference_mode():
    v_cpu = model(x[:CPU_ROWS])
  g_cpu = grad(x[:CPU_ROWS], relu_cpu)
  err_v, scale_v = _card_vs_cpu('enformer_1152 value', v_gpu[:CPU_ROWS].cpu(),
                                v_cpu)
  flipped_rows, edge = set(), 0.0
  for a, b in zip(relu_gpu, relu_cpu):
    flip = (a > 0) != (b > 0)
    if flip.any():
      edge = max(edge, float(torch.maximum(a[flip].abs(), b[flip].abs()).max()))
      flipped_rows.update(int(r) for r in torch.nonzero(flip)[:, 0])
  if edge > RELU_EDGE or len(flipped_rows) > CPU_ROWS // 8:
    raise AssertionError(f'enformer_1152: FFN relu inputs up to {edge} took '
                         f'other sides of 0 in rows {sorted(flipped_rows)}')
  keep = [r for r in range(CPU_ROWS) if r not in flipped_rows]
  err_g, scale_g = _card_vs_cpu('enformer_1152 input gradient',
                                g_gpu[keep].cpu(), g_cpu[keep])
  out.update({'channels': OFFGRID_CHANNELS, 'stem_width': OFFGRID_CHANNELS // 2,
              'rows': MODEL_ROWS, 'length': MODEL_L, 'forward_s': fwd_s,
              'grad_s': grad_s, 'value_max_abs_err': err_v,
              'value_max_abs': scale_v, 'grad_max_abs_err': err_g,
              'grad_max_abs': scale_g,
              'grad_rows_relu_flipped': sorted(flipped_rows),
              'relu_flip_max_abs_input': edge})
  del model
  torch.cuda.empty_cache()
  return out


# ---------------------------------------------------------------------------
# phase 4: the decode
# ---------------------------------------------------------------------------


# the guided decodes' steps: the CLIs' 128 cut in depth, for the smoke's
# time limit (64 until phase 12 needed the time)
DECODE_STEPS = 32
# the SVDD-MC decode with the off-grid value net: B11b inside the loop at
# N = B*M = 5120
OFFGRID_DECODE_STEPS = 8


def _check_npz(path: str, rows: int = 512):
  """The npz's keys ('decoding', 'baseline') and their shapes (rows,),
  finite."""
  import numpy as np
  d = np.load(path)
  if set(d.files) != {'decoding', 'baseline'}:
    raise AssertionError(f'npz keys {d.files}')
  for key in d.files:
    if d[key].shape != (rows,) or not np.isfinite(d[key]).all():
      raise AssertionError(f'npz {key}: shape {d[key].shape} or '
                           'non-finite values')
  return sorted(d.files)


def _check_ess(trace, steps: int, batch: int = 512) -> None:
  """An ESS trace: one value a step (a row a batch), each in [1, B]."""
  import numpy as np
  ess = np.asarray(trace, dtype=np.float64).reshape(-1, steps)
  if not ((ess >= 1 - 1e-2) & (ess <= batch * (1 + 1e-5))).all():
    raise AssertionError(f'ESS trace outside [1, {batch}]: {ess}')


def run_decode(algo: str, run_name: str | None = None,
               steps: int = DECODE_STEPS, value_kwargs=None,
               bf16: bool = False, extra_argv=(), task: str = 'dna'):
  """One decode through its CLI's ``run``: B=512, DECODE_STEPS (or
  ``steps``), --task dna (L=200) or rna (L=50, the ConvGRU value net),
  float32 (or, ``bf16``, under the bf16 switches), --skip_best_of_n,
  M=10 for SVDD-MC and SVDD-PM, TDS at the CLI's alpha 0.5, DG through
  decode_DG's parser, the value net of ``value_kwargs``
  (EnformerValueModel arguments) where given, ``extra_argv`` appended;
  the launch counts are set to 0 just before and read just after: every
  kernel of the path (``run_name``'s) must have run, and an RNA decode's
  counts must be exactly ``rna_decode_launches``'."""
  run_name = run_name or algo
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  from svdd_tpu_torch.cli import (decode_classfier, decode_DG, decode_DPS,
                                  decode_TDS, decode_tweedie)
  run, parser, suffix = {
      'svdd_mc': (cli_decode.run, cli_decode.parser(), ''),
      'dps': (decode_DPS.run, decode_DPS.parser(), decode_DPS.NPZ_SUFFIX),
      'dg': (decode_DPS.run, decode_DG.parser(), decode_DPS.NPZ_SUFFIX),
      'classifier': (decode_classfier.run, decode_classfier.parser(),
                     decode_classfier.NPZ_SUFFIX),
      'svdd_pm': (decode_tweedie.run, decode_tweedie.parser(),
                  decode_tweedie.NPZ_SUFFIX),
      'tds': (decode_TDS.run, decode_TDS.parser(), decode_TDS.NPZ_SUFFIX),
  }[algo]
  out_dir = os.path.join(REPO, 'build', 'chip_smoke', run_name)
  argv = ['--task', task, '--batch_size', '512', '--skip_best_of_n',
          '--device', 'cuda', '--num_steps', str(steps),
          '--out_dir', out_dir, '--run_name', f'chip_smoke_{run_name}']
  if algo in ('svdd_mc', 'svdd_pm'):
    argv += ['--sample_M', '10']
  args = parser.parse_args(argv + list(extra_argv))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  with bf16_switches(bf16):
    report = (run(args, value_kwargs=value_kwargs) if value_kwargs
              else run(args))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  if task == 'rna':
    _check_launches(run_name, launches, rna_decode_launches(algo, steps))
  need = {**PATH_KERNELS, **OFFGRID_KERNELS, **BF16_RUNS,
          **RNA_RUNS}[run_name]
  missing = [k for k in need if launches[k] == 0]
  if missing:
    raise AssertionError(f'{run_name} decode never launched {missing}')
  npz_keys = _check_npz(common.npz_path(args, suffix))
  row = json.loads(open(os.path.join(
      out_dir, f'{args.run_name}.metrics.jsonl')).read().splitlines()[-1])
  dtype = 'bfloat16' if bf16 else 'float32'
  # the RNA value net, the ConvGRU, computes in f32 under the switches
  value_dtype = 'float32' if task == 'rna' else dtype
  if row['denoiser_dtype'] != dtype or row.get('value_dtype',
                                               value_dtype) != value_dtype:
    raise AssertionError(f'{run_name}: metrics row dtypes {row}')
  out = {'algo': algo, 'run': run_name, 'task': task, 'batch_size': 512,
         'length': 50 if task == 'rna' else 200, 'steps': steps,
         'compute_dtype': dtype,
         'value_net': value_kwargs or ('ConvGRUValueModel' if task == 'rna'
                                       else 'EnformerValueModel defaults'),
         'npz': os.path.basename(common.npz_path(args, suffix))}
  if algo in ('svdd_mc', 'svdd_pm'):
    out['sample_M'] = 10
    out['m_schedule'] = row['m_schedule']
  elif algo == 'tds':
    out['alpha'] = args.alpha
    _check_ess(row['ess_trace'], steps)
    out.update({k: row[k] for k in ('ess_min', 'ess_median', 'ess_final',
                                    'ess_trace')})
  else:
    out['guidance_scale'] = args.guidance_scale
  out.update({'wall_s': wall,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
              'guided_reward_mean': report['decoding']['mean'],
              'baseline_reward_mean': report['baseline']['mean'],
              'launches': launches, 'npz_keys': npz_keys})
  return out


def run_oracle_decode(run_name: str):
  """SVDD-PM (M=10) or TDS (alpha 0.5) through ``decode.run_decode`` with
  the full-width Enformer reward oracle (``RewardOracle.create_dna``,
  three tasks, f32, its fused eval tower) as the reward: B=512, L=200,
  ORACLE_STEPS steps, the baseline without best-of-N; the launch counts
  are set to 0 just before and read just after, and every kernel of the
  path must have run. The npz goes under build/chip_smoke."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.decode import run_decode as decode
  from svdd_tpu_torch.rewards import RewardOracle
  algo = run_name.split('_enformer')[0]
  args = common.make_parser('chip smoke').parse_args(
      ['--task', 'dna', '--batch_size', '512', '--device', 'cuda',
       '--num_steps', str(ORACLE_STEPS)])
  cfg = common.task_config(args)
  with bf16_switches(False):
    diffusion = common.load_diffusion(args, cfg)
  oracle = RewardOracle.create_dna(torch.Generator('cuda').manual_seed(2))
  oracle.module.to('cuda')
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  result = decode(diffusion, oracle, algo=algo, batch_size=512,
                  sample_M=10, alpha=0.5, seed=args.seed,
                  skip_best_of_n=True)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  missing = [k for k in ORACLE_RUNS[run_name] if launches[k] == 0]
  if missing:
    raise AssertionError(f'{run_name} decode never launched {missing}')
  path = os.path.join(REPO, 'build', 'chip_smoke', run_name,
                      f'dna-HepG2_{run_name}.npz')
  result.save_npz(path)
  out = {'algo': algo, 'run': run_name, 'task': 'dna', 'batch_size': 512,
         'length': 200, 'steps': ORACLE_STEPS, 'compute_dtype': 'float32',
         'reward': 'RewardOracle.create_dna (EnformerValueModel defaults, '
                   '3 tasks, fused)',
         'wall_s': wall,
         'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
         'guided_reward_mean': float(result.reward_preds.mean()),
         'baseline_reward_mean': float(result.baseline_preds.mean()),
         'launches': launches, 'npz_keys': _check_npz(path)}
  if algo == 'svdd_pm':
    out['sample_M'] = 10
  else:
    ess = result.diagnostics['ess']
    _check_ess(ess, ORACLE_STEPS)
    out.update({'alpha': 0.5, 'ess_trace': [round(float(v), 2)
                                            for v in ess.mean(0)],
                **{k: result.diagnostics[k] for k in ('ess_min', 'ess_median',
                                                      'ess_final')}})
  del oracle, diffusion
  return out


SAMPLE_EVAL = {
    # which: (rows, steps, --gen_ppl_model); 32 steps since phase 12's
    # pipelined runs came (64 since the RNA phase, 128 before), to keep
    # the smoke inside its time limit
    'text_mdlm': (64, 32, 'ar'),
    'dimamba': (512, 32, None),
}


def run_sample_eval(which: str):
  """One ``main_gosai --mode sample_eval`` run through its ``run`` at
  full width (``sample_eval_backbone``), one batch, 32 steps; the text
  preset with its ddpm_cache predictor at 64 rows (cut from 512 and 1000
  steps for the smoke's time) scored by the AR backbone, DiMamba at the
  DNA task's 512 rows with the ddpm predictor. The launch counts are set
  to 0 just before and read just after; every kernel of the path must
  have run."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  rows, steps, scorer = SAMPLE_EVAL[which]
  cfg, backbone = sample_eval_backbone(which)
  cfg.loader.eval_batch_size = rows
  cfg.sampling.steps = steps
  cfg.sampling.num_sample_batches = 1
  argv = ['--mode', 'sample_eval', '--device', 'cuda', '--ckpt_dir',
          os.path.join(REPO, 'build', 'chip_smoke', 'no_checkpoint'),
          '--data_dir', _no_data_dir()]
  if scorer:
    argv += ['--gen_ppl_model', scorer]
  args = main_gosai.parser().parse_args(argv)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  out = main_gosai.run(args, cfg, backbone=backbone)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  missing = [k for k in PATH_KERNELS[which] if launches[k] == 0]
  if missing:
    raise AssertionError(f'{which} sample_eval never launched {missing}')
  tokens = out['tokens']
  if tokens.shape != (rows, cfg.model.length) or tokens.min() < 0 or \
      tokens.max() >= cfg.mask_index:
    raise AssertionError(f'{which}: tokens {tokens.shape} in '
                         f'[{tokens.min()}, {tokens.max()}]')
  if scorer and not np.isfinite(out['gen_ppl']):
    raise AssertionError(f'{which}: gen_ppl {out["gen_ppl"]}')
  res = {'path': which, 'backbone': cfg.backbone, 'task': cfg.task,
         'predictor': cfg.sampling.predictor, 'batch_size': rows,
         'length': cfg.model.length, 'steps': steps,
         'precision': cfg.parallel.precision, 'wall_s': wall,
         'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
         'gen_ppl': out['gen_ppl'], 'launches': launches,
         'distinct_tokens': int(np.unique(tokens).size)}
  if which == 'text_mdlm':
    # 12 blocks per DiT forward: the ddpm_cache forwards, removal included
    res['denoiser_forwards'] = launches['flash_attention'] // cfg.model.n_blocks
  return res


# ---------------------------------------------------------------------------
# phase 5: where the time of one guided step goes
# ---------------------------------------------------------------------------

# kernel name fragment -> kind, first match wins
KINDS = (('flash_attention', 'flash_attention'), ('rmsnorm', 'rmsnorm'),
         ('attn_pool_logits', 'attn_pool_logits'),
         ('nacdr_im2col', 'nacdr_im2col'), ('fused_conv_kernel', 'fused_conv1d'),
         ('cnn_layer_kernel', 'cnn_layer'), ('cnn_bwd_', 'cnn_layer_bwd'),
         ('conv_bwd_', 'conv1d_bwd'), ('pool_bwd_', 'attn_pool_bwd'),
         ('reduce_partials', 'bwd_partial_sums'), ('attn_pool', 'attn_pool'),
         ('attn_l2', 'attn_l2'), ('gumbel_candidates', 'gumbel_candidates'),
         ('gemm', 'gemm'), ('nvjet', 'gemm'), ('fprop', 'conv'),
         ('dgrad', 'conv'),
         ('wgrad', 'conv'), ('conv', 'conv'),
         ('memcpy', 'memcpy_memset'), ('memset', 'memcpy_memset'))
LIBRARY_KINDS = ('gemm', 'conv', 'memcpy_memset', 'other')


def _kind(name: str) -> str:
  low = name.lower()
  return next((k for frag, k in KINDS if frag in low), 'other')


def profile_step(algo: str, bf16: bool = False, task: str = 'dna'):
  """One step of a decode at its shapes (B=512, L=200, M=10 for SVDD-MC
  and SVDD-PM, the same models, the CLIs' synthetic oracle as PM's and
  TDS's reward, whose steps run with a valid posterior carry, as every
  step after the first does; 64 rows at L=1024 for the text preset's ddpm_cache
  step, which runs its forward from an empty cache; 512 rows at L=200
  for DiMamba's ddpm step) under torch.profiler, from the all-MASK prior
  at t=0.5. host_step_ms: mean host time of 3 synchronised steps after a
  warm-up, unprofiled. device_busy_ms: the union of the card's kernel
  and copy intervals in the profiled step; idle_share = 1 -
  device_busy_ms / profiled_step_ms (host time of the profiled step, to
  its synchronize, which the profiler lengthens most where a step
  launches most), idle_share_host = 1 - device_busy_ms / host_step_ms.
  by_kind_ms: summed kernel time by kind ('other' is
  PyTorch's elementwise and reduction glue, 'conv' and 'gemm' the
  library's convolutions and matrix products, cuBLAS's bf16 'nvjet'
  kernels among them). The profiled step follows one warm-up step under
  the profiler. port_kernel_events: the port's kernels in its trace;
  port_kernel_launches: the wrapper launches the step counted;
  trace_complete: the trace holds at least one kernel a launch.
  ``bf16``: a guided step with the models the bf16 switches build.
  ``task`` 'rna': the guided step at --task rna (L=50, the ConvGRU value
  net)."""
  import torch
  from svdd_tpu_torch import mdlm
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.sampling import guidance, sampler
  mode = (torch.inference_mode if algo in ('svdd_mc', 'svdd_pm', 'tds')
          else torch.no_grad)
  if algo in SAMPLE_EVAL:
    cfg, backbone = sample_eval_backbone(algo)
    batch = SAMPLE_EVAL[algo][0]
    diffusion = Diffusion(cfg, device='cuda', backbone=backbone)
    mode = torch.inference_mode
    if algo == 'text_mdlm':
      cache_step = sampler.ddpm_cache_step(diffusion.forward,
                                           diffusion.schedule, cfg.mask_index)
      step = lambda *a: cache_step((None, False), *a)
    else:
      step = sampler.ddpm_step(diffusion.forward, diffusion.schedule,
                               cfg.mask_index)
  else:
    args = common.make_parser('chip smoke').parse_args(
        ['--task', task, '--batch_size', '512', '--sample_M', '10',
         '--device', 'cuda'])
    cfg = common.task_config(args)
    batch = args.batch_size
    with bf16_switches(bf16):
      diffusion = common.load_diffusion(args, cfg)
      vf = (None if algo in ('dps', 'svdd_pm', 'tds')
            else common.load_value_function(args, cfg))
    # the posterior carry of a step after the first: the (B,) forward it
    # replaces is not run
    carry = (torch.zeros((batch, cfg.model.length, cfg.vocab_size),
                         device='cuda'), True) if vf is None else None
    if algo == 'svdd_pm':
      pm = guidance.svdd_pm_step(diffusion.forward,
                                 common.load_reward_fn(args, cfg),
                                 diffusion.schedule, cfg.mask_index,
                                 repeats=args.sample_M, carry_posterior=True)
      step = lambda *a: pm(carry, *a)
    elif algo == 'tds':
      tds = guidance.tds_step(diffusion.forward,
                              common.load_reward_fn(args, cfg),
                              diffusion.schedule, cfg.mask_index, alpha=0.5,
                              carry_posterior=True, track_ess=True,
                              num_steps=DECODE_STEPS)
      aux = guidance.tds_aux_init(batch, carry, track_ess=True,
                                  num_steps=DECODE_STEPS)
      step = lambda *a: tds(aux, *a)
    elif algo == 'svdd_mc':
      step = guidance.svdd_mc_step(diffusion.forward, vf.score_tokens,
                                   diffusion.schedule, cfg.mask_index,
                                   repeats=args.sample_M)
    elif algo == 'dps':
      step = guidance.dps_step(diffusion.forward_onehot,
                               common.load_reward_fn(args, cfg),
                               diffusion.schedule, cfg.mask_index,
                               guidance_scale=1e5)
    else:
      step = guidance.classifier_step(diffusion.forward, vf.as_onehot_fn(),
                                      diffusion.schedule, cfg.mask_index)
  gen = torch.Generator('cuda').manual_seed(0)
  x = mdlm.sample_prior((batch, cfg.model.length), cfg.mask_index, 'cuda')
  t, t_next = torch.tensor(0.5), torch.tensor(0.49)

  def once():
    with mode():
      step(x, t, t_next, gen)
    torch.cuda.synchronize()

  name = f'{algo}_bf16' if bf16 else algo
  return {'algo': f'rna_{name}' if task == 'rna' else name,
          'batch_size': batch, 'length': cfg.model.length,
          **trace_step(once)}


def trace_step(once) -> dict:
  """Time and trace ``once`` (one synchronised step): a warm-up call, the
  host mean of 3, then one warm-up and one recorded call under
  torch.profiler (``profile_step`` says what each number is)."""
  import torch
  from torch.profiler import ProfilerActivity, profile, schedule
  from svdd_tpu_torch import _build
  once()
  t0 = time.perf_counter()
  for _ in range(3):
    once()
  host_ms = (time.perf_counter() - t0) / 3 * 1e3
  # one warm-up step under the profiler before the recorded one: a trace
  # that starts cold can lose the step's first device events
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               schedule=schedule(wait=0, warmup=1, active=1,
                                 repeat=1)) as prof:
    once()
    prof.step()
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    once()
    prof_ms = (time.perf_counter() - t0) * 1e3
    launched = sum(_build.LAUNCHES[k] - before[k] for k in before)
    prof.step()
  # the card's kernels and copies; the schedule's ProfilerStep span also
  # lies on the card's timeline, and is left out
  dev = [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not e.name.startswith('ProfilerStep')]
  # the port's kernels the trace holds against the wrapper launches the
  # step counted (a wrapper launches one or more port kernels)
  traced = sum(1 for e in dev if _kind(e.name) not in LIBRARY_KINDS)
  spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
  busy_us, end = 0.0, float('-inf')
  for a, b in spans:                   # length of the union of intervals
    if b > end:
      busy_us += b - max(a, end)
      end = b
  by_kind = {}
  for e in dev:
    k = _kind(e.name)
    by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end -
                                        e.time_range.start) / 1e3
  busy_ms = busy_us / 1e3
  return {'host_step_ms': host_ms,
          'profiled_step_ms': prof_ms, 'device_events': len(dev),
          'port_kernel_events': traced, 'port_kernel_launches': launched,
          'trace_complete': traced >= launched,
          'device_busy_ms': busy_ms,
          'idle_share': 1 - busy_ms / prof_ms if dev else None,
          'idle_share_host': 1 - busy_ms / host_ms if dev else None,
          'by_kind_ms': dict(sorted(by_kind.items(),
                                    key=lambda kv: -kv[1]))}


def time_dit_forward(rows: int = 512):
  """Host ms of one full-width DiT forward (the text preset, bf16
  precision, L=1024) at the preset's 512 rows: mean of 2 synchronised
  forwards after a warm-up. A full preset run (1000 ddpm_cache steps)
  costs up to 1001 of these per batch."""
  import torch
  cfg, model = sample_eval_backbone('text_mdlm')
  g = torch.Generator('cuda').manual_seed(4)
  x = torch.randint(0, cfg.vocab_size, (rows, cfg.model.length),
                    device='cuda', generator=g)
  sigma = torch.zeros(rows, device='cuda')
  torch.cuda.reset_peak_memory_stats()
  with torch.inference_mode():
    model(x, sigma)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
      model(x, sigma)
    torch.cuda.synchronize()
  return {'rows': rows, 'length': cfg.model.length,
          'dit_forward_ms': (time.perf_counter() - t0) / 2 * 1e3,
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30}


# ---------------------------------------------------------------------------
# phase 6: diffusion pretraining
# ---------------------------------------------------------------------------

# the reference training configuration (the JAX bench's: global batch
# 512 as two microbatches of 256), cut to TRAIN_STEPS steps with a short
# warmup, validation, the sample-quality hook and checkpoints every 20
TRAIN_STEPS = 40
TRAIN_SET = ['training.accum_steps=2', 'optim.warmup_steps=10',
             'eval.val_check_interval=20', 'checkpointing.every_n_steps=20']
TRAIN_KERNELS = ('cnn_layer', 'cnn_layer_bwd')
CNN_LAYERS = 20
RESUME_CRASH = 30
TRAIN_CPU_ROWS = 8
TRAIN_TOL = 1e-4   # f32 card vs CPU, relative by norm
# f32, on the same relu masks: each gradient's distance by norm on the
# card to the float64 step within F64_MULT times the CPU's own f32
# distance to it, plus F64_FLOOR (16 f32 ulps) relative. The layer
# kernels compute f32 products as 3xTF32 (about 2^-20 relative a
# product): 8.2 times the CPU's distance at worst in the first chip run
# of this check, NVIDIA H100 80GB HBM3, 700 W
F64_MULT, F64_FLOOR = 16.0, 2.0 ** -20


def _train_dir(name: str) -> str:
  import shutil
  path = os.path.join(REPO, 'build', 'chip_smoke', name)
  shutil.rmtree(path, ignore_errors=True)
  return path


def _no_data_dir() -> str:
  """The data directory of every run that reads the Gosai splits: an
  empty directory of the checkout, so that each run draws the synthetic
  split, whatever the host holds under $SVDD_DATA_DIR or /data/svdd."""
  path = _train_dir('no_data')
  os.makedirs(path)
  return path


def run_train(bf16: bool) -> dict:
  """``main_gosai --mode train --task dna`` through its ``run`` at full
  width (hidden 128, 20 layers, L=200) on the synthetic split: global
  batch 512, accum 2, TRAIN_STEPS steps (the CLI logs the training loss
  every 100, so none here), val NLL and the sample-quality hook (2
  batches of 64 EMA samples, 128 steps) at steps 20 and 40, and
  checkpoints there; in f32 (TF32 off) or under the bf16 switches. The
  launch counts are set to 0 just before and read just after: B6 must
  have run exactly 20 layers x 2 microbatches x steps times. The
  per-step losses and times come from ``check_resume``'s runs."""
  import json as _json
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  name = 'train_bf16' if bf16 else 'train_f32'
  root = _train_dir(name)
  argv = ['--mode', 'train', '--task', 'dna', '--device', 'cuda',
          '--max_steps', str(TRAIN_STEPS), '--data_dir', _no_data_dir(),
          '--ckpt_dir', os.path.join(root, 'ckpt'),
          '--log_dir', os.path.join(root, 'log'), '--set', *TRAIN_SET]
  args = main_gosai.parser().parse_args(argv)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with bf16_switches(bf16):
    _build.reset_launches()
    t0 = time.perf_counter()
    out = main_gosai.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launches()
  missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
  want_bwd = CNN_LAYERS * 2 * TRAIN_STEPS
  if missing or launches['cnn_layer_bwd'] != want_bwd:
    raise AssertionError(f'{name}: launches {launches}, B6 should run '
                         f'{want_bwd} times')
  rows = [_json.loads(line) for line in open(out['metrics_path'])]
  nlls = [(r['_step'], r['val/nll']) for r in rows if 'val/nll' in r]
  quality = [r for r in rows if 'kmer_pearson' in r]
  if ([s for s, _ in nlls] != [20, 40] or len(quality) != 2
      or any('train/loss' in r for r in rows)
      or not np.isfinite([v for _, v in nlls]).all()):
    raise AssertionError(f'{name}: metrics {rows}')
  ckpts = sorted(os.listdir(os.path.join(root, 'ckpt')))
  if ckpts != ['best', 'step_20.pt', 'step_40.pt']:
    raise AssertionError(f'{name}: checkpoints {ckpts}')
  # the wall clock of the metrics rows: each hook after its step's
  # validation row
  at = {(r['_step'], k): r['_time'] for r in rows for k in
        ('val/nll', 'kmer_pearson') if k in r}
  timing = {'hook_s': [at[(s, 'kmer_pearson')] - at[(s, 'val/nll')]
                       for s, _ in nlls]}
  state = out['state']
  cfg = state.model.config
  return {'run': name, 'batch_size': cfg.loader.global_batch_size,
          'accum_steps': cfg.training.accum_steps,
          'length': cfg.model.length, 'steps': state.step, 'wall_s': wall,
          **timing, 'val_nll': nlls, 'sample_quality_last': {
              k: v for k, v in quality[-1].items() if not k.startswith('_')},
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'launches': launches, 'ckpt_dir': os.path.join(root, 'ckpt')}


class _LossRows:
  """A metrics sink keeping each step's train/loss and the host clock
  when it was logged."""

  def __init__(self):
    self.losses, self.times = {}, {}

  def log(self, metrics, step=None):
    if 'train/loss' in metrics:
      self.losses[step] = metrics['train/loss']
      self.times[step] = time.perf_counter()


def _resume_run(name: str, steps: int, ckpt_dir: str, crash: bool = False):
  """Trainer.fit at the training phase's configuration (f32, log_every
  1, checkpoints every 20, no validation) for ``steps`` more steps from
  the newest checkpoint under ``ckpt_dir``; ``crash`` sets
  SVDD_CRASH_AT_STEP=RESUME_CRASH. Returns (state, losses by step)."""
  from svdd_tpu_torch.cli import main_gosai
  from svdd_tpu_torch.data import gosai
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.train import diffusion as train_diff
  cfg = main_gosai.build_config(main_gosai.parser().parse_args(
      ['--set', *TRAIN_SET]))
  train_it, _, _ = gosai.get_dataloaders(cfg, skip_valid=True,
                                         data_dir=_no_data_dir())
  rows = _LossRows()
  trainer = train_diff.Trainer(Diffusion(cfg, device='cuda'), cfg,
                               ckpt_dir=ckpt_dir, logger=rows)
  state = trainer.init_or_restore(train_it)
  if crash:
    os.environ['SVDD_CRASH_AT_STEP'] = str(RESUME_CRASH)
  try:
    state = trainer.fit(state, train_it, num_steps=steps - state.step,
                        log_every=1, ckpt_every=20)
  except RuntimeError as e:
    if not crash or 'SVDD_CRASH_AT_STEP' not in str(e):
      raise
  finally:
    os.environ.pop('SVDD_CRASH_AT_STEP', None)
  return state, rows, name


def check_resume() -> dict:
  """Resume on the card: a run to step 40 that dies after step 30 (its
  last checkpoint at 20), a run resuming from its directory to step 40,
  and a clean run to 40. The resumed run's losses from step 21 on and
  its final parameters, EMA and generator must equal the clean run's bit
  for bit. Also the clean run's loss at its first and last step and its
  host ms a step over steps 31-40 (the loss read back every step)."""
  import torch
  from svdd_tpu_torch.cli import common
  common.full_f32()
  crashed_dir = _train_dir('resume_crashed')
  _, crashed, _ = _resume_run('crashed', TRAIN_STEPS, crashed_dir, crash=True)
  resumed_state, resumed, _ = _resume_run('resumed', TRAIN_STEPS, crashed_dir)
  clean_state, clean_rows, _ = _resume_run('clean', TRAIN_STEPS,
                                           _train_dir('resume_clean'))
  crashed, resumed, clean = crashed.losses, resumed.losses, clean_rows.losses
  steps = sorted(resumed)
  diff = {s: abs(resumed[s] - clean[s]) for s in steps}
  same_params = all(
      torch.equal(a, b) for a, b in zip(
          resumed_state.model.backbone.state_dict().values(),
          clean_state.model.backbone.state_dict().values()))
  same_ema = all(torch.equal(v, clean_state.ema.shadow[k])
                 for k, v in resumed_state.ema.shadow.items())
  r = {'crashed_steps': max(crashed), 'resumed_from': steps[0] - 1,
       'steps_compared': [steps[0], steps[-1]],
       'max_loss_diff': max(diff.values()), 'params_equal': same_params,
       'ema_equal': same_ema,
       'generator_equal': torch.equal(resumed_state.generator.get_state(),
                                      clean_state.generator.get_state()),
       'crashed_vs_clean_max_loss_diff': max(
           abs(crashed[s] - clean[s]) for s in crashed),
       'loss_first': (1, clean[1]), 'loss_last': (TRAIN_STEPS,
                                                  clean[TRAIN_STEPS]),
       'step_ms_31_to_40': (clean_rows.times[TRAIN_STEPS]
                            - clean_rows.times[30]) / 10 * 1e3}
  if (max(crashed) != RESUME_CRASH or steps != list(range(21, 41))
      or r['max_loss_diff'] != 0 or not same_params or not same_ema
      or not r['generator_equal']):
    raise AssertionError(f'resume on the card differs: {r}')
  return r


def run_ckpt_readers(ckpt_dir: str, sets=TRAIN_SET) -> dict:
  """``--mode ppl_eval`` and ``--mode sample_eval`` (one batch of 512,
  128 steps) from a training run's checkpoint directory (the f32 run's,
  or, with ``sets``, a phase 10 run's, under its --set)."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  common = ['--device', 'cuda', '--ckpt_dir', ckpt_dir,
            '--data_dir', _no_data_dir(), '--set', *sets,
            'sampling.num_sample_batches=1']
  cfg = main_gosai.build_config(main_gosai.parser().parse_args(common))
  _build.reset_launches()
  t0 = time.perf_counter()
  ppl = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'ppl_eval', *common]))
  torch.cuda.synchronize()
  ppl_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  toks = main_gosai.run(main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', *common]))['tokens']
  torch.cuda.synchronize()
  sample_s = time.perf_counter() - t0
  launches = _build.launches()
  if (not np.isfinite(ppl['nll'])
      or toks.shape != (cfg.loader.eval_batch_size, cfg.model.length)
      or toks.min() < 0 or toks.max() > 3 or launches['cnn_layer'] == 0):
    raise AssertionError(f'checkpoint readers: {ppl}, tokens {toks.shape} '
                         f'{launches}')
  return {'ppl_eval': ppl, 'ppl_eval_s': ppl_s, 'sample_eval_s': sample_s,
          'distinct_tokens': int(np.unique(toks).size),
          'launches': {k: v for k, v in launches.items() if v}}


def _train_once(model, cfg, noise, dev, taps=None):
  """One train_step of ``model`` moved to ``dev`` on the fixed batch and
  noise: (loss, {name: clipped gradient}, {name: the update, parameter
  after minus before}). ``taps``, a list, gets what ``_relu_masks`` reads
  of the step's forwards."""
  import copy
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.train import diffusion as train_diff
  den = Diffusion(cfg, device=dev, backbone=copy.deepcopy(model))
  state = train_diff.init_state(den, cfg)
  hooks = [] if taps is None else [
      layer.register_forward_pre_hook(
          lambda mod, args: taps.append(
              [None if a is None else a.detach()
               for a in (args[0], args[1], args[4] if len(args) > 4
                         else None)]))
      for layer in den.backbone.layers] + [
          den.backbone.layers[-1].register_forward_hook(
              lambda mod, args, out: taps.append([out.detach()]))]
  seqs, noise = noise
  loss = train_diff.train_step(state, {'seqs': seqs}, cfg,
                               [(t.to(dev), q.to(dev)) for t, q in noise])
  for h in hooks:
    h.remove()
  before = dict(model.named_parameters())
  named = dict(den.backbone.named_parameters())
  return (float(loss), {k: p.grad.detach().cpu() for k, p in named.items()},
          {k: p.detach().cpu() - before[k].detach() for k, p in named.items()})


def _relu_masks(model, taps, dev) -> list:
  """For each forward of a training step, from the inputs its layers were
  given (``taps``: each layer's (input, time embedding, class embedding
  or None), then the last layer's output): the relu masks of the stem,
  of each layer and of the first 1x1 conv as that forward computed them
  on ``dev`` with ``model``'s weights before the update. The stem's is where layer 0's
  input is positive; a layer's is the one its backward kernel reports
  (the forward kernel's, bit for bit; on the CPU the plain version's);
  the 1x1 conv's is its forward again, on the same inputs. As CPU bool
  tensors: [{'stem', 'layers', 'final_0'}, ...]."""
  import copy
  import torch
  from svdd_tpu_torch.ops import cnn_layer as K
  from svdd_tpu_torch.ops.conv1d import _conv_forward
  m = copy.deepcopy(model).to(dev)
  n_layers, out = len(m.layers), []
  per_call = n_layers + 1
  with torch.no_grad():
    for c in range(len(taps) // per_call):
      call = taps[c * per_call:(c + 1) * per_call]
      layers = []
      for layer, (x, emb, cls_emb) in zip(m.layers, call):
        *_, mask = K.cnn_layer_bwd(
            x, layer.bias_row(emb, cls_emb), layer.ln_scale, layer.ln_bias,
            layer.kernel.to(x.dtype), layer.conv_bias, torch.zeros_like(x),
            dilation=layer.dilation, return_mask=True)
        layers.append(mask.cpu())
      last = call[-1][0]
      out.append({'stem': (call[0][0] > 0).cpu(), 'layers': layers,
                  'final_0': (_conv_forward(last, m.final_0_kernel,
                                            m.final_0_bias, 1) > 0).cpu()})
  return out


def _conv_f64(x, kernel, bias, dilation):
  """SAME conv of x (N, L, Cin) with a flax-layout kernel, plain torch."""
  import torch.nn.functional as F
  k = kernel.shape[0]
  return F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), bias,
                  padding=(k - 1) // 2 * dilation,
                  dilation=dilation).transpose(1, 2)


def _forward_f64(self, seq, sigma, x_onehot=None, train=False,
                 generator=None):
  """The CNN denoiser's forward in float64 by plain autograd ops: the
  time embedding, the stem, each layer's relu(conv(LN(x + bias_row))) +
  x (the bias row holding the null class's projection in a
  class-conditioned net) and the two 1x1 convs, through no kernel and no
  plain version of the port. Where ``self.relu_masks`` holds the masks of another run (one
  entry a forward, ``_relu_masks``), each relu takes that run's side of
  0; ``self.flips`` then gets, a relu, how many inputs that mask puts on
  the other side from this forward's and the largest |input| among
  them."""
  import torch
  import torch.nn.functional as F
  f64 = torch.float64
  masks = self.relu_masks.pop(0) if self.relu_masks else None

  def relu(y, name, i=None):
    if masks is None:
      return torch.relu(y)
    m = masks[name] if i is None else masks[name][i]
    other = (y > 0) != m
    self.flips.append((int(other.sum()), float(
        y.detach()[other].abs().max()) if other.any() else 0.0))
    return y * m.to(f64)

  emb = torch.relu(F.linear(self.gfp(sigma.to(f64)), self.time_linear.weight,
                            self.time_linear.bias))
  feat = relu(_conv_f64(F.one_hot(seq.long(), self.alphabet_size).to(f64),
                        self.stem_kernel, self.stem_bias, 1), 'stem')
  # a class-conditioned net at the null class
  cls_emb = (None if self.cls_embedder is None
             else self.cls_embedder[self.num_cls].expand(seq.shape[0], -1))
  for i, layer in enumerate(self.layers):
    h = feat + F.linear(emb, layer.time.weight, layer.time.bias)[:, None]
    if cls_emb is not None:
      h = h + F.linear(cls_emb, layer.cls.weight, layer.cls.bias)[:, None]
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + 1e-6) * layer.ln_scale + layer.ln_bias
    feat = relu(_conv_f64(h, layer.kernel, layer.conv_bias, layer.dilation),
                'layers', i) + feat
  feat = relu(_conv_f64(feat, self.final_0_kernel, self.final_0_bias, 1),
              'final_0')
  return _conv_f64(feat, self.final_1_kernel, self.final_1_bias, 1)


def _f64_denoiser(model, relu_masks=None):
  """A float64 copy of the CNN denoiser ``model`` (same parameter names)
  whose forward is ``_forward_f64``, on ``relu_masks`` where given."""
  import copy
  import types
  m = copy.deepcopy(model).double()
  # shared by the copies the training step makes
  m.relu_masks, m.flips = _Shared(relu_masks or []), _Shared()
  m.forward = types.MethodType(_forward_f64, m)
  return m


class _Shared(list):
  """A list that a deep copy shares rather than copies."""

  def __deepcopy__(self, memo):
    return self


def _replay_update(model, cfg, grads):
  """The update AdamW makes on the CPU from ``model``'s parameters and the
  given (clipped) gradients at the first update's rate: {name: parameter
  after minus before}."""
  import copy
  import torch
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.train import diffusion as train_diff
  den = Diffusion(cfg, device='cpu', backbone=copy.deepcopy(model))
  opt = train_diff.init_state(den, cfg).optimizer
  named = dict(den.backbone.named_parameters())
  for k, p in named.items():
    p.grad = grads[k].clone()
  for group in opt.adamw.param_groups:
    group['lr'] = opt.schedule(0)
  opt.adamw.step()
  before = dict(model.named_parameters())
  with torch.no_grad():
    return {k: p - before[k] for k, p in named.items()}


def check_train_step(f32_cpu=None, variant: str | None = None):
  """One training step of the full-width denoiser on TRAIN_CPU_ROWS rows
  (accum 2, rate lr from the first update, random weights with every
  parameter perturbed) with the same injected noise on the card and on
  the CPU; ``variant`` (a key of A1_STEP_VARIANTS) sets the config's
  parameterization, T, sampling_eps or class conditioning. B1 and B6 run
  exactly 20 x 2 times, 20 x 4 under D3PM with T > 0 (its
  reconstruction forward). f32: the loss within TRAIN_TOL relative; a
  third witness, the same step in float64 on the CPU through plain autograd
  (``_f64_denoiser``) on the relu masks the card's step took
  (``_relu_masks``): the card's loss and every parameter's clipped
  gradient within TRAIN_TOL of it, relative by norm, and each gradient
  within F64_MULT times the CPU's distance to the float64 step on the
  CPU's masks, plus F64_FLOOR. A relu input within rounding of 0 takes
  either side on the two devices, and one such input moves the
  gradients below its layer far past rounding (``raw``: the card
  against float64 on float64's own masks), so each mask may differ from
  float64's only where |input| <= RELU_EDGE. Given ``f32_cpu``, the f32
  run's CPU results, the model computes in bf16 and the loss and every
  gradient's norm error are held by ``bf16_close`` against the CPU's own
  bf16-to-f32 distance.
  In both, every parameter's update on the card within TRAIN_TOL by norm
  of the update AdamW makes on the CPU from the card's gradients:
  AdamW's first update is lr * g / (|g| + eps), so the two devices'
  gradients, equal within their error, would move an element whose
  gradient lies within that error of 0, or of eps, by up to 2 lr
  (``update_flips`` counts the elements whose two gradients differ in
  sign). Returns the report and the CPU results."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.models.cnn import CNNModel
  bf16 = f32_cpu is not None
  cfg = dna_config()
  cfg.training.accum_steps = 2
  cfg.optim.warmup_steps = 0
  if variant is not None:
    cfg = cfg.override(**A1_STEP_VARIANTS[variant])
  g = torch.Generator().manual_seed(3)
  model = CNNModel(cfg, compute_dtype=torch.bfloat16 if bf16 else
                   torch.float32, generator=torch.Generator().manual_seed(1))
  with torch.no_grad():
    for p in model.parameters():
      p.add_(0.05 * torch.randn(p.shape, generator=g))
  n, half = TRAIN_CPU_ROWS, TRAIN_CPU_ROWS // 2
  seqs = torch.randint(0, 4, (n, 200), generator=g)
  noise = (seqs, [(torch.rand(half, generator=g),
                   torch.rand(half, 200, generator=g)) for _ in range(2)])
  card_taps, cpu_taps = [], []
  _build.reset_launches()
  got = _train_once(model, cfg, noise, 'cuda', card_taps)
  torch.cuda.synchronize()
  launches = _build.launches()
  per = CNN_LAYERS * 2 * _forwards_a_microbatch(cfg)
  _check_launches(f'train step {variant}', {k: launches[k] for k in
                                            TRAIN_KERNELS},
                  {k: per for k in TRAIN_KERNELS})
  want = _train_once(model, cfg, noise, 'cpu', cpu_taps)
  norm = torch.linalg.vector_norm
  rel = lambda a, b: float(norm(a - b) / max(float(norm(b)), 1e-30))
  loss_err = abs(got[0] - want[0]) / abs(want[0])
  grad_rel = {k: rel(got[1][k], want[1][k]) for k in want[1]}
  grad_of_max = {k: float((got[1][k] - want[1][k]).abs().max()
                          / want[1][k].abs().max()) for k in want[1]}
  replay = _replay_update(model, cfg, got[1])
  upd_rel = {k: rel(got[2][k], u) for k, u in replay.items()}
  flips = sum(int((torch.sign(got[1][k]) != torch.sign(w)).sum())
              for k, w in want[1].items())
  n_params = sum(u.numel() for u in replay.values())
  r = {'variant': variant or 'subs',
       'compute_dtype': 'bfloat16' if bf16 else 'float32', 'rows': n,
       'loss_card': got[0], 'loss_cpu': want[0], 'loss_rel_err': loss_err,
       'max_grad_rel_norm_err': max(grad_rel.values()),
       'worst_grad': max(grad_rel, key=grad_rel.get),
       'max_grad_err_of_max': max(grad_of_max.values()),
       'max_update_rel_err': max(upd_rel.values()),
       'worst_update': max(upd_rel, key=upd_rel.get),
       'update_flips': flips, 'params': n_params,
       'launches': {k: launches[k] for k in TRAIN_KERNELS}}
  ok = (max(upd_rel.values()) <= TRAIN_TOL
        and all(torch.isfinite(v).all() for v in got[1].values()))
  if not bf16:
    refs, flips64 = {}, {}
    for name, masks in (('card', _relu_masks(model, card_taps, 'cuda')),
                        ('cpu', _relu_masks(model, cpu_taps, 'cpu')),
                        ('raw', None)):
      f64 = _f64_denoiser(model, masks)
      refs[name] = _train_once(f64, cfg, noise, 'cpu')
      flips64[name] = (sum(c for c, _ in f64.flips),
                       max((e for _, e in f64.flips), default=0.0))
    del card_taps, cpu_taps
    to64 = lambda a, b: float(norm(a.double() - b) / max(float(norm(b)),
                                                          1e-300))
    card64 = {k: to64(got[1][k], w) for k, w in refs['card'][1].items()}
    cpu64 = {k: to64(want[1][k], w) for k, w in refs['cpu'][1].items()}
    raw64 = {k: to64(got[1][k], w) for k, w in refs['raw'][1].items()}
    ratio = {k: card64[k] / max(cpu64[k], 1e-300) for k in card64}
    loss64 = abs(got[0] - refs['card'][0]) / abs(refs['card'][0])
    bad = [k for k, e in card64.items()
           if not e <= min(TRAIN_TOL, F64_MULT * cpu64[k] + F64_FLOOR)]
    r.update(loss_card_vs_f64=loss64,
             loss_cpu_vs_f64=abs(want[0] - refs['cpu'][0])
             / abs(refs['cpu'][0]),
             max_grad_card_vs_f64=max(card64.values()),
             worst_grad_card_vs_f64=max(card64, key=card64.get),
             max_grad_cpu_vs_f64=max(cpu64.values()),
             max_ratio_card_to_cpu=max(ratio.values()),
             worst_ratio_at=max(ratio, key=ratio.get),
             max_grad_card_vs_f64_raw=max(raw64.values()),
             relu_flips_card_vs_f64=flips64['card'],
             relu_flips_cpu_vs_f64=flips64['cpu'], not_close=bad)
    ok = (ok and loss_err <= TRAIN_TOL and loss64 <= TRAIN_TOL and not bad
          and flips64['card'][1] <= RELU_EDGE
          and flips64['cpu'][1] <= RELU_EDGE)
  else:
    loss_noise = abs(want[0] - f32_cpu[0]) / abs(want[0])
    grad_noise = {k: rel(want[1][k], f32_cpu[1][k]) for k in want[1]}
    bad = [k for k in grad_rel
           if not bf16_close(grad_rel[k], grad_noise[k], 1.0)]
    if not bf16_close(loss_err, loss_noise, 1.0):
      bad.append('loss')
    r.update(cpu_bf16_vs_f32_loss=loss_noise,
             cpu_bf16_vs_f32_max_grad_rel=max(grad_noise.values()),
             not_close=bad)
    ok = ok and not bad
  if not ok:
    raise AssertionError(f'train step card vs cpu: {r}')
  return r, want


def _forwards_a_microbatch(cfg) -> int:
  """Denoiser forwards (and backwards) of one training microbatch: two
  under D3PM with T > 0 (the reconstruction term), else one."""
  return 2 if cfg.parameterization == 'd3pm' and cfg.T > 0 else 1


def profile_train_step(bf16: bool, name: str | None = None,
                       sets=()) -> dict:
  """One optimizer step of the training phase's configuration (batch 512
  of the synthetic train split as two microbatches of 256, full width;
  ``sets``, a phase 10 run's --set, appended) traced as ``trace_step``
  traces a decode step, after a warm-up step; tokens_per_s = 512 x 200 /
  host_step_ms."""
  import torch
  from svdd_tpu_torch.cli import main_gosai
  from svdd_tpu_torch.data import gosai
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.train import diffusion as train_diff
  cfg = main_gosai.build_config(main_gosai.parser().parse_args(
      ['--set', *TRAIN_SET, *sets]))
  train_it, _, _ = gosai.get_dataloaders(cfg, skip_valid=True,
                                         data_dir=_no_data_dir())
  with bf16_switches(bf16):
    trainer = train_diff.Trainer(Diffusion(cfg, device='cuda'), cfg)
  state = trainer.init_or_restore()
  batch = next(iter(train_it))

  def once():
    train_diff.train_step(state, batch, cfg)
    torch.cuda.synchronize()

  r = trace_step(once)
  rows, length = cfg.loader.global_batch_size, cfg.model.length
  algo = name or ('train_bf16' if bf16 else 'train')
  return {'algo': algo, 'set': list(sets), 'batch_size': rows,
          'length': length, 'accum_steps': cfg.training.accum_steps,
          'tokens_per_s': rows * length / (r['host_step_ms'] / 1e3), **r}


def train_phase():
  """Phase 5, each part emitting its line: the two CLI training runs,
  resume, the checkpoint readers and the training step against the CPU.
  Returns the launch counts of its runs of the main path and the f32
  run's checkpoint directory."""
  import torch
  runs, trained = {}, {}
  for bf16 in (False, True):
    r = run_train(bf16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'train', **r})
    trained[r['run']] = r
    runs[r['run']] = {'launches': r['launches']}
  r = check_resume()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'train_resume', **r})
  r = run_ckpt_readers(trained['train_f32']['ckpt_dir'])
  torch.cuda.synchronize()
  emit({'phase': 'train_ckpt_readers', **r})
  runs['train_ckpt_readers'] = {'launches': r['launches']}
  step_ref = None
  for _ in range(2):
    r, step_ref = check_train_step(step_ref)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'train_step_vs_cpu', **r})
  return runs, trained['train_f32']['ckpt_dir']


def train_profiles() -> None:
  """One traced training step in f32 and in bf16 (``profile_train_step``)."""
  import torch
  for bf16 in (False, True):
    prof = profile_train_step(bf16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'profile', **prof})


# ---------------------------------------------------------------------------
# phase 5, continued: value-net and reward-oracle training
# ---------------------------------------------------------------------------

VALUE_L = 200            # the DNA task's length
VALUE_BATCH = 8          # cli.train --batch_size: 128 x 8 states a step
VALUE_ITERS = 2          # MC iterations of a cli.train run
VALUE_EVAL_EVERY = 2     # its evaluations and checkpoint writes
CDQ_ITERS = 2
ORACLE_BATCH = 64
ORACLE_ITERS = 20
EVAL_BATCH = 64          # cli.eval's rows
VALUE_LR = 2e-4          # cli.train's --learning_rate
# the kernels one grad step of the full-width value net launches: the
# training forward's 7 pools (B4) and 11 L=2 attentions (B5), the
# backward's 6 k=5 tower convs (B7) and 7 pools (B8)
VALUE_STEP_LAUNCHES = {'attn_pool': 7, 'attn_l2': 11, 'conv1d_bwd': 6,
                       'attn_pool_bwd': 7}


def _value_dir(name: str) -> str:
  path = _train_dir(name)
  os.makedirs(path)
  return path


def _tower_length(model) -> int:
  """The length the Enformer ``model``'s tower pools VALUE_L to."""
  length = VALUE_L
  for _ in range(len(model.trunk.tower.convs) + 1):
    length = (length + 1) // 2
  return length


def _enformer_launches(model, train: bool) -> dict:
  """The kernel launches of one forward of an Enformer built as ``model``
  at L=200 (the eval forward's B3 hand-offs and last pool; a training
  forward's pools) and, for ``train``, of its backward."""
  n_conv = len(model.trunk.tower.convs) + 1
  l2 = len(model.trunk.transformers) if _tower_length(model) == 2 else 0
  if train:
    return {'attn_pool': n_conv, 'attn_l2': l2, 'conv1d_bwd': n_conv - 1,
            'attn_pool_bwd': n_conv}
  return {'attn_pool_prologue_im2col': n_conv - 1, 'attn_pool': 1,
          'attn_l2': l2}


def _add(total: dict, launches: dict, times: int = 1) -> dict:
  for k, v in launches.items():
    total[k] = total.get(k, 0) + v * times
  return total


def _check_launches(name: str, got: dict, want: dict) -> dict:
  got = {k: v for k, v in got.items() if v}
  want = {k: v for k, v in want.items() if v}
  if got != want:
    raise AssertionError(f'{name}: launches {got}, expected {want}')
  return got


def run_train_oracle(root: str, small: bool) -> dict:
  """``cli.train_oracle --task dna`` through its ``run``: the 3-task
  Enformer oracle (full width, or ``--small``), batch 64 of the synthetic
  split, ORACLE_ITERS AdamW steps, then the validation Pearson on 512
  rows and its checkpoint. The launch counts, set to 0 just before and
  read just after, are exactly ORACLE_ITERS grad steps' and one eval
  forward's."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import train_oracle
  name = 'train_oracle_small' if small else 'train_oracle'
  path = os.path.join(root, f'{name}.pt')
  argv = ['--task', 'dna', '--batch_size', str(ORACLE_BATCH), '--max_iters',
          str(ORACLE_ITERS), '--log_every', '5', '--save_path', path,
          '--device', 'cuda', '--data_dir', _no_data_dir()]
  argv += ['--small'] if small else []
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  out = train_oracle.run(train_oracle.parser().parse_args(argv))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  model = out['module']
  want = _add(_add({}, _enformer_launches(model, True), ORACLE_ITERS),
              _enformer_launches(model, False))
  launches = _check_launches(name, _build.launches(), want)
  losses = out['losses']
  if (not np.isfinite(list(losses.values())).all()
      or not np.isfinite(out['val_pearson']) or not os.path.exists(path)
      or not out['synthetic']):
    raise AssertionError(f'{name}: {out}')
  return {'run': name, 'batch_size': ORACLE_BATCH, 'iters': ORACLE_ITERS,
          'width': model.config(), 'losses': losses,
          'val_pearson': out['val_pearson'], 'wall_s': wall,
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'launches': launches, 'path': path}


def _value_argv(root: str, name: str, diffusion_ckpt: str, oracle: str,
                iters: int, cdq: bool = False) -> list:
  return ['--task', 'dna', '--device', 'cuda', '--batch_size',
          str(VALUE_BATCH), '--max_iters', str(iters), '--eval_every',
          str(VALUE_EVAL_EVERY), '--val_batch_num', '1', '--learning_rate',
          str(VALUE_LR), '--diffusion_checkpoint_path', diffusion_ckpt,
          '--reward_checkpoint_path', oracle, '--out_dir', root,
          '--run_name', name,
          '--save_path', os.path.join(root, f'{name}.pt'),
          '--save_state_path', os.path.join(root, f'{name}_state.pt')] + (
              ['--cdq'] if cdq else [])


def run_value_train(root: str, name: str, diffusion_ckpt: str, oracle: str,
                    bf16: bool = False, cdq: bool = False) -> dict:
  """``cli.train --task dna`` through its ``run`` at full width (the
  denoiser of the f32 pretraining run's checkpoint, the full-width
  oracle just trained, a random full-width value net), batch 8, 128
  steps, MC targets or ``cdq``, with one evaluation trajectory and an
  evaluation and checkpoint every VALUE_EVAL_EVERY iterations. The
  launch counts, set to 0 just before and read just after, must be
  exactly: 20 denoiser layers x 129 forwards (128 steps and the noise
  removal) a trajectory; an oracle eval forward a trajectory; the value
  net's eval forwards (128 an evaluation, and CD-Q's bootstrap forward
  an iteration); VALUE_STEP_LAUNCHES a grad step; CD-Q's candidate draw
  a step."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import train as cli_train
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  iters = CDQ_ITERS if cdq else VALUE_ITERS
  args = cli_train.parser().parse_args(
      _value_argv(root, name, diffusion_ckpt, oracle, iters, cdq))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with bf16_switches(bf16):
    _build.reset_launches()
    t0 = time.perf_counter()
    out = cli_train.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launches()
  state, trainer = out['state'], out['trainer']
  steps = trainer.diffusion.config.sampling.steps
  trajectories = iters + 1
  evals = -(-iters // VALUE_EVAL_EVERY)
  eval_fwd = _enformer_launches(state.module, False)
  want = {'cnn_layer': CNN_LAYERS * (steps + 1) * trajectories}
  _add(want, eval_fwd, trajectories + evals * steps + (iters if cdq else 0))
  _add(want, VALUE_STEP_LAUNCHES, iters)
  if cdq:
    want['gumbel_candidates'] = steps * iters
  launches = _check_launches(name, launches, want)
  rows = [json.loads(line) for line in open(out['metrics_path'])]
  if ([r['_step'] for r in rows] != list(range(VALUE_EVAL_EVERY, iters + 1,
                                               VALUE_EVAL_EVERY))
      or not all(np.isfinite(v) for r in rows for k, v in r.items()
                 if k.startswith('eval/'))
      or state.step != iters
      or state.module.compute_dtype != (torch.bfloat16 if bf16
                                        else torch.float32)):
    raise AssertionError(f'{name}: metrics {rows}, step {state.step}')
  return {'run': name, 'targets': 'cdq' if cdq else 'mc',
          'value_dtype': str(state.module.compute_dtype).split('.')[-1],
          'batch_size': VALUE_BATCH, 'steps': steps, 'iters': iters,
          'rows_a_step': steps * VALUE_BATCH, 'eval_last': rows[-1],
          'wall_s': wall,
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'launches': launches, 'save_path': args.save_path,
          'state_path': args.save_state_path}


def run_value_eval(root: str, diffusion_ckpt: str, oracle: str,
                   value_path: str) -> dict:
  """``cli.eval`` through its ``run``, reading the f32 MC run's value net:
  one batch of EVAL_BATCH unguided samples (128 steps), the value net's
  predictions against the oracle's rewards."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import eval as cli_eval
  args = cli_eval.parser().parse_args(
      ['--task', 'dna', '--device', 'cuda', '--batch_size', str(EVAL_BATCH),
       '--val_batch_num', '1', '--diffusion_checkpoint_path', diffusion_ckpt,
       '--reward_checkpoint_path', oracle, '--load_checkpoint_path',
       value_path, '--out_dir', root, '--run_name', 'value_eval'])
  _build.reset_launches()
  t0 = time.perf_counter()
  out = cli_eval.run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = {k: v for k, v in _build.launches().items() if v}
  if (out['n'] != EVAL_BATCH
      or not np.isfinite([out['pearson'], out['mse']]).all()
      or launches.get('cnn_layer', 0) == 0 or launches.get('attn_l2', 0) == 0):
    raise AssertionError(f'value_eval: {out}, launches {launches}')
  return {'run': 'value_eval', **out, 'wall_s': wall, 'launches': launches}


def _value_trainer(diffusion_ckpt: str, oracle: str, cdq: bool = False):
  """A ValueTrainer as cli.train builds it (f32), for the determinism and
  profile checks."""
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import train as cli_train
  from svdd_tpu_torch.train import value as train_val
  args = cli_train.parser().parse_args(_value_argv(
      REPO, 'probe', diffusion_ckpt, oracle, 1, cdq))
  common.full_f32()
  cfg = common.task_config(args)
  tcfg = train_val.ValueTrainerConfig(
      learning_rate=args.learning_rate, batch_size=args.batch_size, cdq=cdq)
  return train_val.ValueTrainer(
      common.load_diffusion(args, cfg), common.load_value_function(args, cfg),
      common.load_reward_fn(args, cfg), tcfg), args.seed


def _same_state(a, b) -> bool:
  import torch
  sa, sb = a.module.state_dict(), b.module.state_dict()
  oa, ob = a.optimizer.adamw.state_dict(), b.optimizer.adamw.state_dict()
  moments = all(torch.equal(oa['state'][i][k], ob['state'][i][k])
                for i in oa['state'] for k in ('exp_avg', 'exp_avg_sq'))
  return (all(torch.equal(sa[k], sb[k]) for k in sa) and moments
          and a.step == b.step and a.optimizer.count == b.optimizer.count
          and torch.equal(a.generator.get_state(), b.generator.get_state()))


def check_value_determinism(root: str, diffusion_ckpt: str,
                            oracle: str) -> dict:
  """On the card, f32, full width: two trainers from the same seed, 2 MC
  iterations each, end with the same parameters, running statistics,
  Adam moments and generator bit for bit (every gradient sums in a fixed
  order: B7, B8, conv1d_deterministic, cuBLAS); the state saved after
  them restores bit for bit; two fresh trainers resumed from it, one
  more iteration each, agree bit for bit. Also the kernel launches of
  one grad step: exactly the oracle's eval forward (the MC targets) and
  VALUE_STEP_LAUNCHES."""
  import torch
  from svdd_tpu_torch import _build
  runs = []
  for _ in range(2):
    trainer, seed = _value_trainer(diffusion_ckpt, oracle)
    state = trainer.init_state(seed)
    trainer.train(state, 2)
    runs.append((trainer, state))
  (trainer, a), (_, b) = runs
  same_runs = _same_state(a, b)
  del runs, b
  path = os.path.join(root, 'determinism_state.pt')
  trainer.save_state(path, a)
  restored = trainer.restore_state(path, 0)
  same_restore = _same_state(a, restored)
  del restored
  resumed = []
  for _ in range(2):
    t, _ = _value_trainer(diffusion_ckpt, oracle)
    state = t.restore_state(path, 0)
    samples, mid_x, _ = t.trajectory()
    torch.cuda.synchronize()
    _build.reset_launches()
    t.grad_step(state, samples, mid_x)
    torch.cuda.synchronize()
    # the MC targets' oracle forward, then the training forward and
    # backward
    step_launches = _check_launches(
        'value grad step', _build.launches(),
        _add(_enformer_launches(t.vf.module, False), VALUE_STEP_LAUNCHES))
    resumed.append(state)
  same_resumes = _same_state(*resumed)
  os.remove(path)
  r = {'runs_equal': same_runs, 'restore_equal': same_restore,
       'resumes_equal': same_resumes, 'iters': 2,
       'grad_step_launches': step_launches}
  if not (same_runs and same_restore and same_resumes):
    raise AssertionError(f'value training on the card is not deterministic: '
                         f'{r}')
  return r


VALUE_CPU_ROWS = 8
# An FFN relu input of the value net's training step may take the other
# side of 0 on the card than in float64 where it lies within this share
# of the relu's largest |input| (after 11 blocks of 3xTF32 products the
# card's inputs lie about 1e-5 relative from float64's: flips up to
# 1.0e-4 absolute at inputs of a few units on an H100)
VALUE_RELU_EDGE = 1e-4
# the bf16 step's further batches (same value net; states, targets and
# dropout masks from each seed): the CPU's bf16-to-f32 distance of the
# loss, one number, can cancel on one batch; its largest over these and
# the step's own batch is the loss's noise
VALUE_BF16_SEEDS = (6, 7, 8)
# the bf16 step on the card through the kernels against the same step
# on the card through their plain versions (every other op the same):
# the predictions by norm within the bf16 kernel tolerance (TOL), the
# loss within a quarter of it
VALUE_WITNESS_TOL = {'predictions': 2 ** -5, 'loss': 2 ** -7}


def _value_step_inputs():
  """A full-width value net (random, every bias, norm scale and running
  statistic perturbed) on the CPU, 8 states at L=200 with masked rows,
  their targets and the 33 dropout masks (keep 0.6) of one training
  forward, from seed 5."""
  import numpy as np
  import torch
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  g = torch.Generator().manual_seed(5)
  model = EnformerValueModel(generator=torch.Generator().manual_seed(1))
  with torch.no_grad():
    for name, t in list(model.named_parameters()) + list(
        model.named_buffers()):
      if name.endswith(('bias', 'mean')):
        t.add_(0.1 * torch.randn(t.shape, generator=g))
      elif name.endswith(('scale', 'var')):
        t.mul_(0.7 + 0.6 * torch.rand(t.shape, generator=g))
  return (model, *_value_step_batch(model, g, np.random.default_rng(5)))


def _value_step_batch(model, g, rs):
  """8 states at L=200 with masked rows and their targets (from the
  torch generator ``g``), and the 33 dropout masks (keep 0.6) of one
  training forward of ``model`` (from the numpy generator ``rs``)."""
  import torch
  from svdd_tpu_torch import mdlm
  tokens = torch.randint(0, 5, (VALUE_CPU_ROWS, VALUE_L), generator=g)
  onehots = mdlm.transform_samples(tokens)
  targets = torch.randn(VALUE_CPU_ROWS, generator=g)
  c = model.trunk.pointwise.kernel.shape[1]
  shape = (VALUE_CPU_ROWS, _tower_length(model))
  masks = []
  for _ in model.trunk.transformers:
    for width in (c, 2 * c, c):
      masks.append(rs.random(shape + (width,)) < 0.6)
  return onehots, targets, masks


@contextlib.contextmanager
def plain_kernels():
  """The value net's training kernels (B4, B5, B7, B8) routed to their
  plain versions on the card's tensors for the enclosed runs (a
  witness: every other op as before), restored after."""
  from svdd_tpu_torch.ops import attn_l2, attn_pool, conv1d

  def l2(q, k, v, bc, bp, relk, heads):
    return attn_l2.attn_l2_plain(q, k, v, bc, bp, relk, heads,
                                 attn_l2.attn_l2_body_rounds(
                                     q.shape[0], q.shape[2], v.shape[2]))

  routes = [(attn_pool, '_attn_pool', attn_pool.attn_pool_plain),
            (attn_pool, 'attn_pool_bwd', attn_pool.attn_pool_bwd_plain),
            (attn_l2, '_attn_l2', l2),
            (conv1d, 'conv1d_bwd', conv1d.conv1d_bwd_plain)]
  saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
  for mod, name, fn in routes:
    setattr(mod, name, fn)
  try:
    yield
  finally:
    for mod, name, fn in saved:
      setattr(mod, name, fn)


def _value_forward(model, dev, onehots, targets, masks, dtype):
  """The training forward of a copy of ``model`` on ``dev`` computing
  in ``dtype``: (loss, predictions)."""
  import copy
  import torch
  from svdd_tpu_torch.models.blocks import DropoutMasks
  m = copy.deepcopy(model).to(dev)
  m.compute_dtype = dtype
  with torch.no_grad():
    preds = m(onehots.to(dev), train=True, masks=DropoutMasks(masks=masks))
    loss = ((preds - targets.to(dev)) ** 2).mean()
  return float(loss), preds.float().cpu()


def _value_step_once(model, dev, onehots, targets, masks, dtype, taps=None):
  """One grad step of a copy of ``model`` on ``dev`` computing in
  ``dtype`` (cli.train's optimizer, the first update's rate): (loss,
  {name: clipped gradient}, {name: update}, {buffer: running statistic
  after}, the predictions). ``taps`` gets each FFN's relu input (the up
  projection's output, before its dropout mask)."""
  import copy
  import torch
  from svdd_tpu_torch.models.blocks import DropoutMasks
  from svdd_tpu_torch.train.diffusion import Optimizer
  m = copy.deepcopy(model).to(dev)
  m.compute_dtype = dtype
  opt = Optimizer(m.parameters(), lambda count: VALUE_LR, 1.0, (0.9, 0.95),
                  weight_decay=0.1)
  hooks = [] if taps is None else [
      b.ffn.up.register_forward_hook(
          lambda mod, i, o: taps.append(o.detach().float().cpu()))
      for b in m.trunk.transformers]
  preds = m(onehots.to(dev), train=True, masks=DropoutMasks(masks=masks))
  loss = ((preds - targets.to(dev)) ** 2).mean()
  loss.backward()
  opt.step()
  for h in hooks:
    h.remove()
  before = dict(model.named_parameters())
  named = dict(m.named_parameters())
  return (float(loss.detach()),
          {k: p.grad.detach().cpu() for k, p in named.items()},
          {k: p.detach().cpu() - before[k].detach() for k, p in named.items()},
          {k: b.detach().cpu() for k, b in m.named_buffers()},
          preds.detach().float().cpu())


def _enformer_f64(m, x, drop_masks, relu_masks=None, flips=None):
  """The Enformer value model ``m`` (float64 parameters) in training mode,
  by plain float64 ops through no kernel and no plain version of the
  port: BatchNorm on the batch, gelu_enformer, SAME convs, the pairwise
  pools with their residuals, the transformer blocks in their general
  form (the relative-position attention by einsums) with their dropouts
  (``drop_masks`` in call order, keep 0.6), the pointwise stage and the
  head. Where ``relu_masks`` holds another run's FFN relu masks, each
  relu takes that run's side of 0, and ``flips`` gets, a relu, how many
  inputs that mask puts on the other side and the largest |input| among
  them and the largest |input| of the relu."""
  import math
  import torch
  import torch.nn.functional as F
  from svdd_tpu_torch.models.enformer import (relative_positional_basis,
                                              relative_shift)
  f64 = torch.float64
  drops, relus = iter(drop_masks), iter(relu_masks or [])

  def drop(y):
    return torch.where(torch.as_tensor(next(drops)), y / 0.6,
                       torch.zeros((), dtype=f64))

  def conv(h, kernel, bias):
    k = kernel.shape[0]
    return F.conv1d(h.transpose(1, 2), kernel.permute(2, 1, 0), bias,
                    padding=(k - 1) // 2).transpose(1, 2)

  def bn(h, norm):
    mean = h.mean((0, 1))
    var = torch.clamp((h * h).mean((0, 1)) - mean * mean, min=0.0)
    return (h - mean) * (torch.rsqrt(var + norm.eps) * norm.scale) + norm.bias

  gelu = lambda h: h * torch.sigmoid(1.702 * h)

  def pool(y, w, res):
    s = y + res
    odd = s.shape[1] % 2
    if odd:
      s = F.pad(s, (0, 0, 0, 1))
    d = s[:, 0::2] - s[:, 1::2]
    wgt = torch.sigmoid(d @ w)
    if odd:
      wgt = torch.cat([wgt[:, :-1], torch.ones_like(wgt[:, -1:])], dim=1)
    return s[:, 1::2] + d * wgt

  def block(h, blk):
    y = conv(gelu(bn(h, blk.norm)), blk.kernel, blk.bias)
    return pool(y, blk.pool.w, h) if blk.pool is not None else y

  tower = m.trunk.tower
  h = block(conv(x, tower.stem_kernel, tower.stem_bias), tower.stem_block)
  for c, p in zip(tower.convs, tower.pools):
    h = block(block(h, c), p)
  for blk in m.trunk.transformers:
    a = blk.attn
    n, hh, dk = h.shape[1], a.heads, a.dim_key
    y = F.layer_norm(h, h.shape[-1:], blk.norm.scale, blk.norm.bias, 1e-5)
    q = (y @ a.to_q.weight.T / math.sqrt(dk)).reshape(-1, n, hh, dk)
    k = (y @ a.to_k.weight.T).reshape(-1, n, hh, dk)
    v = (y @ a.to_v.weight.T).reshape(-1, n, hh, a.dim_value)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    rel_k = (torch.as_tensor(relative_positional_basis(
        n, a.num_rel_pos_features), dtype=f64) @ a.to_rel_k.weight.T)
    rel_k = rel_k.reshape(2 * n - 1, hh, dk).transpose(0, 1)
    content = torch.einsum('bhid,bhjd->bhij',
                           q + a.rel_content_bias.reshape(hh, 1, dk), k)
    rel = relative_shift(torch.einsum(
        'bhid,hjd->bhij', q + a.rel_pos_bias.reshape(hh, 1, dk), rel_k))
    att = torch.softmax(content + rel, dim=-1)
    out = torch.einsum('bhij,bhjd->bhid', att, v).transpose(1, 2)
    out = F.linear(out.reshape(-1, n, hh * a.dim_value), a.to_out.weight,
                   a.to_out.bias)
    h = h + drop(out)
    f = blk.ffn
    u = drop(F.linear(F.layer_norm(h, h.shape[-1:], f.norm.scale,
                                   f.norm.bias, 1e-5),
                      f.up.weight, f.up.bias))
    if relu_masks is not None:
      mask = next(relus)
      other = (u > 0) != mask
      flips.append((int(other.sum()), float(u.detach()[other].abs().max())
                    if other.any() else 0.0, float(u.detach().abs().max())))
      u = u * mask.to(f64)
    else:
      u = torch.relu(u)
    h = h + drop(F.linear(u, f.down.weight, f.down.bias))
  pw = m.trunk.pointwise
  h = gelu(gelu(bn(h, pw.norm)) @ pw.kernel[0] + pw.bias)
  return (h @ m.head.kernel[0] + m.head.bias).mean(1)[..., 0]


def _value_step_f64(model, onehots, targets, masks, relu_masks=None):
  """The grad step's loss and clipped gradients in float64 on the CPU
  (``_enformer_f64``), on ``relu_masks`` where given; and the flips."""
  import copy
  import torch
  from svdd_tpu_torch.train.diffusion import clip_by_global_norm_
  m = copy.deepcopy(model).double()
  flips = []
  preds = _enformer_f64(m, onehots.double(), masks, relu_masks, flips)
  loss = ((preds - targets.double()) ** 2).mean()
  loss.backward()
  named = dict(m.named_parameters())
  clip_by_global_norm_([p.grad for p in named.values()], 1.0)
  return float(loss.detach()), {k: p.grad for k, p in named.items()}, flips


def _relu_masks_of(taps, masks) -> list:
  """Each FFN relu's mask of a run: its dropout mask and a positive up
  projection."""
  import torch
  return [torch.as_tensor(d) & (t > 0) for t, d in zip(taps, masks[1::3])]


def _replay_value_update(model, grads) -> dict:
  """The update the first AdamW step makes on the CPU from ``model``'s
  parameters and the given (clipped) gradients: {name: update}."""
  import copy
  import torch
  from svdd_tpu_torch.train.diffusion import Optimizer
  m = copy.deepcopy(model)
  named = dict(m.named_parameters())
  opt = Optimizer(named.values(), lambda count: VALUE_LR, None, (0.9, 0.95),
                  weight_decay=0.1)
  for k, p in named.items():
    p.grad = grads[k].clone()
  opt.step()
  before = dict(model.named_parameters())
  with torch.no_grad():
    return {k: p - before[k] for k, p in named.items()}


def check_value_step(f32_cpu=None):
  """One grad step of the full-width value net on 8 rows (L=200) with the
  same 33 dropout masks on the card and on the CPU (``_value_step_once``):
  the updated parameters within TRAIN_TOL by norm of the update AdamW
  makes on the CPU from the card's gradients (AdamW's first update is lr
  * g / (|g| + eps): a gradient within rounding of 0, as a conv bias
  ahead of a training BatchNorm has, flips its element by 2 lr on either
  side), the running statistics within TRAIN_TOL of the CPU's by norm.

  f32: the loss within TRAIN_TOL of the CPU's and of the same step in
  float64 on the card's relu masks (``_value_step_f64``). Every clipped
  gradient's distance by norm to that float64 step within F64_MULT times
  the CPU's distance to the float64 step on its own masks plus F64_FLOOR
  of the gradient's norm and of the largest gradient's (the biases ahead
  of a training BatchNorm have a zero gradient in exact arithmetic,
  rounding noise in f32); and, relative to the gradient's norm, within
  TRAIN_TOL, or within F64_MULT times the CPU's own relative distance
  where that is the larger. Each relu mask differs from float64's only
  where |input| <= VALUE_RELU_EDGE of the relu's largest. Every leaf's
  two relative distances go on a line of their own
  (``value_step_f64_leaves``).

  bf16 (given ``f32_cpu``, the f32 run's CPU results): each gradient,
  the statistics and the predictions by ``bf16_close`` against the CPU's
  own bf16-to-f32 distance; the loss, on this batch and on the batches of
  VALUE_BF16_SEEDS (training forwards only, their predictions held as
  these), by ``bf16_close`` against the largest of the CPU's bf16-to-f32
  loss distances over these batches; and, as a witness, the same step on
  the card through the kernels' plain versions (``plain_kernels``): the
  predictions and the loss within VALUE_WITNESS_TOL of the kernels'
  step, each gradient by ``bf16_close`` against the CPU's noise.

  Returns the report and the CPU results."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  bf16 = f32_cpu is not None
  dtype = torch.bfloat16 if bf16 else torch.float32
  model, onehots, targets, masks = _value_step_inputs()
  card_taps, cpu_taps = [], []
  _build.reset_launches()
  got = _value_step_once(model, 'cuda', onehots, targets, masks, dtype,
                         card_taps)
  torch.cuda.synchronize()
  launches = _check_launches('value step vs cpu', _build.launches(),
                             VALUE_STEP_LAUNCHES)
  want = _value_step_once(model, 'cpu', onehots, targets, masks, dtype,
                          cpu_taps)
  norm = torch.linalg.vector_norm
  rel = lambda a, b: float(norm(a.double() - b.double())
                           / max(float(norm(b.double())), 1e-30))
  loss_err = abs(got[0] - want[0]) / abs(want[0])
  grad_rel = {k: rel(got[1][k], want[1][k]) for k in want[1]}
  replay = _replay_value_update(model, got[1])
  upd_rel = {k: rel(got[2][k], u) for k, u in replay.items()}
  stat_rel = {k: rel(got[3][k], w) for k, w in want[3].items()}
  r = {'compute_dtype': str(dtype).split('.')[-1], 'rows': VALUE_CPU_ROWS,
       'loss_card': got[0], 'loss_cpu': want[0], 'loss_rel_err': loss_err,
       'max_grad_rel_norm_err': max(grad_rel.values()),
       'worst_grad': max(grad_rel, key=grad_rel.get),
       'max_update_rel_err': max(upd_rel.values()),
       'worst_update': max(upd_rel, key=upd_rel.get),
       'max_stat_rel_err': max(stat_rel.values()),
       'worst_stat': max(stat_rel, key=stat_rel.get),
       'params': sum(u.numel() for u in replay.values()),
       'launches': launches}
  ok = (max(upd_rel.values()) <= TRAIN_TOL
        and all(torch.isfinite(v).all() for v in got[1].values()))
  if not bf16:
    ok = ok and max(stat_rel.values()) <= TRAIN_TOL
    card_masks = _relu_masks_of(card_taps, masks)
    cpu_masks = _relu_masks_of(cpu_taps, masks)
    loss64, g64, flips_card = _value_step_f64(model, onehots, targets, masks,
                                              card_masks)
    _, g64_cpu, flips_cpu = _value_step_f64(model, onehots, targets, masks,
                                            cpu_masks)
    dist = lambda a, b: float(norm(a.double() - b))
    top = max(float(norm(g)) for g in g64.values())
    card64 = {k: dist(got[1][k], g) for k, g in g64.items()}
    cpu64 = {k: dist(want[1][k], g) for k, g in g64_cpu.items()}
    # each relu's flips: the largest |input| among them over the largest
    # |input| of the relu
    edge = max((e / big for _, e, big in flips_card + flips_cpu),
               default=0.0)
    rel = lambda d, g: {k: e / max(float(norm(g[k])), F64_FLOOR * top)
                        for k, e in d.items()}
    rel64, rel_cpu = rel(card64, g64), rel(cpu64, g64_cpu)
    bad = [k for k, e in card64.items()
           if not e <= F64_MULT * cpu64[k]
           + F64_FLOOR * (float(norm(g64[k])) + top)]
    bad += [f'{k} (cap)' for k, e in rel64.items()
            if not e <= max(TRAIN_TOL, F64_MULT * rel_cpu[k])]
    emit({'phase': 'value_step_f64_leaves',
          'card_and_cpu_rel_to_f64': {
              k: [float(f'{rel64[k]:.3g}'), float(f'{rel_cpu[k]:.3g}')]
              for k in rel64}})
    r.update(loss_card_vs_f64=abs(got[0] - loss64) / abs(loss64),
             max_grad_card_vs_f64=max(rel64.values()),
             worst_grad_card_vs_f64=max(rel64, key=rel64.get),
             max_grad_cpu_vs_f64=max(rel_cpu.values()),
             worst_grad_cpu_vs_f64=max(rel_cpu, key=rel_cpu.get),
             leaves=len(rel64),
             leaves_card_past_train_tol=sum(e > TRAIN_TOL
                                            for e in rel64.values()),
             leaves_cpu_past_train_tol=sum(e > TRAIN_TOL
                                           for e in rel_cpu.values()),
             max_ratio_card_to_cpu=max(
                 card64[k] / max(cpu64[k], 1e-300) for k in card64),
             relu_flips_card_vs_f64=(sum(c for c, _, _ in flips_card),
                                     max((e for _, e, _ in flips_card),
                                         default=0.0)),
             relu_flips_cpu_vs_f64=(sum(c for c, _, _ in flips_cpu),
                                    max((e for _, e, _ in flips_cpu),
                                        default=0.0)),
             relu_flip_edge=edge, not_close=bad)
    ok = (ok and loss_err <= TRAIN_TOL and r['loss_card_vs_f64'] <= TRAIN_TOL
          and not bad and edge <= VALUE_RELU_EDGE)
  else:
    grad_noise = {k: rel(want[1][k], f32_cpu[1][k]) for k in want[1]}
    stat_noise = {k: rel(want[3][k], f32_cpu[3][k]) for k in want[3]}
    bad = [k for k in grad_rel
           if not bf16_close(grad_rel[k], grad_noise[k], 1.0)]
    bad += [k for k in stat_rel
            if not bf16_close(stat_rel[k], stat_noise[k], 1.0)]
    # (card bf16, CPU bf16, CPU f32) losses and (card-to-CPU, CPU
    # bf16-to-f32) prediction distances, by batch seed
    losses = {5: (got[0], want[0], f32_cpu[0])}
    preds = {5: (rel(got[4], want[4]), rel(want[4], f32_cpu[4]))}
    for seed in VALUE_BF16_SEEDS:
      batch = _value_step_batch(model, torch.Generator().manual_seed(seed),
                                np.random.default_rng(seed))
      card, cpu, cpu32 = (_value_forward(model, dev, *batch, dt)
                          for dev, dt in (('cuda', dtype), ('cpu', dtype),
                                          ('cpu', torch.float32)))
      losses[seed] = (card[0], cpu[0], cpu32[0])
      preds[seed] = (rel(card[1], cpu[1]), rel(cpu[1], cpu32[1]))
    loss_errs = {s: abs(c - w) / abs(w) for s, (c, w, _) in losses.items()}
    loss_noises = {s: abs(w - w32) / abs(w)
                   for s, (_, w, w32) in losses.items()}
    loss_noise = max(loss_noises.values())
    bad += [f'loss (batch {s})' for s, e in loss_errs.items()
            if not bf16_close(e, loss_noise, 1.0)]
    bad += [f'predictions (batch {s})' for s, (e, n) in preds.items()
            if not bf16_close(e, n, 1.0)]
    # the witness: the same step on the card through the plain versions
    _build.reset_launches()
    with plain_kernels():
      plain = _value_step_once(model, 'cuda', onehots, targets, masks, dtype)
    torch.cuda.synchronize()
    plain_launches = {k: _build.launches()[k] for k in VALUE_STEP_LAUNCHES}
    if any(plain_launches.values()):
      raise AssertionError(f'value step through the plain versions '
                           f'launched {plain_launches}')
    witness = {'predictions': rel(got[4], plain[4]),
               'loss': abs(got[0] - plain[0]) / abs(plain[0])}
    bad += [f'witness {k}' for k, e in witness.items()
            if not e <= VALUE_WITNESS_TOL[k]]
    wit_grad = {k: rel(got[1][k], plain[1][k]) for k in got[1]}
    bad += [f'witness {k}' for k, e in wit_grad.items()
            if not bf16_close(e, grad_noise[k], 1.0)]
    r.update(cpu_bf16_vs_f32_loss=loss_noises[5],
             loss_card_cpu_cpu32_by_batch=losses,
             loss_rel_err_by_batch=loss_errs,
             cpu_bf16_vs_f32_loss_by_batch=loss_noises,
             loss_noise=loss_noise,
             pred_rel_err=preds[5][0], cpu_bf16_vs_f32_pred_rel=preds[5][1],
             pred_rel_err_and_noise_by_batch=preds,
             cpu_bf16_vs_f32_max_grad_rel=max(grad_noise.values()),
             witness_pred_rel=witness['predictions'],
             witness_loss_rel=witness['loss'],
             witness_max_grad_rel=max(wit_grad.values()),
             witness_worst_grad=max(wit_grad, key=wit_grad.get),
             not_close=bad)
    ok = ok and not bad
  if not ok:
    raise AssertionError(f'value step card vs cpu: {r}')
  return r, want


def profile_value_steps(diffusion_ckpt: str, oracle: str) -> list:
  """Traced steps (``trace_step``, after a warm-up): one MC grad step of
  the full-width value net on a fixed trajectory (1024 states), f32 and
  under the bf16 switches; one CD-Q iteration (trajectory and grad step),
  f32; one step of the full-width oracle trainer (batch 64), f32. Each
  with its peak memory."""
  import torch
  from svdd_tpu_torch.cli import train_oracle
  from svdd_tpu_torch.data.gosai import FaultTolerantIterator, GosaiDataset
  from svdd_tpu_torch.models.blocks import DropoutMasks
  out = []

  def traced(algo, once, **extra):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = trace_step(once)
    out.append({'algo': algo, **extra, **r,
                'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30})

  for bf16 in (False, True):
    with bf16_switches(bf16):
      trainer, seed = _value_trainer(diffusion_ckpt, oracle)
    state = trainer.init_state(seed)
    samples, mid_x, _ = trainer.trajectory()

    def once():
      trainer.grad_step(state, samples, mid_x)
      torch.cuda.synchronize()

    traced('value_mc_step_bf16' if bf16 else 'value_mc_step', once,
           rows=samples.shape[0] * (mid_x.shape[0] + 1))
    del trainer, state
    torch.cuda.empty_cache()
  trainer, seed = _value_trainer(diffusion_ckpt, oracle, cdq=True)
  state = trainer.init_state(seed)

  def cdq_once():
    trainer.train_step(state)
    torch.cuda.synchronize()

  traced('value_cdq_iteration', cdq_once, rows=VALUE_BATCH * 128)
  del trainer, state
  torch.cuda.empty_cache()
  dev = torch.device('cuda')
  module = train_oracle.build_module(False,
                                     torch.Generator(dev).manual_seed(0))
  opt = train_oracle.make_optimizer(module, 1e-3)
  train = GosaiDataset('train', data_dir=_no_data_dir())
  batch = next(iter(FaultTolerantIterator(train, ORACLE_BATCH)))
  seqs = torch.as_tensor(batch['seqs'], device=dev).long()
  labels = torch.as_tensor(batch['clss'], device=dev)
  gen = torch.Generator(dev).manual_seed(1)

  def oracle_once():
    train_oracle.train_step(module, opt, seqs, labels,
                            DropoutMasks(generator=gen))
    torch.cuda.synchronize()

  traced('oracle_step', oracle_once, rows=ORACLE_BATCH)
  return out


def value_phase(diffusion_ckpt: str) -> dict:
  """Phase 5's value-net and oracle training, each part emitting its
  line: the oracle trainer (full width and --small), cli.train (MC f32,
  MC under the bf16 switches, CD-Q f32) chained through the pretraining
  run's and the oracle's checkpoints, cli.eval on the MC value net,
  determinism and resume, and the 8-row step against the CPU (f32, then
  bf16). Returns the launch counts of its runs of the main path."""
  import torch
  root = _value_dir('value')
  runs = {}

  def done(r, phase='value_train'):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': phase, **r})
    if 'launches' in r and 'run' in r:
      runs[r['run']] = {'launches': r['launches']}
    return r

  oracle = done(run_train_oracle(root, False))['path']
  done(run_train_oracle(root, True))
  value_path = None
  for name, kw in (('value_mc', {}), ('value_mc_bf16', {'bf16': True}),
                   ('value_cdq', {'cdq': True})):
    r = done(run_value_train(root, name, diffusion_ckpt, oracle, **kw))
    # the trainer states (2.6 GB each at full width) are not read again
    os.remove(r['state_path'])
    value_path = value_path or r['save_path']
  done(run_value_eval(root, diffusion_ckpt, oracle, value_path))
  done(check_value_determinism(root, diffusion_ckpt, oracle),
       'value_determinism')
  ref = None
  for _ in range(2):
    r, ref = check_value_step(ref)
    done(r, 'value_step_vs_cpu')
  for prof in profile_value_steps(diffusion_ckpt, oracle):
    done(prof, 'profile')
  return runs


# ---------------------------------------------------------------------------
# phase 7: the RNA task (L = 50, the ConvGRU value net and oracle)
# ---------------------------------------------------------------------------

RNA_L = 50
# B1 at the RNA step's rows and at SVDD-PM's candidate forward, B*M
RNA_ROWS = (512, 5120)
RNA_MODEL_ROWS = 512
RNA_KEEP = 0.9           # 1 - the ConvGRU's dropout
RNA_MODEL_TOL = 1e-3     # f32 card vs CPU, whole models (check_models')
RNA_GUIDED = ('svdd_mc', 'dps', 'dg', 'classifier', 'svdd_pm', 'tds')
# the kernels each RNA decode must launch: the ConvGRU runs none (its
# 64-channel convs are off B7's and B11c's gates, and its GRU is a loop
# of library products, as JAX's is a lax.scan)
RNA_PATH_KERNELS = {'svdd_mc': ('cnn_layer', 'gumbel_candidates'),
                    'dps': ('cnn_layer', 'cnn_layer_bwd'),
                    'dg': ('cnn_layer', 'cnn_layer_bwd'),
                    'classifier': ('cnn_layer',),
                    'svdd_pm': ('cnn_layer', 'gumbel_candidates'),
                    'tds': ('cnn_layer',)}
RNA_RUNS = {f'rna_{algo}{sfx}': kernels
            for algo, kernels in RNA_PATH_KERNELS.items()
            for sfx in ('', '_bf16')}
RNA_TRAIN_STEPS = 10
RNA_TRAIN_SET = ['training.accum_steps=2', 'optim.warmup_steps=5',
                 'eval.val_check_interval=10',
                 'checkpointing.every_n_steps=10']
RNA_VALUE_BATCH = 8      # cli.train --batch_size: 128 x 8 states a step
# the pipelines' phase: a few steps of each stage at full width, their
# trajectories and decodes at PIPE_STEPS steps
PIPE_STEPS = 32
PIPE_M_SCHEDULE = '24:12,8:4'


def rna_decode_launches(algo: str, steps: int) -> dict:
  """The exact kernel launches of an RNA decode at --skip_best_of_n, 512
  rows: 20 B1 launches a denoiser forward (the guided loop's: SVDD-MC and
  classifier guidance one a step; DPS and DG two, the gradient's and the
  step's; SVDD-PM one a step and the first step's fresh one, its carried
  posterior replacing the rest; TDS two a step and the first step's
  fresh one; the noise removal's, unless the carried posterior replaces
  it; and the baseline's steps + 1), 20 B6 a DPS or DG step, one B2 a
  step of SVDD-MC and SVDD-PM."""
  loop = {'svdd_mc': steps, 'classifier': steps, 'dps': 2 * steps,
          'dg': 2 * steps, 'svdd_pm': steps + 1, 'tds': 2 * steps + 1}[algo]
  removal = 0 if algo in ('svdd_pm', 'tds') else 1
  want = {'cnn_layer': CNN_LAYERS * (loop + removal + steps + 1)}
  if algo in ('dps', 'dg'):
    want['cnn_layer_bwd'] = CNN_LAYERS * steps
  if algo in ('svdd_mc', 'svdd_pm'):
    want['gumbel_candidates'] = steps
  return want


def check_rna_kernels(dtype, gen) -> dict:
  """B1 at the RNA task's rows, 512 and B*M = 5120, x L = 50, all four
  dilations, against its plain version (``_cnn_forward``: ms a 20-layer
  forward, F.conv1d of the normalised input the library yardstick); B6
  at 512 x 50 against its plain version on the kernel's relu mask, with
  the mask checks (``_cnn_backward``), which below L = 100 rounds as
  JAX's reference VJP in bf16 (``bwd_rounds_as_reference``)."""
  out = {f'cnn_layer_n{n}': _cnn_forward(n, dtype, gen, RNA_L)
         for n in RNA_ROWS}
  out['cnn_layer_bwd_n512'] = _cnn_backward(RNA_ROWS[0], RNA_L, dtype, gen)
  return out


def check_rna_gumbel(gen) -> dict:
  """B2 at the RNA step's shape (512, 10, 50, 5), half the positions
  masked: every draw equal to the plain version's on the kernel's noise,
  unmasked tokens copied, one launch a call; timed beside the plain
  version, its bound ``gumbel_bound`` of this run's masked draws."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.mdlm import gumbel_noise
  from svdd_tpu_torch.ops import fused_sample as K
  b, m, l, v, mask = RNA_ROWS[0], 10, RNA_L, 5, 4
  log_q = torch.log_softmax(torch.randn(b, l, v, device='cuda',
                                        generator=gen), -1)
  x = torch.randint(0, 4, (b, l), device='cuda', generator=gen)
  x = torch.where(torch.rand(b, l, device='cuda', generator=gen) < 0.5,
                  mask, x)
  before = _build.LAUNCHES['gumbel_candidates']
  out, noise = K.gumbel_candidates(log_q, x, m, mask, gen,
                                   return_noise=True)
  if _build.LAUNCHES['gumbel_candidates'] != before + 1:
    raise AssertionError('gumbel_candidates rna: not one launch')
  err = int((out - K.gumbel_candidates_plain(log_q, x, noise, mask))
            .abs().max())
  keep = (x != mask)[:, None].expand(-1, m, -1)
  if err or not torch.equal(out[keep], x[:, None].expand(-1, m, -1)[keep]):
    raise AssertionError(f'gumbel_candidates rna: max abs err {err} or '
                         'unmasked tokens changed')

  def plain():
    return K.gumbel_candidates_plain(log_q, x, gumbel_noise(
        (b, m, l, v), gen, 'cuda'), mask)
  es = x.element_size()
  n_drawn = int((~keep).sum())
  bound_ms, bound_by, work = gumbel_bound(
      n_drawn, v, b * l * v * 4 + b * l * es + b * m * l * es)
  return {'shape': [b, m, l, v], 'max_abs_err': err, 'masked_draws': n_drawn,
          **timed(lambda: K.gumbel_candidates(log_q, x, m, mask, gen),
                  plain),
          'bound_ms': bound_ms, 'bound_by': bound_by, 'work': work}


def _rna_masks(n: int, seed: int) -> list:
  """The dropout masks of one ConvGRU training forward of n rows at L=50,
  in JAX's call order (the five ConvBlocks', the FFN's two)."""
  import numpy as np
  rs = np.random.default_rng(seed)
  return ([rs.random((n, RNA_L, 64)) < RNA_KEEP for _ in range(5)]
          + [rs.random((n, RNA_L, 128)) < RNA_KEEP,
             rs.random((n, RNA_L, 64)) < RNA_KEEP])


def _convgru_run(model, x, train: bool, masks):
  """(output, input gradient of mean(out^2), parameter gradients, buffers)
  of one forward of a copy of ``model`` on ``x``'s device."""
  import copy
  from svdd_tpu_torch.models.blocks import DropoutMasks
  m = copy.deepcopy(model)
  xx = x.clone().requires_grad_(True)
  y = m(xx, fused=False, train=train,
        masks=DropoutMasks(masks=masks) if train else None)
  (y ** 2).mean().backward()
  return (y.detach().cpu(), xx.grad.cpu(),
          {k: p.grad.cpu() for k, p in m.named_parameters()},
          {k: b.cpu() for k, b in m.named_buffers()})


def check_convgru() -> dict:
  """The ConvGRU value net (``build_value_module('rna')``) and the RNA
  oracle's (``RewardOracle.create_rna``) on RNA_MODEL_ROWS rows, L=50, on
  the card against the CPU with the same weights, f32 (TF32 off): the
  eval output and the input gradient of mean(out^2) (the classifier's
  gradient), then a training forward on the same dropout masks: output,
  input gradient, every parameter's gradient (by norm, 1e-6 of the
  largest gradient's norm beside: the ConvBlocks' conv biases, ahead of a
  training BatchNorm, have a zero gradient in exact arithmetic) and the
  moved running statistics; RNA_MODEL_TOL relative. No port kernel runs:
  the launch counts stay 0."""
  import copy
  import torch
  from svdd_tpu_torch import _build, mdlm, rewards
  from svdd_tpu_torch import value as value_lib
  g = torch.Generator().manual_seed(3)
  x = mdlm.transform_samples(torch.randint(0, 5, (RNA_MODEL_ROWS, RNA_L),
                                           generator=g))
  masks = _rna_masks(RNA_MODEL_ROWS, 4)
  norm = torch.linalg.vector_norm
  report = {'rows': RNA_MODEL_ROWS, 'length': RNA_L}
  _build.reset_launches()
  for name, make in (
      ('value', lambda gen: value_lib.build_value_module('rna',
                                                         generator=gen)),
      ('oracle', lambda gen: rewards.RewardOracle.create_rna(gen).module)):
    cpu = make(torch.Generator().manual_seed(5))
    gpu = copy.deepcopy(cpu).cuda()
    for train in (False, True):
      got = _convgru_run(gpu, x.cuda(), train, masks)
      want = _convgru_run(cpu, x, train, masks)
      tag = f'{name}_{"train" if train else "eval"}'
      out_err = float((got[0] - want[0]).abs().max())
      gx_rel = float(norm(got[1] - want[1]) / norm(want[1]))
      r = {'out_max_abs_err': out_err,
           'out_max_abs': float(want[0].abs().max()),
           'input_grad_rel_norm_err': gx_rel}
      ok = (torch.allclose(got[0], want[0], rtol=RNA_MODEL_TOL,
                           atol=RNA_MODEL_TOL * r['out_max_abs'])
            and gx_rel <= RNA_MODEL_TOL)
      if train:
        top = max(float(norm(v)) for v in want[2].values())
        rel = {k: float(norm(got[2][k] - v)) / (float(norm(v)) + 1e-3 * top)
               for k, v in want[2].items()}
        stats = max(float((got[3][k] - v).abs().max()
                          / (v.abs().max() + 1e-12))
                    for k, v in want[3].items())
        r.update(param_grad_max_rel_norm_err=max(rel.values()),
                 running_stats_max_rel_err=stats)
        ok = ok and max(rel.values()) <= RNA_MODEL_TOL and stats <= 1e-4
      report[tag] = r
      if not ok or not torch.isfinite(got[0]).all():
        raise AssertionError(f'convgru {tag} card vs cpu: {r}')
  launches = {k: v for k, v in _build.launches().items() if v}
  if launches:
    raise AssertionError(f'convgru: port kernels launched {launches}')
  return report


def run_rna_sample_eval() -> dict:
  """``main_gosai --mode sample_eval --task rna --set
  sampling.predictor=analytic`` through its ``run``: the full-width
  denoiser at L=50, random weights, one batch of 512, 128 analytic steps
  and ``denoiser_final``; B1 launched exactly 20 x 129 times."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  args = main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--task', 'rna', '--device', 'cuda',
       '--ckpt_dir', os.path.join(REPO, 'build', 'chip_smoke',
                                  'no_checkpoint'),
       '--data_dir', _no_data_dir(), '--set', 'sampling.predictor=analytic',
       f'sampling.steps={DECODE_STEPS}', 'sampling.num_sample_batches=1',
       'loader.eval_batch_size=512'])
  torch.cuda.synchronize()
  _build.reset_launches()
  t0 = time.perf_counter()
  out = main_gosai.run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _check_launches('rna_sample_eval_analytic', _build.launches(),
                             {'cnn_layer': CNN_LAYERS * (DECODE_STEPS + 1)})
  tokens = out['tokens']
  if tokens.shape != (512, RNA_L) or tokens.min() < 0 or tokens.max() > 3:
    raise AssertionError(f'rna sample_eval: tokens {tokens.shape} in '
                         f'[{tokens.min()}, {tokens.max()}]')
  return {'path': 'rna_sample_eval_analytic', 'task': 'rna',
          'predictor': 'analytic', 'batch_size': 512, 'length': RNA_L,
          'steps': DECODE_STEPS, 'wall_s': wall, 'launches': launches,
          'distinct_tokens': int(np.unique(tokens).size)}


def _rna_value_argv(root: str, name: str, ckpt: str, oracle: str,
                    iters: int) -> list:
  return ['--task', 'rna', '--device', 'cuda', '--batch_size',
          str(RNA_VALUE_BATCH), '--max_iters', str(iters), '--eval_every',
          str(VALUE_EVAL_EVERY), '--val_batch_num', '1', '--learning_rate',
          str(VALUE_LR), '--diffusion_checkpoint_path', ckpt,
          '--reward_checkpoint_path', oracle, '--out_dir', root,
          '--run_name', name, '--reward_name', 'MRL',
          '--save_path', os.path.join(root, f'{name}.pt'),
          '--save_state_path', os.path.join(root, f'{name}_state.pt')]


def rna_train_phase() -> dict:
  """The RNA training chain, each part emitting its line:
  ``cli.train_oracle --task rna`` (the ConvGRU MRL oracle, batch 64,
  ORACLE_ITERS steps); ``main_gosai --mode train --task rna`` at full
  width (L=50, global batch 512 in two microbatches, RNA_TRAIN_STEPS
  steps, validation, the sample-quality hook scored by that oracle and a
  checkpoint at the last step; B6 launched exactly 20 x 2 x steps);
  ``cli.train --task rna`` (MC, batch 8, VALUE_ITERS iterations) from
  the checkpoint and the oracle (B1 exactly 20 x 129 a trajectory, no
  other kernel: the ConvGRU runs none); ``cli.eval --task rna`` on that
  value net; two ``cli.train`` runs from one seed and two resumes from
  one saved state, each pair equal bit for bit. Returns the launch
  counts of its runs."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import eval as cli_eval
  from svdd_tpu_torch.cli import main_gosai, train_oracle
  from svdd_tpu_torch.cli import train as cli_train
  from svdd_tpu_torch.config import rna_config
  root = _value_dir('rna')
  runs = {}

  def launched(name, want=None):
    torch.cuda.synchronize()
    got = _build.launches()
    return (_check_launches(name, got, want) if want is not None
            else {k: v for k, v in got.items() if v})

  oracle = os.path.join(root, 'oracle.pt')
  _build.reset_launches()
  t0 = time.perf_counter()
  out = train_oracle.run(train_oracle.parser().parse_args(
      ['--task', 'rna', '--batch_size', str(ORACLE_BATCH), '--max_iters',
       str(ORACLE_ITERS), '--log_every', '5', '--save_path', oracle,
       '--device', 'cuda', '--data_dir', _no_data_dir()]))
  r = {'run': 'rna_train_oracle', 'batch_size': ORACLE_BATCH,
       'iters': ORACLE_ITERS, 'losses': out['losses'],
       'val_pearson': out['val_pearson'],
       'wall_s': time.perf_counter() - t0,
       'launches': launched('rna_train_oracle', {})}
  if not np.isfinite([*out['losses'].values(), out['val_pearson']]).all():
    raise AssertionError(f'rna_train_oracle: {r}')
  emit({'phase': 'rna_train', **r})

  args = main_gosai.parser().parse_args(
      ['--mode', 'train', '--task', 'rna', '--device', 'cuda',
       '--max_steps', str(RNA_TRAIN_STEPS), '--data_dir', _no_data_dir(),
       '--ckpt_dir', os.path.join(root, 'ckpt'),
       '--log_dir', os.path.join(root, 'log'),
       '--eval_oracle_checkpoint_path', oracle, '--set', *RNA_TRAIN_SET])
  _build.reset_launches()
  t0 = time.perf_counter()
  out = main_gosai.run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = launched('rna_train')
  want_bwd = CNN_LAYERS * 2 * RNA_TRAIN_STEPS
  rows = [json.loads(line) for line in open(out['metrics_path'])]
  quality = [q for q in rows if 'kmer_pearson' in q]
  if (launches.get('cnn_layer_bwd') != want_bwd or len(quality) != 1
      or not np.isfinite([q['val/nll'] for q in rows
                          if 'val/nll' in q]).all()):
    raise AssertionError(f'rna_train: launches {launches} (B6 should run '
                         f'{want_bwd} times), metrics {rows}')
  cfg = out['state'].model.config
  r = {'run': 'rna_train', 'batch_size': cfg.loader.global_batch_size,
       'accum_steps': cfg.training.accum_steps, 'length': cfg.model.length,
       'steps': out['state'].step, 'wall_s': wall,
       'sample_quality': {k: v for k, v in quality[0].items()
                          if not k.startswith('_')},
       'launches': launches}
  runs['rna_train'] = {'launches': launches}
  emit({'phase': 'rna_train', **r})
  ckpt = os.path.join(root, 'ckpt')

  steps = rna_config().sampling.steps       # a trajectory's steps
  trained = []
  for name in ('rna_value_mc', 'rna_value_mc_again'):
    args = cli_train.parser().parse_args(_rna_value_argv(
        root, name, ckpt, oracle, VALUE_ITERS))
    _build.reset_launches()
    t0 = time.perf_counter()
    out = cli_train.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched(name, {'cnn_layer': CNN_LAYERS * (steps + 1)
                               * (VALUE_ITERS + 1)})
    state = out['state']
    if state.step != VALUE_ITERS or state.module.compute_dtype != \
        torch.float32:
      raise AssertionError(f'{name}: step {state.step}')
    trained.append(state)
    rows = [json.loads(line) for line in open(out['metrics_path'])]
    r = {'run': name, 'targets': 'mc', 'batch_size': RNA_VALUE_BATCH,
         'steps': steps, 'iters': VALUE_ITERS, 'eval_last': rows[-1],
         'wall_s': wall, 'launches': launches}
    runs[name] = {'launches': launches}
    emit({'phase': 'rna_train', **r})
  value_path = os.path.join(root, 'rna_value_mc.pt')

  args = cli_eval.parser().parse_args(
      ['--task', 'rna', '--device', 'cuda', '--batch_size', str(EVAL_BATCH),
       '--val_batch_num', '1', '--diffusion_checkpoint_path', ckpt,
       '--reward_checkpoint_path', oracle, '--load_checkpoint_path',
       value_path, '--out_dir', root, '--run_name', 'rna_value_eval'])
  _build.reset_launches()
  out = cli_eval.run(args)
  launches = launched('rna_value_eval',
                      {'cnn_layer': CNN_LAYERS * (steps + 1)})
  if out['n'] != EVAL_BATCH or not np.isfinite([out['pearson'],
                                                out['mse']]).all():
    raise AssertionError(f'rna_value_eval: {out}')
  runs['rna_value_eval'] = {'launches': launches}
  emit({'phase': 'rna_train', 'run': 'rna_value_eval', **out,
        'launches': launches})

  resumed = []
  for _ in range(2):
    out = cli_train.run(cli_train.parser().parse_args(_rna_value_argv(
        root, 'rna_value_resume', ckpt, oracle, 1)[:-4] + [
            '--resume_state_path',
            os.path.join(root, 'rna_value_mc_state.pt'),
            '--max_iters', '1', '--val_batch_num', '0']))
    resumed.append(out['state'])
  r = {'runs_equal': _same_state(*trained),
       'resumes_equal': _same_state(*resumed),
       'resumed_step': resumed[0].step}
  if not (r['runs_equal'] and r['resumes_equal']):
    raise AssertionError(f'rna value training on the card is not '
                         f'deterministic: {r}')
  emit({'phase': 'rna_value_determinism', **r})
  return runs


def run_pipelines() -> dict:
  """``svdd_tpu_torch/pipeline.py``'s stages of both tasks chained on the
  card at full width, a few steps each (pretrain 5 steps at batch 16,
  the oracle 3, the value net 2; trajectories and decodes at PIPE_STEPS
  steps, B=64, M=10; DNA with a scheduled-M decode too): no quality
  gate, the stages must run and report finite values. Returns the launch
  counts of each pipeline."""
  import dataclasses
  import math
  import torch
  from svdd_tpu_torch import _build, pipeline
  from svdd_tpu_torch.config import dna_config, rna_config
  from svdd_tpu_torch.utils import parse_m_schedule
  recipe = pipeline.Recipe(pretrain_steps=5, train_batch=16, oracle_steps=3,
                           value_steps=2, decode_batch=64, sample_M=10)
  runs = {}
  for task in ('rna', 'dna'):
    cfg = (rna_config if task == 'rna' else dna_config)()
    cfg.sampling.steps = PIPE_STEPS
    _build.reset_launches()
    t0 = time.perf_counter()
    if task == 'rna':
      results, _ = pipeline.rna(cfg, _no_data_dir(), 'cuda', recipe)
    else:
      results, _ = pipeline.dna(
          cfg, _no_data_dir(), 'cuda', recipe, seed_offset=100,
          m_schedule=parse_m_schedule(PIPE_M_SCHEDULE),
          sched_label=PIPE_M_SCHEDULE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _build.launches().items() if v}
    need = ('cnn_layer', 'cnn_layer_bwd', 'gumbel_candidates') + (
        () if task == 'rna' else ('attn_pool_prologue_im2col', 'attn_pool',
                                  'attn_l2', 'conv1d_bwd', 'attn_pool_bwd'))
    values = [v for row in results['report'].values() for v in row.values()]
    values += [results[k] for k in ('value_mse_first', 'value_mse_last',
                                    'diffusion_loss_last')]
    if [k for k in need if k not in launches] or not all(
        math.isfinite(v) for v in values) or not results['card']:
      raise AssertionError(f'pipeline {task}: launches {launches}, '
                           f'{results}')
    name = f'pipeline_{task}'
    runs[name] = {'launches': launches}
    emit({'phase': 'pipeline', 'run': name, 'wall_s': wall,
          'recipe': dataclasses.asdict(recipe), 'steps': PIPE_STEPS,
          **results, 'launches': launches})
  return runs


def rna_phase() -> dict:
  """Phase 7, each part emitting its line: the ConvGRU on the card
  against the CPU; the six RNA decoders through their CLIs at B=512, 128
  steps, f32 and under the bf16 switches (the ConvGRU stays f32 under
  them), with exact launch counts; sample_eval with the analytic
  predictor; the training chain; the pipelines' stages. Returns the
  launch counts of its runs of the main path."""
  import torch
  emit({'phase': 'rna_models', **check_convgru()})
  torch.cuda.empty_cache()
  runs = {}
  for bf16 in (False, True):
    for algo in RNA_GUIDED:
      name = f'rna_{algo}_bf16' if bf16 else f'rna_{algo}'
      r = run_decode(algo, name, bf16=bf16, task='rna')
      torch.cuda.synchronize()
      torch.cuda.empty_cache()
      emit({'phase': 'decode', **r})
      runs[name] = r
  r = run_rna_sample_eval()
  emit({'phase': 'decode', **r})
  runs[r['path']] = r
  runs.update(rna_train_phase())
  torch.cuda.empty_cache()
  runs.update(run_pipelines())
  torch.cuda.empty_cache()
  return runs


# ---------------------------------------------------------------------------
# phase 8: the reference's torch checkpoints (A17), the timed and multisep
# value models and the multisep trainer (A11)
# ---------------------------------------------------------------------------

REF_DECODE_STEPS = 8      # cli.decode reading the reference-layout files
TIMED_ROWS = 4            # the timed value net, card vs CPU
TIMED_DECODE_STEPS = 16   # controlled_sampler_timed at B=512, M=10
MULTISEP_ITERS = 2        # cli.train --model multienformer, batch VALUE_BATCH
MULTISEP_MODELS = 10      # the CLI's bins
# the 2-trunk step card vs CPU: 2 trajectories of 4 steps (3 mid states and
# the final one: 2 a bin, 4 rows a bin's forward)
MULTISEP_CPU_MODELS, MULTISEP_CPU_BATCH, MULTISEP_CPU_STEPS = 2, 2, 4
# f32 card vs CPU: whole models' outputs and gradients (check_models',
# check_model_grads'), relative by norm; the losses and the replayed
# AdamW updates within TRAIN_TOL
MODEL_TOL = 1e-3
# phase 8's gradients card vs CPU (the timed net's, the multisep step's),
# each leaf's relative by norm, the CPU's forward taking the card's side
# of 0 at every FFN relu (``_on_card_relus``): an FFN relu input within
# rounding of 0 that takes the other side on the card moves the gradient
# of every leaf upstream of it by up to 1.2e-3 (one such flip in the
# first chip runs of the timed check), where the same relus read 1.03e-5
# (NVIDIA H100 80GB HBM3, 700 W)
GRAD_TOL = 1e-4


def _ref_put(sd: dict, name: str, a) -> None:
  import numpy as np
  import torch
  sd[name] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _ref_conv(sd: dict, prefix: str, c) -> None:
  """A flax Conv1D {'kernel' (K, in, out), 'bias'} as torch Conv1d's."""
  import numpy as np
  _ref_put(sd, f'{prefix}.weight', np.transpose(c['kernel'], (2, 1, 0)))
  _ref_put(sd, f'{prefix}.bias', c['bias'])


def _ref_dense(sd: dict, prefix: str, d) -> None:
  """A flax Dense {'kernel' (in, out)[, 'bias']} as torch Linear's."""
  _ref_put(sd, f'{prefix}.weight', d['kernel'].T)
  if 'bias' in d:
    _ref_put(sd, f'{prefix}.bias', d['bias'])


def reference_cnn_dict(model) -> dict:
  """The port's CNN denoiser as the reference CNNModel's state dict: the
  inverse of ``svdd_tpu_torch/importers/cnn.py``'s name map."""
  from svdd_tpu_torch import weights
  v = weights.cnn_to_jax(model)
  p, sd = v['params'], {}
  _ref_conv(sd, 'linear', p['stem'])
  _ref_put(sd, 'time_embedder.0.W',
           v['buffers']['GaussianFourierProjection_0']['W'])
  _ref_dense(sd, 'time_embedder.1', p['time_linear'])
  for i in range(len(model.layers)):
    _ref_conv(sd, f'convs.{i}', p[f'conv_{i}'])
    _ref_dense(sd, f'time_layers.{i}.dense', p[f'time_{i}'])
    _ref_put(sd, f'norms.{i}.weight', p[f'norm_{i}']['scale'])
    _ref_put(sd, f'norms.{i}.bias', p[f'norm_{i}']['bias'])
  _ref_conv(sd, 'final_conv.0', p['final_0'])
  _ref_conv(sd, 'final_conv.2', p['final_1'])
  return sd


def reference_enformer_dict(model) -> dict:
  """The port's Enformer (value net or oracle, timed or not) as the
  reference BaseModel(EnformerTrunk, ConvHead)'s state dict, BatchNorms'
  ``num_batches_tracked`` included: the inverse of
  ``svdd_tpu_torch/importers/enformer.py``'s name map."""
  import numpy as np
  import torch
  from svdd_tpu_torch import weights
  v = weights.enformer_to_jax(model)
  p, stats = v['params'], v['batch_stats']['EnformerTrunk_0']
  trunk = p['EnformerTrunk_0']
  tower, tower_s = trunk['EnformerConvTower_0'], stats['EnformerConvTower_0']
  sd = {}

  def block(prefix, bp, bs):
    _ref_conv(sd, f'{prefix}.conv', bp['Conv1D_0'])
    bn, st = bp['Norm_0']['BatchNorm_0'], bs['Norm_0']['BatchNorm_0']
    _ref_put(sd, f'{prefix}.norm.layer.weight', bn['scale'])
    _ref_put(sd, f'{prefix}.norm.layer.bias', bn['bias'])
    _ref_put(sd, f'{prefix}.norm.layer.running_mean', st['mean'])
    _ref_put(sd, f'{prefix}.norm.layer.running_var', st['var'])
    sd[f'{prefix}.norm.layer.num_batches_tracked'] = torch.tensor(0)
    if 'Pool_0' in bp:
      w = bp['Pool_0']['AttentionPool_0']['to_attn_logits']
      _ref_put(sd, f'{prefix}.pool.layer.to_attn_logits.weight',
               w.T[:, :, None, None])
    if 'ChannelTransform_0' in bp:
      _ref_conv(sd, f'{prefix}.channel_transform.layer',
                bp['ChannelTransform_0']['Conv1D_0'])

  base = 'embedding.conv_tower.blocks'
  _ref_conv(sd, f'{base}.0.0', tower['stem_conv'])
  block(f'{base}.0.1', tower['stem_block'], tower_s['stem_block'])
  for i in range(1, len(model.trunk.tower.convs) + 1):
    block(f'{base}.{i}.0', tower[f'conv_{i}'], tower_s[f'conv_{i}'])
    block(f'{base}.{i}.1', tower[f'pool_{i}'], tower_s[f'pool_{i}'])
  if 'transformer_stack' in trunk:
    stack = trunk['transformer_stack']['EnformerTransformerBlock_0']

    def take(tree, j):
      if isinstance(tree, dict):
        return {k: take(t, j) for k, t in tree.items()}
      return np.asarray(tree)[j]
    layers = [take(stack, j) for j in range(len(model.trunk.transformers))]
  else:
    layers = [trunk['transformer_0']]
  for j, t in enumerate(layers):
    pre = f'embedding.transformer_tower.blocks.{j}'
    _ref_put(sd, f'{pre}.norm.layer.weight', t['LayerNorm_0']['scale'])
    _ref_put(sd, f'{pre}.norm.layer.bias', t['LayerNorm_0']['bias'])
    a = t['EnformerAttention_0']
    for name in ('to_q', 'to_k', 'to_v', 'to_rel_k', 'to_out'):
      _ref_dense(sd, f'{pre}.mha.{name}', a[name])
    _ref_put(sd, f'{pre}.mha.rel_content_bias', a['rel_content_bias'])
    _ref_put(sd, f'{pre}.mha.rel_pos_bias', a['rel_pos_bias'])
    f = t['FeedForwardBlock_0']
    ln = f['LinearBlock_0']['Norm_0']['LayerNorm_0']
    _ref_put(sd, f'{pre}.ffn.dense1.norm.layer.weight', ln['scale'])
    _ref_put(sd, f'{pre}.ffn.dense1.norm.layer.bias', ln['bias'])
    _ref_dense(sd, f'{pre}.ffn.dense1.linear', f['LinearBlock_0']['Dense_0'])
    _ref_dense(sd, f'{pre}.ffn.dense2.linear', f['LinearBlock_1']['Dense_0'])
  block('embedding.pointwise_conv', trunk['pointwise'], stats['pointwise'])
  _ref_conv(sd, 'head.channel_transform.conv.layer',
            p['ConvHead_0']['ChannelTransformBlock_0']['ChannelTransform_0'][
                'Conv1D_0'])
  if 'TimeEmbedding_0' in p:
    _ref_put(sd, 'embedding.time_embedding.time_embedding.weight',
             p['TimeEmbedding_0']['embedding'])
  return sd


def write_reference_files(root: str, denoiser, oracle, value) -> dict:
  """The three DNA models in the reference's files: the denoiser as a
  Lightning checkpoint ('state_dict', keys under 'backbone.'), the
  oracle as a grelu LightningModel checkpoint ('state_dict', keys under
  'model.') and the value net as the value trainer's dict
  ('model_state_dict', keys under 'module.'). Returns their paths."""
  import torch
  paths = {k: os.path.join(root, k) for k in
           ('diffusion.ckpt', 'oracle.ckpt', 'value.pt')}
  pre = lambda sd, p: {p + k: t for k, t in sd.items()}
  torch.save({'state_dict': pre(reference_cnn_dict(denoiser), 'backbone.'),
              'epoch': 0, 'global_step': TRAIN_STEPS},
             paths['diffusion.ckpt'])
  torch.save({'state_dict': pre(reference_enformer_dict(oracle), 'model.'),
              'epoch': 0}, paths['oracle.ckpt'])
  torch.save({'model_state_dict': pre(reference_enformer_dict(value),
                                      'module.'), 'epoch': 0,
              'tokens': 0.0}, paths['value.pt'])
  return paths


def _same_weights(a, b) -> bool:
  import torch
  sa, sb = a.state_dict(), b.state_dict()
  return sa.keys() == sb.keys() and all(
      sa[k].dtype == sb[k].dtype and torch.equal(sa[k].cpu(), sb[k].cpu())
      for k in sa)


def _ref_args(paths: dict, out_dir: str, dev: str, extra=()):
  from svdd_tpu_torch.cli import decode as cli_decode
  return cli_decode.parser().parse_args(
      ['--task', 'dna', '--device', dev, '--out_dir', out_dir,
       '--diffusion_checkpoint_path', paths['diffusion.ckpt'],
       '--reward_checkpoint_path', paths['oracle.ckpt'],
       '--load_checkpoint_path', paths['value.pt'], *extra])


def check_reference_imports(root: str, diffusion_ckpt: str, oracle: str,
                            value: str, dev: str = 'cuda', cfg=None) -> dict:
  """The f32 pretraining run's denoiser (its EMA weights), the oracle and
  the MC value net of phase 5, written in the reference's layouts
  (``write_reference_files``, the inverse name maps above) and read back
  by the CLIs' checkpoint flags (``checkpoint.import_torch_state_dict``,
  the prefix rule, ``importers/``, ``weights.*_from_jax``): each equal to
  its source bit for bit. Returns the report and the files' paths."""
  import torch
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  args = cli_decode.parser().parse_args(
      ['--task', 'dna', '--device', dev, '--diffusion_checkpoint_path',
       diffusion_ckpt, '--reward_checkpoint_path', oracle,
       '--load_checkpoint_path', value])
  cfg = cfg or common.task_config(args)
  sources = (common.load_diffusion(args, cfg).backbone,
             common.load_reward_fn(args, cfg).module,
             common.load_value_function(args, cfg).module)
  t0 = time.perf_counter()
  paths = write_reference_files(root, *sources)
  write_s = time.perf_counter() - t0
  ref = _ref_args(paths, root, dev)
  common.reject_unported(ref)
  t0 = time.perf_counter()
  imported = (common.load_diffusion(ref, cfg).backbone,
              common.load_reward_fn(ref, cfg).module,
              common.load_value_function(ref, cfg).module)
  if dev == 'cuda':
    torch.cuda.synchronize()
  read_s = time.perf_counter() - t0
  names = ('denoiser', 'oracle', 'value_net')
  equal = {n: _same_weights(a, b) for n, a, b in zip(names, imported,
                                                      sources)}
  r = {'files': {k: os.path.getsize(p) for k, p in paths.items()},
       'eval_launches': _enformer_launches(sources[2], False),
       'equal_bitwise': equal,
       'params': {n: sum(t.numel() for t in m.state_dict().values())
                  for n, m in zip(names, sources)},
       'write_s': write_s, 'import_s': read_s}
  if not all(equal.values()):
    raise AssertionError(f'reference imports differ from their sources: {r}')
  return r, paths


def run_reference_decode(paths: dict, out_dir: str, eval_fwd: dict) -> dict:
  """``cli.decode.run --task dna`` reading the three reference files: B=512,
  M=10, REF_DECODE_STEPS steps, --skip_best_of_n; the launch counts, set to
  0 just before and read just after, exactly: 20 B1 launches a denoiser
  forward (the guided steps', the noise removal's and the baseline's
  steps + 1), one B2 a step, and ``eval_fwd`` (a full-width Enformer's
  eval forward) for the value net a step and on the decoded samples, and
  for the oracle on the decoded and the baseline samples."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  steps = REF_DECODE_STEPS
  args = _ref_args(paths, out_dir, 'cuda', [
      '--batch_size', '512', '--sample_M', '10', '--num_steps', str(steps),
      '--skip_best_of_n', '--run_name', 'chip_smoke_reference_decode'])
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  report = cli_decode.run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  want = {'cnn_layer': CNN_LAYERS * (2 * steps + 2),
          'gumbel_candidates': steps}
  _add(want, eval_fwd, steps + 3)
  launches = _check_launches('reference_decode', _build.launches(), want)
  npz_keys = _check_npz(common.npz_path(args))
  return {'run': 'reference_decode', 'batch_size': 512, 'sample_M': 10,
          'steps': steps, 'wall_s': wall,
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'guided_reward_mean': report['decoding']['mean'],
          'baseline_reward_mean': report['baseline']['mean'],
          'launches': launches, 'npz_keys': npz_keys}


def _rel(a, b) -> float:
  """|a - b| / |b| by norm, in float64."""
  import torch
  norm = torch.linalg.vector_norm
  return float(norm(a.double().cpu() - b.double().cpu())
               / max(float(norm(b.double().cpu())), 1e-30))


def _named_grads(module) -> dict:
  """{name: gradient on the CPU} of every leaf that has one."""
  named = list(module.named_parameters()) + list(module.named_buffers())
  return {k: t.grad.detach().cpu() for k, t in named if t.grad is not None}


def _ffn_relu_taps(module, taps: list) -> list:
  """Forward hooks on each transformer block's FFN up projection of the
  Enformer ``module``: ``taps`` gets [block, its relu input] a forward.
  Returns the hooks."""
  return [b.ffn.up.register_forward_hook(
      lambda mod, i, o, j=j: taps.append((j, o.detach().float().cpu())))
          for j, b in enumerate(module.trunk.transformers)]


def _on_card_relus(module, card: list, tag=None) -> None:
  """Make each FFN of the Enformer ``module`` keep, at its relu, the
  inputs the card's relu kept in the same call (``card``:
  ``_ffn_relu_taps``' record of the card's run, its keys block or (tag,
  block)): the relu's output where(card input > 0, input, 0), and its
  gradient through the same mask, so that a flip at an input within
  rounding of 0 does not stand for a fault."""
  import collections
  import torch
  from svdd_tpu_torch.models import blocks
  kept = collections.defaultdict(collections.deque)
  for key, u in card:
    kept[key].append(u > 0)
  for j, b in enumerate(module.trunk.transformers):
    def forward(x, masks=None, ffn=b.ffn,
                queue=kept[j if tag is None else (tag, j)]):
      u = blocks.dropout(ffn.up(ffn.norm(x)), ffn.dropout, masks)
      h = torch.where(queue.popleft().to(u.device), u,
                      torch.zeros((), dtype=u.dtype))
      return blocks.dropout(ffn.down(h), ffn.dropout, masks)
    b.ffn.forward = forward


def _relu_flips(card: list, cpu: list) -> dict:
  """{block: (relu inputs on other sides of 0, the largest |input| among
  them over the largest |input| of the relu)} of the FFN relus where the
  card's and the CPU's inputs (``_ffn_relu_taps``, in call order) differ
  in sign; raises where a flipped input lies past VALUE_RELU_EDGE of its
  relu's largest (a flip further from 0 than rounding)."""
  import torch
  flips = {}
  for (j, a), (_, b) in zip(card, cpu):
    flip = (a > 0) != (b > 0)
    if flip.any():
      edge = float(b[flip].abs().max() / b.abs().max())
      n, e = flips.get(j, (0, 0.0))
      flips[j] = (n + int(flip.sum()), max(e, edge))
  if any(e > VALUE_RELU_EDGE for _, e in flips.values()):
    raise AssertionError(f'relu inputs flipped past the edge: {flips}')
  return flips


def _grads_close(got: dict, want: dict, tol: float) -> dict:
  """Each gradient's distance by norm within ``tol`` of its own norm plus
  1e-6 of the largest one's; returns {name: relative distance} and
  raises naming the leaves off it."""
  import torch
  norm = lambda t: float(torch.linalg.vector_norm(t.double()))
  if got.keys() != want.keys():
    raise AssertionError(f'gradients of other leaves: '
                         f'{sorted(set(got) ^ set(want))[:5]}')
  top = max(norm(t) for t in want.values())
  dist = {k: norm(got[k].double() - want[k].double()) for k in want}
  bad = [k for k in want if not torch.isfinite(got[k]).all()
         or not dist[k] <= tol * norm(want[k]) + 1e-6 * top]
  if bad:
    raise AssertionError(f'gradients card vs cpu: {bad[:5]} '
                         f'{[(dist[k], norm(want[k])) for k in bad[:5]]}')
  return {k: dist[k] / max(norm(want[k]), 1e-30) for k in want}


def _timed_net(dev: str, **widths):
  """The full-width timed Enformer (random, seed 8), eval mode, f32."""
  import torch
  from svdd_tpu_torch import value as value_lib
  gen = torch.Generator(dev).manual_seed(8)
  return value_lib.ValueFunction.create('dna', VALUE_L, gen, timed=True,
                                        compute_dtype=torch.float32, **widths)


def check_timed_model(dev: str = 'cuda', rows: int = TIMED_ROWS,
                      tol: float = GRAD_TOL, **widths) -> dict:
  """The full-width timed value net on TIMED_ROWS rows at L=200 (steps
  drawn per position), through its fused eval forward (the tower's six
  B3 hand-offs, its last pool on B4, the eleven L=2 attentions on B5),
  card against the CPU with the same weights: the outputs within
  MODEL_TOL of the largest, and the gradients of mean(out^2) in the
  one-hot input and in every parameter (the time table's included) by
  norm within ``tol``, the CPU's FFN relus on the card's side of 0
  (``_on_card_relus``; each input that took the other side, within
  rounding of 0, reported by ``_relu_flips``). The backward runs B3's
  repair (the gradient of its reference form), B8 for the last pool and
  B5's plain version; the launch counts of the forward and backward are
  exact."""
  import copy
  import torch
  from svdd_tpu_torch import _build, mdlm
  vf = _timed_net(dev, **widths)
  g = torch.Generator().manual_seed(9)
  tokens = torch.randint(0, 5, (rows, VALUE_L), generator=g)
  steps = torch.randint(0, 128, (rows, VALUE_L), generator=g)

  def grads(module, d, taps):
    hooks = _ffn_relu_taps(module, taps)
    if d == 'cpu' and dev != 'cpu':
      _on_card_relus(module, card_taps)
    x = mdlm.transform_samples(tokens.to(d)).requires_grad_(True)
    out = module(x, time_indices=steps.to(d))
    (out ** 2).mean().backward()
    for h in hooks:
      h.remove()
    return out.detach().cpu(), x.grad.cpu(), _named_grads(module)

  cpu_module = copy.deepcopy(vf.module).cpu()
  card_taps, cpu_taps = [], []
  if dev == 'cuda':
    torch.cuda.synchronize()
  _build.reset_launches()
  out_g, gx_g, gw_g = grads(vf.module, dev, card_taps)
  if dev == 'cuda':
    torch.cuda.synchronize()
  launches = _build.launches()
  out_c, gx_c, gw_c = grads(cpu_module, 'cpu', cpu_taps)
  if dev == 'cuda':
    want = _add(_enformer_launches(vf.module, False), {'attn_pool_bwd': 1})
    launches = _check_launches('timed model', launches, want)
  out_err = float((out_g - out_c).abs().max())
  scale = float(out_c.abs().max())
  flips = _relu_flips(card_taps, cpu_taps)
  gw_rel = _grads_close(gw_g, gw_c, tol)
  r = {'rows': rows, 'value_card': out_g.tolist(),
       'value_cpu': out_c.tolist(), 'value_max_abs_err': out_err,
       'input_grad_rel_norm_err': _rel(gx_g, gx_c),
       'max_weight_grad_rel_norm_err': max(gw_rel.values()),
       'worst_weight_grad': max(gw_rel, key=gw_rel.get),
       'time_table_grad_rel_norm_err': gw_rel['time_embedding.embedding'],
       'weight_grads': len(gw_rel),
       'grad_tol': tol,
       'relu_flips': {j: list(v) for j, v in flips.items()},
       'launches': launches}
  if not (torch.isfinite(out_g).all() and out_err <= MODEL_TOL * scale
          and r['input_grad_rel_norm_err'] <= tol):
    raise AssertionError(f'timed model card vs cpu: {r}')
  return r


def run_timed_decode(diffusion_ckpt: str, dev: str = 'cuda', cfg=None,
                     batch: int = 512, **widths) -> dict:
  """``Diffusion.controlled_sampler_timed`` (SVDD-MC with the timed net's
  step-indexed scores) at B=512, M=10, L=200, TIMED_DECODE_STEPS steps,
  f32, the f32 pretraining run's denoiser and the random full-width timed
  net; the launch counts exactly 20 B1 a denoiser forward (a step's and
  the noise removal's), one B2 a step and the timed net's eval forward
  (6 B3, 1 B4, 11 B5) a step. Each step's index, handed to the value
  function, runs 0..TIMED_DECODE_STEPS-1."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  args = cli_decode.parser().parse_args(
      ['--task', 'dna', '--device', dev, '--diffusion_checkpoint_path',
       diffusion_ckpt])
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  vf = _timed_net(dev, **widths)
  seen = []

  def score(tokens, step):
    seen.append(step)
    return vf.score_tokens(tokens, time_indices=torch.full(
        tokens.shape, step, dtype=torch.int32, device=tokens.device))

  sampler = diffusion.controlled_sampler_timed(
      score, batch, sample_M=10, num_steps=TIMED_DECODE_STEPS)
  if dev == 'cuda':
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  res = sampler(torch.Generator(dev).manual_seed(10))
  samples = res.samples.cpu()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  steps = TIMED_DECODE_STEPS
  if dev == 'cuda':
    want = _add({'cnn_layer': CNN_LAYERS * (steps + 1),
                 'gumbel_candidates': steps},
                _enformer_launches(vf.module, False), steps)
    launches = _check_launches('timed decode', launches, want)
  if (seen != list(range(steps))
      or samples.shape != (batch, cfg.model.length)
      or not ((samples >= 0) & (samples < 4)).all()):
    raise AssertionError(f'timed decode: steps {seen}, samples '
                         f'{tuple(samples.shape)}')
  return {'run': 'timed_decode', 'batch_size': batch, 'sample_M': 10,
          'steps': steps, 'step_indices': seen, 'wall_s': wall,
          'peak_mem_gb': (torch.cuda.max_memory_allocated() / 2 ** 30
                          if dev == 'cuda' else None),
          'launches': launches}


def _multisep_argv(root: str, name: str, diffusion_ckpt: str, oracle: str,
                   dev: str = 'cuda') -> list:
  return ['--task', 'dna', '--device', dev, '--model', 'multienformer',
          '--batch_size', str(VALUE_BATCH), '--max_iters',
          str(MULTISEP_ITERS), '--eval_every', '1', '--learning_rate',
          str(VALUE_LR), '--diffusion_checkpoint_path', diffusion_ckpt,
          '--reward_checkpoint_path', oracle, '--out_dir', root,
          '--save_path', os.path.join(root, f'{name}.pt')]


def _multisep_leaves(state) -> list:
  """The state's every leaf and Adam moment, in one order."""
  st = state.optimizer.adamw.state
  leaves = state.msm.leaves()
  return (leaves + [st[t]['exp_avg'] for t in leaves]
          + [st[t]['exp_avg_sq'] for t in leaves])


def _multisep_snapshot(state) -> dict:
  """The state's leaves and Adam moments on the CPU, its step, count and
  generator state."""
  return {'tensors': [t.detach().cpu() for t in _multisep_leaves(state)],
          'step': state.step, 'count': state.optimizer.count,
          'generator': state.generator.get_state()}


def _same_as_snapshot(snap: dict, state) -> bool:
  """``state`` equals the snapshot bit for bit (compared on the state's
  device, a tensor at a time)."""
  import torch
  now = _multisep_leaves(state)
  return (snap['step'] == state.step
          and snap['count'] == state.optimizer.count
          and torch.equal(snap['generator'], state.generator.get_state())
          and len(now) == len(snap['tensors'])
          and all(torch.equal(t.detach(), s.to(t.device))
                  for t, s in zip(now, snap['tensors'])))


def run_multisep_train(root: str, diffusion_ckpt: str, oracle: str,
                       dev: str = 'cuda', cfg=None, value_kwargs=None) -> dict:
  """``cli.train --model multienformer --task dna`` through its ``run``,
  twice from one seed: ten full-width Enformer trunks binned over 128
  steps (12 states a bin, 96 rows a bin's forward at batch VALUE_BATCH),
  MULTISEP_ITERS iterations from the f32 pretraining run's denoiser and
  the full-width oracle. The launch counts of the first run, set to 0
  just before and read just after, exactly: a trajectory's 20 B1
  launches x 129 forwards, the oracle's eval forward, ten eval forwards
  (6 B3, 1 B4, 11 B5 each) and ten B8 backwards (the last pool's) an
  iteration. The two runs end with every leaf (the running statistics
  included), Adam moment, count and generator equal bit for bit. Then
  one grad step of the second run traced (``trace_step``)."""
  import gc
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import train as cli_train
  reports = []
  for i in range(2):
    name = f'multisep_{i}'
    args = cli_train.parser().parse_args(
        _multisep_argv(root, name, diffusion_ckpt, oracle, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = cli_train.run(args, cfg=cfg, value_kwargs=value_kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launches()
    state, trainer = out['state'], out['trainer']
    trunk = state.msm.trunks[0]
    steps = trainer.diffusion.config.sampling.steps
    if (steps // MULTISEP_MODELS) * VALUE_BATCH != MULTISEP_ROWS:
      raise AssertionError(f'{name}: a bin forwards '
                           f'{(steps // MULTISEP_MODELS) * VALUE_BATCH} '
                           f'rows, the kernel phase held {MULTISEP_ROWS}')
    eval_fwd = _enformer_launches(trunk, False)
    want = {'cnn_layer': CNN_LAYERS * (steps + 1) * MULTISEP_ITERS,
            'attn_pool_bwd': MULTISEP_MODELS * MULTISEP_ITERS}
    _add(want, eval_fwd, (MULTISEP_MODELS + 1) * MULTISEP_ITERS)
    if dev == 'cuda':
      launches = _check_launches(name, launches, want)
    # one more step, timed alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, losses = trainer.train_step(state)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    samples, mid = trainer.trajectory(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, losses = trainer.grad_step(state, samples, mid)
    torch.cuda.synchronize()
    grad_step_ms = 1e3 * (time.perf_counter() - t0)
    losses = losses.cpu()
    if not torch.isfinite(losses).all() or state.step != MULTISEP_ITERS + 2:
      raise AssertionError(f'{name}: losses {losses}, step {state.step}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if i == 0:
      snap = _multisep_snapshot(state)
    else:
      equal = _same_as_snapshot(snap, state)
      del snap

      def once():
        trainer.grad_step(state, samples, mid)
        torch.cuda.synchronize()
      profile = trace_step(once)
    reports.append({
        'run': name, 'n_models': state.msm.n_models, 'steps': steps,
        'batch_size': VALUE_BATCH, 'iters': MULTISEP_ITERS,
        'rows_a_bin': (steps // MULTISEP_MODELS) * VALUE_BATCH,
        'leaves': sum(t.numel() for t in state.msm.leaves()),
        'wall_s': wall, 'iteration_s': step_s, 'grad_step_ms': grad_step_ms,
        'peak_mem_gb': peak, 'per_bin_losses': losses.tolist(),
        'launches': launches,
        'saved': os.path.getsize(args.save_path)})
    # the saved model (9.2 GB at full width) is not read again
    os.remove(args.save_path)
    del out, state, trainer
    gc.collect()
    torch.cuda.empty_cache()
  r = {**reports[0], 'second_run': {k: reports[1][k] for k in (
      'wall_s', 'iteration_s', 'grad_step_ms', 'peak_mem_gb')},
       'runs_equal': equal, 'grad_step_profile': profile}
  if not equal:
    raise AssertionError(f'multisep training is not deterministic: {r}')
  return r


class _Tagged(list):
  """A list view that appends (tag, block) keys: trunk ``tag``'s FFN taps
  go into the shared list as ((tag, block), input)."""

  def __init__(self, target: list, tag):
    super().__init__()
    self.target, self.tag = target, tag

  def append(self, item):
    j, t = item
    self.target.append(((self.tag, j), t))


def check_multisep_step(dev: str = 'cuda', tol: float = GRAD_TOL,
                        **widths) -> dict:
  """One ``MultiSepTrainer`` step at MULTISEP_CPU_MODELS full-width trunks
  (random, seed 11) on a short given trajectory (MULTISEP_CPU_BATCH
  trajectories of MULTISEP_CPU_STEPS states: 2 a bin, 4 rows a bin's
  forward) and the motif oracle, card against the CPU: the mean and
  per-bin losses within TRAIN_TOL, every leaf's gradient (the running
  statistics' included) by norm within ``tol``, the CPU's FFN relus on
  the card's side of 0 (as in ``check_timed_model``), and every updated
  leaf
  within TRAIN_TOL by norm of the update AdamW makes on the CPU from the
  card's gradients (AdamW's first update moves an element by the rate
  whatever its gradient's size)."""
  import copy
  import torch
  from svdd_tpu_torch import _build, rewards
  from svdd_tpu_torch import value as value_lib
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.multisep import MultiSepValueModel
  from svdd_tpu_torch.train import value as train_val
  from svdd_tpu_torch.train.diffusion import Optimizer
  gen = torch.Generator().manual_seed(11)
  msm = MultiSepValueModel.create(
      lambda g: value_lib.build_value_module(
          'dna', generator=g, compute_dtype=torch.float32, **widths),
      n_models=MULTISEP_CPU_MODELS, num_steps=MULTISEP_CPU_STEPS,
      generator=gen)
  g = torch.Generator().manual_seed(12)
  samples = torch.randint(0, 4, (MULTISEP_CPU_BATCH, VALUE_L), generator=g)
  mid = torch.randint(0, 5, (MULTISEP_CPU_STEPS - 1, MULTISEP_CPU_BATCH,
                             VALUE_L), generator=g)
  cfg = dna_config()
  tcfg = train_val.ValueTrainerConfig(learning_rate=VALUE_LR,
                                      batch_size=MULTISEP_CPU_BATCH)
  reward = rewards.synthetic_motif_oracle(VALUE_L)

  def step(d, taps):
    m = copy.deepcopy(msm).to(d)
    hooks = [h for i, t in enumerate(m.trunks) for h in _ffn_relu_taps(
        t, _Tagged(taps, i))]
    if d == 'cpu' and dev != 'cpu':
      for i, t in enumerate(m.trunks):
        _on_card_relus(t, card_taps, tag=i)
    # the denoiser is not run: the trajectory is given
    trainer = train_val.MultiSepTrainer(
        Diffusion(cfg, device=d), m, reward, tcfg)
    state = trainer.init_state(0)
    loss, losses = trainer.grad_step(state, samples.to(d), mid.to(d))
    for h in hooks:
      h.remove()
    return (loss.cpu(), losses.cpu(), [_named_grads(t) for t in m.trunks],
            [{k: v.detach().cpu() for k, v in
              list(t.named_parameters()) + list(t.named_buffers())}
             for t in m.trunks])

  card_taps, cpu_taps = [], []
  if dev == 'cuda':
    torch.cuda.synchronize()
  _build.reset_launches()
  got = step(dev, card_taps)
  if dev == 'cuda':
    torch.cuda.synchronize()
  launches = _build.launches()
  want = step('cpu', cpu_taps)
  flips = _relu_flips(card_taps, cpu_taps)
  if dev == 'cuda':
    trunk = msm.trunks[0]
    launches = _check_launches('multisep step', launches, _add(
        _add({}, _enformer_launches(trunk, False), MULTISEP_CPU_MODELS),
        {'attn_pool_bwd': MULTISEP_CPU_MODELS}))
  loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
  bin_err = max(_rel(a[None], b[None]) for a, b in zip(got[1], want[1]))
  grad_rel, upd_rel = {}, {}
  for i, trunk in enumerate(msm.trunks):
    for k, v in _grads_close(got[2][i], want[2][i], tol).items():
      grad_rel[f'{i}.{k}'] = v
    # the update AdamW makes on the CPU from the card's gradients
    m = copy.deepcopy(trunk)
    named = dict(list(m.named_parameters()) + list(m.named_buffers()))
    opt = Optimizer(named.values(), lambda count: VALUE_LR, None)
    for k, t in named.items():
      t.grad = got[2][i][k].clone()
    opt.step()
    before = dict(list(trunk.named_parameters())
                  + list(trunk.named_buffers()))
    for k, t in named.items():
      upd = got[3][i][k] - before[k].detach()
      upd_rel[f'{i}.{k}'] = _rel(upd, t.detach() - before[k].detach())
  r = {'n_models': MULTISEP_CPU_MODELS, 'rows_a_bin': 2 * MULTISEP_CPU_BATCH,
       'loss_card': float(got[0]), 'loss_cpu': float(want[0]),
       'loss_rel_err': loss_err, 'max_bin_loss_rel_err': bin_err,
       'max_grad_rel_norm_err': max(grad_rel.values()),
       'worst_grad': max(grad_rel, key=grad_rel.get),
       'stat_grads_max_rel_norm_err': max(
           v for k, v in grad_rel.items() if k.endswith(('.mean', '.var'))),
       'max_update_rel_err': max(upd_rel.values()),
       'worst_update': max(upd_rel, key=upd_rel.get),
       'grad_tol': tol,
       'relu_flips': [[t, j, *v] for (t, j), v in flips.items()],
       'leaves': len(upd_rel), 'launches': launches}
  if not (loss_err <= TRAIN_TOL and bin_err <= TRAIN_TOL
          and r['max_update_rel_err'] <= TRAIN_TOL):
    raise AssertionError(f'multisep step card vs cpu: {r}')
  return r


def a17_a11_phase(diffusion_ckpt: str) -> dict:
  """Phase 8, each part emitting its line: the reference-layout files of
  phase 5's denoiser, oracle and value net read back bit for bit, and
  cli.decode from them; the full-width timed net card vs CPU (the fused
  tower's gradient through B3's repair) and its SVDD-MC decode; cli.train
  --model multienformer twice from one seed; the 2-trunk multisep step
  card vs CPU. Returns the launch counts of its runs of the main path."""
  import torch
  root = _value_dir('reference')
  value_root = os.path.join(REPO, 'build', 'chip_smoke', 'value')
  oracle = os.path.join(value_root, 'train_oracle.pt')
  value = os.path.join(value_root, 'value_mc.pt')
  runs = {}

  def done(r, phase):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': phase, **r})
    if 'launches' in r and 'run' in r:
      runs[r['run']] = {'launches': r['launches']}
    return r

  t0 = time.perf_counter()
  r, paths = check_reference_imports(root, diffusion_ckpt, oracle, value)
  eval_fwd = r.pop('eval_launches')
  done(r, 'reference_imports')
  done(run_reference_decode(paths, root, eval_fwd), 'decode')
  for p in paths.values():
    os.remove(p)
  r = done(check_timed_model(), 'timed_model')
  runs['timed_model'] = {'launches': r['launches']}
  done(run_timed_decode(diffusion_ckpt), 'decode')
  done(run_multisep_train(root, diffusion_ckpt, oracle), 'multisep_train')
  r = done(check_multisep_step(), 'multisep_step_vs_cpu')
  runs['multisep_step'] = {'launches': r['launches']}
  emit({'phase': 'a17_a11', 'wall_s': time.perf_counter() - t0})
  return runs


# ---------------------------------------------------------------------------
# phase 9: the DiT, DiMamba and AR backbones trained, sampled and scored;
# the JAX package's checkpoints as exports
# ---------------------------------------------------------------------------

BB_TRAIN_STEPS = 4       # main_gosai --mode train steps of each backbone
BB_TRAIN_ROWS = 64       # its batch (accum 1) and validation batch
# (run name, backbone, parameterization.precision): the DNA DiT in its
# bf16 default and in f32, DiMamba and the AR baseline in their bf16
# default
BB_RUNS = (('dit_bf16', 'dit', 'bf16'), ('dit_f32', 'dit', 'fp32'),
           ('dimamba_bf16', 'dimamba', 'bf16'), ('ar_bf16', 'ar', 'bf16'))
BB_KERNEL = {'dit': 'flash_attention', 'ar': 'flash_attention_causal',
             'dimamba': 'rmsnorm'}
BB_STEP_ROWS = 4         # the one-step check, card vs CPU, f32
SEMI_AR_ROWS, SEMI_AR_STRIDE, SEMI_AR_STRIDES = 4, 8, 2
KV_ROWS, KV_FULL_ROWS = 64, 8
DPS_DIT_ROWS, DPS_DIT_STEPS = 64, 8


def _bb_config(backbone: str, precision: str):
  from svdd_tpu_torch.config import dna_config
  cfg = dna_config(backbone=backbone)
  cfg.parameterization = 'ar' if backbone == 'ar' else 'subs'
  cfg.parallel.precision = precision
  return cfg


def _bb_forward_launches(cfg) -> int:
  """B12 or B13 launches of one forward of the backbone: one a block
  (DiT, AR), one a layer and the final norm (DiMamba)."""
  if cfg.backbone == 'dimamba':
    return cfg.model.n_layer + 1
  return cfg.model.n_blocks


def run_backbone_train(name: str, backbone: str, precision: str) -> dict:
  """``main_gosai --mode train --task dna --set backbone=...`` through
  its ``run`` at full width (DiT hidden 768, 12 blocks, 12 heads; AR the
  same; DiMamba d_model 256, 4 layers; L=200) on the synthetic split:
  BB_TRAIN_STEPS steps of BB_TRAIN_ROWS rows (accum 1), validation (8
  batches of BB_TRAIN_ROWS) and a checkpoint at the last step, no
  sample-quality hook. The launch counts are set to 0 just before and
  read just after: the backbone's kernel exactly once a block (a layer)
  a forward, over the training and validation forwards; its backward is
  the plain form's gradient (no launch)."""
  import json as _json
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  root = _train_dir(f'bb_{name}')
  steps = BB_TRAIN_STEPS
  sets = [f'backbone={backbone}', f'parallel.precision={precision}',
          f'loader.global_batch_size={BB_TRAIN_ROWS}',
          f'loader.batch_size={BB_TRAIN_ROWS}',
          f'loader.eval_global_batch_size={BB_TRAIN_ROWS}',
          f'loader.eval_batch_size={BB_TRAIN_ROWS}',
          'training.accum_steps=1', 'optim.warmup_steps=1',
          f'eval.val_check_interval={steps}',
          f'checkpointing.every_n_steps={steps}']
  if backbone == 'ar':
    sets.append('parameterization=ar')
  argv = ['--mode', 'train', '--task', 'dna', '--device', 'cuda',
          '--max_steps', str(steps), '--data_dir', _no_data_dir(),
          '--ckpt_dir', os.path.join(root, 'ckpt'),
          '--log_dir', os.path.join(root, 'log'), '--no_sample_eval',
          '--set', *sets]
  args = main_gosai.parser().parse_args(argv)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  out = main_gosai.run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  cfg = out['state'].model.config
  kernel = BB_KERNEL[backbone]
  forwards = steps + 8           # the training steps, 8 validation batches
  want = {k: 0 for k in launches}
  want[kernel] = forwards * _bb_forward_launches(cfg)
  if launches != want:
    raise AssertionError(f'{name}: launches {launches}, want {want}')
  rows = [_json.loads(line) for line in open(out['metrics_path'])]
  nlls = [r['val/nll'] for r in rows if 'val/nll' in r]
  if len(nlls) != 1 or not np.isfinite(nlls).all():
    raise AssertionError(f'{name}: metrics {rows}')
  ckpts = sorted(os.listdir(os.path.join(root, 'ckpt')))
  if ckpts != ['best', f'step_{steps}.pt']:
    raise AssertionError(f'{name}: checkpoints {ckpts}')
  n_params = sum(p.numel() for p in out['state'].model.backbone.parameters())
  return {'run': f'train_{name}', 'backbone': backbone,
          'parameterization': cfg.parameterization, 'precision': precision,
          'rows': BB_TRAIN_ROWS, 'length': cfg.model.length, 'steps': steps,
          'params': n_params, 'wall_s': wall, 'val_nll': nlls[0],
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'launches': launches, 'ckpt_dir': os.path.join(root, 'ckpt')}


def profile_backbone_step(name: str, backbone: str, precision: str) -> dict:
  """One training step of the backbone at BB_TRAIN_ROWS rows (the
  trainer's ``train_step``, random full-width weights), after a warm-up
  step, under the profiler: host ms, the card's busy ms and idle share,
  device ms by kind (``trace_step``)."""
  import torch
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.train import diffusion as train_diff
  cfg = _bb_config(backbone, precision)
  cfg.optim.warmup_steps = 0
  model = Diffusion(cfg, device='cuda')
  state = train_diff.init_state(model, cfg)
  g = torch.Generator().manual_seed(4)
  batch = {'seqs': torch.randint(0, 4, (BB_TRAIN_ROWS, 200), generator=g)}

  def once():
    train_diff.train_step(state, batch, cfg)
    torch.cuda.synchronize()

  prof = trace_step(once)
  tokens = BB_TRAIN_ROWS * cfg.model.length
  return {'algo': f'train_step_{name}', 'rows': BB_TRAIN_ROWS,
          'tokens_per_s': tokens / (prof['host_step_ms'] / 1e3), **prof}


def check_backbone_step(backbone: str) -> dict:
  """One training step of the full-width backbone (random weights, the
  layers flax zero-initialises drawn non-zero; f32, TF32 off) on
  BB_STEP_ROWS rows with the same injected time and mask uniforms on
  the card (B12 or B13 forward, their plain forms' backward) and on the
  CPU: the loss within TRAIN_TOL relative, every parameter's gradient
  within TRAIN_TOL by norm (``_grads_close``), and every updated
  parameter within TRAIN_TOL by norm of the update AdamW makes on the
  CPU from the card's gradients (AdamW's first update moves an element
  by about the rate whatever its gradient's size)."""
  import copy
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.train import diffusion as train_diff
  from svdd_tpu_torch.train.diffusion import Optimizer
  cfg = _bb_config(backbone, 'fp32')
  cfg.optim.warmup_steps = 0
  model = nonzero_init(Diffusion(cfg, device='cpu').backbone, 6)
  g = torch.Generator().manual_seed(5)
  n = BB_STEP_ROWS
  batch = {'seqs': torch.randint(0, 4, (n, 200), generator=g)}
  noise = [(torch.rand(n, generator=g), torch.rand(n, 200, generator=g))]

  def step(dev):
    m = Diffusion(cfg, device=dev, backbone=copy.deepcopy(model))
    state = train_diff.init_state(m, cfg)
    seen = {}
    orig = state.optimizer.step

    def keep_grads():
      seen.update({k: p.grad.detach().cpu().clone()
                   for k, p in m.backbone.named_parameters()})
      orig()
    state.optimizer.step = keep_grads
    loss = train_diff.train_step(state, batch, cfg,
                                 None if backbone == 'ar' else
                                 [tuple(t.to(dev) for t in noise[0])])
    return float(loss), seen, {k: p.detach().cpu() for k, p in
                               m.backbone.named_parameters()}

  torch.cuda.synchronize()
  _build.reset_launches()
  got = step('cuda')
  torch.cuda.synchronize()
  launches = {k: v for k, v in _build.launches().items() if v}
  want = step('cpu')
  kernel = BB_KERNEL[backbone]
  if launches != {kernel: _bb_forward_launches(cfg)}:
    raise AssertionError(f'{backbone} step launches {launches}')
  loss_err = abs(got[0] - want[0]) / abs(want[0])
  grad_rel = _grads_close(got[1], want[1], TRAIN_TOL)
  # the update AdamW makes on the CPU from the card's gradients
  m = copy.deepcopy(model)
  named = dict(m.named_parameters())
  opt = train_diff.make_optimizer(cfg, named.values())
  for k, p in named.items():
    p.grad = got[1][k].clone()
  opt.step()
  before = dict(model.named_parameters())
  upd_rel = {k: _rel(got[2][k] - before[k].detach(),
                     p.detach() - before[k].detach())
             for k, p in named.items()}
  r = {'backbone': backbone, 'rows': n, 'length': 200,
       'loss_card': got[0], 'loss_cpu': want[0], 'loss_rel_err': loss_err,
       'max_grad_rel_norm_err': max(grad_rel.values()),
       'worst_grad': max(grad_rel, key=grad_rel.get),
       'max_update_rel_err': max(upd_rel.values()),
       'worst_update': max(upd_rel, key=upd_rel.get),
       'leaves': len(upd_rel), 'tol': TRAIN_TOL, 'launches': launches}
  if not (loss_err <= TRAIN_TOL and r['max_update_rel_err'] <= TRAIN_TOL):
    raise AssertionError(f'{backbone} step card vs cpu: {r}')
  return r


def _bb_model(ckpt_dir: str, backbone: str, precision: str, rows: int):
  """A Diffusion of the backbone holding the EMA weights of its phase-9
  training checkpoint."""
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.train import diffusion as train_diff
  cfg = _bb_config(backbone, precision)
  cfg.loader.eval_batch_size = rows
  model = Diffusion(cfg, device='cuda')
  return train_diff.load_ema_weights(model,
                                     train_diff.checkpoint_file(ckpt_dir))


def run_semi_ar(ckpt_dir: str) -> dict:
  """``main_gosai --mode sample_eval`` with ``sampling.semi_ar`` on the
  trained DiT (bf16), SEMI_AR_ROWS rows, SEMI_AR_STRIDES strides of
  SEMI_AR_STRIDE: B12 exactly 12 a denoiser call (the misses and each
  stride's final denoise)."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  cfg = _bb_config('dit', 'bf16')
  cfg.loader.eval_batch_size = SEMI_AR_ROWS
  cfg.sampling.semi_ar = True
  cfg.sampling.stride_length = SEMI_AR_STRIDE
  cfg.sampling.num_strides = SEMI_AR_STRIDES
  args = main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--device', 'cuda', '--ckpt_dir', ckpt_dir])
  torch.cuda.synchronize()
  _build.reset_launches()
  t0 = time.perf_counter()
  out = main_gosai.run(args, cfg)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  calls = out['sampling_steps'] + SEMI_AR_STRIDES + 1
  if launches['flash_attention'] != 12 * calls:
    raise AssertionError(f'semi-AR: launches {launches}, calls {calls}')
  tokens = out['tokens']
  length = 200 + SEMI_AR_STRIDES * SEMI_AR_STRIDE
  if tokens.shape != (SEMI_AR_ROWS, length) or tokens.min() < 0 or \
      tokens.max() > 3:
    raise AssertionError(f'semi-AR tokens {tokens.shape}')
  return {'run': 'semi_ar', 'rows': SEMI_AR_ROWS,
          'strides': SEMI_AR_STRIDES + 1, 'stride_length': SEMI_AR_STRIDE,
          'sampling_steps': out['sampling_steps'], 'denoiser_calls': calls,
          'caching_steps': (SEMI_AR_STRIDES + 1) * 1001, 'wall_s': wall,
          'distinct_tokens': int(np.unique(tokens).size),
          'launches': launches}


def run_ar_samplers(ckpt_dir: str) -> dict:
  """The trained AR net's decodes: ``ar_sample_kv`` at KV_ROWS rows
  (bf16, its default; the cached loop launches no kernel, as JAX's runs
  no Pallas call), then both loops in f32 on KV_FULL_ROWS rows from one
  noise draw: the full loop (B12 causal, 12 a position) gives the
  cached loop's tokens."""
  import copy
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.models import autoregressive as ar
  model = _bb_model(ckpt_dir, 'ar', 'bf16', KV_ROWS).backbone
  gen = torch.Generator('cuda').manual_seed(7)
  torch.cuda.synchronize()
  _build.reset_launches()
  t0 = time.perf_counter()
  toks = ar.ar_sample_kv(model, KV_ROWS, 200, gen)
  torch.cuda.synchronize()
  kv_s = time.perf_counter() - t0
  kv_launches = _build.launches()
  if any(kv_launches.values()) or toks.shape != (KV_ROWS, 200):
    raise AssertionError(f'ar_sample_kv: {kv_launches}, {toks.shape}')
  f32 = copy.deepcopy(model)
  f32.compute_dtype = torch.float32
  noise = torch.empty(KV_FULL_ROWS, 199, 5, device='cuda')
  noise.exponential_(generator=gen).log_().neg_()
  kv = ar.ar_sample_kv(f32, KV_FULL_ROWS, 200, noise=noise)
  _build.reset_launches()
  t0 = time.perf_counter()
  full = ar.ar_sample(f32, KV_FULL_ROWS, 200, noise=noise)
  torch.cuda.synchronize()
  full_s = time.perf_counter() - t0
  launches = _build.launches()
  same_rows = int((kv == full).all(-1).sum())
  if launches['flash_attention_causal'] != 12 * 199 or \
      same_rows < KV_FULL_ROWS - 1:
    raise AssertionError(f'ar_sample: launches {launches}, rows equal to '
                         f'the cached loop {same_rows}/{KV_FULL_ROWS}')
  return {'run': 'ar_sample', 'kv_rows': KV_ROWS, 'kv_s': kv_s,
          'full_rows': KV_FULL_ROWS, 'full_f32_s': full_s,
          'rows_equal_f32': same_rows, 'launches': launches}


def run_dit_guided(ckpt_dir: str) -> list:
  """DPS and DG (the DPS clone: its CLI's default scale, which is DPS's;
  another seed) with the trained DiT as the denoiser (bf16), DPS_DIT_ROWS
  rows,
  DPS_DIT_STEPS steps, scored by the synthetic motif oracle: each
  guided step differentiates a one-hot DiT forward, so B12 runs forward
  and its backward is its plain form's gradient. B12 is launched exactly
  12 times a DiT forward, and no other kernel at all."""
  import torch
  from svdd_tpu_torch import _build, rewards
  from svdd_tpu_torch.cli import decode_DG, decode_DPS
  model = _bb_model(ckpt_dir, 'dit', 'bf16', DPS_DIT_ROWS)
  reward = rewards.synthetic_motif_oracle(200)
  out = []
  for seed, (name, cli) in enumerate((('dps_dit', decode_DPS),
                                      ('dg_dit', decode_DG))):
    s = cli.parser().parse_args([]).guidance_scale
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = model.dps_sampler(reward, DPS_DIT_ROWS, guidance_scale=s,
                            num_steps=DPS_DIT_STEPS)(
                                torch.Generator('cuda').manual_seed(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launches()
    samples = res.samples
    # two DiT forwards a step (the one-hot forward of the gradient, and
    # log p0 at t), and the final argmax noise removal's
    forwards = 2 * DPS_DIT_STEPS + int(model.config.sampling.noise_removal)
    want = {k: 0 for k in launches}
    want['flash_attention'] = forwards * _bb_forward_launches(model.config)
    if launches != want:
      raise AssertionError(f'{name}: launches {launches}, want {want}')
    if samples.shape != (DPS_DIT_ROWS, 200) or int(samples.max()) > 3:
      raise AssertionError(f'{name}: samples {tuple(samples.shape)}, '
                           f'max {int(samples.max())}')
    with torch.no_grad():
      r = reward(torch.nn.functional.one_hot(samples, 4).float())
    out.append({'run': name, 'guidance_scale': s, 'rows': DPS_DIT_ROWS,
                'steps': DPS_DIT_STEPS, 'wall_s': wall,
                'reward_mean': float(r.mean()), 'launches': launches})
  return out


def run_gen_ppl(dit_ckpt: str, ar_ckpt: str) -> dict:
  """``main_gosai --mode sample_eval`` of the trained DiT (64 rows, 16
  steps) with ``--gen_ppl_model gpt2 --gen_ppl_ar_checkpoint`` the AR
  run's checkpoint: the Hugging Face model is not on the card's machine,
  so its ``RuntimeError`` leads to the AR scorer (JAX's own fallback,
  logged), which holds the AR run's EMA weights."""
  import logging
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  cfg = _bb_config('dit', 'bf16')
  cfg.loader.eval_batch_size = 64
  cfg.sampling.steps = 16
  cfg.sampling.num_sample_batches = 1
  args = main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--device', 'cuda', '--ckpt_dir', dit_ckpt,
       '--gen_ppl_model', 'gpt2', '--gen_ppl_ar_checkpoint', ar_ckpt])

  class Grab(logging.Handler):
    def __init__(self):
      super().__init__()
      self.lines = []

    def emit(self, record):
      self.lines.append(record.getMessage())

  grab = Grab()
  logging.getLogger(main_gosai.__name__).addHandler(grab)
  try:
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = main_gosai.run(args, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  finally:
    logging.getLogger(main_gosai.__name__).removeHandler(grab)
  launches = _build.launches()
  fell_back = any('falling back' in m for m in grab.lines)
  if not np.isfinite(out['gen_ppl']) or not launches['flash_attention'] or \
      not launches['flash_attention_causal']:
    raise AssertionError(f'gen_ppl {out["gen_ppl"]}, launches {launches}')
  return {'run': 'gen_ppl', 'gen_ppl': out['gen_ppl'],
          'hf_fallback_logged': fell_back, 'scorer': 'ar checkpoint',
          'wall_s': wall, 'launches': launches}


def check_npz_reader(diffusion_ckpt: str) -> dict:
  """Phase 5's f32 denoiser (its checkpoint's EMA weights) and MC value
  net written in the export's layout (``weights.cnn_to_jax``,
  ``weights.enformer_to_jax``: the inverse maps; ``save_export``), then
  read back through ``--diffusion_checkpoint_path`` and
  ``--load_checkpoint_path``: every parameter and buffer bit for bit."""
  import torch
  from svdd_tpu_torch import checkpoint as ckpt_lib
  from svdd_tpu_torch import weights
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  from svdd_tpu_torch.config import dna_config
  root = _train_dir('npz_reader')
  value_path = os.path.join(REPO, 'build', 'chip_smoke', 'value',
                            'value_mc.pt')
  cfg = dna_config()
  args = cli_decode.parser().parse_args(
      ['--device', 'cuda', '--diffusion_checkpoint_path', diffusion_ckpt,
       '--load_checkpoint_path', value_path])
  den = common.load_diffusion(args, cfg).backbone
  vf = common.load_value_function(args, cfg)
  t0 = time.perf_counter()
  paths = {'denoiser': os.path.join(root, 'denoiser.npz'),
           'value': os.path.join(root, 'value.npz')}
  ckpt_lib.save_export(paths['denoiser'], 'diffusion',
                       weights.cnn_to_jax(den.cpu()),
                       {'step': 0, 'config': {'backbone': 'cnn'}})
  ckpt_lib.save_export(paths['value'], 'variables',
                       weights.enformer_to_jax(vf.module.cpu()))
  write_s = time.perf_counter() - t0
  args = cli_decode.parser().parse_args(
      ['--device', 'cuda', '--diffusion_checkpoint_path', paths['denoiser'],
       '--load_checkpoint_path', paths['value']])
  t0 = time.perf_counter()
  common.reject_unported(args)
  den2 = common.load_diffusion(args, cfg).backbone
  vf2 = common.load_value_function(args, cfg)
  torch.cuda.synchronize()
  read_s = time.perf_counter() - t0
  same = {'denoiser': _same_weights(den, den2),
          'value': _same_weights(vf.module, vf2.module)}
  if not all(same.values()):
    raise AssertionError(f'npz reader: {same}')
  sizes = {k: os.path.getsize(p) / 2 ** 20 for k, p in paths.items()}
  for p in paths.values():
    os.remove(p)
  return {'bit_for_bit': same, 'mib': sizes, 'write_s': write_s,
          'read_s': read_s}


def backbones_phase(diffusion_ckpt: str) -> dict:
  """Phase 9, each part emitting its line: the four backbone training
  runs, one training step of each backbone card vs CPU, traced training
  steps, semi-AR sample_eval, the AR loops, DPS and DG with the DiT,
  gen-ppl from the AR run's checkpoint, and the .npz reader. Returns the
  launch counts of its runs of the main path."""
  import torch
  runs, ckpts = {}, {}

  def done(r, phase):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': phase, **r})
    if 'launches' in r and 'run' in r:
      runs[r['run']] = {'launches': r['launches']}
    return r

  t0 = time.perf_counter()
  for name, backbone, precision in BB_RUNS:
    r = done(run_backbone_train(name, backbone, precision), 'backbone_train')
    ckpts[name] = r['ckpt_dir']
  for backbone in ('dit', 'dimamba', 'ar'):
    r = done(check_backbone_step(backbone), 'backbone_step_vs_cpu')
    runs[f'{backbone}_step_vs_cpu'] = {'launches': r['launches']}
  for name, backbone, precision in (BB_RUNS[0], BB_RUNS[1], BB_RUNS[2]):
    done(profile_backbone_step(name, backbone, precision), 'profile')
  done(run_semi_ar(ckpts['dit_bf16']), 'sample_eval')
  done(run_ar_samplers(ckpts['ar_bf16']), 'ar_sample')
  for r in run_dit_guided(ckpts['dit_bf16']):
    done(r, 'decode')
  done(run_gen_ppl(ckpts['dit_bf16'], ckpts['ar_bf16']), 'gen_ppl')
  done(check_npz_reader(diffusion_ckpt), 'npz_reader')
  emit({'phase': 'backbones', 'wall_s': time.perf_counter() - t0})
  return runs


# ---------------------------------------------------------------------------
# phase 10: the rest of A1: the MDLM variants in training, the
# class-conditioned CNN and its classifier head, and the RNA saluki task
# ---------------------------------------------------------------------------

A1_TRAIN_STEPS = 4        # main_gosai --mode train steps of each variant
# every run's --set after TRAIN_SET: no validation and no cadence
# checkpoint inside the run (main_gosai writes the final one), so each
# run's launches are its training steps' alone
A1_SET = ['eval.val_check_interval=1000', 'checkpointing.every_n_steps=1000']
# With T > 0 every t below 1/T snaps to 1/T, where the discrete-time VLB
# is 0 x inf = NaN at that row's masked positions, in JAX as in the port
# (tests/test_torch_mdlm_variants.py holds the NaN to JAX's). At the
# default sampling_eps (1e-3) the antithetic draw puts a row there in
# most microbatches and the run's weights turn NaN; from this eps every
# snapped t is at least 3/128, so the T = 128 runs train on finite losses
A1_EPS = 0.02
A1_TRAIN = (
    ('d3pm_T128', ['parameterization=d3pm', 'T=128',
                   f'training.sampling_eps={A1_EPS}']),
    ('sedd', ['parameterization=sedd']),
    ('subs_T128', ['T=128', f'training.sampling_eps={A1_EPS}']),
    ('cosine', ['noise.type=cosine']),
    ('cosinesqr', ['noise.type=cosinesqr']),
    ('linear_importance', ['noise.type=linear',
                           'training.importance_sampling=true']),
    ('geometric', ['noise.type=geometric']),
    ('cls_free_guidance', ['model.cls_free_guidance=true']))
# the runs whose checkpoints ppl_eval and sample_eval read, and whose
# steps are traced
A1_READ = ('d3pm_T128', 'cls_free_guidance')
A1_PROFILED = ('d3pm_T128', 'sedd', 'cls_free_guidance')
# check_train_step's variants (config overrides)
A1_STEP_VARIANTS = {
    'd3pm_T128': {'parameterization': 'd3pm', 'T': 128,
                  'training': {'sampling_eps': A1_EPS}},
    'sedd': {'parameterization': 'sedd'},
    'cls_free_guidance': {'model': {'cls_free_guidance': True}}}
CLASSIFIER_ROWS = 8
# the saluki task: decodes of SALUKI_BATCH rows, M=SALUKI_M, SALUKI_STEPS
# steps (16 until phase 12 needed the time; every check kept), the
# oracle's input padded to SALUKI_FINAL rows behind a body of
# SALUKI_BODY_ROWS written from a seed
SALUKI_FINAL = 12288
SALUKI_BODY_ROWS = 2000
SALUKI_BATCH, SALUKI_M, SALUKI_STEPS = 32, 5, 4
SALUKI_CPU_ROWS = 4
SALUKI_VALUE_BATCH, SALUKI_VALUE_ITERS = 8, 2
SALUKI_ORACLE_ITERS = 20


def run_a1_train(name: str, sets) -> dict:
  """``main_gosai --mode train --task dna`` through its ``run`` at full
  width (hidden 128, 20 layers, L=200) under ``sets``: global batch 512
  in two microbatches, A1_TRAIN_STEPS steps, f32, the final checkpoint;
  the launch counts set to 0 just before and read just after: B1 and B6
  exactly 20 x 2 x steps, twice that under D3PM with T > 0. Every
  parameter and the EMA shadow must stay finite."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  root = _train_dir(f'a1_{name}')
  argv = ['--mode', 'train', '--task', 'dna', '--device', 'cuda',
          '--max_steps', str(A1_TRAIN_STEPS), '--data_dir', _no_data_dir(),
          '--ckpt_dir', os.path.join(root, 'ckpt'),
          '--log_dir', os.path.join(root, 'log'), '--no_sample_eval',
          '--set', *TRAIN_SET, *A1_SET, *sets]
  args = main_gosai.parser().parse_args(argv)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  out = main_gosai.run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  state = out['state']
  cfg = state.model.config
  per = (CNN_LAYERS * _forwards_a_microbatch(cfg) * cfg.training.accum_steps
         * A1_TRAIN_STEPS)
  _check_launches(f'a1_train_{name}', launches,
                  {'cnn_layer': per, 'cnn_layer_bwd': per})
  finite = all(bool(torch.isfinite(p).all()) for p in
               list(state.model.backbone.parameters())
               + list(state.ema.shadow.values()))
  if not finite or state.step != A1_TRAIN_STEPS:
    raise AssertionError(f'a1_train_{name}: step {state.step}, finite '
                         f'weights {finite}')
  return {'run': f'a1_train_{name}', 'set': list(sets),
          'parameterization': cfg.parameterization, 'T': cfg.T,
          'noise': cfg.noise.type,
          'cls_free_guidance': cfg.model.cls_free_guidance,
          'batch_size': cfg.loader.global_batch_size,
          'accum_steps': cfg.training.accum_steps, 'steps': state.step,
          'wall_s': wall,
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
          'launches': {k: v for k, v in launches.items() if v},
          'ckpt_dir': os.path.join(root, 'ckpt')}


def check_classifier_head() -> dict:
  """The classifier-head CNN (``classifier=True``: final_1 to hidden, the
  mean over L, cls_0, relu, cls_1) at full width on CLASSIFIER_ROWS rows
  of L=200: (N, 3) logits on the card against the CPU within
  MODEL_TOL, B1 launched once a layer."""
  import copy
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.models.cnn import CNNModel
  model = CNNModel(dna_config(), classifier=True,
                   generator=torch.Generator().manual_seed(5)).eval()
  g = torch.Generator().manual_seed(6)
  with torch.no_grad():
    for p in model.parameters():
      p.add_(0.05 * torch.randn(p.shape, generator=g))
  seq = torch.randint(0, 4, (CLASSIFIER_ROWS, 200), generator=g)
  sigma = torch.zeros(CLASSIFIER_ROWS)
  with torch.no_grad():
    want = model(seq, sigma)
    card = copy.deepcopy(model).cuda()
    _build.reset_launches()
    got = card(seq.cuda(), sigma.cuda())
    torch.cuda.synchronize()
    launches = _build.launches()
  _check_launches('classifier_head', launches, {'cnn_layer': CNN_LAYERS})
  if got.shape != (CLASSIFIER_ROWS, 3):
    raise AssertionError(f'classifier head: logits {tuple(got.shape)}')
  err, scale = _card_vs_cpu('classifier_head', got.cpu(), want, MODEL_TOL)
  return {'model': 'cnn_classifier_head', 'rows': CLASSIFIER_ROWS,
          'logits': list(got.shape), 'max_abs_err': err, 'max_abs_cpu': scale,
          'tol': MODEL_TOL, 'launches': {k: v for k, v in launches.items()
                                         if v}}


def check_gumbel_inf(gen) -> dict:
  """B2 on a log q with +inf lanes, as SEDD's log score gives them under
  time_conditioning=False (every lane but the current token's): at
  (64, 200, 5), M=10, every position MASK, a third of the positions
  with lanes 0-3 all +inf, a third with lanes 1 and 3 +inf; every draw
  equal to the plain version's (``torch.argmax``, first maximum) on the
  kernel's noise, so the all-+inf positions draw 0 and the others 1."""
  import torch
  from svdd_tpu_torch.ops import fused_sample as K
  b, l, v, m, mask = 64, 200, 5, 10, 4
  log_q = torch.log_softmax(torch.randn(b, l, v, device='cuda',
                                        generator=gen), -1)
  u = torch.rand(b, l, device='cuda', generator=gen)
  all_inf, two_inf = u < 1 / 3, (u >= 1 / 3) & (u < 2 / 3)
  lane = torch.arange(v, device='cuda')
  inf = float('inf')
  log_q = torch.where(all_inf[..., None] & (lane < 4), inf, log_q)
  log_q = torch.where(two_inf[..., None] & ((lane == 1) | (lane == 3)), inf,
                      log_q)
  x = torch.full((b, l), mask, device='cuda')
  out, noise = K.gumbel_candidates(log_q, x, m, mask, gen,
                                   return_noise=True)
  plain = K.gumbel_candidates_plain(log_q, x, noise, mask)
  if not torch.equal(out, plain):
    raise AssertionError('gumbel_candidates: +inf lanes, draws differ from '
                         'the plain version on the same noise')
  draws = out.permute(1, 0, 2)
  if not (bool((draws[:, all_inf] == 0).all())
          and bool((draws[:, two_inf] == 1).all())):
    raise AssertionError('gumbel_candidates: +inf lanes do not draw the '
                         'first maximum')
  return {'kernel': 'gumbel_candidates', 'shape': [b, m, l, v],
          'all_inf_positions': int(all_inf.sum()),
          'two_inf_positions': int(two_inf.sum()), 'max_abs_err': 0}


def write_saluki_body(root: str) -> str:
  """A saluki body of SALUKI_BODY_ROWS rows written from seed 0: a random
  coding sequence one-hot, its frame track (1 on every third row) and a
  sparse splice track, (Lb, 6) float32, as ``--saluki_body_path``
  reads it."""
  import numpy as np
  rs = np.random.default_rng(0)
  body = np.zeros((SALUKI_BODY_ROWS, 6), np.float32)
  body[np.arange(SALUKI_BODY_ROWS), rs.integers(0, 4, SALUKI_BODY_ROWS)] = 1
  body[::3, 4] = 1
  body[rs.random(SALUKI_BODY_ROWS) < 0.01, 5] = 1
  os.makedirs(root, exist_ok=True)
  path = os.path.join(root, 'saluki_body.npy')
  np.save(path, body)
  return path


def _saluki_input(rows: int, body, seed: int, device):
  import torch
  from svdd_tpu_torch import mdlm
  g = torch.Generator().manual_seed(seed)
  toks = torch.randint(0, 5, (rows, 50), generator=g)
  return mdlm.transform_samples_saluki(toks, body,
                                       final_length=SALUKI_FINAL).to(device)


def check_saluki_oracle(body_path: str) -> dict:
  """The saluki oracle (``RewardOracle.create_saluki``, the six-channel
  ConvGRU) on SALUKI_CPU_ROWS rows of (12288, 6) saluki input (RNA
  tokens, MASK rows among them, the body behind) on the card against
  the CPU within RNA_MODEL_TOL; no port kernel (its 64-channel convs are
  off B7's gate, its GRU a loop of library products)."""
  import copy
  import numpy as np
  import torch
  from svdd_tpu_torch import _build, rewards
  body = torch.from_numpy(np.load(body_path))
  oracle = rewards.RewardOracle.create_saluki(
      torch.Generator().manual_seed(0))
  x = _saluki_input(SALUKI_CPU_ROWS, body, 1, 'cpu')
  with torch.no_grad():
    want = oracle(x)
    card = rewards.RewardOracle(copy.deepcopy(oracle.module).cuda())
    _build.reset_launches()
    got = card(x.cuda())
    torch.cuda.synchronize()
  launches = _build.launches()
  if any(launches.values()):
    raise AssertionError(f'saluki oracle launched {launches}')
  err, scale = _card_vs_cpu('saluki_oracle', got.cpu(), want,
                            RNA_MODEL_TOL)
  return {'model': 'saluki_oracle', 'rows': SALUKI_CPU_ROWS,
          'input': [SALUKI_CPU_ROWS, SALUKI_FINAL, 6],
          'max_abs_err': err, 'max_abs_cpu': scale, 'tol': RNA_MODEL_TOL}


def _saluki_oracle_call(oracle, rows: int, body) -> dict:
  """One call of ``oracle`` on ``rows`` rows of saluki input at 12,288
  (warm: the decode before it ran the same shapes): ms by CUDA events,
  peak GiB allocated during it."""
  import torch
  x = _saluki_input(rows, body, 2, 'cuda')
  with torch.inference_mode():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    oracle(x)
    end.record()
    torch.cuda.synchronize()
  return {'rows': rows, 'ms': start.elapsed_time(end),
          'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30}


def run_saluki_decode(algo: str, body_path: str) -> dict:
  """``cli.decode`` (SVDD-MC, the four-channel ConvGRU value net) or
  ``cli.decode_tweedie`` (SVDD-PM, the saluki oracle scoring each step's
  B*M candidates) at --task rna_saluki, B=SALUKI_BATCH, M=SALUKI_M,
  SALUKI_STEPS steps, --skip_best_of_n, the oracle random (as JAX's CLI
  without --reward_checkpoint_path) over the body of ``body_path``;
  exact B1 and B2 counts (``rna_decode_launches``), the npz, then one
  oracle call at the run's per-step rows (B*M for SVDD-PM, B for the
  final scoring of SVDD-MC) timed with its peak memory."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  from svdd_tpu_torch.cli import decode_tweedie
  run, parser, suffix = {
      'svdd_mc': (cli_decode.run, cli_decode.parser(), ''),
      'svdd_pm': (decode_tweedie.run, decode_tweedie.parser(),
                  decode_tweedie.NPZ_SUFFIX)}[algo]
  name = f'saluki_{algo}'
  out_dir = os.path.join(REPO, 'build', 'chip_smoke', name)
  args = parser.parse_args(
      ['--task', 'rna_saluki', '--batch_size', str(SALUKI_BATCH),
       '--sample_M', str(SALUKI_M), '--num_steps', str(SALUKI_STEPS),
       '--skip_best_of_n', '--device', 'cuda', '--saluki_body_path',
       body_path, '--saluki_final_length', str(SALUKI_FINAL),
       '--out_dir', out_dir, '--run_name', f'chip_smoke_{name}'])
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  report = run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  _check_launches(name, launches, rna_decode_launches(algo, SALUKI_STEPS))
  npz_keys = _check_npz(common.npz_path(args, suffix), rows=SALUKI_BATCH)
  rows = SALUKI_BATCH * (SALUKI_M if algo == 'svdd_pm' else 1)
  oracle = common.load_reward_fn(args, None)
  call = _saluki_oracle_call(oracle, rows, torch.from_numpy(
      np.load(body_path)))
  return {'algo': algo, 'run': name, 'task': 'rna_saluki',
          'batch_size': SALUKI_BATCH, 'sample_M': SALUKI_M, 'length': 50,
          'steps': SALUKI_STEPS, 'final_length': SALUKI_FINAL,
          'body_rows': SALUKI_BODY_ROWS, 'wall_s': wall, 'peak_mem_gb': peak,
          'oracle_call': call,
          'npz': os.path.basename(common.npz_path(args, suffix)),
          'guided_reward_mean': report['decoding']['mean'],
          'baseline_reward_mean': report['baseline']['mean'],
          'launches': launches, 'npz_keys': npz_keys}


def run_saluki_train(body_path: str) -> dict:
  """``cli.train --task rna_saluki`` (MC, batch SALUKI_VALUE_BATCH,
  SALUKI_VALUE_ITERS iterations, one evaluation; 128-step trajectories)
  with the random saluki oracle's targets over the body, then
  ``cli.train_oracle --task rna_saluki`` (the four-channel ConvGRU at
  L=50, as JAX's CLI builds it; batch 64, SALUKI_ORACLE_ITERS
  iterations)."""
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import train as cli_train
  from svdd_tpu_torch.cli import train_oracle
  root = _train_dir('saluki_train')
  args = cli_train.parser().parse_args(
      ['--task', 'rna_saluki', '--device', 'cuda', '--batch_size',
       str(SALUKI_VALUE_BATCH), '--max_iters', str(SALUKI_VALUE_ITERS),
       '--eval_every', str(SALUKI_VALUE_ITERS), '--val_batch_num', '1',
       '--saluki_body_path', body_path, '--saluki_final_length',
       str(SALUKI_FINAL), '--out_dir', root,
       '--save_path', os.path.join(root, 'value.pt')])
  _build.reset_launches()
  t0 = time.perf_counter()
  out = cli_train.run(args)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  if launches['cnn_layer'] == 0 or out['state'].step != SALUKI_VALUE_ITERS:
    raise AssertionError(f'saluki value training: {launches}, step '
                         f'{out["state"].step}')
  rows = [json.loads(line) for line in open(out['metrics_path'])]
  mse = [r['eval/mse_tail'] for r in rows if 'eval/mse_tail' in r]
  if len(mse) != 1 or not np.isfinite(mse).all():
    raise AssertionError(f'saluki value training: metrics {rows}')
  t0 = time.perf_counter()
  oracle = train_oracle.run(train_oracle.parser().parse_args(
      ['--task', 'rna_saluki', '--device', 'cuda', '--max_iters',
       str(SALUKI_ORACLE_ITERS), '--log_every', str(SALUKI_ORACLE_ITERS),
       '--data_dir', _no_data_dir(),
       '--save_path', os.path.join(root, 'oracle.pt')]))
  torch.cuda.synchronize()
  oracle_s = time.perf_counter() - t0
  if (oracle['module'].in_channels != 4
      or not np.isfinite(list(oracle['losses'].values())).all()):
    raise AssertionError(f'saluki oracle training: {oracle}')
  return {'run': 'saluki_value_train', 'batch_size': SALUKI_VALUE_BATCH,
          'iters': SALUKI_VALUE_ITERS, 'wall_s': wall,
          'eval_mse_tail': mse[0],
          'value_net': type(out['state'].module).__name__,
          'value_in_channels': out['state'].module.in_channels,
          'oracle_train': {'iters': SALUKI_ORACLE_ITERS, 'wall_s': oracle_s,
                           'in_channels': oracle['module'].in_channels,
                           'losses': oracle['losses'],
                           'val_pearson': oracle['val_pearson']},
          'launches': {k: v for k, v in launches.items() if v}}


def a1_phase() -> dict:
  """Phase 10, each part emitting its line: the eight variant training
  runs, ppl_eval and sample_eval from the D3PM and class-conditioned
  checkpoints, one 8-row step of D3PM (T = 128), SEDD and the
  class-conditioned CNN card vs CPU in f32 and bf16, traced steps, the
  classifier head, B2 on +inf lanes, and the saluki task: the oracle
  card vs CPU, SVDD-MC and SVDD-PM through their CLIs, value and oracle
  training. Returns the launch counts of its runs of the main path."""
  import torch
  runs, ckpts = {}, {}

  def done(r, phase, key='run'):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': phase, **r})
    if 'launches' in r and key in r:
      runs[r[key]] = {'launches': r['launches']}
    return r

  t0 = time.perf_counter()
  for name, sets in A1_TRAIN:
    ckpts[name] = done(run_a1_train(name, sets), 'a1_train')['ckpt_dir']
  for name in A1_READ:
    sets = [*TRAIN_SET, *A1_SET, *dict(A1_TRAIN)[name]]
    r = done(run_ckpt_readers(ckpts[name], sets), 'a1_ckpt_readers')
    runs[f'a1_ckpt_readers_{name}'] = {'launches': r['launches']}
  for variant in A1_STEP_VARIANTS:
    ref = None
    for _ in range(2):
      r, ref = check_train_step(ref, variant)
      done(r, 'train_step_vs_cpu')
      runs[f'a1_step_{variant}_{r["compute_dtype"]}'] = {
          'launches': r['launches']}
  for name in A1_PROFILED:
    done(profile_train_step(False, f'train_{name}', dict(A1_TRAIN)[name]),
         'profile')
  r = done(check_classifier_head(), 'models')
  runs['classifier_head'] = {'launches': r['launches']}
  done(check_gumbel_inf(torch.Generator('cuda').manual_seed(3)),
       'kernel_inf_lanes')
  body = write_saluki_body(os.path.join(REPO, 'build', 'chip_smoke',
                                        'saluki'))
  done(check_saluki_oracle(body), 'models')
  for algo in ('svdd_mc', 'svdd_pm'):
    done(run_saluki_decode(algo, body), 'decode')
  done(run_saluki_train(body), 'saluki_train')
  emit({'phase': 'a1', 'wall_s': time.perf_counter() - t0})
  return runs


# ---------------------------------------------------------------------------
# phase 11: the supporting modules (A15) on the full-width DNA oracle
# ---------------------------------------------------------------------------

A15_SEED = 21
A15_L = 200
A15_ISM_CPU_ROWS = 8       # ISM mutants held card vs CPU, with the sequence
A15_FEW = {'integratedgradients': {'steps': 4}, 'deepshap': {'n_refs': 4}}
A15_DEFAULT_ROWS = {'integratedgradients': 32, 'deepshap': 20}
A15_EVOLVE_ROUNDS = 4
A15_LEDIDI_STEPS = 50
A15_LEDIDI_CPU_STEPS = 3
A15_LEDIDI_TARGET = 1.0
A15_MODISCO_ROWS = 64      # sequences whose IG attributions motif discovery reads
A15_VALIDATION_STEPS = 32  # the validation hook's unguided sampler
A15_VALIDATION_ROWS = 64
A15_TIMER_STEPS = 3        # SVDD-MC steps through StepTimer, B=64, M=10
A15_TOL = 1e-3             # f32 card vs CPU, of the largest value


def _a15_dir(name: str) -> str:
  return _train_dir(os.path.join('a15', name))


def _a15_oracle(bf16: bool):
  """The full-width 3-task DNA oracle (Enformer, 1536 channels, 11
  transformer blocks, random weights from A15_SEED) on the card, in f32
  or as SVDD_VALUE_BF16=1 builds a value net (bf16 compute)."""
  import torch
  from svdd_tpu_torch import rewards, value
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  with bf16_switches(bf16):
    dtype = value.value_compute_dtype()
  return rewards.RewardOracle(EnformerValueModel(
      n_tasks=3, compute_dtype=dtype,
      generator=torch.Generator('cuda').manual_seed(A15_SEED)).eval())


def _on_cpu(oracle):
  """A copy of ``oracle`` on the CPU."""
  import copy
  from svdd_tpu_torch import rewards
  return rewards.RewardOracle(copy.deepcopy(oracle.module).cpu())


def _a15_launches(rows: int, bf16: bool, backward: bool = False,
                  vmapped: bool = False) -> dict:
  """The launches of one oracle forward at ``rows`` rows (and its
  backward): B5 11; B3 6 and B4 1 where the pools take the kernels (f32;
  bf16 on JAX's gate, a multiple of 8 rows that are not vmapped
  examples, ``ops.attn_pool.wlogits_body_takes``), and then B8 1 a
  backward."""
  pools = int(not bf16 or (rows % 8 == 0 and not vmapped))
  return {'attn_pool_prologue_im2col': 6 * pools, 'attn_pool': pools,
          'attn_l2': 11, 'attn_pool_bwd': pools * backward}


def _exactly(name: str, fn, want: dict):
  """(fn's result, wall s, launches), the launch counts set to 0 just
  before and read just after; they must equal ``want``."""
  import torch
  from svdd_tpu_torch import _build
  torch.cuda.synchronize()
  _build.reset_launches()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  return out, wall, _check_launches(name, _build.launches(), want)


def _a15_close(name: str, got, want, f32_cpu=None) -> dict:
  """Card vs CPU: f32 within A15_TOL of the largest CPU value; bf16
  (given the f32 CPU result) by ``bf16_close``."""
  import torch
  got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
  if f32_cpu is None:
    err, scale = _card_vs_cpu(name, got, want, tol=A15_TOL)
    return {f'{name}_max_abs_err': err, f'{name}_max_abs': scale}
  scale = float(want.abs().max())
  err = float((got - want).abs().max())
  noise = float((want - torch.as_tensor(f32_cpu).float()).abs().max())
  if not torch.isfinite(got).all() or not bf16_close(err, noise, scale):
    raise AssertionError(f'{name} bf16 card vs cpu: max abs err {err}, '
                         f'cpu bf16-to-f32 {noise}, max |cpu| {scale}')
  return {f'{name}_max_abs_err': err, f'{name}_max_abs': scale,
          f'{name}_cpu_bf16_vs_f32': noise}


def _mutants(onehot, flat_idx):
  """The one-hots of ``onehot`` (L, 4) with base b at position l, for
  each flat index 4 l + b."""
  import torch
  out = onehot[None].repeat(len(flat_idx), 1, 1)
  for i, f in enumerate(flat_idx):
    out[i, f // 4] = torch.eye(4)[f % 4]
  return out


def a15_attributions(f32_cpu=None) -> tuple:
  """ISM, the attributions and the attention maps of one sequence on the
  full-width oracle, card vs CPU, with exact launch counts; in bf16 when
  given the f32 run's CPU results. Returns (report, CPU results,
  {run: launches})."""
  import numpy as np
  import torch
  from svdd_tpu_torch.analysis import interpret
  bf16 = f32_cpu is not None
  tag = 'bf16' if bf16 else 'f32'
  card = _a15_oracle(bf16)
  cpu = _on_cpu(card)
  onehot = _onehot_rows(1, A15_L, A15_SEED)[0]
  x = onehot.cuda()
  ref = f32_cpu or {}
  r, cpu_out, runs = {'compute_dtype': 'bfloat16' if bf16 else 'float32'}, {}, {}
  torch.cuda.reset_peak_memory_stats()

  # 1. ISM: 800 mutants in batches of 512 and 288, then the sequence
  want = _add(_add(_a15_launches(512, bf16), _a15_launches(288, bf16)),
              _a15_launches(1, bf16))
  attr, wall, runs[f'a15_ism_{tag}'] = _exactly(
      'ism', lambda: interpret.get_attributions(card, x, 'ism'), want)
  if attr.shape != (A15_L, 4) or not np.isfinite(attr).all():
    raise AssertionError(f'ism attributions: {attr.shape}')
  ism = interpret.ism_predict(card, x)
  idx = np.linspace(0, 4 * A15_L - 1, A15_ISM_CPU_ROWS).astype(int)
  with torch.no_grad():
    card_ref = card(x[None]).cpu()
    rows_cpu = torch.cat([cpu(_mutants(onehot, idx)), cpu(onehot[None])])
  cpu_out['ism'] = rows_cpu
  r.update(_a15_close('ism', torch.cat([torch.from_numpy(
      ism.reshape(-1)[idx]), card_ref]), rows_cpu, ref.get('ism')))
  r['ism_wall_s'] = wall
  r['ism_trace'] = trace_step(
      lambda: interpret.get_attributions(card, x, 'ism'))

  # 2. the gradient attributions: input x gradient, IG and EG at few
  # points card vs CPU (EG on one set of CPU draws), then at their
  # defaults on the card alone
  g = torch.Generator().manual_seed(A15_SEED)
  perms = torch.stack([torch.randperm(A15_L, generator=g) for _ in range(
      A15_FEW['deepshap']['n_refs'])])
  alphas = torch.rand(len(perms), generator=g)
  few = {'inputxgradient': {}, 'integratedgradients': A15_FEW[
      'integratedgradients'], 'deepshap': dict(perms=perms, alphas=alphas)}
  for method, kw in few.items():
    rows = {'inputxgradient': 1, 'integratedgradients': kw.get('steps'),
            'deepshap': len(perms)}[method]
    got, wall, runs[f'a15_{method}_few_{tag}'] = _exactly(
        method, lambda: interpret.get_attributions(card, x, method, **kw),
        _a15_launches(rows, bf16, True, method != 'inputxgradient'))
    cpu_out[method] = interpret.get_attributions(cpu, onehot, method, **kw)
    r.update(_a15_close(method, got, cpu_out[method], ref.get(method)))
  for method, rows in A15_DEFAULT_ROWS.items():
    call = lambda: interpret.get_attributions(
        card, x, method, generator=torch.Generator('cuda').manual_seed(0))
    got, wall, runs[f'a15_{method}_{tag}'] = _exactly(
        method, call, _a15_launches(rows, bf16, True, True))
    if not np.isfinite(got).all() or not np.abs(got).max() > 0:
      raise AssertionError(f'{method}: non-finite or zero attributions')
    r[f'{method}_rows'], r[f'{method}_wall_s'] = rows, wall
  r['integratedgradients_trace'] = trace_step(
      lambda: interpret.get_attributions(card, x, 'integratedgradients'))

  # 3. the attention maps of the 11 blocks at L' = 2
  maps, _, runs[f'a15_attention_{tag}'] = _exactly(
      'attention', lambda: interpret.get_attention_scores(card.module, x),
      _a15_launches(1, bf16))
  cpu_out['attention'] = interpret.get_attention_scores(cpu.module, onehot)
  if maps.shape != (11, 8, 2, 2) or not np.allclose(maps.sum(-1), 1.0,
                                                    atol=1e-6):
    raise AssertionError(f'attention maps {maps.shape}, row sums '
                         f'{maps.sum(-1).min()}..{maps.sum(-1).max()}')
  r.update(_a15_close('attention', maps, cpu_out['attention'],
                      ref.get('attention')))
  r['attention_shape'] = list(maps.shape)
  r['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 2 ** 30
  r['launches'] = runs
  return r, cpu_out, runs


def a15_design() -> tuple:
  """evolve (A15_EVOLVE_ROUNDS rounds) and ledidi (A15_LEDIDI_STEPS steps,
  its first losses card vs CPU) on the f32 oracle, and motif discovery
  over the IG attributions of A15_MODISCO_ROWS sequences."""
  import numpy as np
  import torch
  from svdd_tpu_torch import mdlm
  from svdd_tpu_torch.analysis import design, interpret
  card = _a15_oracle(False)
  cpu = _on_cpu(card)
  onehot = _onehot_rows(1, A15_L, A15_SEED + 1)[0]
  x = onehot.cuda()
  r, runs = {}, {}
  from svdd_tpu_torch import _build
  torch.cuda.synchronize()
  _build.reset_launches()
  t0 = time.perf_counter()
  best, hist = design.evolve(card, x, rounds=A15_EVOLVE_ROUNDS)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  ism_calls = A15_EVOLVE_ROUNDS if len(hist) > A15_EVOLVE_ROUNDS else len(
      hist)
  want = _add(_add(_add({}, _a15_launches(1, False)),
                   _a15_launches(512, False), ism_calls),
              _a15_launches(288, False), ism_calls)
  runs['a15_evolve'] = _check_launches('evolve', _build.launches(), want)
  with torch.no_grad():
    fresh = float(card(best[None])[0])
  # the last score came from a row of an ISM batch, the fresh one from a
  # one-row forward: the products sum in other orders
  if any(b < a for a, b in zip(hist, hist[1:])) or abs(
      fresh - hist[-1]) > A15_TOL * max(abs(h) for h in hist):
    raise AssertionError(f'evolve: history {hist}, fresh score {fresh}')
  r['evolve'] = {'rounds': A15_EVOLVE_ROUNDS, 'history': hist,
                 'fresh_score': fresh, 'substitutions': int(
                     (best.cpu() != onehot).any(-1).sum()),
                 'wall_s': wall}

  gumbel = mdlm.gumbel_noise((A15_LEDIDI_STEPS, A15_L, 4),
                             torch.Generator().manual_seed(A15_SEED))
  (final, hist), wall, runs['a15_ledidi'] = _exactly(
      'ledidi', lambda: design.ledidi(card, x, A15_LEDIDI_TARGET,
                                      steps=A15_LEDIDI_STEPS, gumbel=gumbel),
      _add({}, _a15_launches(1, False, True), A15_LEDIDI_STEPS))
  _, hist_cpu = design.ledidi(cpu, onehot, A15_LEDIDI_TARGET,
                              steps=A15_LEDIDI_CPU_STEPS, gumbel=gumbel)
  err = max(abs(a - b) for a, b in zip(hist, hist_cpu))
  scale = max(abs(b) for b in hist_cpu)
  if not np.isfinite(hist).all() or err > A15_TOL * scale:
    raise AssertionError(f'ledidi card vs cpu: {hist[:3]} vs {hist_cpu}')
  r['ledidi'] = {'steps': A15_LEDIDI_STEPS, 'target': A15_LEDIDI_TARGET,
                 'first_losses': hist[:A15_LEDIDI_CPU_STEPS],
                 'first_losses_cpu': hist_cpu, 'max_abs_err': err,
                 'last_loss': hist[-1], 'edits': int(
                     (final.cpu() != onehot).any(-1).sum()),
                 'wall_s': wall, 'ms_per_step': wall / A15_LEDIDI_STEPS * 1e3}

  onehots = _onehot_rows(A15_MODISCO_ROWS, A15_L, A15_SEED + 2)
  out_dir = _a15_dir('modisco')

  def attributions():
    return np.stack([interpret.get_attributions(
        card, oh.cuda(), 'integratedgradients') for oh in onehots])

  attr, wall, runs['a15_modisco_ig'] = _exactly(
      'modisco_ig', attributions, _add({}, _a15_launches(32, False, True),
                                       A15_MODISCO_ROWS))
  t0 = time.perf_counter()
  motifs = interpret.run_modisco(attr, onehots.numpy(), out_dir=out_dir)
  files = sorted(os.listdir(out_dir))
  if not {'report.json', 'motifs.meme'} <= set(files):
    raise AssertionError(f'run_modisco wrote {files}')
  r['motifs'] = {'rows': A15_MODISCO_ROWS, 'ig_wall_s': wall,
                 'discovery_s': time.perf_counter() - t0,
                 'motifs': len(motifs), 'top': json.load(open(os.path.join(
                     out_dir, 'report.json')))[:3],
                 'logos_written': sum(f.endswith('.png') for f in files)}
  r['launches'] = runs
  return r, runs


def a15_support(npz_paths) -> tuple:
  """The report over the decodes' npz files, the validation hook's
  embedding branch, StepTimer around SVDD-MC steps, profile_trace and
  nan_guard, on the f32 oracle and a random full-width denoiser."""
  import numpy as np
  import torch
  from svdd_tpu_torch import mdlm, observability
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.data import gosai
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.eval import report, validation
  from svdd_tpu_torch.sampling import guidance
  card = _a15_oracle(False)
  r, runs = {}, {}
  r['report'] = [report.report_file(p) for p in npz_paths]
  if not npz_paths:
    raise AssertionError('report: no npz files')

  cfg = dna_config()
  cfg.sampling.steps = A15_VALIDATION_STEPS
  diffusion = Diffusion(cfg, device='cuda')
  module = card.module
  embed = lambda oh: module.trunk(oh.to(module.compute_dtype)).float().mean(1)
  datasets = {'train': gosai.GosaiDataset('train', length=A15_L,
                                          data_dir=_no_data_dir())}
  from svdd_tpu_torch import _build
  torch.cuda.synchronize()
  _build.reset_launches()
  t0 = time.perf_counter()
  metrics = validation.distribution_eval(
      diffusion, datasets, torch.Generator('cuda').manual_seed(0),
      embed_fn=embed, n_batches=1, batch_size=A15_VALIDATION_ROWS,
      subset_size=4 * A15_VALIDATION_ROWS)
  torch.cuda.synchronize()
  if not np.isfinite(metrics.get('emb_pca_ws', np.nan)):
    raise AssertionError(f'validation: {metrics}')
  # the sampler's steps and its noise removal, then the embeddings of the
  # samples and of as many train rows
  runs['a15_validation'] = _check_launches(
      'validation', _build.launches(),
      _add({'cnn_layer': 20 * (cfg.sampling.steps + 1)},
           _a15_launches(A15_VALIDATION_ROWS, False), 2))
  r['validation'] = {**metrics, 'wall_s': time.perf_counter() - t0,
                     'samples': A15_VALIDATION_ROWS,
                     'steps': cfg.sampling.steps}

  step = guidance.svdd_mc_step(
      diffusion.forward, lambda toks: card(mdlm.transform_samples(toks)),
      diffusion.schedule, cfg.mask_index, repeats=10)
  xt = mdlm.sample_prior((A15_VALIDATION_ROWS, A15_L), cfg.mask_index,
                         'cuda')
  gen = torch.Generator('cuda').manual_seed(1)
  timer = observability.StepTimer()

  def steps():
    for _ in range(A15_TIMER_STEPS):
      timer.start()
      with torch.inference_mode():
        out = step(xt, torch.tensor(0.5), torch.tensor(0.49), gen)
      timer.stop(out)

  per_step = {'cnn_layer': 20, 'gumbel_candidates': 1,
              **_a15_launches(10 * A15_VALIDATION_ROWS, False)}
  _, _, runs['a15_step_timer'] = _exactly(
      'step_timer', steps, _add({}, per_step, A15_TIMER_STEPS))
  r['step_timer'] = {'batch_size': A15_VALIDATION_ROWS, 'sample_M': 10,
                     **timer.summary()}

  x = _onehot_rows(1, A15_L, A15_SEED)[0].cuda()
  trace_dir = _a15_dir('profile')
  with observability.profile_trace(trace_dir), torch.no_grad():
    out = card(x[None])
  traces = [f for f in os.listdir(trace_dir) if f.endswith('.pt.trace.json')]
  if len(traces) != 1:
    raise AssertionError(f'profile_trace wrote {os.listdir(trace_dir)}')
  r['profile_trace'] = {'file': traces[0], 'bytes': os.path.getsize(
      os.path.join(trace_dir, traces[0]))}
  planted = out.clone()
  planted[0] = float('nan')
  clean, bad = (observability.nan_guard({'out': o}, 'oracle output')
                for o in (out, planted))
  if bool(clean) or not bool(bad) or clean.device != out.device:
    raise AssertionError(f'nan_guard: {clean}, {bad}')
  r['nan_guard'] = {'clean': bool(clean), 'planted_nan': bool(bad)}
  r['launches'] = runs
  return r, runs


def a15_phase(npz_paths) -> dict:
  """Phase 11, each part emitting its line: the attributions in f32, then
  in bf16 against the f32 CPU results, design and motif discovery, the
  report, validation and observability tools. Returns the launch counts
  of its runs."""
  import torch
  runs = {}

  def done(r, phase):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': phase, **r})

  t0 = time.perf_counter()
  ref = None
  for _ in range(2):
    r, ref, more = a15_attributions(ref)
    runs.update(more)
    done(r, 'a15_attributions')
  for fn in (a15_design, lambda: a15_support(npz_paths)):
    r, more = fn()
    runs.update(more)
    done(r, 'a15_design' if 'evolve' in r else 'a15_support')
  emit({'phase': 'a15', 'wall_s': time.perf_counter() - t0})
  return {k: {'launches': v} for k, v in runs.items()}


def kernel_checks() -> list:
  """(name, check(dtype, generator)) of the kernel phase, in order; each
  runs in float32 and bfloat16. B2 (gumbel_candidates, float32 only) is
  checked after them."""
  return [('cnn_layer', check_cnn_layer),
          ('attn_pool_prologue_im2col', check_attn_pool_im2col),
          ('attn_pool', check_attn_pool), ('attn_l2', check_attn_l2),
          ('cnn_layer_bwd', check_cnn_layer_bwd),
          ('conv1d_bwd', check_conv1d_bwd),
          ('attn_pool_bwd', check_attn_pool_bwd),
          ('flash_attention',
           lambda dt, g: check_flash_attention(dt, g, False)),
          ('flash_attention_causal',
           lambda dt, g: check_flash_attention(dt, g, True)),
          ('flash_attention_d128', lambda dt, g: check_flash_attention(
              dt, g, False, ATTN_SHAPE_D128)),
          ('flash_attention_causal_d128', lambda dt, g: check_flash_attention(
              dt, g, True, ATTN_SHAPE_D128)),
          ('flash_attention_l200', lambda dt, g: check_flash_attention(
              dt, g, False, ATTN_SHAPE_L200)),
          ('flash_attention_causal_l200', lambda dt, g: check_flash_attention(
              dt, g, True, ATTN_SHAPE_L200)),
          ('rmsnorm', check_rmsnorm),
          ('nacdr_im2col', check_nacdr_im2col),
          ('fused_conv1d', check_fused_conv1d),
          ('attn_pool_logits', check_attn_pool_logits),
          ('attn_pool_logits_im2col', check_attn_pool_logits_im2col)]


# ---------------------------------------------------------------------------
# phase 12: the parallel paths (A16.1-A16.3) at world 1 under NCCL
# ---------------------------------------------------------------------------

# pretraining at phase 6's configuration, cut to PAR_TRAIN_STEPS steps
# without validation; value training at phase 5's, cut to one iteration
# of PAR_VALUE_STEPS sampling steps; SVDD-MC at phase 4's, PAR_DECODE_STEPS
PAR_TRAIN_STEPS = 4
PAR_TRAIN_SET = ['training.accum_steps=2', 'optim.warmup_steps=2',
                 'eval.val_check_interval=1000',
                 'checkpointing.every_n_steps=1000']
PAR_VALUE_STEPS = 16
PAR_DECODE_STEPS = 4
PAR_RUNS = ('dp_train', 'fsdp_train', 'value_dist', 'value_dist_fsdp',
            'svdd_mc_grid', 'svdd_mc_grid_tp')
PAR_KERNELS = {'dp_train': ('cnn_layer', 'cnn_layer_bwd'),
               'fsdp_train': ('cnn_layer', 'cnn_layer_bwd'),
               'value_dist': ('cnn_layer', 'attn_pool_prologue_im2col',
                              'attn_pool', 'attn_l2', 'conv1d_bwd',
                              'attn_pool_bwd'),
               'value_dist_fsdp': ('cnn_layer', 'gumbel_candidates',
                                   'attn_pool_prologue_im2col', 'attn_pool',
                                   'attn_l2', 'conv1d_bwd', 'attn_pool_bwd'),
               'svdd_mc_grid': ('cnn_layer', 'gumbel_candidates',
                                'attn_pool_prologue_im2col', 'attn_pool',
                                'attn_l2'),
               'svdd_mc_grid_tp': ('cnn_layer', 'gumbel_candidates',
                                   'attn_pool_prologue_im2col', 'attn_pool',
                                   'attn_l2')}


# A16.3: phase 9's DNA DiT (hidden 768, 12 blocks, L=200, BB_TRAIN_ROWS
# rows), dropout 0, f32 with TF32 off, PAR_PIPE_STEPS steps of
# ``train_step`` with the pipelined apply on a one-stage pipe grid (JAX's CLI ignores the
# pipeline at one stage), at M = 4 and at V = 2 (M = S = 1: the plain
# ops), against the plain step, its twin (which issues no collective, and
# runs in the worker)
PAR_PIPE_STEPS = 4
PAR_PIPE_RUNS = {'pipe_train_m4': dict(num_microbatches=4),
                 'pipe_train_v2': dict(virtual=2)}
PAR_PIPE_TWIN = 'pipe_twin'
# JAX's tolerances for its pipelined step against the plain one
# (tests/test_parallel.py:510-516): the loss, the parameters
PAR_PIPE_LOSS_RTOL, PAR_PIPE_ATOL, PAR_PIPE_RTOL = 1e-5, 2e-5, 2e-4
# sp_mha at the text DiT's attention, against mha, on a 1 x 1 grid
PAR_SP_SHAPE = (64, 1024, 12, 64)


def _pipe_state(apply, mesh):
  """(losses, state, a batch) of PAR_PIPE_STEPS steps of the full-width
  DiT (random weights, ``nonzero_init``) on seeded batches, through
  ``train_step`` with ``pipelined_backbone_apply(**apply)`` on ``mesh``,
  or with the plain forward (``apply`` None); the noise from the state's
  generator, seeded alike in every run."""
  import torch
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.parallel.pipeline import pipelined_backbone_apply
  from svdd_tpu_torch.train import diffusion as train_diff
  cfg = _bb_config('dit', 'fp32')
  cfg.model.dropout = 0.0
  cfg.optim.warmup_steps = 1
  model = Diffusion(cfg, device='cuda')
  nonzero_init(model.backbone, 6)
  state = train_diff.init_state(model, cfg)
  if apply is not None:
    state.apply_fn = pipelined_backbone_apply(model.backbone, mesh=mesh,
                                              **apply)
  g = torch.Generator('cuda').manual_seed(4)
  batches = [{'seqs': torch.randint(0, 4, (BB_TRAIN_ROWS, cfg.model.length),
                                    device='cuda', generator=g)}
             for _ in range(PAR_PIPE_STEPS)]
  losses = [float(train_diff.train_step(state, b, cfg)) for b in batches]
  return losses, state, batches[0]


def _pipe_tree(state) -> dict:
  """The state's parameters, EMA shadow and Adam moments (views)."""
  named = dict(state.model.backbone.named_parameters())
  adam = state.optimizer.adamw.state
  return {'params': {k: p.detach() for k, p in named.items()},
          'ema': dict(state.ema.shadow),
          **{m: {k: adam[p][m] for k, p in named.items()}
             for m in ('exp_avg', 'exp_avg_sq')}}


def _pipe_compare(got: dict, want: dict) -> dict:
  """Bit for bit or not, the largest difference of each part, and
  whether the parameters and EMA are within JAX's tolerances."""
  import torch
  bitwise = all(torch.equal(got[p][k], want[p][k]) for p in want
                for k in want[p])
  max_abs = {p: max(float((got[p][k] - w).abs().max())
                    for k, w in want[p].items()) for p in want}
  within = all(bool(((got[p][k] - w).abs()
                     <= PAR_PIPE_ATOL + PAR_PIPE_RTOL * w.abs()).all())
               for p in ('params', 'ema') for k, w in want[p].items())
  return {'bitwise': bitwise, 'max_abs': max_abs, 'within_tol': within}


def _par_pipe(counted, res: dict) -> None:
  """The A16.3 runs of the worker, into ``res`` (where ``counted`` keeps
  each run's launches, collectives and peak memory): the plain twin, the
  pipelined runs of PAR_PIPE_RUNS each held to it (losses, parameters, EMA,
  moments) and timed by ``trace_step``; then ``sp_mha`` against ``mha``
  at PAR_SP_SHAPE, causal and not, with the input gradients."""
  import torch
  from svdd_tpu_torch.ops.attention import mha, sp_mha
  from svdd_tpu_torch.parallel import mesh as M
  from svdd_tpu_torch.train import diffusion as train_diff
  t0 = time.perf_counter()
  pipe = M.make_pipe_mesh(1)
  twin_losses, twin, batch = counted(PAR_PIPE_TWIN,
                                     lambda: _pipe_state(None, None))
  want = _pipe_tree(twin)
  res[PAR_PIPE_TWIN].update(losses=twin_losses, microbatches=1)
  for name, apply in PAR_PIPE_RUNS.items():
    losses, state, b = counted(name, lambda: _pipe_state(apply, pipe))
    res[name].update(
        losses=losses, twin_losses=twin_losses, apply=apply,
        microbatches=apply.get('num_microbatches', 1),
        loss_rel_err=max(abs(a - w) / abs(w)
                         for a, w in zip(losses, twin_losses)),
        **_pipe_compare(_pipe_tree(state), want))
    res[name]['trace'] = trace_step(lambda: (train_diff.train_step(
        state, b, state.model.config), torch.cuda.synchronize()))
    del state
    torch.cuda.empty_cache()
  del want
  res[PAR_PIPE_TWIN]['trace'] = trace_step(lambda: (train_diff.train_step(
      twin, batch, twin.model.config), torch.cuda.synchronize()))
  res[PAR_PIPE_TWIN]['n_blocks'] = twin.model.config.model.n_blocks
  # what the backward's all-reduce sums at S stages: every block's gradient
  res[PAR_PIPE_TWIN]['block_grad_bytes'] = sum(
      p.numel() * p.element_size()
      for p in twin.model.backbone.blocks.parameters())
  del twin
  torch.cuda.empty_cache()
  grid = M.make_mesh(1, 1)
  g = torch.Generator('cuda').manual_seed(8)
  q, k, v, w = (torch.randn(PAR_SP_SHAPE, device='cuda', generator=g)
                for _ in range(4))
  for causal in (False, True):
    def grads(fn):
      xs = [t.clone().requires_grad_() for t in (q, k, v)]
      out = fn(*xs)
      (out * w).sum().backward()
      return [out.detach()] + [x.grad for x in xs]
    name = 'sp_mha_causal' if causal else 'sp_mha'
    got = counted(name, lambda: grads(
        lambda q, k, v: sp_mha(q, k, v, grid, 'model', causal)))
    ref = grads(lambda q, k, v: mha(q, k, v, causal))
    res[name].update(
        shape=list(PAR_SP_SHAPE), causal=causal,
        bitwise=all(torch.equal(a, b) for a, b in zip(got, ref)),
        max_abs_err=max(float((a - b).abs().max())
                        for a, b in zip(got, ref)),
        ms=median_ms(lambda: sp_mha(q, k, v, grid, 'model', causal)),
        mha_ms=median_ms(lambda: mha(q, k, v, causal)))
    del got, ref
    torch.cuda.empty_cache()
  res['pipe_wall_s'] = time.perf_counter() - t0


def check_gumbel_row0(gen) -> dict:
  """B2's row0 at the decode's (512, 10, 200, 5): two launches on the
  row halves (row0 0 and 256), each from the generator's state before the
  full launch, equal the full launch bit for bit, candidates and noise,
  and the second half's draws are the plain version's on its noise. The
  row0 form's time: a full-size launch at row0 512 (rows 512-1023 of a
  batch of 1024), beside the plain version's and its bound."""
  import torch
  from svdd_tpu_torch.mdlm import gumbel_noise
  from svdd_tpu_torch.ops import fused_sample as K
  from svdd_tpu_torch.parallel import rows
  b, l, v, m, mask = 512, 200, 5, 10, 4
  log_q = torch.log_softmax(torch.randn(b, l, v, device='cuda',
                                        generator=gen), -1)
  x = torch.randint(0, 4, (b, l), device='cuda', generator=gen)
  x = torch.where(torch.rand(b, l, device='cuda', generator=gen) < 0.5,
                  mask, x)
  state = gen.get_state()
  full, noise = K.gumbel_candidates(log_q, x, m, mask, gen,
                                    return_noise=True)
  after = gen.get_state()
  halves = []
  for row0 in (0, b // 2):
    gen.set_state(state)
    with rows.global_rows(row0, b):
      halves.append(K.gumbel_candidates(
          log_q[row0:row0 + b // 2], x[row0:row0 + b // 2], m, mask, gen,
          return_noise=True))
    if not torch.equal(gen.get_state(), after):
      raise AssertionError('gumbel_candidates row0: the generator moved '
                           'otherwise than the full launch')
  out = torch.cat([h[0] for h in halves])
  if not (torch.equal(out, full)
          and torch.equal(torch.cat([h[1] for h in halves]), noise)):
    raise AssertionError('gumbel_candidates row0: the halves differ from '
                         'the full launch')
  if not torch.equal(halves[1][0], K.gumbel_candidates_plain(
      log_q[b // 2:], x[b // 2:], halves[1][1], mask)):
    raise AssertionError('gumbel_candidates row0: draws differ from the '
                         'plain version on their noise')

  def plain():
    return K.gumbel_candidates_plain(log_q, x, gumbel_noise(
        (b, m, l, v), gen, 'cuda'), mask)

  def second_block():             # rows 512-1023 of a batch of 1024
    with rows.global_rows(b, 2 * b):
      return K.gumbel_candidates(log_q, x, m, mask, gen)
  es = x.element_size()
  nbytes = b * l * v * 4 + b * l * es + b * m * l * es
  n_drawn = int((x == mask).sum()) * m
  bound_ms, bound_by, work = gumbel_bound(n_drawn, v, nbytes)
  return {'shape': [b, m, l, v], 'row0_timed': b, 'halves_bitwise': True,
          'max_abs_err': 0,
          **timed(second_block, plain),
          'bound_ms': bound_ms, 'bound_by': bound_by, 'work': work}


# phase 6's empty data directory (the synthetic split)
PAR_DATA_DIR = os.path.join(REPO, 'build', 'chip_smoke', 'no_data')


def _par_train_argv(root: str, fsdp: bool) -> list:
  sets = PAR_TRAIN_SET + (['parallel.fsdp=true'] if fsdp else [])
  return ['--mode', 'train', '--task', 'dna', '--device', 'cuda',
          '--max_steps', str(PAR_TRAIN_STEPS), '--data_dir', PAR_DATA_DIR,
          '--ckpt_dir', os.path.join(root, 'ckpt'), '--log_dir',
          os.path.join(root, 'log'), '--no_sample_eval', '--set', *sets]


def _par_value_argv(root: str, name: str, diffusion_ckpt: str,
                    oracle: str) -> list:
  return ['--task', 'dna', '--device', 'cuda', '--batch_size',
          str(VALUE_BATCH), '--max_iters', '1', '--eval_every', '1',
          '--val_batch_num', '1', '--num_steps', str(PAR_VALUE_STEPS),
          '--learning_rate', str(VALUE_LR), '--diffusion_checkpoint_path',
          diffusion_ckpt, '--reward_checkpoint_path', oracle, '--out_dir',
          root, '--run_name', name]


def fingerprint(tree) -> list:
  """[(path, dtype, shape, bits sum, position-weighted bits sum)] of the
  tensors of a nested dict, on the card: two states with the same
  fingerprint agree bit for bit but for a collision of both sums (the
  phase compares multi-GB trainer states across processes this way)."""
  import torch
  out = []

  def walk(x, path):
    if isinstance(x, dict):
      for k in sorted(x, key=str):
        walk(x[k], f'{path}/{k}')
    elif torch.is_tensor(x):
      t = x.detach().contiguous().reshape(-1)
      bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[t.element_size()]
      b = t.view(bits).to(torch.int64)
      idx = torch.arange(1, b.numel() + 1, device=b.device)
      out.append([path, str(x.dtype), list(x.shape), int(b.sum()),
                  int((b * idx).sum())])
    else:
      out.append([path, repr(x)])
  walk(tree, '')
  return out


def _losses_of(module, attr: str, out: list):
  """Wrap ``module.attr`` (a step returning its loss) to keep each loss;
  returns the restore function."""
  orig = getattr(module, attr)

  def wrapped(*a, **kw):
    loss = orig(*a, **kw)
    out.append(float(loss))
    return loss
  setattr(module, attr, wrapped)
  return lambda: setattr(module, attr, orig)


def _par_decode(mesh=None, tp: bool = False):
  """SVDD-MC at phase 4's models (random full-width, from the CLIs'
  seeds), B=512, M=10, PAR_DECODE_STEPS steps, seed 0: the samples and
  the host ms a step (the kernels warm from phase 4)."""
  import torch
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.models.enformer import tp_shard_value_params
  from svdd_tpu_torch.value import ValueFunction
  args = common.make_parser('chip smoke').parse_args(
      ['--task', 'dna', '--batch_size', '512', '--sample_M', '10',
       '--device', 'cuda'])
  cfg = common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  vf = common.load_value_function(args, cfg)
  if tp:
    vf = ValueFunction(tp_shard_value_params(vf.module, mesh), vf.length)
  sample = diffusion.controlled_sampler(
      vf.score_tokens, 512, sample_M=10, num_steps=PAR_DECODE_STEPS,
      mesh=mesh, tp=tp)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = sample(torch.Generator('cuda').manual_seed(0)).samples
  torch.cuda.synchronize()
  return out, (time.perf_counter() - t0) / PAR_DECODE_STEPS * 1e3


def _par_runs(root: str, diffusion_ckpt: str, oracle: str,
              grid: bool) -> dict:
  """The runs of phase 12, on the process grid (``grid``, in the torchrun
  worker) or without a process group (the twins, in this process). Each
  run's launch counts and collectives are set to 0 just before it and
  read just after."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import main_gosai
  from svdd_tpu_torch.cli import train as cli_train
  from svdd_tpu_torch.data import gosai
  from svdd_tpu_torch.parallel import mesh as M
  from svdd_tpu_torch.train import diffusion as train_diff
  from svdd_tpu_torch.train import value as train_val
  res = {}

  def counted(name, fn):
    torch.cuda.synchronize()
    _build.reset_launches()
    M.reset_collectives()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    res[name] = {'wall_s': time.perf_counter() - t0,
                 'launches': _build.launches(),
                 'collectives': M.collectives(),
                 'peak_mib': torch.cuda.max_memory_allocated() / 2 ** 20}
    return out

  for name, fsdp in (('dp_train', False), ('fsdp_train', True)):
    if not grid and fsdp:
      continue                      # one twin serves both
    run_root = os.path.join(root, name)
    losses = []
    restore = _losses_of(train_diff, 'train_step', losses)
    try:
      args = main_gosai.parser().parse_args(_par_train_argv(run_root, fsdp))
      out = counted(name, lambda: main_gosai.run(args))
    finally:
      restore()
    state = out['state']
    res[name].update(losses=losses, state=fingerprint(torch.load(
        train_diff.latest_checkpoint(os.path.join(run_root, 'ckpt')),
        map_location='cuda', weights_only=True)))
    # the card's time a step: the run's steps under the profiler
    it = iter(gosai.get_dataloaders(
        state.model.config, num_shards=1 if state.mesh is None
        else state.mesh.data, skip_valid=True, data_dir=PAR_DATA_DIR)[0])
    batch = next(it)
    res[name]['trace'] = trace_step(lambda: (train_diff.train_step(
        state, batch, state.model.config), torch.cuda.synchronize()))
    del out, state
    torch.cuda.empty_cache()
  for name, extra in (('value_dist', []), ('value_dist_fsdp', ['--cdq'])):
    if grid:
      extra = extra + ['--dist'] + (['--fsdp'] if 'fsdp' in name else [])
    losses = []
    restore = _losses_of(train_val.ValueTrainer, 'train_step', losses)
    try:
      args = cli_train.parser().parse_args(
          _par_value_argv(root, name, diffusion_ckpt, oracle) + extra)
      out = counted(name, lambda: cli_train.run(args))
    finally:
      restore()
    state = out['state']
    res[name].update(losses=losses,
                     state=fingerprint(out['trainer'].state_dict(state)))
    del out, state
    torch.cuda.empty_cache()
  mesh = M.make_mesh(1, 1) if grid else None
  for name, tp in (('svdd_mc_grid', False), ('svdd_mc_grid_tp', True)):
    if not grid and tp:
      continue
    samples, step_ms = counted(name, lambda: _par_decode(mesh, tp))
    path = os.path.join(root, f'{name}_samples.pt')
    torch.save(samples.cpu(), path)
    res[name].update(samples=path, step_ms=step_ms)
  if grid:
    _par_pipe(counted, res)
  return res


def parallel_worker(out_json: str, diffusion_ckpt: str, oracle: str) -> None:
  """Phase 12's process on the grid, started under torchrun by
  ``parallel_phase``: its runs, then their results into ``out_json``."""
  import torch
  sys.path.insert(0, REPO)
  from svdd_tpu_torch.parallel import mesh as M
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  if not M.initialize_multihost(device='cuda'):
    raise SystemExit('parallel worker: no torchrun environment')
  if torch.distributed.get_backend() != 'nccl':
    raise SystemExit('parallel worker: the group is not NCCL')
  root = os.path.dirname(out_json)
  res = _par_runs(root, diffusion_ckpt, oracle, grid=True)
  res['world_size'] = torch.distributed.get_world_size()
  with open(out_json, 'w') as f:
    json.dump(res, f)
  torch.distributed.destroy_process_group()


def parallel_phase(diffusion_ckpt: str) -> dict:
  """Phase 12: ``torchrun --nproc_per_node=1`` runs ``parallel_worker``
  (NCCL, a world of one) through the entry points: ``main_gosai --mode
  train`` DP and with ``parallel.fsdp=true`` (full-width denoiser, batch
  512, accum 2, PAR_TRAIN_STEPS steps), ``cli.train --dist`` (MC) and
  ``--dist --fsdp`` (CD-Q) on the full-width value net from phase 6's
  checkpoint and phase 5's oracle, and SVDD-MC on a 1 x 1 grid, with and
  without the tensor-parallel value net. This process runs the same
  without a process group; each pair must agree bit for bit (losses,
  checkpoints or trainer states, samples), each grid run must have issued
  collectives and launched its kernels. Times: each training step on
  the card under the profiler (host ms, busy ms, idle share) and each
  decode's host ms a step, the grid's beside its twin's. Then the A16.3
  runs of the worker (``_par_pipe``): the pipelined DiT step at V = 2 bit
  for bit its plain twin, at M = 4 within JAX's tolerances, B12 launched
  exactly once a block a microbatch forward, the permutes, broadcast and
  all-reduce issued; ``sp_mha`` bit for bit ``mha``."""
  import torch
  root = _value_dir('parallel')
  oracle = os.path.join(REPO, 'build', 'chip_smoke', 'value',
                        'train_oracle.pt')
  out_json = os.path.join(root, 'grid.json')
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, '-m', 'torch.distributed.run', '--standalone',
       '--nproc_per_node=1', os.path.abspath(__file__), '--parallel-worker',
       out_json, diffusion_ckpt, oracle], cwd=REPO, capture_output=True,
      text=True, timeout=600)
  worker_s = time.perf_counter() - t0
  if proc.returncode != 0:
    raise AssertionError(f'parallel worker exited {proc.returncode}:\n'
                         f'{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}')
  with open(out_json) as f:
    grid = json.load(f)
  twin = _par_runs(os.path.join(root, 'twin'), diffusion_ckpt, oracle,
                   grid=False)
  runs, lines = {}, []
  for name in PAR_RUNS:
    g = grid[name]
    t = twin[name.replace('fsdp_train', 'dp_train').replace(
        'svdd_mc_grid_tp', 'svdd_mc_grid')]
    missing = [k for k in PAR_KERNELS[name] if not g['launches'].get(k)]
    if missing or not sum(g['collectives'].values()):
      raise AssertionError(f'{name}: launches {g["launches"]}, collectives '
                           f'{g["collectives"]}')
    if 'state' in g:          # a checkpoint's or a trainer state's tensors
      same = g['losses'] == t['losses'] and g['state'] == t['state']
    else:
      same = torch.equal(torch.load(g['samples']), torch.load(t['samples']))
    if not same:
      raise AssertionError(f'{name}: the grid run differs from its twin '
                           f'(losses {g.get("losses")} vs {t.get("losses")})')
    line = {'run': name, 'bitwise_twin': True, 'world_size':
            grid['world_size'], 'backend': 'nccl',
            'collectives': g['collectives'], 'launches': g['launches'],
            'wall_s': g['wall_s'], 'twin_wall_s': t['wall_s'],
            'peak_mib': g['peak_mib'], 'twin_peak_mib': t['peak_mib']}
    for k in ('losses', 'step_ms'):
      if k in g:
        line[k], line[f'twin_{k}'] = g[k], t[k]
    if 'trace' in g:
      line['step'] = {k: g['trace'][k] for k in
                      ('host_step_ms', 'device_busy_ms', 'idle_share')}
      line['twin_step'] = {k: t['trace'][k] for k in
                           ('host_step_ms', 'device_busy_ms', 'idle_share')}
    lines.append(line)
    runs[name] = {'launches': g['launches']}
  n_blocks = grid[PAR_PIPE_TWIN]['n_blocks']
  for name in (PAR_PIPE_TWIN, *PAR_PIPE_RUNS):
    g = grid[name]
    want = {k: 0 for k in g['launches']}
    want['flash_attention'] = (PAR_PIPE_STEPS * n_blocks
                               * g['microbatches'])
    if g['launches'] != want:
      raise AssertionError(f'{name}: launches {g["launches"]}, want {want}')
    if name != PAR_PIPE_TWIN:
      kinds = {k for k, v in g['collectives'].items() if v}
      if kinds != {'permute', 'broadcast', 'all_reduce'}:
        raise AssertionError(f'{name}: collectives {g["collectives"]}')
      if name == 'pipe_train_v2' and not (g['bitwise'] and
                                          g['losses'] == g['twin_losses']):
        raise AssertionError(f'{name}: not bit for bit its twin: {g}')
      if not (g['within_tol'] and g['loss_rel_err'] <= PAR_PIPE_LOSS_RTOL):
        raise AssertionError(f'{name}: outside the tolerances: {g}')
    line = {'run': name, **{k: g[k] for k in g if k != 'trace'},
            'forward_b12_launches': n_blocks * g['microbatches'],
            'step': {k: g['trace'][k] for k in
                     ('host_step_ms', 'profiled_step_ms', 'device_busy_ms',
                      'idle_share', 'idle_share_host', 'by_kind_ms')}}
    emit({'phase': 'parallel_pipe', **line})
    runs[name] = {'launches': g['launches']}
  for name in ('sp_mha', 'sp_mha_causal'):
    g = grid[name]
    if not g['bitwise'] or not sum(g['collectives'].values()):
      raise AssertionError(f'{name}: {g}')
    emit({'phase': 'parallel_sp', 'run': name, **g})
  emit({'phase': 'parallel', 'worker_s': worker_s,
        'pipe_s': grid['pipe_wall_s'],
        'wall_s': time.perf_counter() - t0, 'runs': lines})
  return runs


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: no CUDA device; this script checks the '
                     'port on the card and has no CPU path')
  sys.path.insert(0, REPO)
  try:
    from svdd_tpu_torch import _build
  except ImportError as e:
    raise SystemExit(f'chip_smoke: the svdd_tpu_torch package is not '
                     f'beside this script ({e})')

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = nvidia_smi()
  build_s = _build.build()
  torch.cuda.synchronize()
  emit({'phase': 'device', 'nvidia_smi': smi,
        'torch': torch.__version__, 'cuda': torch.version.cuda,
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(), 'nvcc_build_s': build_s})

  sass = sass_counts()
  emit({'phase': 'sass', **sass})

  gen = torch.Generator('cuda').manual_seed(0)
  results = {}
  checks = kernel_checks()
  for name, fn in checks:
    for dtype in (torch.float32, torch.bfloat16):
      r = fn(dtype, gen)
      torch.cuda.synchronize()
      torch.cuda.empty_cache()
      dname = str(dtype).split('.')[-1]
      if 'bound_ms' not in r:
        r['bound_ms'], r['bound_by'] = bound(r['flops'], r['bytes'], dname)
      emit({'phase': 'kernel', 'kernel': name, 'dtype': dname, **r})
      results[(name, dname)] = r
  r = check_gumbel_candidates(gen)
  torch.cuda.synchronize()
  emit({'phase': 'kernel', 'kernel': 'gumbel_candidates',
        'dtype': 'float32', **r})
  results[('gumbel_candidates', 'float32')] = r

  r = check_cnn_layer_past_limit()
  torch.cuda.synchronize()
  emit({'phase': 'cnn_layer_past_limit', **r})

  # B1, B6 and B2 at the RNA task's shapes (L = 50)
  rna_kernels = {}
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for key, r in check_rna_kernels(dtype, gen).items():
      if 'bound_ms' not in r:
        r['bound_ms'], r['bound_by'] = bound(r['flops'], r['bytes'], dname)
      rna_kernels[(key, dname)] = r
      emit({'phase': 'kernel_rna', 'kernel': key, 'dtype': dname, **r})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
  r = check_rna_gumbel(gen)
  rna_kernels[('gumbel_candidates', 'float32')] = r
  emit({'phase': 'kernel_rna', 'kernel': 'gumbel_candidates',
        'dtype': 'float32', **r})

  # B3, B4, B5 and B8 at the analysis path's rows (phase 11)
  analysis_rows = {}
  for dtype in (torch.float32, torch.bfloat16):
    dname = str(dtype).split('.')[-1]
    for key, points in check_analysis_rows(dtype, gen).items():
      analysis_rows[(key, dname)] = points
      emit({'phase': 'kernel_analysis_rows', 'kernel': key, 'dtype': dname,
            'points': points})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

  # float32, then bf16 held against the f32 run's CPU results
  model_ref = grad_ref = None
  for _ in range(2):
    r, model_ref = check_models(model_ref)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'models', **r})

    r, grad_ref = check_model_grads(grad_ref)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'grads', **r})

  r = check_backbones()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'backbones', **r})

  r = check_head_dims()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'head_dims', **r})

  # every run of a main path, with the launch counts read around it
  runs = check_basenji()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'models', 'model': 'basenji', **runs})
  r = check_offgrid_enformer()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'models', 'model': 'enformer_1152', **r})
  runs['enformer_1152'] = {'launches': r['forward_launches']}
  runs['enformer_1152_grad'] = {'launches': r['grad_launches']}

  decodes = {}
  for algo in PATH_KERNELS:
    decodes[algo] = (run_decode(algo) if algo in GUIDED
                     else run_sample_eval(algo))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'decode', **decodes[algo]})
  decodes['svdd_mc_1152'] = run_decode(
      'svdd_mc', 'svdd_mc_1152', steps=OFFGRID_DECODE_STEPS,
      value_kwargs={'channels': OFFGRID_CHANNELS})
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'decode', **decodes['svdd_mc_1152']})
  for algo in GUIDED:
    decodes[f'{algo}_bf16'] = run_decode(algo, f'{algo}_bf16', bf16=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'decode', **decodes[f'{algo}_bf16']})
  decodes['svdd_mc_m_schedule_bf16'] = run_decode(
      'svdd_mc', 'svdd_mc_m_schedule_bf16', bf16=True,
      extra_argv=['--m_schedule', M_SCHEDULE])
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'decode', **decodes['svdd_mc_m_schedule_bf16']})
  for name in ORACLE_RUNS:
    decodes[name] = run_oracle_decode(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'decode', **decodes[name]})
  runs.update(decodes)

  train_runs, diffusion_ckpt = train_phase()
  runs.update(train_runs)
  runs.update(value_phase(diffusion_ckpt))

  for algo, bf16 in ([(a, False) for a in PATH_KERNELS]
                     + [(a, True) for a in GUIDED]):
    prof = profile_step(algo, bf16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'profile', **prof})
  for algo in RNA_PATH_KERNELS:
    if algo == 'dg':          # DPS's step
      continue
    prof = profile_step(algo, task='rna')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'profile', **prof})
  r = time_dit_forward()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'profile', 'algo': 'dit_forward', **r})
  train_profiles()
  runs.update(rna_phase())
  runs.update(a17_a11_phase(diffusion_ckpt))
  runs.update(backbones_phase(diffusion_ckpt))
  runs.update(a1_phase())
  runs.update(a15_phase([
      os.path.join(REPO, 'build', 'chip_smoke', run, decodes[run]['npz'])
      for run in GUIDED]))
  r = check_gumbel_row0(gen)
  torch.cuda.synchronize()
  emit({'phase': 'kernel_row0', 'kernel': 'gumbel_candidates', **r})
  results[('gumbel_candidates', 'float32')]['row0'] = {
      k: r[k] for k in ('shape', 'row0_timed', 'halves_bitwise', 'ms',
                        'plain_ms', 'median_ms', 'bound_ms', 'bound_by')
      if k in r}
  runs.update(parallel_phase(diffusion_ckpt))

  kernels = []
  for name in _build.KERNELS:
    f32 = results[(name, 'float32')]
    info = KERNEL_INFO[name]
    entry = {'name': name, 'route': 'cuda', 'source': info[0],
             'replaces': info[1],
             'launches': sum(d['launches'].get(name, 0)
                             for d in runs.values()),
             'max_abs_err': f32['max_abs_err'], 'ms': f32['ms'],
             'plain_ms': f32['plain_ms'], 'bound_ms': f32['bound_ms'],
             'bound_by': f32['bound_by'],
             'library_ms': f32.get('library_ms')}
    if len(info) > 2:
      entry['also_computes'] = info[2]
    lib = os.path.basename(info[0])[:-len('.cu')]
    if lib in sass:
      entry['sass'] = sass[lib]
    entry['launches_by_run'] = {a: d['launches'].get(name, 0)
                                for a, d in runs.items()}
    entry.update({k: f32[k] for k in ('chi2_min_p', 'max_freq_dev', 'row0',
                                      'mask_flips', 'mask_bitwise',
                                      'library', 'max_abs_err_by_length',
                                      'median_ms',
                                      'max_abs_err_points', 'off_gate',
                                      'achieved_tb_s', 'classifier_pools',
                                      'classifier_n512', 'plain_median_ms',
                                      'library_median_ms', 'n5120',
                                      'train_rows', 'multisep_rows',
                                      'spread')
                  if k in f32})
    bf = results.get((name, 'bfloat16'))
    if bf is not None:
      entry.update(max_abs_err_bf16=bf['max_abs_err'], ms_bf16=bf['ms'],
                   plain_ms_bf16=bf['plain_ms'],
                   bound_ms_bf16=bf['bound_ms'])
      if bf.get('library_ms') is not None:
        entry['library_ms_bf16'] = bf['library_ms']
      for k in ('median_ms', 'achieved_tb_s', 'classifier_pools',
                'classifier_n512', 'max_abs_err_points', 'n5120',
                'train_rows', 'multisep_rows', 'spread'):
        if k in bf:
          entry[f'{k}_bf16'] = bf[k]
    if 'tflops' in f32:
      entry.update({k: f32[k] for k in ('peak', 'tflops', 'bound_share',
                                        'fma_bound_ms', 'fma_bound_share')})
      entry.update(tflops_bf16=bf['tflops'], bound_share_bf16=bf['bound_share'])
    rna = {k: {dt: rna_kernels[(k, dt)] for dt in ('float32', 'bfloat16')
               if (k, dt) in rna_kernels}
           for k, _ in rna_kernels if k == name or k.startswith(f'{name}_n')}
    if rna:
      entry['rna'] = {
          k: {dt: {f: r[f] for f in ('shape', 'max_abs_err', 'ms',
                                     'plain_ms', 'library_ms', 'bound_ms',
                                     'bound_by', 'tflops', 'bound_share',
                                     'rounds_as_reference')
                   if f in r} for dt, r in by_dt.items()}
          for k, by_dt in rna.items()}
    for dt, key in (('float32', 'analysis_rows'),
                    ('bfloat16', 'analysis_rows_bf16')):
      if (name, dt) in analysis_rows:
        entry[key] = analysis_rows[(name, dt)]
    for suffix, key in (('d128', 'head_dim_128'), ('l200', 'length_200')):
      more = {dt: results.get((f'{name}_{suffix}', dt))
              for dt in ('float32', 'bfloat16')}
      if more['float32'] is not None:
        entry[key] = {
            dt: {k: r[k] for k in ('shape', 'rounding', 'max_abs_err',
                                   'mean_abs_err',
                                   'mean_abs_err_other_rounding', 'ms',
                                   'plain_ms', 'library_ms', 'bound_ms',
                                   'tflops', 'bound_share', 'fma_bound_share')
                 if k in r}
            for dt, r in more.items()}
    kernels.append(entry)
  emit({'phase': 'profiler_misses', 'count': len(PROFILER_MISSES),
        'misses': PROFILER_MISSES})
  emit({'kernels': kernels})
  print(smi, flush=True)
  emit({'ok': True, 'device': {'platform': 'gpu',
                               'kind': torch.cuda.get_device_name(0),
                               'count': torch.cuda.device_count()}})


if __name__ == '__main__':
  if sys.argv[1:2] == ['--parallel-worker']:
    parallel_worker(*sys.argv[2:5])
  else:
    main()
