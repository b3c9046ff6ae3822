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
     L = 200), in float32 and bfloat16, against its plain PyTorch
     version on the same inputs (the candidate draw on the noise the
     kernel reports, and by frequencies; the cnn layer's backward on the
     relu mask the kernel reports; B14's and B5's wrappers on shapes off
     their gates, which must take the plain version bit for bit; B3, B4
     and B8 also at short points, N = 6 and 8, B4 at the classifier's
     seven N = 512 pools, B5 at its N = 512), with the times of both, the
     time of one PyTorch call computing the same function where there is
     one, and the least time the card could take for the work; times are
     the card's own for a call (the profiler), CUDA-event medians beside
     them, but B12's and the plain and library times of the multi-ms
     B3, B4, B7 and B14, which are CUDA-event medians;
  3. the full-width denoiser and Enformer value net on a few rows, the
     kernel path on the card against the plain path on the CPU: their
     outputs, then the input gradients the guided decoders take, then
     the full-width DiT, AR and DiMamba backbones' outputs, then the DiT
     at head dims 128 (the kernel) and 16 (the plain attention); then the
     models of the Basenji and off-grid paths at 512 rows, L=200, with
     launch counts: the Basenji trunk at its published defaults and on
     the 128-lane grid (SVDD_PALLAS_FUSED_CONV unset and set), and an
     Enformer value net with channels=1152 (stem width 576, off the
     grid) forward and input gradient;
  4. the decodes, each through its CLI's ``run`` with every kernel's
     launch count read around it: SVDD-MC (M=10), DPS and classifier
     guidance at --task dna, B=512, L=200, 128 steps; ``main_gosai
     --mode sample_eval`` for the text preset's DiT (64 rows, L=1024,
     ddpm_cache, 128 steps, scored by the AR backbone) and DiMamba
     (--task dna, 512 rows, 128 steps); all full-width random-weight
     models; and SVDD-MC for 8 steps with the channels=1152 value net;
  5. one step of each decode under torch.profiler: host ms per step,
     the card's busy ms and idle share, and kernel ms by kind; and one
     DiT forward at the text preset's 512 rows;
then the kernels line (launches summed over the runs of phases 3 and 4),
the card's ``nvidia-smi`` name and power limit, and a last line
{"ok": true, "device": {...}}.

Float32 phases run with TF32 off for matmuls and cuDNN convolutions.
It imports nothing of JAX.
"""

from __future__ import annotations

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
    'text_mdlm': ('flash_attention', 'flash_attention_causal'),
    'dimamba': ('rmsnorm',),
}
GUIDED = ('svdd_mc', 'dps', 'classifier')
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
  would time the host."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  return sum((e.time_range.end - e.time_range.start) / 1e3
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (fragment is None or fragment in e.name)) / reps


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
# B1 and B6 are also held at N = 8 at a short sequence and at the longest
# one a block holds (ops/cnn_layer.kernel_takes)
CNN_SMALL_N, CNN_SHORT_L = 8, 50


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


def _cnn_lengths(dtype, gen, bwd: bool) -> dict:
  """Max abs error against the plain version at N = 8, L = 50 and the
  longest L, all four dilations (B6 with the mask checks)."""
  from svdd_tpu_torch.ops import cnn_layer as K
  name = str(dtype).split('.')[-1]
  res = {}
  for l in (CNN_SHORT_L, cnn_longest(dtype)):
    args, ct = _cnn_inputs(CNN_SMALL_N, l, dtype, gen)
    errs = []
    for d in (1, 4, 16, 64):
      label = f'{"cnn_layer_bwd" if bwd else "cnn_layer"} L={l} d={d}'
      if bwd:
        errs.append(_cnn_bwd_against_plain(args, ct, d, name, label)[0])
      else:
        errs.append(compare(label, K.cnn_layer(*args, dilation=d),
                            K.cnn_layer_plain(*args, dilation=d), name)[0])
    res[str(l)] = max(errs)
  return res


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
  L a block holds. ms, plain_ms and library_ms are one denoiser forward,
  the 20 layers, each layer's the card's time for a call (device_ms,
  every kernel the call launched); flops count the rows the live taps
  need (cnn_rows)."""
  import torch.nn.functional as F
  from svdd_tpu_torch.ops import cnn_layer as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  n, l, c = CNN_SHAPE
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
  r['max_abs_err_by_length'] = _cnn_lengths(dtype, gen, bwd=False)
  return _cnn_rates(r, name)


def check_gumbel_candidates(gen):
  """B2 at (512, 200, 5), M=10: every draw equal to the plain version's
  on the noise the kernel used, frequencies vs softmax(log_q) by
  chi-square over 8 distinct rows, unmasked tokens copied exactly."""
  import numpy as np
  import torch
  from scipy import stats as sps
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

  def plain():
    noise = gumbel_noise((b, m, l, v), gen, 'cuda')
    return K.gumbel_candidates_plain(log_q, x, noise, mask)
  return {'shape': [b, m, l, v], 'max_abs_err': err,
          'chi2_min_p': worst_p, 'max_freq_dev': max_dev,
          **timed(lambda: K.gumbel_candidates(log_q, x, m, mask, gen), plain),
          # one add and compare per candidate lane; log_q and x in, the
          # candidates out
          'flops': b * m * l * v,
          'bytes': b * l * v * 4 + b * l * 4 + b * m * l * 4}


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


def _pool_points(dtype, im2col: bool) -> dict:
  """POOL_POINTS through the wrapper on the card, each one launch,
  against the plain version: {label: max abs err}."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  gen = torch.Generator('cuda').manual_seed(8)
  counter = 'attn_pool_prologue_im2col' if im2col else 'attn_pool'
  points = {}
  for n, l, c, residual in POOL_POINTS:
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
    points[label] = compare(f'{counter} {label}', got, want, name)[0]
  return points


def check_attn_pool_im2col(dtype, gen):
  """B3 at the six fused pools of one value forward (B*M = 5120), each
  against the plain version and timed by the card's own time for a call
  (device_ms, the profiler: the kernel and the wrapper's transpose of W)
  and by CUDA events (median_ms); then at POOL_POINTS. ms is the six
  pools, device time; achieved_tb_s the bytes they must move over it."""
  import torch
  from svdd_tpu_torch.ops import attn_pool as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  errs, per_pool, flops, nbytes = [], [], 0, 0
  for l, c in POOL_SHAPES:
    args = _pool_args(l, c, dtype, gen)
    lh = (l + 1) // 2
    flops += 2 * N_CAND * lh * c * c
    nbytes += _pool_bytes(N_CAND, l, c, args[0].element_size(),
                          len(live_offsets(5, lh)))
    got = K.pool_prologue_im2col_wlogits(*args)
    want = K.pool_prologue_im2col_wlogits_plain(*args)
    errs.append(compare(f'attn_pool_prologue_im2col L={l} C={c}', got,
                        want, name))
    del got, want
    call = lambda: K.pool_prologue_im2col_wlogits(*args)
    per_pool.append({
        'shape': [N_CAND, l, c], 'ms': device_ms(call, reps=5),
        'median_ms': median_ms(call, iters=3),
        'plain_ms': median_ms(
            lambda: K.pool_prologue_im2col_wlogits_plain(*args), iters=3)})
    del args
    torch.cuda.empty_cache()
  total = lambda k: sum(p[k] for p in per_pool)
  r = {'shapes': [p['shape'] for p in per_pool],
       'max_abs_err': max(e[0] for e in errs),
       'max_rel_err': max(e[1] for e in errs),
       'max_abs_err_points': _pool_points(dtype, True),
       'ms': total('ms'),
       'median_ms': total('median_ms'), 'plain_ms': total('plain_ms'),
       'library_ms': None, 'per_pool': per_pool, 'flops': flops,
       'bytes': nbytes, 'achieved_tb_s': nbytes / total('ms') / 1e9}
  return _cnn_rates(r, name)


def _attn_pool_at(n, shapes, dtype, gen):
  """B4 with its residual at each (L, C) of shapes at N = n, against the
  plain version: errors, and ms (device), median_ms, plain_ms, flops and
  bytes summed over the shapes."""
  import torch
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  errs, r = [], {'ms': 0.0, 'median_ms': 0.0, 'plain_ms': 0.0, 'flops': 0,
                 'bytes': 0}
  for l, c in shapes:
    x, res, w = _pool_inputs(l, c, dtype, gen, n)
    errs.append(compare(f'attn_pool N={n} L={l} C={c}', K.attn_pool(x, w, res),
                        K.attn_pool_plain(x, w, res), name))
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
  tower at N = 512 (classifier_pools), and at POOL_POINTS."""
  name = str(dtype).split('.')[-1]
  r = _attn_pool_at(N_CAND, [LAST_POOL], dtype, gen)
  r.update(shape=[N_CAND, *LAST_POOL], library_ms=None,
           max_abs_err_points=_pool_points(dtype, False))
  r = _cnn_rates(r, name)
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


def _attn_l2_at(n, dtype, gen):
  """B5 at (n, 2, 8 heads x (64 | 192)) against the plain version, timed
  (one of the 11 calls of a value forward)."""
  import torch
  from svdd_tpu_torch.ops import attn_l2 as K
  name = str(dtype).split('.')[-1]
  h, dk, dv = ATTN_L2_HEADS
  args = _attn_l2_args(n, h, dk, dv, dtype, gen)
  out, w = K.attn_l2(*args)
  out_p, w_p = K.attn_l2_plain(*args)
  errs = (compare('attn_l2 out', out, out_p, name),
          compare('attn_l2 w', w, w_p, 'float32'
                  if dtype == torch.float32 else name))
  es = args[0].element_size()
  return {'shape': [n, 2, h * dk, h * dv],
          'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          # per query: two logit terms per dk lane, a blend per dv lane
          'flops': n * 2 * h * (6 * dk + 3 * dv),
          # q, k, v read once, the bias rows once, out and w written once
          'bytes': (n * 2 * h * (2 * dk + 2 * dv) + 5 * h * dk) * es
                   + n * 2 * h * 4,
          **timed(lambda: K.attn_l2(*args), lambda: K.attn_l2_plain(*args),
                  reps=20, iters=20)}


def check_attn_l2(dtype, gen):
  """B5 at SVDD-MC's N = B*M = 5120, then at the classifier's N = 512
  (classifier_n512), each timed by the card's own time for a call; then
  at ATTN_L2_POINTS (one launch each)."""
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
  r['max_abs_err_points'] = {}
  for point in ATTN_L2_POINTS:
    args = _attn_l2_args(*point, dtype, gen)
    before = _build.LAUNCHES['attn_l2']
    got, want = K.attn_l2(*args), K.attn_l2_plain(*args)
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
  the longest L a block holds. ms is one backward of the 20 layers, each
  layer's the card's time for a call (device_ms)."""
  import torch
  from svdd_tpu_torch.ops import cnn_layer as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  n, l, c = CNN_SHAPE
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
       'flops': flops, 'bytes': nbytes}
  r['max_abs_err_by_length'] = _cnn_lengths(dtype, gen, bwd=True)
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


def check_conv1d_bwd(dtype, gen):
  """B7 at the six k=5 tower convs at N = 512, against the plain version,
  each timed by the card's own time for a call (device_ms, the profiler:
  the kernels and the wrapper's copies) and by CUDA events around it
  (median_ms), beside aten.convolution_backward (dgrad and wgrad in one
  call; TF32 off in f32); then at CONV_BWD_POINTS. ms is the six convs of
  one value-net backward, device time; flops count the live rows
  (live_rows)."""
  import torch
  from svdd_tpu_torch.ops import conv1d as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  n = N_GRAD
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
  points = {}
  for n_, l, cin, cout, d in CONV_BWD_POINTS:
    x, w, ct = _conv_bwd_inputs(n_, l, cin, cout, dtype, gen)
    label = f'conv1d_bwd N={n_} L={l} {cin}->{cout} d={d}'
    dx_err, dw_err = _conv_bwd_against_plain(x, w, ct, d, name, label)
    points[label] = {'dx': dx_err[0], 'dkernel': dw_err[0]}
  total = lambda k: sum(c[k] for c in per_conv)
  r = {'shapes': [c['shape'] for c in per_conv],
       'max_abs_err': max(e[0] for e in errs),
       'max_rel_err': max(e[1] for e in errs),
       'max_abs_err_points': points,
       # the six tower convs of one value-net backward
       'ms': total('ms'),
       'median_ms': total('median_ms'), 'plain_ms': total('plain_ms'),
       'library_ms': total('library_ms'),
       'library': 'torch.ops.aten.convolution_backward',
       'per_conv': per_conv, 'flops': flops, 'bytes': nbytes}
  return _cnn_rates(r, name)


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


def check_attn_pool_bwd(dtype, gen):
  """B8 at the seven tower pools with their residuals (odd lengths 25,
  13 and 7 among them), against the plain version, each timed by the
  card's own time for a call (device_ms) and by CUDA events (median_ms);
  ms is the seven pools of one value-net backward, device time. Then at
  POOL_BWD_POINTS."""
  import torch
  from svdd_tpu_torch.ops import attn_pool as K
  name = str(dtype).split('.')[-1]
  n = N_GRAD
  errs, per_pool, flops, nbytes = [], [], 0, 0
  for l, c in TOWER_POOLS:
    lh = (l + 1) // 2
    x, w, ct, res = _pool_bwd_inputs(n, l, c, dtype, gen)
    errs += _pool_bwd_against_plain((x, w, ct, res), name,
                                    f'attn_pool_bwd L={l} C={c}')
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
       # the seven pools of one value-net backward
       'ms': total('ms'),
       'median_ms': total('median_ms'), 'plain_ms': total('plain_ms'),
       'plain_median_ms': total('plain_median_ms'), 'library_ms': None,
       'per_pool': per_pool, 'flops': flops, 'bytes': nbytes,
       'max_abs_err_points': _pool_bwd_points(dtype)}
  return _cnn_rates(r, name)


# B12 at the text preset's DiT and AR shapes: the 64-row decode batch,
# L=1024, 12 heads of 64; B13 at DiMamba's 512 x 200 rows of 256
ATTN_SHAPE = (64, 1024, 12, 64)
RMS_SHAPE = (512 * 200, 256)


def check_flash_attention(dtype, gen, causal: bool, shape=ATTN_SHAPE):
  """B12 on q, k, v sliced from one (B, L, 3, H, D) projection, as the
  backbones pass them (the kernel reads them by stride), against the
  plain version and timed beside F.scaled_dot_product_attention on
  contiguous (B, H, L, D) copies. The flops count the causal half. The
  float32 kernel runs its products as 3xTF32, so its bound is the work
  at 495/3 TFLOP/s; the FMA bound (67 TFLOP/s) is reported beside it.
  Achieved TFLOP/s and the share of each bound are in the result."""
  import torch
  import torch.nn.functional as F
  from svdd_tpu_torch.ops import flash_attention as K
  from svdd_tpu_torch.ops.attention import mha
  name = str(dtype).split('.')[-1]
  b, l, h, d = shape
  qkv = torch.randn(b, l, 3, h, d, device='cuda', generator=gen).to(dtype)
  q, k, v = qkv.unbind(2)
  err, rel = compare(f'flash_attention causal={causal}',
                     K.flash_attention(q, k, v, causal),
                     mha(q, k, v, causal), name)
  ms = median_ms(lambda: K.flash_attention(q, k, v, causal), iters=10)
  plain_ms = median_ms(lambda: mha(q, k, v, causal), iters=3)
  qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
  lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
      qt, kt, vt, is_causal=causal), iters=10)
  # the q.k and p.v products; q, k, v in, out written
  flops = 4 * b * h * l * l * d // (2 if causal else 1)
  nbytes = 4 * b * h * l * d * qkv.element_size()
  peak = 'tf32x3' if name == 'float32' else name
  bound_ms, bound_by = bound(flops, nbytes, peak)
  r = {'shape': list(shape), 'causal': causal,
       'max_abs_err': err, 'max_rel_err': rel, 'ms': ms,
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
  F.rms_norm (which rounds only once, so it is a yardstick of time)."""
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
  return {'shape': list(RMS_SHAPE), 'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          **timed(lambda: K.fused_add_rmsnorm(x, None, s),
                  lambda: K.rmsnorm_plain(x, None, s),
                  lambda: F.rms_norm(x, (d,), s, 1e-5), reps=20, iters=20),
          'library': 'torch.nn.functional.rms_norm',
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


def check_nacdr_im2col(dtype, gen):
  """B11c at the four widths, against the plain version; ms is one call
  at each width."""
  import torch
  from svdd_tpu_torch.ops import im2col as K
  from svdd_tpu_torch.ops.kernel_utils import live_offsets
  name = str(dtype).split('.')[-1]
  n, l = IM2COL_ROWS, IM2COL_L
  k_live = len(live_offsets(5, l))
  errs, per_width, flops, nbytes = [], {}, 0, 0
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
    del x
    torch.cuda.empty_cache()
  total = lambda k: sum(p[k] for p in per_width.values())
  return {'shapes': [[n, l, c] for c in IM2COL_WIDTHS], 'k': 5,
          'act': 'gelu', 'max_abs_err': max(e[0] for e in errs),
          'max_rel_err': max(e[1] for e in errs),
          **{k: total(k) for k in ('ms', 'median_ms', 'plain_ms',
                                   'plain_median_ms')},
          'per_width': per_width, 'library_ms': None, 'flops': flops,
          'bytes': nbytes}


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


def check_models(gen_seed: int = 0):
  """The full-width denoiser (8 rows) and value net (4 candidates) on the
  card through the kernels, against the plain path on the CPU with the
  same weights. Whole models sum in other orders on each side: 1e-3."""
  import torch
  from svdd_tpu_torch import mdlm
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  cfg = dna_config()
  den = Diffusion(cfg, device='cuda')
  val = EnformerValueModel(
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
  if not finite.all():
    raise AssertionError('denoiser: non-finite log-probs')
  tol = dict(rtol=1e-3, atol=1e-3)
  if not torch.allclose(lp_gpu, lp_cpu, **tol):
    raise AssertionError(f'denoiser card vs cpu: max abs err '
                         f'{float((lp_gpu - lp_cpu).abs().max())}')
  if not torch.allclose(v_gpu, v_cpu, rtol=1e-3,
                        atol=1e-3 * float(v_cpu.abs().max())):
    raise AssertionError(f'value net card vs cpu: {v_gpu} vs {v_cpu}')
  return {'denoiser_max_abs_err': float((lp_gpu - lp_cpu).abs().max()),
          'value_gpu': v_gpu.tolist(), 'value_cpu': v_cpu.tolist()}


def check_model_grads():
  """The input gradients the guided decoders take, on 8 rows of the
  full-width models: the value net's through its differentiable tower
  (classifier guidance) and the DPS gradient of a fixed linear reward
  through the denoiser's one-hot path, the kernels on the card against
  the plain path on the CPU with the same weights. Whole backward passes
  sum in other orders on each side: 1e-3 of the largest gradient."""
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.config import dna_config
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.models.enformer import EnformerValueModel
  from svdd_tpu_torch.sampling import guidance
  cfg = dna_config()
  den = Diffusion(cfg, device='cuda')
  val = EnformerValueModel(
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
  out = {}
  for name, got, want in (('value_grad', gv_gpu, gv_cpu),
                          ('dps_grad', gd_gpu, gd_cpu)):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if scale == 0 or not torch.isfinite(got).all() or not torch.allclose(
        got, want, rtol=1e-3, atol=1e-3 * scale):
      raise AssertionError(f'{name} card vs cpu: max abs err {err}, '
                           f'max |cpu| {scale}')
    out[f'{name}_max_abs_err'] = err
    out[f'{name}_max_abs'] = scale
  out['launches'] = {k: launches[k] for k in sorted(need)}
  return out


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


DECODE_STEPS = 128
# the SVDD-MC decode with the off-grid value net: B11b inside the loop at
# N = B*M = 5120
OFFGRID_DECODE_STEPS = 8


def run_decode(algo: str, run_name: str | None = None,
               steps: int = DECODE_STEPS, value_kwargs=None):
  """One decode through its CLI's ``run``: B=512, 128 steps (or
  ``steps``), L=200, float32, --skip_best_of_n, the value net of
  ``value_kwargs`` (EnformerValueModel arguments) where given; the launch
  counts are set to 0 just before and read just after, and every kernel
  of the path (``run_name``'s) must have run."""
  run_name = run_name or algo
  import numpy as np
  import torch
  from svdd_tpu_torch import _build
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.cli import decode as cli_decode
  from svdd_tpu_torch.cli import decode_classfier, decode_DPS
  run, parser, suffix = {
      'svdd_mc': (cli_decode.run, common.make_parser('chip smoke'), ''),
      'dps': (decode_DPS.run, decode_DPS.parser(), decode_DPS.NPZ_SUFFIX),
      'classifier': (decode_classfier.run, decode_classfier.parser(),
                     decode_classfier.NPZ_SUFFIX),
  }[algo]
  out_dir = os.path.join(REPO, 'build', 'chip_smoke', run_name)
  argv = ['--task', 'dna', '--batch_size', '512', '--skip_best_of_n',
          '--device', 'cuda', '--num_steps', str(steps),
          '--out_dir', out_dir, '--run_name', f'chip_smoke_{run_name}']
  if algo == 'svdd_mc':
    argv += ['--sample_M', '10']
  args = parser.parse_args(argv)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _build.reset_launches()
  t0 = time.perf_counter()
  report = (run(args, value_kwargs=value_kwargs) if value_kwargs
            else run(args))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _build.launches()
  need = {**PATH_KERNELS, **OFFGRID_KERNELS}[run_name]
  missing = [k for k in need if launches[k] == 0]
  if missing:
    raise AssertionError(f'{run_name} decode never launched {missing}')
  d = np.load(common.npz_path(args, suffix))
  if set(d.files) != {'decoding', 'baseline'}:
    raise AssertionError(f'npz keys {d.files}')
  for key in d.files:
    if d[key].shape != (512,) or not np.isfinite(d[key]).all():
      raise AssertionError(f'npz {key}: shape {d[key].shape} or '
                           'non-finite values')
  out = {'algo': algo, 'run': run_name, 'task': 'dna', 'batch_size': 512,
         'length': 200, 'steps': steps,
         'value_net': value_kwargs or 'EnformerValueModel defaults',
         'npz': os.path.basename(common.npz_path(args, suffix))}
  if algo == 'svdd_mc':
    out['sample_M'] = 10
  else:
    out['guidance_scale'] = args.guidance_scale
  out.update({'wall_s': wall,
              'peak_mem_gb': torch.cuda.max_memory_allocated() / 2 ** 30,
              'guided_reward_mean': report['decoding']['mean'],
              'baseline_reward_mean': report['baseline']['mean'],
              'launches': launches, 'npz_keys': sorted(d.files)})
  return out


SAMPLE_EVAL = {
    # which: (rows, steps, --gen_ppl_model)
    'text_mdlm': (64, 128, 'ar'),
    'dimamba': (512, 128, None),
}


def run_sample_eval(which: str):
  """One ``main_gosai --mode sample_eval`` run through its ``run`` at
  full width (``sample_eval_backbone``), one batch, 128 steps; the text
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
          os.path.join(REPO, 'build', 'chip_smoke', 'no_checkpoint')]
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
         ('gemm', 'gemm'), ('fprop', 'conv'), ('dgrad', 'conv'),
         ('wgrad', 'conv'), ('conv', 'conv'),
         ('memcpy', 'memcpy_memset'), ('memset', 'memcpy_memset'))


def _kind(name: str) -> str:
  low = name.lower()
  return next((k for frag, k in KINDS if frag in low), 'other')


def profile_step(algo: str):
  """One step of a decode at its shapes (B=512, L=200, M=10 for SVDD-MC,
  the same models; 64 rows at L=1024 for the text preset's ddpm_cache
  step, which runs its forward from an empty cache; 512 rows at L=200
  for DiMamba's ddpm step) under torch.profiler, from the all-MASK prior
  at t=0.5. host_step_ms: mean host time of 3 synchronised steps after a
  warm-up, unprofiled. device_busy_ms: the union of the card's kernel
  and copy intervals in the profiled step; idle_share = 1 -
  device_busy_ms / profiled_step_ms (host time of the profiled step, to
  its synchronize). by_kind_ms: summed kernel time by kind ('other' is
  PyTorch's elementwise and reduction glue, 'conv' and 'gemm' the
  library's convolutions and matrix products)."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  from svdd_tpu_torch import mdlm
  from svdd_tpu_torch.cli import common
  from svdd_tpu_torch.diffusion import Diffusion
  from svdd_tpu_torch.sampling import guidance, sampler
  mode = torch.inference_mode if algo == 'svdd_mc' else torch.no_grad
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
        ['--task', 'dna', '--batch_size', '512', '--sample_M', '10',
         '--device', 'cuda'])
    cfg = common.task_config(args)
    batch = args.batch_size
    diffusion = common.load_diffusion(args, cfg)
    if algo == 'svdd_mc':
      vf = common.load_value_function(args, cfg)
      step = guidance.svdd_mc_step(diffusion.forward, vf.score_tokens,
                                   diffusion.schedule, cfg.mask_index,
                                   repeats=args.sample_M)
    elif algo == 'dps':
      step = guidance.dps_step(diffusion.forward_onehot,
                               common.load_reward_fn(args, cfg),
                               diffusion.schedule, cfg.mask_index,
                               guidance_scale=1e5)
    else:
      vf = common.load_value_function(args, cfg)
      step = guidance.classifier_step(diffusion.forward, vf.as_onehot_fn(),
                                      diffusion.schedule, cfg.mask_index)
  gen = torch.Generator('cuda').manual_seed(0)
  x = mdlm.sample_prior((batch, cfg.model.length), cfg.mask_index, 'cuda')
  t, t_next = torch.tensor(0.5), torch.tensor(0.49)

  def once():
    with mode():
      step(x, t, t_next, gen)
    torch.cuda.synchronize()

  once()
  t0 = time.perf_counter()
  for _ in range(3):
    once()
  host_ms = (time.perf_counter() - t0) / 3 * 1e3
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    once()
    prof_ms = (time.perf_counter() - t0) * 1e3
  dev = [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA]
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
  return {'algo': algo, 'batch_size': batch,
          'length': cfg.model.length, 'host_step_ms': host_ms,
          'profiled_step_ms': prof_ms, 'device_events': len(dev),
          'device_busy_ms': busy_ms,
          'idle_share': 1 - busy_ms / prof_ms if dev else None,
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
  r['bound_ms'], r['bound_by'] = bound(r['flops'], r['bytes'])
  emit({'phase': 'kernel', 'kernel': 'gumbel_candidates',
        'dtype': 'float32', **r})
  results[('gumbel_candidates', 'float32')] = r

  r = check_cnn_layer_past_limit()
  torch.cuda.synchronize()
  emit({'phase': 'cnn_layer_past_limit', **r})

  r = check_models()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'models', **r})

  r = check_model_grads()
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
  runs.update(decodes)

  for algo in PATH_KERNELS:
    prof = profile_step(algo)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({'phase': 'profile', **prof})
  r = time_dit_forward()
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  emit({'phase': 'profile', 'algo': 'dit_forward', **r})

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
    entry.update({k: f32[k] for k in ('chi2_min_p', 'max_freq_dev',
                                      'mask_flips', 'mask_bitwise',
                                      'library', 'max_abs_err_by_length',
                                      'median_ms',
                                      'max_abs_err_points', 'off_gate',
                                      'achieved_tb_s', 'classifier_pools',
                                      'classifier_n512', 'plain_median_ms',
                                      'library_median_ms')
                  if k in f32})
    bf = results.get((name, 'bfloat16'))
    if bf is not None:
      entry.update(max_abs_err_bf16=bf['max_abs_err'], ms_bf16=bf['ms'],
                   plain_ms_bf16=bf['plain_ms'],
                   bound_ms_bf16=bf['bound_ms'])
      if bf.get('library_ms') is not None:
        entry['library_ms_bf16'] = bf['library_ms']
      for k in ('median_ms', 'achieved_tb_s', 'classifier_pools',
                'classifier_n512', 'max_abs_err_points'):
        if k in bf:
          entry[f'{k}_bf16'] = bf[k]
    if 'tflops' in f32:
      entry.update({k: f32[k] for k in ('peak', 'tflops', 'bound_share',
                                        'fma_bound_ms', 'fma_bound_share')})
      entry.update(tflops_bf16=bf['tflops'], bound_share_bf16=bf['bound_share'])
    for suffix, key in (('d128', 'head_dim_128'), ('l200', 'length_200')):
      more = {dt: results.get((f'{name}_{suffix}', dt))
              for dt in ('float32', 'bfloat16')}
      if more['float32'] is not None:
        entry[key] = {
            dt: {k: r[k] for k in ('shape', 'max_abs_err', 'ms', 'plain_ms',
                                   'library_ms', 'bound_ms', 'tflops',
                                   'bound_share', 'fma_bound_share')
                 if k in r}
            for dt, r in more.items()}
    kernels.append(entry)
  emit({'kernels': kernels})
  print(smi, flush=True)
  emit({'ok': True, 'device': {'platform': 'gpu',
                               'kind': torch.cuda.get_device_name(0),
                               'count': torch.cuda.device_count()}})


if __name__ == '__main__':
  main()
