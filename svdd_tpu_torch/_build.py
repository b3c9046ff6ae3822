"""Build the CUDA kernels under ``csrc/`` at first use and bind them.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface under
``build/svdd_tpu_torch/`` at the repository root, loaded with ctypes.
The library's file name carries a hash of its sources, so an edited
kernel is rebuilt and a current one is reused. Every C entry point
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code.

``LAUNCHES`` counts, per kernel, the launches the wrappers in ``ops/``
made; a run resets it with ``reset_launches()`` and reads it after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'svdd_tpu_torch'
SOURCES = ('cnn_layer', 'gumbel_candidates', 'attn_pool', 'attn_l2',
           'cnn_layer_bwd', 'conv1d_bwd', 'attn_pool_bwd')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (library, argtypes). Pointers and the stream
# are c_void_p so ctypes never truncates them to 32 bits.
SIGNATURES = {
    'svdd_cnn_layer': ('cnn_layer', [_P] * 8 + [_I] * 4 + [_F, _I, _P]),
    'svdd_gumbel_candidates': ('gumbel_candidates',
                               [_P] * 5 + [_I] * 5 + [_P]),
    'svdd_attn_pool': ('attn_pool', [_P] * 4 + [_I] * 4 + [_P]),
    'svdd_attn_pool_im2col': ('attn_pool',
                              [_P] * 7 + [_I] * 6 + [_P]),
    'svdd_attn_l2': ('attn_l2', [_P] * 8 + [_I] * 5 + [_P]),
    'svdd_cnn_layer_bwd': ('cnn_layer_bwd',
                           [_P] * 18 + [_I] * 5 + [_F, _I, _P]),
    'svdd_conv1d_bwd': ('conv1d_bwd', [_P] * 7 + [_I] * 7 + [_P]),
    'svdd_attn_pool_bwd': ('attn_pool_bwd', [_P] * 9 + [_I] * 5 + [_P]),
}
KERNELS = ('cnn_layer', 'gumbel_candidates', 'attn_pool_prologue_im2col',
           'attn_pool', 'attn_l2', 'cnn_layer_bwd', 'conv1d_bwd',
           'attn_pool_bwd')
LAUNCHES = {k: 0 for k in KERNELS}

_LIBS: dict = {}


def reset_launches() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


def launches() -> dict:
  return dict(LAUNCHES)


def nvcc_path() -> str:
  path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit')
  return path


def _library_path(name: str) -> Path:
  h = hashlib.sha1()
  for src in (SRC_DIR / f'{name}.cu', *sorted(SRC_DIR.glob('*.cuh'))):
    h.update(src.read_bytes())
  h.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'lib{name}-{h.hexdigest()[:12]}.so'


def build(names=SOURCES) -> float:
  """Compile the named sources that have no current library, one nvcc
  per source, all started together. Returns the wall seconds."""
  t0 = time.perf_counter()
  todo = [n for n in names if not _library_path(n).exists()]
  if not todo:
    return 0.0
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = nvcc_path()
  procs = []
  for name in todo:
    out = _library_path(name)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc, *NVCC_FLAGS, '-I', str(SRC_DIR), '-o', str(tmp),
           str(SRC_DIR / f'{name}.cu')]
    procs.append((name, out, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)))
  errors = []
  for name, out, tmp, proc in procs:
    log, _ = proc.communicate()
    if proc.returncode:
      errors.append(f'{name}.cu (nvcc rc {proc.returncode}):\n{log}')
    else:
      os.replace(tmp, out)
  if errors:
    raise RuntimeError('kernel build failed:\n' + '\n'.join(errors))
  return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
  if name not in _LIBS:
    # the first use builds every source, all nvcc runs at once, so a
    # path's later kernels do not each wait for a build of their own
    build()
    lib = ctypes.CDLL(str(_library_path(name)))
    lib.svdd_error_string.argtypes = [_I]
    lib.svdd_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
  return _LIBS[name]


def entry(fn_name: str):
  """The bound C entry point ``fn_name`` (building its library first)."""
  lib_name, argtypes = SIGNATURES[fn_name]
  lib = _lib(lib_name)
  fn = getattr(lib, fn_name)
  fn.argtypes = argtypes
  fn.restype = ctypes.c_int
  return fn


def check(rc: int, fn_name: str) -> None:
  if rc:
    lib = _lib(SIGNATURES[fn_name][0])
    msg = lib.svdd_error_string(rc).decode()
    raise RuntimeError(f'{fn_name}: CUDA error {rc} ({msg})')


def stream_ptr(t) -> int:
  import torch
  return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
  """0 = float32, 1 = bfloat16; the kernels take no other type."""
  import torch
  if t.dtype == torch.float32:
    return 0
  if t.dtype == torch.bfloat16:
    return 1
  raise TypeError(f'kernel takes float32 or bfloat16, got {t.dtype}')


def int_array(values) -> ctypes.Array:
  """A host int32 array for the kernels' tap-offset arguments."""
  return (ctypes.c_int * max(len(values), 1))(*values)


def row_chunks(rows: int, tiles: int, min_rows: int = 256) -> int:
  """Chunks of rows a weight-gradient GEMM splits its sum over rows
  into, each chunk a block per output tile: enough blocks to fill the
  card's 132 SMs about twice at two blocks each, and no chunk shorter
  than ``min_rows`` rows. The chunks' partial sums are added by a
  second, deterministic pass."""
  return max(1, min(-(-4 * 132 // tiles), rows // min_rows))


def require_aligned(name: str, *tensors) -> None:
  """Kernels that read 4 channels per load need 16-byte aligned bases."""
  for t in tensors:
    if t is not None and t.data_ptr() % 16:
      raise ValueError(f'{name}: tensors must start 16-byte aligned')


def require_cuda(name: str, *tensors) -> None:
  """Device and contiguity checks every wrapper runs before a launch."""
  for t in tensors:
    if t is None:
      continue
    if t.device.type != 'cuda':
      raise ValueError(f'{name}: tensors must be on a CUDA device, got '
                       f'{t.device}')
    if not t.is_contiguous():
      raise ValueError(f'{name}: tensors must be contiguous')
