"""Gosai enhancer data (``svdd_tpu/data/gosai.py``), in numpy: the DNA
tokenizer and detokenizer, the CSV-backed dataset with the JAX package's
deterministic synthetic split in its place where no CSV is present, and
the resumable shuffling batch iterator.

The tokenizer and the CSV reader follow the JAX package's native
library (``svdd_tpu/native/dna_kernels.cc``), which that package takes
whenever it is built: 'A', 'C', 'G', 'T' in either case map to 0-3 and
every other character to 4; a row whose field count differs from the
header's, or whose sequence is not ``length`` long, is skipped; a class
field is read as C's ``strtof`` reads it, so an empty one is 0. The
detokenizer maps ids 0-3 to 'A', 'C', 'G', 'T' and every other id to
'N'. The sample_eval CLI logs its samples, DNA or text tokens alike,
through it.

The CSVs are ``gosai_{split}.csv`` under ``data_dir``, or under
``DATA_DIR``: the ``SVDD_DATA_DIR`` environment variable, else
``/data/svdd``, as the JAX package's module constant; with no file there
the split is synthetic.

On a process grid each data shard reads its own rows, as the JAX
package's multi-host jobs do (``svdd_tpu/data/gosai.py:181-185,
232-248``): by default every process holds the whole split and the
iterator takes the strided indices ``order[shard_index::num_shards]`` of
each epoch's permutation; with ``shard_data`` and a CSV present, each
process reads only its contiguous range of the file's raw lines
(``csv_count_rows`` // num_shards of them) and iterates it unsharded,
shuffled from ``seed + shard_index``.
"""

from __future__ import annotations

import csv
import os
import re
import zlib
from typing import Dict, Iterator, Optional

import numpy as np

_ALPHABET = np.array(list('ACGTN'))
_LUT = np.full(256, 4, np.int32)
for _i, _ch in enumerate('ACGT'):
  _LUT[ord(_ch)] = _LUT[ord(_ch.lower())] = _i
CLASS_COLUMNS = ('hepg2', 'k562', 'sknsh')
SYNTHETIC_SIZES = {'train': 4096, 'val': 512, 'test': 512}
DATA_DIR = os.environ.get('SVDD_DATA_DIR', '/data/svdd')
_FLOAT_PREFIX = re.compile(
    r'\s*[+-]?(?:inf(?:inity)?|nan|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)',
    re.IGNORECASE)


def dna_detokenize(seq) -> str:
  """(L,) int tokens -> one string: ids 0-3 are 'A', 'C', 'G', 'T', any
  other id 'N' (one row of ``batch_dna_detokenize``)."""
  return batch_dna_detokenize(np.asarray(seq)[None])[0]


def batch_dna_detokenize(batch_seq) -> list[str]:
  """(N, L) int tokens -> N strings."""
  tokens = np.asarray(batch_seq)
  chars = _ALPHABET[np.where((tokens >= 0) & (tokens < 4), tokens, 4)]
  return [''.join(row) for row in chars]


def dna_tokenize_batch(seqs: list[str]) -> np.ndarray:
  """N strings of one length -> (N, L) int32 tokens."""
  if not seqs:
    return np.zeros((0, 0), np.int32)
  blob = np.frombuffer(''.join(seqs).encode('latin-1'), np.uint8)
  return _LUT[blob].reshape(len(seqs), -1)


def _strtof(field: str) -> float:
  """The float C's ``strtof`` reads from the start of ``field``; 0 where
  none does (an empty field)."""
  m = _FLOAT_PREFIX.match(field)
  return float(m.group(0)) if m else 0.0


def csv_count_rows(path: str) -> int:
  """The data lines of a CSV (its raw lines, an unterminated last one
  included, less the header), as the JAX package's native reader counts
  them to plan row shards."""
  lines, last = 0, b'\n'
  with open(path, 'rb') as f:
    while chunk := f.read(1 << 16):
      lines += chunk.count(b'\n')
      last = chunk[-1:]
  if last != b'\n':
    lines += 1
  return max(lines - 1, 0)


def _raw_lines(f, row_offset: int, row_limit: Optional[int]):
  """The header line, then raw lines [row_offset, row_offset +
  row_limit) after it."""
  yield f.readline()
  for i, line in enumerate(f):
    if i < row_offset:
      continue
    if row_limit is not None and i >= row_offset + row_limit:
      return
    yield line


def read_gosai_csv(path: str, length: int, row_offset: int = 0,
                   row_limit: Optional[int] = None):
  """(tokens (R, L) int32, clss (R, 3) float32) of the rows of ``path``
  with a ``seq`` field of ``length`` characters and the header's field
  count, among its raw data lines [row_offset, row_offset + row_limit)
  (all of them by default), as the native reader bounds a shard."""
  seqs, clss = [], []
  with open(path, newline='') as f:
    rows = csv.reader(_raw_lines(f, row_offset, row_limit))
    header = next(rows)
    seq_idx = header.index('seq')
    cls_idx = [header.index(c) for c in CLASS_COLUMNS]
    for row in rows:
      if len(row) != len(header) or len(row[seq_idx]) != length:
        continue
      seqs.append(row[seq_idx])
      clss.append([_strtof(row[i]) for i in cls_idx])
  return (dna_tokenize_batch(seqs).reshape(len(seqs), length),
          np.asarray(clss, np.float32).reshape(len(seqs), len(cls_idx)))


def _synthetic_split(split: str, n: int, length: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
  """The JAX package's deterministic stand-in split, bit for bit:
  uniform ACGT sequences, a GCGC motif planted in about 30% of them, and
  'activity' labels from the motif counts plus noise. The generator's
  seed is the crc32 of '<split>:<seed>', the same in every process."""
  rng = np.random.default_rng(
      zlib.crc32(f'{split}:{seed}'.encode()) % (2 ** 31))
  seqs = rng.integers(0, 4, size=(n, length), dtype=np.int64)
  motif = np.array([2, 1, 2, 1])
  hot = rng.random(n) < 0.3
  pos = rng.integers(0, length - 4, size=n)
  for i in np.nonzero(hot)[0]:
    seqs[i, pos[i]:pos[i] + 4] = motif
  windows = np.lib.stride_tricks.sliding_window_view(seqs, 4, axis=1)
  counts = (windows == motif).all(-1).sum(-1).astype(np.float32)
  clss = np.stack([
      counts + 0.1 * rng.standard_normal(n).astype(np.float32),
      0.5 * counts + 0.1 * rng.standard_normal(n).astype(np.float32),
      rng.standard_normal(n).astype(np.float32),
  ], axis=1)
  return {'seqs': seqs.astype(np.int32), 'clss': clss}


class GosaiDataset:
  """One split: ``seqs`` (N, L) int32 and ``clss`` (N, 3) float32, from
  ``gosai_{split}.csv`` or, without one, the synthetic split."""

  def __init__(self, split: str = 'train', length: int = 200,
               data_dir: Optional[str] = None,
               synthetic_size: Optional[int] = None,
               row_offset: int = 0, row_limit: Optional[int] = None):
    path = os.path.join(data_dir or DATA_DIR, f'gosai_{split}.csv')
    if os.path.exists(path):
      self.seqs, self.clss = read_gosai_csv(path, length, row_offset,
                                            row_limit)
      self.synthetic = False
    else:
      n = synthetic_size or SYNTHETIC_SIZES.get(split, 512)
      d = _synthetic_split(split, n, length)
      self.seqs, self.clss = d['seqs'], d['clss']
      self.synthetic = True
    self.length = self.seqs.shape[1]

  def __len__(self):
    return len(self.seqs)

  def __getitem__(self, idx):
    return {'seqs': self.seqs[idx], 'clss': self.clss[idx],
            'attention_mask': np.ones(self.length, np.float32)}


class FaultTolerantIterator:
  """Resumable shuffling batch iterator: the epoch's order is a
  permutation drawn from ``seed + epoch``, of which shard ``shard_index``
  of ``num_shards`` takes every ``num_shards``-th index; (epoch, counter,
  seed) round-trip through ``state_dict`` / ``load_state_dict``, so
  training resumes mid-epoch exactly. Iterating is endless, epoch after
  epoch; ``drop_last`` drops an epoch's short last batch."""

  def __init__(self, dataset: GosaiDataset, batch_size: int,
               shuffle: bool = True, seed: int = 0,
               num_shards: int = 1, shard_index: int = 0,
               drop_last: bool = True):
    self.dataset = dataset
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.seed = seed
    self.num_shards = num_shards
    self.shard_index = shard_index
    self.drop_last = drop_last
    self.epoch = 0
    self.counter = 0
    self.restarted = False

  def state_dict(self) -> Dict:
    return {'epoch': self.epoch, 'counter': self.counter,
            'seed': self.seed}

  def load_state_dict(self, state: Dict) -> None:
    self.epoch = int(state['epoch'])
    self.counter = int(state['counter'])
    self.seed = int(state.get('seed', self.seed))
    self.restarted = True

  def _epoch_order(self) -> np.ndarray:
    order = np.arange(len(self.dataset))
    if self.shuffle:
      np.random.default_rng(self.seed + self.epoch).shuffle(order)
    return order[self.shard_index::self.num_shards]

  def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
    while True:
      order = self._epoch_order()
      start = self.counter if self.restarted else 0
      self.restarted = False
      self.counter = start
      limit = len(order) - (self.batch_size - 1 if self.drop_last else 0)
      while self.counter < limit:
        idx = order[self.counter:self.counter + self.batch_size]
        self.counter += len(idx)
        yield {
            'seqs': self.dataset.seqs[idx],
            'clss': self.dataset.clss[idx],
            'attention_mask': np.ones(
                (len(idx), self.dataset.length), np.float32),
        }
      self.epoch += 1
      self.counter = 0


def get_dataloaders(config, *, num_shards: int = 1, shard_index: int = 0,
                    skip_train: bool = False, skip_valid: bool = False,
                    data_dir: Optional[str] = None,
                    shard_data: bool = False):
  """(train, valid, test) iterators of shard ``shard_index`` of
  ``num_shards``, each of the shard's share of ``loader.global_batch_size``
  and ``loader.eval_global_batch_size`` rows (which must divide); train
  shuffled from ``config.seed``. ``shard_data``: the module docstring's
  contiguous row ranges, where a CSV is present and there is more than
  one shard."""
  if config.loader.global_batch_size % num_shards != 0:
    raise ValueError(
        f'Train batch size {config.loader.global_batch_size} not '
        f'divisible by {num_shards} shards.')
  if config.loader.eval_global_batch_size % num_shards != 0:
    raise ValueError(
        f'Eval batch size {config.loader.eval_global_batch_size} not '
        f'divisible by {num_shards} shards.')
  length = config.model.length

  def make(split, bs, shuffle):
    path = os.path.join(data_dir or DATA_DIR, f'gosai_{split}.csv')
    if shard_data and num_shards > 1 and os.path.exists(path):
      share = csv_count_rows(path) // num_shards
      if share > 0:
        ds = GosaiDataset(split, length=length, data_dir=data_dir,
                          row_offset=share * shard_index, row_limit=share)
        return FaultTolerantIterator(ds, bs, shuffle=shuffle,
                                     seed=config.seed + shard_index)
    ds = GosaiDataset(split, length=length, data_dir=data_dir)
    return FaultTolerantIterator(ds, bs, shuffle=shuffle, seed=config.seed,
                                 num_shards=num_shards,
                                 shard_index=shard_index)

  train = None if skip_train else make(
      'train', config.loader.global_batch_size // num_shards, True)
  valid = None if skip_valid else make(
      'val', config.loader.eval_global_batch_size // num_shards, False)
  test = None if skip_valid else make(
      'test', config.loader.eval_global_batch_size // num_shards, False)
  return train, valid, test
