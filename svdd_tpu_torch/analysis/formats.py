"""Sequence format converters (``svdd_tpu/analysis/formats.py``): DNA
strings, int token indices and channel-last one-hot arrays, with their
checks; and genomic intervals resolved against a {chrom: sequence} dict.
pandas is imported inside the interval functions alone."""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from svdd_tpu_torch.data.gosai import batch_dna_detokenize, dna_tokenize_batch

SeqLike = Union[str, Sequence[str], np.ndarray]
DNA_LETTERS = frozenset('ACGTN')


def get_input_type(x: SeqLike) -> str:
  """'strings' | 'indices' | 'one_hot'. A trailing axis of 4 on a 3-D or
  deeper array, or on a float matrix, is one-hot; an int array holds
  indices."""
  if isinstance(x, str) or (
      isinstance(x, (list, tuple)) and x and isinstance(x[0], str)):
    return 'strings'
  arr = np.asarray(x)
  if arr.ndim >= 3 and arr.shape[-1] == 4:
    return 'one_hot'
  if (arr.ndim == 2 and arr.shape[-1] == 4
      and np.issubdtype(arr.dtype, np.floating)):
    return 'one_hot'
  if np.issubdtype(arr.dtype, np.integer):
    return 'indices'
  raise ValueError(f'unrecognized sequence input {type(x)}')


def strings_to_indices(seqs: Union[str, Sequence[str]]) -> np.ndarray:
  if isinstance(seqs, str):
    seqs = [seqs]
  check_strings(seqs)
  return dna_tokenize_batch(list(seqs))


def indices_to_strings(tokens: np.ndarray) -> List[str]:
  return batch_dna_detokenize(np.atleast_2d(np.asarray(tokens)))


def indices_to_one_hot(tokens: np.ndarray) -> np.ndarray:
  """float32 one-hots; ids outside 0-3 give all-zero rows."""
  tokens = np.asarray(tokens)
  out = np.zeros(tokens.shape + (4,), np.float32)
  valid = (tokens >= 0) & (tokens < 4)
  np.put_along_axis(out, np.clip(tokens, 0, 3)[..., None],
                    valid[..., None].astype(np.float32), axis=-1)
  return out


def one_hot_to_indices(onehot: np.ndarray) -> np.ndarray:
  """int32 argmax of each row; an all-zero (masked) row gives 4."""
  onehot = np.asarray(onehot)
  idx = onehot.argmax(-1).astype(np.int32)
  return np.where(onehot.sum(-1) > 0, idx, 4)


def convert_input_type(x: SeqLike, output_type: str):
  """Any of the three forms to ``output_type``."""
  in_type = get_input_type(x)
  if in_type == output_type:
    return x
  if in_type == 'strings':
    idx = strings_to_indices(x)
  elif in_type == 'one_hot':
    idx = one_hot_to_indices(x)
  else:
    idx = np.asarray(x)
  if output_type == 'indices':
    return idx
  if output_type == 'strings':
    return indices_to_strings(idx)
  if output_type == 'one_hot':
    return indices_to_one_hot(idx)
  raise ValueError(f'unknown output type {output_type!r}')


def check_strings(seqs: Sequence[str]) -> None:
  """Raises on a character outside A, C, G, T, N (either case)."""
  for s in seqs:
    bad = set(s.upper()) - DNA_LETTERS
    if bad:
      raise ValueError(f'invalid characters {bad} in sequence')


def check_intervals(df) -> bool:
  """True iff ``df`` is a genomic-interval frame: first three columns
  chrom (string or categorical), start and end (integers). False where
  pandas is absent."""
  try:
    import pandas as pd
    from pandas.api.types import is_integer_dtype, is_string_dtype
  except ImportError:
    return False
  if not hasattr(df, 'columns') or df.shape[1] < 3:
    return False
  if list(df.columns[:3]) != ['chrom', 'start', 'end']:
    return False
  chrom = df['chrom']
  return (bool(is_string_dtype(chrom)
               or isinstance(chrom.dtype, pd.CategoricalDtype))
          and is_integer_dtype(df['start'])
          and is_integer_dtype(df['end']))


def check_indices(indices) -> bool:
  """An int array of 1 or 2 dimensions with values in [0, 4]."""
  arr = np.asarray(indices)
  return (np.issubdtype(arr.dtype, np.integer) and arr.ndim in (1, 2)
          and arr.size > 0 and 0 <= arr.min() and arr.max() <= 4)


def check_one_hot(one_hot) -> bool:
  """A float array of 2 or 3 dimensions with 4 channels last."""
  arr = np.asarray(one_hot)
  return (np.issubdtype(arr.dtype, np.floating)
          and arr.ndim in (2, 3) and arr.shape[-1] == 4)


def intervals_to_strings(df, genome: dict) -> List[str]:
  """Each interval's sequence from ``genome`` ({chrom: sequence}),
  upper-cased, reverse-complemented where an optional 'strand' column is
  '-'."""
  comp = str.maketrans('ACGTN', 'TGCAN')
  out = []
  for row in df.itertuples(index=False):
    chrom, start, end = row.chrom, int(row.start), int(row.end)
    if chrom not in genome:
      raise KeyError(f'chromosome {chrom!r} not in the provided genome '
                     'dict (pass {chrom: sequence})')
    s = genome[chrom][start:end].upper()
    if getattr(row, 'strand', '+') == '-':
      s = s.translate(comp)[::-1]
    out.append(s)
  return out


def strings_to_intervals(seqs: Sequence[str], chrom: str = 'custom'):
  """The sequences laid end to end on one synthetic contig, as an
  interval frame."""
  import pandas as pd
  lengths = np.array([len(s) for s in seqs])
  starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
  return pd.DataFrame({'chrom': chrom, 'start': starts.astype(np.int64),
                       'end': (starts + lengths).astype(np.int64)})
