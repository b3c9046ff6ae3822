"""DNA detokenizer (``svdd_tpu/data/gosai.py:batch_dna_detokenize``), in
numpy: ids 0-3 map to 'A', 'C', 'G', 'T' and every other id to 'N', as
the JAX package's native detokenizer does
(``svdd_tpu/native/dna_kernels.cc:dna_detokenize``). The sample_eval CLI
logs its samples, DNA or text tokens alike, through it."""

from __future__ import annotations

import numpy as np

_ALPHABET = np.array(list('ACGTN'))


def batch_dna_detokenize(batch_seq) -> list[str]:
  """(N, L) int tokens -> N strings."""
  tokens = np.asarray(batch_seq)
  chars = _ALPHABET[np.where((tokens >= 0) & (tokens < 4), tokens, 4)]
  return [''.join(row) for row in chars]
