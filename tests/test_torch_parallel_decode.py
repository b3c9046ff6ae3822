"""The guided decoders on a process grid (``Diffusion.*_sampler(mesh=)``,
``sampling/guidance.py``'s ``shard``) and the tensor-parallel value net
(``models.enformer.tp_shard_value_params``), on the CPU under gloo.

One module fixture starts four processes (``torch_parallel_worker.py``,
suite 'decode'): SVDD-MC, scheduled-M SVDD-MC, SVDD-PM, DPS, classifier
guidance and TDS (with adaptive resampling) at B=8 on grids of 2 x 1,
1 x 2 (the candidates split over the model axis), 2 x 2 and 4 x 1, and
SVDD-MC with the value net split over the model axis; process 0 also
decodes alone. Every draw is the global batch's, sliced, so each grid
returns the single-process samples (the port's counterpart of
``tests/test_parallel.py:107-233, 541-640``). ``tp_value_spec`` is held
to JAX's on the same variables, and B2's plain version to its ``row0``
contract.
"""

import jax
import numpy as np
import pytest
import torch

from svdd_tpu.parallel import mesh as JM

from svdd_tpu_torch.ops import fused_sample
from svdd_tpu_torch.parallel import mesh as M
from svdd_tpu_torch.parallel import rows
from svdd_tpu_torch.value import build_value_module
from svdd_tpu_torch.weights import enformer_params_to_jax
from torch_port_helpers import few_torch_threads  # noqa: F401
import torch_parallel_worker as W

GRIDS = {'2x1': 2, '1x2': 2, '2x2': 4, '4x1': 4}
ALGOS = ['mc', 'mc_sched', 'pm', 'dps', 'classifier', 'tds']


@pytest.fixture(scope='module')
def decodes(tmp_path_factory):
  return W.spawn('decode', 4, str(tmp_path_factory.mktemp('par_decode')))


@pytest.mark.parametrize('grid', list(GRIDS))
@pytest.mark.parametrize('algo', ALGOS)
def test_sharded_decode_matches_world1(decodes, algo, grid):
  """Every process of the grid returns the global samples of the
  single-process decode on the same seed."""
  want = W.find(decodes, 'world1')[algo]
  for r in range(GRIDS[grid]):
    torch.testing.assert_close(decodes[r][grid][algo], want, rtol=0, atol=0)


@pytest.mark.parametrize('grid', list(GRIDS))
def test_sharded_tds_ess_trace_matches_world1(decodes, grid):
  """TDS's ESS trace, from the log-weights gathered over the data axis."""
  want = W.find(decodes, 'world1')['tds_ess']
  assert want.shape == (4,) and (want >= 1).all()
  for r in range(GRIDS[grid]):
    torch.testing.assert_close(decodes[r][grid]['tds_ess'], want)


@pytest.mark.parametrize('grid', ['1x2', '2x2'])
def test_tensor_parallel_svdd_mc_matches_world1(decodes, grid):
  """SVDD-MC with the value net split over the model axis (tp=True)."""
  want = W.find(decodes, 'world1')['mc']
  for r in range(GRIDS[grid]):
    torch.testing.assert_close(decodes[r][grid]['mc_tp'], want, rtol=0,
                               atol=0)


@pytest.mark.parametrize('grid', ['1x2', '2x2'])
def test_tensor_parallel_scores_match_full_net(decodes, grid):
  """The split net's scores (heads over the model axis, one all-reduce
  after each attention, FFN and the head) are the full net's, up to the
  order of the partial sums."""
  want = W.find(decodes, 'scores')
  for r in range(GRIDS[grid]):
    torch.testing.assert_close(decodes[r][f'tp_scores{grid}'], want,
                               rtol=1e-5, atol=1e-6)


def test_sharded_decodes_issue_collectives(decodes):
  """The candidate split gathers its scores over the model axis each
  step, TDS its weights and particles over the data axis, and every
  sampler its result."""
  for grid in GRIDS:
    got = decodes[0][grid]['collectives']
    assert got.get('all_gather', 0) > 0, grid
  assert decodes[0]['1x2']['collectives'].get('all_reduce', 0) > 0   # TP


# ---------------------------------------------------------------------------
# tp_value_spec against JAX's; B2's row0
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaves(v, path + (k,))
  else:
    yield path, np.asarray(tree)


def _held(arr, axis, m, j):
  """The element ids rank j of m holds of ``arr`` split on ``axis``."""
  if axis is None:
    return arr.reshape(-1)
  return np.array_split(arr, m, axis=axis)[j].reshape(-1)


@pytest.mark.parametrize('m', [2, 4])
def test_tp_value_spec_matches_jax(m):
  """Each model rank holds the same elements of every value-net leaf under
  the port's split of its parameters as under JAX's tp_value_spec of the
  flax variables (two transformer blocks, stacked in JAX): the
  column/row table, the relative biases split by head, and the conv
  tower replicated."""
  module = build_value_module('dna', 'enformer', 1, torch.Generator(),
                              **dict(W.VALUE_KW, n_heads=8))
  ids, off = {}, 1
  for k, p in module.named_parameters():
    ids[k] = torch.arange(off, off + p.numel(),
                          dtype=torch.float64).reshape(p.shape)
    off += p.numel()
  assert off < 2 ** 24                  # exact in the converter's float32
  tree = {'params': enformer_params_to_jax(ids, module)}
  split = 0
  for j in range(m):
    port = np.concatenate([
        _held(t.numpy(), M.tp_value_spec(k, t.shape, m, heads=8), m, j)
        for k, t in ids.items()])
    jax_parts = []
    for path, arr in _leaves(tree):
      spec = JM.tp_value_spec(path, arr, m)
      axis = next((i for i, a in enumerate(spec) if a == JM.MODEL_AXIS), None)
      split += axis is not None
      jax_parts.append(_held(arr, axis, m, j))
    np.testing.assert_array_equal(np.sort(port),
                                  np.sort(np.concatenate(jax_parts)))
  assert split > 0


def test_candidate_rows_split_as_jax_candidate_sharding():
  """A data block's candidate rows over its model ranks are its share of
  JAX's P(('data', 'model')) split of the global B*M rows."""
  class Grid:
    model, data = 2, 2
  for d in range(2):
    for j in range(2):
      g = Grid()
      g.model_index, g.data_index = j, d
      mine = M.candidate_rows(g, 12)
      glob = np.arange(24).reshape(4, 6)[d * 2 + j]      # (data, model) major
      np.testing.assert_array_equal(np.arange(24)[d * 12:(d + 1) * 12][mine],
                                    glob)


def test_gumbel_candidates_plain_row0_halves():
  """B2's plain version with row0: two calls on the row halves, each from
  the same generator state in its block of the batch's rows, are one
  call on all the rows, and leave the generator where the one call does;
  the block decides the offset: outside one, the second half draws the
  first rows' noise."""
  rs = np.random.default_rng(0)
  log_q = torch.log_softmax(torch.as_tensor(rs.normal(size=(6, 7, 5)),
                                            dtype=torch.float32), -1)
  x = torch.as_tensor(rs.integers(0, 5, (6, 7)))
  full_gen = torch.Generator().manual_seed(4)
  want, noise = fused_sample.gumbel_candidates(log_q, x, 3, 4, full_gen,
                                               return_noise=True)
  halves = []
  for row0 in (0, 3):
    gen = torch.Generator().manual_seed(4)
    with rows.global_rows(row0, 6):
      halves.append(fused_sample.gumbel_candidates(
          log_q[row0:row0 + 3], x[row0:row0 + 3], 3, 4, gen,
          return_noise=True))
    torch.testing.assert_close(gen.get_state(), full_gen.get_state())
  torch.testing.assert_close(torch.cat([h[0] for h in halves]), want,
                             rtol=0, atol=0)
  torch.testing.assert_close(torch.cat([h[1] for h in halves]), noise,
                             rtol=0, atol=0)
  _, outside = fused_sample.gumbel_candidates(
      log_q[3:], x[3:], 3, 4, torch.Generator().manual_seed(4),
      return_noise=True)
  torch.testing.assert_close(outside, noise[:3], rtol=0, atol=0)
  assert not torch.equal(outside, noise[3:])
