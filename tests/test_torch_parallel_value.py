"""Value-net training on a process grid (``train/value.py``'s ``mesh``,
global BatchNorm, FSDP) and ``cli.train --dist`` / ``--fsdp``, on the CPU
under gloo.

One module fixture starts two processes (``torch_parallel_worker.py``,
suite 'value'): ``ValueTrainer`` MC and CD-Q, each also under FSDP (the
tiny Enformer's two transformer blocks sharded by layer as JAX's stacked
leaves are), and ``MultiSepTrainer``, two iterations each at world 2;
process 0 also trains alone. The pattern of
``tests/test_parallel.py:646-760``: the sharded trajectories, targets and
regression rows give the single-process numbers.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import few_torch_threads  # noqa: F401
import torch_parallel_worker as W

REL = dict(rtol=1e-5, atol=1e-6)
# Adam's first steps move a parameter by about the learning rate whatever
# its gradient's size, so an element whose gradient is as small as the
# rounding of the sums may move the other way: two steps at 3e-4 bound
# that. The conv biases ahead of a training BatchNorm are such elements
# (their gradient is 0 in exact arithmetic: the norm takes the mean out),
# a few thousand of the tiny net's 1.7M; the rest stay within REL.
ADAM_FLIP = 2 * 2 * 3e-4
FLIPPED = 0.01
# flax's variance E[x^2] - E[x]^2 loses digits to cancellation, so the
# order of BatchNorm's sums (per process, then all-reduced) shows in the
# gradients at about 2e-5 of their norm, growing toward the input.
GRAD_REL, GRAD_ABS = 1e-4, 1e-6


@pytest.fixture(scope='module')
def value_grid(tmp_path_factory):
  return W.spawn('value', 2, str(tmp_path_factory.mktemp('par_value')))


def _world1(results) -> dict:
  """The single-process runs, which the two processes share out."""
  return {k: v for r in results for k, v in r['world1'].items()}


def _assert_state(got, want, tol=REL, flips=False):
  """Every tensor within ``tol``; with ``flips``, within ADAM_FLIP and
  all but a FLIPPED share of the elements within ``tol``."""
  assert list(got) == list(want)
  far = total = 0
  for k in want:
    a, b = got[k].numpy(), want[k].numpy()
    if not flips:
      np.testing.assert_allclose(a, b, **tol, err_msg=k)
      continue
    np.testing.assert_allclose(a, b, rtol=tol['rtol'], atol=ADAM_FLIP,
                               err_msg=k)
    far += int((~np.isclose(a, b, **tol)).sum())
    total += a.size
  assert far <= FLIPPED * max(total, 1), (far, total)


def _assert_losses(got, want):
  """The first iteration's loss within REL; the second, after an Adam
  step (ADAM_FLIP), within 1e-3 as JAX's own test holds it
  (``tests/test_parallel.py:701-702``)."""
  np.testing.assert_allclose(got[0], want[0], **REL)
  np.testing.assert_allclose(got[1], want[1], rtol=1e-3)


@pytest.mark.parametrize('kind,ref', [('mc', 'mc'), ('cdq', 'cdq'),
                                      ('mc_fsdp', 'mc'),
                                      ('cdq_fsdp', 'cdq')])
def test_value_trainer_grid_matches_world1(value_grid, kind, ref):
  """Two MC or CD-Q iterations at world 2, with and without FSDP: the
  losses and the net's parameters and running statistics, on both
  processes, are the single-process run's."""
  want = _world1(value_grid)[ref]
  for r in range(2):
    _assert_losses(value_grid[r][kind]['losses'], want['losses'])
    _assert_state(value_grid[r][kind]['state'], want['state'], flips=True)


@pytest.mark.parametrize('kind', ['mc_fsdp', 'cdq_fsdp'])
def test_value_fsdp_holds_shards_between_steps(value_grid, kind):
  """Between FSDP steps each process holds half of the sharded value-net
  parameters and the replicated ones once, and no gradient."""
  for r in range(2):
    held = value_grid[r][kind]['held']
    assert held['module'] == held['replicated']
    assert held['parts'] * 2 == held['whole'] > held['replicated']
    assert held['grads'] == 0


def test_value_fsdp_state_restores_whole(value_grid):
  """A world-2 FSDP trainer state, saved whole, restores into the shards
  and reads back as it was saved, bit for bit."""
  assert [value_grid[r]['restored_fsdp'] for r in range(2)] == [True, True]


def test_multisep_trainer_grid_matches_world1(value_grid):
  want = _world1(value_grid)['multisep']
  for r in range(2):
    got = value_grid[r]['multisep']
    _assert_losses([x.numpy() for x in got['losses']],
                   [x.numpy() for x in want['losses']])
    _assert_state(got['state'], want['state'], flips=True)


def test_global_batchnorm_matches_world1(value_grid):
  """A training step's loss, gradients and running statistics at world 2
  with BatchNorm on the global batch equal world 1's; with each
  process's own statistics they do not."""
  want = _world1(value_grid)['bn']
  for r in range(2):
    got = value_grid[r]['bn']
    np.testing.assert_allclose(got['loss'], want['loss'], **REL)
    _assert_state(got['stats'], want['stats'])
    for k, b in want['grads'].items():
      err = float((got['grads'][k] - b).norm())
      assert err <= GRAD_REL * float(b.norm()) + GRAD_ABS, k
  local = value_grid[0]['bn_local']
  assert not np.isclose(local['loss'], want['loss'], rtol=1e-4)
  k = next(k for k in want['stats'] if k.endswith('norm.mean'))
  assert not np.allclose(local['stats'][k].numpy(),
                         want['stats'][k].numpy(), rtol=1e-4)


@pytest.mark.parametrize('name', ['cli_dist', 'cli_fsdp'])
def test_cli_train_dist_runs(value_grid, name):
  """``cli.train --dist`` and ``--dist --fsdp`` train over the group's two
  processes (an iteration, its collectives issued)."""
  for r in range(2):
    got = value_grid[r][name]
    assert got['step'] == 1
    assert got['collectives'].get('all_reduce', 0) > 0
    assert got['collectives'].get('all_gather', 0) > 0


def test_cli_train_batch_must_divide_data_axis(value_grid):
  """A --batch_size the data axis does not divide exits, as JAX's CLI."""
  for r in range(2):
    assert 'must divide' in value_grid[r]['cli_batch3']
