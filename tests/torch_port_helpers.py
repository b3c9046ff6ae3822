"""Weights for the svdd_tpu_torch tests: flax variables of the shapes a
traced ``init`` makes (``jax.eval_shape``; compiling ``init`` costs
seconds on one core), drawn with numpy as flax initialises them; and
flax's dropout on injected masks (``FlaxMasks``)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svdd_tpu.diffusion import build_backbone


def random_cnn_variables(cfg, rs):
  """Denoiser variables: lecun-normal kernels, zero biases, unit norm
  scales, normal Fourier weights."""
  shapes = jax.eval_shape(build_backbone(cfg).init, jax.random.key(0),
                          jnp.zeros((1, cfg.model.length), jnp.int32),
                          jnp.zeros((1,)))

  def fill(path, leaf):
    name = getattr(path[-1], 'key', '')
    if name == 'kernel':
      return (rs.normal(size=leaf.shape)
              / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
    if name == 'bias':
      return np.zeros(leaf.shape, np.float32)
    if name == 'scale':
      return np.ones(leaf.shape, np.float32)
    return rs.normal(size=leaf.shape).astype(np.float32)

  return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def perturb(tree, rs):
  """Non-trivial biases, norm scales and batch stats (flax initialises
  biases and means to 0 and scales and variances to 1)."""
  out = {}
  for k, v in tree.items():
    if isinstance(v, dict):
      out[k] = perturb(v, rs)
      continue
    v = np.asarray(v)
    if k in ('bias', 'mean'):
      v = v + 0.1 * rs.normal(size=v.shape).astype(v.dtype)
    elif k == 'var':
      v = rs.uniform(0.5, 1.5, size=v.shape).astype(v.dtype)
    elif k == 'scale':
      v = v * rs.uniform(0.7, 1.3, size=v.shape).astype(v.dtype)
    out[k] = v
  return out


def random_variables(init, *args, rs):
  """Variables of the shapes ``init`` makes: lecun-normal kernels, 2*I
  pool logit weights, normal(1) rel biases and Fourier weights, then
  the biases, scales and batch stats of ``perturb``."""
  shapes = jax.eval_shape(init, jax.random.key(0), *args)

  def fill(path, leaf):
    names = [getattr(k, 'key', '') for k in path]
    shape = leaf.shape
    if names[-1] == 'kernel':        # transformer_stack: leading axis n
      fan_in = np.prod(shape[1 if 'transformer_stack' in names else 0:-1])
      return (rs.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    if names[-1] == 'to_attn_logits':
      return 2 * np.eye(shape[-1], dtype=np.float32)
    if names[-1] in ('scale', 'var'):
      return np.ones(shape, np.float32)
    if names[-1] in ('bias', 'mean'):
      return np.zeros(shape, np.float32)
    return rs.normal(size=shape).astype(np.float32)

  return perturb(jax.tree_util.tree_map_with_path(fill, dict(shapes)), rs)


class FlaxMasks:
  """flax ``nn.Dropout.__call__`` taking its masks in call order from a
  list (``set``), for the test that installs it with its monkeypatch:
  flax's select(mask, x / keep, 0), the rate-0 and deterministic cases as
  flax returns them. The port's forward takes the same list
  (``blocks.DropoutMasks(masks=...)``)."""

  def __init__(self):
    self.masks, self.i = [], 0

  def set(self, masks):
    self.masks, self.i = list(masks), 0
    return self

  def install(self, monkeypatch):
    owner = self

    def call(self, inputs, deterministic=None, rng=None):
      det = self.deterministic if deterministic is None else deterministic
      if self.rate == 0.0 or det:
        return inputs
      mask = jnp.asarray(owner.masks[owner.i])
      owner.i += 1
      return jax.lax.select(mask, inputs / (1.0 - self.rate),
                            jnp.zeros_like(inputs))

    monkeypatch.setattr(nn.Dropout, '__call__', call)
    return self


def dropout_masks(rs, n, c, blocks=1, length=2, keep=0.6):
  """The dropout masks of one Enformer training forward: per transformer
  block the attention output's, the FFN's up and down projections'."""
  return [rs.random((n, length, w)) < keep for _ in range(blocks)
          for w in (c, 2 * c, c)]


@pytest.fixture(autouse=True, scope='module')
def few_torch_threads():
  """Two torch intra-op threads while a test file that imports this
  fixture runs (restored after it): the full test run puts six test
  processes on the machine's cores, and torch's default of a thread a
  core makes them spin against each other (three RNA test files: 155 s
  with the default, 81 s with two, on three processes)."""
  import torch
  n = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(n)


def jax_cli_common():
  """``svdd_tpu.cli.common`` imported with ``jax.config.update`` stubbed
  out: that module turns on JAX's persistent compilation cache when it is
  imported, and a later test in the same process (``tests/test_aot.py``'s
  executable round trip) fails under that cache. Where another file of
  the process imported it first, the module is returned as it is."""
  from unittest import mock
  with mock.patch.object(jax.config, 'update'):
    from svdd_tpu.cli import common
  return common
