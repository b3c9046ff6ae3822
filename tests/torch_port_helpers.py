"""Weights for the svdd_tpu_torch tests: flax variables of the shapes a
traced ``init`` makes (``jax.eval_shape``; compiling ``init`` costs
seconds on one core), drawn with numpy as flax initialises them."""

import jax
import jax.numpy as jnp
import numpy as np

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
