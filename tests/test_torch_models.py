"""svdd_tpu_torch models on svdd_tpu weights carried over by
svdd_tpu_torch.weights, vs the JAX modules on the same inputs.

Float32 with TF32 off. A whole model sums in a different order in each
package at every layer, so outputs agree to about 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu import rewards as jrewards
from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.models.cnn import CNNModel as JaxCNN
from svdd_tpu.models.enformer import EnformerValueModel as JaxEnformer

from svdd_tpu_torch import mdlm, rewards
from svdd_tpu_torch.weights import cnn_from_jax, enformer_value_from_jax
from torch_port_helpers import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def test_cnn_denoiser_matches_svdd_tpu():
  cfg = jax_tiny_config('dna')            # L=24, hidden 32, 5 layers
  jmodel = JaxCNN(config=cfg, alphabet_size=cfg.vocab_size)
  rs = np.random.default_rng(0)
  x = rs.integers(0, 5, (4, cfg.model.length)).astype(np.int32)
  sigma = rs.uniform(0, 2, 4).astype(np.float32)
  variables = random_variables(jmodel.init, jnp.asarray(x),
                                jnp.asarray(sigma), rs=rs)
  want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x),
                                          jnp.asarray(sigma)))
  model = cnn_from_jax(variables)
  with torch.no_grad():
    got = model(torch.from_numpy(x).long(), torch.from_numpy(sigma))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('length,n_conv,channels,n_transformers,batch', [
    (14, 3, 256, 2, 4),     # 14 -> 7 -> 4 -> 2: odd tail, L=2 attention
    (32, 3, 256, 1, 4),     # 32 -> 16 -> 8 -> 4: general-L attention
    (200, 7, 256, 1, 2),    # the full tower depth at narrow channels
])
def test_enformer_value_model_matches_svdd_tpu(length, n_conv, channels,
                                               n_transformers, batch):
  jmodel = JaxEnformer(channels=channels, n_conv=n_conv,
                       n_transformers=n_transformers, n_heads=2)
  rs = np.random.default_rng(length)
  tokens = rs.integers(0, 5, (batch, length))        # 4 = MASK rows
  onehot = np.asarray(mdlm.transform_samples(torch.from_numpy(tokens)))
  variables = random_variables(jmodel.init, jnp.zeros((1, length, 4)),
                                rs=rs)
  want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(onehot)))
  model = enformer_value_from_jax(variables)
  with torch.no_grad():
    got = model(torch.from_numpy(onehot)).numpy()
  assert got.shape == want.shape == (batch,)
  np.testing.assert_allclose(got, want, rtol=2e-4,
                             atol=2e-4 * np.abs(want).max())


def test_reward_oracles_match_svdd_tpu():
  """The synthetic motif oracle, and the 3-task DNA Enformer oracle read
  at task 0, on the same one-hot inputs (MASK rows zeroed)."""
  rs = np.random.default_rng(7)
  length, batch = 14, 4
  tokens = rs.integers(0, 5, (batch, length))
  onehot_t = mdlm.transform_samples(torch.from_numpy(tokens))
  onehot = jnp.asarray(onehot_t.numpy())
  np.testing.assert_allclose(
      rewards.synthetic_motif_oracle(length)(onehot_t).numpy(),
      np.asarray(jrewards.synthetic_motif_oracle(length)(onehot)),
      rtol=1e-6, atol=1e-6)
  kwargs = dict(channels=256, n_conv=3, n_transformers=1, n_heads=2)
  jmodule = JaxEnformer(n_tasks=3, **kwargs)
  joracle = jrewards.RewardOracle(jmodule, random_variables(
      jmodule.init, jnp.zeros((1, length, 4)), rs=rs), task_index=0)
  want = np.asarray(jax.jit(lambda o: joracle(o))(onehot))
  oracle = rewards.RewardOracle(enformer_value_from_jax(joracle.variables))
  with torch.no_grad():
    got = oracle(onehot_t).numpy()
    fresh = rewards.RewardOracle.create_dna(torch.Generator().manual_seed(0),
                                            **kwargs)(onehot_t)
  assert got.shape == want.shape == fresh.shape == (batch,)
  np.testing.assert_allclose(got, want, rtol=2e-4,
                             atol=2e-4 * np.abs(want).max())
