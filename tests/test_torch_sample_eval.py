"""svdd_tpu_torch's sample_eval path (``cli.main_gosai --mode
sample_eval``) vs svdd_tpu: the ddpm_cache step pinned to the JAX step
given the same Gumbel noise, the generative perplexity under the AR
scorer equal to JAX's on the same tokens and weights, the detokenizer,
and the CLI's rejections of what is not ported.

Tiny sizes on the CPU (the DiT at hidden 32, 2 heads; L <= 32; 8 steps),
float32 unless a test says otherwise.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.data import gosai as jgosai
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.eval import gen_ppl as jgen_ppl
from svdd_tpu.models.autoregressive import ARModel as JaxAR
from svdd_tpu.models.dit import DIT as JaxDIT
from svdd_tpu.sampling import sampler as jsampler

from svdd_tpu_torch.cli import main_gosai
from svdd_tpu_torch.config import text_mdlm_config, tiny_test_config
from svdd_tpu_torch.data import gosai
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.eval import gen_ppl
from svdd_tpu_torch.sampling import sampler
from svdd_tpu_torch.weights import ar_from_jax, dimamba_from_jax, dit_from_jax
from torch_port_helpers import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L, VOCAB, MASK = 32, 28, 27


def _text_configs():
  """The text preset cut to a tiny DiT (hidden 32, 2 heads, 2 blocks),
  f32, in both packages."""
  jcfg = jax_tiny_config('dna')
  jcfg.task, jcfg.backbone, jcfg.alphabet_size = 'text', 'dit', VOCAB - 1
  jcfg.sampling.predictor = 'ddpm_cache'
  tcfg = text_mdlm_config()
  for cfg in (jcfg, tcfg):
    cfg.model.length = L
    cfg.model.hidden_size, cfg.model.n_heads = 32, 2
    cfg.model.n_blocks, cfg.model.cond_dim = 2, 16
    cfg.sampling.steps = 8
    cfg.sampling.num_sample_batches = 1
    cfg.loader.eval_batch_size = 4
    cfg.parallel.precision = 'fp32'
  return jcfg, tcfg


@pytest.fixture(scope='module')
def text_pair():
  """The tiny text DiT in both packages on shared weights (every
  zero-init layer drawn non-zero, the final layer sharpened so p(x0|xt)
  is peaked and the step's draws depend on it)."""
  jcfg, tcfg = _text_configs()
  x = np.zeros((1, L), np.int32)
  variables = random_variables(
      JaxDIT(config=jcfg, vocab_size=VOCAB, compute_dtype=jnp.float32).init,
      jnp.asarray(x), jnp.zeros((1,)), rs=np.random.default_rng(0))
  lin = variables['params']['DDitFinalLayer_0']['linear']
  lin['kernel'] = 4.0 * lin['kernel']
  jdiff = JaxDiffusion(jcfg, variables=jax.tree.map(jnp.asarray, variables))
  tdiff = Diffusion(tcfg, device='cpu',
                    backbone=dit_from_jax(variables, tcfg, torch.float32))
  return jdiff, tdiff, variables


def _partly_masked(seed, b=4):
  rs = np.random.default_rng(seed)
  return np.where(rs.random((b, L)) < 0.6, MASK,
                  rs.integers(0, MASK, (b, L))).astype(np.int32)


def test_ddpm_cache_step_pinned_to_svdd_tpu(text_pair):
  """Three steps given the same Gumbel noise as JAX's: a fresh forward
  (the carried log p equal to JAX's), a step reusing a valid cache with
  no forward (the cached log p, not the denoiser's, drives the draw),
  and a step on a fully unmasked x, whose cache stays valid. f32 log p:
  1e-5; the draws and flags exactly."""
  jdiff, tdiff, _ = text_pair
  calls = []

  def counted(x, sigma):
    calls.append(1)
    return tdiff.forward(x, sigma)

  jstep = jax.jit(jsampler.ddpm_cache_step(jdiff.denoise_fn(),
                                           jdiff.schedule, MASK))
  tstep = sampler.ddpm_cache_step(counted, tdiff.schedule, MASK)
  t, t_next = np.float32(0.5), np.float32(0.45)
  key = jax.random.key(3)
  noise = torch.from_numpy(np.array(
      jax.random.gumbel(key, (4, L, VOCAB), jnp.float32)))

  def both(x, aux_j, aux_t):
    (lp_j, valid_j), want = jstep(aux_j, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(t_next), key)
    with torch.no_grad():
      (lp_t, valid_t), got = tstep(aux_t, torch.from_numpy(x).long(),
                                   torch.tensor(t), torch.tensor(t_next),
                                   None, gumbel=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert valid_t == bool(valid_j)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j),
                               rtol=1e-5, atol=1e-5)
    return lp_t, np.asarray(lp_j), valid_t

  x = _partly_masked(1)
  empty = (jnp.zeros((4, L, VOCAB)), jnp.asarray(False))
  lp_t, lp_j, valid = both(x, empty, (None, False))
  assert len(calls) == 1 and not valid
  # a valid cache taken from another x: no forward, and the draw follows it
  x2 = _partly_masked(2)
  both(x2, (jnp.asarray(lp_j), jnp.asarray(True)), (lp_t, True))
  assert len(calls) == 1
  fresh = tdiff.forward(torch.from_numpy(x2).long(), torch.zeros(4))
  assert not torch.allclose(fresh, lp_t)
  # nothing masked: x is unchanged, so the next step may reuse the cache
  x3 = np.random.default_rng(3).integers(0, MASK, (4, L)).astype(np.int32)
  _, _, valid = both(x3, empty, (None, False))
  assert len(calls) == 2 and valid


def _args(*extra):
  return main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--device', 'cpu', '--ckpt_dir',
       '/nonexistent/checkpoints', *extra])


def test_sample_eval_text_dit_gen_ppl_matches_svdd_tpu(text_pair, caplog):
  """The tiny text preset through ``run`` with --gen_ppl_model ar: the
  ddpm_cache decode makes mask-free tokens, and the generative
  perplexity equals JAX's ``compute_generative_perplexity_local`` on the
  same tokens under the same AR weights (bf16 compute, as the JAX scorer
  runs it; JAX compiled vs the port op by op: 1e-4 relative)."""
  _, tdiff, _ = text_pair
  jcfg, tcfg = _text_configs()
  x = np.zeros((1, L), np.int32)
  jar = JaxAR(config=jcfg, vocab_size=VOCAB)
  ar_vars = random_variables(jar.init, jnp.asarray(x), jnp.zeros((1,)),
                             rs=np.random.default_rng(1))
  with caplog.at_level(logging.INFO, logger=main_gosai.__name__):
    out = main_gosai.run(_args('--gen_ppl_model', 'ar'), tcfg,
                         backbone=tdiff.backbone,
                         ar_model=ar_from_jax(ar_vars, tcfg))
  tokens = out['tokens']
  assert tokens.shape == (4, L) and tokens.min() >= 0
  assert tokens.max() < MASK
  assert sum('sample: ' in r.message for r in caplog.records) == 4
  apply = jax.jit(lambda v, toks: jar.apply(v, toks,
                                            jnp.zeros((toks.shape[0],))))
  want = jgen_ppl.compute_generative_perplexity_local(
      tokens, lambda toks: apply(ar_vars, jnp.asarray(toks)))
  assert np.isfinite(out['gen_ppl'])
  np.testing.assert_allclose(out['gen_ppl'], want, rtol=1e-4)
  # the aggregate itself on fixed log-probs, EOS masking included
  rs = np.random.default_rng(4)
  logp = np.log(rs.dirichlet(np.ones(6), size=(3, 9)))
  toks = rs.integers(0, 6, (3, 9))
  for eos in (None, 2):
    np.testing.assert_allclose(
        gen_ppl.compute_generative_perplexity_local(
            toks, lambda _: logp, eos_token_id=eos),
        jgen_ppl.compute_generative_perplexity_local(
            toks, lambda _: logp, eos_token_id=eos), rtol=1e-12)


def test_sample_eval_dimamba_on_cpu():
  """DiMamba on the DNA task (d_model 64, 2 layers, L=24, 8 steps, bf16
  as the preset runs it) through ``run``: two batches of eight
  mask-free DNA tokens, the ddpm predictor."""
  cfg = tiny_test_config('dna', backbone='dimamba')
  cfg.model.d_model, cfg.model.n_layer = 64, 2
  cfg.parallel.precision = 'bf16'
  jcfg = jax_tiny_config('dna')
  jcfg.model.d_model, jcfg.model.n_layer = 64, 2
  from svdd_tpu.models.dimamba import DiMamba as JaxDiMamba
  variables = random_variables(
      JaxDiMamba(config=jcfg, vocab_size=5).init,
      jnp.zeros((1, 24), jnp.int32), jnp.zeros((1,)),
      rs=np.random.default_rng(2))
  out = main_gosai.run(_args(), cfg, backbone=dimamba_from_jax(
      variables, cfg, torch.bfloat16))
  assert out['tokens'].shape == (16, 24) and out['gen_ppl'] is None
  assert set(np.unique(out['tokens'])) <= {0, 1, 2, 3}


def test_batch_dna_detokenize_matches_svdd_tpu():
  toks = np.array([[0, 1, 2, 3, 4, 27, -1, 3]], np.int32)
  assert gosai.batch_dna_detokenize(toks) == jgosai.batch_dna_detokenize(toks)
  assert gosai.batch_dna_detokenize(toks) == ['ACGTNNNT']


@pytest.mark.parametrize('extra,match', [
    (['--eval_oracle_checkpoint_path', 'oracle.ckpt'], 'A17'),
    (['--set', 'parallel.pipeline_stages=2', 'model.hidden_dim=32',
      'model.num_cnn_stacks=1', 'model.length=24', 'sampling.steps=8',
      'loader.eval_batch_size=8', 'sampling.num_sample_batches=1'], None),
    (['--gen_ppl_ar_checkpoint', 'ar.ckpt'], 'A17'),
], ids=['extra0-A17', 'extra1-A16', 'extra2-A17'])
def test_sample_eval_rejects_what_is_not_ported(extra, match):
  """Files of other packages raise, naming A17; the pipeline settings
  (A16.3) are the trainer's alone, and sample_eval runs with them as
  JAX's does."""
  if match is None:
    out = main_gosai.run(_args(*extra))
    assert out['tokens'].shape == (8, 24)
    return
  with pytest.raises(NotImplementedError, match=match):
    main_gosai.run(_args(*extra))


def test_sample_eval_runs_d3pm():
  """``--set parameterization=d3pm`` (tiny widths through ``--set``):
  sample_eval draws from the D3PM denoiser's random weights, its
  noise removal leaving (8, 24) tokens over A, C, G, T."""
  out = main_gosai.run(_args(
      '--set', 'parameterization=d3pm', 'model.hidden_dim=32',
      'model.num_cnn_stacks=1', 'model.length=24', 'sampling.steps=8',
      'loader.eval_batch_size=8', 'sampling.num_sample_batches=1'))
  assert out['tokens'].shape == (8, 24)
  assert set(np.unique(out['tokens'])) <= {0, 1, 2, 3}


def test_sample_eval_rejects_an_existing_checkpoint(tmp_path):
  """A --ckpt_dir holding files but no checkpoint of the port (an orbax
  step directory, a reference .pt) is another package's checkpoint."""
  (tmp_path / '1000').mkdir()
  (tmp_path / 'model.pt').write_bytes(b'not a port checkpoint')
  args = main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--device', 'cpu', '--ckpt_dir',
       str(tmp_path)])
  with pytest.raises(NotImplementedError, match='A17'):
    main_gosai.run(args)
