"""svdd_tpu_torch's semi-AR sampling, AR decode loops, text data layer and
generative perplexity against svdd_tpu.

Samplers are pinned to JAX's on JAX's own Gumbel noise (the keys split as
JAX's loops split them). The Hugging Face pieces run on a small GPT-2
built from a config in code and a tokenizer built in code, saved to a
temporary directory: both packages load them from local files, with the
hub switched off (``HF_HUB_OFFLINE``), so nothing is fetched. f32
throughout; tolerances per test.
"""

import importlib.machinery
import logging
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svdd_tpu.config import tiny_test_config as jax_tiny_config
from svdd_tpu.data import text as jtext
from svdd_tpu.diffusion import Diffusion as JaxDiffusion
from svdd_tpu.eval import gen_ppl as jgen
from svdd_tpu.models.autoregressive import ARModel as JaxAR
from svdd_tpu.models import autoregressive as jar
from svdd_tpu.sampling.semi_ar import semi_ar_sample as jax_semi_ar

from svdd_tpu_torch.cli import main_gosai
from svdd_tpu_torch.config import tiny_test_config
from svdd_tpu_torch.data import text as ttext
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.eval import gen_ppl as tgen
from svdd_tpu_torch.models import autoregressive as tar
from svdd_tpu_torch.sampling.semi_ar import semi_ar_sample
from svdd_tpu_torch.weights import ar_from_jax, cnn_from_jax
from torch_port_helpers import few_torch_threads  # noqa: F401
from torch_port_helpers import perturb, random_cnn_variables, random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
  return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def offline(monkeypatch):
  """No test here may reach the hub."""
  monkeypatch.setenv('HF_HUB_OFFLINE', '1')
  monkeypatch.setenv('HF_DATASETS_OFFLINE', '1')
  monkeypatch.setenv('TRANSFORMERS_OFFLINE', '1')


# ---------------------------------------------------------------------------
# semi-AR sampling
# ---------------------------------------------------------------------------


def _jax_stride_noise(key, num_strides, steps, shape):
  """The Gumbel noise JAX's ``semi_ar_sample`` draws: a key a stride
  split from ``key``, a key a step split from the stride's."""
  out = {}
  for j in range(num_strides + 1):
    key, sub = jax.random.split(key)
    kk = sub
    for i in range(steps + 1):
      kk, s = jax.random.split(kk)
      out[(j, i)] = np.asarray(jax.random.gumbel(s, shape, jnp.float32))
  return out


@pytest.mark.parametrize('dt,stride,strides', [(0.125, 8, 2), (0.25, 4, 1)])
def test_semi_ar_sample_matches_svdd_tpu(dt, stride, strides):
  """The tiny CNN denoiser (L=24, random weights) through both packages'
  ``semi_ar_sample`` on JAX's noise: the denoiser-call count, every
  stride's block and the full samples equal."""
  jcfg, cfg = jax_tiny_config('dna'), tiny_test_config('dna')
  rs = np.random.default_rng(0)
  variables = perturb(random_cnn_variables(jcfg, rs), rs)
  jmodel = JaxDiffusion(jcfg, variables=jax.tree.map(jnp.asarray, variables))
  model = Diffusion(cfg, device='cpu', backbone=cnn_from_jax(variables))
  n, length = 3, cfg.model.length
  key = jax.random.key(1)
  steps, blocks, full = jax_semi_ar(jmodel, n, stride, strides, key, dt=dt)
  noise = _jax_stride_noise(key, strides, int(1 / dt),
                            (n, length, cfg.vocab_size))
  got = semi_ar_sample(model, n, stride, strides, dt=dt,
                       noise=lambda j, i: noise[(j, i)])
  assert got[0] == steps
  assert len(got[1]) == len(blocks) == strides + 2
  for a, b in zip(got[1], blocks):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(got[2], full)
  assert got[2].shape == (n, length + strides * stride)


def test_sample_eval_semi_ar_branch(caplog):
  """``main_gosai --mode sample_eval`` with ``sampling.semi_ar`` samples
  block-wise (the semi-AR branch, no gen-ppl) on the CPU."""
  cfg = tiny_test_config('dna')
  cfg.sampling.semi_ar = True
  cfg.sampling.stride_length = 4
  cfg.sampling.num_strides = 1
  cfg.loader.eval_batch_size = 2
  args = main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--device', 'cpu', '--ckpt_dir', '',
       '--gen_ppl_model', 'ar'])
  with caplog.at_level(logging.INFO):
    out = main_gosai.run(args, cfg)
  assert out['tokens'].shape == (2, 24 + 4) and out['gen_ppl'] is None
  assert out['sampling_steps'] >= 2
  assert 'semi-AR' in caplog.text


# ---------------------------------------------------------------------------
# the AR decode loops
# ---------------------------------------------------------------------------

AR_L, AR_V = 12, 5


def _ar_pair(seed):
  jcfg, cfg = jax_tiny_config('dna'), tiny_test_config('dna')
  for c in (jcfg, cfg):
    c.model.length = AR_L
    c.model.hidden_size, c.model.n_heads, c.model.n_blocks = 128, 2, 2
    c.parallel.precision = 'fp32'
  jmodel = JaxAR(config=jcfg, vocab_size=AR_V, compute_dtype=jnp.float32)
  variables = random_variables(jmodel.init, jnp.zeros((1, AR_L), jnp.int32),
                               jnp.zeros((1,)),
                               rs=np.random.default_rng(seed))
  model = ar_from_jax(variables, cfg, torch.float32)
  return jmodel, jax.tree.map(jnp.asarray, variables), model


def test_ar_samplers_match_svdd_tpu():
  """``ar_sample`` and ``ar_sample_kv`` on JAX's Gumbel noise (the one
  draw of (B, L - 1, V) from the key) give JAX's tokens exactly, and the
  cached loop gives the full one's."""
  jmodel, jvars, model = _ar_pair(2)
  key = jax.random.key(3)
  b = 4
  noise = np.asarray(jax.random.gumbel(key, (b, AR_L - 1, AR_V)))
  want = np.asarray(jar.ar_sample(jmodel, jvars, b, AR_L, key))
  want_kv = np.asarray(jar.ar_sample_kv(jmodel, jvars, b, AR_L, key))
  np.testing.assert_array_equal(want, want_kv)
  got = tar.ar_sample(model, b, AR_L, noise=noise).numpy()
  got_kv = tar.ar_sample_kv(model, b, AR_L, noise=noise).numpy()
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got_kv, want)
  assert (got[:, 0] == 0).all() and len(np.unique(got)) > 1


def test_ar_samplers_draw_their_own_noise():
  """Without injected noise both loops draw it from the generator: the
  same generator seed gives the same tokens in both."""
  _, _, model = _ar_pair(4)
  a = tar.ar_sample(model, 3, AR_L, torch.Generator().manual_seed(5))
  b = tar.ar_sample_kv(model, 3, AR_L, torch.Generator().manual_seed(5))
  np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# data/text.py
# ---------------------------------------------------------------------------


def test_char_tokenizer_and_synthetic_corpus_match_svdd_tpu():
  j, t = jtext.CharTokenizer(), ttext.CharTokenizer()
  s = 'the quick brown fox, 42 jumps'
  np.testing.assert_array_equal(t.encode(s), j.encode(s))
  assert t.decode(t.encode(s)) == j.decode(j.encode(s))
  assert t.batch_decode(np.array([[0, 1, 26, 30]])) == j.batch_decode(
      np.array([[0, 1, 26, 30]]))
  assert t.vocab_size == j.vocab_size == 27
  for split in ('train', 'val'):
    a = ttext.TextDataset(split, length=32, synthetic_chars=2 ** 12)
    b = jtext.TextDataset(split, length=32, synthetic_chars=2 ** 12)
    np.testing.assert_array_equal(a.seqs, b.seqs)
    np.testing.assert_array_equal(a[3]['seqs'], b[3]['seqs'])


def test_text_dataloaders_match_svdd_tpu(tmp_path):
  """The loaders over a text file: the first batches of train and val
  equal, whole and as shard 1 of 2."""
  path = tmp_path / 'corpus.txt'
  path.write_text(' '.join(['alpha beta gamma delta'] * 200))
  cfg, jcfg = tiny_test_config('dna'), jax_tiny_config('dna')
  for c in (cfg, jcfg):
    c.model.length = 16
  t_train, t_val, _ = ttext.get_text_dataloaders(cfg, path=str(path))
  j_train, j_val, _ = jtext.get_text_dataloaders(jcfg, path=str(path))
  for ti, ji in ((t_train, j_train), (t_val, j_val)):
    for _, a, b in zip(range(2), iter(ti), iter(ji)):
      np.testing.assert_array_equal(a['seqs'], b['seqs'])
  t_train, _, _ = ttext.get_text_dataloaders(cfg, path=str(path),
                                             num_shards=2, shard_index=1)
  j_train, _, _ = jtext.get_text_dataloaders(jcfg, path=str(path),
                                             num_shards=2, shard_index=1)
  for _, a, b in zip(range(2), iter(t_train), iter(j_train)):
    np.testing.assert_array_equal(a['seqs'], b['seqs'])


def test_detokenizers_and_group_and_wrap_match_svdd_tpu():
  samples = ["it 's a test @-@ case , with ( spaces ) and \" quotes \" .",
             "the cat 's hat n't here \n . $ 1 <unk>",
             "http : / / x . org ? yes ! \" a b \" ' c d ' [ e ]",
             '= = = heading = = = ' + chr(176) + ' N']
  assert set(ttext.DETOKENIZERS) == set(jtext.DETOKENIZERS)
  for name, fn in ttext.DETOKENIZERS.items():
    for s in samples:
      assert fn(s) == jtext.DETOKENIZERS[name](s), (name, s)
  for fn in ('wt_detokenizer', 'ptb_detokenizer', 'lm1b_detokenizer',
             'lambada_detokenizer', 'scientific_papers_detokenizer'):
    for s in samples:
      assert getattr(ttext, fn)(s) == getattr(jtext, fn)(s)
  docs = [[5, 6, 7], [8, 9], [10, 11, 12, 13, 14], [15]]
  got = ttext.group_and_wrap(docs, 5, bos=1, eos=2)
  want = jtext.group_and_wrap(docs, 5, bos=1, eos=2)
  for k in ('input_ids', 'attention_mask'):
    np.testing.assert_array_equal(got[k], want[k])


DNA_VOCAB = ['[PAD]', '[BOS]', '[EOS]', '[UNK]', 'A', 'C', 'G', 'T', 'N',
             'the', 'cat', 'sat', 'on', 'mat', 'a', 'dog']


def _tokenizer(char_level: bool = True, pad: bool = True):
  """A fast tokenizer built in code: a BPE without merges over single
  characters and a few words (so a DNA string splits into its bases)."""
  import tokenizers
  import transformers
  vocab = {w: i for i, w in enumerate(DNA_VOCAB)}
  model = tokenizers.models.BPE(vocab=vocab, merges=[], unk_token='[UNK]')
  tok = tokenizers.Tokenizer(model)
  tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
  kwargs = dict(tokenizer_object=tok, bos_token='[BOS]', eos_token='[EOS]',
                unk_token='[UNK]')
  if pad:
    kwargs['pad_token'] = '[PAD]'
  return transformers.PreTrainedTokenizerFast(**kwargs)


def test_hf_text_pipeline_matches_svdd_tpu():
  """``prepare_hf_tokenizer`` (the [PAD] token added where missing) and
  ``tokenize_texts`` wrapped and padded, on a tokenizer built in code."""
  texts = ['the cat sat on a mat', 'a dog', 'the dog sat on the cat', 'cat']
  for wrap in (True, False):
    t_tok = ttext.prepare_hf_tokenizer(_tokenizer(pad=False))
    j_tok = jtext.prepare_hf_tokenizer(_tokenizer(pad=False))
    assert t_tok.pad_token == j_tok.pad_token == '[PAD]'
    got = ttext.tokenize_texts(texts, t_tok, wrap=wrap, block_size=6)
    want = jtext.tokenize_texts(texts, j_tok, wrap=wrap, block_size=6)
    for k in ('input_ids', 'attention_mask'):
      np.testing.assert_array_equal(got[k], want[k])
      assert got[k].dtype == want[k].dtype


def test_get_tokenizer_reads_local_files_only(tmp_path):
  """A tokenizer saved to a directory loads by path in both packages; a
  name with no local files raises ``RuntimeError`` (nothing fetched)."""
  _tokenizer().save_pretrained(tmp_path)
  t, j = ttext.get_tokenizer(str(tmp_path)), jtext.get_tokenizer(
      str(tmp_path))
  assert t('the cat')['input_ids'] == j('the cat')['input_ids']
  assert isinstance(ttext.get_tokenizer('text8'), ttext.CharTokenizer)
  with pytest.raises(RuntimeError, match='local'):
    ttext.get_tokenizer('no-such-tokenizer-anywhere')


def _fake_datasets(texts, fail=False):
  """A stand-in ``datasets`` module whose ``load_dataset`` returns
  ``texts`` as a one-split dataset (or raises)."""

  class _DS:
    def __init__(self, rows):
      self.rows = rows

    def __len__(self):
      return len(self.rows)

    def select(self, idx):
      return _DS([self.rows[i] for i in idx])

    def __getitem__(self, field):
      assert field == 'text'
      return list(self.rows)

  mod = types.ModuleType('datasets')
  # a spec, as the import system's lookups (transformers') expect one
  mod.__spec__ = importlib.machinery.ModuleSpec('datasets', None)

  def load_dataset(*args, **kwargs):
    if fail:
      raise FileNotFoundError('no local copy')
    return {'train': _DS(texts)}

  mod.load_dataset = load_dataset
  return mod


def test_get_hf_text_dataset_matches_svdd_tpu(monkeypatch):
  """``get_hf_text_dataset`` over a local dataset (a stand-in ``datasets``
  module): the wrapped blocks equal JAX's, with the dataset's
  detokenizer and ``max_docs``; a load that fails raises
  ``RuntimeError``; an unknown name ``KeyError``."""
  texts = ['the cat @-@ sat', 'on a mat', 'a dog', 'the cat sat on a dog']
  toks = [_tokenizer() for _ in range(4)]
  monkeypatch.setitem(sys.modules, 'datasets', _fake_datasets(texts))
  got = ttext.get_hf_text_dataset('wikitext2', toks[0], block_size=5,
                                  max_docs=3)
  want = jtext.get_hf_text_dataset('wikitext2', toks[1], block_size=5,
                                   max_docs=3)
  np.testing.assert_array_equal(got['input_ids'], want['input_ids'])
  assert got['input_ids'].shape[0] >= 1
  monkeypatch.setitem(sys.modules, 'datasets',
                      _fake_datasets(texts, fail=True))
  with pytest.raises(RuntimeError):
    ttext.get_hf_text_dataset('wikitext2', toks[2])
  with pytest.raises(KeyError):
    ttext.get_hf_text_dataset('no_such_set', toks[3])


# ---------------------------------------------------------------------------
# generative perplexity
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def hf_dir(tmp_path_factory):
  """A small GPT-2 (built from a config in code, random weights from
  torch seed 0) and the tokenizer above, saved as a local model
  directory."""
  import transformers
  path = tmp_path_factory.mktemp('tiny_gpt2')
  cfg = transformers.GPT2Config(vocab_size=len(DNA_VOCAB), n_positions=64,
                                n_embd=16, n_layer=1, n_head=2,
                                eos_token_id=2, bos_token_id=1)
  torch.manual_seed(0)
  transformers.GPT2LMHeadModel(cfg).eval().save_pretrained(path)
  _tokenizer().save_pretrained(path)
  return str(path)


def test_hf_gen_ppl_matches_svdd_tpu(hf_dir):
  """``compute_generative_perplexity`` by local path (text retokenized,
  padded to the longest, the short last batch covered) and on token
  samples with objects passed: equal to JAX's to 1e-6 relative."""
  texts = ['ACGTACGTAA', 'GGGTTTACN', 'ACGT', 'TTTTACGACGATCG', 'CAT']
  got = tgen.compute_generative_perplexity(
      texts, eval_model_name_or_path=hf_dir, max_length=12, batch_size=2)
  want = jgen.compute_generative_perplexity(
      texts, eval_model_name_or_path=hf_dir, max_length=12, batch_size=2)
  np.testing.assert_allclose(got, want, rtol=1e-6)
  model, tok = tgen.load_eval_model(hf_dir)
  toks = np.random.default_rng(0).integers(4, 9, (3, 10))
  toks[:, -2:] = 2
  a = tgen.compute_generative_perplexity(eval_model=model, tokenizer=tok,
                                         token_samples=toks)
  b = jgen.compute_generative_perplexity(eval_model=model, tokenizer=tok,
                                         token_samples=toks)
  np.testing.assert_allclose(a, b, rtol=1e-6)
  assert np.isfinite(a) and a > 1
  ids, mask, ctx = tgen.retokenize(tok, texts, 12)
  jids, jmask, jctx = jgen.retokenize(tok, texts, 12)
  assert ctx == jctx == 1024
  np.testing.assert_array_equal(ids.numpy(), jids.numpy())
  np.testing.assert_array_equal(mask.numpy(), jmask.numpy())


def test_load_eval_model_raises_runtime_error_without_local_files():
  with pytest.raises(RuntimeError, match='local files'):
    tgen.load_eval_model('no-such-model-anywhere-xyz')


def _sample_eval_args(*extra):
  return main_gosai.parser().parse_args(
      ['--mode', 'sample_eval', '--device', 'cpu', '--ckpt_dir', '',
       *extra])


def _tiny_sample_cfg():
  cfg = tiny_test_config('dna')
  cfg.loader.eval_batch_size = 4
  cfg.sampling.num_sample_batches = 1
  cfg.sampling.steps = 4
  return cfg


def test_sample_eval_scores_with_the_named_hf_model(hf_dir, caplog):
  """``--gen_ppl_model DIR``: the samples' DNA strings scored by the
  local HF model, as ``compute_generative_perplexity`` scores them."""
  with caplog.at_level(logging.INFO):
    out = main_gosai.run(_sample_eval_args('--gen_ppl_model', hf_dir),
                         _tiny_sample_cfg())
  from svdd_tpu_torch.data import gosai
  want = tgen.compute_generative_perplexity(
      gosai.batch_dna_detokenize(out['tokens']),
      eval_model_name_or_path=hf_dir, max_length=24)
  np.testing.assert_allclose(out['gen_ppl'], want, rtol=1e-9)
  assert f'val/gen_ppl ({hf_dir})' in caplog.text
  assert 'falling back' not in caplog.text


def test_sample_eval_falls_back_to_ar_on_runtime_error(caplog):
  """A model name with no local files: the RuntimeError is logged and the
  AR scorer (random, seed 0) scores the samples, as ``--gen_ppl_model
  ar`` does."""
  cfg = _tiny_sample_cfg()
  with caplog.at_level(logging.INFO):
    out = main_gosai.run(_sample_eval_args('--gen_ppl_model',
                                           'no-such-model-xyz'), cfg)
  assert 'falling back to the local AR backbone' in caplog.text
  ar = main_gosai.run(_sample_eval_args('--gen_ppl_model', 'ar'), cfg)
  np.testing.assert_array_equal(out['tokens'], ar['tokens'])
  np.testing.assert_allclose(out['gen_ppl'], ar['gen_ppl'], rtol=1e-12)


def test_sample_eval_scoring_fault_propagates(hf_dir, monkeypatch, caplog):
  """A fault while the loaded HF model scores (a device fault on the card
  is a ``RuntimeError`` too) is raised, not turned into the AR scorer's
  perplexity: only ``load_eval_model``'s error falls back."""
  def fail(*args, **kwargs):
    raise RuntimeError('device fault while scoring')

  monkeypatch.setattr(tgen, 'compute_generative_perplexity', fail)
  with caplog.at_level(logging.INFO):
    with pytest.raises(RuntimeError, match='device fault while scoring'):
      main_gosai.run(_sample_eval_args('--gen_ppl_model', hf_dir),
                     _tiny_sample_cfg())
  assert 'falling back' not in caplog.text


def test_ar_gen_ppl_reads_the_ports_ar_training_checkpoint(tmp_path):
  """``main_gosai --mode train`` of the AR baseline (2 steps) writes a
  checkpoint that ``--gen_ppl_ar_checkpoint`` reads: the scorer holds its
  EMA weights, and the perplexity is theirs."""
  cfg = tiny_test_config('dna', backbone='ar', parameterization='ar')
  cfg.checkpointing.every_n_steps = 2
  cfg.eval.val_check_interval = 2
  ckpt = tmp_path / 'ar'
  args = main_gosai.parser().parse_args(
      ['--mode', 'train', '--device', 'cpu', '--ckpt_dir', str(ckpt),
       '--log_dir', str(tmp_path / 'log'), '--max_steps', '2',
       '--no_sample_eval'])
  state = main_gosai.run(args, cfg)['state']
  assert state.step == 2
  scorer_model = tgen.load_ar_scorer(str(ckpt), cfg, 'cpu')
  shadow = state.ema.shadow
  for name, p in scorer_model.named_parameters():
    np.testing.assert_array_equal(p.detach().numpy(), shadow[name].numpy())
  sample_cfg = _tiny_sample_cfg()
  out = main_gosai.run(_sample_eval_args(
      '--gen_ppl_model', 'ar', '--gen_ppl_ar_checkpoint', str(ckpt)),
      sample_cfg)
  want = tgen.compute_generative_perplexity_local(
      out['tokens'], tgen.ar_fallback_scorer(sample_cfg, device='cpu',
                                             model=scorer_model))
  np.testing.assert_allclose(out['gen_ppl'], want, rtol=1e-12)
