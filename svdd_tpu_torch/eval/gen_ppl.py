"""Generative perplexity (``svdd_tpu/eval/gen_ppl.py``): under an external
causal language model of the Hugging Face library
(``compute_generative_perplexity``, ``load_eval_model``, ``retokenize``),
or under the repo's own AR backbone (``ar_fallback_scorer``,
``compute_generative_perplexity_local``), with ``PerplexityAggregate``.

The external model is loaded by name from local files only: a name not
in the local cache raises ``RuntimeError`` at once, where JAX's loader
would try the hub next, and ``main_gosai --mode sample_eval`` then
falls back to the AR scorer, as the JAX CLI does on that error. The
external model runs on the device the caller names.

The AR scorer reads ``--gen_ppl_ar_checkpoint``: a pretraining checkpoint
of this package whose backbone is the AR net (``main_gosai --mode train
--set backbone=ar parameterization=ar``; its EMA weights), or an export
of the JAX package's AR variables (``scripts/export_jax_checkpoint.py``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from svdd_tpu_torch import checkpoint as ckpt_lib
from svdd_tpu_torch import weights
from svdd_tpu_torch.config import Config
from svdd_tpu_torch.models.autoregressive import ARModel


@dataclass
class PerplexityAggregate:
  """exp(sum nll / count) over masked token NLLs."""
  total_nll: float = 0.0
  total_count: float = 0.0

  def update(self, nlls, mask) -> None:
    nlls = np.asarray(nlls, dtype=np.float64)
    mask = np.asarray(mask, dtype=np.float64)
    self.total_nll += float((nlls * mask).sum())
    self.total_count += float(mask.sum())

  def compute(self) -> float:
    if self.total_count == 0:
      return float('nan')
    return math.exp(self.total_nll / self.total_count)


def load_eval_model(name_or_path: str):
  """(AutoModelForCausalLM, AutoTokenizer) of ``name_or_path`` from local
  files only; ``RuntimeError`` where they cannot be loaded (no
  ``transformers``, no local copy)."""
  try:
    import transformers
    tokenizer = transformers.AutoTokenizer.from_pretrained(
        name_or_path, local_files_only=True)
    model = transformers.AutoModelForCausalLM.from_pretrained(
        name_or_path, local_files_only=True).eval()
    return model, tokenizer
  except Exception as exc:                        # noqa: BLE001
    raise RuntimeError(
        f'could not load eval model {name_or_path!r} from local files; '
        f'pass eval_model/tokenizer objects directly ({exc})') from exc


def retokenize(tokenizer, text_samples: Sequence[str], max_length: int):
  """Pad and truncate with the eval tokenizer: (input_ids,
  attention_mask, the eval context: 4096 for llama2-family names, else
  1024)."""
  os.environ['TOKENIZERS_PARALLELISM'] = 'false'
  name = getattr(tokenizer, 'name_or_path', '') or ''
  eval_context_size = 4096 if 'llama2' in name else 1024
  batch = tokenizer(list(text_samples), return_tensors='pt',
                    return_token_type_ids=False,
                    return_attention_mask=True, truncation=True,
                    padding=True, max_length=max_length)
  return batch['input_ids'], batch['attention_mask'], eval_context_size


def compute_generative_perplexity(
    text_samples: Optional[List[str]] = None, *, eval_model=None,
    tokenizer=None, eval_model_name_or_path: str = 'gpt2',
    token_samples=None, max_length: int = 1024, batch_size: int = 8,
    metric: Optional[PerplexityAggregate] = None, device='cpu') -> float:
  """Perplexity of generated text under an external causal LM: the text
  retokenized by ``tokenizer`` (or ``token_samples`` as they are, the
  whole row attended), run in rows of ``batch_size`` (the last short
  one included) and context-size chunks, the token NLLs of every
  non-EOS token plus the first EOS aggregated."""
  if eval_model is None or tokenizer is None:
    eval_model, tokenizer = load_eval_model(eval_model_name_or_path)
  eval_model = eval_model.eval()
  device = torch.device(device)
  if device.type != 'cpu':
    eval_model = eval_model.to(device)
  if token_samples is not None:
    samples = torch.as_tensor(token_samples)
    attn_mask = torch.ones_like(samples)
    eval_context_size = samples.shape[-1]
  else:
    samples, attn_mask, eval_context_size = retokenize(
        tokenizer, text_samples, max_length=max_length)
  metric = metric if metric is not None else PerplexityAggregate()
  eos = tokenizer.eos_token_id
  batch_size = min(batch_size, samples.shape[0])
  with torch.no_grad():
    for s in range(0, samples.shape[0], batch_size):
      rows = slice(s, min(s + batch_size, samples.shape[0]))
      for chunk, mask_chunk in zip(
          torch.split(samples[rows], eval_context_size, dim=-1),
          torch.split(attn_mask[rows], eval_context_size, dim=-1)):
        chunk, mask_chunk = chunk.to(device), mask_chunk.to(device)
        logits = eval_model(chunk, attention_mask=mask_chunk)[0]
        nlls = F.cross_entropy(logits[:, :-1].transpose(-1, -2),
                               chunk[:, 1:], reduction='none')
        first_eos = (chunk == eos).cumsum(-1) == 1
        token_mask = chunk != eos
        metric.update(nlls.cpu().numpy(),
                      (first_eos[:, 1:] | token_mask[:, 1:]).cpu().numpy())
  return metric.compute()


def ar_checkpoint(path: str):
  """(export, port file) that ``--gen_ppl_ar_checkpoint`` names, one of
  them None: an export of the JAX package's variables, or this package's
  pretraining checkpoint (a ``step_<n>.pt`` or its directory). Anything
  else raises ``NotImplementedError`` naming A17."""
  from svdd_tpu_torch.train import diffusion as train_diff
  export = ckpt_lib.export_in(path, ('variables', 'diffusion'))
  if export is not None:
    return export, None
  found = train_diff.checkpoint_file(path)
  if found is not None and ckpt_lib.port_format(found) == train_diff.FORMAT:
    return None, found
  if ckpt_lib.is_orbax_dir(path):
    raise NotImplementedError(
        ckpt_lib.orbax_message('--gen_ppl_ar_checkpoint', path))
  raise NotImplementedError(
      f'--gen_ppl_ar_checkpoint {path}: not a pretraining checkpoint of '
      f'this package ({train_diff.FORMAT}) nor an export of the JAX '
      "package's (ROADMAP A17: scripts/export_jax_checkpoint.py writes one)")


def load_ar_scorer(path: str, cfg: Config, device='cuda') -> ARModel:
  """The AR net ``--gen_ppl_ar_checkpoint`` names (``ar_checkpoint``), at
  ``cfg``'s widths, computing in bf16 (the JAX scorer's ARModel
  default): the export's variables, or the EMA weights of the port's
  pretraining checkpoint of an AR backbone."""
  from svdd_tpu_torch.train import diffusion as train_diff
  device = torch.device(device)
  export, found = ar_checkpoint(path)
  if export is not None:
    return weights.ar_from_jax(ckpt_lib.load_export(export).tree, cfg,
                               torch.bfloat16, device).eval()
  model = ARModel(cfg, cfg.vocab_size,
                  generator=torch.Generator(device).manual_seed(0))
  shadow = train_diff._load(found)['ema']['shadow']
  with torch.no_grad():
    for name, p in model.named_parameters():
      p.copy_(shadow[name])
  return model.eval()


def ar_fallback_scorer(cfg: Config, checkpoint_path: Optional[str] = None,
                       device='cuda', model: Optional[ARModel] = None):
  """``log_prob_fn(tokens) -> (B, L, V)`` log-probs (numpy) of the AR
  backbone over the task vocab, at ``cfg``'s widths and bf16 compute
  (the JAX scorer's ARModel default): ``model``, else the net of
  ``checkpoint_path`` (``load_ar_scorer``), else one drawn at random
  from seed 0."""
  device = torch.device(device)
  if model is None and checkpoint_path:
    model = load_ar_scorer(checkpoint_path, cfg, device)
  if model is None:
    model = ARModel(cfg, cfg.vocab_size,
                    generator=torch.Generator(device).manual_seed(0))
  model = model.to(device).eval()

  def log_prob_fn(tokens):
    with torch.inference_mode():
      toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                             device=device)
      return model(toks).cpu().numpy()

  return log_prob_fn


def compute_generative_perplexity_local(
    token_samples, log_prob_fn, eos_token_id: Optional[int] = None,
    batch_size: int = 64,
    metric: Optional[PerplexityAggregate] = None) -> float:
  """Generative perplexity under a local causal LM returning (B, L, V)
  log-probs, scored in chunks of ``batch_size`` rows: the next-token
  NLLs, every position counted when ``eos_token_id`` is None (the DNA
  vocab has no EOS), else the non-EOS tokens plus the first EOS."""
  tokens = np.asarray(token_samples)
  metric = metric if metric is not None else PerplexityAggregate()
  for s in range(0, tokens.shape[0], batch_size):
    chunk = tokens[s:s + batch_size]
    logp = np.asarray(log_prob_fn(chunk), dtype=np.float64)
    nll = -np.take_along_axis(
        logp[:, :-1], chunk[:, 1:, None], axis=-1)[..., 0]
    if eos_token_id is None:
      mask = np.ones_like(nll)
    else:
      first_eos = np.cumsum(chunk == eos_token_id, axis=-1) == 1
      token_mask = chunk != eos_token_id
      mask = (first_eos | token_mask)[:, 1:]
    metric.update(nll, mask)
  return metric.compute()
