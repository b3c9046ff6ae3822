"""Diffusion pretraining entry, ``sample_eval`` mode
(``svdd_tpu/cli/main_gosai.py``): the same flags and defaults, plus
``--device``.

  python -m svdd_tpu_torch.cli.main_gosai --mode sample_eval \
      --config svdd_tpu_torch/configs/text_mdlm.yaml --gen_ppl_model ar
  python -m svdd_tpu_torch.cli.main_gosai --mode sample_eval \
      --set backbone=dimamba

``sample_eval`` draws ``sampling.num_sample_batches`` batches of
``loader.eval_batch_size`` unguided samples (the ``sampling.predictor``,
ddpm or ddpm_cache), logs the first four of each batch through the DNA
detokenizer and, with ``--gen_ppl_model``, their generative perplexity
under the repo's AR backbone. The model takes random weights from
``seed``; the train and ppl_eval modes, checkpoints and the Hugging Face
scorer are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from svdd_tpu_torch.cli import common
from svdd_tpu_torch.config import Config, dna_config
from svdd_tpu_torch.data import gosai
from svdd_tpu_torch.diffusion import Diffusion
from svdd_tpu_torch.eval import gen_ppl

LOGGER = logging.getLogger(__name__)


def parse_overrides(pairs):
  """['a.b=1', ...] -> {'a': {'b': 1}}, values parsed as JSON where
  they are JSON."""
  out = {}
  for pair in pairs or []:
    k, v = pair.split('=', 1)
    cur = out
    parts = k.split('.')
    for p in parts[:-1]:
      cur = cur.setdefault(p, {})
    try:
      v = json.loads(v)
    except json.JSONDecodeError:
      pass
    cur[parts[-1]] = v
  return out


def build_config(args) -> Config:
  if args.config:
    cfg = Config.from_yaml(args.config)
  elif args.task == 'rna':
    raise NotImplementedError('--task rna: the RNA task is not ported yet '
                              '(ROADMAP A10)')
  else:
    cfg = dna_config()
  overrides = parse_overrides(args.set)
  return cfg.override(**overrides) if overrides else cfg


def _reject_unported(args) -> None:
  if args.mode != 'sample_eval':
    raise NotImplementedError(f'--mode {args.mode}: diffusion training and '
                              'ppl_eval are not ported yet (ROADMAP A12)')
  if args.ckpt_dir and os.path.exists(args.ckpt_dir):
    raise NotImplementedError(f'--ckpt_dir {args.ckpt_dir}: checkpoint '
                              'loading is not ported yet (ROADMAP A17)')
  if args.gen_ppl_ar_checkpoint:
    raise NotImplementedError('--gen_ppl_ar_checkpoint: checkpoint loading '
                              'is not ported yet (ROADMAP A17)')


def run(args, cfg: Config | None = None, backbone=None, ar_model=None
        ) -> dict:
  """``sample_eval``. ``cfg`` replaces the config the flags build;
  ``backbone`` and ``ar_model`` replace the randomly initialised
  denoiser and gen-ppl scorer (tests). Returns {'tokens': (N, L) int
  array of every batch, 'gen_ppl': float or None}."""
  _reject_unported(args)
  cfg = cfg or build_config(args)
  LOGGER.info('config:\n%s', json.dumps(cfg.to_dict(), indent=2,
                                        default=str))
  if args.ckpt_dir:
    LOGGER.warning('no checkpoint under --ckpt_dir %s: sampling from a '
                   'randomly initialized model', args.ckpt_dir)
  common.full_f32()
  model = Diffusion(cfg, device=args.device, backbone=backbone)
  sampler = model.sampler(cfg.loader.eval_batch_size)
  all_tokens = []
  for i in range(cfg.sampling.num_sample_batches):
    res = sampler(torch.Generator(model.device).manual_seed(i))
    tokens = res.samples.cpu().numpy()
    all_tokens.append(tokens)
    for s in gosai.batch_dna_detokenize(tokens[:4]):
      LOGGER.info('sample: %s', s)
  tokens = np.concatenate(all_tokens)
  ppl = None
  if args.gen_ppl_model:
    if args.gen_ppl_model != 'ar':
      LOGGER.warning('gen_ppl: the Hugging Face model %r is not ported; '
                     'falling back to the local AR backbone',
                     args.gen_ppl_model)
    if ar_model is None:
      LOGGER.warning('gen_ppl AR fallback: no --gen_ppl_ar_checkpoint, '
                     'scoring with a randomly initialized AR net')
    scorer = gen_ppl.ar_fallback_scorer(cfg, args.gen_ppl_ar_checkpoint,
                                        device=model.device, model=ar_model)
    ppl = gen_ppl.compute_generative_perplexity_local(tokens, scorer)
    LOGGER.info('val/gen_ppl (local ar backbone): %.4f', ppl)
  return {'tokens': tokens, 'gen_ppl': ppl}


def parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description='MDLM diffusion pretraining')
  p.add_argument('--task', default='dna', choices=['dna', 'rna'])
  p.add_argument('--mode', default='train',
                 choices=['train', 'ppl_eval', 'sample_eval'])
  p.add_argument('--config', default=None,
                 help='yaml config overlay (needs PyYAML)')
  p.add_argument('--set', nargs='*', default=None,
                 help='dotted overrides, e.g. sampling.steps=64')
  p.add_argument('--ckpt_dir', default='./checkpoints',
                 help='an existing directory raises (checkpoint loading '
                      'is not ported); a missing one means random weights')
  p.add_argument('--data_dir', default=None)
  p.add_argument('--max_steps', type=int, default=None)
  p.add_argument('--shard_data', action='store_true', default=False)
  p.add_argument('--log_dir', default='./log')
  p.add_argument('--no_sample_eval', action='store_true', default=False)
  p.add_argument('--eval_oracle_checkpoint_path', default=None)
  p.add_argument('--gen_ppl_model', default=None,
                 help="'ar' scores the samples with the repo's own AR "
                      'backbone; any other name falls back to it (the '
                      'Hugging Face path is not ported)')
  p.add_argument('--gen_ppl_ar_checkpoint', default=None,
                 help='not ported yet: raises')
  p.add_argument('--device', type=str, default='cuda',
                 help="torch device of the run ('cuda' or 'cpu')")
  return p


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
