"""Value-net accuracy evaluation CLI (``svdd_tpu/cli/eval.py``).

  python -m svdd_tpu_torch.cli.eval --task dna --batch_size 64 \
      --load_checkpoint_path value.pt --reward_checkpoint_path oracle.pt \
      --diffusion_checkpoint_path ckpt/step_40.pt

Draws ``--val_batch_num`` unguided batches from the denoiser and holds
the value net's predictions on the final samples against the oracle's
rewards: the streaming Pearson correlation and the MSE, logged and
appended to ``{out_dir}/{run_name}.metrics.jsonl``. Float32 with TF32
off unless the bf16 switches are set.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch import value as value_lib
from svdd_tpu_torch.cli import common
from svdd_tpu_torch.eval.metrics import PearsonState
from svdd_tpu_torch.observability import MetricsLogger

LOGGER = logging.getLogger(__name__)


def run(args, cfg=None, value_kwargs=None) -> dict:
  """Evaluate; ``cfg`` and ``value_kwargs`` replace the full-size DNA
  models, for tests. Returns the Pearson correlation, the MSE and the
  number of rows."""
  common.reject_unported(args)
  common.full_f32()
  cfg = cfg or common.task_config(args)
  diffusion = common.load_diffusion(args, cfg)
  reward_fn = common.load_reward_fn(args, cfg)
  vf = common.load_value_function(args, cfg, **(value_kwargs or {}))
  # the saluki oracle reads the padded six-channel input, the value net
  # the one-hot
  saluki = common.saluki_kwargs(args)
  transform = value_lib.make_reward_transform(
      args.task, saluki['saluki_body'], saluki['saluki_final_length'])

  sampler = diffusion.sampler(args.batch_size)
  gen = torch.Generator(diffusion.device).manual_seed(args.seed)
  pearson = PearsonState.init(1, diffusion.device)
  preds_all, targets_all = [], []
  for i in range(args.val_batch_num):
    samples = sampler(gen).samples
    with torch.inference_mode():
      target = reward_fn(transform(samples))
      pred = vf.score_onehot(mdlm.transform_samples(samples))
    pearson = pearson.update(target, pred)
    preds_all.append(pred.float().cpu().numpy())
    targets_all.append(target.float().cpu().numpy())
    LOGGER.info('batch %d pearson so far %.4f', i, float(pearson.compute()))
  preds = np.concatenate(preds_all)
  targets = np.concatenate(targets_all)
  out = {'pearson': float(pearson.compute()),
         'mse': float(np.mean((preds - targets) ** 2)), 'n': int(preds.size)}
  LOGGER.info('final pearson %.4f  MSE %.5f (n=%d)', out['pearson'],
              out['mse'], out['n'])
  logger = MetricsLogger(log_dir=args.out_dir, run_name=args.run_name
                         or f'{args.task}-{args.reward_name}-eval')
  logger.log({f'eval/{k}': v for k, v in out.items()})
  logger.finish()
  return out


def parser():
  return common.make_parser('value-net accuracy evaluation')


def main() -> None:
  logging.basicConfig(level=logging.INFO)
  run(parser().parse_args())


if __name__ == '__main__':
  main()
