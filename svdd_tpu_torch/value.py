"""Value-function API and value-net training targets
(``svdd_tpu/value.py``): the value-net factory, the bundle whose
``score_tokens`` the guided samplers call, the reward oracle's input,
the MC and CD-Q regression targets and the MSE objective, and the
value net's checkpoint file.

A value net or reward oracle that ``cli.train`` or ``cli.train_oracle``
saved is one ``torch.save`` dict (``save_checkpoint``): the format tag,
the task whose architecture it holds ('dna': the Enformer, 'rna': the
ConvGRU; a file without the key is a DNA one), the module's
constructor arguments (``config()``) and its state dict (parameters and
BatchNorm running statistics). ``load_checkpoint`` reads it back; it
raises ``NotImplementedError`` naming ROADMAP A17 for any other file
(an orbax directory; the CLIs' checkpoint flags import a reference
``.pt`` through ``importers/``, and read an export of the JAX package's
checkpoints, before they get here), and ``ValueError``
naming both tasks for a file of the other task.

The value-net factory builds the Enformer and its timed variant
(``timed=True``, or ``model='timedenformer'``): the multisep model's
trunks are Enformers (or ConvGRUs) that ``models/multisep.py`` holds.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from svdd_tpu_torch import mdlm
from svdd_tpu_torch.models.convgru import ConvGRUValueModel
from svdd_tpu_torch.models.enformer import EnformerValueModel

FORMAT = 'svdd_tpu_torch.value/1'
RNA_TASKS = ('rna', 'rna_saluki')
_ARCH = {'dna': 'Enformer', 'rna': 'ConvGRU'}   # a checkpoint's task's net


def checkpoint_task(task: str) -> str:
  """The architecture family of ``task``'s value nets and oracles:
  'rna' (ConvGRU) or 'dna' (Enformer)."""
  return 'rna' if task in RNA_TASKS else 'dna'


def value_compute_dtype() -> torch.dtype:
  """The Enformer value net's compute dtype where the caller gives none:
  bfloat16 under SVDD_VALUE_BF16=1, else float32."""
  return (torch.bfloat16 if os.environ.get('SVDD_VALUE_BF16') == '1'
          else torch.float32)


def check_value_model(task: str, model: str, timed: bool = False) -> None:
  """Raise as ``ValueFunction.create(task, model=model, timed=timed)``
  raises, before any module is built: a DNA model other than 'enformer'
  and 'timedenformer' (``NotImplementedError``, as JAX's factory), and a
  timed model without ``timed`` (JAX's init without time indices:
  ``ValueError``, which JAX's CLIs raise for ``--model timedenformer``).
  The RNA tasks, 'rna' and 'rna_saluki', take the ConvGRU whatever
  ``model`` says."""
  if task in RNA_TASKS:
    return
  if task != 'dna' or model not in ('enformer', 'timedenformer'):
    raise NotImplementedError(
        f'value model {model!r} for task {task!r}: the factory builds '
        "'enformer' and 'timedenformer', as the JAX package's does")
  if model == 'timedenformer' and not timed:
    raise ValueError('timed model requires time_indices')


def build_value_module(task: str, model: str = 'enformer',
                       n_tasks: int = 1,
                       generator: torch.Generator | None = None,
                       timed: bool = False, **kwargs):
  """Value-net factory (``svdd_tpu/value.py:build_value_module``): the
  RNA tasks take the four-channel ConvGRU whatever ``model`` says (the
  saluki task's value net sees (N, L, 4) states; only its oracle reads
  the six-channel input), in float32, as JAX
  returns it before reading SVDD_VALUE_BF16; DNA the Enformer
  (``model`` 'enformer', timed with ``timed``, or 'timedenformer',
  timed always), which without a ``compute_dtype`` computes in bfloat16
  under SVDD_VALUE_BF16=1, else in float32. Any other ``model`` raises
  ``NotImplementedError`` as JAX's factory does ('multienformer': its
  trunks are built by ``cli.train --model multienformer``). ``kwargs``:
  the module's constructor arguments (widths)."""
  check_value_model(task, model, timed=True)
  if task in RNA_TASKS:
    return ConvGRUValueModel(n_tasks=n_tasks, generator=generator, **kwargs)
  kwargs.setdefault('compute_dtype', value_compute_dtype())
  return EnformerValueModel(n_tasks=n_tasks, generator=generator,
                            timed=timed or model == 'timedenformer',
                            **kwargs)


class ValueFunction:
  """A value module scoring token sequences (eval mode; the trainers
  call the module with ``train=True``). ``timed``: the scores take each
  state's step index (``time_indices``)."""

  def __init__(self, module, length: int, timed: bool = False):
    self.module = module.eval()
    self.length = length
    self.timed = timed

  @classmethod
  def create(cls, task: str, length: int, generator: torch.Generator,
             model: str = 'enformer', n_tasks: int = 1, timed: bool = False,
             **kwargs) -> 'ValueFunction':
    """As ``svdd_tpu/value.py:ValueFunction.create``, whose module init
    without time indices raises for a timed module: ``model=
    'timedenformer'`` with ``timed`` False raises the same
    ``ValueError``, as JAX's CLIs do for ``--model timedenformer``."""
    check_value_model(task, model, timed)
    return cls(build_value_module(task, model, n_tasks, generator, timed,
                                  **kwargs), length, timed)

  def score_onehot(self, onehot4: torch.Tensor, fused: bool = True,
                   time_indices: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """(N, L, 4) one-hot -> (N,) value; ``fused=False`` takes the
    differentiable tower; ``time_indices`` (N, L) the steps of a timed
    net."""
    if self.timed:
      return self.module(onehot4, fused, time_indices=time_indices)
    return self.module(onehot4, fused)

  def score_tokens(self, tokens: torch.Tensor,
                   time_indices: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """(N, L) tokens (MASK rows zeroed in the one-hot) -> (N,)."""
    return self.score_onehot(mdlm.transform_samples(tokens),
                             time_indices=time_indices)

  def as_onehot_fn(self):
    """The value on (N, L, 4) one-hots, differentiable with respect to
    them: classifier guidance takes its gradient
    (``svdd_tpu/value.py:as_onehot_fn``)."""
    return lambda onehot4: self.score_onehot(onehot4, fused=False)


# ---------------------------------------------------------------------------
# The reward oracle as the trainers take it
# ---------------------------------------------------------------------------


def make_reward_transform(task: str = 'dna', saluki_body=None,
                          saluki_final_length: int = 12288):
  """Tokens -> the reward oracle's input (``svdd_tpu/value.py:146-157``):
  for ``rna_saluki`` the padded (N, saluki_final_length, 6) saluki input
  (``mdlm.transform_samples_saluki`` with ``saluki_body``), else the
  4-channel one-hot. Only the reward reads the saluki input; the value
  net's states stay (N, L, 4). The port's oracles hold their weights, so
  a reward function is one callable of that input (JAX's (apply_fn,
  variables) pair has no counterpart)."""
  if task == 'rna_saluki':
    return lambda samples: mdlm.transform_samples_saluki(
        samples, saluki_body, final_length=saluki_final_length)
  return mdlm.transform_samples


# ---------------------------------------------------------------------------
# Training targets
# ---------------------------------------------------------------------------


class ValueBatch(NamedTuple):
  onehots: torch.Tensor              # (N, L, 4) states, timesteps flattened
  targets: torch.Tensor              # (N,) regression targets
  time_indices: Optional[torch.Tensor] = None   # (N, L) step of each state


def mc_targets(samples, mid_x, reward_fn,
               generator: Optional[torch.Generator] = None,
               num_subsample: Optional[int] = None,
               subsample_idx: Optional[torch.Tensor] = None,
               reward_transform=mdlm.transform_samples) -> ValueBatch:
  """Monte-Carlo targets (``svdd_tpu/value.py:166-202``): every state of
  the trajectory regresses onto the final sample's reward. samples (B,
  L), mid_x (S-1, B, L): S*B pairs, the mid states step by step, then
  the final ones. ``num_subsample`` keeps that many distinct random mid
  steps (``subsample_idx`` given, or drawn uniformly without
  replacement from ``generator``, as ``jax.random.choice`` draws them
  from its key in another stream). ``reward_transform`` builds the
  oracle's input from the final tokens (``make_reward_transform``)."""
  s_minus_1, b, l = mid_x.shape
  target = reward_fn(reward_transform(samples))                # (B,)
  if num_subsample is not None and num_subsample < s_minus_1:
    if subsample_idx is None:
      if generator is None:
        raise ValueError('num_subsample requires a generator or indices')
      subsample_idx = torch.randperm(s_minus_1, generator=generator,
                                     device=generator.device)[:num_subsample]
    idx = torch.as_tensor(subsample_idx, device=mid_x.device).long()
    mid_x = mid_x[idx]
    steps = torch.cat([idx, torch.tensor([s_minus_1], device=idx.device)])
    s_minus_1 = num_subsample
  else:
    steps = torch.arange(s_minus_1 + 1, device=mid_x.device)
  states = torch.cat([mid_x.reshape(-1, l), samples], dim=0)
  onehots = mdlm.transform_samples(states)
  targets = target.repeat(s_minus_1 + 1)
  time_idx = steps.repeat_interleave(b)[:, None].expand(-1, l).int()
  return ValueBatch(onehots, targets, time_idx)


def cdq_targets(samples, mid_x, all_candidates, reward_fn,
                value_fn, reward_transform=mdlm.transform_samples
                ) -> ValueBatch:
  """CD-Q bootstrapped targets (``svdd_tpu/value.py:205-228``): the state
  after step j regresses onto the mean value (no gradient) of the
  candidates drawn at step j + 1, the final state onto its reward (of
  ``reward_transform``'s input; the bootstrap value net reads one-hots).
  all_candidates (S, B, M, L) from ``Diffusion.cdq_sampler``."""
  s, b, m, l = all_candidates.shape
  target = reward_fn(reward_transform(samples))                # (B,)
  cand = all_candidates[1:].reshape((s - 1) * b * m, l)
  with torch.no_grad():
    cand_vals = value_fn(mdlm.transform_samples(cand))
  case_avg = cand_vals.reshape(s - 1, b, m).mean(dim=-1)         # (S-1, B)
  states = torch.cat([mid_x.reshape(-1, l), samples], dim=0)
  onehots = mdlm.transform_samples(states)
  targets = torch.cat([case_avg.reshape(-1), target], dim=0)
  return ValueBatch(onehots, targets)


def value_loss(value_fn_onehot, batch: ValueBatch,
               rows: Optional[int] = None) -> torch.Tensor:
  """MSE objective (``svdd_tpu/value.py:231-234``): the squared errors'
  sum over ``rows`` (the batch's own row count by default; a process's
  share of a batch split over processes takes the global count)."""
  preds = value_fn_onehot(batch.onehots)
  sq = (preds.reshape(-1) - batch.targets.reshape(-1)) ** 2
  return sq.sum() / (sq.numel() if rows is None else rows)


# ---------------------------------------------------------------------------
# The value net's checkpoint file
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, module) -> None:
  """Write ``module`` (an Enformer or a ConvGRU: its task, widths,
  parameters, running statistics) to ``path``, through a temporary file
  and a rename."""
  from svdd_tpu_torch.train.diffusion import write_atomic
  if os.path.dirname(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
  task = 'rna' if isinstance(module, ConvGRUValueModel) else 'dna'
  write_atomic(path, {'format': FORMAT, 'task': task,
                      'config': module.config(),
                      'model': module.state_dict()})


def load_checkpoint(path: str, mmap: bool = False,
                    task: Optional[str] = None) -> dict:
  """The dict ``save_checkpoint`` wrote (``mmap``: its tensors mapped,
  not read); any other file raises, and so does, given ``task``, a file
  of the other task's architecture."""
  ckpt = None
  if os.path.isfile(path):
    try:
      ckpt = torch.load(path, map_location='cpu', weights_only=True,
                        mmap=mmap)
    except Exception:   # not a torch file, or pickled objects
      ckpt = None
  if not isinstance(ckpt, dict) or ckpt.get('format') != FORMAT:
    raise NotImplementedError(
        f'{path}: not a value-net or oracle checkpoint of this package '
        f'({FORMAT}) nor a reference torch pickle the checkpoint flags '
        "import; the JAX package's orbax checkpoints are read as exports "
        '(ROADMAP A17: scripts/export_jax_checkpoint.py writes one)')
  if task is not None:
    want, held = checkpoint_task(task), ckpt.get('task', 'dna')
    if held != want:
      raise ValueError(
          f'{path}: a {held} checkpoint ({_ARCH[held]}) handed to a {want} '
          f'run, which needs a {_ARCH[want]}')
  return ckpt
