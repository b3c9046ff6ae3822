"""Typed configuration: the subset of ``svdd_tpu/config.py`` that the
ported paths read, with the same field names and defaults.

The ``parallel`` fields other than ``precision`` belong to the parallel
paths (``parallel/``), which run on ``torch.distributed``: the data and
model axes, FSDP, and the DiT's pipeline (``pipeline_*``, read by the
trainer alone, as JAX's).

The JAX module cannot be imported here (``svdd_tpu/__init__.py`` pulls
in JAX), so the dataclasses are restated. ``Config.from_yaml`` needs
PyYAML, imported when it is called; ``text_mdlm_config()`` builds the
``configs/text_mdlm.yaml`` preset without it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


def _update(obj: Any, overrides: Dict[str, Any]) -> None:
  for k, v in overrides.items():
    if not hasattr(obj, k):
      raise KeyError(f'unknown config key {k!r} on {type(obj).__name__}')
    cur = getattr(obj, k)
    if dataclasses.is_dataclass(cur) and isinstance(v, dict):
      _update(cur, v)
    else:
      setattr(obj, k, v)


@dataclass
class NoiseConfig:
  type: str = 'loglinear'
  sigma_min: float = 1e-4
  sigma_max: float = 20.0
  eps: float = 1e-3


@dataclass
class ModelConfig:
  name: str = 'dnaconv'
  length: int = 200
  hidden_dim: int = 128
  num_cnn_stacks: int = 4
  dropout: float = 0.0
  clean_data: bool = False
  cls_free_guidance: bool = False
  # dit (reference configs_gosai/model/small.yaml)
  hidden_size: int = 768
  cond_dim: int = 128
  n_blocks: int = 12
  n_heads: int = 12
  scale_by_sigma: bool = True
  # dimamba
  n_layer: int = 4
  d_model: int = 256


@dataclass
class LoaderConfig:
  global_batch_size: int = 512
  eval_global_batch_size: int = 512
  batch_size: int = 512
  eval_batch_size: int = 512


@dataclass
class SamplingConfig:
  predictor: str = 'ddpm'
  steps: int = 128
  noise_removal: bool = True
  num_sample_batches: int = 2
  semi_ar: bool = False        # sample_eval: strided semi-AR sampling
  stride_length: int = 1
  num_strides: int = 1


@dataclass
class TrainingConfig:
  ema: float = 0.9999
  antithetic_sampling: bool = True
  importance_sampling: bool = False
  sampling_eps: float = 1e-3
  change_of_variables: bool = False
  # the per-step batch is split into this many microbatches; their
  # losses and gradients are averaged before one optimizer update
  accum_steps: int = 1


@dataclass
class OptimConfig:
  weight_decay: float = 0.0
  lr: float = 3e-4
  beta1: float = 0.9
  beta2: float = 0.999
  eps: float = 1e-8
  grad_clip: float = 1.0
  warmup_steps: int = 2500
  max_steps: int = 131_500
  lr_schedule: str = 'constant_warmup'   # constant_warmup / cosine_decay_warmup
  lr_min: float = 1e-6


@dataclass
class EvalConfig:
  checkpoint_path: str = ''
  disable_ema: bool = False
  generate_samples: bool = True
  subset_size: int = 5000
  val_check_interval: int = 1000


@dataclass
class CheckpointingConfig:
  save_dir: str = './checkpoints'
  resume_from_ckpt: bool = True
  every_n_steps: int = 1000


@dataclass
class ParallelConfig:
  data_axis: int = -1          # -1: all devices
  model_axis: int = 1
  fsdp: bool = False
  fsdp_min_size: int = 2 ** 14
  precision: str = 'bf16'      # compute dtype of the dit/dimamba forwards
  pipeline_stages: int = 1
  pipeline_microbatches: int = 0
  pipeline_virtual: int = 1



@dataclass
class Config:
  diffusion: str = 'absorbing_state'
  backbone: str = 'cnn'
  parameterization: str = 'subs'
  time_conditioning: bool = False
  T: int = 0                   # 0 = continuous time
  subs_masking: bool = False   # d3pm: zero the MASK lane's probability
  seed: int = 1
  task: str = 'dna'            # dna / rna / rna_saluki / text
  alphabet_size: int = 4

  noise: NoiseConfig = field(default_factory=NoiseConfig)
  model: ModelConfig = field(default_factory=ModelConfig)
  loader: LoaderConfig = field(default_factory=LoaderConfig)
  sampling: SamplingConfig = field(default_factory=SamplingConfig)
  training: TrainingConfig = field(default_factory=TrainingConfig)
  optim: OptimConfig = field(default_factory=OptimConfig)
  eval: EvalConfig = field(default_factory=EvalConfig)
  checkpointing: CheckpointingConfig = field(
      default_factory=CheckpointingConfig)
  parallel: ParallelConfig = field(default_factory=ParallelConfig)

  @property
  def vocab_size(self) -> int:
    return self.alphabet_size + 1   # + MASK

  @property
  def mask_index(self) -> int:
    return self.alphabet_size

  def override(self, **overrides: Any) -> 'Config':
    cfg = dataclasses.replace(self)
    for f in dataclasses.fields(cfg):
      v = getattr(cfg, f.name)
      if dataclasses.is_dataclass(v):
        setattr(cfg, f.name, dataclasses.replace(v))
    _update(cfg, overrides)
    return cfg

  def to_dict(self) -> Dict[str, Any]:
    return dataclasses.asdict(self)

  @staticmethod
  def from_dict(d: Dict[str, Any]) -> 'Config':
    cfg = Config()
    _update(cfg, d)
    return cfg

  @staticmethod
  def from_yaml(path: str) -> 'Config':
    try:
      import yaml
    except ImportError as e:
      raise ImportError(f'Config.from_yaml({path!r}) needs PyYAML, which '
                        'is not installed; build the config in Python '
                        '(e.g. text_mdlm_config()) instead') from e
    with open(path) as f:
      return Config.from_dict(yaml.safe_load(f) or {})


def dna_config(**overrides: Any) -> Config:
  """DNA enhancer task (L=200, HepG2 reward)."""
  cfg = Config(task='dna')
  return cfg.override(**overrides) if overrides else cfg


def rna_config(**overrides: Any) -> Config:
  """RNA 5'UTR task (L=50, MRL reward): the DNA preset at length 50
  (``svdd_tpu/config.py:rna_config``)."""
  cfg = Config(task='rna')
  cfg.model.length = 50
  return cfg.override(**overrides) if overrides else cfg


def text_mdlm_config(**overrides: Any) -> Config:
  """The legacy text MDLM preset (``svdd_tpu/configs/text_mdlm.yaml``,
  copied to ``configs/text_mdlm.yaml``): the MDLM paper's small DiT
  (hidden 768, 12 blocks, 12 heads) at L=1024 over the 27-symbol text8
  alphabet, the ddpm_cache predictor and 1000 steps."""
  cfg = Config.from_dict({
      'task': 'text', 'backbone': 'dit', 'parameterization': 'subs',
      'alphabet_size': 27,
      'model': {'length': 1024, 'hidden_size': 768, 'cond_dim': 128,
                'n_blocks': 12, 'n_heads': 12},
      'noise': {'type': 'loglinear'},
      'sampling': {'predictor': 'ddpm_cache', 'steps': 1000}})
  return cfg.override(**overrides) if overrides else cfg


def tiny_test_config(task: str = 'dna', **overrides: Any) -> Config:
  """Small config for CPU unit tests (``svdd_tpu.config.tiny_test_config``
  with the fields this package reads): L=16 for the RNA task, 24 for
  DNA and, as in JAX, for the saluki task (the DNA preset with its
  task)."""
  if task not in ('dna', 'rna', 'rna_saluki'):
    raise NotImplementedError(f'task {task!r} is not ported yet')
  cfg = rna_config() if task == 'rna' else dna_config()
  cfg.task = task
  cfg.model.length = 16 if task == 'rna' else 24
  cfg.model.hidden_dim = 32
  cfg.model.num_cnn_stacks = 1
  cfg.model.hidden_size = 32
  cfg.model.cond_dim = 16
  cfg.model.n_blocks = 2
  cfg.model.n_heads = 2
  cfg.sampling.steps = 8
  cfg.loader.global_batch_size = 8
  cfg.loader.eval_global_batch_size = 8
  cfg.loader.batch_size = 8
  cfg.loader.eval_batch_size = 8
  cfg.parallel.precision = 'fp32'
  return cfg.override(**overrides) if overrides else cfg
