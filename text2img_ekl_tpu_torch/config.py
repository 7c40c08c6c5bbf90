"""Typed configuration tree of the PyTorch port.

The port's own copy of ``text2img_ekl_tpu/config.py`` (the port imports
nothing of the JAX package): the same dataclasses, defaults and strict
merge, so every ``cfg/*.yml`` loads to the same values in both packages
(tests/test_torch_port_config_data.py holds them equal). It mirrors the
reference schema (reference: miscc/config.py:13-77): unknown keys raise
``KeyError`` (miscc/config.py:92) and type mismatches raise ``ValueError``
(miscc/config.py:100).

The ``TPU_*`` keys keep their names so that the YAML files load in both
packages; the port reads the ones it implements and refuses, by name, the
options it has not ported (train/step.py).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class TreeConfig:
    """Multi-stage image pyramid (reference: miscc/config.py:23-26)."""

    BRANCH_NUM: int = 3
    BASE_SIZE: int = 64
    SCALE: int = 2


@dataclass
class TestConfig:
    """Test/sampling options (reference: miscc/config.py:30-35)."""

    B_EXAMPLE: bool = True
    SAMPLE_NUM: int = 30000
    EVAL_MODE: bool = True
    G_CAPSULE: bool = False
    CLS_PRIOR: bool = False
    # Surfaces the reference's hard-coded ``cls_share`` local: the 10
    # captions of an image share one fixed N(0,1) class prior
    # (cub_trainer_splitz_cap_ca.py:810-812,866-867). Only meaningful with
    # CLS_PRIOR=True.
    CLS_SHARE: bool = False


@dataclass
class CoeffConfig:
    """Loss coefficients (reference: miscc/config.py:58-61)."""

    KL: float = 2.0
    UNCOND_LOSS: float = 0.0
    COLOR_LOSS: float = 0.0


@dataclass
class TrainConfig:
    """Training options (reference: miscc/config.py:39-61)."""

    BATCH_SIZE: int = 64
    VIS_COUNT: int = 64
    MAX_EPOCH: int = 600
    SNAPSHOT_INTERVAL: int = 2000
    DISCRIMINATOR_LR: float = 2e-4
    GENERATOR_LR: float = 2e-4
    FLAG: bool = True
    NET_G: str = ''
    ENTITY_NET_G: str = ''
    NET_D: str = ''
    ENTITY_NET_D: str = ''
    BIG_EVAL: bool = False
    G_CAPSULE: bool = False
    D_CAPSULE: bool = False
    CAT_Z: str = 'concat'
    EXCHANGE: bool = False
    GENERAL_IS: bool = False
    COEFF: CoeffConfig = field(default_factory=CoeffConfig)


@dataclass
class GanConfig:
    """Model dimensions (reference: miscc/config.py:65-74)."""

    EMBEDDING_DIM: int = 128
    DF_DIM: int = 64
    GF_DIM: int = 64
    Z_DIM: int = 100
    NETWORK_TYPE: str = 'default'
    R_NUM: int = 2
    B_CONDITION: bool = False
    ENTITY_DIM: int = 200
    MANIFD_DIM: int = 128


@dataclass
class TextConfig:
    """Text embedding dims (reference: miscc/config.py:76-77)."""

    DIMENSION: int = 1024


@dataclass
class Config:
    """Top-level config (reference: miscc/config.py:9-77).

    The JAX package's additions live under names absent from the reference
    schema, prefixed TPU_* so reference YAMLs can never collide with them;
    they are also mergeable from YAML for new-style configs.
    """

    DATASET_NAME: str = 'birds'
    EMBEDDING_TYPE: str = 'cnn-rnn'
    CONFIG_NAME: str = ''
    DATA_DIR: str = ''
    GPU_ID: str = '0'
    CUDA: bool = True
    WORKERS: int = 6
    TREE: TreeConfig = field(default_factory=TreeConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    GAN: GanConfig = field(default_factory=GanConfig)
    TEXT: TextConfig = field(default_factory=TextConfig)

    # --- TPU_* extensions (not present in the reference schema) ---------
    # The JAX package's own keys, with its defaults, so that every YAML
    # loads the same in both packages. What the port does with each:
    # Compute dtype of convs and matmuls ('bfloat16' or 'float32'): used.
    TPU_COMPUTE_DTYPE: str = 'bfloat16'
    # BatchNorm IO dtype: the port normalises in float32 always.
    TPU_BN_DTYPE: str = 'bfloat16'
    # Mesh and multi-device keys: one device only (ROADMAP.md M13).
    TPU_DATA_PARALLEL: int = 0
    TPU_SPMD_MODE: str = 'shard_map'
    TPU_GROUPED_D: bool = False          # raises when set (M13)
    TPU_SHARDED_ADAM: bool = False
    # Kernel and formulation switches of the JAX package; the port raises
    # when one that changes what runs is set (M14).
    TPU_FUSED_BN_GLU: bool = False       # needs K3
    TPU_SPLIT_JOINTCONV: bool = True     # same function either way
    TPU_SUBPIXEL_UP: bool = False
    TPU_PALLAS_DW: bool = False          # needs K4
    TPU_REMAT_G: str = ''
    # XLA compiler knobs: no counterpart in the port.
    TPU_SCOPED_VMEM_KIB: int = 0
    TPU_COMPILER_OPTIONS: Optional[dict] = None
    # uint8 image pyramids from the loader, normalised on the device: used.
    TPU_UINT8_INPUT: bool = True
    # Gradient accumulation over microbatches: raises when > 1 (M13).
    TPU_GRAD_ACCUM: int = 0
    # Capsule routing ('dynamic' or 'k_means') and its passes: used.
    TPU_CAPSULE_ROUTING: str = 'dynamic'
    TPU_CAPSULE_ITERATIONS: int = 3
    # Route dynamic capsule routing through the hand-written kernels.
    TPU_CAPSULE_PALLAS: bool = True
    # Synthetic data when DATA_DIR has no dataset on disk: used.
    TPU_SYNTHETIC_DATA: bool = False
    # The native C++ JPEG decoder: the port decodes with PIL (M9).
    TPU_NATIVE_DECODE: bool = True
    # Steps between in-training IS prediction batches (M11).
    TPU_IS_EVERY: int = 2
    # Generator EMA decay (0 disables, the reference's default): used.
    TPU_EMA_DECAY: float = 0.0
    # Evaluate with the EMA weights when a state carries them.
    TPU_EMA_EVAL: bool = True
    # Profiler trace of a few steps (JAX package only).
    TPU_PROFILE: bool = False
    # Checkpoint retention (M10).
    TPU_KEEP_CHECKPOINTS: int = 0
    # Direct on-device IS/FID scoring in evaluate (M11).
    TPU_EVAL_DIRECT: bool = False
    TPU_EVAL_FID_STATS: str = ''

    # ------------------------------------------------------------------
    @property
    def imsize(self) -> int:
        """Top-stage image size (reference: main.py:109)."""
        return self.TREE.BASE_SIZE * (self.TREE.SCALE ** (self.TREE.BRANCH_NUM - 1))

    def branch_sizes(self) -> list:
        """Per-branch image sizes, e.g. [64, 128, 256]."""
        return [self.TREE.BASE_SIZE * (self.TREE.SCALE ** i)
                for i in range(self.TREE.BRANCH_NUM)]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)


def _merge_dict_into_dataclass(src: Dict[str, Any], dst: Any, path: str = '') -> None:
    """Strict recursive merge with the reference's error semantics.

    Reference behaviour (miscc/config.py:80-112): a key absent from the
    defaults raises KeyError; a type mismatch between the YAML value and the
    default raises ValueError; nested dicts merge recursively.
    """
    if not isinstance(src, dict):
        return
    valid = {f.name: f for f in dataclasses.fields(dst)}
    for k, v in src.items():
        if k not in valid:
            raise KeyError('{} is not a valid config key'.format(k))
        old = getattr(dst, k)
        if dataclasses.is_dataclass(old):
            if not isinstance(v, dict):
                raise ValueError(
                    'Type mismatch ({} vs. {}) for config key: {}'.format(
                        type(old), type(v), k))
            try:
                _merge_dict_into_dataclass(v, old, path + k + '.')
            except Exception:
                print('Error under config key: {}'.format(k))
                raise
            continue
        old_type = type(old)
        if old_type is not type(v):
            # Permit the numeric coercions YAML naturally produces, exactly
            # like the reference permits np.ndarray coercion: int -> float
            # for float-typed defaults (YAML '2e-4' parses fine but '1.0'
            # vs int defaults must still error, as in the reference).
            if old_type is float and isinstance(v, int) and not isinstance(v, bool):
                v = float(v)
            else:
                raise ValueError(
                    'Type mismatch ({} vs. {}) for config key: {}'.format(
                        old_type, type(v), k))
        setattr(dst, k, v)


def cfg_from_file(filename: str, base: Config = None) -> Config:
    """Load a YAML file and merge it into a fresh (or given) Config.

    Mirrors reference ``cfg_from_file`` (miscc/config.py:115-121) but returns
    the config instead of mutating a module global.
    """
    import yaml

    with open(filename, 'r') as f:
        yaml_cfg = yaml.safe_load(f)
    out = copy.deepcopy(base) if base is not None else Config()
    if yaml_cfg:
        _merge_dict_into_dataclass(yaml_cfg, out)
    return out


def cfg_from_dict(d: Dict[str, Any], base: Config = None) -> Config:
    out = copy.deepcopy(base) if base is not None else Config()
    _merge_dict_into_dataclass(d or {}, out)
    return out
