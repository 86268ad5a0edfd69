"""Config tree for the PyTorch port: defaults -> YAML -> CLI overrides.

Same key names and default values as the JAX package's config, so the
recipes under ``experiments/*/e2e_*.yaml`` merge unchanged. The ``TPU`` node
keeps its name for that reason; in this package its kernel switches read:

    TPU.ATTENTION_IMPL  "pallas" = the hand-written CUDA flash-attention
                        kernel (kernels/attention.py), "xla" = plain torch.
    TPU.CONV_IMPL       "pallas" = the hand-written CUDA fused-bottleneck
                        kernel (kernels/bottleneck.py) on TPU.CONV_STAGES,
                        "xla" = plain torch convolutions.

Keys that only the training, data-loading or mesh code reads are kept as
inert fields so that a recipe which sets them still merges.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, List, Optional, Tuple


def _tup(*xs):
    return field(default_factory=lambda: tuple(xs))


@dataclass(frozen=True)
class InputConfig:
    MAX_QUERY_LEN: int = 26
    MAX_VIDEO_LEN: int = 200
    TRAIN_SAMPLE_NUM: int = 64
    SAMPLE_FPS: float = 3.2
    RESOLUTION: int = 224
    PIXEL_MEAN: Tuple[float, ...] = _tup(0.485, 0.456, 0.406)
    PIXEL_STD: Tuple[float, ...] = _tup(0.229, 0.224, 0.225)
    AUG_SCALE: bool = True
    AUG_CROP: bool = True
    AUG_TRANSLATE: bool = False
    FLIP_PROB_TRAIN: float = 0.5
    TEMP_CROP_PROB: float = 0.5


@dataclass(frozen=True)
class VisionBackboneConfig:
    NAME: str = "resnet101"        # resnet50 | resnet101 (+ "-gn")
    POS_ENC: str = "sine"          # sine | sineHW | learned
    DILATION: bool = False         # DC5: dilation instead of stride in layer4
    FREEZE: bool = False
    DEPTHS: Tuple[int, ...] = ()   # override stage depths; () = from NAME


@dataclass(frozen=True)
class TextModelConfig:
    NAME: str = "roberta-base"
    FREEZE: bool = False
    LOCAL_PATH: str = ""           # local dir with the HF tokenizer files
    VOCAB_SIZE: int = 50265
    HIDDEN: int = 768
    LAYERS: int = 12
    HEADS: int = 12
    INTERMEDIATE: int = 3072
    MAX_POS: int = 514
    DROPOUT: float = 0.1
    ALLOW_HASH_TOKENIZER: bool = False


@dataclass(frozen=True)
class STCATConfig:
    HIDDEN: int = 256
    QUERY_DIM: int = 4
    ENC_LAYERS: int = 6
    DEC_LAYERS: int = 6
    FFN_DIM: int = 2048
    DROPOUT: float = 0.1
    HEAD_DROPOUT: float = 0.3
    HEADS: int = 8
    USE_LEARN_TIME_EMBED: bool = False
    USE_ACTION: bool = True
    FROM_SCRATCH: bool = True


@dataclass(frozen=True)
class LSTMConfig:
    HIDDEN_SIZE: int = 512
    BIDIRECTIONAL: bool = True
    NUM_LAYERS: int = 2
    EMBED_DIM: int = 300
    GLOVE_PATH: str = ""


@dataclass(frozen=True)
class ModelConfig:
    WEIGHT: str = ""
    EMA: bool = True
    EMA_DECAY: float = 0.9998
    QUERY_NUM: int = 1
    USE_LSTM: bool = False
    VISION_BACKBONE: VisionBackboneConfig = field(default_factory=VisionBackboneConfig)
    TEXT_MODEL: TextModelConfig = field(default_factory=TextModelConfig)
    LSTM: LSTMConfig = field(default_factory=LSTMConfig)
    STCAT: STCATConfig = field(default_factory=STCATConfig)


@dataclass(frozen=True)
class DatasetConfig:
    NAME: str = "VidSTG"


@dataclass(frozen=True)
class DataLoaderConfig:
    NUM_WORKERS: int = 4
    ASPECT_RATIO_GROUPING: bool = False
    PREFETCH_DEPTH: int = 2


@dataclass(frozen=True)
class ScheduleConfig:
    TYPE: str = "linear_with_warmup"
    DROP_STEP: Tuple[int, ...] = _tup(8, 12)


@dataclass(frozen=True)
class SolverConfig:
    MAX_EPOCH: int = 30
    BATCH_SIZE: int = 1
    SHUFFLE: bool = True
    BASE_LR: float = 2e-5
    VIS_BACKBONE_LR: float = 1e-5
    TEXT_LR: float = 2e-5
    TEMP_LR: float = 1e-4
    OPTIMIZER: str = "adamw"
    MAX_GRAD_NORM: float = 0.1
    BBOX_COEF: float = 5.0
    GIOU_COEF: float = 2.0
    TEMP_COEF: float = 2.0
    ATTN_COEF: float = 1.0
    ACTIONESS_COEF: float = 2.0
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 1e-4
    WARMUP_PROP: float = 0.01
    SCHEDULE: ScheduleConfig = field(default_factory=ScheduleConfig)
    PRE_VAL: bool = False
    TO_VAL: bool = True
    VAL_PERIOD: int = 2500
    CHECKPOINT_PERIOD: int = 5000
    USE_ATTN: bool = True
    SIGMA: float = 2.0
    USE_AUX_LOSS: bool = True
    EOS_COEF: float = 0.1


@dataclass(frozen=True)
class TPUConfig:
    """Kernel selection and shape policy (name kept for recipe compatibility)."""
    FRAME_BUCKETS: Tuple[int, ...] = _tup(32, 64, 96, 128)
    COMPUTE_DTYPE: str = "bfloat16"
    PARAM_DTYPE: str = "float32"
    MESH_DATA: int = 0
    MODEL_PARALLEL: int = 1
    ATTENTION_IMPL: str = "pallas"
    CONV_IMPL: str = "xla"
    CONV_STAGES: Tuple[int, ...] = _tup(1)
    DEVICE_PREPROCESS: bool = True
    INGEST_LAYOUT: str = "rgb"
    SEQUENCE_PARALLEL: bool = False
    MESH_SEQ: int = 1
    GRAD_ACCUM: int = 1
    REMAT_BACKBONE: bool = True
    REMAT_STAGES: Tuple[int, ...] = _tup(1, 2)
    REMAT_ENCODER: bool = False
    EVAL_DEVICE_SPLIT: bool = True
    PROFILE_STEP: int = -1
    COMPILE_CACHE_DIR: str = ""


@dataclass(frozen=True)
class Config:
    FROM_SCRATCH: bool = True
    DATA_TRUNK: Optional[int] = None
    OUTPUT_DIR: str = ""
    DATA_DIR: str = ""
    TENSORBOARD_DIR: str = ""
    SEED: int = 42
    INPUT: InputConfig = field(default_factory=InputConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    DATALOADER: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    SOLVER: SolverConfig = field(default_factory=SolverConfig)
    TPU: TPUConfig = field(default_factory=TPUConfig)


def _coerce(value: Any, target_type: Any) -> Any:
    """Coerce a YAML/CLI value into the declared field type."""
    if value is None:
        return None
    if target_type in (int, float, bool, str):
        if target_type is bool and isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
            raise ValueError(f"cannot parse bool from {value!r}")
        return target_type(value)
    origin = getattr(target_type, "__origin__", None)
    if origin in (tuple, list) or target_type in (tuple, list):
        if isinstance(value, str):
            value = value.strip().strip("[]()")
            value = [v for v in value.replace(",", " ").split() if v]
        args = getattr(target_type, "__args__", ())
        elem = args[0] if args else str
        if elem is Ellipsis:
            elem = str
        return tuple(_coerce(v, elem) for v in value)
    if origin is typing.Union:
        for arg in target_type.__args__:
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError):
                continue
        raise ValueError(f"cannot coerce {value!r} to {target_type}")
    return value


def _field_type(node: Any, name: str) -> Any:
    return typing.get_type_hints(type(node))[name]


def _replace_path(node: Any, path: List[str], value: Any) -> Any:
    name = path[0]
    names = {f.name for f in fields(node)}
    if name not in names:
        raise KeyError(f"unknown config key: {name} (valid: {sorted(names)})")
    current = getattr(node, name)
    if len(path) == 1:
        if is_dataclass(current):
            raise KeyError(f"{name} is a config node, not a leaf")
        return dataclasses.replace(node, **{name: _coerce(value, _field_type(node, name))})
    return dataclasses.replace(node, **{name: _replace_path(current, path[1:], value)})


def merge_from_list(cfg: Config, opts: List[Any]) -> Config:
    """Apply CLI-style overrides: ["SOLVER.BASE_LR", 1e-4, "INPUT.RESOLUTION", 448]."""
    if len(opts) % 2:
        raise ValueError("opts must be KEY VALUE pairs")
    for key, value in zip(opts[::2], opts[1::2]):
        cfg = _replace_path(cfg, key.split("."), value)
    return cfg


def _merge_dict(node: Any, d: dict) -> Any:
    updates = {}
    names = {f.name for f in fields(node)}
    for key, value in d.items():
        if key not in names:
            raise KeyError(f"unknown config key: {key}")
        current = getattr(node, key)
        if is_dataclass(current):
            if not isinstance(value, dict):
                raise ValueError(f"{key} expects a mapping")
            updates[key] = _merge_dict(current, value)
        else:
            updates[key] = _coerce(value, _field_type(node, key))
    return dataclasses.replace(node, **updates)


def merge_from_file(cfg: Config, path: str) -> Config:
    """Merge a YAML recipe (same key layout as the experiment YAMLs)."""
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return _merge_dict(cfg, d)


def default_config() -> Config:
    return Config()


def save_config(cfg: Config, path: str) -> None:
    """The config as YAML, loadable by merge_from_file."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
