"""Training configuration schema on stdlib dataclasses.

Counterpart of ``vision_transformers_tpu/config/schema.py`` (itself the
reference's ``config.py:27-102``), field for field, so the same ``.conf``
files load unchanged.  ``arch``, ``training.optimizer``,
``training.scheduler`` and ``checker`` are typed through the port's
registry (namespaces ``model``, ``optimizer``, ``scheduler``, ``checker``;
the checker's ``storage`` / ``reporter`` items resolve when it is made), as
in the JAX package; an unregistered type raises a KeyError that lists the
registered ones.  ``task`` is the typed DINO block, :class:`DINOTask`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from . import hocon, registry

__all__ = [
    "Progressive",
    "DINOTask",
    "DataLoaderConf",
    "Training",
    "MeshConf",
    "ImageNetConfig",
    "load_config",
    "hocon",
]


@dataclasses.dataclass
class Progressive:
    """Progressive-training schedule (reference: config.py:27-39)."""

    step: int = 0
    train_sizes: Tuple[int, int] = (128, 300)
    valid_sizes: Tuple[int, int] = (128, 300)
    randaug_layers: Tuple[int, int] = (2, 2)
    randaug_magnitudes: Tuple[float, float] = (5, 15)
    mixups: Tuple[float, float] = (0, 0)
    cutmixes: Tuple[float, float] = (0, 1)
    dropouts: Tuple[float, float] = (0.1, 0.3)
    drop_paths: Tuple[float, float] = (0.2, 0.2)
    grad_accumulation: Optional[List[int]] = None
    verbose: bool = True


@dataclasses.dataclass
class DINOTask:
    """DINO self-distillation task settings (reference: config.py:42-56; the
    JAX package's DINOTask, schema.py:54)."""

    type: str = "dino"
    global_crop_size: int = 224
    local_crop_size: int = 96
    global_crop_scale: Tuple[float, float] = (0.4, 1.0)
    local_crop_scale: Tuple[float, float] = (0.05, 0.4)
    n_local_crop: int = 8
    student_drop_path: float = 0.1
    warmup_teacher_temperature: float = 0.04
    teacher_temperature: float = 0.07
    warmup_teacher_temperature_epoch: int = 30
    teacher_momentum: float = 0.9
    weight_decay_end: float = 0.4
    freeze_last_layer: int = 1


@dataclasses.dataclass
class DataLoaderConf:
    """Loader settings (reference: tensorfn DataLoader, config.py:90)."""

    batch_size: int = 256
    num_workers: int = 4
    drop_last: bool = True
    prefetch: int = 2


@dataclasses.dataclass
class Training:
    """Training hyper-parameters (reference: config.py:59-90)."""

    optimizer: Any
    scheduler: Any

    base_lr: float
    weight_decay: float
    wd_skip: str
    epoch: int
    ema: float = 0.0
    ema_bn: bool = False
    agc: float = 0.0
    train_size: int = 224
    valid_size: int = 224

    randaug_layer: int = 0
    randaug_magnitude: float = 5.0
    randaug_increasing: bool = False
    randaug_magnitude_std: float = 0.0
    randaug_cutout: int = 40

    erasing: float = 0.0

    mixup: float = 0.0
    cutmix: float = 0.0
    mix_before_aug: bool = True

    augment_backend: str = "device"

    clip_grad_norm: float = 0.0
    grad_accumulation: int = 1

    progressive: Progressive = dataclasses.field(default_factory=Progressive)

    dataloader: DataLoaderConf = dataclasses.field(default_factory=DataLoaderConf)

    def __post_init__(self):
        self.optimizer = registry.build("optimizer", self.optimizer)
        self.scheduler = registry.build("scheduler", self.scheduler)
        if self.augment_backend not in ("device", "host"):
            raise ValueError(f"augment_backend must be 'device' or 'host', "
                             f"got {self.augment_backend!r}")


@dataclasses.dataclass
class MeshConf:
    """Device-mesh layout: sizes of the named sharding axes."""

    data: int = -1
    model: int = 1


@dataclasses.dataclass
class ImageNetConfig:
    """Top-level config (reference: config.py:93-102)."""

    arch: Any
    training: Training
    dataset_path: str
    task: Optional[DINOTask] = None

    log_freq: int = 10
    checker: Any = None
    fp16: bool = False
    logger: str = "rich"

    n_device: int = 0
    mesh: MeshConf = dataclasses.field(default_factory=MeshConf)
    precision: str = "bf16"
    seed: int = 0
    data_backend: str = "auto"
    resume: Optional[str] = None
    profile_dir: Optional[str] = None
    finetune: Optional[str] = None

    def __post_init__(self):
        self.arch = registry.build("model", self.arch)
        checker = {"type": "checker"} if self.checker is None else self.checker
        if isinstance(checker, dict):
            checker = {"type": "checker", **checker}
        self.checker = registry.build("checker", checker)


def load_config(path: str, overrides: Optional[List[str]] = None) -> ImageNetConfig:
    """Load + validate a ``.conf`` file with optional ``key=value`` overrides."""
    raw = hocon.load(path)
    if overrides:
        hocon.apply_overrides(raw, list(overrides))
    return registry.from_dict(ImageNetConfig, raw)
