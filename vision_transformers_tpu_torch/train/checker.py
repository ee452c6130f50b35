"""Checker: metric reporting + checkpoint storage (counterpart of
``vision_transformers_tpu/train/checker.py``; reference call sites:
train.py:171,200-217).

Storages receive checkpoints, reporters scalar metrics, each resolved
through the registry (namespaces ``storage`` and ``reporter``).  Ported:
the ``local`` storage, which writes the reference's own ``.pt`` format
(:mod:`.checkpoint`), and the ``logger`` and ``jsonl`` reporters.
``tensorboard`` raises NotImplementedError when it is made.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Optional

from ..config.registry import TypedConfig, register
from ..utils.logging import get_logger
from . import checkpoint as ckpt

__all__ = ["Checker", "CheckerConfig", "LocalStorage", "LoggerReporter",
           "JsonlReporter"]


@register("storage", "local")
@dataclasses.dataclass
class LocalStorage(TypedConfig):
    path: str = "experiment"

    def make(self) -> "_LocalStorage":
        return _LocalStorage(self.path)


class _LocalStorage:
    def __init__(self, path: str):
        self.path = path

    def save(self, obj: Any, name: str) -> str:
        return ckpt.save_checkpoint(os.path.join(self.path, f"{name}.pt"), obj)


@register("reporter", "logger")
@dataclasses.dataclass
class LoggerReporter(TypedConfig):
    def make(self) -> "_LoggerReporter":
        return _LoggerReporter()


class _LoggerReporter:
    def __init__(self):
        self.logger = get_logger()

    def report(self, step: Optional[int] = None, **scalars: Any) -> None:
        parts = [] if step is None else [f"step {step}"]
        for k, v in scalars.items():
            parts.append(f"{k}: {v:.5f}" if isinstance(v, float) else f"{k}: {v}")
        self.logger.info("; ".join(parts))


@register("reporter", "jsonl")
@dataclasses.dataclass
class JsonlReporter(TypedConfig):
    """Append-only metrics file, one JSON object per report."""

    path: str = "metrics.jsonl"

    def make(self) -> "_JsonlReporter":
        return _JsonlReporter(self.path)


class _JsonlReporter:
    def __init__(self, path: str):
        self.path = path

    def report(self, step: Optional[int] = None, **scalars: Any) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")


@register("reporter", "tensorboard")
@dataclasses.dataclass
class TensorboardReporter(TypedConfig):
    path: str = "runs"

    def make(self):
        raise NotImplementedError("the tensorboard reporter is not ported (ROADMAP)")


@register("checker", "checker")
@dataclasses.dataclass
class CheckerConfig(TypedConfig):
    storage: List[Any] = dataclasses.field(default_factory=list)
    reporter: List[Any] = dataclasses.field(default_factory=list)

    def make(self) -> "Checker":
        from ..config import registry

        storages = [registry.build("storage", s).make() for s in self.storage]
        reporters = [registry.build("reporter", r).make() for r in self.reporter]
        return Checker(storages, reporters)


class Checker:
    """(reference usage: checker.log train.py:200-206; checker.checkpoint
    :208-217)"""

    def __init__(self, storages: list, reporters: list):
        self.storages = storages
        self.reporters = reporters or [_LoggerReporter()]

    def log(self, step: Optional[int] = None, **scalars: Any) -> None:
        for reporter in self.reporters:
            reporter.report(step=step, **scalars)

    def checkpoint(self, obj: Any, name: str) -> None:
        """Save to every storage; a failed save is logged and training goes
        on, as in the reference (train.py:207-219)."""
        for storage in self.storages:
            try:
                storage.save(obj, name)
            except Exception as e:
                get_logger().info(f"checkpoint save failed: {e!r}")
