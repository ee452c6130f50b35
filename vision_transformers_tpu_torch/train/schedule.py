"""Learning-rate schedules as ``count -> lr`` functions (counterpart of
``vision_transformers_tpu/train/schedule.py``; reference: tensorfn's
PhaseScheduler, mirrored by the reference's lr_scheduler.py).

``cycle`` (warmup → plateau → cosine decay) and ``constant`` are ported;
``exp_epoch`` and ``step`` are not registered yet, so a conf naming them
raises the registry's KeyError.  The optimizer steps on the host, so a
schedule is plain Python arithmetic evaluated once per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

from ..config.registry import TypedConfig, register

__all__ = ["CycleScheduler", "ConstantScheduler", "make_schedule", "cosine_schedule"]


def _anneal_cos(start, end, proportion):
    return end + (start - end) / 2 * (math.cos(math.pi * proportion) + 1)


def _anneal_linear(start, end, proportion):
    return start + proportion * (end - start)


@register("scheduler", "cycle")
@dataclasses.dataclass
class CycleScheduler(TypedConfig):
    """Warmup → (plateau) → cosine decay (reference: lr_scheduler.py:146-166)."""

    lr: float
    warmup: int = 0  # epochs; make_schedule converts them to steps
    plateau: int = 0
    initial_multiplier: float = 4e-2
    final_multiplier: float = 1e-5
    decay: Tuple[str, str] = ("cos", "cos")

    def make(self, lr: float, n_iter: int, warmup: int) -> Callable[[int], float]:
        plateau = self.plateau
        decay_iter = max(n_iter - warmup - plateau, 1)
        init_lr = lr * self.initial_multiplier
        final_lr = lr * self.final_multiplier
        anneal = {"cos": _anneal_cos, "linear": _anneal_linear}
        warm_fn, decay_fn = anneal[self.decay[0]], anneal[self.decay[1]]
        # PhaseScheduler counting (JAX schedule.py:65-89): step() counts
        # before it evaluates, and a phase advances only once its count
        # exceeds its length, so each phase emits length + 1 values
        warm_calls = warmup + 1 if warmup > 0 else 0
        plat_calls = plateau + 1 if plateau > 0 else 0

        def schedule(count: int) -> float:
            # optimizer step `count` (0-based) sees scheduler call count + 1
            n = count + 1.0
            if n <= warm_calls:
                return warm_fn(init_lr, lr, n / max(warmup, 1))
            if plateau > 0 and n <= warm_calls + plat_calls:
                return lr
            t = min(max((n - warm_calls - plat_calls) / decay_iter, 0.0),
                    (decay_iter + 1) / decay_iter)
            return decay_fn(lr, final_lr, t)

        return schedule


@register("scheduler", "constant")
@dataclasses.dataclass
class ConstantScheduler(TypedConfig):
    lr: float

    def make(self, lr: float, **_) -> Callable[[int], float]:
        return lambda count: lr


def make_schedule(train_conf, epoch_len: int) -> Callable[[int], float]:
    """The LR schedule of a Training config (reference: factory.py:48-59),
    at the linear-scaling rule ``base_lr · batch / 256`` (factory.py:42-45)."""
    sched = train_conf.scheduler
    warmup = int(getattr(sched, "warmup", 0) * epoch_len)
    n_iter = epoch_len * train_conf.epoch
    lr = train_conf.base_lr * train_conf.dataloader.batch_size / 256
    if sched.type == "constant":
        return sched.make(lr=lr)
    return sched.make(lr=lr, n_iter=n_iter, warmup=warmup)


def cosine_schedule(base: float, final: float, step: int, warmup: int = 0,
                    warmup_start: float = 0.0) -> list:
    """A precomputed cosine schedule of ``step`` values from ``base`` to
    ``final`` after an optional linear warmup (reference: train_util.py:6-22,
    the JAX package's schedule.py:209): DINO's weight-decay and
    teacher-momentum tables (reference train_dino.py:135-142)."""
    out = []
    if warmup > 0:
        if warmup == 1:
            out.append(warmup_start)
        else:
            out.extend(warmup_start + (base - warmup_start) * i / (warmup - 1)
                       for i in range(warmup))
    n = step - warmup
    out.extend(final + 0.5 * (base - final) * (1 + math.cos(math.pi * i / n))
               for i in range(n))
    return out
