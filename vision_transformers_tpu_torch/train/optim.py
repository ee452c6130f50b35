"""Optimizer, global-norm clipping and weight-decay partitioning (counterpart
of ``vision_transformers_tpu/train/optim.py``; reference: factory.py:25-45,
train_util.py:87-111, train.py:285-299).

AdamW is decoupled in the order optax chains it in the JAX package
(optim.py:269-281): Adam's normalized step, then ``+ wd · p`` on the decay
group, then ``× −lr``.  The decay group comes from the wd-skip rule applied
to state_dict names; the ``vit`` and ``dino`` rules are ported.  The decay
may be a float or a table evaluated per optimizer step (DINO's cosine
weight decay, the JAX ``add_scheduled_decayed_weights``, optim.py:307-336),
and a step can leave out parameters with torch's semantics for a
parameter whose gradient is None (DINO's last-layer freeze, JAX
train/dino.py:172-216): no moment update, no step count, no decay, no
update; each parameter's bias correction runs at its own step count.  ``agc > 0`` and the
other optimizers (rmsprop_tf, sgd, lamb) are not: a conf naming another
optimizer raises the registry's KeyError, ``agc > 0`` NotImplementedError.
Everything runs on the parameters' device with ``torch._foreach`` ops, so
a step needs no host round-trip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..config.registry import TypedConfig, register

__all__ = ["AdamW", "AdamWConfig", "wd_skip_fn", "wd_mask", "global_norm",
           "clip_by_global_norm", "make_optimizer"]


def wd_skip_fn(skip_type: str) -> Callable[[str, torch.Tensor], bool]:
    """``(name, param) -> skip?`` on state_dict names (reference
    factory.py:25-39; the JAX package's ``wd_skip_fn``, optim.py:125-157)."""
    if skip_type == "vit":
        def check(name: str, param: torch.Tensor) -> bool:
            name = name.lower()
            return "bias" in name or "cls" in name or "norm" in name or param.ndim == 1
    elif skip_type == "dino":
        # the reference's names: head.last.weight_g is [out, 1], 2-D, so it
        # lands in the decay group, as in the reference (the JAX package
        # keeps the gain 1-D and puts it there by name, optim.py:146-155)
        def check(name: str, param: torch.Tensor) -> bool:
            return "bias" in name.lower() or param.ndim == 1
    else:
        raise NotImplementedError(
            f"wd_skip {skip_type!r} is not ported (only 'vit' and 'dino'); see ROADMAP")
    return check


def wd_mask(params: Mapping[str, torch.Tensor], skip_type: str = "vit") -> Dict[str, bool]:
    """state_dict name → True where weight decay applies (the decay group)."""
    skip = wd_skip_fn(skip_type)
    return {name: not skip(name, p) for name, p in params.items()}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖t‖²) over all tensors (optax.global_norm), on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        g_norm: torch.Tensor) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: ``g`` where ‖g‖ < max_norm, else
    ``(g / ‖g‖) · max_norm``, without a host round-trip."""
    scaled = torch._foreach_div(grads, g_norm)
    torch._foreach_mul_(scaled, max_norm)
    keep = g_norm < max_norm
    return [torch.where(keep, g, s) for g, s in zip(grads, scaled)]


class AdamW:
    """optax ``chain(scale_by_adam, masked add_decayed_weights,
    scale_by_schedule(−lr))`` on a list of named parameters.  ``mu`` /
    ``nu`` are the first / second moments, ``count`` the optimizer steps
    taken (it indexes the lr schedule and a decay table), ``steps`` each
    parameter's own step count (torch AdamW's ``state["step"]``), which lags
    ``count`` for a parameter left out of some steps.  ``weight_decay`` is
    a float or a ``count -> decay`` function."""

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 schedule: Callable[[int], float], betas=(0.9, 0.999),
                 eps: float = 1e-8,
                 weight_decay: float | Callable[[int], float] = 0.0,
                 decay: Mapping[str, bool] | None = None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule = schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = weight_decay if callable(weight_decay) else float(weight_decay)
        decay = decay or {}
        self.decays = [decay.get(n, False) for n in self.names]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.steps = [0] * len(self.params)

    def _bias_corrections(self, step: int) -> Tuple[float, float]:
        # in f32, as optax computes 1 − b**count
        c = np.float32(step)
        return (float(np.float32(1.0) - np.float32(self.b1) ** c),
                float(np.float32(1.0) - np.float32(self.b2) ** c))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], skip=()) -> None:
        """One step on ``grads`` (one per parameter); the parameters at the
        indices in ``skip`` take no part (see the module docstring)."""
        wd = self.weight_decay(self.count) if callable(self.weight_decay) \
            else self.weight_decay
        lr = self.schedule(self.count)
        self.count += 1
        skip = set(skip)
        live = [i for i in range(len(self.params)) if i not in skip]
        b1, b2 = self.b1, self.b2
        mu, nu = [self.mu[i] for i in live], [self.nu[i] for i in live]
        g = [grads[i] for i in live]
        # moments: (1 − b)·g^k + b·m
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        for i in live:
            self.steps[i] += 1
        # one group per step count (two at most: the frozen layer's lags)
        for t in sorted({self.steps[i] for i in live}):
            idx = [i for i in live if self.steps[i] == t]
            bc1, bc2 = self._bias_corrections(t)
            upd = torch._foreach_div([self.mu[i] for i in idx], bc1)
            den = torch._foreach_div([self.nu[i] for i in idx], bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_div_(upd, den)
            dec = [k for k, i in enumerate(idx) if self.decays[i]]
            if wd and dec:
                torch._foreach_add_([upd[k] for k in dec],
                                    [self.params[idx[k]] for k in dec], alpha=wd)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_([self.params[i] for i in idx], upd)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "steps": dict(zip(self.names, self.steps)),
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}


@register("optimizer", "adamw")
@dataclasses.dataclass
class AdamWConfig(TypedConfig):
    lr: float
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0  # applied through Training.weight_decay

    def make(self, named_params, schedule, weight_decay: float, decay) -> AdamW:
        return AdamW(named_params, schedule, self.betas, self.eps, weight_decay,
                     decay)


def make_optimizer(train_conf, model: torch.nn.Module,
                   schedule: Callable[[int], float],
                   weight_decay: float | Callable[[int], float] | None = None) -> AdamW:
    """The optimizer of a Training config over ``model``'s parameters
    (reference train.py:285-299; clipping is applied by the train step);
    ``weight_decay`` overrides the conf's with a float or a ``count ->
    decay`` function (DINO's table)."""
    if train_conf.agc > 0:
        raise NotImplementedError(
            "adaptive gradient clipping (training.agc > 0) is not ported (ROADMAP)")
    named = list(model.named_parameters())
    decay = wd_mask(dict(named), train_conf.wd_skip)
    wd = train_conf.weight_decay if weight_decay is None else weight_decay
    return train_conf.optimizer.make(named, schedule, wd, decay)
