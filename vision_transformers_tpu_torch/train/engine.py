"""The train and eval steps (counterpart of ``vision_transformers_tpu/train/
engine.py``; reference: train.py:236-386).

One call of :func:`train_step` is one optimizer step: the forward and
backward of each microbatch (gradient accumulation is a loop; the JAX step
scans), the mix loss with label smoothing 0.1, the global-norm clip, AdamW,
and the EMA lerp with its warmup decay.  Metrics stay on the device as
tensors, so a step has no host round-trip; the caller fetches them when it
logs.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import ops
from . import loss as L
from .optim import AdamW, clip_by_global_norm, global_norm

__all__ = ["TrainState", "create_train_state", "train_step", "eval_step",
           "accuracy", "ema_decay_schedule"]


@dataclasses.dataclass
class TrainState:
    """All mutable training state: the model (its parameters), the
    optimizer (its moments and step count), optimizer steps taken, and the
    EMA copy of the model when ``ema > 0``."""

    model: torch.nn.Module
    optimizer: AdamW
    step: int = 0
    ema_model: Optional[torch.nn.Module] = None


def create_train_state(model: torch.nn.Module, optimizer: AdamW,
                       ema: float = 0.0) -> TrainState:
    ema_model = None
    if ema > 0:
        ema_model = copy.deepcopy(model).eval()
        ema_model.requires_grad_(False)
    return TrainState(model=model, optimizer=optimizer, ema_model=ema_model)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1, 5)) -> tuple:
    """Top-k accuracy in percent (reference: train_util.py:53-67)."""
    ranks = torch.topk(logits, max(topk), dim=-1).indices
    hit = ranks == labels[:, None]
    return tuple(100.0 * hit[:, :k].any(-1).float().mean() for k in topk)


def ema_decay_schedule(ema: float, step: int) -> np.float32:
    """Warmup-aware EMA decay ``min(ema, (1+t)/(10+t))`` in f32
    (reference: train.py:313-314)."""
    t = np.float32(step)
    return np.minimum(np.float32(ema), (np.float32(1) + t) / (np.float32(10) + t))


def _lerp(ema_params, params, decay: np.float32) -> None:
    """e ← e·decay + p·(1 − decay)."""
    torch._foreach_mul_(ema_params, float(decay))
    torch._foreach_add_(ema_params, params, alpha=float(np.float32(1) - decay))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               grad_accumulation: int = 1, label_smoothing: float = 0.1,
               ema: float = 0.0, clip_grad_norm: float = 0.0) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` ({image NCHW f32, label1, label2,
    ratio}, on the model's device); returns the metrics (tensors).

    Under accumulation the EMA follows the reference's per-loader-batch
    lerps (JAX engine.py:126-139): the first A−1 pull toward the unchanged
    pre-step parameters (one lerp with the product of their decays), the
    last, after the optimizer step, toward the updated ones; the warmup
    decay counts loader batches, ``t = step·A + k``."""
    model, opt = state.model, state.optimizer
    model.train()
    model.zero_grad(set_to_none=True)
    n = batch["image"].shape[0]
    if n % grad_accumulation:
        raise ValueError(f"batch {n} is not divisible by grad_accumulation "
                         f"{grad_accumulation}")
    mb = n // grad_accumulation
    totals = None
    for i in range(grad_accumulation):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        logits = model(part["image"], generator=generator).float()  # the loss in f32
        loss = L.mix_loss(logits, part["label1"], part["label2"], part["ratio"],
                          eps=label_smoothing)
        loss.backward()
        with torch.no_grad():
            prec1, prec5 = accuracy(logits, part["label1"])
            m = torch.stack([loss.detach(), prec1, prec5])
        totals = m if totals is None else totals + m
    metrics = totals / grad_accumulation

    params = opt.params
    grads = [p.grad for p in params]
    if grad_accumulation > 1:
        torch._foreach_div_(grads, float(grad_accumulation))
    g_norm = global_norm(grads)
    if clip_grad_norm > 0:
        grads = clip_by_global_norm(grads, clip_grad_norm, g_norm)

    t0 = state.step * grad_accumulation
    if state.ema_model is not None and grad_accumulation > 1:
        d_pre = np.prod([ema_decay_schedule(ema, t0 + k)
                         for k in range(grad_accumulation - 1)], dtype=np.float32)
        _lerp(list(state.ema_model.parameters()), [p.detach() for p in params], d_pre)
    opt.step(grads)
    if state.ema_model is not None:
        _lerp(list(state.ema_model.parameters()), [p.detach() for p in params],
              ema_decay_schedule(ema, t0 + grad_accumulation - 1))
    state.step += 1
    return {"loss": metrics[0], "prec1": metrics[1], "prec5": metrics[2],
            "grad_norm": g_norm}


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Validation sums (reference: train.py:335-386): CE loss, top-1/5 hits
    in percent, and the count, under :func:`ops.forward_only` (so the
    'layer' sites take the whole-layer kernel, JAX engine.py:250-255)."""
    model.eval()
    with ops.forward_only():
        logits = model(batch["image"]).float()
    losses = L.cross_entropy_loss(logits, batch["label1"], reduction="none")
    ranks = torch.topk(logits, 5, dim=-1).indices
    hit = ranks == batch["label1"][:, None]
    return {"loss": losses.sum(),
            "prec1": 100.0 * hit[:, :1].any(-1).float().sum(),
            "prec5": 100.0 * hit.any(-1).float().sum(),
            "n": torch.tensor(float(logits.shape[0]), device=logits.device)}
