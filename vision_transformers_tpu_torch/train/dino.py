"""DINO self-distillation training (counterpart of
``vision_transformers_tpu/train/dino.py``; reference: train_dino.py), on one
card.

The student and the teacher share the architecture; the teacher starts as a
copy of the student and moves only by the per-step EMA (reference :53-76,
:257-261).  One call of the step is one optimizer step: per microbatch, the
teacher's forward on the two global crops (under :func:`ops.forward_only`
and ``torch.no_grad``, so its layers take the whole-layer kernel), the
student's forward and backward on every crop, the DINO loss against the
running center and the center EMA (momentum 0.9); then the global-norm clip,
AdamW with the cosine weight decay of the step, the last-layer freeze with
torch's semantics (the clip norm includes the last layer's gradients; while
frozen it takes no update, no decay, no moment update and no step count;
after, its bias correction runs at its own step count), and the teacher EMA.

The schedules (reference :132-142) are the JAX package's: the lr from the
conf's scheduler, the weight decay cosine ``weight_decay → weight_decay_end``
and the teacher momentum cosine ``m → 1`` over the run's optimizer steps,
indexed by optimizer step; the teacher temperature per epoch.

Data come from the synthetic multi-crop backend, as the JAX trainer's
without ``train.rec`` (dino.py:259-292): 4 batches an epoch, augmented on
the device (:mod:`..data.dino`).  Each epoch logs through the checker and
writes ``epoch-NNN.pt``: {"student", "teacher" (reference layout),
"center", "optimizer", "frozen_steps", "epoch"}.

Both nets compute at the conf's precision, as the JAX trainer's
(the JAX trainer, dino.py:245-254; ``trainer.compute_dtype``): bf16 (the schema's
default, and DeiT-S/16's conf's) or f32.  The DINO loss, the center and its
EMA stay f32 (the teacher's and the student's f32 logits, loss.py:128-131,
:155), and so do the parameters, AdamW, the teacher EMA and the ``.pt``
checkpoints.  Not ported (each raises NotImplementedError, see ROADMAP):
more than one device, ``training.agc > 0``, ``resume`` and the records
loader (``data_backend=records``); nor the JAX trainer's preemption
checkpoint, which no conf field turns on (a SIGTERM ends the run).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import ops
from ..config.schema import ImageNetConfig
from ..data.dino import make_dino_device_augment
from ..data.synthetic import synthetic_dino_batches
from ..utils.logging import get_logger
from ..utils.weights import load_dino_checkpoint
from . import loss as L
from .checkpoint import _to_cpu
from .optim import AdamW, clip_by_global_norm, global_norm, make_optimizer
from .schedule import cosine_schedule, make_schedule
from .trainer import check_supported, compute_dtype

__all__ = ["DINOTrainState", "make_dino_train_step", "train_dino", "last_layer_indices",
           "dino_checkpoint"]

EPOCH_LEN = 4  # synthetic batches an epoch (the JAX trainer's)


@dataclasses.dataclass
class DINOTrainState:
    """All mutable DINO state: the two nets, the optimizer (its moments and
    per-parameter steps), the center [1, K], the optimizer steps taken and
    those taken while the last layer was frozen."""

    student: torch.nn.Module
    teacher: torch.nn.Module
    optimizer: AdamW
    center: torch.Tensor
    step: int = 0
    frozen_steps: int = 0


def last_layer_indices(optimizer: AdamW) -> List[int]:
    """The optimizer's indices of the head's weight-normed last layer
    (reference ``cancel_last_layer_grad``, train_util.py:25-31)."""
    return [i for i, n in enumerate(optimizer.names) if n.startswith("head.last.")]


def make_dino_train_step(training, student: torch.nn.Module, lr_schedule: Callable,
                         wd_sched: Sequence[float], n_crop: int):
    """``(optimizer, train_step)``, the JAX ``make_dino_train_step``
    (dino.py:91-255) on torch: AdamW over the student's parameters with the
    ``wd_skip`` decay group and the decay of ``wd_sched`` evaluated per
    optimizer step, and

        train_step(state, crops, generator, teacher_temp, momentum, freeze)

    one optimizer step on ``crops`` (the 2 globals, then the locals, NCHW
    on the nets' device): the metrics {loss, grad_norm} as tensors on the
    device (no host round-trip)."""
    table = np.asarray(wd_sched, np.float32)
    optimizer = make_optimizer(
        training, student, lr_schedule,
        weight_decay=lambda count: float(table[min(count, len(table) - 1)]))
    last = last_layer_indices(optimizer)
    accum, clip = training.grad_accumulation, training.clip_grad_norm

    def microbatch(state, crops, generator, teacher_temp):
        """Teacher forward on the two globals, student gradients on every
        crop (accumulated into .grad), the center EMA (reference
        train_dino.py:224-233, loss.py:144-151)."""
        with torch.no_grad(), ops.forward_only():
            teacher_out = state.teacher(list(crops[:2])).float()
        student_out = state.student(list(crops), generator)
        loss = L.dino_loss(student_out, teacher_out, state.center, teacher_temp, n_crop)
        (loss / accum).backward()
        state.center = L.update_center(state.center, teacher_out, momentum=0.9)
        return loss.detach()

    def train_step(state: DINOTrainState, crops: Sequence[torch.Tensor],
                   generator: Optional[torch.Generator], teacher_temp: float,
                   momentum: float, freeze: bool) -> Dict[str, torch.Tensor]:
        student, teacher = state.student, state.teacher
        student.train()
        teacher.eval()
        student.zero_grad(set_to_none=True)
        n = crops[0].shape[0]
        if n % accum:
            raise ValueError(f"batch {n} is not divisible by grad_accumulation {accum}")
        mb = n // accum
        losses = [microbatch(state, [c[i * mb:(i + 1) * mb] for c in crops], generator,
                             teacher_temp) for i in range(accum)]
        loss = torch.stack(losses).mean()
        params = optimizer.params
        grads = [p.grad for p in params]
        g_norm = global_norm(grads)
        if clip > 0:  # the norm includes the last layer's (train_dino.py:240-250)
            grads = clip_by_global_norm(grads, clip, g_norm)
        optimizer.step(grads, skip=last if freeze else ())
        with torch.no_grad():  # teacher EMA (reference :257-261)
            t_params = list(teacher.parameters())
            torch._foreach_mul_(t_params, momentum)
            torch._foreach_add_(t_params, [p.detach() for p in student.parameters()],
                                alpha=1.0 - momentum)
        state.step += 1
        state.frozen_steps += int(bool(freeze))
        return {"loss": loss, "grad_norm": g_norm}

    return optimizer, train_step


def dino_checkpoint(state: DINOTrainState, epoch: int) -> dict:
    """The dict an epoch checkpoint holds, on the CPU: both nets in the
    reference layout, the center, the optimizer's state (moments, global and
    per-parameter step counts), the frozen-step count and the epoch."""
    return _to_cpu({"student": state.student.state_dict(),
                    "teacher": state.teacher.state_dict(), "center": state.center,
                    "optimizer": {**state.optimizer.state_dict(), "step": state.step},
                    "frozen_steps": state.frozen_steps, "epoch": epoch})


def _check_dino(conf: ImageNetConfig) -> None:
    check_supported(conf)
    if conf.task is None:
        raise ValueError("DINO training needs a task: {type: dino, ...} block")
    if conf.training.agc > 0:
        raise NotImplementedError(
            "adaptive gradient clipping (training.agc > 0) is not ported (ROADMAP.md, "
            "queue A)")


def train_dino(conf: ImageNetConfig, device: torch.device | str = "cuda") -> dict:
    """Run the DINO recipe on ``device``; returns the last epoch's metrics."""
    _check_dino(conf)
    logger = get_logger()
    device = torch.device(device)
    task, training = conf.task, conf.training
    batch = training.dataloader.batch_size
    n_crop = task.n_local_crop + 2
    if batch % training.grad_accumulation:
        raise ValueError(f"batch_size {batch} not divisible by grad_accumulation "
                         f"{training.grad_accumulation}")
    checker = conf.checker.make()
    dtype = compute_dtype(conf)
    logger.info(f"device: {device}; dtype: {str(dtype).removeprefix('torch.')}")

    # the student takes drop-path (reference :47-49), the teacher none
    student = conf.arch.make(dtype=dtype, drop_path=task.student_drop_path)
    teacher = conf.arch.make(dtype=dtype, drop_path=0.0)
    if conf.finetune:
        sd_s, sd_t = load_dino_checkpoint(conf.finetune)
        student.load_state_dict(sd_s, strict=True)
        teacher.load_state_dict(sd_s if sd_t is None else sd_t, strict=True)
        logger.info(f"loaded pretrained weights from {conf.finetune}")
    else:
        student.reset_parameters(torch.Generator().manual_seed(conf.seed))
        teacher.load_state_dict(student.state_dict())
    student.to(device)
    teacher.to(device).requires_grad_(False)

    # schedules (reference :132-142)
    n_iter = EPOCH_LEN * training.epoch
    lr_schedule = make_schedule(training, EPOCH_LEN)
    wd_sched = cosine_schedule(training.weight_decay, task.weight_decay_end, n_iter)
    momentum_sched = cosine_schedule(task.teacher_momentum, 1.0, n_iter)
    temp_sched = L.teacher_temperature_schedule(
        task.warmup_teacher_temperature, task.teacher_temperature,
        task.warmup_teacher_temperature_epoch, training.epoch)
    optimizer, train_step = make_dino_train_step(training, student, lr_schedule, wd_sched,
                                                 n_crop)
    state = DINOTrainState(student, teacher, optimizer,
                           torch.zeros((1, conf.arch.dim_head_out), device=device))
    augment = make_dino_device_augment(task.n_local_crop)
    generator = torch.Generator(device=device).manual_seed(conf.seed)
    aug_generator = torch.Generator(device=device).manual_seed(conf.seed + 23)

    final_metrics: dict = {}
    for epoch in range(training.epoch):
        t0 = time.perf_counter()
        freeze = epoch < task.freeze_last_layer
        n_steps, loss_sum, prev = 0, None, None
        for host_batch in synthetic_dino_batches(batch, task.global_crop_size,
                                                 task.local_crop_size, task.n_local_crop,
                                                 EPOCH_LEN, seed=epoch):
            it = state.step
            crops = augment(aug_generator,
                            torch.from_numpy(host_batch["globals"]).to(device),
                            torch.from_numpy(host_batch["locals"]).to(device))
            if conf.log_freq and n_steps % conf.log_freq == 0 and prev is not None:
                logger.info(f"epoch {epoch}; {n_steps}/{EPOCH_LEN}; "
                            f"loss: {float(prev['loss']):.5f}; "
                            f"lr: {lr_schedule(max(state.step - 1, 0)):.6f}; "
                            f"img/s: {batch * n_steps / max(time.perf_counter() - t0, 1e-9):.1f}")
            prev = train_step(state, crops, generator, temp_sched[epoch],
                              momentum_sched[min(it, n_iter - 1)], freeze)
            loss_sum = prev["loss"] if loss_sum is None else loss_sum + prev["loss"]
            n_steps += 1
        loss = float(loss_sum) / n_steps if n_steps else float("nan")
        dt = time.perf_counter() - t0
        final_metrics = {
            "epoch": epoch,
            "loss": loss,
            "lr": lr_schedule(max(state.step - 1, 0)),
            "weight_decay": wd_sched[min(state.step - 1, n_iter - 1)],
            "images_per_sec": batch * n_steps / dt,
        }
        checker.log(step=epoch, **final_metrics)
        checker.checkpoint(dino_checkpoint(state, epoch), f"epoch-{epoch + 1:03d}")
    return final_metrics
