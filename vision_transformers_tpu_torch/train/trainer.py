"""Classification trainer (counterpart of
``vision_transformers_tpu/train/trainer.py::train_classification``;
reference: train.py:89-386), stage 0 on one card.

Each epoch: the train loop, the valid loop (the EMA model when ``ema > 0``),
``checker.log`` and an ``epoch-NNN.pt`` checkpoint.  Data come from the
synthetic backend, as the JAX trainer's (trainer.py:85-102): ``data_backend``
``synthetic``, or ``auto`` without ``<dataset_path>/train.rec``.

The compute dtype follows the conf as in the JAX trainer
(trainer.py:58-61): ``precision=bf16`` (the schema's default) or ``fp16``
computes in bf16, ``precision=f32`` in f32; the parameters, the optimizer,
the EMA and the checkpoints stay f32 either way.  bf16 is ported for arch
types ``vit``, ``swin_transformer`` and ``halo_transformer`` (this
trainer) and ``dino`` (``train/dino.py``); PVT and Twins at bf16 raise
NotImplementedError (ROADMAP.md §A2's bf16 queue) and run with
``precision=f32``.

Not ported yet (each raises NotImplementedError, see ROADMAP): the records
loader and its augmentation, progressive resizing (``progressive.step >
0``), ``resume``, ``profile_dir`` and more than one device.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ..config.schema import ImageNetConfig
from ..data.synthetic import SyntheticDataset
from ..utils.logging import get_logger
from ..utils.weights import load_checkpoint
from . import checkpoint as ckpt
from . import engine
from .optim import make_optimizer
from .schedule import make_schedule

__all__ = ["train_classification", "check_supported", "to_device", "compute_dtype",
           "full_precision_products", "BF16_ARCHS"]

# the arch types whose models compute in bf16 on the card
BF16_ARCHS = ("vit", "swin_transformer", "dino", "halo_transformer")


def compute_dtype(conf: ImageNetConfig) -> torch.dtype:
    """The JAX trainer's ``_compute_dtype`` (trainer.py:58-61): bf16 for
    ``precision=bf16`` or ``fp16``, else f32."""
    return torch.bfloat16 if conf.precision == "bf16" or conf.fp16 else torch.float32


def full_precision_products() -> None:
    """The training entry points' product numerics on the card: f32 stays
    full precision (no TF32 in the conv or the matmuls), and bf16 products
    reduce in f32, as XLA's do (cuBLAS may otherwise sum partial products
    in bf16)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def check_supported(conf: ImageNetConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    todo = "is not ported yet (ROADMAP.md, queue A)"
    if conf.precision not in ("f32", "bf16"):
        raise NotImplementedError(
            f"precision={conf.precision!r}: the port computes in f32 or bf16")
    if compute_dtype(conf) == torch.bfloat16 and conf.arch.type not in BF16_ARCHS:
        raise NotImplementedError(
            f"precision={conf.precision!r} fp16={conf.fp16} for arch type "
            f"{conf.arch.type!r}: bf16 is ported for {', '.join(BF16_ARCHS)}; PVT's and "
            f"Twins' bf16 forms are ROADMAP.md §A2's bf16 queue (run them with "
            f"precision=f32)")
    if conf.n_device > 1:
        raise NotImplementedError(f"n_device={conf.n_device}: multi-GPU {todo}")
    if conf.training.progressive.step > 0:
        raise NotImplementedError(f"progressive resizing {todo}")
    if conf.resume:
        raise NotImplementedError(f"resume={conf.resume!r}: resume {todo}")
    if conf.profile_dir:
        raise NotImplementedError(f"profile_dir {todo}")
    backend = conf.data_backend
    if backend == "auto":
        has_records = os.path.exists(os.path.join(conf.dataset_path, "train.rec"))
        backend = "records" if has_records else "synthetic"
    if backend != "synthetic":
        raise NotImplementedError(f"data_backend {backend!r}: the records loader {todo}")


def _loaders(conf: ImageNetConfig) -> Tuple[Callable[[int], Iterator[dict]],
                                            Callable[[], Iterator[dict]], int]:
    """(train_iter(epoch), valid_iter(), epoch_len), as the JAX trainer's
    synthetic branch builds them (trainer.py:85-102)."""
    training = conf.training
    batch = training.dataloader.batch_size
    n_class = getattr(conf.arch, "n_class", 1000)
    valid_ds = SyntheticDataset(batch * 2, training.valid_size, n_class,
                                seed=conf.seed + 1, normalized=True)
    n_train = max(batch * 4, 64)
    train_ds = SyntheticDataset(n_train, training.train_size, n_class,
                                seed=conf.seed, normalized=True)
    return (lambda epoch: train_ds.batches(batch, seed=epoch),
            lambda: valid_ds.batches(batch), max(n_train // batch, 1))


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch → tensors on ``device``; NHWC → NCHW happens there."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
           for k, v in batch.items()}
    out["image"] = out["image"].permute(0, 3, 1, 2)
    out["label1"], out["label2"] = out["label1"].long(), out["label2"].long()
    return out


def train_classification(conf: ImageNetConfig, device: torch.device | str = "cuda") -> dict:
    """Run the classification recipe on ``device``; returns the last
    epoch's metrics."""
    check_supported(conf)
    logger = get_logger()
    device = torch.device(device)
    training = conf.training
    batch = training.dataloader.batch_size
    accum = training.grad_accumulation
    if batch % accum:
        raise ValueError(f"batch_size {batch} must be divisible by "
                         f"grad_accumulation {accum}")
    checker = conf.checker.make()
    dtype = compute_dtype(conf)
    logger.info(f"device: {device}; dtype: {str(dtype).replace('torch.', '')}")

    model = conf.arch.make(dtype=dtype) if dtype != torch.float32 else conf.arch.make()
    if conf.finetune:
        model.load_state_dict(load_checkpoint(conf.finetune), strict=True)
        logger.info(f"loaded pretrained weights from {conf.finetune}")
    else:
        model.reset_parameters(torch.Generator().manual_seed(conf.seed))
    model.to(device)

    train_iter, valid_iter, epoch_len = _loaders(conf)
    schedule = make_schedule(training, epoch_len)
    state = engine.create_train_state(
        model, make_optimizer(training, model, schedule), ema=training.ema)
    generator = torch.Generator(device=device).manual_seed(conf.seed)
    eval_model = state.ema_model if state.ema_model is not None else model

    final_metrics: dict = {}
    for epoch in range(training.epoch):
        # ---- train; the epoch loss accumulates on the device ----
        t0 = time.perf_counter()
        img_count, n_steps, loss_sum, prev = 0, 0, None, None
        for host_batch in train_iter(epoch):
            if conf.log_freq and n_steps % conf.log_freq == 0 and prev is not None:
                logger.info(f"epoch {epoch}; {n_steps}/{epoch_len}; "
                            f"loss: {float(prev['loss']):.5f}; "
                            f"lr: {schedule(max(state.step - 1, 0)):.5f}; "
                            f"img/s: {img_count / max(time.perf_counter() - t0, 1e-9):.1f}")
            prev = engine.train_step(
                state, to_device(host_batch, device), generator,
                grad_accumulation=accum, ema=training.ema,
                clip_grad_norm=training.clip_grad_norm)
            loss_sum = prev["loss"] if loss_sum is None else loss_sum + prev["loss"]
            img_count += batch
            n_steps += 1
        train_loss = float(loss_sum) / n_steps if n_steps else float("nan")
        dt = time.perf_counter() - t0

        # ---- valid ----
        sums = None
        for host_batch in valid_iter():
            out = engine.eval_step(eval_model, to_device(host_batch, device))
            sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
        sums = {k: float(v) for k, v in sums.items()} if sums else \
            {"loss": 0.0, "prec1": 0.0, "prec5": 0.0, "n": 0.0}
        n = max(sums["n"], 1.0)
        final_metrics = {
            "epoch": epoch,
            "loss": train_loss,
            "valid_loss": sums["loss"] / n,
            "prec1": sums["prec1"] / n,
            "prec5": sums["prec5"] / n,
            "lr": schedule(max(state.step - 1, 0)),
            "images_per_sec": img_count / dt,
        }
        checker.log(step=epoch, **final_metrics)
        checker.checkpoint(ckpt.training_checkpoint(state, epoch), f"epoch-{epoch + 1:03d}")
    return final_metrics
