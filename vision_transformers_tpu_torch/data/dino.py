"""DINO multi-crop augmentation on the device (counterpart of
``vision_transformers_tpu/data/dino.py``; reference transforms.py:216-294).

The host gives uint8 crops, globals [2, B, S, S, 3] and locals [n, B, s, s,
3] (the synthetic backend: :func:`..data.synthetic.synthetic_dino_batches`;
the records loader's multi-crop decode, ``DINOHostLoader``, is not ported).
The device runs the colour stack per crop group, in plain torch: hflip →
ColorJitter (p 0.8) → grayscale (p 0.2) → the group's blur / solarize →
normalize.  The groups' recipes (reference :247-284):

- global 1: blur p = 1.0
- global 2: blur p = 0.1, solarize p = 0.2
- locals:   blur p = 0.5

The n local crops share one recipe and run as one batch of n·B.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from . import ops

__all__ = ["make_dino_device_augment", "augment_crops"]


def augment_crops(generator: torch.Generator, crops_u8: torch.Tensor, blur_p: float,
                  solarize_p: float) -> torch.Tensor:
    """uint8 NHWC crops on the device → normalized float32 NCHW, through the
    colour stack with the given blur and solarize probabilities; every draw
    from ``generator``."""
    x = (crops_u8.float() / 255.0).permute(0, 3, 1, 2).contiguous()
    x = ops.random_hflip(generator, x)
    x = ops.color_jitter(generator, x, brightness=0.4, contrast=0.4, saturation=0.2,
                         hue=0.1, p=0.8)
    x = ops.random_grayscale(generator, x, p=0.2)
    if blur_p > 0:
        x = ops.gaussian_blur(generator, x, p=blur_p)
    if solarize_p > 0:
        x = ops.random_solarize(generator, x, p=solarize_p)
    return ops.normalize_nchw(x)


def make_dino_device_augment(n_local: int) -> Callable[..., List[torch.Tensor]]:
    """``augment(generator, globals_u8 [2, B, S, S, 3], locals_u8 [n, B, s, s,
    3])`` → the 2 + n crops, each normalized float32 NCHW [B, 3, ., .], on
    the tensors' device: global 1, global 2, then the locals."""

    def augment(generator, globals_u8: torch.Tensor,
                locals_u8: torch.Tensor) -> List[torch.Tensor]:
        crops = [augment_crops(generator, globals_u8[0], blur_p=1.0, solarize_p=0.0),
                 augment_crops(generator, globals_u8[1], blur_p=0.1, solarize_p=0.2)]
        if n_local:
            b = locals_u8.shape[1]
            local = augment_crops(generator, locals_u8.reshape(-1, *locals_u8.shape[2:]),
                                  blur_p=0.5, solarize_p=0.0)
            crops += list(local.split(b))
        return crops

    return augment
