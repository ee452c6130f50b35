"""On-device input ops (counterpart of ``vision_transformers_tpu/data/ops.py``):
``normalize`` (the serving path) and DINO's colour ops (reference
transforms.py:216-294; JAX data/ops.py:59-66,228-337), in plain torch on
the images' device, over a whole batch.

Each DINO op is split into a draw and an apply: ``draw_*`` draws the
per-sample parameters from a ``torch.Generator`` (one Bernoulli gate a
sample, and the op's own parameters), ``apply_*`` takes them as tensors, so
a test can feed the apply the draws the JAX package made; ``random_hflip``,
``color_jitter``, ``random_grayscale``, ``gaussian_blur`` and
``random_solarize`` are draw-then-apply.  The colour ops take float NCHW
images in [0, 1]; their arithmetic is the JAX package's, in its order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize", "normalize_nchw",
           "draw_hflip", "apply_hflip", "random_hflip",
           "draw_color_jitter", "apply_color_jitter", "color_jitter",
           "draw_grayscale", "apply_grayscale", "random_grayscale",
           "draw_gaussian_blur", "apply_gaussian_blur", "gaussian_blur",
           "draw_solarize", "apply_solarize", "random_solarize"]


def normalize(images: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """uint8/float [0,255] NHWC → normalized float32 (ToTensor + Normalize),
    on the images' device."""
    x = images.float() / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (x - mean) / std


def normalize_nchw(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Float NCHW in [0, 1] → (x − mean) / std per channel."""
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)[:, None, None]
    std = torch.tensor(std, dtype=torch.float32, device=x.device)[:, None, None]
    return (x - mean) / std


def _bernoulli(b: int, p: float, generator, device) -> torch.Tensor:
    return torch.rand(b, generator=generator, device=device) < p


def _uniform(b: int, lo: float, hi: float, generator, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(b, generator=generator, device=device)


def _per_sample(t: torch.Tensor) -> torch.Tensor:
    """[b] → [b, 1, 1, 1], to broadcast over an NCHW batch."""
    return t.reshape(-1, 1, 1, 1)


# ---------------------------------------------------------------------------
# horizontal flip
# ---------------------------------------------------------------------------


def draw_hflip(b: int, p: float = 0.5, generator: Optional[torch.Generator] = None,
               device="cpu") -> torch.Tensor:
    return _bernoulli(b, p, generator, device)


def apply_hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_sample(flip), x.flip(-1), x)


def random_hflip(generator, x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    return apply_hflip(x, draw_hflip(x.shape[0], p, generator, x.device))


# ---------------------------------------------------------------------------
# ColorJitter (torchvision-style, random op order, applied with probability p)
# ---------------------------------------------------------------------------


def _gray(x: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] → [B, H, W] luma (JAX ``_rgb_to_gray``)."""
    return x[:, 0] * 0.299 + x[:, 1] * 0.587 + x[:, 2] * 0.114


def draw_color_jitter(b: int, brightness: float = 0.4, contrast: float = 0.4,
                      saturation: float = 0.2, hue: float = 0.1, p: float = 0.8,
                      generator: Optional[torch.Generator] = None,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Per sample: ``gate`` (apply at all), the brightness / contrast /
    saturation factors ``fb`` / ``fc`` / ``fs``, the hue shift ``fh`` and
    ``order`` [b, 4], a permutation of the four ops."""
    return {
        "gate": _bernoulli(b, p, generator, device),
        "fb": _uniform(b, 1 - brightness, 1 + brightness, generator, device),
        "fc": _uniform(b, 1 - contrast, 1 + contrast, generator, device),
        "fs": _uniform(b, 1 - saturation, 1 + saturation, generator, device),
        "fh": _uniform(b, -hue, hue, generator, device),
        "order": torch.rand((b, 4), generator=generator, device=device).argsort(dim=1),
    }


def _jitter_ops(d: Dict[str, torch.Tensor]):
    fb, fc, fs = (_per_sample(d[k].float()) for k in ("fb", "fc", "fs"))
    theta = 2.0 * math.pi * d["fh"].float()
    cos, sin = theta.cos()[:, None, None], theta.sin()[:, None, None]

    def brightness(x):
        return torch.clamp(x * fb, 0.0, 1.0)

    def contrast(x):
        mean = _gray(x).mean(dim=(1, 2))[:, None, None, None]
        return torch.clamp(mean + fc * (x - mean), 0.0, 1.0)

    def saturation(x):
        g = _gray(x)[:, None]
        return torch.clamp(g + fs * (x - g), 0.0, 1.0)

    def hue(x):  # a hue rotation in YIQ
        r, g, b = x[:, 0], x[:, 1], x[:, 2]
        y = _gray(x)
        i = 0.596 * r - 0.274 * g - 0.322 * b
        q = 0.211 * r - 0.523 * g + 0.312 * b
        i2 = cos * i - sin * q
        q2 = sin * i + cos * q
        out = torch.stack([y + 0.956 * i2 + 0.621 * q2, y - 0.272 * i2 - 0.647 * q2,
                           y - 1.106 * i2 + 1.703 * q2], dim=1)
        return torch.clamp(out, 0.0, 1.0)

    return (brightness, contrast, saturation, hue)


def apply_color_jitter(x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The four ops in each sample's ``order``, where its ``gate`` is set."""
    ops = _jitter_ops(draws)
    out = x
    for slot in range(4):
        pick, prev = draws["order"][:, slot], out
        for k, op in enumerate(ops):
            out = torch.where(_per_sample(pick == k), op(prev), out)
    return torch.where(_per_sample(draws["gate"]), out, x)


def color_jitter(generator, x: torch.Tensor, brightness=0.4, contrast=0.4,
                 saturation=0.2, hue=0.1, p=0.8) -> torch.Tensor:
    return apply_color_jitter(x, draw_color_jitter(x.shape[0], brightness, contrast,
                                                   saturation, hue, p, generator,
                                                   x.device))


# ---------------------------------------------------------------------------
# grayscale, gaussian blur, solarize
# ---------------------------------------------------------------------------


def draw_grayscale(b: int, p: float = 0.2, generator: Optional[torch.Generator] = None,
                   device="cpu") -> torch.Tensor:
    return _bernoulli(b, p, generator, device)


def apply_grayscale(x: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_sample(take), _gray(x)[:, None].expand_as(x), x)


def random_grayscale(generator, x: torch.Tensor, p: float = 0.2) -> torch.Tensor:
    return apply_grayscale(x, draw_grayscale(x.shape[0], p, generator, x.device))


RADIUS_MAX = 2.0


def draw_gaussian_blur(b: int, p: float = 0.5, radius_min: float = 0.1,
                       radius_max: float = RADIUS_MAX,
                       generator: Optional[torch.Generator] = None,
                       device="cpu") -> Dict[str, torch.Tensor]:
    """``gate`` and the per-sample ``radius`` (uniform in [min, max])."""
    return {"gate": _bernoulli(b, p, generator, device),
            "radius": _uniform(b, radius_min, radius_max, generator, device)}


def apply_gaussian_blur(x: torch.Tensor, draws: Dict[str, torch.Tensor],
                        radius_max: float = RADIUS_MAX) -> torch.Tensor:
    """The true separable gaussian at sigma = radius over edge-extended
    padding (PIL extends border pixels), a kernel 2·⌈3·radius_max⌉ + 1 wide,
    vertical pass then horizontal (JAX data/ops.py:282-325)."""
    B, C, H, W = x.shape
    kmax = int(math.ceil(radius_max * 3)) * 2 + 1
    half = kmax // 2
    offsets = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    sigma = torch.clamp(draws["radius"].float(), min=1e-3)[:, None]
    kern = torch.exp(-0.5 * (offsets / sigma) ** 2)
    kern = (kern / kern.sum(-1, keepdim=True)).repeat_interleave(C, dim=0)  # [B·C, k]
    y = F.pad(x, (half, half, half, half), mode="replicate").reshape(1, B * C, H + 2 * half,
                                                                    W + 2 * half)
    y = F.conv2d(y, kern[:, None, :, None], groups=B * C)
    y = F.conv2d(y, kern[:, None, None, :], groups=B * C).reshape(B, C, H, W)
    return torch.where(_per_sample(draws["gate"]), y, x)


def gaussian_blur(generator, x: torch.Tensor, p: float = 0.5, radius_min: float = 0.1,
                  radius_max: float = RADIUS_MAX) -> torch.Tensor:
    return apply_gaussian_blur(
        x, draw_gaussian_blur(x.shape[0], p, radius_min, radius_max, generator, x.device),
        radius_max)


def draw_solarize(b: int, p: float = 0.2, generator: Optional[torch.Generator] = None,
                  device="cpu") -> torch.Tensor:
    return _bernoulli(b, p, generator, device)


def apply_solarize(x: torch.Tensor, take: torch.Tensor,
                   threshold: float = 0.5) -> torch.Tensor:
    """Tensor solarize on [0, 1] images (reference Solarize at 128)."""
    return torch.where(_per_sample(take), torch.where(x < threshold, x, 1.0 - x), x)


def random_solarize(generator, x: torch.Tensor, threshold: float = 0.5,
                    p: float = 0.2) -> torch.Tensor:
    return apply_solarize(x, draw_solarize(x.shape[0], p, generator, x.device), threshold)
