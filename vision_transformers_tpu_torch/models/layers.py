"""Shared layers (counterpart of ``vision_transformers_tpu/models/layers.py``).

Module and parameter names follow the reference torch code
(models/layer.py), so its ``state_dict`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

__all__ = ["layer_norm", "LayerNorm", "FeedForward", "dropout", "drop_path_scale",
           "patchify", "scaled", "pair"]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The JAX package's LayerNorm numerics (``layer_norm_apply``,
    models/layers.py:147-156): f32 statistics, fast variance
    ``E[x²] − μ²``, scale folded into the rsqrt multiplier."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    mul = torch.rsqrt(var + eps) * weight.float()
    return ((xf - mu) * mul + bias.float()).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` parameters (``weight``/``bias``) with the
    :func:`layer_norm` numerics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout`` computes it:
    ``where(mask, x / keep, 0)`` with the mask Bernoulli(keep = 1 − rate)
    drawn from ``generator`` on x's device; x itself at rate 0.  Every
    dropout mask of the port is drawn here, in the JAX models' call order,
    so a test can supply the masks by replacing this one function."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class FeedForward(nn.Sequential):
    """Positionwise FF: Linear → SiLU → Dropout → Linear (reference:
    models/layer.py:186-196), keyed ``0`` / ``3`` as the reference's
    Sequential is; in training the dropout between the activation and the
    second Linear draws its mask from the caller's generator
    (:func:`dropout`)."""

    def __init__(self, in_dim: int, dim: int, dropout: float = 0.0):
        super().__init__(nn.Linear(in_dim, dim), nn.SiLU(), nn.Identity(),
                         nn.Linear(dim, in_dim))
        self.rate = dropout

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self[1](self[0](x))
        if self.training:
            h = dropout(h, self.rate, generator)
        return self[3](h)


def drop_path_scale(b: int, rate: float, generator: torch.Generator | None,
                    device: torch.device | str) -> torch.Tensor | None:
    """Per-sample DropPath scale [b] (reference models/layer.py:166-183, the
    JAX package's ``drop_path``, layers.py:215-229): keep-mask / keep-prob,
    the mask Bernoulli(1 − rate) from ``generator``; None at rate 0."""
    if rate == 0.0:
        return None
    keep = 1.0 - rate
    mask = torch.rand(b, generator=generator, device=device) < keep
    return mask.float() / keep


def scaled(h: torch.Tensor, rs: torch.Tensor | None) -> torch.Tensor:
    """h ⊙ rs per sample (the leading dim); rs None leaves h as it is."""
    return h if rs is None else h * rs.to(h.dtype).reshape(-1, *([1] * (h.ndim - 1)))


def patchify(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, D] → [B, H/s, W/s, s·s·D], feature order (sy, sx, d) (the
    JAX package's models/swin.py:47-53; reference swin_transformer.py:15-22)."""
    b, h, w, d = x.shape
    x = x.reshape(b, h // size, size, w // size, size, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // size, w // size, size * size * d)


def pair(v: Any) -> tuple[int, int]:
    """An int or a 2-sequence as (h, w)."""
    return (v, v) if isinstance(v, int) else tuple(v)
