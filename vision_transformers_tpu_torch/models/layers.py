"""Shared layers (counterpart of ``vision_transformers_tpu/models/layers.py``).

Module and parameter names follow the reference torch code
(models/layer.py), so its ``state_dict`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

__all__ = ["layer_norm", "LayerNorm", "FeedForward", "dropout", "drop_path_scale",
           "patchify", "scaled", "pair", "dense", "kernel_weights", "f32_out_product"]


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


def dense(x: torch.Tensor, linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``linear`` applied in the compute dtype as the JAX package's
    ``dense_apply`` (models/layers.py:121-131): x and the weight cast to
    ``dtype``, the product accumulated in f32 and rounded to ``dtype``, then
    the bias, cast to ``dtype``, added there.  In f32 the Linear itself."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        return linear(x)
    y = torch.matmul(x.to(dtype), linear.weight.to(dtype).t())
    return y if linear.bias is None else y + linear.bias.to(dtype)


def kernel_weights(linear: nn.Linear, dtype: torch.dtype):
    """(weight, bias) of ``linear`` as the layer kernels take them: the
    weight as its [in, out] view, both in the compute ``dtype`` (the JAX
    models cast the parameters at each use; they stay f32 here), the bias
    None where there is none."""
    bias = linear.bias
    return linear.weight.t().to(dtype), None if bias is None else bias.to(dtype)


class _F32OutProduct(torch.autograd.Function):
    """a·bᵀ of two compute-dtype operands with an f32 result; its backward
    takes the f32 cotangent and rounds each operand's f32 gradient once to
    the operand's dtype (JAX's transpose of a dot with
    ``preferred_element_type``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b.t(), out_dtype=torch.float32)
        # no CPU kernel for mm's out_dtype form: the operands' product in f32
        return a.float() @ b.float().t()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = (g @ b.float()).to(a.dtype) if ctx.needs_input_grad[0] else None
        db = (g.t() @ a.float()).to(b.dtype) if ctx.needs_input_grad[1] else None
        return da, db


def f32_out_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] · bᵀ (b [N, K]) with an f32 result, the operands in their
    (compute) dtype: the JAX package's ``lax.dot(a, b,
    preferred_element_type=float32)`` (models/vit.py:620-625) — on the card
    ``torch.mm(..., out_dtype=torch.float32)``, on the CPU the product of
    the same operands in f32 — differentiable in both."""
    return _F32OutProduct.apply(a, b)


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
    (:func:`dropout`).  ``dtype``: the compute dtype of both Linears
    (:func:`dense`); the parameters stay f32."""

    def __init__(self, in_dim: int, dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Linear(in_dim, dim), nn.SiLU(), nn.Identity(),
                         nn.Linear(dim, in_dim))
        self.rate = dropout
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self[1](dense(x, self[0], self.dtype))
        if self.training:
            h = dropout(h, self.rate, generator)
        return dense(h, self[3], self.dtype)


def drop_path_scale(b: int, rate: float, generator: torch.Generator | None,
                    device: torch.device | str, pack: int = 1,
                    n: int | None = None) -> torch.Tensor | None:
    """DropPath scale (reference models/layer.py:166-183, the JAX package's
    ``drop_path``, layers.py:215-229, and ``TransformerLayer._row_scale``,
    vit.py:174-187): keep-mask / keep-prob, the mask Bernoulli(1 − rate)
    from ``generator``; None at rate 0.  Per sample [b] where a row is one
    crop; token level [b, pack·n] where ``pack`` crops of ``n`` tokens share
    a row: one draw per (row, crop), repeated over the crop's tokens."""
    if rate == 0.0:
        return None
    keep = 1.0 - rate
    if pack == 1:
        mask = torch.rand(b, generator=generator, device=device) < keep
        return mask.float() / keep
    mask = torch.rand((b, pack), generator=generator, device=device) < keep
    return mask.float().repeat_interleave(n, dim=1) / keep


def scaled(h: torch.Tensor, rs: torch.Tensor | None) -> torch.Tensor:
    """h ⊙ rs per sample ([b], the leading dim) or per token ([b, n], the
    leading two); rs None leaves h as it is."""
    if rs is None:
        return h
    return h * rs.to(h.dtype).reshape(*rs.shape, *([1] * (h.ndim - rs.ndim)))


def patchify(x: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, D] → [B, H/s, W/s, s·s·D], feature order (sy, sx, d) (the
    JAX package's models/swin.py:47-53; reference swin_transformer.py:15-22)."""
    b, h, w, d = x.shape
    x = x.reshape(b, h // size, size, w // size, size, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // size, w // size, size * size * d)


def pair(v: Any) -> tuple[int, int]:
    """An int or a 2-sequence as (h, w)."""
    return (v, v) if isinstance(v, int) else tuple(v)
