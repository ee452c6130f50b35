"""Pyramid Vision Transformer classifier (counterpart of
``vision_transformers_tpu/models/pvt.py``; reference: models/pvt.py).

Four stages, each a strided-conv patch embedding and pre-LN layers whose
attention is spatial-reduction attention (SRA): q over the stage's tokens,
k / v over the tokens of a strided conv of the map (+ LayerNorm) where the
stage's reduction is > 1.  The attention itself dispatches through
:func:`ops.sra_impl` (the JAX ``sra_attention_impl``): ``fused`` runs
:func:`ops.fused_attention` on the projections' head views,
``einsum`` (the default) its plain torch version.

Module names are the reference torch ``state_dict`` keys (the inverse of
the JAX package's ``utils/torch_convert.py::_convert_pvt``):
``patch_embedding.{s}.{conv, norm, pos, cls_token}``, ``block{s}.{i}.
{norm_attn, attn.{linear_q, linear_kv, linear, reduce_conv, reduce_norm},
norm_ff, ff.0, ff.3}``, ``norm`` and ``classifier``.  Images are NCHW;
tokens are [b, h·w (+1), C] in row-major map order.

Reference quirks reproduced: q / kv projections without bias, the output
projection with one; the cls token only in the last stage, the position
embedding added after the cls concat; the final LayerNorm on the cls token
only; LayerNorm eps 1e-6; the DropPath ramp ``drop_path·i/(total − 1)``
with two per-sample draws per layer (attention and FF branch) from an
explicit ``torch.Generator``.  The reference's ``prev`` score chain, which
its own layers never feed, is dropped.  dropout, drop_attn and drop_ff > 0
in training raise NotImplementedError; remat is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch import nn

from .. import ops
from ..config.registry import TypedConfig, register
from ..ops.fused_attention import fused_attention_reference
from .layers import FeedForward, LayerNorm, drop_path_scale, pair, scaled

__all__ = ["reduced_kv_attention", "SpatialReductionAttention", "PVTLayer",
           "PVTPatchEmbedding", "PyramidVisionTransformer", "PVTConfig"]

_LN_EPS = 1e-6  # reference: models/pvt.py:9


def reduced_kv_attention(q: torch.Tensor, kv: torch.Tensor, n_head: int) -> torch.Tensor:
    """softmax(q·kᵀ/√D)·v per head: q [b, M, C] (the query projection), kv
    [b, N, 2C] (k lanes, then v lanes) → [b, M, C]; the heads are strided
    views of the projections, the path :func:`ops.sra_impl`'s (PVT's SRA
    and Twins' GSA share it)."""
    b, M, C = q.shape
    D = C // n_head

    def heads(t):
        return t.reshape(b, -1, n_head, D).permute(0, 2, 1, 3)

    qh, kh, vh = heads(q), heads(kv[..., :C]), heads(kv[..., C:])
    attend = ops.fused_attention if ops.sra_impl(kv.shape[1]) == "fused" \
        else fused_attention_reference
    return attend(qh, kh, vh, None, 1.0 / math.sqrt(D)).transpose(1, 2).reshape(b, M, C)


class SpatialReductionAttention(nn.Module):
    """MHSA with strided-conv k / v reduction (reference: models/pvt.py:12-69)."""

    def __init__(self, dim: int, n_head: int, reduction: int = 1):
        super().__init__()
        self.n_head, self.reduction = n_head, reduction
        self.linear_q = nn.Linear(dim, dim, bias=False)
        self.linear_kv = nn.Linear(dim, 2 * dim, bias=False)
        self.linear = nn.Linear(dim, dim)
        if reduction > 1:
            self.reduce_conv = nn.Conv2d(dim, dim, reduction, stride=reduction)
            self.reduce_norm = LayerNorm(dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor, height: int, width: int) -> torch.Tensor:
        """x [b, n, C] (n = height·width, or with the cls token where
        reduction = 1) → [b, n, C]."""
        b, _, C = x.shape
        kv_in = x
        if self.reduction > 1:
            fmap = x.transpose(1, 2).reshape(b, C, height, width)
            red = self.reduce_conv(fmap).reshape(b, C, -1).transpose(1, 2)
            kv_in = self.reduce_norm(red)
        out = reduced_kv_attention(self.linear_q(x), self.linear_kv(kv_in), self.n_head)
        return self.linear(out)


class PVTLayer(nn.Module):
    """Pre-LN layer with SRA and a SiLU FF (reference: models/pvt.py:72-103)."""

    def __init__(self, dim: int, n_head: int, dim_ff: int, reduction: int = 1,
                 drop_ff: float = 0.0):
        super().__init__()
        self.norm_attn = LayerNorm(dim, eps=_LN_EPS)
        self.attn = SpatialReductionAttention(dim, n_head, reduction)
        self.norm_ff = LayerNorm(dim, eps=_LN_EPS)
        self.ff = FeedForward(dim, dim_ff, dropout=drop_ff)

    def forward(self, x: torch.Tensor, height: int, width: int, rs=None) -> torch.Tensor:
        """``rs``: pre-drawn DropPath scales ``(rs_attn, rs_ff)``, each None
        or [b]."""
        rs_attn, rs_ff = (None, None) if rs is None else rs
        x = x + scaled(self.attn(self.norm_attn(x), height, width), rs_attn)
        return x + scaled(self.ff(self.norm_ff(x)), rs_ff)


class PVTPatchEmbedding(nn.Module):
    """Strided conv → LN → (cls token) → + learned position embedding
    (reference: models/pvt.py:106-148)."""

    def __init__(self, in_dim: int, dim: int, patch: int, n_patch: int,
                 cls_token: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_dim, dim, patch, stride=patch)
        self.norm = LayerNorm(dim, eps=_LN_EPS)
        self.pos = nn.Parameter(torch.zeros(n_patch + (1 if cls_token else 0), dim))
        self.cls_token = nn.Parameter(torch.zeros(dim)) if cls_token else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """NCHW map → (tokens [b, h·w (+1), C], (h, w))."""
        out = self.conv(x)
        b, C, h, w = out.shape
        out = self.norm(out.flatten(2).transpose(1, 2))
        if self.cls_token is not None:
            out = torch.cat([self.cls_token.to(out.dtype).expand(b, 1, C), out], 1)
        return out + self.pos.to(out.dtype), (h, w)


class PyramidVisionTransformer(nn.Module):
    """4-stage PVT (reference: models/pvt.py:151-280).  Parameters start at
    torch's default init: call :meth:`reset_parameters` for the JAX model's
    initializers, or ``load_state_dict`` real weights."""

    def __init__(self, image_size, n_class: int, depths, patch_embed_dims, n_heads,
                 dim_ffs, reductions, drop_ff: float = 0.0, drop_attn: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        h, w = pair(image_size)
        embeds, in_dim = [], 3
        for s, (depth, patch) in enumerate(zip(depths, (4, 2, 2, 2))):
            h, w = h // patch, w // patch
            dim = patch_embed_dims[s]
            embeds.append(PVTPatchEmbedding(in_dim, dim, patch, h * w,
                                            cls_token=s == len(depths) - 1))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                PVTLayer(dim, n_heads[s], dim_ffs[s], reductions[s], drop_ff)
                for _ in range(depth)))
            in_dim = dim
        self.patch_embedding = nn.ModuleList(embeds)
        self.norm = LayerNorm(patch_embed_dims[-1], eps=_LN_EPS)
        self.classifier = nn.Linear(patch_embed_dims[-1], n_class)
        self.n_stages = len(depths)
        self._dropout = drop_attn > 0 or drop_ff > 0
        total = sum(depths)
        self.drop_path_rates = [drop_path * i / max(total - 1, 1) for i in range(total)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX model's initializers: normal(0.02) for every Linear and
        Conv kernel (``trunc_normal_init(0.02)`` is a plain normal,
        layers.py:92-95) and for the position embeddings and the cls token,
        zeros for the biases, ones / zeros for the LayerNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, PVTPatchEmbedding):
                m.pos.normal_(0.0, 0.02, generator=generator)
                if m.cls_token is not None:
                    m.cls_token.normal_(0.0, 0.02, generator=generator)

    def draw_drop_path(self, b: int, generator: torch.Generator | None = None):
        """Per-layer ``(rs_attn, rs_ff)``: two independent [b] keep-mask /
        keep-prob draws from ``generator`` (None at rate 0), on the model's
        device."""
        device = self.classifier.weight.device
        return [(drop_path_scale(b, r, generator, device),
                 drop_path_scale(b, r, generator, device))
                for r in self.drop_path_rates]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NCHW images; in training mode DropPath draws from
        ``generator``."""
        if self.training and self._dropout:
            raise NotImplementedError(
                "drop_attn / drop_ff > 0 in training is not ported (ROADMAP); "
                "PVT-S trains with both at 0")
        scales = iter(self.draw_drop_path(x.shape[0], generator) if self.training
                      else [None] * len(self.drop_path_rates))
        out = x
        for s in range(self.n_stages):
            out, (h, w) = self.patch_embedding[s](out)
            for layer in getattr(self, f"block{s + 1}"):
                out = layer(out, h, w, next(scales))
            if s < self.n_stages - 1:
                out = out.transpose(1, 2).reshape(out.shape[0], -1, h, w)
        return self.classifier(self.norm(out[:, 0]).float())


@register("model", "pvt")
@dataclasses.dataclass
class PVTConfig(TypedConfig):
    """PVT classifier (same fields and PVT-Small defaults as the JAX
    package's PVTConfig, pvt.py:226-258; Wang et al., 2021)."""

    image_size: Any = 224
    n_class: int = 1000
    depths: Tuple[int, int, int, int] = (3, 4, 6, 3)
    patch_embed_dims: Tuple[int, int, int, int] = (64, 128, 320, 512)
    n_heads: Tuple[int, int, int, int] = (1, 2, 5, 8)
    dim_ffs: Tuple[int, int, int, int] = (512, 1024, 1280, 2048)
    reductions: Tuple[int, int, int, int] = (8, 4, 2, 1)
    drop_ff: float = 0.0
    drop_attn: float = 0.0
    drop_path: float = 0.1
    remat: bool = False

    def make(self) -> PyramidVisionTransformer:
        if self.remat:
            raise NotImplementedError("arch.remat is not ported")
        return PyramidVisionTransformer(
            image_size=self.image_size, n_class=self.n_class, depths=self.depths,
            patch_embed_dims=self.patch_embed_dims, n_heads=self.n_heads,
            dim_ffs=self.dim_ffs, reductions=self.reductions, drop_ff=self.drop_ff,
            drop_attn=self.drop_attn, drop_path=self.drop_path)
