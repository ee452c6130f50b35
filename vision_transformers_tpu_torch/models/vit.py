"""Vision Transformer classifier (counterpart of
``vision_transformers_tpu/models/vit.py``; reference: models/vit.py).

Module names are the reference torch ``state_dict`` keys
(``patch_embedding.linear``, ``cls_token``, ``pos_embed``,
``layers.{i}.{norm_attn,attn.qkv,attn.linear,norm_ff,ff.0,ff.3}``, ``norm``,
``head``), so a reference ``.pt`` loads with ``strict=True``.  Images are
NCHW.  Each layer dispatches through :func:`ops.attention_impl` as the JAX
layer does (vit.py:229-303): plain torch (``einsum``), the attention-half
kernel (``layer``, with the FF-half kernel too under
:func:`ops.set_ff_kernel`) or the whole-layer kernel (``layer1``) — the
layer kernels only where no dropout is active: in eval, or with
``dropout``, ``drop_attn`` and ``drop_ff`` all 0.  Otherwise the layer runs
as two residual branches, its attention through the packed-qkv kernel
(``fused``, from 32 rows and 128 tokens), through the attention-block kernel
under a ``block`` force (the projections inside it, vit.py:115-122) or,
with attention-probability dropout in training, through the plain einsum
(vit.py:111-113).

In training, DropPath draws one per-sample scale (keep-mask / keep-prob)
per residual branch and layer, at the JAX model's rate ramp
``drop_path·i/(depth−1)`` (vit.py:418), from an explicit
``torch.Generator``; the ``layer`` path hands the scales to the kernels as
their row scales (vit.py:259-280).  Dropout draws its masks from the same
generator through :func:`layers.dropout`, in the JAX model's order: after
the pos-embed add, then per layer the attention probabilities
(``drop_attn``), the attention branch (``dropout``), the FF hidden
(``drop_ff``) and the FF branch (``dropout``).  scan_layers, remat, the
DINO head and crop packing are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..config.registry import TypedConfig, register
from . import layers
from .layers import FeedForward, LayerNorm, drop_path_scale, pair, scaled

__all__ = ["MultiHeadedAttention", "TransformerLayer", "PatchEmbedding",
           "VisionTransformer", "ViTConfig"]

_LN_EPS = 1e-6  # reference: models/vit.py:13



class MultiHeadedAttention(nn.Module):
    """Fused-qkv MHSA (reference: models/vit.py:16-45); ``dropout`` is the
    attention-probability rate (the conf's ``drop_attn``)."""

    def __init__(self, dim: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.qkv = nn.Linear(dim, dim * 3)
        self.linear = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                impl: str = "einsum") -> torch.Tensor:
        """``impl``: "block", the whole block as one op
        (:func:`ops.fused_attention_block`, vit.py:115-122); "fused", the
        packed-qkv kernel between the projections
        (:func:`ops.fused_attention_qkv`, vit.py:124-129) — neither takes
        probability dropout —; else plain torch, with the probabilities'
        dropout in training."""
        b, n, dim = x.shape
        d = dim // self.n_head
        if impl == "block":
            return ops.fused_attention_block(x, self.qkv.weight.t(), self.qkv.bias,
                                             self.linear.weight.t(), self.linear.bias,
                                             self.n_head)
        qkv = self.qkv(x)
        if impl == "fused":
            return self.linear(ops.fused_attention_qkv(qkv, self.n_head))
        q, k, v = qkv.reshape(b, n, 3, self.n_head, d).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        if self.training:
            attn = layers.dropout(attn, self.dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, dim)
        return self.linear(out)


class TransformerLayer(nn.Module):
    """Pre-LN block (reference: models/vit.py:48-66)."""

    def __init__(self, dim: int, n_head: int, dim_ff: int, dropout: float = 0.0,
                 drop_attn: float = 0.0, drop_ff: float = 0.0):
        super().__init__()
        self.norm_attn = LayerNorm(dim, eps=_LN_EPS)
        self.attn = MultiHeadedAttention(dim, n_head, dropout=drop_attn)
        self.norm_ff = LayerNorm(dim, eps=_LN_EPS)
        self.ff = FeedForward(dim, dim_ff, dropout=drop_ff)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, rs=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``rs``: pre-drawn DropPath scales ``(rs_attn, rs_ff)``, each None
        or [b] (the JAX layer's ``rs_override``, vit.py:196-208);
        ``generator``: the dropout masks' source in training."""
        b, n, _ = x.shape
        rs_attn, rs_ff = (None, None) if rs is None else rs
        na, attn, nf, ff = self.norm_attn, self.attn, self.norm_ff, self.ff
        impl = ops.attention_impl(b, default="layer" if n >= 128 else "einsum")
        dropping = self.training and (self.dropout, attn.dropout, ff.rate) != (0, 0, 0)
        attn_w = (na.weight, na.bias, attn.qkv.weight.t(), attn.qkv.bias,
                  attn.linear.weight.t(), attn.linear.bias)
        ff_w = (nf.weight, nf.bias, ff[0].weight.t(), ff[0].bias, ff[3].weight.t(),
                ff[3].bias)
        if impl == "layer1" and not dropping:
            return ops.fused_transformer_layer(
                x, *attn_w, *ff_w, attn.n_head, rs_attn=rs_attn, rs_ff=rs_ff,
                activation="silu", eps=_LN_EPS)
        if impl == "layer" and not dropping:
            x = ops.fused_attention_layer(x, *attn_w, attn.n_head,
                                          row_scale=rs_attn, eps=_LN_EPS)
            if ops.ff_kernel_enabled():
                return ops.fused_ff_layer(x, *ff_w, "silu", rs_ff, _LN_EPS)
            return x + scaled(ff(nf(x)), rs_ff)
        # two residual branches; the attention's own dispatch (vit.py:111-113)
        attn_impl = ops.attention_impl(b, seq=n, default="fused")
        if self.training and attn.dropout > 0:
            attn_impl = "einsum"  # attention dropout needs materialized probs
        drop = (lambda h: layers.dropout(h, self.dropout, generator)) if self.training \
            else (lambda h: h)
        x = x + scaled(drop(attn(na(x), generator, attn_impl)), rs_attn)
        return x + scaled(drop(ff(nf(x), generator)), rs_ff)


class PatchEmbedding(nn.Module):
    """Stride-p conv over p×p patches → [B, h·w, dim] tokens in (h, w)
    row-major order (reference: models/vit.py:69-76)."""

    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.linear = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x).flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """(reference: models/vit.py:79-203).  Parameters start at torch's
    default init (zeros for the embeddings): call :meth:`reset_parameters`
    for the JAX model's initializers, or ``load_state_dict`` real weights."""

    def __init__(self, image_size, patch_size: int, depth: int, dim: int,
                 n_head: int, dim_ff: int, dropout: float = 0.0,
                 drop_attn: float = 0.0, drop_ff: float = 0.0,
                 drop_path: float = 0.0, n_class: int = 1000):
        super().__init__()
        h, w = pair(image_size)
        n_patch = (h // patch_size) * (w // patch_size)
        self.patch_embedding = PatchEmbedding(dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patch + 1, dim))
        self.layers = nn.ModuleList(
            TransformerLayer(dim, n_head, dim_ff, dropout, drop_attn, drop_ff)
            for _ in range(depth))
        self.norm = LayerNorm(dim, eps=_LN_EPS)
        self.head = nn.Linear(dim, n_class)
        self.dropout = dropout  # after the pos-embed add (vit.py:447)
        # per-layer DropPath rates (vit.py:418)
        self.drop_path_rates = [drop_path * i / max(depth - 1, 1)
                                for i in range(depth)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX model's initializers: normal(0.02) for cls_token,
        pos_embed (vit.py:412-417) and every Linear / conv kernel (the JAX
        package's ``trunc_normal_init(0.02)`` is a plain normal,
        layers.py:92-95: qkv, out-proj, FF, patch embedding, head), zeros
        for every bias, ones / zeros for the LayerNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def draw_drop_path(self, b: int, generator: torch.Generator | None = None):
        """Per-layer ``(rs_attn, rs_ff)``: None at rate 0, else [b]
        keep-mask / keep-prob drawn from ``generator`` on the model's device
        (the JAX ``_row_scale``, vit.py:174-187)."""
        device = self.cls_token.device
        return [(drop_path_scale(b, r, generator, device),
                 drop_path_scale(b, r, generator, device))
                for r in self.drop_path_rates]

    def interpolate_pos_embedding(self, n_patch: int) -> torch.Tensor:
        """Bicubic resize of the grid pos-embed when the token count differs
        from the one it was built for (reference: models/vit.py:153-175)."""
        pos_embed = self.pos_embed
        n_pos = pos_embed.shape[1] - 1
        if n_patch == n_pos:
            return pos_embed
        dim = pos_embed.shape[-1]
        side_in, side_out = int(math.sqrt(n_pos)), int(math.sqrt(n_patch))
        grid = pos_embed[:, 1:].reshape(1, side_in, side_in, dim).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(side_out, side_out), mode="bicubic",
                             align_corners=False)
        grid = grid.permute(0, 2, 3, 1).reshape(1, side_out * side_out, dim)
        return torch.cat([pos_embed[:, :1], grid], dim=1)

    def forward_feature(self, x: torch.Tensor,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """(reference: models/vit.py:139-151).  x: NCHW."""
        out = self.patch_embedding(x)
        b, n, dim = out.shape
        cls = self.cls_token.to(out.dtype).expand(b, 1, dim)
        out = torch.cat([cls, out], dim=1)
        out = out + self.interpolate_pos_embedding(n).to(out.dtype)
        scales = [None] * len(self.layers)
        if self.training:
            scales = self.draw_drop_path(b, generator)
            out = layers.dropout(out, self.dropout, generator)
        for layer, rs in zip(self.layers, scales):
            out = layer(out, rs, generator)
        return self.norm(out)[:, 0]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits; in training mode DropPath and dropout draw from
        ``generator``."""
        return self.head(self.forward_feature(x, generator).float())


@register("model", "vit")
@dataclasses.dataclass
class ViTConfig(TypedConfig):
    """Plain ViT classifier (same fields as the JAX package's ViTConfig)."""

    image_size: Any = 224
    window_size: int = 16  # the reference calls the patch size "window_size"
    n_class: int = 1000
    depth: int = 12
    dim: int = 384
    n_head: int = 6
    dim_ff: int = 1536
    dropout: float = 0.0
    drop_attn: float = 0.0
    drop_ff: float = 0.0
    drop_path: float = 0.0
    remat: bool = False
    scan_layers: bool = False

    def make(self) -> VisionTransformer:
        if self.remat or self.scan_layers:
            raise NotImplementedError(
                "arch.remat / arch.scan_layers are not ported")
        return VisionTransformer(
            image_size=self.image_size, patch_size=self.window_size,
            depth=self.depth, dim=self.dim, n_head=self.n_head,
            dim_ff=self.dim_ff, dropout=self.dropout, drop_attn=self.drop_attn,
            drop_ff=self.drop_ff, drop_path=self.drop_path,
            n_class=self.n_class)
