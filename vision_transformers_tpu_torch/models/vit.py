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
(``drop_ff``) and the FF branch (``dropout``).

The multi-crop forward of DINO (vit.py:473-572): a list of crops is grouped
consecutively by size, one batch a group, and ``n_class=None`` returns the
features.  A group of short crops (≤ 64 tokens, DINO's 37-token locals) is
packed 3 or 2 crops to a row for the whole layer stack, a [b/p, p·seq, C]
view under the block-diagonal −1e9 mask ``extra``; the layers run the
'layer' path on the packed rows, B1 taking the mask as its bias, and
DropPath keeps one draw per crop as token-level scales [b/p, p·seq], applied
outside the kernel (``x + rs ⊙ (out − x)``; the FF half in plain torch).
``VTX_PACK_MODEL=0`` turns the packing off, as in the JAX package.  The
pos-embed resize to another grid is the JAX package's torch-bicubic matrix
(vit.py:41-66), applied as two einsums.

``dtype`` (:meth:`ViTConfig.make`, the JAX model's ``dtype``, vit.py:664) is
the compute dtype: bf16 is the JAX package's default precision.  The
parameters stay f32 and are cast at each use, as the JAX modules cast them
(vit.py:106-108, :253-257): the patch embedding's conv in ``dtype`` with its
bias added after (vit.py:322), the cls token and pos-embed cast, the
layers' weights and biases cast before the kernels take them (their
LayerNorm parameters stay f32), every dense in ``dtype``
(:func:`layers.dense`), the final LayerNorm with f32 statistics and a
``dtype`` output, and the head in f32 on the features promoted to f32
(vit.py:450).  Gradients come back to the f32 parameters through the casts.  :class:`DINOModel` is the trunk with
:class:`DINOHead` as its head (vit.py:575-637), in the reference state_dict
layout, both at ``dtype`` (:meth:`DINOConfig.make`, vit.py:707): the head's
MLP in ``dtype``, its L2 normalisation in f32 and its prototype product
with ``dtype`` operands and an f32 result (:func:`layers.f32_out_product`);
the local crops' interpolated pos-embed cast to ``dtype`` after the f32
resize (vit.py:488), their token-level DropPath scales applied to the
kernel's ``out − x`` in ``dtype`` (vit.py:228).  scan_layers and remat are
not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..config.registry import TypedConfig, register
from . import layers
from .layers import (FeedForward, LayerNorm, dense, drop_path_scale, f32_out_product,
                     kernel_weights, pair, scaled)

__all__ = ["MultiHeadedAttention", "TransformerLayer", "PatchEmbedding",
           "VisionTransformer", "ViTConfig", "DINOHead", "DINOModel", "DINOConfig",
           "torch_bicubic_matrix", "crop_pack", "pack_mask"]

_LN_EPS = 1e-6  # reference: models/vit.py:13


@functools.lru_cache(maxsize=None)
def torch_bicubic_matrix(side_in: int, side_out: int) -> np.ndarray:
    """The JAX package's ``_torch_bicubic_matrix`` (vit.py:41-66): W
    [side_out, side_in] of torch's ``F.interpolate(mode="bicubic",
    align_corners=False, antialias=False)`` at ``scale_factor = side_out /
    side_in`` (reference models/vit.py:163-171) — source index
    ``(i + 0.5)·in/out − 0.5``, the 4-tap Keys cubic with A = −0.75, border
    taps clamped onto the edge pixel."""
    A = -0.75

    def k1(x):  # |x| <= 1
        return ((A + 2) * x - (A + 3)) * x * x + 1

    def k2(x):  # 1 < |x| < 2
        return ((A * x - 5 * A) * x + 8 * A) * x - 4 * A

    inv_scale = side_in / side_out
    W = np.zeros((side_out, side_in), np.float64)
    for i in range(side_out):
        src = (i + 0.5) * inv_scale - 0.5
        f = math.floor(src)
        t = src - f
        for tap, w in enumerate((k2(t + 1), k1(t), k1(1 - t), k2(2 - t))):
            W[i, min(max(f - 1 + tap, 0), side_in - 1)] += w
    return W.astype(np.float32)


def crop_pack(b: int, seq: int) -> int:
    """Crops of ``seq`` tokens packed to a row (vit.py:491-502): 3 or 2 where
    seq ≤ 64, b divides by it and the row keeps ≤ 128 tokens; else 1.
    ``VTX_PACK_MODEL=0`` turns it off."""
    if seq <= 64 and os.environ.get("VTX_PACK_MODEL", "1") != "0":
        for p in (3, 2):
            if b % p == 0 and p * seq <= 128:
                return p
    return 1


def pack_mask(pack: int, seq: int, device) -> torch.Tensor:
    """The block-diagonal additive mask [pack·seq, pack·seq] of a packed row:
    0 within a crop, −1e9 across crops (vit.py:506-508)."""
    eye = torch.block_diag(*[torch.ones(seq, seq)] * pack)
    return torch.where(eye > 0, 0.0, -1e9).to(device)



class MultiHeadedAttention(nn.Module):
    """Fused-qkv MHSA (reference: models/vit.py:16-45); ``dropout`` is the
    attention-probability rate (the conf's ``drop_attn``), ``dtype`` the
    compute dtype."""

    def __init__(self, dim: int, n_head: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.dtype = dtype
        self.qkv = nn.Linear(dim, dim * 3)
        self.linear = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                impl: str = "einsum", extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``impl``: "block", the whole block as one op
        (:func:`ops.fused_attention_block`, vit.py:115-122); "fused", the
        packed-qkv kernel between the projections
        (:func:`ops.fused_attention_qkv`, vit.py:124-129) — neither takes
        probability dropout —; else plain torch, with the probabilities'
        dropout in training.  ``extra``: the additive [n, n] f32 mask of
        packed crops, added to the scores."""
        b, n, dim = x.shape
        d = dim // self.n_head
        dt = self.dtype
        if impl == "block":
            return ops.fused_attention_block(x, self.qkv.weight.t().to(dt),
                                             self.qkv.bias.to(dt),
                                             self.linear.weight.t().to(dt),
                                             self.linear.bias.to(dt), self.n_head, extra)
        qkv = dense(x, self.qkv, dt)
        if impl == "fused":
            return dense(ops.fused_attention_qkv(qkv, self.n_head, extra), self.linear, dt)
        q, k, v = qkv.reshape(b, n, 3, self.n_head, d).unbind(2)
        attn = (torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))).float()
        if extra is not None:
            attn = attn + extra.float()
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        if self.training:
            attn = layers.dropout(attn, self.dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, dim)
        return dense(out, self.linear, dt)


class TransformerLayer(nn.Module):
    """Pre-LN block (reference: models/vit.py:48-66); ``dtype`` the compute
    dtype."""

    def __init__(self, dim: int, n_head: int, dim_ff: int, dropout: float = 0.0,
                 drop_attn: float = 0.0, drop_ff: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_attn = LayerNorm(dim, eps=_LN_EPS)
        self.attn = MultiHeadedAttention(dim, n_head, dropout=drop_attn, dtype=dtype)
        self.norm_ff = LayerNorm(dim, eps=_LN_EPS)
        self.ff = FeedForward(dim, dim_ff, dropout=drop_ff, dtype=dtype)
        self.dropout = dropout
        self.dtype = dtype

    def forward(self, x: torch.Tensor, rs=None,
                generator: torch.Generator | None = None,
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``rs``: pre-drawn DropPath scales ``(rs_attn, rs_ff)``, each None,
        [b] (per sample) or [b, n] (token level, packed crops) — the JAX
        layer's ``rs_override``, vit.py:196-208; ``generator``: the dropout
        masks' source in training; ``extra``: the [n, n] mask of packed
        crops (vit.py:190-194)."""
        b, n, _ = x.shape
        rs_attn, rs_ff = (None, None) if rs is None else rs
        per_sample = rs_attn is None or rs_attn.ndim == 1
        na, attn, nf, ff = self.norm_attn, self.attn, self.norm_ff, self.ff
        # vit.py:233: the attention layer for full-length or packed rows
        impl = ops.attention_impl(
            b, seq=n, default="layer" if n >= 128 or extra is not None else "einsum")
        dropping = self.training and (self.dropout, attn.dropout, ff.rate) != (0, 0, 0)
        # the kernels' weights and biases in the compute dtype, the
        # LayerNorms' parameters f32 (vit.py:185-188, :253-257)
        dt = self.dtype
        attn_w = (na.weight, na.bias, *kernel_weights(attn.qkv, dt),
                  *kernel_weights(attn.linear, dt))
        ff_w = (nf.weight, nf.bias, *kernel_weights(ff[0], dt), *kernel_weights(ff[3], dt))
        if impl == "layer1" and not dropping and per_sample:
            # the whole layer only with per-sample scales (vit.py:243-258)
            return ops.fused_transformer_layer(
                x, *attn_w, *ff_w, attn.n_head, extra=extra, rs_attn=rs_attn,
                rs_ff=rs_ff, activation="silu", eps=_LN_EPS)
        if impl in ("layer", "layer1") and not dropping:
            # token-level scales are applied outside the kernel, exact since
            # it returns x + branch: x + rs ⊙ (out − x) (vit.py:259-282)
            if per_sample:
                x = ops.fused_attention_layer(x, *attn_w, attn.n_head, extra=extra,
                                              row_scale=rs_attn, eps=_LN_EPS)
            else:
                out = ops.fused_attention_layer(x, *attn_w, attn.n_head, extra=extra,
                                                eps=_LN_EPS)
                x = x + scaled(out - x, rs_attn)
            if ops.ff_kernel_enabled() and (rs_ff is None or rs_ff.ndim == 1):
                return ops.fused_ff_layer(x, *ff_w, "silu", rs_ff, _LN_EPS)
            return x + scaled(ff(nf(x)), rs_ff)
        # two residual branches; the attention's own dispatch (vit.py:111-113)
        attn_impl = ops.attention_impl(b, seq=n, default="fused")
        if self.training and attn.dropout > 0:
            attn_impl = "einsum"  # attention dropout needs materialized probs
        drop = (lambda h: layers.dropout(h, self.dropout, generator)) if self.training \
            else (lambda h: h)
        x = x + scaled(drop(attn(na(x), generator, attn_impl, extra)), rs_attn)
        return x + scaled(drop(ff(nf(x), generator)), rs_ff)


class PatchEmbedding(nn.Module):
    """Stride-p conv over p×p patches → [B, h·w, dim] tokens in (h, w)
    row-major order (reference: models/vit.py:69-76); in a compute
    ``dtype`` other than f32 the conv runs there and its bias, cast, is
    added after (flax's ``nn.Conv(dtype=...)``, JAX vit.py:322)."""

    def __init__(self, dim: int, patch_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, dt = self.linear, self.dtype
        if dt == torch.float32:
            y = conv(x)
        else:
            y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride)
            y = y + conv.bias.to(dt)[:, None, None]
        return y.flatten(2).transpose(1, 2)


class VisionTransformer(nn.Module):
    """(reference: models/vit.py:79-203).  Parameters start at torch's
    default init (zeros for the embeddings): call :meth:`reset_parameters`
    for the JAX model's initializers, or ``load_state_dict`` real weights."""

    def __init__(self, image_size, patch_size: int, depth: int, dim: int,
                 n_head: int, dim_ff: int, dropout: float = 0.0,
                 drop_attn: float = 0.0, drop_ff: float = 0.0,
                 drop_path: float = 0.0, n_class: Optional[int] = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = pair(image_size)
        n_patch = (h // patch_size) * (w // patch_size)
        self.dtype = dtype  # the compute dtype; the parameters stay f32
        self.patch_embedding = PatchEmbedding(dim, patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patch + 1, dim))
        self.layers = nn.ModuleList(
            TransformerLayer(dim, n_head, dim_ff, dropout, drop_attn, drop_ff, dtype)
            for _ in range(depth))
        self.norm = LayerNorm(dim, eps=_LN_EPS)
        # n_class None: the features (the DINO trunk, vit.py:403)
        self.head = nn.Linear(dim, n_class) if n_class is not None else None
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

    def draw_drop_path(self, b: int, generator: torch.Generator | None = None,
                       pack: int = 1, seq: int | None = None):
        """Per-layer ``(rs_attn, rs_ff)``: None at rate 0, else keep-mask /
        keep-prob drawn from ``generator`` on the model's device (the JAX
        ``_row_scale``, vit.py:174-187): [b] per row, or token level
        [b, pack·seq] where ``pack`` crops of ``seq`` tokens share a row."""
        device = self.cls_token.device
        return [(drop_path_scale(b, r, generator, device, pack, seq),
                 drop_path_scale(b, r, generator, device, pack, seq))
                for r in self.drop_path_rates]

    def interpolate_pos_embedding(self, n_patch: int) -> torch.Tensor:
        """Bicubic resize of the grid pos-embed when the token count differs
        from the one it was built for (reference: models/vit.py:153-175), as
        the JAX package computes it: :func:`torch_bicubic_matrix` applied
        along each axis (vit.py:453-471)."""
        pos_embed = self.pos_embed
        n_pos = pos_embed.shape[1] - 1
        if n_patch == n_pos:
            return pos_embed
        dim = pos_embed.shape[-1]
        side_in, side_out = int(math.sqrt(n_pos)), int(math.sqrt(n_patch))
        W = torch.from_numpy(torch_bicubic_matrix(side_in, side_out)).to(pos_embed)
        grid = pos_embed[0, 1:].reshape(side_in, side_in, dim)
        grid = torch.einsum("oi,ijd->ojd", W, grid)
        grid = torch.einsum("pj,ojd->opd", W, grid)
        return torch.cat([pos_embed[:, :1], grid.reshape(1, side_out * side_out, dim)],
                         dim=1)

    def forward_feature(self, x: torch.Tensor,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """(reference: models/vit.py:139-151).  x: NCHW.  Crops of ≤ 64
        tokens run packed (:func:`crop_pack`) through the whole layer stack
        under :func:`pack_mask` (vit.py:473-542)."""
        out = self.patch_embedding(x)
        b, n, dim = out.shape
        cls = self.cls_token.to(out.dtype).expand(b, 1, dim)
        out = torch.cat([cls, out], dim=1)
        out = out + self.interpolate_pos_embedding(n).to(out.dtype)
        seq = n + 1
        pack = crop_pack(b, seq)
        scales = [None] * len(self.layers)
        if self.training:
            scales = self.draw_drop_path(b // pack, generator, pack, seq)
            out = layers.dropout(out, self.dropout, generator)
        extra = None
        if pack > 1:
            out = out.reshape(b // pack, pack * seq, dim)
            extra = pack_mask(pack, seq, out.device)
        for layer, rs in zip(self.layers, scales):
            out = layer(out, rs, generator, extra)
        return self.norm(out.reshape(b, seq, dim))[:, 0]

    def forward(self, x, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits (features where ``n_class`` is None) of one NCHW batch or
        of a list of crops: crops of equal size are grouped consecutively and
        each group runs as one batch (reference models/vit.py:177-203, JAX
        vit.py:544-572).  In training mode DropPath and dropout draw from
        ``generator``."""
        crops = list(x) if isinstance(x, (list, tuple)) else [x]
        groups = []
        for crop in crops:
            if groups and groups[-1][0].shape[-2:] == crop.shape[-2:]:
                groups[-1].append(crop)
            else:
                groups.append([crop])
        feats = [self.forward_feature(g[0] if len(g) == 1 else torch.cat(g), generator)
                 for g in groups]
        out = feats[0] if len(feats) == 1 else torch.cat(feats)
        return out if self.head is None else self.head(out.float())


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

    def make(self, dtype: torch.dtype = torch.float32) -> VisionTransformer:
        """The model in compute ``dtype`` (the JAX ``make(dtype=...)``,
        vit.py:664; the trainer passes the conf's precision)."""
        if self.remat or self.scan_layers:
            raise NotImplementedError(
                "arch.remat / arch.scan_layers are not ported")
        return VisionTransformer(
            image_size=self.image_size, patch_size=self.window_size,
            depth=self.depth, dim=self.dim, n_head=self.n_head,
            dim_ff=self.dim_ff, dropout=self.dropout, drop_attn=self.drop_attn,
            drop_ff=self.drop_ff, drop_path=self.drop_path,
            n_class=self.n_class, dtype=dtype)


class WeightNormLinear(nn.Module):
    """The weight-normed last layer of the DINO head, bias-free: ``w = g ·
    v / ‖v‖`` per output row (reference models/vit.py:244-248), with
    ``weight_v`` [out, in] and ``weight_g`` [out, 1] — the keys torch's
    ``weight_norm`` gives the reference state_dict.  ``weight_g`` is a
    trainable parameter unless ``norm_last_layer``, which fixes it at 1 (a
    buffer, so the optimizer never sees it)."""

    def __init__(self, in_dim: int, out_dim: int, norm_last_layer: bool = True):
        super().__init__()
        self.weight_v = nn.Parameter(torch.zeros(out_dim, in_dim))
        if norm_last_layer:
            self.register_buffer("weight_g", torch.ones(out_dim, 1))
        else:
            self.weight_g = nn.Parameter(torch.ones(out_dim, 1))

    def weight(self) -> torch.Tensor:
        """g · v / max(‖v‖, 1e-12), the norm over each output's row (JAX
        vit.py:615-619)."""
        v = self.weight_v
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                               min=1e-12) * self.weight_g

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return F.linear(h, self.weight())


class DINOHead(nn.Module):
    """MLP → L2 normalisation → weight-normed linear (reference
    models/vit.py:206-262, JAX vit.py:575-625): ``mlp`` a Sequential of
    Linear layers with exact GELUs in the odd slots (a bare Linear at
    depth 1), each Linear in the compute ``dtype`` (:func:`layers.dense`),
    the output L2-normalised (eps 1e-12) in f32, then ``last``: in f32 its
    own Linear, else the product of the ``dtype``-rounded output and weight
    with an f32 result (JAX vit.py:620-625) — the [crops, out_dim] logits
    are never rounded to ``dtype``.  ``use_bn`` (BatchNorm after each hidden
    Linear) is not ported."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = False,
                 norm_last_layer: bool = True, depth: int = 3, dim_ff: int = 2048,
                 dim_bottleneck: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if use_bn:
            raise NotImplementedError(
                "arch.use_bn: the DINO head's BatchNorm is not ported (ROADMAP.md, queue A)")
        if depth == 1:
            self.mlp = nn.Linear(in_dim, dim_bottleneck)
        else:
            mods = [nn.Linear(in_dim, dim_ff), nn.GELU()]
            for _ in range(depth - 2):
                mods += [nn.Linear(dim_ff, dim_ff), nn.GELU()]
            self.mlp = nn.Sequential(*mods, nn.Linear(dim_ff, dim_bottleneck))
        self.last = WeightNormLinear(dim_bottleneck, out_dim, norm_last_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x
        for m in self.mlp if isinstance(self.mlp, nn.Sequential) else (self.mlp,):
            h = dense(h, m, dt) if isinstance(m, nn.Linear) else m(h)
        h = h.float()
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-12)
        if dt == torch.float32:
            return self.last(h)
        return f32_out_product(h.to(dt), self.last.weight().to(dt))


class DINOModel(VisionTransformer):
    """The DINO network: the ViT trunk (``n_class`` None, so its forward
    gives the features of every crop group) with :class:`DINOHead` as its
    ``head`` — the reference state_dict layout the JAX package's
    ``_convert_dino`` reads (utils/torch_convert.py:146-189): the trunk at
    top level, ``head.mlp.{0,2,4}``, ``head.last.weight_v`` [out, in] and
    ``head.last.weight_g`` [out, 1]."""

    def __init__(self, head: DINOHead, **trunk):
        super().__init__(**trunk, n_class=None)
        self.head = head

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The trunk's and the head's Linear layers as
        :meth:`VisionTransformer.reset_parameters`; ``last.weight_v``
        normal(0.02) and ``last.weight_g`` ones (JAX vit.py:588-618)."""
        super().reset_parameters(generator)
        self.head.last.weight_v.normal_(0.0, 0.02, generator=generator)
        self.head.last.weight_g.fill_(1.0)


@register("model", "dino")
@dataclasses.dataclass
class DINOConfig(TypedConfig):
    """(the JAX package's DINOConfig, vit.py:684-733; reference factory
    models/vit.py:265-307)"""

    image_size: Any = 224
    window_size: int = 16
    depth: int = 12
    dim: int = 384
    n_head: int = 6
    dim_ff: int = 1536
    dropout: float = 0.0
    drop_attn: float = 0.0
    drop_ff: float = 0.0
    drop_path: float = 0.0
    dim_head_out: int = 65536
    use_bn: bool = False
    norm_last_layer: bool = True
    depth_head: int = 3
    dim_head_ff: int = 2048
    dim_head_bottleneck: int = 256
    remat: bool = False
    scan_layers: bool = False

    def make(self, dtype: torch.dtype = torch.float32,
             drop_path: Optional[float] = None) -> DINOModel:
        """The network in compute ``dtype`` (the JAX ``make(dtype=...)``,
        vit.py:707; the trainer passes the conf's precision); ``drop_path``
        overrides the conf's rate (the student takes
        ``task.student_drop_path``, the teacher 0)."""
        if self.remat or self.scan_layers:
            raise NotImplementedError(
                "arch.remat / arch.scan_layers are not ported (ROADMAP.md, queue A)")
        head = DINOHead(self.dim, self.dim_head_out, self.use_bn, self.norm_last_layer,
                        self.depth_head, self.dim_head_ff, self.dim_head_bottleneck, dtype)
        return DINOModel(
            head, image_size=self.image_size, patch_size=self.window_size,
            depth=self.depth, dim=self.dim, n_head=self.n_head, dim_ff=self.dim_ff,
            dropout=self.dropout, drop_attn=self.drop_attn, drop_ff=self.drop_ff,
            drop_path=self.drop_path if drop_path is None else drop_path, dtype=dtype)
