"""Halo Transformer classifier (counterpart of
``vision_transformers_tpu/models/halo.py``; reference:
models/halo_transformer.py).

Blocked local attention with a halo: the queries of each w x w window
attend to the k x k neighbourhood centred on it (k = w + 2·halo), whose
positions outside the map are zero keys and values (the reference unfolds
the zero-padded projected map; the zeros are not masked and take softmax
mass), with a relative-position bias [heads, w², k²] gathered from a
zero-initialised table by the static numpy index :func:`halo_position_index`.

Module names are the reference torch ``state_dict`` keys (the inverse of
the JAX package's ``utils/torch_export.py::_export_halo``):
``block{s}.0.{linear,norm}`` the stage embedding, ``block{s}.{i+1}.
{norm_attn, attn.weight, attn.linear, attn.rel_pos, norm_ff, ff.0, ff.3}``
the layers, ``final_linear.{0,1,2}`` and ``classifier.2``, so a reference
``.pt`` loads with ``strict=True`` once its ``.attn.pos`` buffers are
dropped (utils/weights.py::load_checkpoint drops them).  Images are NCHW;
the model works on NHWC maps inside.

Each layer dispatches through :func:`ops.halo_impl` (the JAX
``halo_impl``): ``layer`` (the default where 2·halo ≤ window) runs the whole
layer as one op, :func:`ops.fused_halo_layer.fused_halo_layer`; ``direct``
the attention alone, :func:`ops.halo_attention_direct`, between plain
projections (the JAX path when the layer kernel is not taken,
halo.py:150-162); ``gather`` (the default where 2·halo > window) the
attention on the gathered neighbourhoods, :func:`ops.halo_attention`, between
plain projections, the gather and its adjoint torch data movement
(halo.py:163-175); ``einsum`` the plain torch neighbourhood attention
(halo.py:179-204).

``dtype`` (:meth:`HaloConfig.make`, the JAX model's ``dtype``, halo.py:337-353)
is the compute dtype: bf16 is the JAX package's default precision.  The
parameters stay f32 and are cast at each use: the patch embeddings' Linears
in ``dtype`` (Swin's :class:`PatchEmbedding`), the layers' weights and
biases in ``dtype`` with their LayerNorm parameters, the relative-position
bias and the DropPath scales f32 (halo.py:125-145), the einsum path's
scores and P·V in ``dtype`` with its softmax f32 (:179-201), the head's LN
→ Linear → LN → SiLU in ``dtype`` and the classifier f32 on an f32 input
(:306-314).

Reference quirks reproduced: the qkv projection has no bias, LayerNorm eps
1e-6 in the layers and 1e-5 in the embeddings and the head, the widened
final head LN → Linear(2·C) → LN → SiLU before the spatial mean and the
classifier, and no DropPath ramp: every layer has the same rate, with two
per-sample draws (attention and FF branch) from an explicit
``torch.Generator``.  dropout, drop_attn and drop_ff > 0 in training raise
NotImplementedError.  remat is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch
from torch import nn

from .. import ops
from ..config.registry import TypedConfig, register
from ..ops.fused_halo import halo_attention, halo_attention_direct, unwindows, windows
from ..ops.fused_halo import neighborhoods as halo_neighborhoods
from ..ops.fused_halo_layer import fused_halo_layer
from .layers import FeedForward, LayerNorm, dense, drop_path_scale, kernel_weights, scaled
from .swin import PatchEmbedding

__all__ = ["halo_position_index", "halo_neighborhoods", "HaloAttention", "HaloLayer",
           "HaloTransformer", "HaloConfig"]

_LN_EPS = 1e-6  # reference: models/halo_transformer.py:9


def halo_position_index(window: int, halo: int) -> tuple[np.ndarray, int]:
    """[w², k²] index into the relative-position table and its largest
    entry (JAX halo.py:77-88; reference :41-55)."""
    k = window + 2 * halo
    p = np.arange(k)
    yy, xx = np.meshgrid(p, p, indexing="ij")
    q_y = yy[halo:-halo, halo:-halo].reshape(-1, 1)
    q_x = xx[halo:-halo, halo:-halo].reshape(-1, 1)
    dy = yy.reshape(1, -1) - q_y + (window + halo - 1)
    dx = xx.reshape(1, -1) - q_x + (window + halo - 1)
    pos = dy * k + dx
    max_pos = (window + halo - 1) * 2 * k + (window + halo - 1) * 2
    return pos, max_pos


class HaloAttention(nn.Module):
    """Halo windowed MHSA (reference: models/halo_transformer.py:22-116);
    ``forward`` is the direct / einsum path on an LN'd map."""

    def __init__(self, dim: int, n_head: int, dim_head: int, window: int, halo: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = n_head * dim_head
        self.n_head, self.dim_head, self.window, self.halo = n_head, dim_head, window, halo
        self.dtype = dtype  # the projections' compute dtype
        self.weight = nn.Linear(dim, inner * 3, bias=False)  # q-heads | k-heads | v-heads
        self.linear = nn.Linear(inner, dim)
        pos, max_pos = halo_position_index(window, halo)
        self.rel_pos = nn.Embedding(max_pos + 1, n_head)
        self.register_buffer("pos_index", torch.from_numpy(pos.astype(np.int64)),
                             persistent=False)

    def relative_bias(self) -> torch.Tensor:
        """[H, w², k²]: the table gathered by the static index."""
        return self.rel_pos.weight[self.pos_index].permute(2, 0, 1)

    def forward(self, x: torch.Tensor, impl: str = "einsum") -> torch.Tensor:
        """Attention on an LN'd map [b, H, W, C], projected back to C."""
        inner, H = self.n_head * self.dim_head, self.n_head
        scale = 1.0 / math.sqrt(self.dim_head)
        qkv = dense(x, self.weight, self.dtype)
        q, kv = qkv[..., :inner], qkv[..., inner:]
        if impl == "direct":
            out = halo_attention_direct(q.contiguous(), kv.contiguous(),
                                        self.relative_bias(), self.window, self.halo, H,
                                        scale)
        elif impl == "gather":
            # queries window-partitioned, heads left on lanes; the kv
            # neighbourhoods exactly as the gather emits them (JAX
            # halo.py:163-175)
            b, h, w, _ = x.shape
            win, k = self.window, self.window + 2 * self.halo
            qw = windows(q, win).reshape(-1, win * win, inner).contiguous()
            nb = halo_neighborhoods(kv, win, self.halo).reshape(-1, k * k, 2 * inner)
            out = halo_attention(qw, nb.contiguous(), self.relative_bias(), H, scale)
            out = unwindows(out.reshape(b, -1, win * win, inner), win, h, w)
        else:
            out = self._einsum(q, kv, scale)
        return dense(out, self.linear, self.dtype)

    def _einsum(self, q: torch.Tensor, kv: torch.Tensor, scale: float) -> torch.Tensor:
        """The plain neighbourhood attention as the JAX model computes it
        (halo.py:179-204): scores and P·V in the compute dtype, the bias added
        there, the softmax in f32."""
        b, h, w, inner = q.shape
        H, D, win = self.n_head, self.dim_head, self.window
        qw = windows(q, win).unflatten(-1, (H, D)).permute(0, 3, 1, 2, 4)  # [b, H, S, w², D]
        nb = halo_neighborhoods(kv, win, self.halo).unflatten(-1, (2, H, D))
        key, value = (nb[..., i, :, :].permute(0, 3, 1, 2, 4) for i in range(2))
        score = torch.einsum("bhsqd,bhskd->bhsqk", qw, key) * scale
        score = score + self.relative_bias().to(score.dtype)[None, :, None]
        attn = torch.softmax(score.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhsqk,bhskd->bhsqd", attn, value)
        return unwindows(out.permute(0, 2, 3, 1, 4).flatten(-2), win, h, w)


class HaloLayer(nn.Module):
    """Pre-LN Halo block (reference: models/halo_transformer.py:119-150)."""

    def __init__(self, dim: int, n_head: int, dim_head: int, dim_ff: int, window: int,
                 halo: int, drop_ff: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_attn = LayerNorm(dim, eps=_LN_EPS)
        self.attn = HaloAttention(dim, n_head, dim_head, window, halo, dtype)
        self.norm_ff = LayerNorm(dim, eps=_LN_EPS)
        self.ff = FeedForward(dim, dim_ff, dropout=drop_ff, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, rs=None) -> torch.Tensor:
        """x [b, H, W, C]; ``rs``: pre-drawn DropPath scales
        ``(rs_attn, rs_ff)``, each None or [b]."""
        rs_attn, rs_ff = (None, None) if rs is None else rs
        na, attn, nf, ff = self.norm_attn, self.attn, self.norm_ff, self.ff
        impl = ops.halo_impl(attn.window, attn.halo)
        if impl == "layer":
            # the weights and biases in the compute dtype, the LayerNorms'
            # parameters, the bias and the row scales f32 (halo.py:125-145)
            dt = self.dtype
            return fused_halo_layer(
                x, na.weight, na.bias, kernel_weights(attn.weight, dt)[0],
                *kernel_weights(attn.linear, dt), nf.weight, nf.bias,
                *kernel_weights(ff[0], dt), *kernel_weights(ff[3], dt),
                attn.relative_bias(), attn.n_head, rs_attn, rs_ff, activation="silu",
                window=attn.window, halo=attn.halo, eps=_LN_EPS)
        x = x + scaled(attn(na(x), impl), rs_attn)
        return x + scaled(ff(nf(x)), rs_ff)


class HaloTransformer(nn.Module):
    """4-stage Halo Transformer (reference: :176-280).  Parameters start at
    torch's default init: call :meth:`reset_parameters` for the JAX model's
    initializers, or ``load_state_dict`` real weights."""

    def __init__(self, image_size, n_class: int, depths, dims, dim_head: int,
                 n_heads, dim_ffs, window_size: int, halo_size: int,
                 drop_ff: float = 0.0, drop_attn: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype  # the compute dtype; the parameters stay f32
        in_dim = 3
        for s, (depth, reduction) in enumerate(zip(depths, (4, 2, 2, 2))):
            stage = [PatchEmbedding(dims[s], reduction, in_dim=in_dim, dtype=dtype)]
            stage += [HaloLayer(dims[s], n_heads[s], dim_head, dim_ffs[s], window_size,
                                halo_size, drop_ff=drop_ff, dtype=dtype)
                      for _ in range(depth)]
            setattr(self, f"block{s + 1}", nn.ModuleList(stage))
            in_dim = dims[s]
        self.n_stages = len(depths)
        # reference Sequential(LN, Linear, LN, SiLU) and Sequential(pool, flatten, linear)
        self.final_linear = nn.Sequential(
            LayerNorm(dims[-1], eps=1e-5), nn.Linear(dims[-1], 2 * dims[-1]),
            LayerNorm(2 * dims[-1], eps=1e-5), nn.SiLU())
        self.classifier = nn.Sequential(nn.Identity(), nn.Identity(),
                                        nn.Linear(2 * dims[-1], n_class))
        self._dropout = drop_attn > 0 or drop_ff > 0
        # no ramp: every layer takes the same rate (JAX halo.py:296-303)
        self.drop_path_rates = [drop_path] * sum(depths)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX model's initializers: normal(0.02) for every Linear kernel
        (``trunc_normal_init(0.02)`` is a plain normal, layers.py:92-95),
        zeros for the biases and the relative-position tables, ones / zeros
        for the LayerNorms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.zero_()

    def draw_drop_path(self, b: int, generator: torch.Generator | None = None):
        """Per-layer ``(rs_attn, rs_ff)``: two independent [b] keep-mask /
        keep-prob draws from ``generator`` (None at rate 0), on the model's
        device (the JAX ``_row_scale``, halo.py:220-228)."""
        device = self.classifier[2].weight.device
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
                "Halo-S trains with both at 0")
        out = x.permute(0, 2, 3, 1)
        scales = iter(self.draw_drop_path(out.shape[0], generator) if self.training
                      else [None] * len(self.drop_path_rates))
        for s in range(self.n_stages):
            embed, *layers = getattr(self, f"block{s + 1}")
            out = embed(out)
            for layer in layers:
                out = layer(out, next(scales))
        # LN → Linear → LN → SiLU in the compute dtype, the classifier f32
        # on an f32 input (halo.py:306-314)
        norm, linear, norm2, act = self.final_linear
        out = act(norm2(dense(norm(out), linear, self.dtype))).mean(dim=(1, 2))
        return self.classifier(out.float())


@register("model", "halo_transformer")
@dataclasses.dataclass
class HaloConfig(TypedConfig):
    """Halo classifier (same fields and HaloNet-style defaults as the JAX
    package's HaloConfig, halo.py:318-335: Halo-S at 256 px)."""

    image_size: Any = 256
    n_class: int = 1000
    depths: Tuple[int, int, int, int] = (2, 2, 6, 2)
    dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    dim_head: int = 32
    n_heads: Tuple[int, int, int, int] = (3, 6, 12, 24)
    dim_ffs: Tuple[int, int, int, int] = (384, 768, 1536, 3072)
    window_size: int = 8
    halo_size: int = 2
    drop_ff: float = 0.0
    drop_attn: float = 0.0
    drop_path: float = 0.0
    remat: bool = False

    def make(self, dtype: torch.dtype = torch.float32) -> HaloTransformer:
        """The model in compute ``dtype`` (the JAX ``make(dtype=...)``,
        halo.py:337-353; the trainer passes the conf's precision)."""
        if self.remat:
            raise NotImplementedError("arch.remat is not ported")
        return HaloTransformer(
            image_size=self.image_size, n_class=self.n_class, depths=self.depths,
            dims=self.dims, dim_head=self.dim_head, n_heads=self.n_heads,
            dim_ffs=self.dim_ffs, window_size=self.window_size,
            halo_size=self.halo_size, drop_ff=self.drop_ff, drop_attn=self.drop_attn,
            drop_path=self.drop_path, dtype=dtype)
