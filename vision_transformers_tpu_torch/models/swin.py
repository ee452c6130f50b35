"""Swin Transformer classifier (counterpart of
``vision_transformers_tpu/models/swin.py``; reference:
models/swin_transformer.py).

Module names are the reference torch ``state_dict`` keys
(``patch_embedding.{linear,norm}``, ``block{s}.0`` the patch merge of
stages s ≥ 2, ``block{s}.{j}.{norm_attn, attn.weight, attn.linear,
attn.rel_pos, norm_ff, ff.0, ff.3}``, ``final_linear.0``, ``classifier.2``),
so a reference ``.pt`` loads with ``strict=True`` once its ``.attn.pos`` and
``.attn.local_mask`` buffers are dropped (utils/weights.py::load_checkpoint
drops them): the relative-position index and the shifted-window mask are
static numpy constants here, as in the JAX package.  Images are NCHW; the
model works on NHWC maps inside.

Window pairs are packed into one attention problem where a stage has an
even number of windows per row (m = 2·w² tokens, the off-diagonal blocks of
the pair at −1e9, JAX swin.py:180-206).  Each layer dispatches through
:func:`ops.attention_impl` with the JAX default ``layer1`` (swin.py:374):

- ``layer1``: the window partition, then the whole-layer kernel
  (:func:`ops.fused_transformer_layer`) on [G·b, m, C] rows in group-major
  order with the grouped bias [G, H, m, m] (relative-position bias + shift
  mask) and both DropPath scales tiled over the groups (swin.py:239-276);
- ``layer`` (forced only): the attention-half op with the same bias, the
  FF half in plain torch or, under :func:`ops.set_ff_kernel`, through the
  FF kernel (:func:`ops.fused_ff_layer`) on the same partitioned rows
  with the FF scale tiled over the groups (swin.py:396-400);
- ``fused`` (forced only): the window partition, the qkv projection, the
  packed-qkv attention kernel (:func:`ops.fused_attention_qkv`) with the
  grouped bias, the out projection and the unpartition (swin.py:163-170,
  288-293); LN, the residuals and the FF in plain torch;
- ``einsum``: plain torch on the packed windows (swin.py:302-330).

Reference quirks reproduced: ``shift = i % 2 == 0`` (the first layer of each
stage is shifted), the mask criterion on pre-roll coordinates, the
zero-initialised bias table, the index taken from window 0 of the rolled
grid (which wraps inside the window when the grid equals it: the last
stage), and the DropPath ramp ``drop_path·i/sum(depths)``.  In training
each layer draws two independent per-sample DropPath scales from an
explicit ``torch.Generator``; dropout, drop_attn and drop_ff > 0 in
training raise NotImplementedError.  remat is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import ops
from ..config.registry import TypedConfig, register
from .layers import FeedForward, LayerNorm, drop_path_scale, pair, patchify, scaled

__all__ = ["relative_position_index", "shifted_window_mask", "WindowAttention",
           "SwinLayer", "PatchEmbedding", "PatchMerge", "SwinTransformer",
           "SwinConfig"]

_LN_EPS = 1e-6  # reference: models/swin_transformer.py:12
_MASKED = -1e9  # additive bias of a pair the window does not hold



# ---------------------------------------------------------------------------
# static index and masks (numpy, once per layer; JAX swin.py:56-116)
# ---------------------------------------------------------------------------


def _window_coords(input_size: Tuple[int, int], window: int, shift: bool):
    """Per-window token coordinates (y, x), each [n_windows, w²], on the
    grid rolled by −w/2 when shifted; token order (wy, wx) row-major."""
    h, w = input_size
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if shift:
        roll = window // 2
        yy = np.roll(yy, (-roll, -roll), (0, 1))
        xx = np.roll(xx, (-roll, -roll), (0, 1))

    def part(c):
        c = c.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
        return c.reshape(-1, window * window)

    return part(yy), part(xx)


def relative_position_index(window: int,
                            input_size: Optional[Tuple[int, int]] = None,
                            shift: bool = False) -> np.ndarray:
    """[w², w²] index into the (2w−1)² bias table: ``key − query`` offsets
    of window 0 of the (rolled, when shifted) grid, non-local pairs zeroed
    when shifted (JAX swin.py:77-102)."""
    if input_size is None:
        input_size = (window, window)
    y, x = _window_coords(input_size, window, shift)
    dy = y[0][None, :] - y[0][:, None]
    dx = x[0][None, :] - x[0][:, None]
    if shift:
        local = (np.abs(dy) < window) & (np.abs(dx) < window)
        dy = dy * local
        dx = dx * local
    return (dy + window - 1) * (2 * window - 1) + (dx + window - 1)


def shifted_window_mask(input_size: Tuple[int, int], window: int) -> np.ndarray:
    """[n_windows, w², w²] additive mask, 0 where a (query, key) pair is
    within the window extent on the original grid, else −1e9 (JAX
    swin.py:105-116)."""
    y, x = _window_coords(input_size, window, shift=True)
    dy = y[:, :, None] - y[:, None, :]
    dx = x[:, :, None] - x[:, None, :]
    local = (np.abs(dy) < window) & (np.abs(dx) < window)
    return np.where(local, 0.0, _MASKED).astype(np.float32)


def window_pack(window: int, input_size: Tuple[int, int]) -> int:
    """Windows per attention problem: 2 where a row holds an even number of
    windows and a pair fits 128 tokens (JAX swin.py:184)."""
    ws = input_size[1] // window
    return 2 if ws % 2 == 0 and 2 * window * window <= 128 else 1


def packed_shift_mask(input_size: Tuple[int, int], window: int, pack: int) -> np.ndarray:
    """[G, m, m] shift mask in pack order, m = pack·w², G = n_windows / pack
    (JAX swin.py:198-206)."""
    h, w = input_size
    hs, ws, w2 = h // window, w // window, window * window
    m_tok, groups = pack * w2, hs * ws // pack
    m = shifted_window_mask(input_size, window).reshape(hs, ws // pack, pack, w2, w2)
    pm = np.zeros((hs, ws // pack, m_tok, m_tok), np.float32)
    for i in range(pack):
        pm[:, :, i * w2:(i + 1) * w2, i * w2:(i + 1) * w2] = m[:, :, i]
    return pm.reshape(groups, m_tok, m_tok)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    """Windowed MHSA with a relative-position bias and an optional cyclic
    shift (reference: models/swin_transformer.py:25-160); ``forward`` is the
    plain packed-window path on an LN'd map."""

    def __init__(self, dim: int, n_head: int, dim_head: int,
                 input_size: Tuple[int, int], window: int, shift: bool):
        super().__init__()
        inner = n_head * dim_head
        self.n_head, self.dim_head = n_head, dim_head
        self.input_size, self.window, self.shift = input_size, window, shift
        self.weight = nn.Linear(dim, inner * 3)  # qkv, q-heads | k-heads | v-heads
        self.linear = nn.Linear(inner, dim)
        self.rel_pos = nn.Embedding((2 * window - 1) ** 2, n_head)
        self.pack = window_pack(window, input_size)
        self.register_buffer("pos_index", torch.from_numpy(
            relative_position_index(window, input_size, shift).astype(np.int64)),
            persistent=False)
        if shift:
            mask = torch.from_numpy(packed_shift_mask(input_size, window, self.pack))
            self.register_buffer("shift_mask", mask, persistent=False)
        else:
            self.shift_mask = None

    @property
    def groups(self) -> int:
        h, w = self.input_size
        return (h // self.window) * (w // self.window) // self.pack

    def packed_slab(self) -> torch.Tensor:
        """[H, m, m] relative-position bias, block-diagonal with −1e9 off
        the diagonal blocks when packed (JAX swin.py:188-196)."""
        bias = self.rel_pos.weight[self.pos_index].permute(2, 0, 1)  # [H, w², w²]
        if self.pack == 1:
            return bias
        neg = bias.new_full(bias.shape, _MASKED)
        rows = [torch.cat([bias if j == i else neg for j in range(self.pack)], dim=-1)
                for i in range(self.pack)]
        return torch.cat(rows, dim=-2)

    def grouped_bias(self) -> torch.Tensor:
        """[G, H, m, m] f32: the slab for every group, plus the shift mask
        (JAX swin.py:249-252)."""
        slab = self.packed_slab().float()
        extra = slab[None].expand(self.groups, *slab.shape)
        if self.shift_mask is not None:
            extra = extra + self.shift_mask[:, None]
        return extra.contiguous()

    def _roll(self, x: torch.Tensor, sign: int) -> torch.Tensor:
        if not self.shift:
            return x
        r = self.window // 2
        return torch.roll(x, (sign * r, sign * r), (1, 2))

    def partition(self, x: torch.Tensor) -> torch.Tensor:
        """[b, H, W, C] → [G·b, m, C], rows group-major (JAX swin.py:244-247)."""
        b, h, w, c = x.shape
        win, pack = self.window, self.pack
        x = self._roll(x, -1).reshape(b, h // win, win, w // win // pack, pack, win, c)
        return x.permute(1, 3, 0, 4, 2, 5, 6).reshape(-1, pack * win * win, c)

    def unpartition(self, out: torch.Tensor, b: int) -> torch.Tensor:
        h, w = self.input_size
        win, pack = self.window, self.pack
        out = out.reshape(h // win, w // win // pack, b, pack, win, win, -1)
        out = out.permute(2, 0, 4, 1, 3, 5, 6).reshape(b, h, w, -1)
        return self._roll(out, 1)

    def forward(self, x: torch.Tensor, impl: str = "einsum") -> torch.Tensor:
        """Packed-window attention on an LN'd map [b, H, W, C]: plain torch
        (JAX swin.py:302-330) or, on the partitioned rows with the grouped
        bias, the packed-qkv kernel between the projections (``impl``
        "fused", swin.py:288-293) or the attention-block kernel with the
        projections inside (``impl`` "block", swin.py:280-286)."""
        b, h, w, _ = x.shape
        scale = 1.0 / self.dim_head ** 0.5
        if impl == "block":
            out = ops.fused_attention_block(
                self.partition(x).contiguous(), self.weight.weight.t(), self.weight.bias,
                self.linear.weight.t(), self.linear.bias, self.n_head, self.grouped_bias(),
                scale)
            return self.unpartition(out, b)
        if impl == "fused":
            qkv = self.weight(self.partition(x))
            out = ops.fused_attention_qkv(qkv, self.n_head, self.grouped_bias(), scale)
            return self.unpartition(self.linear(out), b)
        win, pack, H, D = self.window, self.pack, self.n_head, self.dim_head
        hs, wsp = h // win, w // win // pack
        qkv = self.weight(self._roll(x, -1))
        qkv = qkv.reshape(b, hs, win, wsp, pack, win, 3, H, D)
        qkv = qkv.permute(0, 1, 3, 6, 7, 4, 2, 5, 8).reshape(b, hs * wsp, 3, H, -1, D)
        q, k, v = qkv.unbind(2)
        score = torch.einsum("bshqd,bshkd->bshqk", q, k) * (1.0 / D ** 0.5)
        score = score + self.packed_slab().to(score.dtype)[None, None]
        if self.shift_mask is not None:
            score = score + self.shift_mask.to(score.dtype)[None, :, None]
        attn = torch.softmax(score.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bshqk,bshkd->bshqd", attn, v)
        out = out.reshape(b, hs, wsp, H, pack, win, win, D)
        out = out.permute(0, 1, 5, 2, 4, 6, 3, 7).reshape(b, h, w, H * D)
        return self._roll(self.linear(out), 1)


class SwinLayer(nn.Module):
    """Pre-LN window-attention block (reference: :163-197)."""

    def __init__(self, dim: int, n_head: int, dim_head: int, dim_ff: int,
                 input_size: Tuple[int, int], window: int, shift: bool,
                 drop_ff: float = 0.0):
        super().__init__()
        self.norm_attn = LayerNorm(dim, eps=_LN_EPS)
        self.attn = WindowAttention(dim, n_head, dim_head, input_size, window, shift)
        self.norm_ff = LayerNorm(dim, eps=_LN_EPS)
        self.ff = FeedForward(dim, dim_ff, dropout=drop_ff)

    def forward(self, x: torch.Tensor, rs=None) -> torch.Tensor:
        """x [b, H, W, C]; ``rs``: pre-drawn DropPath scales
        ``(rs_attn, rs_ff)``, each None or [b]."""
        b = x.shape[0]
        rs_attn, rs_ff = (None, None) if rs is None else rs
        na, attn, nf, ff = self.norm_attn, self.attn, self.norm_ff, self.ff
        impl = ops.attention_impl(b, default="layer1")
        if impl in ("einsum", "fused", "block"):
            x = x + scaled(attn(na(x), impl), rs_attn)
            return x + scaled(ff(nf(x)), rs_ff)
        # kernel paths: LN, the residuals and the row scales are token-
        # pointwise, so they commute with the roll / partition permutation;
        # rows are (group, image) pairs, so the scales tile over the groups
        G = attn.groups
        tile = lambda r: None if r is None else r.repeat(G)  # noqa: E731
        xw = attn.partition(x)
        attn_w = (na.weight, na.bias, attn.weight.weight.t(), attn.weight.bias,
                  attn.linear.weight.t(), attn.linear.bias)
        if impl == "layer1":
            out = ops.fused_transformer_layer(
                xw, *attn_w, nf.weight, nf.bias, ff[0].weight.t(), ff[0].bias,
                ff[3].weight.t(), ff[3].bias, attn.n_head, attn.grouped_bias(),
                tile(rs_attn), tile(rs_ff), activation="silu", eps=_LN_EPS)
            return attn.unpartition(out, b)
        out = ops.fused_attention_layer(xw, *attn_w, attn.n_head,
                                        extra=attn.grouped_bias(),
                                        row_scale=tile(rs_attn), eps=_LN_EPS)
        if ops.ff_kernel_enabled():
            out = ops.fused_ff_layer(out, nf.weight, nf.bias, ff[0].weight.t(),
                                     ff[0].bias, ff[3].weight.t(), ff[3].bias, "silu",
                                     tile(rs_ff), _LN_EPS)
            return attn.unpartition(out, b)
        x = attn.unpartition(out, b)
        return x + scaled(ff(nf(x)), rs_ff)


class PatchEmbedding(nn.Module):
    """patchify → linear → LN (eps 1e-5) (reference: :200-213); ``in_dim``
    channels in (3 for images, the previous stage's width in Halo)."""

    def __init__(self, out_dim: int, patch: int, in_dim: int = 3):
        super().__init__()
        self.patch = patch
        self.linear = nn.Linear(in_dim * patch * patch, out_dim)
        self.norm = LayerNorm(out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.linear(patchify(x, self.patch)))


class PatchMerge(nn.Module):
    """patchify → LN (eps 1e-5) → linear without bias (reference: :216-229)."""

    def __init__(self, in_dim: int, out_dim: int, size: int = 2):
        super().__init__()
        self.size = size
        self.norm = LayerNorm(in_dim * size * size, eps=1e-5)
        self.linear = nn.Linear(in_dim * size * size, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.norm(patchify(x, self.size)))


class SwinTransformer(nn.Module):
    """4-stage Swin (reference: :236-379).  Parameters start at torch's
    default init: call :meth:`reset_parameters` for the JAX model's
    initializers, or ``load_state_dict`` real weights."""

    def __init__(self, image_size, n_class: int, depths, dims, dim_head: int,
                 n_heads, dim_ffs, window_size: int, drop_ff: float = 0.0,
                 drop_attn: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        h, w = pair(image_size)
        self.patch_embedding = PatchEmbedding(dims[0], 4)
        size = (h // 4, w // 4)
        for s, depth in enumerate(depths):
            stage = []
            if s > 0:
                stage.append(PatchMerge(dims[s - 1], dims[s]))
                size = (size[0] // 2, size[1] // 2)
            for i in range(depth):
                layer = SwinLayer(dims[s], n_heads[s], dim_head, dim_ffs[s], size,
                                  window_size, shift=i % 2 == 0, drop_ff=drop_ff)
                stage.append(layer)
            setattr(self, f"block{s + 1}", nn.ModuleList(stage))
        self.n_stages = len(depths)
        # reference Sequential(LayerNorm) and Sequential(pool, flatten, linear)
        self.final_linear = nn.Sequential(LayerNorm(dims[-1], eps=1e-5))
        self.classifier = nn.Sequential(nn.Identity(), nn.Identity(),
                                        nn.Linear(dims[-1], n_class))
        self._dropout = drop_attn > 0 or drop_ff > 0
        n_layers = sum(depths)
        # per-layer DropPath rates (JAX swin.py:474-476)
        self.drop_path_rates = [drop_path * i / n_layers for i in range(n_layers)]

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
        device (the JAX ``_row_scale``, swin.py:347-354)."""
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
                "Swin-S trains with both at 0")
        out = self.patch_embedding(x.permute(0, 2, 3, 1))
        scales = iter(self.draw_drop_path(out.shape[0], generator) if self.training
                      else [None] * len(self.drop_path_rates))
        for s in range(self.n_stages):
            for block in getattr(self, f"block{s + 1}"):
                out = block(out, next(scales)) if isinstance(block, SwinLayer) \
                    else block(out)
        out = self.final_linear(out).mean(dim=(1, 2))
        return self.classifier(out.float())


@register("model", "swin_transformer")
@dataclasses.dataclass
class SwinConfig(TypedConfig):
    """Swin classifier (same fields as the JAX package's SwinConfig)."""

    image_size: Any = (224, 224)
    n_class: int = 1000
    depths: Tuple[int, int, int, int] = (2, 2, 6, 2)
    dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    dim_head: int = 32
    n_heads: Tuple[int, int, int, int] = (3, 6, 12, 24)
    dim_ffs: Tuple[int, int, int, int] = (384, 768, 1536, 3072)
    window_size: int = 7
    drop_ff: float = 0.0
    drop_attn: float = 0.0
    drop_path: float = 0.0
    remat: bool = False

    def make(self) -> SwinTransformer:
        if self.remat:
            raise NotImplementedError("arch.remat is not ported")
        return SwinTransformer(
            image_size=self.image_size, n_class=self.n_class, depths=self.depths,
            dims=self.dims, dim_head=self.dim_head, n_heads=self.n_heads,
            dim_ffs=self.dim_ffs, window_size=self.window_size,
            drop_ff=self.drop_ff, drop_attn=self.drop_attn,
            drop_path=self.drop_path)
