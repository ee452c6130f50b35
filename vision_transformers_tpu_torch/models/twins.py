"""Twins-SVT classifier (counterpart of ``vision_transformers_tpu/models/
twins.py``; reference: models/twins.py).

Each layer alternates windowed local attention (LSA: no bias table, no
shift) with global sub-sampled attention (GSA: PVT's reduced-kv attention
with the strided conv's kernel and stride the window size and no
LayerNorm after it), each followed by a SiLU FF, four pre-LN residual
branches in all; a depthwise 3x3 conv residual (the positional-encoding
generator, PEG) follows the first layer of each stage.

Module names are the reference torch ``state_dict`` keys (the inverse of
the JAX package's ``utils/torch_convert.py::_convert_twins``):
``block{s}.0.{linear, norm}`` the stage embedding, ``block{s}.1`` layer 0,
``block{s}.2.proj`` the PEG, ``block{s}.{i + 2}`` layer i ≥ 1, each layer
``{norm_attn_local, attn_local.{weight, linear}, norm_ff_local, ff_local,
norm_attn_global, attn_global.{linear_q, linear_kv, linear, reduce_conv},
norm_ff_global, ff_global}``, ``final_linear.0`` and ``classifier.2``.
Images are NCHW; the model works on NHWC maps inside.

LSA dispatches through :func:`ops.attention_impl` with the JAX default
``layer`` (twins.py:224-232; ``layer1`` maps to it, since the window
partition sits between the residual branches): the window partition, then
:func:`ops.fused_attention_layer` on [G·b, m, C] rows in group-major order,
window pairs packed where a row of windows is even and 2·w² ≤ 128 (m =
2·w², the off-diagonal blocks of the pair at −1e9 in an [m, m] mask shared
by heads and groups), the DropPath scale tiled over the groups
(twins.py:84-110); ``einsum`` is the plain per-window attention
(:112-123).  GSA dispatches through :func:`ops.sra_impl` as PVT's SRA does.

Reference quirks reproduced: GSA's reduction is the window size; its conv
reads the NHWC map through ``transpose(1, 2).reshape(b, C, h, w)``, a
reinterpretation of the buffer rather than a permute (twins.py:149-161),
and its output is read back in NCHW order; q / kv projections without
bias; LayerNorm eps 1e-6 in the layers and 1e-5 in the embeddings and the
head; the spatial mean before the classifier; the DropPath ramp
``drop_path·i/sum(depths)`` with four per-sample draws per layer from an
explicit ``torch.Generator``.  dropout, drop_attn and drop_ff > 0 in
training raise NotImplementedError; remat is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from .. import ops
from ..config.registry import TypedConfig, register
from ..ops.fused_attention import fused_attention_reference
from .layers import FeedForward, LayerNorm, drop_path_scale, scaled
from .pvt import reduced_kv_attention
from .swin import PatchEmbedding

__all__ = ["PositionalEncodingGenerator", "LocalAttention", "GlobalSubsampledAttention",
           "TwinsLayer", "TwinsSVT", "TwinsConfig"]

_LN_EPS = 1e-6  # reference: models/twins.py:12
_MASKED = -1e9  # additive bias of a pair the window does not hold


class PositionalEncodingGenerator(nn.Module):
    """x + depthwise 3x3 conv(x) on an NHWC map (CPVT; reference:
    models/twins.py:25-36)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, padding=1, groups=dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class LocalAttention(nn.Module):
    """Windowed MHSA without a bias table or shift (reference:
    models/twins.py:96-152)."""

    def __init__(self, dim: int, n_head: int, dim_head: int, window: int):
        super().__init__()
        self.n_head, self.dim_head, self.window = n_head, dim_head, window
        inner = n_head * dim_head
        self.weight = nn.Linear(dim, 3 * inner)  # q-heads | k-heads | v-heads
        self.linear = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The plain per-window attention on an LN'd map [b, h, w, C]
        (JAX twins.py:112-123)."""
        b, h, w, _ = x.shape
        win, H, D = self.window, self.n_head, self.dim_head
        hs, ws = h // win, w // win
        qkv = self.weight(x).reshape(b, hs, win, ws, win, 3, H, D)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * hs * ws, H, win * win, D)
        out = fused_attention_reference(qkv[0], qkv[1], qkv[2], None, 1.0 / math.sqrt(D))
        out = out.reshape(b, hs, ws, H, win, win, D).permute(0, 1, 4, 2, 5, 3, 6)
        return self.linear(out.reshape(b, h, w, H * D))

    def pack(self, ws: int) -> int:
        """Windows per attention problem: 2 where a row of ``ws`` windows
        is even and a pair holds ≤ 128 tokens (the JAX gate), else 1."""
        return 2 if ws % 2 == 0 and 2 * self.window ** 2 <= 128 else 1

    def pair_mask(self, pack: int, device) -> torch.Tensor | None:
        """[m, m] additive mask of a packed pair: 0 within a window, −1e9
        across (None unpacked)."""
        if pack == 1:
            return None
        m, w2 = pack * self.window ** 2, self.window ** 2
        same = torch.arange(m, device=device) // w2
        mask = torch.full((m, m), _MASKED, device=device)
        return mask.masked_fill(same[:, None] == same[None, :], 0.0)

    def residual_branch(self, x: torch.Tensor, norm: LayerNorm,
                        rs: torch.Tensor | None) -> torch.Tensor:
        """x + rs ⊙ LSA(LN(x)) through the attention-layer op on the
        partitioned map [b, h, w, C] (JAX twins.py:84-110)."""
        b, h, w, C = x.shape
        win = self.window
        hs, ws = h // win, w // win
        pack = self.pack(ws)
        groups = hs * ws // pack
        xw = x.reshape(b, hs, win, ws // pack, pack, win, C).permute(1, 3, 0, 4, 2, 5, 6)
        xw = xw.reshape(groups * b, pack * win * win, C)
        out = ops.fused_attention_layer(
            xw, norm.weight, norm.bias, self.weight.weight.t(), self.weight.bias,
            self.linear.weight.t(), self.linear.bias, self.n_head,
            extra=self.pair_mask(pack, x.device),
            row_scale=None if rs is None else rs.repeat(groups),
            scale=1.0 / math.sqrt(self.dim_head), eps=norm.eps)
        out = out.reshape(hs, ws // pack, b, pack, win, win, C).permute(2, 0, 4, 1, 3, 5, 6)
        return out.reshape(b, h, w, C)


class GlobalSubsampledAttention(nn.Module):
    """PVT-style reduced-kv attention on an NHWC map, no LayerNorm after the
    reduction (reference: models/twins.py:39-93)."""

    def __init__(self, dim: int, n_head: int, reduction: int = 1):
        super().__init__()
        self.n_head, self.reduction = n_head, reduction
        self.linear_q = nn.Linear(dim, dim, bias=False)
        self.linear_kv = nn.Linear(dim, 2 * dim, bias=False)
        self.linear = nn.Linear(dim, dim)
        if reduction > 1:
            self.reduce_conv = nn.Conv2d(dim, dim, reduction, stride=reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """An LN'd map [b, h, w, C] → [b, h, w, C]."""
        b, h, w, C = x.shape
        if self.reduction > 1:
            # the reference's reinterpretation of the NHWC buffer (twins.py:149-161)
            scrambled = x.transpose(1, 2).reshape(b, C, h, w)
            kv_in = self.reduce_conv(scrambled).reshape(b, C, -1).transpose(1, 2)
        else:
            kv_in = x.reshape(b, h * w, C)
        out = reduced_kv_attention(self.linear_q(x).reshape(b, h * w, C),
                                   self.linear_kv(kv_in), self.n_head)
        return self.linear(out.reshape(b, h, w, C))


class TwinsLayer(nn.Module):
    """LSA + FF + GSA + FF, four DropPath residuals (reference:
    models/twins.py:155-197)."""

    def __init__(self, dim: int, n_head: int, dim_head: int, dim_ff: int, window: int,
                 drop_ff: float = 0.0):
        super().__init__()
        self.norm_attn_local = LayerNorm(dim, eps=_LN_EPS)
        self.attn_local = LocalAttention(dim, n_head, dim_head, window)
        self.norm_ff_local = LayerNorm(dim, eps=_LN_EPS)
        self.ff_local = FeedForward(dim, dim_ff, dropout=drop_ff)
        self.norm_attn_global = LayerNorm(dim, eps=_LN_EPS)
        self.attn_global = GlobalSubsampledAttention(dim, n_head, window)
        self.norm_ff_global = LayerNorm(dim, eps=_LN_EPS)
        self.ff_global = FeedForward(dim, dim_ff, dropout=drop_ff)

    def forward(self, x: torch.Tensor, rs=None) -> torch.Tensor:
        """x [b, h, w, C]; ``rs``: pre-drawn DropPath scales of the four
        branches (LSA, its FF, GSA, its FF), each None or [b]."""
        r_lsa, r_ffl, r_gsa, r_ffg = (None,) * 4 if rs is None else rs
        if ops.attention_impl(x.shape[0], default="layer") in ("layer", "layer1"):
            x = self.attn_local.residual_branch(x, self.norm_attn_local, r_lsa)
        else:
            x = x + scaled(self.attn_local(self.norm_attn_local(x)), r_lsa)
        x = x + scaled(self.ff_local(self.norm_ff_local(x)), r_ffl)
        x = x + scaled(self.attn_global(self.norm_attn_global(x)), r_gsa)
        return x + scaled(self.ff_global(self.norm_ff_global(x)), r_ffg)


class TwinsSVT(nn.Module):
    """4-stage Twins-SVT (reference: models/twins.py:220-356).  Parameters
    start at torch's default init: call :meth:`reset_parameters` for the JAX
    model's initializers, or ``load_state_dict`` real weights."""

    def __init__(self, n_class: int, depths, dims, dim_head: int, n_heads, dim_ffs,
                 window_size: int, drop_ff: float = 0.0, drop_attn: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        in_dim = 3
        for s, (depth, reduction) in enumerate(zip(depths, (4, 2, 2, 2))):
            layers = [TwinsLayer(dims[s], n_heads[s], dim_head, dim_ffs[s], window_size,
                                 drop_ff) for _ in range(depth)]
            stage = [PatchEmbedding(dims[s], reduction, in_dim=in_dim), layers[0],
                     PositionalEncodingGenerator(dims[s]), *layers[1:]]
            setattr(self, f"block{s + 1}", nn.ModuleList(stage))
            in_dim = dims[s]
        self.n_stages = len(depths)
        # reference Sequential(LN) and Sequential(pool, flatten, linear)
        self.final_linear = nn.Sequential(LayerNorm(dims[-1], eps=1e-5))
        self.classifier = nn.Sequential(nn.Identity(), nn.Identity(),
                                        nn.Linear(dims[-1], n_class))
        self._dropout = drop_attn > 0 or drop_ff > 0
        n_layers = sum(depths)
        self.drop_path_rates = [drop_path * i / n_layers for i in range(n_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The JAX model's initializers: normal(0.02) for every Linear and
        Conv kernel (``trunc_normal_init(0.02)`` is a plain normal,
        layers.py:92-95), zeros for the biases, ones / zeros for the
        LayerNorms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def draw_drop_path(self, b: int, generator: torch.Generator | None = None):
        """Per-layer scales of the four branches: independent [b] keep-mask /
        keep-prob draws from ``generator`` (None at rate 0), on the model's
        device."""
        device = self.classifier[2].weight.device
        return [tuple(drop_path_scale(b, r, generator, device) for _ in range(4))
                for r in self.drop_path_rates]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits of NCHW images; in training mode DropPath draws from
        ``generator``."""
        if self.training and self._dropout:
            raise NotImplementedError(
                "drop_attn / drop_ff > 0 in training is not ported (ROADMAP); "
                "Twins-SVT-S trains with both at 0")
        out = x.permute(0, 2, 3, 1)
        scales = iter(self.draw_drop_path(out.shape[0], generator) if self.training
                      else [None] * len(self.drop_path_rates))
        for s in range(self.n_stages):
            for block in getattr(self, f"block{s + 1}"):
                out = block(out, next(scales)) if isinstance(block, TwinsLayer) \
                    else block(out)
        out = self.final_linear(out).mean(dim=(1, 2))
        return self.classifier(out.float())


@register("model", "twins_svt")
@dataclasses.dataclass
class TwinsConfig(TypedConfig):
    """Twins-SVT classifier (same fields and Twins-SVT-S defaults as the JAX
    package's TwinsConfig, twins.py:326-343; Chu et al., 2021).  No image
    size: the model takes any map whose stages divide into windows."""

    n_class: int = 1000
    depths: Tuple[int, int, int, int] = (2, 2, 10, 4)
    dims: Tuple[int, int, int, int] = (64, 128, 256, 512)
    dim_head: int = 32
    n_heads: Tuple[int, int, int, int] = (2, 4, 8, 16)
    dim_ffs: Tuple[int, int, int, int] = (256, 512, 1024, 2048)
    window_size: int = 7
    drop_ff: float = 0.0
    drop_attn: float = 0.0
    drop_path: float = 0.0
    remat: bool = False

    def make(self) -> TwinsSVT:
        if self.remat:
            raise NotImplementedError("arch.remat is not ported")
        return TwinsSVT(
            n_class=self.n_class, depths=self.depths, dims=self.dims,
            dim_head=self.dim_head, n_heads=self.n_heads, dim_ffs=self.dim_ffs,
            window_size=self.window_size, drop_ff=self.drop_ff,
            drop_attn=self.drop_attn, drop_path=self.drop_path)
