"""Weights for the port's ViT, DINO, Swin, Halo, PVT and Twins-SVT: from the
JAX package's flax params, from a reference ``.pt`` checkpoint, or generated
from a numpy seed; and the seeded dropout masks a train-step golden and
its checks share.

Every state_dict here is in the reference torch layout (models/vit.py,
models/swin_transformer.py, models/halo_transformer.py, models/pvt.py and
models/twins.py of the reference; the keys of the JAX package's
``utils/torch_convert.py:118-328``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "load_checkpoint", "load_dino_checkpoint",
           "seeded_state_dict",
           "seeded_images", "seeded_train_batch", "seeded_dino_crops",
           "seeded_dropout_masks", "row_projections",
           "supplied_dropout_masks", "vit_dropout_calls", "swin_dropout_calls",
           "grad_projections", "to_torch"]


# ---------------------------------------------------------------------------
# flax params → state_dict (numpy only; mirrors the JAX package's
# utils/torch_export.py::_export_vit, :75-96)
# ---------------------------------------------------------------------------


def _lin(dst, name, p):
    dst[f"{name}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        dst[f"{name}.bias"] = np.asarray(p["bias"])


def _ln(dst, name, p):
    dst[f"{name}.weight"] = np.asarray(p["scale"])
    dst[f"{name}.bias"] = np.asarray(p["bias"])


def _ff(dst, name, p):
    _lin(dst, f"{name}.0", p["fc1"])
    _lin(dst, f"{name}.3", p["fc2"])


def _conv(dst, name, p):
    """flax Conv kernel [kh, kw, in, out] → torch weight [out, in, kh, kw]."""
    dst[f"{name}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        dst[f"{name}.bias"] = np.asarray(p["bias"])


def _swin_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of the JAX package's ``_convert_swin``
    (utils/torch_convert.py:192-224)."""
    dst: Dict[str, np.ndarray] = {}
    _lin(dst, "patch_embedding.linear", params["patch_embedding"]["linear"])
    _ln(dst, "patch_embedding.norm", params["patch_embedding"]["norm"])
    _ln(dst, "final_linear.0", params["final_norm"])
    _lin(dst, "classifier.2", params["classifier"])
    s = 1
    while f"block{s}_0" in params:
        offset = 0
        if f"merge{s}" in params:
            _ln(dst, f"block{s}.0.norm", params[f"merge{s}"]["norm"])
            _lin(dst, f"block{s}.0.linear", params[f"merge{s}"]["linear"])
            offset = 1
        i = 0
        while f"block{s}_{i}" in params:
            bp, t = params[f"block{s}_{i}"], f"block{s}.{i + offset}"
            _ln(dst, f"{t}.norm_attn", bp["norm_attn"])
            _lin(dst, f"{t}.attn.weight", bp["attn"]["weight"])
            _lin(dst, f"{t}.attn.linear", bp["attn"]["linear"])
            dst[f"{t}.attn.rel_pos.weight"] = np.asarray(bp["attn"]["rel_pos"])
            _ln(dst, f"{t}.norm_ff", bp["norm_ff"])
            _ff(dst, f"{t}.ff", bp["ff"])
            i += 1
        s += 1
    return dst


def _halo_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of the JAX package's ``_convert_halo``
    (utils/torch_convert.py:258-283); the same keys as its
    ``utils/torch_export.py::_export_halo`` writes."""
    dst: Dict[str, np.ndarray] = {}
    _ln(dst, "final_linear.0", params["final_norm"])
    _lin(dst, "final_linear.1", params["final_linear"])
    _ln(dst, "final_linear.2", params["final_norm2"])
    _lin(dst, "classifier.2", params["classifier"])
    s = 1
    while f"embed{s}" in params:
        _lin(dst, f"block{s}.0.linear", params[f"embed{s}"]["linear"])
        _ln(dst, f"block{s}.0.norm", params[f"embed{s}"]["norm"])
        i = 0
        while f"block{s}_{i}" in params:
            bp, t = params[f"block{s}_{i}"], f"block{s}.{i + 1}"
            _ln(dst, f"{t}.norm_attn", bp["norm_attn"])
            _lin(dst, f"{t}.attn.weight", bp["attn"]["weight"])
            _lin(dst, f"{t}.attn.linear", bp["attn"]["linear"])
            dst[f"{t}.attn.rel_pos.weight"] = np.asarray(bp["attn"]["rel_pos"])
            _ln(dst, f"{t}.norm_ff", bp["norm_ff"])
            _ff(dst, f"{t}.ff", bp["ff"])
            i += 1
        s += 1
    return dst


def _pvt_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of the JAX package's ``_convert_pvt``
    (utils/torch_convert.py:227-255)."""
    dst: Dict[str, np.ndarray] = {}
    _ln(dst, "norm", params["norm"])
    _lin(dst, "classifier", params["classifier"])
    s = 0
    while f"patch_embedding_{s}" in params:
        pe, t = params[f"patch_embedding_{s}"], f"patch_embedding.{s}"
        _conv(dst, f"{t}.conv", pe["conv"])
        _ln(dst, f"{t}.norm", pe["norm"])
        dst[f"{t}.pos"] = np.asarray(pe["pos"])
        if "cls_token" in pe:  # the last stage only
            dst[f"{t}.cls_token"] = np.asarray(pe["cls_token"])
        i = 0
        while f"block{s + 1}_{i}" in params:
            bp, t = params[f"block{s + 1}_{i}"], f"block{s + 1}.{i}"
            _ln(dst, f"{t}.norm_attn", bp["norm_attn"])
            for name in ("linear_q", "linear_kv", "linear"):
                _lin(dst, f"{t}.attn.{name}", bp["attn"][name])
            if "reduce_conv" in bp["attn"]:  # reduction > 1
                _conv(dst, f"{t}.attn.reduce_conv", bp["attn"]["reduce_conv"])
                _ln(dst, f"{t}.attn.reduce_norm", bp["attn"]["reduce_norm"])
            _ln(dst, f"{t}.norm_ff", bp["norm_ff"])
            _ff(dst, f"{t}.ff", bp["ff"])
            i += 1
        s += 1
    return dst


def _twins_layer_index(i: int) -> int:
    """Torch index of layer ``i`` in a Twins stage's Sequential(embedding,
    layer 0, PEG, layer 1, ...): 1 for i = 0, else i + 2."""
    return 1 if i == 0 else i + 2


def _twins_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of the JAX package's ``_convert_twins``
    (utils/torch_convert.py:287-328)."""
    dst: Dict[str, np.ndarray] = {}
    _ln(dst, "final_linear.0", params["final_norm"])
    _lin(dst, "classifier.2", params["classifier"])
    s = 1
    while f"embed{s}" in params:
        _lin(dst, f"block{s}.0.linear", params[f"embed{s}"]["linear"])
        _ln(dst, f"block{s}.0.norm", params[f"embed{s}"]["norm"])
        i = 0
        while f"block{s}_{i}" in params:
            bp, t = params[f"block{s}_{i}"], f"block{s}.{_twins_layer_index(i)}"
            _ln(dst, f"{t}.norm_attn_local", bp["norm_attn_local"])
            _lin(dst, f"{t}.attn_local.weight", bp["attn_local"]["weight"])
            _lin(dst, f"{t}.attn_local.linear", bp["attn_local"]["linear"])
            _ln(dst, f"{t}.norm_ff_local", bp["norm_ff_local"])
            _ff(dst, f"{t}.ff_local", bp["ff_local"])
            _ln(dst, f"{t}.norm_attn_global", bp["norm_attn_global"])
            for name in ("linear_q", "linear_kv", "linear"):
                _lin(dst, f"{t}.attn_global.{name}", bp["attn_global"][name])
            if "reduce_conv" in bp["attn_global"]:
                _conv(dst, f"{t}.attn_global.reduce_conv", bp["attn_global"]["reduce_conv"])
            _ln(dst, f"{t}.norm_ff_global", bp["norm_ff_global"])
            _ff(dst, f"{t}.ff_global", bp["ff_global"])
            i += 1
        # the depthwise PEG conv after layer 0 (no bias)
        _conv(dst, f"block{s}.2.proj", params[f"peg{s}"]["proj"])
        s += 1
    return dst


def _dino_head_from_flax(head: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of the head half of the JAX package's ``_convert_dino``
    (utils/torch_convert.py:146-189): ``mlp_i`` → ``head.mlp.{2i}`` (the
    GELUs hold the odd slots; a bare ``head.mlp`` at depth 1), ``last_v``
    [in, out] → ``head.last.weight_v`` [out, in], ``last_g`` [out] →
    ``head.last.weight_g`` [out, 1] (ones where the gain is frozen, as the
    reference's weight_norm keeps it)."""
    if any(k.startswith("bn_") for k in head):
        raise NotImplementedError("the DINO head's BatchNorm (use_bn) is not ported")
    dst: Dict[str, np.ndarray] = {}
    n_mlp = sum(k.startswith("mlp_") for k in head)
    for i in range(n_mlp):
        _lin(dst, "head.mlp" if n_mlp == 1 else f"head.mlp.{2 * i}", head[f"mlp_{i}"])
    v = np.asarray(head["last_v"])
    dst["head.last.weight_v"] = v.T
    dst["head.last.weight_g"] = (np.asarray(head["last_g"]).reshape(-1, 1) if "last_g" in head
                                 else np.ones((v.shape[1], 1), v.dtype))
    return dst


def state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's flax ``params`` (nested dict of arrays) of a ViT
    (per-layer ``layers_{i}`` layout), a DINO network, a Swin, a Halo, a
    PVT or a Twins-SVT → the port's state_dict, as numpy arrays.  The
    family is told by a top-level key only it has: ``backbone`` beside
    ``head`` (DINO: the ViT trunk at top level, the head under ``head.``),
    ``peg1`` (Twins' positional-encoding generator; Twins also has
    ``embed1`` and ``final_norm``), ``patch_embedding_0`` (PVT's per-stage
    embeddings), ``embed1`` without ``peg1`` (Halo's stage embeddings; Halo
    also has ``final_norm``), ``final_norm`` beside ``patch_embedding``
    (Swin), else ViT."""
    if "backbone" in params and "head" in params:
        return {**state_dict_from_flax(params["backbone"]),
                **_dino_head_from_flax(params["head"])}
    if "peg1" in params:
        return _twins_from_flax(params)
    if "patch_embedding_0" in params:
        return _pvt_from_flax(params)
    if "embed1" in params:
        return _halo_from_flax(params)
    if "final_norm" in params and "patch_embedding" in params:
        return _swin_from_flax(params)
    dst: Dict[str, np.ndarray] = {}
    conv = params["patch_embedding"]["linear"]
    dst["patch_embedding.linear.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
    dst["patch_embedding.linear.bias"] = np.asarray(conv["bias"])
    dst["cls_token"] = np.asarray(params["cls_token"])
    dst["pos_embed"] = np.asarray(params["pos_embed"])
    _ln(dst, "norm", params["norm"])
    i = 0
    while f"layers_{i}" in params:
        lp = params[f"layers_{i}"]
        _ln(dst, f"layers.{i}.norm_attn", lp["norm_attn"])
        _lin(dst, f"layers.{i}.attn.qkv", lp["attn"]["qkv"])
        _lin(dst, f"layers.{i}.attn.linear", lp["attn"]["linear"])
        _ln(dst, f"layers.{i}.norm_ff", lp["norm_ff"])
        _ff(dst, f"layers.{i}.ff", lp["ff"])
        i += 1
    if "head" in params:
        _lin(dst, "head", params["head"])
    return dst


def to_torch(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy state_dict → torch tensors (contiguous copies)."""
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in state_dict.items()}


# ---------------------------------------------------------------------------
# reference .pt checkpoints (JAX package: utils/torch_convert.py:588-650)
# ---------------------------------------------------------------------------


# state_dict entries of the reference that are no weights: BN step
# counters and Swin's precomputed relative-position index / shift mask
# buffers and Halo's ``.attn.pos`` index (the port computes them in numpy;
# the JAX package's list, utils/torch_convert.py:450-458)
_BUFFER_SUFFIXES = ("num_batches_tracked", ".attn.pos", ".attn.local_mask")


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """One state_dict from a reference ``.pt[:key]`` checkpoint.

    ``:key`` selects the sub-dict (``model`` / ``ema``; reference
    train.py:208-217); without it a wrapper resolves to the first of
    ``model``, ``ema``, ``student``, ``teacher``, ``state_dict`` it holds,
    as the JAX package's ``load_torch_checkpoint`` does.  DDP's ``module.``
    prefix is stripped, and the reference's buffers that hold no weights
    (``_BUFFER_SUFFIXES``) are dropped.  Orbax checkpoint directories are not read by the
    port yet."""
    key: Optional[str] = None
    if ":" in path and not os.path.exists(path):
        path, key = path.rsplit(":", 1)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a checkpoint directory (orbax); the port reads reference "
            f".pt files only — export one with export.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    # reference checkpoints pickle their conf/optimizer state beside the
    # weights, so weights_only=True refuses them (as in the JAX package)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None:
        if key not in obj:
            raise KeyError(f"{path} has no {key!r}; top-level keys: {sorted(obj)}")
        obj = obj[key]
    elif any(isinstance(v, dict) for v in obj.values()):
        # a wrapper (a state_dict holds tensors only): a DINO checkpoint
        # keeps its center tensor beside the two nets
        for candidate in ("model", "ema", "student", "teacher", "state_dict"):
            if candidate in obj:
                obj = obj[candidate]
                break
        else:
            raise KeyError(f"{path} is a checkpoint wrapper, not a bare "
                           f"state_dict; append :key, one of {sorted(obj)}")
    return _state_dict(obj, path)


def _state_dict(obj: Dict[str, Any], path: str) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in obj.items():
        if k.endswith(_BUFFER_SUFFIXES):
            continue
        if not torch.is_tensor(v):
            raise ValueError(f"{path}: entry {k!r} is {type(v).__name__}, not a "
                             f"tensor; append :key to select a state_dict")
        out[k[len("module."):] if k.startswith("module.") else k] = v
    return out


def load_dino_checkpoint(path: str):
    """(student, teacher) state_dicts of a reference DINO ``.pt`` holding
    both nets (reference train_dino.py:173-181; the JAX package's
    ``load_torch_dino_checkpoint``), with one file read; (state_dict, None)
    for any other file :func:`load_checkpoint` reads (``PATH:key`` too) —
    the caller seeds the teacher from the student."""
    if os.path.isfile(path):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "student" in obj and "teacher" in obj:
            return _state_dict(obj["student"], path), _state_dict(obj["teacher"], path)
    return load_checkpoint(path), None


# ---------------------------------------------------------------------------
# seeded weights and images (tests, the golden file, chip_smoke.py)
# ---------------------------------------------------------------------------


def seeded_state_dict(arch, seed: int) -> Dict[str, np.ndarray]:
    """Random weights in reference layout from a numpy seed: std-0.02
    normals for every weight and bias (and PVT's position embeddings and
    cls token), LayerNorms at ones / zeros, and for a Swin or a Halo std-0.2
    normals in the relative-position tables (non-zero, so that a comparison
    sees the bias; the JAX initializer is zeros).  ``arch`` is the port's
    ViTConfig, SwinConfig, HaloConfig, PVTConfig or TwinsConfig; the family
    is its registered type (a DINOConfig: the ViT trunk, then the head,
    whose trainable gain is drawn around 1)."""
    rng = np.random.default_rng([seed, 0])

    def normal(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    sd: Dict[str, np.ndarray] = {}

    def ln(name, n):
        sd[f"{name}.weight"] = np.ones(n, np.float32)
        sd[f"{name}.bias"] = np.zeros(n, np.float32)

    def lin(name, n_out, n_in, bias=True):
        sd[f"{name}.weight"] = normal(n_out, n_in)
        if bias:
            sd[f"{name}.bias"] = normal(n_out)

    def conv(name, n_out, n_in, k, bias=True):
        sd[f"{name}.weight"] = normal(n_out, n_in, k, k)
        if bias:
            sd[f"{name}.bias"] = normal(n_out)

    def ff(name, dim, dim_ff):
        lin(f"{name}.0", dim_ff, dim)
        lin(f"{name}.3", dim, dim_ff)

    if arch.type == "pvt":
        h, w = (arch.image_size, arch.image_size) if isinstance(arch.image_size, int) \
            else tuple(arch.image_size)
        dims, in_dim = arch.patch_embed_dims, 3
        for s, (depth, patch) in enumerate(zip(arch.depths, (4, 2, 2, 2))):
            h, w, t = h // patch, w // patch, f"patch_embedding.{s}"
            conv(f"{t}.conv", dims[s], in_dim, patch)
            ln(f"{t}.norm", dims[s])
            last = s == len(arch.depths) - 1
            sd[f"{t}.pos"] = normal(h * w + (1 if last else 0), dims[s])
            if last:
                sd[f"{t}.cls_token"] = normal(dims[s])
            for i in range(depth):
                t = f"block{s + 1}.{i}"
                ln(f"{t}.norm_attn", dims[s])
                lin(f"{t}.attn.linear_q", dims[s], dims[s], bias=False)
                lin(f"{t}.attn.linear_kv", 2 * dims[s], dims[s], bias=False)
                lin(f"{t}.attn.linear", dims[s], dims[s])
                if arch.reductions[s] > 1:
                    conv(f"{t}.attn.reduce_conv", dims[s], dims[s], arch.reductions[s])
                    ln(f"{t}.attn.reduce_norm", dims[s])
                ln(f"{t}.norm_ff", dims[s])
                ff(f"{t}.ff", dims[s], arch.dim_ffs[s])
            in_dim = dims[s]
        ln("norm", dims[-1])
        lin("classifier", arch.n_class, dims[-1])
        return sd

    if arch.type == "twins_svt":
        dims, in_dim = arch.dims, 3
        for s, (depth, patch) in enumerate(zip(arch.depths, (4, 2, 2, 2))):
            lin(f"block{s + 1}.0.linear", dims[s], in_dim * patch * patch)
            ln(f"block{s + 1}.0.norm", dims[s])
            inner = arch.n_heads[s] * arch.dim_head
            for i in range(depth):
                t = f"block{s + 1}.{_twins_layer_index(i)}"
                ln(f"{t}.norm_attn_local", dims[s])
                lin(f"{t}.attn_local.weight", 3 * inner, dims[s])
                lin(f"{t}.attn_local.linear", dims[s], inner)
                ln(f"{t}.norm_ff_local", dims[s])
                ff(f"{t}.ff_local", dims[s], arch.dim_ffs[s])
                ln(f"{t}.norm_attn_global", dims[s])
                lin(f"{t}.attn_global.linear_q", dims[s], dims[s], bias=False)
                lin(f"{t}.attn_global.linear_kv", 2 * dims[s], dims[s], bias=False)
                lin(f"{t}.attn_global.linear", dims[s], dims[s])
                if arch.window_size > 1:  # the GSA reduction is the window
                    conv(f"{t}.attn_global.reduce_conv", dims[s], dims[s],
                         arch.window_size)
                ln(f"{t}.norm_ff_global", dims[s])
                ff(f"{t}.ff_global", dims[s], arch.dim_ffs[s])
            sd[f"block{s + 1}.2.proj.weight"] = normal(dims[s], 1, 3, 3)
            in_dim = dims[s]
        ln("final_linear.0", dims[-1])
        lin("classifier.2", arch.n_class, dims[-1])
        return sd

    if arch.type == "halo_transformer":
        from ..models.halo import halo_position_index

        dims, in_dim = arch.dims, 3
        n_pos = halo_position_index(arch.window_size, arch.halo_size)[1] + 1
        for s, (depth, patch) in enumerate(zip(arch.depths, (4, 2, 2, 2))):
            lin(f"block{s + 1}.0.linear", dims[s], in_dim * patch * patch)
            ln(f"block{s + 1}.0.norm", dims[s])
            inner = arch.n_heads[s] * arch.dim_head
            for i in range(depth):
                t = f"block{s + 1}.{i + 1}"
                ln(f"{t}.norm_attn", dims[s])
                lin(f"{t}.attn.weight", 3 * inner, dims[s], bias=False)
                lin(f"{t}.attn.linear", dims[s], inner)
                sd[f"{t}.attn.rel_pos.weight"] = normal(n_pos, arch.n_heads[s], std=0.2)
                ln(f"{t}.norm_ff", dims[s])
                lin(f"{t}.ff.0", arch.dim_ffs[s], dims[s])
                lin(f"{t}.ff.3", dims[s], arch.dim_ffs[s])
            in_dim = dims[s]
        ln("final_linear.0", dims[-1])
        lin("final_linear.1", 2 * dims[-1], dims[-1])
        ln("final_linear.2", 2 * dims[-1])
        lin("classifier.2", arch.n_class, 2 * dims[-1])
        return sd

    if arch.type == "swin_transformer":
        dims = arch.dims
        lin("patch_embedding.linear", dims[0], 3 * 4 * 4)
        ln("patch_embedding.norm", dims[0])
        for s, depth in enumerate(arch.depths):
            offset = 0
            if s > 0:
                ln(f"block{s + 1}.0.norm", 4 * dims[s - 1])
                lin(f"block{s + 1}.0.linear", dims[s], 4 * dims[s - 1], bias=False)
                offset = 1
            inner = arch.n_heads[s] * arch.dim_head
            for i in range(depth):
                t = f"block{s + 1}.{i + offset}"
                ln(f"{t}.norm_attn", dims[s])
                lin(f"{t}.attn.weight", 3 * inner, dims[s])
                lin(f"{t}.attn.linear", dims[s], inner)
                sd[f"{t}.attn.rel_pos.weight"] = normal(
                    (2 * arch.window_size - 1) ** 2, arch.n_heads[s], std=0.2)
                ln(f"{t}.norm_ff", dims[s])
                lin(f"{t}.ff.0", arch.dim_ffs[s], dims[s])
                lin(f"{t}.ff.3", dims[s], arch.dim_ffs[s])
        ln("final_linear.0", dims[-1])
        lin("classifier.2", arch.n_class, dims[-1])
        return sd

    h, w = (arch.image_size, arch.image_size) if isinstance(arch.image_size, int) \
        else tuple(arch.image_size)
    p, dim, ff = arch.window_size, arch.dim, arch.dim_ff
    n_tok = (h // p) * (w // p) + 1
    sd["patch_embedding.linear.weight"] = normal(dim, 3, p, p)
    sd["patch_embedding.linear.bias"] = normal(dim)
    sd["cls_token"] = normal(1, 1, dim)
    sd["pos_embed"] = normal(1, n_tok, dim)
    for i in range(arch.depth):
        t = f"layers.{i}"
        ln(f"{t}.norm_attn", dim)
        lin(f"{t}.attn.qkv", 3 * dim, dim)
        lin(f"{t}.attn.linear", dim, dim)
        ln(f"{t}.norm_ff", dim)
        lin(f"{t}.ff.0", ff, dim)
        lin(f"{t}.ff.3", dim, ff)
    ln("norm", dim)
    if arch.type != "dino":
        lin("head", arch.n_class, dim)
        return sd
    # the head after the trunk: std-0.02 normals, and a gain around 1
    # that is not 1 where it trains (unit gains would hide its gradient)
    bottleneck, width = arch.dim_head_bottleneck, arch.dim_head_ff
    dims = [arch.dim] + [width] * (arch.depth_head - 1) + [bottleneck]
    for i in range(arch.depth_head):
        name = "head.mlp" if arch.depth_head == 1 else f"head.mlp.{2 * i}"
        sd[f"{name}.weight"] = normal(dims[i + 1], dims[i])
        sd[f"{name}.bias"] = normal(dims[i + 1])
    sd["head.last.weight_v"] = normal(arch.dim_head_out, bottleneck)
    sd["head.last.weight_g"] = (np.ones((arch.dim_head_out, 1), np.float32)
                                if arch.norm_last_layer else
                                1.0 + normal(arch.dim_head_out, 1, std=0.2))
    return sd


def seeded_images(seed: int, n: int, size: int) -> np.ndarray:
    """``n`` uint8 [size, size, 3] noise images (NHWC) from a numpy seed."""
    rng = np.random.default_rng([seed, 1])
    return rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def seeded_train_batch(seed: int, n: int, size: int, n_class: int) -> Dict[str, np.ndarray]:
    """A train-step batch from a numpy seed: ``n`` normalized f32 NHWC
    images (standard normals, as the synthetic backend's) and labels, with
    ``label2 = label1`` and ``ratio = 1`` (no mixing)."""
    rng = np.random.default_rng([seed, 2])
    labels = rng.integers(0, n_class, size=n).astype(np.int32)
    return {"image": rng.standard_normal((n, size, size, 3), dtype=np.float32),
            "label1": labels, "label2": labels.copy(),
            "ratio": np.ones(n, np.float32)}


def seeded_dino_crops(seed: int, n: int, global_size: int, local_size: int,
                      n_local: int) -> list:
    """The crops of a DINO step from a numpy seed, as the step takes them
    after the augmentation: 2 global f32 NHWC batches [n, S, S, 3], then
    ``n_local`` local ones [n, s, s, 3], standard normals (normalized
    images)."""
    rng = np.random.default_rng([seed, 5])
    return [rng.standard_normal((n, size, size, 3), dtype=np.float32)
            for size in [global_size] * 2 + [local_size] * n_local]


def row_projections(out: np.ndarray, seed: int) -> np.ndarray:
    """out [rows, K] → Σ_k out[r, k] · v[k] per row, v a standard-normal
    [K] vector from ``(seed, 6)``: one number per row (a crop's DINO
    output) that moves with any part of it."""
    v = np.random.default_rng([seed, 6]).standard_normal(out.shape[-1], dtype=np.float32)
    return np.asarray(out, np.float64) @ v.astype(np.float64)


def seeded_dropout_masks(seed: int, shapes, rate) -> list:
    """One boolean keep-mask per shape, True with probability 1 − ``rate``
    (one rate, or one per shape), the i-th from the numpy stream
    ``(seed, 4, i)`` drawn in row-major order — so a mask depends on its
    element count, not on how the caller splits the dims: the dropout masks
    of a train-step golden, made the same way by the script that writes
    it, its test and chip_smoke.py."""
    rates = [rate] * len(shapes) if np.ndim(rate) == 0 else list(rate)
    return [np.random.default_rng([seed, 4, i]).random(int(np.prod(shape)))
            .reshape(shape) < 1.0 - r for i, (shape, r) in enumerate(zip(shapes, rates))]


@contextlib.contextmanager
def supplied_dropout_masks(masks):
    """Within the block every active dropout of the port (``models.layers.
    dropout``, rate > 0) takes the next of ``masks`` (boolean arrays or
    tensors of its element count, in call order) instead of drawing one:
    ``where(mask, x / keep, 0)``.  Yields the list of the (shape, rate) of
    each call that took one."""
    from ..models import layers

    feed, calls, draw = iter(masks), [], layers.dropout

    def supplied(x, rate, generator=None):
        if rate == 0.0:
            return x
        calls.append((tuple(x.shape), rate))
        mask = torch.as_tensor(next(feed), device=x.device).reshape(x.shape)
        return torch.where(mask, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    layers.dropout = supplied
    try:
        yield calls
    finally:
        layers.dropout = draw


def vit_dropout_calls(arch, n: int) -> list:
    """(shape, rate) of each of a ViT's dropout masks in one training
    forward of ``n`` images, in the JAX model's call order (vit.py:296-303,
    447): the pos-embed output, then per layer the attention probabilities
    (where ``drop_attn`` > 0), the attention branch, the FF hidden (where
    ``drop_ff`` > 0) and the FF branch (where ``dropout`` > 0)."""
    size = arch.image_size if isinstance(arch.image_size, int) else arch.image_size[0]
    tokens = (size // arch.window_size) ** 2 + 1
    row, hidden = (n, tokens, arch.dim), (n, tokens, arch.dim_ff)
    probs = (n, arch.n_head, tokens, tokens)
    layer = [(probs, arch.drop_attn), (row, arch.dropout), (hidden, arch.drop_ff),
             (row, arch.dropout)]
    return [c for c in [(row, arch.dropout)] + layer * arch.depth if c[1] > 0]


def swin_dropout_calls(arch, n: int) -> list:
    """(shape, rate) of each of a Swin's dropout masks in one training
    forward of ``n`` images, in the JAX model's call order (swin.py:320,
    layers.py:346): per layer, stage by stage, the attention probabilities
    [n, G, heads, m, m] of the packed windows (where ``drop_attn`` > 0),
    then the FF hidden [n, h, w, dim_ff] (where ``drop_ff`` > 0)."""
    from ..models.swin import window_pack

    size = arch.image_size
    h, w = (size, size) if isinstance(size, int) else tuple(size)
    h, w = h // 4, w // 4
    win, calls = arch.window_size, []
    for s, depth in enumerate(arch.depths):
        if s:
            h, w = h // 2, w // 2
        pack = window_pack(win, (h, w))
        groups = (h // win) * (w // win) // pack
        probs = (n, groups, arch.n_heads[s], pack * win * win, pack * win * win)
        hidden = (n, h, w, arch.dim_ffs[s])
        calls += [(probs, arch.drop_attn), (hidden, arch.drop_ff)] * depth
    return [c for c in calls if c[1] > 0]


def grad_projection_vector(seed: int, i: int, shape) -> np.ndarray:
    """The standard-normal tensor of :func:`grad_projections` for the i-th
    key in sorted order: ``shape``, drawn from ``(seed, 3, i)``."""
    return np.random.default_rng([seed, 3, i]).standard_normal(shape, dtype=np.float32)


def grad_projections(grads: Dict[str, np.ndarray], seed: int,
                     vectors: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, float]:
    """state_dict key → Σ grad · v, with v a standard-normal tensor of the
    grad's shape drawn from ``(seed, 3, i)`` for the i-th key in sorted
    order: one number per tensor that moves with any part of it.
    ``vectors``: those tensors by key, made beforehand with
    :func:`grad_projection_vector` (a caller projecting several steps' grads
    draws them once)."""
    out = {}
    for i, k in enumerate(sorted(grads)):
        g = np.asarray(grads[k], np.float64)
        v = vectors[k] if vectors is not None else grad_projection_vector(seed, i, g.shape)
        out[k] = float(np.dot(g.ravel(), v.ravel().astype(np.float64)))
    return out
