"""Weights for the port's ViT: from the JAX package's flax params, from a
reference ``.pt`` checkpoint, or generated from a numpy seed.

Every state_dict here is in the reference torch layout (models/vit.py of
the reference; the keys of the JAX package's
``utils/torch_convert.py:118-143``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "load_checkpoint", "seeded_state_dict",
           "seeded_images", "seeded_train_batch", "grad_projections", "to_torch"]


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


def state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX package's flax ViT ``params`` (nested dict of arrays, per-layer
    ``layers_{i}`` layout) → the port's state_dict, as numpy arrays."""
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
        _lin(dst, f"layers.{i}.ff.0", lp["ff"]["fc1"])
        _lin(dst, f"layers.{i}.ff.3", lp["ff"]["fc2"])
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


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """One state_dict from a reference ``.pt[:key]`` checkpoint.

    ``:key`` selects the sub-dict (``model`` / ``ema``; reference
    train.py:208-217); without it a wrapper resolves to the first of
    ``model``, ``ema``, ``student``, ``teacher``, ``state_dict`` it holds,
    as the JAX package's ``load_torch_checkpoint`` does.  DDP's ``module.``
    prefix is stripped.  Orbax checkpoint directories are not read by the
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
    elif any(isinstance(v, dict) for v in obj.values()) and \
            not any(torch.is_tensor(v) for v in obj.values()):
        for candidate in ("model", "ema", "student", "teacher", "state_dict"):
            if candidate in obj:
                obj = obj[candidate]
                break
        else:
            raise KeyError(f"{path} is a checkpoint wrapper, not a bare "
                           f"state_dict; append :key, one of {sorted(obj)}")
    out = {}
    for k, v in obj.items():
        if not torch.is_tensor(v):
            raise ValueError(f"{path}: entry {k!r} is {type(v).__name__}, not a "
                             f"tensor; append :key to select a state_dict")
        out[k[len("module."):] if k.startswith("module.") else k] = v
    return out


# ---------------------------------------------------------------------------
# seeded weights and images (tests, the golden file, chip_smoke.py)
# ---------------------------------------------------------------------------


def seeded_state_dict(arch, seed: int) -> Dict[str, np.ndarray]:
    """Random ViT weights in reference layout from a numpy seed: std-0.02
    normals for every weight and bias, LayerNorms at ones / zeros.  ``arch``
    is the port's ViTConfig (or anything with its fields)."""
    rng = np.random.default_rng([seed, 0])
    h, w = (arch.image_size, arch.image_size) if isinstance(arch.image_size, int) \
        else tuple(arch.image_size)
    p, dim, ff = arch.window_size, arch.dim, arch.dim_ff
    n_tok = (h // p) * (w // p) + 1

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    sd: Dict[str, np.ndarray] = {}

    def ln(name, n):
        sd[f"{name}.weight"] = np.ones(n, np.float32)
        sd[f"{name}.bias"] = np.zeros(n, np.float32)

    def lin(name, n_out, n_in):
        sd[f"{name}.weight"] = normal(n_out, n_in)
        sd[f"{name}.bias"] = normal(n_out)

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
    lin("head", arch.n_class, dim)
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


def grad_projections(grads: Dict[str, np.ndarray], seed: int) -> Dict[str, float]:
    """state_dict key → Σ grad · v, with v a standard-normal tensor of the
    grad's shape drawn from ``(seed, 3, i)`` for the i-th key in sorted
    order: one number per tensor that moves with any part of it."""
    out = {}
    for i, k in enumerate(sorted(grads)):
        g = np.asarray(grads[k], np.float64)
        v = np.random.default_rng([seed, 3, i]).standard_normal(g.shape, dtype=np.float32)
        out[k] = float((g * v).sum())
    return out
