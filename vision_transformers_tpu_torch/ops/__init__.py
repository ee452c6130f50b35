"""Hand-written CUDA kernels and the attention dispatch.

Counterpart of ``vision_transformers_tpu/ops/__init__.py``.  Each kernel
(float32) sits beside its plain torch version, forward and backward inside
a ``torch.autograd.Function``.  Three take the attention dispatch of
:func:`attention_impl`:

- ``layer``:  :func:`fused_attention_layer` (ops/fused_layer.py) — the
  pre-LN attention residual branch, with an optional additive bias.  ViT's
  training path without dropout (32+ rows) and Twins' local attention
  (window pairs under a block-diagonal mask).  The FF half stays plain
  torch unless :func:`set_ff_kernel` (or ``VTX_FF_KERNEL``) turns on
  :func:`fused_ff_layer` (ops/fused_layer.py), the pre-LN FF residual
  branch with silu or tanh-gelu and a DropPath row scale — off by default,
  as in the JAX package.
- ``layer1``: :func:`fused_transformer_layer` (ops/fused_layer1.py) — the
  whole layer, both residual branches, with the additive attention bias
  (Swin's grouped [G, H, m, m] relative-position bias + shift mask) and
  both DropPath row scales.  Swin's default path in training, eval and
  serving; ViT's under :func:`forward_only` from 128 rows.
- ``fused``:  :func:`fused_attention_qkv` (ops/fused_attention.py) — the
  attention alone, straight from the packed qkv projection, with an
  optional shared or grouped bias.  ViT's training path with dropout (the
  layer kernels take no dropout; 32+ rows, 128+ tokens, and no
  attention-probability dropout); Swin's under a force.
- ``block``:  :func:`fused_attention_block` (ops/fused_block.py) — the qkv
  projection, the attention with an optional shared or grouped bias and the
  out projection, no LN and no residual.  Only under a force
  (``set_attention_impl("block")`` or ``VTX_ATTN_IMPL=block``), as in the
  JAX package; ViT's and Swin's two-branch layer runs it, with LN, the
  residuals, DropPath and dropout outside (einsum instead where attention
  probabilities are dropped in training).

``einsum`` is the plain torch attention of the models.

The reduced-kv attention of PVT (spatial reduction) and Twins (global
sub-sampled attention) has its own dispatch, :func:`sra_impl` (the JAX
``sra_attention_impl``): ``fused`` runs :func:`fused_attention`
(ops/fused_attention.py) on the projected q [B, H, M, D] and the reduced
k / v [B, H, N, D], ``einsum`` (the default, as in the JAX package) its
plain torch version.  The name ``fused_attention`` here is the function; its
module (launch counters, plain versions) is ``fused_attention_mod``, as in
the JAX package.

Halo attention has its own dispatch, :func:`halo_impl` (the JAX
``halo_impl``): ``layer`` runs ``fused_halo_layer.fused_halo_layer``
(ops/fused_halo_layer.py; the module keeps the name here), the whole Halo
layer off the feature map — the default wherever 2·halo ≤ window, in
training, eval and serving —; ``direct`` the attention alone,
:func:`halo_attention_direct` (ops/fused_halo.py), between plain torch
projections; ``gather`` the attention on gathered neighbourhoods,
:func:`halo_attention` (ops/fused_halo.py) — the default wherever
2·halo > window, the neighbourhood gather and its adjoint plain torch data
movement around it —; ``einsum`` the plain torch neighbourhood attention.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

from . import fused_attention as fused_attention_mod  # noqa: F401  (the module)
from . import fused_halo_layer  # noqa: F401  (the module; see above)
from .fused_attention import fused_attention  # noqa: F401  (the function)
from .fused_attention import fused_attention_qkv  # noqa: F401
from .fused_block import fused_attention_block  # noqa: F401
from .fused_halo import halo_attention, halo_attention_direct  # noqa: F401
from .fused_layer import fused_attention_layer, fused_ff_layer  # noqa: F401
from .fused_layer1 import fused_transformer_layer  # noqa: F401

__all__ = ["forward_only", "set_attention_impl", "attention_impl", "set_ff_kernel",
           "ff_kernel_enabled", "set_halo_impl", "halo_impl", "set_sra_impl", "sra_impl",
           "fused_attention", "fused_attention_mod", "fused_attention_qkv",
           "fused_attention_layer", "fused_ff_layer", "fused_transformer_layer",
           "fused_attention_block", "halo_attention", "halo_attention_direct"]

_FORCED: Optional[str] = None
_FF_KERNEL_FORCED: Optional[bool] = None
_HALO_FORCED: Optional[str] = None
_SRA_FORCED: Optional[str] = None
# thread-local, as in the JAX package: one thread's eval forward never
# changes another thread's dispatch
_TLS = threading.local()

# Row-count gates copied from the JAX package (vision_transformers_tpu/ops/
# __init__.py:66-79) so that the port takes the reference's path: below
# _AUTO_MIN_BATCH rows the einsum path runs, a 'fused' default needs
# _AUTO_MIN_SEQ tokens, and under forward_only() the 'layer' default becomes
# 'layer1' from _FWDONLY_L1_MIN_BATCH rows up.  The values were chosen by
# measurements on another chip; an A/B on the H100 is to settle them
# (ROADMAP).
_AUTO_MIN_BATCH = 32
_AUTO_MIN_SEQ = 128
_FWDONLY_L1_MIN_BATCH = 128


@contextlib.contextmanager
def forward_only():
    """Marks a forward that is never differentiated (eval, predict): the
    'layer' default becomes 'layer1' at ≥ _FWDONLY_L1_MIN_BATCH rows."""
    prev = getattr(_TLS, "forward_only", False)
    _TLS.forward_only = True
    try:
        yield
    finally:
        _TLS.forward_only = prev


def set_attention_impl(impl: Optional[str]) -> None:
    """Force the attention implementation: "einsum" | "fused" | "layer" |
    "layer1" | "block"; None = the row / token-count dispatch of
    :func:`attention_impl`."""
    global _FORCED
    if impl not in (None, "einsum", "fused", "layer", "layer1", "block"):
        raise ValueError(f"unknown attention impl {impl!r}")
    _FORCED = impl


def attention_impl(batch: Optional[int] = None, seq: Optional[int] = None,
                   default: str = "einsum") -> str:
    """Implementation for one attention call site: ``batch`` is the call's
    row count, ``seq`` its token count, ``default`` the site's default
    ('layer' for sequences of ≥ 128 tokens and 'fused' for the attention
    itself in models/vit.py, 'layer1' in models/swin.py)."""
    if _FORCED is not None:
        return _FORCED
    if default != "einsum" and batch is not None and batch < _AUTO_MIN_BATCH:
        return "einsum"
    if default == "fused" and seq is not None and seq < _AUTO_MIN_SEQ:
        return "einsum"
    if default == "layer" and getattr(_TLS, "forward_only", False) and \
            (batch is None or batch >= _FWDONLY_L1_MIN_BATCH):
        return "layer1"
    return default


def set_ff_kernel(enabled: Optional[bool]) -> None:
    """Force the FF kernel (:func:`fused_ff_layer`) on or off at the
    'layer' sites; None = :func:`ff_kernel_enabled`'s default."""
    global _FF_KERNEL_FORCED
    _FF_KERNEL_FORCED = enabled


def ff_kernel_enabled() -> bool:
    """Whether the 'layer' sites (ViT's and Swin's) run their FF residual
    branch through :func:`fused_ff_layer`: a :func:`set_ff_kernel` force,
    else ``VTX_FF_KERNEL`` (anything but 0 / false / off is on), else off —
    the JAX package's default (ops/__init__.py:251-268).  Whether it pays
    on the H100 is measured, not assumed (PERF.md)."""
    if _FF_KERNEL_FORCED is not None:
        return _FF_KERNEL_FORCED
    env = os.environ.get("VTX_FF_KERNEL")
    return env is not None and env not in ("0", "false", "off")


def set_halo_impl(impl: Optional[str]) -> None:
    """Force the Halo attention implementation: "layer" | "direct" |
    "gather" | "einsum"; None = the default of :func:`halo_impl`."""
    global _HALO_FORCED
    if impl not in (None, "layer", "direct", "gather", "einsum"):
        raise ValueError(f"unknown halo impl {impl!r}")
    _HALO_FORCED = impl


def halo_impl(window: int, halo: int) -> str:
    """Implementation for a Halo layer, the JAX ``halo_impl``
    (ops/__init__.py:194-227): a :func:`set_halo_impl` force, else "einsum"
    under ``set_attention_impl("einsum")`` (as the JAX package's global
    force), else "layer" where 2·halo ≤ window and "gather" where the halo is
    wider — on every device; a CPU tensor takes the op's plain version.  The
    layer and direct ops need 2·halo ≤ window (a token in at most 2 x 2
    neighbourhoods): a "layer" force on a wider halo becomes "gather", as in
    JAX, and a "direct" force on one raises NotImplementedError.  JAX's
    8 | window clause (aligned slices on the TPU) is not carried over: the
    CUDA kernels take any window (ROADMAP A10)."""
    wide = 2 * halo > window
    impl = _HALO_FORCED or ("einsum" if _FORCED == "einsum" else
                            "gather" if wide else "layer")
    if wide and impl == "layer":
        return "gather"
    if wide and impl == "direct":
        raise NotImplementedError(
            f"the direct halo attention needs 2·halo ≤ window; got window {window}, "
            f"halo {halo} (set_halo_impl('gather') runs the gathered kernel)")
    return impl


def set_sra_impl(impl: Optional[str]) -> None:
    """Force the reduced-kv attention implementation: "einsum" | "fused";
    None = the default of :func:`sra_impl`."""
    global _SRA_FORCED
    if impl not in (None, "einsum", "fused"):
        raise ValueError(f"unknown sra impl {impl!r}")
    _SRA_FORCED = impl


def sra_impl(n_kv: int) -> str:
    """Implementation for one reduced-kv attention call (PVT SRA, Twins GSA)
    with ``n_kv`` reduced key / value tokens: a :func:`set_sra_impl` force,
    else "einsum" — the JAX package's default, which
    ``set_attention_impl("einsum")`` (its global force) keeps too; on every
    device, and a CPU tensor takes the op's plain version.  The JAX
    package's n_kv < 8 gate works round a TPU compiler fault and is not
    carried over: the CUDA kernel takes any n_kv ≥ 1 (Twins' last stage
    reduces to one token).  Which arm is faster on the H100 is measured,
    not assumed (PERF.md); the default stays the reference's until that
    A/B settles it (ROADMAP B)."""
    if n_kv < 1:
        raise ValueError(f"reduced-kv attention over {n_kv} tokens")
    return _SRA_FORCED or "einsum"
