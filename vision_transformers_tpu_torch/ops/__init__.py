"""Hand-written CUDA kernels and the attention dispatch.

Counterpart of ``vision_transformers_tpu/ops/__init__.py``.  Two kernels
are ported (float32), each beside its plain torch version, each forward and
backward inside a ``torch.autograd.Function``:

- ``layer``:  :func:`fused_attention_layer` (ops/fused_layer.py) — the
  pre-LN attention residual branch; the FF half stays plain torch.  ViT's
  training path (32+ rows).
- ``layer1``: :func:`fused_transformer_layer` (ops/fused_layer1.py) — the
  whole layer, both residual branches, with the additive attention bias
  (Swin's grouped [G, H, m, m] relative-position bias + shift mask) and
  both DropPath row scales.  Swin's default path in training, eval and
  serving; ViT's under :func:`forward_only` from 128 rows.

``einsum`` is the plain torch attention of the models.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from .fused_layer import fused_attention_layer  # noqa: F401
from .fused_layer1 import fused_transformer_layer  # noqa: F401

__all__ = ["forward_only", "set_attention_impl", "attention_impl",
           "fused_attention_layer", "fused_transformer_layer"]

_FORCED: Optional[str] = None
# thread-local, as in the JAX package: one thread's eval forward never
# changes another thread's dispatch
_TLS = threading.local()

# Row-count gates copied from the JAX package (vision_transformers_tpu/ops/
# __init__.py:66-79) so that the port takes the reference's path: below
# _AUTO_MIN_BATCH rows the einsum path runs, and under forward_only() the
# 'layer' default becomes 'layer1' from _FWDONLY_L1_MIN_BATCH rows up.  Both
# values were chosen by measurements on another chip; an A/B on the H100 is
# to settle them (ROADMAP).
_AUTO_MIN_BATCH = 32
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
    """Force the attention implementation: "einsum" | "layer" | "layer1";
    None = the row-count dispatch of :func:`attention_impl`."""
    global _FORCED
    if impl not in (None, "einsum", "layer", "layer1"):
        raise ValueError(f"unknown attention impl {impl!r}")
    _FORCED = impl


def attention_impl(batch: Optional[int] = None, default: str = "einsum") -> str:
    """Implementation for one attention call site: ``batch`` is the call's
    row count, ``default`` the site's default ('layer' for sequences of
    ≥ 128 tokens in models/vit.py, 'layer1' in models/swin.py)."""
    if _FORCED is not None:
        return _FORCED
    if default != "einsum" and batch is not None and batch < _AUTO_MIN_BATCH:
        return "einsum"
    if default == "layer" and getattr(_TLS, "forward_only", False) and \
            (batch is None or batch >= _FWDONLY_L1_MIN_BATCH):
        return "layer1"
    return default
