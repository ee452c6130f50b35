"""The port's fused attention layer (vision_transformers_tpu_torch/ops/
fused_layer.py) against the JAX package's ``fused_attention_layer`` — the
Pallas kernel in interpret mode — on the same numpy-seeded inputs, float32.

Tolerance atol = rtol = 5e-5, as tests/test_fused_layer1.py:70 holds the
Pallas kernel to its jnp composition: the same f32 math in another
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_layer import \
    fused_attention_layer as jax_fused_attention_layer
from vision_transformers_tpu_torch.ops import fused_layer
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=5e-5, rtol=5e-5)


def make_args(B, N, C, H, D, seed=7, extra=False, rs=False):
    """numpy inputs in the JAX kernel's argument order."""
    rng = np.random.default_rng(seed)
    HD = H * D
    f = np.float32
    args = [
        rng.normal(size=(B, N, C)).astype(f),
        (1.0 + 0.1 * rng.normal(size=C)).astype(f),
        (0.1 * rng.normal(size=C)).astype(f),
        (0.05 * rng.normal(size=(C, 3 * HD))).astype(f),
        (0.1 * rng.normal(size=3 * HD)).astype(f),
        (0.05 * rng.normal(size=(HD, C))).astype(f),
        (0.1 * rng.normal(size=C)).astype(f),
    ]
    ex = rng.normal(size=(H, N, N)).astype(f) if extra else None
    r = rng.choice([0.0, 1.25], size=B).astype(f) if rs else None
    return args, ex, r


def jax_out(args, H, extra, rs):
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = jax_fused_attention_layer(*map(jnp.asarray, args), H, opt(extra),
                                    opt(rs), interpret=True)
    return np.asarray(out)


def torch_out(args, H, extra, rs):
    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = fused_layer.fused_attention_layer(*map(torch.from_numpy, args), H,
                                            opt(extra), opt(rs))
    return out.numpy()


@pytest.mark.parametrize("B,N,C,H,D", [
    (4, 17, 64, 2, 32),
    (3, 37, 48, 2, 24),     # odd sequence and head width
    (2, 197, 384, 6, 64),   # ViT-S/16 at 224
])
def test_matches_jax_kernel(B, N, C, H, D):
    args, _, _ = make_args(B, N, C, H, D)
    np.testing.assert_allclose(torch_out(args, H, None, None),
                               jax_out(args, H, None, None), **TOL)


@pytest.mark.parametrize("extra,rs", [(True, False), (False, True), (True, True)])
def test_plain_version_extra_and_row_scale(extra, rs):
    """The plain version carries the additive [H, N, N] bias and the
    per-sample DropPath scale for later slices."""
    args, ex, r = make_args(3, 37, 48, 2, 24, seed=3, extra=extra, rs=rs)
    np.testing.assert_allclose(torch_out(args, 2, ex, r), jax_out(args, 2, ex, r),
                               **TOL)


def test_cpu_tensor_takes_plain_version():
    args, _, _ = make_args(2, 17, 32, 2, 16)
    before = fused_layer.LAUNCHES
    t = list(map(torch.from_numpy, args))
    out = fused_layer.fused_attention_layer(*t, 2)
    ref = fused_layer.fused_attention_layer_reference(*t, 2)
    assert fused_layer.LAUNCHES == before  # no kernel launched for a CPU tensor
    assert torch.equal(out, ref)


def test_transposed_weight_view_matches_contiguous():
    """The model passes ``linear.weight.t()`` (a strided view); the result is
    that of the contiguous [C, 3HD] matrix."""
    args, _, _ = make_args(2, 17, 32, 2, 16)
    t = list(map(torch.from_numpy, args))
    views = list(t)
    views[3] = t[3].t().contiguous().t()
    views[5] = t[5].t().contiguous().t()
    assert not views[3].is_contiguous()
    np.testing.assert_allclose(fused_layer.fused_attention_layer(*views, 2).numpy(),
                               fused_layer.fused_attention_layer(*t, 2).numpy(),
                               atol=1e-6, rtol=1e-6)
