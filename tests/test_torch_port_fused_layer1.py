"""The port's whole-layer op (vision_transformers_tpu_torch/ops/
fused_layer1.py) against the JAX package's ``fused_transformer_layer`` —
the Pallas kernel in interpret mode — on the same numpy-seeded inputs,
float32, F = 4C.

Tolerance atol = rtol = 5e-5, as tests/test_fused_layer1.py:70.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_layer1 import \
    fused_transformer_layer as jax_fused_transformer_layer
from vision_transformers_tpu_torch.ops import fused_layer1
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=5e-5, rtol=5e-5)


def make_args(B, N, C, H, D, F, seed=11, extra=False, rs=False):
    """numpy inputs in the JAX kernel's argument order (x … b2)."""
    rng = np.random.default_rng(seed)
    HD = H * D
    f = np.float32

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(f)

    args = [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, 3 * HD, s=0.05), n(3 * HD, s=0.1), n(HD, C, s=0.05), n(C, s=0.1),
            n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, F, s=0.05), n(F, s=0.1), n(F, C, s=0.05), n(C, s=0.1)]
    ex = n(H, N, N) if extra else None
    rs1 = rng.choice([0.0, 1.25], size=B).astype(f) if rs else None
    rs2 = rng.choice([0.0, 1.25], size=B).astype(f) if rs else None
    return args, ex, rs1, rs2


def jax_out(args, H, extra, rs1, rs2, act="silu"):
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = jax_fused_transformer_layer(*map(jnp.asarray, args), H, opt(extra),
                                      opt(rs1), opt(rs2), act, interpret=True)
    return np.asarray(out)


def torch_out(args, H, extra, rs1, rs2, act="silu"):
    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = fused_layer1.fused_transformer_layer(
        *map(torch.from_numpy, args), H, opt(extra), opt(rs1), opt(rs2), act)
    return out.numpy()


@pytest.mark.parametrize("B,N,C,H,D", [
    (4, 17, 64, 2, 32),
    (3, 37, 48, 2, 24),     # odd sequence and head width
    (2, 197, 384, 6, 64),   # ViT-S/16 at 224
])
def test_matches_jax_kernel(B, N, C, H, D):
    args, _, _, _ = make_args(B, N, C, H, D, 4 * C)
    np.testing.assert_allclose(torch_out(args, H, None, None, None),
                               jax_out(args, H, None, None, None), **TOL)


@pytest.mark.parametrize("extra,rs,act", [
    (True, False, "silu"), (False, True, "silu"), (True, True, "gelu")])
def test_plain_version_extra_row_scale_gelu(extra, rs, act):
    """The plain version carries the additive bias, both DropPath scales and
    the tanh-GELU activation for later slices."""
    args, ex, r1, r2 = make_args(3, 37, 48, 2, 24, 96, seed=5, extra=extra, rs=rs)
    np.testing.assert_allclose(torch_out(args, 2, ex, r1, r2, act),
                               jax_out(args, 2, ex, r1, r2, act), **TOL)


def test_cpu_tensor_takes_plain_version():
    args, _, _, _ = make_args(2, 17, 32, 2, 16, 64)
    t = list(map(torch.from_numpy, args))
    before = fused_layer1.LAUNCHES
    out = fused_layer1.fused_transformer_layer(*t, 2)
    assert fused_layer1.LAUNCHES == before  # no kernel launched for a CPU tensor
    assert torch.equal(out, fused_layer1.fused_transformer_layer_reference(*t, 2))
