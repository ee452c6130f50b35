"""The backward of the port's fused attention layer (the autograd Function
in vision_transformers_tpu_torch/ops/fused_layer.py; on the CPU its plain
forward with saves and its plain backward) against ``jax.grad`` of the JAX
package's ``fused_attention_layer`` — the Pallas kernels in interpret
mode — on the same numpy-seeded inputs, float32.

The loss is sum(out²) and every input gets its gradient, the LN
parameters, the biases and the DropPath row scale included, as
tests/test_fused_layer.py:63-110 checks the Pallas kernel.  Tolerance 1e-4
of each gradient's largest magnitude, as that test's ``_grad_check``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_layer import \
    fused_attention_layer as jax_fused_attention_layer
from vision_transformers_tpu_torch.ops import fused_layer

NAMES = ["dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout", "drs"]
SHAPES = [(4, 17, 64, 2, 32), (3, 37, 48, 2, 24), (2, 197, 384, 6, 64)]


def make_args(B, N, C, H, D, rs, seed=11):
    """numpy inputs in the JAX kernel's argument order, and a row scale of
    dropped and kept samples."""
    rng = np.random.default_rng(seed)
    HD = H * D
    f = np.float32
    args = [rng.normal(size=(B, N, C)).astype(f),
            (1.0 + 0.1 * rng.normal(size=C)).astype(f),
            (0.1 * rng.normal(size=C)).astype(f),
            (0.05 * rng.normal(size=(C, 3 * HD))).astype(f),
            (0.1 * rng.normal(size=3 * HD)).astype(f),
            (0.05 * rng.normal(size=(HD, C))).astype(f),
            (0.1 * rng.normal(size=C)).astype(f)]
    r = None
    if rs:
        r = np.where(np.arange(B) % 2 == 0, 0.0, 1.25).astype(f)
    return args, r


def jax_grads(args, r, H):
    inputs = [jnp.asarray(a) for a in args] + ([jnp.asarray(r)] if r is not None else [])

    def loss(*a):
        out = jax_fused_attention_layer(*a[:7], H, None, a[7] if r is not None else None,
                                        interpret=True)
        return jnp.sum(out ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(inputs))))(*inputs)]


def port_grads(args, r, H, fn=fused_layer.fused_attention_layer):
    inputs = [torch.from_numpy(a).requires_grad_() for a in args]
    rs = torch.from_numpy(r).requires_grad_() if r is not None else None
    out = fn(*inputs, H, row_scale=rs)
    (out ** 2).sum().backward()
    return [t.grad.numpy() for t in inputs] + ([rs.grad.numpy()] if rs is not None else [])


def assert_grads_close(ours, theirs, tol=1e-4):
    assert len(ours) == len(theirs)
    for name, a, b in zip(NAMES, ours, theirs):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("rs", [False, True], ids=["no-rs", "rs"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grads_match_jax_kernel(shape, rs):
    B, N, C, H, D = shape
    args, r = make_args(B, N, C, H, D, rs)
    before = fused_layer.BWD_LAUNCHES, fused_layer.LAUNCHES
    assert_grads_close(port_grads(args, r, H), jax_grads(args, r, H))
    # a CPU tensor takes the plain versions: no kernel launch counted
    assert (fused_layer.BWD_LAUNCHES, fused_layer.LAUNCHES) == before


@pytest.mark.parametrize("rs", [False, True], ids=["no-rs", "rs"])
def test_plain_backward_matches_torch_autograd(rs):
    """The plain backward (the kernel's steps 1-6 spelled out on the saved
    residuals) against torch autograd of the plain forward."""
    args, r = make_args(3, 37, 48, 2, 24, rs, seed=4)
    assert_grads_close(port_grads(args, r, 2),
                       port_grads(args, r, 2, fused_layer.fused_attention_layer_reference),
                       tol=1e-5)


def test_weight_views_get_grads_in_their_layout():
    """The model passes ``linear.weight.t()``; the gradients reach the
    [out, in] parameters through autograd, equal to the contiguous case."""
    args, _ = make_args(2, 17, 32, 2, 16, False)
    t = [torch.from_numpy(a) for a in args]
    w_qkv = t[3].t().contiguous().requires_grad_()   # [3HD, C] parameter
    w_out = t[5].t().contiguous().requires_grad_()   # [C, HD] parameter
    out = fused_layer.fused_attention_layer(t[0], t[1], t[2], w_qkv.t(), t[4],
                                            w_out.t(), t[6], 2)
    (out ** 2).sum().backward()
    ref = port_grads(args, None, 2)
    np.testing.assert_allclose(w_qkv.grad.numpy(), ref[3].T, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(w_out.grad.numpy(), ref[5].T, rtol=1e-6, atol=1e-6)


def test_no_grad_call_saves_nothing():
    """Under torch.no_grad() (the serving path) no autograd Function runs."""
    args, _ = make_args(2, 17, 32, 2, 16, False)
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    with torch.no_grad():
        out = fused_layer.fused_attention_layer(*t, 2)
    assert out.grad_fn is None
    ref = fused_layer.fused_attention_layer_reference(*(a.detach() for a in t), 2)
    assert torch.equal(out, ref)
