"""The FF residual branch B7 (vision_transformers_tpu_torch/ops/
fused_layer.py::fused_ff_layer) against the JAX package's Pallas kernel in
interpret mode.

- ``x + rs ⊙ (act(LN(x)·W₁ + b₁)·W₂ + b₂)`` with silu and tanh-gelu, with and
  without the [B] row scale and with and without b₁ / b₂ (the JAX kernel's
  has_b1 / has_b2 / has_rs): the forward within atol = rtol = 1e-5 and every
  gradient (dx, dln_scale, dln_bias, dW₁, db₁, dW₂, db₂, drs; ``jax.vjp``)
  within 1e-4·max(1, max|JAX|) — the same f32 math in another summation
  order.

The CUDA dispatch and the card-only checks are in
tests/test_torch_port_vit_entry.py, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_layer import fused_ff_layer as jax_fused_ff_layer
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.ops import fused_layer as fl

B, N, C, F = 3, 5, 16, 40
NAMES = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "row_scale")


def inputs(biases=True, rs=True, seed=0):
    """x, ln_scale, ln_bias, w1 [C, F], b1, w2 [F, C], b2, row_scale (None
    where absent) and the output grad, scaled as chip_smoke.layer_args."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(np.float32)

    a = [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(C, F, s=0.2),
         n(F, s=0.1) if biases else None, n(F, C, s=0.2), n(C, s=0.1) if biases else None,
         np.array([0.0, 1.25, 1.25], np.float32) if rs else None]
    return a, n(B, N, C)


@pytest.mark.parametrize("biases", [True, False], ids=["biases", "no-biases"])
@pytest.mark.parametrize("rs", [True, False], ids=["rs", "no-rs"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_matches_jax_forward_and_grads(act, rs, biases):
    a, do = inputs(biases, rs)
    present = [i for i, t in enumerate(a) if t is not None]

    def jax_fn(*args):
        full = list(a)
        for i, t in zip(present, args):
            full[i] = t
        return jax_fused_ff_layer(*full[:7], act, full[7], 1e-6, True)

    @jax.jit
    def jax_fwd_bwd(d, *args):
        out, vjp = jax.vjp(jax_fn, *args)
        return out, vjp(d)

    out_j, grads_j = jax_fwd_bwd(jnp.asarray(do), *(jnp.asarray(a[i]) for i in present))
    ts = [None if t is None else torch.from_numpy(t).requires_grad_() for t in a]
    out = ops.fused_ff_layer(*ts[:7], act, ts[7], 1e-6)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-5)
    for i, g in zip(present, grads_j):
        g = np.asarray(g)
        tol = 1e-4 * max(1.0, float(np.abs(g).max()))
        err = float(np.abs(ts[i].grad.numpy() - g).max())
        assert err <= tol, (NAMES[i], err, tol)


def test_weight_views_and_no_grad_path():
    """The model passes ``linear.weight.t()`` views; a call without grad
    runs the plain forward and matches the training forward."""
    a, do = inputs()
    t = [torch.from_numpy(v) for v in a]
    w1v, w2v = t[3].t().contiguous().t(), t[5].t().contiguous().t()
    with torch.no_grad():
        out = ops.fused_ff_layer(t[0], t[1], t[2], w1v, t[4], w2v, t[6], "gelu", t[7])
    out2, saved = fl.fused_ff_layer_fwd(*t[:7], "gelu", t[7])
    torch.testing.assert_close(out, out2, atol=0, rtol=0)
    assert saved.hid.shape == (B, N, F) and saved.mu.shape == (B, N)
    grads = fl.fused_ff_layer_bwd(saved, torch.from_numpy(do), need_drs=False)
    assert len(grads) == len(fl.FF_GRAD_NAMES) and grads[-1] is None
