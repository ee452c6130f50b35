"""The port's reduced-kv attention op (vision_transformers_tpu_torch/ops/
fused_attention.py: its autograd Function, on the CPU the plain forward with
saves and the plain backward) against the JAX package's ``fused_attention``
— the Pallas kernels in interpret mode, forward and ``jax.grad`` — and the
port's attention layer with Twins' 2-D block mask against the JAX
``fused_attention_layer``, on the same numpy-seeded inputs, float32.

The reduced-kv shapes have M ≠ N, N ∈ {1, 4, 9} (Twins' last stage reduces
to one token), head widths 8 and 32 and G > 1 heads; one case adds an
additive bias in each of the three forms the op takes ([M, N], [1, M, N],
[G, M, N]) and checks its gradient too.  q, k and v go in as the strided
head views the models pass.  The layer takes the [m, m] pair mask (−1e9
across the two windows of a packed pair) and a DropPath row scale; every
gradient is compared, the mask's among them.  The loss is sum(out · w)
with a seeded w.  Tolerances: forward atol = rtol = 1e-5; gradients rtol
1e-3 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_attention import \
    fused_attention as jax_fused_attention
from vision_transformers_tpu.ops.fused_layer import \
    fused_attention_layer as jax_fused_attention_layer
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.ops import fused_layer
from vision_transformers_tpu_torch.ops import fused_attention_mod as fa
from torch_port_threads import one_torch_thread  # noqa: F401

# (B, G, M, N, D)
SHAPES = [(2, 3, 13, 1, 8), (2, 2, 16, 4, 32), (3, 4, 10, 9, 8), (1, 2, 49, 4, 32)]


def sra_inputs(B, G, M, N, D, extra_shape=None, seed=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.normal(size=(B, M, G * D)).astype(f)
    kv = rng.normal(size=(B, N, 2 * G * D)).astype(f)
    w = rng.normal(size=(B, G, M, D)).astype(f)
    extra = None if extra_shape is None else rng.normal(size=extra_shape).astype(f)
    return q, kv, w, extra


def heads(t, G):
    """[B, rows, G·D] → the [B, G, rows, D] view (a torch or a JAX array)."""
    B, rows, C = t.shape
    t = t.reshape(B, rows, G, C // G)
    return t.permute(0, 2, 1, 3) if isinstance(t, torch.Tensor) else t.transpose(0, 2, 1, 3)


def jax_sra(q, kv, w, extra, G):
    C = q.shape[-1]
    inputs = [jnp.asarray(a) for a in (q, kv)] + \
        ([jnp.asarray(extra)] if extra is not None else [])

    def f(q, kv, *e):
        qh = heads(q, G)
        kh, vh = heads(kv[..., :C], G), heads(kv[..., C:], G)
        return jax_fused_attention(qh, kh, vh, e[0] if e else None, None, True)

    return jax_value_and_grads(f, inputs, w)


def jax_value_and_grads(f, inputs, w):
    """(f(*inputs), the gradients of sum(f · w)) as numpy, from one jitted
    program (not op-by-op dispatch of the interpreted kernel)."""
    def loss(*a):
        out = f(*a)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs))), has_aux=True))(*inputs)
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_sra(q, kv, w, extra, G, fn=ops.fused_attention):
    C = q.shape[-1]
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, kv)] + \
        ([torch.from_numpy(extra).requires_grad_()] if extra is not None else [])
    qt, kvt = inputs[:2]
    out = fn(heads(qt, G), heads(kvt[..., :C], G), heads(kvt[..., C:], G),
             inputs[2] if extra is not None else None)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in inputs]


def assert_close(ours, theirs, names):
    (out, grads), (out_j, grads_j) = ours, theirs
    np.testing.assert_allclose(out, out_j, atol=1e-5, rtol=1e-5)
    assert len(grads) == len(grads_j)
    for name, g, g_j in zip(names, grads, grads_j):
        assert g.shape == g_j.shape, name
        np.testing.assert_allclose(g, g_j, rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fused_attention_matches_jax(shape):
    B, G, M, N, D = shape
    q, kv, w, _ = sra_inputs(*shape)
    before = fa.LAUNCHES, fa.BWD_LAUNCHES
    assert_close(port_sra(q, kv, w, None, G), jax_sra(q, kv, w, None, G), ("dq", "dkv"))
    # a CPU tensor takes the plain versions: no kernel launch counted
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before


@pytest.mark.parametrize("form", ["2d", "shared", "grouped"])
def test_fused_attention_bias_and_its_gradient_match_jax(form):
    B, G, M, N, D = 2, 3, 11, 4, 8
    extra_shape = {"2d": (M, N), "shared": (1, M, N), "grouped": (G, M, N)}[form]
    q, kv, w, extra = sra_inputs(B, G, M, N, D, extra_shape, seed=6)
    assert_close(port_sra(q, kv, w, extra, G), jax_sra(q, kv, w, extra, G),
                 ("dq", "dkv", "dextra"))


def test_plain_version_and_no_grad_call_agree():
    """The no-grad call (serving) is the plain forward; the plain forward
    with saves gives the same output and lse = logsumexp of the scores."""
    q, kv, _, _ = sra_inputs(2, 2, 16, 4, 32)
    C = q.shape[-1]
    qh = heads(torch.from_numpy(q), 2)
    kh, vh = heads(torch.from_numpy(kv[..., :C]), 2), heads(torch.from_numpy(kv[..., C:]), 2)
    with torch.no_grad():
        out = ops.fused_attention(qh, kh, vh)
    ref, saved = fa.fused_attention_fwd(qh, kh, vh)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    s = qh @ kh.transpose(-1, -2) / np.sqrt(32)
    torch.testing.assert_close(saved.lse, torch.logsumexp(s, -1), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the attention layer with Twins' pair mask
# ---------------------------------------------------------------------------

LAYER_NAMES = ["dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout",
               "dmask", "drs"]


def pair_mask(w2):
    m = 2 * w2
    blk = np.full((m, m), -1e9, np.float32)
    blk[:w2, :w2] = blk[w2:, w2:] = 0.0
    return blk


def layer_inputs(B, w2, C, H, D, seed=9):
    rng = np.random.default_rng(seed)
    HD, f = H * D, np.float32
    args = [rng.normal(size=(B, 2 * w2, C)).astype(f),
            (1.0 + 0.1 * rng.normal(size=C)).astype(f), (0.1 * rng.normal(size=C)).astype(f),
            (0.05 * rng.normal(size=(C, 3 * HD))).astype(f),
            (0.1 * rng.normal(size=3 * HD)).astype(f),
            (0.05 * rng.normal(size=(HD, C))).astype(f), (0.1 * rng.normal(size=C)).astype(f)]
    rs = np.where(np.arange(B) % 3 == 0, 0.0, 1.25).astype(f)
    return args, pair_mask(w2), rs, rng.normal(size=(B, 2 * w2, C)).astype(f)


@pytest.mark.parametrize("shape", [(6, 4, 16, 2, 8), (4, 9, 64, 2, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_layer_with_pair_mask_matches_jax(shape):
    B, w2, C, H, D = shape
    args, mask, rs, w = layer_inputs(*shape)
    scale = 1.0 / np.sqrt(D)
    inputs = [jnp.asarray(a) for a in (*args, mask, rs)]

    def f(*a):
        return jax_fused_attention_layer(*a[:7], H, a[7], a[8], scale, 1e-6, interpret=True)

    out_j, grads_j = jax_value_and_grads(f, inputs, w)
    t = [torch.from_numpy(a).requires_grad_() for a in (*args, mask, rs)]
    before = fused_layer.BIAS_LAUNCHES, fused_layer.BIAS_BWD_LAUNCHES
    out = ops.fused_attention_layer(*t[:7], H, extra=t[7], row_scale=t[8], scale=scale)
    (out * torch.from_numpy(w)).sum().backward()
    assert (fused_layer.BIAS_LAUNCHES, fused_layer.BIAS_BWD_LAUNCHES) == before
    assert_close((out.detach().numpy(), [x.grad.numpy() for x in t]), (out_j, grads_j),
                 LAYER_NAMES)


def test_layer_mask_without_grad_gets_none():
    """Twins' mask requires no gradient: the backward returns None for it
    and still the other gradients."""
    args, mask, rs, w = layer_inputs(3, 4, 16, 2, 8)
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    out = ops.fused_attention_layer(*t, 2, extra=torch.from_numpy(mask),
                                    row_scale=torch.from_numpy(rs))
    (out * torch.from_numpy(w)).sum().backward()
    assert all(x.grad is not None for x in t)
