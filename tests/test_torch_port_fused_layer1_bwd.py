"""The port's whole-layer op with its backward (the autograd Function in
vision_transformers_tpu_torch/ops/fused_layer1.py; on the CPU its plain
forward with saves and its plain backward) against the JAX package's
``fused_transformer_layer`` — the Pallas kernels in interpret mode, forward
and ``jax.grad`` — on the same numpy-seeded inputs, float32.

Covered: the additive bias absent, shared [H, N, N] and grouped
[G, H, N, N] with Swin's −1e9 off-diagonal blocks of a packed window pair;
each DropPath row scale absent or set; N = 2·m with m = 4 (a packed pair)
and N = 9 (odd); D = 8 and D = 16.  The loss is sum(out · w) with a seeded
w, and every input gets its gradient: x, both LayerNorms, the four weights
and their biases, the bias and both row scales.  Tolerance: forward atol
1e-5; gradients rtol 1e-3 / atol 1e-4 per tensor, as
tests/test_fused_layer1.py:195-203 holds the Pallas kernel's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_layer1 import \
    fused_transformer_layer as jax_fused_transformer_layer
from vision_transformers_tpu_torch.ops import fused_layer1

NAMES = ["dx", "dln1_scale", "dln1_bias", "dwqkv", "dbqkv", "dwout", "dbout",
         "dln2_scale", "dln2_bias", "dw1", "db1", "dw2", "db2", "dextra",
         "drs_attn", "drs_ff"]


def packed_bias(rng, G, H, m):
    """[G, H, 2m, 2m] bias of packed window pairs: a per-head table on each
    diagonal block, −1e9 off it, and a 0 / −1e9 shift mask per group."""
    f = np.float32
    slab = np.full((H, 2 * m, 2 * m), -1e9, f)
    table = rng.normal(size=(H, m, m)).astype(f)
    slab[:, :m, :m] = table
    slab[:, m:, m:] = table
    mask = np.where(rng.random((G, 1, 2 * m, 2 * m)) < 0.3, -1e9, 0.0).astype(f)
    idx = np.arange(2 * m)
    mask[:, :, idx, idx] = 0.0  # every query keeps at least itself
    return slab[None] + mask


def make_inputs(B, N, C, H, D, extra, rs, seed=3):
    rng = np.random.default_rng(seed)
    HD, F = H * D, 2 * C
    f = np.float32

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(f)

    args = [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, 3 * HD, s=0.2), n(3 * HD, s=0.1), n(HD, C, s=0.2), n(C, s=0.1),
            n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, F, s=0.2), n(F, s=0.1), n(F, C, s=0.2), n(C, s=0.1)]
    ex = None
    if extra == "shared":
        ex = n(H, N, N)
    elif extra == "grouped":
        ex = packed_bias(rng, 2, H, N // 2)
    drop_attn, drop_ff = np.arange(B) % 2 == 0, np.arange(B) % 3 == 1
    rs_attn = np.where(drop_attn, 0.0, 1.25).astype(f) if rs in ("attn", "both") else None
    rs_ff = np.where(drop_ff, 0.0, 1.25).astype(f) if rs in ("ff", "both") else None
    w = n(B, N, C)  # the loss's weights
    return args, ex, rs_attn, rs_ff, w


def jax_run(args, ex, rs_attn, rs_ff, w, H):
    opt = [a for a in (ex, rs_attn, rs_ff) if a is not None]
    inputs = [jnp.asarray(a) for a in args + opt]

    def unpack(a):
        it = iter(a[13:])
        return [next(it) if t is not None else None for t in (ex, rs_attn, rs_ff)]

    def f(*a):
        e, r1, r2 = unpack(a)
        return jax_fused_transformer_layer(*a[:13], H, e, r1, r2, interpret=True)

    out = np.asarray(f(*inputs))
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(w)),
                     argnums=tuple(range(len(inputs))))(*inputs)
    grads = [np.asarray(g) for g in grads]
    return out, grads[:13] + unpack(grads)


def port_run(args, ex, rs_attn, rs_ff, w, H, fn=fused_layer1.fused_transformer_layer):
    opt = lambda a: None if a is None else torch.from_numpy(a).requires_grad_()  # noqa: E731
    inputs = [torch.from_numpy(a).requires_grad_() for a in args]
    e, r1, r2 = opt(ex), opt(rs_attn), opt(rs_ff)
    out = fn(*inputs, H, e, r1, r2)
    (out * torch.from_numpy(w)).sum().backward()
    grads = [t.grad.numpy() for t in inputs] + \
        [None if t is None else t.grad.numpy() for t in (e, r1, r2)]
    return out.detach().numpy(), grads


def assert_grads_close(ours, theirs, rtol=1e-3, atol=1e-4):
    assert len(ours) == len(theirs) == len(NAMES)
    for name, a, b in zip(NAMES, ours, theirs):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


CASES = [  # (B, N, C, H, D, extra, rs)
    (4, 8, 16, 2, 8, None, None),
    (4, 8, 16, 2, 8, "grouped", "both"),    # a packed pair of 2x2 windows
    (4, 8, 32, 2, 16, "grouped", "attn"),
    (3, 9, 16, 2, 8, "shared", "ff"),       # odd N
    (3, 9, 32, 2, 16, None, "both"),
    (2, 8, 16, 2, 8, "shared", None),
]


@pytest.mark.parametrize("B,N,C,H,D,extra,rs", CASES,
                         ids=lambda v: str(v))
def test_matches_jax_kernel(B, N, C, H, D, extra, rs):
    args, ex, r1, r2, w = make_inputs(B, N, C, H, D, extra, rs)
    out_j, g_j = jax_run(args, ex, r1, r2, w, H)
    before = fused_layer1.LAUNCHES, fused_layer1.BWD_LAUNCHES
    out_p, g_p = port_run(args, ex, r1, r2, w, H)
    # a CPU tensor takes the plain versions: no kernel launch counted
    assert (fused_layer1.LAUNCHES, fused_layer1.BWD_LAUNCHES) == before
    np.testing.assert_allclose(out_p, out_j, atol=1e-5, rtol=0)
    assert_grads_close(g_p, g_j)


@pytest.mark.parametrize("extra,rs", [(None, None), ("grouped", "both"),
                                      ("shared", "attn")])
def test_plain_backward_matches_torch_autograd(extra, rs):
    """The plain backward (the kernel's steps spelled out on the saves)
    against torch autograd of the plain forward, so that the card's
    comparison holds the kernel to a version held to the JAX package."""
    args, ex, r1, r2, w = make_inputs(4, 8, 16, 2, 8, extra, rs, seed=8)
    out_f, g_f = port_run(args, ex, r1, r2, w, 2)
    out_r, g_r = port_run(args, ex, r1, r2, w, 2,
                          fused_layer1.fused_transformer_layer_reference)
    np.testing.assert_allclose(out_f, out_r, atol=1e-6, rtol=0)
    assert_grads_close(g_f, g_r, rtol=0, atol=1e-5)


def test_grouped_bias_rows_take_their_group():
    """Row b of a grouped bias takes group b // (B/G): the op equals the
    plain version, and swapping the two groups' biases changes the output."""
    args, ex, _, _, _ = make_inputs(4, 8, 16, 2, 8, "grouped", None)
    t = [torch.from_numpy(a) for a in args]
    ex = torch.from_numpy(ex)
    out = fused_layer1.fused_transformer_layer(*t, 2, ex)
    swapped = fused_layer1.fused_transformer_layer(*t, 2, ex.flip(0))
    ref = fused_layer1.fused_transformer_layer_reference(*t, 2, ex)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    assert not torch.allclose(out, swapped)  # the groups differ


def test_saves_only_with_grad():
    """Under torch.no_grad() no autograd Function runs and nothing is saved;
    with grads, the training forward's output equals the plain one."""
    args, ex, r1, r2, _ = make_inputs(4, 8, 16, 2, 8, "grouped", "both")
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    extras = [torch.from_numpy(a) for a in (ex, r1, r2)]
    with torch.no_grad():
        out = fused_layer1.fused_transformer_layer(*t, 2, *extras)
    assert out.grad_fn is None
    ref = fused_layer1.fused_transformer_layer_reference(
        *(a.detach() for a in t), 2, *extras)
    assert torch.equal(out, ref)
    out2 = fused_layer1.fused_transformer_layer(*t, 2, *extras)
    assert out2.grad_fn is not None
    torch.testing.assert_close(out2.detach(), ref, atol=1e-6, rtol=0)


def test_weight_views_get_grads_in_their_layout():
    """The model passes ``linear.weight.t()``; the gradients reach the
    [out, in] parameters, equal to the contiguous case."""
    args, ex, r1, r2, w = make_inputs(4, 8, 16, 2, 8, "grouped", "both")
    t = [torch.from_numpy(a) for a in args]
    params = {i: t[i].t().contiguous().requires_grad_() for i in (3, 5, 9, 11)}
    inputs = [params[i].t() if i in params else t[i] for i in range(13)]
    out = fused_layer1.fused_transformer_layer(
        *inputs, 2, torch.from_numpy(ex), torch.from_numpy(r1), torch.from_numpy(r2))
    (out * torch.from_numpy(w)).sum().backward()
    _, ref = port_run(args, ex, r1, r2, w, 2)
    for i, k in zip((3, 5, 9, 11), (3, 5, 9, 11)):
        np.testing.assert_allclose(params[i].grad.numpy(), ref[k].T, rtol=1e-6, atol=1e-6)
