"""The port's two Halo ops with their backwards (the autograd Functions in
vision_transformers_tpu_torch/ops/fused_halo_layer.py and ops/fused_halo.py;
on the CPU their plain forwards with saves and plain backwards) against the
JAX package's ``fused_halo_layer`` and ``halo_attention_direct`` — the
Pallas kernels in interpret mode, forward and ``jax.grad`` — on the same
numpy-seeded inputs, float32.

Covered: maps of 8x8 with window 4 and halo 1 and 2 (2·halo = window: the
neighbourhood spans three windows a side), a map equal to one window (4x4,
halo 2: 20 of the 64 neighbourhood positions inside the map) and a
non-square map (8x12), each DropPath row scale absent or set, the three
biases of the layer absent or set.  The loss is sum(out · w) with a seeded
w, and every input gets its gradient: x, both LayerNorms, the four weights
and their biases, the relative-position bias and both row scales (the
layer); q, kv and the bias (the direct op).  Tolerance: forward atol 1e-5;
gradients rtol 1e-3 / atol 1e-4 per tensor, as
tests/test_torch_port_fused_layer1_bwd.py holds the whole transformer
layer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_halo import \
    halo_attention_direct as jax_halo_attention_direct
from vision_transformers_tpu.ops.fused_halo_layer import \
    fused_halo_layer as jax_fused_halo_layer
from vision_transformers_tpu_torch.ops import fused_halo, fused_halo_layer
from torch_port_threads import one_torch_thread  # noqa: F401

NAMES = fused_halo_layer.GRAD_NAMES


def layer_inputs(B, H, W, C, nh, D, window, halo, rs, biases=True, seed=3):
    """(args of the 13 tensor inputs, rs_attn, rs_ff, the loss weights)."""
    rng = np.random.default_rng(seed)
    HD, F, k = nh * D, 2 * C, window + 2 * halo
    f = np.float32

    def n(*shape, s=1.0, mean=0.0):
        return (mean + s * rng.normal(size=shape)).astype(f)

    args = [n(B, H, W, C), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, 3 * HD, s=0.2), n(HD, C, s=0.2), n(C, s=0.1) if biases else None,
            n(C, s=0.1, mean=1.0), n(C, s=0.1),
            n(C, F, s=0.2), n(F, s=0.1) if biases else None, n(F, C, s=0.2),
            n(C, s=0.1) if biases else None, n(nh, window * window, k * k, s=0.5)]
    keep_a, keep_f = np.arange(B) % 2 == 0, np.arange(B) % 3 == 1
    rs_attn = np.where(keep_a, 0.0, 1.25).astype(f) if rs else None
    rs_ff = np.where(keep_f, 0.0, 1.25).astype(f) if rs else None
    return args, rs_attn, rs_ff, n(B, H, W, C)


def jax_layer(args, rs_attn, rs_ff, w, nh, window, halo):
    present = [i for i, a in enumerate(args) if a is not None]
    opt = [a for a in (rs_attn, rs_ff) if a is not None]
    inputs = [jnp.asarray(args[i]) for i in present] + [jnp.asarray(a) for a in opt]

    def f(*a):
        full = [None] * 13
        for i, v in zip(present, a):
            full[i] = v
        it = iter(a[len(present):])
        r1, r2 = (next(it) if t is not None else None for t in (rs_attn, rs_ff))
        return jax_fused_halo_layer(*full, nh, r1, r2, window=window, halo=halo,
                                    interpret=True)

    out, grads = jax_value_and_grads(f, inputs, w)
    grads = iter(grads)
    full = [next(grads) if a is not None else None for a in args]
    return out, full + [next(grads) if t is not None else None for t in (rs_attn, rs_ff)]


def jax_value_and_grads(f, inputs, w):
    """(f(*inputs), the gradients of sum(f · w)) as numpy, from one jitted
    program (one XLA program, not op-by-op dispatch of the interpreted
    kernels)."""
    def loss(*a):
        out = f(*a)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs))), has_aux=True))(*inputs)
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_layer(args, rs_attn, rs_ff, w, nh, window, halo,
               fn=fused_halo_layer.fused_halo_layer):
    opt = lambda a: None if a is None else torch.from_numpy(a).requires_grad_()  # noqa: E731
    inputs = [opt(a) for a in args]
    r1, r2 = opt(rs_attn), opt(rs_ff)
    out = fn(*inputs, nh, r1, r2, window=window, halo=halo)
    (out * torch.from_numpy(w)).sum().backward()
    grads = [None if t is None else t.grad.numpy() for t in inputs + [r1, r2]]
    return out.detach().numpy(), grads


def assert_grads_close(names, ours, theirs, rtol=1e-3, atol=1e-4):
    assert len(ours) == len(theirs) == len(names)
    for name, a, b in zip(names, ours, theirs):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


CASES = [  # (B, H, W, C, heads, D, window, halo, row scales, biases)
    (2, 8, 8, 16, 2, 8, 4, 1, False, True),
    (3, 8, 8, 16, 2, 8, 4, 2, True, True),     # 2·halo = window
    (3, 4, 4, 16, 2, 8, 4, 2, True, False),    # the map is one window
    (2, 8, 12, 24, 3, 8, 4, 1, True, True),    # non-square
]


@pytest.mark.parametrize("B,H,W,C,nh,D,window,halo,rs,biases", CASES, ids=str)
def test_layer_matches_jax_kernel(B, H, W, C, nh, D, window, halo, rs, biases):
    args, r1, r2, w = layer_inputs(B, H, W, C, nh, D, window, halo, rs, biases)
    out_j, g_j = jax_layer(args, r1, r2, w, nh, window, halo)
    before = fused_halo_layer.LAUNCHES, fused_halo_layer.BWD_LAUNCHES
    out_p, g_p = port_layer(args, r1, r2, w, nh, window, halo)
    # a CPU tensor takes the plain versions: no kernel launch counted
    assert (fused_halo_layer.LAUNCHES, fused_halo_layer.BWD_LAUNCHES) == before
    np.testing.assert_allclose(out_p, out_j, atol=1e-5, rtol=0)
    assert_grads_close(NAMES, g_p, g_j)
    assert np.abs(g_p[12]).max() > 0  # the bias gets a gradient


@pytest.mark.parametrize("rs", [False, True])
def test_layer_plain_backward_matches_torch_autograd(rs):
    """The plain backward (the kernels' steps spelled out on the saves)
    against torch autograd of the plain forward, so that the card's
    comparison holds the kernels to a version held to the JAX package."""
    args, r1, r2, w = layer_inputs(3, 8, 8, 16, 2, 8, 4, 2, rs, seed=8)
    out_f, g_f = port_layer(args, r1, r2, w, 2, 4, 2)
    out_r, g_r = port_layer(args, r1, r2, w, 2, 4, 2,
                            fused_halo_layer.fused_halo_layer_reference)
    np.testing.assert_allclose(out_f, out_r, atol=1e-6, rtol=0)
    assert_grads_close(NAMES, g_f, g_r, rtol=0, atol=1e-5)


def test_layer_saves_only_with_grad():
    """Under torch.no_grad() nothing is saved and the plain forward runs;
    with grads, the training forward's output equals it."""
    args, r1, r2, _ = layer_inputs(2, 8, 8, 16, 2, 8, 4, 1, True)
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    rs = [torch.from_numpy(a) for a in (r1, r2)]
    kw = dict(window=4, halo=1)
    with torch.no_grad():
        out = fused_halo_layer.fused_halo_layer(*t, 2, *rs, **kw)
    assert out.grad_fn is None
    ref = fused_halo_layer.fused_halo_layer_reference(*(a.detach() for a in t), 2, *rs,
                                                      **kw)
    assert torch.equal(out, ref)
    out2 = fused_halo_layer.fused_halo_layer(*t, 2, *rs, **kw)
    assert out2.grad_fn is not None
    torch.testing.assert_close(out2.detach(), ref, atol=1e-6, rtol=0)


def direct_inputs(B, H, W, nh, D, window, halo, seed=4):
    rng = np.random.default_rng(seed)
    C, k = nh * D, window + 2 * halo
    f = np.float32
    return (rng.normal(size=(B, H, W, C)).astype(f),
            rng.normal(size=(B, H, W, 2 * C)).astype(f),
            (0.5 * rng.normal(size=(nh, window * window, k * k))).astype(f),
            rng.normal(size=(B, H, W, C)).astype(f))


@pytest.mark.parametrize("B,H,W,nh,D,window,halo", [
    (2, 8, 8, 2, 8, 4, 1), (2, 8, 8, 2, 8, 4, 2), (3, 4, 4, 2, 8, 4, 2),
    (2, 8, 12, 3, 8, 4, 1)], ids=str)
def test_direct_matches_jax_kernel(B, H, W, nh, D, window, halo):
    q, kv, bias, w = direct_inputs(B, H, W, nh, D, window, halo)

    def f(q_, kv_, b_):
        return jax_halo_attention_direct(q_, kv_, b_, window, halo, nh, None, True)

    out_j, g_j = jax_value_and_grads(f, [jnp.asarray(a) for a in (q, kv, bias)], w)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, kv, bias)]
    before = fused_halo.LAUNCHES, fused_halo.BWD_LAUNCHES
    out = fused_halo.halo_attention_direct(*t, window, halo, nh)
    (out * torch.from_numpy(w)).sum().backward()
    assert (fused_halo.LAUNCHES, fused_halo.BWD_LAUNCHES) == before
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=1e-5, rtol=0)
    assert_grads_close(("dq", "dkv", "dbias"), [a.grad.numpy() for a in t], g_j)


def test_direct_plain_backward_matches_torch_autograd():
    q, kv, bias, w = direct_inputs(2, 8, 12, 3, 8, 4, 2, seed=9)

    def run(fn):
        t = [torch.from_numpy(a).requires_grad_() for a in (q, kv, bias)]
        out = fn(*t, 4, 2, 3)
        (out * torch.from_numpy(w)).sum().backward()
        return out.detach(), [a.grad for a in t]

    out_f, g_f = run(fused_halo.halo_attention_direct)
    out_r, g_r = run(fused_halo.halo_attention_direct_reference)
    torch.testing.assert_close(out_f, out_r, atol=1e-6, rtol=0)
    for a, b in zip(g_f, g_r):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("H,W,window,halo", [(8, 8, 4, 1), (8, 12, 4, 2), (4, 4, 4, 2),
                                             (16, 16, 8, 2)])
def test_fold_is_the_adjoint_of_the_neighbourhoods(H, W, window, halo):
    """<neighborhoods(x), y> = <x, fold(y)>: the fold sums each token's
    positions over every neighbourhood and drops the zero border."""
    rng = np.random.default_rng(0)
    k = window + 2 * halo
    x = torch.from_numpy(rng.normal(size=(2, H, W, 3)))
    y = torch.from_numpy(rng.normal(size=(2, (H // window) * (W // window), k * k, 3)))
    lhs = (fused_halo.neighborhoods(x, window, halo) * y).sum()
    rhs = (x * fused_halo.fold_neighborhoods(y, window, halo, H, W)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)
