"""The bf16 forms of the attention layer B1 (forward and backward) and the
whole layer B2 (forward) against the JAX package at dtype bfloat16.

The JAX side runs the Pallas kernels in interpret mode
(``fused_attention_layer`` / ``fused_transformer_layer`` with
``interpret=True``) on bfloat16 activations, weights and biases with f32
LayerNorm parameters and row scales, as the JAX model calls them, and its
f32 values through the JAX package's pure-jnp reference of the same math
(``_attn_layer_ref``, jitted; B2's FF half after it in jnp); the port side
runs its plain versions on the CPU (the CUDA kernels' rounding points).
Both take the same numpy-seeded inputs.

The limit is JAX's own bf16 error, computed here from the same inputs: for
each compared tensor, max|port bf16 − JAX bf16| ≤ 3 · max|JAX bf16 − JAX
f32|, and for each gradient the relative Frobenius error ‖port − JAX bf16‖
/ ‖JAX bf16‖ ≤ 3 · ‖JAX bf16 − JAX f32‖ / ‖JAX f32‖.  The row-scale cases
take 1/0.9, which bf16 rounds to 1.109375: the port's kept samples must
also scale as JAX's do, to within one bf16 ulp of the branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_layer import _attn_layer_ref
from vision_transformers_tpu.ops.fused_layer import \
    fused_attention_layer as jax_fused_attention_layer
from vision_transformers_tpu.ops.fused_layer1 import \
    fused_transformer_layer as jax_fused_transformer_layer
from vision_transformers_tpu_torch.ops import fused_layer, fused_layer1
from torch_port_threads import one_torch_thread  # noqa: F401

GAP_FACTOR = 3.0
NAMES = ["dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout", "drs"]
SHAPES = [(4, 17, 64, 2, 32), (4, 33, 64, 2, 32)]
KEEP = 0.9


def make_args(B, N, C, H, D, F=None, seed=17):
    """numpy f32 inputs in the JAX kernels' order (B1's 7, B2's 13 with F)."""
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
    if F:
        args += [(1.0 + 0.1 * rng.normal(size=C)).astype(f),
                 (0.1 * rng.normal(size=C)).astype(f),
                 (0.05 * rng.normal(size=(C, F))).astype(f),
                 (0.1 * rng.normal(size=F)).astype(f),
                 (0.05 * rng.normal(size=(F, C))).astype(f),
                 (0.1 * rng.normal(size=C)).astype(f)]
    return args


def row_scale(B):
    """A DropPath scale of kept (1/0.9) and dropped (0) samples, f32."""
    return np.array([1 / KEEP if b != 1 else 0.0 for b in range(B)], np.float32)


# the LayerNorm parameters (and the row scales) stay f32 in the bf16 calls
F32_ARGS = {1, 2, 7, 8}


def jax_inputs(args, dtype):
    return [jnp.asarray(a, jnp.float32 if i in F32_ARGS else dtype)
            for i, a in enumerate(args)]


def port_inputs(args, dtype, grad=False):
    out = []
    for i, a in enumerate(args):
        t = torch.from_numpy(a).to(torch.float32 if i in F32_ARGS else dtype)
        out.append(t.requires_grad_() if grad else t)
    return out


def b1_jax(args, r, H, dtype):
    """(out, grads of sum(out²)) of the JAX package at ``dtype``: its Pallas
    kernel in bf16, its reference in f32."""
    inputs = jax_inputs(args, dtype) + ([jnp.asarray(r)] if r is not None else [])
    D = args[3].shape[1] // 3 // H

    def f(*a):
        rs = a[7] if r is not None else None
        if dtype == jnp.float32:
            out = _attn_layer_ref(*a[:7], None, rs, H, D ** -0.5, 1e-6)
        else:
            out = jax_fused_attention_layer(*a[:7], H, None, rs, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    grad_fn = jax.value_and_grad(f, argnums=tuple(range(len(inputs))), has_aux=True)
    (_, out), grads = jax.jit(grad_fn)(*inputs)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def b1_port(args, r, H):
    inputs = port_inputs(args, torch.bfloat16, grad=True)
    rs = torch.from_numpy(r).requires_grad_() if r is not None else None
    out = fused_layer.fused_attention_layer(*inputs, H, row_scale=rs)
    (out.float() ** 2).sum().backward()
    grads = [t.grad for t in inputs] + ([rs.grad] if rs is not None else [])
    return out.detach(), grads


def assert_within_gap(name, ours, bf, f32):
    """max|ours − bf| ≤ GAP_FACTOR·max|bf − f32| (elementwise tensors)."""
    gap = float(np.abs(bf - f32).max())
    err = float(np.abs(ours - bf).max())
    assert gap > 0, f"{name}: JAX bf16 equals JAX f32; the limit means nothing"
    assert err <= GAP_FACTOR * gap, f"{name}: {err:.3e} > {GAP_FACTOR} x {gap:.3e}"


def assert_grad_within_gap(name, ours, bf, f32):
    """Relative Frobenius error of ours against JAX bf16 within GAP_FACTOR
    of JAX bf16's against JAX f32."""
    gap = np.linalg.norm(bf - f32) / np.linalg.norm(f32)
    err = np.linalg.norm(ours - bf) / np.linalg.norm(bf)
    assert gap > 0, f"{name}: JAX bf16 equals JAX f32"
    assert err <= GAP_FACTOR * gap, f"{name}: {err:.3e} > {GAP_FACTOR} x {gap:.3e}"


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def b1_case(request):
    B, N, C, H, D = request.param
    args = make_args(B, N, C, H, D)
    r = row_scale(B)
    jax_out = {key: (b1_jax(args, rv, H, jnp.bfloat16), b1_jax(args, rv, H, jnp.float32))
               for key, rv in (("plain", None), ("rs", r))}
    return request.param, args, r, jax_out


@pytest.mark.parametrize("rs", ["plain", "rs"])
def test_b1_bf16_forward_and_grads_within_jax_bf16_gap(b1_case, rs):
    shape, args, r, jax_out = b1_case
    H = shape[3]
    (out_bf, grads_bf), (out_f32, grads_f32) = jax_out[rs]
    out, grads = b1_port(args, r if rs == "rs" else None, H)
    assert out.dtype == torch.bfloat16
    assert_within_gap("out", out.float().numpy(), out_bf, out_f32)
    for name, g, gb, gf in zip(NAMES, grads, grads_bf, grads_f32):
        assert g is not None, name
        want = torch.float32 if name in ("dln_scale", "dln_bias", "drs") else torch.bfloat16
        assert g.dtype == want, (name, g.dtype)
        assert_grad_within_gap(name, g.float().numpy(), gb, gf)


def test_b1_bf16_row_scale_rounds_to_bf16_first(b1_case):
    """The kept samples' branch scales by bf16(1/0.9) = 1.109375, as JAX's
    does: (out − x) of the kept rows agrees with JAX bf16's to within one
    bf16 ulp of the branch, and a branch scaled by the f32 1/0.9 would
    not."""
    shape, args, r, jax_out = b1_case
    H = shape[3]
    (out_bf, _), _ = jax_out["rs"]
    out, _ = b1_port(args, r, H)
    x = torch.from_numpy(args[0]).to(torch.bfloat16).float().numpy()
    kept = r > 0
    ours = out.float().numpy()[kept] - x[kept]
    theirs = out_bf[kept] - x[kept]
    assert np.abs(ours - theirs).max() <= 2.0 ** -8 * np.abs(theirs).max()
    # the same branch at an f32 scale: 1/0.9 / 1.109375 - 1 = 0.16% larger
    assert abs(np.float32(1 / KEEP) / np.float32(1.109375) - 1) > 1e-3
    assert float(torch.tensor(1 / KEEP).to(torch.bfloat16)) == 1.109375


@pytest.mark.parametrize("rs", [False, True], ids=["plain", "rs"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_b2_bf16_forward_within_jax_bf16_gap(shape, rs):
    B, N, C, H, D = shape
    F = 2 * C
    args = make_args(B, N, C, H, D, F)
    r = row_scale(B) if rs else None

    def jax_out(dtype):
        a = jax_inputs(args, dtype)
        rr = jnp.asarray(r) if r is not None else None
        if dtype == jnp.bfloat16:
            out = jax_fused_transformer_layer(*a, H, None, rr, rr, "silu", interpret=True)
            return np.asarray(out.astype(jnp.float32))
        z = _attn_layer_ref(*a[:7], None, rr, H, D ** -0.5, 1e-6)
        mu = z.mean(-1, keepdims=True)
        var = (z * z).mean(-1, keepdims=True) - mu * mu
        u = (z - mu) * jax.lax.rsqrt(var + 1e-6) * a[7] + a[8]
        out = jax.nn.silu(u @ a[9] + a[10]) @ a[11] + a[12]
        return np.asarray(z + (out if rr is None else out * rr[:, None, None]))

    a = port_inputs(args, torch.bfloat16)
    rr = torch.from_numpy(r) if r is not None else None
    with torch.no_grad():
        out = fused_layer1.fused_transformer_layer(*a, H, rs_attn=rr, rs_ff=rr)
    assert out.dtype == torch.bfloat16
    assert_within_gap("out", out.float().numpy(), jax_out(jnp.bfloat16), jax_out(jnp.float32))


def test_bf16_differs_from_f32():
    """The port's bf16 output is not its f32 output: bf16 ran."""
    B, N, C, H, D = SHAPES[0]
    args = make_args(B, N, C, H, D)
    with torch.no_grad():
        bf = fused_layer.fused_attention_layer(*port_inputs(args, torch.bfloat16), H)
        f = fused_layer.fused_attention_layer(*port_inputs(args, torch.float32), H)
    assert bf.dtype == torch.bfloat16
    assert (bf.float() - f).abs().max() > 1e-3
