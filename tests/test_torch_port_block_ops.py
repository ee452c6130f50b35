"""The attention block B8 (vision_transformers_tpu_torch/ops/fused_block.py::
fused_attention_block) against the JAX package's Pallas kernel in interpret
mode.

Forward and all six gradients (``jax.vjp`` of the JAX op against the port's
autograd Function on its plain forward and backward), from numpy-seeded
inputs, at B = 4, N = 13, C = 16, H = 2, D = 8: without a bias and with each
of its forms — [N, N], [1, N, N], [H, N, N] shared and [G, H, N, N] grouped
with G = 2 —, with and without the qkv and out biases, and with Cout = 24 ≠
C; and the grouped and [H, N, N] biases on heads 64 wide (``"grouped@64"``,
``"hnn@64"``), the widest the card takes them at.  Forward within atol = rtol = 1e-5 (the same f32 math in another
summation order); each gradient within 1e-4·max(1, max|JAX|).

The CUDA dispatch and the card-only checks are in
tests/test_torch_port_gather_block_entry.py, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_block import \
    fused_attention_block as jax_fused_attention_block
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.ops import fused_block as fb

B, N, C, H, D = 4, 13, 16, 2, 8
SHAPES = {None: None, "nn": (N, N), "1nn": (1, N, N), "hnn": (H, N, N),
          "grouped": (2, H, N, N)}
# (bias form, qkv / out biases, Cout); "form@64": that bias on heads 64 wide
CASES = [(None, True, C), (None, False, 24), ("nn", True, C), ("1nn", False, C),
         ("hnn", True, 24), ("grouped", True, C), ("grouped", False, 24),
         ("grouped@64", True, C), ("hnn@64", False, 24)]


def bias_form(form):
    """(the bias form, the head width) of a case's form."""
    if form is not None and "@" in form:
        base, width = form.split("@")
        return base, int(width)
    return form, D


def inputs(form, biases, cout, seed=0):
    """x, wqkv [C, 3HD], bqkv, wout [HD, Cout], bout (None without
    ``biases``), the bias in ``form`` (or None) and an output grad."""
    form, dh = bias_form(form)
    rng = np.random.default_rng([seed, cout, list(SHAPES).index(form)]
                                + ([dh] if dh != D else []))

    def n(*shape, s=1.0):
        return (s * rng.normal(size=shape)).astype(np.float32)

    HD = H * dh
    shape = SHAPES[form]
    return (n(B, N, C), n(C, 3 * HD, s=0.2), n(3 * HD, s=0.1) if biases else None,
            n(HD, cout, s=0.2), n(cout, s=0.1) if biases else None,
            None if shape is None else n(*shape, s=0.5), n(B, N, cout))


def close(ours, theirs, what):
    theirs = np.asarray(theirs)
    tol = 1e-4 * max(1.0, float(np.abs(theirs).max()))
    err = float(np.abs(ours - theirs).max())
    assert ours.shape == theirs.shape and err <= tol, (what, err, tol)


@pytest.mark.parametrize("form,biases,cout", CASES,
                         ids=lambda v: str(v) if not isinstance(v, bool)
                         else ("biases" if v else "no-biases"))
def test_matches_jax_forward_and_grads(form, biases, cout):
    *args, do = inputs(form, biases, cout)
    present = [i for i, a in enumerate(args) if a is not None]

    @jax.jit
    def jax_fwd_bwd(ins, d):
        def f(*xs):
            full = list(args)
            for i, x in zip(present, xs):
                full[i] = x
            x, wqkv, bqkv, wout, bout, extra = full
            return jax_fused_attention_block(x, wqkv, bqkv, wout, bout, H, extra,
                                             interpret=True)

        out, vjp = jax.vjp(f, *ins)
        return out, vjp(d)

    out_j, grads_j = jax_fwd_bwd([jnp.asarray(args[i]) for i in present], jnp.asarray(do))
    t = [None if a is None else torch.from_numpy(a).requires_grad_() for a in args]
    out = ops.fused_attention_block(*t[:5], H, t[5])
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-5)
    for i, g_j in zip(present, grads_j):
        close(t[i].grad.numpy(), g_j, fb.GRAD_NAMES[i])
    _, saved = fb.fused_attention_block_fwd(*(None if a is None else torch.from_numpy(a)
                                              for a in args[:5]), H, t[5])
    grads = fb.fused_attention_block_bwd(saved, torch.from_numpy(do))
    assert [g is None for g in grads] == [a is None for a in args]


def test_training_forward_saves_and_no_grad_path():
    """The no-grad call is the plain forward; the training forward keeps the
    packed projection, the attention output and lse of the biased scores;
    the bias's gradient is not computed where it needs none."""
    *args, do = inputs("grouped", True, 24)
    x, wqkv, bqkv, wout, bout, extra = (torch.from_numpy(a) for a in args)
    with torch.no_grad():
        out = ops.fused_attention_block(x, wqkv, bqkv, wout, bout, H, extra)
    out2, saved = fb.fused_attention_block_fwd(x, wqkv, bqkv, wout, bout, H, extra)
    torch.testing.assert_close(out, out2, atol=0, rtol=0)
    torch.testing.assert_close(saved.qkv, x @ wqkv + bqkv, atol=1e-5, rtol=1e-5)
    q, k = (saved.qkv[..., i * H * D:(i + 1) * H * D].reshape(B, N, H, D).transpose(1, 2)
            for i in (0, 1))
    s = q @ k.transpose(-1, -2) / D ** 0.5 + extra.repeat_interleave(2, 0)
    torch.testing.assert_close(saved.lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
    assert saved.acc.shape == (B, N, H * D) and saved.extra_g.shape == (2, H, N, N)
    grads = fb.fused_attention_block_bwd(saved, torch.from_numpy(do), need_dextra=False)
    assert grads[-1] is None and grads[0].shape == x.shape
    assert fb.block_bwd_reference(saved, torch.from_numpy(do))[-1].shape == (2, H, N, N)
