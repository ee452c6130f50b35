"""The packed-qkv attention B3 (vision_transformers_tpu_torch/ops/
fused_attention.py::fused_attention_qkv) against the JAX package's Pallas
kernel in interpret mode.

- Forward and every gradient (``jax.vjp`` of the JAX op against the port's
  autograd Function on its plain forward and backward), from numpy-seeded
  inputs, at B = 4, N ∈ {37, 64}, H = 2, D ∈ {16, 32, 64}, without a bias
  and with each of its forms: [N, N], [H, N, N], [1, N, N] shared and
  [G, H, N, N] grouped with G = 2.  Forward within atol = rtol = 1e-5 (the
  same f32 math in another summation order); each gradient within
  1e-4·max(1, max|JAX|).

The CUDA dispatch and the card-only checks are in
tests/test_torch_port_vit_entry.py, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu.ops.fused_attention import \
    fused_attention_qkv as jax_fused_attention_qkv
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.ops import fused_attention_mod as fa

B, H = 4, 2
FORMS = [None, "nn", "hnn", "1nn", "grouped"]


def inputs(N, D, form, seed=0):
    rng = np.random.default_rng([seed, N, D])
    qkv = rng.normal(size=(B, N, 3 * H * D)).astype(np.float32)
    shape = {None: None, "nn": (N, N), "hnn": (H, N, N), "1nn": (1, N, N),
             "grouped": (2, H, N, N)}[form]
    extra = None if shape is None else (0.5 * rng.normal(size=shape)).astype(np.float32)
    do = rng.normal(size=(B, N, H * D)).astype(np.float32)
    return qkv, extra, do


def close(ours, theirs, what):
    theirs = np.asarray(theirs)
    tol = 1e-4 * max(1.0, float(np.abs(theirs).max()))
    err = float(np.abs(ours - theirs).max())
    assert ours.shape == theirs.shape and err <= tol, (what, err, tol)


@pytest.mark.parametrize("form", FORMS, ids=lambda f: f or "no-bias")
@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("N", [37, 64])
def test_matches_jax_forward_and_grads(N, D, form):
    qkv, extra, do = inputs(N, D, form)

    @jax.jit
    def jax_fwd_bwd(q, e, d):
        out, vjp = jax.vjp(lambda q, e: jax_fused_attention_qkv(q, H, e, None, True), q, e)
        return out, vjp(d)

    out_j, (dq_j, de_j) = jax_fwd_bwd(jnp.asarray(qkv), None if extra is None
                                      else jnp.asarray(extra), jnp.asarray(do))
    q_t = torch.from_numpy(qkv).requires_grad_()
    e_t = None if extra is None else torch.from_numpy(extra).requires_grad_()
    out = ops.fused_attention_qkv(q_t, H, e_t)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-5)
    close(q_t.grad.numpy(), dq_j, "dqkv")
    if extra is not None:
        close(e_t.grad.numpy(), de_j, "dextra")


def test_plain_forward_without_grad_and_lse():
    """The no-grad call is the plain forward; the training forward's lse is
    the log-sum-exp of the scaled scores."""
    qkv, extra, _ = inputs(37, 32, "grouped")
    q, e = torch.from_numpy(qkv), torch.from_numpy(extra)
    with torch.no_grad():
        out = ops.fused_attention_qkv(q, H, e)
    out2, saved = fa.fused_attention_qkv_fwd(q, H, e)
    torch.testing.assert_close(out, out2, atol=0, rtol=0)
    qh, kh = (q.reshape(B, 37, 3, H, 32)[:, :, i].permute(0, 2, 1, 3) for i in (0, 1))
    s = qh @ kh.transpose(-1, -2) / 32 ** 0.5 + e.repeat_interleave(2, 0)
    torch.testing.assert_close(saved.lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
    assert saved.extra_g.shape == (2, H, 37, 37)


