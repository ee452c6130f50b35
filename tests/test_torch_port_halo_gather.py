"""Halo's gather path in the port against the JAX package: the gathered halo
attention B5b (vision_transformers_tpu_torch/ops/fused_halo.py::
halo_attention), a tiny Halo whose halo is wider than half its window, the
dispatch and the weight conversion.

- B5b's plain version (the port's autograd Function on the CPU) against the
  JAX ``halo_attention`` in interpret mode: forward within atol = rtol =
  1e-5, dq / dkv / dbias within 1e-4·max(1, max|JAX|), at two shapes of
  numpy-seeded inputs: window 4 with halo 2 (M 16, N 64, heads 8 wide) and
  window 4 with halo 3 (2·halo > window: M 16, N 100, heads 12 wide).
- A tiny Halo (image 128, window 4, halo 3: stage maps 32 / 16 / 8 / 4,
  depths 1·4, dims 16-128, dim_head 8) on the port's DEFAULT dispatch
  (which takes 'gather' there) against the JAX Halo forced to its gather
  path (``VTX_HALO_IMPL=gather``, the Pallas kernel in interpret mode):
  logits to atol 1e-5, one train step's loss to rtol 1e-5 and every
  gradient to rtol 1e-3 per tensor (as tests/test_torch_port_halo.py).
- ``ops.halo_impl`` against the JAX ``halo_impl`` over windows, halos and
  forces, on the accelerator (the JAX side's backend read as the TPU's), the
  JAX 8 | window alignment clause excepted (interpret mode), which the port
  does not carry over.
- The window-4 / halo-3 tree (a 133-position rel-pos table per layer) through
  the JAX conversion and ``state_dict_from_flax`` back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.config import registry as jax_registry
from vision_transformers_tpu.ops.fused_halo import halo_attention as jax_halo_attention
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.models import halo as port_halo
from vision_transformers_tpu_torch.models.halo import HaloConfig
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         seeded_train_batch,
                                                         state_dict_from_flax, to_torch)

TINY = dict(image_size=128, n_class=10, depths=[1, 1, 1, 1], dims=[16, 32, 64, 128],
            dim_head=8, n_heads=[2, 4, 8, 16], dim_ffs=[32, 64, 128, 256], window_size=4,
            halo_size=3)
IMAGES = 2


def close(ours, theirs, what):
    theirs = np.asarray(theirs)
    tol = 1e-4 * max(1.0, float(np.abs(theirs).max()))
    err = float(np.abs(ours - theirs).max())
    assert ours.shape == theirs.shape and err <= tol, (what, err, tol)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,M,N,H,D", [(6, 16, 64, 2, 8), (5, 16, 100, 3, 12)],
                         ids=["w4-halo2", "w4-halo3"])
def test_op_matches_jax_forward_and_grads(B, M, N, H, D):
    rng = np.random.default_rng([B, N])
    q, kv, do = (rng.normal(size=s).astype(np.float32)
                 for s in ((B, M, H * D), (B, N, 2 * H * D), (B, M, H * D)))
    bias = (0.5 * rng.normal(size=(H, M, N))).astype(np.float32)

    @jax.jit
    def jax_fwd_bwd(q, kv, bias, d):
        out, vjp = jax.vjp(lambda *a: jax_halo_attention(*a, H, None, True), q, kv, bias)
        return out, vjp(d)

    out_j, grads_j = jax_fwd_bwd(*map(jnp.asarray, (q, kv, bias, do)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, kv, bias)]
    out = ops.halo_attention(*t, H)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-5)
    for x, g_j, name in zip(t, grads_j, ("dq", "dkv", "dbias")):
        close(x.grad.numpy(), g_j, name)
    with torch.no_grad():  # the serving call: the plain forward, no saves
        torch.testing.assert_close(ops.halo_attention(*t, H), out.detach(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the tiny window-4 / halo-3 Halo
# ---------------------------------------------------------------------------


class jax_gather:
    """The JAX Halo forced to its gather path, the kernel interpreted."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def __enter__(self):
        self.monkeypatch.setenv("VTX_HALO_IMPL", "gather")
        jax_ops.set_attention_impl(None, interpret=True)

    def __exit__(self, *exc):
        jax_ops.set_attention_impl(None)


@pytest.fixture(scope="module")
def tiny():
    """(state_dict, batch, the JAX variables built from it)."""
    cfg = jax_registry.build("model", {"type": "halo_transformer", **TINY})
    sd = seeded_state_dict(HaloConfig(**TINY), seed=2)
    return sd, seeded_train_batch(8, IMAGES, 128, 10), cfg, \
        jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))


def port_model(sd):
    model = HaloConfig(**TINY).make()
    model.load_state_dict(to_torch(sd), strict=True)
    return model


def test_default_dispatch_takes_gather_and_matches_jax_logits(tiny, monkeypatch):
    """No force: the port's four layers take the gathered op; the logits
    are the JAX gather path's."""
    sd, batch, cfg, variables = tiny
    with jax_gather(monkeypatch):
        theirs = np.asarray(jax.jit(cfg.make().apply)(variables, jnp.asarray(batch["image"])))
    calls = []
    fn = port_halo.halo_attention
    monkeypatch.setattr(port_halo, "halo_attention",
                        lambda *a, **k: calls.append(a[0].shape) or fn(*a, **k))
    with torch.no_grad():
        ours = port_model(sd).eval()(torch.from_numpy(batch["image"]).permute(0, 3, 1, 2))
    # one call per layer: B' = images · windows, 16 queries
    assert calls == [(IMAGES * (s // 4) ** 2, 16, TINY["n_heads"][i] * 8)
                     for i, s in enumerate((32, 16, 8, 4))]
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5, rtol=0)


def test_train_step_grads_match_jax(tiny, monkeypatch):
    sd, batch, cfg, variables = tiny
    b = jax.tree.map(jnp.asarray, batch)

    def f(p):
        logits = cfg.make().apply({"params": p}, b["image"], deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_loss.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)

    with jax_gather(monkeypatch):
        loss_j, g = jax.jit(jax.value_and_grad(f))(variables["params"])
    theirs = state_dict_from_flax(jax.tree.map(np.asarray, g))
    model = port_model(sd).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tb["image"].permute(0, 3, 1, 2))
    loss = L.mix_loss(logits, tb["label1"].long(), tb["label2"].long(), tb["ratio"], eps=0.1)
    loss.backward()
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    assert sorted(ours) == sorted(theirs)
    for k in sorted(ours):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-3, atol=1e-6, err_msg=k)
    assert all(np.abs(ours[k]).max() > 0 for k in ours if "rel_pos" in k)


def test_weights_convert_with_the_wider_table(tiny):
    """The window-4 / halo-3 tree: state_dict → the JAX params → back is the
    identity, and loads strictly into the port (a table of 133 positions,
    where window 4 / halo 2 has 91)."""
    sd, _, _, variables = tiny
    back = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    assert sd["block1.1.attn.rel_pos.weight"].shape == (
        port_halo.halo_position_index(4, 3)[1] + 1, 2) == (133, 2)
    port_model(back)


# ---------------------------------------------------------------------------
# the dispatch table
# ---------------------------------------------------------------------------


WINDOWS, HALOS = (2, 4, 7, 8), (1, 2, 3, 4)
FORCES = [None, "layer", "direct", "gather", "einsum", "global-einsum"]


def port_impl(window, halo, force):
    ops.set_halo_impl(force if force not in (None, "global-einsum") else None)
    ops.set_attention_impl("einsum" if force == "global-einsum" else None)
    try:
        return ops.halo_impl(window, halo)
    except NotImplementedError:
        return "raises"
    finally:
        ops.set_halo_impl(None)
        ops.set_attention_impl(None)


@pytest.mark.parametrize("force", FORCES, ids=lambda f: f or "default")
def test_halo_impl_table_matches_jax(monkeypatch, force):
    """On the accelerator JAX takes 'layer' where 2·halo ≤ window, 'gather'
    where the halo is wider; the forces as there, except that a 'direct'
    force on a wide halo raises in the port (JAX returns 'direct', which
    its direct op cannot take)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_ops, "_INTERPRET", True)  # alignment clause excepted
    monkeypatch.delenv("VTX_ATTN_IMPL", raising=False)
    monkeypatch.delenv("VTX_FUSED_ATTENTION", raising=False)
    if force in (None, "global-einsum"):
        monkeypatch.delenv("VTX_HALO_IMPL", raising=False)
    else:
        monkeypatch.setenv("VTX_HALO_IMPL", force)
    monkeypatch.setattr(jax_ops, "_FORCED", "einsum" if force == "global-einsum" else None)
    for window in WINDOWS:
        for halo in HALOS:
            theirs = jax_ops.halo_impl(window, halo)
            ours = port_impl(window, halo, force)
            if force == "direct" and 2 * halo > window:
                assert (theirs, ours) == ("direct", "raises"), (window, halo)
            else:
                assert ours == theirs, (window, halo, force)
