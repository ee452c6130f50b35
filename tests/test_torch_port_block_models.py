"""ViT and Swin under ``set_attention_impl("block")`` in the port against the
JAX package under the same force: the attention block B8
(vision_transformers_tpu_torch/ops/fused_block.py, its plain versions on
the CPU) against the JAX ``fused_attention_block`` in interpret mode,
inside the models.

Both sides start from one numpy-seeded reference-layout state_dict, as in
tests/test_torch_port_vit_dropout.py, whose helpers this file uses: the
dropout masks are made explicit on both sides and must be drawn in the same
order (the attention output's dropout after the block, vit.py:298-299).

- The tiny ViT (depth 2, dim 64, 2 heads, 17 tokens) at 5 images, without
  dropout and with dropout = 0.1, drop_ff = 0.2: eval logits to rtol 1e-4 /
  atol 1e-5, one train step's logits, loss (rtol 1e-5) and every gradient
  (rtol 1e-3 per tensor); each layer's attention through the block op.
- A tiny Swin (tests/test_torch_port_vit_dropout.py's, image 64, 2x2
  windows packed in pairs, at depths 2, 1, 1, 1: a shifted and an unshifted
  layer in stage 1) at 2 images: the same, the block op on the window-major
  rows with the grouped bias (relative-position table + shift mask) in
  every layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_vit_dropout import (ARCH, IMAGES, SWIN, close_grads, forced,
                                         jax_vit, masks_for, port_vit, spy,
                                         train_step_both)
from vision_transformers_tpu.config import registry as jax_registry
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch.models.swin import SwinConfig
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         seeded_train_batch, to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401


def eval_logits_both(cfg_jax, model, sd, images):
    variables = jax.tree.map(jnp.asarray, convert_state_dict(cfg_jax, sd))
    theirs = np.asarray(jax.jit(cfg_jax.make().apply)(variables, jnp.asarray(images)))
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
    return ours, theirs


@pytest.mark.parametrize("rates", [{}, dict(dropout=0.1, drop_ff=0.2)],
                         ids=["no-dropout", "dropout+drop_ff"])
def test_vit_block_matches_jax(monkeypatch, rates):
    cfg, model, sd = port_vit(**rates)
    block = spy(monkeypatch, "fused_attention_block")
    batch = seeded_train_batch(9, IMAGES, 32, 10)
    with forced("block"):
        ours, theirs = eval_logits_both(jax_vit(**rates), model, sd, batch["image"])
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
        logits, logits_j, loss, loss_j, g, g_j, calls = train_step_both(
            jax_vit(**rates), model, sd, batch, masks_for(cfg) if rates else [])
    assert block.n == 2 * ARCH["depth"]  # the eval forward and the train step
    assert len(calls) == (1 + 3 * ARCH["depth"] if rates else 0)
    np.testing.assert_allclose(logits, logits_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    close_grads(g, g_j)


SWIN_BLOCK = {**SWIN, "depths": [2, 1, 1, 1]}


def test_swin_block_matches_jax(monkeypatch):
    cfg = SwinConfig(**SWIN_BLOCK)
    sd = seeded_state_dict(cfg, seed=0)
    model = cfg.make()
    model.load_state_dict(to_torch(sd), strict=True)
    cfg_jax = jax_registry.build("model", {"type": "swin_transformer", **SWIN_BLOCK})
    block = spy(monkeypatch, "fused_attention_block")
    batch = seeded_train_batch(10, 2, 64, 10)
    with forced("block"):
        ours, theirs = eval_logits_both(cfg_jax, model, sd, batch["image"])
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
        logits, logits_j, loss, loss_j, g, g_j, _ = train_step_both(
            cfg_jax, model, sd, batch, [])
    assert block.n == 2 * sum(SWIN_BLOCK["depths"])
    np.testing.assert_allclose(logits, logits_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    close_grads(g, g_j)
    assert all(np.abs(g[k]).max() > 0 for k in g if "rel_pos" in k)
