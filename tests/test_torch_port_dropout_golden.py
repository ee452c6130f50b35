"""ViT-S/16 at full width with dropout = drop_ff = 0.1, one f32 train-step
gradient, against stored JAX values.

tests/data/vit_s16_port_dropout_train_golden.npz (scripts/
make_torch_port_train_golden.py --dropout) holds a seed, the JAX package's
mix loss and global gradient norm on its packed-qkv attention kernel
(forced, interpreted) with every dropout mask taken from
``utils/weights.seeded_dropout_masks``, and per state_dict key the
gradient's L2 norm and its projection on a seeded normal tensor.  The port
regenerates weights, batch and masks from the seed and supplies the masks
in call order (``utils/weights.supplied_dropout_masks``); it must match on
the CPU through its plain einsum (2 rows take it) and through the
packed-qkv op's autograd Function ('fused' forced).  Tolerance as
tests/test_torch_port_train_golden.py: rtol 1e-4, a projection to 1e-4 of
its tensor's norm.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                         seeded_dropout_masks,
                                                         seeded_state_dict,
                                                         seeded_train_batch,
                                                         supplied_dropout_masks,
                                                         to_torch,
                                                         vit_dropout_calls)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_train_golden.py")
RTOL = 1e-4


@pytest.fixture(scope="module")
def golden():
    spec = importlib.util.spec_from_file_location("make_torch_port_train_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(mod.DROPOUT_GOLDEN) as f:
        return mod, {k: f[k] for k in f.files}


@pytest.mark.parametrize("impl", [None, "fused"], ids=["default-einsum", "fused"])
def test_port_matches_dropout_golden_on_cpu(golden, impl):
    mod, g = golden
    seed = int(g["seed"])
    arch = mod.dropout_arch(load_config(mod.CONF).arch)
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    b = {k: torch.from_numpy(v) for k, v in
         seeded_train_batch(seed, mod.N_IMAGES, arch.image_size, arch.n_class).items()}
    shapes, rates = zip(*vit_dropout_calls(arch, mod.N_IMAGES))
    ops.set_attention_impl(impl)
    try:
        with supplied_dropout_masks(seeded_dropout_masks(seed, shapes, rates)) as calls:
            logits = model.train()(b["image"].permute(0, 3, 1, 2))
            loss = L.mix_loss(logits, b["label1"].long(), b["label2"].long(),
                              b["ratio"], eps=0.1)
        loss.backward()
    finally:
        ops.set_attention_impl(None)
    assert calls == list(zip(shapes, rates))
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    keys = list(g["keys"])
    assert sorted(grads) == keys
    norms = np.array([np.linalg.norm(grads[k].astype(np.float64)) for k in keys])
    proj = grad_projections(grads, seed)
    np.testing.assert_allclose(float(loss.detach()), g["loss"], rtol=RTOL)
    np.testing.assert_allclose(np.sqrt((norms ** 2).sum()), g["grad_norm"], rtol=RTOL)
    np.testing.assert_allclose(norms, g["norms"], rtol=RTOL)
    err = np.abs(np.array([proj[k] for k in keys]) - g["projections"])
    assert (err <= RTOL * g["norms"] + 1e-7).all(), keys[int(np.argmax(err / g["norms"]))]
