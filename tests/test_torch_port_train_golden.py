"""ViT-S/16 at full width, one f32 train-step gradient, against stored JAX
values.

tests/data/vit_s16_port_train_golden.npz (scripts/make_torch_port_train_golden.py)
holds a seed, the JAX package's mix loss and global gradient norm, and per
state_dict key the gradient's L2 norm and its projection on a seeded normal
tensor; weights, the batch and the projection tensors are regenerated from
the seed.  The JAX package must still reproduce the file (about 20 s here,
so it stays in tier-1), and the port's CPU path must match it, on the
einsum path (2 rows take it) and through the fused layer's autograd Function
('layer' forced).  Tolerance rtol 1e-4, a projection to 1e-4 of its
tensor's norm: 12 f32 layers in another summation order.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                         seeded_state_dict,
                                                         seeded_train_batch,
                                                         to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_train_golden.py")
RTOL = 1e-4


def _script():
    spec = importlib.util.spec_from_file_location("make_torch_port_train_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden():
    mod = _script()
    with np.load(mod.GOLDEN) as f:
        return mod, {k: f[k] for k in f.files}


def test_jax_package_reproduces_golden(golden):
    mod, g = golden
    ours = mod.jax_train_grads(int(g["seed"]))
    assert list(ours["keys"]) == list(g["keys"])
    np.testing.assert_allclose(ours["loss"], g["loss"], rtol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], g["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(ours["norms"], g["norms"], rtol=1e-5)
    np.testing.assert_allclose(ours["projections"], g["projections"],
                               atol=1e-5 * float(g["norms"].max()))


def port_grads(mod, seed):
    # the conf's drop_path 0.1 off: the golden is one deterministic step
    arch = dataclasses.replace(load_config(mod.CONF).arch, drop_path=0.0)
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    b = {k: torch.from_numpy(v) for k, v in
         seeded_train_batch(seed, mod.N_IMAGES, arch.image_size, arch.n_class).items()}
    logits = model.train()(b["image"].permute(0, 3, 1, 2))
    loss = L.mix_loss(logits, b["label1"].long(), b["label2"].long(), b["ratio"], eps=0.1)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return float(loss.detach()), grads


@pytest.mark.parametrize("impl", [None, "layer"], ids=["default-einsum", "layer"])
def test_port_matches_golden_on_cpu(golden, impl):
    mod, g = golden
    seed = int(g["seed"])
    ops.set_attention_impl(impl)
    try:
        loss, grads = port_grads(mod, seed)
    finally:
        ops.set_attention_impl(None)
    keys = list(g["keys"])
    assert sorted(grads) == keys
    norms = np.array([np.linalg.norm(grads[k].astype(np.float64)) for k in keys])
    proj = grad_projections(grads, seed)
    np.testing.assert_allclose(loss, g["loss"], rtol=RTOL)
    np.testing.assert_allclose(np.sqrt((norms ** 2).sum()), g["grad_norm"], rtol=RTOL)
    np.testing.assert_allclose(norms, g["norms"], rtol=RTOL)
    err = np.abs(np.array([proj[k] for k in keys]) - g["projections"])
    assert (err <= RTOL * g["norms"] + 1e-7).all(), keys[int(np.argmax(err / g["norms"]))]
