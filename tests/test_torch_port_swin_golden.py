"""Swin-S at full width and depth against stored JAX values.

tests/data/swin_s_port_golden.npz and swin_s_port_train_golden.npz
(scripts/make_torch_port_swin_golden.py) hold a seed, the JAX package's f32
logits [2, 1000], and one drop_path-0 train-step gradient summarised as the
mix loss, the global gradient norm and per state_dict key the gradient's
L2 norm and its projection on a seeded normal tensor; weights, images,
labels and projections are regenerated from the seed.  The JAX package must
still reproduce the logits (so the files cannot go stale), and the port's
CPU path must match both, on the einsum path (2 rows take it) and through
the whole-layer op's autograd Function ('layer1' forced: its plain forward
with saves and plain backward).  Logits within 1e-3·max(1, max|golden|),
the tolerance chip_smoke.py holds the card to; gradients rtol 1e-4, a
projection to 1e-4 of its tensor's norm: 24 f32 layers in another
summation order.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch import ops
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.predict import predict_batch
from vision_transformers_tpu_torch.train import loss as L
from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                         seeded_images,
                                                         seeded_state_dict,
                                                         seeded_train_batch,
                                                         to_torch)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_swin_golden.py")
N_IMAGES, SIZE = 2, 224
RTOL = 1e-4


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("make_torch_port_swin_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


class forced:
    def __init__(self, impl):
        self.impl = impl

    def __enter__(self):
        ops.set_attention_impl(self.impl)

    def __exit__(self, *exc):
        ops.set_attention_impl(None)


def test_jax_package_reproduces_golden(script):
    g = load(script.GOLDEN)
    np.testing.assert_allclose(script.jax_logits(int(g["seed"])), g["logits"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", [None, "layer1"], ids=["default-einsum", "layer1"])
def test_port_matches_golden_on_cpu(script, impl):
    g = load(script.GOLDEN)
    seed, logits = int(g["seed"]), g["logits"]
    arch = load_config(script.CONF).arch
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    images = seeded_images(seed, N_IMAGES, SIZE)
    with forced(impl):
        out, top, _ = predict_batch(model.eval(), images, 5, torch.device("cpu"))
    assert out.shape == logits.shape and np.isfinite(out).all()
    assert np.abs(out - logits).max() <= 1e-3 * max(1.0, float(np.abs(logits).max()))
    np.testing.assert_array_equal(top[:, 0], logits.argmax(-1))


@pytest.mark.parametrize("impl", [None, "layer1"], ids=["default-einsum", "layer1"])
def test_port_matches_train_golden_on_cpu(script, impl):
    g = load(script.TRAIN_GOLDEN)
    seed = int(g["seed"])
    # the conf's drop_path 0.3 off: the golden is one deterministic step
    arch = dataclasses.replace(load_config(script.CONF).arch, drop_path=0.0)
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    b = {k: torch.from_numpy(v) for k, v in
         seeded_train_batch(seed, N_IMAGES, SIZE, arch.n_class).items()}
    with forced(impl):
        logits = model.train()(b["image"].permute(0, 3, 1, 2))
        loss = L.mix_loss(logits, b["label1"].long(), b["label2"].long(), b["ratio"],
                          eps=0.1)
        loss.backward()
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
