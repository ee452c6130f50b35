"""PVT-S and Twins-SVT-S at full width and depth against stored JAX values.

tests/data/{pvt_s,twins_svt_s}_port_golden.npz and ``…_train_golden.npz``
(scripts/make_torch_port_pvt_twins_golden.py) hold a seed, the JAX
package's f32 logits [2, 1000] for tests/data/pvt_s_port.conf and
twins_svt_s_port.conf (the JAX package's registered defaults at 224 px) on
its einsum paths, and one drop_path-0 train-step gradient summarised as the
mix loss, the global gradient norm and per state_dict key the gradient's
L2 norm and its projection on a seeded normal tensor; weights, images,
labels and projections are regenerated from the seed.  The JAX package
must still reproduce the logits, so the files cannot go stale (that check
sits in tests/test_torch_port_pvt.py and test_torch_port_twins.py, which
keeps each file's time short).  The port's CPU path must match both on its
plain einsum path and through the ops' autograd Functions (PVT's and
Twins' reduced-kv attention forced to ``fused``, Twins' local attention
forced to ``layer``: the plain forwards with saves and the plain
backwards).  Logits within 1e-3·max(1,
max|golden|), the tolerance chip_smoke.py holds the card to; gradients
rtol 1e-4, a projection to 1e-4 of its tensor's norm: 16 and 18 f32 layers
in another summation order.
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
SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_pvt_twins_golden.py")
N_IMAGES, SIZE = 2, 224
RTOL = 1e-4
# path → (the local attention force, the reduced-kv force)
PATHS = {"einsum": ("einsum", "einsum"), "kernels": ("layer", "fused")}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("make_torch_port_pvt_twins_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


class forced:
    def __init__(self, path):
        self.local, self.glob = PATHS[path]

    def __enter__(self):
        ops.set_attention_impl(self.local)
        ops.set_sra_impl(self.glob)

    def __exit__(self, *exc):
        ops.set_attention_impl(None)
        ops.set_sra_impl(None)


def seeded(conf, seed, **kw):
    arch = dataclasses.replace(load_config(conf).arch, **kw)
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    return arch, model


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", ["PVT-S", "Twins-SVT-S"])
def test_port_matches_golden_on_cpu(script, name, path):
    conf, golden, _ = script.MODELS[name]
    g = load(golden)
    seed, logits = int(g["seed"]), g["logits"]
    _, model = seeded(conf, seed)
    images = seeded_images(seed, N_IMAGES, SIZE)
    with forced(path):
        out, top, _ = predict_batch(model.eval(), images, 5, torch.device("cpu"))
    assert out.shape == logits.shape and np.isfinite(out).all()
    assert np.abs(out - logits).max() <= 1e-3 * max(1.0, float(np.abs(logits).max()))
    np.testing.assert_array_equal(top[:, 0], logits.argmax(-1))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", ["PVT-S", "Twins-SVT-S"])
def test_port_matches_train_golden_on_cpu(script, name, path):
    conf, _, train_golden = script.MODELS[name]
    g = load(train_golden)
    seed = int(g["seed"])
    # the golden is one deterministic step: drop_path off
    arch, model = seeded(conf, seed, drop_path=0.0)
    b = {k: torch.from_numpy(v) for k, v in
         seeded_train_batch(seed, N_IMAGES, SIZE, arch.n_class).items()}
    with forced(path):
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
