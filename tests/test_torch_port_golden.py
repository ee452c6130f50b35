"""ViT-S/16 at full width against stored JAX logits.

tests/data/vit_s16_port_golden.npz holds a seed and the JAX package's f32
logits [2, 1000] (scripts/make_torch_port_golden.py); weights and images are
regenerated from the seed.  The JAX package must still reproduce the file
(so it cannot go stale), and the port's CPU path must match it within
1e-3·max(1, max|golden|) — the tolerance chip_smoke.py holds the card to:
12 f32 layers with another summation order.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.predict import predict_batch
from vision_transformers_tpu_torch.utils.weights import (seeded_images,
                                                         seeded_state_dict,
                                                         to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_golden.py")


def _script():
    spec = importlib.util.spec_from_file_location("make_torch_port_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden():
    mod = _script()
    with np.load(mod.GOLDEN) as f:
        return mod, int(f["seed"]), f["logits"]


def test_jax_package_reproduces_golden(golden):
    mod, seed, logits = golden
    np.testing.assert_allclose(mod.jax_logits(seed), logits, rtol=1e-5, atol=1e-5)


def test_port_matches_golden_on_cpu(golden):
    mod, seed, logits = golden
    arch = load_config(mod.CONF).arch
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    images = seeded_images(seed, mod.N_IMAGES, arch.image_size)
    out, top, prob = predict_batch(model.eval(), images, 5, torch.device("cpu"))
    assert out.shape == logits.shape and np.isfinite(out).all()
    tol = 1e-3 * max(1.0, float(np.abs(logits).max()))
    assert np.abs(out - logits).max() <= tol
    np.testing.assert_array_equal(top[:, 0], logits.argmax(-1))
