"""ViT-S/16 at full width and depth in bf16 against the stored JAX values.

tests/data/vit_s16_bf16_port_golden.npz (scripts/make_torch_port_bf16_golden.py)
holds, for seeded weights and two seeded images, the JAX package's logits
at bf16 (on B1 and on B2, Pallas in interpret mode) and at f32, and one
train step at bf16 and at f32 (the loss, per-key gradient norms and
projections, a few whole gradients).  The port's plain path on the CPU must
meet the file within 3 times the JAX package's own bf16-against-f32 error,
as chip_smoke.py holds the card's kernels to it: the logits on the 'layer'
and 'layer1' forces, the train step on the 'layer' force.
"""

import importlib.util
import os

import numpy as np
import pytest

from torch_port_threads import one_torch_thread  # noqa: F401

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "make_torch_port_bf16_golden.py")


@pytest.fixture(scope="module")
def golden():
    spec = importlib.util.spec_from_file_location("make_torch_port_bf16_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(mod.GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    return mod, g, mod.port_model(int(g["seed"]), "cpu")


def test_golden_holds_a_bf16_gap(golden):
    """The stored bf16 values are not the f32 ones: the limits mean
    something."""
    _, g, _ = golden
    for impl in ("layer", "layer1"):
        assert np.abs(g[f"logits_bf16_{impl}"] - g["logits_f32"]).max() > 1e-3
    assert g["loss_bf16"] != g["loss_f32"]
    assert g["logits_f32"].shape == (2, 1000) and len(g["keys"]) == len(g["norms_bf16"])


@pytest.mark.parametrize("impl", ["layer", "layer1"])
def test_port_logits_meet_golden_on_cpu(golden, impl):
    mod, g, model = golden
    err, lim = mod.check_logits(mod.port_logits(int(g["seed"]), "cpu", 2, impl, model), g,
                                impl)
    assert err <= lim


def test_port_train_step_meets_golden_on_cpu(golden):
    mod, g, model = golden
    checks = mod.check_train(mod.port_train(int(g["seed"]), "cpu", 2, "layer", model), g)
    assert all(e <= lim for e, lim in checks.values())
