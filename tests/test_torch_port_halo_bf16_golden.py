"""Halo-S at full width and depth in bf16 against the stored JAX values.

tests/data/halo_s_bf16_port_golden.npz
(scripts/make_torch_port_halo_bf16_golden.py) holds, for seeded weights and
two seeded images, the JAX package's logits at bf16 (on the whole Halo
layer, Pallas in interpret mode) and at f32, and one train step at bf16
and at f32 (the loss, per-key gradient norms and projections, a
relative-position table's whole gradient in each stage and a few more).
The port's plain path on the CPU, on its default 'layer' dispatch, must
meet the file within 3 times the JAX package's own bf16-against-f32 error
(the loss's: the root mean square of JAX's over the file's six seeds), as
chip_smoke.py holds the card's kernels to it.
"""

import importlib.util
import os

import numpy as np
import pytest

from torch_port_threads import one_torch_thread  # noqa: F401

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "make_torch_port_halo_bf16_golden.py")


@pytest.fixture(scope="module")
def golden():
    spec = importlib.util.spec_from_file_location("make_torch_port_halo_bf16_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(mod.GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    return mod, mod.vit_golden(), g, mod.port_model(int(g["seed"]), "cpu")


def test_golden_holds_a_bf16_gap(golden):
    """The stored bf16 values are not the f32 ones: the limits mean
    something."""
    mod, _, g, _ = golden
    assert np.abs(g["logits_bf16_layer"] - g["logits_f32"]).max() > 1e-3
    assert g["loss_bf16"] != g["loss_f32"] and mod.loss_gap(g) > 1e-4
    assert len(g["gap_seeds"]) == len(g["loss_bf16_seeds"]) == 6
    assert g["logits_f32"].shape == (2, 1000) and len(g["keys"]) == len(g["norms_bf16"])
    for k in mod.FULL_KEYS:
        assert np.abs(g[f"grad_bf16.{k}"] - g[f"grad_f32.{k}"]).max() > 0, k


def test_port_logits_meet_golden_on_cpu(golden):
    mod, vit, g, model = golden
    ours = mod.port_logits(int(g["seed"]), "cpu", 2, model)
    err, lim = vit.check_logits(ours, g, "layer")
    assert err <= lim


def test_port_train_step_meets_golden_on_cpu(golden):
    mod, vit, g, model = golden
    ours = mod.port_train(int(g["seed"]), "cpu", 2, model)
    checks = vit.check_train(ours, g, mod.FULL_KEYS, mod.loss_gap(g))
    assert set(checks) >= {"loss", "projections", "norms", *mod.FULL_KEYS}
