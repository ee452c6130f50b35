"""DINO DeiT-S/16 at full width and depth, one step at its conf's default
precision, bf16, against stored JAX values.

tests/data/dino_deit_s16_bf16_port_golden.npz
(scripts/make_torch_port_dino_bf16_golden.py) holds the JAX package's DINO
step at bf16 (B1 with the locals' block mask in Pallas interpret mode, under
the 'layer' force) and at f32 on make_torch_port_dino_golden.py's seeded
setup: the loss, the gradient norm, per state_dict key the gradient's norm
and projection, both nets' outputs as per-crop norms and projections, the
loss's 54 cross-entropies, and the loss and the gradient norm of the same
two steps at six seeds.  The port's CPU path must land within 3 times
JAX's own bf16-against-f32 gap on each of those vectors (the gap at the
golden's seed) and on the two scalars (the root mean square of their gaps
over the six seeds): on its default dispatch (8 packed rows take the
einsum gate) and through B1's autograd Function ('layer' forced).  The
JAX recompute is the script's, not this test's.
"""

import importlib.util
import os

import numpy as np
import pytest

from vision_transformers_tpu_torch import ops
from torch_port_threads import one_torch_thread  # noqa: F401

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "make_torch_port_dino_bf16_golden.py")


@pytest.fixture(scope="module")
def golden():
    spec = importlib.util.spec_from_file_location("make_torch_port_dino_bf16_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(mod.GOLDEN) as f:
        return mod, {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def vectors(golden):
    """The gradients' seeded projection tensors, drawn once for both steps."""
    mod, g = golden
    return mod.f32_golden_module().projection_vectors(int(g["seed"]))


def test_golden_holds_a_bf16_gap(golden):
    """The stored bf16 step is not the f32 one, so each limit means
    something; the shapes are the golden setup's."""
    mod, g = golden
    assert g["student_norms_bf16"].shape == (30,) and g["teacher_norms_bf16"].shape == (6,)
    assert len(g["keys"]) == len(g["norms_bf16"]) == len(g["projections_f32"])
    for k in mod.SCALARS + mod.VECTORS:
        assert mod.rel(g[f"{k}_bf16"], g[f"{k}_f32"]) > 0, k
    assert g["gap_seeds"][0] == g["seed"] and len(set(g["gap_seeds"])) == 6
    for k in mod.SCALARS:  # the golden's seed leads the scalars' seeds
        assert g[f"{k}_bf16_seeds"][0] == g[f"{k}_bf16"] and g[f"{k}_f32_seeds"][0] == g[f"{k}_f32"]


@pytest.mark.parametrize("impl", [None, "layer"], ids=["default-einsum", "layer"])
def test_port_bf16_step_meets_golden_on_cpu(golden, vectors, impl):
    mod, g = golden
    ops.set_attention_impl(impl)
    try:
        ours = mod.port_bf16_step(int(g["seed"]), "cpu", vectors)
    finally:
        ops.set_attention_impl(None)
    errors = mod.check(ours, g)
    assert set(errors) == set(mod.VECTORS + mod.SCALARS)
    assert all(err <= lim for err, lim in errors.values())
