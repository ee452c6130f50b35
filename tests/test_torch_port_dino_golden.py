"""DINO DeiT-S/16 at full width and depth, one f32 step, against stored JAX
values.

tests/data/dino_deit_s16_port_golden.npz (scripts/make_torch_port_dino_golden.py)
holds a seed, the JAX package's DINO loss, the student's and the teacher's
outputs as per-crop norms and seeded projections, the global gradient norm,
and per state_dict key the gradient's norm and its projection on a seeded
normal tensor; weights, the 6 global and 24 local crops, the center and the
projection tensors are regenerated from the seed.  The JAX package must
still reproduce the file (about 40 s here), and the port's CPU path must
meet it: on its default dispatch (8 packed rows take the einsum gate) and
through B1's autograd Function ('layer' forced, the locals' block mask as
its bias).  Tolerance rtol 1e-4, a projection to 1e-4 of its tensor's norm
(or of the largest output row's): 12 f32 layers in another summation order.
"""

import importlib.util
import os

import numpy as np
import pytest

from vision_transformers_tpu_torch import ops
from torch_port_threads import one_torch_thread  # noqa: F401

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "make_torch_port_dino_golden.py")
RTOL = 1e-4


@pytest.fixture(scope="module")
def golden():
    spec = importlib.util.spec_from_file_location("make_torch_port_dino_golden", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(mod.GOLDEN) as f:
        return mod, {k: f[k] for k in f.files}


def assert_meets(ours, g, rtol):
    assert list(ours["keys"]) == list(g["keys"])
    np.testing.assert_allclose(ours["loss"], g["loss"], rtol=rtol)
    np.testing.assert_allclose(ours["grad_norm"], g["grad_norm"], rtol=rtol)
    np.testing.assert_allclose(ours["norms"], g["norms"], rtol=rtol)
    err = np.abs(ours["projections"] - g["projections"])
    assert (err <= rtol * g["norms"] + 1e-7).all(), \
        list(g["keys"])[int(np.argmax(err / g["norms"]))]
    for net in ("student", "teacher"):
        norms = g[f"{net}_norms"]
        np.testing.assert_allclose(ours[f"{net}_norms"], norms, rtol=rtol)
        np.testing.assert_allclose(ours[f"{net}_projections"], g[f"{net}_projections"],
                                   rtol=0, atol=rtol * float(np.abs(
                                       g[f"{net}_projections"]).max()))
    assert g["student_norms"].shape == (30,) and g["teacher_norms"].shape == (6,)


def test_jax_package_reproduces_golden(golden):
    mod, g = golden
    assert_meets(mod.jax_dino_step(int(g["seed"])), g, 1e-5)


@pytest.mark.parametrize("impl", [None, "layer"], ids=["default-einsum", "layer"])
def test_port_meets_golden_on_cpu(golden, impl):
    mod, g = golden
    ops.set_attention_impl(impl)
    try:
        ours = mod.port_dino_step(int(g["seed"]), "cpu")
    finally:
        ops.set_attention_impl(None)
    assert_meets(ours, g, RTOL)
