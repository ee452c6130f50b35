"""ViT at the JAX package's default precision, bf16, against the JAX package
at dtype bfloat16: a tiny ViT's logits on the 'layer' and 'layer1' paths,
one train step (loss and the f32 parameters' gradients), the trainer CLI at
the confs' default precision, and what still refuses bf16.

Both packages load one numpy-seeded reference-layout state_dict (the JAX
side through its ``convert_state_dict``).  The JAX side runs B1 and B2 in
Pallas interpret mode for the logits; its train step takes its default
(einsum) path at this size, against the port's default path and the
port's B1 forced ('layer').  The limit is JAX's own bf16 error from the
same inputs: max|port bf16 − JAX bf16| ≤ 3 · max|JAX bf16 − JAX f32| for
the logits and the loss, and per gradient the relative Frobenius error
within 3 × JAX's own.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_transformers_tpu import ops as jax_ops
from vision_transformers_tpu.models.vit import ViTConfig as JaxViTConfig
from vision_transformers_tpu.train import loss as jax_loss
from vision_transformers_tpu.utils.torch_convert import convert_state_dict
from vision_transformers_tpu_torch import ops, train
from vision_transformers_tpu_torch.config.schema import load_config
from vision_transformers_tpu_torch.models.vit import ViTConfig
from vision_transformers_tpu_torch.train import engine
from vision_transformers_tpu_torch.train.trainer import check_supported, compute_dtype
from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                         state_dict_from_flax, to_torch)
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GAP_FACTOR = 3.0
ARCH = dict(image_size=32, window_size=8, depth=2, dim=64, n_head=2,
            dim_ff=128, n_class=10)
TINY = ["training.epoch=1", "training.dataloader.batch_size=8",
        "data_backend=synthetic", "arch.depth=2", "arch.dim=64", "arch.n_head=2",
        "arch.dim_ff=128", "arch.image_size=32", "arch.window_size=8",
        "arch.n_class=10", "training.train_size=32", "training.valid_size=32",
        "training.ema=0.99", "n_device=1"]


@pytest.fixture(scope="module")
def weights():
    return seeded_state_dict(ViTConfig(**ARCH), seed=3)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng([5, 9])
    n = 4
    return {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            "label1": rng.integers(0, ARCH["n_class"], n).astype(np.int32),
            "label2": rng.integers(0, ARCH["n_class"], n).astype(np.int32),
            "ratio": rng.uniform(0.2, 0.8, n).astype(np.float32)}


def jax_model(sd, dtype):
    cfg = JaxViTConfig(**ARCH)
    return cfg.make(dtype=dtype), jax.tree.map(jnp.asarray, convert_state_dict(cfg, sd))


def port_model(sd, dtype):
    model = ViTConfig(**ARCH).make(dtype=dtype)
    model.load_state_dict(to_torch(sd), strict=True)
    return model


def within_gap(name, ours, bf, f32):
    gap = float(np.abs(bf - f32).max())
    err = float(np.abs(ours - bf).max())
    assert 0 < gap and err <= GAP_FACTOR * gap, \
        f"{name}: {err:.3e} against {GAP_FACTOR} x {gap:.3e}"


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# logits on B1 ('layer') and B2 ('layer1')
# ---------------------------------------------------------------------------


def jax_logits(sd, x, dtype, impl):
    model, variables = jax_model(sd, dtype)
    jax_ops.set_attention_impl(impl, interpret=impl is not None)
    try:
        with jax_ops.forward_only():
            return np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    finally:
        jax_ops.set_attention_impl(None)


@pytest.mark.parametrize("impl", ["layer", "layer1"])
def test_logits_within_jax_bf16_gap(weights, batch, impl):
    x = batch["image"]
    ops.set_attention_impl(impl)
    try:
        with torch.no_grad(), ops.forward_only():
            model = port_model(weights, torch.bfloat16).eval()
            launches = ops.fused_layer.LAUNCHES, ops.fused_layer1.LAUNCHES
            ours = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    finally:
        ops.set_attention_impl(None)
    assert ours.dtype == torch.float32  # the head computes in f32
    # the CPU runs the plain versions: no kernel launch counted
    assert (ops.fused_layer.LAUNCHES, ops.fused_layer1.LAUNCHES) == launches
    within_gap("logits", ours.numpy(), jax_logits(weights, x, jnp.bfloat16, impl),
               jax_logits(weights, x, jnp.float32, None))


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


def jax_loss_and_grads(sd, batch, dtype):
    model, variables = jax_model(sd, dtype)

    def f(p):
        logits = model.apply({"params": p}, batch["image"], deterministic=False)
        return jax_loss.mix_loss(logits, batch["label1"], batch["label2"], batch["ratio"],
                                 eps=0.1)

    loss, grads = jax.jit(jax.value_and_grad(f))(variables["params"])
    return float(loss), state_dict_from_flax(jax.tree.map(np.asarray, grads))


def port_step(sd, batch, dtype, impl=None):
    """(loss, {key: f32 gradient}) of one engine.train_step at lr 0."""
    from vision_transformers_tpu_torch.train.optim import AdamW

    model = port_model(sd, dtype)
    state = engine.create_train_state(model, AdamW(list(model.named_parameters()), lambda s: 0.0))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b["image"] = b["image"].permute(0, 3, 1, 2)
    b["label1"], b["label2"] = b["label1"].long(), b["label2"].long()
    ops.set_attention_impl(impl)
    try:
        metrics = engine.train_step(state, b)
    finally:
        ops.set_attention_impl(None)
    return float(metrics["loss"]), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_step(weights, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax_loss_and_grads(weights, jb, jnp.bfloat16), jax_loss_and_grads(weights, jb,
                                                                             jnp.float32)


@pytest.mark.parametrize("impl", [None, "layer"], ids=["default-einsum", "layer"])
def test_train_step_within_jax_bf16_gap(weights, batch, jax_step, impl):
    (loss_bf, g_bf), (loss_f32, g_f32) = jax_step
    loss, grads = port_step(weights, batch, torch.bfloat16, impl)
    assert abs(loss - loss_bf) <= GAP_FACTOR * abs(loss_bf - loss_f32), (loss, loss_bf,
                                                                         loss_f32)
    assert sorted(grads) == sorted(g_bf)
    for k, g in grads.items():
        assert g.dtype == torch.float32, k  # the parameters' gradients stay f32
        gap = rel(g_bf[k], g_f32[k])
        assert gap > 0, k
        assert rel(g.numpy(), g_bf[k]) <= GAP_FACTOR * gap, \
            f"{k}: {rel(g.numpy(), g_bf[k]):.3e} against {GAP_FACTOR} x {gap:.3e}"
    # bf16 ran: the port's own f32 gradients differ from its bf16 ones
    _, f32 = port_step(weights, batch, torch.float32, impl)
    assert any(not torch.allclose(grads[k], f32[k], rtol=1e-4, atol=1e-6) for k in grads)


# ---------------------------------------------------------------------------
# the trainer at the confs' default precision, and what refuses bf16
# ---------------------------------------------------------------------------


def test_trainer_cli_runs_vit_at_the_default_precision(tmp_path):
    conf = load_config(os.path.join(ROOT, "configs", "vit-s-16.conf"), TINY)
    assert conf.precision == "bf16" and compute_dtype(conf) == torch.bfloat16
    metrics = train.main(["--conf", os.path.join(ROOT, "configs", "vit-s-16.conf"),
                          "--device", "cpu", *TINY,
                          f"checker.storage=[{{type: local, path: {tmp_path}}}]"])
    assert all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss", "prec1"))
    obj = torch.load(tmp_path / "epoch-001.pt", map_location="cpu", weights_only=False)
    for key in ("model", "ema"):
        assert all(v.dtype == torch.float32 for v in obj[key].values()), key
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


@pytest.mark.parametrize("conf", ["swin-transformer-s.conf", "dino_deit-s-16.conf"])
def test_other_arch_types_refuse_bf16(conf):
    """Swin-S and DINO, ported at bf16 since, take their confs' default
    precision, bf16, and f32; PVT-S (tests/data/pvt_s_port.conf, bf16 by
    the schema's default) still refuses bf16 and runs at f32."""
    c = load_config(os.path.join(ROOT, "configs", conf))
    assert c.precision == "bf16"
    check_supported(c)
    c.precision = "f32"
    check_supported(c)
    pvt = load_config(os.path.join(ROOT, "tests", "data", "pvt_s_port.conf"))
    assert pvt.precision == "bf16"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(pvt)
    pvt.precision = "f32"
    check_supported(pvt)


def test_fp16_maps_to_bf16():
    c = load_config(os.path.join(ROOT, "configs", "vit-s-16.conf"), ["precision=f32",
                                                                      "fp16=true"])
    assert compute_dtype(c) == torch.bfloat16
    check_supported(c)
