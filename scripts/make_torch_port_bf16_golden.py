#!/usr/bin/env python
"""Write tests/data/vit_s16_bf16_port_golden.npz: the JAX package's ViT-S/16
at 224 (configs/vit-s-16.conf, depth 12) at its default precision, bf16,
beside the same model in f32, for seeded weights and two seeded images:

- logits [2, 1000]: bf16 on the attention layer B1 ('layer') and on the
  whole layer B2 ('layer1', under forward_only), both Pallas kernels in
  interpret mode, and f32 on the CPU einsum path;
- one train step (the mix loss, label smoothing 0.1) on the seeded batch of
  tests/data/vit_s16_port_train_golden.npz: bf16 on 'layer' (B1's forward
  and backward in interpret mode), f32 on the einsum path — the loss, per
  state_dict key the gradient's norm and its projection on a seeded normal
  tensor (``utils/weights.grad_projections``), and the full gradients of a
  few small tensors (``FULL_KEYS``).

The bf16 error the port may show is JAX's own: ``check`` holds the port's
values to ``GAP_FACTOR`` times JAX's bf16-against-f32 gap, per quantity
(the logits and the loss as max |Δ|, the projections and each full
gradient as a relative Frobenius error).  chip_smoke.py checks the card's
bf16 port against the file, tests/test_torch_port_bf16_golden.py the port's
CPU path; both regenerate weights, images and batch from the seed with
numpy (vision_transformers_tpu_torch/utils/weights.py).

    JAX_PLATFORMS=cpu python scripts/make_torch_port_bf16_golden.py [--seed 0]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "vit_s16_bf16_port_golden.npz")
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")
N_IMAGES = 2
GAP_FACTOR = 3.0
# small gradients stored whole, bf16 and f32
FULL_KEYS = ("cls_token", "norm.weight", "norm.bias", "layers.0.norm_attn.weight",
             "layers.11.attn.linear.bias", "patch_embedding.linear.bias")


def jax_side(seed: int) -> dict:
    """The JAX package's values (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_tpu import ops as kernel_ops
    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.data import ops
    from vision_transformers_tpu.train import loss as L
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.config.schema import \
        load_config as port_load_config
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_images,
                                                             seeded_state_dict,
                                                             seeded_train_batch,
                                                             state_dict_from_flax)

    arch = load_config(CONF).arch
    size = arch.image_size
    variables = convert_variables(arch, seeded_state_dict(port_load_config(CONF).arch, seed),
                                  size)
    images = ops.normalize(jnp.asarray(seeded_images(seed, N_IMAGES, size), jnp.float32))
    batch = jax.tree.map(jnp.asarray, seeded_train_batch(seed, N_IMAGES, size, arch.n_class))
    out = {}

    def forced(impl):
        kernel_ops.set_attention_impl(impl, interpret=impl not in (None, "einsum"))

    for name, dtype, impl in (("bf16_layer", jnp.bfloat16, "layer"),
                              ("bf16_layer1", jnp.bfloat16, "layer1"),
                              ("f32", jnp.float32, "einsum")):
        model = arch.make(dtype=dtype)
        forced(impl)
        try:
            with kernel_ops.forward_only():
                out[f"logits_{name}"] = np.asarray(
                    jax.jit(model.apply)(variables, images), np.float32)
        finally:
            forced(None)
    for name, dtype, impl in (("bf16", jnp.bfloat16, "layer"), ("f32", jnp.float32, "einsum")):
        model = arch.make(dtype=dtype, drop_path=0.0)

        def f(p):
            logits = model.apply({"params": p}, batch["image"], deterministic=False)
            return L.mix_loss(logits, batch["label1"], batch["label2"], batch["ratio"],
                              eps=0.1)

        forced(impl)
        try:
            loss, grads = jax.jit(jax.value_and_grad(f))(variables["params"])
        finally:
            forced(None)
        sd = state_dict_from_flax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads))
        out.update(train_values(name, float(loss), sd, seed, grad_projections))
    return out


def train_values(name, loss, grads, seed, grad_projections, full_keys=FULL_KEYS) -> dict:
    """The stored values of one train step: loss, keys, norms, projections,
    the ``full_keys`` gradients."""
    keys = sorted(grads)
    proj = grad_projections(grads, seed)
    out = {f"loss_{name}": np.float64(loss), "keys": np.array(keys),
           f"norms_{name}": np.array([np.linalg.norm(np.asarray(grads[k], np.float64))
                                      for k in keys]),
           f"projections_{name}": np.array([proj[k] for k in keys])}
    for k in full_keys:
        out[f"grad_{name}.{k}"] = np.asarray(grads[k], np.float32)
    return out


def port_logits(seed: int, device: str, rows: int, impl: str, model=None,
                conf: str = CONF) -> np.ndarray:
    """The port's bf16 logits of the two seeded images tiled to ``rows``
    rows under forward_only, ``impl`` forced ('layer': B1, 'layer1': B2);
    the first two rows (``conf``: the model, 224 px)."""
    import torch

    from vision_transformers_tpu_torch import ops
    from vision_transformers_tpu_torch.predict import predict_batch
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    model = model if model is not None else port_model(seed, device, conf)
    images = np.tile(seeded_images(seed, N_IMAGES, 224), (rows // N_IMAGES, 1, 1, 1))
    ops.set_attention_impl(impl)
    try:
        with torch.no_grad(), ops.forward_only():
            logits, _, _ = predict_batch(model.eval(), images, 5, device)
    finally:
        ops.set_attention_impl(None)
    return np.asarray(logits[:N_IMAGES], np.float32)


def port_model(seed: int, device: str, conf: str = CONF):
    """The port's model of ``conf`` (ViT-S/16) in bf16 with the seeded
    weights, on ``device``; DropPath off (the golden's train step is the JAX
    model's at drop_path 0)."""
    import dataclasses

    import torch

    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch

    arch = dataclasses.replace(load_config(conf).arch, drop_path=0.0)
    model = arch.make(dtype=torch.bfloat16)
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    return model.to(device)


def port_train(seed: int, device: str, rows: int, impl=None, model=None, conf: str = CONF,
               full_keys=FULL_KEYS) -> dict:
    """One bf16 engine.train_step of the port on the seeded batch tiled to
    ``rows`` rows (the mean loss and gradients of the two images), lr 0."""
    import torch

    from vision_transformers_tpu_torch import ops
    from vision_transformers_tpu_torch.train import engine
    from vision_transformers_tpu_torch.train.optim import AdamW
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_train_batch)

    model = model if model is not None else port_model(seed, device, conf)
    batch = seeded_train_batch(seed, N_IMAGES, 224, 1000)
    b = {k: torch.from_numpy(np.concatenate([v] * (rows // N_IMAGES))).to(device)
         for k, v in batch.items()}
    b["image"] = b["image"].permute(0, 3, 1, 2)
    b["label1"], b["label2"] = b["label1"].long(), b["label2"].long()
    state = engine.create_train_state(model, AdamW(list(model.named_parameters()),
                                                   lambda s: 0.0))
    ops.set_attention_impl(impl)
    try:
        metrics = engine.train_step(state, b)
    finally:
        ops.set_attention_impl(None)
    grads = {k: p.grad.detach().float().cpu().numpy() for k, p in model.named_parameters()}
    return train_values("port", float(metrics["loss"]), grads, seed, grad_projections,
                        full_keys)


def rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def check_logits(ours: np.ndarray, g: dict, impl: str) -> tuple:
    """(error, limit) of the port's bf16 logits on ``impl`` against JAX's."""
    bf = g[f"logits_bf16_{impl}"]
    gap = float(np.abs(bf - g["logits_f32"]).max())
    err = float(np.abs(ours - bf).max())
    if not (np.isfinite(ours).all() and ours.shape == bf.shape and err <= GAP_FACTOR * gap):
        raise AssertionError(f"bf16 logits on {impl}: max|port - JAX bf16| {err:.4e} > "
                             f"{GAP_FACTOR} x JAX's bf16 gap {gap:.4e}")
    return err, GAP_FACTOR * gap


def check_train(ours: dict, g: dict, full_keys=FULL_KEYS, loss_gap=None) -> dict:
    """{quantity: (error, limit)} of the port's bf16 train step against
    JAX's: the loss, the projections (relative Frobenius over all keys) and
    each ``full_keys`` gradient; the loss's gap ``loss_gap`` where given
    (JAX's over several seeds), else JAX's at the golden's seed."""
    if list(ours["keys"]) != list(g["keys"]):
        raise AssertionError("the port's state_dict keys are not the golden's")
    if loss_gap is None:
        loss_gap = abs(float(g["loss_bf16"]) - float(g["loss_f32"]))
    out = {"loss": (abs(float(ours["loss_port"]) - float(g["loss_bf16"])),
                    GAP_FACTOR * loss_gap),
           "projections": (rel(ours["projections_port"], g["projections_bf16"]),
                           GAP_FACTOR * rel(g["projections_bf16"], g["projections_f32"])),
           "norms": (rel(ours["norms_port"], g["norms_bf16"]),
                     GAP_FACTOR * rel(g["norms_bf16"], g["norms_f32"]))}
    for k in full_keys:
        out[k] = (rel(ours[f"grad_port.{k}"], g[f"grad_bf16.{k}"]),
                  GAP_FACTOR * rel(g[f"grad_bf16.{k}"], g[f"grad_f32.{k}"]))
    bad = {k: v for k, v in out.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"bf16 train step beyond {GAP_FACTOR} x JAX's bf16 gap: {bad}")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    g = jax_side(args.seed)
    np.savez_compressed(GOLDEN, seed=np.int64(args.seed), **g)
    gap = float(np.abs(g["logits_bf16_layer"] - g["logits_f32"]).max())
    print(f"wrote {GOLDEN}: logits bf16-vs-f32 gap {gap:.4e}, loss bf16 "
          f"{float(g['loss_bf16']):.6f} f32 {float(g['loss_f32']):.6f}, "
          f"{len(g['keys'])} tensors")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
