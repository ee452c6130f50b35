#!/usr/bin/env python
"""Write tests/data/halo_s_bf16_port_golden.npz: the JAX package's Halo-S at
256 (tests/data/halo_s_port.conf: depths 2/2/6/2, dims 96-768, window 8,
halo 2) at its default precision, bf16, beside the same model in f32, for
seeded weights and two seeded images:

- logits [2, 1000]: bf16 on the whole Halo layer ('layer', under
  forward_only, its Pallas kernel in interpret mode), f32 on the CPU
  einsum path;
- one train step (the mix loss, label smoothing 0.1, drop_path 0) on the
  seeded batch: bf16 on 'layer' (the Pallas kernel's forward and backward
  in interpret mode, the bias's gradient into each layer's
  relative-position table), f32 on the einsum path — the loss, per
  state_dict key the gradient's norm and its projection on a seeded normal
  tensor, and the full gradients of ``FULL_KEYS`` (a relative-position
  table of each stage among them).

The limits are scripts/make_torch_port_bf16_golden.py's (its functions
check the port against this file too): the port's values within
``GAP_FACTOR`` times JAX's own bf16-against-f32 gap, the loss's gap the
root mean square of JAX's over the train steps of ``--gap-seeds`` seeds.
chip_smoke.py checks the card's bf16 port against the file,
tests/test_torch_port_halo_bf16_golden.py the port's CPU path.  ``--port
cpu|cuda`` runs no JAX: it prints the port's loss at each stored seed
beside JAX's, on the port's default dispatch ('layer').

    JAX_PLATFORMS=cpu python scripts/make_torch_port_halo_bf16_golden.py [--seed 0]
    python scripts/make_torch_port_halo_bf16_golden.py --port cuda
"""

import argparse
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "halo_s_bf16_port_golden.npz")
CONF = os.path.join(ROOT, "tests", "data", "halo_s_port.conf")
SIZE = 256
N_IMAGES = 2
# small gradients stored whole: one relative-position table a stage, the
# norms and biases of both ends
FULL_KEYS = ("block1.1.attn.rel_pos.weight", "block2.1.attn.rel_pos.weight",
             "block3.1.attn.rel_pos.weight", "block4.1.attn.rel_pos.weight",
             "block1.1.norm_attn.weight", "final_linear.2.weight", "classifier.2.bias",
             "block1.0.linear.bias")


def vit_golden():
    """scripts/make_torch_port_bf16_golden.py: the checks and the stored
    values' layout."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_bf16_golden", os.path.join(ROOT, "scripts",
                                                    "make_torch_port_bf16_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GAP_FACTOR = vit_golden().GAP_FACTOR


def jax_side(seed: int) -> dict:
    """The JAX package's values (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_tpu import ops as kernel_ops
    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.data import ops
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.config.schema import \
        load_config as port_load_config
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_images,
                                                             seeded_state_dict,
                                                             seeded_train_batch,
                                                             state_dict_from_flax)

    arch = load_config(CONF).arch
    variables = convert_variables(arch, seeded_state_dict(port_load_config(CONF).arch, seed),
                                  SIZE)
    images = ops.normalize(jnp.asarray(seeded_images(seed, N_IMAGES, SIZE), jnp.float32))
    batch = jax.tree.map(jnp.asarray, seeded_train_batch(seed, N_IMAGES, SIZE, arch.n_class))
    out = {}
    for name, dtype, impl in (("bf16_layer", jnp.bfloat16, "layer"),
                              ("f32", jnp.float32, "einsum")):
        model = arch.make(dtype=dtype)
        kernel_ops.set_attention_impl(impl, interpret=impl != "einsum")
        try:
            with kernel_ops.forward_only():
                out[f"logits_{name}"] = np.asarray(
                    jax.jit(model.apply)(variables, images), np.float32)
        finally:
            kernel_ops.set_attention_impl(None)
    steps = {name: train_step(arch.make(dtype=dtype, drop_path=0.0), impl)
             for name, dtype, impl in (("bf16", jnp.bfloat16, "layer"),
                                       ("f32", jnp.float32, "einsum"))}
    for name, step in steps.items():
        loss, grads = step(variables["params"], batch)
        sd = state_dict_from_flax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads))
        out.update(vit_golden().train_values(name, float(loss), sd, seed, grad_projections,
                                             FULL_KEYS))
    out["steps"] = steps
    return out


def train_step(model, impl):
    """(params, batch) → (the mix loss, its gradients) of ``model`` on
    ``impl`` (the Pallas kernels interpreted), jitted once."""
    import jax

    from vision_transformers_tpu import ops as kernel_ops
    from vision_transformers_tpu.train import loss as L

    def f(p, b):
        logits = model.apply({"params": p}, b["image"], deterministic=False)
        return L.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)

    jitted = jax.jit(jax.value_and_grad(f))

    def step(params, batch):
        kernel_ops.set_attention_impl(impl, interpret=impl != "einsum")
        try:
            return jitted(params, batch)
        finally:
            kernel_ops.set_attention_impl(None)

    return step


def seed_losses(steps: dict, seed: int) -> dict:
    """{"bf16", "f32"}: JAX's loss of one train step at ``seed``."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.config.schema import \
        load_config as port_load_config
    from vision_transformers_tpu_torch.utils.weights import (seeded_state_dict,
                                                             seeded_train_batch)

    arch = load_config(CONF).arch
    params = convert_variables(arch, seeded_state_dict(port_load_config(CONF).arch, seed),
                               SIZE)["params"]
    batch = jax.tree.map(jnp.asarray, seeded_train_batch(seed, N_IMAGES, SIZE, arch.n_class))
    return {name: float(step(params, batch)[0]) for name, step in steps.items()}


def loss_gap(g: dict) -> float:
    """The root mean square over the stored seeds of JAX's bf16 loss less
    its f32 loss."""
    return float(np.sqrt(np.mean((g["loss_bf16_seeds"] - g["loss_f32_seeds"]) ** 2)))


# ---------------------------------------------------------------------------
# the port's side (no JAX)
# ---------------------------------------------------------------------------


def port_model(seed: int, device: str):
    """The port's Halo-S in bf16 with the seeded weights, on ``device``;
    DropPath off (the golden's train step is the JAX model's at drop_path
    0)."""
    import dataclasses

    import torch

    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch

    arch = dataclasses.replace(load_config(CONF).arch, drop_path=0.0)
    model = arch.make(dtype=torch.bfloat16)
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    return model.to(device)


def port_logits(seed: int, device: str, rows: int, model) -> np.ndarray:
    """The port's bf16 logits of the two seeded images tiled to ``rows``
    rows under forward_only, on the default dispatch; the first two rows."""
    import torch

    from vision_transformers_tpu_torch import ops
    from vision_transformers_tpu_torch.predict import predict_batch
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    images = np.tile(seeded_images(seed, N_IMAGES, SIZE), (rows // N_IMAGES, 1, 1, 1))
    with torch.no_grad(), ops.forward_only():
        logits, _, _ = predict_batch(model.eval(), images, 5, device)
    return np.asarray(logits[:N_IMAGES], np.float32)


def port_train(seed: int, device: str, rows: int, model, full_keys=FULL_KEYS) -> dict:
    """One bf16 engine.train_step of the port on the seeded batch tiled to
    ``rows`` rows (the mean loss and gradients of the two images), lr 0, on
    the default dispatch."""
    import torch

    from vision_transformers_tpu_torch.train import engine
    from vision_transformers_tpu_torch.train.optim import AdamW
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_train_batch)

    batch = seeded_train_batch(seed, N_IMAGES, SIZE, 1000)
    b = {k: torch.from_numpy(np.concatenate([v] * (rows // N_IMAGES))).to(device)
         for k, v in batch.items()}
    b["image"] = b["image"].permute(0, 3, 1, 2)
    b["label1"], b["label2"] = b["label1"].long(), b["label2"].long()
    model.zero_grad(set_to_none=True)
    state = engine.create_train_state(model, AdamW(list(model.named_parameters()),
                                                   lambda s: 0.0))
    metrics = engine.train_step(state, b)
    grads = {k: p.grad.detach().float().cpu().numpy() for k, p in model.named_parameters()}
    return vit_golden().train_values("port", float(metrics["loss"]), grads, seed,
                                     grad_projections, full_keys)


def port_seeds(g: dict, device: str) -> None:
    """Print the port's bf16 loss less JAX's bf16 loss at each stored seed
    (the two images tiled to 64 rows on the card, as chip_smoke.py phase
    4hbf runs them; the two alone on the CPU) beside JAX's own bf16 less
    f32; the products set as the training entry point sets them."""
    from vision_transformers_tpu_torch.train.trainer import full_precision_products

    full_precision_products()
    rows = 64 if device == "cuda" else N_IMAGES
    for i, seed in enumerate(int(s) for s in g["gap_seeds"]):
        jax_bf16 = float(g["loss_bf16_seeds"][i])
        ours = port_train(seed, device, rows, port_model(seed, device), ())
        print(f"seed {seed}: JAX bf16 - f32 {jax_bf16 - float(g['loss_f32_seeds'][i]):+.4e}; "
              f"port ({rows} rows) - JAX bf16 {float(ours['loss_port']) - jax_bf16:+.4e}",
              flush=True)
    print(f"3 x rms gap: {GAP_FACTOR * loss_gap(g):.4e}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gap-seeds", type=int, default=6,
                        help="seeds (from --seed on) whose loss gaps scale the loss's limit")
    parser.add_argument("--port", choices=("cpu", "cuda"),
                        help="run the port at the stored seeds instead of writing the file")
    args = parser.parse_args()
    if args.port:
        with np.load(GOLDEN) as f:
            port_seeds({k: f[k] for k in f.files}, args.port)
        return
    g = jax_side(args.seed)
    steps = g.pop("steps")
    seeds = list(range(args.seed, args.seed + args.gap_seeds))
    losses = [{"bf16": float(g["loss_bf16"]), "f32": float(g["loss_f32"])}]
    for seed in seeds[1:]:
        losses.append(seed_losses(steps, seed))
        print(f"seed {seed}: loss bf16 - f32 {losses[-1]['bf16'] - losses[-1]['f32']:+.4e}",
              flush=True)
    g["gap_seeds"] = np.array(seeds)
    for name in ("bf16", "f32"):
        g[f"loss_{name}_seeds"] = np.array([v[name] for v in losses])
    np.savez_compressed(GOLDEN, seed=np.int64(args.seed), **g)
    gap = float(np.abs(g["logits_bf16_layer"] - g["logits_f32"]).max())
    print(f"wrote {GOLDEN}: logits bf16-vs-f32 gap {gap:.4e}, loss bf16 "
          f"{float(g['loss_bf16']):.6f} f32 {float(g['loss_f32']):.6f} (rms gap over "
          f"{len(seeds)} seeds {loss_gap(g):.4e}), {len(g['keys'])} tensors")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
