#!/usr/bin/env python
"""Write tests/data/vit_s16_port_train_golden.npz: one f32 train-step
gradient of the JAX package for ViT-S/16 at 224 (configs/vit-s-16.conf,
depth 12, drop_path 0) on its CPU einsum path, for two seeded images and
labels and seeded weights.

Stored, besides the seed: the mix loss (label smoothing 0.1), the global
gradient norm, and for every state_dict key the gradient's L2 norm and its
projection on a seeded normal tensor (``utils/weights.grad_projections``).
Weights, images, labels and the projection tensors are regenerated from the
seed with numpy (vision_transformers_tpu_torch/utils/weights.py) by this
script, by tests/test_torch_port_train_golden.py and by chip_smoke.py.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_train_golden.py [--seed 0]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "vit_s16_port_train_golden.npz")
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")
N_IMAGES = 2


def image_size(conf) -> int:
    """The model's image size, or the conf's training size for a model that
    has none (Twins-SVT)."""
    size = getattr(conf.arch, "image_size", None) or conf.training.train_size
    return size if isinstance(size, int) else size[0]


def jax_train_grads(seed: int, conf: str = CONF) -> dict:
    """{"loss", "grad_norm", "keys", "norms", "projections"} from the JAX
    package for the seeded weights and batch of the model in ``conf``."""
    import jax
    import jax.numpy as jnp
    import optax

    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.train import loss as L
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.config.schema import \
        load_config as port_load_config
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_state_dict,
                                                             seeded_train_batch,
                                                             state_dict_from_flax)

    full = load_config(conf)
    arch = full.arch
    size = image_size(full)
    params = convert_variables(arch, seeded_state_dict(port_load_config(conf).arch, seed),
                               size)["params"]
    batch = seeded_train_batch(seed, N_IMAGES, size, arch.n_class)
    model = arch.make(drop_path=0.0)  # f32

    @jax.jit
    def loss_and_grads(p, b):
        def f(p):
            logits = model.apply({"params": p}, b["image"], deterministic=False)
            return L.mix_loss(logits, b["label1"], b["label2"], b["ratio"], eps=0.1)
        return jax.value_and_grad(f)(p)

    loss, grads = loss_and_grads(params, jax.tree.map(jnp.asarray, batch))
    grad_norm = float(optax.global_norm(grads))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    keys = sorted(sd)
    proj = grad_projections(sd, seed)
    return {"loss": float(loss), "grad_norm": grad_norm, "keys": keys,
            "norms": np.array([np.linalg.norm(sd[k].astype(np.float64)) for k in keys]),
            "projections": np.array([proj[k] for k in keys])}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    g = jax_train_grads(args.seed)
    np.savez(GOLDEN, seed=np.int64(args.seed), loss=np.float64(g["loss"]),
             grad_norm=np.float64(g["grad_norm"]), keys=np.array(g["keys"]),
             norms=g["norms"], projections=g["projections"])
    print(f"wrote {GOLDEN}: loss {g['loss']:.6f}, grad_norm {g['grad_norm']:.6f}, "
          f"{len(g['keys'])} tensors")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
