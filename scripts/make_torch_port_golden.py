#!/usr/bin/env python
"""Write tests/data/vit_s16_port_golden.npz: the JAX package's float32 logits
for ViT-S/16 at 224 (configs/vit-s-16.conf, depth 12) on its CPU einsum
path, for two seeded uint8 images and seeded weights.

Only the seed and the logits [2, 1000] are stored.  The weights and the
images are regenerated from the seed with numpy
(vision_transformers_tpu_torch/utils/weights.py) by this script, by
tests/test_torch_port_golden.py and by chip_smoke.py alike.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden.py [--seed 0]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "vit_s16_port_golden.npz")
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")
N_IMAGES = 2


def image_size(conf) -> int:
    """The model's image size, or the conf's eval size for a model that has
    none (Twins-SVT)."""
    size = getattr(conf.arch, "image_size", None) or conf.training.valid_size
    return size if isinstance(size, int) else size[0]


def jax_logits(seed: int, conf: str = CONF) -> np.ndarray:
    """The JAX package's logits for the seeded weights and images of the
    model in ``conf``."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_tpu import ops as kernel_ops
    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.data import ops
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.config.schema import \
        load_config as port_load_config
    from vision_transformers_tpu_torch.utils.weights import (seeded_images,
                                                             seeded_state_dict)

    full = load_config(conf)
    arch = full.arch
    sd = seeded_state_dict(port_load_config(conf).arch, seed)
    size = image_size(full)
    variables = convert_variables(arch, sd, size)
    images = seeded_images(seed, N_IMAGES, size)
    model = arch.make()  # f32, as predict.py

    @jax.jit
    def forward(x):
        with kernel_ops.forward_only():
            return model.apply(variables, ops.normalize(x.astype(jnp.float32)))

    return np.asarray(forward(jnp.asarray(images)), np.float32)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    logits = jax_logits(args.seed)
    np.savez(GOLDEN, seed=np.int64(args.seed), logits=logits)
    print(f"wrote {GOLDEN}: logits {logits.shape}, max |logit| "
          f"{np.abs(logits).max():.4f}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
