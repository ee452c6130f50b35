#!/usr/bin/env python
"""Write the Halo-S goldens of the port's tests and chip_smoke.py from the
JAX package on its CPU einsum path (tests/data/halo_s_port.conf: the JAX
HaloConfig defaults at 256 px, depth 12, f32; tests/test_fused_halo_layer.py
holds that path equal to the whole-layer kernel's):

- tests/data/halo_s_port_golden.npz: the seed and the logits [2, 1000] of
  two seeded uint8 images (scripts/make_torch_port_golden.py's recipe);
- tests/data/halo_s_port_train_golden.npz: one train-step gradient at
  drop_path 0 on two seeded images and labels, as the mix loss, the global
  gradient norm and per state_dict key the gradient's L2 norm and its
  projection on a seeded normal tensor (scripts/make_torch_port_train_golden.py's
  summary).

Weights, images, labels and projection tensors are regenerated from the
seed with numpy (vision_transformers_tpu_torch/utils/weights.py), so the
files hold summaries, not weights.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_halo_golden.py [--seed 0]
"""

import argparse
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "tests", "data", "halo_s_port.conf")
GOLDEN = os.path.join(ROOT, "tests", "data", "halo_s_port_golden.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data", "halo_s_port_train_golden.npz")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_logits(seed: int) -> np.ndarray:
    return _script("make_torch_port_golden").jax_logits(seed, CONF)


def jax_train_grads(seed: int) -> dict:
    return _script("make_torch_port_train_golden").jax_train_grads(seed, CONF)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    logits = jax_logits(args.seed)
    np.savez(GOLDEN, seed=np.int64(args.seed), logits=logits)
    print(f"wrote {GOLDEN}: logits {logits.shape}, max |logit| {np.abs(logits).max():.4f}")
    g = jax_train_grads(args.seed)
    np.savez(TRAIN_GOLDEN, seed=np.int64(args.seed), loss=np.float64(g["loss"]),
             grad_norm=np.float64(g["grad_norm"]), keys=np.array(g["keys"]),
             norms=g["norms"], projections=g["projections"])
    print(f"wrote {TRAIN_GOLDEN}: loss {g['loss']:.6f}, grad_norm {g['grad_norm']:.6f}, "
          f"{len(g['keys'])} tensors")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
