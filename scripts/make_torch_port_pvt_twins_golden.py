#!/usr/bin/env python
"""Write the PVT-S and Twins-SVT-S goldens of the port's tests and
chip_smoke.py from the JAX package on its CPU einsum path (the default
arms of both reduced-kv sites and of Twins' local attention;
tests/test_pvt_twins_halo.py holds the fused paths equal to them):

- tests/data/{pvt_s,twins_svt_s}_port_golden.npz: the seed and the logits
  [2, 1000] of two seeded uint8 images at 224 px
  (scripts/make_torch_port_golden.py's recipe);
- tests/data/{pvt_s,twins_svt_s}_port_train_golden.npz: one train-step
  gradient at drop_path 0 on two seeded images and labels, as the mix
  loss, the global gradient norm and per state_dict key the gradient's L2
  norm and its projection on a seeded normal tensor
  (scripts/make_torch_port_train_golden.py's summary).

The models are tests/data/pvt_s_port.conf and twins_svt_s_port.conf (the
JAX package's registered defaults, full width and depth, f32).  Weights,
images, labels and projection tensors are regenerated from the seed with
numpy (vision_transformers_tpu_torch/utils/weights.py), so the files hold
summaries, not weights.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_pvt_twins_golden.py [--seed 0]
"""

import argparse
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
MODELS = {  # name → (conf, logits golden, train-step golden)
    name: (os.path.join(DATA, f"{stem}_port.conf"),
           os.path.join(DATA, f"{stem}_port_golden.npz"),
           os.path.join(DATA, f"{stem}_port_train_golden.npz"))
    for name, stem in (("PVT-S", "pvt_s"), ("Twins-SVT-S", "twins_svt_s"))}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_logits(seed: int, conf: str) -> np.ndarray:
    return _script("make_torch_port_golden").jax_logits(seed, conf)


def jax_train_grads(seed: int, conf: str) -> dict:
    return _script("make_torch_port_train_golden").jax_train_grads(seed, conf)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    for name, (conf, golden, train_golden) in MODELS.items():
        logits = jax_logits(args.seed, conf)
        np.savez(golden, seed=np.int64(args.seed), logits=logits)
        print(f"{name}: wrote {golden}: logits {logits.shape}, max |logit| "
              f"{np.abs(logits).max():.4f}")
        g = jax_train_grads(args.seed, conf)
        np.savez(train_golden, seed=np.int64(args.seed), loss=np.float64(g["loss"]),
                 grad_norm=np.float64(g["grad_norm"]), keys=np.array(g["keys"]),
                 norms=g["norms"], projections=g["projections"])
        print(f"{name}: wrote {train_golden}: loss {g['loss']:.6f}, grad_norm "
              f"{g['grad_norm']:.6f}, {len(g['keys'])} tensors")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
