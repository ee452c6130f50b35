#!/usr/bin/env python
"""Write tests/data/dino_deit_s16_bf16_port_golden.npz: one DINO step of the
JAX package for DeiT-S/16 (configs/dino_deit-s-16.conf, depth 12, the head
to 65,536) at its conf's default precision, bf16, beside the same step in
f32, on make_torch_port_dino_golden.py's setup: 3 seeded images (6 global
crops at 224, 24 local crops at 96, packed 3 to a row: 8 rows of 111
tokens under the block-diagonal mask), seeded student, teacher and center,
``student_drop_path`` 0 and the teacher temperature 0.04.

- bf16: both nets at dtype bfloat16 under the 'layer' force, B1 in every
  layer with its Pallas kernel in interpret mode (the student's globals
  and, with the mask, its packed locals, forward and backward; the
  teacher's globals, forward);
- f32: the same step on the JAX package's CPU dispatch (einsum), as the f32
  golden holds it.

Stored for each, as ``<quantity>_bf16`` and ``<quantity>_f32``: the loss
and its 54 cross-entropies (one per teacher global, student crop and image:
their mean is the loss), the global gradient norm, per state_dict key the
gradient's norm and its projection on a seeded normal tensor, and the
student's [30, 65,536] and the teacher's [6, 65,536] outputs as per-crop
norms and seeded projections (make_torch_port_dino_golden.summary).  Also
``<scalar>_{bf16,f32}_seeds``: the loss and the gradient norm of the same
two steps at ``--gap-seeds`` seeds (the golden's seed first).

The bf16 error the port may show is JAX's own: :func:`check` holds each
vector of the port's values within ``GAP_FACTOR`` times JAX's
bf16-against-f32 gap at the golden's seed (relative Frobenius errors), and
each scalar within ``GAP_FACTOR`` times the root mean square of its gaps
over the seeds.  A scalar's gap at one seed is too few draws to scale a
limit by: the loss's cross-entropies move in six blocks, one per teacher
global and image (the sharp teacher's rounding shifts every student crop's
term against it alike), so the loss is the mean of about six draws of the
bf16 noise, and one seed's draw may sit near zero.  chip_smoke.py checks
the card's bf16 port against the file, tests/test_torch_port_dino_bf16_golden.py
the port's CPU path; both regenerate the inputs from the seed with numpy.
``--port cpu|cuda`` runs no JAX: it prints the port's scalars at each
stored seed beside JAX's, to see whether the port's scalars scatter about
JAX's or sit to one side.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_dino_bf16_golden.py [--seed 0] [--gap-seeds 6]
    python scripts/make_torch_port_dino_bf16_golden.py --port cuda
"""

import argparse
import functools
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "dino_deit_s16_bf16_port_golden.npz")
GAP_FACTOR = 3.0
SCALARS = ("loss", "grad_norm")
VECTORS = ("loss_terms", "norms", "projections", "student_norms", "student_projections",
           "teacher_norms", "teacher_projections")


@functools.lru_cache(maxsize=None)
def f32_golden_module():
    """scripts/make_torch_port_dino_golden.py: the setup, the summary and the
    port's step."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_dino_golden", os.path.join(ROOT, "scripts",
                                                    "make_torch_port_dino_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_bf16_step(seed: int) -> dict:
    """The JAX package's bf16 step under the 'layer' force, the Pallas
    kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_tpu import ops as jax_ops
    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.train import loss as L
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.utils.weights import state_dict_from_flax

    g = f32_golden_module()
    conf, sd_s, sd_t, crops, center = g.step_inputs(seed)
    arch = load_config(g.CONF).arch
    n_crop = len(crops)
    model = arch.make(dtype=jnp.bfloat16, drop_path=0.0)
    params = convert_variables(arch, sd_s, 224)["params"]
    teacher_params = convert_variables(arch, sd_t, 224)["params"]
    crops = [jnp.asarray(c) for c in crops]

    def step(p, tp, crops):
        with jax_ops.forward_only():
            t_out = model.apply({"params": tp}, crops[:2], deterministic=True)
        t_out = t_out.astype(jnp.float32)

        def f(p):
            s_out = model.apply({"params": p}, crops, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)})
            return L.dino_loss(s_out, t_out, jnp.asarray(center), g.TEACHER_TEMP,
                               n_crop), s_out
        (loss, s_out), grads = jax.value_and_grad(f, has_aux=True)(p)
        return loss, s_out, t_out, grads

    jax_ops.set_attention_impl("layer", interpret=True)
    try:
        loss, s_out, t_out, grads = jax.jit(step)(params, teacher_params, crops)
    finally:
        jax_ops.set_attention_impl(None)
    grads = state_dict_from_flax(jax.tree.map(lambda a: np.asarray(a, np.float32), grads))
    return g.summary(seed, loss, np.asarray(s_out, np.float32), np.asarray(t_out, np.float32),
                     grads)


def port_bf16_step(seed: int, device: str = "cpu", vectors=None) -> dict:
    """The port's bf16 step on ``device`` (its dispatch, or the caller's
    ``ops`` force); imports no JAX.  ``vectors``: the gradients' projection
    tensors, made once for several steps
    (make_torch_port_dino_golden.projection_vectors)."""
    import torch

    return f32_golden_module().port_dino_step(seed, device, torch.bfloat16, vectors)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def scalar_gaps(g: dict) -> dict:
    """{scalar: root mean square over the stored seeds of JAX's bf16 step
    less its f32 step}."""
    return {k: float(np.sqrt(np.mean((g[f"{k}_bf16_seeds"] - g[f"{k}_f32_seeds"]) ** 2)))
            for k in SCALARS}


def check(ours: dict, g: dict) -> dict:
    """{quantity: (error, limit)} of the port's bf16 step against JAX's bf16
    step: each vector's relative error against ``GAP_FACTOR`` times JAX's
    bf16-against-f32 gap at the golden's seed, each scalar's absolute error
    against ``GAP_FACTOR`` times :func:`scalar_gaps`; raises AssertionError
    when any is beyond its limit or not finite."""
    if list(ours["keys"]) != list(g["keys"]):
        raise AssertionError("the port's state_dict keys are not the golden's")
    out = {k: (rel(ours[k], g[f"{k}_bf16"]), GAP_FACTOR * rel(g[f"{k}_bf16"], g[f"{k}_f32"]))
           for k in VECTORS}
    out.update({k: (abs(float(ours[k]) - float(g[f"{k}_bf16"])), GAP_FACTOR * gap)
                for k, gap in scalar_gaps(g).items()})
    bad = {k: v for k, v in out.items() if not (np.isfinite(v[0]) and v[0] <= v[1])}
    if bad:
        raise AssertionError(f"DINO bf16 step beyond {GAP_FACTOR} x JAX's bf16 gap: {bad}")
    return out


def port_seeds(g: dict, device: str) -> None:
    """Print the port's loss and gradient norm at each stored seed, on its
    default dispatch and through B1 ('layer' forced), beside JAX's bf16 and
    f32 values; the products set as the training entry points set them."""
    from vision_transformers_tpu_torch import ops
    from vision_transformers_tpu_torch.train.trainer import full_precision_products

    full_precision_products()
    for i, seed in enumerate(int(s) for s in g["gap_seeds"]):
        jax_gaps = ", ".join(f"{k} {g[f'{k}_bf16_seeds'][i] - g[f'{k}_f32_seeds'][i]:+.4e}"
                             for k in SCALARS)
        print(f"seed {seed}: JAX bf16 - f32: {jax_gaps}", flush=True)
        for impl in (None, "layer"):
            ops.set_attention_impl(impl)
            try:
                ours = port_bf16_step(seed, device)
            finally:
                ops.set_attention_impl(None)
            print(f"seed {seed}: port ({impl or 'default'}) - JAX bf16: " + ", ".join(
                f"{k} {float(ours[k]) - g[f'{k}_bf16_seeds'][i]:+.4e}" for k in SCALARS),
                flush=True)
    print("3 x rms gap: " + ", ".join(f"{k} {GAP_FACTOR * v:.4e}"
                                       for k, v in scalar_gaps(g).items()))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gap-seeds", type=int, default=6,
                        help="seeds (from --seed on) whose scalar gaps scale the scalars' limits")
    parser.add_argument("--port", choices=("cpu", "cuda"),
                        help="run the port at the stored seeds instead of writing the file")
    args = parser.parse_args()
    if args.port:
        with np.load(GOLDEN) as f:
            port_seeds({k: f[k] for k in f.files}, args.port)
        return
    bf = jax_bf16_step(args.seed)
    f = f32_golden_module().jax_dino_step(args.seed)
    out = {"seed": np.int64(args.seed), "keys": np.array(bf["keys"])}
    for name, v in (("bf16", bf), ("f32", f)):
        out.update({f"{k}_{name}": np.float64(v[k]) for k in SCALARS})
        out.update({f"{k}_{name}": np.asarray(v[k]) for k in VECTORS})
    seeds = list(range(args.seed, args.seed + args.gap_seeds))
    scalars = {seeds[0]: (bf, f)}
    for seed in seeds[1:]:
        scalars[seed] = (jax_bf16_step(seed), f32_golden_module().jax_dino_step(seed))
        gaps = {k: scalars[seed][0][k] - scalars[seed][1][k] for k in SCALARS}
        print(f"seed {seed}: " + ", ".join(f"{k} bf16 - f32 {v:+.4e}" for k, v in gaps.items()),
              flush=True)
    out["gap_seeds"] = np.array(seeds)
    for i, name in enumerate(("bf16", "f32")):
        out.update({f"{k}_{name}_seeds": np.array([scalars[s][i][k] for s in seeds])
                    for k in SCALARS})
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: loss bf16 {bf['loss']:.6f} f32 {f['loss']:.6f}; gaps "
          + ", ".join(f"{k} {rel(bf[k], f[k]):.3e}" for k in VECTORS) + "; rms scalar gaps "
          + ", ".join(f"{k} {v:.3e}" for k, v in scalar_gaps(out).items()))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
