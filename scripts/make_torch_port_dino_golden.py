#!/usr/bin/env python
"""Write tests/data/dino_deit_s16_port_golden.npz: one f32 DINO step of the
JAX package for DeiT-S/16 (configs/dino_deit-s-16.conf: depth 12, dim 384,
6 heads of 64, head 384 → 2048 → 2048 → 256 → 65536) on its CPU path, at
``student_drop_path`` 0, for 3 seeded images — 6 global crops at 224 and 24
local crops at 96, so that the locals pack 3 to a row (8 rows of 111
tokens under the block-diagonal mask) — seeded student and teacher weights
(the teacher from the next seed), a seeded center and the teacher
temperature ``TEACHER_TEMP``.

Stored, besides the seed: the DINO loss; the student's [30, 65536] and the
teacher's [6, 65536] outputs as per-crop L2 norms and projections on a
seeded normal vector (``utils/weights.row_projections``); the global
gradient norm, and for every state_dict key the gradient's L2 norm and its
projection on a seeded normal tensor (``utils/weights.grad_projections``).
Weights, crops, the center and the projection vectors are regenerated from
the seed with numpy (vision_transformers_tpu_torch/utils/weights.py) by this
script, by tests/test_torch_port_dino_golden.py and by chip_smoke.py.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_dino_golden.py [--seed 0]
"""

import argparse
import functools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "dino_deit_s16_port_golden.npz")
CONF = os.path.join(ROOT, "configs", "dino_deit-s-16.conf")
N_IMAGES = 3
TEACHER_TEMP = 0.04  # the conf's warmup temperature, the sharpest


def seeded_center(seed: int, dim: int) -> np.ndarray:
    """The fixed center [1, dim]: normals of std 0.1 from ``(seed, 7)``."""
    return 0.1 * np.random.default_rng([seed, 7]).standard_normal((1, dim), dtype=np.float32)


@functools.lru_cache(maxsize=1)
def step_inputs(seed: int):
    """(port conf, student sd, teacher sd, crops, center) of the golden step
    (kept for the next call with the same seed: read only)."""
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.utils.weights import (seeded_dino_crops,
                                                             seeded_state_dict)

    conf = load_config(CONF)
    task, arch = conf.task, conf.arch
    crops = seeded_dino_crops(seed, N_IMAGES, task.global_crop_size, task.local_crop_size,
                              task.n_local_crop)
    return (conf, seeded_state_dict(arch, seed), seeded_state_dict(arch, seed + 1), crops,
            seeded_center(seed, arch.dim_head_out))


def loss_terms(seed: int, student_out, teacher_out, student_temp: float = 0.1) -> np.ndarray:
    """The DINO loss's cross-entropies, one per (teacher global, student
    crop ≠ it, image), in f64 from the nets' outputs, the seeded center and
    TEACHER_TEMP (train/loss.py's sum, not averaged): their mean is the
    loss."""
    s = np.asarray(student_out, np.float64) / student_temp
    t = np.asarray(teacher_out, np.float64)
    t = (t - seeded_center(seed, t.shape[-1])) / TEACHER_TEMP
    q = np.exp(t - t.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    logp = s - s.max(-1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    b = len(t) // 2
    n_crop = len(s) // b
    return np.array([-(q[i * b:(i + 1) * b] * logp[v * b:(v + 1) * b]).sum(-1)
                     for i in range(2) for v in range(n_crop) if v != i]).ravel()


def summary(seed, loss, student_out, teacher_out, grads, vectors=None) -> dict:
    """The stored numbers of one step (see the module docstring);
    ``vectors``: the gradients' projection tensors, made beforehand
    (:func:`projection_vectors`)."""
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             row_projections)

    keys = sorted(grads)
    proj = grad_projections(grads, seed, vectors)
    norms = np.array([np.linalg.norm(np.asarray(grads[k], np.float64)) for k in keys])
    return {"loss": float(loss), "grad_norm": float(np.sqrt((norms ** 2).sum())),
            "keys": keys, "norms": norms, "projections": np.array([proj[k] for k in keys]),
            "student_norms": np.linalg.norm(np.asarray(student_out, np.float64), axis=-1),
            "student_projections": row_projections(student_out, seed),
            "teacher_norms": np.linalg.norm(np.asarray(teacher_out, np.float64), axis=-1),
            "teacher_projections": row_projections(teacher_out, seed),
            "loss_terms": loss_terms(seed, student_out, teacher_out)}


def projection_vectors(seed: int) -> dict:
    """The student's gradient projection tensors by state_dict key
    (utils/weights.grad_projection_vector), for a caller that summarises
    several steps of one seed."""
    from vision_transformers_tpu_torch.utils.weights import grad_projection_vector

    sd_s = step_inputs(seed)[1]
    return {k: grad_projection_vector(seed, i, sd_s[k].shape) for i, k in enumerate(sorted(sd_s))}


def port_dino_step(seed: int, device: str = "cpu", dtype=None, vectors=None) -> dict:
    """The same numbers from the port on ``device`` (its dispatch, or the
    caller's ``ops`` force), imports no JAX: the teacher under
    ``forward_only`` and ``no_grad``, the student with gradients; both nets
    at the compute ``dtype`` (None: f32); ``vectors`` as :func:`summary`'s."""
    import torch

    from vision_transformers_tpu_torch import ops
    from vision_transformers_tpu_torch.train import loss as L
    from vision_transformers_tpu_torch.utils.weights import to_torch

    dtype = dtype or torch.float32
    conf, sd_s, sd_t, crops, center = step_inputs(seed)
    with torch.device("meta"):  # no initializer runs: the weights are loaded
        student = conf.arch.make(dtype=dtype, drop_path=0.0)
        teacher = conf.arch.make(dtype=dtype, drop_path=0.0)
    student.load_state_dict(to_torch(sd_s), strict=True, assign=True)
    teacher.load_state_dict(to_torch(sd_t), strict=True, assign=True)
    student.to(device).train()
    teacher.to(device).eval()
    crops = [torch.from_numpy(c).to(device).permute(0, 3, 1, 2) for c in crops]
    with torch.no_grad(), ops.forward_only():
        t_out = teacher(crops[:2])
    s_out = student(crops)
    loss = L.dino_loss(s_out, t_out.float(), torch.from_numpy(center).to(device),
                       TEACHER_TEMP, len(crops))
    loss.backward()
    grads = {k: p.grad.double().cpu().numpy() for k, p in student.named_parameters()}
    return summary(seed, loss.detach().cpu(), s_out.detach().float().cpu().numpy(),
                   t_out.float().cpu().numpy(), grads, vectors)


def jax_dino_step(seed: int) -> dict:
    """The golden's numbers from the JAX package (its CPU dispatch: the
    einsum attention, the locals packed at the model level)."""
    import jax
    import jax.numpy as jnp

    from vision_transformers_tpu import ops as jax_ops
    from vision_transformers_tpu.config.schema import load_config
    from vision_transformers_tpu.train import loss as L
    from vision_transformers_tpu.utils.torch_convert import convert_variables
    from vision_transformers_tpu_torch.utils.weights import state_dict_from_flax

    conf, sd_s, sd_t, crops, center = step_inputs(seed)
    arch = load_config(CONF).arch
    n_crop = len(crops)
    student = arch.make(drop_path=0.0)  # f32
    params = convert_variables(arch, sd_s, 224)["params"]
    teacher_params = convert_variables(arch, sd_t, 224)["params"]
    crops = [jnp.asarray(c) for c in crops]

    def step(p, tp, crops):
        with jax_ops.forward_only():
            t_out = student.apply({"params": tp}, crops[:2], deterministic=True)

        def f(p):
            s_out = student.apply({"params": p}, crops, deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
            return L.dino_loss(s_out, t_out, jnp.asarray(center), TEACHER_TEMP,
                               n_crop), s_out
        (loss, s_out), g = jax.value_and_grad(f, has_aux=True)(p)
        return loss, s_out, t_out, g

    loss, s_out, t_out, grads = jax.jit(step)(params, teacher_params, crops)
    grads = state_dict_from_flax(jax.tree.map(np.asarray, grads))
    return summary(seed, loss, np.asarray(s_out), np.asarray(t_out), grads)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    g = jax_dino_step(args.seed)
    np.savez(GOLDEN, seed=np.int64(args.seed), loss=np.float64(g["loss"]),
             grad_norm=np.float64(g["grad_norm"]), keys=np.array(g["keys"]),
             **{k: g[k] for k in ("norms", "projections", "student_norms",
                                  "student_projections", "teacher_norms",
                                  "teacher_projections")})
    print(f"wrote {GOLDEN}: loss {g['loss']:.6f}, grad_norm {g['grad_norm']:.6f}, "
          f"{len(g['keys'])} tensors")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
