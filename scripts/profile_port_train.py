#!/usr/bin/env python3
"""Where the time goes in the port's train step on one GPU.

Runs ``engine.train_step`` on the model of ``--conf`` (seeded weights and a
synthetic batch, f32 with no TF32 — or, with ``--precision bf16``, the
JAX package's default precision, ViT only —, AdamW with the conf's clip and
grad_accumulation, DropPath at the conf's rate drawn from a seeded
generator) under ``torch.profiler`` after a warm-up and prints the device
time by kernel per step, grouped by layer (hand-written GEMM in its
row-major and split-K forms, attention forward / backward kernels, other
hand-written kernels, cuBLAS, the rest), the device's busy share of the wall
time, the census of the "other hand-written" passes (each kernel's launches
and ms per step), and one JSON line.

    python3 scripts/profile_port_train.py [--conf configs/vit-s-16.conf] [--rows 128]
        [--steps 5] [--trace out.json] [--halo-impl ...] [--sra-impl einsum|fused]
        [--attn-impl einsum|fused|layer|layer1|block|swin] [--ff-kernel]
        [--precision f32|bf16] [key=value conf overrides ...]

ViT-S/16 at ``--rows`` ≥ 32 takes the fused attention layer (forward and
backward kernels); Swin-S (``--conf configs/swin-transformer-s.conf``, two
64-image micro-batches at 128 rows) the whole-layer kernel's forward and
backward; Halo-S (``--conf tests/data/halo_s_port.conf``, 128 images at
256 px) the whole Halo layer's (``arch.drop_path=0.1`` as chip_smoke.py's
trainer run; ``--halo-impl direct`` the halo attention's between torch
projections, ``--halo-impl gather`` the gathered halo attention's, the
neighbourhood gather and its adjoint in torch); PVT-S (``--conf tests/data/pvt_s_port.conf``) and Twins-SVT-S
(``--conf tests/data/twins_svt_s_port.conf arch.drop_path=0.1``) at 224 px,
their reduced-kv attention on the plain ``einsum`` default or, with
``--sra-impl fused``, on the hand-written kernel (Twins' local attention
takes the attention layer with the pair mask either way).  ViT-S/16 with
``arch.dropout=0.1 arch.drop_ff=0.1`` leaves the layer kernels for the
packed-qkv attention kernel between cuBLAS projections (``--attn-impl
einsum`` its plain einsum); ``--ff-kernel`` turns the FF-half kernel on at
the 'layer' sites; ``--attn-impl block`` runs ViT's and Swin's attention
through the attention block kernel (projections inside it), ``--attn-impl
swin`` Swin's layers through the map-resident whole-layer kernel (no roll or
window partition around it).  DINO (``--conf configs/dino_deit-s-16.conf
--rows 96``, the conf's batch cut to 96 images) profiles the DINO step as its
trainer runs it: the uint8 multi-crop batch to the card, the augmentation,
the teacher's forward on the 2 globals (the whole-layer kernel), the
student's forward and backward on all 10 crops (the attention layer, the
locals packed 3 to a row under the block mask), the DINO loss, the clip,
AdamW with the scheduled decay and the teacher EMA (``--freeze`` with the
last layer frozen); the conf's ``student_drop_path`` 0.1.  Needs CUDA;
imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "configs", "vit-s-16.conf")

# kernel-name substring → layer, first match wins (PyTorch's own kernels
# first: some share a name part with the hand-written ones, e.g. silu)
GROUPS = (("at::native", "other (elementwise, reductions, conv)"),
          ("gemm_tc_kernel<128, true", "hand-written GEMM, split-K (weight gradients)"),
          ("gemm_tc_kernel<64, true", "hand-written GEMM, split-K (weight gradients)"),
          ("gemm_tc_kernel", "hand-written GEMM, row-major"),
          # the bf16 form on TMA: gemm_bf16_tma_kernel<BN, TA, ...>, TA 1 the split-K form
          ("gemm_bf16_tma_kernel<64, 1", "hand-written GEMM, split-K (weight gradients)"),
          ("gemm_bf16_tma_kernel<128, 1", "hand-written GEMM, split-K (weight gradients)"),
          ("gemm_bf16_tma_kernel<192, 1", "hand-written GEMM, split-K (weight gradients)"),
          ("gemm_bf16_tma_kernel", "hand-written GEMM, row-major"),
          ("halo_bwd_kernel", "hand-written halo attention backward"),
          ("halo_fwd_kernel", "hand-written halo attention forward"),
          ("halo_fold", "other hand-written"),
          ("window_bwd_kernel", "hand-written attention backward"),
          ("window_fwd_kernel", "hand-written attention forward"),
          ("attn_bwd", "hand-written attention backward"),
          ("attn_rows", "hand-written attention backward"),  # its L / Δ pass (bf16)
          ("attn_fwd", "hand-written attention forward"),
          ("splitk_reduce", "other hand-written"), ("colsum", "other hand-written"),
          ("ln_", "other hand-written"),
          ("row_scale_grad", "other hand-written"), ("scale_rows", "other hand-written"),
          ("silu", "other hand-written"), ("group_sum", "other hand-written"),
          ("act_kernel", "other hand-written"), ("dact_mul", "other hand-written"),
          ("gather_rows", "other hand-written"), ("drs_part", "other hand-written"),
          ("gemm", "cuBLAS GEMM"), ("sgemm", "cuBLAS GEMM"), ("cutlass", "cuBLAS GEMM"),
          ("nvjet", "cuBLAS GEMM"),  # cuBLAS's bf16 GEMMs
          ("Memcpy", "copies"), ("foreach", "optimizer (foreach)"))


def group(name: str) -> str:
    for key, label in GROUPS:
        if key in name:
            return label
    return "other (elementwise, reductions, conv)"


def dino_step(conf, images, seed, freeze, gen):
    """The DINO trainer's step at ``images`` images a step, seeded weights
    (the teacher a copy of the student), as train/dino.py runs it."""
    from vision_transformers_tpu_torch.data.dino import make_dino_device_augment
    from vision_transformers_tpu_torch.data.synthetic import synthetic_dino_batches
    from vision_transformers_tpu_torch.train.dino import DINOTrainState, make_dino_train_step
    from vision_transformers_tpu_torch.train.schedule import cosine_schedule
    from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch

    arch, task, training = conf.arch, conf.task, conf.training
    sd = to_torch(seeded_state_dict(arch, seed))
    student = arch.make(drop_path=task.student_drop_path)
    teacher = arch.make(drop_path=0.0)
    student.load_state_dict(sd, strict=True)
    teacher.load_state_dict(sd, strict=True)
    student.cuda()
    teacher.cuda().requires_grad_(False)
    optimizer, train_step = make_dino_train_step(
        training, student, lambda c: 1e-4, cosine_schedule(training.weight_decay,
                                                           task.weight_decay_end, 100),
        task.n_local_crop + 2)
    state = DINOTrainState(student, teacher, optimizer,
                           torch.zeros((1, arch.dim_head_out), device="cuda"))
    host = next(synthetic_dino_batches(images, task.global_crop_size, task.local_crop_size,
                                       task.n_local_crop, 1, seed=seed))
    augment = make_dino_device_augment(task.n_local_crop)
    aug_gen = torch.Generator(device="cuda").manual_seed(seed + 23)

    def step():
        crops = augment(aug_gen, torch.from_numpy(host["globals"]).cuda(),
                        torch.from_numpy(host["locals"]).cuda())
        return train_step(state, crops, gen, task.warmup_teacher_temperature, 0.996, freeze)

    return step


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--conf", default=CONF)
    parser.add_argument("--rows", type=int, default=128)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trace", default=None, help="write a chrome trace here")
    parser.add_argument("--halo-impl", default=None,
                        choices=("layer", "direct", "gather", "einsum"),
                        help="force a Halo path (default: the dispatch's)")
    parser.add_argument("--sra-impl", default=None, choices=("einsum", "fused"),
                        help="force the reduced-kv path of PVT / Twins (default: the "
                             "dispatch's, einsum)")
    parser.add_argument("--attn-impl", default=None,
                        choices=("einsum", "fused", "layer", "layer1", "block", "swin"),
                        help="force the attention path (default: the dispatch's)")
    parser.add_argument("--ff-kernel", action="store_true",
                        help="the FF-half kernel at the 'layer' sites (default off)")
    parser.add_argument("--freeze", action="store_true",
                        help="DINO: the last layer frozen (epoch 0 of the recipe)")
    parser.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                        help="the compute dtype (bf16: the ViT's bf16 forms)")
    parser.add_argument("overrides", nargs="*", help="key=value conf overrides")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    sys.path.insert(0, ROOT)
    from vision_transformers_tpu_torch import ops
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.data.synthetic import SyntheticDataset
    from vision_transformers_tpu_torch.train import engine
    from vision_transformers_tpu_torch.train.optim import make_optimizer
    from vision_transformers_tpu_torch.train.trainer import (check_supported, compute_dtype,
                                                             to_device)
    from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch

    ops.set_halo_impl(args.halo_impl)
    ops.set_sra_impl(args.sra_impl)
    ops.set_attention_impl(args.attn_impl)
    ops.set_ff_kernel(args.ff_kernel or None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    conf = load_config(args.conf, [f"precision={args.precision}", *args.overrides])
    if args.precision == "bf16":
        check_supported(conf)  # bf16 is ported for ViT
    dtype = compute_dtype(conf)
    arch, training = conf.arch, conf.training
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if arch.type == "dino":
        step = dino_step(conf, args.rows, args.seed, args.freeze, gen)
    else:
        model = arch.make(dtype=dtype) if dtype != torch.float32 else arch.make()
        model.load_state_dict(to_torch(seeded_state_dict(arch, args.seed)), strict=True)
        model = model.cuda()
        state = engine.create_train_state(
            model, make_optimizer(training, model, lambda c: 1e-4), ema=training.ema)
        size = getattr(arch, "image_size", None) or training.train_size  # Twins has none
        size = size if isinstance(size, int) else size[0]
        batch = to_device(next(SyntheticDataset(args.rows, size, arch.n_class,
                                                seed=args.seed).batches(args.rows)), "cuda")

        def step():
            return engine.train_step(state, batch, gen,
                                     grad_accumulation=training.grad_accumulation,
                                     ema=training.ema,
                                     clip_grad_norm=training.clip_grad_norm)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    # device-side events only (kernels, memcpy): a CPU op's device time
    # repeats the time of the kernels it launched
    rows = [(e.key, e.count // args.steps, e.self_device_time_total / args.steps / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    groups = {}
    for name, _, ms in rows:
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    print(card)
    print(f"{arch.type} {os.path.basename(args.conf)} {' '.join(args.overrides)} "
          f"{'halo path ' + args.halo_impl + ' ' if args.halo_impl else ''}"
          f"{'sra path ' + args.sra_impl + ' ' if args.sra_impl else ''}"
          f"{'attention ' + args.attn_impl + ' ' if args.attn_impl else ''}"
          f"{'FF kernel ' if args.ff_kernel else ''}{args.precision} "
          f"{'(last layer frozen) ' if args.freeze else ''}train step, {args.rows} rows "
          f"(grad_accumulation {training.grad_accumulation}), {args.steps} profiled "
          f"steps: wall {wall * 1e3:.3f} ms ({args.rows / wall:.1f} images/s), "
          f"device busy {busy:.3f} ms ({busy / (wall * 1e3):.1%})")
    for label, ms in sorted(groups.items(), key=lambda g: -g[1]):
        print(f"  {ms:9.3f} ms  {ms / busy:6.1%}  {label}")
    for name, calls, ms in rows[:25]:
        print(f"  {ms:9.3f} ms  {ms / busy:6.1%}  x{calls:<4d} {name[:90]}")
    passes = [(n, c, m) for n, c, m in rows if group(n) == "other hand-written"]
    print("other hand-written, by kernel (launches and ms per step):")
    for name, calls, ms in passes:
        print(f"  {ms:9.3f} ms  x{calls:<4d} {name[:90]}")
    print(json.dumps({"conf": os.path.basename(args.conf), "overrides": args.overrides,
                      "halo_impl": args.halo_impl, "sra_impl": args.sra_impl,
                      "attn_impl": args.attn_impl, "ff_kernel": args.ff_kernel,
                      "rows": args.rows,
                      "wall_ms": wall * 1e3, "device_ms": busy,
                      "device_busy_share": busy / (wall * 1e3), "groups": groups,
                      "kernels": [{"name": n[:120], "calls": c, "ms": m}
                                  for n, c, m in rows[:25]],
                      "passes": [{"name": n[:120], "calls": c, "ms": m}
                                 for n, c, m in passes]}))


if __name__ == "__main__":
    main()
