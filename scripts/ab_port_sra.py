#!/usr/bin/env python3
"""H100 A/B of the reduced-kv attention's two arms in the port's f32 train
step: PVT's spatial-reduction attention or Twins' global sub-sampled
attention on the plain ``einsum`` version or on the hand-written ``fused``
kernel (``ops.set_sra_impl``), everything else as the model's default.

One process, one model and optimizer state, one synthetic batch; the arms
run in turns (einsum, fused, fused, einsum by default), each ``--warmup``
steps and then ``--steps`` timed steps (host clock around a step ended by
``torch.cuda.synchronize()``); prints each turn's median ms and images/s,
each arm's median over its turns, and one JSON line.

    python3 scripts/ab_port_sra.py --conf tests/data/pvt_s_port.conf [--rows 128]
    python3 scripts/ab_port_sra.py --conf tests/data/twins_svt_s_port.conf arch.drop_path=0.1

Needs CUDA; imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--conf", required=True)
    parser.add_argument("--rows", type=int, default=128)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--order", default="einsum,fused,fused,einsum")
    parser.add_argument("--seed", type=int, default=0)
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
    from vision_transformers_tpu_torch.train.trainer import to_device
    from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    conf = load_config(args.conf, ["precision=f32", *args.overrides])
    arch, training = conf.arch, conf.training
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, args.seed)), strict=True)
    model = model.cuda()
    state = engine.create_train_state(
        model, make_optimizer(training, model, lambda c: 1e-4), ema=training.ema)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    size = getattr(arch, "image_size", None) or training.train_size
    size = size if isinstance(size, int) else size[0]
    batch = to_device(next(SyntheticDataset(args.rows, size, arch.n_class,
                                            seed=args.seed).batches(args.rows)), "cuda")

    def step():
        engine.train_step(state, batch, gen, grad_accumulation=training.grad_accumulation,
                          ema=training.ema, clip_grad_norm=training.clip_grad_norm)
        torch.cuda.synchronize()

    turns = []
    for arm in args.order.split(","):
        ops.set_sra_impl(arm)
        for _ in range(args.warmup):
            step()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        turns.append((arm, float(np.median(times)), times))
        print(f"{arch.type} {os.path.basename(args.conf)} sra {arm}: median "
              f"{turns[-1][1]:.3f} ms/step = {args.rows / turns[-1][1] * 1e3:.1f} images/s "
              f"(steps " + ", ".join(f"{t:.2f}" for t in times) + ")", flush=True)
    ops.set_sra_impl(None)
    arms = {arm: float(np.median([m for a, m, _ in turns if a == arm]))
            for arm in dict.fromkeys(a for a, _, _ in turns)}
    print(card)
    print("; ".join(f"{a}: {m:.3f} ms/step, {args.rows / m * 1e3:.1f} images/s"
                    for a, m in arms.items()))
    print(json.dumps({"card": card, "conf": os.path.basename(args.conf),
                      "overrides": args.overrides, "rows": args.rows,
                      "turns": [{"arm": a, "median_ms": m, "steps_ms": t} for a, m, t in turns],
                      "arms_median_ms": arms}))


if __name__ == "__main__":
    main()
