#!/usr/bin/env python3
"""H100 A/B of two paths of the port's f32 ViT-S/16 train step, in turns
within one process:

- ``--ab attention`` (with ``arch.dropout=0.1 arch.drop_ff=0.1``): the
  attention of the dropout step on the packed-qkv kernel (``fused``, the
  default from 32 rows and 128 tokens) or on the plain ``einsum``
  (``ops.set_attention_impl``);
- ``--ab ff``: the FF half of the 'layer' path on the FF kernel (``on``,
  ``ops.set_ff_kernel(True)``) or in plain torch on cuBLAS (``off``, the
  default).

One model and optimizer state, one synthetic batch; the arms run in turns
(A, B, B, A), each ``--warmup`` steps and then ``--steps`` timed steps
(host clock around a step ended by ``torch.cuda.synchronize()``); prints
each turn's median ms and images/s, each arm's median over its turns, the
card and one JSON line.

    python3 scripts/ab_port_vit.py --ab attention arch.dropout=0.1 arch.drop_ff=0.1
    python3 scripts/ab_port_vit.py --ab ff

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
ARMS = {"attention": ("fused", "einsum"), "ff": ("on", "off")}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ab", required=True, choices=sorted(ARMS))
    parser.add_argument("--conf", default=os.path.join(ROOT, "configs", "vit-s-16.conf"))
    parser.add_argument("--rows", type=int, default=128)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
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
    batch = to_device(next(SyntheticDataset(args.rows, arch.image_size, arch.n_class,
                                            seed=args.seed).batches(args.rows)), "cuda")

    def use(arm):
        if args.ab == "attention":
            ops.set_attention_impl(arm)
        else:
            ops.set_ff_kernel(arm == "on")

    def step():
        engine.train_step(state, batch, gen, grad_accumulation=training.grad_accumulation,
                          ema=training.ema, clip_grad_norm=training.clip_grad_norm)
        torch.cuda.synchronize()

    a, b = ARMS[args.ab]
    turns = []
    for arm in (a, b, b, a):
        use(arm)
        for _ in range(args.warmup):
            step()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        turns.append((arm, float(np.median(times)), times))
        print(f"ViT-S/16 {' '.join(args.overrides)} {args.ab} {arm}: median "
              f"{turns[-1][1]:.3f} ms/step = {args.rows / turns[-1][1] * 1e3:.1f} images/s "
              f"(steps " + ", ".join(f"{t:.2f}" for t in times) + ")", flush=True)
    ops.set_attention_impl(None)
    ops.set_ff_kernel(None)
    arms = {arm: float(np.median([m for x, m, _ in turns if x == arm])) for arm in (a, b)}
    print(card)
    print("; ".join(f"{x}: {m:.3f} ms/step, {args.rows / m * 1e3:.1f} images/s"
                    for x, m in arms.items()))
    print(json.dumps({"card": card, "ab": args.ab, "overrides": args.overrides,
                      "rows": args.rows,
                      "turns": [{"arm": x, "median_ms": m, "steps_ms": t} for x, m, t in turns],
                      "arms_median_ms": arms}))


if __name__ == "__main__":
    main()
