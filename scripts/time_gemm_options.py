#!/usr/bin/env python3
"""Time the GEMM core's pass options (``ops/gemm.py``, ``GemmExtra`` in
csrc/common.cuh) one at a time on the GPU, at B4's products at a Halo-S
stage (128 images; stage 1: 524,288 rows, C 96, F 384), to see what each
costs beside the same product without options and beside one elementwise
torch pass over the operand it replaces (the bytes of the pass the option
took in):

    python3 scripts/time_gemm_options.py [STAGE ...]   # 1-4, default 1

Per product: the bare call, then each option alone (the producer's
LayerNorm apply, silu and B's row scale; the epilogue's hid with silu', and
with the row or column partials), each as the median of 20 CUDA-event
timings of 10 calls in a row.  Prints the card and one JSON line.  Needs
CUDA; imports no JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = {1: (64, 96), 2: (32, 192), 3: (16, 384), 4: (8, 768)}  # map side, C


def ms(fn, reps=20, inner=10):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def main() -> None:
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import gemm as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    out = {}
    for stage in map(int, sys.argv[1:] or ["1"]):
        side, C = STAGES[stage]
        out.update(stage_times(torch, gm, fl, stage, 128 * side * side, C, 4 * C, side * side))
    print(card)
    print(json.dumps(out))


def stage_times(torch, gm, fl, stage, M, C, F, PER):
    """The options' times at one stage: {label: ms}."""
    g = torch.Generator("cuda").manual_seed(0)

    def n(*shape, s=1.0):
        return s * torch.randn(*shape, device="cuda", generator=g)

    x, hid, dy = n(M, C), n(M, F), n(M, C)
    ln_rows = (n(M, s=0.3), 0.5 + torch.rand(M, device="cuda", generator=g),
               1 + n(C, s=0.1), n(C, s=0.1))
    w1, w2 = n(F, C, s=C ** -0.5).t(), n(C, F, s=F ** -0.5).t()
    rs = 0.5 + torch.rand(M // PER, device="cuda", generator=g)
    out = {}
    # one elementwise pass over the operand each option replaces: x and hid
    # read and written once (the LayerNorm apply, act), dy (the row scale)
    out[f"stage {stage} pass over x [M,C]"] = ms(lambda: torch.mul(x, 1.5))
    out[f"stage {stage} pass over hid [M,F]"] = ms(lambda: torch.mul(hid, 1.5))
    calls = {
        "FF1 [M,F]=x·W1": (x, w1, "rows", {}, {
            "ln": dict(ln=ln_rows), "column partials": dict(col_partials=True),
            "rs_b (B row scale)": dict(rs_b=torch.ones(C, device="cuda")),
            "silu staged": dict(act_a="silu")}),
        "FF2 [M,C]=hid·W2": (hid, w2, "rows", {}, {
            "silu staged": dict(act_a="silu")}),
        "dh [M,F]=dy·W2ᵀ": (dy, w2.t(), "rows", {}, {
            "hid": dict(hid=hid), "hid+rs": dict(hid=hid, rs=rs, rs_rows=PER),
            "hid+row partials": dict(hid=hid, row_partials=True),
            "hid+column partials": dict(hid=hid, col_partials=True),
            "all": dict(hid=hid, rs=rs, rs_rows=PER, row_partials=True,
                        col_partials=True)}),
        "dW2 [F,C]=hidᵀ·dy": (hid, dy, "splitk", {}, {
            "silu staged": dict(act_a="silu"), "rs_b": dict(rs_b=rs, rs_b_rows=PER),
            "both": dict(act_a="silu", rs_b=rs, rs_b_rows=PER)}),
        "dW1 [C,F]=xᵀ·hid": (x, hid, "splitk", {}, {
            "ln (token = k)": dict(ln=(ln_rows[0], ln_rows[1], 1 + n(C, s=0.1),
                                       n(C, s=0.1)))}),
    }
    for label, (a, b, form, base, options) in calls.items():
        K, Mo = a.shape if form == "splitk" else a.shape[::-1]
        splits = fl._splits(Mo, b.shape[1], K) if form == "splitk" else 1
        label = f"stage {stage} {label}"
        out[f"{label} bare"] = ms(lambda: gm.gemm(a, b, form=form, splits=splits, **base))
        for name, kw in options.items():
            out[f"{label} {name}"] = ms(lambda: gm.gemm(a, b, form=form, splits=splits,
                                                        **base, **kw))
    for k, v in out.items():
        print(f"{k}: {v:.3f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
