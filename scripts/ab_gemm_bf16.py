#!/usr/bin/env python3
"""Time the bf16 GEMM core and the bf16 layers of one source tree on the GPU,
for a parent / change comparison run in turns within one call:

    for t in _archive_check/base . . _archive_check/base; do
        python3 scripts/ab_gemm_bf16.py $t; done

``ROOT`` (default: this checkout) is the tree whose
``vision_transformers_tpu_torch`` is imported and built (each tree builds
into its own ``_build/``).  At ViT-S/16's trainer shapes (128 images, 25,216
rows), through the tree's ``ops/gemm.py::gemm_bf16``: the seven products of
B1 and B2 at bf16 (qkv, the out projection with bias, row scale and
residual, the eval's FF1 with silu and FF2 with the residual, dln with f32
out, the split-K weight gradients dWqkv and dWout in ``_splits``' slabs),
dln both with the weight K-major (a contiguous copy, as the bf16 backward
read it before the TMA path) and N-major (the weight read in place, as it
reads it since); then B1's bf16 forward with the saves and its backward at
the trainer's call (row scales) and B2's bf16 serving forward at the eval's
call.  Each time twice: ``call`` the median of 20 single calls from the
host, CUDA events around each (the wrapper's host work included, as
chip_smoke.py's phase 3bf timed them before), and ``device`` the median of
20 replays of a CUDA graph of 10 calls, over 10 (the device's time alone).
Prints the card and one JSON line.  Needs CUDA; imports no JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch


def median_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


_WARMUP_STREAM = []


def device_ms(fn, reps=20, inner=10, warmup=3):
    # one warm-up stream (cuBLAS keeps a workspace per stream)
    if not _WARMUP_STREAM:
        _WARMUP_STREAM.append(torch.cuda.Stream())
    side = _WARMUP_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(inner):
            fn()
    return median_ms(graph.replay, reps, 1) / inner


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    sys.path.insert(0, root)
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1
    from vision_transformers_tpu_torch.ops import gemm as gm

    if not _build.__file__.startswith(root):
        raise SystemExit(f"imported {_build.__file__}, not the tree under {root}")
    _build.build()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    bf = torch.bfloat16
    g = torch.Generator("cuda").manual_seed(0)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g, device="cuda")).to(bf)

    M, C, HD, F = 128 * 197, 384, 384, 1536
    rs = torch.rand(128, generator=g, device="cuda") + 0.5
    products = {
        "qkv": (r(M, C), r(3 * HD, C, s=0.05).t(), dict(bias=r(3 * HD, s=0.1))),
        "out projection": (r(M, HD), r(C, HD, s=0.05).t(),
                           dict(bias=r(C, s=0.1), rs=rs, rs_rows=197, res=r(M, C))),
        "FF1 (eval)": (r(M, C), r(F, C, s=0.05).t(), dict(bias=r(F, s=0.1), silu=True)),
        "FF2 (eval)": (r(M, F), r(C, F, s=0.05).t(), dict(bias=r(C, s=0.1), res=r(M, C))),
        "dln K-major": (r(M, 3 * HD), r(C, 3 * HD, s=0.05).t(),
                        dict(out_f32=True)),
        "dln N-major": (r(M, 3 * HD), r(3 * HD, C, s=0.05), dict(out_f32=True)),
        "dWqkv": (r(M, C), r(M, 3 * HD), dict(form="splitk", splits=fl._splits(C, 3 * HD, M))),
        "dWout": (r(M, HD), r(M, C), dict(form="splitk", splits=fl._splits(HD, C, M))),
    }
    out = {"root": root, "card": card}
    for name, (a, b, kw) in products.items():
        def call():
            gm.gemm_bf16(a, b, **kw)
        out[name] = {"call": median_ms(call), "device": device_ms(call)}

    B, N, H = 128, 197, 6
    rng = np.random.default_rng(0)

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.standard_normal(shape)).astype(np.float32)).cuda()

    layer = [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
             n(3 * HD, s=0.1), n(C, HD, s=0.05).t(), n(C, s=0.1), n(C, s=0.1, mean=1.0),
             n(C, s=0.1), n(F, C, s=0.05).t(), n(F, s=0.1), n(C, F, s=0.05).t(), n(C, s=0.1)]
    layer = [t if i in (1, 2, 7, 8) else t.to(bf) for i, t in enumerate(layer)]
    row_scale = torch.full((B,), 1 / 0.9, device="cuda")
    row_scale[::10] = 0.0
    dz = n(B, N, C).to(bf)
    _, saved = fl.fused_attention_layer_fwd(*layer[:7], H, row_scale=row_scale)

    def b1_fwd():
        fl.fused_attention_layer_fwd(*layer[:7], H, row_scale=row_scale)

    def b1_bwd():
        fl.fused_attention_layer_bwd(saved, dz)

    def b2():
        fl1.fused_transformer_layer(*layer, H)

    for name, fn in (("B1 bf16 fwd", b1_fwd), ("B1 bf16 bwd", b1_bwd), ("B2 bf16 eval", b2)):
        out[name] = {"call": median_ms(fn), "device": device_ms(fn)}
    print(card)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
