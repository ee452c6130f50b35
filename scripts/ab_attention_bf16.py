#!/usr/bin/env python3
"""Time the packed-row attention's bf16 form and the layers around it in one
source tree on the GPU, for a parent / change comparison run in turns within
one call:

    for t in _archive_check/base . . _archive_check/base; do
        python3 scripts/ab_attention_bf16.py $t; done

``ROOT`` (default: this checkout) is the tree whose
``vision_transformers_tpu_torch`` is imported and built (each tree builds
into its own ``_build/``).  At ViT-S/16's trainer shapes (128 images, 197
tokens, 6 heads 64 wide), through the tree's thin doors
``ops/fused_layer.py::packed_attention_bf16`` / ``_bwd``: the attention's
bf16 forward with lse (B1's training call) and without (B2's serving call),
and its backward with its dq sum (and, in a tree that has one, the reduce
pass); beside them ``scaled_dot_product_attention`` on the same bf16 q, k,
v: its forward, its forward and backward (``torch.autograd.grad``) in one
CUDA graph and the backward alone, as their difference and on a retained
graph (the forward recorded on the timing stream); then B1's bf16
forward with the saves and its backward at the trainer's call (row scales),
B2's bf16 serving forward at the eval's call, and the GEMM core's bf16 qkv
and out projection (their outputs' SHA-256, so that two trees' products can
be held bit for bit); then the f32 forms on the packed-row core
(``attention_tc.cuh``): B1's forward and backward at ViT-S/16 and B3's
(``fused_attention_qkv``, no bias).  Each time as ``device``, the median of
20 replays of a CUDA graph of 10 calls, over 10 (the device's time alone),
and ``call``, the median of 20 single calls from the host with CUDA events
around each (the wrapper's host work included).  Prints the card and one
JSON line.  Needs CUDA; imports no JAX.
"""

import hashlib
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


_SIDE = []


def device_ms(fn, reps=20, inner=10, warmup=3):
    """One call's device time: ``inner`` calls captured in a CUDA graph after
    ``warmup`` on a side stream, the median of ``reps`` replays, over
    ``inner``."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
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


def sha(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    sys.path.insert(0, root)
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import fused_attention_mod as fa
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1
    from vision_transformers_tpu_torch.ops import gemm as gm

    if not _build.__file__.startswith(root):
        raise SystemExit(f"imported {_build.__file__}, not the tree under {root}")
    _build.build()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    bf = torch.bfloat16
    g = torch.Generator("cuda").manual_seed(0)
    B, N, C, H, D, F = 128, 197, 384, 6, 64, 1536
    HD, M = H * D, B * N
    out = {"root": root, "card": card}

    def both(name, fn):
        out[name] = {"device": device_ms(fn), "call": median_ms(fn)}

    # the packed-row attention's bf16 form beside SDPA on the same q, k, v
    qkv = torch.randn(B, N, 3 * HD, generator=g, device="cuda").to(bf)
    do = torch.randn(B, N, HD, generator=g, device="cuda").to(bf)
    o, lse = fl.packed_attention_bf16(qkv, H)
    both("attention bf16 fwd (lse)", lambda: fl.packed_attention_bf16(qkv, H))
    both("attention bf16 fwd (serving)", lambda: fl.packed_attention_bf16(qkv, H, save=False))
    both("attention bf16 bwd", lambda: fl.packed_attention_bf16_bwd(qkv, o, lse, do, H))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0))
    dog = do.view(B, N, H, D).transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(q, k, v)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(q, k, v), (q, k, v), dog)

    both("sdpa fwd", sdpa_fwd)
    both("sdpa fwd + bwd", sdpa_fwd_bwd)
    out["sdpa bwd (difference)"] = {key: out["sdpa fwd + bwd"][key] - out["sdpa fwd"][key]
                                    for key in ("device", "call")}
    # the backward alone on a retained graph: the forward recorded on the
    # timing stream, so that autograd runs the backward there, in the capture
    device_ms(sdpa_fwd)  # makes the timing stream
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o_sdpa = sdpa(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    both("sdpa bwd", lambda: torch.autograd.grad(o_sdpa, (q, k, v), dog, retain_graph=True))
    del o_sdpa

    # B1 and B2 at bf16
    rng = np.random.default_rng(0)

    def n(*shape, s=1.0, mean=0.0):
        return torch.from_numpy((mean + s * rng.standard_normal(shape)).astype(np.float32)).cuda()

    layer = [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
             n(3 * HD, s=0.1), n(C, HD, s=0.05).t(), n(C, s=0.1), n(C, s=0.1, mean=1.0),
             n(C, s=0.1), n(F, C, s=0.05).t(), n(F, s=0.1), n(C, F, s=0.05).t(), n(C, s=0.1)]
    layer32 = layer
    layer = [t if i in (1, 2, 7, 8) else t.to(bf) for i, t in enumerate(layer)]
    row_scale = torch.full((B,), 1 / 0.9, device="cuda")
    row_scale[::10] = 0.0
    dz32 = n(B, N, C)
    dz = dz32.to(bf)
    _, saved = fl.fused_attention_layer_fwd(*layer[:7], H, row_scale=row_scale)
    both("B1 bf16 fwd", lambda: fl.fused_attention_layer_fwd(*layer[:7], H, row_scale=row_scale))
    both("B1 bf16 bwd", lambda: fl.fused_attention_layer_bwd(saved, dz))
    both("B2 bf16 eval", lambda: fl1.fused_transformer_layer(*layer, H))
    del saved

    # the GEMM core's bf16 form: times and outputs
    products = {
        "GEMM bf16 qkv": (layer[0].reshape(M, C), layer[3], dict(bias=layer[4])),
        "GEMM bf16 out projection": (
            torch.randn(M, HD, generator=g, device="cuda").to(bf), layer[5],
            dict(bias=layer[6], rs=row_scale, rs_rows=N, res=layer[0].reshape(M, C)))}
    for name, (a, b, kw) in products.items():
        both(name, lambda: gm.gemm_bf16(a, b, **kw))
        out[name]["sha256"] = sha(gm.gemm_bf16(a, b, **kw))

    # the f32 forms on the packed-row core (attention_tc.cuh)
    _, saved = fl.fused_attention_layer_fwd(*layer32[:7], H, row_scale=row_scale)
    both("B1 f32 fwd", lambda: fl.fused_attention_layer_fwd(*layer32[:7], H,
                                                            row_scale=row_scale))
    both("B1 f32 bwd", lambda: fl.fused_attention_layer_bwd(saved, dz32))
    del saved
    qkv32 = torch.randn(B, N, 3 * HD, generator=g, device="cuda")
    do32 = torch.randn(B, N, HD, generator=g, device="cuda")
    _, saved = fa.fused_attention_qkv_fwd(qkv32, H, None)
    both("B3 f32 fwd", lambda: fa.fused_attention_qkv_fwd(qkv32, H, None))
    both("B3 f32 bwd", lambda: fa.fused_attention_qkv_bwd(saved, do32))
    print(card)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
