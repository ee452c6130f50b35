#!/usr/bin/env python3
"""Time the port's whole-layer kernels of one source tree on the GPU, for a
parent / change comparison run in turns within one call:

    for t in parent . . parent; do python3 scripts/ab_port_kernels.py $t; done

``ROOT`` (default: this checkout) is the tree whose
``vision_transformers_tpu_torch`` is imported and built (each tree builds
into its own ``_build/``).  Times, as medians of 20 CUDA-event timings
after 3 warm-up calls: B1 ``fused_attention_layer`` forward with saves and
backward at ViT-S B=128 with a row scale; B2 ``fused_transformer_layer``
forward with saves and backward at Swin-S stages 3 and 1 at 64 images (128
rows of 98 tokens, C 384, 12 heads of 32, the grouped bias of 2 groups;
2048 rows, C 96, 3 heads, 32 groups; both row scales); B4
``fused_halo_layer`` the same at Halo-S stage 1 at 128 images (64x64 map,
C 96, 3 heads, window 8, halo 2); B3 ``fused_attention_qkv`` forward with
lse and backward at ViT-S B=128 (no bias) and at Swin-S stage 1 at 64
images (2048 rows of 98 tokens, 3 heads of 32, the grouped bias of 32
groups); B5a ``halo_attention_direct`` forward with lse and backward at
Halo-S stage 1 at 128 images; B8 ``fused_attention_block`` forward with
saves and backward at ViT-S B=128 (no bias); where the tree has it, B9
``fused_swin_layer`` forward with saves and backward at Swin-S stages 1 and
3 at 64 images (shifted: the grouped bias of 32 / 2 groups, both per-sample
row scales).  Prints the card, ptxas's registers and spills of every kernel
compiled from fused_layer.cu, fused_layer_bwd.cu and fused_layer1_bwd.cu
(B1, B2, B3, B7, B8) when this process builds the tree, and one JSON line.
Needs CUDA; imports no JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    sys.path.insert(0, root)
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import fused_attention_mod as fa
    from vision_transformers_tpu_torch.ops import fused_halo as fh
    from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1

    if not _build.__file__.startswith(root):
        raise SystemExit(f"imported {_build.__file__}, not the tree under {root}")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]

    def ms(fn, reps=20):
        for _ in range(3):
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

    def args(B, N, C, H, D, F):
        g = torch.Generator("cuda").manual_seed(0)

        def n(*shape, s=1.0, m=0.0):
            return m + s * torch.randn(*shape, device="cuda", generator=g)

        HD = H * D
        return [n(B, N, C), n(C, s=0.1, m=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
                n(3 * HD, s=0.1), n(C, HD, s=0.05).t(), n(C, s=0.1), n(C, s=0.1, m=1.0),
                n(C, s=0.1), n(F, C, s=0.05).t(), n(F, s=0.1), n(C, F, s=0.05).t(),
                n(C, s=0.1)]

    out = {}
    r = torch.ones(128, device="cuda")
    a = args(128, 197, 384, 6, 64, 1536)
    dz = torch.randn(128, 197, 384, device="cuda")
    _, saved = fl.fused_attention_layer_fwd(*a[:7], 6, row_scale=r)
    out["B1 ViT fwd"] = ms(lambda: fl.fused_attention_layer_fwd(*a[:7], 6, row_scale=r))
    out["B1 ViT bwd"] = ms(lambda: fl.fused_attention_layer_bwd(saved, dz))
    a = args(128, 98, 384, 12, 32, 1536)
    extra = 0.2 * torch.randn(2, 12, 98, 98, device="cuda")
    dz = torch.randn(128, 98, 384, device="cuda")
    _, saved = fl1.fused_transformer_layer_fwd(*a, 12, extra, r, r)
    out["B2 Swin3 fwd"] = ms(lambda: fl1.fused_transformer_layer_fwd(*a, 12, extra, r, r))
    out["B2 Swin3 bwd"] = ms(lambda: fl1.fused_transformer_layer_bwd(saved, dz))
    a = args(2048, 98, 96, 3, 32, 384)
    extra = 0.2 * torch.randn(32, 3, 98, 98, device="cuda")
    dz = torch.randn(2048, 98, 96, device="cuda")
    r = torch.ones(2048, device="cuda")
    _, saved = fl1.fused_transformer_layer_fwd(*a, 3, extra, r, r)
    out["B2 Swin1 fwd"] = ms(lambda: fl1.fused_transformer_layer_fwd(*a, 3, extra, r, r))
    out["B2 Swin1 bwd"] = ms(lambda: fl1.fused_transformer_layer_bwd(saved, dz))
    r = torch.ones(128, device="cuda")
    a = args(128, 64 * 64, 96, 3, 32, 384)
    ha = [a[0].reshape(128, 64, 64, 96), *a[1:4], *a[5:],
          0.2 * torch.randn(3, 64, 144, device="cuda")]
    dz = torch.randn(128, 64, 64, 96, device="cuda")
    _, saved = fhl.fused_halo_layer_fwd(*ha, 3, r, r, window=8, halo=2)
    out["B4 Halo1 fwd"] = ms(lambda: fhl.fused_halo_layer_fwd(*ha, 3, r, r, window=8, halo=2))
    out["B4 Halo1 bwd"] = ms(lambda: fhl.fused_halo_layer_bwd(saved, dz))
    del ha, saved
    for name, (B, N, H, D, G) in (("B3 ViT", (128, 197, 6, 64, 0)),
                                  ("B3 Swin1", (2048, 98, 3, 32, 32))):
        g = torch.Generator("cuda").manual_seed(1)
        qkv = torch.randn(B, N, 3 * H * D, device="cuda", generator=g)
        do = torch.randn(B, N, H * D, device="cuda", generator=g)
        extra = 0.2 * torch.randn(G, H, N, N, device="cuda", generator=g) if G else None
        _, saved = fa.fused_attention_qkv_fwd(qkv, H, extra)
        out[name + " fwd"] = ms(lambda: fa.fused_attention_qkv_fwd(qkv, H, extra))
        out[name + " bwd"] = ms(lambda: fa.fused_attention_qkv_bwd(saved, do))
    try:  # B8 (in the trees since it was ported)
        from vision_transformers_tpu_torch.ops import fused_block as fb
    except ImportError:
        fb = None
    if fb is not None:
        a = args(128, 197, 384, 6, 64, 1536)
        dz = torch.randn(128, 197, 384, device="cuda")
        _, saved = fb.fused_attention_block_fwd(a[0], *a[3:7], 6)
        out["B8 ViT fwd"] = ms(lambda: fb.fused_attention_block_fwd(a[0], *a[3:7], 6))
        out["B8 ViT bwd"] = ms(lambda: fb.fused_attention_block_bwd(saved, dz))
        del saved
    g = torch.Generator("cuda").manual_seed(2)
    q, kv, do = (torch.randn(128, 64, 64, c, device="cuda", generator=g) for c in (96, 192, 96))
    bias = 0.2 * torch.randn(3, 64, 144, device="cuda", generator=g)
    _, saved = fh.halo_attention_direct_fwd(q, kv, bias, 8, 2, 3)
    out["B5a Halo1 fwd"] = ms(lambda: fh.halo_attention_direct_fwd(q, kv, bias, 8, 2, 3))
    out["B5a Halo1 bwd"] = ms(lambda: fh.halo_attention_direct_bwd(saved, do))
    try:
        from vision_transformers_tpu_torch.ops import fused_swin as fs
    except ImportError:
        fs = None
    for name, (size, C, H, F, groups) in (("B9 Swin1", (56, 96, 3, 384, 32)),
                                          ("B9 Swin3", (14, 384, 12, 1536, 2))):
        if fs is None:
            break
        a = args(64, size * size, C, H, 32, F)
        a[0] = a[0].reshape(64, size, size, C)
        extra = 0.2 * torch.randn(groups, H, 98, 98, device="cuda")
        dz = torch.randn(64, size, size, C, device="cuda")
        r = torch.ones(64, device="cuda")
        kw = dict(window=7, shift=True, pack=2)
        _, saved = fs.fused_swin_layer_fwd(*a, H, extra, r, r, **kw)
        out[name + " fwd"] = ms(lambda: fs.fused_swin_layer_fwd(*a, H, extra, r, r, **kw))
        out[name + " bwd"] = ms(lambda: fs.fused_swin_layer_bwd(saved, dz))
        del saved
    registers, entry = {}, None
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif ("registers" in line or "spill" in line) and entry and any(
                f"_{src}_cu_" in entry for src in ("fused_layer", "fused_layer_bwd",
                                                  "fused_layer1_bwd")):
            source = entry.split("_cu_")[0].split("__")[-1].split("_", 2)[2]
            key = f"{source} {entry.split('_cu_')[1][8:]}"
            registers[key] = (registers.get(key, "") + " " + line.split(": ")[-1]).strip()
    print(card)
    for key, used in sorted(registers.items()):
        print(f"ptxas: {key}: {used}")
    print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else ".", **out}))


if __name__ == "__main__":
    main()
