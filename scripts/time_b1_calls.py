#!/usr/bin/env python3
"""Time the attention layer B1's training calls of one source tree on the
GPU, for a parent / change comparison run in turns within one call:

    for t in parent . . parent parent . . parent; do
        python3 scripts/time_b1_calls.py $t; done
    python3 scripts/time_b1_calls.py . --hold-workspace

``ROOT`` (default: this checkout) is the tree whose
``vision_transformers_tpu_torch`` is imported and built.  Times, as medians
of 20 CUDA-event timings after 3 warm-up calls, ``fused_attention_layer``'s
forward with saves and its backward (no bias gradient) with a row scale at
ViT-S/16, B = 128 (197 tokens, C 384, 6 heads of 64, no bias) and at the
four Twins-SVT-S stages at 128 images (the pair mask at stages 1-3: 4096 /
1024 / 256 rows of 98 tokens; stage 4: 128 rows of 49 tokens, no mask).
``--hold-workspace`` allocates two [B·N, C] tensors just before each
backward and frees them after it, as a backward that still took the ``u``
and ``da`` workspaces would: whether a time difference comes from the
caching allocator's placement rather than from the kernels.  Prints the
card and one JSON line.  Needs CUDA; imports no JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

# (label, rows, tokens, C, heads, D, pair mask)
CALLS = (("ViT", 128, 197, 384, 6, 64, False),
         ("Twins1", 4096, 98, 64, 2, 32, True),
         ("Twins2", 1024, 98, 128, 4, 32, True),
         ("Twins3", 256, 98, 256, 8, 32, True),
         ("Twins4", 128, 49, 512, 16, 32, False))


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    hold = "--hold-workspace" in sys.argv[1:]
    root = os.path.abspath(args[0] if args else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    sys.path.insert(0, root)
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import fused_layer as fl

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

    out = {}
    for label, rows, N, C, H, D, masked in CALLS:
        g = torch.Generator("cuda").manual_seed(0)

        def n(*shape, s=1.0, m=0.0):
            return m + s * torch.randn(*shape, device="cuda", generator=g)

        HD = H * D
        a = [n(rows, N, C), n(C, s=0.1, m=1.0), n(C, s=0.1), n(3 * HD, C, s=0.05).t(),
             n(3 * HD, s=0.1), n(C, HD, s=0.05).t(), n(C, s=0.1)]
        dz = n(rows, N, C)
        r = torch.ones(rows, device="cuda")
        mask = None
        if masked:
            win = torch.arange(N, device="cuda") // (N // 2)
            mask = torch.where(win[:, None] == win[None, :], 0.0, -1e9)
        _, saved = fl.fused_attention_layer_fwd(*a, H, row_scale=r, extra=mask)

        def bwd():
            held = [torch.empty(rows * N, C, device="cuda") for _ in range(2)] if hold else []
            fl.fused_attention_layer_bwd(saved, dz, need_dextra=False)
            del held

        out[f"{label} fwd"] = ms(lambda: fl.fused_attention_layer_fwd(*a, H, row_scale=r,
                                                                      extra=mask))
        out[f"{label} bwd"] = ms(bwd)
        del a, dz, saved
    print(card)
    print(json.dumps({"tree": args[0] if args else ".", "hold_workspace": hold, **out}))


if __name__ == "__main__":
    main()
