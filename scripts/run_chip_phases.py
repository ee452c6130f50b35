#!/usr/bin/env python3
"""Run a few of chip_smoke.py's phases on the GPU, for a short check of a
kernel change: the probe, the build (ptxas's registers and spills, the
tensor-core instruction counts) and the named kernel phases, each printing
the same lines as in the whole script, then each timed record as one JSON
line.

    python3 scripts/run_chip_phases.py            # 3s and 3q
    python3 scripts/run_chip_phases.py 3s         # the reduced-kv attention only
    python3 scripts/run_chip_phases.py 3m 3k      # the GEMM core and B8

Phases: ``3m`` (the GEMM core under every projection of B1, B2, B4, B7, B8 and
B9), ``3`` (the forwards of the attention layer B1 and the whole layer B2,
Swin-S's stages and Twins-SVT-S stage 3's mask call among them), ``3v`` (B1's
training forward and backward at ViT-S/16, no bias), ``3b`` (B2's training
forward and backward at Swin-S's stages and without a bias at ViT-S/16's
widths), ``3t`` (B1 with Twins' pair mask at stages 1-3 and without one at
stage 4, forward and backward), ``3a`` (the tensor-core window attention alone,
under B1's bias calls, B2 and B9), ``3s`` (the reduced-kv attention, B6),
``3q`` (the packed-qkv attention, B3), ``3h`` (the Halo kernels' forwards: the
whole Halo layer B4 and the halo attention B5a), ``3hb`` (their backwards),
``3g`` (the gathered halo attention, B5b), ``3k`` (the attention block, B8),
``3w`` (the map-resident Swin layer, B9), ``3f`` (the FF layer, B7), ``3d`` (B1
with DINO's block mask at heads 64 wide), ``3dbf`` (the same at bf16),
``3bf`` (the bf16 forms: the GEMM core's, B1 forward and backward, B2's
serving forward, the packed-row attention beside SDPA, with and without the
bias), and chip_smoke's model phases ``4d`` (the DINO golden), ``4dbf`` (the
DINO golden at bf16), ``6d`` (the DINO trainer at f32 and at bf16, side by
side), ``4bf`` (ViT-S/16 at bf16 against its golden), ``6bf`` (the
ViT-S/16 trainer at f32 and at bf16, side by side), ``3sbf`` (Swin-S's bf16
kernels: B2's training forward and backward with the grouped bias and the
packed-row attention's backward with the bias's gradient, at the four
stages, beside SDPA and the f32 window attention), ``4sbf`` (Swin-S at bf16
against its golden), ``6sbf`` (the Swin-S trainer at f32 and at bf16,
side by side), ``3hbf`` (Halo-S's bf16 kernels: B4's training forward,
serving forward and backward at the four stages, B5a and B5b at stage 1,
B5b at window 4 / halo 3 too, beside SDPA), ``4hbf`` (Halo-S at bf16
against its golden) and ``6hbf`` (the Halo-S trainer at f32 and at bf16,
side by side, then at bf16 forced to 'direct').
Exits non-zero when a phase fails.  Needs CUDA; imports no JAX.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = {"3m": "gemm_kernels", "3": "kernels", "3v": "backward_kernel",
          "3b": "swin_backward_kernel",
          "3t": "twins_layer_kernels", "3a": "window_kernels", "3s": "sra_kernels",
          "3q": "qkv_kernels", "3h": "halo_kernels", "3hb": "halo_backward_kernels",
          "3g": "gather_kernels", "3k": "block_kernels", "3w": "swin_map_kernels",
          "3f": "ff_kernels", "3d": "dino_layer_kernels", "4d": "dino_golden",
          "6d": "dino_trainers", "3bf": "bf16_kernels", "4bf": "bf16_golden",
          "6bf": "vit_trainers", "3dbf": "dino_bf16_layer_kernels",
          "4dbf": "dino_bf16_golden", "3sbf": "swin_bf16_kernels",
          "4sbf": "swin_bf16_golden", "6sbf": "swin_trainers",
          "3hbf": "halo_bf16_kernels", "4hbf": "halo_bf16_golden", "6hbf": "halo_trainers"}
DEFAULT = ("3s", "3q")


def main() -> None:
    which = sys.argv[1:] or list(DEFAULT)
    unknown = [p for p in which if p not in PHASES]
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; choose from {sorted(PHASES)}")
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

    t0 = time.perf_counter()
    chip_smoke.probe(torch)
    chip_smoke.build()
    for phase in which:
        fn = getattr(chip_smoke, PHASES[phase])
        result = fn(torch, False) if phase in ("6bf", "6sbf", "6hbf") else fn(torch)
        parts = result.values() if isinstance(result, dict) else result or ()
        # a phase returns records, lists of records or {kernel: records}
        # (a model phase: None, or its launch counts)
        records = [r for part in parts if isinstance(part, (dict, list, tuple))
                   for r in ([part] if isinstance(part, dict) else part)]
        for rec in records:
            print(json.dumps({"phase": phase, **rec}), flush=True)
    print(f"phases {' '.join(which)} ok in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
