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
``3w`` (the map-resident Swin layer, B9) and ``3f`` (the FF layer, B7).  Exits
non-zero when a phase fails.  Needs CUDA; imports no JAX.
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
          "3f": "ff_kernels"}
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
        result = getattr(chip_smoke, PHASES[phase])(torch)
        parts = result.values() if isinstance(result, dict) else result or ()
        # a phase returns records, lists of records or {kernel: records}
        records = [r for part in parts for r in ([part] if isinstance(part, dict) else part)]
        for rec in records:
            print(json.dumps({"phase": phase, **rec}), flush=True)
    print(f"phases {' '.join(which)} ok in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
