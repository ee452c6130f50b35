#!/usr/bin/env python3
"""Time the port's trainer step of one source tree on the GPU, every model
and path that chip_smoke.py's phase 6 trains, for a parent / change
comparison run in turns within one call:

    for t in parent . . parent; do python3 scripts/ab_port_trainer.py $t; done
    python3 scripts/ab_port_trainer.py . "ViT-S/16 block" "Swin-S swin"
    python3 scripts/ab_port_trainer.py . --precision bf16 "ViT-S/16"

``ROOT`` (default: this checkout) is the tree whose
``vision_transformers_tpu_torch`` is imported and built; labels after it
(those of ``RUNS``) keep only those runs.  Each run is
``train.main`` at batch 128 for one synthetic epoch (4 steps, then the
256-image valid pass), as phase 6 runs it: ViT-S/16 (default; dropout;
the FF kernel; 'block' with and without dropout), Swin-S ('layer1'
default; 'swin' through ``VTX_ATTN_IMPL``; dropout), Halo-S at DropPath
0.1 ('layer' default; 'direct'; 'gather'; window 4 / halo 3), PVT-S with
its reduced-kv attention 'fused' and Twins-SVT-S at DropPath 0.1; f32
unless ``--precision bf16`` (the JAX package's default precision, which
only ViT's runs take), so that earlier records stay comparable.  Prints
the card, each run's step times (steps 2-4, each ended by
``torch.cuda.synchronize()``) and their mean, and one JSON line.  Uses
only the train entry point and the ``ops.set_*`` forces, so it runs any
tree since those exist.  Needs CUDA; imports no JAX.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HALO_DP = ("arch.drop_path=0.1",)
DROPOUT = ("arch.dropout=0.1", "arch.drop_ff=0.1")
# (label, conf, overrides, forces: halo / sra / attn / ff, environment)
RUNS = (("ViT-S/16", "configs/vit-s-16.conf", (), {}, {}),
        ("ViT-S/16 dropout", "configs/vit-s-16.conf", DROPOUT, {}, {}),
        ("ViT-S/16 FF kernel", "configs/vit-s-16.conf", (), {"ff": True}, {}),
        ("ViT-S/16 block", "configs/vit-s-16.conf", (), {"attn": "block"}, {}),
        ("ViT-S/16 block dropout", "configs/vit-s-16.conf", DROPOUT, {"attn": "block"}, {}),
        ("Swin-S", "configs/swin-transformer-s.conf", (), {}, {}),
        ("Swin-S swin", "configs/swin-transformer-s.conf", (), {},
         {"VTX_ATTN_IMPL": "swin"}),
        ("Swin-S dropout", "configs/swin-transformer-s.conf",
         ("arch.drop_attn=0.1", "arch.drop_ff=0.1"), {}, {}),
        ("Halo-S", "tests/data/halo_s_port.conf", HALO_DP, {}, {}),
        ("Halo-S direct", "tests/data/halo_s_port.conf", HALO_DP, {"halo": "direct"}, {}),
        ("Halo-S gather", "tests/data/halo_s_port.conf", HALO_DP, {"halo": "gather"}, {}),
        ("Halo-S w4 h3", "tests/data/halo_s_port.conf",
         ("arch.window_size=4", "arch.halo_size=3") + HALO_DP, {}, {}),
        ("PVT-S fused", "tests/data/pvt_s_port.conf", (), {"sra": "fused"}, {}),
        ("Twins-SVT-S", "tests/data/twins_svt_s_port.conf", HALO_DP, {}, {}))


@contextlib.contextmanager
def forced(ops, halo=None, sra=None, attn=None, ff=None):
    ops.set_halo_impl(halo)
    ops.set_sra_impl(sra)
    ops.set_attention_impl(attn)
    ops.set_ff_kernel(ff)
    try:
        yield
    finally:
        ops.set_halo_impl(None)
        ops.set_sra_impl(None)
        ops.set_attention_impl(None)
        ops.set_ff_kernel(None)


@contextlib.contextmanager
def environ(env):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main() -> None:
    argv = sys.argv[1:]
    precision = "f32"
    if "--precision" in argv:
        i = argv.index("--precision")
        precision = argv[i + 1]
        del argv[i:i + 2]
        if precision not in ("f32", "bf16"):
            raise SystemExit(f"--precision f32 or bf16, got {precision!r}")
    root = os.path.abspath(argv[0] if argv else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    from vision_transformers_tpu_torch import ops, train
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.train import engine

    if not _build.__file__.startswith(root):
        raise SystemExit(f"imported {_build.__file__}, not the tree under {root}")
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    train_step = engine.train_step
    out = {}
    only = argv[1:]
    unknown = set(only) - {run[0] for run in RUNS}
    if unknown:
        raise SystemExit(f"unknown runs {sorted(unknown)}")
    for label, conf, overrides, forces, env in RUNS:
        if only and label not in only:
            continue
        steps = []

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            res = train_step(*args, **kwargs)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            return res

        with tempfile.TemporaryDirectory() as tmp:
            args = ["--conf", os.path.join(root, conf), "--device", "cuda", f"precision={precision}",
                    "training.dataloader.batch_size=128", "training.epoch=1",
                    "data_backend=synthetic", "log_freq=1", *overrides,
                    f"checker.storage=[{{type: local, path: {tmp}}}]"]
            engine.train_step = timed
            try:
                with forced(ops, **forces), environ(env):
                    train.main(args)
            finally:
                engine.train_step = train_step
        ms = [1e3 * s for s in steps[1:]]
        out[label] = sum(ms) / len(ms)
        print(f"{label}: steps 2-{len(steps)} " + " / ".join(f"{t:.2f}" for t in ms)
              + f" ms, mean {out[label]:.2f} ms", flush=True)
    print(card)
    print(json.dumps({"tree": argv[0] if argv else ".", "precision": precision, **out}))


if __name__ == "__main__":
    main()
