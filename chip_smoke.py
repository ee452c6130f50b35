#!/usr/bin/env python3
"""Start-up check of the PyTorch port (vision_transformers_tpu_torch) on one
NVIDIA H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version, runs full-width ViT-S/16, Swin-S and Halo-S against the JAX
package's stored logits and train-step gradients, and drives the serving and
the training entry points of the three models end to end.

    python3 chip_smoke.py

Phases (each prints its lines and raises on failure, so the script exits
non-zero and prints no ok line):

1. probe   torch / CUDA / nvcc / nvidia-smi / PIL; the card must be sm_90
2. build   nvcc → shared library, one nvcc per source in parallel (timed)
3. kernels each forward kernel vs its plain version, f32, atol = rtol = 1e-4
           (same f32 math, another summation order over K ≤ 3072): at an odd
           small shape, at every ViT-S shape phases 5 and 6 give it (48 / 160
           rows serving, 128 rows the trainer's eval) and at the timed ViT-S
           shapes; the whole-layer kernel also with Swin's grouped bias and
           both row scales at an odd small shape and at every Swin-S stage of
           the trainer (64 images) and of its eval (128 images); median ms of
           kernel and plain version
3b. backward each forward (with saves) + backward kernel vs the plain forward
           + plain backward, with and without row scales; per tensor max |Δ|
           ≤ 1e-3·max(1, max|plain|) (f32 sums over all rows in another
           order); two runs bit-identical; median ms.  The attention layer
           at an odd small shape and at the ViT trainer's B=128; the whole
           layer, with the grouped bias, at an odd small shape and at the
           four Swin-S stages of the trainer's 64-image micro-batches
3h. halo   the Halo kernels vs their plain versions at two odd small shapes
           and at the four Halo-S @256 stages at 128 images (the trainer's
           batch and its eval's): the whole Halo layer's forward (serving
           call, no saves) with the bias and both row scales, atol = rtol =
           1e-4; the map-resident halo attention's forward, and its time
           beside F.scaled_dot_product_attention with the bias as attn_mask
           on the gathered [b·S, H, w², k²] problem (gather excluded)
3hb.       each Halo kernel's forward (with saves) + backward vs the plain
           forward + plain backward, the layer with and without row scales;
           per tensor ≤ 1e-3·max(1, max|plain|); two runs bit-identical;
           median ms at each stage's training call
4. golden  ViT-S/16 @224 (depth 12), Swin-S @224 (depth 24) and Halo-S @256
           (depth 12), seeded weights, against the JAX logits in
           tests/data/*_port_golden.npz: ViT at 64 rows ('layer') and 256
           rows ('layer1'), Swin at 64 and 128 rows ('layer1'), Halo at 64
           and 128 rows (the whole Halo layer); max |Δ| ≤ 1e-3·max(1,
           max|golden|)
4b. train  one f32 train-step gradient (drop_path 0) of each model on the 2
           golden images tiled to 64 rows (ViT through the attention layer's
           kernels, Swin through the whole layer's, Halo through the whole
           Halo layer's and, forced to 'direct', through the halo
           attention's) against tests/data/*_port_train_golden.npz: loss,
           gradient norm, per-tensor norms and projections, rtol 1e-3
5. predict the serving path of each model: ``predict.main`` on 48 and then
           160 seeded JPEGs (Halo: 48 at 256 px) with a seeded ``.pt:ema``;
           the launch counters are zeroed just before and read just after
6. trainer each model's training path: ``train.main`` f32, batch 128, one
           synthetic epoch (4 train steps, then a valid pass of 256 images)
           — ViT-S/16 from configs/vit-s-16.conf (DropPath 0.1 through the
           attention layer's forward and backward kernels, eval through the
           whole-layer kernel), Swin-S from configs/swin-transformer-s.conf
           (grad_accumulation 2, so 64-image micro-batches, DropPath 0.3,
           forward and backward of the whole-layer kernel), Halo-S from
           tests/data/halo_s_port.conf (DropPath 0.1; 12 forward and 12
           backward whole-Halo-layer launches per step, none of another
           path) and Halo-S forced to 'direct' (the halo attention's forward
           and backward between plain projections); the counters are zeroed
           just before and read just after each; then ``predict.main`` reads
           the epoch checkpoint

The line before the last is the kernels' JSON record: each kernel's
launches on the trainer run that takes it (ViT's for the attention layer,
Swin's for the whole layer, Halo's for the whole Halo layer, Halo's forced
to 'direct' for the halo attention; every path's in ``launches_by_path``)
and its
times at a call that run makes (``shape``; other shapes in
``other_shapes``); the last line is ``{"ok": true, "device": {...}}``.
Needs no network and no JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
MODELS = {  # name → (conf, logits golden, train-step golden, depth)
    "ViT-S/16": (os.path.join(ROOT, "configs", "vit-s-16.conf"),
                 os.path.join(DATA, "vit_s16_port_golden.npz"),
                 os.path.join(DATA, "vit_s16_port_train_golden.npz"), 12),
    "Swin-S": (os.path.join(ROOT, "configs", "swin-transformer-s.conf"),
               os.path.join(DATA, "swin_s_port_golden.npz"),
               os.path.join(DATA, "swin_s_port_train_golden.npz"), 24),
    "Halo-S": (os.path.join(DATA, "halo_s_port.conf"),
               os.path.join(DATA, "halo_s_port_golden.npz"),
               os.path.join(DATA, "halo_s_port_train_golden.npz"), 12),
}
KERNELS = {  # name → (source, the TPU kernel it replaces)
    "fused_attention_layer": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                              "vision_transformers_tpu/ops/fused_layer.py:116"),
    "fused_attention_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_layer_bwd.cu",
                                  "vision_transformers_tpu/ops/fused_layer.py:183"),
    "fused_transformer_layer": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                                "vision_transformers_tpu/ops/fused_layer1.py:91"),
    "fused_transformer_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_layer1_bwd.cu",
                                    "vision_transformers_tpu/ops/fused_layer1.py:181"),
    "fused_halo_layer": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                         "vision_transformers_tpu/ops/fused_halo_layer.py:92"),
    "fused_halo_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                             "vision_transformers_tpu/ops/fused_halo_layer.py:179"),
    "halo_attention_direct": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                              "vision_transformers_tpu/ops/fused_halo.py:252"),
    "halo_attention_direct_bwd": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                                  "vision_transformers_tpu/ops/fused_halo.py:282"),
}
KERNEL_TOL = 1e-4
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd, timeout=60) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# 1. probe
# ---------------------------------------------------------------------------


def probe(torch):
    if not torch.cuda.is_available():
        raise SystemExit("probe: torch.cuda.is_available() is false; "
                         "chip_smoke.py needs an NVIDIA H100")
    from vision_transformers_tpu_torch.ops import _build

    log(f"probe: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    name, cap = torch.cuda.get_device_name(0), torch.cuda.get_device_capability(0)
    log(f"probe: device 0 {name}, capability {cap}, count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"probe: the kernels are built for sm_90a; device 0 is {cap}")
    nvcc = _build.find_nvcc()
    log(f"probe: {nvcc}: " + run([nvcc, "--version"]).splitlines()[-1])
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = smi.splitlines()[0]
    log(card)
    try:
        import PIL
        has_pil = True
        log(f"probe: PIL {PIL.__version__} imports")
    except ImportError:
        has_pil = False
        log("probe: PIL does not import")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"probe: allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name, card, has_pil


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def build():
    from vision_transformers_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"build: {line.strip()}")
    return secs


# ---------------------------------------------------------------------------
# work counts and bounds
# ---------------------------------------------------------------------------

H100_F32_FLOPS = 67e12   # f32 FMA peak outside the tensor cores, 700 W
H100_BYTES = 3.35e12     # HBM3 rate


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time for this work on the card."""
    t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_fwd_work(B, N, C, H, D, saves=False):
    """(operations, bytes) of the attention half's forward: four projection
    products and two attention products; x, weights in, out written, and
    with ``saves`` the residuals (qkv, acc, mu, rstd, lse) written too."""
    M, HD = B * N, H * D
    flops = 8 * M * C * HD + 4 * B * H * N * N * D
    nbytes = 4 * (2 * M * C + 4 * C * HD + 3 * HD + 3 * C + B)
    if saves:
        nbytes += 4 * (4 * M * HD + 2 * M + B * H * N)
    return flops, nbytes


def layer_fwd_work(B, N, C, H, D, F, groups=0, row_scales=False, saves=False):
    """(operations, bytes) of the whole layer's forward: the attention half
    plus the FF GEMMs (4·M·C·F); with ``groups`` the bias [G, H, N, N] read,
    with ``saves`` qkv, acc, z, hid and the statistics written."""
    M, HD = B * N, H * D
    flops = 8 * M * C * HD + 4 * M * C * F + 4 * B * H * N * N * D
    nbytes = 4 * (2 * M * C + 4 * C * HD + 2 * C * F + 3 * HD + 5 * C + F
                  + groups * H * N * N + (2 * B if row_scales else 0))
    if saves:
        nbytes += 4 * (4 * M * HD + M * C + M * F + 4 * M + B * H * N)
    return flops, nbytes


def attn_bwd_work(B, N, C, H, D):
    """(operations, bytes) of the backward: the four projection products of
    the weight and input gradients (16·M·C·HD) and five attention products
    (recomputed scores, dv, dp, dk, dq); reads x, dz, the saves and the
    weights once, writes dx and the parameter gradients once."""
    M, HD = B * N, H * D
    flops = 16 * M * C * HD + 10 * B * H * N * N * D
    nbytes = 4 * (3 * M * C + 4 * M * HD + 2 * M + B * H * N
                  + 2 * (4 * C * HD + 3 * HD + 3 * C) + 2 * B)
    return flops, nbytes


def layer_bwd_work(B, N, C, H, D, F, groups=0, row_scales=False):
    """(operations, bytes) of the whole layer's backward: the attention
    half's (attn_bwd_work) plus the FF half's four GEMMs (8·M·C·F); reads x,
    do, the saves (qkv, acc, z, hid, statistics, lse), the weights and the
    bias once, writes dx, the parameter gradients and dextra once."""
    M, HD = B * N, H * D
    flops = 16 * M * C * HD + 8 * M * C * F + 10 * B * H * N * N * D
    nbytes = 4 * (3 * M * C + 4 * M * HD + M * C + M * F + 4 * M + B * H * N
                  + 2 * (4 * C * HD + 2 * C * F + 3 * HD + 7 * C + F)
                  + 2 * groups * H * N * N + (4 * B if row_scales else 0))
    return flops, nbytes


def halo_layer_fwd_work(B, H, W, C, nh, D, F, window, halo, row_scales=False,
                       saves=False):
    """(operations, bytes) of the whole Halo layer's forward on M = B·H·W
    tokens: the four projection GEMMs (8·M·C·HD + 4·M·C·F) and halo
    attention over k² = (w + 2·halo)² positions (4·M·k²·HD); x, the weights
    and the bias [nh, w², k²] read, out written, and with ``saves`` qkv,
    acc, z, hid, the statistics and lse written too."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    flops = 8 * M * C * HD + 4 * M * C * F + 4 * M * k2 * HD
    nbytes = 4 * (2 * M * C + 4 * C * HD + 2 * C * F + 6 * C + F
                  + nh * window * window * k2 + (2 * B if row_scales else 0))
    if saves:
        nbytes += 4 * (4 * M * HD + M * C + M * F + 4 * M + nh * M)
    return flops, nbytes


def halo_layer_bwd_work(B, H, W, C, nh, D, F, window, halo, row_scales=False):
    """(operations, bytes) of the whole Halo layer's backward: 16·M·C·HD +
    8·M·C·F of GEMMs and five halo attention products (recomputed scores,
    dv, dp, dk, dq: 10·M·k²·HD); reads x, do, the saves and the weights and
    bias once, writes dx, the parameter gradients and dbias once."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    flops = 16 * M * C * HD + 8 * M * C * F + 10 * M * k2 * HD
    params = 4 * C * HD + 2 * C * F + 6 * C + F
    nbytes = 4 * (3 * M * C + 4 * M * HD + M * C + M * F + 4 * M + nh * M
                  + 2 * params + 2 * nh * window * window * k2
                  + (4 * B if row_scales else 0))
    return flops, nbytes


def halo_attn_fwd_work(B, H, W, nh, D, window, halo, saves=False):
    """(operations, bytes) of halo attention off the maps: 4·M·k²·HD; q, kv
    and the bias read, out (and with ``saves`` lse) written."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    nbytes = 4 * (4 * M * HD + nh * window * window * k2 + (nh * M if saves else 0))
    return 4 * M * k2 * HD, nbytes


def halo_attn_bwd_work(B, H, W, nh, D, window, halo):
    """(operations, bytes) of its backward: five products, 10·M·k²·HD; q,
    kv, out, lse, do and the bias read, dq, dkv and dbias written."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    return 10 * M * k2 * HD, 4 * (8 * M * HD + nh * M + 2 * nh * window * window * k2)


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------


def layer_args(torch, B, N, C, H, D, F, seed=0):
    """Seeded f32 inputs on the card; weights as transposed views of
    [out, in] matrices, as the model passes ``linear.weight.t()``."""
    rng = np.random.default_rng(seed)
    HD = H * D

    def n(*shape, s=1.0, mean=0.0):
        a = (mean + s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(DEVICE)

    def w(k, m):
        return n(m, k, s=0.05).t()

    return [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            w(C, 3 * HD), n(3 * HD, s=0.1), w(HD, C), n(C, s=0.1),
            n(C, s=0.1, mean=1.0), n(C, s=0.1),
            w(C, F), n(F, s=0.1), w(F, C), n(C, s=0.1)]


def median_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def vit_shape(B):
    """ViT-S/16 @224 layer shape (B, N, C, H, D, F) at B rows."""
    return (B, 197, 384, 6, 64, 1536)


def swin_stages(images):
    """The whole-layer kernel's calls in Swin-S @224 at ``images`` images,
    one per stage: dicts of the layer shape (rows = groups·images, N = m
    tokens of a packed window pair or window), the window geometry and the
    depth, from configs/swin-transformer-s.conf."""
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.models.swin import window_pack

    arch = load_config(MODELS["Swin-S"][0]).arch
    win = arch.window_size
    size = arch.image_size[0] // 4
    out = []
    for s in range(4):
        if s:
            size //= 2
        pack = window_pack(win, (size, size))
        groups = (size // win) ** 2 // pack
        out.append(dict(stage=s + 1, size=(size, size), window=win, images=images,
                        groups=groups, depth=arch.depths[s],
                        shape=(groups * images, pack * win * win, arch.dims[s],
                               arch.n_heads[s], arch.dim_head, arch.dim_ffs[s])))
    return out


# the odd small whole-layer call: 3 images of a 6x6 map, 3x3 windows packed in
# pairs (2 groups, m = 18 tokens), head width 24
SWIN_ODD = dict(stage="odd", size=(6, 6), window=3, images=3, groups=2, depth=1,
                shape=(6, 18, 48, 2, 24, 96))


def swin_layer_inputs(torch, call, row_scales, seed=0):
    """Seeded inputs of one whole-layer call: ``layer_args``, the grouped
    bias [G, H, m, m] of a shifted layer built by the port's WindowAttention
    (a std-0.2 table, −1e9 off a pair's diagonal blocks, the shift mask) and,
    with ``row_scales``, two per-image DropPath scales (keep 0.9) tiled over
    the groups as SwinLayer tiles them."""
    from vision_transformers_tpu_torch.models.swin import WindowAttention

    rows, N, C, H, D, F = call["shape"]
    a = layer_args(torch, *call["shape"], seed=seed)
    attn = WindowAttention(C, H, D, call["size"], call["window"], shift=True)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        attn.rel_pos.weight.normal_(0.0, 0.2, generator=gen)
        extra = attn.to(DEVICE).grouped_bias()
    if extra.shape != (call["groups"], H, N, N):
        raise RuntimeError(f"swin inputs: bias {tuple(extra.shape)} for {call}")
    rs = [None, None]
    if row_scales:
        rng = np.random.default_rng(seed + 100)
        for i in range(2):
            keep = rng.random(call["images"]) < 0.9
            keep[0], keep[-1] = False, True  # both kinds at every shape
            r = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
            rs[i] = r.repeat(call["groups"])
    return a, extra, rs


def check_close(torch, name, out, ref, what):
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"kernels: {name} {what}: bad output")
    err = (out - ref).abs().max().item()
    ok = torch.allclose(out, ref, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    log(f"kernels: {name} {what}: max|kernel-plain| {err:.3e} "
        f"(atol=rtol={KERNEL_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"kernels: {name} disagrees with its plain version")
    return err


def kernels(torch):
    """3: each forward kernel (serving call, no saves) against its plain
    version at an odd shape, at every ViT shape phases 5 and 6 give it and at
    the timed shapes; the whole-layer kernel also at every Swin-S call, with
    the grouped bias and both row scales.  The training calls (saves) are
    held in 3b.  Returns {kernel: [timed entries]}."""
    from vision_transformers_tpu_torch.ops import fused_layer, fused_layer1

    # (kernel, plain version, the main paths' shapes, the timed shapes)
    ops = {
        "fused_attention_layer": (
            lambda a, H: fused_layer.fused_attention_layer(*a[:7], H),
            lambda a, H: fused_layer.fused_attention_layer_reference(*a[:7], H),
            [vit_shape(48)], [vit_shape(64)]),
        "fused_transformer_layer": (
            lambda a, H: fused_layer1.fused_transformer_layer(*a, H),
            lambda a, H: fused_layer1.fused_transformer_layer_reference(*a, H),
            [vit_shape(160), vit_shape(128)], [vit_shape(256), vit_shape(128)]),
    }
    odd = (3, 37, 48, 2, 24, 96)
    results = {"fused_attention_layer": [], "fused_transformer_layer": []}
    for name, (kernel, plain, main_shapes, timed) in ops.items():
        for shape in dict.fromkeys((odd, *main_shapes, *timed)):
            a = layer_args(torch, *shape)
            out = kernel(a, shape[3])
            torch.cuda.synchronize()
            err = check_close(torch, name, out, plain(a, shape[3]),
                              "B,N,C,H,D,F=" + str(shape))
            if shape in timed:
                H = shape[3]
                ms = median_ms(torch, lambda: kernel(a, H))
                plain_ms = median_ms(torch, lambda: plain(a, H))
                work = attn_fwd_work(*shape[:5]) if name == "fused_attention_layer" \
                    else layer_fwd_work(*shape)
                bound_ms, by = bound(*work)
                log(f"kernels: {name} ViT-S B={shape[0]}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms (median of 20, CUDA events); bound "
                    f"{bound_ms:.3f} ms ({by})")
                results[name].append({
                    "shape": "ViT-S, B,N,C,H,D,F=" + ",".join(map(str, shape)),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None})

    # Swin-S: the grouped bias and both row scales (the eval's calls are
    # timed: the trainer's training calls are timed in 3b)
    name = "fused_transformer_layer"
    calls = [SWIN_ODD] + swin_stages(64) + swin_stages(128)
    for call in calls:
        a, extra, (r1, r2) = swin_layer_inputs(torch, call, row_scales=True)
        H = call["shape"][3]
        out = fused_layer1.fused_transformer_layer(*a, H, extra, r1, r2)
        torch.cuda.synchronize()
        ref = fused_layer1.fused_transformer_layer_reference(*a, H, extra, r1, r2)
        what = (f"Swin stage {call['stage']} at {call['images']} images, "
                f"B,N,C,H,D,F={call['shape']}, G={call['groups']}, row scales")
        err = check_close(torch, name, out, ref, what)
        if call["images"] == 128:
            a, extra, _ = swin_layer_inputs(torch, call, row_scales=False)
            ms = median_ms(torch, lambda: fused_layer1.fused_transformer_layer(*a, H, extra))
            plain_ms = median_ms(
                torch, lambda: fused_layer1.fused_transformer_layer_reference(*a, H, extra))
            bound_ms, by = bound(*layer_fwd_work(*call["shape"], groups=call["groups"]))
            log(f"kernels: {name} Swin stage {call['stage']} eval call (128 images, "
                f"{call['shape'][0]} rows, bias, no saves): kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({by})")
            results[name].append({
                "shape": f"Swin-S stage {call['stage']} eval, B,N,C,H,D,F="
                         + ",".join(map(str, call["shape"])) + f", G={call['groups']}",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
    return results


# ---------------------------------------------------------------------------
# 3b. the backward kernels vs their plain versions
# ---------------------------------------------------------------------------


def bwd_args(torch, B, N, C, H, D, rs, seed=1):
    """Seeded forward inputs (weights as transposed views), a row scale of
    dropped / kept samples (keep 0.9) when ``rs``, and the output grad."""
    a = layer_args(torch, B, N, C, H, D, 4 * C, seed=seed)[:7]
    rng = np.random.default_rng(seed + 100)
    r = None
    if rs:
        keep = rng.random(B) < 0.9
        keep[0], keep[-1] = False, True  # both kinds at every shape
        r = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
    dz = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(DEVICE)
    return a, r, dz


def compare_grads(torch, what, names, kernel, again, plain, worst):
    """Per tensor: finite, bit-identical across two kernel runs, within
    1e-3·max(1, max|plain|) of the plain version."""
    for name, k, k2, p in zip(names, kernel, again, plain):
        if p is None:
            if k is not None:
                raise RuntimeError(f"backward {what}: {name} should be None")
            continue
        if k.shape != p.shape or not torch.isfinite(k).all():
            raise RuntimeError(f"backward {what}: bad {name}")
        if not torch.equal(k, k2):
            raise RuntimeError(f"backward {what}: {name} differs between two runs "
                               f"of the kernel")
        err = (k - p).abs().max().item()
        tol = 1e-3 * max(1.0, p.abs().max().item())
        which = "out" if name == "out" else "grads"
        worst[which] = max(worst[which], err)
        log(f"backward: {what} {name}: max|kernel-plain| {err:.3e} (tol {tol:.3e}), "
            f"bit-identical across two runs")
        if err > tol:
            raise RuntimeError(f"backward: {name} disagrees with the plain version")


GRAD_NAMES = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout", "drs")


def backward_kernel(torch):
    """3b, the attention layer: forward (with saves) + backward kernel
    against the plain forward + plain backward, twice for bit-identity, at
    an odd shape and at the ViT trainer's calls (B=128: layer 0 without a
    row scale, the others with one); returns the timed records of the
    training forward and of the backward."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    train_shape = (128, 197, 384, 6, 64)
    worst = {"out": 0.0, "grads": 0.0}
    for shape, use_rs in (((3, 37, 48, 2, 24), False), ((3, 37, 48, 2, 24), True),
                          (train_shape, False), (train_shape, True)):
        a, rs, dz = bwd_args(torch, *shape, use_rs)
        H = shape[3]
        out, saved = fl.fused_attention_layer_fwd(*a, H, row_scale=rs)
        grads = fl.fused_attention_layer_bwd(saved, dz)
        again = fl.fused_attention_layer_bwd(saved, dz)
        torch.cuda.synchronize()
        out_p, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, row_scale=rs)
        plain = fl.fused_attention_layer_bwd_reference(saved_p, dz)
        compare_grads(torch, f"B,N,C,H,D={shape} rs={use_rs}", ("out",) + GRAD_NAMES,
                      (out,) + grads, (out,) + again, (out_p,) + plain, worst)

    a, rs, dz = bwd_args(torch, *train_shape, True)
    H = train_shape[3]
    _, saved = fl.fused_attention_layer_fwd(*a, H, row_scale=rs)
    _, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, row_scale=rs)
    fwd_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd(*a, H, row_scale=rs))
    ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd(saved, dz))
    plain_fwd_ms = median_ms(
        torch, lambda: fl.fused_attention_layer_fwd_reference(*a, H, row_scale=rs))
    plain_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd_reference(saved_p, dz))
    bwd_ms, by = bound(*attn_bwd_work(*train_shape))
    fwd_bound, fwd_by = bound(*attn_fwd_work(*train_shape, saves=True))
    log(f"backward: B=128 N=197 C=384 H=6 D=64 with rs (median of 20, CUDA events): "
        f"kernel fwd(saves) {fwd_ms:.3f} + bwd {ms:.3f} = {fwd_ms + ms:.3f} ms; "
        f"plain fwd {plain_fwd_ms:.3f} + bwd {plain_ms:.3f} = "
        f"{plain_fwd_ms + plain_ms:.3f} ms; bound fwd {fwd_bound:.3f} + bwd "
        f"{bwd_ms:.3f} ms ({by})")
    shape = "ViT-S, B,N,C,H,D=" + ",".join(map(str, train_shape)) + ", row scale"
    fwd = {"shape": shape + ", saves", "max_abs_err": worst["out"], "ms": fwd_ms,
           "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
           "library_ms": None}
    bwd = {"shape": shape, "max_abs_err": worst["grads"], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bwd_ms, "bound_by": by, "library_ms": None}
    return fwd, bwd


def swin_backward_kernel(torch):
    """3b, the whole layer: training forward (with saves) + backward kernel
    against the plain forward + plain backward, with the grouped bias, twice
    for bit-identity, at an odd shape and at the four Swin-S stages of the
    trainer's 64-image micro-batches, each with and without both row scales;
    then median ms of each stage's call with row scales.  Returns the timed
    entries of the training forward and of the backward, stage 3 (18 of the
    24 layers) first."""
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1

    worst = {"out": 0.0, "grads": 0.0}
    stages = swin_stages(64)
    for call in [SWIN_ODD] + stages:
        for use_rs in (False, True):
            a, extra, (r1, r2) = swin_layer_inputs(torch, call, use_rs, seed=1)
            H = call["shape"][3]
            do = torch.randn(a[0].shape, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(2))
            out, saved = fl1.fused_transformer_layer_fwd(*a, H, extra, r1, r2)
            grads = fl1.fused_transformer_layer_bwd(saved, do)
            again = fl1.fused_transformer_layer_bwd(saved, do)
            torch.cuda.synchronize()
            out_p, saved_p = fl1.fused_transformer_layer_fwd_reference(*a, H, extra, r1, r2)
            plain = fl1.fused_transformer_layer_bwd_reference(saved_p, do)
            what = (f"Swin stage {call['stage']} B,N,C,H,D,F={call['shape']} "
                    f"G={call['groups']} rs={use_rs}")
            compare_grads(torch, what, ("out",) + fl1.GRAD_NAMES, (out,) + grads,
                          (out,) + again, (out_p,) + plain, worst)
            del saved, saved_p, grads, again, plain

    fwd, bwd = [], []
    for call in sorted(stages, key=lambda c: c["stage"] != 3):
        a, extra, (r1, r2) = swin_layer_inputs(torch, call, True, seed=1)
        H = call["shape"][3]
        do = torch.randn(a[0].shape, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(2))
        _, saved = fl1.fused_transformer_layer_fwd(*a, H, extra, r1, r2)
        _, saved_p = fl1.fused_transformer_layer_fwd_reference(*a, H, extra, r1, r2)
        f_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_fwd(*a, H, extra, r1, r2))
        b_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_bwd(saved, do))
        pf_ms = median_ms(
            torch, lambda: fl1.fused_transformer_layer_fwd_reference(*a, H, extra, r1, r2))
        pb_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_bwd_reference(saved_p, do))
        kw = dict(groups=call["groups"], row_scales=True)
        fb, fby = bound(*layer_fwd_work(*call["shape"], saves=True, **kw))
        bb, bby = bound(*layer_bwd_work(*call["shape"], **kw))
        log(f"backward: Swin stage {call['stage']} train call (64 images, "
            f"B,N,C,H,D,F={call['shape']}, G={call['groups']}, bias, row scales; median "
            f"of 20, CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; "
            f"plain fwd {pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) "
            f"+ bwd {bb:.3f} ms ({bby})")
        shape = (f"Swin-S stage {call['stage']} train, B,N,C,H,D,F="
                 + ",".join(map(str, call["shape"])) + f", G={call['groups']}, row scales")
        fwd.append({"shape": shape + ", saves", "max_abs_err": worst["out"], "ms": f_ms,
                    "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": None})
        bwd.append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                    "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby, "library_ms": None})
        del saved, saved_p
    return fwd, bwd


# ---------------------------------------------------------------------------
# 3h / 3hb. the Halo kernels vs their plain versions
# ---------------------------------------------------------------------------


def halo_stages(images):
    """The Halo kernels' calls in Halo-S @256 at ``images`` images, one per
    stage: dicts of the map shape (B, H, W, C, heads, D, F), the window
    geometry and the depth, from tests/data/halo_s_port.conf."""
    from vision_transformers_tpu_torch.config.schema import load_config

    arch = load_config(MODELS["Halo-S"][0]).arch
    size = image_size(arch) // 4
    out = []
    for s in range(4):
        if s:
            size //= 2
        out.append(dict(stage=s + 1, window=arch.window_size, halo=arch.halo_size,
                        depth=arch.depths[s],
                        shape=(images, size, size, arch.dims[s], arch.n_heads[s],
                               arch.dim_head, arch.dim_ffs[s])))
    return out


# the odd small calls: a non-square map with 2·halo = window and heads 24 wide,
# and 3x3 windows (k² = 25 positions) with heads 20 wide
HALO_ODD = [dict(stage="odd", window=4, halo=2, depth=1, shape=(3, 12, 8, 48, 2, 24, 96)),
            dict(stage="odd", window=3, halo=1, depth=1, shape=(2, 6, 9, 40, 2, 20, 80))]


def halo_bias(torch, call, seed):
    """[heads, w², k²]: the port's HaloAttention's gathered bias from a
    std-0.2 table."""
    from vision_transformers_tpu_torch.models.halo import HaloAttention

    C, nh, D = call["shape"][3:6]
    attn = HaloAttention(C, nh, D, call["window"], call["halo"])
    with torch.no_grad():
        attn.rel_pos.weight.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(seed))
        return attn.to(DEVICE).relative_bias().contiguous()


def halo_layer_inputs(torch, call, row_scales, seed=0):
    """Seeded inputs of one whole-Halo-layer call: ``layer_args`` without
    the qkv bias, x as the [B, H, W, C] map, the bias and, with
    ``row_scales``, two per-image DropPath scales (keep 0.9)."""
    B, H, W, C, nh, D, F = call["shape"]
    a = layer_args(torch, B, H * W, C, nh, D, F, seed=seed)
    args = [a[0].reshape(B, H, W, C), *a[1:4], *a[5:], halo_bias(torch, call, seed)]
    rs = [None, None]
    if row_scales:
        rng = np.random.default_rng(seed + 100)
        for i in range(2):
            keep = rng.random(B) < 0.9
            keep[0], keep[-1] = False, True  # both kinds at every shape
            rs[i] = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
    return args, rs


def halo_attn_inputs(torch, call, seed=0):
    """Seeded q [B, H, W, HD], kv [B, H, W, 2HD], bias, and an output grad
    (HD = heads·D)."""
    B, H, W, _, nh, D, _ = call["shape"]
    g = torch.Generator(DEVICE).manual_seed(seed)
    q, kv, do = (torch.randn(B, H, W, c, device=DEVICE, generator=g)
                 for c in (nh * D, 2 * nh * D, nh * D))
    return q, kv, halo_bias(torch, call, seed), do


def sdpa_problem(torch, q, kv, bias, call):
    """The same function as the gathered problem of F.scaled_dot_product_attention:
    q [b·S, H, w², D], k / v [b·S, H, k², D], attn_mask = the bias."""
    from vision_transformers_tpu_torch.ops.fused_halo import neighborhoods, windows

    nh, D = call["shape"][4:6]
    w, halo = call["window"], call["halo"]
    heads = lambda t: t.reshape(-1, t.shape[2], nh, D).transpose(1, 2).contiguous()  # noqa: E731
    nb = neighborhoods(kv, w, halo)
    return (heads(windows(q, w)), heads(nb[..., :nh * D]), heads(nb[..., nh * D:]),
            bias[None], 1.0 / D ** 0.5)


def direct_plain_fwd(torch, q, kv, bias, call):
    """The halo attention's plain training forward on the card: (out,
    DirectSaved of the plain version)."""
    from vision_transformers_tpu_torch.ops import fused_halo

    C, nh = q.shape[-1], call["shape"][4]
    w, halo, scale = call["window"], call["halo"], 1.0 / call["shape"][5] ** 0.5
    out, lse = fused_halo.attention_fwd_reference(q, kv[..., :C], kv[..., C:], bias, nh,
                                                  w, halo, scale)
    return out, fused_halo.DirectSaved(q, kv, bias, out, lse, w, halo, nh, scale)


def halo_what(call, extra=""):
    return (f"Halo stage {call['stage']} B,H,W,C,heads,D,F={call['shape']} window "
            f"{call['window']} halo {call['halo']}{extra}")


def halo_kernels(torch):
    """3h: the whole Halo layer's forward (serving call, no saves) with the
    bias and both row scales, and the halo attention's forward, each against
    its plain version at the odd shapes and the Halo-S stages at 128
    images; median ms at every stage (the eval's calls; the trainer's take
    the saves, timed in 3hb) beside the bound and, for the halo attention,
    scaled_dot_product_attention on the gathered problem.  Returns
    {kernel: [timed entries]}."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_halo
    from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl

    results = {"fused_halo_layer": [], "halo_attention_direct": []}
    for call in HALO_ODD + halo_stages(128):
        B, H, W, _, nh, D, _ = call["shape"]
        kw = dict(window=call["window"], halo=call["halo"])
        timed = call["stage"] != "odd"
        a, (r1, r2) = halo_layer_inputs(torch, call, row_scales=True)
        out = fhl.fused_halo_layer(*a, nh, r1, r2, **kw)
        torch.cuda.synchronize()
        err = check_close(torch, "fused_halo_layer", out,
                          fhl.fused_halo_layer_reference(*a, nh, r1, r2, **kw),
                          halo_what(call, ", row scales"))
        if timed:
            a, _ = halo_layer_inputs(torch, call, row_scales=False)
            ms = median_ms(torch, lambda: fhl.fused_halo_layer(*a, nh, **kw))
            plain_ms = median_ms(torch, lambda: fhl.fused_halo_layer_reference(*a, nh, **kw))
            bound_ms, by = bound(*halo_layer_fwd_work(*call["shape"], **kw))
            log(f"kernels: fused_halo_layer Halo stage {call['stage']} eval call (128 "
                f"images, no saves): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
                f"{bound_ms:.3f} ms ({by})")
            results["fused_halo_layer"].append({
                "shape": f"Halo-S stage {call['stage']} eval, B,H,W,C,heads,D,F="
                         + ",".join(map(str, call["shape"])),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": None})
        del a
        q, kv, bias, _ = halo_attn_inputs(torch, call)
        out = fused_halo.halo_attention_direct(q, kv, bias, **kw, n_head=nh)
        torch.cuda.synchronize()
        ref = fused_halo.halo_attention_direct_reference(q, kv, bias, n_head=nh, **kw)
        err = check_close(torch, "halo_attention_direct", out, ref, halo_what(call))
        if timed:
            ms = median_ms(torch, lambda: fused_halo.halo_attention_direct(
                q, kv, bias, n_head=nh, **kw))
            plain_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_reference(
                q, kv, bias, n_head=nh, **kw))
            qg, kg, vg, mask, scale = sdpa_problem(torch, q, kv, bias, call)
            lib = F_.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
            lib_err = (lib.transpose(1, 2).reshape(-1, nh * D) - fused_halo.windows(
                out, call["window"]).reshape(-1, nh * D)).abs().max().item()
            library_ms = median_ms(torch, lambda: F_.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, scale=scale))
            bound_ms, by = bound(*halo_attn_fwd_work(B, H, W, nh, D, **kw))
            log(f"kernels: halo_attention_direct Halo stage {call['stage']} (128 images): "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, scaled_dot_product_attention "
                f"on the gathered problem {library_ms:.3f} ms (max|Δ| to the kernel "
                f"{lib_err:.3e}); bound {bound_ms:.3f} ms ({by})")
            results["halo_attention_direct"].append({
                "shape": f"Halo-S stage {call['stage']}, B,H,W,C,heads,D="
                         + ",".join(map(str, call["shape"][:6])),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": library_ms})
            del qg, kg, vg, mask, lib
        del q, kv, bias, out, ref
    return results


def halo_backward_kernels(torch):
    """3hb: each Halo kernel's forward (with saves) + backward against the
    plain forward + plain backward, twice for bit-identity, at the odd
    shapes and the four Halo-S stages at 128 images (the layer with and
    without both row scales); then median ms of each stage's training call
    (the layer with row scales).  Returns the timed entries: the layer's
    training forward and backward, the halo attention's forward (with
    saves) and backward."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_halo
    from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl

    worst = {"out": 0.0, "grads": 0.0}
    worst_d = {"out": 0.0, "grads": 0.0}
    stages = halo_stages(128)
    out_rec = {k: [] for k in ("fwd", "bwd", "dfwd", "dbwd")}
    for call in HALO_ODD + stages:
        nh = call["shape"][4]
        kw = dict(window=call["window"], halo=call["halo"])
        for use_rs in (False, True):
            a, (r1, r2) = halo_layer_inputs(torch, call, use_rs, seed=1)
            do = torch.randn(a[0].shape, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(2))
            out, saved = fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw)
            grads = fhl.fused_halo_layer_bwd(saved, do)
            again = fhl.fused_halo_layer_bwd(saved, do)
            torch.cuda.synchronize()
            out_p, saved_p = fhl.fused_halo_layer_fwd_reference(*a, nh, r1, r2, **kw)
            plain = fhl.fused_halo_layer_bwd_reference(saved_p, do)
            compare_grads(torch, halo_what(call, f" rs={use_rs}"), ("out",) + fhl.GRAD_NAMES,
                          (out,) + grads, (out,) + again, (out_p,) + plain, worst)
            del saved, saved_p, grads, again, plain
        q, kv, bias, do = halo_attn_inputs(torch, call, seed=3)
        out, saved = fused_halo.halo_attention_direct_fwd(q, kv, bias, n_head=nh, **kw)
        grads = fused_halo.halo_attention_direct_bwd(saved, do)
        again = fused_halo.halo_attention_direct_bwd(saved, do)
        torch.cuda.synchronize()
        out_p, saved_p = direct_plain_fwd(torch, q, kv, bias, call)
        plain = fused_halo.halo_attention_direct_bwd_reference(saved_p, do)
        compare_grads(torch, "direct " + halo_what(call), ("out", "dq", "dkv", "dbias"),
                      (out,) + grads, (out,) + again, (out_p,) + plain, worst_d)
        del saved, saved_p, grads, again, plain

    for call in stages:
        B, H, W, _, nh, D, _ = call["shape"]
        kw = dict(window=call["window"], halo=call["halo"])
        a, (r1, r2) = halo_layer_inputs(torch, call, True, seed=1)
        do = torch.randn(a[0].shape, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(2))
        _, saved = fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw)
        _, saved_p = fhl.fused_halo_layer_fwd_reference(*a, nh, r1, r2, **kw)
        f_ms = median_ms(torch, lambda: fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw))
        b_ms = median_ms(torch, lambda: fhl.fused_halo_layer_bwd(saved, do))
        pf_ms = median_ms(torch, lambda: fhl.fused_halo_layer_fwd_reference(
            *a, nh, r1, r2, **kw))
        pb_ms = median_ms(torch, lambda: fhl.fused_halo_layer_bwd_reference(saved_p, do))
        fb, fby = bound(*halo_layer_fwd_work(*call["shape"], **kw, row_scales=True,
                                             saves=True))
        bb, bby = bound(*halo_layer_bwd_work(*call["shape"], **kw, row_scales=True))
        log(f"backward: fused_halo_layer Halo stage {call['stage']} train call (128 "
            f"images, B,H,W,C,heads,D,F={call['shape']}, bias, row scales; median of 20, "
            f"CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd "
            f"{pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) + bwd {bb:.3f} "
            f"ms ({bby})")
        shape = (f"Halo-S stage {call['stage']} train, B,H,W,C,heads,D,F="
                 + ",".join(map(str, call["shape"])) + ", row scales")
        out_rec["fwd"].append({"shape": shape + ", saves", "max_abs_err": worst["out"],
                               "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb,
                               "bound_by": fby, "library_ms": None})
        out_rec["bwd"].append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                               "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
                               "library_ms": None})
        del saved, saved_p, a

        q, kv, bias, do = halo_attn_inputs(torch, call, seed=3)
        _, saved = fused_halo.halo_attention_direct_fwd(q, kv, bias, n_head=nh, **kw)
        f_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_fwd(
            q, kv, bias, n_head=nh, **kw))
        b_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_bwd(saved, do))
        _, saved_p = direct_plain_fwd(torch, q, kv, bias, call)
        pf_ms = median_ms(torch, lambda: direct_plain_fwd(torch, q, kv, bias, call))
        pb_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_bwd_reference(
            saved_p, do))
        qg, kg, vg, mask, scale = sdpa_problem(torch, q, kv, bias, call)
        mask = mask.clone()
        leaves = [t.requires_grad_() for t in (qg, kg, vg, mask)]
        lib = F_.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
        dlib = torch.randn_like(lib)
        lib_ms = median_ms(torch, lambda: torch.autograd.grad(lib, leaves, dlib,
                                                              retain_graph=True))
        fb, fby = bound(*halo_attn_fwd_work(B, H, W, nh, D, **kw, saves=True))
        bb, bby = bound(*halo_attn_bwd_work(B, H, W, nh, D, **kw))
        log(f"backward: halo_attention_direct Halo stage {call['stage']} (128 images): "
            f"kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + "
            f"bwd {pb_ms:.3f} ms; scaled_dot_product_attention's backward on the "
            f"gathered problem {lib_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) + bwd "
            f"{bb:.3f} ms ({bby})")
        shape = (f"Halo-S stage {call['stage']}, B,H,W,C,heads,D="
                 + ",".join(map(str, call["shape"][:6])))
        out_rec["dfwd"].append({"shape": shape + ", saves", "max_abs_err": worst_d["out"],
                                "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb,
                                "bound_by": fby, "library_ms": None})
        out_rec["dbwd"].append({"shape": shape, "max_abs_err": worst_d["grads"],
                                "ms": b_ms, "plain_ms": pb_ms, "bound_ms": bb,
                                "bound_by": bby, "library_ms": lib_ms})
        del saved, saved_p, q, kv, bias, do, qg, kg, vg, mask, lib, leaves
    return out_rec["fwd"], out_rec["bwd"], out_rec["dfwd"], out_rec["dbwd"]


# ---------------------------------------------------------------------------
# 4. full width against the JAX package's logits
# ---------------------------------------------------------------------------


def seeded_model(torch, conf, seed):
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch

    arch = load_config(conf).arch
    sd = to_torch(seeded_state_dict(arch, seed))
    model = arch.make()
    model.load_state_dict(sd, strict=True)
    return arch, sd, model.to(DEVICE).eval()


def image_size(arch):
    return arch.image_size if isinstance(arch.image_size, int) else arch.image_size[0]


def counted_modules():
    """kernel name → (its ops module, the counter's name there)."""
    from vision_transformers_tpu_torch.ops import (fused_halo, fused_halo_layer,
                                                   fused_layer, fused_layer1)

    return {"fused_attention_layer": (fused_layer, "LAUNCHES"),
            "fused_attention_layer_bwd": (fused_layer, "BWD_LAUNCHES"),
            "fused_transformer_layer": (fused_layer1, "LAUNCHES"),
            "fused_transformer_layer_bwd": (fused_layer1, "BWD_LAUNCHES"),
            "fused_halo_layer": (fused_halo_layer, "LAUNCHES"),
            "fused_halo_layer_bwd": (fused_halo_layer, "BWD_LAUNCHES"),
            "halo_attention_direct": (fused_halo, "LAUNCHES"),
            "halo_attention_direct_bwd": (fused_halo, "BWD_LAUNCHES")}


def counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in counted_modules().items()}


def reset_counts():
    for mod, attr in counted_modules().values():
        setattr(mod, attr, 0)


@contextlib.contextmanager
def halo_forced(impl):
    """The Halo path ``impl`` (None: the default) for the duration."""
    from vision_transformers_tpu_torch import ops

    ops.set_halo_impl(impl)
    try:
        yield
    finally:
        ops.set_halo_impl(None)


def expect_path(before, after, expected, what):
    """Each counter moved by ``expected[name]`` (0 where unnamed)."""
    moved = {k: after[k] - before[k] for k in after}
    want = {k: expected.get(k, 0) for k in after}
    if moved != want:
        raise RuntimeError(f"{what}: expected launches {want}, counted {moved}")


def golden(torch, model_name, cases):
    """``cases``: (rows, the kernel those rows take)."""
    from vision_transformers_tpu_torch.predict import predict_batch
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    conf, path, _, depth = MODELS[model_name]
    with np.load(path) as f:
        seed, ref = int(f["seed"]), f["logits"]
    arch, _, model = seeded_model(torch, conf, seed)
    images = seeded_images(seed, ref.shape[0], image_size(arch))
    tol = 1e-3 * max(1.0, float(np.abs(ref).max()))
    for rows, kernel in cases:
        idx = np.arange(rows) % ref.shape[0]
        before = counts()
        logits, top, _ = predict_batch(model, images[idx], 5, DEVICE)
        expect_path(before, counts(), {kernel: depth}, f"golden {model_name} {rows} rows")
        if logits.shape != (rows, ref.shape[1]) or not np.isfinite(logits).all():
            raise RuntimeError(f"golden: bad logits {logits.shape}")
        err = float(np.abs(logits - ref[idx]).max())
        log(f"golden: {model_name} @{image_size(arch)} depth {depth}, {rows} rows via {kernel}: "
            f"max|port-JAX| {err:.3e} (tol {tol:.3e})")
        if err > tol or not (top[:, 0] == ref[idx].argmax(-1)).all():
            raise RuntimeError("golden: the port disagrees with the JAX logits")


# ---------------------------------------------------------------------------
# 4b. a full-width train step against the JAX package's gradients
# ---------------------------------------------------------------------------


def train_golden(torch, model_name, kernels, halo_impl=None):
    """One train step at 64 rows through ``kernels`` (forward, backward);
    ``halo_impl`` forces a Halo path."""
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.train import loss as L
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_state_dict,
                                                             seeded_train_batch,
                                                             to_torch)

    conf, _, path, depth = MODELS[model_name]
    with np.load(path) as f:
        g = {k: f[k] for k in f.files}
    seed, keys, rtol = int(g["seed"]), list(g["keys"]), 1e-3
    # the golden is one deterministic step: the conf's drop_path off
    arch = dataclasses.replace(load_config(conf).arch, drop_path=0.0)
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    model.to(DEVICE).train()
    batch = seeded_train_batch(seed, 2, image_size(arch), arch.n_class)
    idx = np.arange(64) % 2  # 64 rows take the kernels; the mean over
    b = {k: torch.from_numpy(v[idx]).to(DEVICE) for k, v in batch.items()}  # copies = 2-row mean
    before = counts()
    with halo_forced(halo_impl):
        logits = model(b["image"].permute(0, 3, 1, 2))
        loss = L.mix_loss(logits, b["label1"].long(), b["label2"].long(), b["ratio"],
                          eps=0.1)
        loss.backward()
    torch.cuda.synchronize()
    expect_path(before, counts(), {k: depth for k in kernels},
                f"train golden {model_name}, 64 rows")
    grads = {k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()}
    if sorted(grads) != keys:
        raise RuntimeError("train golden: the port's parameters differ from the golden's")
    norms = np.array([np.linalg.norm(grads[k]) for k in keys])
    projections = grad_projections(grads, seed)
    proj = np.array([projections[k] for k in keys])
    checks = {
        "loss": (float(loss.detach()), float(g["loss"])),
        "grad_norm": (float(np.sqrt((norms ** 2).sum())), float(g["grad_norm"])),
    }
    rel = {k: abs(a - b) / abs(b) for k, (a, b) in checks.items()}
    rel["tensor norms (worst)"] = float(np.max(np.abs(norms - g["norms"]) / g["norms"]))
    rel["projections (worst, of the tensor norm)"] = float(
        np.max(np.abs(proj - g["projections"]) / g["norms"]))
    log(f"train golden: {model_name} @{image_size(arch)} depth {depth} f32, 64 rows via "
        f"{' + '.join(kernels)}: loss {checks['loss'][0]:.6f} (JAX "
        f"{checks['loss'][1]:.6f}), grad_norm {checks['grad_norm'][0]:.5f} (JAX "
        f"{checks['grad_norm'][1]:.5f}); relative "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (rtol {rtol})")
    if not all(np.isfinite(v) and v <= rtol for v in rel.values()):
        raise RuntimeError("train golden: the port's gradients disagree with the JAX package")


# ---------------------------------------------------------------------------
# 5. predict end to end (the serving path)
# ---------------------------------------------------------------------------


def check_lines(lines, files, topk):
    if len(lines) != len(files):
        raise RuntimeError(f"predict: {len(lines)} lines for {len(files)} images")
    for line, path in zip(lines, files):
        entry = json.loads(line)
        probs = [t["prob"] for t in entry["topk"]]
        if entry["file"] != path or len(probs) != topk \
                or not all(0.0 < p <= 1.0 for p in probs) or sum(probs) > 1.0 + 1e-4:
            raise RuntimeError(f"predict: bad line {line}")


def write_jpegs(directory, images):
    """Seeded uint8 images as JPEGs of a few widths; returns the paths."""
    from PIL import Image

    files = []
    for i, img in enumerate(images):
        path = os.path.join(directory, f"img{i:03d}.jpg")
        Image.fromarray(img[:, : 200 + (i % 5) * 20]).save(path, quality=90)
        files.append(path)
    return files


def predict_main_path(torch, has_pil, model_name, cases):
    """``cases``: (images, the kernel that many take)."""
    from vision_transformers_tpu_torch import predict
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    conf, _, _, depth = MODELS[model_name]
    seed = 7
    arch, sd, model = seeded_model(torch, conf, seed)
    size = image_size(arch)
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        ckpt = os.path.join(tmp, "ckpt.pt")
        torch.save({"ema": sd}, ckpt)
        noise = seeded_images(seed, 160, 256)
        files = write_jpegs(tmp, noise) if has_pil else []
        if not has_pil:
            log("predict: PIL does not import on this machine, so JPEG decode is "
                "not exercised; predict_batch runs on the seeded uint8 images")
        reset_counts()  # the main path's run starts here
        for n, kernel in cases:
            before = counts()
            t0 = time.perf_counter()
            if has_pil:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    predict.main(["--conf", conf, "--checkpoint", f"{ckpt}:ema",
                                  "--topk", "5", "--device", DEVICE, *files[:n]])
                secs = time.perf_counter() - t0
                check_lines(buf.getvalue().splitlines(), files[:n], 5)
            else:
                _, top, prob = predict.predict_batch(model, noise[:n, :size, :size], 5, DEVICE)
                secs = time.perf_counter() - t0
                if not ((prob > 0) & (prob <= 1)).all() or (prob.sum(-1) > 1 + 1e-4).any():
                    raise RuntimeError("predict: bad probabilities")
            expect_path(before, counts(), {kernel: depth}, f"predict {model_name} {n} images")
            log(f"predict: {model_name}, {n} images through "
                f"{'predict.main (JPEG decode, checkpoint load, forward)' if has_pil else 'predict_batch'}"
                f" in {secs:.3f} s = {n / secs:.1f} images/s end to end, via {kernel}")
        launches = counts()  # read just after the main path's run
        off = (256 - size) // 2
        batch = noise[:, off:off + size, off:off + size]
        for n, _ in cases:
            predict.predict_batch(model, batch[:n], 5, DEVICE)  # warm-up
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                predict.predict_batch(model, batch[:n], 5, DEVICE)
            secs = (time.perf_counter() - t0) / reps
            log(f"predict: {model_name} predict_batch steady state, {n} uint8 images "
                f"(host→device, forward, top-k back): {secs * 1e3:.2f} ms = "
                f"{n / secs:.1f} images/s")
    for _, kernel in cases:
        if launches[kernel] == 0:
            raise RuntimeError(f"predict: {kernel} was not launched on the serving path")
    log(f"predict: {model_name} launches on the serving path {launches}")
    return launches


# ---------------------------------------------------------------------------
# 6. the trainer end to end (the slices' main paths)
# ---------------------------------------------------------------------------


def train_main_path(torch, has_pil, model_name, expected, overrides=(), halo_impl=None):
    """``train.main`` f32 at batch 128 for one synthetic epoch, with conf
    ``overrides`` and ``halo_impl`` forcing a Halo path; ``expected`` the
    launches of each kernel on that run."""
    from vision_transformers_tpu_torch import predict, train
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.train import engine
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    conf_path = MODELS[model_name][0]
    conf = load_config(conf_path, list(overrides))
    label = model_name + (f" ({halo_impl})" if halo_impl else "")
    step_secs = []
    train_step = engine.train_step

    def timed_step(*args, **kwargs):  # per-step wall time, ended by a sync
        t0 = time.perf_counter()
        out = train_step(*args, **kwargs)
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t0)
        return out

    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        args = ["--conf", conf_path, "--device", DEVICE, "precision=f32",
                "training.dataloader.batch_size=128", "training.epoch=1",
                "data_backend=synthetic", "log_freq=1", *overrides,
                f"checker.storage=[{{type: local, path: {tmp}}}]"]
        engine.train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        try:
            with halo_forced(halo_impl):
                reset_counts()  # the main path's run starts here
                t0 = time.perf_counter()
                metrics = train.main(args)
                secs = time.perf_counter() - t0
                launches = counts()  # read just after the main path's run
        finally:
            engine.train_step = train_step
        peak = torch.cuda.max_memory_allocated()
        want = {k: expected.get(k, 0) for k in launches}
        if launches != want:
            raise RuntimeError(f"trainer {label}: expected launches {want}, "
                               f"counted {launches}")
        if not all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss")):
            raise RuntimeError(f"trainer: non-finite metrics {metrics}")
        ckpt = os.path.join(tmp, "epoch-001.pt")
        if not os.path.isfile(ckpt):
            raise RuntimeError("trainer: no epoch-001.pt")
        steady = np.mean(step_secs[1:])
        log(f"trainer: 1 epoch of {label} f32 ({len(step_secs)} steps x 128 images, "
            f"grad_accumulation {conf.training.grad_accumulation}, drop_path "
            f"{conf.arch.drop_path}, valid 256 images) in {secs:.2f} s: loss "
            f"{metrics['loss']:.5f}, valid_loss {metrics['valid_loss']:.5f}, prec1 "
            f"{metrics['prec1']:.3f}; trainer images/s {metrics['images_per_sec']:.1f}; "
            f"steps " + ", ".join(f"{t * 1e3:.1f}" for t in step_secs) + " ms; steady "
            f"state (steps 2-{len(step_secs)}) {steady * 1e3:.2f} ms/step = "
            f"{128 / steady:.1f} images/s; max_memory_allocated {peak / 2**30:.2f} GiB")
        log(f"trainer: {label} launches on the main path {launches}")
        # the epoch checkpoint serves
        noise = seeded_images(11, 48, 256)
        if has_pil:
            files = write_jpegs(tmp, noise)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                predict.main(["--conf", conf_path, "--checkpoint", f"{ckpt}:model",
                              "--topk", "5", "--device", DEVICE, *files])
            check_lines(buf.getvalue().splitlines(), files, 5)
        else:
            from vision_transformers_tpu_torch.utils.weights import load_checkpoint

            model = conf.arch.make()
            model.load_state_dict(load_checkpoint(f"{ckpt}:model"), strict=True)
            size = image_size(conf.arch)
            _, _, prob = predict.predict_batch(model.to(DEVICE).eval(),
                                               noise[:, :size, :size], 5, DEVICE)
            if not ((prob > 0) & (prob <= 1)).all():
                raise RuntimeError("trainer: bad probabilities from the checkpoint")
        log(f"trainer: predict read {label}'s epoch-001.pt:model and classified "
            f"48 images")
    return launches


def main() -> None:
    import torch

    t_start = time.perf_counter()
    phase_secs = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_secs[name] = time.perf_counter() - t0
        return out

    name, _, has_pil = phase("1 probe", probe, torch)
    phase("2 build", build)
    timed = phase("3 kernels", kernels, torch)
    attn_fwd, attn_bwd = phase("3b attention layer", backward_kernel, torch)
    l1_fwd, l1_bwd = phase("3b whole layer", swin_backward_kernel, torch)
    # the record times each kernel at a call its trainer (phase 6) makes
    timed["fused_attention_layer"].insert(0, attn_fwd)
    timed["fused_attention_layer_bwd"] = [attn_bwd]
    timed["fused_transformer_layer"] = l1_fwd + timed["fused_transformer_layer"]
    timed["fused_transformer_layer_bwd"] = l1_bwd
    halo_timed = phase("3h halo", halo_kernels, torch)
    hl_fwd, hl_bwd, hd_fwd, hd_bwd = phase("3hb halo", halo_backward_kernels, torch)
    timed["fused_halo_layer"] = hl_fwd + halo_timed["fused_halo_layer"]
    timed["fused_halo_layer_bwd"] = hl_bwd
    timed["halo_attention_direct"] = halo_timed["halo_attention_direct"] + hd_fwd
    timed["halo_attention_direct_bwd"] = hd_bwd
    fal, falb = "fused_attention_layer", "fused_attention_layer_bwd"
    ftl, ftlb = "fused_transformer_layer", "fused_transformer_layer_bwd"
    fhl, fhlb = "fused_halo_layer", "fused_halo_layer_bwd"
    had, hadb = "halo_attention_direct", "halo_attention_direct_bwd"
    phase("4 golden ViT", golden, torch, "ViT-S/16", ((64, fal), (256, ftl)))
    phase("4 golden Swin", golden, torch, "Swin-S", ((64, ftl), (128, ftl)))
    phase("4 golden Halo", golden, torch, "Halo-S", ((64, fhl), (128, fhl)))
    phase("4b train ViT", train_golden, torch, "ViT-S/16", (fal, falb))
    phase("4b train Swin", train_golden, torch, "Swin-S", (ftl, ftlb))
    phase("4b train Halo", train_golden, torch, "Halo-S", (fhl, fhlb))
    phase("4b train Halo direct", train_golden, torch, "Halo-S", (had, hadb), "direct")
    halo_dp = ("arch.drop_path=0.1",)
    paths = {
        "ViT-S/16 predict": phase("5 predict ViT", predict_main_path, torch, has_pil,
                                  "ViT-S/16", ((48, fal), (160, ftl))),
        "Swin-S predict": phase("5 predict Swin", predict_main_path, torch, has_pil,
                                "Swin-S", ((48, ftl), (160, ftl))),
        "Halo-S predict": phase("5 predict Halo", predict_main_path, torch, has_pil,
                                "Halo-S", ((48, fhl),)),
        # 4 steps x 12 layers; the valid pass: 2 batches x 12 layers
        "ViT-S/16 train": phase("6 trainer ViT", train_main_path, torch, has_pil,
                                "ViT-S/16", {fal: 48, falb: 48, ftl: 24}),
        # 4 steps x 2 micro-batches x 24 layers; the valid pass: 2 x 24
        "Swin-S train": phase("6 trainer Swin", train_main_path, torch, has_pil,
                              "Swin-S", {ftl: 24 * 2 * 4 + 24 * 2, ftlb: 24 * 2 * 4}),
        # 4 steps x 12 layers (12 forward and 12 backward per step); the
        # valid pass: 2 batches x 12
        "Halo-S train": phase("6 trainer Halo", train_main_path, torch, has_pil,
                              "Halo-S", {fhl: 12 * 4 + 12 * 2, fhlb: 12 * 4}, halo_dp),
        "Halo-S train (direct)": phase(
            "6 trainer Halo direct", train_main_path, torch, has_pil, "Halo-S",
            {had: 12 * 4 + 12 * 2, hadb: 12 * 4}, halo_dp, "direct"),
    }
    trainer_of = {fal: "ViT-S/16 train", falb: "ViT-S/16 train",
                  ftl: "Swin-S train", ftlb: "Swin-S train",
                  fhl: "Halo-S train", fhlb: "Halo-S train",
                  had: "Halo-S train (direct)", hadb: "Halo-S train (direct)"}
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": paths[trainer_of[k]][k],
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         **timed[k][0], "other_shapes": timed[k][1:]}
        for k, (src, rep) in KERNELS.items()]}
    log("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_secs.items()))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
