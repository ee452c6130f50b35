#!/usr/bin/env python3
"""Start-up check of the PyTorch port (vision_transformers_tpu_torch) on one
NVIDIA H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version, runs full-width ViT-S/16 and Swin-S against the JAX
package's stored logits and train-step gradients, and drives the serving and
the training entry points of both models end to end.

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
4. golden  ViT-S/16 @224 (depth 12) and Swin-S @224 (depth 24), seeded
           weights, against the JAX logits in tests/data/*_port_golden.npz:
           ViT at 64 rows ('layer') and 256 rows ('layer1'), Swin at 64 and
           128 rows ('layer1'); max |Δ| ≤ 1e-3·max(1, max|golden|)
4b. train  one f32 train-step gradient (drop_path 0) of each model on the 2
           golden images tiled to 64 rows (ViT through the attention layer's
           kernels, Swin through the whole layer's) against
           tests/data/*_port_train_golden.npz: loss, gradient norm,
           per-tensor norms and projections, rtol 1e-3
5. predict the serving path of each model: ``predict.main`` on 48 and then
           160 seeded JPEGs with a seeded ``.pt:ema``; the launch counters
           are zeroed just before and read just after
6. trainer each model's training path: ``train.main`` f32, batch 128, one
           synthetic epoch (4 train steps, then a valid pass of 256 images)
           — ViT-S/16 from configs/vit-s-16.conf (DropPath 0.1 through the
           attention layer's forward and backward kernels, eval through the
           whole-layer kernel), Swin-S from configs/swin-transformer-s.conf
           (grad_accumulation 2, so 64-image micro-batches, DropPath 0.3,
           forward and backward of the whole-layer kernel); the counters
           are zeroed just before and read just after each; then
           ``predict.main`` reads the epoch checkpoint

The line before the last is the kernels' JSON record: each kernel's
launches on the trainer run that takes it (ViT's for the attention layer,
Swin's for the whole layer; every path's in ``launches_by_path``) and its
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


def counts():
    from vision_transformers_tpu_torch.ops import fused_layer, fused_layer1

    return {"fused_attention_layer": fused_layer.LAUNCHES,
            "fused_attention_layer_bwd": fused_layer.BWD_LAUNCHES,
            "fused_transformer_layer": fused_layer1.LAUNCHES,
            "fused_transformer_layer_bwd": fused_layer1.BWD_LAUNCHES}


def reset_counts():
    from vision_transformers_tpu_torch.ops import fused_layer, fused_layer1

    fused_layer.LAUNCHES = 0
    fused_layer.BWD_LAUNCHES = 0
    fused_layer1.LAUNCHES = 0
    fused_layer1.BWD_LAUNCHES = 0


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
        log(f"golden: {model_name} @224 depth {depth}, {rows} rows via {kernel}: "
            f"max|port-JAX| {err:.3e} (tol {tol:.3e})")
        if err > tol or not (top[:, 0] == ref[idx].argmax(-1)).all():
            raise RuntimeError("golden: the port disagrees with the JAX logits")


# ---------------------------------------------------------------------------
# 4b. a full-width train step against the JAX package's gradients
# ---------------------------------------------------------------------------


def train_golden(torch, model_name, kernels):
    """One train step at 64 rows through ``kernels`` (forward, backward)."""
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
    logits = model(b["image"].permute(0, 3, 1, 2))
    loss = L.mix_loss(logits, b["label1"].long(), b["label2"].long(), b["ratio"], eps=0.1)
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
    log(f"train golden: {model_name} @224 depth {depth} f32, 64 rows via "
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
                _, top, prob = predict.predict_batch(model, noise[:n, :224, :224], 5, DEVICE)
                secs = time.perf_counter() - t0
                if not ((prob > 0) & (prob <= 1)).all() or (prob.sum(-1) > 1 + 1e-4).any():
                    raise RuntimeError("predict: bad probabilities")
            expect_path(before, counts(), {kernel: depth}, f"predict {model_name} {n} images")
            log(f"predict: {model_name}, {n} images through "
                f"{'predict.main (JPEG decode, checkpoint load, forward)' if has_pil else 'predict_batch'}"
                f" in {secs:.3f} s = {n / secs:.1f} images/s end to end, via {kernel}")
        launches = counts()  # read just after the main path's run
        batch = noise[:, 16:240, 16:240]
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


def train_main_path(torch, has_pil, model_name, expected):
    """``train.main`` f32 at batch 128 for one synthetic epoch; ``expected``
    the launches of each kernel on that run."""
    from vision_transformers_tpu_torch import predict, train
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.train import engine
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    conf_path = MODELS[model_name][0]
    conf = load_config(conf_path)
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
                "data_backend=synthetic", "log_freq=1",
                f"checker.storage=[{{type: local, path: {tmp}}}]"]
        engine.train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        try:
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
            raise RuntimeError(f"trainer {model_name}: expected launches {want}, "
                               f"counted {launches}")
        if not all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss")):
            raise RuntimeError(f"trainer: non-finite metrics {metrics}")
        ckpt = os.path.join(tmp, "epoch-001.pt")
        if not os.path.isfile(ckpt):
            raise RuntimeError("trainer: no epoch-001.pt")
        steady = np.mean(step_secs[1:])
        log(f"trainer: 1 epoch of {model_name} f32 ({len(step_secs)} steps x 128 images, "
            f"grad_accumulation {conf.training.grad_accumulation}, drop_path "
            f"{conf.arch.drop_path}, valid 256 images) in {secs:.2f} s: loss "
            f"{metrics['loss']:.5f}, valid_loss {metrics['valid_loss']:.5f}, prec1 "
            f"{metrics['prec1']:.3f}; trainer images/s {metrics['images_per_sec']:.1f}; "
            f"steps " + ", ".join(f"{t * 1e3:.1f}" for t in step_secs) + " ms; steady "
            f"state (steps 2-{len(step_secs)}) {steady * 1e3:.2f} ms/step = "
            f"{128 / steady:.1f} images/s; max_memory_allocated {peak / 2**30:.2f} GiB")
        log(f"trainer: {model_name} launches on the main path {launches}")
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
            _, _, prob = predict.predict_batch(model.to(DEVICE).eval(),
                                               noise[:, :224, :224], 5, DEVICE)
            if not ((prob > 0) & (prob <= 1)).all():
                raise RuntimeError("trainer: bad probabilities from the checkpoint")
        log(f"trainer: predict read {model_name}'s epoch-001.pt:model and classified "
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
    fal, falb = "fused_attention_layer", "fused_attention_layer_bwd"
    ftl, ftlb = "fused_transformer_layer", "fused_transformer_layer_bwd"
    phase("4 golden ViT", golden, torch, "ViT-S/16", ((64, fal), (256, ftl)))
    phase("4 golden Swin", golden, torch, "Swin-S", ((64, ftl), (128, ftl)))
    phase("4b train ViT", train_golden, torch, "ViT-S/16", (fal, falb))
    phase("4b train Swin", train_golden, torch, "Swin-S", (ftl, ftlb))
    paths = {
        "ViT-S/16 predict": phase("5 predict ViT", predict_main_path, torch, has_pil,
                                  "ViT-S/16", ((48, fal), (160, ftl))),
        "Swin-S predict": phase("5 predict Swin", predict_main_path, torch, has_pil,
                                "Swin-S", ((48, ftl), (160, ftl))),
        # 4 steps x 12 layers; the valid pass: 2 batches x 12 layers
        "ViT-S/16 train": phase("6 trainer ViT", train_main_path, torch, has_pil,
                                "ViT-S/16", {fal: 48, falb: 48, ftl: 24}),
        # 4 steps x 2 micro-batches x 24 layers; the valid pass: 2 x 24
        "Swin-S train": phase("6 trainer Swin", train_main_path, torch, has_pil,
                              "Swin-S", {ftl: 24 * 2 * 4 + 24 * 2, ftlb: 24 * 2 * 4}),
    }
    trainer_of = {fal: "ViT-S/16 train", falb: "ViT-S/16 train",
                  ftl: "Swin-S train", ftlb: "Swin-S train"}
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
