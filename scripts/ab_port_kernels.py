#!/usr/bin/env python3
"""Time the port's whole-layer kernels of one source tree on the GPU, for a
parent / change comparison run in turns within one call:

    for t in parent . . parent; do python3 scripts/ab_port_kernels.py $t; done

``ROOT`` (default: this checkout) is the tree whose
``vision_transformers_tpu_torch`` is imported and built (each tree builds into
its own ``_build/``). Times, as medians of 20 CUDA-event timings after 3 warm-
up calls: B1 ``fused_attention_layer`` forward with saves and backward at
ViT-S B=128 with a row scale, at Twins-SVT-S stages 3 and 1 at 128 images
(256 rows of 98 tokens, C 256, 8 heads of 32; 4096 rows, C 64, 2 heads; the
pair mask, no mask gradient) and
at Twins-SVT-S stage 4 at 128 images (49 tokens, C 512, 16 heads of 32, no
mask); B2's serving forward at ViT-S B=128 (the eval call, no bias); B2
``fused_transformer_layer`` forward with saves and backward at Swin-S stages 3
and 1 at 64 images (128 rows of 98 tokens, C 384, 12 heads of 32, the grouped
bias of 2 groups; 2048 rows, C 96, 3 heads, 32 groups; both row scales); B4
``fused_halo_layer`` the same at the four Halo-S stages at 128 images (64x64
to 8x8 maps, C 96 to 768, 3 to 24 heads of 32, F = 4C, window 8, halo 2, both
row scales); B3 ``fused_attention_qkv`` forward with lse
and backward at ViT-S B=128 (no bias) and at Swin-S stage 1 at 64 images (2048
rows of 98 tokens, 3 heads of 32, the grouped bias of 32 groups); B5a
``halo_attention_direct`` forward with lse and
backward at Halo-S stage 1 at 128 images; B5b ``halo_attention`` forward with
lse and backward on the gathered problem of Halo-S stage 1 at 128 images (B' =
8192 windows of 64 queries, 144 keys, 3 heads of 32) and of the window-4 /
halo-3 model's stage 1 (B' = 32,768 windows of 16 queries, 100 keys); B8
``fused_attention_block`` forward with saves and backward at ViT-S B=128 (no
bias); where the tree has it, B9 ``fused_swin_layer`` forward with saves and
backward at Swin-S stages 1 and 3 at 64 images (shifted: the grouped bias of 32
/ 2 groups, both per-sample row scales); B6 ``fused_attention`` forward with
lse and backward at PVT-S stages 1 and 3 at 128 images (the models' strided
head views). Prints the card, ptxas's registers and spills of every kernel
compiled from fused_layer.cu, fused_layer_bwd.cu, fused_layer1_bwd.cu,
fused_attention.cu (where the tree has it), fused_attention_qkv.cu and
fused_halo.cu (B1-B8) when this
process builds the tree, and one JSON line. Needs CUDA; imports no JAX.

Also the GEMM core under B1, B2, B4, B7, B8 and B9 alone, at the main
paths' products (``GEMM_CALLS``: ViT-S/16 at 25,216 rows, Swin-S stages 1
and 3 at 64 images, forward with its epilogue, a data gradient and split-K
weight gradients in the tree's own slab counts), through the C entry
``vtx_gemm_tc`` where the tree has ``csrc/gemm_tc.cu``, else through a shim
compiled here against the tree's ``csrc/common.cuh`` (the same launchers,
inline there); B7 ``fused_ff_layer`` forward with saves and backward at
ViT-S/16 (25,216 rows, silu, a row scale); and B8 at B=64 too.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

# (label, form, M, N, K, epilogue): rows = A row-major and the weight a
# linear.weight.t() view; nmajor = the weight read N-major (a data
# gradient); splitk = A as Aᵀ storage [K, M]
GEMM_CALLS = (("ViT qkv", "rows", 25216, 1152, 384, "bias"),
              ("ViT FF1", "rows", 25216, 1536, 384, "bias+silu"),
              ("ViT FF2", "rows", 25216, 384, 1536, "bias+rs+res"),
              ("ViT dX", "nmajor", 25216, 384, 1152, ""),
              ("ViT dWqkv", "splitk", 384, 1152, 25216, ""),
              ("Swin1 qkv", "rows", 200704, 288, 96, "bias"),
              ("Swin1 dWqkv", "splitk", 96, 288, 200704, ""),
              ("Swin3 qkv", "rows", 12544, 1152, 384, "bias"))

# vtx_gemm_tc (csrc/gemm_tc.cu) over a tree that predates it: forms 0 and 3
# on the tree's own launch_gemm / launch_gemm_splitk
SHIM = r"""
#include "common.cuh"
extern "C" int vtx_gemm_tc(const float* A, int lda, const float* B, long long sbk,
                           long long sbn, const float* bias, const float* rs, int rs_rows,
                           const float* res, float* out, const int* pix, int map_hw,
                           int form, float* part, int splits, long long som, long long son,
                           int M, int N, int K, int silu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0)
    return static_cast<int>(launch_gemm(A, B, sbk, sbn, bias, rs, rs_rows, res, out, M, N,
                                        K, silu, s));
  if (form == 3)
    return static_cast<int>(launch_gemm_splitk(A, lda, B, sbk, sbn, part, splits, out, som,
                                               son, M, N, K, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def gemm_entry(root, _build):
    """The tree's vtx_gemm_tc: its own library's, or the shim's."""
    pkg = os.path.join(root, "vision_transformers_tpu_torch")
    if os.path.exists(os.path.join(pkg, "csrc", "gemm_tc.cu")):
        lib = _build.build()
    else:
        src = os.path.join(pkg, "_build", "gemm_shim.cu")
        so = os.path.join(pkg, "_build", "gemm_shim.so")
        with open(src, "w") as f:
            f.write(SHIM)
        subprocess.run([_build.find_nvcc(), *_build._FLAGS, "-shared", "-I",
                        os.path.join(pkg, "csrc"), "-o", so, src], check=True,
                       capture_output=True, timeout=600)
        lib = ctypes.CDLL(so)
    fn = lib.vtx_gemm_tc
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # the tree's own declaration where it has one (the passes' options since
    # they moved into the core), else the shim's
    fn.argtypes = getattr(_build, "_SIGNATURES", {}).get(
        "vtx_gemm_tc", [P, I, P, L, L, P, P, I, P, P, P, I, I, P, I, L, L, I, I, I, I, P])
    fn.restype = ctypes.c_int
    return fn


def gemm_times(fn, splits_of, ms):
    """Median ms of each GEMM_CALLS product on the entry fn."""
    out = {}
    g = torch.Generator("cuda").manual_seed(4)
    stream = torch.cuda.current_stream().cuda_stream
    for label, form, M, N, K, epi in GEMM_CALLS:
        a = torch.randn(*((K, M) if form == "splitk" else (M, K)), device="cuda", generator=g)
        b = torch.randn(N, K, device="cuda", generator=g).t() if form == "rows" else \
            torch.randn(K, N, device="cuda", generator=g)
        bias = torch.randn(N, device="cuda", generator=g) if "bias" in epi else None
        rs = torch.rand(-(-M // 197), device="cuda", generator=g) if "rs" in epi else None
        res = torch.randn(M, N, device="cuda", generator=g) if "res" in epi else None
        o = torch.empty(M, N, device="cuda")
        splits = splits_of(M, N, K) if form == "splitk" else 1
        part = torch.empty(splits * M * N, device="cuda") if form == "splitk" else None

        def ptr(t):
            return None if t is None else t.data_ptr()

        # no pass options: ln (4), act (ACT_NONE), B's row scale and its rows,
        # hid and its act, the two partials
        extra = (None, None, None, None, -1, None, 1, None, 0, None, None) \
            if len(fn.argtypes) > 22 else ()

        def call():
            err = fn(ptr(a), M if form == "splitk" else K, ptr(b), b.stride(0), b.stride(1),
                     ptr(bias), ptr(rs), 197, ptr(res), ptr(o), None, 0,
                     3 if form == "splitk" else 0, ptr(part), splits, N, 1, M, N, K,
                     int("silu" in epi), *extra, stream)
            if err:
                raise RuntimeError(f"vtx_gemm_tc {label}: CUDA error {err}")

        out[f"GEMM {label}"] = ms(call)
        del a, b, bias, rs, res, o, part
    return out


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

    out = gemm_times(gemm_entry(root, _build), fl._splits, ms)
    r = torch.ones(128, device="cuda")
    a = args(128, 197, 384, 6, 64, 1536)
    dz = torch.randn(128, 197, 384, device="cuda")
    _, saved = fl.fused_attention_layer_fwd(*a[:7], 6, row_scale=r)
    out["B1 ViT fwd"] = ms(lambda: fl.fused_attention_layer_fwd(*a[:7], 6, row_scale=r))
    out["B1 ViT bwd"] = ms(lambda: fl.fused_attention_layer_bwd(saved, dz))
    win = torch.arange(98, device="cuda") // 49
    mask = torch.where(win[:, None] == win[None, :], 0.0, -1e9)
    for stage, (rows, C, H) in ((3, (256, 256, 8)), (1, (4096, 64, 2))):
        a = args(rows, 98, C, H, 32, 4 * C)
        dz = torch.randn(rows, 98, C, device="cuda")
        r = torch.ones(rows, device="cuda")
        _, saved = fl.fused_attention_layer_fwd(*a[:7], H, row_scale=r, extra=mask)
        out[f"B1 Twins{stage} fwd"] = ms(lambda: fl.fused_attention_layer_fwd(
            *a[:7], H, row_scale=r, extra=mask))
        out[f"B1 Twins{stage} bwd"] = ms(lambda: fl.fused_attention_layer_bwd(
            saved, dz, need_dextra=False))
        del saved
    a = args(128, 49, 512, 16, 32, 2048)
    dz = torch.randn(128, 49, 512, device="cuda")
    r = torch.ones(128, device="cuda")
    _, saved = fl.fused_attention_layer_fwd(*a[:7], 16, row_scale=r)
    out["B1 Twins4 fwd"] = ms(lambda: fl.fused_attention_layer_fwd(*a[:7], 16, row_scale=r))
    out["B1 Twins4 bwd"] = ms(lambda: fl.fused_attention_layer_bwd(saved, dz))
    a = args(128, 197, 384, 6, 64, 1536)
    with torch.no_grad():
        out["B2 ViT eval fwd"] = ms(lambda: fl1.fused_transformer_layer(*a, 6))
    r = torch.ones(128, device="cuda")
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
    for stage, (size, C, H) in enumerate(((64, 96, 3), (32, 192, 6), (16, 384, 12),
                                          (8, 768, 24)), 1):
        a = args(128, size * size, C, H, 32, 4 * C)
        ha = [a[0].reshape(128, size, size, C), *a[1:4], *a[5:],
              0.2 * torch.randn(H, 64, 144, device="cuda")]
        dz = torch.randn(128, size, size, C, device="cuda")
        _, saved = fhl.fused_halo_layer_fwd(*ha, H, r, r, window=8, halo=2)
        out[f"B4 Halo{stage} fwd"] = ms(lambda: fhl.fused_halo_layer_fwd(
            *ha, H, r, r, window=8, halo=2))
        out[f"B4 Halo{stage} bwd"] = ms(lambda: fhl.fused_halo_layer_bwd(saved, dz))
        del ha, saved, dz
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
        x64, dz64 = a[0][:64].contiguous(), dz[:64].contiguous()
        _, saved = fb.fused_attention_block_fwd(x64, *a[3:7], 6)
        out["B8 ViT64 fwd"] = ms(lambda: fb.fused_attention_block_fwd(x64, *a[3:7], 6))
        out["B8 ViT64 bwd"] = ms(lambda: fb.fused_attention_block_bwd(saved, dz64))
        del saved
    a = args(128, 197, 384, 6, 64, 1536)
    dz = torch.randn(128, 197, 384, device="cuda")
    ff = [a[0], a[7], a[8], *a[9:]]
    _, saved = fl.fused_ff_layer_fwd(*ff, "silu", r)
    out["B7 ViT fwd"] = ms(lambda: fl.fused_ff_layer_fwd(*ff, "silu", r))
    out["B7 ViT bwd"] = ms(lambda: fl.fused_ff_layer_bwd(saved, dz))
    del saved, ff
    g = torch.Generator("cuda").manual_seed(2)
    q, kv, do = (torch.randn(128, 64, 64, c, device="cuda", generator=g) for c in (96, 192, 96))
    bias = 0.2 * torch.randn(3, 64, 144, device="cuda", generator=g)
    _, saved = fh.halo_attention_direct_fwd(q, kv, bias, 8, 2, 3)
    out["B5a Halo1 fwd"] = ms(lambda: fh.halo_attention_direct_fwd(q, kv, bias, 8, 2, 3))
    out["B5a Halo1 bwd"] = ms(lambda: fh.halo_attention_direct_bwd(saved, do))
    del q, kv, do, saved
    for name, (Bw, M, N) in (("B5b Halo1", (8192, 64, 144)), ("B5b w4h3", (32768, 16, 100))):
        q, kv, do = (torch.randn(Bw, rows, c, device="cuda", generator=g)
                     for rows, c in ((M, 96), (N, 192), (M, 96)))
        bias = 0.2 * torch.randn(3, M, N, device="cuda", generator=g)
        _, saved = fh.halo_attention_fwd(q, kv, bias, 3)
        out[name + " fwd"] = ms(lambda: fh.halo_attention_fwd(q, kv, bias, 3))
        out[name + " bwd"] = ms(lambda: fh.halo_attention_bwd(saved, do))
        del q, kv, do, saved
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
    for name, (G, M, N) in (("B6 PVT1", (1, 3136, 49)), ("B6 PVT3", (5, 196, 49))):
        g = torch.Generator("cuda").manual_seed(3)
        q, kv, do = (torch.randn(128, rows, c * G * 64, device="cuda", generator=g)
                     for rows, c in ((M, 1), (N, 2), (M, 1)))

        def heads(t):
            return t.reshape(128, -1, G, 64).permute(0, 2, 1, 3)

        q, k, v, do = heads(q), heads(kv[..., :G * 64]), heads(kv[..., G * 64:]), heads(do)
        _, saved = fa.fused_attention_fwd(q, k, v)
        out[name + " fwd"] = ms(lambda: fa.fused_attention_fwd(q, k, v))
        out[name + " bwd"] = ms(lambda: fa.fused_attention_bwd(saved, do))
        del saved
    registers, entry = {}, None
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif ("registers" in line or "spill" in line) and entry and any(
                f"_{src}_cu_" in entry for src in ("fused_layer", "fused_layer_bwd",
                                                  "fused_layer1_bwd", "fused_attention",
                                                  "fused_attention_qkv", "fused_halo",
                                                  "gemm_tc")):
            source = entry.split("_cu_")[0].split("__")[-1].split("_", 2)[2]
            key = f"{source} {entry.split('_cu_')[1][8:]}"
            registers[key] = (registers.get(key, "") + " " + line.split(": ")[-1]).strip()
    print(card)
    for key, used in sorted(registers.items()):
        print(f"ptxas: {key}: {used}")
    print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else ".", **out}))


if __name__ == "__main__":
    main()
