"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (one process per source,
all started together), then links the objects into a shared library with a
plain C interface, under ``vision_transformers_tpu_torch/_build/``.  The
library's name carries a hash of the sources and flags, so a stale build is
never loaded.  A missing ``nvcc`` or a failed build raises RuntimeError with
nvcc's output; there is no fallback.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then on ``PATH``, then in
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "find_nvcc", "BUILD_LOG"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# nvcc's stderr from the build in this process: ptxas's per-kernel
# register / shared-memory / spill report
BUILD_LOG = ""

_LOCK = threading.Lock()
_LIB = None

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "vtx_fused_attention_layer_fwd": [
        _P, _P, _P,              # x, ln_scale, ln_bias
        _P, _L, _L, _P,          # wqkv, its strides, bqkv
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _I, _P,              # extra, groups, rs (extra, rs nullable)
        _P, _P, _P,              # u, qkv, acc (workspace; qkv, acc saved)
        _P, _P, _P,              # mu, rstd, lse (nullable saves)
        _P,                      # out
        _I, _I, _I, _I, _I,      # B, N, C, H, D
        _F, _F, _P,              # scale, eps, stream
    ],
    "vtx_fused_attention_layer_bwd": [
        _P, _P, _P,              # x, ln_scale, ln_bias
        _P, _L, _L, _P,          # wqkv, its strides, bqkv
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _I,                  # extra, groups
        _P, _P, _P, _P, _P, _P,  # rs, qkv, acc, mu, rstd, lse
        _P,                      # dz
        _P, _P, _P, _P,          # dacc, dq partials (nullable), dqkv, dln (workspace)
        _P, _P, _I, _I, _P,      # dbpart, wpart, splits_out, splits_qkv, cpart
        _P, _P, _P,              # dx, dln_scale, dln_bias
        _P, _L, _L, _P,          # dwqkv, its strides, dbqkv
        _P, _L, _L, _P,          # dwout, its strides, dbout
        _P, _P,                  # drs, dextra
        _I, _I, _I, _I, _I,      # B, N, C, H, D
        _F, _P,                  # scale, stream
    ],
    "vtx_window_attention_fwd": [
        _P, _P, _I, _I,          # qkv, bias, groups, cyclic
        _P, _P,                  # out, lse (nullable)
        _I, _I, _I, _I,          # P, N, H, D
        _F, _P,                  # scale, stream
    ],
    "vtx_window_attention_bwd": [
        _P, _P, _P, _P,          # qkv, out, dout, lse
        _P, _I, _I,              # bias, groups, cyclic
        _P, _P, _P,              # dqkv, dbpart (nullable), dbias (nullable)
        _I, _I, _I, _I,          # P, N, H, D
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_transformer_layer_fwd": [
        _P, _P, _P,              # x, ln1_scale, ln1_bias
        _P, _L, _L, _P,          # wqkv, its strides, bqkv
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _P,                  # ln2_scale, ln2_bias
        _P, _L, _L, _P,          # w1, its strides, b1
        _P, _L, _L, _P,          # w2, its strides, b2
        _P, _I, _P, _P,          # extra, groups, rs_attn, rs_ff (nullable)
        _P, _P, _P, _P, _P, _P,  # u, qkv, acc, z, hid (workspace), af (nullable)
        _P, _P, _P, _P, _P,      # mu1, rstd1, lse, mu2, rstd2 (nullable saves)
        _P,                      # out
        _I, _I, _I, _I, _I, _I,  # B, N, C, H, D, F
        _F, _F, _P,              # scale, eps, stream
    ],
    "vtx_fused_transformer_layer_bwd": [
        _P, _P, _P,              # x, ln1_scale, ln1_bias
        _P, _L, _L, _P,          # wqkv, its strides, bqkv
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _P,                  # ln2_scale, ln2_bias
        _P, _L, _L, _P,          # w1, its strides, b1
        _P, _L, _L, _P,          # w2, its strides, b2
        _P, _I, _P, _P,          # extra, groups, rs_attn, rs_ff
        _P, _P, _P, _P,          # qkv, acc, z, hid
        _P, _P, _P, _P, _P,      # mu1, rstd1, lse, mu2, rstd2
        _P,                      # do
        _P, _P, _P, _P, _P,      # af, dh, dz, dacc, dq partials (workspace; nullable)
        _P, _P, _P, _P,          # dqkv, dln, dbpart, wpart
        _I, _I, _I, _I, _P,      # splits out / qkv / w1 / w2, cpart
        _P, _P, _P,              # dx, dln1_scale, dln1_bias
        _P, _L, _L, _P,          # dwqkv, its strides, dbqkv
        _P, _L, _L, _P,          # dwout, its strides, dbout
        _P, _P,                  # dln2_scale, dln2_bias
        _P, _L, _L, _P,          # dw1, its strides, db1
        _P, _L, _L, _P,          # dw2, its strides, db2
        _P, _P, _P,              # dextra, drs_attn, drs_ff
        _I, _I, _I, _I, _I, _I,  # B, N, C, H, D, F
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_swin_layer_fwd": [
        _P, _P, _P,              # x (map), ln1_scale, ln1_bias
        _P, _L, _L, _P,          # wqkv, its strides, bqkv
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _P,                  # ln2_scale, ln2_bias
        _P, _L, _L, _P,          # w1, its strides, b1
        _P, _L, _L, _P,          # w2, its strides, b2
        _P, _I, _P, _P,          # extra, groups, rs_attn, rs_ff (nullable)
        _P,                      # the row → pixel table
        _P, _P, _P, _P, _P, _P,  # u, qkv, acc, z, hid (workspace), af (nullable)
        _P, _P, _P, _P, _P,      # mu1, rstd1, lse, mu2, rstd2 (nullable saves)
        _P,                      # out (map)
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, H, W, C, heads, D, F, window, pack
        _F, _F, _P,              # scale, eps, stream
    ],
    "vtx_fused_swin_layer_bwd": [
        _P, _P, _P,              # x (map), ln1_scale, ln1_bias
        _P, _L, _L, _P,          # wqkv, its strides, bqkv
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _P,                  # ln2_scale, ln2_bias
        _P, _L, _L, _P,          # w1, its strides, b1
        _P, _L, _L, _P,          # w2, its strides, b2
        _P, _I, _P, _P,          # extra, groups, rs_attn, rs_ff
        _P,                      # the row → pixel table
        _P, _P, _P, _P,          # qkv, acc, z, hid
        _P, _P, _P, _P, _P,      # mu1, rstd1, lse, mu2, rstd2
        _P,                      # do (map)
        _P, _P, _P, _P, _P, _P,  # dor, da, af, dh, dz, dacc (workspace)
        _P, _P, _P, _P, _P,      # dqkv, u, dln, dbpart, wpart
        _I, _I, _I, _I, _P,      # splits out / qkv / w1 / w2, cpart
        _P, _P, _P,              # dx (map), dln1_scale, dln1_bias
        _P, _L, _L, _P,          # dwqkv, its strides, dbqkv
        _P, _L, _L, _P,          # dwout, its strides, dbout
        _P, _P,                  # dln2_scale, dln2_bias
        _P, _L, _L, _P,          # dw1, its strides, db1
        _P, _L, _L, _P,          # dw2, its strides, db2
        _P, _P, _P,              # dextra, drs_attn, drs_ff
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, H, W, C, heads, D, F, window, pack
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_halo_layer_fwd": [
        _P, _P, _P,              # x, ln1_scale, ln1_bias
        _P, _L, _L,              # wqkv, its strides (no bias)
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _P,                  # ln2_scale, ln2_bias
        _P, _L, _L, _P,          # w1, its strides, b1
        _P, _L, _L, _P,          # w2, its strides, b2
        _P, _P, _P,              # bias, rs_attn, rs_ff (row scales nullable)
        _P, _P, _P, _P,          # qkv, acc, z, hid (workspace the training forward keeps)
        _P, _P, _P, _P, _P,      # mu1, rstd1, lse (nullable), mu2, rstd2 (statistics)
        _P,                      # out
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, H, W, C, heads, D, F, window, halo
        _F, _F, _I, _P,          # scale, eps, save, stream
    ],
    "vtx_fused_halo_layer_bwd": [
        _P, _P, _P,              # x, ln1_scale, ln1_bias
        _P, _L, _L,              # wqkv, its strides
        _P, _L, _L, _P,          # wout, its strides, bout
        _P, _P,                  # ln2_scale, ln2_bias
        _P, _L, _L, _P,          # w1, its strides, b1
        _P, _L, _L, _P,          # w2, its strides, b2
        _P, _P, _P,              # bias, rs_attn, rs_ff
        _P, _P, _P, _P,          # qkv, acc, z, hid
        _P, _P, _P, _P, _P,      # mu1, rstd1, lse, mu2, rstd2
        _P,                      # do
        _P, _P, _P, _P, _P, _P,  # dh, dz, dacc, dq partials (nullable), dqkv, dln (workspace)
        _P, _P, _P, _I,          # dr₂ row partials, dkvw, dbias partials, chunks
        _P, _I, _I, _I, _I, _P,  # wpart, splits out / qkv / w1 / w2, cpart
        _P, _P, _P,              # dx, dln1_scale, dln1_bias
        _P, _L, _L,              # dwqkv, its strides
        _P, _L, _L, _P,          # dwout, its strides, dbout
        _P, _P,                  # dln2_scale, dln2_bias
        _P, _L, _L, _P,          # dw1, its strides, db1
        _P, _L, _L, _P,          # dw2, its strides, db2
        _P, _P, _P,              # dbias, drs_attn, drs_ff
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # B, H, W, C, heads, D, F, window, halo
        _F, _P,                  # scale, stream
    ],
    "vtx_halo_attention_direct_fwd": [
        _P, _P, _P, _P, _P,      # q, kv, bias, out, lse (nullable save)
        _I, _I, _I, _I, _I, _I, _I,  # B, H, W, heads, D, window, halo
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_attention_fwd": [
        _P, _L, _L, _L,          # q, its (b, g, row) strides
        _P, _L, _L, _L,          # k, its strides
        _P, _L, _L, _L,          # v, its strides
        _P, _L, _L,              # extra (nullable), its (g, m) strides
        _P, _P,                  # out, lse (nullable save)
        _I, _I, _I, _I, _I,      # B, G, M, N, D
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_attention_bwd": [
        _P, _L, _L, _L,          # q, its strides
        _P, _L, _L, _L,          # k, its strides
        _P, _L, _L, _L,          # v, its strides
        _P, _L, _L,              # extra (nullable), its (g, m) strides
        _P, _P,                  # out, lse
        _P, _L, _L, _L,          # do, its strides
        _P, _P, _I,              # dq / dk-dv partials (workspace, nullable), chunks
        _P,                      # dsbuf (workspace, nullable)
        _P, _P, _P,              # dq, dkv, dextra (nullable)
        _I, _I, _I, _I, _I,      # B, G, M, N, D
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_attention_qkv_fwd": [
        _P, _P, _I,              # qkv, extra (nullable), groups
        _P, _P,                  # out, lse (nullable save)
        _I, _I, _I, _I,          # B, N, H, D
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_attention_qkv_bwd": [
        _P, _P, _I,              # qkv, extra (nullable), groups
        _P, _P, _P,              # out, lse, dout
        _P, _P,                  # dq partials, dsbuf (workspace, nullable)
        _P, _P,                  # dqkv, dextra (nullable)
        _I, _I, _I, _I,          # B, N, H, D
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_ff_layer_fwd": [
        _P, _P, _P,              # x, ln_scale, ln_bias
        _P, _L, _L, _P,          # w1, its strides, b1 (nullable)
        _P, _L, _L, _P,          # w2, its strides, b2 (nullable)
        _P,                      # row scale (nullable)
        _P, _P, _P,              # u, hid (workspace), af (nullable)
        _P, _P,                  # mu, rstd (nullable saves)
        _P,                      # out
        _I, _I, _I, _I, _I,      # B, N, C, F, activation (0 silu, 1 gelu)
        _F, _P,                  # eps, stream
    ],
    "vtx_fused_ff_layer_bwd": [
        _P, _P, _P,              # x, ln_scale, ln_bias
        _P, _L, _L, _P,          # w1, its strides, b1
        _P, _L, _L, _P,          # w2, its strides, b2
        _P, _P, _P, _P,          # row scale, hid, mu, rstd
        _P,                      # dout
        _P, _P, _P, _P, _P,      # da, af, dh, u, dln (workspace)
        _P, _I, _I, _P,          # wpart, splits w1 / w2, cpart
        _P, _P, _P,              # dx, dln_scale, dln_bias
        _P, _L, _L, _P,          # dw1, its strides, db1
        _P, _L, _L, _P,          # dw2, its strides, db2
        _P,                      # drs
        _I, _I, _I, _I, _I,      # B, N, C, F, activation
        _P,                      # stream
    ],
    "vtx_halo_attention_direct_bwd": [
        _P, _P, _P, _P, _P, _P,  # q, kv, bias, out, lse, do
        _P, _P, _I, _P,          # dkvw, dbias partials, chunks, dq partials (nullable)
        _P, _P, _P,              # dq, dkv, dbias
        _I, _I, _I, _I, _I, _I, _I,  # B, H, W, heads, D, window, halo
        _F, _P,                  # scale, stream
    ],
    "vtx_halo_attention_fwd": [
        _P, _P, _P, _P, _P,      # q, kv, bias, out, lse (nullable save)
        _I, _I, _I, _I, _I,      # B' windows, M, N, heads, D
        _F, _P,                  # scale, stream
    ],
    "vtx_halo_attention_bwd": [
        _P, _P, _P, _P, _P, _P,  # q, kv, bias, out, lse, do
        _P, _I, _P,              # dbias partials, chunks, dq partials (nullable)
        _P, _P, _P,              # dq, dkv, dbias
        _I, _I, _I, _I, _I,      # B' windows, M, N, heads, D
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_attention_block_fwd": [
        _P,                      # x
        _P, _L, _L, _P,          # wqkv, its strides, bqkv (nullable)
        _P, _L, _L, _P,          # wout, its strides, bout (nullable)
        _P, _I,                  # extra (nullable), groups
        _P, _P, _P, _P,          # qkv, acc (workspace, saved), lse (nullable), out
        _I, _I, _I, _I, _I, _I,  # B, N, C, H, D, Cout
        _F, _P,                  # scale, stream
    ],
    "vtx_fused_attention_block_bwd": [
        _P, _P, _L, _L,          # x; wqkv, its strides
        _P, _L, _L,              # wout, its strides
        _P, _I,                  # extra (nullable), groups
        _P, _P, _P, _P,          # qkv, acc, lse, dout
        _P, _P, _P, _P,          # dacc, dq partials, dqkv, dsbuf (workspace; nullable
                                 # but dacc, dqkv)
        _P, _I, _I, _P,          # wpart, splits out / qkv, cpart
        _P,                      # dx
        _P, _L, _L, _P,          # dwqkv, its strides, dbqkv (nullable)
        _P, _L, _L, _P,          # dwout, its strides, dbout (nullable)
        _P,                      # dextra (nullable)
        _I, _I, _I, _I, _I, _I,  # B, N, C, H, D, Cout
        _F, _P,                  # scale, stream
    ],
    "vtx_gemm_tc": [
        _P, _I, _P, _L, _L,      # A, lda (split-K), B, its (k, n) strides
        _P, _P, _I, _P,          # bias, row scale, rows per scale, res (nullable)
        _P,                      # out
        _P, _I, _I,              # the row → pixel table (nullable), its length, form
        _P, _I, _L, _L,          # split-K slabs (workspace), their count, out strides
        _I, _I, _I, _I,          # M, N, K, silu
        _P, _P, _P, _P, _I,      # A's LayerNorm: mu, rstd, scale, bias (nullable); A's act
        _P, _I,                  # B's row scale (nullable), its rows
        _P, _I, _P, _P,          # hid (nullable), its act, row partials, column partials
        _P,                      # stream
    ],
    "vtx_gemm_tc_bf16": [
        _P, _I, _P, _L, _L,      # A, lda (split-K), B, its (k, n) strides (bf16)
        _P, _P, _I, _P,          # bias (bf16), row scale (f32), rows per scale, res
        _P, _I, _I,              # out (bf16, or f32 with out_f32 / split-K), out_f32, form
        _P, _I, _L, _L,          # split-K slabs (workspace), their count, out strides
        _I, _I, _I, _I,          # M, N, K, silu
        _I, _P,                  # the TMA path's promote (0: the rule's); plan
        _P,                      # stream
    ],
    "vtx_packed_attention_fwd_bf16": [
        _P, _P, _P,              # qkv, out, lse (nullable)
        _I, _I, _I, _I,          # B, N, H, D
        _F, _P,                  # scale, stream
    ],
    "vtx_packed_attention_bwd_bf16": [
        _P, _P, _P, _P,          # qkv, out, lse, dout
        _P, _P,                  # workspace (L and Δ rows; dq partials past 256 keys), dqkv
        _I, _I, _I, _I,          # B, N, H, D
        _F, _P,                  # scale, stream
    ],
}
# the bf16 forms of B1 and B2 (bias-free): the f32 entries' parameter lists
for _name in ("vtx_fused_attention_layer_fwd", "vtx_fused_attention_layer_bwd",
              "vtx_fused_transformer_layer_fwd"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None,
                 shutil.which("nvcc"), _DEFAULT_NVCC):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin); the CUDA "
        "kernels of vision_transformers_tpu_torch are built from csrc/ at first "
        "use and need the CUDA toolkit")


def _library_path(sources: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_DIR / f"libvtx_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with nvcc's output on the first
    failure.  Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs, failed = [], None
    try:
        for cmd, proc in zip(cmds, procs):
            try:
                out, err = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc timed out after {e.timeout} s: "
                                   f"{' '.join(cmd)}") from e
            logs.append(err)
            if proc.returncode != 0 and failed is None:
                failed = (f"nvcc failed with exit code {proc.returncode}: "
                          f"{' '.join(cmd)}\n{err}{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(failed)
    return logs


def _compile(sources: list[Path], so: Path) -> str:
    nvcc = find_nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus = [p for p in sources if p.suffix == ".cu"]
    objs = [_BUILD_DIR / f"{so.stem}.{os.getpid()}.{p.stem}.o" for p in cus]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        logs = _run_all([[nvcc, *_FLAGS, "-c", "-o", str(o), str(p)]
                         for o, p in zip(objs, cus)])
        logs += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return "".join(logs)


def build() -> ctypes.CDLL:
    """Compile (if needed), load and declare the kernel library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
        so = _library_path(sources)
        if not so.exists():
            BUILD_LOG = _compile(sources, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib
