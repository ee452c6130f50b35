// Halo windowed attention and the whole Halo layer, float32, for Hopper
// (sm_90a).
//
// Replaces the TPU (Pallas) kernels
//   vision_transformers_tpu/ops/fused_halo_layer.py:92   _hl_fwd_kernel
//   vision_transformers_tpu/ops/fused_halo_layer.py:179  _hl_bwd_kernel
//       the whole Halo layer off the feature map x [B, H, W, C]:
//       z = x + r₁ ⊙ OutProj(HaloAttn(QkvProj(LN₁(x)) + bias))   (qkv: no bias)
//       o = z + r₂ ⊙ (silu(LN₂(z)·W₁ + b₁)·W₂ + b₂)
//   vision_transformers_tpu/ops/fused_halo.py:252  _direct_fwd_kernel
//   vision_transformers_tpu/ops/fused_halo.py:282  _direct_bwd_kernel
//       the attention alone, straight off q [B, H, W, C] and kv [B, H, W, 2C]
//       (k lanes, then v lanes)
// with four C entry points, each a short sequence of launches on the
// caller's stream:
//   vtx_fused_halo_layer_fwd      ln_rows → gemm (qkv) → halo attention (+ lse)
//                                 → gemm (+bout, ×r₁, +x) → ln_rows →
//                                 gemm (+b₁, silu) → gemm (+b₂, ×r₂, +z)
//   vtx_fused_halo_layer_bwd      the FF half and the out projection's
//                                 backward as the whole transformer layer's
//                                 (fused_layer1_bwd.cu, fused_layer_bwd.cu),
//                                 then the halo attention backward (dk / dv
//                                 per window with the dbias partials, dq),
//                                 the dkv fold, the ordered dbias sum, the
//                                 qkv projection's and LN₁'s backward
//   vtx_halo_attention_direct_fwd the halo attention (+ lse)
//   vtx_halo_attention_direct_bwd Δ, the halo attention backward, the fold
//                                 and the dbias sum
//
// Halo attention.  Windows are w x w tiles of the map; the w² queries of a
// window attend to the k² keys of its neighbourhood, the k x k square
// (k = w + 2·halo) centred on the window, and every score carries the
// relative-position bias [heads, w², k²].  Neighbourhood positions outside
// the map are ZERO keys and values, not masked ones: the reference
// zero-pads the projected kv (halo_transformer.py; fused_halo_layer.py:81-89),
// so such a position scores 0·scale + bias and takes softmax mass.  The
// kernels read q / k / v straight from the maps by (image, y, x) with a row
// stride, so the whole layer's packed qkv [M, 3HD] and the direct op's two
// maps go through the same kernels.  The Pallas layer kernel LNs the
// zero-padded band and masks kv afterwards; here LN₁ and the qkv GEMM run
// once over the unpadded map and out-of-map positions read as zeros: the
// same values, without LN(0).
//
//   forward   one block per (window, head, image), one query per thread
//             (w² ≤ 64), neighbourhood key / value tiles and the bias tile
//             staged in shared memory, online max-subtracted softmax in f32;
//             the training forward also writes lse [B, heads, H·W].
//   dk / dv   one key of the neighbourhood per thread, blocks of 64 keys; a
//             block walks a chunk of (image, window) pairs in order and
//             writes, per pair, dk and dv to the per-window buffer
//             dkvw [B·S, k², 2HD] (S windows per image), and keeps
//             dS = p ⊙ (dP − Δ) summed over its pairs for each (query, its
//             key) in shared memory: one dbias partial per chunk.
//   dq        one query per thread, keys and the bias staged as in the
//             forward.
//   fold      each token's dk / dv are the sum over the ≤ 2 x 2 windows
//             whose neighbourhood holds it (2·halo ≤ w), gathered from dkvw
//             in window order; out-of-map positions are dropped (their k and
//             v were zeros, not functions of x), their dS still feeds dbias.
//   dbias     the chunks' partials summed in chunk order.
// No float atomics anywhere, so the backward is bit-identical from run to
// run.
//
// What bounds it on this card.  At Halo-S (window 8, halo 2, D = 32,
// k² = 144) the layer's four projection GEMMs are 24·M·C² operations
// forward (116 GFLOP per layer at 128 images, the same at each stage),
// halo attention 4·M·k²·HD (28.9 GFLOP at stage 1), all plain f32 FMAs:
// the bound is the f32 FMA rate, 67 TFLOP/s at 700 W.  The attention
// kernels hold one query (or key) per thread with a 32-wide head in
// registers and stream the other side through shared memory, as the whole
// transformer layer's do; only D ≤ 32 is instantiated.  The per-window
// dkvw buffer costs B·S·k²·2HD floats written and read once (0.9 GB at
// stage 1 for 128 images) instead of atomics.
//
// What later work changes: mma / wgmma tiles for the attention products,
// the attention fused into the qkv GEMM's consumer, bf16 operands.

#include "common.cuh"

namespace {

constexpr int HQ = 64;    // queries per block = threads (window² ≤ HQ)
constexpr int HDH = 32;   // register width of a head (D ≤ HDH, zero-padded)
constexpr int HKV = 16;   // keys per shared-memory tile (forward, dq)
constexpr int HKB = 64;   // keys per block = threads (dk / dv)
constexpr int HBQ = 16;   // queries per shared-memory tile (dk / dv)

// map geometry: H x W tokens per image, windows w x w, neighbourhoods k x k
struct HaloGeom {
  int H, W, w, halo, k, hs, ws;  // hs x ws windows per image
};

inline HaloGeom halo_geom(int H, int W, int window, int halo) {
  return {H, W, window, halo, window + 2 * halo, H / window, W / window};
}

// token (y·W + x) of query i of window (wy, wx)
__device__ __forceinline__ int q_token(const HaloGeom& g, int wy, int wx, int i) {
  return (wy * g.w + i / g.w) * g.W + wx * g.w + i % g.w;
}

// token of neighbourhood position j of window (wy, wx), −1 outside the map
__device__ __forceinline__ int nb_token(const HaloGeom& g, int wy, int wx, int j) {
  const int y = wy * g.w - g.halo + j / g.k;
  const int x = wx * g.w - g.halo + j % g.k;
  return (y >= 0 && y < g.H && x >= 0 && x < g.W) ? y * g.W + x : -1;
}

// ---------------------------------------------------------------------------
// forward: grid (windows, heads, images), one query per thread.  q, k, v
// are the maps' first lanes of the head-0 query / key / value (element
// (token, h·D + d) at ptr[token·stride + h·D + d]); out [M, HD].
// ---------------------------------------------------------------------------

template <bool SAVE_LSE>
__global__ void __launch_bounds__(HQ)
halo_attn_fwd_kernel(const float* __restrict__ q, int qs, const float* __restrict__ k,
                     const float* __restrict__ v, int kvs, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ lse, HaloGeom g,
                     int nh, int D, float scale) {
  __shared__ float Ks[HKV][HDH];
  __shared__ float Vs[HKV][HDH];
  __shared__ float Es[HQ][HKV + 1];
  const int win = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int wy = win / g.ws, wx = win % g.ws;
  const int nq = g.w * g.w, nk = g.k * g.k, HD = nh * D;
  const long long img = (long long)b * g.H * g.W;
  const bool active = t < nq;
  const int tok = active ? q_token(g, wy, wx, t) : 0;
  const float* bh = bias + (long long)h * nq * nk;

  float qr[HDH], o[HDH];
#pragma unroll
  for (int d = 0; d < HDH; ++d) {
    qr[d] = (active && d < D) ? q[(img + tok) * qs + h * D + d] : 0.f;
    o[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < nk; j0 += HKV) {
    for (int idx = t; idx < HKV * HDH; idx += HQ) {
      const int jj = idx / HDH, d = idx % HDH, j = j0 + jj;
      const int kt = (j < nk && d < D) ? nb_token(g, wy, wx, j) : -1;
      const long long off = (img + kt) * kvs + h * D + d;
      Ks[jj][d] = kt >= 0 ? k[off] : 0.f;  // zero key / value outside the map
      Vs[jj][d] = kt >= 0 ? v[off] : 0.f;
    }
    for (int idx = t; idx < HQ * HKV; idx += HQ) {
      const int i = idx / HKV, jj = idx % HKV;
      Es[i][jj] = (i < nq && j0 + jj < nk) ? bh[(long long)i * nk + j0 + jj] : 0.f;
    }
    __syncthreads();

    float s[HKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < HKV; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HDH; ++d) dot = fmaf(qr[d], Ks[jj][d], dot);
      s[jj] = (j0 + jj < nk) ? dot * scale + Es[t][jj] : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    // every tile holds at least one position, so m_new is finite
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HDH; ++d) o[d] *= alpha;
#pragma unroll
    for (int jj = 0; jj < HKV; ++jj) {
      const float p = expf(s[jj] - m_new);  // 0 past the neighbourhood
      l += p;
#pragma unroll
      for (int d = 0; d < HDH; ++d) o[d] = fmaf(p, Vs[jj][d], o[d]);
    }
    m = m_new;
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / l;
    float* orow = out + (img + tok) * HD + h * D;
#pragma unroll
    for (int d = 0; d < HDH; ++d)
      if (d < D) orow[d] = o[d] * inv;
    if (SAVE_LSE) lse[((long long)b * nh + h) * g.H * g.W + tok] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// dk / dv and the dbias partials: grid (chunks · key tiles, heads), one
// neighbourhood key per thread.  Chunk c walks pairs [c·per, (c+1)·per) of
// the B·S (image, window) pairs in order; per pair, query tiles of q, do,
// lse, Δ are streamed through shared memory (broadcast) in d-outer passes
// as in fused_layer_bwd.cu's key-tile pass.  Thread t keeps column t of
// the chunk's dS sum, Bacc[i][t], in shared memory.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(HKB)
halo_attn_bwd_dkdv_kernel(const float* __restrict__ q, int qs,
                          const float* __restrict__ k, const float* __restrict__ v,
                          int kvs, const float* __restrict__ bias,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dkvw,
                          float* __restrict__ part, int pairs, int per_chunk,
                          int ktiles, HaloGeom g, int nh, int D, float scale) {
  __shared__ float Ks[HKB][HDH + 1];  // +1: thread t reads row t, bank-free
  __shared__ float Vs[HKB][HDH + 1];
  __shared__ float Qs[HBQ][HDH];
  __shared__ float dOs[HBQ][HDH];
  __shared__ float Ls[HBQ], Ds[HBQ];
  __shared__ float Bacc[HQ][HKB];
  __shared__ int Tk[HKB];
  const int c = blockIdx.x / ktiles, kt = blockIdx.x % ktiles;
  const int h = blockIdx.y, t = threadIdx.x;
  const int nq = g.w * g.w, nk = g.k * g.k, HD = nh * D, S = g.hs * g.ws;
  const long long HW = (long long)g.H * g.W;
  const int j = kt * HKB + t;
  const bool key = j < nk;
  const float* bh = bias + (long long)h * nq * nk;
  for (int i = 0; i < nq; ++i) Bacc[i][t] = 0.f;

  const int p_end = min(pairs, (c + 1) * per_chunk);
  for (int pr = c * per_chunk; pr < p_end; ++pr) {
    const int b = pr / S, win = pr % S;
    const int wy = win / g.ws, wx = win % g.ws;
    const long long img = (long long)b * HW;
    __syncthreads();  // the last pair's tiles fully read
    Tk[t] = key ? nb_token(g, wy, wx, j) : -1;
    __syncthreads();
    for (int idx = t; idx < HKB * HDH; idx += HKB) {
      const int jj = idx / HDH, d = idx % HDH;
      const int tk = d < D ? Tk[jj] : -1;
      const long long off = (img + tk) * kvs + h * D + d;
      Ks[jj][d] = tk >= 0 ? k[off] : 0.f;
      Vs[jj][d] = tk >= 0 ? v[off] : 0.f;
    }

    float dk[HDH], dv[HDH];
#pragma unroll
    for (int d = 0; d < HDH; ++d) dk[d] = dv[d] = 0.f;

    for (int q0 = 0; q0 < nq; q0 += HBQ) {
      __syncthreads();  // Ks / Vs written, or the last query tile fully read
      for (int idx = t; idx < HBQ * HDH; idx += HKB) {
        const int i = idx / HDH, d = idx % HDH;
        const bool ok = q0 + i < nq && d < D;
        const long long tq = ok ? img + q_token(g, wy, wx, q0 + i) : 0;
        Qs[i][d] = ok ? q[tq * qs + h * D + d] : 0.f;
        dOs[i][d] = ok ? dout[tq * HD + h * D + d] : 0.f;
      }
      if (t < HBQ) {
        const bool ok = q0 + t < nq;
        const long long r = ((long long)b * nh + h) * HW +
                            (ok ? q_token(g, wy, wx, q0 + t) : 0);
        Ls[t] = ok ? lse[r] : INFINITY;  // p = exp(−inf) = 0 for padding
        Ds[t] = ok ? delta[r] : 0.f;
      }
      __syncthreads();
      float p[HBQ], ds[HBQ];
#pragma unroll
      for (int i = 0; i < HBQ; ++i) p[i] = ds[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HDH; ++d) {
        const float kd = Ks[t][d], vd = Vs[t][d];
#pragma unroll
        for (int i = 0; i < HBQ; ++i) {
          p[i] = fmaf(Qs[i][d], kd, p[i]);     // the score q_i·k
          ds[i] = fmaf(dOs[i][d], vd, ds[i]);  // do_i·v
        }
      }
#pragma unroll
      for (int i = 0; i < HBQ; ++i) {
        const bool ok = q0 + i < nq && key;
        const float e = ok ? bh[(long long)(q0 + i) * nk + j] : 0.f;
        p[i] = ok ? expf(p[i] * scale + e - Ls[i]) : 0.f;
        ds[i] = p[i] * (ds[i] - Ds[i]);
        if (q0 + i < nq) Bacc[q0 + i][t] += ds[i];
      }
#pragma unroll
      for (int d = 0; d < HDH; ++d) {
        float v_acc = dv[d], k_acc = dk[d];
#pragma unroll
        for (int i = 0; i < HBQ; ++i) {
          v_acc = fmaf(p[i], dOs[i][d], v_acc);
          k_acc = fmaf(ds[i], Qs[i][d], k_acc);
        }
        dv[d] = v_acc;
        dk[d] = k_acc;
      }
    }

    // a key outside the map is a zero, not a function of x: dropped
    if (Tk[t] >= 0) {
      float* row = dkvw + (((long long)b * S + win) * nk + j) * 2 * HD + h * D;
#pragma unroll
      for (int d = 0; d < HDH; ++d) {
        if (d < D) {
          row[d] = dk[d] * scale;
          row[HD + d] = dv[d];
        }
      }
    }
  }

  if (key) {
    float* prow = part + ((long long)c * nh + h) * nq * nk + j;
    for (int i = 0; i < nq; ++i) prow[(long long)i * nk] = Bacc[i][t];
  }
}

// ---------------------------------------------------------------------------
// dq: grid (windows, heads, images), one query per thread, its q and do rows
// in (padded) shared memory, neighbourhood key tiles and the bias tile
// staged as in the forward; two d-outer passes per tile as in
// fused_layer_bwd.cu's query-tile pass.  dq [token·dqs + h·D + d].
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(HQ)
halo_attn_bwd_dq_kernel(const float* __restrict__ q, int qs,
                        const float* __restrict__ k, const float* __restrict__ v,
                        int kvs, const float* __restrict__ bias,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int dqs, HaloGeom g, int nh, int D, float scale) {
  __shared__ float Qs[HQ][HDH + 1];  // +1: thread t reads row t, bank-free
  __shared__ float dOs[HQ][HDH + 1];
  __shared__ float Ks[HKV][HDH];
  __shared__ float Vs[HKV][HDH];
  __shared__ float Es[HQ][HKV + 1];
  const int win = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t = threadIdx.x;
  const int wy = win / g.ws, wx = win % g.ws;
  const int nq = g.w * g.w, nk = g.k * g.k, HD = nh * D;
  const long long HW = (long long)g.H * g.W;
  const long long img = (long long)b * HW;
  const float* bh = bias + (long long)h * nq * nk;

  for (int idx = t; idx < HQ * HDH; idx += HQ) {
    const int i = idx / HDH, d = idx % HDH;
    const bool ok = i < nq && d < D;
    const long long tq = ok ? img + q_token(g, wy, wx, i) : 0;
    Qs[i][d] = ok ? q[tq * qs + h * D + d] : 0.f;
    dOs[i][d] = ok ? dout[tq * HD + h * D + d] : 0.f;
  }
  const bool active = t < nq;
  const int tok = active ? q_token(g, wy, wx, t) : 0;
  const long long r = ((long long)b * nh + h) * HW + tok;
  const float l = active ? lse[r] : 0.f;
  const float dl = active ? delta[r] : 0.f;
  float dqa[HDH];
#pragma unroll
  for (int d = 0; d < HDH; ++d) dqa[d] = 0.f;

  for (int j0 = 0; j0 < nk; j0 += HKV) {
    __syncthreads();  // Qs / dOs written, or the last tile fully read
    for (int idx = t; idx < HKV * HDH; idx += HQ) {
      const int jj = idx / HDH, d = idx % HDH, j = j0 + jj;
      const int kt = (j < nk && d < D) ? nb_token(g, wy, wx, j) : -1;
      const long long off = (img + kt) * kvs + h * D + d;
      Ks[jj][d] = kt >= 0 ? k[off] : 0.f;
      Vs[jj][d] = kt >= 0 ? v[off] : 0.f;
    }
    for (int idx = t; idx < HQ * HKV; idx += HQ) {
      const int i = idx / HKV, jj = idx % HKV;
      Es[i][jj] = (i < nq && j0 + jj < nk) ? bh[(long long)i * nk + j0 + jj] : 0.f;
    }
    __syncthreads();
    float p[HKV], ds[HKV];
#pragma unroll
    for (int jj = 0; jj < HKV; ++jj) p[jj] = ds[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDH; ++d) {
      const float qd = Qs[t][d], dod = dOs[t][d];
#pragma unroll
      for (int jj = 0; jj < HKV; ++jj) {
        p[jj] = fmaf(qd, Ks[jj][d], p[jj]);     // the score q·k_j
        ds[jj] = fmaf(dod, Vs[jj][d], ds[jj]);  // do·v_j
      }
    }
#pragma unroll
    for (int jj = 0; jj < HKV; ++jj) {
      p[jj] = (active && j0 + jj < nk) ? expf(p[jj] * scale + Es[t][jj] - l) : 0.f;
      ds[jj] = p[jj] * (ds[jj] - dl);
    }
#pragma unroll
    for (int d = 0; d < HDH; ++d) {
      float acc = dqa[d];
#pragma unroll
      for (int jj = 0; jj < HKV; ++jj) acc = fmaf(ds[jj], Ks[jj][d], acc);
      dqa[d] = acc;
    }
  }

  if (active) {
    float* row = dq + (img + tok) * dqs + h * D;
#pragma unroll
    for (int d = 0; d < HDH; ++d)
      if (d < D) row[d] = dqa[d] * scale;
  }
}

// ---------------------------------------------------------------------------
// fold: out[token·os + lane] = Σ dkvw[(b·S + win)·k² + j(token, win), lane]
// over the windows whose neighbourhood holds the token, in window order
// (lanes: 2HD, dk then dv)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__global__ void __launch_bounds__(EW_THREADS)
halo_fold_kernel(const float* __restrict__ dkvw, HaloGeom g, int lanes,
                 long long total, float* __restrict__ out, int os) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= total) return;
  const int lane = i % lanes;
  const long long m = i / lanes;
  const long long HW = (long long)g.H * g.W;
  const long long b = m / HW;
  const int tok = m % HW, y = tok / g.W, x = tok % g.W;
  const int nk = g.k * g.k, S = g.hs * g.ws;
  // window wy holds row y iff 0 ≤ y + halo − wy·w < k
  const int wy0 = max(0, floor_div(y + g.halo - g.k, g.w) + 1);
  const int wy1 = min(g.hs - 1, (y + g.halo) / g.w);
  const int wx0 = max(0, floor_div(x + g.halo - g.k, g.w) + 1);
  const int wx1 = min(g.ws - 1, (x + g.halo) / g.w);
  float s = 0.f;
  for (int wy = wy0; wy <= wy1; ++wy)
    for (int wx = wx0; wx <= wx1; ++wx) {
      const int j = (y + g.halo - wy * g.w) * g.k + (x + g.halo - wx * g.w);
      s += dkvw[((b * S + wy * g.ws + wx) * nk + j) * lanes + lane];
    }
  out[m * os + lane] = s;
}

// ---------------------------------------------------------------------------
// launch sequences
// ---------------------------------------------------------------------------

cudaError_t check_geom(const HaloGeom& g, int B, int nh, int D) {
  if (D < 1 || D > HDH || g.w < 1 || g.w * g.w > HQ || g.halo < 0 ||
      2 * g.halo > g.w || g.H % g.w || g.W % g.w || B > 65535 || nh > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t halo_attention_fwd(const float* q, int qs, const float* k, const float* v,
                               int kvs, const float* bias, float* out, float* lse,
                               int B, const HaloGeom& g, int nh, int D, float scale,
                               cudaStream_t s) {
  VTX_CHECK(check_geom(g, B, nh, D));
  const dim3 grid(g.hs * g.ws, nh, B);
  if (lse)
    halo_attn_fwd_kernel<true><<<grid, HQ, 0, s>>>(q, qs, k, v, kvs, bias, out, lse,
                                                   g, nh, D, scale);
  else
    halo_attn_fwd_kernel<false><<<grid, HQ, 0, s>>>(q, qs, k, v, kvs, bias, out,
                                                    nullptr, g, nh, D, scale);
  return cudaGetLastError();
}

// dq [token·dqs + h·D + d], dkv [token·dkvs + lane] (2HD lanes), dbias
// [heads, w², k²]; workspace dkvw [B·S·k²·2HD], part [chunks·heads·w²·k²]
cudaError_t halo_attention_bwd(const float* q, int qs, const float* k, const float* v,
                               int kvs, const float* bias, const float* dout,
                               const float* lse, const float* delta, float* dkvw,
                               float* part, int chunks, float* dq, int dqs,
                               float* dkv, int dkvs, float* dbias, int B,
                               const HaloGeom& g, int nh, int D, float scale,
                               cudaStream_t s) {
  VTX_CHECK(check_geom(g, B, nh, D));
  const int S = g.hs * g.ws, pairs = B * S, HD = nh * D;
  const int nq = g.w * g.w, nk = g.k * g.k;
  if (chunks < 1 || chunks > pairs) return cudaErrorInvalidValue;
  const int per_chunk = cdiv(pairs, chunks), ktiles = cdiv(nk, HKB);
  halo_attn_bwd_dkdv_kernel<<<dim3(chunks * ktiles, nh), HKB, 0, s>>>(
      q, qs, k, v, kvs, bias, dout, lse, delta, dkvw, part, pairs, per_chunk,
      ktiles, g, nh, D, scale);
  VTX_CHECK(cudaGetLastError());
  halo_attn_bwd_dq_kernel<<<dim3(S, nh, B), HQ, 0, s>>>(
      q, qs, k, v, kvs, bias, dout, lse, delta, dq, dqs, g, nh, D, scale);
  VTX_CHECK(cudaGetLastError());
  const long long total = (long long)B * g.H * g.W * 2 * HD;
  halo_fold_kernel<<<ew_blocks(total), EW_THREADS, 0, s>>>(dkvw, g, 2 * HD, total,
                                                          dkv, dkvs);
  VTX_CHECK(cudaGetLastError());
  return launch_splitk_reduce(part, chunks, 1, nh * nq * nk, dbias, 0, 1, s);
}

}  // namespace

// The C entry points return the first cudaError_t met (0 = success).  Maps
// are NHWC, M = B·H·W tokens, HD = heads·D; lse and Δ are [B, heads, H·W].

// x [M, C]; qkv has no bias; rs_attn / rs_ff [B] and the saves af [M, F],
// mu1, rstd1, lse, mu2, rstd2 may be null (serving); u, qkv, acc, z, hid are
// workspace the training forward keeps (hid then holds the FF
// pre-activation).
extern "C" int vtx_fused_halo_layer_fwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* bias, const float* rs_attn, const float* rs_ff,
    float* u, float* qkv, float* acc, float* z, float* hid, float* af,
    float* mu1, float* rstd1, float* lse, float* mu2, float* rstd2, float* out,
    int B, int H, int W, int C, int nh, int D, int F, int window, int halo,
    float scale, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HaloGeom g = halo_geom(H, W, window, halo);
  const int N = H * W, M = B * N, HD = nh * D;
  VTX_CHECK(launch_ln(x, ln1_g, ln1_b, u, mu1, rstd1, M, C, eps, s));
  VTX_CHECK(launch_gemm(u, wqkv, wqkv_s0, wqkv_s1, nullptr, nullptr, 1, nullptr,
                        qkv, M, 3 * HD, C, 0, s));
  VTX_CHECK(halo_attention_fwd(qkv, 3 * HD, qkv + HD, qkv + 2 * HD, 3 * HD, bias,
                               acc, lse, B, g, nh, D, scale, s));
  VTX_CHECK(launch_gemm(acc, wout, wout_s0, wout_s1, bout, rs_attn, N, x, z, M, C,
                        HD, 0, s));
  return static_cast<int>(vtx::ff_half_fwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2,
                                           w2_s0, w2_s1, b2, rs_ff, N, u, hid, af,
                                           mu2, rstd2, out, M, C, F, eps, s));
}

// Workspace, all allocated by the caller: da [M, C] (used only with a row
// scale), af [M, F], dh [M, F], dz [M, C], dacc [M, HD], delta [B·heads·H·W],
// dqkv [M, 3HD], u [M, C], dln [M, C], dkvw [B·S·k²·2HD], part
// [chunks·heads·w²·k²], wpart [max over the four weight gradients of
// splits·rows·cols], cpart [ceil(M / 128) · max(C, 3HD, F)].  The weight
// gradients are written through their (row, col) strides; bout, b1, b2,
// the row scales and their gradients may be null.
extern "C" int vtx_fused_halo_layer_bwd(
    const float* x, const float* ln1_g, const float* ln1_b,
    const float* wqkv, long long wqkv_s0, long long wqkv_s1,
    const float* wout, long long wout_s0, long long wout_s1, const float* bout,
    const float* ln2_g, const float* ln2_b,
    const float* w1, long long w1_s0, long long w1_s1, const float* b1,
    const float* w2, long long w2_s0, long long w2_s1, const float* b2,
    const float* bias, const float* rs_attn, const float* rs_ff,
    const float* qkv, const float* acc, const float* z, const float* hid,
    const float* mu1, const float* rstd1, const float* lse, const float* mu2,
    const float* rstd2, const float* dout,
    float* da, float* af, float* dh, float* dz, float* dacc, float* delta,
    float* dqkv, float* u, float* dln, float* dkvw, float* part, int chunks,
    float* wpart, int splits_out, int splits_qkv, int splits_w1, int splits_w2,
    float* cpart,
    float* dx, float* dg1, float* db1,
    float* dwqkv, long long dwqkv_s0, long long dwqkv_s1,
    float* dwout, long long dwout_s0, long long dwout_s1, float* dbout,
    float* dg2, float* db2,
    float* dw1, long long dw1_s0, long long dw1_s1, float* db1f,
    float* dw2, long long dw2_s0, long long dw2_s1, float* db2f,
    float* dbias, float* drs_attn, float* drs_ff,
    int B, int H, int W, int C, int nh, int D, int F, int window, int halo,
    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HaloGeom g = halo_geom(H, W, window, halo);
  const int N = H * W, M = B * N, HD = nh * D;
  // FF half, given do → dz
  VTX_CHECK(vtx::ff_half_bwd(z, ln2_g, ln2_b, w1, w1_s0, w1_s1, b1, w2, w2_s0,
                             w2_s1, b2, rs_ff, N, hid, mu2, rstd2, dout, da, af,
                             dh, u, dln, wpart, splits_w1, splits_w2, cpart, dz,
                             dg2, db2, dw1, dw1_s0, dw1_s1, db1f, dw2, dw2_s0,
                             dw2_s1, db2f, drs_ff, B, M, C, F, s));
  // the out projection → dacc
  VTX_CHECK(vtx::out_proj_bwd(acc, wout, wout_s0, wout_s1, bout, rs_attn, N, dz, da,
                              dacc, wpart, splits_out, cpart, dwout, dwout_s0,
                              dwout_s1, dbout, drs_attn, B, M, C, HD, s));
  // halo attention → dqkv, dbias
  attn_delta_kernel<<<ew_blocks((long long)B * nh * N), EW_THREADS, 0, s>>>(
      dacc, acc, delta, B, N, nh, D);
  VTX_CHECK(cudaGetLastError());
  VTX_CHECK(halo_attention_bwd(qkv, 3 * HD, qkv + HD, qkv + 2 * HD, 3 * HD, bias,
                               dacc, lse, delta, dkvw, part, chunks, dqkv, 3 * HD,
                               dqkv + HD, 3 * HD, dbias, B, g, nh, D, scale, s));
  // the qkv projection (no bias) and LN₁, with the residual dz
  return static_cast<int>(vtx::qkv_proj_bwd(
      x, ln1_g, ln1_b, mu1, rstd1, wqkv, wqkv_s0, wqkv_s1, dqkv, dz, u, dln, wpart,
      splits_qkv, cpart, dx, dg1, db1, dwqkv, dwqkv_s0, dwqkv_s1, nullptr, M, C, HD,
      s));
}

// q [M, HD], kv [M, 2HD] (k lanes, then v lanes), bias [heads, w², k²];
// out [M, HD]; lse may be null (no saves)
extern "C" int vtx_halo_attention_direct_fwd(
    const float* q, const float* kv, const float* bias, float* out, float* lse,
    int B, int H, int W, int nh, int D, int window, int halo, float scale,
    void* stream) {
  const int HD = nh * D;
  return static_cast<int>(halo_attention_fwd(
      q, HD, kv, kv + HD, 2 * HD, bias, out, lse, B, halo_geom(H, W, window, halo),
      nh, D, scale, static_cast<cudaStream_t>(stream)));
}

// out and lse: the training forward's; workspace delta [B·heads·H·W], dkvw
// [B·S·k²·2HD], part [chunks·heads·w²·k²]; dq [M, HD], dkv [M, 2HD], dbias
// [heads, w², k²]
extern "C" int vtx_halo_attention_direct_bwd(
    const float* q, const float* kv, const float* bias, const float* out,
    const float* lse, const float* dout, float* delta, float* dkvw, float* part,
    int chunks, float* dq, float* dkv, float* dbias, int B, int H, int W, int nh,
    int D, int window, int halo, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HD = nh * D, N = H * W;
  attn_delta_kernel<<<ew_blocks((long long)B * nh * N), EW_THREADS, 0, s>>>(
      dout, out, delta, B, N, nh, D);
  VTX_CHECK(cudaGetLastError());
  return static_cast<int>(halo_attention_bwd(
      q, HD, kv, kv + HD, 2 * HD, bias, dout, lse, delta, dkvw, part, chunks, dq, HD,
      dkv, 2 * HD, dbias, B, halo_geom(H, W, window, halo), nh, D, scale, s));
}
