// Flash attention for Hopper (sm_90a): forward with the per-row log-sum-exp,
// and the backward (dQ, dK, dV) recomputed from it.  Training and prefill
// attention over canonical positions (query i and key j sit at positions i
// and j).
//
// Replaces, in the JAX package:
//   flash_attention_fwd <- src/repro/kernels/flash_attention.py:96
//                          flash_attention_bhsd (pallas_call at :134) and its
//                          wrapper pallas_flash_attention (:157)
//   flash_attention_bwd <- the vjp of the jnp twin that
//                          src/repro/kernels/ops.py:74 uses as the custom_vjp
//                          backward (no Pallas kernel there)
//
// Layouts (row-major, contiguous):
//   q, o, dout, dq   (B, Sq, H, D), fp32 or bf16
//   k, v, dk, dv     (B, Sk, KV, D), same dtype
//   lse              (B, H, Sq) fp32: m + log(l) of each query row's softmax
// Masks: causal (key j <= query i), local (i - window < j <= i) and full.
//
// GQA without expanding K/V: the query heads that read kv head kh, which are
// h with (h·KV)/H == kh (G = H/KV of them when H % KV == 0, otherwise a
// ragged count), are folded into the rows of one (batch, kv head) problem,
// row = g·q_stride + position with q_stride = Sq rounded up to the tile, as
// the Pallas wrapper folds them.  A tile of rows never spans two heads, so a
// block knows the positions of its rows and walks only the key tiles they
// can see; a key tile every row of which is masked adds exactly 0 once the
// row has seen a live key, so skipping it leaves the result unchanged.
//
// What bounds it on this card: operations.  At the training shapes (S 1024,
// D 48, causal) a block does ~4·D multiply-adds per (row, key) against 2·D
// elements of K/V that it reads once per row tile, far above the ~20 flops
// per byte where fp32 CUDA-core arithmetic stops being the limit.  This
// first version keeps the arithmetic in fp32 on the CUDA cores: each of 256
// threads owns a 4×4 (or 2×2) patch of the score tile and TILE/16 rows of
// the output in registers, with Q/K/V tiles in shared memory.  Tensor-core
// products (wgmma on bf16 tiles), TMA loads and a softmax that overlaps the
// products are later work.
//
// The arithmetic is the jnp twin's (src/repro/kernels/ref.py:56): fp32
// q·scale, a -1e30 mask (not -inf), an fp32 online softmax (m, l, acc) and
// acc / max(l, 1e-30) cast to q's dtype.  The backward recomputes
// P = exp(s - lse), then with Di = rowsum(dO ∘ O):
//   dS = P ∘ (dO·Vᵀ - Di),  dQ = dS·K·scale,  dK = dSᵀ·Q·scale,  dV = Pᵀ·dO.
// It is one launch of two kinds of block: blocks over key tiles loop over
// every query row of their kv head and write dK/dV, blocks over row tiles
// loop over the keys and write dQ.  Every output element has one writer, so
// there are no atomics and the result is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 × 16 thread grid over a score tile
constexpr int kBatch = 8;      // global loads a thread issues before using any
constexpr float kNegInf = -1e30f;
constexpr int kCausal = 0, kLocal = 1, kFull = 2;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // forward output (read by the backward)
  const void* dout;  // gradient of o
  void* out;         // forward: o; backward: dq
  void* dk;
  void* dv;
  float* lse;
  int B, Sq, Sk, H, KV, D;
  int q_stride;  // Sq rounded up to the tile
  int mode, window;
  float scale;
};

// Rows [g, q0 .. q0 + TILE) of kv head kh: the query head they belong to.
__device__ __forceinline__ int head_lo(int kh, int H, int KV) {
  return (kh * H + KV - 1) / KV;
}

// Copy rows [0, nvalid) of a TILE-row tile (row r at src + r·stride, D
// contiguous elements) into shared memory with row stride DP, times mul, as
// fp32; rows past nvalid are zero.  A thread issues kBatch loads (from
// clamped addresses) before it converts any of them.
template <typename T, int TILE>
__device__ __forceinline__ void load_tile(float* dst, int DP, const T* __restrict__ src,
                                          long long stride, int nvalid, int D, float mul) {
  const int total = TILE * D;
  if (nvalid <= 0) {
    for (int i = threadIdx.x; i < total; i += kThreads) dst[(i / D) * DP + i % D] = 0.f;
    return;
  }
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
    T raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(i0 + u * kThreads, total - 1);
      const int r = min(i / D, nvalid - 1);
      raw[u] = src[r * stride + i % D];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        const int r = i / D;
        dst[r * DP + i % D] = r < nvalid ? to_f32(raw[u]) * mul : 0.f;
      }
    }
  }
}

__device__ __forceinline__ bool key_visible(int mode, int window, int qpos, int t, int Sq,
                                            int Sk) {
  if (qpos >= Sq || t >= Sk) return false;
  if (mode == kFull) return true;
  return t <= qpos && (mode != kLocal || t > qpos - window);
}

// Key range [lo, hi) the rows [q0, q1) can see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q1, int& lo,
                                          int& hi) {
  if (p.mode == kFull) {
    lo = 0;
    hi = p.Sk;
    return;
  }
  hi = min(p.Sk, q1);
  lo = p.mode == kLocal ? max(0, q0 - p.window + 1) : 0;
}

// s[i][j] = Σ_d a[row i][d] · b[col j][d] for this thread's rows ty + 16i
// and columns tx + 16j of the tile.
template <int TILE>
__device__ __forceinline__ void tile_dot(float (&s)[TILE / 16][TILE / 16], const float* a,
                                         const float* b, int DP, int D, int ty, int tx) {
  constexpr int N = TILE / 16;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[N], bv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) av[i] = a[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < N; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Reductions over the 16 threads that share a row (one half warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][c] += Σ_j A(ty + 16i, j) · Bm[j][tx + 16c] over j < TILE, where
// A(r, j) = a[r·ars + j·ajs] and Bm[j][d] = b[j·DP + d]: a sum of TILE
// rank-one updates of this thread's N × DC patch.  Per j a thread loads N
// values of A and DC of Bm for N·DC multiply-adds (columns d >= D read 0).
template <int TILE, int N, int DC>
__device__ __forceinline__ void rank1_updates(float (&acc)[N][DC], const float* a, int ars,
                                              int ajs, int ty, const float* b, int DP, int tx,
                                              int D) {
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
    float av[N], bv[DC];
#pragma unroll
    for (int i = 0; i < N; ++i) av[i] = a[(ty + 16 * i) * ars + j * ajs];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      bv[c] = d < D ? b[j * DP + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
  }
}

template <int TILE>
__host__ __device__ inline size_t fwd_smem(int D) {
  return sizeof(float) * (3 * (size_t)TILE * (D + 1) + (size_t)TILE * (TILE + 1));
}
template <int TILE>
__host__ __device__ inline size_t bwd_smem(int D) {
  return sizeof(float) *
         (4 * (size_t)TILE * (D + 1) + 2 * (size_t)TILE * (TILE + 1) + 2 * (size_t)TILE);
}

// ---------------------------------------------------------------------------
// Forward.  Grid (Gmax·q_stride/TILE, KV, B).
// ---------------------------------------------------------------------------

template <typename T, int TILE, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int N = TILE / 16;   // rows and key columns per thread
  constexpr int DC = DMAX / 16;  // output columns per thread
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int h_lo = head_lo(kh, p.H, p.KV);
  const int g = head_lo(kh + 1, p.H, p.KV) - h_lo;
  const int row0 = blockIdx.x * TILE;
  const int gi = row0 / p.q_stride;
  const int q0 = row0 % p.q_stride;
  if (gi >= g || q0 >= p.Sq) return;
  const int h = h_lo + gi;
  const int D = p.D, DP = D + 1;
  const int q1 = min(q0 + TILE, p.Sq);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + TILE * DP;
  float* v_s = k_s + TILE * DP;
  float* p_s = v_s + TILE * DP;  // [TILE][TILE + 1]

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const long long q_row = (long long)p.H * D, kv_row = (long long)p.KV * D;
  load_tile<T, TILE>(q_s, DP, q + (((long long)b * p.Sq + q0) * p.H + h) * D, q_row, q1 - q0,
                     D, p.scale);

  float m[N], l[N], acc[N][DC];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  int t_lo, t_hi;
  key_range(p, q0, q1, t_lo, t_hi);
  t_lo = (t_lo / TILE) * TILE;

  for (int t0 = t_lo; t0 < t_hi; t0 += TILE) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    const long long kv_off = (((long long)b * p.Sk + t0) * p.KV + kh) * D;
    load_tile<T, TILE>(k_s, DP, k + kv_off, kv_row, min(TILE, p.Sk - t0), D, 1.f);
    load_tile<T, TILE>(v_s, DP, v + kv_off, kv_row, min(TILE, p.Sk - t0), D, 1.f);
    __syncthreads();

    float s[N][N];
    tile_dot<TILE>(s, q_s, k_s, DP, D, ty, tx);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (!key_visible(p.mode, p.window, qpos, t0 + tx + 16 * j, p.Sq, p.Sk))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float pr = expf(s[i][j] - m_new);
        sum += pr;
        p_s[(ty + 16 * i) * (TILE + 1) + tx + 16 * j] = pr;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    // acc[row][d] += Σ_key P[row][key]·V[key][d]
    rank1_updates<TILE, N, DC>(acc, p_s, TILE + 1, 1, ty, v_s, DP, tx, D);
  }

  T* o = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f32<T>(acc[i][c] * inv);
    }
    if (tx == 0) p.lse[((long long)b * p.H + h) * p.Sq + qpos] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// Backward.  Grid (NK + Gmax·q_stride/TILE, KV, B): blockIdx.x < NK are key
// tiles (dK, dV), the rest row tiles (dQ).
// ---------------------------------------------------------------------------

// Di = Σ_d dO[r][d]·O[r][d] for the rows [q0, q1) of head h into dd_s, and
// their lse into lse_s (padding rows get 0 and are masked anyway).
template <typename T, int TILE>
__device__ __forceinline__ void row_stats(const Params& p, int b, int h, int q0, int q1,
                                          float* dd_s, float* lse_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);
  for (int r = warp; r < TILE; r += kThreads / 32) {
    const int qpos = q0 + r;
    float s = 0.f;
    if (qpos < q1) {
      const long long off = (((long long)b * p.Sq + qpos) * p.H + h) * p.D;
      for (int d = lane; d < p.D; d += 32) s += to_f32(dout[off + d]) * to_f32(o[off + d]);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
    if (lane == 0) {
      dd_s[r] = s;
      lse_s[r] = qpos < q1 ? p.lse[((long long)b * p.H + h) * p.Sq + qpos] : 0.f;
    }
  }
}

// P and dS of one (row tile, key tile) pair, this thread's patch: rows
// q0 + ty + 16i, keys t0 + tx + 16j.
template <int TILE>
__device__ __forceinline__ void probs_and_dscores(const Params& p, const float* q_s,
                                                  const float* k_s, const float* v_s,
                                                  const float* do_s, const float* lse_s,
                                                  const float* dd_s, int q0, int t0, int ty,
                                                  int tx, float (&pr)[TILE / 16][TILE / 16],
                                                  float (&ds)[TILE / 16][TILE / 16]) {
  constexpr int N = TILE / 16;
  const int DP = p.D + 1;
  tile_dot<TILE>(pr, q_s, k_s, DP, p.D, ty, tx);
  tile_dot<TILE>(ds, do_s, v_s, DP, p.D, ty, tx);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool live = key_visible(p.mode, p.window, q0 + r, t0 + tx + 16 * j, p.Sq, p.Sk);
      pr[i][j] = live ? expf(pr[i][j] - lse_s[r]) : 0.f;
      ds[i][j] = pr[i][j] * (ds[i][j] - dd_s[r]);
    }
  }
}

template <typename T, int TILE, int DMAX>
__device__ __forceinline__ void dkdv_block(const Params& p, int kt, int kh, int b,
                                           float* smem) {
  constexpr int N = TILE / 16;
  constexpr int DC = DMAX / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DP = D + 1;
  const int t0 = kt * TILE;
  const int t1 = min(t0 + TILE, p.Sk);
  const int h_lo = head_lo(kh, p.H, p.KV);
  const int g = head_lo(kh + 1, p.H, p.KV) - h_lo;

  float* k_s = smem;
  float* v_s = k_s + TILE * DP;
  float* q_s = v_s + TILE * DP;
  float* do_s = q_s + TILE * DP;
  float* p_s = do_s + TILE * DP;       // [TILE rows][TILE + 1]
  float* ds_s = p_s + TILE * (TILE + 1);
  float* lse_s = ds_s + TILE * (TILE + 1);
  float* dd_s = lse_s + TILE;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const long long q_row = (long long)p.H * D, kv_row = (long long)p.KV * D;
  const long long kv_off = (((long long)b * p.Sk + t0) * p.KV + kh) * D;
  load_tile<T, TILE>(k_s, DP, k + kv_off, kv_row, t1 - t0, D, 1.f);
  load_tile<T, TILE>(v_s, DP, v + kv_off, kv_row, t1 - t0, D, 1.f);

  float dk[N][DC], dv[N][DC];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // Row tiles (within one head) that can see a key of [t0, t1).
  const int nq = (p.Sq + TILE - 1) / TILE;
  int qt_lo = 0, qt_hi = nq;
  if (p.mode != kFull) {
    qt_lo = t0 / TILE;
    if (p.mode == kLocal) qt_hi = min(nq, (t1 + p.window - 2) / TILE + 1);
  }
  for (int gi = 0; gi < g; ++gi) {
    const int h = h_lo + gi;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * TILE, q1 = min(q0 + TILE, p.Sq);
      __syncthreads();  // the previous pair's q_s, do_s, p_s, ds_s are consumed
      const long long q_off = (((long long)b * p.Sq + q0) * p.H + h) * D;
      load_tile<T, TILE>(q_s, DP, q + q_off, q_row, q1 - q0, D, p.scale);
      load_tile<T, TILE>(do_s, DP, dout + q_off, q_row, q1 - q0, D, 1.f);
      row_stats<T, TILE>(p, b, h, q0, q1, dd_s, lse_s);
      __syncthreads();

      float pr[N][N], ds[N][N];
      probs_and_dscores<TILE>(p, q_s, k_s, v_s, do_s, lse_s, dd_s, q0, t0, ty, tx, pr, ds);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          p_s[(ty + 16 * i) * (TILE + 1) + tx + 16 * j] = pr[i][j];
          ds_s[(ty + 16 * i) * (TILE + 1) + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV[key][d] += Σ_r P[r][key]·dO[r][d];  dK[key][d] += Σ_r dS[r][key]·q[r][d]
      // (q_s holds q·scale, so dK needs no further scaling).
      rank1_updates<TILE, N, DC>(dv, p_s, 1, TILE + 1, ty, do_s, DP, tx, D);
      rank1_updates<TILE, N, DC>(dk, ds_s, 1, TILE + 1, ty, q_s, DP, tx, D);
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= p.Sk) continue;
    const long long off = (((long long)b * p.Sk + t) * p.KV + kh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk_out[off + d] = from_f32<T>(dk[i][c]);
        dv_out[off + d] = from_f32<T>(dv[i][c]);
      }
    }
  }
}

template <typename T, int TILE, int DMAX>
__device__ __forceinline__ void dq_block(const Params& p, int row_tile, int kh, int b,
                                         float* smem) {
  constexpr int N = TILE / 16;
  constexpr int DC = DMAX / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = p.D, DP = D + 1;
  const int h_lo = head_lo(kh, p.H, p.KV);
  const int g = head_lo(kh + 1, p.H, p.KV) - h_lo;
  const int row0 = row_tile * TILE;
  const int gi = row0 / p.q_stride;
  const int q0 = row0 % p.q_stride;
  if (gi >= g || q0 >= p.Sq) return;
  const int h = h_lo + gi;
  const int q1 = min(q0 + TILE, p.Sq);

  float* q_s = smem;
  float* do_s = q_s + TILE * DP;
  float* k_s = do_s + TILE * DP;
  float* v_s = k_s + TILE * DP;
  float* ds_s = v_s + TILE * DP;  // [TILE][TILE + 1]
  float* lse_s = ds_s + 2 * TILE * (TILE + 1);
  float* dd_s = lse_s + TILE;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const long long q_row = (long long)p.H * D, kv_row = (long long)p.KV * D;
  const long long q_off = (((long long)b * p.Sq + q0) * p.H + h) * D;
  load_tile<T, TILE>(q_s, DP, q + q_off, q_row, q1 - q0, D, p.scale);
  load_tile<T, TILE>(do_s, DP, dout + q_off, q_row, q1 - q0, D, 1.f);
  row_stats<T, TILE>(p, b, h, q0, q1, dd_s, lse_s);

  float dq[N][DC];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  int t_lo, t_hi;
  key_range(p, q0, q1, t_lo, t_hi);
  t_lo = (t_lo / TILE) * TILE;
  for (int t0 = t_lo; t0 < t_hi; t0 += TILE) {
    __syncthreads();
    const long long kv_off = (((long long)b * p.Sk + t0) * p.KV + kh) * D;
    load_tile<T, TILE>(k_s, DP, k + kv_off, kv_row, min(TILE, p.Sk - t0), D, 1.f);
    load_tile<T, TILE>(v_s, DP, v + kv_off, kv_row, min(TILE, p.Sk - t0), D, 1.f);
    __syncthreads();
    float pr[N][N], ds[N][N];
    probs_and_dscores<TILE>(p, q_s, k_s, v_s, do_s, lse_s, dd_s, q0, t0, ty, tx, pr, ds);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) ds_s[(ty + 16 * i) * (TILE + 1) + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[r][d] += Σ_key dS[r][key]·K[key][d]
    rank1_updates<TILE, N, DC>(dq, ds_s, TILE + 1, 1, ty, k_s, DP, tx, D);
  }

  T* dq_out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= p.Sq) continue;
    T* row = dq_out + (((long long)b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) row[d] = from_f32<T>(dq[i][c] * p.scale);
    }
  }
}

template <typename T, int TILE, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(Params p, int n_key_tiles) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < n_key_tiles)
    dkdv_block<T, TILE, DMAX>(p, blockIdx.x, blockIdx.y, blockIdx.z, smem);
  else
    dq_block<T, TILE, DMAX>(p, blockIdx.x - n_key_tiles, blockIdx.y, blockIdx.z, smem);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int TILE, int DMAX>
int launch(Params p, bool backward, cudaStream_t stream) {
  p.q_stride = (p.Sq + TILE - 1) / TILE * TILE;
  const int gmax = (p.H + p.KV - 1) / p.KV;
  const int row_tiles = gmax * p.q_stride / TILE;
  if (!backward) {
    const size_t smem = fwd_smem<TILE>(p.D);
    int err = set_smem(flash_fwd_kernel<T, TILE, DMAX>, smem);
    if (err) return err;
    flash_fwd_kernel<T, TILE, DMAX><<<dim3(row_tiles, p.KV, p.B), kThreads, smem, stream>>>(p);
  } else {
    const int key_tiles = (p.Sk + TILE - 1) / TILE;
    const size_t smem = bwd_smem<TILE>(p.D);
    int err = set_smem(flash_bwd_kernel<T, TILE, DMAX>, smem);
    if (err) return err;
    flash_bwd_kernel<T, TILE, DMAX>
        <<<dim3(key_tiles + row_tiles, p.KV, p.B), kThreads, smem, stream>>>(p, key_tiles);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_for_dim(const Params& p, bool backward, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64, 64>(p, backward, stream);
  if (p.D <= 128) return launch<T, 64, 128>(p, backward, stream);
  return launch<T, 32, 256>(p, backward, stream);
}

// dtype: 0 = fp32, 1 = bf16.  Returns a cudaError_t (0 on success), or -1
// for arguments the kernels do not take.
int run(int dtype, Params p, bool backward, cudaStream_t stream) {
  if (p.D < 1 || p.D > 256 || p.H < 1 || p.KV < 1 || p.KV > p.H || p.B < 0 || p.Sq < 0 ||
      p.Sk < 0 || p.mode < kCausal || p.mode > kFull || (p.mode == kLocal && p.window < 1))
    return -1;
  if (p.B == 0 || p.Sq == 0) return 0;
  if (dtype == 0) return launch_for_dim<float>(p, backward, stream);
  if (dtype == 1) return launch_for_dim<__nv_bfloat16>(p, backward, stream);
  return -1;
}

}  // namespace

extern "C" {

// o (B, Sq, H, D) and lse (B, H, Sq) from q (B, Sq, H, D), k/v (B, Sk, KV, D).
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int KV, int D, int mode,
                        int window, float scale, void* stream) {
  Params p{q, k, v, nullptr, nullptr, o, nullptr, nullptr, lse, B, Sq, Sk, H, KV, D, 0,
           mode, window, scale};
  return run(dtype, p, false, static_cast<cudaStream_t>(stream));
}

// dq, dk, dv from the forward's inputs, its output o and lse, and dout.
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int H, int KV, int D, int mode,
                        int window, float scale, void* stream) {
  Params p{q, k, v, o, dout, dq, dk, dv, const_cast<float*>(lse), B, Sq, Sk, H, KV, D, 0,
           mode, window, scale};
  return run(dtype, p, true, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
