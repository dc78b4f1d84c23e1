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
// Two sets of kernels, chosen in run() below by type and head dim:
//   bf16 with D % 8 == 0 (every head dim of the repo's configs: 48, 64, 128,
//   256) -> the tensor-core kernels (namespace tc);
//   fp32, and bf16 with D % 8 != 0 -> the CUDA-core kernels.
// fp32 stays off the tensor cores so that fp32 training keeps fp32
// products (TF32 would break its card-against-CPU parity).
//
// The arithmetic is the jnp twin's (src/repro/kernels/ref.py:56): fp32
// scores times scale, a -1e30 mask (not -inf), an fp32 online softmax
// (m, l, acc) and acc / max(l, 1e-30) cast to q's dtype; lse = m + log(l).
// The backward recomputes P = exp(s - lse), then with Di = rowsum(dO ∘ O):
//   dS = P ∘ (dO·Vᵀ - Di),  dQ = dS·K·scale,  dK = dSᵀ·Q·scale,  dV = Pᵀ·dO.
// Every output element has one writer, so there are no atomics and the
// result is the same from run to run.
//
// CUDA-core kernels.  fp32 arithmetic: each of 256 threads owns a 4×4 (or
// 2×2) patch of the score tile and TILE/16 rows of the output in registers,
// with Q/K/V tiles in shared memory as fp32.  The backward is one launch of
// two kinds of block: blocks over key tiles loop over every query row of
// their kv head and write dK/dV, blocks over row tiles loop over the keys
// and write dQ.
//
// Tensor-core kernels (sm_90a).  What bounds them on this card: at the
// paper model's training shape (S 1024, D 48, causal) three floors lie
// within 25% of each other (chip_smoke.py's flash_bound): the forward's
// exponentials (one exp2 per visible pair at the special-function units' 16
// per clock per SM) above its bytes and its bf16 tensor work; the backward's
// tensor work (10·D flops per pair) level with its exponentials (two per
// pair) and its bytes.  So no unit may idle while another works: the
// design keeps every product on wgmma (bf16 operands in
// shared memory, fp32 accumulators in registers), the softmax in registers
// (P rounded to bf16 there is the A operand of the next product, as SDPA's
// flash backend rounds it), and the copies asynchronous (cp.async into a
// ring of stages, the next tile in flight while this one is used).  The
// forward issues tile j's Q·Kᵀ together with tile j-1's P·V so that tile
// j's softmax can run while P·V is on the tensor cores (ptxas serializes
// them as the code stands: see the forward kernel).  The backward computes Di
// once per row in a pre-pass, then runs dK/dV blocks with the keys as M
// (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ come out of the registers as the A
// operands of dV += Pᵀ·dO and dK += dSᵀ·Q), then dQ blocks that recompute S
// and dP (14·D flops per pair instead of 10·D: the price of one writer per
// dQ element without a per-key-tile scratch).
//
// Head dims: shared-memory tiles are padded to DP, a multiple of 64 (one
// 128-byte swizzle atom of bf16), and the pad columns are zero (a copy of 0
// source bytes fills them).  Products that reduce over D take ceil(D/16)
// k16 steps, so the pad costs nothing there; products whose N is D (P·V,
// dV, dK, dQ) run over DP, a third more tensor work at D 48.  The 32-byte
// swizzle with three k-slices would avoid that, but needs a second layout
// for the MN-major operands; the exponentials, not these products, set the
// forward's floor at D 48.  Copies are 16 bytes wide, hence D % 8 == 0.
//
// cp.async rather than TMA: it needs no tensor map (cuTensorMapEncodeTiled
// lives in libcuda, which the build does not link),
// zero-fills ragged rows and pad columns by itself, and writes the swizzled
// layout directly.  TMA with a producer warp is where a faster version
// starts (PERF.md).

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
  float* di;  // backward, tensor-core path: (B, H, Sq) fp32 scratch for rowsum(dO ∘ O)
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

// ===========================================================================
// Tensor-core path: bf16 with D % 8 == 0
// ===========================================================================

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWG = 128;  // threads of one warpgroup
constexpr int kT = 64;    // rows and keys per tile of the backward
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// --- shared-memory tiles ----------------------------------------------------
// A tile of R rows × DP columns (DP a multiple of 64) is DP/64 atoms of R rows
// × 128 bytes, each atom on a 1024-byte boundary; the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8) of its row (the 128-byte swizzle).  One tile
// serves wgmma as a K-major operand (rows are M or N, columns the reduction;
// a k16 slice starts 32 bytes further along the row) and as an MN-major one
// (rows are the reduction; a k16 slice starts 16 rows = 2048 bytes further).

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// After this thread's copies have landed: make them visible to wgmma (the
// async proxy) and then to every thread of the block.
__device__ __forceinline__ void tiles_ready() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Rows [0, nvalid) of an R-row tile (row r at src + r·stride, D elements,
// 16-byte aligned) copied asynchronously into the tile at dst by NT threads;
// rows past nvalid and columns past D are filled with zeros (a copy of 0
// source bytes), so the pad columns add nothing to a product over D.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long stride,
                                          int nvalid, int D) {
  constexpr int CPR = DP / 8;  // chunks per row
#pragma unroll 4
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < nvalid && c * 8 < D;
    const uint32_t off = (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
    cp_async16(dst + off, ok ? src + r * stride + c * 8 : src, ok);
  }
}

// 64 floats src[0, nvalid) into dst, zeros past nvalid (threads 0..63).
__device__ __forceinline__ void load_stats(uint32_t dst, const float* src, int nvalid) {
  const int i = threadIdx.x;
  if (i < kT) cp_async4(dst + 4 * i, i < nvalid ? src + i : src, i < nvalid);
}

// --- wgmma --------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand starting at addr.  Both byte
// offsets are 1024 (the next group of 8 rows): no instruction here reaches
// past one 64-column atom along a strided dimension, so the one form serves
// K-major and MN-major operands alike.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define FA_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32 FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)

// d (64 × N, fp32) = A·Bᵀ (+ d when acc): A (64 × 16) and B (N × 16), bf16,
// both K-major in shared memory.  Thread t of the warpgroup holds d[i] at
// row 16·(t/32) + (t%32)/4 + 8·((i/2)%2), column 8·(i/4) + 2·(t%4) + i%2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


#undef FA_D8
#undef FA_D32

// 2^x in one special-function op; results below 2^-126 flush to 0, far below
// what a row sum of at least 1 can resolve.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Every row of [q0, q1) sees every key of [t0, t0 + n): the tile needs no mask.
__device__ __forceinline__ bool all_visible(const Params& p, int q0, int q1, int t0, int n) {
  if (q1 > p.Sq || t0 + n > p.Sk) return false;
  if (p.mode == kFull) return true;
  return t0 + n - 1 <= q0 && (p.mode != kLocal || t0 > q1 - 1 - p.window);
}

// ---------------------------------------------------------------------------
// Forward.  Block: NWG warpgroups, 64 rows each, over BM = 64·NWG rows of one
// query head (rows never span heads); grid (Gmax·⌈Sq/BM⌉, KV, B), the row
// tiles with the most keys first.  Q is loaded once; K and V tiles of BN keys
// go through a ring of three stages, the copy of tile j + 1 in flight while
// tile j is used.  S = Q·Kᵀ runs on wgmma with fp32 accumulators in
// registers; the online softmax (exp2 of scores times scale·log2e, a mask
// only on tiles that need one) stays in registers, and P, rounded to bf16
// there, is the A operand of O += P·V (wgmma, V MN-major).  The products of
// tile j, Q·K_jᵀ and P_{j-1}·V_{j-1}, are issued together, so that the
// softmax of tile j can run while P_{j-1}·V_{j-1} is on the tensor cores.
// ptxas still serializes them (C7513, "non wgmma instructions defining input
// registers ... between start and end of the pipeline stage"), so the
// overlap is not realized yet (PERF.md).  Tiles: 64 keys; 2 warpgroups at
// D <= 64, the fastest of 1 or 2 warpgroups and 64 or 128 keys at the paper
// model's shape, and 1 above, where O's accumulators take the registers.
// ---------------------------------------------------------------------------

template <int NWG, int DP, int KS>
__global__ void __launch_bounds__(NWG * kWG) flash_fwd_tc_kernel(Params p) {
  constexpr int BN = 64, BM = 64 * NWG, NT = NWG * kWG, KT = BN * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + BM * DP * 2;  // stage s: K at kv_s + 2·KT·s, V at + KT

  const int gmax = (p.H + p.KV - 1) / p.KV;
  const int n_rt = (p.Sq + BM - 1) / BM;
  const int gi = blockIdx.x % gmax;
  const int rt = n_rt - 1 - (int)blockIdx.x / gmax;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int h_lo = head_lo(kh, p.H, p.KV);
  if (gi >= head_lo(kh + 1, p.H, p.KV) - h_lo) return;
  const int h = h_lo + gi, D = p.D;
  const int q0 = rt * BM, q1 = min(q0 + BM, p.Sq);
  int t_lo, t_hi;
  key_range(p, q0, q1, t_lo, t_hi);
  t_lo = t_lo / BN * BN;
  const int n_kt = t_hi > t_lo ? (t_hi - t_lo + BN - 1) / BN : 0;

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const long long q_row = (long long)p.H * D, kv_row = (long long)p.KV * D;
  auto stage = [&](int it) { return kv_s + (it % 3) * 2 * KT; };
  auto load_kv = [&](int it) {
    const int t0 = t_lo + it * BN;
    const long long off = (((long long)b * p.Sk + t0) * p.KV + kh) * D;
    load_tile<BN, DP, NT>(stage(it), k + off, kv_row, min(BN, p.Sk - t0), D);
    load_tile<BN, DP, NT>(stage(it) + KT, v + off, kv_row, min(BN, p.Sk - t0), D);
  };
  load_tile<BM, DP, NT>(q_s, q + (((long long)b * p.Sq + q0) * p.H + h) * D, q_row, q1 - q0, D);
  if (n_kt > 0) load_kv(0);
  cp_async_commit();
  if (n_kt > 1) {
    load_kv(1);
    cp_async_commit();
  }

  const int wg = threadIdx.x / kWG, warp = (threadIdx.x % kWG) / 32, lane = threadIdx.x % 32;
  const int rl = 64 * wg + 16 * warp + lane / 4;  // tile row of d[i], i % 4 < 2 (rl + 8 else)
  const int cq = 2 * (lane % 4);                  // column of d[0] in its 8-column block
  const float c = p.scale * kLog2e;
  const uint32_t q_wg = q_s + wg * 64 * 128;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DP / 64][32];
#pragma unroll
  for (int a = 0; a < DP / 64; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;

  // S = Q·K_itᵀ, issued and committed (not waited for).
  auto issue_qk = [&](float (&s)[BN / 2], int it) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss(s, sdesc(q_wg + (ks / 4) * (BM * 128) + (ks % 4) * 32),
               sdesc(stage(it) + (ks / 4) * (BN * 128) + (ks % 4) * 32), ks > 0);
    wgmma_commit();
  };
  // O += P·V_it, issued and committed.
  auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], int it) {
#pragma unroll
    for (int a = 0; a < DP / 64; ++a)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_n64_tb(o[a], pa[kk], sdesc(stage(it) + KT + a * (BN * 128) + kk * 2048), 1);
    wgmma_commit();
  };
  // The online softmax of tile it's scores: updates m and l, returns the
  // rescale of O in corr and P as bf16 A fragments in pa.  Scores are scaled
  // before the maximum, so a masked score (exactly -1e30) less a maximum of
  // -1e30 is exactly 0, as in the plain version: a row that sees no key of
  // the tile adds finite terms that its first live key wipes out, and a row
  // that sees no key at all averages V as the plain version does.
  auto softmax = [&](float (&s)[BN / 2], int it, uint32_t (&pa)[BN / 16][4], float (&corr)[2]) {
    const int t0 = t_lo + it * BN;
    const bool full = all_visible(p, q0, q0 + BM, t0, BN);
    float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] *= c;
      if (!full && !key_visible(p.mode, p.window, q0 + rl + 8 * ((i / 2) % 2),
                                t0 + (i / 4) * 8 + cq + i % 2, p.Sq, p.Sk))
        s[i] = kNegInf;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      s[i] = exp2_approx(s[i] - m[(i / 2) % 2]);
      sum[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) pa[kk][u] = pack_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
  };

  uint32_t pa[BN / 16][4];
  if (n_kt > 0) {
    if (n_kt > 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    tiles_ready();
    float s[BN / 2], corr[2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    issue_qk(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, 0, pa, corr);  // O is still 0: no rescale
  }
  for (int it = 1; it < n_kt; ++it) {
    if (it + 1 < n_kt) {
      load_kv(it + 1);  // into the stage of tile it - 2, free since the last barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    tiles_ready();
    float s[BN / 2], corr[2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    fence_regs(s);
#pragma unroll
    for (int a = 0; a < DP / 64; ++a) fence_regs(o[a]);
    wgmma_fence();
    issue_qk(s, it);
    issue_pv(pa, it - 1);
    wgmma_wait<1>();  // S of tile it is in; P_{it-1}·V_{it-1} may still run
    fence_regs(s);
    uint32_t pn[BN / 16][4];
    softmax(s, it, pn, corr);
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < DP / 64; ++a) fence_regs(o[a]);
#pragma unroll
    for (int a = 0; a < DP / 64; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] *= corr[(i / 2) % 2];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) pa[kk][u] = pn[kk][u];
    __syncthreads();  // the stage of tile it - 1 is free for the copy of tile it + 2
  }
  if (n_kt > 0) {
#pragma unroll
    for (int a = 0; a < DP / 64; ++a) fence_regs(o[a]);
    wgmma_fence();
    issue_pv(pa, n_kt - 1);
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < DP / 64; ++a) fence_regs(o[a]);
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = q0 + rl + 8 * r;
    if (qpos >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
    bf16* orow = out + (((long long)b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int a = 0; a < DP / 64; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = a * 64 + j * 8 + cq;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[a][4 * j + 2 * r] * inv, o[a][4 * j + 2 * r + 1] * inv);
      }
    if (lane % 4 == 0) p.lse[((long long)b * p.H + h) * p.Sq + qpos] = m[r] * kLn2 + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// Backward.  Three launches in one call: the Di pre-pass, the dK/dV blocks,
// the dQ blocks.  All products on tensor cores; P and dS in registers.
// ---------------------------------------------------------------------------

// Di = Σ_d dO·O in fp32 for every row, once.  A block takes 256 rows, which
// are contiguous in memory: its threads first read them as one flat run of
// 16-byte pieces (each piece's 8 products into shared memory), then each
// thread sums its row's pieces in order.
__global__ void __launch_bounds__(256) flash_bwd_prepass_kernel(Params p) {
  __shared__ float part[256 * 32];  // D / 8 <= 32 pieces per row
  const int cpr = p.D / 8;
  const long long rows = (long long)p.B * p.Sq * p.H;
  const long long row0 = (long long)blockIdx.x * 256;
  const int n = (int)min(256LL, rows - row0) * cpr;
  const uint4* o = reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.o) + row0 * p.D);
  const uint4* d = reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.dout) + row0 * p.D);
  for (int f = threadIdx.x; f < n; f += 256) {
    const uint4 ov = __ldg(o + f), dv = __ldg(d + f);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 x = __bfloat1622float2(o2[u]), y = __bfloat1622float2(d2[u]);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
    part[f] = s;
  }
  __syncthreads();
  const long long row = row0 + threadIdx.x;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = 0; c < cpr; ++c) s += part[threadIdx.x * cpr + c];
  const int h = (int)(row % p.H);
  const long long bs = row / p.H;
  p.di[((bs / p.Sq) * p.H + h) * p.Sq + bs % p.Sq] = s;
}

// dK, dV of 64 keys of one kv head: grid (⌈Sk/64⌉, KV, B), one warpgroup.  K
// and V stay in shared memory; the 64-row tiles of Q, dO, lse and Di of every
// row that can see the keys (all query heads of the kv head) stream through a
// ring of two stages.  The products run with the keys as M: Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ, then Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e) and
// dSᵀ = Pᵀ∘(dPᵀ − Di) in registers become, rounded to bf16, the A operands of
// dV += Pᵀ·dO and dK += dSᵀ·Q (dO and Q MN-major).  Each pass accumulates 64
// columns of dK and dV (DP/64 passes, Sᵀ and dPᵀ recomputed in each), which
// keeps the accumulators in registers at every head dim.
template <int DP, int KS>
__global__ void __launch_bounds__(kWG) flash_bwd_dkdv_tc_kernel(Params p) {
  constexpr int TB = kT * DP * 2;  // bytes of a 64-row tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u, v_s = k_s + TB;
  const uint32_t ring = v_s + TB;       // stage s: Q at ring + 2·TB·s, dO at + TB
  const uint32_t stats = ring + 4 * TB;  // stage s: lse at stats + 512·s, Di at + 256
  const float* stats_f = reinterpret_cast<const float*>(smem_raw + (stats - raw));

  const int kh = blockIdx.y, b = blockIdx.z, D = p.D;
  const int t0 = blockIdx.x * kT, t1 = min(t0 + kT, p.Sk);
  const int h_lo = head_lo(kh, p.H, p.KV), g = head_lo(kh + 1, p.H, p.KV) - h_lo;
  const int nq = (p.Sq + kT - 1) / kT;
  int qt_lo = 0, qt_hi = nq;
  if (p.mode != kFull) {
    qt_lo = t0 / kT;
    if (p.mode == kLocal) qt_hi = min(nq, (t1 + p.window - 2) / kT + 1);
  }
  const int per_head = max(0, qt_hi - qt_lo), total = g * per_head;

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const long long q_row = (long long)p.H * D, kv_row = (long long)p.KV * D;
  const long long kv_off = (((long long)b * p.Sk + t0) * p.KV + kh) * D;
  load_tile<kT, DP, kWG>(k_s, k + kv_off, kv_row, t1 - t0, D);
  load_tile<kT, DP, kWG>(v_s, v + kv_off, kv_row, t1 - t0, D);
  auto load_rows = [&](int n) {
    const int h = h_lo + n / per_head, q0 = (qt_lo + n % per_head) * kT;
    const int nvalid = min(kT, p.Sq - q0);
    const long long off = (((long long)b * p.Sq + q0) * p.H + h) * D;
    const uint32_t st = ring + (n & 1) * 2 * TB;
    load_tile<kT, DP, kWG>(st, q + off, q_row, nvalid, D);
    load_tile<kT, DP, kWG>(st + TB, dout + off, q_row, nvalid, D);
    const long long soff = ((long long)b * p.H + h) * p.Sq + q0;
    load_stats(stats + (n & 1) * 512, p.lse + soff, nvalid);
    load_stats(stats + (n & 1) * 512 + 256, p.di + soff, nvalid);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = 16 * warp + lane / 4;  // tile key of d[i], i % 4 < 2 (kl + 8 else)
  const int cq = 2 * (lane % 4);
  const float c = p.scale * kLog2e;
  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);

  for (int pass = 0; pass < DP / 64; ++pass) {
    float dv[32], dk[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[i] = dk[i] = 0.f;
    if (total > 0) load_rows(0);
    cp_async_commit();
    for (int n = 0; n < total; ++n) {
      if (n + 1 < total) {
        load_rows(n + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      tiles_ready();
      const int q0 = (qt_lo + n % per_head) * kT;
      const uint32_t q_st = ring + (n & 1) * 2 * TB, do_st = q_st + TB;
      const float* lse_s = stats_f + (n & 1) * 128;
      const float* di_s = lse_s + 64;

      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t off = (ks / 4) * (kT * 128) + (ks % 4) * 32;
        wgmma_ss(s, sdesc(k_s + off), sdesc(q_st + off), ks > 0);
        wgmma_ss(dp, sdesc(v_s + off), sdesc(do_st + off), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const bool full = all_visible(p, q0, q0 + kT, t0, kT);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i / 4) * 8 + cq + i % 2;  // tile row (the column of Sᵀ)
        float pt = exp2_approx(fmaf(s[i], c, -lse_s[row] * kLog2e));
        if (!full && !key_visible(p.mode, p.window, q0 + row, t0 + kl + 8 * ((i / 2) % 2), p.Sq,
                                  p.Sk))
          pt = 0.f;
        s[i] = pt;
        dp[i] = pt * (dp[i] - di_s[row]);
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          pa[kk][u] = pack_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
          da[kk][u] = pack_bf16(dp[8 * kk + 2 * u], dp[8 * kk + 2 * u + 1]);
        }
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = pass * (kT * 128) + kk * 2048;
        wgmma_rs_n64_tb(dv, pa[kk], sdesc(do_st + off), 1);
        wgmma_rs_n64_tb(dk, da[kk], sdesc(q_st + off), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      __syncthreads();  // this stage is free for the copy two tiles on
    }
    cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + kl + 8 * r;
      if (t >= p.Sk) continue;
      const long long off = (((long long)b * p.Sk + t) * p.KV + kh) * D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pass * 64 + j * 8 + cq;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(dv_out + off + col) =
              __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dk_out + off + col) = __floats2bfloat162_rn(
              dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

// dQ of 64 rows of one query head: grid (Gmax·⌈Sq/64⌉, KV, B), one
// warpgroup, the rows with the most keys first.  Q and dO stay in shared
// memory; K and V tiles of 64 keys go through a ring of two stages.  Per
// tile: S = Q·Kᵀ and dP = dO·Vᵀ, P and dS = P∘(dP − Di) in registers, dS
// rounded to bf16 as the A operand of dQ += dS·K (K MN-major).  Each pass
// accumulates DO columns of dQ (one pass up to D 128, two at D 256).
template <int DP, int DO, int KS>
__global__ void __launch_bounds__(kWG) flash_bwd_dq_tc_kernel(Params p) {
  constexpr int TB = kT * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u, do_s = q_s + TB;
  const uint32_t ring = do_s + TB;  // stage s: K at ring + 2·TB·s, V at + TB

  const int gmax = (p.H + p.KV - 1) / p.KV;
  const int n_rt = (p.Sq + kT - 1) / kT;
  const int gi = blockIdx.x % gmax;
  const int rt = n_rt - 1 - (int)blockIdx.x / gmax;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int h_lo = head_lo(kh, p.H, p.KV);
  if (gi >= head_lo(kh + 1, p.H, p.KV) - h_lo) return;
  const int h = h_lo + gi, D = p.D;
  const int q0 = rt * kT, q1 = min(q0 + kT, p.Sq);
  int t_lo, t_hi;
  key_range(p, q0, q1, t_lo, t_hi);
  t_lo = t_lo / kT * kT;
  const int n_kt = t_hi > t_lo ? (t_hi - t_lo + kT - 1) / kT : 0;

  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const long long q_row = (long long)p.H * D, kv_row = (long long)p.KV * D;
  const long long q_off = (((long long)b * p.Sq + q0) * p.H + h) * D;
  load_tile<kT, DP, kWG>(q_s, static_cast<const bf16*>(p.q) + q_off, q_row, q1 - q0, D);
  load_tile<kT, DP, kWG>(do_s, static_cast<const bf16*>(p.dout) + q_off, q_row, q1 - q0, D);
  auto load_kv = [&](int it) {
    const int t0 = t_lo + it * kT;
    const long long off = (((long long)b * p.Sk + t0) * p.KV + kh) * D;
    const uint32_t st = ring + (it & 1) * 2 * TB;
    load_tile<kT, DP, kWG>(st, k + off, kv_row, min(kT, p.Sk - t0), D);
    load_tile<kT, DP, kWG>(st + TB, v + off, kv_row, min(kT, p.Sk - t0), D);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float c = p.scale * kLog2e;
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + rl + 8 * r;
    const long long idx = ((long long)b * p.H + h) * p.Sq + qpos;
    lse2[r] = qpos < p.Sq ? p.lse[idx] * kLog2e : 0.f;
    di[r] = qpos < p.Sq ? p.di[idx] : 0.f;
  }
  bf16* dq_out = static_cast<bf16*>(p.out);

  for (int pass = 0; pass < DP / DO; ++pass) {
    float dq[DO / 64][32];
#pragma unroll
    for (int a = 0; a < DO / 64; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[a][i] = 0.f;
    if (n_kt > 0) load_kv(0);
    cp_async_commit();
    for (int it = 0; it < n_kt; ++it) {
      if (it + 1 < n_kt) {
        load_kv(it + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      tiles_ready();
      const int t0 = t_lo + it * kT;
      const uint32_t k_st = ring + (it & 1) * 2 * TB, v_st = k_st + TB;

      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t off = (ks / 4) * (kT * 128) + (ks % 4) * 32;
        wgmma_ss(s, sdesc(q_s + off), sdesc(k_st + off), ks > 0);
        wgmma_ss(dp, sdesc(do_s + off), sdesc(v_st + off), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const bool full = all_visible(p, q0, q0 + kT, t0, kT);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        float pt = exp2_approx(fmaf(s[i], c, -lse2[r]));
        if (!full && !key_visible(p.mode, p.window, q0 + rl + 8 * r, t0 + (i / 4) * 8 + cq + i % 2,
                                  p.Sq, p.Sk))
          pt = 0.f;
        dp[i] = pt * (dp[i] - di[r]);
      }
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) da[kk][u] = pack_bf16(dp[8 * kk + 2 * u], dp[8 * kk + 2 * u + 1]);
#pragma unroll
      for (int a = 0; a < DO / 64; ++a) fence_regs(dq[a]);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < DO / 64; ++a)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n64_tb(dq[a], da[kk],
                          sdesc(k_st + (pass * (DO / 64) + a) * (kT * 128) + kk * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < DO / 64; ++a) fence_regs(dq[a]);
      __syncthreads();  // this stage is free for the copy two tiles on
    }
    cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + rl + 8 * r;
      if (qpos >= p.Sq) continue;
      bf16* row = dq_out + (((long long)b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
      for (int a = 0; a < DO / 64; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = pass * DO + a * 64 + j * 8 + cq;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
                dq[a][4 * j + 2 * r] * p.scale, dq[a][4 * j + 2 * r + 1] * p.scale);
        }
    }
  }
}

}  // namespace tc

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

// Forward on tensor cores: NWG warpgroups of 64 rows, K/V tiles of 64 keys.
template <int NWG, int DP, int KS>
int launch_fwd_tc(const Params& p, cudaStream_t stream) {
  constexpr int BM = 64 * NWG;
  const size_t smem = 1024 + (size_t)BM * DP * 2 + 6 * (size_t)tc::kT * DP * 2;
  auto kernel = tc::flash_fwd_tc_kernel<NWG, DP, KS>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  const int gmax = (p.H + p.KV - 1) / p.KV;
  kernel<<<dim3(gmax * ((p.Sq + BM - 1) / BM), p.KV, p.B), NWG * tc::kWG, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Backward on tensor cores: the Di pre-pass, then the dK/dV and dQ blocks.
template <int DP, int DQ_COLS, int KS>
int launch_bwd_tc(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.Sq * p.H;
  tc::flash_bwd_prepass_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t tile = (size_t)tc::kT * DP * 2;
  const int gmax = (p.H + p.KV - 1) / p.KV;
  if (p.Sk > 0) {
    const size_t smem = 1024 + 6 * tile + 1024;
    auto kernel = tc::flash_bwd_dkdv_tc_kernel<DP, KS>;
    if ((err = set_smem(kernel, smem))) return err;
    kernel<<<dim3((p.Sk + tc::kT - 1) / tc::kT, p.KV, p.B), tc::kWG, smem, stream>>>(p);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const size_t smem = 1024 + 6 * tile;
  auto kernel = tc::flash_bwd_dq_tc_kernel<DP, DQ_COLS, KS>;
  if ((err = set_smem(kernel, smem))) return err;
  kernel<<<dim3(gmax * ((p.Sq + tc::kT - 1) / tc::kT), p.KV, p.B), tc::kWG, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_tc(const Params& p, bool backward, cudaStream_t stream) {
  if (backward && p.di == nullptr) return -1;
  // KS: k16 steps of the products that reduce over D (the pad columns are
  // zero, so running over them is exact); D 33..48 skips the fourth.
  if (p.D > 32 && p.D <= 48)
    return backward ? launch_bwd_tc<64, 64, 3>(p, stream)
                    : launch_fwd_tc<2, 64, 3>(p, stream);
  if (p.D <= 64)
    return backward ? launch_bwd_tc<64, 64, 4>(p, stream)
                    : launch_fwd_tc<2, 64, 4>(p, stream);
  if (p.D <= 128)
    return backward ? launch_bwd_tc<128, 128, 8>(p, stream)
                    : launch_fwd_tc<1, 128, 8>(p, stream);
  return backward ? launch_bwd_tc<256, 128, 16>(p, stream) : launch_fwd_tc<1, 256, 16>(p, stream);
}

// Which kernels serve a call, decided here and nowhere else on the card
// (kernels/flash_attention.py's path_for states the same rule for callers):
// bf16 with D % 8 == 0 takes the tensor-core kernels; fp32, and bf16 with
// D % 8 != 0 (rows of D elements are then no whole 16-byte copies), take the
// CUDA-core kernels.
bool tensor_core_path(int dtype, int D) { return dtype == 1 && D % 8 == 0; }

// dtype: 0 = fp32, 1 = bf16.  Returns a cudaError_t (0 on success), or -1
// for arguments the kernels do not take.
// cuda_core: the CUDA-core kernels whatever the type (the *_cuda_core entry
// points, which time the kept kernels beside the new ones).
int run(int dtype, Params p, bool backward, cudaStream_t stream, bool cuda_core = false) {
  if (p.D < 1 || p.D > 256 || p.H < 1 || p.KV < 1 || p.KV > p.H || p.B < 0 || p.Sq < 0 ||
      p.Sk < 0 || p.mode < kCausal || p.mode > kFull || (p.mode == kLocal && p.window < 1))
    return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (p.B == 0 || p.Sq == 0) return 0;
  if (!cuda_core && tensor_core_path(dtype, p.D)) return launch_tc(p, backward, stream);
  if (dtype == 0) return launch_for_dim<float>(p, backward, stream);
  return launch_for_dim<__nv_bfloat16>(p, backward, stream);
}

}  // namespace

extern "C" {

// o (B, Sq, H, D) and lse (B, H, Sq) from q (B, Sq, H, D), k/v (B, Sk, KV, D).
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int KV, int D, int mode,
                        int window, float scale, void* stream) {
  Params p{q, k, v, nullptr, nullptr, o, nullptr, nullptr, lse, nullptr, B, Sq, Sk, H, KV, D, 0,
           mode, window, scale};
  return run(dtype, p, false, static_cast<cudaStream_t>(stream));
}

// dq, dk, dv from the forward's inputs, its output o and lse, and dout; di is
// an fp32 (B, H, Sq) scratch the tensor-core path writes Di into (the
// CUDA-core path leaves it alone).
int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse, void* dq, void* dk,
                        void* dv, int B, int Sq, int Sk, int H, int KV, int D, int mode,
                        int window, float scale, void* stream, float* di) {
  Params p{q, k, v, o, dout, dq, dk, dv, const_cast<float*>(lse), di, B, Sq, Sk, H, KV, D, 0,
           mode, window, scale};
  return run(dtype, p, true, static_cast<cudaStream_t>(stream));
}

// The same two calls on the CUDA-core kernels for every type.
int flash_attention_fwd_cuda_core(int dtype, const void* q, const void* k, const void* v, void* o,
                                  float* lse, int B, int Sq, int Sk, int H, int KV, int D,
                                  int mode, int window, float scale, void* stream) {
  Params p{q, k, v, nullptr, nullptr, o, nullptr, nullptr, lse, nullptr, B, Sq, Sk, H, KV, D, 0,
           mode, window, scale};
  return run(dtype, p, false, static_cast<cudaStream_t>(stream), true);
}

int flash_attention_bwd_cuda_core(int dtype, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, const float* lse, void* dq,
                                  void* dk, void* dv, int B, int Sq, int Sk, int H, int KV, int D,
                                  int mode, int window, float scale, void* stream, float* di) {
  Params p{q, k, v, o, dout, dq, dk, dv, const_cast<float*>(lse), di, B, Sq, Sk, H, KV, D, 0,
           mode, window, scale};
  return run(dtype, p, true, static_cast<cudaStream_t>(stream), true);
}

}  // extern "C"
