// Paged attention for Hopper (sm_90a): decode (one query token per request
// slot) and chunked prefill (C query tokens per slot) over a paged K/V pool.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attention_decode  <- pallas_paged_attention        (:110)
//   paged_attention_chunk   <- pallas_paged_chunk_attention  (:226)
//
// Layouts (row-major, contiguous):
//   q        decode (R, H, D) / chunk (R, C, H, D), fp32 or bf16
//   k_pages  (NP + 1, BS, KV, D), same dtype as q; page NP is the trash page
//   v_pages  (NP + 1, BS, KV, D)
//   tables   (R, MB) int32, every entry a page id in [0, NP]
//   positions (R,) int32: the position of query token 0 of each slot
//   out      like q
// Query token c of slot r sits at position positions[r] + c and sees key j
// iff j <= positions[r] + c (and j > positions[r] + c - window when local).
// Query head h reads kv head (h * KV) / H, which also serves H % KV != 0.
//
// What bounds it on this card: bytes.  Each key costs 2·D multiply-adds per
// query row against 2·D elements read, and a block has only G = H/KV (decode)
// or C·G (chunk) rows to spend them on, far below the ~295 operations per
// byte where the H100's tensor cores would become the limit.  So the design
// is about reading the live K/V once and nothing else:
//   * one block per (slot, kv head[, row tile]): the G query heads (or C·G
//     chunk rows, folded as row = c·G + g like the Pallas q tile) that share a
//     kv head are served from one read of that head's K/V;
//   * the block walks only the keys its rows can see, [t_lo, t_hi): t_hi
//     stops at the last query position (not at the end of the num_pages-wide
//     block table, which the Pallas grid walks whole), t_lo starts at the
//     window's first key on local layers.  Keys outside it are masked for
//     every row, and a masked key adds exactly 0 once a live key has been
//     seen, so skipping them leaves the result unchanged while decode costs
//     O(context), not O(num_pages);
//   * keys go through the block table one tile of 32 at a time, so no dense
//     gather of the context is ever written; table entries past t_hi (stale
//     rows of evicted requests, trash fill) are never read;
//   * with one block per (slot, kv head) there are few warps per SM to hide
//     memory latency, so every copy from global memory (q rows, K/V tiles)
//     issues kBatch loads per thread before it reads any of them.
// The arithmetic is the Pallas kernel's: fp32 q·scale, a -1e30 mask (not
// -inf), an fp32 online softmax (m, l, acc) and acc / max(l, 1e-30) cast to
// q's dtype.  One difference: a row that can see no key at all (only a
// local row more than a window past the end of its table, which the engine
// never issues) walks no tile and gets 0, where the Pallas kernel averages V
// over the whole table.  Products run on the CUDA cores; tensor cores
// (wgmma), TMA page loads and splitting long contexts over several blocks
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;  // keys per tile: one per lane in the score pass
constexpr int kBatch = 16;  // loads a thread issues before it reads any
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

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
  const void* k_pages;
  const void* v_pages;
  const int32_t* tables;
  const int32_t* positions;
  void* out;
  int R, C, H, KV, D, BS, MB;
  int local, window;
  float scale;
};

// Dynamic shared memory of one block, in bytes.
__host__ __device__ inline size_t smem_bytes(int rows, int d) {
  return sizeof(long long) * kKeys +
         sizeof(float) * ((size_t)rows * d        // q rows, scaled
                          + (size_t)kKeys * (d + 1)  // K tile, padded
                          + (size_t)kKeys * d        // V tile
                          + (size_t)rows * kKeys     // probabilities
                          + 3 * (size_t)rows);       // m, l, correction
}

// Grid (row tiles, KV, R).  ROWS query rows per block, each thread keeping
// ACC = ROWS·kMaxHeadDim/kThreads accumulator slots in registers.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  constexpr int ACC = ROWS * kMaxHeadDim / kThreads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kh = blockIdx.y;
  const int r = blockIdx.z;

  // The query heads that read kv head kh: h with (h·KV)/H == kh.
  const int h_lo = (kh * p.H + p.KV - 1) / p.KV;
  const int h_hi = ((kh + 1) * p.H + p.KV - 1) / p.KV;
  const int g = h_hi - h_lo;
  const int n_rows = p.C * g;
  const int row0 = blockIdx.x * ROWS;
  if (g <= 0 || row0 >= n_rows) return;
  const int nr = min(ROWS, n_rows - row0);
  const int D = p.D;
  const int Dp = D + 1;  // K tile row stride: lanes read distinct banks

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(off_s + kKeys);
  float* k_s = q_s + ROWS * D;
  float* v_s = k_s + kKeys * Dp;
  float* p_s = v_s + kKeys * D;
  float* m_s = p_s + ROWS * kKeys;
  float* l_s = m_s + ROWS;
  float* c_s = l_s + ROWS;

  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k_pages);
  const T* vp = static_cast<const T*>(p.v_pages);
  T* out = static_cast<T*>(p.out);

  const int base = p.positions[r];
  const int c_first = row0 / g;
  const int c_last = (row0 + nr - 1) / g;
  const int t_hi = min(base + c_last + 1, p.MB * p.BS);
  const int t_lo = p.local ? max(0, base + c_first - p.window + 1) : 0;

  // Element i of the block's q rows in global memory.
  auto q_at = [&](int i) {
    const int row = row0 + i / D;
    const int c = row / g;
    const int h = h_lo + row % g;
    return (((long long)r * p.C + c) * p.H + h) * D + i % D;
  };
  for (int i0 = tid; i0 < nr * D; i0 += kBatch * kThreads) {
    T raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      raw[u] = q[q_at(min(i0 + u * kThreads, nr * D - 1))];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nr * D) q_s[i] = to_f32(raw[u]) * p.scale;
    }
  }
  if (tid < ROWS) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int t0 = t_lo; t0 < t_hi; t0 += kKeys) {
    // Element offset of each key of the tile in the pool, through the table.
    if (tid < kKeys) {
      const int t = t0 + tid;
      long long off = -1;
      if (t < t_hi) {
        const int page = p.tables[(long long)r * p.MB + t / p.BS];
        off = (((long long)page * p.BS + t % p.BS) * p.KV + kh) * D;
      }
      off_s[tid] = off;
    }
    __syncthreads();
    // Copy the tile's K/V rows into shared memory.  A thread issues all
    // kBatch loads of K and of V before it reads any of them (a key past
    // t_hi loads pool element 0 and is zeroed afterwards), so the copy waits
    // on about one memory latency per batch instead of one per element.
    for (int i0 = tid; i0 < kKeys * D; i0 += kBatch * kThreads) {
      T kraw[kBatch], vraw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = min(i0 + u * kThreads, kKeys * D - 1);
        const long long off = off_s[i / D];
        const long long at = off >= 0 ? off + i % D : 0;
        kraw[u] = kp[at];
        vraw[u] = vp[at];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < kKeys * D) {
          const bool live = off_s[i / D] >= 0;
          k_s[(i / D) * Dp + i % D] = live ? to_f32(kraw[u]) : 0.f;
          v_s[i] = live ? to_f32(vraw[u]) : 0.f;
        }
      }
    }
    __syncthreads();

    // Scores and the online-softmax update: lane = key, warps stride rows.
    const int t = t0 + lane;
    for (int i = warp; i < nr; i += kWarps) {
      const float* qr = q_s + i * D;
      const float* kr = k_s + lane * Dp;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int qpos = base + (row0 + i) / g;
      const bool valid =
          t < t_hi && t <= qpos && (!p.local || t > qpos - p.window);
      s = valid ? s : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      const float pr = expf(s - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[i * kKeys + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[i] = corr;
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·corr + P·V, thread-owned (row, d) slots.
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < nr * D) {
        const int i = idx / D;
        const int d = idx % D;
        const float* pr = p_s + i * kKeys;
        float v = acc[a] * c_s[i];
#pragma unroll 8
        for (int j = 0; j < kKeys; ++j) v = fmaf(pr[j], v_s[j * D + d], v);
        acc[a] = v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < nr * D) {
      const int i = idx / D;
      const int d = idx % D;
      const int row = row0 + i;
      const int c = row / g;
      const int h = h_lo + row % g;
      out[(((long long)r * p.C + c) * p.H + h) * D + d] =
          from_f32<T>(acc[a] / fmaxf(l_s[i], 1e-30f));
    }
  }
}

template <typename T, int ROWS>
int launch(const Params& p, cudaStream_t stream) {
  if (p.R == 0) return 0;
  const int gmax = (p.H + p.KV - 1) / p.KV;
  const int tiles = (p.C * gmax + ROWS - 1) / ROWS;
  const size_t smem = smem_bytes(ROWS, p.D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(tiles, p.KV, p.R);
  paged_attention_kernel<T, ROWS><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// dtype: 0 = fp32, 1 = bf16.  Returns a cudaError_t (0 on success), or -1
// for arguments the kernel does not take.
template <int ROWS>
int dispatch(int dtype, const Params& p, cudaStream_t stream) {
  if (p.D < 1 || p.D > kMaxHeadDim || p.KV < 1 || p.H < 1 || p.C < 1 ||
      p.BS < 1 || p.MB < 1 || (p.local && p.window < 1))
    return -1;
  if (dtype == 0) return launch<float, ROWS>(p, stream);
  if (dtype == 1) return launch<__nv_bfloat16, ROWS>(p, stream);
  return -1;
}

}  // namespace

extern "C" {

// Decode: q (R, H, D), one query token per slot at positions[r].  Rows of a
// block are the G query heads of one kv head (8 per block at most).
int paged_attention_decode(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const int32_t* tables,
                           const int32_t* positions, void* out, int R, int H,
                           int KV, int D, int BS, int MB, int local,
                           int window, float scale, void* stream) {
  const Params p{q, k_pages, v_pages, tables, positions, out, R, 1, H, KV, D,
                 BS, MB, local, window, scale};
  return dispatch<8>(dtype, p, static_cast<cudaStream_t>(stream));
}

// Chunked prefill: q (R, C, H, D), token c of slot r at positions[r] + c.
// Rows of a block are a tile of 16 of the C·G (token, head) rows.
int paged_attention_chunk(int dtype, const void* q, const void* k_pages,
                          const void* v_pages, const int32_t* tables,
                          const int32_t* positions, void* out, int R, int C,
                          int H, int KV, int D, int BS, int MB, int local,
                          int window, float scale, void* stream) {
  const Params p{q, k_pages, v_pages, tables, positions, out, R, C, H, KV, D,
                 BS, MB, local, window, scale};
  return dispatch<16>(dtype, p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
