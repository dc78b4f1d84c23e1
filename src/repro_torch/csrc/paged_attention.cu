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
//   ws_ml    (R·KV, splits, n_rows, 2) fp32 workspace: (m, l) per split row
//   ws_acc   (R·KV, splits, n_rows, D) fp32 workspace: acc per split row
// Query token c of slot r sits at position positions[r] + c and sees key j
// iff j <= positions[r] + c (and j > positions[r] + c - window when local).
// Query head h reads kv head (h * KV) / H, which also serves H % KV != 0.
// The rows of a (slot, kv head) are its C·G (token, head) pairs, folded as
// row = c·G + g like the Pallas q tile; n_rows = C·ceil(H / KV).
//
// What bounds it on this card: bytes, and at serving sizes the latency of
// the few loads each key needs.  Each key costs 2·D multiply-adds per query
// row against 2·D elements read, and a (slot, kv head) has only G = H/KV
// (decode) or C·G (chunk) rows to spend them on, far below the ~295
// operations per byte where the H100's tensor cores become the limit.  A
// serving call reads a few MB at most, so what costs is how many dependent
// memory round trips each block waits for, and how few blocks there are to
// overlap them.  The design:
//   * split keys over blocks: split s of a slot covers the absolute keys
//     [s·KS, (s+1)·KS) of the keys its rows can see (KS = kKeysPerSplit,
//     chosen by a sweep on the card, PERF.md).  Grid (splits, row tiles,
//     R·KV), the split axis computed in run() from C, BS, MB and the window
//     (split_axis); paged_attention_split_plan reports it, so the wrapper
//     sizes the workspace without a copy of the rule.  A block
//     computes f32 partials (m, l, acc) of one split for one row tile and
//     writes them to the workspace; a split no row of the tile can see
//     writes m = -1e30, l = 0.  A second kernel, one thread per output
//     element, merges a row's splits in split order: m* = max m_s, l =
//     Σ l_s·e^(m_s − m*), out = Σ acc_s·e^(m_s − m*) / max(l, 1e-30); it is
//     a programmatic dependent launch, so its launch overlaps the split
//     pass.  The splits of a slot depend on its own positions only, so a
//     slot gets the same bits alone as batched;
//   * a block loads the table entries of its split once, then copies the
//     split's K/V rows into a ring of up to kStages tiles in shared memory
//     with 16-byte cp.async (table entries past the last visible key, stale
//     or trash, are never read), so tile j+1 is in flight while tile j is
//     computed; rows that do not start 16-byte aligned (a head dim that is
//     no multiple of 16 bytes, a tensor offset into its buffer) are copied
//     with plain loads into the same ring.  The ring only overlaps copies
//     within a block where a split holds more than one tile: the chunk's
//     16-key tiles (4 per split) and fp32's 32-key tiles (2).  Decode's
//     tile is 64 keys (KG = 4 warps of 16), so a split is one tile and its
//     ring a single stage: its copies overlap only across the blocks
//     resident on an SM;
//   * bf16: S = Q·Kᵀ and O += P·V on the tensor cores, mma.sync m16n8k16
//     bf16 → f32, operands from shared memory by ldmatrix.  Query rows are
//     padded to 16 per warp; decode's G rows fill one 16-row tile, so the
//     four warps of a block split each tile's keys 4 ways (16 keys a warp,
//     KG = 4 key groups) and merge their softmax states in shared memory at
//     the end; the chunk's C·G rows give each warp a 16-row tile of its own
//     (KG = 1; 17 to 32 rows take KG = 2).  P is rounded to bf16 as the A operand of P·V, as SDPA's
//     flash backend does; m and l stay f32;
//   * fp32 keeps the CUDA cores (lane = key for the scores, thread-owned
//     (row, d) accumulators), with the same splits, ring and merge.  The
//     choice is made once, by dtype, in run().
// The arithmetic is the Pallas kernel's: scores (q·k)·scale in f32 (fp32:
// (q·scale)·k), a -1e30 mask (not -inf), an f32 online softmax (m, l, acc)
// and acc / max(l, 1e-30) cast to q's dtype.  One difference: a row that
// can see no key at all (only a local row more than a window past the end
// of its table, which the engine never issues) gets 0, where the Pallas
// kernel averages V over the whole table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;       // tiles of the cp.async ring
constexpr int kMaxHeadDim = 256;
constexpr int kTileKeysF32 = 32;   // fp32: keys per tile, one per lane
constexpr int kRowsF32 = 16;       // fp32: query rows per block
constexpr int kKeysPerSplit = 64;  // KS: keys per split
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

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
  float* ws_ml;
  float* ws_acc;
  int R, C, H, KV, D, BS, MB;
  int local, window;
  float scale;
  int splits;  // split slots per (slot, kv head): the grid's x, split_axis()
  int n_rows;  // C·ceil(H / KV): workspace rows per (slot, kv head, split)
  int vec;     // every K/V/q row starts 16-byte aligned: copies by cp.async
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the 16 bytes at src (n_valid of their elements exist; the rest and
// every element when n_valid <= 0 become 0) to shared dst.  With vec the
// copy is an asynchronous cp.async (src 16-byte aligned); without it, plain
// loads and stores.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int n_valid, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int bytes = n_valid > 0 ? min(n_valid, E) * (int)sizeof(T) : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = e < n_valid ? src[e] : from_f32<T>(0.f);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a·b: a 16×16 bf16 (row), b 16×8 bf16 (col), c 16×8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Splits and the block's share of them
// ---------------------------------------------------------------------------

// The keys the rows of query tokens [c_first, c_last] of a slot at base can
// see in a table of n_keys keys: [lo, hi).
__host__ __device__ __forceinline__ void key_range(int local, int window, int n_keys, int base,
                                                   int c_first, int c_last, int& lo, int& hi) {
  lo = local && base + c_first - window + 1 > 0 ? base + c_first - window + 1 : 0;
  hi = base + c_last + 1 < n_keys ? base + c_last + 1 : n_keys;
}

// Splits of a slot whose rows together see [lo, hi): the one holding lo and
// every one after it up to hi.
__host__ __device__ __forceinline__ int split_count(int lo, int hi) {
  return hi > lo ? (hi + kKeysPerSplit - 1) / kKeysPerSplit - lo / kKeysPerSplit : 0;
}

// The grid's split axis: the most splits a slot of a table MB pages of BS
// wide can have.  A causal slot sees at most keys [0, MB·BS); a local
// slot's C rows see window + C − 1 consecutive keys, which touch at most
// ceil((window + C − 1) / KS) + 1 splits.  So split_count never exceeds it.
int split_axis(int C, int BS, int MB, int local, int window) {
  int n = (MB * BS + kKeysPerSplit - 1) / kKeysPerSplit;
  if (local) n = std::min(n, (window + C - 1 + kKeysPerSplit - 1) / kKeysPerSplit + 1);
  return std::max(n, 1);
}

struct Block {
  int r, kh, h_lo, g;  // slot, kv head, its query heads [h_lo, h_lo + g)
  int row0, nr;        // rows [row0, row0 + nr) of the (slot, kv head)
  int base;            // positions[r]
  int split0;          // the split's first key
  int k_lo, k_hi;      // keys the block's rows can see in the split
  size_t ws_row;       // workspace row of row0 in this split
};

// Locate the block; false when it has no rows or its split is past the
// slot's last one.
__device__ __forceinline__ bool locate(const Params& p, int rows, Block& b) {
  const int rk = blockIdx.z;
  b.r = rk / p.KV;
  b.kh = rk % p.KV;
  b.h_lo = (b.kh * p.H + p.KV - 1) / p.KV;
  b.g = (((b.kh + 1) * p.H + p.KV - 1) / p.KV) - b.h_lo;
  b.row0 = blockIdx.y * rows;
  if (b.g <= 0 || b.row0 >= p.C * b.g) return false;
  b.nr = min(rows, p.C * b.g - b.row0);
  b.base = p.positions[b.r];
  int lo, hi;
  key_range(p.local, p.window, p.MB * p.BS, b.base, 0, p.C - 1, lo, hi);
  if ((int)blockIdx.x >= split_count(lo, hi)) return false;
  b.split0 = (lo / kKeysPerSplit + (int)blockIdx.x) * kKeysPerSplit;
  key_range(p.local, p.window, p.MB * p.BS, b.base, b.row0 / b.g, (b.row0 + b.nr - 1) / b.g, lo,
            hi);
  b.k_lo = max(b.split0, lo);
  b.k_hi = min(b.split0 + kKeysPerSplit, hi);
  b.ws_row = ((size_t)rk * p.splits + blockIdx.x) * p.n_rows + b.row0;
  return true;
}

// Pool row (page·BS + offset) of each key of the split, -1 for keys the
// block's rows cannot see: the table is read once per split, and only for
// visible keys.
__device__ __forceinline__ void load_key_rows(const Params& p, const Block& b, int* rows_s) {
  for (int i = threadIdx.x; i < kKeysPerSplit; i += kThreads) {
    const int t = b.split0 + i;
    int row = -1;
    if (t >= b.k_lo && t < b.k_hi)
      row = p.tables[(size_t)b.r * p.MB + t / p.BS] * p.BS + t % p.BS;
    rows_s[i] = row;
  }
}

// Issue the copies of tile j (tk keys from the split's key j·tk on) of K
// and V into k_s / v_s (tk rows of stride elements, cols columns each,
// zero past D and for keys the block cannot see).
template <typename T>
__device__ __forceinline__ void load_tile(const Params& p, const Block& b, const int* rows_s,
                                          int j, int tk, int cols, int stride, T* k_s, T* v_s) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = cols / E;
  const T* kp = static_cast<const T*>(p.k_pages);
  const T* vp = static_cast<const T*>(p.v_pages);
  for (int i = threadIdx.x; i < tk * cpr; i += kThreads) {
    const int key = i / cpr;
    const int col = (i % cpr) * E;
    const int row = rows_s[j * tk + key];
    const size_t at = row >= 0 ? (((size_t)row * p.KV + b.kh) * p.D + col) : 0;
    const int n_valid = row >= 0 ? p.D - col : 0;
    copy16(k_s + key * stride + col, kp + at, n_valid, p.vec);
    copy16(v_s + key * stride + col, vp + at, n_valid, p.vec);
  }
}

// The split's partials of rows i < nr whose (m, l) a thread holds: l = 0
// when the row saw no key of the split.
__device__ __forceinline__ void store_ml(const Params& p, const Block& b, int i, float m,
                                         float l) {
  p.ws_ml[(b.ws_row + i) * 2] = m;
  p.ws_ml[(b.ws_row + i) * 2 + 1] = m == kNegInf ? 0.f : l;
}

// Let the merge kernel, launched as this grid's programmatic dependent, be
// scheduled once every block of the split pass has started; it waits for
// the pass to finish before it reads the partials.
__device__ __forceinline__ void launch_merge_early() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// A split that none of the block's rows can see.
__device__ __forceinline__ void store_empty(const Params& p, const Block& b) {
  for (int i = threadIdx.x; i < b.nr; i += kThreads) store_ml(p, b, i, kNegInf, 0.f);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// DP: head dim padded to 64, 128 or 256.  KG: key groups (warps that split
// each tile's keys); the block has 4/KG 16-row tiles, so 64/KG rows, and
// tiles of 16·KG keys.  Shared memory: the split's key rows, q (bf16,
// unscaled), then the ring of K/V tiles, rows of DP + 8 elements (ldmatrix
// rows of 8 lanes fall on distinct banks).
template <int DP, int KG>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_kernel_tc(Params p) {
  using T = __nv_bfloat16;
  constexpr int MT = kWarps / KG;
  constexpr int ROWS = 16 * MT;
  constexpr int TK = 16 * KG;
  constexpr int STRIDE = DP + 8;
  launch_merge_early();
  Block b;
  if (!locate(p, ROWS, b)) return;
  if (b.k_lo >= b.k_hi) {
    store_empty(p, b);
    return;
  }
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int mt = warp % MT;
  const int kg = warp / MT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* rows_s = reinterpret_cast<int*>(smem_raw);
  T* q_s = reinterpret_cast<T*>(rows_s + kKeysPerSplit);
  T* ring = q_s + ROWS * STRIDE;  // stage st: K at ring + st·2·TK·STRIDE, V after it

  load_key_rows(p, b, rows_s);
  // q rows (zero past nr and past D), in the first copy group
  {
    constexpr int CPR = DP / 8;
    const T* q = static_cast<const T*>(p.q);
    for (int i = tid; i < ROWS * CPR; i += kThreads) {
      const int row = i / CPR;
      const int col = (i % CPR) * 8;
      size_t at = 0;
      int n_valid = 0;
      if (row < b.nr) {
        const int rr = b.row0 + row;
        at = (((size_t)b.r * p.C + rr / b.g) * p.H + b.h_lo + rr % b.g) * p.D + col;
        n_valid = p.D - col;
      }
      copy16(q_s + row * STRIDE + col, q + at, n_valid, p.vec);
    }
  }
  __syncthreads();  // rows_s

  const int j0 = (b.k_lo - b.split0) / TK;
  const int n_tiles = (b.k_hi - 1 - b.split0) / TK + 1 - j0;
  auto issue = [&](int i) {
    T* k_s = ring + (i % kStages) * 2 * TK * STRIDE;
    load_tile<T>(p, b, rows_s, j0 + i, TK, DP, STRIDE, k_s, k_s + TK * STRIDE);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // The thread's two rows (fragment rows lane/4 and lane/4 + 8 of the warp's
  // tile) and their query positions.
  int qpos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rr = b.row0 + mt * 16 + (lane >> 2) + 8 * e;
    qpos[e] = b.base + rr / b.g;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed for every thread; tile i-1's stage is free
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();

    const T* k_s = ring + (i % kStages) * 2 * TK * STRIDE + kg * 16 * STRIDE;
    const T* v_s = k_s + TK * STRIDE;
    // S = Q·Kᵀ over the warp's 16 keys: two n-tiles of 8
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldmatrix_x4(a, q_s + (mt * 16 + (lane & 15)) * STRIDE + kk * 16 + (lane >> 4) * 8);
      ldmatrix_x4(kb, k_s + ((lane >> 4) * 8 + (lane & 7)) * STRIDE + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], a, kb[0], kb[1]);
      mma_bf16(s[1], a, kb[2], kb[3]);
    }
    // scale and mask; element e of n-tile n: row lane/4 + 8·(e/2), key
    // n·8 + (lane%4)·2 + e%2 of the warp's 16
    const int t0 = b.split0 + (j0 + i) * TK + kg * 16 + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + n * 8 + (e & 1);
        const int qp = qpos[e >> 1];
        const bool valid = t >= b.k_lo && t < b.k_hi && t <= qp &&
                           (!p.local || t > qp - p.window);
        s[n][e] = valid ? s[n][e] * p.scale : kNegInf;
      }
    // online softmax of the thread's two rows; a row's 16 keys sit in the
    // four lanes of a quad
    float corr[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(fmaxf(s[0][2 * e], s[0][2 * e + 1]), fmaxf(s[1][2 * e], s[1][2 * e + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[e], mx);
      corr[e] = expf(m[e] - m_new);
      m[e] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float pr = expf(s[n][2 * e + u] - m_new);
          s[n][2 * e + u] = pr;
          sum += pr;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[e] = l[e] * corr[e] + sum;
    }
    // O = O·corr + P·V: P (16 rows × 16 keys) is the A operand as it sits
    uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                      pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * STRIDE + n * 8 +
                                (lane >> 4) * 8);
      mma_bf16(acc[n], pa, vb[0], vb[1]);
      mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
    }
  }

  if (KG == 1) {  // the warp's rows are its own: write them
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = mt * 16 + (lane >> 2) + 8 * e;
      if (row >= b.nr) continue;
      if ((lane & 3) == 0) store_ml(p, b, row, m[e], l[e]);
      float* dst = p.ws_acc + (b.ws_row + row) * p.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int d = n * 8 + (lane & 3) * 2 + u;
          if (d < p.D) dst[d] = acc[n][2 * e + u];
        }
    }
    return;
  }

  // KG warps hold the same rows over different keys: merge them in key-group
  // order through shared memory (the ring is free now).
  cp_async_wait<0>();
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(ring);  // [warp][16 rows][DP]
  float* ml_s = acc_s + kWarps * 16 * DP;         // [warp][16 rows][2]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int lr = (lane >> 2) + 8 * e;
    if ((lane & 3) == 0) {
      ml_s[(warp * 16 + lr) * 2] = m[e];
      ml_s[(warp * 16 + lr) * 2 + 1] = m[e] == kNegInf ? 0.f : l[e];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        acc_s[(warp * 16 + lr) * DP + n * 8 + (lane & 3) * 2 + u] = acc[n][2 * e + u];
  }
  __syncthreads();
  for (int idx = tid; idx < b.nr * p.D; idx += kThreads) {
    const int row = idx / p.D;
    const int d = idx % p.D;
    const int w0 = row / 16;  // the warp of key group 0 holding the row
    const int lr = row % 16;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int w = w0 + k * MT;
      if (ml_s[(w * 16 + lr) * 2 + 1] > 0.f) mx = fmaxf(mx, ml_s[(w * 16 + lr) * 2]);
    }
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const int w = w0 + k * MT;
      const float lk = ml_s[(w * 16 + lr) * 2 + 1];
      if (lk > 0.f) {
        const float wt = expf(ml_s[(w * 16 + lr) * 2] - mx);
        lsum += lk * wt;
        o += acc_s[(w * 16 + lr) * DP + d] * wt;
      }
    }
    p.ws_acc[(b.ws_row + row) * p.D + d] = o;
    if (d == 0) store_ml(p, b, row, mx, lsum);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// kRowsF32 rows per block, tiles of kTileKeysF32 keys; each thread keeps
// ACC = kRowsF32·kMaxHeadDim/kThreads accumulator slots in registers.
// Shared memory: the split's key rows, q (fp32, scaled), the ring of K/V
// tiles (rows of stride = D rounded up to 4, plus 4), probabilities, m, l
// and the correction of each row.
__global__ void __launch_bounds__(kThreads) paged_attention_kernel_f32(Params p, int stride) {
  using T = float;
  constexpr int ROWS = kRowsF32;
  constexpr int TK = kTileKeysF32;
  constexpr int ACC = ROWS * kMaxHeadDim / kThreads;
  launch_merge_early();
  Block b;
  if (!locate(p, ROWS, b)) return;
  if (b.k_lo >= b.k_hi) {
    store_empty(p, b);
    return;
  }
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* rows_s = reinterpret_cast<int*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(rows_s + kKeysPerSplit);
  float* p_s = q_s + ROWS * D;
  float* m_s = p_s + ROWS * TK;
  float* l_s = m_s + ROWS;
  float* c_s = l_s + ROWS;
  // the ring, 16-byte aligned after the 3·ROWS floats above
  float* ring = c_s + ROWS + ((4 - (ROWS * D + ROWS * TK + 3 * ROWS) % 4) % 4);

  load_key_rows(p, b, rows_s);
  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < b.nr * D; i += kThreads) {
    const int rr = b.row0 + i / D;
    q_s[i] = q[(((size_t)b.r * p.C + rr / b.g) * p.H + b.h_lo + rr % b.g) * D + i % D] * p.scale;
  }
  if (tid < ROWS) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();  // rows_s

  const int cols = (D + 3) / 4 * 4;
  const int j0 = (b.k_lo - b.split0) / TK;
  const int n_tiles = (b.k_hi - 1 - b.split0) / TK + 1 - j0;
  auto issue = [&](int i) {
    float* k_s = ring + (i % kStages) * 2 * TK * stride;
    load_tile<T>(p, b, rows_s, j0 + i, TK, cols, stride, k_s, k_s + TK * stride);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    const float* k_s = ring + (i % kStages) * 2 * TK * stride;
    const float* v_s = k_s + TK * stride;

    // Scores and the online-softmax update: lane = key, warps stride rows.
    const int t = b.split0 + (j0 + i) * TK + lane;
    for (int r = warp; r < b.nr; r += kWarps) {
      const float* qr = q_s + r * D;
      const float* kr = k_s + lane * stride;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int qpos = b.base + (b.row0 + r) / b.g;
      const bool valid = t >= b.k_lo && t < b.k_hi && t <= qpos &&
                         (!p.local || t > qpos - p.window);
      s = valid ? s : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float pr = expf(s - m_new);
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r * TK + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·corr + P·V, thread-owned (row, d) slots.
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < b.nr * D) {
        const int r = idx / D;
        const int d = idx % D;
        const float* pr = p_s + r * TK;
        float v = acc[a] * c_s[r];
#pragma unroll 8
        for (int j = 0; j < TK; ++j) v = fmaf(pr[j], v_s[j * stride + d], v);
        acc[a] = v;
      }
    }
  }

  if (tid < b.nr) store_ml(p, b, tid, m_s[tid], l_s[tid]);
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < b.nr * D) p.ws_acc[(b.ws_row + idx / D) * D + idx % D] = acc[a];
  }
}

// ---------------------------------------------------------------------------
// The merge of a row's splits
// ---------------------------------------------------------------------------

constexpr int kMergeBatch = 8;  // splits whose partials a thread loads at once

// Grid (ceil(n_rows·D / kThreads), R·KV), one thread per (row, d) of a
// (slot, kv head): in split order, m* = max m_s over splits that saw a key,
// l = Σ l_s·e^(m_s − m*), out = Σ acc_s·e^(m_s − m*) / max(l, 1e-30).  The
// kernel is launched as a programmatic dependent of the split pass: it
// locates its row and reads positions while that pass runs, then waits for
// it (griddepcontrol.wait) before it reads the partials, kMergeBatch splits
// of loads in flight at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel_combine(Params p) {
  const int rk = blockIdx.y;
  const int r = rk / p.KV;
  const int kh = rk % p.KV;
  const int h_lo = (kh * p.H + p.KV - 1) / p.KV;
  const int g = (((kh + 1) * p.H + p.KV - 1) / p.KV) - h_lo;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int row = idx / p.D;
  const int d = idx % p.D;
  const bool live = g > 0 && row < p.C * g;
  int n = 0;
  if (live) {
    int lo, hi;
    key_range(p.local, p.window, p.MB * p.BS, p.positions[r], 0, p.C - 1, lo, hi);
    n = split_count(lo, hi);  // <= p.splits (split_axis)
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (!live) return;
  const size_t first = (size_t)rk * p.splits * p.n_rows + row;  // split s: first + s·n_rows
  const float2* ml = reinterpret_cast<const float2*>(p.ws_ml);

  float mx = kNegInf;
  for (int s0 = 0; s0 < n; s0 += kMergeBatch) {
    float2 v[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < n) v[u] = __ldcg(ml + first + (size_t)(s0 + u) * p.n_rows);
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < n && v[u].y > 0.f) mx = fmaxf(mx, v[u].x);
  }
  float l = 0.f, o = 0.f;
  for (int s0 = 0; s0 < n; s0 += kMergeBatch) {
    float2 v[kMergeBatch];
    float a[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < n) {
        const size_t at = first + (size_t)(s0 + u) * p.n_rows;
        v[u] = __ldcg(ml + at);
        a[u] = __ldcg(p.ws_acc + at * p.D + d);
      }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u)
      if (s0 + u < n && v[u].y > 0.f) {
        const float w = expf(v[u].x - mx);
        l += v[u].y * w;
        o += a[u] * w;
      }
  }
  T* out = static_cast<T*>(p.out);
  const int c = row / g;
  const int h = h_lo + row % g;
  out[(((size_t)r * p.C + c) * p.H + h) * p.D + d] = from_f32<T>(o / fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int DP, int KG>
int launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int ROWS = 16 * (kWarps / KG);
  constexpr int TK = 16 * KG;
  constexpr int stages = std::min(kStages, kKeysPerSplit / TK);  // stages a split can fill
  const size_t ring = (size_t)stages * 2 * TK * (DP + 8) * sizeof(__nv_bfloat16);
  const size_t merge = KG > 1 ? (size_t)kWarps * 16 * (DP + 2) * sizeof(float) : 0;
  const size_t smem = (size_t)kKeysPerSplit * sizeof(int) +
                      (size_t)ROWS * (DP + 8) * sizeof(__nv_bfloat16) + (ring > merge ? ring : merge);
  int err = set_smem(paged_attention_kernel_tc<DP, KG>, smem);
  if (err) return err;
  const dim3 grid(p.splits, (p.n_rows + ROWS - 1) / ROWS, p.R * p.KV);
  paged_attention_kernel_tc<DP, KG><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tc_rows(const Params& p, cudaStream_t stream) {
  if (p.n_rows <= 16) return launch_tc<DP, 4>(p, stream);
  if (p.n_rows <= 32) return launch_tc<DP, 2>(p, stream);
  return launch_tc<DP, 1>(p, stream);
}

int launch_f32(const Params& p, cudaStream_t stream) {
  const int stride = (p.D + 3) / 4 * 4 + 4;
  constexpr int stages = std::min(kStages, kKeysPerSplit / kTileKeysF32);
  const size_t head = (size_t)kRowsF32 * p.D + (size_t)kRowsF32 * kTileKeysF32 + 3 * kRowsF32;
  const size_t smem = (size_t)kKeysPerSplit * sizeof(int) + ((head + 3) / 4 * 4) * sizeof(float) +
                      (size_t)stages * 2 * kTileKeysF32 * stride * sizeof(float);
  int err = set_smem(paged_attention_kernel_f32, smem);
  if (err) return err;
  const dim3 grid(p.splits, (p.n_rows + kRowsF32 - 1) / kRowsF32, p.R * p.KV);
  paged_attention_kernel_f32<<<grid, kThreads, smem, stream>>>(p, stride);
  return (int)cudaGetLastError();
}

// The merge, as a programmatic dependent launch of the split pass.
template <typename T>
int launch_combine(const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((size_t)p.n_rows * p.D + kThreads - 1) / kThreads), p.R * p.KV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, paged_attention_kernel_combine<T>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// dtype: 0 = fp32 (CUDA cores), 1 = bf16 (tensor cores).  Returns a
// cudaError_t (0 on success), or -1 for arguments the kernels do not take.
int run(int dtype, Params p, cudaStream_t stream) {
  const int gmax = (p.H + p.KV - 1) / std::max(p.KV, 1);
  if (p.D < 1 || p.D > kMaxHeadDim || p.KV < 1 || p.H < 1 || p.C < 1 || p.BS < 1 ||
      p.MB < 1 || (p.local && p.window < 1) || p.n_rows != p.C * gmax ||
      (dtype != 0 && dtype != 1))
    return -1;
  if (p.R == 0) return 0;
  p.splits = split_axis(p.C, p.BS, p.MB, p.local, p.window);
  const int elems = dtype == 0 ? 4 : 8;  // elements per 16 bytes
  p.vec = p.D % elems == 0 && aligned16(p.q) && aligned16(p.k_pages) && aligned16(p.v_pages);
  int err;
  if (dtype == 0) {
    err = launch_f32(p, stream);
    if (!err) err = launch_combine<float>(p, stream);
  } else {
    err = p.D <= 64 ? launch_tc_rows<64>(p, stream)
        : p.D <= 128 ? launch_tc_rows<128>(p, stream)
                     : launch_tc_rows<256>(p, stream);
    if (!err) err = launch_combine<__nv_bfloat16>(p, stream);
  }
  return err;
}

}  // namespace

extern "C" {

// Decode: q (R, H, D), one query token per slot at positions[r].
int paged_attention_decode(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const int32_t* tables,
                           const int32_t* positions, void* out, float* ws_ml,
                           float* ws_acc, int R, int H, int KV, int D, int BS,
                           int MB, int local, int window, float scale,
                           void* stream) {
  const int n_rows = (H + KV - 1) / (KV > 0 ? KV : 1);
  const Params p{q, k_pages, v_pages, tables, positions, out, ws_ml, ws_acc,
                 R, 1, H, KV, D, BS, MB, local, window, scale, 0, n_rows, 0};
  return run(dtype, p, static_cast<cudaStream_t>(stream));
}

// Chunked prefill: q (R, C, H, D), token c of slot r at positions[r] + c.
int paged_attention_chunk(int dtype, const void* q, const void* k_pages,
                          const void* v_pages, const int32_t* tables,
                          const int32_t* positions, void* out, float* ws_ml,
                          float* ws_acc, int R, int C, int H, int KV, int D,
                          int BS, int MB, int local, int window, float scale,
                          void* stream) {
  const int n_rows = C * ((H + KV - 1) / (KV > 0 ? KV : 1));
  const Params p{q, k_pages, v_pages, tables, positions, out, ws_ml, ws_acc,
                 R, C, H, KV, D, BS, MB, local, window, scale, 0, n_rows, 0};
  return run(dtype, p, static_cast<cudaStream_t>(stream));
}

// The split plan of a call with C query tokens per slot (1 for decode):
// plan[0] = keys per split, plan[1] = the grid's split axis (the
// workspace's second dimension), plan[2] = the splits a slot at position
// runs.  Returns -1 for arguments the kernels do not take.
int paged_attention_split_plan(int position, int C, int BS, int MB, int local, int window,
                               int* plan) {
  if (position < 0 || C < 1 || BS < 1 || MB < 1 || (local && window < 1)) return -1;
  int lo, hi;
  key_range(local, window, MB * BS, position, 0, C - 1, lo, hi);
  plan[0] = kKeysPerSplit;
  plan[1] = split_axis(C, BS, MB, local, window);
  plan[2] = split_count(lo, hi);
  return 0;
}

}  // extern "C"
