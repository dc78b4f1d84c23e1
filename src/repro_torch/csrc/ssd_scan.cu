// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a).  Per (batch, chunk,
// head), over the chunk's Q tokens:
//
//   cums_i  = Σ_{t ≤ i} dt_t·a                       (inclusive cumsum)
//   L[i, j] = exp(cums_i − cums_j)·[i ≥ j]
//   y_i     = Σ_{j ≤ i} (C_i·B_j)·L[i, j]·(dt_j·x_j)  (intra-chunk output)
//   state   = Σ_j exp(cums_{Q−1} − cums_j)·B_j ⊗ (dt_j·x_j)   (chunk end)
//
// Replaces src/repro/kernels/ssd_scan.py:52 ssd_chunk_kernel (pallas_call at
// :66).  The inter-chunk state recurrence stays in plain PyTorch
// (repro_torch/kernels/ops.py::ssd_chunk), as the JAX package leaves it to
// jnp.
//
// Layouts (row-major, contiguous, fp32):
//   x (B, NC, Q, H, P), dt (B, NC, Q, H), a (H,) or (B, H), b/c (B, NC, Q, N)
//   y (B, NC, Q, H, P), states (B, NC, H, N, P)
// a is (B, H) when every row has rates of its own (a_rows = 1): training
// folds the replicas into B, each with its own −exp(a_log).
//
// What bounds it on this card.  The function needs Q²·N/2 multiply-adds per
// chunk for S = C Bᵀ (B and C are shared by the heads) and, per head, Q²·P/2
// for y = (S ∘ L)·xdt and Q·N·P for the state.  At the training shape
// (B 16, NC 8, Q 128, H 32, P 64, N 128) that is 13 GFLOP against 0.42 GB
// moved: operations bound, 0.197 ms at the CUDA cores' fp32 peak.  At the
// serving shape (one chunk of 32 tokens) it is 19 MFLOP against 1.6 MB:
// bytes bound, under a microsecond, so what costs is latency and how many
// SMs share it.
//
// The design:
//   * The three products run on the tensor cores, mma.sync m16n8k8 TF32, at
//     fp32 accuracy by the 3xTF32 split: each operand v = hi + lo, hi and lo
//     rounded to TF32 (to nearest, ties away: cvt.rna's rounding, done with
//     an integer add and mask, which ran faster on the card than cvt), and
//     a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (the dropped a_lo·b_lo is
//     ~2^-22 of a·b).  Plain TF32 would keep ~3 decimal digits.  Each k step
//     of 8 sums its three products in a fresh accumulator, added to the
//     running sum with an fp32 add, since the tensor cores' own accumulation
//     truncates.  Each warp owns a 16-row output tile of 8·NT columns with
//     its own accumulators; fragments are read from shared memory with row
//     strides chosen so a warp's 32 reads fall in 32 banks (≡ 4 mod 32 for
//     rows read by (group, thread) as (row, k), ≡ 8 for rows read as (k,
//     row); B's transposed read in the state product is the one 2-way
//     conflict left).
//   * The cumsum is a warp scan (shuffles, 32 rows a step) by warp 0, in
//     fp64, while the first tiles' copies are in flight, and L and the decay
//     are exp of fp64 differences rounded once to fp32.  The plain version
//     differences two fp32 prefix sums, which at the training shape reach
//     ~350 (|a| up to 16 over 128 steps of dt), where an fp32 ulp is 3e-5,
//     so its L carries relative errors of that order; an fp32 scan in
//     another order than its own would add errors of the same size instead
//     of reproducing them.  In fp64 the kernel's L is near exact, and
//     chip_smoke.py holds both against an fp64 evaluation.
//   * Q is walked in tiles of kT = 64 rows.  For each i tile the block
//     holds C_i, and for each j tile ≤ i it brings B_j and x_j, forms the
//     64 × 64 tile S_ij, applies L and the causal mask in registers (a
//     masked entry is set to 0, never multiplied: exp of a masked entry may
//     overflow), stores S ∘ L to shared memory and adds (S ∘ L)·xdt_j to the
//     i tile's y accumulators.  The state is then Σ_j (B_j ∘ dec_j)ᵀ·xdt_j
//     over the j tiles, 128 state rows a pass, starting from the tile still
//     in shared memory.  Shared memory is four 64-row tiles and three Q-long
//     vectors (the fp64 cumsum, dt, the decay), 105,472 bytes at Q 128,
//     N 128 and P 64, and only the vectors grow with Q; two blocks share an
//     SM at the training shape.
//   * Column slabs.  The P columns of a head are split into slabs of PW
//     (64, 32 or 16) columns, one block each; the y and state columns are
//     independent once S, L and the decay are known.  The launcher takes
//     the widest slab that still gives kMinBlocks blocks (~ one per SM):
//     PW 64 at the training shape (4,096 blocks), PW 16 at the serving
//     shape (32 heads × 4 slabs = 128 blocks, where one block per head left
//     100 of 132 SMs idle).  The rule is the source's; nothing reaches the
//     C interface.
//   * S is formed again by every block, per head and per slab.  At the
//     training shape a chunk's S is Q²·N/2 = 1.06M multiply-adds and each of
//     its 32 heads forms it again: 1.65× the multiply-adds the bound counts
//     (83M against 50M per chunk); with 64-row tiles a block there does
//     1.31M multiply-adds for S of its 2.95M.  At the serving shape each of
//     the 128 blocks forms a 32 × 32 × 128 S.  Forming S once per chunk in
//     a cluster of four heads (each block a quarter of the rows, read back
//     by the others from distributed shared memory after a cluster barrier)
//     gave the same bits and ran slower at both shapes on the card: the
//     barriers and the remote reads cost more than the products they saved.
//   * B, C and x come in by cp.async: 16-byte copies where N % 4 == 0,
//     P % 4 == 0 and the pointers are 16-byte aligned, 4-byte copies
//     otherwise; rows past Q and columns past N or P are zero-filled, so
//     nothing outside the function reaches a sum.  dt·x is formed in shared
//     memory by the thread that copied x, after its own copies land.  y and
//     the state leave as 8-byte pairs on the 16-byte path.
// A pad row with dt = 0 adds dt·a = 0 to the cumsum and has dt·x = 0, so
// every product it takes part in for the state or for a real row's y is an
// exact zero, whatever its x, B and C hold: the serving engine masks ragged
// chunk tails that way.  Every output element is a fixed sequence of
// products and sums set by Q and N alone (the slab width only partitions
// the columns), so a (b, c, h) gets the same bits whatever B, NC and the
// slab count are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // eight warps
constexpr int kT = 64;                 // rows of a Q tile
constexpr int kStateRows = 128;        // state rows per pass: 16 per warp
constexpr int kPS = kT + 4;            // row stride of S ∘ L in shared memory
constexpr long long kMinBlocks = 128;  // the slab rule's aim: about one block per SM
constexpr size_t kMaxSmem = 232448;    // 227 KB, a block's most on sm_90

struct Params {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* states;
  int NC, Q, H, P, N;
  int slabs;   // column slabs per head
  int a_rows;  // 1: a is (B, H); 0: (H,)
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride of the B and C tiles: N padded to a multiple of 8, plus 4.
__host__ __device__ inline int bc_stride(int N) { return round_up(N, 8) + 4; }

template <int PW>
__host__ __device__ inline size_t smem_bytes(int Q, int N) {
  return sizeof(double) * round_up(Q, 2)                   // the cumsum, fp64
         + sizeof(float) * (2 * (size_t)kT * bc_stride(N)  // C_i, B_j
                            + (size_t)kT * (PW + 8)         // dt·x of the slab, j tile
                            + (size_t)kT * kPS              // S ∘ L
                            + 2 * (size_t)round_up(Q, 4));  // dt, chunk-end decay
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 (VEC) or 4 bytes from src to shared dst; valid false writes zeros
// and reads nothing.
template <bool VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  if (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The bits of a float rounded to TF32 (10 mantissa bits), to nearest with
// ties away from zero: cvt.rna.tf32.f32's rounding, done by an integer add
// and mask, which ran faster than the conversion instruction on the card.
__device__ __forceinline__ uint32_t to_tf32(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// v = hi + lo, both TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(__float_as_uint(v));
  lo = to_tf32(__float_as_uint(__fsub_rn(v, __uint_as_float(hi))));
}

// d += a·b: a 16×8 TF32 (row), b 8×8 TF32 (col), d 16×8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc (16 × 8·NT) += A (16 × 8·ksteps) · B (8·ksteps × 8·NT) in
// 3xTF32.  la(r, k) and lb(k, n) read the operands.  Accumulator element e
// of tile nt sits at row g + 8·(e / 2), column 8·nt + 2·t + e % 2, with
// g = lane / 4 and t = lane % 4 (the PTX fragment layout).  Each k step's
// three products go to a fresh partial sum, added to acc in fp32: the tensor
// cores' accumulation truncates, so the running sum never passes through it.
template <int NT, typename LoadA, typename LoadB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int ksteps, LoadA la, LoadB lb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 8;
    uint32_t ahi[4], alo[4];
    split_tf32(la(g, k + t), ahi[0], alo[0]);
    split_tf32(la(g + 8, k + t), ahi[1], alo[1]);
    split_tf32(la(g, k + t + 4), ahi[2], alo[2]);
    split_tf32(la(g + 8, k + t + 4), ahi[3], alo[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bhi0, blo0, bhi1, blo1;
      split_tf32(lb(k + t, nt * 8 + g), bhi0, blo0);
      split_tf32(lb(k + t + 4, nt * 8 + g), bhi1, blo1);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(part, alo, bhi0, bhi1);
      mma_tf32(part, ahi, blo0, blo1);
      mma_tf32(part, ahi, bhi0, bhi1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], part[e]);
    }
  }
}

// dst[0], dst[1] = v0, v1 where they lie among the row's `left` columns; one
// 8-byte store on the 16-byte path (P % 4 == 0 and the column even, so both
// or neither are in the row).
template <bool VEC>
__device__ __forceinline__ void store_pair(float* dst, float v0, float v1, int left) {
  if (VEC) {
    if (left > 0) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    if (left > 0) dst[0] = v0;
    if (left > 1) dst[1] = v1;
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
}

// ---------------------------------------------------------------------------
// Tile copies
// ---------------------------------------------------------------------------

// Rows [r0, r0 + kT) of a (rows, N) matrix into a kT × stride tile, one warp
// per row; rows past `rows` and columns past N become 0.
template <bool VEC>
__device__ __forceinline__ void copy_bc_tile(float* tile, const float* src, int r0, int rows,
                                             int N, int stride) {
  const int lane = threadIdx.x & 31;
  const int n8 = round_up(N, 8);
  for (int r = threadIdx.x >> 5; r < kT; r += kThreads / 32) {
    const bool row_ok = r0 + r < rows;
    const float* s = src + (long long)(row_ok ? r0 + r : 0) * N;
    float* d = tile + r * stride;
    if (VEC) {
      for (int col = lane * 4; col < n8; col += 128) {
        const bool ok = row_ok && col < N;
        copy_async<true>(d + col, ok ? s + col : src, ok);
      }
    } else {
      for (int col = lane; col < n8; col += 32) {
        const bool ok = row_ok && col < N;
        copy_async<false>(d + col, ok ? s + col : src, ok);
      }
    }
  }
}

// x[j, h, p0 : p0 + PW] for j in [j0, j0 + kT) into a kT × (PW + 8) tile.
template <int PW, bool VEC>
__device__ __forceinline__ void copy_x_tile(float* tile, const float* xb, int j0, int Q, int H,
                                            int h, int P, int p0) {
  constexpr int E = VEC ? 4 : 1;
  constexpr int per_row = PW / E;
  for (int idx = threadIdx.x; idx < kT * per_row; idx += kThreads) {
    const int r = idx / per_row, col = (idx % per_row) * E;
    const bool ok = j0 + r < Q && p0 + col < P;
    const float* s = xb + ((long long)(j0 + r) * H + h) * P + p0 + col;
    copy_async<VEC>(tile + r * (PW + 8) + col, ok ? s : xb, ok);
  }
}

// After this thread's copies of the x tile land: x ← dt·x on its elements.
template <int PW, bool VEC>
__device__ __forceinline__ void scale_x_tile(float* tile, const float* dt_s, int j0, int Q) {
  constexpr int E = VEC ? 4 : 1;
  constexpr int per_row = PW / E;
  for (int idx = threadIdx.x; idx < kT * per_row; idx += kThreads) {
    const int r = idx / per_row, col = (idx % per_row) * E;
    if (j0 + r >= Q) continue;  // zero-filled rows stay 0
    const float d = dt_s[j0 + r];
#pragma unroll
    for (int e = 0; e < E; ++e) tile[r * (PW + 8) + col + e] = __fmul_rn(tile[r * (PW + 8) + col + e], d);
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Grid (H·slabs, NC, B): block (h·slabs + s, c, b) computes columns
// [s·PW, (s + 1)·PW) of y and of the state of head h in chunk (b, c).
template <int PW, bool VEC>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Params p) {
  constexpr int SX = PW + 8;       // row stride of the x tile (≡ 8 mod 32)
  constexpr int NTY = PW / 16;     // y: 4 × 2 warps of 16 rows × PW/2 columns
  constexpr int NTS = PW / 8;      // state: 8 warps of 16 rows × PW columns
  const int h = blockIdx.x / p.slabs;
  const int p0 = (blockIdx.x - h * p.slabs) * PW;
  const int Q = p.Q, N = p.N, P = p.P, H = p.H;
  const int SN = bc_stride(N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cums_s = reinterpret_cast<double*>(smem_raw);                  // (Q,)
  float* c_s = reinterpret_cast<float*>(cums_s + round_up(Q, 2));        // (kT, SN) C rows, i tile
  float* b_s = c_s + kT * SN;               // (kT, SN)  B rows of the j tile
  float* x_s = b_s + kT * SN;               // (kT, SX)  dt·x of the j tile
  float* s_s = x_s + kT * SX;               // (kT, kPS) S ∘ L
  float* dt_s = s_s + kT * kPS;             // (Q,)
  float* dec_s = dt_s + round_up(Q, 4);     // (Q,)

  const long long chunk = (long long)blockIdx.z * p.NC + blockIdx.y;  // (b, c) index
  const float* xb = p.x + chunk * Q * H * P;
  const float* bb = p.b + chunk * Q * N;
  const float* cb = p.c + chunk * Q * N;

  copy_bc_tile<VEC>(c_s, cb, 0, Q, N, SN);
  copy_bc_tile<VEC>(b_s, bb, 0, Q, N, SN);
  copy_x_tile<PW, VEC>(x_s, xb, 0, Q, H, h, P, p0);
  if (warp == 0) {  // dt, the inclusive cumsum of dt·a (fp64) and the chunk-end decay
    const float a = p.a[p.a_rows ? (long long)blockIdx.z * H + h : h];
    double carry = 0.0;
    for (int j0 = 0; j0 < Q; j0 += 32) {
      const int j = j0 + lane;
      const float d = j < Q ? p.dt[(chunk * Q + j) * H + h] : 0.0f;
      double v = __fmul_rn(d, a);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = __dadd_rn(u, v);
      }
      v = __dadd_rn(carry, v);
      if (j < Q) {
        dt_s[j] = d;
        cums_s[j] = v;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();  // cums_s, written by this warp's lanes
    for (int j = lane; j < Q; j += 32) dec_s[j] = expf((float)__dsub_rn(cums_s[Q - 1], cums_s[j]));
  }
  __syncthreads();  // dt_s before the x tile is scaled

  int resident = -1;  // first row of the B and x tiles in shared memory
  const int n_tiles = (Q + kT - 1) / kT;
  for (int i0 = 0; i0 < Q; i0 += kT) {
    float acc_y[NTY][4];
    zero(acc_y);
    for (int j0 = 0; j0 <= i0; j0 += kT) {
      if (i0 > 0) {
        __syncthreads();  // every warp is done with the tiles it overwrites
        if (j0 == 0) copy_bc_tile<VEC>(c_s, cb, i0, Q, N, SN);
        if (resident != j0) {
          copy_bc_tile<VEC>(b_s, bb, j0, Q, N, SN);
          copy_x_tile<PW, VEC>(x_s, xb, j0, Q, H, h, P, p0);
        }
      }
      cp_async_wait_all();
      if (resident != j0) scale_x_tile<PW, VEC>(x_s, dt_s, j0, Q);
      resident = j0;
      __syncthreads();  // the tiles are in shared memory

      // S_ij = C_i B_jᵀ: warp (wm, wn) owns rows 16·wm, columns 32·wn.
      {
        float acc[4][4];
        zero(acc);
        const int r_lo = i0 + 16 * wm, c_lo = j0 + 32 * wn;
        if (r_lo < Q && c_lo < Q && c_lo <= r_lo + 15) {
          const float* ca = c_s + (16 * wm) * SN;
          const float* bw = b_s + (32 * wn) * SN;
          warp_mma<4>(acc, round_up(N, 8) / 8,
                      [&](int r, int k) { return ca[r * SN + k]; },
                      [&](int k, int n) { return bw[n * SN + k]; });
        }
        // S ∘ L, masked entries exactly 0
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * wm + g + 8 * (e >> 1), col = 32 * wn + 8 * nt + 2 * t + (e & 1);
            const int gi = i0 + r, gj = j0 + col;
            s_s[r * kPS + col] = gi < Q && gj <= gi
                                     ? __fmul_rn(acc[nt][e], expf((float)__dsub_rn(cums_s[gi], cums_s[gj])))
                                     : 0.0f;
          }
      }
      __syncthreads();  // S ∘ L is in shared memory

      // y_i += (S ∘ L)·xdt_j: warp (wm, wn) owns rows 16·wm, columns wn·PW/2.
      {
        const int r_lo = i0 + 16 * wm;
        const int kmax = min(kT, min(Q, r_lo + 16) - j0);
        if (r_lo < Q && kmax > 0) {
          const float* sa = s_s + (16 * wm) * kPS;
          const float* xw = x_s + wn * (PW / 2);
          warp_mma<NTY>(acc_y, (kmax + 7) / 8,
                        [&](int r, int k) { return sa[r * kPS + k]; },
                        [&](int k, int n) { return xw[k * SX + n]; });
        }
      }
    }
    // y rows of the i tile
#pragma unroll
    for (int nt = 0; nt < NTY; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + 16 * wm + g + 8 * half;
        const int q = p0 + wn * (PW / 2) + 8 * nt + 2 * t;
        if (i < Q)
          store_pair<VEC>(p.y + ((chunk * Q + i) * H + h) * P + q, acc_y[nt][2 * half],
                          acc_y[nt][2 * half + 1], P - q);
      }
  }

  // The chunk-end state, kStateRows rows a pass: state[n, q] = Σ_j
  // B[j, n]·dec_j·xdt[j, q].  Each pass walks the j tiles starting from the
  // one in shared memory.
  float* st = p.states + (chunk * H + h) * (long long)N * P;
  for (int n0 = 0; n0 < N; n0 += kStateRows) {
    float acc[NTS][4];
    zero(acc);
    const bool down = resident != 0;
    for (int step = 0; step < n_tiles; ++step) {
      const int j0 = (down ? n_tiles - 1 - step : step) * kT;
      if (resident != j0) {
        __syncthreads();
        copy_bc_tile<VEC>(b_s, bb, j0, Q, N, SN);
        copy_x_tile<PW, VEC>(x_s, xb, j0, Q, H, h, P, p0);
        cp_async_wait_all();
        scale_x_tile<PW, VEC>(x_s, dt_s, j0, Q);
        resident = j0;
        __syncthreads();
      }
      const int n_lo = n0 + 16 * warp;
      if (n_lo < N) {
        const float* ba = b_s + n_lo;
        const float* dj = dec_s + j0;
        warp_mma<NTS>(acc, (min(kT, Q - j0) + 7) / 8,
                      [&](int r, int k) { return j0 + k < Q ? __fmul_rn(ba[k * SN + r], dj[k]) : 0.0f; },
                      [&](int k, int n) { return x_s[k * SX + n]; });
      }
    }
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + 16 * warp + g + 8 * half;
        const int q = p0 + 8 * nt + 2 * t;
        if (n < N) store_pair<VEC>(st + (long long)n * P + q, acc[nt][2 * half], acc[nt][2 * half + 1], P - q);
      }
  }
}

template <int PW, bool VEC>
int launch(const Params& prm, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<PW, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(prm.H * prm.slabs, prm.NC, B);
  ssd_chunk_kernel<PW, VEC><<<grid, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <int PW>
int launch_pw(const Params& prm, int B, bool vec, cudaStream_t stream) {
  const size_t smem = smem_bytes<PW>(prm.Q, prm.N);
  if (smem > kMaxSmem) return -1;
  return vec ? launch<PW, true>(prm, B, smem, stream) : launch<PW, false>(prm, B, smem, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------
//
// The JAX package differentiates the jnp twin (src/repro/kernels/ops.py:127,
// the vjp of ref.jnp_ssd_chunk_intra).  Per chunk (b, c) and head h, with
// S = C Bᵀ, M = S ∘ L, u_j = dt_j·x_j, dec_j = exp(cums_{Q−1} − cums_j) and
// the output gradients dy (Q, P) and dst (N, P):
//
//   dM  = dy uᵀ                 dS = dM ∘ L         G = dS ∘ S
//   du  = Mᵀ dy + dec ∘ (B dst)                      dx = du ∘ dt
//   dC  = Σ_h dS B              dB = Σ_h dSᵀ C + Σ_h (dec ∘ u) dstᵀ
//   dcums_i = Σ_j G_ij − Σ_k G_ki − dec_i E_i + [i = Q−1] Σ_j dec_j E_j,
//             E_j = u_j · (B dst)_j
//   d(dt·a) = the reverse cumsum of dcums;  ddt = d(dt·a)·a + Σ_p du ∘ x;
//   da = Σ_{c, t} d(dt·a)·dt
//
// B and C are shared by the H heads of a row and a by its chunks, so dB,
// dC and da are sums across blocks.  Six kernels, launched in order on the
// stream, take them without atomics: every sum runs in a fixed order, so
// equal inputs give equal bits.
//   0. cums, a warp per (chunk, head), grid (⌈H/4⌉, B·NC): the fp64
//      inclusive cumsum of dt·a, dt and the chunk-end decay, each formed once
//      and written to the workspace as (chunk, head, row) vectors.
//   1. pairs, grid (tile pairs i ≥ j · head groups, B·NC): S of the 64 × 64
//      tile once (K = N), then for each head of its group dM (K = P), dS, G;
//      writes S, the group's Σ_h dS and G's row and column sums of the tile
//      (per head).
//   2. keys, grid (row tiles · H, B·NC): du of 64 rows of one head, Mᵀ dy
//      over the i tiles (S from the workspace, ∘ L) and B·dst (K = N);
//      writes dx, Σ_p du ∘ x and dec_j E_j.
//   3. bc, grid (row tiles · N slabs of 64, B·NC): dC and dB of a 64 × 64
//      tile from the groups' Σ_h dS and the state term over all heads
//      (K = H·P).
//   4. dt, one warp per (head, chunk): dcums from the partial sums, its
//      reverse cumsum in fp64, ddt, and the chunk's share of da (fp64).
//   5. da, a thread per entry of da: the chunks' shares summed in order.
//
// What bounds it: at the training shape (B 16, NC 8, Q 128, H 32, P 64,
// N 128) the function needs 13.3 G multiply-adds (operations, 0.40 ms at
// the fp32 peak) against 0.57 GB (0.17 ms).  The first design ran every
// product on the CUDA cores from shared memory (4.33 ms on the card, 10.9×
// its bound, PERF.md): shared-memory reads bound it, each tile came in by a
// synchronous load, and warp 0 formed the cumsum of each head while seven
// warps waited.  This design:
//   * Every product runs on the tensor cores, mma.sync m16n8k8 in 3xTF32 as
//     the forward's (split_tf32, a fresh fp32 partial per k step of 8), in
//     steps of one 64 × 64 output tile by a depth of 64: four warps, each a
//     32 × 32 quarter (two 16-row by four 8-column fragments), so a warp
//     splits 8 A and 8 B values for 24 products a k step, where the
//     forward's 16 × 32 warp tiles split 4 and 8 for 12.  Both state-term
//     products (B·dst and (dec ∘ u)·dstᵀ, ~60% of the work) and every other
//     product take this shape; a K past 64 (N, P or H·P) is more steps.
//   * Each kernel walks its steps through two stages of shared memory
//     (run_steps): step s + 1's tiles come in by cp.async (16-byte copies on
//     aligned rows whose width is a multiple of 4, else 4-byte; rows and
//     columns past the matrix zero-filled) while step s computes.  No tile
//     is loaded synchronously.  Fragments are read with row strides ≡ 4 mod
//     32 for (row, k) reads and ≡ 8 for (k, row) reads, so a warp's 32 reads
//     fall in 32 banks.  A stage is two 64-row tiles; a block holds about
//     74 KB, three to an SM.
//   * The cumsum and the decays are formed once per (chunk, head) by kernel
//     0, whose four warps scan four heads at once; the other kernels copy
//     the vectors they need with their tiles.  L and dec stay exp of fp64
//     differences rounded once to fp32, and a masked entry (i < j) is set to
//     0, never exponentiated.
//   * Enough blocks: the pairs kernel splits its heads into groups until
//     its grid reaches kBwdMinBlocks (bwd_plan; the bc kernel sums the
//     groups' Σ_h dS in order); the bc kernel's rows are split by N slabs.
//     At the training shape the grids are 1,024, 384, 8,192, 512, 4,096
//     and 4 blocks.  The three product kernels cap their registers at 168
//     a thread (kBwdBlocksPerSM): three blocks to an SM ran faster than
//     two at 226–255 registers, despite a few spilled values.
// The workspace holds S and each head group's Σ_h dS (B·NC·Q² each), G's
// partial sums (2·B·NC·H·⌈Q/64⌉·Q), two (B·NC·Q·H) vectors, dt and the
// decay (B·NC·H·Q each), the fp64 cumsum and the chunks' fp64 shares of
// da: 37.8 MB at the training shape.

constexpr int kBT = 64;                   // rows of a backward tile, and the depth of one step
constexpr int kBThreads = 128;            // four warps, each a 32 × 32 quarter of a tile
constexpr int kSR = kBT + 4;              // tile row stride for (row, k) reads, ≡ 4 mod 32
constexpr int kSK = kBT + 8;              // tile row stride for (k, row) reads, ≡ 8 mod 32
constexpr long long kBwdMinBlocks = 264;  // the head-group rule's aim: two blocks per SM
constexpr int kBwdBlocksPerSM = 3;        // registers capped at 168 a thread so three fit

struct BwdParams {
  const float *x, *dt, *a, *b, *c, *dy, *dst;
  float *dx, *ddt, *da, *db, *dc;
  float *s_mat, *dss, *rowg, *colg, *dux, *ed, *dtv, *dec;   // workspace
  double *cums, *da_part;                                    // workspace
  int B, NC, Q, H, P, N, a_rows;
  int nt, hg, hpg;   // row tiles; head groups of the pairs kernel, heads per group
  int vec_bc, vec_xp, vec_q;   // 16-byte copies of B and C; x, dy, dstates; Q-wide rows
};

struct BwdPlan {
  int nt, npairs, hg, hpg, nslabs;
};

// The tile and grid rule: row tiles of kBT, tile pairs i ≥ j, N in slabs of
// kBT, and the heads of the pairs kernel in hg groups of hpg: hg starts
// from the smallest power of two (doubling stops at H) whose pairs grid
// reaches kBwdMinBlocks, then hpg = ⌈H / hg⌉ and hg = ⌈H / hpg⌉, so no
// group is empty.
BwdPlan bwd_plan(int B, int NC, int Q, int H, int N) {
  BwdPlan pl;
  pl.nt = (Q + kBT - 1) / kBT;
  pl.npairs = pl.nt * (pl.nt + 1) / 2;
  pl.nslabs = (N + kBT - 1) / kBT;
  const long long base = (long long)pl.npairs * B * NC;
  int hg = 1;
  while (hg < H && base * hg < kBwdMinBlocks) hg *= 2;
  pl.hpg = H > 0 ? (H + hg - 1) / hg : 1;
  pl.hg = H > 0 ? (H + pl.hpg - 1) / pl.hpg : 1;
  return pl;
}

// Workspace floats, in the order of BwdParams (the fp64 parts last).
long long ws_sizes(int B, int NC, int Q, int H, long long (&sz)[10]) {
  const BwdPlan pl = bwd_plan(B, NC, Q, H, 1);
  const long long bnc = (long long)B * NC;
  sz[0] = bnc * Q * Q;
  sz[1] = pl.hg * bnc * Q * Q;
  sz[2] = sz[3] = bnc * H * pl.nt * Q;
  sz[4] = sz[5] = bnc * Q * H;
  sz[6] = sz[7] = bnc * H * Q;
  sz[8] = 2 * bnc * H * Q;
  sz[9] = 2 * bnc * H;
  long long total = 0;
  for (long long v : sz) total += (v + 63) / 64 * 64;   // each part 256-byte aligned
  return total;
}

__device__ __forceinline__ void copy_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Every copy group of this thread but the newest has landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + kBT) and columns [c0, c0 + kBT) of a row-major matrix of
// rows × cols (row stride ld) into a kBT-row tile of row stride sst; entries
// outside the matrix become 0.  vec: 16-byte copies (cols, ld, c0 and the
// pointer's offset multiples of 4 floats, the matrix 16-byte aligned).
__device__ __forceinline__ void copy_tile(float* dst, int sst, const float* src, long long ld,
                                          int r0, int rows, int c0, int cols, int vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kBT * kBT / 4; idx += kBThreads) {
      const int r = idx / (kBT / 4), cc = idx % (kBT / 4) * 4;
      const bool ok = r0 + r < rows && c0 + cc < cols;
      copy_async<true>(dst + r * sst + cc, ok ? src + (long long)(r0 + r) * ld + c0 + cc : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBT * kBT; idx += kBThreads) {
      const int r = idx / kBT, cc = idx % kBT;
      const bool ok = r0 + r < rows && c0 + cc < cols;
      copy_async<false>(dst + r * sst + cc, ok ? src + (long long)(r0 + r) * ld + c0 + cc : src, ok);
    }
  }
}

// v[i] = src[i0 + i] for i < kBT where i0 + i < n, else 0.
__device__ __forceinline__ void copy_vec(float* v, const float* src, int i0, int n) {
  for (int i = threadIdx.x; i < kBT; i += kBThreads) {
    const bool ok = i0 + i < n;
    copy_async<false>(v + i, ok ? src + i0 + i : src, ok);
  }
}

__device__ __forceinline__ void copy_vec(double* v, const double* src, int i0, int n) {
  for (int i = threadIdx.x; i < kBT; i += kBThreads) {
    const bool ok = i0 + i < n;
    copy_async8(v + i, ok ? src + i0 + i : src, ok);
  }
}

// The step pipeline every product kernel of the backward walks: step s + 1's
// tiles are copied into stage (s + 1) % 2 by `fetch` while step s computes
// from stage s % 2; `compute` runs once step s's copies have landed and
// every thread of the block can see them.
template <typename Fetch, typename Compute>
__device__ __forceinline__ void run_steps(int steps, Fetch fetch, Compute compute) {
  if (steps > 0) fetch(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    __syncthreads();   // step s − 1 is done with the stage step s + 1 fills
    if (s + 1 < steps) fetch(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait_prior();   // this thread's copies of step s have landed
    __syncthreads();         // ... and every thread's
    compute(s, s & 1);
  }
}

// The warp's row of accumulator fragment (mt, hf): 16·mt + 8·hf + lane / 4.
__device__ __forceinline__ int frag_row(int mt, int hf) {
  return 16 * mt + 8 * hf + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

// One warp: acc (32 × 32) += A (32 × kBT) · B (kBT × 32) in 3xTF32, as
// warp_mma does it.  la(mt, hf, k) reads A at the warp's row frag_row(mt,
// hf) and column k, lb(k, n) reads B.  Accumulator element (mt, nt, e)
// sits at row frag_row(mt, e / 2), column 8·nt + 2·(lane % 4) + e % 2.
// UNROLL k steps of 8 are unrolled together (the pairs kernel, which holds
// three accumulators, ran faster with 1).
template <int UNROLL = 2, typename LoadA, typename LoadB>
__device__ __forceinline__ void mma_tile(float (&acc)[2][4][4], LoadA la, LoadB lb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto kstep = [&](int k) {
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      split_tf32(la(mt, 0, k + t), ahi[mt][0], alo[mt][0]);
      split_tf32(la(mt, 1, k + t), ahi[mt][1], alo[mt][1]);
      split_tf32(la(mt, 0, k + t + 4), ahi[mt][2], alo[mt][2]);
      split_tf32(la(mt, 1, k + t + 4), ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bhi0, blo0, bhi1, blo1;
      split_tf32(lb(k + t, 8 * nt + g), bhi0, blo0);
      split_tf32(lb(k + t + 4, 8 * nt + g), bhi1, blo1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(part, alo[mt], bhi0, bhi1);
        mma_tf32(part, ahi[mt], blo0, blo1);
        mma_tf32(part, ahi[mt], bhi0, bhi1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[e]);
      }
    }
  };
  if constexpr (UNROLL == 1) {
#pragma unroll 1
    for (int k = 0; k < kBT; k += 8) kstep(k);
  } else {
#pragma unroll 2
    for (int k = 0; k < kBT; k += 8) kstep(k);
  }
}

__device__ __forceinline__ float decay(double ci, double cj) { return expf((float)__dsub_rn(ci, cj)); }

// 0. Grid (⌈H / 4⌉, B·NC), a warp per head: the inclusive fp64 cumsum of
// dt·a over the chunk as the forward forms it, dt, and the chunk-end decay.
__global__ void __launch_bounds__(kBThreads) ssd_bwd_cums_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, lane = threadIdx.x & 31;
  const int h = blockIdx.x * (kBThreads / 32) + (threadIdx.x >> 5);
  if (h >= H) return;
  const long long chunk = blockIdx.y;
  const int b = (int)(chunk / p.NC);
  const float a = p.a[p.a_rows ? (long long)b * H + h : h];
  const long long row = (chunk * H + h) * Q;
  double carry = 0.0;
  for (int j0 = 0; j0 < Q; j0 += 32) {
    const int j = j0 + lane;
    const float d = j < Q ? p.dt[(chunk * Q + j) * H + h] : 0.0f;
    double v = __fmul_rn(d, a);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v = __dadd_rn(u, v);
    }
    v = __dadd_rn(carry, v);
    if (j < Q) {
      p.cums[row + j] = v;
      p.dtv[row + j] = d;
    }
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  // carry is cums_{Q−1}; each lane reads back the entries it wrote
  for (int j = lane; j < Q; j += 32) p.dec[row + j] = decay(carry, p.cums[row + j]);
}

// 1. Grid (tile pairs · hg, B·NC): block (pair·hg + group, chunk), pair
// it·(it + 1)/2 + jt with jt ≤ it.  Steps: ⌈N/64⌉ of S = C_i B_jᵀ, then for
// each head of the group ⌈P/64⌉ of dM = dy_i x_jᵀ (dt_j is applied to dM's
// columns), the last of which turns dM into dS and G.
__global__ void __launch_bounds__(kBThreads, kBwdBlocksPerSM) ssd_bwd_pairs_mma_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, P = p.P, N = p.N;
  const int pair = blockIdx.x / p.hg, grp = blockIdx.x - pair * p.hg;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  const int jt = pair - it * (it + 1) / 2;
  const int i0 = it * kBT, j0 = jt * kBT;
  const int h_lo = grp * p.hpg, heads = min(H, h_lo + p.hpg) - h_lo;
  const long long chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;   // the warp's rows 32·wm, columns 32·wn

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cij = reinterpret_cast<double*>(smem_raw);       // (stage, i or j) cums of the tile's rows
  float* tiles = reinterpret_cast<float*>(cij + 4 * kBT);  // (stage, A or B) kBT × kSR
  float* dtj = tiles + 4 * kBT * kSR;                      // (stage) dt of the j rows
  float* red = dtj + 2 * kBT;                              // row sums by wn, column sums by wm

  const float* cb = p.c + chunk * Q * N;
  const float* bb = p.b + chunk * Q * N;
  const float* xb = p.x + chunk * Q * H * P;
  const float* yb = p.dy + chunk * Q * H * P;
  const long long ld = (long long)H * P;
  const int ks = (N + kBT - 1) / kBT, kp = (P + kBT - 1) / kBT;
  float s_acc[2][4][4], dss[2][4][4], dm[2][4][4];
  zero(s_acc);
  zero(dss);
  zero(dm);

  auto fetch = [&](int step, int st) {
    float* ta = tiles + st * 2 * kBT * kSR;
    float* tb = ta + kBT * kSR;
    if (step < ks) {
      copy_tile(ta, kSR, cb, N, i0, Q, step * kBT, N, p.vec_bc);
      copy_tile(tb, kSR, bb, N, j0, Q, step * kBT, N, p.vec_bc);
      return;
    }
    const int hh = (step - ks) / kp, pc = step - ks - hh * kp, h = h_lo + hh;
    copy_tile(ta, kSR, yb + h * P, ld, i0, Q, pc * kBT, P, p.vec_xp);
    copy_tile(tb, kSR, xb + h * P, ld, j0, Q, pc * kBT, P, p.vec_xp);
    if (pc == kp - 1) {
      const long long row = (chunk * H + h) * Q;
      copy_vec(cij + st * 2 * kBT, p.cums + row, i0, Q);
      copy_vec(cij + st * 2 * kBT + kBT, p.cums + row, j0, Q);
      copy_vec(dtj + st * kBT, p.dtv + row, j0, Q);
    }
  };

  auto compute = [&](int step, int st) {
    const float* wa = tiles + st * 2 * kBT * kSR + (32 * wm) * kSR;
    const float* wb = tiles + st * 2 * kBT * kSR + kBT * kSR + (32 * wn) * kSR;
    auto la = [&](int mt, int hf, int k) { return wa[frag_row(mt, hf) * kSR + k]; };
    auto lb = [&](int k, int n) { return wb[n * kSR + k]; };
    if (step < ks) {
      mma_tile<1>(s_acc, la, lb);
      return;
    }
    const int hh = (step - ks) / kp, pc = step - ks - hh * kp, h = h_lo + hh;
    if (pc == 0) zero(dm);
    mma_tile<1>(dm, la, lb);
    if (pc < kp - 1) return;
    const double* ci = cij + st * 2 * kBT;
    const double* cj = ci + kBT;
    const float* dtjs = dtj + st * kBT;
    float rowp[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    float colp[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * wm + frag_row(mt, e >> 1), cc = 32 * wn + 8 * nt + 2 * t + (e & 1);
          const int i = i0 + r, j = j0 + cc;
          float gv = 0.0f;
          if (i < Q && j <= i) {
            const float ds = __fmul_rn(__fmul_rn(dm[mt][nt][e], dtjs[cc]), decay(ci[r], cj[cc]));
            dss[mt][nt][e] = __fadd_rn(dss[mt][nt][e], ds);
            gv = __fmul_rn(ds, s_acc[mt][nt][e]);
          }
          rowp[mt][e >> 1] = __fadd_rn(rowp[mt][e >> 1], gv);
          colp[nt][e & 1] = __fadd_rn(colp[nt][e & 1], gv);
        }
    // G's row sums over the quad's four lanes, column sums over the eight quads
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v = rowp[mt][hf];
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
        rowp[mt][hf] = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colp[nt][e];
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
        colp[nt][e] = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
      }
    if (t == 0)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) red[wn * kBT + 32 * wm + frag_row(mt, hf)] = rowp[mt][hf];
    if (g == 0)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) red[2 * kBT + wm * kBT + 32 * wn + 8 * nt + 2 * t + e] = colp[nt][e];
    __syncthreads();
    const long long part = (chunk * H + h) * p.nt;
    if (threadIdx.x < kBT) {   // this tile's share of Σ_j G_ij
      const int r = threadIdx.x;
      if (i0 + r < Q) p.rowg[(part + jt) * Q + i0 + r] = __fadd_rn(red[r], red[kBT + r]);
    } else {                   // Σ_i G_ij
      const int cc = threadIdx.x - kBT;
      if (j0 + cc < Q) p.colg[(part + it) * Q + j0 + cc] = __fadd_rn(red[2 * kBT + cc], red[3 * kBT + cc]);
    }
  };

  run_steps(ks + heads * kp, fetch, compute);

  float* dsg = p.dss + ((long long)grp * p.B * p.NC + chunk) * Q * Q;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 32 * wm + frag_row(mt, e >> 1), j = j0 + 32 * wn + 8 * nt + 2 * t + (e & 1);
        if (i < Q && j < Q) {
          if (grp == 0) p.s_mat[(chunk * Q + i) * Q + j] = s_acc[mt][nt][e];
          dsg[(long long)i * Q + j] = dss[mt][nt][e];
        }
      }
}

// 2. Grid (nt · H, B·NC): block (h·nt + jt, chunk), du of rows [j0, j0 + 64)
// of head h, P in passes of 64 columns.  A pass's steps: for each i tile ≥
// jt, M_ij = S_ij ∘ L in place, then du += M_ijᵀ dy_i; then ⌈N/64⌉ steps of
// bt = B_j dst_h; its last step writes dx and adds the row sums Σ_p du ∘ x
// and Σ_p x ∘ bt.
__global__ void __launch_bounds__(kBThreads, kBwdBlocksPerSM) ssd_bwd_keys_mma_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, P = p.P, N = p.N;
  const int jt = blockIdx.x % p.nt, h = blockIdx.x / p.nt, j0 = jt * kBT;
  const long long chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ci = reinterpret_cast<double*>(smem_raw);      // (stage) cums of the i rows
  double* cj = ci + 2 * kBT;                              // cums of the j rows
  float* tiles = reinterpret_cast<float*>(cj + kBT);      // (stage, A or B) kBT × kSK
  float* dtj = tiles + 4 * kBT * kSK;                     // dt of the j rows
  float* decj = dtj + kBT;                                // dec of the j rows

  const long long row = (chunk * H + h) * Q;
  copy_vec(cj, p.cums + row, j0, Q);   // these join step 0's copies
  copy_vec(dtj, p.dtv + row, j0, Q);
  copy_vec(decj, p.dec + row, j0, Q);
  const float* sb = p.s_mat + chunk * Q * Q;
  const float* yb = p.dy + chunk * Q * H * P + h * P;
  const float* bb = p.b + chunk * Q * N;
  const float* tb = p.dst + (chunk * H + h) * (long long)N * P;
  const long long ld = (long long)H * P;
  const int ni = p.nt - jt, per_pass = ni + (N + kBT - 1) / kBT, passes = (P + kBT - 1) / kBT;
  float du[2][4][4], bt[2][4][4];
  float pd[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, pe[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  auto fetch = [&](int step, int st) {
    const int pass = step / per_pass, k = step - pass * per_pass, p0 = pass * kBT;
    float* ta = tiles + st * 2 * kBT * kSK;
    float* tbuf = ta + kBT * kSK;
    if (k < ni) {
      const int i0 = (jt + k) * kBT;
      copy_tile(ta, kSK, sb, Q, i0, Q, j0, Q, p.vec_q);
      copy_tile(tbuf, kSK, yb, ld, i0, Q, p0, P, p.vec_xp);
      copy_vec(ci + st * kBT, p.cums + row, i0, Q);
    } else {
      const int n0 = (k - ni) * kBT;
      copy_tile(ta, kSR, bb, N, j0, Q, n0, N, p.vec_bc);
      copy_tile(tbuf, kSK, tb, P, n0, N, p0, P, p.vec_xp);
    }
  };

  auto compute = [&](int step, int st) {
    const int pass = step / per_pass, k = step - pass * per_pass, p0 = pass * kBT;
    float* ta = tiles + st * 2 * kBT * kSK;
    const float* tbuf = ta + kBT * kSK;
    auto lb = [&](int kk, int n) { return tbuf[kk * kSK + 32 * wn + n]; };
    if (k == 0) {
      zero(du);
      zero(bt);
    }
    if (k < ni) {
      const int i0 = (jt + k) * kBT;
      const double* cis = ci + st * kBT;
      for (int idx = threadIdx.x; idx < kBT * kBT; idx += kBThreads) {   // M = S ∘ L
        const int r = idx / kBT, cc = idx % kBT, i = i0 + r, j = j0 + cc;
        float* m = ta + r * kSK + cc;
        *m = i < Q && j <= i ? __fmul_rn(*m, decay(cis[r], cj[cc])) : 0.0f;
      }
      __syncthreads();
      mma_tile(du, [&](int mt, int hf, int kk) { return ta[kk * kSK + 32 * wm + frag_row(mt, hf)]; }, lb);
    } else {
      mma_tile(bt, [&](int mt, int hf, int kk) { return ta[(32 * wm + frag_row(mt, hf)) * kSR + kk]; }, lb);
    }
    if (k < per_pass - 1) return;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 32 * wm + frag_row(mt, e >> 1), j = j0 + r;
          const int pc = p0 + 32 * wn + 8 * nt + 2 * t + (e & 1);
          if (j >= Q || pc >= P) continue;
          const long long at = ((chunk * Q + j) * H + h) * P + pc;
          const float xv = p.x[at];
          const float duv = __fadd_rn(du[mt][nt][e], __fmul_rn(decj[r], bt[mt][nt][e]));
          p.dx[at] = __fmul_rn(duv, dtj[r]);
          pd[mt][e >> 1] = __fadd_rn(pd[mt][e >> 1], __fmul_rn(duv, xv));
          pe[mt][e >> 1] = __fadd_rn(pe[mt][e >> 1], __fmul_rn(xv, bt[mt][nt][e]));
        }
  };

  const int steps = passes * per_pass;
  run_steps(steps, fetch, compute);

  // The row sums over the quad's four lanes, then over the two column halves;
  // red is the stage no step reads any more.
  float* red = tiles + (steps & 1) * 2 * kBT * kSK;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float d = pd[mt][hf], v = pe[mt][hf];
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 1));
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 2));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) {
        const int r = 32 * wm + frag_row(mt, hf);
        red[wn * kBT + r] = d;
        red[(2 + wn) * kBT + r] = v;
      }
    }
  __syncthreads();
  if (threadIdx.x < kBT) {
    const int r = threadIdx.x, j = j0 + r;
    if (j < Q) {
      const long long e = (chunk * Q + j) * H + h;
      p.dux[e] = __fadd_rn(red[r], red[kBT + r]);
      p.ed[e] = __fmul_rn(__fmul_rn(__fadd_rn(red[2 * kBT + r], red[3 * kBT + r]), dtj[r]), decj[r]);
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 3. Grid (nt · ⌈N/64⌉, B·NC): block (rt·slabs + slab, chunk), dC and dB of
// rows [r0, r0 + 64) and columns [n0, n0 + 64).  Steps: for each head
// group, dC += dss_g[r, j]·B[j, n] over the j tiles ≤ rt; then dB +=
// dss_g[i, r]·C[i, n] over the i tiles ≥ rt; then for each head and each 64
// columns of P, dB += (dec·dt)_r x[r, h, p]·dst[h, n, p].
__global__ void __launch_bounds__(kBThreads, kBwdBlocksPerSM) ssd_bwd_bc_mma_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, P = p.P, N = p.N, nt = p.nt;
  const int slabs = (N + kBT - 1) / kBT;
  const int rt = blockIdx.x / slabs, r0 = rt * kBT, n0 = (blockIdx.x - rt * slabs) * kBT;
  const long long chunk = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);   // (stage, A or B) kBT × kSK
  float* vdec = tiles + 4 * kBT * kSK;                  // (stage) dec of the step's head, rows r
  float* vdt = vdec + 2 * kBT;                          // (stage) dt

  const long long bnc = (long long)p.B * p.NC;
  const float* bb = p.b + chunk * Q * N;
  const float* cb = p.c + chunk * Q * N;
  const float* xb = p.x + chunk * Q * H * P;
  const long long ld = (long long)H * P;
  const int kp = (P + kBT - 1) / kBT;
  const int n1 = p.hg * (rt + 1), n2 = p.hg * (nt - rt);
  float acc_c[2][4][4], acc_b[2][4][4];
  zero(acc_c);
  zero(acc_b);

  auto fetch = [&](int step, int st) {
    float* ta = tiles + st * 2 * kBT * kSK;
    float* tbuf = ta + kBT * kSK;
    if (step < n1) {
      const int grp = step / (rt + 1), jt = step - grp * (rt + 1);
      const float* dsg = p.dss + (grp * bnc + chunk) * Q * Q;
      copy_tile(ta, kSR, dsg, Q, r0, Q, jt * kBT, Q, p.vec_q);
      copy_tile(tbuf, kSK, bb, N, jt * kBT, Q, n0, N, p.vec_bc);
    } else if (step < n1 + n2) {
      const int s2 = step - n1, grp = s2 / (nt - rt), it = rt + s2 - grp * (nt - rt);
      const float* dsg = p.dss + (grp * bnc + chunk) * Q * Q;
      copy_tile(ta, kSK, dsg, Q, it * kBT, Q, r0, Q, p.vec_q);
      copy_tile(tbuf, kSK, cb, N, it * kBT, Q, n0, N, p.vec_bc);
    } else {
      const int s3 = step - n1 - n2, h = s3 / kp, pc = s3 - h * kp;
      copy_tile(ta, kSR, xb + h * P, ld, r0, Q, pc * kBT, P, p.vec_xp);
      copy_tile(tbuf, kSR, p.dst + (chunk * H + h) * (long long)N * P, P, n0, N, pc * kBT, P,
                p.vec_xp);
      copy_vec(vdec + st * kBT, p.dec + (chunk * H + h) * Q, r0, Q);
      copy_vec(vdt + st * kBT, p.dtv + (chunk * H + h) * Q, r0, Q);
    }
  };

  auto compute = [&](int step, int st) {
    const float* ta = tiles + st * 2 * kBT * kSK;
    const float* tbuf = ta + kBT * kSK;
    if (step < n1) {
      mma_tile(acc_c, [&](int mt, int hf, int k) { return ta[(32 * wm + frag_row(mt, hf)) * kSR + k]; },
               [&](int k, int n) { return tbuf[k * kSK + 32 * wn + n]; });
    } else if (step < n1 + n2) {
      mma_tile(acc_b, [&](int mt, int hf, int k) { return ta[k * kSK + 32 * wm + frag_row(mt, hf)]; },
               [&](int k, int n) { return tbuf[k * kSK + 32 * wn + n]; });
    } else {
      float rs[2][2];   // (dec·dt) of the warp's A rows
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 32 * wm + frag_row(mt, hf);
          rs[mt][hf] = __fmul_rn(vdec[st * kBT + r], vdt[st * kBT + r]);
        }
      mma_tile(acc_b,
               [&](int mt, int hf, int k) {
                 return __fmul_rn(ta[(32 * wm + frag_row(mt, hf)) * kSR + k], rs[mt][hf]);
               },
               [&](int k, int n) { return tbuf[(32 * wn + n) * kSR + k]; });
    }
  };

  run_steps(n1 + n2 + H * kp, fetch, compute);

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt4 = 0; nt4 < 4; ++nt4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 32 * wm + frag_row(mt, e >> 1), n = n0 + 32 * wn + 8 * nt4 + 2 * t + (e & 1);
        if (r < Q && n < N) {
          p.dc[(chunk * Q + r) * N + n] = acc_c[mt][nt4][e];
          p.db[(chunk * Q + r) * N + n] = acc_b[mt][nt4][e];
        }
      }
}

// 4. Grid (H, B·NC), one warp per (head, chunk): dcums from the partial
// sums, its reverse cumsum in fp64, ddt, and the chunk's share of da as an
// fp64 sum.
__global__ void __launch_bounds__(32) ssd_bwd_dt_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, h = blockIdx.x, lane = threadIdx.x;
  const long long chunk = blockIdx.y;
  const int b = (int)(chunk / p.NC);
  const float a = p.a[p.a_rows ? (long long)b * H + h : h];
  const long long part = (chunk * H + h) * p.nt;
  double sed = 0.0;
  for (int i = lane; i < Q; i += 32) sed = __dadd_rn(sed, (double)p.ed[(chunk * Q + i) * H + h]);
  sed = warp_sum(sed);
  double carry = 0.0, da_acc = 0.0;   // carry: Σ dcums over the rows after this group of 32
  for (int base = (Q - 1) / 32 * 32; base >= 0; base -= 32) {
    const int i = base + lane;
    double v = 0.0;
    if (i < Q) {
      const int ti = i / kBT;
      double rs = 0.0, cs = 0.0;
      for (int t = 0; t <= ti; ++t) rs = __dadd_rn(rs, (double)p.rowg[(part + t) * Q + i]);
      for (int t = ti; t < p.nt; ++t) cs = __dadd_rn(cs, (double)p.colg[(part + t) * Q + i]);
      v = rs - cs - (double)p.ed[(chunk * Q + i) * H + h] + (i == Q - 1 ? sed : 0.0);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {   // reverse inclusive scan
      const double u = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < 32) v = __dadd_rn(v, u);
    }
    v = __dadd_rn(v, carry);
    carry = __shfl_sync(0xffffffffu, v, 0);
    if (i < Q) {
      const long long e = (chunk * Q + i) * H + h;
      const float dda = (float)v;
      p.ddt[e] = __fadd_rn(__fmul_rn(dda, a), p.dux[e]);
      da_acc = __dadd_rn(da_acc, (double)dda * (double)p.dt[e]);
    }
  }
  da_acc = warp_sum(da_acc);
  if (lane == 0) p.da_part[chunk * H + h] = da_acc;
}

// 5. One thread per entry of da ((B, H) or (H,)): the chunks' shares in
// order of (row, chunk), in fp64.
__global__ void __launch_bounds__(kBThreads) ssd_bwd_da_kernel(BwdParams p) {
  const int H = p.H, o = blockIdx.x * kBThreads + threadIdx.x;
  if (o >= (p.a_rows ? p.B : 1) * H) return;
  const int h = o % H;
  const long long c_lo = p.a_rows ? (long long)(o / H) * p.NC : 0;
  const long long c_hi = p.a_rows ? c_lo + p.NC : (long long)p.B * p.NC;
  double total = 0.0;
  for (long long chunk = c_lo; chunk < c_hi; ++chunk) total = __dadd_rn(total, p.da_part[chunk * H + h]);
  p.da[o] = (float)total;
}

constexpr size_t kSmemPairs = sizeof(double) * 4 * kBT + sizeof(float) * (4 * kBT * kSR + 2 * kBT + 4 * kBT);
constexpr size_t kSmemKeys = sizeof(double) * 3 * kBT + sizeof(float) * (4 * kBT * kSK + 2 * kBT);
constexpr size_t kSmemBc = sizeof(float) * (4 * kBT * kSK + 4 * kBT);

template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, int threads, size_t smem, const BwdParams& prm,
               cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or -1 for arguments the kernel does
// not take (a shared-memory footprint above a block's 227 KB included).
int ssd_chunk(const float* x, const float* dt, const float* a, const float* b, const float* c,
              float* y, float* states, int B, int NC, int Q, int H, int P, int N, int a_rows,
              void* stream) {
  if (B < 0 || NC < 0 || Q < 1 || H < 0 || P < 1 || N < 1 || NC > 65535 || B > 65535)
    return -1;
  if (B == 0 || NC == 0 || H == 0) return 0;
  // The slab rule: the widest slab whose grid still reaches kMinBlocks.
  const long long heads = (long long)B * NC * H;
  int pw = 16;
  if (heads * ((P + 63) / 64) >= kMinBlocks) pw = 64;
  else if (heads * ((P + 31) / 32) >= kMinBlocks) pw = 32;
  const int slabs = (P + pw - 1) / pw;
  if ((long long)H * slabs > 0x7fffffffLL) return -1;
  const bool vec = N % 4 == 0 && P % 4 == 0 && aligned16(x) && aligned16(b) && aligned16(c) &&
                   aligned16(y) && aligned16(states);
  const Params prm{x, dt, a, b, c, y, states, NC, Q, H, P, N, slabs, a_rows ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pw == 64) return launch_pw<64>(prm, B, vec, s);
  if (pw == 32) return launch_pw<32>(prm, B, vec, s);
  return launch_pw<16>(prm, B, vec, s);
}

// Bytes of the workspace ssd_chunk_bwd needs.
long long ssd_chunk_bwd_workspace(int B, int NC, int Q, int H) {
  if (B < 0 || NC < 0 || Q < 1 || H < 0) return -1;
  long long sz[10];
  return ws_sizes(B, NC, Q, H, sz) * (long long)sizeof(float);
}

// The backward's tile and grid rule (bwd_plan) at a shape, into out[9]: the
// tile rows, the pairs kernel's head groups and heads per group, then the
// blocks of the cums, pairs, keys, bc, dt and da grids.  Returns 0, or -1 for
// a shape ssd_chunk_bwd does not take.
int ssd_chunk_bwd_plan(int B, int NC, int Q, int H, int P, int N, int a_rows, int* out) {
  if (B < 1 || NC < 1 || Q < 1 || H < 1 || P < 1 || N < 1 || (long long)B * NC > 65535) return -1;
  const BwdPlan pl = bwd_plan(B, NC, Q, H, N);
  const int bnc = B * NC;
  const long long grids[6] = {(long long)(H + 3) / 4 * bnc, (long long)pl.npairs * pl.hg * bnc,
                              (long long)pl.nt * H * bnc, (long long)pl.nt * pl.nslabs * bnc,
                              (long long)H * bnc,
                              ((long long)(a_rows ? B : 1) * H + kBThreads - 1) / kBThreads};
  out[0] = kBT;
  out[1] = pl.hg;
  out[2] = pl.hpg;
  for (int k = 0; k < 6; ++k) {
    if (grids[k] > 0x7fffffffLL) return -1;
    out[3 + k] = (int)grids[k];
  }
  return 0;
}

// The backward: dx, ddt, da (a's shape), db, dc from the forward's inputs and
// the gradients dy (B, NC, Q, H, P) and dst (B, NC, H, N, P); `work` holds
// ssd_chunk_bwd_workspace bytes.  Returns a cudaError_t (0 on success), or
// -1 for arguments the kernels do not take (B·NC above 65,535, a grid's
// row of blocks past 2^31 − 1).
int ssd_chunk_bwd(const float* x, const float* dt, const float* a, const float* b, const float* c,
                  const float* dy, const float* dst, float* dx, float* ddt, float* da, float* db,
                  float* dc, float* work, int B, int NC, int Q, int H, int P, int N, int a_rows,
                  void* stream) {
  if (B < 0 || NC < 0 || Q < 1 || H < 0 || P < 1 || N < 1 || (long long)B * NC > 65535 ||
      B > 65535)
    return -1;
  if (B == 0 || NC == 0 || H == 0) return 0;
  const BwdPlan pl = bwd_plan(B, NC, Q, H, N);
  if ((long long)pl.nt * H > 0x7fffffffLL || (long long)pl.npairs * pl.hg > 0x7fffffffLL) return -1;
  long long sz[10];
  ws_sizes(B, NC, Q, H, sz);
  float* ws[10];
  float* at = work;
  for (int k = 0; k < 10; ++k) {
    ws[k] = at;
    at += (sz[k] + 63) / 64 * 64;
  }
  const int vec_bc = N % 4 == 0 && aligned16(b) && aligned16(c);
  const int vec_xp = P % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dst);
  const BwdParams prm{x, dt, a, b, c, dy, dst, dx, ddt, da, db, dc,
                      ws[0], ws[1], ws[2], ws[3], ws[4], ws[5], ws[6], ws[7],
                      reinterpret_cast<double*>(ws[8]), reinterpret_cast<double*>(ws[9]),
                      B, NC, Q, H, P, N, a_rows ? 1 : 0, pl.nt, pl.hg, pl.hpg,
                      vec_bc, vec_xp, Q % 4 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned bnc = (unsigned)(B * NC);
  int err = launch_bwd(ssd_bwd_cums_kernel, dim3((H + 3) / 4, bnc), kBThreads, 0, prm, s);
  if (err) return err;
  err = launch_bwd(ssd_bwd_pairs_mma_kernel, dim3(pl.npairs * pl.hg, bnc), kBThreads, kSmemPairs,
                   prm, s);
  if (err) return err;
  err = launch_bwd(ssd_bwd_keys_mma_kernel, dim3(pl.nt * H, bnc), kBThreads, kSmemKeys, prm, s);
  if (err) return err;
  err = launch_bwd(ssd_bwd_bc_mma_kernel, dim3(pl.nt * pl.nslabs, bnc), kBThreads, kSmemBc, prm, s);
  if (err) return err;
  err = launch_bwd(ssd_bwd_dt_kernel, dim3(H, bnc), 32, 0, prm, s);
  if (err) return err;
  return launch_bwd(ssd_bwd_da_kernel, dim3(((a_rows ? B : 1) * H + kBThreads - 1) / kBThreads),
                    kBThreads, 0, prm, s);
}

}  // extern "C"
