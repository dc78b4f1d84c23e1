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
// dC and da are sums across blocks.  Four kernels, launched in order on the
// stream, take them without atomics: every sum runs in a fixed order, so
// equal inputs give equal bits.
//   1. pairs, grid (tile pairs i ≥ j, B·NC): S of the 32 × 32 tile once,
//      then per head dM, dS, G; writes S, Σ_h dS and G's row and column
//      sums of the tile (per head) to the workspace.
//   2. keys, grid (row tiles · H, B·NC): du of 32 rows of one head from S
//      (workspace) ∘ L and the state term; writes dx, Σ_p du ∘ x and
//      dec_j E_j.
//   3. dt, one warp per (row, head) (per head when a is (H,)): walks the
//      chunks in order: dcums from the partial sums, its reverse cumsum in
//      fp64, ddt, and da as an fp64 sum.
//   4. bc, grid (row tiles, B·NC): dC and dB of 32 rows from Σ_h dS and the
//      state term over all heads (K = H·P).
// The products run on the CUDA cores in fp32 (2 × 2 or 2 × 4 outputs a
// thread, operands from shared memory); cums is an fp64 warp scan as in the
// forward, so L and dec are exp of fp64 differences rounded once, and a
// masked entry (i < j) is never exponentiated.  What bounds it: at the
// training shape (B 16, NC 8, Q 128, H 32, P 64, N 128) the function needs
// 13.3 G multiply-adds (operations, 0.40 ms at the fp32 peak) against
// 0.57 GB (0.17 ms).  This first design is simple, not fast: the tensor
// cores wait for a later redesign.  The workspace holds S and Σ_h dS
// (B·NC·Q² each), G's partial sums (2·B·NC·H·⌈Q/32⌉·Q) and two (B·NC·Q·H)
// vectors: 37.7 MB at the training shape.

constexpr int kBT = 32;          // rows of a backward tile
constexpr int kBThreads = 256;   // 16 × 16 threads, 2 rows each
constexpr int kCW = 64;          // output columns of a 2 × 4 product pass

struct BwdParams {
  const float *x, *dt, *a, *b, *c, *dy, *dst;
  float *dx, *ddt, *da, *db, *dc;
  float *s_mat, *dss, *rowg, *colg, *dux, *ed;   // workspace
  int B, NC, Q, H, P, N, a_rows, nt;
};

// Workspace floats, in the order of BwdParams.
long long ws_sizes(int B, int NC, int Q, int H, long long (&sz)[6]) {
  const long long bnc = (long long)B * NC, nt = (Q + kBT - 1) / kBT;
  sz[0] = sz[1] = bnc * Q * Q;
  sz[2] = sz[3] = bnc * H * nt * Q;
  sz[4] = sz[5] = bnc * Q * H;
  long long total = 0;
  for (long long v : sz) total += (v + 63) / 64 * 64;   // each part 256-byte aligned
  return total;
}

// acc (rows 2·ty + {0, 1}, columns CW·tx + {0..CW−1}) += A · B over k < K,
// ty = thread / 16, tx = thread % 16: a 32 × 16·CW output tile.
template <int CW, typename LA, typename LB>
__device__ __forceinline__ void mm(float (&acc)[2][CW], int K, LA la, LB lb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    const float a0 = la(2 * ty, k), a1 = la(2 * ty + 1, k);
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float bv = lb(k, CW * tx + j);
      acc[0][j] = fmaf(a0, bv, acc[0][j]);
      acc[1][j] = fmaf(a1, bv, acc[1][j]);
    }
  }
}

// Rows [r0, r0 + nr) and columns [c0, c0 + w) of a (rows, cols) matrix with
// row stride ld into a tile of row stride sst; entries outside the matrix
// become 0.
__device__ __forceinline__ void load_tile(float* dst, int sst, const float* src, long long ld,
                                          int r0, int nr, int rows, int c0, int w, int cols) {
  for (int idx = threadIdx.x; idx < nr * w; idx += blockDim.x) {
    const int r = idx / w, cc = idx - r * w;
    const bool ok = r0 + r < rows && c0 + cc < cols;
    dst[r * sst + cc] = ok ? src[(long long)(r0 + r) * ld + c0 + cc] : 0.0f;
  }
}

// One warp: the inclusive fp64 cumsum of dt·a of head h over the chunk into
// cums (Q,), and dt into dt_s, as the forward forms them.
__device__ __forceinline__ void head_cums(const BwdParams& p, long long chunk, int h, double* cums,
                                          float* dt_s) {
  const int lane = threadIdx.x & 31, Q = p.Q, H = p.H;
  const int b = (int)(chunk / p.NC);
  const float a = p.a[p.a_rows ? (long long)b * H + h : h];
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
      cums[j] = v;
      if (dt_s) dt_s[j] = d;
    }
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  __syncwarp();
}

__device__ __forceinline__ float decay(const double* cums, int i, int j) {
  return expf((float)__dsub_rn(cums[i], cums[j]));
}

// 1. Grid (tile pairs, B·NC): pair it·(it + 1)/2 + jt, jt <= it.
__global__ void __launch_bounds__(kBThreads) ssd_bwd_pairs_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, P = p.P, N = p.N, SN = N + 1, SP = P + 1;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.x) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int i0 = it * kBT, j0 = jt * kBT;
  const long long chunk = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, warp = threadIdx.x >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cums = reinterpret_cast<double*>(smem_raw);   // (Q,)
  float* dt_s = reinterpret_cast<float*>(cums + round_up(Q, 2));
  float* c_s = dt_s + round_up(Q, 4);   // (kBT, SN) C rows of the i tile
  float* b_s = c_s + kBT * SN;          // (kBT, SN) B rows of the j tile
  float* y_s = b_s + kBT * SN;          // (kBT, SP) dy rows of the i tile, head h
  float* u_s = y_s + kBT * SP;          // (kBT, SP) dt·x rows of the j tile, head h
  float* g_s = u_s + kBT * SP;          // (kBT, kBT + 1) G of head h

  load_tile(c_s, SN, p.c + chunk * Q * N, N, i0, kBT, Q, 0, N, N);
  load_tile(b_s, SN, p.b + chunk * Q * N, N, j0, kBT, Q, 0, N, N);
  __syncthreads();
  float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  mm<2>(s, N, [&](int r, int k) { return c_s[r * SN + k]; },
        [&](int k, int c) { return b_s[c * SN + k]; });
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int i = i0 + 2 * ty + rr, j = j0 + 2 * tx + jj;
      if (i < Q && j < Q) p.s_mat[(chunk * Q + i) * Q + j] = s[rr][jj];
    }

  const float* xb = p.x + chunk * Q * H * P;
  const float* yb = p.dy + chunk * Q * H * P;
  const long long ld = (long long)H * P;
  float dss[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's tiles are consumed
    if (warp == 0) head_cums(p, chunk, h, cums, dt_s);
    load_tile(y_s, SP, yb + h * P, ld, i0, kBT, Q, 0, P, P);
    load_tile(u_s, SP, xb + h * P, ld, j0, kBT, Q, 0, P, P);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBT * P; idx += kBThreads) {
      const int r = idx / P, cc = idx - r * P;
      if (j0 + r < Q) u_s[r * SP + cc] = __fmul_rn(u_s[r * SP + cc], dt_s[j0 + r]);
    }
    __syncthreads();
    float dm[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    mm<2>(dm, P, [&](int r, int k) { return y_s[r * SP + k]; },
          [&](int k, int c) { return u_s[c * SP + k]; });
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int r = 2 * ty + rr, c = 2 * tx + jj, i = i0 + r, j = j0 + c;
        float g = 0.0f;
        if (i < Q && j < Q && i >= j) {
          const float ds = __fmul_rn(dm[rr][jj], decay(cums, i, j));
          dss[rr][jj] = __fadd_rn(dss[rr][jj], ds);
          g = __fmul_rn(ds, s[rr][jj]);
        }
        g_s[r * (kBT + 1) + c] = g;
      }
    __syncthreads();
    const long long part = (chunk * H + h) * p.nt;
    if (threadIdx.x < kBT) {   // row sums: this tile's share of Σ_j G_ij
      const int r = threadIdx.x;
      float sum = 0.0f;
      for (int c = 0; c < kBT; ++c) sum = __fadd_rn(sum, g_s[r * (kBT + 1) + c]);
      if (i0 + r < Q) p.rowg[(part + jt) * Q + i0 + r] = sum;
    } else if (threadIdx.x < 2 * kBT) {   // column sums: Σ_i G_ij
      const int c = threadIdx.x - kBT;
      float sum = 0.0f;
      for (int r = 0; r < kBT; ++r) sum = __fadd_rn(sum, g_s[r * (kBT + 1) + c]);
      if (j0 + c < Q) p.colg[(part + it) * Q + j0 + c] = sum;
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int i = i0 + 2 * ty + rr, j = j0 + 2 * tx + jj;
      if (i < Q && j < Q) p.dss[(chunk * Q + i) * Q + j] = dss[rr][jj];
    }
}

// 2. Grid (row tiles · H, B·NC): du of rows [j0, j0 + 32) of head h.
__global__ void __launch_bounds__(kBThreads) ssd_bwd_keys_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, P = p.P, N = p.N, SN = N + 1;
  const int jt = blockIdx.x % p.nt, h = blockIdx.x / p.nt, j0 = jt * kBT;
  const long long chunk = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, warp = threadIdx.x >> 5;
  constexpr int SX = kCW + 1, SM = kBT + 1, SR = 17;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cums = reinterpret_cast<double*>(smem_raw);   // (Q,)
  float* dt_s = reinterpret_cast<float*>(cums + round_up(Q, 2));
  float* b_s = dt_s + round_up(Q, 4);   // (kBT, SN) B rows of the j tile
  float* t_s = b_s + kBT * SN;          // (N, kCW) dst of head h, this pass's columns
  float* x_s = t_s + N * kCW;           // (kBT, SX) x rows of the j tile
  float* y_s = x_s + kBT * SX;          // (kBT, SX) dy rows of an i tile
  float* m_s = y_s + kBT * SX;          // (kBT, SM) M = S ∘ L of the (i, j) tile
  float* red = m_s + kBT * SM;          // (2, kBT, SR) row partial sums

  if (warp == 0) head_cums(p, chunk, h, cums, dt_s);
  load_tile(b_s, SN, p.b + chunk * Q * N, N, j0, kBT, Q, 0, N, N);
  const float* xb = p.x + chunk * Q * H * P + h * P;
  const float* yb = p.dy + chunk * Q * H * P + h * P;
  const float* tb = p.dst + (chunk * H + h) * (long long)N * P;
  const long long ld = (long long)H * P;
  float pdux[2] = {0.0f, 0.0f}, pe[2] = {0.0f, 0.0f};
  for (int c0 = 0; c0 < P; c0 += kCW) {
    __syncthreads();  // the previous pass's tiles are consumed
    load_tile(x_s, SX, xb, ld, j0, kBT, Q, c0, kCW, P);
    load_tile(t_s, kCW, tb, P, 0, N, N, c0, kCW, P);
    float du[2][4] = {}, bt[2][4] = {};
    for (int it = jt; it < p.nt; ++it) {
      const int i0 = it * kBT;
      __syncthreads();  // m_s and y_s are consumed; cums and dt_s are in place
      for (int idx = threadIdx.x; idx < kBT * kBT; idx += kBThreads) {
        const int r = idx / kBT, c = idx - r * kBT, i = i0 + r, j = j0 + c;
        m_s[r * SM + c] = i < Q && j < Q && i >= j
                              ? __fmul_rn(p.s_mat[(chunk * Q + i) * Q + j], decay(cums, i, j))
                              : 0.0f;
      }
      load_tile(y_s, SX, yb, ld, i0, kBT, Q, c0, kCW, P);
      __syncthreads();
      mm<4>(du, kBT, [&](int r, int k) { return m_s[k * SM + r]; },
            [&](int k, int c) { return y_s[k * SX + c]; });
    }
    mm<4>(bt, N, [&](int r, int k) { return b_s[r * SN + k]; },
          [&](int k, int c) { return t_s[k * kCW + c]; });
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * ty + rr, j = j0 + r;
      if (j >= Q) continue;
      const float dtj = dt_s[j], dec = decay(cums, Q - 1, j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = 4 * tx + jj, pc = c0 + c;
        if (pc >= P) continue;
        const float xv = x_s[r * SX + c];
        const float duv = __fadd_rn(du[rr][jj], __fmul_rn(dec, bt[rr][jj]));
        p.dx[((chunk * Q + j) * H + h) * P + pc] = __fmul_rn(duv, dtj);
        pdux[rr] = __fadd_rn(pdux[rr], __fmul_rn(duv, xv));
        pe[rr] = __fadd_rn(pe[rr], __fmul_rn(__fmul_rn(dtj, xv), bt[rr][jj]));
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    red[(2 * ty + rr) * SR + tx] = pdux[rr];
    red[(kBT + 2 * ty + rr) * SR + tx] = pe[rr];
  }
  __syncthreads();
  if (threadIdx.x < kBT) {
    const int r = threadIdx.x, j = j0 + r;
    float sd = 0.0f, se = 0.0f;
    for (int c = 0; c < 16; ++c) {
      sd = __fadd_rn(sd, red[r * SR + c]);
      se = __fadd_rn(se, red[(kBT + r) * SR + c]);
    }
    if (j < Q) {
      p.dux[(chunk * Q + j) * H + h] = sd;
      p.ed[(chunk * Q + j) * H + h] = __fmul_rn(se, decay(cums, Q - 1, j));
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 3. Grid (H, B when a is (B, H), else 1), one warp: ddt of head h over the
// rows' chunks in order, and da.
__global__ void __launch_bounds__(32) ssd_bwd_dt_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, h = blockIdx.x, lane = threadIdx.x;
  const int b_lo = p.a_rows ? blockIdx.y : 0, b_hi = p.a_rows ? blockIdx.y + 1 : p.B;
  double da_acc = 0.0;
  for (int b = b_lo; b < b_hi; ++b) {
    const float a = p.a[p.a_rows ? (long long)b * H + h : h];
    for (int c = 0; c < p.NC; ++c) {
      const long long chunk = (long long)b * p.NC + c;
      const long long part = (chunk * H + h) * p.nt;
      double sed = 0.0;
      for (int i = lane; i < Q; i += 32) sed = __dadd_rn(sed, (double)p.ed[(chunk * Q + i) * H + h]);
      sed = warp_sum(sed);
      double carry = 0.0;   // Σ dcums over the rows after this group of 32
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
    }
    if (p.a_rows) {
      const double total = warp_sum(da_acc);
      if (lane == 0) p.da[(long long)b * H + h] = (float)total;
      da_acc = 0.0;
    }
  }
  if (!p.a_rows) {
    const double total = warp_sum(da_acc);
    if (lane == 0) p.da[h] = (float)total;
  }
}

// 4. Grid (row tiles, B·NC): dC and dB of rows [r0, r0 + 32).
__global__ void __launch_bounds__(kBThreads) ssd_bwd_bc_kernel(BwdParams p) {
  const int Q = p.Q, H = p.H, P = p.P, N = p.N, SP = P + 1;
  const int rt = blockIdx.x, r0 = rt * kBT;
  const long long chunk = blockIdx.y;
  const int b = (int)(chunk / p.NC);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int SD = kBT + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cw = reinterpret_cast<double*>(smem_raw);      // (8, kBT) each warp's cums of the tile
  float* dec_s = reinterpret_cast<float*>(cw + 8 * kBT); // (H, kBT) dec of every head
  float* dt_t = dec_s + H * kBT;                         // (kBT, H)
  float* d_s = dt_t + kBT * H;                           // (kBT, SD) a Σ_h dS tile
  float* v_s = d_s + kBT * SD;                           // (kBT, kCW) B or C rows
  float* x_s = v_s + kBT * kCW;                          // (kBT, SP) (dt·x)·dec of head h
  float* t_s = x_s + kBT * SP;                           // (kCW, SP) dst rows of head h

  load_tile(dt_t, H, p.dt + chunk * Q * H, H, r0, kBT, Q, 0, H, H);
  for (int h = warp; h < H; h += kBThreads / 32) {   // each warp scans its heads
    const float a = p.a[p.a_rows ? (long long)b * H + h : h];
    double carry = 0.0;
    for (int j0 = 0; j0 < Q; j0 += 32) {
      const int j = j0 + lane;
      double v = __fmul_rn(j < Q ? p.dt[(chunk * Q + j) * H + h] : 0.0f, a);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = __dadd_rn(u, v);
      }
      v = __dadd_rn(carry, v);
      if (j >= r0 && j < r0 + kBT) cw[warp * kBT + j - r0] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    dec_s[h * kBT + lane] = r0 + lane < Q ? expf((float)__dsub_rn(carry, cw[warp * kBT + lane])) : 0.0f;
    __syncwarp();
  }

  const float* dsb = p.dss + chunk * Q * Q;
  const float* bb = p.b + chunk * Q * N;
  const float* cb = p.c + chunk * Q * N;
  for (int n0 = 0; n0 < N; n0 += kCW) {
    // dC rows r: Σ_j dss[r, j]·B[j, n]
    float acc[2][4] = {};
    for (int jt = 0; jt <= rt; ++jt) {
      __syncthreads();
      load_tile(d_s, SD, dsb, Q, r0, kBT, Q, jt * kBT, kBT, Q);
      load_tile(v_s, kCW, bb, N, jt * kBT, kBT, Q, n0, kCW, N);
      __syncthreads();
      mm<4>(acc, kBT, [&](int r, int k) { return d_s[r * SD + k]; },
            [&](int k, int c) { return v_s[k * kCW + c]; });
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = r0 + 2 * ty + rr, n = n0 + 4 * tx + jj;
        if (r < Q && n < N) p.dc[(chunk * Q + r) * N + n] = acc[rr][jj];
      }
    // dB rows r: Σ_i dss[i, r]·C[i, n] + Σ_h Σ_p dec_r·dt_r·x[r, h, p]·dst[h, n, p]
    float acc2[2][4] = {};
    for (int it = rt; it < p.nt; ++it) {
      __syncthreads();
      load_tile(d_s, SD, dsb, Q, it * kBT, kBT, Q, r0, kBT, Q);
      load_tile(v_s, kCW, cb, N, it * kBT, kBT, Q, n0, kCW, N);
      __syncthreads();
      mm<4>(acc2, kBT, [&](int r, int k) { return d_s[k * SD + r]; },
            [&](int k, int c) { return v_s[k * kCW + c]; });
    }
    for (int h = 0; h < H; ++h) {
      __syncthreads();
      const float* xh = p.x + chunk * Q * H * P + h * P;
      for (int idx = threadIdx.x; idx < kBT * P; idx += kBThreads) {
        const int r = idx / P, cc = idx - r * P;
        float v = 0.0f;
        if (r0 + r < Q)
          v = __fmul_rn(__fmul_rn(xh[(long long)(r0 + r) * H * P + cc], dt_t[r * H + h]),
                        dec_s[h * kBT + r]);
        x_s[r * SP + cc] = v;
      }
      load_tile(t_s, SP, p.dst + (chunk * H + h) * (long long)N * P, P, n0, kCW, N, 0, P, P);
      __syncthreads();
      mm<4>(acc2, P, [&](int r, int k) { return x_s[r * SP + k]; },
            [&](int k, int c) { return t_s[c * SP + k]; });
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = r0 + 2 * ty + rr, n = n0 + 4 * tx + jj;
        if (r < Q && n < N) p.db[(chunk * Q + r) * N + n] = acc2[rr][jj];
      }
  }
}

size_t smem_pairs(int Q, int N, int P) {
  return sizeof(double) * round_up(Q, 2) +
         sizeof(float) * (round_up(Q, 4) + 2 * kBT * (N + 1) + 2 * kBT * (P + 1) + kBT * (kBT + 1));
}
size_t smem_keys(int Q, int N) {
  return sizeof(double) * round_up(Q, 2) +
         sizeof(float) * (round_up(Q, 4) + kBT * (N + 1) + (size_t)N * kCW + 2 * kBT * (kCW + 1) +
                          kBT * (kBT + 1) + 2 * kBT * 17);
}
size_t smem_bc(int H, int P) {
  return sizeof(double) * 8 * kBT +
         sizeof(float) * (2 * (size_t)H * kBT + kBT * (kBT + 1) + kBT * kCW + kBT * (P + 1) +
                          (size_t)kCW * (P + 1));
}

template <typename Kernel>
int launch_bwd(Kernel kernel, dim3 grid, int threads, size_t smem, const BwdParams& prm,
               cudaStream_t stream) {
  if (smem > kMaxSmem) return -1;
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
  long long sz[6];
  return ws_sizes(B, NC, Q, H, sz) * (long long)sizeof(float);
}

// The backward: dx, ddt, da (a's shape), db, dc from the forward's inputs and
// the gradients dy (B, NC, Q, H, P) and dst (B, NC, H, N, P); `work` holds
// ssd_chunk_bwd_workspace bytes.  Returns a cudaError_t (0 on success), or
// -1 for arguments the kernels do not take (a shared-memory footprint
// above a block's 227 KB included).
int ssd_chunk_bwd(const float* x, const float* dt, const float* a, const float* b, const float* c,
                  const float* dy, const float* dst, float* dx, float* ddt, float* da, float* db,
                  float* dc, float* work, int B, int NC, int Q, int H, int P, int N, int a_rows,
                  void* stream) {
  if (B < 0 || NC < 0 || Q < 1 || H < 0 || P < 1 || N < 1 || (long long)B * NC > 65535 ||
      B > 65535)
    return -1;
  if (B == 0 || NC == 0 || H == 0) return 0;
  const int nt = (Q + kBT - 1) / kBT;
  long long sz[6];
  ws_sizes(B, NC, Q, H, sz);
  float* ws[6];
  float* at = work;
  for (int k = 0; k < 6; ++k) {
    ws[k] = at;
    at += (sz[k] + 63) / 64 * 64;
  }
  const BwdParams prm{x, dt, a, b, c, dy, dst, dx, ddt, da, db, dc,
                      ws[0], ws[1], ws[2], ws[3], ws[4], ws[5],
                      B, NC, Q, H, P, N, a_rows ? 1 : 0, nt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned bnc = (unsigned)(B * NC);
  int err = launch_bwd(ssd_bwd_pairs_kernel, dim3(nt * (nt + 1) / 2, bnc), kBThreads,
                       smem_pairs(Q, N, P), prm, s);
  if (err) return err;
  err = launch_bwd(ssd_bwd_keys_kernel, dim3(nt * H, bnc), kBThreads, smem_keys(Q, N), prm, s);
  if (err) return err;
  err = launch_bwd(ssd_bwd_bc_kernel, dim3(nt, bnc), kBThreads, smem_bc(H, P), prm, s);
  if (err) return err;
  return launch_bwd(ssd_bwd_dt_kernel, dim3(H, a_rows ? B : 1), 32, 0, prm, s);
}

}  // extern "C"
