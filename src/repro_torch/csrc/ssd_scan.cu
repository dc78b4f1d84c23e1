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
//   x (B, NC, Q, H, P), dt (B, NC, Q, H), a (H,), b/c (B, NC, Q, N)
//   y (B, NC, Q, H, P), states (B, NC, H, N, P)
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
  int slabs;  // column slabs per head
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
    const float a = p.a[h];
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

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or -1 for arguments the kernel does
// not take (a shared-memory footprint above a block's 227 KB included).
int ssd_chunk(const float* x, const float* dt, const float* a, const float* b, const float* c,
              float* y, float* states, int B, int NC, int Q, int H, int P, int N,
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
  const Params prm{x, dt, a, b, c, y, states, NC, Q, H, P, N, slabs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pw == 64) return launch_pw<64>(prm, B, vec, s);
  if (pw == 32) return launch_pw<32>(prm, B, vec, s);
  return launch_pw<16>(prm, B, vec, s);
}

}  // extern "C"
