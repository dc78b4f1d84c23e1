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
// One block per (head, chunk, batch).  The TPU kernel holds L, B, C and x of
// a chunk whole in its megabytes of VMEM.  A block here has at most 227 KB
// of shared memory, and at Q 128, N 128, P 64 the whole set would be
// 4·Q·(Q + 2N + P) = 224 KB.  So L is never stored: the block keeps B (rows
// padded by one word, so lanes on neighbouring rows read distinct banks),
// dt·x and the cumsum whole, and walks the rows of C Bᵀ ∘ L in tiles of
// kTile rows: a tile of C rows and its kTile × Q scores sit in shared
// memory, and the tile's y rows are written before the next tile starts.
// That is 4·(Q·(N + 1 + P + 3) + kTile·(N + Q)) bytes, 117 KB at Q 128.
// Rows j > i are skipped, not masked: they would add exact zeros.
//
// A pad row with dt = 0 adds dt·a = 0 to the cumsum and dt·x = 0 to every
// sum, so it leaves y of the real rows and the chunk-end state exactly
// unchanged: the serving engine masks ragged chunk tails that way.
//
// What bounds it on this card.  The function needs Q²·N/2 multiply-adds per
// chunk for C Bᵀ and, per head, Q²·P/2 for y and Q·N·P for the state.  At
// the training shape (B 16, NC 8, Q 128, H 32, P 64, N 128) that is 13
// GFLOP against 0.29 GB moved: operations bound, 0.2 ms at the CUDA cores'
// fp32 peak.  At the serving shape (one chunk of 32 tokens) it is 19 MFLOP
// against 1.6 MB: bytes bound, under a microsecond, so the launch's fixed
// cost dominates.  This first kernel forms C Bᵀ again for every head (it
// does 1.6 times the needed operations at the training shape) and runs its
// products on the CUDA cores in fp32, as the path feeds fp32; forming C Bᵀ
// once per chunk and the tensor cores (TF32 or bf16 wgmma) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // rows of C Bᵀ ∘ L per tile
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

struct Params {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* states;
  int B, NC, Q, H, P, N;
};

__host__ __device__ inline size_t smem_floats(int Q, int N, int P) {
  return (size_t)Q * (N + 1)     // B, rows padded
         + (size_t)Q * P         // dt·x
         + 3 * (size_t)Q         // dt, cumsum, chunk-end decay
         + (size_t)kTile * N     // C rows of the tile
         + (size_t)kTile * Q;    // scores of the tile
}

__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Params p) {
  const int h = blockIdx.x;
  const int ci = blockIdx.y;
  const int bi = blockIdx.z;
  const int Q = p.Q, N = p.N, P = p.P, H = p.H;
  const int Np = N + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* b_s = smem;                       // (Q, N + 1)
  float* xdt_s = b_s + (size_t)Q * Np;     // (Q, P)
  float* dt_s = xdt_s + (size_t)Q * P;     // (Q,)
  float* cums_s = dt_s + Q;                // (Q,)
  float* dec_s = cums_s + Q;               // (Q,)
  float* c_s = dec_s + Q;                  // (kTile, N)
  float* s_s = c_s + (size_t)kTile * N;    // (kTile, Q)

  const long long chunk = (long long)bi * p.NC + ci;    // (b, c) index
  const float* xb = p.x + chunk * Q * H * P;            // x[b, c]
  const float* bb = p.b + chunk * Q * N;
  const float* cb = p.c + chunk * Q * N;
  const float a = p.a[h];

  for (int j = tid; j < Q; j += kThreads) dt_s[j] = p.dt[(chunk * Q + j) * H + h];
  for (int idx = tid; idx < Q * N; idx += kThreads) {
    const int j = idx / N, n = idx - j * N;
    b_s[j * Np + n] = bb[idx];
  }
  __syncthreads();
  if (tid == 0) {  // the inclusive cumsum, in order
    float run = 0.0f;
    for (int j = 0; j < Q; ++j) {
      run = __fadd_rn(run, __fmul_rn(dt_s[j], a));
      cums_s[j] = run;
    }
  }
  for (int idx = tid; idx < Q * P; idx += kThreads) {
    const int j = idx / P, q = idx - j * P;
    xdt_s[idx] = __fmul_rn(xb[((long long)j * H + h) * P + q], dt_s[j]);
  }
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads) dec_s[j] = expf(cums_s[Q - 1] - cums_s[j]);
  __syncthreads();

  // Chunk-end state (N, P): Σ_j B[j, n]·decay_j·xdt[j, p].
  float* st = p.states + (chunk * H + h) * N * P;
  for (int idx = tid; idx < N * P; idx += kThreads) {
    const int n = idx / P, q = idx - n * P;
    float acc = 0.0f;
    for (int j = 0; j < Q; ++j) acc = fmaf(b_s[j * Np + n] * dec_s[j], xdt_s[j * P + q], acc);
    st[idx] = acc;
  }

  // y, kTile rows at a time.
  for (int i0 = 0; i0 < Q; i0 += kTile) {
    const int rows = min(kTile, Q - i0);
    __syncthreads();  // the previous tile's scores are consumed
    for (int idx = tid; idx < rows * N; idx += kThreads) c_s[idx] = cb[(long long)i0 * N + idx];
    __syncthreads();
    for (int idx = tid; idx < rows * Q; idx += kThreads) {
      const int ii = idx / Q, j = idx - ii * Q;
      const int i = i0 + ii;
      float s = 0.0f;
      if (j <= i) {
        const float* crow = c_s + ii * N;
        const float* brow = b_s + j * Np;
        for (int n = 0; n < N; ++n) s = fmaf(crow[n], brow[n], s);
        s *= expf(cums_s[i] - cums_s[j]);
      }
      s_s[idx] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < rows * P; idx += kThreads) {
      const int ii = idx / P, q = idx - ii * P;
      const int i = i0 + ii;
      const float* srow = s_s + ii * Q;
      float acc = 0.0f;
      for (int j = 0; j <= i; ++j) acc = fmaf(srow[j], xdt_s[j * P + q], acc);
      p.y[((chunk * Q + i) * H + h) * P + q] = acc;
    }
  }
}

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
  const size_t smem = sizeof(float) * smem_floats(Q, N, P);
  if (smem > kMaxSmem) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Params p{x, dt, a, b, c, y, states, B, NC, Q, H, P, N};
  const dim3 grid(H, NC, B);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
