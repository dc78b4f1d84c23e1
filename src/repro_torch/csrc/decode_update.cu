// Single-token recurrent-state updates of the serving decode step, for
// Hopper (sm_90a):
//
//   rglru_decode:  h' = a·h + b                         over (R, W)
//   ssd_decode:    st' = decay·st + dtx ⊗ b,  y = st'·c  over (R, HP, N)
//
// Replace src/repro/kernels/decode_update.py:44 pallas_rglru_decode
// (pallas_call at :62) and :86 pallas_ssd_decode (pallas_call at :97).
//
// Layouts (row-major, contiguous, fp32):
//   rglru   h, a, b, out   (R, W)
//   ssd     state, out_state (R, HP, N); decay, dtx, y (R, HP); b, c (R, N)
//
// Every product and sum is spelled with the round-to-nearest intrinsics, in
// the order the plain versions evaluate them, so nvcc cannot contract them
// into fused multiply-adds: h' and st' are the plain versions' bits.  y sums
// its N products in another order than the plain version's einsum (a
// strided partial sum per lane, then a shuffle tree), so it agrees with it
// to the rounding of an N-term sum.  Each slot's row is computed by its own
// threads in a fixed order, so nothing of a row depends on R: a request
// decoded in a batch gets the bits it gets alone.
//
// What bounds them on this card: bytes.  rglru reads 3 and writes 1 value
// per element for 2 operations; ssd reads and writes the state (8 bytes per
// element) for 5 operations.  Both are a fraction of an operation per byte,
// far below the ~20 where the CUDA cores would limit, so the design only
// moves the bytes once and coalesced: rglru takes 16-byte words per thread
// where the rows allow it; ssd gives each (slot, channel) row of N state
// values to one warp, lanes on consecutive values, b and c read once per
// block into shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// VEC = 4 when every pointer is 16-byte aligned, else 1.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    rglru_decode_kernel(const float* __restrict__ h, const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ out, long long n) {
  const long long words = n / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < words; i += stride) {
    if (VEC == 4) {
      const float4 hv = reinterpret_cast<const float4*>(h)[i];
      const float4 av = reinterpret_cast<const float4*>(a)[i];
      const float4 bv = reinterpret_cast<const float4*>(b)[i];
      float4 o;
      o.x = step(av.x, hv.x, bv.x);
      o.y = step(av.y, hv.y, bv.y);
      o.z = step(av.z, hv.z, bv.z);
      o.w = step(av.w, hv.w, bv.w);
      reinterpret_cast<float4*>(out)[i] = o;
    } else {
      out[i] = step(a[i], h[i], b[i]);
    }
  }
  const long long tail = words * VEC + threadIdx.x;  // the n % VEC tail
  if (VEC > 1 && blockIdx.x == 0 && tail < n) out[tail] = step(a[tail], h[tail], b[tail]);
}

// Grid (ceil(HP / kWarps), R): warp w of block (x, r) owns row k = x·kWarps + w
// of slot r.  Dynamic shared memory: b and c of slot r, 2·N floats.
__global__ void __launch_bounds__(kThreads)
    ssd_decode_kernel(const float* __restrict__ state, const float* __restrict__ decay,
                      const float* __restrict__ dtx, const float* __restrict__ b,
                      const float* __restrict__ c, float* __restrict__ out_state,
                      float* __restrict__ y, int HP, int N) {
  extern __shared__ float smem[];
  float* b_s = smem;
  float* c_s = smem + N;
  const int r = blockIdx.y;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    b_s[n] = b[(long long)r * N + n];
    c_s[n] = c[(long long)r * N + n];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= HP) return;
  const long long row = (long long)r * HP + k;
  const float dk = decay[row];
  const float xk = dtx[row];
  const float* st = state + row * N;
  float* st_out = out_state + row * N;
  float acc = 0.0f;
  for (int n = lane; n < N; n += 32) {
    const float v = __fadd_rn(__fmul_rn(st[n], dk), __fmul_rn(xk, b_s[n]));
    st_out[n] = v;
    acc = __fadd_rn(acc, __fmul_rn(v, c_s[n]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) y[row] = acc;
}

}  // namespace

extern "C" {

// vectorised: every pointer is 16-byte aligned.  sms: the card's
// multiprocessor count (sizes the grid).  Returns a cudaError_t (0 on
// success), or -1 for arguments the kernel does not take.
int rglru_decode(const float* h, const float* a, const float* b, float* out, long long n,
                 int vectorised, int sms, void* stream) {
  if (n < 0 || sms < 1) return -1;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = vectorised ? 4 : 1;
  const long long need = (n / vec + kThreads - 1) / kThreads;
  const int blocks = (int)(need < 1 ? 1 : (need < 8LL * sms ? need : 8LL * sms));
  if (vectorised)
    rglru_decode_kernel<4><<<blocks, kThreads, 0, s>>>(h, a, b, out, n);
  else
    rglru_decode_kernel<1><<<blocks, kThreads, 0, s>>>(h, a, b, out, n);
  return (int)cudaGetLastError();
}

int ssd_decode(const float* state, const float* decay, const float* dtx, const float* b,
               const float* c, float* out_state, float* y, int R, int HP, int N,
               void* stream) {
  if (R < 0 || HP < 0 || N < 1 || R > 65535) return -1;
  if (R == 0 || HP == 0) return 0;
  const size_t smem = 2 * sizeof(float) * (size_t)N;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((HP + kWarps - 1) / kWarps, R);
  ssd_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      state, decay, dtx, b, c, out_state, y, HP, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
