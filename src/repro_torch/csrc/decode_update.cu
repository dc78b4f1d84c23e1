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
// its N products in another order than the plain version's einsum: each
// lane adds, in order, the products of its words (words lane, lane + 32,
// ...; a word is 4 values on the 16-byte path, 1 on the scalar one, its
// values in order), then a shuffle tree over the 32 lanes (xor 16, 8, 4,
// 2, 1), so it agrees with the einsum to the rounding of an N-term sum.
// Each slot's row is computed by one warp in a fixed order, so nothing of a
// row depends on R: a request decoded in a batch gets the bits it gets
// alone.
//
// What bounds them on this card: bytes.  rglru reads 3 and writes 1 value
// per element for 2 operations; ssd reads and writes the state (8 bytes per
// element) for 5 operations.  Both are a fraction of an operation per byte,
// far below the ~20 where the CUDA cores would limit, so the design only
// moves the bytes once, coalesced and with as many loads in flight as it
// can: rglru takes 16-byte words per thread where the rows allow it.  ssd at
// the serving shape (4 slots × 2,048 rows × N 128) moves 8.4 MB, 2.5 µs at
// the memory's rate; what costs there is how many dependent round trips to
// cold memory a warp waits for.  So each (slot, channel) row goes to one
// warp whose lanes read their own words of b and c straight into registers
// (at N 128 one 16-byte word each) together with the state's: one round
// trip, no shared memory and no barrier.  Rows that start 16-byte aligned
// with N % 4 == 0 (the wrapper's `vectorised`) move as one 16-byte load and
// store per lane; the rest one value at a time.  On the H100 this moves the
// serving shape's bytes as fast as PyTorch's own copy of the state does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// ssd_decode: rows a warp carries.  One, 8,192 warps at the serving shape:
// of 1, 2 and 4 rows per warp, 1 ran fastest on the H100.
constexpr int kRowsPerWarp = 1;

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

// Grid (ceil(HP / (kWarps·kRowsPerWarp)), R): warp w of block (x, r) owns
// rows k0 .. k0 + kRowsPerWarp − 1 of slot r, k0 = (x·kWarps + w)·kRowsPerWarp,
// every load of a word (b, c and each row's state) issued before any use.
// VEC = 4: the rows start 16-byte aligned (N % 4 == 0), each lane takes
// 16-byte words; VEC = 1: one value at a time.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    ssd_decode_kernel(const float* __restrict__ state, const float* __restrict__ decay,
                      const float* __restrict__ dtx, const float* __restrict__ b,
                      const float* __restrict__ c, float* __restrict__ out_state,
                      float* __restrict__ y, int HP, int N) {
  const int r = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int k0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRowsPerWarp;
  if (k0 >= HP) return;
  const int rows = min(kRowsPerWarp, HP - k0);
  const long long row0 = (long long)r * HP + k0;
  const float* br = b + (long long)r * N;
  const float* cr = c + (long long)r * N;
  float dk[kRowsPerWarp], xk[kRowsPerWarp], acc[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    dk[i] = i < rows ? decay[row0 + i] : 0.0f;
    xk[i] = i < rows ? dtx[row0 + i] : 0.0f;
    acc[i] = 0.0f;
  }
  for (int w = lane; w < N / VEC; w += 32) {
    float bv[VEC], cv[VEC], sv[kRowsPerWarp][VEC];
    if constexpr (VEC == 4) {
      const float4 b4 = reinterpret_cast<const float4*>(br)[w];
      const float4 c4 = reinterpret_cast<const float4*>(cr)[w];
      bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
      cv[0] = c4.x, cv[1] = c4.y, cv[2] = c4.z, cv[3] = c4.w;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (i >= rows) break;
        const float4 s4 = reinterpret_cast<const float4*>(state + (row0 + i) * N)[w];
        sv[i][0] = s4.x, sv[i][1] = s4.y, sv[i][2] = s4.z, sv[i][3] = s4.w;
      }
    } else {
      bv[0] = br[w];
      cv[0] = cr[w];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (i >= rows) break;
        sv[i][0] = state[(row0 + i) * N + w];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i >= rows) break;
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        o[e] = __fadd_rn(__fmul_rn(sv[i][e], dk[i]), __fmul_rn(xk[i], bv[e]));
        acc[i] = __fadd_rn(acc[i], __fmul_rn(o[e], cv[e]));
      }
      if constexpr (VEC == 4)
        reinterpret_cast<float4*>(out_state + (row0 + i) * N)[w] = make_float4(o[0], o[1], o[2], o[3]);
      else
        out_state[(row0 + i) * N + w] = o[0];
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], off));
    if (lane == 0 && i < rows) y[row0 + i] = acc[i];
  }
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

// vectorised: every pointer is 16-byte aligned; the 16-byte path also
// needs N % 4 == 0.  Returns a cudaError_t (0 on success), or -1 for
// arguments the kernel does not take.
int ssd_decode(const float* state, const float* decay, const float* dtx, const float* b,
               const float* c, float* out_state, float* y, int R, int HP, int N,
               int vectorised, void* stream) {
  if (R < 0 || HP < 0 || N < 1 || R > 65535) return -1;
  if (R == 0 || HP == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int rows_per_block = kWarps * kRowsPerWarp;
  const dim3 grid((HP + rows_per_block - 1) / rows_per_block, R);
  if (vectorised && N % 4 == 0)
    ssd_decode_kernel<4><<<grid, kThreads, 0, s>>>(state, decay, dtx, b, c, out_state, y, HP, N);
  else
    ssd_decode_kernel<1><<<grid, kThreads, 0, s>>>(state, decay, dtx, b, c, out_state, y, HP, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
