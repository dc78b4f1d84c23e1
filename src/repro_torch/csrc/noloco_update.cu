// Fused NoLoCo outer update (Eqs. 2-3 over the group statistics) for Hopper
// (sm_90a):
//
//   δ' = α·δ + β·mean_Δ − γ·(φ − mean_φ)
//   φ' = φ + δ'
//
// Replaces src/repro/kernels/noloco_update.py:47 noloco_update_flat
// (pallas_call at :66).
//
// All six arrays are flat, of one length and one dtype (fp32 or bf16); the
// arithmetic is fp32 and each result is rounded once to the dtype.  The
// operations are spelled with the round-to-nearest intrinsics in the order
// the plain version (and the JAX reference) evaluates them, so nvcc cannot
// contract them into fused multiply-adds and the kernel gives the plain
// version's bits.
//
// What bounds it on this card: bytes.  Each element costs 4 reads and 2
// writes against 8 flops, ~0.7 flop per byte in bf16, far below the ~20
// where the CUDA cores would become the limit.  So the design is only about
// moving those bytes at the memory's rate: each thread moves 16 bytes per
// array per access (8 bf16 or 4 fp32 values), consecutive threads touch
// consecutive 16-byte words, and a grid-stride loop over a grid of a few
// blocks per SM keeps enough loads in flight.  Arrays whose address is not a
// multiple of 16 bytes take the same loop one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Coeffs {
  float alpha, beta, gamma;
};

template <typename T>
__device__ __forceinline__ void update(T phi, T dm, T md, T mp, T& phi_out, T& d_out,
                                       const Coeffs& c) {
  const float p = to_f32(phi);
  const float nd = __fsub_rn(__fadd_rn(__fmul_rn(c.alpha, to_f32(dm)),
                                       __fmul_rn(c.beta, to_f32(md))),
                             __fmul_rn(c.gamma, __fsub_rn(p, to_f32(mp))));
  phi_out = from_f32<T>(__fadd_rn(p, nd));
  d_out = from_f32<T>(nd);
}

// VEC elements per access: 16 bytes when the arrays allow it, else 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    noloco_update_kernel(const T* __restrict__ phi, const T* __restrict__ dm,
                         const T* __restrict__ md, const T* __restrict__ mp,
                         T* __restrict__ phi_out, T* __restrict__ d_out, long long n,
                         Coeffs c) {
  using Word = typename std::conditional<VEC == 1, T, uint4>::type;
  const long long words = n / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < words; i += stride) {
    const Word wa = reinterpret_cast<const Word*>(phi)[i];
    const Word wb = reinterpret_cast<const Word*>(dm)[i];
    const Word wx = reinterpret_cast<const Word*>(md)[i];
    const Word wy = reinterpret_cast<const Word*>(mp)[i];
    const T* a = reinterpret_cast<const T*>(&wa);
    const T* b = reinterpret_cast<const T*>(&wb);
    const T* x = reinterpret_cast<const T*>(&wx);
    const T* y = reinterpret_cast<const T*>(&wy);
    alignas(16) T po[VEC];
    alignas(16) T dout[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) update(a[u], b[u], x[u], y[u], po[u], dout[u], c);
    reinterpret_cast<Word*>(phi_out)[i] = *reinterpret_cast<const Word*>(po);
    reinterpret_cast<Word*>(d_out)[i] = *reinterpret_cast<const Word*>(dout);
  }
  // The n % VEC tail, one element per thread of block 0.
  const long long tail = words * VEC + threadIdx.x;
  if (VEC > 1 && blockIdx.x == 0 && tail < n)
    update(phi[tail], dm[tail], md[tail], mp[tail], phi_out[tail], d_out[tail], c);
}

template <typename T>
int launch(const void* phi, const void* dm, const void* md, const void* mp, void* phi_out,
           void* d_out, long long n, Coeffs c, int vectorised, int sms, cudaStream_t stream) {
  if (n <= 0) return 0;
  const T* a = static_cast<const T*>(phi);
  const T* b = static_cast<const T*>(dm);
  const T* x = static_cast<const T*>(md);
  const T* y = static_cast<const T*>(mp);
  T* po = static_cast<T*>(phi_out);
  T* dout = static_cast<T*>(d_out);
  constexpr int VEC = 16 / sizeof(T);
  const long long per_block = (long long)kThreads * (vectorised ? VEC : 1);
  const long long need = (n + per_block - 1) / per_block;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  if (vectorised)
    noloco_update_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(a, b, x, y, po, dout, n, c);
  else
    noloco_update_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(a, b, x, y, po, dout, n, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16.  vectorised: every pointer is 16-byte aligned.
// sms: the card's multiprocessor count (sizes the grid).  Returns a
// cudaError_t (0 on success), or -1 for arguments the kernel does not take.
int noloco_update(int dtype, const void* phi, const void* delta, const void* mean_delta,
                  const void* mean_phi, void* phi_out, void* delta_out, long long n,
                  float alpha, float beta, float gamma, int vectorised, int sms,
                  void* stream) {
  const Coeffs c{alpha, beta, gamma};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || sms < 1) return -1;
  if (dtype == 0)
    return launch<float>(phi, delta, mean_delta, mean_phi, phi_out, delta_out, n, c,
                         vectorised, sms, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(phi, delta, mean_delta, mean_phi, phi_out, delta_out, n, c,
                                 vectorised, sms, s);
  return -1;
}

}  // extern "C"
