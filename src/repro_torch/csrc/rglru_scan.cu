// RG-LRU linear recurrence for Hopper (sm_90a): the inclusive scan
//
//   h_t = a_t·h_{t−1} + b_t,   h_0 = 0,   channelwise over (B, S, W)
//
// Replaces src/repro/kernels/rglru_scan.py:66 pallas_rglru_scan (pallas_call
// at :86).
//
// Layouts (row-major, contiguous, fp32): a, b, h (B, S, W).
//
// The TPU kernel runs a log-step doubling scan over (S_chunk, 128) tiles,
// because its vector unit wants whole tiles and a serial loop over rows
// would leave it idle.  A GPU has a thread for every channel instead: one
// thread owns channel w of sequence b and walks t = 0..S−1 with its running
// h in a register, so the scan costs one product and one sum per element,
// against the doubling scan's log2(S) of each.  Neighbouring threads own
// neighbouring channels, so every step's loads and store are coalesced
// across the width.  The thread issues the loads of kUnroll steps before it
// uses any of them, which keeps that many loads in flight while the
// recurrence itself waits on nothing but the register.  S and W are
// arbitrary: a thread past W does nothing, the last group of steps is
// bounds-checked, no input is padded or copied.
//
// The product and the sum are spelled with the round-to-nearest intrinsics,
// in the plain version's order, so nvcc cannot fuse them: the kernel gives
// the sequential plain version's bits.  The JAX package's twin (an
// associative scan) differs from both by rounding order only.
//
// What bounds it on this card: bytes.  Each element costs 8 bytes read and
// 4 written against 2 operations.  At the serve shape (1, 32, 4096) the
// launch is a few microseconds of fixed cost; at the training shape
// (16, 1024, 4096) the grid holds 65,536 threads, about 500 for each SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

// Grid (ceil(W / kThreads), B).
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  float state = 0.0f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)(t + u) * W;
      av[u] = a[i];
      bv[u] = b[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      h[base + (long long)(t + u) * W] = state;
    }
  }
  for (; t < S; ++t) {
    const long long i = base + (long long)t * W;
    state = __fadd_rn(__fmul_rn(a[i], state), b[i]);
    h[i] = state;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or -1 for arguments the kernel does
// not take.
int rglru_scan(const float* a, const float* b, float* h, int B, int S, int W, void* stream) {
  if (B < 0 || S < 0 || W < 0 || B > 65535) return -1;
  if (B == 0 || S == 0 || W == 0) return 0;
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, h, S, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
