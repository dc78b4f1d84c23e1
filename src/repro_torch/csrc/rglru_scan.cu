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
// across the width.  S and W are arbitrary: a thread past W does nothing,
// the steps past S are predicated off, no input is padded or copied.
//
// The product and the sum are spelled with the round-to-nearest intrinsics,
// in the plain version's order, so nvcc cannot fuse them: the kernel gives
// the sequential plain version's bits on either path.  The JAX package's
// twin (an associative scan) differs from both by rounding order only.
//
// What bounds it on this card.  Each element costs 8 bytes read and 4
// written against 2 operations, so bytes at the training shape
// (16, 1024, 4096): 805 MB, 0.240 ms at 3.35 TB/s.  At the serve shape
// (1, 32, 4096), one prefill chunk of recurrentgemma-9b, the 1.5 MB take
// 0.47 µs at that rate, and the time is latency: the launch, and how many
// dependent round trips to memory a thread waits for.  The first design
// (blocks of 128 channels, 8 steps loaded at a time) gave that shape
// ⌈4096 / 128⌉ = 32 blocks, so 100 of the 132 SMs had nothing, and a
// 32-step chunk waited for 4 round trips in a row: 0.00896 ms against a
// floor of about 5.6 µs that any launch costs in chip_smoke.py's timing
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).
//
// Design, a function of S (rglru_scan_steps reports it), blocks of 128
// channels:
// - "whole", S <= 32: the thread issues the loads of every step of its
//   channel before the first step, so a chunk costs one round trip, then
//   steps through registers and stores each h as it goes.  The serving
//   engine pads every prefill chunk to its width (prefill_chunk, 32), so
//   every served launch has S = 32, and then no step is predicated off:
//   the loads and stores issue back to back with no branch between them.
//   A shorter S (a caller's own) runs the same kernel with each step
//   predicated on S.
// - "ring", longer S (the training shape): two register buffers of kGroup
//   steps; the next group's loads are in flight while the current group is
//   stepped, so the memory pipe does not drain between groups.
// What probe calls on the card showed, at the serve shape: with each step
// predicated on a runtime S (a branch around each load and store) the
// kernel beat the first design alone with L2 flushed, but took longer
// than it inside a step, where a and b come from L2; unpredicated it wins
// both ways.  Blocks of 32 or 16 channels (spreading the 32 blocks over
// 128 or 256) did not change the time.  The measured times are in PERF.md.
//
// The backward, rglru_scan_bwd: the JAX package differentiates its twin
// (src/repro/kernels/ops.py:222, the vjp of the associative scan); here a
// reverse scan per channel from the forward's saved h and g = dL/dh:
//
//   dh_t = g_t + a_{t+1}·dh_{t+1}  (dh_S = g_S),  da_t = dh_t·h_{t−1}  (h_0 = 0),
//   db_t = dh_t
//
// each product and sum rounded once, so it gives the plain version's
// autograd bits (ref.torch_rglru_scan_bwd).  Bytes bound it: 12 read and 8
// written per element, 1.34 GB at (16, 1024, 4096), 0.401 ms at 3.35 TB/s.
// One thread per channel walks t = S−1..0 with dh and a_{t+1} in
// registers; a ring of two kGroup-step buffers keeps the next group's loads
// in flight while the current one is stepped, as the forward's ring does.
// Blocks of 64 channels: at recurrentgemma-9b's (2, 1024, 4096) that is 128
// blocks, one per SM, where 128-channel blocks would leave half the SMs
// idle.

#include <cuda_runtime.h>

namespace {

constexpr int kWholeSteps = 32;   // sequences this short are loaded whole
constexpr int kGroup = 16;        // steps per buffer on the ring path
constexpr int kChannels = 128;    // per block, one thread each

// The steps a thread holds for a sequence of S: kWholeSteps (the whole
// path), or 0 for the ring of two kGroup-step buffers.
int whole_steps(int S) { return S <= kWholeSteps ? kWholeSteps : 0; }

// a and b of steps 0..n−1 (n <= N) from element i, one step every W.
template <int N>
__device__ __forceinline__ void load(const float* __restrict__ a, const float* __restrict__ b,
                                     long long i, int W, int n, float (&av)[N], float (&bv)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (u < n) {
      av[u] = a[i + (long long)u * W];
      bv[u] = b[i + (long long)u * W];
    }
  }
}

// Steps 0..n−1 of the recurrence from `state`, each h stored; returns the
// last h.
template <int N>
__device__ __forceinline__ float step(float state, const float (&av)[N], const float (&bv)[N],
                                      float* __restrict__ h, long long i, int W, int n) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (u < n) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      h[i + (long long)u * W] = state;
    }
  }
  return state;
}

// Grid (⌈W / kChannels⌉, B), one thread per channel.  N > 0: the whole
// sequence (S <= N) in registers; N = 0: the ring.
template <int N>
__global__ void __launch_bounds__(kChannels)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kChannels + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  if constexpr (N > 0) {
    float av[N], bv[N];
    if (S == N) {   // the serving chunks: no step predicated off
      load(a, b, base, W, N, av, bv);
      step(0.0f, av, bv, h, base, W, N);
    } else {
      load(a, b, base, W, S, av, bv);
      step(0.0f, av, bv, h, base, W, S);
    }
  } else {
    float a0[kGroup], b0[kGroup], a1[kGroup], b1[kGroup];
    load(a, b, base, W, S < kGroup ? S : kGroup, a0, b0);
    float state = 0.0f;
    for (int t = 0; t < S; t += 2 * kGroup) {
      const int n0 = min(S - t, kGroup);
      const int n1 = max(0, min(S - t - kGroup, kGroup));
      const int n2 = max(0, min(S - t - 2 * kGroup, kGroup));
      load(a, b, base + (long long)(t + kGroup) * W, W, n1, a1, b1);   // in flight meanwhile
      state = step(state, a0, b0, h, base + (long long)t * W, W, n0);
      load(a, b, base + (long long)(t + 2 * kGroup) * W, W, n2, a0, b0);
      state = step(state, a1, b1, h, base + (long long)(t + kGroup) * W, W, n1);
    }
  }
}

constexpr int kBwdChannels = 64;   // per block of the backward

// a, h_{t−1} and g of steps t0 − u for u < n (walking back), from element i
// of step t0; h_{−1} = 0.
__device__ __forceinline__ void load_back(const float* __restrict__ a, const float* __restrict__ h,
                                          const float* __restrict__ g, long long i, int t0, int W,
                                          int n, float (&av)[kGroup], float (&hv)[kGroup],
                                          float (&gv)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (u < n) {
      const long long e = i + (long long)(t0 - u) * W;
      av[u] = a[e];
      gv[u] = g[e];
      hv[u] = t0 - u > 0 ? h[e - W] : 0.0f;
    }
  }
}

// Steps t0, t0 − 1, ..., t0 − n + 1 of the reverse scan; dh and a_next
// (a_{t+1}) carry between groups.
__device__ __forceinline__ void step_back(float& dh, float& a_next, const float (&av)[kGroup],
                                          const float (&hv)[kGroup], const float (&gv)[kGroup],
                                          float* __restrict__ da, float* __restrict__ db,
                                          long long i, int t0, int W, int n) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    if (u < n) {
      const long long e = i + (long long)(t0 - u) * W;
      dh = __fadd_rn(gv[u], __fmul_rn(a_next, dh));
      da[e] = __fmul_rn(dh, hv[u]);
      db[e] = dh;
      a_next = av[u];
    }
  }
}

// Grid (⌈W / kBwdChannels⌉, B), one thread per channel.
__global__ void __launch_bounds__(kBwdChannels)
    rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                          const float* __restrict__ g, float* __restrict__ da,
                          float* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * kBwdChannels + threadIdx.x;
  if (w >= W) return;
  const long long base = (long long)blockIdx.y * S * W + w;
  float a0[kGroup], h0[kGroup], g0[kGroup], a1[kGroup], h1[kGroup], g1[kGroup];
  float dh = 0.0f, a_next = 0.0f;   // the last step: dh = g + 0·0
  load_back(a, h, g, base, S - 1, W, min(S, kGroup), a0, h0, g0);
  for (int t = S - 1; t >= 0; t -= 2 * kGroup) {
    const int n0 = min(t + 1, kGroup);
    const int n1 = max(0, min(t + 1 - kGroup, kGroup));
    const int n2 = max(0, min(t + 1 - 2 * kGroup, kGroup));
    load_back(a, h, g, base, t - kGroup, W, n1, a1, h1, g1);   // in flight meanwhile
    step_back(dh, a_next, a0, h0, g0, da, db, base, t, W, n0);
    load_back(a, h, g, base, t - 2 * kGroup, W, n2, a0, h0, g0);
    step_back(dh, a_next, a1, h1, g1, da, db, base, t - kGroup, W, n1);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or -1 for arguments the kernel does
// not take.
int rglru_scan(const float* a, const float* b, float* h, int B, int S, int W, void* stream) {
  if (B < 0 || S < 0 || W < 0 || B > 65535) return -1;
  if (B == 0 || S == 0 || W == 0) return 0;
  const dim3 grid((W + kChannels - 1) / kChannels, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole_steps(S))
    rglru_scan_kernel<kWholeSteps><<<grid, kChannels, 0, s>>>(a, b, h, S, W);
  else
    rglru_scan_kernel<0><<<grid, kChannels, 0, s>>>(a, b, h, S, W);
  return (int)cudaGetLastError();
}

// The backward: da, db (B, S, W) from a, the forward's h and g = dL/dh.
// Returns a cudaError_t (0 on success), or -1 for arguments the kernel does
// not take.
int rglru_scan_bwd(const float* a, const float* h, const float* g, float* da, float* db, int B,
                   int S, int W, void* stream) {
  if (B < 0 || S < 0 || W < 0 || B > 65535) return -1;
  if (B == 0 || S == 0 || W == 0) return 0;
  const dim3 grid((W + kBwdChannels - 1) / kBwdChannels, B);
  rglru_scan_bwd_kernel<<<grid, kBwdChannels, 0, static_cast<cudaStream_t>(stream)>>>(
      a, h, g, da, db, S, W);
  return (int)cudaGetLastError();
}

// The steps rglru_scan's threads hold for a sequence of S: 32 on the whole
// path, 0 on the ring.
int rglru_scan_steps(int S) { return whole_steps(S); }

}  // extern "C"
