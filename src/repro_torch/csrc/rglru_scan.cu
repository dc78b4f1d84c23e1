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
// written per element, 168 MB at recurrentgemma-9b's training shape
// (2, 1024, 4096), 0.050 ms at 3.35 TB/s; 1.34 GB, 0.401 ms at 16 rows.
// S cannot be split without changing the rounding the plain version fixes,
// so a thread per channel walks t = S−1..0 with dh and a_{t+1} in
// registers, and only the depth of the prefetch and the layout of the work
// are free.
//
// What held the first design back.  It kept the loads in registers: two
// buffers of 16 steps, the next group's 48 loads in flight while the current
// group was stepped, in blocks of 64 channels.  Without the card's stall
// counters, the reading is its times and its SASS
// (scripts/time_scan_bwd.py --sass: 144 global loads in
// three unrolled groups of 48, no shared memory).  At (2, 1024, 4096) only
// 256 warps exist, two an SM, and one group in flight a thread is ~1.6 MB
// over the card: 0.3457 ms, 0.49 TB/s.  At 16 rows, eight times the warps,
// the same kernel moved 2.27 TB/s (0.5908 ms).  Bytes in flight, not the
// card's bandwidth, bounded the training shape.
//
// This design keeps them in shared memory instead: a block is one warp of
// 32 channels of one row (256 blocks at the training shape), and a ring of
// kRingDepth boxes, each kBoxSteps steps of a, g and h_{t−1} for the
// warp's channels (6 KB), comes in by cp.async (16-byte copies when W is a
// multiple of 4 and the arrays are aligned, else 4-byte), waited on by
// cp.async.wait_group.  kRingDepth − 1 = 5 boxes are in flight while one
// is stepped: 30 KB a warp, 7.7 MB over the card at the training shape,
// and no register holds a load in flight.  The lane steps its channel from
// shared memory (conflict-free: lane c reads bank c) and stores da and db
// as it goes, coalesced across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWholeSteps = 32;   // sequences this short are loaded whole
constexpr int kGroup = 16;        // steps per buffer on the ring path
constexpr int kChannels = 128;    // per block, one thread each

// The steps a thread holds for a sequence of S: kWholeSteps (the whole
// path), or 0 for the ring of two kGroup-step buffers.
int whole_steps(int S) { return S <= kWholeSteps ? kWholeSteps : 0; }

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

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

// The backward's ring: a block is one warp of kRingChannels channels of one
// row; box k of the ring holds steps [S − (k + 1)·kBoxSteps, S − k·kBoxSteps)
// of a and g and the step before each of h, (3, kBoxSteps, kRingChannels)
// floats, and kRingDepth − 1 boxes are in flight while one is stepped.
constexpr int kRingChannels = 32;
constexpr int kBoxSteps = 16;
constexpr int kRingDepth = 6;

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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Every copy group of this thread but the newest kRingDepth − 1 has landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRingDepth - 1) : "memory");
}

// Box k's copies into ring slot k % kRingDepth (nothing past the last box):
// rows before step 0 and channels past W become 0.  VEC: 16-byte copies
// (W a multiple of 4, the arrays 16-byte aligned).
template <bool VEC>
__device__ __forceinline__ void fetch_box(float (*ring)[3][kBoxSteps][kRingChannels],
                                          const float* __restrict__ a, const float* __restrict__ h,
                                          const float* __restrict__ g, long long base, int k,
                                          int boxes, int S, int W, int w0) {
  if (k >= boxes) return;
  constexpr int E = VEC ? 4 : 1, words = kRingChannels / E;
  const int t_lo = S - (k + 1) * kBoxSteps;
  for (int idx = threadIdx.x; idx < 3 * kBoxSteps * words; idx += kRingChannels) {
    const int arr = idx / (kBoxSteps * words), rem = idx - arr * kBoxSteps * words;
    const int r = rem / words, col = (rem - r * words) * E;
    const int ts = t_lo + r - (arr == 2);   // h: the step before
    const bool ok = ts >= 0 && w0 + col < W;
    const float* src = arr == 0 ? a : arr == 1 ? g : h;
    copy_async<VEC>(&ring[k % kRingDepth][arr][r][col],
                    ok ? src + base + (long long)ts * W + w0 + col : src, ok);
  }
}

// Grid (⌈W / kRingChannels⌉, B), one thread per channel walking t = S−1..0
// with dh and a_{t+1} in registers, a, g and h_{t−1} from the ring.
template <bool VEC>
__global__ void __launch_bounds__(kRingChannels)
    rglru_scan_bwd_ring_kernel(const float* __restrict__ a, const float* __restrict__ h,
                               const float* __restrict__ g, float* __restrict__ da,
                               float* __restrict__ db, int S, int W) {
  __shared__ __align__(16) float ring[kRingDepth][3][kBoxSteps][kRingChannels];
  const int lane = threadIdx.x, w0 = blockIdx.x * kRingChannels, w = w0 + lane;
  const long long base = (long long)blockIdx.y * S * W;
  const int boxes = (S + kBoxSteps - 1) / kBoxSteps;
  for (int k = 0; k < kRingDepth - 1; ++k) {
    fetch_box<VEC>(ring, a, h, g, base, k, boxes, S, W, w0);
    cp_async_commit();
  }
  float dh = 0.0f, a_next = 0.0f;   // the last step: dh = g + 0·0
  for (int k = 0; k < boxes; ++k) {
    fetch_box<VEC>(ring, a, h, g, base, k + kRingDepth - 1, boxes, S, W, w0);
    cp_async_commit();
    cp_async_wait_ring();   // this lane's copies of box k have landed
    __syncwarp();           // ... and every lane's
    const float (*box)[kBoxSteps][kRingChannels] = ring[k % kRingDepth];
    const int t_lo = S - (k + 1) * kBoxSteps;
    if (w < W) {
#pragma unroll
      for (int r = kBoxSteps - 1; r >= 0; --r) {
        const int t = t_lo + r;
        if (t >= 0) {
          const long long e = base + (long long)t * W + w;
          dh = __fadd_rn(box[1][r][lane], __fmul_rn(a_next, dh));
          da[e] = __fmul_rn(dh, box[2][r][lane]);
          db[e] = dh;
          a_next = box[0][r][lane];
        }
      }
    }
    __syncwarp();   // every lane is done with the slot the next box fills
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
  const dim3 grid((W + kRingChannels - 1) / kRingChannels, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned16(a) && aligned16(h) && aligned16(g))
    rglru_scan_bwd_ring_kernel<true><<<grid, kRingChannels, 0, s>>>(a, h, g, da, db, S, W);
  else
    rglru_scan_bwd_ring_kernel<false><<<grid, kRingChannels, 0, s>>>(a, h, g, da, db, S, W);
  return (int)cudaGetLastError();
}

// The backward's ring, into out[3]: channels per block (one warp), steps
// per box, boxes in the ring.
void rglru_scan_bwd_ring(int* out) {
  out[0] = kRingChannels;
  out[1] = kBoxSteps;
  out[2] = kRingDepth;
}

// The steps rglru_scan's threads hold for a sequence of S: 32 on the whole
// path, 0 on the ring.
int rglru_scan_steps(int S) { return whole_steps(S); }

}  // extern "C"
