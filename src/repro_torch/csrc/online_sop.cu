// Digit-serial MSDF sum of products with Early Negative Detection (END),
// for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
//   src/repro/kernels/online_sop/online_sop.py :: _sop_end_kernel  (entry
//     point `online_sop_end` below).
//
// What it computes (the TPU kernel's contract): for every row i of the
// row-major float32 x (P, m), |x| < 1, and the weight vector y (m,):
//   * n_digits cycles of signed-digit radix-2 digit generation per element,
//     v = 2w, d = +1 if v >= 1/2, -1 if v <= -1/2, else 0, w = v - d
//     (w starts at x; every step is exact in float32);
//   * the MSDF prefix of the sum of products, P_j = P_{j-1} + 2^-(j+1) S_j
//     with S_j = sum_i d_ij y_i, taken in order of j;
//   * the END latch (Algorithm 2): the first cycle j (1-based) at which
//     P_j + 2^-j sum|y| <= 0 proves the final sum negative;
//   * the full-precision sum of x * y.
// Outputs: sop (P,) float32, cycle (P,) int32 (n_digits when the latch never
// fires), detected (P,) bool.
//
// Design.  Rows are independent and each digit stream depends on its own
// x_i only, so S_j needs one pass over the row per chunk of cycles, and the
// prefix and the latch then run in cycle order.  y and sum|y| are staged
// once per block in shared memory.  The S_j of a chunk of kChunk = 16 cycles
// live in registers; a later chunk runs the recurrence again from x_i, so
// any n_digits >= 1 works.  Two mappings:
//   * rows of m <= kRowsByThreadMaxM (VGG-16 CONV1, m = 27): one row per
//     thread.  The thread runs every element's recurrence, sums S_j in
//     element order, and runs its own prefix and latch; no shuffles;
//   * wider rows: one warp per row, lanes striding over m so loads
//     coalesce.  Each lane carries kGroup elements at once (kGroup loads in
//     flight, kGroup independent chains), then each S_j is summed across
//     the warp by a shuffle tree of fixed shape and lane 0 runs the prefix,
//     the latch and the sum of x * y.
// No atomics: the order of every float sum is fixed, so results do not
// depend on scheduling.  Only those sums depend on the order of their
// terms; a plain version that sums in another order can disagree on the
// latch only where P_j + 2^-j sum|y| lies within rounding of zero.
//
// What bounds it on this card: at the main path's shapes (VGG-16 CONV2 at
// 224^2, P = 50,176 windows of m = 576), each launch must read x once,
// 115.6 MB, 34.7 us at 3.35 TB/s, against 14.7 us for its 2 P m
// (n_digits + 1) operations (a d * y multiply-add per element and cycle,
// and the x * y one) at 67 TFLOP/s: bytes bound it.  The recurrence's
// compares and selects are not in that count; with them, and with each
// element's digit steps forming one dependent chain, the kernel runs well
// above both figures.  PERF.md records its measured time beside the bound.
// Each launch reads all of x for one weight vector, following the
// reference's contract y (m,); letting several filters share one read of x
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;              // elements a lane carries at once
constexpr int kChunk = 16;             // cycle sums held in registers
constexpr int kRowsByThreadMaxM = 64;  // up to this m, one row per thread
constexpr unsigned kFullMask = 0xffffffffu;
// y lives in shared memory: above 48 KB the kernel opts in to more
constexpr int kDefaultSmem = 48 * 1024;
// 224 KB of y, under the 227 KB cap (the wrapper's _MAX_M)
constexpr int kMaxM = 56 * 1024;

__device__ __forceinline__ float select_digit(float v) {
  return v >= 0.5f ? 1.0f : (v <= -0.5f ? -1.0f : 0.0f);
}

// The residual after `steps` cycles of the recurrence from w = x.
__device__ __forceinline__ float advance(float w, int steps) {
  for (int t = 0; t < steps; ++t) {
    const float v = 2.0f * w;
    w = v - select_digit(v);
  }
  return w;
}

// Sum over the warp in a fixed tree; lane 0 ends with the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(kFullMask, v, off);
  }
  return v;
}

// Every block stages y into shared memory and sums |y| in the same fixed
// order; returns sum |y|.
__device__ __forceinline__ float stage_y(const float* __restrict__ y,
                                         float* ys, int m) {
  __shared__ float tail_s;
  for (int i = threadIdx.x; i < m; i += kThreads) ys[i] = y[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    float a = 0.0f;
    for (int i = threadIdx.x; i < m; i += 32) a += fabsf(ys[i]);
    a = warp_sum(a);
    if (threadIdx.x == 0) tail_s = a;
  }
  __syncthreads();
  return tail_s;
}

// The prefix and the END latch over one chunk of cycle sums s, in cycle
// order.  `scale` carries 2^-(cycle) from chunk to chunk; halving is exact.
__device__ __forceinline__ void latch(const float (&s)[kChunk], int c0,
                                      int n_digits, float tail, float& scale,
                                      float& prefix, int& cyc, bool& det) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (c0 + j < n_digits) {
      scale *= 0.5f;  // 2^-(c0 + j + 1): both products below are exact
      prefix = __fadd_rn(prefix, scale * s[j]);
      if (!det && __fadd_rn(prefix, scale * tail) <= 0.0f) {
        det = true;
        cyc = c0 + j + 1;
      }
    }
  }
}

// One row per thread (small m).
__global__ void __launch_bounds__(kThreads)
    sop_end_by_thread(const float* __restrict__ x, const float* __restrict__ y,
                      float* __restrict__ sop, int* __restrict__ cycle,
                      bool* __restrict__ detected, long long P, int m,
                      int n_digits) {
  extern __shared__ float ys[];  // y, m floats
  const float tail = stage_y(y, ys, m);
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= P) return;  // no barrier follows
  const float* xr = x + row * (long long)m;

  float full = 0.0f, prefix = 0.0f, scale = 1.0f;
  int cyc = n_digits;
  bool det = false;
  for (int c0 = 0; c0 < n_digits; c0 += kChunk) {
    float s[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) s[j] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const float xi = xr[i];
      const float yi = ys[i];
      if (c0 == 0) full = fmaf(xi, yi, full);
      float w = advance(xi, c0);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < n_digits) {
          const float v = 2.0f * w;
          const float d = select_digit(v);
          w = v - d;
          s[j] = fmaf(d, yi, s[j]);  // d * yi is exact
        }
      }
    }
    latch(s, c0, n_digits, tail, scale, prefix, cyc, det);
  }
  sop[row] = full;
  cycle[row] = cyc;
  detected[row] = det;
}

// One row per warp (wider m).
__global__ void __launch_bounds__(kThreads)
    sop_end_by_warp(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ sop, int* __restrict__ cycle,
                    bool* __restrict__ detected, long long P, int m,
                    int n_digits) {
  extern __shared__ float ys[];  // y, m floats
  const float tail = stage_y(y, ys, m);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= P) return;  // no barrier follows
  const float* xr = x + row * (long long)m;

  float full = 0.0f, prefix = 0.0f, scale = 1.0f;
  int cyc = n_digits;
  bool det = false;
  for (int c0 = 0; c0 < n_digits; c0 += kChunk) {
    float s[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) s[j] = 0.0f;
    for (int i0 = lane; i0 < m; i0 += 32 * kGroup) {
      float w[kGroup], yv[kGroup];
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        // past the row's end: x = y = 0, whose digits add only zeros
        const int i = i0 + 32 * e;
        w[e] = i < m ? xr[i] : 0.0f;
        yv[e] = i < m ? ys[i] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        if (c0 == 0) full = fmaf(w[e], yv[e], full);
        w[e] = advance(w[e], c0);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < n_digits) {
#pragma unroll
          for (int e = 0; e < kGroup; ++e) {
            const float v = 2.0f * w[e];
            const float d = select_digit(v);
            w[e] = v - d;
            s[j] = fmaf(d, yv[e], s[j]);  // d * y is exact
          }
        }
      }
    }
    // all kChunk trees, unguarded so they overlap (unused sums are zeros)
#pragma unroll
    for (int j = 0; j < kChunk; ++j) s[j] = warp_sum(s[j]);
    if (lane == 0) {
      latch(s, c0, n_digits, tail, scale, prefix, cyc, det);
    }
  }
  full = warp_sum(full);
  if (lane == 0) {
    sop[row] = full;
    cycle[row] = cyc;
    detected[row] = det;
  }
}

using KernelFn = void (*)(const float*, const float*, float*, int*, bool*,
                         long long, int, int);

cudaError_t launch(const float* x, const float* y, float* sop, int* cycle,
                   bool* detected, long long P, int m, int n_digits,
                   cudaStream_t stream) {
  const bool by_thread = m <= kRowsByThreadMaxM;
  const KernelFn kernel =
      by_thread ? &sop_end_by_thread : &sop_end_by_warp;
  const long long rows_per_block = by_thread ? kThreads : kWarps;
  const long long blocks = (P + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = m * (int)sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, y, sop, cycle, detected, P, m, n_digits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel C (replaces _sop_end_kernel): x (P, m) and y (m,) float32 in,
// sop (P,) float32, cycle (P,) int32 and detected (P,) bool out, on
// `stream`.  Returns a cudaError_t (0 = launched, or nothing to do at
// P == 0).
int online_sop_end(const void* x, const void* y, void* sop, void* cycle,
                   void* detected, long long P, int m, int n_digits,
                   void* stream) {
  if (P < 0 || m < 1 || m > kMaxM || n_digits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (P == 0) return (int)cudaSuccess;
  const float* xp = static_cast<const float*>(x);
  const float* yp = static_cast<const float*>(y);
  float* sp = static_cast<float*>(sop);
  int* cp = static_cast<int*>(cycle);
  bool* dp = static_cast<bool*>(detected);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch(xp, yp, sp, cp, dp, P, m, n_digits, s);
}

const char* online_sop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
