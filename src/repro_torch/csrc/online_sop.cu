// Digit-serial MSDF sum of products with Early Negative Detection (END),
// for NVIDIA Hopper (sm_90a): one launch for all the filters of a layer.
//
// Replaces the reference package's Pallas TPU kernel
//   src/repro/kernels/online_sop/online_sop.py :: _sop_end_kernel  (entry
//     point `online_sop_end` below).  The reference reaches a layer's
//     filters with jax.vmap over y; here the filter axis is written out.
//
// What it computes: for every row i of the row-major float32 x (P, m),
// |x| < 1, and every filter f of y (F, m):
//   * n_digits cycles of signed-digit radix-2 digit generation per element,
//     v = 2w, d = +1 if v >= 1/2, -1 if v <= -1/2, else 0, w = v - d
//     (w starts at x; every step is exact in float32);
//   * the MSDF prefix P_j = P_{j-1} + 2^-(j+1) S_j, S_j = sum_k d_kj y_fk,
//     taken in order of j, and the END latch (Algorithm 2): the first cycle
//     j (1-based) at which P_j + 2^-j sum_k |y_fk| <= 0;
//   * the full-precision sum of x * y_f.
// Outputs (P, F): sop float32, cycle int32 (n_digits when the latch never
// fires), detected bool.
//
// Why the sums are exact.  The wrapper puts each filter in 31-bit fixed
// point, q = round(y 2^(31-E)) with 2^(E-2) < max|y| <= 2^(E-1), |q| <=
// 2^30, as four balanced signed int8 limbs, q = sum_l 256^l q_l.  A digit
// is -1, 0 or 1, so S_j = sum_l 256^l sum_k d_kj q_lk is an integer
// product: each limb's sum runs on the int8 tensor cores
// (mma.sync.m16n8k32 s8 * s8 -> s32; |sum| <= 128 m_pad, no overflow),
// and the limbs combine exactly in float64 (|S_j| <= 2^30 m < 2^53).  The
// latch compares P_j + 2^-(j+1) T <= 0 with T = sum|q|: a common positive
// scale 2^(E-31) does not change its sign, so E never reaches the kernel.
// The prefix is a float64 scan of fixed shape over the 16 cycles a warp
// holds (the kernel's order, which tests/test_torch_online_sop.py
// emulates); its rounding (2^-52 of T) and the quantisation of y (at most
// m 2^-30 max|y| per S_j) lie far inside the band (m + n_digits) 2^-24
// sum|y| within which a plain float32 version may latch on another cycle
// (latch_disagreements in the wrapper).  No atomics: no result depends on
// scheduling, and each filter's arithmetic does not depend on F or on the
// block that holds it, so a batched call equals F single calls bit for bit.
// sop sums x * y in float32 FMAs over the staged x tile and y itself, in
// an order fixed by the element index alone.
//
// Design.  A block owns kFilters filters (blockIdx.y) and walks tiles in
// order: k-tile kt (kKTile elements) of chunk c (16 cycles) of pass p
// (kRows rows; blockIdx.x strides over the passes, persistent).
//   * Y's limbs, [limb][filter][element], are the A operand; when every
//     k-tile fits (kMaxResident; VGG-16 CONV2 at m = 576 does) the block
//     stages them once for all its passes, else a two-slot ring streams
//     them one tile ahead.  cp.async stages x two tiles ahead (three
//     slots);
//   * each element's recurrence runs once per chunk (digits generated once
//     for n_digits <= 16; a later chunk re-runs it from x to reach its
//     start) and writes its digits as int8 to shared memory, a digit row
//     per (row, cycle) holding the elements: the B operand.  Two digit
//     buffers: while the tensor cores take this tile's digits, the warps
//     write the next tile's, in the same basic block as the MMAs and the
//     sop FMAs (no branch between them, zeros past m, y = 0 after chunk
//     0), so the scheduler interleaves the three;
//   * 8 warps: warp w holds 32 filters (two m16 tiles of limbs) against
//     rows 2(w/2), 2(w/2)+1 (each row's 16 digit rows two n8 tiles) for
//     the four limbs, 128 int32 accumulators a thread; operands by
//     ldmatrix.  The digit rows are stored permuted so that each lane's
//     accumulators hold 4 consecutive cycles of a (row, filter) column;
//   * the chunk's epilogue combines the limbs, sums each column's prefix
//     over its lane's 4 cycles and then across the 4 lanes holding the
//     column, latches the first firing cycle (a min across those lanes),
//     and carries the prefix to the next chunk in shared memory;
//   * sop: thread (filter, quarter of the k-tile) accumulates 8 rows; its
//     y loads (from L2) are issued before the products.
//
// The bound (chip_smoke.py prints it from the run's shapes): the least
// work reads x once, Y once and writes the three (P, F) outputs, and does
// 2 P m F n_digits digit products at the int8 rate plus 2 P m F x * y
// operations at the float32 rate.  At VGG-16 CONV2 (P = 50,176, m = 576,
// F = 64, 16 digits) that is 144.7 MB (0.043 ms at 3.35 TB/s) against
// 0.030 + 0.055 ms of operations: operations bound it, and the float32
// sop dominates them.  At CONV1 (m = 27) bytes bound it (0.010 ms).
//
// What limits the design now: mma.sync from ldmatrix (not wgmma fed by
// TMA), the digits, the sop and the products sharing every warp's issue
// slots (no warp specialisation), one block a SM (the accumulators), the
// float64 latch's shuffles and conversions (CONV1's largest cost), y for
// sop read from L2 on every pass, and CONV1's 27 elements padded to a
// 64-wide k-tile.  PERF.md records the measured times beside the bound.

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;       // x rows a pass
constexpr int kFilters = 64;   // filters a block
constexpr int kKTile = 64;     // elements a k-tile
constexpr int kCycles = 16;    // cycles a chunk: two n8 tiles per row
constexpr int kLimbs = 4;
constexpr int kPitch = kKTile + 16;  // bytes a digit or limb row; ldmatrix
                                     // rows then hit distinct banks
constexpr unsigned kFullMask = 0xffffffffu;
// the largest m: a limb's sum stays in int32 and S_j below 2^53
constexpr int kMaxM = 1 << 22;

// shared memory, in bytes
constexpr int kYTile = kLimbs * kFilters * kPitch;       // one k-tile of Y
constexpr int kXTile = kRows * kKTile * 4;               // one k-tile of x
constexpr int kDigits = kRows * kCycles * kPitch;        // the B operand
constexpr int kPrefixBytes = kRows * kFilters * 8;       // carried prefix
constexpr int kPartBytes = 4 * kRows * kFilters * 4;     // sop partials
constexpr int kCycleBytes = kRows * kFilters * 4;        // latched cycle
constexpr int kTailBytes = kFilters * 8;                 // sum|q|
constexpr int kFixed = kTailBytes + kPrefixBytes + kPartBytes + kCycleBytes +
                       3 * kXTile + 2 * kDigits;
constexpr int kMaxSmem = 232448;  // a block's limit on sm_90
constexpr int kMaxResident = (kMaxSmem - kFixed) / kYTile;
static_assert(kThreads == kRows * 32, "digit mapping: a warp per row");
static_assert(kThreads == 4 * kFilters, "sop mapping: 4 threads a filter");

struct Args {
  const float* x;              // (P, m)
  const float* y;              // (F, m)
  const signed char* limbs;    // (kLimbs, F_pad, m_pad)
  const double* tail;          // (F_pad,) sum|q|
  float* sop;                  // (P, F)
  int* cycle;                  // (P, F)
  bool* detected;              // (P, F)
  long long P;
  int m, m_pad, F, F_pad, n_digits;
  long long passes;
  int n_ktiles, resident, x_vec, y_vec;
};

__device__ __forceinline__ float select_digit(float v) {
  return v >= 0.5f ? 1.0f : (v <= -0.5f ? -1.0f : 0.0f);
}

// x rows [r0, r0 + kRows) of k-tile kt into xs (zeros past P and m)
__device__ __forceinline__ void stage_x(const Args& a, float* xs,
                                        long long r0, int kt) {
  const int t = threadIdx.x;
  const int k0 = kt * kKTile;
  if (a.x_vec) {  // m % 4 == 0 and x 16-byte aligned
    if (t < kRows * kKTile / 4) {
      const int r = t / (kKTile / 4), k = k0 + 4 * (t % (kKTile / 4));
      const bool ok = r0 + r < a.P && k < a.m;
      const float* src = ok ? a.x + (r0 + r) * a.m + k : a.x;
      cp_async16(xs + r * kKTile + k - k0, src, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows * kKTile / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int r = e / kKTile, k = k0 + e % kKTile;
      const bool ok = r0 + r < a.P && k < a.m;
      const float* src = ok ? a.x + (r0 + r) * a.m + k : a.x;
      cp_async4(xs + e, src, ok);
    }
  }
}

// k-tile kt of the block's filters' limbs into ys, [limb][filter][kPitch]
__device__ __forceinline__ void stage_y(const Args& a, signed char* ys,
                                        int f0, int kt) {
#pragma unroll
  for (int i = 0; i < kLimbs * kFilters * 4 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int c = e & 3, f = (e >> 2) % kFilters, l = e / (4 * kFilters);
    const signed char* src = a.limbs +
                             ((long long)l * a.F_pad + f0 + f) * a.m_pad +
                             kt * kKTile + 16 * c;
    cp_async16(ys + (l * kFilters + f) * kPitch + 16 * c, src, true);
  }
}

// Digits of cycles c0 .. c0 + 15 of the staged tile: thread (row, pair of
// elements) runs both recurrences and writes each cycle's two digits.
// Cycle 4a + 2h + b goes to the row's digit row 8h + 2a + b, so that the
// accumulator fragment gives lane (lr, g) cycles 4g .. 4g + 3.
// digits_start loads the pair and runs the cycles before c0; digits_half
// writes 8 cycles, j0 .. j0 + 7 of the chunk, so that the caller can
// interleave them with its MMAs.
__device__ __forceinline__ void digits_start(const float* xs, int c0,
                                             float& w0, float& w1) {
  const int r = threadIdx.x >> 5, k = 2 * (threadIdx.x & 31);
  const float2 x2 = *reinterpret_cast<const float2*>(xs + r * kKTile + k);
  w0 = x2.x;
  w1 = x2.y;
  for (int s = 0; s < c0; ++s) {  // a later chunk: reach its start
    const float v0 = 2.0f * w0, v1 = 2.0f * w1;
    w0 = v0 - select_digit(v0);
    w1 = v1 - select_digit(v1);
  }
}

__device__ __forceinline__ void digits_half(unsigned char* dg, int j0,
                                            float& w0, float& w1) {
  const int r = threadIdx.x >> 5, k = 2 * (threadIdx.x & 31);
#pragma unroll
  for (int jj = 0; jj < kCycles / 2; ++jj) {
    const int j = j0 + jj;
    const float v0 = 2.0f * w0, v1 = 2.0f * w1;
    w0 = v0 - select_digit(v0);
    w1 = v1 - select_digit(v1);
    // the digits as int8 bytes, from the same compares (no conversion)
    const unsigned b0 = v0 >= 0.5f ? 0x01u : (v0 <= -0.5f ? 0xffu : 0u);
    const unsigned b1 = v1 >= 0.5f ? 0x01u : (v1 <= -0.5f ? 0xffu : 0u);
    const int dr = ((j >> 1) & 1) * 8 + 2 * (j >> 2) + (j & 1);
    *reinterpret_cast<unsigned short*>(dg + (r * kCycles + dr) * kPitch + k) =
        (unsigned short)(b0 | (b1 << 8));
  }
}

// sop: thread (filter f, quarter of the k-tile) loads its 16 elements of
// y_f (zeros past m and F), issued before the products so that these hide
// the loads' latency ...
__device__ __forceinline__ void sop_load_y(const Args& a, int f, int kt,
                                           float (&yv)[16]) {
  const int kb = kt * kKTile + 16 * (threadIdx.x / kFilters);
  const float* yr = a.y + (long long)f * a.m;
#pragma unroll
  for (int i = 0; i < 16; ++i) yv[i] = 0.0f;
  // volatile: the loads stay where they are issued rather than sinking to
  // their use after the MMAs
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    const int k = kb + i;
    if (a.y_vec) {
      if (f < a.F && k < a.m) {
        asm volatile("ld.global.nc.v4.f32 {%0,%1,%2,%3}, [%4];\n"
                     : "=f"(yv[i]), "=f"(yv[i + 1]), "=f"(yv[i + 2]),
                       "=f"(yv[i + 3])
                     : "l"(yr + k));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (f < a.F && k + e < a.m) {
          asm volatile("ld.global.nc.f32 %0, [%1];\n"
                       : "=f"(yv[i + e]) : "l"(yr + k + e));
        }
      }
    }
  }
}

// ... and adds their x * y to ps[row], in element order (x and y are
// zeros past m, so the FMAs need no guard).
__device__ __forceinline__ void sop_fma(const float* xs,
                                        const float (&yv)[16], float* ps) {
  const int kq = 16 * (threadIdx.x / kFilters);
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + r * kKTile + kq + i);
      const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ps[r] = fmaf(xe[e], yv[i + e], ps[r]);
      }
    }
  }
}

// The accumulators of a warp: [limb][m-tile of 16 filters][row][n-tile h
// of 8 digit rows][fragment element]
using Acc = int[kLimbs][2][2][2][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int l = 0; l < kLimbs; ++l)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[l][mt][i][h][c] = 0;
}

// The pass row and block filter of a lane's epilogue column v = (m-tile,
// row of the warp's pair, filter lr or lr + 8)
__device__ __forceinline__ int col_row(int v, int mp) {
  return 2 * mp + ((v >> 1) & 1);
}
__device__ __forceinline__ int col_filter(int v, int fh, int lr) {
  return fh * 32 + (v >> 2) * 16 + lr + 8 * (v & 1);
}

// S_j of one accumulator element: the limbs' sums combined, exactly
__device__ __forceinline__ long long limb_sum(const Acc& acc, int mt, int i,
                                              int h, int c) {
  return (long long)acc[0][mt][i][h][c] + 256LL * acc[1][mt][i][h][c] +
         65536LL * acc[2][mt][i][h][c] + 16777216LL * acc[3][mt][i][h][c];
}

// A tile of the block's work: k-tile kt of chunk `chunk` of pass `pass`
struct Tile {
  long long pass;
  int chunk, kt;
};

__device__ __forceinline__ Tile next_tile(Tile u, int nk, int chunks) {
  if (++u.kt == nk) {
    u.kt = 0;
    if (++u.chunk == chunks) {
      u.chunk = 0;
      u.pass += gridDim.x;
    }
  }
  return u;
}

// One 32-element k-step of a warp's products: 2 rows x 32 filters x 4 limbs
__device__ __forceinline__ void mma_kstep(Acc& acc, const unsigned char* dg,
                                          const signed char* ys, int ks,
                                          int mp, int fh, int lane) {
  // B: each row's 16 digit rows (two n8 tiles) by 32 elements
  unsigned bf[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ldsm_x4(bf[i], dg + ((2 * mp + i) * kCycles + ((lane >> 4) << 3) +
                         (lane & 7)) * kPitch +
                       ks * 32 + ((lane >> 3) & 1) * 16);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    // A: 16 filters by 32 elements, one fragment a limb
    unsigned af[kLimbs][4];
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      ldsm_x4(af[l], ys + (l * kFilters + fh * 32 + mt * 16 + (lane & 15)) *
                              kPitch +
                         ks * 32 + (lane >> 4) * 16);
    }
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_s8(acc[l][mt][i][0], af[l], bf[i]);
        mma_s8(acc[l][mt][i][1], af[l], bf[i] + 2);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    sop_end_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* tail_s = reinterpret_cast<double*>(smem);
  double* pre_s = reinterpret_cast<double*>(smem + kTailBytes);
  float* part_s = reinterpret_cast<float*>(smem + kTailBytes + kPrefixBytes);
  int* cyc_s = reinterpret_cast<int*>(smem + kTailBytes + kPrefixBytes +
                                      kPartBytes);
  float* x_s = reinterpret_cast<float*>(smem + kFixed - 2 * kDigits -
                                        3 * kXTile);
  unsigned char* dg_s = smem + kFixed - 2 * kDigits;
  signed char* y_s = reinterpret_cast<signed char*>(smem + kFixed);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int mp = warp >> 1, fh = warp & 1;  // row pair, filter half
  const int g = lane & 3, lr = lane >> 2;   // C-fragment column pair, row
  const int f0 = blockIdx.y * kFilters;
  const int nf = min(kFilters, a.F - f0);  // the block's real filters
  const int f = f0 + t % kFilters;         // this thread's sop filter
  const int nk = a.n_ktiles;
  const int chunks = (a.n_digits + kCycles - 1) / kCycles;
  auto xslot = [&](int i) { return x_s + i * (kXTile / 4); };
  auto yslot = [&](int i) { return y_s + i * kYTile; };

  // The block walks tiles T in order.  While the tensor cores take T's
  // digits, the warps write the next tile N's digits into the other
  // buffer; x runs two tiles ahead (three slots), streamed limbs one.
  Tile T{blockIdx.x, 0, 0};
  if (T.pass >= a.passes) return;
  Tile N = next_tile(T, nk, chunks), NN = next_tile(N, nk, chunks);
  stage_x(a, xslot(0), T.pass * kRows, T.kt);
  if (N.pass < a.passes) stage_x(a, xslot(1), N.pass * kRows, N.kt);
  if (a.resident) {
    for (int k = 0; k < nk; ++k) stage_y(a, yslot(k), f0, k);
  } else {
    stage_y(a, yslot(0), f0, T.kt);
  }
  cp_async_commit();
  if (t < kFilters) tail_s[t] = a.tail[f0 + t];
  cp_async_wait<0>();
  __syncthreads();
  {
    float w0, w1;
    digits_start(xslot(0), T.chunk * kCycles, w0, w1);
    digits_half(dg_s, 0, w0, w1);
    digits_half(dg_s, kCycles / 2, w0, w1);
  }

  Acc acc;
  zero(acc);
  float ps[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ps[r] = 0.0f;

  for (int it = 0;; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // T's digits and N's x are in; the last MMAs are done
    const bool has_next = N.pass < a.passes;
    if (NN.pass < a.passes) {
      stage_x(a, xslot((it + 2) % 3), NN.pass * kRows, NN.kt);
    }
    if (!a.resident && has_next) stage_y(a, yslot((it + 1) & 1), f0, N.kt);
    cp_async_commit();

    float yv[16];
    if (T.chunk == 0) {
      sop_load_y(a, f, T.kt, yv);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) yv[i] = 0.0f;
    }
    float w0, w1;
    digits_start(xslot((it + 1) % 3), N.chunk * kCycles, w0, w1);

    const unsigned char* dg = dg_s + (it & 1) * kDigits;
    unsigned char* dg_next = dg_s + ((it + 1) & 1) * kDigits;
    const signed char* ys = a.resident ? yslot(T.kt) : yslot(it & 1);
    // one basic block, so that the scheduler interleaves the MMAs with N's
    // digits and T's sop FMAs (zeros past m, and y = 0 after chunk 0)
    mma_kstep(acc, dg, ys, 0, mp, fh, lane);
    digits_half(dg_next, 0, w0, w1);
    mma_kstep(acc, dg, ys, 1, mp, fh, lane);
    digits_half(dg_next, kCycles / 2, w0, w1);
    sop_fma(xslot(it % 3), yv, ps);

    if (T.kt == nk - 1) {
      const int c0 = T.chunk * kCycles;
      // The chunk's epilogue.  Lane (lr, g) holds cycles c0 + 4g .. + 3 of
      // 8 (row, filter) columns v = (m-tile, row, filter lr or lr + 8).
      // Per column: S_j, the prefix in cycle order (the lane's four in
      // order, then across the 4 lanes g), the latch.
      // Each step runs over all 8 columns before the next, with no branch
      // between, so the columns' latencies overlap.
      const int j0 = c0 + 4 * g;  // the lane's first cycle, 0-based
      double sc[4];
      sc[0] = ldexp(1.0, -(j0 + 1));
#pragma unroll
      for (int b = 1; b < 4; ++b) sc[b] = 0.5 * sc[b - 1];
      double lp[8][4], inc[8], sh[8], carry[8], last[8];
      int first[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int mt = v >> 2, i = (v >> 1) & 1, q = 2 * (v & 1);
#pragma unroll
        for (int b = 0; b < 4; ++b) {  // exact: scaled by a power of two
          lp[v][b] = sc[b] * (double)limb_sum(acc, mt, i, b >> 1, q + (b & 1));
        }
        lp[v][1] += lp[v][0];
        lp[v][2] += lp[v][1];
        lp[v][3] += lp[v][2];
        inc[v] = lp[v][3];
        carry[v] = 0.0;
      }
      // inclusive scan of the lanes' sums over g, then the exclusive one
#pragma unroll
      for (int v = 0; v < 8; ++v) sh[v] = __shfl_up_sync(kFullMask, inc[v], 1, 4);
#pragma unroll
      for (int v = 0; v < 8; ++v) inc[v] = g >= 1 ? inc[v] + sh[v] : inc[v];
#pragma unroll
      for (int v = 0; v < 8; ++v) sh[v] = __shfl_up_sync(kFullMask, inc[v], 2, 4);
#pragma unroll
      for (int v = 0; v < 8; ++v) inc[v] = g >= 2 ? inc[v] + sh[v] : inc[v];
#pragma unroll
      for (int v = 0; v < 8; ++v) sh[v] = __shfl_up_sync(kFullMask, inc[v], 1, 4);
      if (c0 > 0) {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          carry[v] = pre_s[col_row(v, mp) * kFilters + col_filter(v, fh, lr)];
        }
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const double exc = g == 0 ? 0.0 : sh[v];
        const double tail = tail_s[col_filter(v, fh, lr)];
        first[v] = kCycles;  // the lane's first firing cycle in the chunk
#pragma unroll
        for (int b = 3; b >= 0; --b) {
          const double pref = (exc + lp[v][b]) + carry[v];
          if (b == 3) last[v] = pref;
          const bool fire =
              j0 + b < a.n_digits && pref + tail * sc[b] <= 0.0;
          first[v] = fire ? 4 * g + b : first[v];
        }
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        first[v] = min(first[v], __shfl_xor_sync(kFullMask, first[v], 1, 4));
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        first[v] = min(first[v], __shfl_xor_sync(kFullMask, first[v], 2, 4));
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        last[v] = __shfl_sync(kFullMask, last[v], 3, 4);  // the chunk's prefix
      }
      if (g == 0) {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int o = col_row(v, mp) * kFilters + col_filter(v, fh, lr);
          int cy = c0 == 0 ? -1 : cyc_s[o];
          if (cy < 0 && first[v] < kCycles) cy = c0 + first[v] + 1;
          cyc_s[o] = cy;
          pre_s[o] = last[v];
        }
      }
      zero(acc);

      if (T.chunk == chunks - 1) {  // the pass's outputs
        const int q = t / kFilters, fo = t % kFilters;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          part_s[(q * kRows + r) * kFilters + fo] = ps[r];
          ps[r] = 0.0f;
        }
        __syncthreads();
        const long long r0 = T.pass * kRows;
        for (int e = t; e < kRows * kFilters; e += kThreads) {
          const int r = e / kFilters, fc = e % kFilters;
          if (r0 + r < a.P && fc < nf) {
            const float* pp = part_s + r * kFilters + fc;
            float sum = pp[0] + pp[kRows * kFilters];
            sum += pp[2 * kRows * kFilters];
            sum += pp[3 * kRows * kFilters];
            const int cy = cyc_s[r * kFilters + fc];
            const long long o = (r0 + r) * a.F + f0 + fc;
            a.sop[o] = sum;
            a.cycle[o] = cy < 0 ? a.n_digits : cy;
            a.detected[o] = cy >= 0;
          }
        }
      }
    }
    if (!has_next) break;
    T = N;
    N = NN;
    NN = next_tile(NN, nk, chunks);
  }
  cp_async_wait<0>();
}

int smem_bytes(int resident, int n_ktiles) {
  return kFixed + (resident ? n_ktiles : 2) * kYTile;
}

}  // namespace

extern "C" {

// Kernel C (replaces _sop_end_kernel): x (P, m) and y (F, m) float32, Y's
// limbs (4, F_pad, m_pad) int8 and tail (F_pad,) float64 as the wrapper
// makes them (F_pad a multiple of 64, m_pad of 64, zeros past F and m) in;
// sop (P, F) float32, cycle (P, F) int32 and detected (P, F) bool out, on
// `stream`.  Returns a cudaError_t (0 = launched, or nothing to do at
// P == 0).
int online_sop_end(const void* x, const void* y, const void* limbs,
                   const void* tail, void* sop, void* cycle, void* detected,
                   long long P, int m, int F, int n_digits, void* stream) {
  if (P < 0 || m < 1 || m > kMaxM || F < 1 || n_digits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (P == 0) return (int)cudaSuccess;
  Args a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<const float*>(y);
  a.limbs = static_cast<const signed char*>(limbs);
  a.tail = static_cast<const double*>(tail);
  a.sop = static_cast<float*>(sop);
  a.cycle = static_cast<int*>(cycle);
  a.detected = static_cast<bool*>(detected);
  a.P = P;
  a.m = m;
  a.F = F;
  a.n_digits = n_digits;
  a.m_pad = (m + kKTile - 1) / kKTile * kKTile;
  a.F_pad = (F + kFilters - 1) / kFilters * kFilters;
  a.n_ktiles = a.m_pad / kKTile;
  a.resident = a.n_ktiles <= kMaxResident;
  a.passes = (P + kRows - 1) / kRows;
  a.x_vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.y_vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int fblocks = a.F_pad / kFilters;
  if (fblocks > 65535) return (int)cudaErrorInvalidValue;

  const int smem = smem_bytes(a.resident, a.n_ktiles);
  cudaError_t e = cudaFuncSetAttribute(
      sop_end_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sop_end_kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // enough persistent blocks to fill the card once, spread over the
  // filter blocks
  const long long slots = (long long)sms * per_sm;
  long long gx = (slots + fblocks - 1) / fblocks;
  if (gx > a.passes) gx = a.passes;
  const dim3 grid((unsigned)gx, (unsigned)fblocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sop_end_kernel<<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

const char* online_sop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
