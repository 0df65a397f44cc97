// Mamba-2 SSD chunk scan (state-space duality), for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py :: _ssd_kernel  (entry point
//     `ssd_scan` below).
//
// What it computes (the TPU kernel's contract): for every sequence b and
// head h, over x (b, S, H, P), dt (b, S, H), A (H,), B/C (b, S, N) and
// D (H,), walking the chunks of Q tokens in order with the (P, N) float32
// state h carried from one chunk to the next (zero before the first):
//   cums[t]     = sum_{u <= t} dt[u] A          (inclusive, within the chunk)
//   y[q]        = sum_{k <= q} exp(cums[q] - cums[k]) (C[q] . B[k]) dt[k] x[k]
//               + exp(cums[q]) C[q] h_in^T + D x[q]
//   h_out       = exp(cums[Q-1]) h_in
//               + sum_k exp(cums[Q-1] - cums[k]) dt[k] x[k]^T B[k]
// y is written in x's type and the final state in float32.  x, B and C are
// float32 or bfloat16 (one type for the three); dt, A and D are float32
// (the wrapper casts them); every sum is float32.
//
// Schedule (both instances).  The TPU grid walks the chunks in order and
// keeps the state in VMEM across grid steps; CUDA blocks run in no order,
// so one block owns one (sequence, head) and walks that head's chunks
// itself with the float32 state in shared memory: one launch, a fixed order
// for every sum, no atomics.  A chunk is cut into 64-row query slabs and
// 64-row key tiles; a slab visits the key tiles at or below its diagonal,
// and the chunk's last slab, which visits them all, also folds each tile
// into the state once every slab has read h_in.  The mask k <= q is applied
// *before* exp (above the diagonal cums[q] - cums[k] > 0, and an exp that
// overflows would turn the mask's zero into NaN).  The cumulative sums stay
// float32 (one warp's scan).  Rows past Q (a chunk that is not a multiple
// of 64) load as zeros and are not written.
//
// bfloat16 instance (the Mamba-2 main path): all four products run on the
// tensor cores as mma.sync.m16n8k16 bf16 -> float32, fed by ldmatrix.
// x, B and C stay bf16 in shared memory and are exact operands (a product
// of two bf16 values is exact in float32); every float32 operand v is cut
// into bf16 parts, hi = bf16(v), then lo = bf16(v - hi) and so on (each
// remainder exact in float32), and multiplied part by part.  One part
// keeps 8 significant bits (2^-9 relative), two 16 (2^-17), three at
// least float32's 24.  The scores' operands G and the carried
// state h_in reach only y, which is stored in bf16 and held to 2^-7 of
// its magnitude: two parts suffice, and one fails where y cancels (terms
// of 2^10 times y's size); x' = w x reaches the float32 state, held to
// 1e-4 of its magnitude with no bf16 step, so it takes three parts: one
// fails on random inputs and two where the state's terms cancel
// (tests/test_torch_ssd_scan.py emulates each case; the card tests run
// the kernel on the same inputs).  128 threads:
// warp w owns rows 16 w .. 16 w + 15 of every slab and of the state, whole,
// so no warp waits on another's partial sums.  Per chunk:
//   * scores C B^T: C slab and B tile both bf16, one pass; the warp's
//     16 rows x 64 keys stay in registers;
//   * diagonal block: G = S exp(cums[q] - cums[k]) dt[k] (masked by
//     selects, no branch; no mask at all below the diagonal) is split in
//     registers into hi and lo A operands of G . x (the m16n8 accumulator
//     layout is the m16n8k16 A layout), x exact;
//   * carried-state term C h_in^T: C exact, h_in split in two as it is
//     read from the float32 state, then scaled by exp(cums[q]); D x (from
//     the diagonal tile's x in shared memory) is added when y is written;
//   * state update h = exp(cums[Q-1]) h + (w x)^T B, w[k] = exp(cums[Q-1]
//     - cums[k]) dt[k]: x' = w x (the 64-wide operand, half the size of
//     B' = w B) is split in three as its fragments are loaded, B exact;
//     the warp's 16 state rows in 64-column blocks, read from and written
//     back to shared memory per tile.
// The hot loops hold no per-tile guard (a branch there keeps a tile's
// loads from running ahead): the state's rows past P, x's columns past P
// and B's and C's columns past N are zeros in shared memory.  The next key
// tile's B and x (or the next slab's or chunk's first) are staged with
// 16-byte cp.async in a second stage while the current tile's products
// run, and a slab's C while the previous slab writes y; one barrier a tile.
// Rows are padded by 16 bytes (ldmatrix and the state's float2 reads free
// of bank conflicts, cp.async 16-byte aligned); N is padded to 64 and P to
// 64, so any N >= 1 and P <= 64 run (N or P that is not a multiple of 8
// stages with plain loads).  Shared memory at P = 64, N = 128, Q = 256: the
// f32 state 34.8 KB, the C slab 17.4 KB, two stages of B 34.8 KB and of x
// 18.4 KB, cums, dt and w 3 KB: 106 KB, two blocks per SM, which leaves a
// thread up to 255 registers (no spills).
//
// float32 instance (the f32 checks only): float32 FMAs from shared memory
// on the same slabs and tiles, 256 threads, each a 4 x 4 patch of every
// 64 x 64 product; 135 KB, one block per SM.
//
// What bounds it on this card: at the main path's shapes (Mamba-2-780m
// prefill, b = 4, S = 4096, H = 48, P = 64, N = 128, Q = 256, bf16) each
// chunk of each sequence sums over the Q(Q+1)/2 pairs k <= q: 2 N Q(Q+1)/2
// FLOPs for the scores, H 2 P Q(Q+1)/2 for the diagonal blocks, then
// H 2 Q N P for the state's output term and as many for the state update:
// 39.2 GFLOP per layer, 0.040 ms at the 989 TFLOP/s of bf16 on the tensor
// cores, against 0.065 ms for the 217 MB it must read and write at
// 3.35 TB/s: bytes bound it.  The kernel executes 3.3 times the bound's
// FLOPs (129 GFLOP per layer: the scores once per head, though B and C are
// shared by all 48 heads; whole diagonal tiles; two parts of G and h_in,
// three of x') through mma.sync, and stages 0.96 GB a layer from L2 into
// shared memory (each key tile once per slab at or below it), 4.4 times
// the bytes of the bound.  Neither rate is reached: one block walks its
// chunks in sequence, so its phases (starting the staging copies, the
// scores, the scalar work of G, the carried term, the barriers) run back
// to back with 4 warps to hide their latency, and 192 blocks fill 132 SMs
// unevenly.  PERF.md records the measured time and the versions tried
// beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kTile = 64;       // query rows per slab, key rows per tile
constexpr int kMaxP = 64;       // the widest head either instance covers
constexpr int kXS = kMaxP + 8;  // bf16 x tile row: P padded to 64, +16 bytes

// ---------------------------------------------------------------------------
// bfloat16 instance: tensor cores
// ---------------------------------------------------------------------------

// 4 warps, one per 16 rows of a 64-row slab; two blocks per SM leave each
// thread up to 255 registers
constexpr int kThreads = 128;

// Byte offsets of the bf16 kernel's dynamic shared memory.
struct Layout {
  int np;  // N padded to a multiple of 64
  int ld;  // row stride of the C slab and B tiles (bf16) and the state (f32)
  unsigned cb, bt, xt, cums, dts, wk, total;  // the state starts at 0
};

__host__ __device__ inline Layout layout(int N, int Q) {
  Layout L;
  L.np = (N + 63) / 64 * 64;
  L.ld = L.np + 8;  // 16 bytes of bf16; np + 8 = 8 mod 32 floats
  const unsigned qp = (Q + kTile - 1) / kTile * kTile;
  const unsigned tile = kTile * L.ld * 2;  // one C slab or B tile
  L.cb = kTile * L.ld * 4;                 // after the f32 state
  L.bt = L.cb + tile;
  L.xt = L.bt + 2 * tile;
  L.cums = L.xt + 2 * kTile * kXS * 2;
  L.dts = L.cums + qp * 4;
  L.wk = L.dts + qp * 4;
  L.total = L.wk + qp * 4;
  return L;
}

// Stage rows r0 .. r0 + 63 of a chunk into a 64-row bf16 tile of row stride
// ld: tile row r is the `cols` values at src + (r0 + r) * stride, zero past
// row `rows` (the chunk's end) and from `cols` to `width`.  16-byte cp.async
// when `vec` (cols a multiple of 8, src 16-byte aligned), else loads stored
// at once.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           int stride, int r0, int rows,
                                           int cols, int width, bool vec) {
  const int per = vec ? width / 8 : width;  // copies (or values) a row
  const int tid = threadIdx.x;
  if (vec && kThreads % per == 0) {
    // each thread keeps one 16-byte column and walks the rows, pointers
    // advanced by addition
    const int rs = kThreads / per;
    const int j = tid % per;
    const bool col_ok = j * 8 < cols;
    int r = tid / per;
    const __nv_bfloat16* at = src + (size_t)(r0 + r) * stride + j * 8;
    __nv_bfloat16* to = dst + r * ld + j * 8;
#pragma unroll 4
    for (; r < kTile; r += rs) {
      const bool ok = col_ok && r0 + r < rows;
      cp_async16(to, ok ? at : src, ok);
      at += (size_t)rs * stride;
      to += rs * ld;
    }
    return;
  }
  // any other width: element e = tid + i kThreads of the 64 x per grid,
  // its row and column advanced by addition
  const int dr = kThreads / per;
  const int dj = kThreads - dr * per;
  int r = tid / per;
  int j = tid - r * per;
  while (r < kTile) {
    const bool ok = r0 + r < rows && (vec ? j * 8 : j) < cols;
    const __nv_bfloat16* at = src + (size_t)(r0 + r) * stride;
    if (vec) {
      cp_async16(dst + r * ld + j * 8, ok ? at + j * 8 : src, ok);
    } else {
      dst[r * ld + j] = ok ? at[j] : __float2bfloat16(0.f);
    }
    r += dr;
    j += dj;
    if (j >= per) {
      j -= per;
      ++r;
    }
  }
}

// The next bf16x2 part of two float32 values: part = bf16(v) (round to
// nearest even), and v -= part, which is exact in float32.
__device__ __forceinline__ unsigned take_part(float& v0, float& v1) {
  const __nv_bfloat162 part = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(part);
  v0 -= f.x;
  v1 -= f.y;
  return *reinterpret_cast<const unsigned*>(&part);
}

// Two float32 values as bf16x2 pairs hi = bf16(v) and lo = bf16(v - hi).
__device__ __forceinline__ void split(float v0, float v1, unsigned& hi,
                                      unsigned& lo) {
  hi = take_part(v0, v1);
  lo = take_part(v0, v1);
}

// A bf16x2 fragment register times two float32 weights, in three parts:
// register r of the three fragments `part`.
__device__ __forceinline__ void scale_split3(unsigned v, float2 w,
                                             unsigned (&part)[3][4], int r) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v));
  float v0 = f.x * w.x, v1 = f.y * w.y;
#pragma unroll
  for (int i = 0; i < 3; ++i) part[i][r] = take_part(v0, v1);
}

// The chunk's dt at t0 .. t0 + Q - 1 of head h (row stride H) into dts,
// and the inclusive cumulative sum of dt A into cums; both are zero from Q
// to `len`.  `threads` is the block's size.  Ends behind a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             size_t t0, int H, int h, float a,
                                             int Q, int len, int threads,
                                             float* dts, float* cums) {
  const int tid = threadIdx.x;
  for (int t = tid; t < len; t += threads) {
    dts[t] = t < Q ? dt[(t0 + t) * H + h] : 0.f;
    if (t >= Q) cums[t] = 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    // each lane runs a contiguous run of the chunk, then the lanes' totals
    // are scanned across the warp
    const int per = (Q + 31) / 32;
    const int lo = tid * per;
    const int hi = min(lo + per, Q);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += dts[t] * a;
      cums[t] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    const float excl = incl - run;
    for (int t = lo; t < hi; ++t) cums[t] += excl;
  }
  __syncthreads();
}

// The (P, N) state from shared memory (row stride ld) out to global by the
// block's `threads` threads.
__device__ __forceinline__ void store_state(float* __restrict__ out,
                                            const float* hs, int ld, int P,
                                            int N, int threads) {
  for (int e = threadIdx.x; e < P * N; e += threads) {
    const int p = e / N;
    out[e] = hs[p * ld + (e - p * N)];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm,
                     const float* __restrict__ D, __nv_bfloat16* __restrict__ y,
                     float* __restrict__ state, int S, int H, int P, int N,
                     int Q, int vec_bc, int vec_x, int vec_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(N, Q);
  const int ld = L.ld;
  const int np = L.np;
  float* hs = reinterpret_cast<float*>(smem);  // state, row p, stride ld
  __nv_bfloat16* cb = reinterpret_cast<__nv_bfloat16*>(smem + L.cb);
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(smem + L.bt);
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(smem + L.xt);
  float* cums = reinterpret_cast<float*>(smem + L.cums);
  float* dts = reinterpret_cast<float*>(smem + L.dts);
  float* wk = reinterpret_cast<float*>(smem + L.wk);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;   // this warp's slab rows (and state rows) 16 w ..
  const int g = lane >> 2;  // accumulator fragment row
  const int c = lane & 3;   // accumulator fragment column pair
  const int tile = kTile * ld;
  const int nslab = (Q + kTile - 1) / kTile;
  const int nk = np / 16;  // 16-wide steps over N
  const size_t seq = (size_t)b * S;  // first token of this sequence
  const int xrow = H * P;
  const float a = A[h];
  const float dh = D[h];

  for (int e = tid; e < kTile * ld; e += kThreads) hs[e] = 0.f;

  // key tile k0 of the chunk at c0 (B rows, x rows) into stage st
  auto stage_tile = [&](int c0, int k0, int st) {
    stage_rows(bt + st * tile, ld, Bm + (seq + c0) * N, N, k0, Q, N, np,
               vec_bc);
    stage_rows(xt + st * kTile * kXS, kXS, x + (seq + c0) * xrow + h * P,
               xrow, k0, Q, P, kMaxP, vec_x);
  };
  auto stage_c = [&](int c0, int q0) {
    stage_rows(cb, ld, Cm + (seq + c0) * N, N, q0, Q, N, np, vec_bc);
  };

  int st = 0;  // the stage holding the current key tile
  stage_tile(0, 0, st);
  cp_async_commit();
  stage_c(0, 0);
  cp_async_commit();

  for (int c0 = 0; c0 < S; c0 += Q) {
    // dt and cums zero past the chunk: G reads whole tiles, its masked
    // entries included
    chunk_cumsum(dt, seq + c0, H, h, a, Q, nslab * kTile, kThreads, dts,
                 cums);
    const float clast = cums[Q - 1];
    // the state update's weights, zero past the chunk (read after the
    // next barrier)
    for (int t = tid; t < nslab * kTile; t += kThreads) {
      wk[t] = t < Q ? expf(clast - cums[t]) * dts[t] : 0.f;
    }

    for (int s = 0; s < nslab; ++s) {
      const int q0 = s * kTile;
      const bool last = s == nslab - 1;
      const int qa = q0 + 16 * w + g;  // this thread's accumulator rows
      const int qb = qa + 8;
      const bool rows_live = q0 + 16 * w < Q;
      cp_async_wait<0>();  // the slab's C and its first key tile
      __syncthreads();

      // y's accumulator: the warp's 16 rows x 64 p, eight m16n8 tiles,
      // started by the carried state's term (the state's rows past P are
      // zero): eight independent accumulators per C fragment
      float yacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
      }
      if (c0 > 0 && rows_live) {
#pragma unroll 2
        for (int ks = 0; ks < nk; ++ks) {
          unsigned af[4];
          ldsm_x4(af, cb + (16 * w + (lane & 15)) * ld + ks * 16 +
                          (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float* hp = hs + (8 * j + g) * ld + ks * 16 + 2 * c;
            const float2 v0 = *reinterpret_cast<const float2*>(hp);
            const float2 v1 = *reinterpret_cast<const float2*>(hp + 8);
            unsigned bh[2], bl[2];
            split(v0.x, v0.y, bh[0], bl[0]);
            split(v1.x, v1.y, bh[1], bl[1]);
            mma_bf16(yacc[j], af, bh);
            mma_bf16(yacc[j], af, bl);
          }
        }
        const float ea = qa < Q ? expf(cums[qa]) : 0.f;
        const float eb = qb < Q ? expf(cums[qb]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          yacc[j][0] *= ea;
          yacc[j][1] *= ea;
          yacc[j][2] *= eb;
          yacc[j][3] *= eb;
        }
      }

      for (int kt = 0; kt <= s; ++kt) {
        const int k0 = kt * kTile;
        if (kt > 0) {
          // this tile has landed for every thread, and every warp is done
          // with the previous tile, whose stage the next copy refills
          cp_async_wait<0>();
          __syncthreads();
        }
        // the following key tile into the other stage
        if (kt < s) {
          stage_tile(c0, k0 + kTile, st ^ 1);
        } else if (!last) {
          stage_tile(c0, 0, st ^ 1);
        } else if (c0 + Q < S) {
          stage_tile(c0 + Q, 0, st ^ 1);
        }
        cp_async_commit();
        const __nv_bfloat16* bs = bt + st * tile;
        const __nv_bfloat16* xs = xt + st * kTile * kXS;

        if (rows_live) {
          // scores of the warp's 16 rows against the tile's 64 keys
          float sc[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
          }
#pragma unroll 2
          for (int ks = 0; ks < nk; ++ks) {
            unsigned af[4];
            ldsm_x4(af, cb + (16 * w + (lane & 15)) * ld + ks * 16 +
                            (lane >> 4) * 8);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              unsigned bf[4];
              ldsm_x4(bf, bs + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) *
                                   ld +
                              ks * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(sc[2 * jj], af, bf);
              mma_bf16(sc[2 * jj + 1], af, bf + 2);
            }
          }
          // G = S exp(cums[q] - cums[k]) dt[k] where k <= q < Q (the mask
          // before the exp; __expf's error, about 2^-21 relative where the
          // decay is not negligible, is far below the split's), split into
          // the A operand of G . x: score tile j holds keys 8 j .. 8 j + 7,
          // half j % 2 of 16-key step j / 2
          unsigned gh[4][4], gl[4][4];
          const float cqa = cums[min(qa, Q - 1)];
          const float cqb = cums[min(qb, Q - 1)];
          // a tile below the diagonal with the slab inside the chunk has
          // nothing to mask (a uniform branch)
          const bool whole = kt < s && q0 + kTile <= Q;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = k0 + 8 * j + 2 * c;  // this thread's keys k, k+1
            const float2 ck = *reinterpret_cast<const float2*>(cums + k);
            const float2 dk = *reinterpret_cast<const float2*>(dts + k);
            float g0, g1, g2, g3;
            if (whole) {
              g0 = sc[j][0] * __expf(cqa - ck.x) * dk.x;
              g1 = sc[j][1] * __expf(cqa - ck.y) * dk.y;
              g2 = sc[j][2] * __expf(cqb - ck.x) * dk.x;
              g3 = sc[j][3] * __expf(cqb - ck.y) * dk.y;
            } else {
              // selects, not branches: the masked exponents are 0, then
              // the masked values 0
              const bool m0 = k <= qa && qa < Q, m1 = k + 1 <= qa && qa < Q;
              const bool m2 = k <= qb && qb < Q, m3 = k + 1 <= qb && qb < Q;
              const float e0 = __expf(m0 ? cqa - ck.x : 0.f);
              const float e1 = __expf(m1 ? cqa - ck.y : 0.f);
              const float e2 = __expf(m2 ? cqb - ck.x : 0.f);
              const float e3 = __expf(m3 ? cqb - ck.y : 0.f);
              g0 = m0 ? sc[j][0] * e0 * dk.x : 0.f;
              g1 = m1 ? sc[j][1] * e1 * dk.y : 0.f;
              g2 = m2 ? sc[j][2] * e2 * dk.x : 0.f;
              g3 = m3 ? sc[j][3] * e3 * dk.y : 0.f;
            }
            split(g0, g1, gh[j >> 1][(j & 1) * 2], gl[j >> 1][(j & 1) * 2]);
            split(g2, g3, gh[j >> 1][(j & 1) * 2 + 1],
                  gl[j >> 1][(j & 1) * 2 + 1]);
          }
          // y += G_hi x + G_lo x over the tile's keys (x's columns past P
          // are zero)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int pg = 0; pg < 4; ++pg) {
              unsigned bf[4];
              ldsm_x4_trans(bf, xs + (16 * t + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * kXS +
                                    16 * pg + (lane >> 4) * 8);
              mma_bf16(yacc[2 * pg], gh[t], bf);
              mma_bf16(yacc[2 * pg], gl[t], bf);
              mma_bf16(yacc[2 * pg + 1], gh[t], bf + 2);
              mma_bf16(yacc[2 * pg + 1], gl[t], bf + 2);
            }
          }
        }

        if (last && kt == 0) {
          __syncthreads();  // every warp has read h_in (the carried term)
        }
        if (last && 16 * w < P) {
          // h = exp(clast) h (first tile) + (w x)^T B over the tile: this
          // warp's state rows 16 w .. +16, in 64-column blocks
          const float decay = kt == 0 ? expf(clast) : 1.f;
#pragma unroll 1
          for (int nb = 0; nb < np; nb += 64) {
            float acc[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float* hp = hs + (16 * w + g) * ld + nb + 8 * j + 2 * c;
              const float2 u = *reinterpret_cast<const float2*>(hp);
              const float2 v = *reinterpret_cast<const float2*>(hp + 8 * ld);
              acc[j][0] = u.x * decay;
              acc[j][1] = u.y * decay;
              acc[j][2] = v.x * decay;
              acc[j][3] = v.y * decay;
            }
            // all four 16-key steps: rows past Q are zero, their w too
#pragma unroll
            for (int ks = 0; ks < kTile; ks += 16) {
              unsigned xf[4], ap[3][4];  // x, then x' in three parts
              ldsm_x4_trans(xf, xs + (ks + (lane & 7) + (lane >> 4) * 8) * kXS +
                                    16 * w + ((lane >> 3) & 1) * 8);
              const float2 w0 =
                  *reinterpret_cast<const float2*>(wk + k0 + ks + 2 * c);
              const float2 w1 =
                  *reinterpret_cast<const float2*>(wk + k0 + ks + 8 + 2 * c);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                scale_split3(xf[r], r < 2 ? w0 : w1, ap, r);
              }
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                unsigned bf[4];
                ldsm_x4_trans(bf, bs + (ks + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * ld +
                                      nb + 16 * jj + (lane >> 4) * 8);
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                  mma_bf16(acc[2 * jj], ap[i], bf);
                  mma_bf16(acc[2 * jj + 1], ap[i], bf + 2);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float* hp = hs + (16 * w + g) * ld + nb + 8 * j + 2 * c;
              *reinterpret_cast<float2*>(hp) =
                  make_float2(acc[j][0], acc[j][1]);
              *reinterpret_cast<float2*>(hp + 8 * ld) =
                  make_float2(acc[j][2], acc[j][3]);
            }
          }
        }
        st ^= 1;
      }
      __syncthreads();  // every warp is done with the C slab

      // the next slab's C (or the next chunk's first) while y is written
      if (!last) {
        stage_c(c0, q0 + kTile);
      } else if (c0 + Q < S) {
        stage_c(c0 + Q, 0);
      }
      cp_async_commit();
      // y = the sum + D x, D x from the slab's own rows: the diagonal key
      // tile, the stage before the current one, which no copy overwrites
      // before the next slab's first tile
      const __nv_bfloat16* xd = xt + (st ^ 1) * kTile * kXS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = hh ? qb : qa;
          const int p = 8 * j + 2 * c;
          if (q < Q && p < P) {
            const __nv_bfloat16* xq = xd + (q - q0) * kXS + p;
            const float v0 = yacc[j][2 * hh] + dh * __bfloat162float(xq[0]);
            const float v1 =
                yacc[j][2 * hh + 1] + dh * __bfloat162float(xq[1]);
            __nv_bfloat16* at = y + (seq + c0 + q) * xrow + h * P + p;
            if (vec_y) {
              *reinterpret_cast<__nv_bfloat162*>(at) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              at[0] = __float2bfloat16_rn(v0);
              if (p + 1 < P) at[1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
  }

  store_state(state + ((size_t)b * H + h) * P * N, hs, ld, P, N, kThreads);
}

// ---------------------------------------------------------------------------
// float32 instance: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;
constexpr int kLd = kTile + 1;  // padded row of a transposed tile

// floats of dynamic shared memory for one block
size_t smem_floats_f32(int P, int N, int Q) {
  return (size_t)P * (N + 1)      // hs: the carried state
         + 2 * (size_t)N * kLd    // ct, bt: C slab and B tile, transposed
         + (size_t)kTile * P      // xs: dt-scaled x tile
         + (size_t)kTile * kLd    // gs: masked, decayed scores
         + kTile                  // wk: the tile's state-update decays
         + 2 * (size_t)Q;         // cums, dts over the chunk
}

// 256 threads; each owns a 4 x 4 patch of every 64 x 64 product (rows
// ty + 16 i, columns tx + 16 j).  For a slab, the carried-state term and
// D x start the accumulator; then for each key tile at or below the
// diagonal the scores are built in registers, masked, decayed, staged in
// shared memory and multiplied into the accumulator with the tile's
// dt-scaled x; the last slab's tiles also update the state.
// One block per SM (its shared memory allows no more), so ptxas may give
// a thread up to 255 registers.
__global__ void __launch_bounds__(kThreadsF32, 1)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ D,
                    float* __restrict__ y, float* __restrict__ state, int S,
                    int H, int P, int N, int Q) {
  extern __shared__ float smem_f[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ldh = N + 1;
  float* hs = smem_f;
  float* ct = hs + (size_t)P * ldh;
  float* bt = ct + (size_t)N * kLd;
  float* xs = bt + (size_t)N * kLd;
  float* gs = xs + (size_t)kTile * P;
  float* wk = gs + (size_t)kTile * kLd;
  float* cums = wk + kTile;
  float* dts = cums + Q;

  for (int e = tid; e < P * ldh; e += kThreadsF32) hs[e] = 0.f;
  const float a = A[h];
  const float dh = D[h];
  const int nslab = (Q + kTile - 1) / kTile;
  const size_t seq = (size_t)b * S;  // first token of this sequence

  for (int c0 = 0; c0 < S; c0 += Q) {
    chunk_cumsum(dt, seq + c0, H, h, a, Q, Q, kThreadsF32, dts, cums);
    const float clast = cums[Q - 1];

    for (int s = 0; s < nslab; ++s) {
      const int q0 = s * kTile;
      for (int e = tid; e < kTile * N; e += kThreadsF32) {
        const int r = e / N;
        const int n = e - r * N;
        const int q = q0 + r;
        ct[n * kLd + r] = q < Q ? Cm[(seq + c0 + q) * N + n] : 0.f;
      }
      __syncthreads();

      // the carried state's term and D x start the accumulator
      float acc[4][4];
      {
        float sum[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ct[n * kLd + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hv[j] = hs[min(tx + 16 * j, P - 1) * ldh + n];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sum[i][j] += cv[i] * hv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            acc[i][j] = 0.f;
            if (q < Q && p < P) {
              const float xv = x[((seq + c0 + q) * H + h) * P + p];
              acc[i][j] = sum[i][j] * expf(cums[q]) + xv * dh;
            }
          }
        }
      }

      const bool last = s == nslab - 1;
      if (last) {
        __syncthreads();  // every read of h_in above is done
        const float g = expf(clast);
        for (int e = tid; e < P * N; e += kThreadsF32) {
          const int p = e / N;
          hs[p * ldh + (e - p * N)] *= g;
        }
      }

      for (int kt = 0; kt <= s; ++kt) {
        const int k0 = kt * kTile;
        for (int e = tid; e < kTile * N; e += kThreadsF32) {
          const int r = e / N;
          const int n = e - r * N;
          const int k = k0 + r;
          bt[n * kLd + r] = k < Q ? Bm[(seq + c0 + k) * N + n] : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kThreadsF32) {
          const int r = e / P;
          const int p = e - r * P;
          const int k = k0 + r;
          xs[e] = k < Q ? x[((seq + c0 + k) * H + h) * P + p] * dts[k] : 0.f;
        }
        if (last && tid < kTile) {
          const int k = k0 + tid;
          wk[tid] = k < Q ? expf(clast - cums[k]) : 0.f;
        }
        __syncthreads();

        // scores C B^T of the slab against the tile, masked, then decayed
        {
          float sc[4][4] = {};
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = ct[n * kLd + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = bt[n * kLd + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = k0 + tx + 16 * j;
              float g = 0.f;
              if (k <= q && q < Q) g = sc[i][j] * expf(cums[q] - cums[k]);
              gs[(ty + 16 * i) * kLd + tx + 16 * j] = g;
            }
          }
        }
        __syncthreads();

        for (int kk = 0; kk < kTile; ++kk) {
          float gv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = gs[(ty + 16 * i) * kLd + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xv[j] = xs[kk * P + min(tx + 16 * j, P - 1)];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += gv[i] * xv[j];
        }

        if (last) {
          // h += (wk * xs)^T B over the tile, in 64-column blocks of N
          for (int nb = 0; nb < N; nb += kTile) {
            float u[4][4] = {};
            for (int kk = 0; kk < kTile; ++kk) {
              const float w = wk[kk];
              float xv[4], bv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                xv[i] = w * xs[kk * P + min(ty + 16 * i, P - 1)];
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                bv[j] = bt[min(nb + tx + 16 * j, N - 1) * kLd + kk];
              }
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) u[i][j] += xv[i] * bv[j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int p = ty + 16 * i;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int n = nb + tx + 16 * j;
                if (p < P && n < N) hs[p * ldh + n] += u[i][j];
              }
            }
          }
        }
        __syncthreads();  // the next tile overwrites bt, xs, gs and wk
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (q < Q && p < P) y[((seq + c0 + q) * H + h) * P + p] = acc[i][j];
        }
      }
    }
  }

  store_state(state + ((size_t)b * H + h) * P * N, hs, ldh, P, N,
              kThreadsF32);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The instance's kernel with its dynamic shared memory allowed, and the
// byte count a launch at (P, N, Q) passes.
cudaError_t prepare(int bf16, int P, int N, int Q, const void** fn,
                    int* threads, size_t* bytes) {
  if (bf16) {
    *fn = reinterpret_cast<const void*>(ssd_scan_bf16_kernel);
    *threads = kThreads;
    *bytes = layout(N, Q).total;
  } else {
    *fn = reinterpret_cast<const void*>(ssd_scan_f32_kernel);
    *threads = kThreadsF32;
    *bytes = smem_floats_f32(P, N, Q) * sizeof(float);
  }
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

bool valid(int P, int N, int Q, int bf16) {
  return P >= 1 && P <= kMaxP && N >= 1 && Q >= 1 && (bf16 == 0 || bf16 == 1);
}

}  // namespace

extern "C" {

// Kernel D (replaces _ssd_kernel): x (batch, S, H, P), B and C
// (batch, S, N) contiguous, float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// dt (batch, S, H), A (H,) and D (H,) contiguous float32; y (batch, S, H, P)
// in x's type and state (batch, H, P, N) float32 out, on `stream`.  S must
// be a multiple of the chunk Q, and 1 <= P <= 64.  Returns a cudaError_t
// (0 = launched, or nothing to do when batch, S or H is 0).
int ssd_scan(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* D, void* y, void* state, int batch,
             int S, int H, int P, int N, int Q, int bf16, void* stream) {
  if (batch < 0 || S < 0 || H < 0 || !valid(P, N, Q, bf16) || S % Q != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  const void* fn = nullptr;
  int threads = 0;
  size_t bytes = 0;
  cudaError_t err = prepare(bf16, P, N, Q, &fn, &threads, &bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, batch);
  if (bf16) {
    const int vec_bc = N % 8 == 0 && aligned16(B) && aligned16(C);
    const int vec_x = P % 8 == 0 && aligned16(x);
    const int vec_y = P % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0;
    ssd_scan_bf16_kernel<<<grid, threads, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(D),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), S, H, P,
        N, Q, vec_bc, vec_x, vec_y);
  } else {
    ssd_scan_f32_kernel<<<grid, threads, bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<const float*>(D),
        static_cast<float*>(y), static_cast<float*>(state), S, H, P, N, Q);
  }
  return (int)cudaGetLastError();
}

// Blocks of the instance (bf16 == 1 or 0) that one SM holds at once at
// (P, N, Q), with the dynamic shared memory a launch there passes.
int ssd_scan_resident_blocks(int P, int N, int Q, int bf16, int* blocks) {
  if (!valid(P, N, Q, bf16)) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int threads = 0;
  size_t bytes = 0;
  cudaError_t err = prepare(bf16, P, N, Q, &fn, &threads, &bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            threads, bytes);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
