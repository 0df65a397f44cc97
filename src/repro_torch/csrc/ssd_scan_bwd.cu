// Backward of the Mamba-2 SSD chunk scan (kernel D), for NVIDIA Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference package trains Mamba-2 through
// the pure-jnp `ssd_chunked` (src/repro/models/ssm.py), whose gradient XLA's
// autodiff writes.  The port trains through kernel D (ssd_scan.cu), so this
// file computes the vector-Jacobian product of the same function (entry
// point `ssd_scan_bwd` below).
//
// What it computes.  Inputs as kernel D's forward: x (b, S, H, P),
// dt (b, S, H), A (H,), B/C (b, S, N), D (H,), chunk Q; the upstream
// gradients gy (b, S, H, P) of y, in x's type, and gstate (b, H, P, N) of
// the final state, float32.  Per sequence, head and chunk, with the
// forward's notation (cums the inclusive sum of dt A in the chunk,
// xb[k] = dt[k] x[k], S[q, k] = C[q] . B[k], L[q, k] = [k <= q]
// exp(cums[q] - cums[k]), G = L S, w[k] = exp(cums[Q-1] - cums[k]), h_in the
// chunk's entry state and dh the adjoint of its exit state):
//   dxb[k]  = sum_q G[q, k] dy[q] + w[k] dh B[k]
//   dx      = dt dxb + D dy,           dD = sum x . dy
//   dG      = dy xb^T,  M = sum_heads dG L      (B and C are shared)
//   dC[q]   = sum_k M[q, k] B[k] + sum_heads exp(cums[q]) h_in^T dy[q]
//   dB[k]   = sum_q M[q, k] C[q] + sum_heads w[k] dh^T xb[k]
//   dcums   = rows minus columns of dG G + exp(cums[q]) C[q] . h_in^T dy[q]
//             - w[k] xb[k] . dh B[k] (their sum, and exp(cums[Q-1]) <dh, h_in>,
//             at Q-1)
//   da      = the reverse cumulative sum of dcums
//   ddt     = x . dxb + A da,          dA = sum dt da
// and the adjoint passes to the previous chunk as
//   dh_in   = exp(cums[Q-1]) dh + sum_q exp(cums[q]) dy[q]^T C[q].
// dx, dB and dC are written in x's type, ddt, dA and dD in float32; every
// sum is float32, in a fixed order (no atomics: two runs give equal bits).
//
// Schedule of the bfloat16 instance (the train step's): eight launches on
// the caller's stream from one C entry (one counted launch), nine where a
// shape needs the pad copy (0).
//   0. pad (P or N not a multiple of 8 only): x, gy, B, C copied into rows
//      of a multiple of 8 values, which TMA can describe (their rows would
//      start on 2-byte boundaries, which neither TMA nor cp.async copies).
//   1. states (head, chunk, role, 128-column pass): the chunk's cums (kept
//      for the later kernels), its own state sum_k w xb^T B (role 0) or its
//      own adjoint sum_q exp(cums) dy^T C (role 1).  Chunk-parallel: the
//      entry states are recomputed here rather than saved by the forward,
//      which under remat would hold them for every layer.
//   2. scan (sequence, head, 512 state elements): walks the chunks forward
//      turning the own states into entry states and backward turning the
//      own adjoints into exit adjoints, eight chunks' loads in flight at a
//      time; writes both as three bf16 parts each (cut once here rather
//      than in every block that reads them) and <dh, h_in> a warp.
//   3. scores (tile pair kt <= qt, chunk): the chunk's scores C B^T once
//      for all heads (stored transposed), and M = sum_h dG_h L_h, the head
//      sum taken before the products with B and C so that dB and dC need no
//      per-head partials.
//   4. dc, db (64-row slab, chunk, head group of four and pass): dC and dB
//      as float32 partial sums a head group, M's terms in group 0; dc also
//      writes the carried state's term of dcums from its per-head product
//      h_in^T dy, which it needs for dC anyway.
//   5. bc_sum: the groups' partial sums in order, rounded to bf16 once.
//   6. chunk (head, chunk): dxb key tile by key tile over the query slabs
//      at or below the diagonal, the decay's gradient (sums over keys and
//      over queries into separate arrays, so no two threads add to one
//      value), dx, ddt, and this block's partial sums of dA and dD.
//   7. reduce: dA and dD over the sequences and chunks, in order.
// The float32 instance (the f32 checks) keeps the same algorithm in six
// launches (1-3, the chunk kernel with the carried term as a product of its
// own, one bc kernel over all heads, reduce), float32 states in place, and
// every product as float32 FMAs on 64 x 64 tiles from shared memory, 256
// threads each a 4 x 4 patch (rows ty + 16 i, columns tx + 16 j).  The
// mask k <= q is applied before exp in both, as in the forward.
//
// What bounds it on this card: at the train step's shapes (Mamba-2-780m,
// b = 4, S = 4096, H = 48, P = 64, N = 128, Q = 256, bf16) the function
// needs about 92 GFLOP (the scores once, dG and G^T dy once per head, five
// state products of 2 Q P N per head and chunk, M's two products; the
// carried state's term of dcums reuses dC's state term), 0.093 ms at
// bf16's 989 TFLOP/s, and moves 0.33 GB (x, gy, dx, dt, ddt, B, C, dB, dC
// once), 0.097 ms at 3.35 TB/s: bytes bound it.  The bf16 instance runs
// 247 GFLOP on the tensor cores, 2.7 times that: the float32 operands'
// two or three parts, whole diagonal tiles, and dG once in the scores
// kernel and again in the chunk kernel.  Storing dG per head for the chunk
// kernel instead would write and read 0.50 GB of float32 (64 chunks x 48
// heads x 10 tile pairs x 16 KB), some 0.3 ms at 3.35 TB/s, against four
// 64 x 64 x 64 products a tile pair to recompute it.  It keeps 0.54 GB of
// workspace (the float32 own states, their bf16 parts, scores, M; the
// dC/dB partials in the own states' room), written once and read by
// several kernels.  What the design does about the limits of its mma.sync
// predecessor (loops of small tiles between barriers at eight warps an SM,
// the float32 parts cut in every block, synchronous staging):
//   - every product of the states, scores, chunk, dc and db kernels is
//     wgmma.mma_async from one warpgroup on 64 x 64 (or x 128) tiles, and
//     operands made in registers (the scaled x and dy, G^T, M) are its
//     register A operand, so they make no round trip through shared memory;
//   - every staged tile (x, gy, B, C and the states' parts) is a TMA box
//     into a ring of swizzled slots completing on mbarriers, so no thread
//     loads a tile, and no thread branches while a product is in flight
//     (ptxas would serialize the products);
//   - the states are cut into parts once, in the scan, which also reads
//     them back for <dh, h_in> instead of float32 copies;
//   - the chunk kernel keeps nothing larger than a tile resident (dh's part
//     tiles stream for each key tile's v), 73 KB, so that three blocks
//     share an SM: the work between its products (the masked decays, the
//     parts of G^T, the decay's sums) needs the warps to hide its latency;
//   - dC and dB run as two kernels of head groups, 1,024 blocks each in
//     place of 256 that walked all 48 heads.
// chip_smoke.py times each part; PERF.md records them beside the bound.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_async.cuh"

namespace {

constexpr int kTile = 64;        // tile rows and columns
constexpr int kLd = kTile + 1;   // padded row of a staged tile
constexpr int kThreads = 256;    // 16 x 16 threads, each a 4 x 4 patch
constexpr int kMaxP = 64;        // the widest head (the forward's limit)

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round64(int v) { return (v + 63) / 64 * 64; }

// Offsets (in floats) of the workspace.  Both instances use the float32
// sections cums .. pd; the bfloat16 instance also the rest: <dh, h_in>'s
// partial sums (one a scan warp), the carried state's term of dcums (one
// array a 128-column pass of N), the entry states' and exit adjoints' bf16
// parts, the head groups' partial sums of dC and dB (in the float32
// states' room, dead once the scan has read it, where they fit), and the
// zero-padded copies of x, gy, B and C for shapes TMA cannot describe.
struct Ws {
  size_t cums, hin, dh, sc, m, pa, pd;
  size_t hd, car, ph, pdh, part, padx, padg, padb, padc, total;
  int vec, nblk, nhd, npass, n8, p8, pad_on;
};

constexpr int kBcGroups = 4;  // head groups of the dC and dB kernels

// each section starts on 16 bytes (float2 and float4 accesses)
__host__ __device__ inline size_t align4(size_t v) { return (v + 3) / 4 * 4; }
// and the bf16 instance's on 256 (TMA's bases)
__host__ __device__ inline size_t align64(size_t v) {
  return (v + 63) / 64 * 64;
}

__host__ __device__ inline Ws ws_layout(int b, int S, int H, int P, int N,
                                        int Q) {
  const size_t nc = S / Q, qp = round64(Q);
  const size_t units = (size_t)b * nc * H, bS = (size_t)b * S;
  Ws w;
  w.cums = 0;                                          // (b, S, H)
  w.hin = align4(w.cums + (size_t)b * S * H);          // (b, nc, H, P, N)
  w.dh = align4(w.hin + (size_t)b * nc * H * P * N);   // (b, nc, H, P, N)
  w.sc = align4(w.dh + (size_t)b * nc * H * P * N);    // (b, nc, qp, qp)
  w.m = w.sc + (size_t)b * nc * qp * qp;               // (b, nc, qp, qp)
  w.pa = w.m + (size_t)b * nc * qp * qp;               // (b, nc, H)
  w.pd = w.pa + (size_t)b * nc * H;                    // (b, nc, H)
  w.n8 = (N + 7) / 8 * 8;
  w.p8 = (P + 7) / 8 * 8;
  w.vec = N % 2 == 0 ? 2 : 1;  // state elements a scan thread
  w.nblk = (P * N / w.vec + kThreads - 1) / kThreads;
  w.nhd = w.nblk * (kThreads / 32);
  w.npass = (w.n8 + 127) / 128;
  w.pad_on = P % 8 != 0 || N % 8 != 0;
  w.hd = align64(w.pd + (size_t)b * nc * H);            // (units, nhd)
  w.car = align64(w.hd + units * w.nhd);                // (npass, b, S, H)
  const size_t parts = (3 * units * P * w.n8 + 1) / 2;  // (units, 3, P, n8)
  w.ph = align64(w.car + (size_t)w.npass * bS * H);
  w.pdh = align64(w.ph + parts);
  size_t end = align64(w.pdh + parts);
  const size_t part = (size_t)kBcGroups * 2 * bS * w.n8;  // (G, 2, bS, n8)
  if (part <= w.sc - w.hin) {
    w.part = w.hin;
  } else {
    w.part = end;
    end = align64(end + part);
  }
  const size_t xs = align64((bS * H * w.p8 + 1) / 2);
  const size_t bs = align64((bS * w.n8 + 1) / 2);
  w.padx = end;
  w.padg = w.padx + xs;
  w.padb = w.padg + xs;
  w.padc = w.padb + bs;
  w.total = w.pad_on ? w.padc + bs : end;
  return w;
}

// The sum over the 16 threads of one row of the 16 x 16 thread grid (the
// lanes that differ in tx), in the same order every run.
__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The block's sum of v, valid in thread 0; `red` holds a float per warp.
// Ends behind a barrier.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  }
  __syncthreads();
  return t;
}

// Warp 0: cs[t] = a sum_{u <= t} dts[u] for t < Q, each lane a contiguous
// run, then the runs' totals scanned across the warp (kernel D's order).
__device__ __forceinline__ void warp_cumsum(const float* dts, float a, int Q,
                                            float* cs) {
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int lo = lane * per;
  const int hi = min(lo + per, Q);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += dts[t] * a;
    cs[t] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - run;
  for (int t = lo; t < hi; ++t) cs[t] += excl;
}

// ---------------------------------------------------------------------------
// 1. the chunk's cums, own state and own adjoint
// ---------------------------------------------------------------------------

size_t states_floats(int Q) { return 3 * (size_t)round64(Q) + 4 * kTile * kLd; }

__global__ void __launch_bounds__(kThreads, 2)
bwd_states(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ gy,
           float* __restrict__ ws, Ws L, int S, int H, int P, int N, int Q) {
  extern __shared__ float sm[];
  const int qp = round64(Q);
  float* cs = sm;          // cums
  float* wx = cs + qp;     // dt, then w dt
  float* ec = wx + qp;     // exp(cums)
  float* xs = ec + qp;     // w dt x, rows k
  float* ys = xs + kTile * kLd;  // exp(cums) dy, rows q
  float* bs = ys + kTile * kLd;  // B, rows k, a 64-column block of N
  float* cc = bs + kTile * kLd;  // C, rows q
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;  // the chunk's first token
  const size_t hp = (size_t)H * P;

  for (int t = tid; t < qp; t += kThreads) {
    wx[t] = t < Q ? dt[(t0 + t) * H + h] : 0.f;
  }
  __syncthreads();
  if (tid < 32) warp_cumsum(wx, A[h], Q, cs);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int t = tid; t < qp; t += kThreads) {
    const bool in = t < Q;
    if (in) ws[L.cums + (t0 + t) * H + h] = cs[t];
    ec[t] = in ? expf(cs[t]) : 0.f;
    wx[t] = in ? expf(cl - cs[t]) * wx[t] : 0.f;
  }
  __syncthreads();

  const size_t at = (((size_t)b * nc + c) * H + h) * P * N;
  for (int nb = 0; nb < N; nb += kTile) {
    float as[4][4] = {}, au[4][4] = {};
    for (int k0 = 0; k0 < Q; k0 += kTile) {
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e >> 6, j = e & 63;
        const int t = k0 + r;
        const bool xok = t < Q && j < P, nok = t < Q && nb + j < N;
        const size_t xi = (t0 + t) * hp + (size_t)h * P + j;
        const size_t bi = (t0 + t) * N + nb + j;
        xs[r * kLd + j] = xok ? wx[t] * x[xi] : 0.f;
        ys[r * kLd + j] = xok ? ec[t] * gy[xi] : 0.f;
        bs[r * kLd + j] = nok ? Bm[bi] : 0.f;
        cc[r * kLd + j] = nok ? Cm[bi] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float xv[4], yv[4], bv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[i] = xs[k * kLd + ty + 16 * i];
          yv[i] = ys[k * kLd + ty + 16 * i];
          bv[i] = bs[k * kLd + tx + 16 * i];
          cv[i] = cc[k * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            as[i][j] += xv[i] * bv[j];
            au[i][j] += yv[i] * cv[j];
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nb + tx + 16 * j;
        if (p < P && n < N) {
          ws[L.hin + at + (size_t)p * N + n] = as[i][j];
          ws[L.dh + at + (size_t)p * N + n] = au[i][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. entry states forward, exit adjoints backward
// ---------------------------------------------------------------------------

// chunks whose loads a thread issues together before it walks them (the
// walk's stores would otherwise wait for each load in turn)
constexpr int kScanBatch = 8;

__global__ void __launch_bounds__(kThreads)
bwd_scan(const float* __restrict__ gstate, float* __restrict__ ws, Ws L,
         int S, int H, int P, int N, int Q) {
  const int PN = P * N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const int nc = S / Q;
  const size_t step = (size_t)H * PN;
  const size_t base = ((size_t)b * nc * H + h) * PN + e;
  const float* cums = ws + L.cums + ((size_t)b * S + Q - 1) * H + h;
  float* hin = ws + L.hin + base;
  float* dh = ws + L.dh + base;
  float own[kScanBatch], decay[kScanBatch];
  float hv = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kScanBatch) {
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c0 + i < nc) {
        own[i] = hin[(c0 + i) * step];
        decay[i] = expf(cums[(size_t)(c0 + i) * Q * H]);
      }
    }
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c0 + i < nc) {
        hin[(c0 + i) * step] = hv;
        hv = decay[i] * hv + own[i];
      }
    }
  }
  float d = gstate[((size_t)b * H + h) * PN + e];
  for (int c1 = nc - 1; c1 >= 0; c1 -= kScanBatch) {
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c1 - i >= 0) {
        own[i] = dh[(c1 - i) * step];
        decay[i] = expf(cums[(size_t)(c1 - i) * Q * H]);
      }
    }
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c1 - i >= 0) {
        dh[(c1 - i) * step] = d;
        d = decay[i] * d + own[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the scores C B^T and M = sum_h dG_h L_h, one 64 x 64 tile pair
// ---------------------------------------------------------------------------

size_t scores_floats() { return 2 * kTile * kLd + 3 * kTile; }

__global__ void __launch_bounds__(kThreads, 2)
bwd_scores(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const float* __restrict__ gy, float* __restrict__ ws, Ws L, int S,
           int H, int P, int N, int Q) {
  extern __shared__ float sm[];
  float* ta = sm;                 // C^T or dy (rows q)
  float* tb = ta + kTile * kLd;   // B^T or x^T
  float* cq = tb + kTile * kLd;   // cums at the slab's rows
  float* ck = cq + kTile;         // cums at the tile's keys
  float* dk = ck + kTile;         // dt at the tile's keys
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qp = round64(Q);
  int qt = 0;  // pair blockIdx.x -> (qt, kt), kt <= qt
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = blockIdx.x - qt * (qt + 1) / 2;
  const int q0 = qt * kTile, k0 = kt * kTile;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t hp = (size_t)H * P;
  const size_t tile = ((size_t)b * nc + c) * qp * qp + (size_t)q0 * qp + k0;

  float acc[4][4] = {};
  for (int nb = 0; nb < N; nb += kTile) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e >> 6, j = e & 63;
      const bool nok = nb + j < N;
      ta[j * kLd + r] =
          nok && q0 + r < Q ? Cm[(t0 + q0 + r) * N + nb + j] : 0.f;
      tb[j * kLd + r] =
          nok && k0 + r < Q ? Bm[(t0 + k0 + r) * N + nb + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = ta[n * kLd + ty + 16 * i];
        bv[i] = tb[n * kLd + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ws[L.sc + tile + (size_t)(ty + 16 * i) * qp + tx + 16 * j] = acc[i][j];
    }

  float m[4][4] = {};
  for (int hh = 0; hh < H; ++hh) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e >> 6, j = e & 63;
      const bool pok = j < P;
      ta[r * kLd + j] = pok && q0 + r < Q
                            ? gy[(t0 + q0 + r) * hp + (size_t)hh * P + j]
                            : 0.f;
      tb[j * kLd + r] = pok && k0 + r < Q
                            ? x[(t0 + k0 + r) * hp + (size_t)hh * P + j]
                            : 0.f;
    }
    if (tid < kTile) {
      const int q = q0 + tid;
      cq[tid] = q < Q ? ws[L.cums + (t0 + q) * H + hh] : 0.f;
    } else if (tid < 2 * kTile) {
      const int k = k0 + tid - kTile;
      ck[tid - kTile] = k < Q ? ws[L.cums + (t0 + k) * H + hh] : 0.f;
      dk[tid - kTile] = k < Q ? dt[(t0 + k) * H + hh] : 0.f;
    }
    __syncthreads();
    float g[4][4] = {};
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i] = ta[(ty + 16 * i) * kLd + p];
        xv[i] = tb[p * kLd + tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] += dv[i] * xv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        const bool ok = k <= q && q < Q;
        const float d = expf(ok ? cq[ty + 16 * i] - ck[tx + 16 * j] : 0.f);
        m[i][j] += ok ? g[i][j] * dk[tx + 16 * j] * d : 0.f;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ws[L.m + tile + (size_t)(ty + 16 * i) * qp + tx + 16 * j] = m[i][j];
    }
}

// ---------------------------------------------------------------------------
// 4. per (sequence, chunk, head): dx, ddt and the dA, dD partial sums
// ---------------------------------------------------------------------------

size_t chunk_floats(int N, int Q) {
  return 7 * (size_t)round64(Q) + (size_t)kMaxP * (N + 1) +
         (size_t)N * kLd + 3 * kTile * kLd + 16 * kTile + 16;
}

__global__ void __launch_bounds__(kThreads, 1)
bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ A, const float* __restrict__ Bm,
          const float* __restrict__ Cm, const float* __restrict__ D,
          const float* __restrict__ gy, float* __restrict__ ws, Ws L,
          float* __restrict__ dx, float* __restrict__ ddt, int S, int H, int P,
          int N, int Q) {
  extern __shared__ float sm[];
  const int qp = round64(Q);
  const int ldn = N + 1;
  float* cs = sm;              // cums
  float* dts = cs + qp;        // dt
  float* wk = dts + qp;        // w
  float* drow = wk + qp;       // row sums of dG G and the carried term
  float* dcol = drow + qp;     // column sums of dG G
  float* dxd = dcol + qp;      // x . dxb
  float* dwv = dxd + qp;       // xb . dh B
  float* st = dwv + qp;        // h_in, then dh: (64, N + 1), rows >= P zero
  float* cb = st + kMaxP * ldn;    // C^T of a slab or B^T of a tile
  float* xT = cb + (size_t)N * kLd;  // x^T of a key tile
  float* dys = xT + kTile * kLd;     // dy of a query slab
  float* gs = dys + kTile * kLd;     // the scores, then G, of a tile pair
  float* colp = gs + kTile * kLd;    // column partial sums, (16, 64)
  float* red = colp + 16 * kTile;    // 8 for block_sum, then <dh, h_in>

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nt = qp / kTile;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t hp = (size_t)H * P;
  const size_t bc = (size_t)b * nc + c;
  const float a = A[h], dd = D[h];

  for (int t = tid; t < qp; t += kThreads) {
    const bool in = t < Q;
    cs[t] = in ? ws[L.cums + (t0 + t) * H + h] : 0.f;
    dts[t] = in ? dt[(t0 + t) * H + h] : 0.f;
    drow[t] = dcol[t] = dxd[t] = dwv[t] = 0.f;
  }
  const size_t at = (bc * H + h) * P * N;
  for (int e = tid; e < kMaxP * N; e += kThreads) {
    const int p = e / N;
    st[p * ldn + e - p * N] = p < P ? ws[L.hin + at + e] : 0.f;
  }
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int t = tid; t < qp; t += kThreads) {
    wk[t] = t < Q ? expf(cl - cs[t]) : 0.f;
  }

  // stage the C slab at q0 (transposed) and its dy
  auto stage_slab = [&](int q0, bool with_c) {
    if (with_c) {
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        cb[n * kLd + r] = q0 + r < Q ? Cm[(t0 + q0 + r) * N + n] : 0.f;
      }
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e >> 6, j = e & 63;
      dys[r * kLd + j] = j < P && q0 + r < Q
                             ? gy[(t0 + q0 + r) * hp + (size_t)h * P + j]
                             : 0.f;
    }
  };

  // the carried state's term of dcums: dy[q] . exp(cums[q]) h_in C[q]
  for (int qt = 0; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    stage_slab(q0, true);
    __syncthreads();
    float yo[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cv[i] = cb[n * kLd + ty + 16 * i];
        hv[i] = st[(tx + 16 * i) * ldn + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yo[i][j] += cv[i] * hv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += dys[r * kLd + tx + 16 * j] * yo[i][j];
      s = sum16(s);
      if (tx == 0 && q0 + r < Q) drow[q0 + r] += expf(cs[q0 + r]) * s;
    }
    __syncthreads();
  }

  // dh in h_in's place, and <dh, h_in>
  float hd = 0.f;
  for (int e = tid; e < kMaxP * N; e += kThreads) {
    const int p = e / N;
    const int i = p * ldn + e - p * N;
    const float v = p < P ? ws[L.dh + at + e] : 0.f;
    hd += v * st[i];
    st[i] = v;
  }
  hd = block_sum(hd, red);
  if (tid == 0) red[8] = hd;

  float dDp = 0.f;
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTile;
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      cb[n * kLd + r] = k0 + r < Q ? Bm[(t0 + k0 + r) * N + n] : 0.f;
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e >> 6, j = e & 63;
      xT[j * kLd + r] = j < P && k0 + r < Q
                            ? x[(t0 + k0 + r) * hp + (size_t)h * P + j]
                            : 0.f;
    }
    __syncthreads();
    // v = dh B[k] (rows k, columns p); dw[k] = dt[k] x[k] . v[k]; the
    // accumulator of dxb starts at w[k] v[k]
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float bv[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bv[i] = cb[n * kLd + ty + 16 * i];
        hv[i] = st[(tx + 16 * i) * ldn + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += bv[i] * hv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += xT[(tx + 16 * j) * kLd + r] * acc[i][j];
      s = sum16(s);
      if (tx == 0) dwv[k0 + r] = dts[k0 + r] * s;
      const float wr = wk[k0 + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= wr;
    }

    float dyk[4][4] = {};  // dy at the tile's own rows
    for (int qt = kt; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      const float* sc = ws + L.sc + bc * qp * qp + (size_t)q0 * qp + k0;
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e >> 6, j = e & 63;
        gs[r * kLd + j] = sc[(size_t)r * qp + j];
      }
      stage_slab(q0, false);
      __syncthreads();
      // dG = dt[k] dy[q] . x[k], then dG G (masked before the exp)
      float g[4][4], dg[4][4] = {};
      for (int p = 0; p < P; ++p) {
        float dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i] = dys[(ty + 16 * i) * kLd + p];
          xv[i] = xT[p * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dg[i][j] += dv[i] * xv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, q = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j, k = k0 + cc;
          const bool ok = k <= q && q < Q;
          const float d = expf(ok ? cs[q] - cs[k] : 0.f);
          g[i][j] = ok ? gs[r * kLd + cc] * d : 0.f;
          dg[i][j] *= dts[k] * g[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = dg[i][0] + dg[i][1] + dg[i][2] + dg[i][3];
        s = sum16(s);
        if (tx == 0) drow[q0 + ty + 16 * i] += s;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        colp[ty * kTile + tx + 16 * j] = dg[0][j] + dg[1][j] + dg[2][j] +
                                         dg[3][j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gs[(ty + 16 * i) * kLd + tx + 16 * j] = g[i][j];
        }
      __syncthreads();
      if (tid < kTile) {
        float s = 0.f;
        for (int y = 0; y < 16; ++y) s += colp[y * kTile + tid];
        dcol[k0 + tid] += s;
      }
      // dxb += G^T dy over the slab (rows k, columns p)
#pragma unroll 4
      for (int q = 0; q < kTile; ++q) {
        float gv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i] = gs[q * kLd + ty + 16 * i];
          dv[i] = dys[q * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += gv[i] * dv[j];
      }
      if (qt == kt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dyk[i][j] = dys[(ty + 16 * i) * kLd + tx + 16 * j];
            dDp += xT[(tx + 16 * j) * kLd + ty + 16 * i] * dyk[i][j];
          }
      }
      __syncthreads();
    }

    // dx = dt dxb + D dy; x . dxb for ddt
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, k = k0 + r;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += xT[(tx + 16 * j) * kLd + r] * acc[i][j];
      s = sum16(s);
      if (tx == 0) dxd[k] = s;
      if (k < Q) {
        const float dk = dts[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) {
            dx[(t0 + k) * hp + (size_t)h * P + p] =
                dk * acc[i][j] + dd * dyk[i][j];
          }
        }
      }
    }
    __syncthreads();  // the next tile restages cb and xT
  }

  // dcums, da (its reverse cumulative sum), ddt, and the partial sums
  dDp = block_sum(dDp, red);
  if (tid < 32) {
    const int lane = tid;
    float sw = 0.f;
    for (int t = lane; t < Q; t += 32) sw += wk[t] * dwv[t];
    sw = warp_sum(sw);
    const float last = sw + expf(cl) * red[8];
    const int per = (Q + 31) / 32;
    const int lo = lane * per;
    const int hi = min(lo + per, Q);
    float run = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      run += drow[t] - dcol[t] - wk[t] * dwv[t] + (t == Q - 1 ? last : 0.f);
      drow[t] = run;
    }
    float incl = run;  // this lane's run and every later lane's
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    const float excl = incl - run;
    float pa = 0.f;
    for (int t = lo; t < hi; ++t) {
      const float da = drow[t] + excl;
      ddt[(t0 + t) * H + h] = dxd[t] + a * da;
      pa += dts[t] * da;
    }
    pa = warp_sum(pa);
    if (lane == 0) {
      ws[L.pa + bc * H + h] = pa;
      ws[L.pd + bc * H + h] = dDp;
    }
  }
}

// ---------------------------------------------------------------------------
// 5. dB and dC of one 64-row slab of a chunk
// ---------------------------------------------------------------------------

size_t bc_floats() { return 4 * kTile * kLd + 2 * kTile; }

__global__ void __launch_bounds__(kThreads, 2)
bwd_bc(const float* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ Bm, const float* __restrict__ Cm,
       const float* __restrict__ gy, const float* __restrict__ ws, Ws L,
       float* __restrict__ dB, float* __restrict__ dC, int S, int H, int P, int N,
       int Q) {
  extern __shared__ float sm[];
  float* t0s = sm;                 // M tile; then exp(cums) dy
  float* t1s = t0s + kTile * kLd;  // B or C tile; then w dt x
  float* t2s = t1s + kTile * kLd;  // h_in block
  float* t3s = t2s + kTile * kLd;  // dh block
  float* eq = t3s + kTile * kLd;   // exp(cums) at the slab's rows
  float* wq = eq + kTile;          // w dt at the slab's rows
  const int s = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qp = round64(Q), nt = qp / kTile;
  const int r0 = s * kTile;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t hp = (size_t)H * P;
  const size_t bc = (size_t)b * nc + c;
  const float* m = ws + L.m + bc * qp * qp;

  for (int nb = 0; nb < N; nb += kTile) {
    float aC[4][4] = {}, aB[4][4] = {};
    // dC[r] += sum_k M[r, k] B[k] over the key tiles at or below the slab
    for (int kt = 0; kt <= s; ++kt) {
      const int k0 = kt * kTile;
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e >> 6, j = e & 63;
        t0s[r * kLd + j] = m[(size_t)(r0 + r) * qp + k0 + j];
        t1s[r * kLd + j] = k0 + r < Q && nb + j < N
                               ? Bm[(t0 + k0 + r) * N + nb + j]
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float mv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mv[i] = t0s[(ty + 16 * i) * kLd + k];
          bv[i] = t1s[k * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) aC[i][j] += mv[i] * bv[j];
      }
      __syncthreads();
    }
    // dB[r] += sum_q M[q, r] C[q] over the query slabs at or above it
    for (int qt = s; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e >> 6, j = e & 63;
        t0s[r * kLd + j] = m[(size_t)(q0 + r) * qp + r0 + j];
        t1s[r * kLd + j] = q0 + r < Q && nb + j < N
                               ? Cm[(t0 + q0 + r) * N + nb + j]
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < kTile; ++q) {
        float mv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mv[i] = t0s[q * kLd + ty + 16 * i];
          cv[i] = t1s[q * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) aB[i][j] += mv[i] * cv[j];
      }
      __syncthreads();
    }
    // the state terms, head by head: dC[r] += exp(cums[r]) dy[r] h_in,
    // dB[r] += w[r] dt[r] x[r] dh
    for (int hh = 0; hh < H; ++hh) {
      if (tid < kTile) {
        const int t = r0 + tid;
        const float cl = ws[L.cums + (t0 + Q - 1) * H + hh];
        const float ct = t < Q ? ws[L.cums + (t0 + t) * H + hh] : 0.f;
        eq[tid] = t < Q ? expf(ct) : 0.f;
        wq[tid] = t < Q ? expf(cl - ct) * dt[(t0 + t) * H + hh] : 0.f;
      }
      __syncthreads();
      const size_t at = (bc * H + hh) * P * N;
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e >> 6, j = e & 63;
        const bool rok = r0 + r < Q && j < P;
        const size_t xi = (t0 + r0 + r) * hp + (size_t)hh * P + j;
        t0s[r * kLd + j] = rok ? eq[r] * gy[xi] : 0.f;
        t1s[r * kLd + j] = rok ? wq[r] * x[xi] : 0.f;
        const bool sok = r < P && nb + j < N;
        const size_t si = at + (size_t)r * N + nb + j;
        t2s[r * kLd + j] = sok ? ws[L.hin + si] : 0.f;
        t3s[r * kLd + j] = sok ? ws[L.dh + si] : 0.f;
      }
      __syncthreads();
      for (int p = 0; p < P; ++p) {
        float yv[4], xv[4], hv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yv[i] = t0s[(ty + 16 * i) * kLd + p];
          xv[i] = t1s[(ty + 16 * i) * kLd + p];
          hv[i] = t2s[p * kLd + tx + 16 * i];
          dv[i] = t3s[p * kLd + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            aC[i][j] += yv[i] * hv[j];
            aB[i][j] += xv[i] * dv[j];
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nb + tx + 16 * j;
        if (t < Q && n < N) {
          dC[(t0 + t) * N + n] = aC[i][j];
          dB[(t0 + t) * N + n] = aB[i][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 instance: wgmma on 128-byte swizzled tiles that TMA stages
// ---------------------------------------------------------------------------
//
// One warpgroup a block (128 threads, warp w on rows 16 w .. 16 w + 15 of
// every 64-row tile).  The states, scores, chunk, dc and db kernels run
// every product as wgmma.mma_async (sm90_async.cuh): B always, and A where
// it is an exact bf16 input (x, dy, B, C), from 128-byte swizzled
// shared-memory tiles that TMA copies in rings of kStages slots, each
// completing on an mbarrier; thread 0 refills a slot once the whole block
// is done with it.  A float32 operand made in registers (the scaled x and
// dy, G^T, M) is fed as wgmma's register A operand, cut into bf16 parts
// there (hi = bf16(v), then the remainders; the forward's rule).
// Fragment (j, e) of a warp's 16 x 8n accumulator is row g (e < 2) or
// g + 8 and column 8 j + 2 c + (e & 1), g = lane / 4, c = lane % 4; the
// register A operand is mma.sync.m16n8k16's A fragment, so an
// accumulator's columns 16 s .. 16 s + 15 are the A operand of k16 step s
// with no shuffle.

constexpr int kThreadsTc = 128;  // one warpgroup
constexpr int kWarps = kThreadsTc / 32;
constexpr int kStages = 2;       // slots of a TMA ring

// The TMA descriptions of one call's operands: x and gy as
// (P, H, Q, chunks) with 64 x 1 x 64 x 1 boxes, B and C as (N, Q, chunks)
// with 64 x 64 x 1 boxes, the states' bf16 parts as (N, P, 3 units) with
// 64 x 64 x 1 boxes; every box a swizzled tile, zero past the edges.
struct TcMaps {
  CUtensorMap x, gy, b, c, hin, dh;
};

// the dynamic shared memory's first 1024-byte boundary (swizzled tiles)
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const unsigned a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}
__device__ __forceinline__ float2 bf2(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// elements (r, c), (r, c + 1) of a swizzled tile (c even)
__device__ __forceinline__ unsigned lds_bf2(const unsigned char* t, int r,
                                            int c) {
  return *reinterpret_cast<const unsigned*>(t + sw128(r, c));
}
// wgmma's register A (rows m0 .., depth k0 ..) from a swizzled tile stored
// [K][M]
__device__ __forceinline__ void lda_sw_trans(unsigned* a,
                                             const unsigned char* t, int m0,
                                             int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(a, t + sw128(k0 + (lane & 7) + (lane >> 4) * 8,
                             m0 + ((lane >> 3) & 1) * 8));
}

// The next bf16x2 part of two float32 values (kernel D's take_part).
__device__ __forceinline__ unsigned take_part(float& v0, float& v1) {
  const __nv_bfloat162 part = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(part);
  v0 -= f.x;
  v1 -= f.y;
  return *reinterpret_cast<const unsigned*>(&part);
}

// Sum over the four lanes of a fragment row (the lanes that differ in c).
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
// Sum over the eight lanes of a fragment column (the lanes that differ in g).
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// 0'. Shapes TMA cannot describe (P or N not a multiple of 8: rows that
// start on 2-byte boundaries, which neither TMA nor cp.async copies): x,
// gy, B and C into rows of P8 and N8 values in the workspace, zero-padded.
__global__ void __launch_bounds__(kThreads)
bwd_pad(const bf16* __restrict__ x, const bf16* __restrict__ gy,
        const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
        float* __restrict__ ws, Ws L, size_t rows_x, int P, size_t rows_b,
        int N) {
  bf16* px = reinterpret_cast<bf16*>(ws + L.padx);
  bf16* pg = reinterpret_cast<bf16*>(ws + L.padg);
  bf16* pb = reinterpret_cast<bf16*>(ws + L.padb);
  bf16* pc = reinterpret_cast<bf16*>(ws + L.padc);
  const size_t step = (size_t)gridDim.x * kThreads;
  const bf16 zero = __float2bfloat16(0.f);
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < rows_x * L.p8; i += step) {
    const size_t r = i / L.p8;
    const int j = (int)(i - r * L.p8);
    px[i] = j < P ? x[r * P + j] : zero;
    pg[i] = j < P ? gy[r * P + j] : zero;
  }
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < rows_b * L.n8; i += step) {
    const size_t r = i / L.n8;
    const int j = (int)(i - r * L.n8);
    pb[i] = j < N ? Bm[r * N + j] : zero;
    pc[i] = j < N ? Cm[r * N + j] : zero;
  }
}

// 1'. states: s = (w dt x)^T B (role 0) and u = (exp(cums) dy)^T C (role
// 1), per (head, chunk, role and 128-column pass of N): A = the key tile
// of x or dy through ldmatrix.trans, scaled and cut into three parts in
// registers; B = the B or C tile, MN-major; nb = 2 gives m64n128.
template <int nb>
size_t states_tc_bytes(int Q) {
  return 1024 + (size_t)kStages * (1 + nb) * kSwTile + 8 * kStages +
         2 * (size_t)round64(Q) * 4;
}

template <int nb>
__global__ void __launch_bounds__(kThreadsTc)
bwd_states_tc(const __grid_constant__ TcMaps maps,
              const float* __restrict__ dt, const float* __restrict__ A,
              float* __restrict__ ws, Ws L, int S, int H, int P, int N,
              int Q) {
  extern __shared__ unsigned char smem_tc[];
  constexpr int kSlot = (1 + nb) * kSwTile;  // the x or dy tile, then B or C
  unsigned char* ring = align_1k(smem_tc);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlot);
  const int qp = round64(Q), nt = qp / kTile;
  float* cs = reinterpret_cast<float*>(full + kStages);  // cums
  float* sc = cs + qp;  // dt, then the row scale: w dt or exp(cums)
  const int h = blockIdx.x, ch = blockIdx.y;
  const int role = blockIdx.z & 1, n0 = (blockIdx.z >> 1) * 2 * kTile;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const size_t t0 = (size_t)ch * Q;
  const CUtensorMap* mo = role ? &maps.gy : &maps.x;
  const CUtensorMap* mn = role ? &maps.c : &maps.b;

  auto fetch = [&](int kt) {
    unsigned char* slot = ring + (kt % kStages) * kSlot;
    uint64_t* bar = full + kt % kStages;
    mbar_expect_tx(bar, kSlot);
    tma_load_4d(slot, mo, bar, 0, h, kt * kTile, ch);
    for (int j = 0; j < nb; ++j) {
      tma_load_3d(slot + (1 + j) * kSwTile, mn, bar, n0 + j * kTile,
                  kt * kTile, ch);
    }
  };
  for (int t = tid; t < qp; t += kThreadsTc) {
    sc[t] = t < Q ? dt[(t0 + t) * H + h] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int kt = 0; kt < kStages && kt < nt; ++kt) fetch(kt);
  }
  if (tid < 32) warp_cumsum(sc, A[h], Q, cs);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int t = tid; t < qp; t += kThreadsTc) {
    const bool in = t < Q;
    if (in && role == 0 && n0 == 0) ws[L.cums + (t0 + t) * H + h] = cs[t];
    sc[t] = in ? (role ? expf(cs[t]) : expf(cl - cs[t]) * sc[t]) : 0.f;
  }
  __syncthreads();

  float acc[nb * 32];
#pragma unroll
  for (int i = 0; i < nb * 32; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nt; ++kt) {
    const int st = kt % kStages;
    const unsigned char* slot = ring + st * kSlot;
    mbar_wait(full + st, (kt / kStages) & 1);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned a[4];
      lda_sw_trans(a, slot, 16 * w, 16 * s);
      const int k = kt * kTile + 16 * s + 2 * cc;
      const float s0 = sc[k], s1 = sc[k + 1], s8 = sc[k + 8], s9 = sc[k + 9];
      float v[8];
      float2 f = bf2(a[0]);
      v[0] = f.x * s0;
      v[1] = f.y * s1;
      f = bf2(a[1]);
      v[2] = f.x * s0;
      v[3] = f.y * s1;
      f = bf2(a[2]);
      v[4] = f.x * s8;
      v[5] = f.y * s9;
      f = bf2(a[3]);
      v[6] = f.x * s8;
      v[7] = f.y * s9;
      unsigned pa[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[i][r] = take_part(v[2 * r], v[2 * r + 1]);
      }
      const uint64_t db = sw128_desc(slot + kSwTile + 2048 * s, kSwTile);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 3; ++i) wgmma_rs<nb>(acc, pa[i], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(acc);
    fence_proxy_async();
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && kt + kStages < nt) fetch(kt + kStages);
  }
  float* out = ws + (role ? L.dh : L.hin) + ((size_t)ch * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < nb * 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 16 * w + g + (e >> 1) * 8;
      const int n = n0 + 8 * j + 2 * cc + (e & 1);
      if (p < P && n < N) out[(size_t)p * N + n] = acc[4 * j + e];
    }
  }
}

// 2'. the bf16 instance's scan: the own states into entry states forward,
// the own adjoints into exit adjoints backward, as in 2, each written as
// three bf16 parts, [unit][part][p][n8], that the later kernels load with
// TMA as they are (cut once here rather than in every block that reads
// them); kVec neighbouring elements a thread (2 where N is even).  For
// <dh, h_in> the backward walk reads the entry states back from their
// parts (hi + mid + lo is within 2^-27 of the float32 value) and each
// warp writes its share, so no block barrier stands in the walk.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
bwd_scan_tc(const float* __restrict__ gstate, float* __restrict__ ws, Ws L,
            int S, int H, int P, int N, int Q) {
  const int PN = P * N;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool on = e < PN;
  const int nc = S / Q;
  const size_t step = (size_t)H * PN;
  const size_t base = ((size_t)b * nc * H + h) * PN + (on ? e : 0);
  const float* cums = ws + L.cums + ((size_t)b * S + Q - 1) * H + h;
  const float* own_s = ws + L.hin + base;
  const float* own_u = ws + L.dh + base;
  const int p = on ? e / N : 0, n = on ? e - p * N : 0;
  const size_t plane = (size_t)P * L.n8;
  const size_t pstep = (size_t)H * 3 * plane;  // the next chunk's unit
  const size_t pbase =
      ((size_t)b * nc * H + h) * 3 * plane + (size_t)p * L.n8 + n;
  bf16* ph = reinterpret_cast<bf16*>(ws + L.ph) + pbase;
  bf16* pd = reinterpret_cast<bf16*>(ws + L.pdh) + pbase;
  float* hd = ws + L.hd + ((size_t)b * nc * H + h) * L.nhd +
              blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);

  auto load = [](const float* src, float (&v)[kVec]) {
    if constexpr (kVec == 2) {
      const float2 f = *reinterpret_cast<const float2*>(src);
      v[0] = f.x;
      v[1] = f.y;
    } else {
      v[0] = *src;
    }
  };
  auto put3 = [&](bf16* dst, const float (&v)[kVec]) {
    float r[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) r[k] = v[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if constexpr (kVec == 2) {
        const unsigned part = take_part(r[0], r[1]);
        *reinterpret_cast<unsigned*>(dst + i * plane) = part;
      } else {
        const bf16 part = __float2bfloat16_rn(r[0]);
        dst[i * plane] = part;
        r[0] -= __bfloat162float(part);
      }
    }
  };
  auto get3 = [&](const bf16* src, float (&v)[kVec]) {
    float part[3][kVec];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if constexpr (kVec == 2) {
        const float2 f =
            bf2(*reinterpret_cast<const unsigned*>(src + i * plane));
        part[i][0] = f.x;
        part[i][1] = f.y;
      } else {
        part[i][0] = __bfloat162float(src[i * plane]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = (part[0][k] + part[1][k]) + part[2][k];
  };

  float own[kScanBatch][kVec], decay[kScanBatch], hv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) hv[k] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kScanBatch) {
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c0 + i < nc) {
        if (on) load(own_s + (c0 + i) * step, own[i]);
        decay[i] = expf(cums[(size_t)(c0 + i) * Q * H]);
      }
    }
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c0 + i < nc && on) {
        put3(ph + (c0 + i) * pstep, hv);
#pragma unroll
        for (int k = 0; k < kVec; ++k) hv[k] = decay[i] * hv[k] + own[i][k];
      }
    }
  }
  float d[kVec], hs[kScanBatch][kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) d[k] = 0.f;
  if (on) load(gstate + ((size_t)b * H + h) * PN + e, d);
  for (int c1 = nc - 1; c1 >= 0; c1 -= kScanBatch) {
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c1 - i >= 0) {
        if (on) {
          load(own_u + (c1 - i) * step, own[i]);
          get3(ph + (c1 - i) * pstep, hs[i]);
        }
        decay[i] = expf(cums[(size_t)(c1 - i) * Q * H]);
      }
    }
#pragma unroll
    for (int i = 0; i < kScanBatch; ++i) {
      if (c1 - i >= 0) {
        float s = 0.f;
        if (on) {
          put3(pd + (c1 - i) * pstep, d);
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            s += d[k] * hs[i][k];
            d[k] = decay[i] * d[k] + own[i][k];
          }
        }
        s = warp_sum(s);
        if ((threadIdx.x & 31) == 0) hd[(c1 - i) * H * L.nhd] = s;
      }
    }
  }
}

// 3'. scores and M, one tile pair (query slab qt, key tile kt <= qt) a
// block: the scores C B^T once (stored transposed, [k][q], for the chunk
// kernel), then head by head dG = dy x^T (exact) and M += dG dt[k] L; the
// dy slabs and x tiles in a TMA ring, every head's cums and dt for the
// pair in shared memory from the start.
size_t scores_tc_bytes(int nbk, int H) {
  return 1024 + (size_t)(2 * nbk + 2 * kStages) * kSwTile +
         8 * (kStages + 1) + 3 * (size_t)kTile * H * 4;
}

__global__ void __launch_bounds__(kThreadsTc)
bwd_scores_tc(const __grid_constant__ TcMaps maps,
              const float* __restrict__ dt, float* __restrict__ ws, Ws L,
              int H, int Q, int nbk) {
  extern __shared__ unsigned char smem_tc[];
  unsigned char* cb = align_1k(smem_tc);   // C slab [q][n], nbk tiles
  unsigned char* bb = cb + nbk * kSwTile;  // B tile [k][n]
  unsigned char* ring = bb + nbk * kSwTile;  // dy slab [q][p], x tile [k][p]
  constexpr int kSlot = 2 * kSwTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlot);
  uint64_t* sbar = full + kStages;
  float* cqt = reinterpret_cast<float*>(sbar + 1);  // [H][64] cums, rows q
  float* ckt = cqt + H * kTile;                     // cums at the keys
  float* dkt = ckt + H * kTile;                     // dt at the keys
  const int ch = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const int qp = round64(Q);
  int qt = 0;  // pair blockIdx.x -> (qt, kt), kt <= qt
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = (int)blockIdx.x - qt * (qt + 1) / 2;
  const int q0 = qt * kTile, k0 = kt * kTile;
  const size_t t0 = (size_t)ch * Q;
  const size_t tile = (size_t)ch * qp * qp;
  const int ra = 16 * w + g, rb = ra + 8;

  auto fetch = [&](int hh) {
    unsigned char* slot = ring + (hh % kStages) * kSlot;
    uint64_t* bar = full + hh % kStages;
    mbar_expect_tx(bar, kSlot);
    tma_load_4d(slot, &maps.gy, bar, 0, hh, q0, ch);
    tma_load_4d(slot + kSwTile, &maps.x, bar, 0, hh, k0, ch);
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(full + i);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, 2 * nbk * kSwTile);
    for (int j = 0; j < nbk; ++j) {
      tma_load_3d(cb + j * kSwTile, &maps.c, sbar, j * kTile, q0, ch);
      tma_load_3d(bb + j * kSwTile, &maps.b, sbar, j * kTile, k0, ch);
    }
    for (int i = 0; i < kStages && i < H; ++i) fetch(i);
  }
  for (int e = tid; e < kTile * H; e += kThreadsTc) {
    const int r = e / H, hh = e - r * H;
    const int q = q0 + r, k = k0 + r;
    cqt[hh * kTile + r] = q < Q ? ws[L.cums + (t0 + q) * H + hh] : 0.f;
    ckt[hh * kTile + r] = k < Q ? ws[L.cums + (t0 + k) * H + hh] : 0.f;
    dkt[hh * kTile + r] = k < Q ? dt[(t0 + k) * H + hh] : 0.f;
  }
  __syncthreads();

  // the scores, K = N; stored transposed
  {
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(sbar, 0);
    wgmma_fence();
    for (int s = 0; s < 4 * nbk; ++s) {
      const int o = (s >> 2) * kSwTile + 32 * (s & 3);
      wgmma_ss<1, 0>(sc, sw128_desc(cb + o, 16), sw128_desc(bb + o, 16),
                        1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 8 * j + 2 * cc + (e & 1);
        const int q = q0 + (e < 2 ? ra : rb);
        ws[L.sc + tile + (size_t)k * qp + q] = sc[4 * j + e];
      }
    }
  }

  // M = sum_h dG_h dt[k] L_h at this thread's entries, head by head
  float m[32], dg[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) m[i] = dg[i] = 0.f;
  const int qa = q0 + ra, qb = q0 + rb;
  for (int hh = 0; hh < H; ++hh) {
    const unsigned char* slot = ring + (hh % kStages) * kSlot;
    mbar_wait(full + hh % kStages, (hh / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_ss<1, 0>(dg, sw128_desc(slot + 32 * s, 16),
                        sw128_desc(slot + kSwTile + 32 * s, 16), s != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(dg);
    fence_proxy_async();
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && hh + kStages < H) fetch(hh + kStages);
    const float cqa = cqt[hh * kTile + ra], cqb = cqt[hh * kTile + rb];
    const float* ck = ckt + hh * kTile;
    const float* dk = dkt + hh * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = 8 * j + 2 * cc, k = k0 + kk;
      const float2 c2 = *reinterpret_cast<const float2*>(ck + kk);
      const float2 d2 = *reinterpret_cast<const float2*>(dk + kk);
      const bool m0 = k <= qa && qa < Q, m1 = k + 1 <= qa && qa < Q;
      const bool m2 = k <= qb && qb < Q, m3 = k + 1 <= qb && qb < Q;
      m[4 * j] += m0 ? dg[4 * j] * d2.x * __expf(cqa - c2.x) : 0.f;
      m[4 * j + 1] += m1 ? dg[4 * j + 1] * d2.y * __expf(cqa - c2.y) : 0.f;
      m[4 * j + 2] += m2 ? dg[4 * j + 2] * d2.x * __expf(cqb - c2.x) : 0.f;
      m[4 * j + 3] += m3 ? dg[4 * j + 3] * d2.y * __expf(cqb - c2.y) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + 8 * j + 2 * cc;
    *reinterpret_cast<float2*>(ws + L.m + tile + (size_t)(q0 + ra) * qp + k) =
        make_float2(m[4 * j], m[4 * j + 1]);
    *reinterpret_cast<float2*>(ws + L.m + tile + (size_t)(q0 + rb) * qp + k) =
        make_float2(m[4 * j + 2], m[4 * j + 3]);
  }
}

// 5'. dC (role 0) and dB (role 1) of one 64-row slab of a chunk, per head
// group and 128-column pass, as float32 partial sums that bwd_bc_sum adds
// in order.  Group 0 first takes M's terms: dC += M B over the key tiles at
// or below the slab, dB += M^T C over the query slabs at or above it, M in
// two parts from global memory as register A, B and C MN-major.  Then
// head by head: dC += exp(cums) (dy h_in), dB += w dt (x dh), dy or x the
// slab's tile (K-major A) and the state's parts (h_in three, dh two)
// MN-major B.  Role 0 also writes the carried state's term of dcums,
// exp(cums[t]) C[t] . (dy h_in)[t], for the chunk kernel.
template <int kRole, int nb>
__host__ __device__ constexpr int bc_slot() {
  return (1 + (kRole == 0 ? 3 : 2) * nb) * kSwTile;
}
template <int kRole, int nb>
size_t bc_tc_bytes() {
  return 1024 + (size_t)kStages * bc_slot<kRole, nb>() +
         (kRole == 0 ? nb * kSwTile : 0) + 8 * (kStages + 1);
}

template <int kRole, int nb>
__device__ __forceinline__ void bc_body(const TcMaps& maps,
                                        const float* __restrict__ dt,
                                        float* __restrict__ ws, const Ws& L,
                                        int H, int Q) {
  extern __shared__ unsigned char smem_tc[];
  constexpr int kParts = kRole == 0 ? 3 : 2;
  constexpr int kSlot = bc_slot<kRole, nb>();
  unsigned char* ring = align_1k(smem_tc);
  unsigned char* ct = ring + kStages * kSlot;  // role 0: the slab's C
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ct + (kRole == 0 ? nb * kSwTile : 0));
  uint64_t* cbar = full + kStages;
  const int s = blockIdx.x, ch = blockIdx.y;
  const int grp = blockIdx.z % kBcGroups;
  const int pass = blockIdx.z / kBcGroups, n0 = pass * 2 * kTile;
  const int qp = round64(Q), nt = qp / kTile, r0 = s * kTile;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const size_t t0 = (size_t)ch * Q, bS = (size_t)gridDim.y * Q;
  const float* m = ws + L.m + (size_t)ch * qp * qp;
  const int h_lo = grp * H / kBcGroups, h_hi = (grp + 1) * H / kBcGroups;
  const int nm = grp == 0 ? (kRole == 0 ? s + 1 : nt - s) : 0;
  const int items = nm + h_hi - h_lo;
  const CUtensorMap* mt = kRole == 0 ? &maps.b : &maps.c;
  const CUtensorMap* mx = kRole == 0 ? &maps.gy : &maps.x;
  const CUtensorMap* mp = kRole == 0 ? &maps.hin : &maps.dh;

  // item i: M's operand tile (i < nm), else head h_lo + i - nm's slab tile
  // and state parts
  auto fetch = [&](int i) {
    unsigned char* slot = ring + (i % kStages) * kSlot;
    uint64_t* bar = full + i % kStages;
    if (i < nm) {
      const int t = kRole == 0 ? i : s + i;
      mbar_expect_tx(bar, nb * kSwTile);
      for (int j = 0; j < nb; ++j) {
        tma_load_3d(slot + j * kSwTile, mt, bar, n0 + j * kTile, t * kTile,
                    ch);
      }
    } else {
      const int hh = h_lo + i - nm, unit = ch * H + hh;
      mbar_expect_tx(bar, kSlot);
      tma_load_4d(slot, mx, bar, 0, hh, r0, ch);
      for (int pi = 0; pi < kParts; ++pi) {
        for (int j = 0; j < nb; ++j) {
          tma_load_3d(slot + (1 + pi * nb + j) * kSwTile, mp, bar,
                      n0 + j * kTile, 0, unit * 3 + pi);
        }
      }
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(full + i);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (kRole == 0) {
      mbar_expect_tx(cbar, nb * kSwTile);
      for (int j = 0; j < nb; ++j) {
        tma_load_3d(ct + j * kSwTile, &maps.c, cbar, n0 + j * kTile, r0, ch);
      }
    }
    for (int i = 0; i < kStages && i < items; ++i) fetch(i);
  }
  const int ra = 16 * w + g, rb = ra + 8;  // this thread's rows in the slab
  const int ta = r0 + ra, tb = r0 + rb;    // and in the chunk
  float acc[nb * 32], t[nb * 32];
#pragma unroll
  for (int i = 0; i < nb * 32; ++i) acc[i] = t[i] = 0.f;
  if (kRole == 0) mbar_wait(cbar, 0);
  for (int i = 0; i < items; ++i) {
    const int st = i % kStages;
    const unsigned char* slot = ring + st * kSlot;
    if (i < nm) {
      // A = M at the slab's rows (role 0) or M^T (role 1), k16 step s4 of
      // the tile o0: values (row a|b, depth 2c, 2c + 1, 2c + 8, 2c + 9)
      const int o0 = (kRole == 0 ? i : s + i) * kTile;
      float v[4][8];
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        const int k = o0 + 16 * s4 + 2 * cc;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // depth k + 8 hf
          const int kk = k + 8 * hf;
          float2 fa, fb;
          if (kRole == 0) {
            fa = *reinterpret_cast<const float2*>(m + (size_t)ta * qp + kk);
            fb = *reinterpret_cast<const float2*>(m + (size_t)tb * qp + kk);
          } else {
            fa = make_float2(m[(size_t)kk * qp + ta],
                             m[(size_t)(kk + 1) * qp + ta]);
            fb = make_float2(m[(size_t)kk * qp + tb],
                             m[(size_t)(kk + 1) * qp + tb]);
          }
          v[s4][4 * hf + 0] = fa.x;
          v[s4][4 * hf + 1] = fa.y;
          v[s4][4 * hf + 2] = fb.x;
          v[s4][4 * hf + 3] = fb.y;
        }
      }
      mbar_wait(full + st, (i / kStages) & 1);
#pragma unroll
      for (int s4 = 0; s4 < 4; ++s4) {
        unsigned pa[2][4];
#pragma unroll
        for (int p2 = 0; p2 < 2; ++p2) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[p2][r] = take_part(v[s4][2 * r], v[s4][2 * r + 1]);
          }
        }
        const uint64_t db = sw128_desc(slot + 2048 * s4, kSwTile);
        wgmma_fence();
        wgmma_rs<nb>(acc, pa[0], db, 1);
        wgmma_rs<nb>(acc, pa[1], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(acc);
    } else {
      const int hh = h_lo + i - nm;
      // this head's row scale: exp(cums) (role 0), w dt (role 1)
      const float* cu = ws + L.cums + t0 * H + hh;
      float fa = 0.f, fb = 0.f;
      if (kRole == 0) {
        if (ta < Q) fa = expf(cu[(size_t)ta * H]);
        if (tb < Q) fb = expf(cu[(size_t)tb * H]);
      } else {
        const float cl = cu[(size_t)(Q - 1) * H];
        if (ta < Q) fa = expf(cl - cu[(size_t)ta * H]) * dt[(t0 + ta) * H + hh];
        if (tb < Q) fb = expf(cl - cu[(size_t)tb * H]) * dt[(t0 + tb) * H + hh];
      }
      mbar_wait(full + st, (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int pi = 0; pi < kParts; ++pi) {
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          wgmma_ss<nb, 1>(
              t, sw128_desc(slot + 32 * s4, 16),
              sw128_desc(slot + (1 + pi * nb) * kSwTile + 2048 * s4, kSwTile),
              pi | s4);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(t);
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < nb * 8; ++j) {
        acc[4 * j] += fa * t[4 * j];
        acc[4 * j + 1] += fa * t[4 * j + 1];
        acc[4 * j + 2] += fb * t[4 * j + 2];
        acc[4 * j + 3] += fb * t[4 * j + 3];
        if (kRole == 0) {
          const unsigned char* cj = ct + (j >> 3) * kSwTile;
          const int col = (8 * j + 2 * cc) & 63;
          const float2 ca = bf2(lds_bf2(cj, ra, col));
          const float2 cb = bf2(lds_bf2(cj, rb, col));
          sa += ca.x * t[4 * j] + ca.y * t[4 * j + 1];
          sb += cb.x * t[4 * j + 2] + cb.y * t[4 * j + 3];
        }
      }
      if (kRole == 0) {
        sa = sum4(sa);
        sb = sum4(sb);
        float* car = ws + L.car + pass * bS * H + t0 * H + hh;
        if (cc == 0 && ta < Q) car[(size_t)ta * H] = fa * sa;
        if (cc == 0 && tb < Q) car[(size_t)tb * H] = fb * sb;
      }
    }
    fence_proxy_async();
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && i + kStages < items) fetch(i + kStages);
  }
  float* part = ws + L.part + ((size_t)(grp * 2 + kRole) * bS + t0) * L.n8;
#pragma unroll
  for (int j = 0; j < nb * 8; ++j) {
    const int n = n0 + 8 * j + 2 * cc;
    if (n < L.n8) {
      if (ta < Q) {
        *reinterpret_cast<float2*>(part + (size_t)ta * L.n8 + n) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      }
      if (tb < Q) {
        *reinterpret_cast<float2*>(part + (size_t)tb * L.n8 + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int nb>
__global__ void __launch_bounds__(kThreadsTc)
bwd_dc_tc(const __grid_constant__ TcMaps maps, const float* __restrict__ dt,
          float* __restrict__ ws, Ws L, int H, int Q) {
  bc_body<0, nb>(maps, dt, ws, L, H, Q);
}

template <int nb>
__global__ void __launch_bounds__(kThreadsTc)
bwd_db_tc(const __grid_constant__ TcMaps maps, const float* __restrict__ dt,
          float* __restrict__ ws, Ws L, int H, int Q) {
  bc_body<1, nb>(maps, dt, ws, L, H, Q);
}

// 5''. dC and dB: the head groups' partial sums in order, rounded once.
__global__ void __launch_bounds__(kThreads)
bwd_bc_sum(const float* __restrict__ ws, Ws L, bf16* __restrict__ dB,
           bf16* __restrict__ dC, size_t bS, int N) {
  const size_t per = bS * N;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < 2 * per;
       i += (size_t)gridDim.x * kThreads) {
    const int role = i >= per;
    const size_t r = i - role * per, t = r / N, n = r - t * N;
    const float* p = ws + L.part + (role * bS + t) * L.n8 + n;
    float v = 0.f;
    for (int g = 0; g < kBcGroups; ++g) v += p[(size_t)g * 2 * bS * L.n8];
    (role ? dB : dC)[r] = __float2bfloat16_rn(v);
  }
}

// 4'. the per-head chunk gradients, per (head, chunk): for each key tile,
// v = B dh^T (dh in three parts, both operands K-major, the whole N in
// k16 steps), then over the query slabs at or below the diagonal the
// transposed score gradient dG^T = x dy^T (keys as rows, exact), G^T and
// the decay's terms in registers, and dxb += G^T dy with G^T's two parts
// as register A and the dy slab MN-major.  Three blocks share an SM (the
// elementwise work between products needs the warps to hide its latency),
// so nothing larger than a tile stays in shared memory: x and the dy slabs
// arrive in rings of two slots, dh's part tiles stream through a third
// ring for each key tile's v, and the B tile of the next key tile is
// loaded into its slot as soon as v is done with it.
struct ChunkTc {
  size_t x, b, dy, dh, bars, f32s, total;  // byte offsets past the 1 KB
                                           // alignment; total with it
};

__host__ __device__ inline ChunkTc chunk_tc_layout(int nbk, int Q) {
  ChunkTc T;
  T.x = 0;                                    // x tiles [k][p]
  T.b = T.x + kStages * (size_t)kSwTile;      // B [k][n], nbk tiles
  T.dy = T.b + (size_t)nbk * kSwTile;         // dy slabs [q][p]
  T.dh = T.dy + kStages * (size_t)kSwTile;    // dh part tiles [p][n]
  T.bars = T.dh + kStages * (size_t)kSwTile;  // x, dy, dh rings; B
  T.f32s = T.bars + 8 * (3 * kStages + 1);
  // cs, dts, wk, drow, dcol, dxd, dwv; colp (4 x 64); red (16)
  T.total = 1024 + T.f32s + (7 * (size_t)round64(Q) + kWarps * kTile + 16) * 4;
  return T;
}

__global__ void __launch_bounds__(kThreadsTc, 3)
bwd_chunk_tc(const __grid_constant__ TcMaps maps,
             const float* __restrict__ dt, const float* __restrict__ A,
             const float* __restrict__ D, float* __restrict__ ws, Ws L,
             bf16* __restrict__ dx, float* __restrict__ ddt, int H, int P,
             int Q, int nbk) {
  extern __shared__ unsigned char smem_tc[];
  const ChunkTc T = chunk_tc_layout(nbk, Q);
  unsigned char* base = align_1k(smem_tc);
  unsigned char* xr = base + T.x;
  unsigned char* bt = base + T.b;
  unsigned char* dyr = base + T.dy;
  unsigned char* dhr = base + T.dh;
  uint64_t* xbar = reinterpret_cast<uint64_t*>(base + T.bars);
  uint64_t* ybar = xbar + kStages;
  uint64_t* hbar = ybar + kStages;
  uint64_t* bbar = hbar + kStages;
  const int qp = round64(Q), nt = qp / kTile;
  float* cs = reinterpret_cast<float*>(base + T.f32s);  // cums
  float* dts = cs + qp;     // dt
  float* wk = dts + qp;     // w
  float* drow = wk + qp;    // the carried term and dG G's sums over keys
  float* dcol = drow + qp;  // dG G's sums over queries
  float* dxd = dcol + qp;   // x . dxb
  float* dwv = dxd + qp;    // xb . dh B
  float* colp = dwv + qp;   // each warp's sums over its keys, (4, 64)
  float* red = colp + kWarps * kTile;  // block_sum, then <dh, h_in>
  const int h = blockIdx.x, ch = blockIdx.y, unit = ch * H + h;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const size_t t0 = (size_t)ch * Q, hp = (size_t)H * P;
  const size_t bSH = (size_t)gridDim.y * Q * H;
  const float a = A[h], dd = D[h];
  const int ra = 16 * w + g, rb = ra + 8;  // this thread's fragment rows
  const int npairs = nt * (nt + 1) / 2;
  const int nparts = 3 * nbk;  // dh's part tiles, streamed once a key tile

  auto fetch_x = [&](int kt) {
    uint64_t* bar = xbar + kt % kStages;
    mbar_expect_tx(bar, kSwTile);
    tma_load_4d(xr + (kt % kStages) * kSwTile, &maps.x, bar, 0, h,
                kt * kTile, ch);
  };
  auto fetch_b = [&](int kt) {
    mbar_expect_tx(bbar, nbk * kSwTile);
    for (int j = 0; j < nbk; ++j) {
      tma_load_3d(bt + j * kSwTile, &maps.b, bbar, j * kTile, kt * kTile, ch);
    }
  };
  // pair i of the walk (kt, qt >= kt in order): its query slab
  auto fetch_dy = [&](int i) {
    int kt = 0, r = i;
    while (r >= nt - kt) {
      r -= nt - kt;
      ++kt;
    }
    uint64_t* bar = ybar + i % kStages;
    mbar_expect_tx(bar, kSwTile);
    tma_load_4d(dyr + (i % kStages) * kSwTile, &maps.gy, bar, 0, h,
                (kt + r) * kTile, ch);
  };
  // dh's part tile u % nparts (part u / nbk % 3, columns 64 (u % nbk) ..)
  auto fetch_dh = [&](int u) {
    const int t = u % nparts;
    uint64_t* bar = hbar + u % kStages;
    mbar_expect_tx(bar, kSwTile);
    tma_load_3d(dhr + (u % kStages) * kSwTile, &maps.dh, bar,
                (t % nbk) * kTile, 0, unit * 3 + t / nbk);
  };
  if (tid == 0) {
    for (int i = 0; i < 3 * kStages + 1; ++i) mbar_init(xbar + i);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    fetch_b(0);
    for (int i = 0; i < kStages; ++i) {
      if (i < nt) fetch_x(i);
      if (i < npairs) fetch_dy(i);
      fetch_dh(i);
    }
  }
  for (int t = tid; t < qp; t += kThreadsTc) {
    const bool in = t < Q;
    float car = 0.f;
    if (in) {
      for (int i = 0; i < L.npass; ++i) {
        car += ws[L.car + i * bSH + (t0 + t) * H + h];
      }
    }
    cs[t] = in ? ws[L.cums + (t0 + t) * H + h] : 0.f;
    dts[t] = in ? dt[(t0 + t) * H + h] : 0.f;
    drow[t] = car;
    dcol[t] = dxd[t] = dwv[t] = 0.f;
  }
  if (tid == 0) {
    const float* hdp = ws + L.hd + (size_t)unit * L.nhd;
    float hd = 0.f;
    for (int i = 0; i < L.nhd; ++i) hd += hdp[i];
    red[8] = hd;
  }
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int t = tid; t < qp; t += kThreadsTc) {
    wk[t] = t < Q ? expf(cl - cs[t]) : 0.f;
  }
  __syncthreads();

  float dDp = 0.f;
  const float* sct = ws + L.sc + (size_t)ch * qp * qp;  // the scores, [k][q]
  int pi = 0;  // the pair's place in the dy ring
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTile, ka = k0 + ra, kb = k0 + rb;
    const unsigned char* xs = xr + (kt % kStages) * kSwTile;
    mbar_wait(bbar, kt & 1);
    // v = B dh^T (rows k, columns p), dh in three parts, a tile at a time
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int t = 0; t < nparts; ++t) {
      const int u = kt * nparts + t;
      const unsigned char* hs = dhr + (u % kStages) * kSwTile;
      const unsigned char* bs = bt + (t % nbk) * kSwTile;
      mbar_wait(hbar + u % kStages, (u / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma_ss<1, 0>(acc, sw128_desc(bs + 32 * s, 16),
                          sw128_desc(hs + 32 * s, 16), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(acc);
      fence_proxy_async();
      __syncthreads();  // every warp is done with the dh slot (and B)
      if (tid == 0) {
        if (u + kStages < nt * nparts) fetch_dh(u + kStages);
        if (t == nparts - 1 && kt + 1 < nt) fetch_b(kt + 1);
      }
    }
    mbar_wait(xbar + kt % kStages, (kt / kStages) & 1);
    {
      // dw[k] = dt[k] x[k] . v[k]; the accumulator of dxb starts at w v
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * cc;
        const float2 xa = bf2(lds_bf2(xs, ra, p)), xb = bf2(lds_bf2(xs, rb, p));
        sa += xa.x * acc[4 * j] + xa.y * acc[4 * j + 1];
        sb += xb.x * acc[4 * j + 2] + xb.y * acc[4 * j + 3];
      }
      sa = sum4(sa);
      sb = sum4(sb);
      if (cc == 0) {
        dwv[ka] = dts[ka] * sa;
        dwv[kb] = dts[kb] * sb;
      }
      const float wa = wk[ka], wb = wk[kb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= wa;
        acc[4 * j + 1] *= wa;
        acc[4 * j + 2] *= wb;
        acc[4 * j + 3] *= wb;
      }
    }
    const float csa = cs[ka], csb = cs[kb], da = dts[ka], db = dts[kb];
    unsigned dyk[16];  // dy at the tile's own rows (j, row a | b)
    for (int qt = kt; qt < nt; ++qt, ++pi) {
      const int q0 = qt * kTile;
      const int st = pi % kStages;
      const unsigned char* dys = dyr + st * kSwTile;
      // the scores at this thread's entries, loaded before the wait
      float2 s0[8], s1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = q0 + 8 * j + 2 * cc;
        s0[j] = *reinterpret_cast<const float2*>(sct + (size_t)ka * qp + q);
        s1[j] = *reinterpret_cast<const float2*>(sct + (size_t)kb * qp + q);
      }
      mbar_wait(ybar + st, (pi / kStages) & 1);
      // dG^T = x dy^T (rows k, columns q), exact
      float dg[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dg[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma_ss<1, 0>(dg, sw128_desc(xs + 32 * s, 16),
                          sw128_desc(dys + 32 * s, 16), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dg);
      // G^T and dt[k] dG G at the fragment's entries, the mask before the
      // exp (__expf: about 2^-21 relative where the decay is not
      // negligible, as in the forward); G^T's two parts as the A operand
      // of the slab's k16 steps
      float sa = 0.f, sb = 0.f;
      unsigned gp[2][4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qq = 8 * j + 2 * cc, q = q0 + qq;
        const float2 cq = *reinterpret_cast<const float2*>(cs + q);
        const bool m0 = ka <= q && q < Q, m1 = ka <= q + 1 && q + 1 < Q;
        const bool m2 = kb <= q && q < Q, m3 = kb <= q + 1 && q + 1 < Q;
        float g0 = m0 ? s0[j].x * __expf(cq.x - csa) : 0.f;
        float g1 = m1 ? s0[j].y * __expf(cq.y - csa) : 0.f;
        float g2 = m2 ? s1[j].x * __expf(cq.x - csb) : 0.f;
        float g3 = m3 ? s1[j].y * __expf(cq.y - csb) : 0.f;
        const float p0 = da * dg[4 * j] * g0, p1 = da * dg[4 * j + 1] * g1;
        const float p2 = db * dg[4 * j + 2] * g2, p3 = db * dg[4 * j + 3] * g3;
        sa += p0 + p1;
        sb += p2 + p3;
        const float c0 = sum8(p0 + p2), c1 = sum8(p1 + p3);
        if (g == 0) {
          *reinterpret_cast<float2*>(colp + w * kTile + qq) =
              make_float2(c0, c1);
        }
        const int kk = j >> 1, r = (j & 1) * 2;
        gp[0][kk][r] = take_part(g0, g1);
        gp[1][kk][r] = take_part(g0, g1);
        gp[0][kk][r + 1] = take_part(g2, g3);
        gp[1][kk][r + 1] = take_part(g2, g3);
      }
      sa = sum4(sa);
      sb = sum4(sb);
      if (cc == 0) {
        dcol[ka] += sa;
        dcol[kb] += sb;
      }
      // dxb += G^T dy over the slab (rows k, columns p), dy MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dyd = sw128_desc(dys + 2048 * kk, kSwTile);
        wgmma_rs<1>(acc, gp[0][kk], dyd, 1);
        wgmma_rs<1>(acc, gp[1][kk], dyd, 1);
      }
      wgmma_commit();
      // while it runs (no branch on the thread here, where ptxas would
      // serialize the products), at the diagonal: dy at the tile's own
      // rows, for dx, and dD's terms x . dy (zero past P and Q, where TMA
      // fills)
      if (qt == kt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * cc;
          dyk[2 * j] = lds_bf2(dys, ra, p);
          dyk[2 * j + 1] = lds_bf2(dys, rb, p);
          const float2 xa = bf2(lds_bf2(xs, ra, p)), xb = bf2(lds_bf2(xs, rb, p));
          const float2 ya = bf2(dyk[2 * j]), yb = bf2(dyk[2 * j + 1]);
          dDp += xa.x * ya.x + xa.y * ya.y + xb.x * yb.x + xb.y * yb.y;
        }
      }
      wgmma_wait<0>();
      wgmma_hold(acc);
      __syncthreads();  // colp
      if (tid < kTile) {
        drow[q0 + tid] += ((colp[tid] + colp[kTile + tid]) +
                           colp[2 * kTile + tid]) + colp[3 * kTile + tid];
      }
      fence_proxy_async();
      __syncthreads();  // every warp is done with the dy slot and colp
      if (tid == 0 && pi + kStages < npairs) fetch_dy(pi + kStages);
    }

    // dx = dt dxb + D dy; x . dxb for ddt
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * cc;
      const float2 xa = bf2(lds_bf2(xs, ra, p)), xb = bf2(lds_bf2(xs, rb, p));
      sa += xa.x * acc[4 * j] + xa.y * acc[4 * j + 1];
      sb += xb.x * acc[4 * j + 2] + xb.y * acc[4 * j + 3];
      const float2 ya = bf2(dyk[2 * j]), yb = bf2(dyk[2 * j + 1]);
      const float dyv[4] = {ya.x, ya.y, yb.x, yb.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = e < 2 ? ka : kb, pe = p + (e & 1);
        if (k < Q && pe < P) {
          dx[(t0 + k) * hp + (size_t)h * P + pe] =
              __float2bfloat16_rn(dts[k] * acc[4 * j + e] + dd * dyv[e]);
        }
      }
    }
    sa = sum4(sa);
    sb = sum4(sb);
    if (cc == 0) {
      dxd[ka] = sa;
      dxd[kb] = sb;
    }
    fence_proxy_async();
    __syncthreads();  // every warp is done with the key slot
    if (tid == 0 && kt + kStages < nt) fetch_x(kt + kStages);
  }

  // dcums, da (its reverse cumulative sum), ddt, and the partial sums
  dDp = block_sum(dDp, red);
  if (tid < 32) {
    float sw = 0.f;
    for (int t = lane; t < Q; t += 32) sw += wk[t] * dwv[t];
    sw = warp_sum(sw);
    const float last = sw + expf(cl) * red[8];
    const int per = (Q + 31) / 32;
    const int lo = lane * per;
    const int hi = min(lo + per, Q);
    float run = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      run += drow[t] - dcol[t] - wk[t] * dwv[t] + (t == Q - 1 ? last : 0.f);
      drow[t] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    const float excl = incl - run;
    float pa = 0.f;
    for (int t = lo; t < hi; ++t) {
      const float da = drow[t] + excl;
      ddt[(t0 + t) * H + h] = dxd[t] + a * da;
      pa += dts[t] * da;
    }
    pa = warp_sum(pa);
    if (lane == 0) {
      ws[L.pa + (size_t)ch * H + h] = pa;
      ws[L.pd + (size_t)ch * H + h] = dDp;
    }
  }
}

// ---------------------------------------------------------------------------
// 6. dA and dD over the sequences and chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_reduce(const float* __restrict__ ws, Ws L, float* __restrict__ dA,
           float* __restrict__ dD, int blocks, int H) {
  for (int h = blockIdx.x * kThreads + threadIdx.x; h < H;
       h += gridDim.x * kThreads) {
    float sa = 0.f, sd = 0.f;
    for (int i = 0; i < blocks; ++i) {
      sa += ws[L.pa + (size_t)i * H + h];
      sd += ws[L.pd + (size_t)i * H + h];
    }
    dA[h] = sa;
    dD[h] = sd;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

cudaError_t allow_bytes(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t allow(const void* fn, size_t floats) {
  return allow_bytes(fn, floats * sizeof(float));
}

// The TMA maps of one bf16 call (x, gy, B, C at `xs`, `gs`, `bs`, `cs` in
// rows of ldx and ldn values); false where TMA refuses a base or stride.
bool make_maps(TcMaps* m, const void* xs, const void* gs, const void* bs,
               const void* cs, const float* ws, const Ws& L, int chunks,
               int H, int P, int N, int Q, size_t ldx, size_t ldn) {
  const cuuint32_t box4[4] = {kTile, 1, kTile, 1};
  const cuuint32_t box3[3] = {kTile, kTile, 1};
  const cuuint64_t dx[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)Q,
                            (cuuint64_t)chunks};
  const cuuint64_t sx[3] = {ldx * 2, H * ldx * 2, Q * H * ldx * 2};
  const cuuint64_t db[3] = {(cuuint64_t)N, (cuuint64_t)Q, (cuuint64_t)chunks};
  const cuuint64_t sb[2] = {ldn * 2, Q * ldn * 2};
  const cuuint64_t dp[3] = {(cuuint64_t)N, (cuuint64_t)P,
                            (cuuint64_t)chunks * H * 3};
  const cuuint64_t sp[2] = {(cuuint64_t)L.n8 * 2, (cuuint64_t)P * L.n8 * 2};
  return bf16_tile_map(&m->x, xs, 4, dx, sx, box4) &&
         bf16_tile_map(&m->gy, gs, 4, dx, sx, box4) &&
         bf16_tile_map(&m->b, bs, 3, db, sb, box3) &&
         bf16_tile_map(&m->c, cs, 3, db, sb, box3) &&
         bf16_tile_map(&m->hin, ws + L.ph, 3, dp, sp, box3) &&
         bf16_tile_map(&m->dh, ws + L.pdh, 3, dp, sp, box3);
}

template <int nb>
cudaError_t run_tc(const bf16* x, const float* dt, const float* A,
                   const bf16* B, const bf16* C, const float* D,
                   const bf16* gy, const float* gstate, bf16* dx, float* ddt,
                   bf16* dB, bf16* dC, float* ws, const Ws& L, int batch,
                   int S, int H, int P, int N, int Q, cudaStream_t st) {
  const int nc = S / Q, nt = round64(Q) / kTile, chunks = batch * nc;
  const size_t bS = (size_t)batch * S;
  cudaError_t err;
#define SSD_BWD_TRY(expr)            \
  if ((err = (expr)) != cudaSuccess) \
  return err
  const bf16 *xs = x, *gs = gy, *bs = B, *cs = C;
  size_t ldx = P, ldn = N;
  if (L.pad_on) {
    bwd_pad<<<1024, kThreads, 0, st>>>(x, gy, B, C, ws, L, bS * H, P, bS, N);
    SSD_BWD_TRY(cudaGetLastError());
    xs = reinterpret_cast<const bf16*>(ws + L.padx);
    gs = reinterpret_cast<const bf16*>(ws + L.padg);
    bs = reinterpret_cast<const bf16*>(ws + L.padb);
    cs = reinterpret_cast<const bf16*>(ws + L.padc);
    ldx = L.p8;
    ldn = L.n8;
  }
  TcMaps maps;
  if (!make_maps(&maps, xs, gs, bs, cs, ws, L, chunks, H, P, N, Q, ldx,
                 ldn)) {
    return cudaErrorMisalignedAddress;
  }
  const int nbk = L.n8 / kTile + (L.n8 % kTile != 0);
  const size_t chunk_bytes = chunk_tc_layout(nbk, Q).total;
  SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_states_tc<nb>),
                          states_tc_bytes<nb>(Q)));
  SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_scores_tc),
                          scores_tc_bytes(nbk, H)));
  SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_dc_tc<nb>),
                          bc_tc_bytes<0, nb>()));
  SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_db_tc<nb>),
                          bc_tc_bytes<1, nb>()));
  SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_chunk_tc),
                          chunk_bytes));
  bwd_states_tc<nb><<<dim3(H, chunks, 2 * L.npass), kThreadsTc,
                      states_tc_bytes<nb>(Q), st>>>(maps, dt, A, ws, L, S, H,
                                                     P, N, Q);
  SSD_BWD_TRY(cudaGetLastError());
  if (L.vec == 2) {
    bwd_scan_tc<2><<<dim3(L.nblk, H, batch), kThreads, 0, st>>>(
        gstate, ws, L, S, H, P, N, Q);
  } else {
    bwd_scan_tc<1><<<dim3(L.nblk, H, batch), kThreads, 0, st>>>(
        gstate, ws, L, S, H, P, N, Q);
  }
  SSD_BWD_TRY(cudaGetLastError());
  bwd_scores_tc<<<dim3(nt * (nt + 1) / 2, chunks), kThreadsTc,
                  scores_tc_bytes(nbk, H), st>>>(maps, dt, ws, L, H, Q, nbk);
  SSD_BWD_TRY(cudaGetLastError());
  const dim3 slabs(nt, chunks, kBcGroups * L.npass);
  bwd_dc_tc<nb><<<slabs, kThreadsTc, bc_tc_bytes<0, nb>(), st>>>(maps, dt, ws,
                                                                 L, H, Q);
  SSD_BWD_TRY(cudaGetLastError());
  bwd_db_tc<nb><<<slabs, kThreadsTc, bc_tc_bytes<1, nb>(), st>>>(maps, dt, ws,
                                                                 L, H, Q);
  SSD_BWD_TRY(cudaGetLastError());
  bwd_bc_sum<<<1024, kThreads, 0, st>>>(ws, L, dB, dC, bS, N);
  SSD_BWD_TRY(cudaGetLastError());
  bwd_chunk_tc<<<dim3(H, chunks), kThreadsTc, chunk_bytes, st>>>(
      maps, dt, A, D, ws, L, dx, ddt, H, P, Q, nbk);
  return cudaGetLastError();
#undef SSD_BWD_TRY
}

template <typename T>
cudaError_t run(const void* x, const void* dt, const void* A, const void* B,
                const void* C, const void* D, const void* gy,
                const void* gstate, void* dx, void* ddt, void* dA, void* dB,
                void* dC, void* dD, void* wsp, int batch, int S, int H, int P,
                int N, int Q, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const T* gt = static_cast<const T*>(gy);
  const float* dtf = static_cast<const float*>(dt);
  float* ws = static_cast<float*>(wsp);
  const Ws L = ws_layout(batch, S, H, P, N, Q);
  const int nc = S / Q, nt = round64(Q) / kTile;
  cudaError_t err;
#define SSD_BWD_TRY(expr)            \
  if ((err = (expr)) != cudaSuccess) \
  return err

  const dim3 per_head(H, nc, batch);
  const dim3 pairs(nt * (nt + 1) / 2, nc, batch);
  const dim3 slabs(nt, nc, batch);
  const dim3 scan((P * N + kThreads - 1) / kThreads, H, batch);
  if constexpr (std::is_same<T, bf16>::value) {
    const float* Af = static_cast<const float*>(A);
    const float* Df = static_cast<const float*>(D);
    const float* gsf = static_cast<const float*>(gstate);
    bf16* dxt = static_cast<bf16*>(dx);
    bf16* dBt = static_cast<bf16*>(dB);
    bf16* dCt = static_cast<bf16*>(dC);
    float* ddtf = static_cast<float*>(ddt);
    SSD_BWD_TRY(L.n8 > kTile
                    ? run_tc<2>(xt, dtf, Af, Bt, Ct, Df, gt, gsf, dxt, ddtf,
                                dBt, dCt, ws, L, batch, S, H, P, N, Q, st)
                    : run_tc<1>(xt, dtf, Af, Bt, Ct, Df, gt, gsf, dxt, ddtf,
                                dBt, dCt, ws, L, batch, S, H, P, N, Q, st));
  } else {
    SSD_BWD_TRY(allow(reinterpret_cast<const void*>(bwd_states),
                      states_floats(Q)));
    SSD_BWD_TRY(allow(reinterpret_cast<const void*>(bwd_scores),
                      scores_floats()));
    SSD_BWD_TRY(allow(reinterpret_cast<const void*>(bwd_chunk),
                      chunk_floats(N, Q)));
    SSD_BWD_TRY(allow(reinterpret_cast<const void*>(bwd_bc), bc_floats()));
    bwd_states<<<per_head, kThreads, states_floats(Q) * 4, st>>>(
        xt, dtf, static_cast<const float*>(A), Bt, Ct, gt, ws, L, S, H, P, N,
        Q);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_scan<<<scan, kThreads, 0, st>>>(static_cast<const float*>(gstate), ws,
                                        L, S, H, P, N, Q);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_scores<<<pairs, kThreads, scores_floats() * 4, st>>>(
        xt, dtf, Bt, Ct, gt, ws, L, S, H, P, N, Q);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_chunk<<<per_head, kThreads, chunk_floats(N, Q) * 4, st>>>(
        xt, dtf, static_cast<const float*>(A), Bt, Ct,
        static_cast<const float*>(D), gt, ws, L, static_cast<T*>(dx),
        static_cast<float*>(ddt), S, H, P, N, Q);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_bc<<<slabs, kThreads, bc_floats() * 4, st>>>(
        xt, dtf, Bt, Ct, gt, ws, L, static_cast<T*>(dB), static_cast<T*>(dC),
        S, H, P, N, Q);
    SSD_BWD_TRY(cudaGetLastError());
  }
  bwd_reduce<<<(H + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ws, L, static_cast<float*>(dA), static_cast<float*>(dD), batch * nc, H);
  return cudaGetLastError();
#undef SSD_BWD_TRY
}

bool valid(int P, int N, int Q, int bf16) {
  return P >= 1 && P <= kMaxP && N >= 1 && Q >= 1 && (bf16 == 0 || bf16 == 1);
}

}  // namespace

extern "C" {

// Bytes of float32 workspace one `ssd_scan_bwd` call takes (0 for shapes it
// refuses).
size_t ssd_scan_bwd_workspace(int batch, int S, int H, int P, int N, int Q) {
  if (batch < 0 || S < 0 || H < 0 || !valid(P, N, Q, 0) || S % Q != 0) {
    return 0;
  }
  return ws_layout(batch, S, H, P, N, Q).total * sizeof(float);
}

// Kernel D's backward: x (batch, S, H, P), B and C (batch, S, N) and gy
// (batch, S, H, P) contiguous, float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// dt (batch, S, H), A (H,), D (H,) and gstate (batch, H, P, N) contiguous
// float32.  Writes dx (x's shape and type), ddt (dt's, float32), dA and dD
// (H,) float32, dB and dC (B's shape and type), using `workspace`
// (`ssd_scan_bwd_workspace` bytes), on `stream`.  S must be a multiple of
// the chunk Q, and 1 <= P <= 64.  Returns a cudaError_t (0 = launched).
int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* D, const void* gy,
                 const void* gstate, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, void* dD, void* workspace, int batch, int S, int H,
                 int P, int N, int Q, int bf16, void* stream) {
  if (batch < 0 || S < 0 || H < 0 || !valid(P, N, Q, bf16) || S % Q != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || S == 0 || H == 0) {
    // nothing flows: the gradients that are not empty are zero
    cudaError_t err = cudaMemsetAsync(dA, 0, (size_t)H * sizeof(float), st);
    if (err == cudaSuccess) {
      err = cudaMemsetAsync(dD, 0, (size_t)H * sizeof(float), st);
    }
    const size_t bytes = (size_t)batch * S * N * (bf16 ? 2 : 4);
    if (err == cudaSuccess) err = cudaMemsetAsync(dB, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dC, 0, bytes, st);
    return (int)err;
  }
  const cudaError_t err =
      bf16 ? run<__nv_bfloat16>(x, dt, A, B, C, D, gy, gstate, dx, ddt, dA,
                                dB, dC, dD, workspace, batch, S, H, P, N, Q, st)
           : run<float>(x, dt, A, B, C, D, gy, gstate, dx, ddt, dA, dB, dC, dD,
                        workspace, batch, S, H, P, N, Q, st);
  return (int)err;
}

const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
