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
//   dcums   = rows minus columns of dG G + dy . exp(cums) C h_in^T
//             - w[k] xb[k] . dh B[k] (their sum, and exp(cums[Q-1]) <dh, h_in>,
//             at Q-1)
//   da      = the reverse cumulative sum of dcums
//   ddt     = x . dxb + A da,          dA = sum dt da
// and the adjoint passes to the previous chunk as
//   dh_in   = exp(cums[Q-1]) dh + sum_q exp(cums[q]) dy[q]^T C[q].
// dx, dB and dC are written in x's type, ddt, dA and dD in float32; every
// sum is float32, in a fixed order (no atomics: two runs give equal bits).
//
// Schedule: six launches on the caller's stream, one C entry (one counted
// launch).
//   1. states (sequence, chunk, head): the chunk's cums (kept in the
//      workspace for the later kernels), its own state sum_k w xb^T B and
//      its own adjoint sum_q exp(cums) dy^T C.  Chunk-parallel: the entry
//      states are recomputed here rather than saved by the forward, which
//      under remat would hold them for every layer.
//   2. scan (sequence, head, 256 state elements): walks the chunks forward
//      turning the own states into entry states, and backward turning the
//      own adjoints into exit adjoints, in place, eight chunks' loads in
//      flight at a time.
//   3. scores (sequence, chunk, tile pair kt <= qt): the chunk's scores
//      C B^T once for all heads, and M = sum_h dG_h L_h, the head sum taken
//      before the products with B and C so that dB and dC need no per-head
//      partials.
//   4. chunk (sequence, chunk, head): dxb tile by key tile over the query
//      slabs at or below the diagonal, the decay's gradient (row and column
//      sums into separate arrays, so no two threads add to one value),
//      dx, ddt, and this block's partial sums of dA and dD.
//   5. bc (sequence, chunk, 64-row slab): dC and dB from M and the state
//      terms, a loop over the heads inside the block.
//   6. reduce: dA and dD over the sequences and chunks, in order.
// The mask k <= q is applied before exp, as in the forward.  Two instances:
// the bfloat16 one (the train step's) runs every product of kernels 1 and
// 3-5 on the tensor cores (the section below says how); the float32 one
// (the f32 checks) runs them as float32 FMAs on 64 x 64 tiles from shared
// memory, 256 threads each a 4 x 4 patch (rows ty + 16 i, columns
// tx + 16 j).
//
// What bounds it on this card: at the train step's shapes (Mamba-2-780m,
// b = 4, S = 4096, H = 48, P = 64, N = 128, Q = 256, bf16) the function
// needs about 92 GFLOP (the scores once, dG and G^T dy once per head, five
// state products of 2 Q P N per head and chunk, M's two products; the
// carried state's term of dcums is exp(cums[q]) C[q] . (h_in^T dy[q]),
// which reuses dC's state term), 0.093 ms at bf16's 989 TFLOP/s, and moves
// 0.33 GB (x, gy, dx, dt, ddt, B, C, dB, dC once), 0.097 ms at 3.35 TB/s:
// bytes bound it.  This kernel runs about 3.0 times those FLOPs on the
// tensor cores (274 GFLOP: the float32 operands' two or three parts, dG
// computed twice, whole diagonal tiles, the carried state's term of dcums
// as a product of its own)
// and keeps 0.24 GB of float32 workspace (entry states, exit adjoints,
// scores, M), written once and read by several kernels.  Neither rate is
// reached: each kernel is a loop of small tiles (64 x 64 x 64 products
// between barriers) at eight warps an SM, where latency, the bf16 parts'
// conversions and the staging loads are the likely limits (not measured
// inside a kernel); chip_smoke.py times each part and PERF.md records
// them beside the bound.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace {

constexpr int kTile = 64;        // tile rows and columns
constexpr int kLd = kTile + 1;   // padded row of a staged tile
constexpr int kThreads = 256;    // 16 x 16 threads, each a 4 x 4 patch
constexpr int kMaxP = 64;        // the widest head (the forward's limit)

__host__ __device__ inline int round64(int v) { return (v + 63) / 64 * 64; }

// Offsets (in floats) of the float32 workspace.
struct Ws {
  size_t cums, hin, dh, sc, m, pa, pd, total;
};

// each section starts on 16 bytes (float2 and float4 accesses)
__host__ __device__ inline size_t align4(size_t v) { return (v + 3) / 4 * 4; }

__host__ __device__ inline Ws ws_layout(int b, int S, int H, int P, int N,
                                        int Q) {
  const size_t nc = S / Q, qp = round64(Q);
  Ws w;
  w.cums = 0;                                          // (b, S, H)
  w.hin = align4(w.cums + (size_t)b * S * H);          // (b, nc, H, P, N)
  w.dh = align4(w.hin + (size_t)b * nc * H * P * N);   // (b, nc, H, P, N)
  w.sc = align4(w.dh + (size_t)b * nc * H * P * N);    // (b, nc, qp, qp)
  w.m = w.sc + (size_t)b * nc * qp * qp;               // (b, nc, qp, qp)
  w.pa = w.m + (size_t)b * nc * qp * qp;               // (b, nc, H)
  w.pd = w.pa + (size_t)b * nc * H;                    // (b, nc, H)
  w.total = w.pd + (size_t)b * nc * H;
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
// bfloat16 instance: the products on the tensor cores
// ---------------------------------------------------------------------------
//
// mma.sync.m16n8k16 bf16 -> float32 fed by ldmatrix, four warps a block,
// warp w owning rows 16 w .. 16 w + 15 of every 64-row tile, as in kernel
// D's forward.  x, gy, B and C are exact bf16 operands; a float32 operand
// (a scaled x or dy, a state, an adjoint, G, M) is cut into bf16 parts
// (hi = bf16(v), then the remainders; the forward's rule): three for the
// states and adjoints where they reach a float32 gradient (ddt through the
// carried term and dh B), two for G (its product G^T dy reaches ddt through
// x . dxb) and where only a bf16 gradient follows (dB and dC's parts from M
// and the states).  tests/test_torch_ssd_bwd.py emulates the cut on
// tests/test_torch_cuda_ssd.py's cancelling and slowly decaying inputs:
// this one errs by at most 1.4e-6 of ddt's and dx's magnitude, two parts
// of the states by 3.9e-5 (1e-4 is the limit) and one part of G by 6.8e-4.
// Fragment (j, e) of a warp's 16 x 64
// accumulator is row g (e < 2) or g + 8 and column 8 j + 2 c + (e & 1),
// g = lane / 4, c = lane % 4.

using bf16 = __nv_bfloat16;
constexpr int kThreadsTc = 128;  // 4 warps
constexpr int kWarps = kThreadsTc / 32;
constexpr int kLdT = kTile + 8;  // bf16 tile row: 64 values + 16 bytes
constexpr int kTileT = kTile * kLdT;  // one bf16 tile

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// A (16 x 16 at rows m0, depth k0) from a row-major [M][K] tile
__device__ __forceinline__ void lda_rows(unsigned* a, const bf16* s, int ld,
                                         int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// A from a tile stored [K][M]
__device__ __forceinline__ void lda_cols(unsigned* a, const bf16* s, int ld,
                                         int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(a, s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
                       ((lane >> 3) & 1) * 8);
}
// B (depth k0, columns n0 .. n0 + 15: b[0..1] the first 8, b[2..3] the next)
// from a tile stored [N][K]
__device__ __forceinline__ void ldb_rows(unsigned* b, const bf16* s, int ld,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}
// B from a tile stored [K][N]
__device__ __forceinline__ void ldb_cols(unsigned* b, const bf16* s, int ld,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                       (lane >> 4) * 8);
}

// acc (the warp's 16 rows at m0 x 64 columns) += A (16 x K) B (K x 64); A
// stored [K][M] when A_T, else [M][K]; B stored [K][N] when B_T, else [N][K]
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_tile(float (&acc)[8][4], const bf16* a,
                                         int lda, int m0, const bf16* b,
                                         int ldb, int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned af[4];
    if (A_T) {
      lda_cols(af, a, lda, m0, k0);
    } else {
      lda_rows(af, a, lda, m0, k0);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      unsigned bf[4];
      if (B_T) {
        ldb_cols(bf, b, ldb, 16 * jj, k0);
      } else {
        ldb_rows(bf, b, ldb, 16 * jj, k0);
      }
      mma_bf16(acc[2 * jj], af, bf);
      mma_bf16(acc[2 * jj + 1], af, bf + 2);
    }
  }
}

// The next bf16x2 part of two float32 values (kernel D's take_part).
__device__ __forceinline__ unsigned take_part(float& v0, float& v1) {
  const __nv_bfloat162 part = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(part);
  v0 -= f.x;
  v1 -= f.y;
  return *reinterpret_cast<const unsigned*>(&part);
}

// A 64-row bf16 tile from global: row r is `cols` values at src + r *
// stride, zero from `cols` to `width` (a multiple of 8) and at rows >=
// `rows`.  16-byte loads when `vec` (cols a multiple of 8, src and stride
// 16-byte aligned).
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld, const bf16* src,
                                           size_t stride, int rows, int cols,
                                           int width, bool vec) {
  if (vec) {
    const int per = width / 8;
    for (int e = threadIdx.x; e < kTile * per; e += blockDim.x) {
      const int r = e / per, j = (e - r * per) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && j < cols) {
        v = *reinterpret_cast<const uint4*>(src + r * stride + j);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + j) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kTile * width; e += blockDim.x) {
      const int r = e / width, j = e - r * width;
      dst[r * ld + j] =
          r < rows && j < cols ? src[r * stride + j] : __float2bfloat16(0.f);
    }
  }
}

// stage_bf16 with 16-byte cp.async copies when `vec` (the caller commits
// and waits), else with loads stored at once.
__device__ __forceinline__ void stage_bf16_async(bf16* dst, int ld,
                                                 const bf16* src,
                                                 size_t stride, int rows,
                                                 int cols, int width,
                                                 bool vec) {
  if (!vec) {
    stage_bf16(dst, ld, src, stride, rows, cols, width, false);
    return;
  }
  const int per = width / 8;
  for (int e = threadIdx.x; e < kTile * per; e += blockDim.x) {
    const int r = e / per, j = (e - r * per) * 8;
    const bool ok = r < rows && j < cols;
    cp_async16(dst + r * ld + j, ok ? src + r * stride + j : src, ok);
  }
}

// Store two neighbouring float32 values cut into `parts` bf16x2 parts, the
// parts `stride` values apart (a bf16 tile by default).
__device__ __forceinline__ void store_parts2(bf16* dst, int parts, float v0,
                                             float v1, int stride = kTileT) {
  for (int i = 0; i < parts; ++i) {
    const unsigned p = take_part(v0, v1);
    *reinterpret_cast<unsigned*>(dst + i * stride) = p;
  }
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

// 1'. states: s = (w dt x)^T B and u = (exp(cums) dy)^T C on the tensor
// cores, per (sequence, chunk, head); the scaled x and dy in three parts,
// cut once per key tile, B and C at their full width.
size_t states_tc_bytes(int N, int Q) {
  return (size_t)6 * kTileT * 2 + 2 * (size_t)kTile * (round16(N) + 8) * 2 +
         3 * (size_t)round64(Q) * 4;
}

__global__ void __launch_bounds__(kThreadsTc, 2)
bwd_states_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const bf16* __restrict__ gy,
              float* __restrict__ ws, Ws L, int S, int H, int P, int N, int Q,
              int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int qp = round64(Q), np = round16(N), ld = np + 8;
  bf16* xp = reinterpret_cast<bf16*>(smem_tc);  // 3 parts of w dt x, [k][p]
  bf16* yp = xp + 3 * kTileT;                   // 3 parts of exp(cums) dy
  bf16* bt = yp + 3 * kTileT;                   // B, [k][n]
  bf16* ct = bt + kTile * ld;                   // C
  float* cs = reinterpret_cast<float*>(ct + kTile * ld);
  float* wx = cs + qp;
  float* ec = wx + qp;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t hp = (size_t)H * P;

  for (int t = tid; t < qp; t += kThreadsTc) {
    wx[t] = t < Q ? dt[(t0 + t) * H + h] : 0.f;
  }
  __syncthreads();
  if (tid < 32) warp_cumsum(wx, A[h], Q, cs);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int t = tid; t < qp; t += kThreadsTc) {
    const bool in = t < Q;
    if (in) ws[L.cums + (t0 + t) * H + h] = cs[t];
    ec[t] = in ? expf(cs[t]) : 0.f;
    wx[t] = in ? expf(cl - cs[t]) * wx[t] : 0.f;
  }
  __syncthreads();

  // two 64-column blocks of N at most in registers: N <= 128 in one pass
  const size_t at = (((size_t)b * nc + c) * H + h) * P * N;
  for (int n0 = 0; n0 < np; n0 += 2 * kTile) {
    const int nbs = min(2, (np - n0 + kTile - 1) / kTile);
    float as[2][8][4] = {}, au[2][8][4] = {};
    for (int k0 = 0; k0 < Q; k0 += kTile) {
      for (int e = tid; e < kTile * kTile / 2; e += kThreadsTc) {
        const int r = e >> 5, j = (e & 31) * 2;
        const int t = k0 + r;
        const size_t xi = (t0 + t) * hp + (size_t)h * P + j;
        float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
        if (t < Q && j < P) {
          x0 = wx[t] * __bfloat162float(x[xi]);
          y0 = ec[t] * __bfloat162float(gy[xi]);
          if (j + 1 < P) {
            x1 = wx[t] * __bfloat162float(x[xi + 1]);
            y1 = ec[t] * __bfloat162float(gy[xi + 1]);
          }
        }
        store_parts2(xp + r * kLdT + j, 3, x0, x1);
        store_parts2(yp + r * kLdT + j, 3, y0, y1);
      }
      stage_bf16(bt, ld, Bm + (t0 + k0) * N, N, Q - k0, N, np, vec_bc);
      stage_bf16(ct, ld, Cm + (t0 + k0) * N, N, Q - k0, N, np, vec_bc);
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          if (nb < nbs) {
            mma_tile<true, true>(as[nb], xp + i * kTileT, kLdT, 16 * w,
                                 bt + n0 + nb * kTile, ld, kTile);
            mma_tile<true, true>(au[nb], yp + i * kTileT, kLdT, 16 * w,
                                 ct + n0 + nb * kTile, ld, kTile);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * w + g + (e >> 1) * 8;
          const int n = n0 + nb * kTile + 8 * j + 2 * cc + (e & 1);
          if (p < P && n < N) {
            ws[L.hin + at + (size_t)p * N + n] = as[nb][j][e];
            ws[L.dh + at + (size_t)p * N + n] = au[nb][j][e];
          }
        }
      }
    }
  }
}

// 3'. scores and M on the tensor cores, one tile pair a block; dy x^T is
// exact in bf16 and needs one pass.
size_t scores_tc_bytes(int N) {
  return (size_t)2 * kTile * (round16(N) + 8) * 2 + 4 * (size_t)kTileT * 2 +
         6 * kTile * 4;
}

__global__ void __launch_bounds__(kThreadsTc, 2)
bwd_scores_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
              const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              const bf16* __restrict__ gy, float* __restrict__ ws, Ws L, int S,
              int H, int P, int N, int Q, int vec_x, int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int np = round16(N), ldc = np + 8;
  bf16* cb = reinterpret_cast<bf16*>(smem_tc);  // C slab [q][n]
  bf16* bb = cb + kTile * ldc;                  // B tile [k][n]
  // per head, two stages: the dy slab [q][p], the x tile [k][p], and cums
  // at the slab's rows, cums and dt at the tile's keys
  bf16* dyq = bb + kTile * ldc;
  bf16* xk = dyq + 2 * kTileT;
  float* cq = reinterpret_cast<float*>(xk + 2 * kTileT);
  float* ck = cq + 2 * kTile;
  float* dk = ck + 2 * kTile;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const int qp = round64(Q);
  int qt = 0;  // pair blockIdx.x -> (qt, kt), kt <= qt
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = (int)blockIdx.x - qt * (qt + 1) / 2;
  const int q0 = qt * kTile, k0 = kt * kTile;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t hp = (size_t)H * P;
  const size_t tile = ((size_t)b * nc + c) * qp * qp;

  stage_bf16(cb, ldc, Cm + (t0 + q0) * N, N, Q - q0, N, np, vec_bc);
  stage_bf16(bb, ldc, Bm + (t0 + k0) * N, N, Q - k0, N, np, vec_bc);
  __syncthreads();
  float acc[8][4] = {};
  mma_tile<false, false>(acc, cb, ldc, 16 * w, bb, ldc, np);
  const int ra = 16 * w + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + 8 * j + 2 * cc;
    *reinterpret_cast<float2*>(ws + L.sc + tile + (size_t)(q0 + ra) * qp + k) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(ws + L.sc + tile + (size_t)(q0 + ra + 8) * qp +
                               k) = make_float2(acc[j][2], acc[j][3]);
  }

  // head hh's inputs into stage st; the next head's are copied while this
  // one's products run
  auto stage_head = [&](int hh, int st) {
    stage_bf16_async(dyq + st * kTileT, kLdT,
                     gy + (t0 + q0) * hp + (size_t)hh * P, hp, Q - q0, P,
                     kTile, vec_x);
    stage_bf16_async(xk + st * kTileT, kLdT,
                     x + (t0 + k0) * hp + (size_t)hh * P, hp, Q - k0, P, kTile,
                     vec_x);
    if (tid < kTile) {
      const int q = q0 + tid, k = k0 + tid;
      cq[st * kTile + tid] = q < Q ? ws[L.cums + (t0 + q) * H + hh] : 0.f;
      ck[st * kTile + tid] = k < Q ? ws[L.cums + (t0 + k) * H + hh] : 0.f;
      dk[st * kTile + tid] = k < Q ? dt[(t0 + k) * H + hh] : 0.f;
    }
  };
  float m[8][4] = {};
  stage_head(0, 0);
  cp_async_commit();
  for (int hh = 0; hh < H; ++hh) {
    const int st = hh & 1;
    if (hh + 1 < H) stage_head(hh + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // head hh's copies have landed
    __syncthreads();
    float dg[8][4] = {};
    mma_tile<false, false>(dg, dyq + st * kTileT, kLdT, 16 * w,
                           xk + st * kTileT, kLdT, kTile);
    const float* cqs = cq + st * kTile;
    const float* cks = ck + st * kTile;
    const float* dks = dk + st * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ra + (e >> 1) * 8, kk = 8 * j + 2 * cc + (e & 1);
        const int q = q0 + r, k = k0 + kk;
        const bool ok = k <= q && q < Q;
        const float d = __expf(ok ? cqs[r] - cks[kk] : 0.f);
        m[j][e] += ok ? dg[j][e] * dks[kk] * d : 0.f;
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + 8 * j + 2 * cc;
    *reinterpret_cast<float2*>(ws + L.m + tile + (size_t)(q0 + ra) * qp + k) =
        make_float2(m[j][0], m[j][1]);
    *reinterpret_cast<float2*>(ws + L.m + tile + (size_t)(q0 + ra + 8) * qp +
                               k) = make_float2(m[j][2], m[j][3]);
  }
}

// 4'. the per-head chunk gradients on the tensor cores.
struct ChunkTc {
  int np, ld;  // N rounded up to 16; the row of the state's parts and of
               // the B/C tile (bf16, 16-byte aligned)
  size_t f32s, hs, cb, xk, dyq, total;  // byte offsets; G's parts share cb
};

__host__ __device__ inline ChunkTc chunk_tc_layout(int N, int Q) {
  ChunkTc T;
  T.np = round16(N);
  T.ld = T.np + 8;
  const size_t qp = round64(Q);
  const size_t tile_bc = (size_t)kTile * T.ld * 2, g_parts = 2 * kTileT * 2;
  T.f32s = 0;  // cs, dts, wk, drow, dcol, dxd, dwv; colp (4 x 64); red (16)
  T.hs = T.f32s + (7 * qp + kWarps * kTile + 16) * 4;
  T.cb = T.hs + 3 * tile_bc;  // the state in three parts
  T.xk = T.cb + (tile_bc > g_parts ? tile_bc : g_parts);
  T.dyq = T.xk + (size_t)kTileT * 2;  // two stages
  T.total = T.dyq + 2 * (size_t)kTileT * 2;  // 104 KB at N = 128, Q = 256
  return T;
}

__global__ void __launch_bounds__(kThreadsTc, 2)
bwd_chunk_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const float* __restrict__ D,
             const bf16* __restrict__ gy, float* __restrict__ ws, Ws L,
             bf16* __restrict__ dx, float* __restrict__ ddt, int S, int H,
             int P, int N, int Q, int vec_x, int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const ChunkTc T = chunk_tc_layout(N, Q);
  const int qp = round64(Q), nt = qp / kTile, np = T.np, ld = T.ld;
  const int hpart = kTile * ld;  // one part of the state
  float* cs = reinterpret_cast<float*>(smem_tc + T.f32s);  // cums
  float* dts = cs + qp;     // dt
  float* wk = dts + qp;     // w
  float* drow = wk + qp;    // row sums of dG G and the carried term
  float* dcol = drow + qp;  // column sums of dG G
  float* dxd = dcol + qp;   // x . dxb
  float* dwv = dxd + qp;    // xb . dh B
  float* colp = dwv + qp;   // each warp's column sums, (4, 64)
  float* red = colp + kWarps * kTile;  // block_sum, then <dh, h_in>
  bf16* hs = reinterpret_cast<bf16*>(smem_tc + T.hs);  // h_in, then dh, [p][n]
  bf16* cb = reinterpret_cast<bf16*>(smem_tc + T.cb);  // C slab or B tile
  bf16* xk = reinterpret_cast<bf16*>(smem_tc + T.xk);    // x tile [k][p]
  bf16* dyq = reinterpret_cast<bf16*>(smem_tc + T.dyq);  // dy slabs [q][p]
  // G's two parts, [q][k], in the B tile's place once dh B[k] is done
  bf16* gp = cb;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t hp = (size_t)H * P;
  const size_t bc = (size_t)b * nc + c;
  const float a = A[h], dd = D[h];
  const int ra = 16 * w + g, rb = ra + 8;  // this thread's fragment rows

  for (int t = tid; t < qp; t += kThreadsTc) {
    const bool in = t < Q;
    cs[t] = in ? ws[L.cums + (t0 + t) * H + h] : 0.f;
    dts[t] = in ? dt[(t0 + t) * H + h] : 0.f;
    drow[t] = dcol[t] = dxd[t] = dwv[t] = 0.f;
  }
  const size_t at = (bc * H + h) * P * N;
  // the state (h_in, later dh) into its three parts, zero past P and N
  auto split_state = [&](size_t off) {
    for (int e = tid; e < kTile * np / 2; e += kThreadsTc) {
      const int p = e / (np / 2), n = (e - p * (np / 2)) * 2;
      const size_t i = off + at + (size_t)p * N + n;
      const float v0 = p < P && n < N ? ws[i] : 0.f;
      const float v1 = p < P && n + 1 < N ? ws[i + 1] : 0.f;
      store_parts2(hs + p * ld + n, 3, v0, v1, hpart);
    }
  };
  split_state(L.hin);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int t = tid; t < qp; t += kThreadsTc) {
    wk[t] = t < Q ? expf(cl - cs[t]) : 0.f;
  }
  auto stage_bc = [&](const bf16* m, int r0) {
    stage_bf16(cb, ld, m + (t0 + r0) * N, N, Q - r0, N, np, vec_bc);
  };
  auto stage_head = [&](bf16* dst, const bf16* m, int r0) {
    stage_bf16(dst, kLdT, m + (t0 + r0) * hp + (size_t)h * P, hp, Q - r0, P,
               kTile, vec_x);
  };
  auto stage_dy_async = [&](int st, int r0) {
    stage_bf16_async(dyq + st * kTileT, kLdT,
                     gy + (t0 + r0) * hp + (size_t)h * P, hp, Q - r0, P, kTile,
                     vec_x);
  };

  // the carried state's term of dcums: dy[q] . exp(cums[q]) h_in C[q]
  for (int qt = 0; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    stage_bc(Cm, q0);
    stage_head(dyq, gy, q0);
    __syncthreads();
    float yo[8][4] = {};
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      mma_tile<false, false>(yo, cb, ld, 16 * w, hs + i * hpart, ld, np);
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * cc;
      const float2 da = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dyq + ra * kLdT + p));
      const float2 db = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dyq + rb * kLdT + p));
      sa += da.x * yo[j][0] + da.y * yo[j][1];
      sb += db.x * yo[j][2] + db.y * yo[j][3];
    }
    sa = sum4(sa);
    sb = sum4(sb);
    if (cc == 0) {
      if (q0 + ra < Q) drow[q0 + ra] += expf(cs[q0 + ra]) * sa;
      if (q0 + rb < Q) drow[q0 + rb] += expf(cs[q0 + rb]) * sb;
    }
    __syncthreads();
  }

  // <dh, h_in>, and dh in h_in's place
  float hd = 0.f;
  for (int e = tid; e < P * N; e += kThreadsTc) {
    hd += ws[L.dh + at + e] * ws[L.hin + at + e];
  }
  split_state(L.dh);
  hd = block_sum(hd, red);
  if (tid == 0) red[8] = hd;

  float dDp = 0.f;
  const float* sc = ws + L.sc + bc * qp * qp;
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTile;
    stage_bc(Bm, k0);
    stage_head(xk, x, k0);
    // the slabs' dy in two stages, the next slab's copied while this one's
    // products run: the diagonal slab's first
    stage_dy_async(0, k0);
    cp_async_commit();
    __syncthreads();
    // v = dh B[k] (rows k, columns p); dw[k] = dt[k] x[k] . v[k]; the
    // accumulator of dxb starts at w[k] v[k]
    float acc[8][4] = {};
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      mma_tile<false, false>(acc, cb, ld, 16 * w, hs + i * hpart, ld, np);
    }
    {
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * cc;
        const float2 xa = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xk + ra * kLdT + p));
        const float2 xb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xk + rb * kLdT + p));
        sa += xa.x * acc[j][0] + xa.y * acc[j][1];
        sb += xb.x * acc[j][2] + xb.y * acc[j][3];
      }
      sa = sum4(sa);
      sb = sum4(sb);
      if (cc == 0) {
        dwv[k0 + ra] = dts[k0 + ra] * sa;
        dwv[k0 + rb] = dts[k0 + rb] * sb;
      }
      const float wa = wk[k0 + ra], wb = wk[k0 + rb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= wa;
        acc[j][1] *= wa;
        acc[j][2] *= wb;
        acc[j][3] *= wb;
      }
    }

    for (int qt = kt; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      const int st = (qt - kt) & 1;
      const bf16* dys = dyq + st * kTileT;
      const int qa = q0 + ra, qb = q0 + rb;
      // the scores at this thread's entries, loaded before the products
      // (whose shared-memory loads order every memory access after them)
      float2 s0[8], s1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + 8 * j + 2 * cc;
        s0[j] = *reinterpret_cast<const float2*>(sc + (size_t)qa * qp + k);
        s1[j] = *reinterpret_cast<const float2*>(sc + (size_t)qb * qp + k);
      }
      if (qt + 1 < nt) stage_dy_async(st ^ 1, q0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();  // this slab's copies have landed
      __syncthreads();
      // dG = dy x^T (exact), then G and dG G at the fragment's entries, the
      // mask before the exp (__expf: about 2^-21 relative where the decay
      // is not negligible, as in the forward)
      float dg[8][4] = {};
      mma_tile<false, false>(dg, dys, kLdT, 16 * w, xk, kLdT, kTile);
      const float csa = cs[qa], csb = cs[qb];
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = 8 * j + 2 * cc, k = k0 + kk;
        const bool m0 = k <= qa && qa < Q, m1 = k + 1 <= qa && qa < Q;
        const bool m2 = k <= qb && qb < Q, m3 = k + 1 <= qb && qb < Q;
        const float g0 = m0 ? s0[j].x * __expf(csa - cs[k]) : 0.f;
        const float g1 = m1 ? s0[j].y * __expf(csa - cs[k + 1]) : 0.f;
        const float g2 = m2 ? s1[j].x * __expf(csb - cs[k]) : 0.f;
        const float g3 = m3 ? s1[j].y * __expf(csb - cs[k + 1]) : 0.f;
        const float p0 = dts[k] * dg[j][0] * g0;
        const float p1 = dts[k + 1] * dg[j][1] * g1;
        const float p2 = dts[k] * dg[j][2] * g2;
        const float p3 = dts[k + 1] * dg[j][3] * g3;
        sa += p0 + p1;
        sb += p2 + p3;
        const float c0 = sum8(p0 + p2), c1 = sum8(p1 + p3);
        if (g == 0) {
          colp[w * kTile + kk] = c0;
          colp[w * kTile + kk + 1] = c1;
        }
        store_parts2(gp + ra * kLdT + kk, 2, g0, g1);
        store_parts2(gp + rb * kLdT + kk, 2, g2, g3);
      }
      sa = sum4(sa);
      sb = sum4(sb);
      if (cc == 0) {
        drow[qa] += sa;
        drow[qb] += sb;
      }
      __syncthreads();
      if (tid < kTile) {
        dcol[k0 + tid] += ((colp[tid] + colp[kTile + tid]) +
                           colp[2 * kTile + tid]) + colp[3 * kTile + tid];
      }
      // dxb += G^T dy over the slab (rows k, columns p), G in two parts
#pragma unroll 1
      for (int i = 0; i < 2; ++i) {
        mma_tile<true, true>(acc, gp + i * kTileT, kLdT, 16 * w, dys, kLdT,
                             kTile);
      }
      __syncthreads();
    }

    // dx = dt dxb + D dy; x . dxb for ddt; x . dy for dD
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * cc;
      const float2 xa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xk + ra * kLdT + p));
      const float2 xb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xk + rb * kLdT + p));
      sa += xa.x * acc[j][0] + xa.y * acc[j][1];
      sb += xb.x * acc[j][2] + xb.y * acc[j][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + (e < 2 ? ra : rb), pe = p + (e & 1);
        if (k < Q && pe < P) {
          const size_t i = (t0 + k) * hp + (size_t)h * P + pe;
          const float dyv = __bfloat162float(gy[i]);
          dx[i] = __float2bfloat16_rn(dts[k] * acc[j][e] + dd * dyv);
          dDp += __bfloat162float(x[i]) * dyv;
        }
      }
    }
    sa = sum4(sa);
    sb = sum4(sb);
    if (cc == 0) {
      dxd[k0 + ra] = sa;
      dxd[k0 + rb] = sb;
    }
    __syncthreads();  // the next tile restages cb and xk
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
      ws[L.pa + bc * H + h] = pa;
      ws[L.pd + bc * H + h] = dDp;
    }
  }
}

// 5'. dB and dC of one 64-row slab on the tensor cores; M, the states and
// the adjoints in two parts (they reach only the bf16 dB and dC).
size_t bc_tc_bytes() { return (size_t)9 * kTileT * 2 + 2 * kTile * 4; }

__global__ void __launch_bounds__(kThreadsTc, 2)
bwd_bc_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
          const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
          const bf16* __restrict__ gy, const float* __restrict__ ws, Ws L,
          bf16* __restrict__ dB, bf16* __restrict__ dC, int S, int H, int P,
          int N, int Q, int vec_x, int vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* mp = reinterpret_cast<bf16*>(smem_tc);  // 2 parts of an M tile
  bf16* ot = mp + 2 * kTileT;                   // B or C tile, [t][n]
  bf16* dyr = ot + kTileT;                      // dy of the slab [r][p]
  bf16* xr = dyr + kTileT;                      // x of the slab
  bf16* hp2 = xr + kTileT;                      // 2 parts of h_in [p][n]
  bf16* dp2 = hp2 + 2 * kTileT;                 // 2 parts of dh
  float* eq = reinterpret_cast<float*>(dp2 + 2 * kTileT);
  float* wq = eq + kTile;
  const int s = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, cc = lane & 3;
  const int qp = round64(Q), nt = qp / kTile;
  const int r0 = s * kTile;
  const size_t t0 = (size_t)b * S + (size_t)c * Q;
  const size_t hp = (size_t)H * P;
  const size_t bc = (size_t)b * nc + c;
  const float* m = ws + L.m + bc * qp * qp;
  const int ra = 16 * w + g;

  // the M tile at rows m0, columns n0 in two parts, [row][col]
  auto stage_m = [&](int m0, int n0) {
    for (int e = tid; e < kTile * kTile / 2; e += kThreadsTc) {
      const int r = e >> 5, j = (e & 31) * 2;
      const float2 v =
          *reinterpret_cast<const float2*>(m + (size_t)(m0 + r) * qp + n0 + j);
      store_parts2(mp + r * kLdT + j, 2, v.x, v.y);
    }
  };

  for (int nb = 0; nb < N; nb += kTile) {
    float aC[8][4] = {}, aB[8][4] = {};
    // dC[r] += sum_k M[r, k] B[k] over the key tiles at or below the slab
    for (int kt = 0; kt <= s; ++kt) {
      const int k0 = kt * kTile;
      stage_m(r0, k0);
      stage_bf16(ot, kLdT, Bm + (t0 + k0) * N + nb, N, Q - k0, N - nb, kTile,
                 vec_bc);
      __syncthreads();
      mma_tile<false, true>(aC, mp, kLdT, 16 * w, ot, kLdT, kTile);
      mma_tile<false, true>(aC, mp + kTileT, kLdT, 16 * w, ot, kLdT, kTile);
      __syncthreads();
    }
    // dB[r] += sum_q M[q, r] C[q] over the query slabs at or above it
    for (int qt = s; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      stage_m(q0, r0);
      stage_bf16(ot, kLdT, Cm + (t0 + q0) * N + nb, N, Q - q0, N - nb, kTile,
                 vec_bc);
      __syncthreads();
      mma_tile<true, true>(aB, mp, kLdT, 16 * w, ot, kLdT, kTile);
      mma_tile<true, true>(aB, mp + kTileT, kLdT, 16 * w, ot, kLdT, kTile);
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
      stage_bf16(dyr, kLdT, gy + (t0 + r0) * hp + (size_t)hh * P, hp, Q - r0,
                 P, kTile, vec_x);
      stage_bf16(xr, kLdT, x + (t0 + r0) * hp + (size_t)hh * P, hp, Q - r0, P,
                 kTile, vec_x);
      const size_t at = (bc * H + hh) * P * N;
      for (int e = tid; e < kTile * kTile / 2; e += kThreadsTc) {
        const int p = e >> 5, j = (e & 31) * 2;
        const size_t i = at + (size_t)p * N + nb + j;
        float h0 = 0.f, h1 = 0.f, d0 = 0.f, d1 = 0.f;
        if (p < P && nb + j < N) {
          h0 = ws[L.hin + i];
          d0 = ws[L.dh + i];
          if (nb + j + 1 < N) {
            h1 = ws[L.hin + i + 1];
            d1 = ws[L.dh + i + 1];
          }
        }
        store_parts2(hp2 + p * kLdT + j, 2, h0, h1);
        store_parts2(dp2 + p * kLdT + j, 2, d0, d1);
      }
      __syncthreads();
      float tC[8][4] = {}, tB[8][4] = {};
      mma_tile<false, true>(tC, dyr, kLdT, 16 * w, hp2, kLdT, kTile);
      mma_tile<false, true>(tC, dyr, kLdT, 16 * w, hp2 + kTileT, kLdT, kTile);
      mma_tile<false, true>(tB, xr, kLdT, 16 * w, dp2, kLdT, kTile);
      mma_tile<false, true>(tB, xr, kLdT, 16 * w, dp2 + kTileT, kLdT, kTile);
      const float ea = eq[ra], eb = eq[ra + 8], wa = wq[ra], wb = wq[ra + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        aC[j][0] += ea * tC[j][0];
        aC[j][1] += ea * tC[j][1];
        aC[j][2] += eb * tC[j][2];
        aC[j][3] += eb * tC[j][3];
        aB[j][0] += wa * tB[j][0];
        aB[j][1] += wa * tB[j][1];
        aB[j][2] += wb * tB[j][2];
        aB[j][3] += wb * tB[j][3];
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + ra + (e >> 1) * 8;
        const int n = nb + 8 * j + 2 * cc + (e & 1);
        if (t < Q && n < N) {
          dC[(t0 + t) * N + n] = __float2bfloat16_rn(aC[j][e]);
          dB[(t0 + t) * N + n] = __float2bfloat16_rn(aB[j][e]);
        }
      }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
    const int vec_x = P % 8 == 0 && aligned16(x) && aligned16(gy);
    const int vec_bc = N % 8 == 0 && aligned16(B) && aligned16(C);
    const size_t chunk_bytes = chunk_tc_layout(N, Q).total;
    SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_states_tc),
                            states_tc_bytes(N, Q)));
    SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_scores_tc),
                            scores_tc_bytes(N)));
    SSD_BWD_TRY(allow_bytes(reinterpret_cast<const void*>(bwd_chunk_tc),
                            chunk_bytes));
    SSD_BWD_TRY(
        allow_bytes(reinterpret_cast<const void*>(bwd_bc_tc), bc_tc_bytes()));
    bwd_states_tc<<<per_head, kThreadsTc, states_tc_bytes(N, Q), st>>>(
        xt, dtf, static_cast<const float*>(A), Bt, Ct, gt, ws, L, S, H, P, N,
        Q, vec_bc);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_scan<<<scan, kThreads, 0, st>>>(static_cast<const float*>(gstate), ws,
                                        L, S, H, P, N, Q);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_scores_tc<<<pairs, kThreadsTc, scores_tc_bytes(N), st>>>(
        xt, dtf, Bt, Ct, gt, ws, L, S, H, P, N, Q, vec_x, vec_bc);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_chunk_tc<<<per_head, kThreadsTc, chunk_bytes, st>>>(
        xt, dtf, static_cast<const float*>(A), Bt, Ct,
        static_cast<const float*>(D), gt, ws, L, static_cast<T*>(dx),
        static_cast<float*>(ddt), S, H, P, N, Q, vec_x, vec_bc);
    SSD_BWD_TRY(cudaGetLastError());
    bwd_bc_tc<<<slabs, kThreadsTc, bc_tc_bytes(), st>>>(
        xt, dtf, Bt, Ct, gt, ws, L, static_cast<T*>(dB), static_cast<T*>(dC),
        S, H, P, N, Q, vec_x, vec_bc);
    SSD_BWD_TRY(cudaGetLastError());
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
