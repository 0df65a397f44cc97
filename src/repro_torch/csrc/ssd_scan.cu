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
// (the wrapper casts them); everything is computed in float32.
//
// Design.  The TPU grid walks the chunks in order and keeps the state in
// VMEM across grid steps; CUDA blocks run in no order, so one block owns
// one (sequence, head) and walks that head's chunks itself, with the state
// in shared memory (P x (N+1) floats, 33 KB at P = 64, N = 128).  The TPU
// body materialises the whole (Q, Q, H) decay L and the (Q, Q) scores; at
// the model's chunk of 256 one such f32 square is 256 KB, more than a
// block's shared memory, so the chunk is cut into 64-row query slabs and
// 64-column key tiles.  For a slab, the carried-state term and D x start
// the accumulator; then for each key tile at or below the diagonal the
// scores C B^T (64 x 64, inner dimension N) are built in registers, masked
// to k <= q *before* exp (above the diagonal cums[q] - cums[k] > 0, and an
// exp that overflows would turn the mask's zero into NaN), decayed, staged
// in shared memory and multiplied into the accumulator with the tile's
// dt-scaled x.  The state update reuses the key tiles of the chunk's last
// slab, which visits every key tile, after that slab has read h_in.  The
// cumulative sums stay float32.  256 threads; each owns a 4 x 4 patch of
// every 64 x 64 product (rows ty + 16 i, columns tx + 16 j), so P <= 64.
// Rows past Q (a chunk that is not a multiple of 64) load as zeros and are
// not written.  No atomics: every sum has a fixed order.
//
// What bounds it on this card: at the main path's shapes (Mamba-2-780m
// prefill, b = 4, S = 4096, H = 48, P = 64, N = 128, Q = 256, bf16) each
// chunk of each sequence sums over the Q(Q+1)/2 pairs k <= q: 2 N Q(Q+1)/2
// FLOPs for the scores, H 2 P Q(Q+1)/2 for the diagonal blocks, then
// H 2 Q N P for the state's output term and as many for the state update:
// 39.2 GFLOP per layer, 0.59 ms at 67 TFLOP/s in float32 FMAs, against
// 0.065 ms for the 217 MB it must read and write at 3.35 TB/s.  Operations
// bound it.  This kernel computes more than that (74 GFLOP per layer):
// the scores once per head (48 times, since B and C are shared by all
// heads; computing them once per sequence and chunk is the obvious next
// gain), whole 64 x 64 tiles on the diagonal, and all of it in float32
// FMAs from shared memory rather than on the tensor cores (wgmma with the
// operands in bf16 and TMA staging are later work).  At one 135 KB block
// per SM, 192 blocks take two waves on 132 SMs.  PERF.md records its
// measured time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query rows per slab, key rows per tile
constexpr int kLd = kTile + 1;  // padded row of a transposed tile
constexpr int kMaxP = 64;       // columns the 16 x 16 thread map covers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as a cast in torch
}

// floats of dynamic shared memory for one block
size_t smem_floats(int P, int N, int Q) {
  return (size_t)P * (N + 1)      // hs: the carried state
         + 2 * (size_t)N * kLd    // ct, bt: C slab and B tile, transposed
         + (size_t)kTile * P      // xs: dt-scaled x tile
         + (size_t)kTile * kLd    // gs: masked, decayed scores
         + kTile                  // wk: the tile's state-update decays
         + 2 * (size_t)Q;         // cums, dts over the chunk
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ state, int S, int H,
                int P, int N, int Q) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ldh = N + 1;
  float* hs = smem;
  float* ct = hs + (size_t)P * ldh;
  float* bt = ct + (size_t)N * kLd;
  float* xs = bt + (size_t)N * kLd;
  float* gs = xs + (size_t)kTile * P;
  float* wk = gs + (size_t)kTile * kLd;
  float* cums = wk + kTile;
  float* dts = cums + Q;

  for (int e = tid; e < P * ldh; e += kThreads) hs[e] = 0.f;
  const float a = A[h];
  const float dh = D[h];
  const int nslab = (Q + kTile - 1) / kTile;
  const size_t seq = (size_t)b * S;  // first token of this sequence

  for (int c0 = 0; c0 < S; c0 += Q) {
    for (int t = tid; t < Q; t += kThreads) {
      dts[t] = dt[(seq + c0 + t) * H + h];
    }
    __syncthreads();
    if (tid < 32) {
      // inclusive cumsum of dt * A: each lane runs a contiguous run of the
      // chunk, then the lanes' totals are scanned across the warp
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
    const float clast = cums[Q - 1];

    for (int s = 0; s < nslab; ++s) {
      const int q0 = s * kTile;
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N;
        const int n = e - r * N;
        const int q = q0 + r;
        ct[n * kLd + r] =
            q < Q ? to_f32(Cm[(seq + c0 + q) * N + n]) : 0.f;
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
              const float xv =
                  to_f32(x[((seq + c0 + q) * H + h) * P + p]);
              acc[i][j] = sum[i][j] * expf(cums[q]) + xv * dh;
            }
          }
        }
      }

      const bool last = s == nslab - 1;
      if (last) {
        __syncthreads();  // every read of h_in above is done
        const float g = expf(clast);
        for (int e = tid; e < P * N; e += kThreads) {
          const int p = e / N;
          hs[p * ldh + (e - p * N)] *= g;
        }
      }

      for (int kt = 0; kt <= s; ++kt) {
        const int k0 = kt * kTile;
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N;
          const int n = e - r * N;
          const int k = k0 + r;
          bt[n * kLd + r] =
              k < Q ? to_f32(Bm[(seq + c0 + k) * N + n]) : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int r = e / P;
          const int p = e - r * P;
          const int k = k0 + r;
          xs[e] = k < Q ? to_f32(x[((seq + c0 + k) * H + h) * P + p]) *
                              dts[k]
                        : 0.f;
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
          if (q < Q && p < P) {
            store(&y[((seq + c0 + q) * H + h) * P + p], acc[i][j]);
          }
        }
      }
    }
  }

  float* out = state + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    out[e] = hs[p * ldh + (e - p * N)];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* D, void* y,
                   void* state, int batch, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N, Q) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(state), S, H, P, N, Q);
  return cudaGetLastError();
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
  if (batch < 0 || S < 0 || H < 0 || P < 1 || P > kMaxP || N < 1 || Q < 1 ||
      S % Q != 0 || (bf16 != 0 && bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)launch<__nv_bfloat16>(x, dt, A, B, C, D, y, state, batch, S,
                                      H, P, N, Q, s);
  }
  return (int)launch<float>(x, dt, A, B, C, D, y, state, batch, S, H, P, N,
                            Q, s);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
