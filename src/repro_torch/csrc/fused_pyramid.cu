// Fused conv pyramid (conv + bias + ReLU + validity mask [+ maxpool] x Q)
// with the END tile-skip cascade, for NVIDIA Hopper (sm_90a).
//
// Replaces the reference package's Pallas TPU kernels
//   src/repro/kernels/fused_conv/fused_conv.py :: _pyramid_kernel  (entry
//     point `fused_pyramid` below) and
//   src/repro/kernels/fused_conv/fused_conv.py :: _ktiled_kernel   (entry
//     point `fused_pyramid_ktiled`, the last level split into c_tiles
//     output-channel blocks).
//
// What it computes (identical contract to the TPU kernels): for every grid
// cell (b, i, j) of the (B, alpha, alpha) uniform-stride grid, the level-0
// halo tile of the pre-padded NHWC input at (i*stride0, j*stride0), then per
// conv level K*K*Cin float32 multiply-adds per output, + bias, optional
// ReLU, the validity mask on global coordinates, an optional maxpool with
// its own mask, and one cast to the compute dtype (float32 or bfloat16).
// END cascade: at a level l >= 1 (ReLU on, end_skip on) whose incoming
// compute-dtype tile has max == 0, the multiply-adds are skipped and the
// level emits the closed form epilogue(relu(b)) — bit-identical to the live
// path, which computes 0 + b.  Per-cell per-level skip flags are written as
// int32 (B, alpha, alpha, Q); level 0 never skips.
//
// Design.  The TPU kernel runs one grid cell per step with the whole tile
// cascade in VMEM.  At the reference's plans an H100 block could not hold
// that (ResNet-18 b0's mid tile alone is 58*58*64*4 B = 861 KB against
// 227 KB of shared memory), and at 224^2 every ResNet-18 launch has
// alpha == 1, so one block per cell would leave 131 of 132 SMs idle at
// batch 1.  So the kernel is one persistent cooperative launch of as many
// blocks as fit on the card at once, and every level is swept by all of
// them, for all cells together, between grid-wide barriers:
//   * conv phase — the level as one implicit GEMM per cell, (pixels x
//     K*K*Cin) @ (K*K*Cin x Cout), cut into 64-pixel x 64-channel tiles;
//     each tile stages its K*K*Cin sum through shared memory 16 at a time
//     and each thread keeps 4 x 4 float32 accumulators.  A level with fewer
//     tiles than blocks (deep layers at batch 1) also splits the K*K*Cin
//     sum across blocks into partial sums, which a reduction phase adds up
//     in a fixed order, so results do not depend on scheduling;
//   * epilogue — bias, ReLU, validity mask, and either the level's output
//     (cast once) or the pre-pool conv tile; then the pool phase.
// Inter-level tiles live in a per-cell global scratch (two ping-pong level
// outputs and the pre-pool conv tile), which stays mostly in the 50 MB L2;
// scratch, partial sums and liveness flags are read with ld.global.cg so
// no stale L1 line survives a barrier.  The END test needs no reduction
// pass: whoever writes a positive value into a cell's level-l output sets
// that cell's live flag for level l+1, and the barrier publishes it; a
// tile of a dead cell skips its multiply-adds (the whole block agrees).
//
// What bounds it on this card: at the main path's shapes the multiply-adds
// (float32 on the CUDA cores, 67 TFLOP/s; bf16 could use the tensor cores
// at 989) bound it far more than bytes.  The kernel issues float32 FMAs
// from shared-memory tiles without tensor cores, double buffering or
// vectorized loads, so it runs well below that bound; PERF.md records its
// measured time beside the bound.
//
// x_slots / w_slots / streamed are schedule knobs of the TPU kernels that
// never change values; this kernel reads one flat HWIO weight buffer with
// per-level offsets and ignores them.  c_tiles only reorders the last
// level's tiles (channel block outermost), which changes no value.  The
// grid and every level's K-split come from the wrapper in the descriptor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;
// conv output tile per block: kBM pixels x kBN channels, the K*K*Cin sum in
// kBK steps staged in shared memory; each thread owns kTM x kTN outputs
// (pixels ty*kTM.., channels tx + e*kGX so stores stay coalesced)
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kGX = 16;  // threads along the channel axis
constexpr int kTM = kBM / (kThreads / kGX), kTN = kBN / kGX;
// int64 descriptor layout shared with the Python wrapper
// (repro_torch/kernels/fused_conv/fused_conv.py :: _descriptor)
constexpr int kHeader = 12;
constexpr int kPerLevel = 18;

struct Level {
  int K, S, n_in, n_out, in_size, out_size;
  int o_base, o_step, valid;
  int pool_k, pool_s, pool_out, pool_o_base, pool_o_step, pool_valid;
  long long w_off;
  int b_off;
  int splits;  // K*K*Cin split this many ways across blocks (1 = none)
};

struct Desc {
  int batch, alpha, tile0, stride0, padded, c0;
  int q, relu, end_skip, c_tiles;
  long long cap;  // floats per cell in one scratch buffer
  int grid;       // blocks to launch (at most the co-resident count)
  Level lv[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Grid-wide barrier over a cooperative launch (all blocks co-resident).
// bar[0] counts arrivals cumulatively; bar[1] is the last released epoch.
// Both start at 0 (the wrapper zeroes them), so nothing needs resetting.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int& epoch) {
  __threadfence();
  __syncthreads();
  ++epoch;
  if (threadIdx.x == 0) {
    const unsigned int arrived = atomicAdd(&bar[0], 1u) + 1u;
    if (arrived == gridDim.x * epoch) {
      atomicExch(&bar[1], epoch);
    } else {
      while (atomicAdd(&bar[1], 0u) < epoch) {
        __nanosleep(64);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ bool in_range(int g, int valid) {
  return g >= 0 && g < valid;
}

template <typename T, bool KTILED>
__global__ void __launch_bounds__(kThreads)
    pyramid_kernel(const Desc d, const T* __restrict__ x,
                   const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int* __restrict__ skip,
                   float* scratch, float* partial, int* live,
                   unsigned int* bar) {
  __shared__ float As[kBK][kBM + 4];  // gathered inputs, k-major
  __shared__ float Bs[kBK][kBN + 4];  // weight rows
  const int tx = threadIdx.x % kGX, ty = threadIdx.x / kGX;
  unsigned int epoch = 0;
  const long long cells = (long long)d.batch * d.alpha * d.alpha;
  const long long cells2 = (long long)d.alpha * d.alpha;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Level& lastL = d.lv[d.q - 1];
  const int region = lastL.pool_k ? lastL.pool_out : lastL.out_size;
  const int out_w = d.alpha * region;
  const int c_last = lastL.n_out;
  const long long buf = cells * d.cap;  // floats per scratch buffer
  float* tconv = scratch + 2 * buf;     // pre-pool conv tiles

  for (int l = 0; l < d.q; ++l) {
    const Level& L = d.lv[l];
    const bool last = l == d.q - 1;
    const bool pooled = L.pool_k > 0;
    const bool can_skip = l > 0 && d.relu && d.end_skip;
    const float* tin = scratch + ((l + 1) % 2) * buf;  // level l-1's output
    float* tout = scratch + (l % 2) * buf;
    const int osz = L.out_size;
    const long long pix = (long long)osz * osz;
    const int kdim = L.K * L.K * L.n_in;
    const int ksteps = (kdim + kBK - 1) / kBK;
    const int splits = L.splits;

    // conv output (cell, pixel p, channel co) with its K*K*Cin sum in acc:
    // + bias, ReLU, validity mask, then the pre-pool tile, the next level's
    // input (setting the cell's live flag) or the output
    auto emit = [&](long long cell, long long p, int co, float acc) {
      const int ij = (int)(cell % cells2);
      const int i = ij / d.alpha, j = ij % d.alpha;
      const int r = (int)(p / osz), c = (int)(p % osz);
      float v = acc + to_f32(bias[L.b_off + co]);
      if (d.relu) v = fmaxf(v, 0.f);
      if (!in_range(L.o_base + i * L.o_step + r, L.valid) ||
          !in_range(L.o_base + j * L.o_step + c, L.valid)) {
        v = 0.f;
      }
      if (pooled) {
        tconv[cell * d.cap + p * L.n_out + co] = v;
        return;
      }
      const T t = from_f32<T>(v);
      if (last) {
        const long long b = cell / cells2;
        out[((b * out_w + (long long)i * region + r) * out_w +
              (long long)j * region + c) *
                 c_last +
             co] = t;
      } else {
        const float vf = to_f32(t);
        tout[cell * d.cap + p * L.n_out + co] = vf;
        if (vf > 0.f) live[cell * d.q + l + 1] = 1;
      }
    };

    // ---- conv phase: level l as one implicit GEMM per cell, (pixels x
    // K*K*Cin) @ (K*K*Cin x Cout), in kBM x kBN output tiles; a level with
    // fewer tiles than blocks also splits the K*K*Cin sum `splits` ways
    // into partial sums, added up in a fixed order below ----
    const long long mblocks = (pix + kBM - 1) / kBM;
    const long long nblocks = (L.n_out + kBN - 1) / kBN;
    const long long tiles = cells * mblocks * nblocks;
    // channel-tiled last level: channel block outermost, so concurrent
    // blocks share one slice of the weights (c_tiles changes no value)
    const bool nmajor = KTILED && last && d.c_tiles > 1;
    for (long long u = blockIdx.x; u < tiles * splits; u += gridDim.x) {
      const int sp = (int)(u % splits);
      const long long tile = u / splits;
      long long cell, mb, nb;
      if (nmajor) {
        nb = tile / (cells * mblocks);
        const long long rest = tile % (cells * mblocks);
        cell = rest / mblocks;
        mb = rest % mblocks;
      } else {
        nb = tile % nblocks;
        const long long rest = tile / nblocks;
        mb = rest % mblocks;
        cell = rest / mblocks;
      }
      // END: the conv of an all-zero tile is the bias (uniform per block)
      const bool dead = can_skip && __ldcg(live + cell * d.q + l) == 0;
      if (dead && splits > 1) continue;  // the reduction emits the bias
      float acc[kTM][kTN];
#pragma unroll
      for (int a = 0; a < kTM; ++a) {
#pragma unroll
        for (int e = 0; e < kTN; ++e) acc[a][e] = 0.f;
      }
      if (!dead) {
        const int ij = (int)(cell % cells2);
        const int i = ij / d.alpha, j = ij % d.alpha;
        const long long b = cell / cells2;
        const float* tcell = tin + cell * d.cap;
        const T* xcell = x + ((b * d.padded + (long long)i * d.stride0) *
                                  d.padded +
                              (long long)j * d.stride0) *
                                 d.c0;
        const long long row = l == 0 ? (long long)d.padded : L.in_size;
        const int s0 = (int)((long long)sp * ksteps / splits);
        const int s1 = (int)((long long)(sp + 1) * ksteps / splits);
        for (int k0 = s0 * kBK; k0 < s1 * kBK; k0 += kBK) {
          // gather the input tile: k = (kh * K + kw) * Cin + ci, the HWIO
          // weight row order; ci is contiguous in memory
          for (int e = threadIdx.x; e < kBK * kBM; e += kThreads) {
            const int m = e / kBK, kk = e % kBK;
            const int k = k0 + kk;
            const long long p = mb * kBM + m;
            float v = 0.f;
            if (k < kdim && p < pix) {
              const int ci = k % L.n_in, kwh = k / L.n_in;
              const int kh = kwh / L.K, kw = kwh % L.K;
              const long long r = p / osz, c = p % osz;
              const long long at =
                  ((r * L.S + kh) * row + c * L.S + kw) * L.n_in + ci;
              v = l == 0 ? to_f32(xcell[at]) : __ldcg(tcell + at);
            }
            As[kk][m] = v;
          }
          for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
            const int kk = e / kBN, n = e % kBN;
            const int k = k0 + kk;
            const long long co = nb * kBN + n;
            Bs[kk][n] = (k < kdim && co < L.n_out)
                            ? to_f32(w[L.w_off + (long long)k * L.n_out + co])
                            : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < kBK; ++kk) {
            float av[kTM], bv[kTN];
#pragma unroll
            for (int a = 0; a < kTM; ++a) av[a] = As[kk][ty * kTM + a];
#pragma unroll
            for (int e = 0; e < kTN; ++e) bv[e] = Bs[kk][tx + e * kGX];
#pragma unroll
            for (int a = 0; a < kTM; ++a) {
#pragma unroll
              for (int e = 0; e < kTN; ++e) {
                acc[a][e] = fmaf(av[a], bv[e], acc[a][e]);
              }
            }
          }
          __syncthreads();
        }
      }
#pragma unroll
      for (int a = 0; a < kTM; ++a) {
        const long long p = mb * kBM + ty * kTM + a;
        if (p >= pix) continue;
#pragma unroll
        for (int e = 0; e < kTN; ++e) {
          const int co = (int)(nb * kBN) + tx + e * kGX;
          if (co >= L.n_out) continue;
          if (splits > 1) {
            partial[((sp * cells + cell) * pix + p) * L.n_out + co] =
                acc[a][e];
          } else {
            emit(cell, p, co, acc[a][e]);
          }
        }
      }
    }
    if (splits > 1) {
      // ---- split reduction: partial sums in split order, then emit ----
      grid_sync(bar, epoch);
      const long long outs = cells * pix * L.n_out;
      for (long long it = tid; it < outs; it += nthreads) {
        const int co = (int)(it % L.n_out);
        const long long p = (it / L.n_out) % pix;
        const long long cell = it / ((long long)L.n_out * pix);
        float acc = 0.f;
        if (!(can_skip && __ldcg(live + cell * d.q + l) == 0)) {
          for (int sp = 0; sp < splits; ++sp) {
            acc += __ldcg(partial + sp * outs + it);
          }
        }
        emit(cell, p, co, acc);
      }
    }

    // ---- pool phase: maxpool epilogue of the conv tile, then its mask ----
    if (pooled) {
      grid_sync(bar, epoch);
      const int po = L.pool_out;
      const long long ppix = (long long)po * po;
      const long long ptotal = cells * ppix * L.n_out;
      for (long long it = tid; it < ptotal; it += nthreads) {
        const int co = (int)(it % L.n_out);
        const long long rest = it / L.n_out;
        const long long p = rest % ppix;
        const long long cell = rest / ppix;
        const int pr = (int)(p / po), pc = (int)(p % po);
        const int ij = (int)(cell % cells2);
        const int i = ij / d.alpha, j = ij % d.alpha;
        const float* tc = tconv + cell * d.cap;
        float m = -INFINITY;
        for (int pi = 0; pi < L.pool_k; ++pi) {
          for (int pj = 0; pj < L.pool_k; ++pj) {
            const long long q =
                (long long)(pr * L.pool_s + pi) * osz + (pc * L.pool_s + pj);
            m = fmaxf(m, __ldcg(tc + q * L.n_out + co));
          }
        }
        if (!in_range(L.pool_o_base + i * L.pool_o_step + pr, L.pool_valid) ||
            !in_range(L.pool_o_base + j * L.pool_o_step + pc, L.pool_valid)) {
          m = 0.f;
        }
        const T v = from_f32<T>(m);
        if (last) {
          const long long b = cell / cells2;
          out[((b * out_w + (long long)i * region + pr) * out_w +
                (long long)j * region + pc) *
                   c_last +
               co] = v;
        } else {
          const float vf = to_f32(v);
          tout[cell * d.cap + p * L.n_out + co] = vf;
          if (vf > 0.f) live[cell * d.q + l + 1] = 1;
        }
      }
    }
    if (!last) grid_sync(bar, epoch);
  }

  // ---- skip map: every level's live flag was published by the barrier
  // that preceded that level ----
  const long long nflags = cells * d.q;
  for (long long it = tid; it < nflags; it += nthreads) {
    const int l = (int)(it % d.q);
    const bool skipped = l > 0 && d.relu && d.end_skip && __ldcg(live + it) == 0;
    skip[it] = skipped ? 1 : 0;
  }
}

bool parse(const long long* v, int n, Desc* d) {
  if (n < kHeader) return false;
  d->batch = (int)v[0];
  d->alpha = (int)v[1];
  d->tile0 = (int)v[2];
  d->stride0 = (int)v[3];
  d->padded = (int)v[4];
  d->c0 = (int)v[5];
  d->q = (int)v[6];
  d->relu = (int)v[7];
  d->end_skip = (int)v[8];
  d->c_tiles = (int)v[9];
  d->cap = v[10];
  d->grid = (int)v[11];
  if (d->q < 1 || d->q > kMaxLevels || n != kHeader + d->q * kPerLevel ||
      d->batch < 1 || d->alpha < 1 || d->c_tiles < 1 || d->grid < 1) {
    return false;
  }
  for (int l = 0; l < d->q; ++l) {
    const long long* s = v + kHeader + l * kPerLevel;
    Level& L = d->lv[l];
    L.K = (int)s[0];
    L.S = (int)s[1];
    L.n_in = (int)s[2];
    L.n_out = (int)s[3];
    L.in_size = (int)s[4];
    L.out_size = (int)s[5];
    L.o_base = (int)s[6];
    L.o_step = (int)s[7];
    L.valid = (int)s[8];
    L.pool_k = (int)s[9];
    L.pool_s = (int)s[10];
    L.pool_out = (int)s[11];
    L.pool_o_base = (int)s[12];
    L.pool_o_step = (int)s[13];
    L.pool_valid = (int)s[14];
    L.w_off = s[15];
    L.b_off = (int)s[16];
    L.splits = (int)s[17];
    if (L.splits < 1) return false;
  }
  if (d->lv[d->q - 1].n_out % d->c_tiles != 0) return false;
  return true;
}

// How many blocks of the kernel can be co-resident on the current device:
// the largest grid a cooperative launch accepts.
template <typename T, bool KTILED>
cudaError_t resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pyramid_kernel<T, KTILED>, kThreads, 0);
  if (e != cudaSuccess) return e;
  *blocks = per_sm * sms;
  return *blocks > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

template <typename T, bool KTILED>
cudaError_t launch(const Desc& d, const void* x, const void* w, const void* b,
                   void* out, void* skip, void* scratch, void* partial,
                   void* live, void* bar, cudaStream_t stream) {
  int resident = 0;
  cudaError_t e = resident_blocks<T, KTILED>(&resident);
  if (e != cudaSuccess) return e;
  if (d.grid > resident) return cudaErrorCooperativeLaunchTooLarge;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  int* sp = static_cast<int*>(skip);
  float* scr = static_cast<float*>(scratch);
  float* part = static_cast<float*>(partial);
  int* lv = static_cast<int*>(live);
  unsigned int* br = static_cast<unsigned int*>(bar);
  void* args[] = {(void*)&d,  (void*)&xp,   (void*)&wp, (void*)&bp,
                  (void*)&op, (void*)&sp,   (void*)&scr, (void*)&part,
                  (void*)&lv, (void*)&br};
  e = cudaLaunchCooperativeKernel((const void*)pyramid_kernel<T, KTILED>,
                                  dim3((unsigned)d.grid), dim3(kThreads),
                                  args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool KTILED>
int entry(int dtype, const long long* desc, int n, const void* x,
          const void* w, const void* b, void* out, void* skip, void* scratch,
          void* partial, void* live, void* bar, void* stream) {
  Desc d;
  if (!parse(desc, n, &d)) return (int)cudaErrorInvalidValue;
  if (KTILED && d.c_tiles < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float, KTILED>(d, x, w, b, out, skip, scratch,
                                      partial, live, bar, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16, KTILED>(d, x, w, b, out, skip, scratch,
                                              partial, live, bar, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel A: the untiled pyramid (replaces _pyramid_kernel).  dtype: 0 =
// float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int fused_pyramid(int dtype, const long long* desc, int n, const void* x,
                  const void* w, const void* b, void* out, void* skip,
                  void* scratch, void* partial, void* live, void* bar,
                  void* stream) {
  return entry<false>(dtype, desc, n, x, w, b, out, skip, scratch, partial,
                      live, bar, stream);
}

// Kernel B: the channel-tiled pyramid (replaces _ktiled_kernel); needs
// c_tiles >= 2 in the descriptor.
int fused_pyramid_ktiled(int dtype, const long long* desc, int n,
                         const void* x, const void* w, const void* b,
                         void* out, void* skip, void* scratch, void* partial,
                         void* live, void* bar, void* stream) {
  return entry<true>(dtype, desc, n, x, w, b, out, skip, scratch, partial,
                     live, bar, stream);
}

// The grid the wrapper should launch (and may not exceed) for a dtype and
// kernel: the co-resident block count on the current device.
int fused_pyramid_resident_blocks(int dtype, int ktiled, int* blocks) {
  if (dtype == 0) {
    return (int)(ktiled ? resident_blocks<float, true>(blocks)
                        : resident_blocks<float, false>(blocks));
  }
  if (dtype == 1) {
    return (int)(ktiled ? resident_blocks<__nv_bfloat16, true>(blocks)
                        : resident_blocks<__nv_bfloat16, false>(blocks));
  }
  return (int)cudaErrorInvalidValue;
}

const char* fused_pyramid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
