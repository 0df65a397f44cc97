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
// conv level K*K*Cin multiply-adds per output summed in float32, + bias,
// optional ReLU, the validity mask on global coordinates, an optional
// maxpool with its own mask, and one cast to the compute dtype (float32 or
// bfloat16).  END cascade: at a level l >= 1 (ReLU on, end_skip on) whose
// incoming compute-dtype tile has max == 0, the multiply-adds are skipped
// and the level emits the closed form epilogue(relu(b)) — bit-identical to
// the live path, which computes 0 + b.  Per-cell per-level skip flags are
// written as int32 (B, alpha, alpha, Q); level 0 never skips.
//
// Schedule.  At the reference's plans a block cannot hold a cell's tile
// cascade (ResNet-18 b0's mid tile alone is 861 KB against 227 KB of
// shared memory), and at 224^2 every ResNet-18 launch has alpha == 1.  So
// the kernel is one persistent cooperative launch of as many blocks as fit
// on the card at once, and every level is swept by all of them, for all
// cells together, between grid-wide barriers.  Inter-level tiles live in a
// per-cell global scratch in the compute dtype (two ping-pong level outputs
// and the pre-pool conv tile; their values are compute-dtype values, and
// maxpool commutes with the monotonic rounding), which stays mostly in the
// 50 MB L2.  Scratch, partial sums and live flags are read through L2 only
// (ld.global.cg, cp.async.cg), so no stale L1 line survives a barrier.  The
// END test needs no reduction pass: whoever writes a positive value into a
// cell's level-l output sets that cell's live flag for level l+1, and the
// barrier publishes it; a tile of a dead cell skips its multiply-adds.
//
// Conv phase.  A level is one implicit GEMM per cell, (pixels x K*K*Cin) @
// (K*K*Cin x Cout), cut into tiles of kBM pixels x kBN = 64 channels; the
// wrapper picks kBM = 128, or 64 where a 128-pixel tile would be mostly
// empty (a 7 x 7 level), and writes the choice into the descriptor.  A
// level with fewer tiles than blocks also splits the K*K*Cin sum across
// blocks into float32 partial sums, which a reduction phase adds up in
// split order, so results never depend on scheduling.  A block walks its
// tile's sum in kBK = 32 steps through four shared-memory stages: steps
// s+1 .. s+3 are in flight while step s computes.  The window gather splits
// each address into a per-pixel part ((r*S)*row + c*S)*Cin, tabulated in
// shared memory once per tile, and a per-k part ((kh*row + kw)*Cin + ci),
// computed once per step, in 32-bit arithmetic off a 64-bit cell base.
// Where Cin (for the input tile) or Cout (for the weights) is a multiple of
// 16 bytes' worth of values, the copies are 16-byte cp.async along the
// channel axis; otherwise (an RGB input, a 6-channel level) they are 4-byte
// cp.async for float32 data that no block writes during the launch, and
// loads stored at once for the rest.
//   * bfloat16: the tiles stay bf16 in shared memory (rows padded by 16
//     bytes so ldmatrix is free of bank conflicts) and feed
//     mma.sync.m16n8k16 bf16 -> float32 on the tensor cores; the 8 warps
//     split a tile 4 (pixels) x 2 (channels).
//   * float32: IEEE fp32 FMAs on the CUDA cores (no TF32); each thread owns
//     kBM/16 pixels (16 rows apart) x 4 channels, 8 x 4 of the large tile,
//     and reads only 16-byte vectors: per 4 k a float4 of B for each k and
//     a float4 of A (4 k of its row) for each pixel, 12 loads per 128 FMAs
//     at the large tile, each one shared-memory wavefront (warps are 4
//     pixel rows x 8 channel quads).  The next fragments are loaded one use
//     ahead, into the registers they replace; the loop over 4-k groups is
//     not unrolled, which keeps it within 128 registers (two blocks of 256
//     threads per SM) without spills.
// The tile's sums then go through shared memory to the epilogue (bias,
// ReLU, mask, one cast), in float32 per output, each thread on one channel
// with its pixel coordinates advanced by addition; a block sets its cell's
// live flag with one store.
//
// What bounds it on this card: the multiply-adds bound it far more than
// bytes (float32 at 67 TFLOP/s on the CUDA cores; bf16 at 989 on the
// tensor cores, which puts a whole batch-8 ResNet-18 forward's convolutions
// at about 0.03 ms).  The float32 product loop alone, out of a resident
// tile, issues one shared load per 10.7 FMAs and runs at about 70 % of the
// FMA peak; inside the kernel each step adds the window gather (its address
// arithmetic and 24 KB of cp.async from L2 a block, K*K times the level's
// input for every 64 output channels) and a block barrier, which hold a
// one-conv VGG-16 level at batch 32 near half the peak.  Around the steps:
// the launch and the grid barriers (one per level, one per pool, one per
// split reduction), tiles that overhang a level's pixels (196 of 256 rows
// at 14 x 14), the partial-sum reduction and the scalar epilogue.  PERF.md
// records the measured time beside the bound.
//
// x_slots / w_slots / streamed are schedule knobs of the TPU kernels that
// never change values; this kernel reads one flat HWIO weight buffer with
// per-level offsets and ignores them.  c_tiles only reorders the last
// level's tiles (channel block outermost), which changes no value.  The
// grid, every level's tile and its K-split come from the wrapper in the
// descriptor.
//
// CUDA graphs.  The launch is the only stream work an entry point issues
// (setting the kernel's shared-memory attribute is none), so a launch
// issued while PyTorch captures the stream into a graph records the
// cooperative kernel alone, and each replay relaunches it.  The grid comes
// from the wrapper, which sized it by resident_blocks before any capture;
// a grid too large for one wave is refused by the cooperative launch.  The
// wrapper zeroes the barrier and the live flags with stream work before
// every launch, so a replay starts from zero too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kMaxLevels = 16;
// conv tile: kBM[tile] pixels x kBN channels, the K*K*Cin sum in kBK steps
// (mirrored by CONV_TILE_M / CONV_TILE_N / CONV_TILE_K in
// repro_torch/core/program.py, whose card_layout the wrapper builds on)
constexpr int kBMLarge = 128, kBMSmall = 64, kBN = 64, kBK = 32;
// shared-memory stages of the K loop: up to kStages - 1 steps in flight
constexpr int kStages = 4;
// int64 descriptor layout shared with the Python wrapper
// (repro_torch/kernels/fused_conv/fused_conv.py :: _descriptor)
constexpr int kHeader = 12;
constexpr int kPerLevel = 19;

// threads per block, and the co-resident blocks per SM the registers are
// budgeted for (128 registers a thread)
constexpr int kThreads = 256, kMinBlocks = 2;

struct Level {
  int K, S, n_in, n_out, in_size, out_size;
  int o_base, o_step, valid;
  int pool_k, pool_s, pool_out, pool_o_base, pool_o_step, pool_valid;
  long long w_off;
  int b_off;
  int splits;  // K*K*Cin split this many ways across blocks (1 = none)
  int tile;    // 0: kBMLarge pixels per conv tile, 1: kBMSmall
};

struct Desc {
  int batch, alpha, tile0, stride0, padded, c0;
  int q, relu, end_skip, c_tiles;
  long long cap;  // compute-dtype values per cell in one scratch buffer
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

// loads through L2 only (written earlier in this launch by other blocks)
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Shared-memory layout of one conv tile: kStages stages of A (BM pixel rows
// of kBK values, k contiguous) and B (kBK rows of kBN channels), each row
// padded by 16 bytes (conflict-free ldmatrix and float4 reads, rows stay
// 16-byte aligned for cp.async); after the last step the tile's float32
// sums are laid over them for the epilogue; then the per-pixel gather
// offsets.
template <typename T, int BM>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kAS = kBK + kVec;  // A row stride, values
  static constexpr int kBS = kBN + kVec;  // B row stride, values
  static constexpr int kA = BM * kAS;
  static constexpr int kStage = kA + kBK * kBS;
  static constexpr int kCS = kBN + 8;  // float32 sums row stride
  // the stages, or the tile's float32 sums laid over them
  static constexpr int kTileBytes =
      kStages * kStage * static_cast<int>(sizeof(T)) > BM * kCS * 4
          ? kStages * kStage * static_cast<int>(sizeof(T))
          : BM * kCS * 4;
};

// dynamic shared memory of a block: the larger tile's (kBMSmall uses less)
template <typename T>
constexpr int smem_bytes() {
  return Tile<T, kBMLarge>::kTileBytes +
         kBMLarge * static_cast<int>(sizeof(int));
}

// One kBK step of a tile's products, out of shared memory into per-thread
// float32 accumulators (BM/4 of them), and the (pixel, channel) of each.
template <typename T, int BM>
struct Mma;

// float32 on the CUDA cores: thread (tx, ty) owns pixels ty + 16*a (a <
// kTM) and channels tx*4 .. +4, a warp 4 ty x 8 tx.  A step is kGroups
// groups of 4 k.  Per group a thread reads a float4 of B a k (its 4
// channels) and a float4 of A a pixel (4 k of its row): 4 + kTM 16-byte
// loads for 16*kTM FMAs, each one shared-memory wavefront (the warp's B
// quads are 128 contiguous bytes; its 4 A rows lie kAS = 36 words, 4 banks,
// apart).  Fragments are loaded one use ahead, in place: pixel a+1's A
// before pixel a's FMAs, the next group's b[i] after this group's last FMA
// with b[i]; so 4 B and 2 A vectors are live beside the accumulators.  The
// group loop is not unrolled, which keeps those lifetimes from stretching
// across groups (unrolled, the kernel spills at 128 registers).  An
// iteration runs the last quarter of one group's pixels and the first
// three quarters of the next group's, so the B fragments it loads are used
// in the same iteration and are issued early.
template <int BM>
struct Mma<float, BM> {
  using C = Tile<float, BM>;
  static constexpr int kTM = BM / 16;
  static constexpr int kGroups = kBK / 4;
  // an iteration of the group loop: pixels kSplit .. kTM-1 of one group,
  // then 0 .. kSplit-1 of the next
  static constexpr int kSplit = kTM * 3 / 4;
  static_assert(kTM % 2 == 0, "A fragments alternate between two slots");

  __device__ __forceinline__ static int tx() {
    return (threadIdx.x / 128) * 8 + threadIdx.x % 8;
  }
  __device__ __forceinline__ static int ty() {
    return (threadIdx.x / 32) % 4 * 4 + threadIdx.x % 32 / 8;
  }
  __device__ __forceinline__ static float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }

  // pixels A0 .. A1-1 of group g; with kNext, the group's last pixel (A1 ==
  // kTM) also loads the next group's B fragments and its pixel 0
  template <int A0, int A1, bool kNext>
  __device__ __forceinline__ static void pixels(const float* ar,
                                                const float* bc, int g,
                                                float4 (&b)[4],
                                                float4 (&av)[2], float* acc) {
#pragma unroll
    for (int a = A0; a < A1; ++a) {
      const float4 v = av[a % 2];
      if (a + 1 < kTM) {
        av[(a + 1) % 2] = ld4(ar + (a + 1) * 16 * C::kAS + g * 4);
      } else if (kNext) {
        av[0] = ld4(ar + (g + 1) * 4);
      }
      const float x[4] = {v.x, v.y, v.z, v.w};
      float* c = acc + a * 4;
      // each sum takes its products in ascending k, as fmaf chains
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[0] = fmaf(x[i], b[i].x, c[0]);
        c[1] = fmaf(x[i], b[i].y, c[1]);
        c[2] = fmaf(x[i], b[i].z, c[2]);
        c[3] = fmaf(x[i], b[i].w, c[3]);
        if (kNext && a + 1 == kTM) {
          b[i] = ld4(bc + ((g + 1) * 4 + i) * C::kBS);
        }
      }
    }
  }

  __device__ __forceinline__ static void run(const float* As,
                                             const float* Bs, float* acc) {
    const float* const ar = As + ty() * C::kAS;
    const float* const bc = Bs + tx() * 4;
    float4 b[4], av[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = ld4(bc + i * C::kBS);
    av[0] = ld4(ar);
    pixels<0, kSplit, false>(ar, bc, 0, b, av, acc);
#pragma unroll 1
    for (int g = 0; g < kGroups - 1; ++g) {
      pixels<kSplit, kTM, true>(ar, bc, g, b, av, acc);
      pixels<0, kSplit, false>(ar, bc, g + 1, b, av, acc);
    }
    pixels<kSplit, kTM, false>(ar, bc, kGroups - 1, b, av, acc);
  }

  __device__ __forceinline__ static void coord(int idx, int& m, int& n) {
    m = ty() + 16 * (idx / 4);
    n = tx() * 4 + idx % 4;
  }
};

// bfloat16 on the tensor cores: warp w owns pixels (w % 4)*kMT*16 .. and
// channels (w / 4)*32 .., kMT x 4 m16n8 accumulator tiles
template <int BM>
struct Mma<__nv_bfloat16, BM> {
  using C = Tile<__nv_bfloat16, BM>;
  static constexpr int kMT = BM / 64;

  __device__ __forceinline__ static void run(const __nv_bfloat16* As,
                                             const __nv_bfloat16* Bs,
                                             float* acc) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int m0 = (warp % 4) * kMT * 16, n0 = (warp / 4) * 32;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[kMT][4], b[4][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        ldsm_x4(a[i], As + (m0 + i * 16 + (lane & 15)) * C::kAS + kk +
                          (lane >> 4) * 8);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4];
        ldsm_x4_trans(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  C::kBS +
                             n0 + h * 16 + (lane >> 4) * 8);
        b[2 * h][0] = r[0];
        b[2 * h][1] = r[1];
        b[2 * h + 1][0] = r[2];
        b[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc + (i * 4 + j) * 4, a[i], b[j]);
      }
    }
  }

  __device__ __forceinline__ static void coord(int idx, int& m, int& n) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int i = idx / 16, j = (idx / 4) % 4, c = idx % 4;
    m = (warp % 4) * kMT * 16 + i * 16 + (lane >> 2) + (c >> 1) * 8;
    n = (warp / 4) * 32 + j * 8 + (lane & 3) * 2 + (c & 1);
  }
};

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

// live[i] = 1 where pos: one store per warp and flag, not one per positive
// value (same-address stores from every thread serialise in L2)
__device__ __forceinline__ void flag_live(int* live, int i, bool pos) {
  const unsigned int want = __ballot_sync(__activemask(), pos);
  if (pos) {
    const unsigned int peers = __match_any_sync(want, i);
    if (static_cast<int>(threadIdx.x % 32) == __ffs(peers) - 1) live[i] = 1;
  }
}

__device__ __forceinline__ bool in_range(int g, int valid) {
  return g >= 0 && g < valid;
}

// Grid cells of a launch and per image; values per scratch buffer.  Read
// from the descriptor where they are needed, so no register holds them
// across a phase.
__device__ __forceinline__ int n_cells(const Desc& d) {
  return d.batch * d.alpha * d.alpha;
}
__device__ __forceinline__ long long scratch_buf(const Desc& d) {
  return static_cast<long long>(n_cells(d)) * d.cap;
}

// The buffers every phase of a launch shares.
template <typename T>
struct Ctx {
  const T* x;
  const T* w;
  const T* bias;
  T* out;
  T* scratch;  // two level-output buffers, then the pre-pool conv tiles
  float* partial;
  int* live;

  // the level-l value v at (cell, row r, col c, channel co) of a tile of
  // width `width` — a conv output or a pool output — after its mask: the
  // output, or the next level's input; true where that input is positive
  // (the caller sets the cell's live flag for level l+1)
  __device__ __forceinline__ bool put(const Desc& d, int l, int cell,
                                      int r, int c, int width, int co,
                                      float v) const {
    const T t = from_f32<T>(v);
    const int n_out = d.lv[l].n_out;
    if (l == d.q - 1) {
      const Level& L = d.lv[l];
      const int region = L.pool_k ? L.pool_out : L.out_size;
      const int out_w = d.alpha * region, a2 = d.alpha * d.alpha;
      const int ij = cell % a2, i = ij / d.alpha, j = ij % d.alpha;
      const long long b = cell / a2;
      out[((b * out_w + i * region + r) * out_w + j * region + c) * n_out +
          co] = t;
      return false;
    }
    T* tout = scratch + (l % 2) * scratch_buf(d);
    tout[cell * d.cap + static_cast<long long>(r * width + c) * n_out + co] =
        t;
    return to_f32(t) > 0.f;
  }

  // conv output (cell at grid (i, j), pixel p = (r, c), channel co) of
  // level l, its K*K*Cin sum plus the bias in v: ReLU, validity mask, then
  // the pre-pool tile or put (returning put's flag)
  __device__ __forceinline__ bool finish(const Desc& d, int l, int cell,
                                         int i, int j, int p, int r, int c,
                                         int co, float v) const {
    const Level& L = d.lv[l];
    if (d.relu) v = fmaxf(v, 0.f);
    if (!in_range(L.o_base + i * L.o_step + r, L.valid) ||
        !in_range(L.o_base + j * L.o_step + c, L.valid)) {
      v = 0.f;
    }
    if (L.pool_k > 0) {
      T* tconv = scratch + 2 * scratch_buf(d);
      tconv[cell * d.cap + static_cast<long long>(p) * L.n_out + co] =
          from_f32<T>(v);
      return false;
    }
    return put(d, l, cell, r, c, L.out_size, co, v);
  }

  // the same from (cell, p, co) and the sum alone
  __device__ __forceinline__ bool emit(const Desc& d, int l, int cell,
                                       int p, int co, float acc) const {
    const Level& L = d.lv[l];
    const int a2 = d.alpha * d.alpha;
    const int ij = cell % a2, i = ij / d.alpha, j = ij % d.alpha;
    const int r = p / L.out_size, c = p % L.out_size;
    return finish(d, l, cell, i, j, p, r, c, co,
                  acc + to_f32(bias[L.b_off + co]));
  }
};

// The conv phase of level l with BM-pixel tiles: every (cell, tile, split)
// unit in turn, strided over the grid.
template <typename T, bool KTILED, int BM>
__device__ __forceinline__ void conv_phase(const Desc& d, const Ctx<T>& cx,
                                           int l, unsigned char* smem) {
  using C = Tile<T, BM>;
  using M = Mma<T, BM>;
  constexpr int V = C::kVec;
  constexpr int kAcc = BM * kBN / kThreads;
  T* const sA = reinterpret_cast<T*>(smem);
  float* const Cs = reinterpret_cast<float*>(smem);
  int* const pixoff = reinterpret_cast<int*>(smem + C::kTileBytes);
  const Level& L = d.lv[l];
  const int tid = threadIdx.x;
  const bool last = l == d.q - 1;
  const bool can_skip = l > 0 && d.relu && d.end_skip;
  const int cin = L.n_in, K = L.K, S = L.S, n_out = L.n_out;
  const int osz = L.out_size, pix = osz * osz;
  const int kdim = K * K * cin;
  const int ksteps = (kdim + kBK - 1) / kBK;
  const int splits = L.splits;
  const int row = l == 0 ? d.padded : L.in_size;
  const T* const src =
      l == 0 ? cx.x : cx.scratch + ((l + 1) % 2) * scratch_buf(d);
  const T* const wl = cx.w + L.w_off;
  // 16-byte copies along the channel axis where every row start is aligned
  // (cell bases are multiples of Cin or of the scratch capacity)
  const bool vec_a =
      cin % V == 0 && (l == 0 || d.cap % V == 0) && aligned16(src);
  const bool vec_b = n_out % V == 0 && aligned16(wl);
  // unit indices fit in 32 bits (cells * tiles * splits is at most a few
  // million); only addresses are 64-bit
  const int cells = n_cells(d);
  const int mblocks = (pix + BM - 1) / BM;
  const int nblocks = (n_out + kBN - 1) / kBN;
  const int tiles = cells * mblocks * nblocks;
  // channel-tiled last level: channel block outermost, so concurrent
  // blocks share one slice of the weights (c_tiles changes no value)
  const bool nmajor = KTILED && last && d.c_tiles > 1;
  // the per-k part of the gather address of reduction index k
  auto koff = [&](int k) {
    const int kwh = k / cin, ci = k - kwh * cin;
    const int kh = kwh / K, kw = kwh - kh * K;
    return (kh * row + kw) * cin + ci;
  };

  for (int u = blockIdx.x; u < tiles * splits; u += gridDim.x) {
    const int sp = u % splits;
    const int tile = u / splits;
    int cell, mb, nb;
    if (nmajor) {
      nb = tile / (cells * mblocks);
      const int rest = tile % (cells * mblocks);
      cell = rest / mblocks;
      mb = rest % mblocks;
    } else {
      nb = tile % nblocks;
      const int rest = tile / nblocks;
      mb = rest % mblocks;
      cell = rest / mblocks;
    }
    const int m_base = mb * BM;
    const int n_base = nb * kBN;
    // END: the conv of an all-zero tile is the bias (uniform per block);
    // one load of the flag per warp, not per thread
    int flag = 1;
    if (can_skip && threadIdx.x % 32 == 0) {
      flag = __ldcg(cx.live + cell * d.q + l);
    }
    const bool dead = __shfl_sync(0xffffffffu, flag, 0) == 0;
    if (dead && splits > 1) continue;  // the reduction emits the bias
    if (!dead) {
      const T* base;
      if (l == 0) {
        const int a2 = d.alpha * d.alpha;
        const int ij = cell % a2, i = ij / d.alpha, j = ij % d.alpha;
        const long long b = cell / a2;
        base = cx.x + ((b * d.padded + static_cast<long long>(i) * d.stride0) *
                           d.padded +
                       static_cast<long long>(j) * d.stride0) *
                          d.c0;
      } else {
        base = src + static_cast<long long>(cell) * d.cap;
      }
      for (int m = tid; m < BM; m += kThreads) {
        const int p = m_base + m;
        const int r = p / osz, c = p - r * osz;
        pixoff[m] = p < pix ? (r * S * row + c * S) * cin : -1;
      }
      __syncthreads();
      const int s0 = sp * ksteps / splits;
      const int s1 = (sp + 1) * ksteps / splits;
      // stage s into shared buffer `stage`: 16-byte cp.async copies left
      // in flight; the scalar gathers (an RGB input, a 6-channel level) are
      // 4-byte cp.async copies where the data is float32 and read-only
      // during the launch, else loads stored at once (registers are the
      // scarcer)
      constexpr bool async4 = sizeof(T) == 4;
      auto fetch = [&](int s, int stage) {
        T* As = sA + stage * C::kStage;
        T* Bs = As + C::kA;
        const int k0 = s * kBK;
        if (vec_a) {
          constexpr int cpr = kBK / V;
          const int kc = tid % cpr, k = k0 + kc * V, ko = koff(k);
#pragma unroll
          for (int e = 0; e < BM * cpr / kThreads; ++e) {
            const int m = tid / cpr + e * (kThreads / cpr);
            const int po = pixoff[m];
            const bool ok = po >= 0 && k < kdim;
            cp_async16(As + m * C::kAS + kc * V, ok ? base + po + ko : base,
                       ok);
          }
        } else {
          const int kk = tid % kBK, k = k0 + kk, ko = koff(k);
#pragma unroll 4
          for (int e = 0; e < BM * kBK / kThreads; ++e) {
            const int m = tid / kBK + e * (kThreads / kBK);
            const int po = pixoff[m];
            const bool ok = po >= 0 && k < kdim;
            if (async4 && l == 0) {
              cp_async4(As + m * C::kAS + kk, ok ? base + po + ko : base, ok);
            } else {
              As[m * C::kAS + kk] =
                  from_f32<T>(ok ? ldcg(base + po + ko) : 0.f);
            }
          }
        }
        if (vec_b) {
          constexpr int cpr = kBN / V;
          const int nc = tid % cpr, co = n_base + nc * V;
#pragma unroll
          for (int e = 0; e < kBK * cpr / kThreads; ++e) {
            const int kk = tid / cpr + e * (kThreads / cpr), k = k0 + kk;
            const bool ok = k < kdim && co < n_out;
            cp_async16(Bs + kk * C::kBS + nc * V,
                       ok ? wl + static_cast<long long>(k) * n_out + co : wl,
                       ok);
          }
        } else {
          const int n = tid % kBN, co = n_base + n;
#pragma unroll 4
          for (int e = 0; e < kBK * kBN / kThreads; ++e) {
            const int kk = tid / kBN + e * (kThreads / kBN), k = k0 + kk;
            const bool ok = k < kdim && co < n_out;
            const T* at = ok ? wl + static_cast<long long>(k) * n_out + co : wl;
            if (async4) {
              cp_async4(Bs + kk * C::kBS + n, at, ok);
            } else {
              Bs[kk * C::kBS + n] = ok ? *at : from_f32<T>(0.f);
            }
          }
        }
      };
      float acc[kAcc];
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
      // one commit group per step, empty past the split's end, so the
      // group count stays uniform
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        if (s0 + i < s1) fetch(s0 + i, i);
        cp_async_commit();
      }
      for (int s = s0; s < s1; ++s) {
        cp_async_wait<kStages - 2>();  // step s has landed ...
        __syncthreads();  // ... for every thread, and step s-1 is consumed
        const int ahead = s + kStages - 1;
        if (ahead < s1) fetch(ahead, (ahead - s0) % kStages);
        cp_async_commit();
        const int stage = (s - s0) % kStages;
        M::run(sA + stage * C::kStage, sA + stage * C::kStage + C::kA, acc);
      }
      cp_async_wait<0>();  // only empty groups are left
      __syncthreads();
      // the sums go through shared memory (over the stages, which every
      // thread has finished reading), so the epilogue holds no accumulator
      // registers and writes each output row with consecutive threads
#pragma unroll
      for (int a = 0; a < kAcc; a += 2) {
        int m, n;
        M::coord(a, m, n);
        *reinterpret_cast<float2*>(Cs + m * C::kCS + n) =
            make_float2(acc[a], acc[a + 1]);
      }
      __syncthreads();
    }
    // epilogue (a dead tile's sums are 0): each thread keeps one channel
    // and steps down the tile's pixels kRows at a time, its output
    // coordinates advanced by addition
    bool pos = false;
    const int n = tid % kBN, co = n_base + n;
    if (co < n_out) {
      constexpr int kRows = kThreads / kBN;
      const int a2 = d.alpha * d.alpha, ij = cell % a2;
      const int i = ij / d.alpha, j = ij % d.alpha;
      const float b = to_f32(cx.bias[L.b_off + co]);
      int m = tid / kBN, p = m_base + m;
      int r = p / osz, c = p - r * osz;
      for (; m < BM && p < pix; m += kRows, p += kRows) {
        const float v = dead ? 0.f : Cs[m * C::kCS + n];
        if (splits > 1) {
          cx.partial[(static_cast<long long>(sp * cells + cell) * pix + p) *
                         n_out +
                     co] = v;
        } else {
          pos |= cx.finish(d, l, cell, i, j, p, r, c, co, v + b);
        }
        for (c += kRows; c >= osz; c -= osz) ++r;
      }
    }
    // the tile is one cell's: one flag store per block
    if (__syncthreads_or(pos) && tid == 0) cx.live[cell * d.q + l + 1] = 1;
  }
}

template <typename T, bool KTILED>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pyramid_kernel(const Desc d, const T* __restrict__ x,
                   const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int* __restrict__ skip, T* scratch,
                   float* partial, int* live, unsigned int* bar) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int epoch = 0;
  // element indices of a phase fit in 32 bits (the wrapper checks the
  // buffer sizes); addresses are formed in 64 bits
  const int nthreads = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  Ctx<T> cx;
  cx.x = x;
  cx.w = w;
  cx.bias = bias;
  cx.out = out;
  cx.scratch = scratch;
  cx.partial = partial;
  cx.live = live;

  for (int l = 0; l < d.q; ++l) {
    const Level& L = d.lv[l];
    const bool can_skip = l > 0 && d.relu && d.end_skip;

    // ---- conv phase ----
    if (L.tile == 0) {
      conv_phase<T, KTILED, kBMLarge>(d, cx, l, smem);
    } else {
      conv_phase<T, KTILED, kBMSmall>(d, cx, l, smem);
    }
    if (L.splits > 1) {
      // ---- split reduction: partial sums in split order, then emit ----
      grid_sync(bar, epoch);
      const int pix = L.out_size * L.out_size;
      const int outs = n_cells(d) * pix * L.n_out;
      int flag_cell = -1;  // the cell whose live flag `alive` holds
      bool alive = true;
      for (int it = tid; it < outs; it += nthreads) {
        const int co = it % L.n_out, p = (it / L.n_out) % pix;
        const int cell = it / (L.n_out * pix);
        if (can_skip && cell != flag_cell) {
          alive = __ldcg(live + cell * d.q + l) != 0;
          flag_cell = cell;
        }
        float acc = 0.f;
        if (alive) {
          for (int sp = 0; sp < L.splits; ++sp) {
            acc += __ldcg(partial + static_cast<long long>(sp) * outs + it);
          }
        }
        flag_live(live, cell * d.q + l + 1, cx.emit(d, l, cell, p, co, acc));
      }
    }

    // ---- pool phase: maxpool epilogue of the conv tile, then its mask ----
    if (L.pool_k > 0) {
      grid_sync(bar, epoch);
      const int po = L.pool_out, osz = L.out_size, ppix = po * po;
      const int ptotal = n_cells(d) * ppix * L.n_out;
      for (int it = tid; it < ptotal; it += nthreads) {
        const int co = it % L.n_out, rest = it / L.n_out;
        const int p = rest % ppix, cell = rest / ppix;
        const int pr = p / po, pc = p % po;
        const int a2 = d.alpha * d.alpha;
        const int ij = cell % a2, i = ij / d.alpha, j = ij % d.alpha;
        const T* tc = scratch + 2 * scratch_buf(d) + cell * d.cap;
        float m = -INFINITY;
        for (int pi = 0; pi < L.pool_k; ++pi) {
          for (int pj = 0; pj < L.pool_k; ++pj) {
            const int q = (pr * L.pool_s + pi) * osz + pc * L.pool_s + pj;
            m = fmaxf(m, ldcg(tc + q * L.n_out + co));
          }
        }
        if (!in_range(L.pool_o_base + i * L.pool_o_step + pr, L.pool_valid) ||
            !in_range(L.pool_o_base + j * L.pool_o_step + pc, L.pool_valid)) {
          m = 0.f;
        }
        flag_live(live, cell * d.q + l + 1,
                  cx.put(d, l, cell, pr, pc, po, co, m));
      }
    }
    if (l != d.q - 1) grid_sync(bar, epoch);
  }

  // ---- skip map: every level's live flag was published by the barrier
  // that preceded that level ----
  for (int it = tid; it < n_cells(d) * d.q; it += nthreads) {
    const int l = it % d.q;
    const bool skipped =
        l > 0 && d.relu && d.end_skip && __ldcg(live + it) == 0;
    skip[it] = skipped ? 1 : 0;
  }
}

bool parse(const long long* v, int n, Desc* d) {
  if (n < kHeader) return false;
  d->batch = static_cast<int>(v[0]);
  d->alpha = static_cast<int>(v[1]);
  d->tile0 = static_cast<int>(v[2]);
  d->stride0 = static_cast<int>(v[3]);
  d->padded = static_cast<int>(v[4]);
  d->c0 = static_cast<int>(v[5]);
  d->q = static_cast<int>(v[6]);
  d->relu = static_cast<int>(v[7]);
  d->end_skip = static_cast<int>(v[8]);
  d->c_tiles = static_cast<int>(v[9]);
  d->cap = v[10];
  d->grid = static_cast<int>(v[11]);
  if (d->q < 1 || d->q > kMaxLevels || n != kHeader + d->q * kPerLevel ||
      d->batch < 1 || d->alpha < 1 || d->c_tiles < 1 || d->grid < 1) {
    return false;
  }
  for (int l = 0; l < d->q; ++l) {
    const long long* s = v + kHeader + l * kPerLevel;
    Level& L = d->lv[l];
    L.K = static_cast<int>(s[0]);
    L.S = static_cast<int>(s[1]);
    L.n_in = static_cast<int>(s[2]);
    L.n_out = static_cast<int>(s[3]);
    L.in_size = static_cast<int>(s[4]);
    L.out_size = static_cast<int>(s[5]);
    L.o_base = static_cast<int>(s[6]);
    L.o_step = static_cast<int>(s[7]);
    L.valid = static_cast<int>(s[8]);
    L.pool_k = static_cast<int>(s[9]);
    L.pool_s = static_cast<int>(s[10]);
    L.pool_out = static_cast<int>(s[11]);
    L.pool_o_base = static_cast<int>(s[12]);
    L.pool_o_step = static_cast<int>(s[13]);
    L.pool_valid = static_cast<int>(s[14]);
    L.w_off = s[15];
    L.b_off = static_cast<int>(s[16]);
    L.splits = static_cast<int>(s[17]);
    L.tile = static_cast<int>(s[18]);
    if (L.splits < 1 || (L.tile != 0 && L.tile != 1)) return false;
  }
  if (d->lv[d->q - 1].n_out % d->c_tiles != 0) return false;
  return true;
}

// Allow the kernel its dynamic shared memory; before every occupancy query
// and launch, so both see the kernel that runs.
template <typename T, bool KTILED>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(pyramid_kernel<T, KTILED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T>());
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
  e = set_smem<T, KTILED>();
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pyramid_kernel<T, KTILED>, kThreads, smem_bytes<T>());
  if (e != cudaSuccess) return e;
  *blocks = per_sm * sms;
  return *blocks > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

template <typename T, bool KTILED>
cudaError_t launch(const Desc& d, const void* x, const void* w, const void* b,
                   void* out, void* skip, void* scratch, void* partial,
                   void* live, void* bar, cudaStream_t stream) {
  cudaError_t e = set_smem<T, KTILED>();
  if (e != cudaSuccess) return e;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  int* sp = static_cast<int*>(skip);
  T* scr = static_cast<T*>(scratch);
  float* part = static_cast<float*>(partial);
  int* lv = static_cast<int*>(live);
  unsigned int* br = static_cast<unsigned int*>(bar);
  void* args[] = {(void*)&d,  (void*)&xp,   (void*)&wp, (void*)&bp,
                  (void*)&op, (void*)&sp,   (void*)&scr, (void*)&part,
                  (void*)&lv, (void*)&br};
  e = cudaLaunchCooperativeKernel((const void*)pyramid_kernel<T, KTILED>,
                                  dim3(static_cast<unsigned>(d.grid)),
                                  dim3(kThreads), args, smem_bytes<T>(),
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool KTILED>
int entry(int dtype, const long long* desc, int n, const void* x,
          const void* w, const void* b, void* out, void* skip, void* scratch,
          void* partial, void* live, void* bar, void* stream) {
  Desc d;
  if (!parse(desc, n, &d)) return static_cast<int>(cudaErrorInvalidValue);
  if (KTILED && d.c_tiles < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch<float, KTILED>(
        d, x, w, b, out, skip, scratch, partial, live, bar, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16, KTILED>(
        d, x, w, b, out, skip, scratch, partial, live, bar, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
    return static_cast<int>(ktiled ? resident_blocks<float, true>(blocks)
                                   : resident_blocks<float, false>(blocks));
  }
  if (dtype == 1) {
    return static_cast<int>(
        ktiled ? resident_blocks<__nv_bfloat16, true>(blocks)
               : resident_blocks<__nv_bfloat16, false>(blocks));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_pyramid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
