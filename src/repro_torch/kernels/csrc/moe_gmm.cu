// Grouped matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` / `gmm` of
// src/repro/kernels/moe_gmm.py and computes what it computes:
//
//   out[g] = x[g] @ w[g]      x (G, C, d), w (G, d, F) -> out (G, C, F)
//
// with the products summed in f32 over the whole contraction and the result
// rounded once, to x's dtype.  x, w and out share one dtype (f32 or bf16) and
// are contiguous; nothing is padded in memory.  In the MoE layer G is the
// expert count, C the capacity (tokens per expert) and d, F the expert's
// input and hidden widths: the three "ecd,edf->ecf" products of
// models/moe._expert_compute.
//
// Design.  The TPU kernel walks the contraction as the innermost, sequential
// grid axis and carries the f32 sum in VMEM scratch across grid steps, after
// padding C, F and d to its tiles.  Blocks on the GPU run in no order, so
// here one block owns one output tile of one expert and loops over d itself.
// The wrapper (kernels/moe_gmm.py, `variant`) chooses among:
//
// * FMA (f32 inputs, and bf16 inputs with d or F not a multiple of 8 or a
//   base not 16-byte aligned).  BM x 64 tiles (BM 64, or 16 when C <= 16),
//   a BM x 16 tile of x and a 16 x 64 tile of w staged as f32 in shared
//   memory per step, a TM x 4 block of f32 accumulators a thread; rows past
//   C, columns past F and the contraction tail past d are masked.
// * Tensor-core prefill tile, wgmma (bf16, C > 16).  128 x 256 outputs of
//   one expert a block; two warpgroups of 64 rows, each issuing one
//   m64n256k16 wgmma (bf16 in, f32 out) per k16 step with both operands read
//   from shared memory; BK 64.  x (128 x 64) and w (64 x 256) tiles stream
//   through a 4-stage cp.async ring, written in the 128-byte swizzled layouts
//   wgmma reads: x K-major (one 128-byte row per row of x), w N-major (w is
//   (d, F) row-major; the instruction's transpose flag reads it so), four
//   64-column atoms of 8 KB.  Chunks past C, d or F are zero-filled by the
//   copy (src-size 0).  Each step's wgmma group is left in flight while the
//   next step's copies are issued, so tiles are loaded two steps ahead.  One
//   block an SM (193 KB of shared memory, 128 f32 accumulators a thread).
//   The epilogue rounds once, stages the tile in shared memory and stores 16
//   bytes a thread.  Granite-3.0-1B-A400M's prefill products are 320 (wg,
//   wi) and 640 (wo) blocks with no ragged tile (C = 640 = 5 x 128).
//   Tried on the H100 and slower (PERF.md, PR 15): the same tile on
//   mma.sync m16n8k16 (8 warps of 64 x 32), and 128 x 128 wgmma tiles with
//   3 or 4 stages, 1 or 2 blocks an SM, with and without a group in flight.
// * Tensor-core decode tile (bf16, C <= 16).  The cost is streaming the
//   experts' weights, 33.6 MB a product at Granite's size.  The C rows fill
//   one m16 tile of mma.sync; a block of 4 warps owns 64 columns of one
//   expert and streams its (d x 64) slab of w through a 4-stage ring of
//   64 x 64 tiles, three in flight while one is used; 256 (wg, wi) or 512
//   (wo) blocks of 46 KB keep every SM's memory pipe busy.
//
// Bound on the H100 (SXM, 700 W data sheet: 3.35 TB/s HBM, 989 TFLOP/s dense
// bf16, 67 TFLOP/s f32 without tensor cores).  Work is 2*G*C*d*F FLOPs;
// bytes are x and w read once and out written once.  Granite-3.0-1B-A400M's
// prefill (4 x 512 tokens, top-8 of 32 experts, capacity 640): x (32, 640,
// 1024) @ w (32, 1024, 512) in bf16 moves 96.5 MB for 21.5 GFLOP (223 FLOP
// per byte, below the ~295 ridge), bound by bytes at ~28.8 us.  A decode step
// (C = 4) streams the 33.6 MB of weights: ~10 us.
//
// What is still left on the table: the wgmma tile loads with cp.async from
// every thread and syncs the block once a step (no TMA, no producer warp
// with mbarriers, no clusters that share tiles); the tiles are not
// persistent, so an epilogue does not overlap the next tile's loads, and the
// 320 blocks of wg/wi are 2.4 waves on 132 SMs; the capacity buffer is
// dense, so padded slots of lightly loaded experts are computed too (no
// ragged schedule over the experts' real counts); the decode tile computes
// 16 rows for C of them (the tensor cores are idle there anyway: the tile
// is bound by w's bytes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // contraction step
constexpr int kTN = 4;    // columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 4 consecutive elements from an address aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

struct Params {
  const void* x;
  const void* w;
  void* out;
  int G, C, d, F;
  int vec_x;  // x rows may be read 4 elements at a time
  int vec_w;  // w rows may be read 4 elements at a time
};

template <typename T, int BM, int TM>
__global__ void __launch_bounds__(kThreads) gmm_kernel(Params p) {
  static_assert((BM / TM) * (kBN / kTN) == kThreads, "one thread per TM x 4 outputs");
  // x tile stored transposed, [k][m], so one thread's TM rows of one k are
  // consecutive; +4 keeps rows 16-byte aligned and staggers the banks.
  __shared__ __align__(16) float xs[kBK][BM + 4];
  __shared__ __align__(16) float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int f0 = blockIdx.x * kBN;
  const int c0 = blockIdx.y * BM;
  const int64_t g = blockIdx.z;
  const T* x = static_cast<const T*>(p.x) + g * p.C * p.d;
  const T* w = static_cast<const T*>(p.w) + g * p.d * p.F;
  T* out = static_cast<T*>(p.out) + g * p.C * p.F;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.d; k0 += kBK) {
    // x tile: BM rows x kBK, 4 consecutive k per item
    for (int it = tid; it < BM * (kBK / 4); it += kThreads) {
      const int m = it / (kBK / 4);
      const int k = (it % (kBK / 4)) * 4;
      const int row = c0 + m;
      const int kg = k0 + k;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < p.C) {
        const T* src = x + static_cast<int64_t>(row) * p.d + kg;
        if (p.vec_x) {
          if (kg < p.d) v = load4(src);  // d % 4 == 0: all 4 in range
        } else {
          if (kg < p.d) v.x = to_f32(src[0]);
          if (kg + 1 < p.d) v.y = to_f32(src[1]);
          if (kg + 2 < p.d) v.z = to_f32(src[2]);
          if (kg + 3 < p.d) v.w = to_f32(src[3]);
        }
      }
      xs[k][m] = v.x;
      xs[k + 1][m] = v.y;
      xs[k + 2][m] = v.z;
      xs[k + 3][m] = v.w;
    }
    // w tile: kBK rows x kBN, 4 consecutive columns per item
    for (int it = tid; it < kBK * (kBN / 4); it += kThreads) {
      const int k = it / (kBN / 4);
      const int n = (it % (kBN / 4)) * 4;
      const int kg = k0 + k;
      const int col = f0 + n;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kg < p.d) {
        const T* src = w + static_cast<int64_t>(kg) * p.F + col;
        if (p.vec_w) {
          if (col < p.F) v = load4(src);  // F % 4 == 0: all 4 in range
        } else {
          if (col < p.F) v.x = to_f32(src[0]);
          if (col + 1 < p.F) v.y = to_f32(src[1]);
          if (col + 2 < p.F) v.z = to_f32(src[2]);
          if (col + 3 < p.F) v.w = to_f32(src[3]);
        }
      }
      *reinterpret_cast<float4*>(&ws[k][n]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * TM + i]);
          a[i] = av.x;
          a[i + 1] = av.y;
          a[i + 2] = av.z;
          a[i + 3] = av.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
      }
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      const float b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = c0 + ty * TM + i;
    if (row >= p.C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = f0 + tx * kTN + j;
      if (col < p.F) store(out + static_cast<int64_t>(row) * p.F + col, acc[i][j]);
    }
  }
}

template <typename T, int BM, int TM>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int64_t c_tiles = (static_cast<int64_t>(p.C) + BM - 1) / BM;
  if (c_tiles > 65535 || p.G > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((p.F + kBN - 1) / kBN, static_cast<unsigned>(c_tiles), p.G);
  gmm_kernel<T, BM, TM><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  return p.C <= 16 ? launch<T, 16, 1>(p, stream) : launch<T, 64, 4>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// Decode tile (C <= 16): the C rows padded to one m16 tile, 64 columns of
// one expert a block, 4 warps of 16 columns, BK 64; the cost is streaming w.
constexpr int kDBN = 64, kDBK = 64, kDThreads = 128, kDStages = 4;
constexpr int kDXLD = kDBK + 8, kDWLD = kDBN + 8;
constexpr int kDStage = 16 * kDXLD + kDBK * kDWLD;
constexpr size_t kDSmem = sizeof(bf16) * kDStages * kDStage;

struct TcParams {
  const bf16* x;
  const bf16* w;
  bf16* out;
  int C, d, F;
};

// x rows [0, 16) x cols [k0, k0 + kDBK) and w rows [k0, k0 + kDBK) x cols
// [f0, f0 + kDBN) into shared memory by 16-byte cp.async; chunks past C, d
// or F are zero-filled (d and F are multiples of 8, so a chunk is wholly in
// or out).
__device__ __forceinline__ void load_decode_stage(bf16* xs, bf16* ws, const bf16* x,
                                                  const bf16* w, int C, int d, int F, int k0,
                                                  int f0) {
  constexpr int XCH = kDBK / 8, WCH = kDBN / 8;
  for (int i = threadIdx.x; i < 16 * XCH; i += kDThreads) {
    const int r = i / XCH, c = (i % XCH) * 8;
    const int k = k0 + c;
    const bool ok = r < C && k < d;
    mma::cp_async16(xs + r * kDXLD + c, ok ? x + static_cast<int64_t>(r) * d + k : x, ok);
  }
  for (int i = threadIdx.x; i < kDBK * WCH; i += kDThreads) {
    const int r = i / WCH, c = (i % WCH) * 8;
    const int k = k0 + r, col = f0 + c;
    const bool ok = k < d && col < F;
    mma::cp_async16(ws + r * kDWLD + c, ok ? w + static_cast<int64_t>(k) * F + col : w, ok);
  }
}

// grid (F tiles of 64, G).  Each block streams its 64 columns of w through
// a 4-stage ring of 64 x 64 tiles (three in flight while one is used).
__global__ void __launch_bounds__(kDThreads) gmm_tc_decode_kernel(TcParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int f0 = blockIdx.x * kDBN;
  const int64_t g = blockIdx.y;
  const bf16* x = p.x + g * p.C * p.d;
  const bf16* w = p.w + g * p.d * p.F;
  bf16* out = p.out + g * p.C * p.F;
  const int n_k = (p.d + kDBK - 1) / kDBK;

  auto load = [&](int kt) {
    bf16* xs = smem + (kt % kDStages) * kDStage;
    load_decode_stage(xs, xs + 16 * kDXLD, x, w, p.C, p.d, p.F, kt * kDBK, f0);
  };
#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < n_k) load(s);
    mma::cp_async_commit();
  }
  float acc[2][4] = {};
  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<kDStages - 2>();
    __syncthreads();
    if (kt + kDStages - 1 < n_k) load(kt + kDStages - 1);
    mma::cp_async_commit();
    const bf16* xs = smem + (kt % kDStages) * kDStage;
    const bf16* ws = xs + 16 * kDXLD;
#pragma unroll
    for (int ks = 0; ks < kDBK / 16; ++ks) {
      uint32_t a[4], b[4];
      mma::ldmatrix_x4(a, xs + (lane % 16) * kDXLD + ks * 16 + (lane / 16) * 8);
      mma::ldmatrix_x4_trans(b, ws + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kDWLD +
                                    warp * 16 + (lane / 16) * 8);
      mma::mma_16816(acc[0], a, b);
      mma::mma_16816(acc[1], a, b + 2);
    }
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) {
    const int col = f0 + warp * 16 + ni * 8 + 2 * t4;
    if (col >= p.F) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = g8 + 8 * i;
      if (row < p.C)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(row) * p.F + col) =
            __floats2bfloat162_rn(acc[ni][2 * i], acc[ni][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma (Hopper's warpgroup MMA) for the prefill tile
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = mma::smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 256, f32, the mma.sync C layout per n8 tile) += A B: A (64 x 16)
// K-major, B (16 x 256) N-major (transposed), both from shared memory.
#define ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(1));
}
#undef ACC8

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warp are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders the accumulator registers around a wait: code that reads them is
// not moved above it, and no copy of them is made while a wgmma is pending.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy writes to shared memory (cp.async included) made visible to
// the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 128 x 256 outputs of one expert a block; 2 warpgroups of 64 rows, each one
// m64n256k16 wgmma per k16 step; BK 64; a 4-stage cp.async ring whose x and w
// tiles are written in the 128-byte swizzled layouts wgmma reads: x rows (K
// contiguous, 128 bytes each) and w rows (N contiguous, four 64-column atoms
// of 8 KB).  Each step's wgmma group stays in flight while the next step
// waits, syncs and issues its loads, so tiles are loaded kWgAhead = 2 steps
// ahead: the ring holds the tile being loaded, the one landing, the one read
// now and the one the pending group still reads.
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64, kWgThreads = 256, kWgStages = 4;
constexpr int kWgAhead = kWgStages - 2;
constexpr int kWgStage = kWgBM * kWgBK + kWgBK * kWgBN;  // elements per stage
constexpr size_t kWgSmem = sizeof(bf16) * kWgStages * kWgStage + 1024;  // + alignment slack
static_assert(kWgBM * (kWgBN + 8) <= kWgStages * kWgStage, "epilogue tile fits in the ring");

__global__ void __launch_bounds__(kWgThreads, 1) gmm_wgmma_kernel(TcParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  bf16* smem =
      reinterpret_cast<bf16*>(smem_raw + ((1024 - (mma::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int f0 = blockIdx.x * kWgBN, c0 = blockIdx.y * kWgBM;
  const int64_t g = blockIdx.z;
  const bf16* x = p.x + g * p.C * p.d;
  const bf16* w = p.w + g * p.d * p.F;
  bf16* out = p.out + g * p.C * p.F;
  const int n_k = (p.d + kWgBK - 1) / kWgBK;

  auto load = [&](int kt) {
    bf16* xs = smem + (kt % kWgStages) * kWgStage;
    bf16* ws = xs + kWgBM * kWgBK;
    const int k0 = kt * kWgBK;
    for (int i = threadIdx.x; i < kWgBM * 8; i += kWgThreads) {
      const int r = i / 8, c = i % 8;
      const int row = c0 + r, k = k0 + c * 8;
      const bool ok = row < p.C && k < p.d;
      mma::cp_async16(xs + r * kWgBK + ((c ^ (r & 7)) * 8),
                      ok ? x + static_cast<int64_t>(row) * p.d + k : x, ok);
    }
    constexpr int WCH = kWgBN / 8;  // 16-byte chunks of a w row
    for (int i = threadIdx.x; i < kWgBK * WCH; i += kWgThreads) {
      const int k = i / WCH, c = i % WCH;
      const int kg = k0 + k, col = f0 + c * 8;
      const bool ok = kg < p.d && col < p.F;
      mma::cp_async16(ws + (c / 8) * (kWgBK * 64) + k * 64 + (((c % 8) ^ (k & 7)) * 8),
                      ok ? w + static_cast<int64_t>(kg) * p.F + col : w, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kWgAhead; ++s) {
    if (s < n_k) load(s);
    mma::cp_async_commit();
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<kWgAhead - 1>();  // tile kt has landed
    fence_proxy_async();
    // all copies of tile kt are visible, and both warpgroups' wgmma of tile
    // kt - 2, whose stage the next load refills, are done: one barrier a step
    __syncthreads();
    if (kt + kWgAhead < n_k) load(kt + kWgAhead);
    mma::cp_async_commit();
    const bf16* xs = smem + (kt % kWgStages) * kWgStage;
    const bf16* ws = xs + kWgBM * kWgBK;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kWgBK / 16; ++j) {
      // A: this warpgroup's 64 rows, k 16j..16j+15 (32 bytes into each
      // swizzled 128-byte row); 8-row groups 1024 bytes apart
      const uint64_t da = sw128_desc(xs + wg * 64 * kWgBK + j * 16, 16, 1024);
      // B: k rows 16j..16j+15 (two 8-row groups 1024 bytes apart), the four
      // 64-column atoms 8 KB apart
      const uint64_t db = sw128_desc(ws + j * 16 * 64, kWgBK * 64 * 2, 1024);
      wgmma_m64n256k16(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's group is done; tile kt's may run on
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mma::cp_async_wait<0>();
  __syncthreads();

  // round once; stage the 128 x 256 bf16 tile; 16-byte stores
  constexpr int OLD = kWgBN + 8;
  bf16* os = smem;
#pragma unroll
  for (int ni = 0; ni < kWgBN / 8; ++ni) {
    const int r = wg * 64 + warp * 16 + g8, c = ni * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(os + r * OLD + c) = mma::pack_bf16(acc[4 * ni], acc[4 * ni + 1]);
    *reinterpret_cast<uint32_t*>(os + (r + 8) * OLD + c) =
        mma::pack_bf16(acc[4 * ni + 2], acc[4 * ni + 3]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWgBM * (kWgBN / 8); i += kWgThreads) {
    const int r = i / (kWgBN / 8), c = (i % (kWgBN / 8)) * 8;
    const int row = c0 + r, col = f0 + c;
    if (row < p.C && col < p.F)
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * p.F + col) =
          *reinterpret_cast<const uint4*>(os + r * OLD + c);
  }
}

cudaError_t launch_wgmma_prefill(const TcParams& p, int G, cudaStream_t stream) {
  const int64_t c_tiles = (static_cast<int64_t>(p.C) + kWgBM - 1) / kWgBM;
  if (c_tiles > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = launch::opt_in_smem<&gmm_wgmma_kernel>(kWgSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.F + kWgBN - 1) / kWgBN, static_cast<unsigned>(c_tiles), G);
  gmm_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(p);
  return cudaGetLastError();
}

// variant 1: wgmma prefill tile, 2: decode tile
cudaError_t launch_tc(const TcParams& p, int G, int variant, cudaStream_t stream) {
  if (p.d % 8 != 0 || p.F % 8 != 0) return cudaErrorInvalidValue;
  if (G > 65535) return cudaErrorInvalidConfiguration;
  if (variant == 2) {
    if (p.C > 16) return cudaErrorInvalidValue;
    cudaError_t err = launch::opt_in_smem<&gmm_tc_decode_kernel>(kDSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.F + kDBN - 1) / kDBN, G);
    gmm_tc_decode_kernel<<<grid, kDThreads, kDSmem, stream>>>(p);
    return cudaGetLastError();
  }
  return launch_wgmma_prefill(p, G, stream);
}

bool aligned4(const void* ptr, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % (4 * elem_bytes) == 0;
}

}  // namespace

// x: (G, C, d); w: (G, d, F); out: (G, C, F); all contiguous and of one dtype
// (0: f32, 1: bf16).  `variant` 0 runs the FMA kernel (any shape); 1 and 2
// the bf16 tensor-core tiles (wgmma prefill, decode for C <= 16), which need
// d and F multiples of 8 and 16-byte aligned bases (the caller checks the
// bases).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an empty shape, an unknown dtype or a variant
// the inputs do not fit.
extern "C" int repro_gmm(const void* x, const void* w, void* out, int dtype, int G, int C,
                         int d, int F, int variant, void* stream) {
  if (G < 1 || C < 1 || d < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1 || variant == 2) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    const TcParams p{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                     static_cast<bf16*>(out), C, d, F};
    return static_cast<int>(launch_tc(p, G, variant, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  Params p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.G = G;
  p.C = C;
  p.d = d;
  p.F = F;
  // every row of x (w) starts 4-aligned when the base is and d (F) % 4 == 0
  p.vec_x = d % 4 == 0 && aligned4(x, elem);
  p.vec_w = F % 4 == 0 && aligned4(w, elem);
  return static_cast<int>(dtype == 0 ? dispatch<float>(p, s) : dispatch<__nv_bfloat16>(p, s));
}
