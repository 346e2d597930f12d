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
//   C, columns past F and the contraction tail past d are masked.  The same
//   kernel, given other strides, runs the backward's FMA products.
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
// The backward (`repro_gmm_bwd`, no TPU kernel: JAX differentiates the
// expert einsums of models/moe.py) is two more grouped products, dx = dy w^T
// (contracting over F) and dw = x^T dy (contracting over C), each read in
// its stored layout, with no transposed copy: bf16 inputs the forward's
// tensor-core tiles take run the same wgmma tile with dx's B (w) read
// K-major and dw's A (x) read M-major through wgmma's transpose bits; the
// rest runs the FMA kernel with the operands' strides.  A block owns an output
// tile and sums the whole contraction itself, in order (no split over C),
// so a repeat launch gives the same bits.  At Granite's training products
// (capacity 2560) each is 85.9 GFLOP against ~285 MB, bound by operations
// at ~0.087 ms; PERF.md has the times.
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

// The FMA kernel: one grouped product out[g] (M x N, row-major) = A[g] (M x
// K) B[g] (K x N) with A(m, k) at a[m * sam + k * sak] and B(k, n) at
// b[k * sbk + n * sbn], so the forward (A = x, B = w), dx = dy w^T and dw =
// x^T dy read x, w and dy as they are stored; which dimension of each is
// unit-stride is a template argument, so a layout's index arithmetic is the
// forward kernel's.  BM x 64 output tiles (BM 64, or 16 when M <= 16), BK
// 16, a TM x 4 block of f32 accumulators a thread; consecutive threads along
// each operand's unit-stride dimension, 4 elements an item, one load where
// `vec_a` / `vec_b` allow it; rows past M, columns past N and the
// contraction tail past K masked; the whole contraction in one block, in
// order (no split over K).
struct GenParams {
  const void* a;
  const void* b;
  void* out;
  int M, N, K;
  int64_t sam, sak, sbk, sbn;  // element strides of A(m, k) and B(k, n)
  int64_t ga, gb, go;          // group strides
  int vec_a, vec_b;            // 4 elements a load along the unit-stride dimension
};

// A(m, k) at a[m * sam + k] when kAUnitK, else at a[m + k * sak]; B(k, n) at
// b[k * sbk + n] when kBUnitN, else at b[k + n * sbn].
template <typename T, bool kAUnitK>
__device__ __forceinline__ const T* a_at(const T* a, const GenParams& p, int m, int k) {
  if constexpr (kAUnitK) return a + m * p.sam + k;
  else return a + m + k * p.sak;
}
template <typename T, bool kBUnitN>
__device__ __forceinline__ const T* b_at(const T* b, const GenParams& p, int k, int n) {
  if constexpr (kBUnitN) return b + k * p.sbk + n;
  else return b + k + n * p.sbn;
}

template <typename T, int BM, int TM, bool kAUnitK, bool kBUnitN>
__global__ void __launch_bounds__(kThreads, 4) gmm_fma_kernel(GenParams p) {
  static_assert((BM / TM) * (kBN / kTN) == kThreads, "one thread per TM x 4 outputs");
  // A's tile stored [k][m], so one thread's TM rows of one k are consecutive;
  // +4 keeps rows 16-byte aligned and staggers the banks.
  __shared__ __align__(16) float as[kBK][BM + 4];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int64_t g = blockIdx.z;
  const T* a = static_cast<const T*>(p.a) + g * p.ga;
  const T* b = static_cast<const T*>(p.b) + g * p.gb;
  T* out = static_cast<T*>(p.out) + g * p.go;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    // A's tile: 4 consecutive elements along its unit-stride dimension per
    // item, one load where `vec_a` allows (that extent is then a multiple of
    // 4, so the 4 are all in range or all out), else four
    for (int it = tid; it < BM * kBK / 4; it += kThreads) {
      const int m = kAUnitK ? it / (kBK / 4) : (it % (BM / 4)) * 4;
      const int k = kAUnitK ? (it % (kBK / 4)) * 4 : it / (BM / 4);
      const int row = m0 + m, kg = k0 + k;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const T* src = a_at<T, kAUnitK>(a, p, row, kg);
      if (p.vec_a) {
        if (row < p.M && kg < p.K) {
          const float4 q = load4(src);
          v[0] = q.x;
          v[1] = q.y;
          v[2] = q.z;
          v[3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kAUnitK ? row < p.M && kg + e < p.K : row + e < p.M && kg < p.K) v[e] = to_f32(src[e]);
      }
      if constexpr (kAUnitK) {
#pragma unroll
        for (int e = 0; e < 4; ++e) as[k + e][m] = v[e];
      } else {
        *reinterpret_cast<float4*>(&as[k][m]) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    // B's tile, the same way
    for (int it = tid; it < kBK * kBN / 4; it += kThreads) {
      const int n = kBUnitN ? (it % (kBN / 4)) * 4 : it / (kBK / 4);
      const int k = kBUnitN ? it / (kBN / 4) : (it % (kBK / 4)) * 4;
      const int col = n0 + n, kg = k0 + k;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const T* src = b_at<T, kBUnitN>(b, p, kg, col);
      if (p.vec_b) {
        if (col < p.N && kg < p.K) {
          const float4 q = load4(src);
          v[0] = q.x;
          v[1] = q.y;
          v[2] = q.z;
          v[3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kBUnitN ? col + e < p.N && kg < p.K : col < p.N && kg + e < p.K) v[e] = to_f32(src[e]);
      }
      if constexpr (kBUnitN) {
        *reinterpret_cast<float4*>(&bs[k][n]) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) bs[k + e][n] = v[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float aa[TM];
      if constexpr (TM == 4) {
        const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
        aa[0] = av.x;
        aa[1] = av.y;
        aa[2] = av.z;
        aa[3] = av.w;
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) aa[i] = as[kk][ty * TM + i];
      }
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
      const float bb[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(aa[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < p.N) store(out + static_cast<int64_t>(row) * p.N + col, acc[i][j]);
    }
  }
}

template <typename T, int BM, int TM, bool kAUnitK, bool kBUnitN>
cudaError_t launch_fma_tile(const GenParams& p, int G, cudaStream_t stream) {
  const int64_t m_tiles = (static_cast<int64_t>(p.M) + BM - 1) / BM;
  if (m_tiles > 65535 || G > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((p.N + kBN - 1) / kBN, static_cast<unsigned>(m_tiles), G);
  gmm_fma_kernel<T, BM, TM, kAUnitK, kBUnitN><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kAUnitK, bool kBUnitN>
cudaError_t launch_fma_layout(const GenParams& p, int G, cudaStream_t stream) {
  return p.M <= 16 ? launch_fma_tile<T, 16, 1, kAUnitK, kBUnitN>(p, G, stream)
                   : launch_fma_tile<T, 64, 4, kAUnitK, kBUnitN>(p, G, stream);
}

// An operand is read 4 elements at a time along its unit-stride dimension
// when that extent, its other stride and its group stride are multiples of 4
// and its base is aligned to 4 elements: every load is then aligned and all
// in or all out of range.
bool vec4(const void* base, int elem_bytes, int extent, int64_t other, int64_t group) {
  return extent % 4 == 0 && other % 4 == 0 && group % 4 == 0 &&
         reinterpret_cast<uintptr_t>(base) % (4 * elem_bytes) == 0;
}

// The three layouts of gmm's products: the forward (x, w), dx (dy, w read
// K-major) and dw (x read M-major, dy).
template <typename T>
cudaError_t launch_fma(GenParams p, int G, cudaStream_t stream) {
  constexpr int e = sizeof(T);
  const bool ak = p.sak == 1, bn = p.sbn == 1;
  p.vec_a = ak ? vec4(p.a, e, p.K, p.sam, p.ga) : vec4(p.a, e, p.M, p.sak, p.ga);
  p.vec_b = bn ? vec4(p.b, e, p.N, p.sbk, p.gb) : vec4(p.b, e, p.K, p.sbn, p.gb);
  if (ak && bn) return launch_fma_layout<T, true, true>(p, G, stream);
  if (ak && p.sbk == 1) return launch_fma_layout<T, true, false>(p, G, stream);
  if (bn && p.sam == 1) return launch_fma_layout<T, false, true>(p, G, stream);
  return cudaErrorInvalidValue;
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
// wgmma (Hopper's warpgroup MMA; the helpers are in mma_bf16.cuh) for the
// prefill tile
// ---------------------------------------------------------------------------

// 128 x 256 outputs of one expert a block; 2 warpgroups of 64 rows, each one
// m64n256k16 wgmma per k16 step; BK 64; a 4-stage cp.async ring whose A and B
// tiles are written in the 128-byte swizzled layouts wgmma reads.  A K-major
// operand (the forward's x, dx's dy, dx's w as B) is stored as rows of its M
// or N dimension, 128 bytes of K each; an MN-major one (the forward's w,
// dw's x as A and dy as B) as 64-column atoms of 64 contraction rows, 8 KB
// apart.  Each step's wgmma group stays in flight while the next step
// waits, syncs and issues its loads, so tiles are loaded kWgAhead = 2 steps
// ahead: the ring holds the tile being loaded, the one landing, the one read
// now and the one the pending group still reads.
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64, kWgThreads = 256, kWgStages = 4;
constexpr int kWgAhead = kWgStages - 2;
constexpr int kWgStage = kWgBM * kWgBK + kWgBK * kWgBN;  // elements per stage
constexpr size_t kWgSmem = sizeof(bf16) * kWgStages * kWgStage + 1024;  // + alignment slack
static_assert(kWgBM * (kWgBN + 8) <= kWgStages * kWgStage, "epilogue tile fits in the ring");

// One grouped product out[g] (M x N, row-major) = A[g] (M x K) B[g] (K x N).
// A(m, k) is a[m * lda + k] (K-major) or, kAMn, a[k * lda + m]; B(k, n) is
// b[k * ldb + n] (kBMn, N-major) or b[n * ldb + k].  Group g starts ga, gb
// and go elements into a, b and out.  The forward is <false, true> (x, w),
// dx = dy w^T is <false, false> and dw = x^T dy is <true, true>.
struct WgParams {
  const bf16* a;
  const bf16* b;
  bf16* out;
  int M, N, K, lda, ldb;
  int64_t ga, gb, go;
};

template <bool kAMn, bool kBMn>
__global__ void __launch_bounds__(kWgThreads, 1) gmm_wgmma_kernel(WgParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  bf16* smem =
      reinterpret_cast<bf16*>(smem_raw + ((1024 - (mma::smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kWgBN, m0 = blockIdx.y * kWgBM;
  const int64_t g = blockIdx.z;
  const bf16* a = p.a + g * p.ga;
  const bf16* b = p.b + g * p.gb;
  bf16* out = p.out + g * p.go;
  const int n_k = (p.K + kWgBK - 1) / kWgBK;

  // rows [r0, r0 + R) of a K-major operand (M or N rows, K contiguous) at
  // contraction step k0: 128-byte rows, chunk c of row r at chunk c ^ (r % 8)
  auto load_kmajor = [&](bf16* dst, const bf16* src, int ld, int r0, int rows, int R, int k0) {
    for (int i = threadIdx.x; i < R * 8; i += kWgThreads) {
      const int r = i / 8, c = i % 8;
      const int row = r0 + r, k = k0 + c * 8;
      const bool ok = row < rows && k < p.K;
      mma::cp_async16(dst + r * kWgBK + ((c ^ (r & 7)) * 8),
                      ok ? src + static_cast<int64_t>(row) * ld + k : src, ok);
    }
  };
  // columns [c0, c0 + C) of an MN-major operand (contraction rows, M or N
  // contiguous) at contraction step k0: 64-column atoms of kWgBK rows
  auto load_mnmajor = [&](bf16* dst, const bf16* src, int ld, int c0, int cols, int C, int k0) {
    const int chunks = C / 8;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < kWgBK * chunks; i += kWgThreads) {
      const int k = i / chunks, c = i % chunks;
      const int kg = k0 + k, col = c0 + c * 8;
      const bool ok = kg < p.K && col < cols;
      mma::cp_async16(dst + (c / 8) * (kWgBK * 64) + k * 64 + (((c % 8) ^ (k & 7)) * 8),
                      ok ? src + static_cast<int64_t>(kg) * ld + col : src, ok);
    }
  };
  auto load = [&](int kt) {
    bf16* as = smem + (kt % kWgStages) * kWgStage;
    bf16* bs = as + kWgBM * kWgBK;
    const int k0 = kt * kWgBK;
    if constexpr (kAMn)
      load_mnmajor(as, a, p.lda, m0, p.M, kWgBM, k0);
    else
      load_kmajor(as, a, p.lda, m0, p.M, kWgBM, k0);
    if constexpr (kBMn)
      load_mnmajor(bs, b, p.ldb, n0, p.N, kWgBN, k0);
    else
      load_kmajor(bs, b, p.ldb, n0, p.N, kWgBN, k0);
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
    mma::fence_proxy_async();
    // all copies of tile kt are visible, and both warpgroups' wgmma of tile
    // kt - 2, whose stage the next load refills, are done: one barrier a step
    __syncthreads();
    if (kt + kWgAhead < n_k) load(kt + kWgAhead);
    mma::cp_async_commit();
    const bf16* as = smem + (kt % kWgStages) * kWgStage;
    const bf16* bs = as + kWgBM * kWgBK;
    mma::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kWgBK / 16; ++j) {
      // A: this warpgroup's 64 rows, k 16j..16j+15.  K-major: 32 bytes into
      // each swizzled 128-byte row, 8-row groups 1024 bytes apart; M-major:
      // the warpgroup's atom, contraction rows 16j.. (two 8-row groups 1024
      // bytes apart)
      const uint64_t da = kAMn ? mma::sw128_desc(as + wg * (kWgBK * 64) + j * 16 * 64,
                                                 kWgBK * 64 * 2, 1024)
                               : mma::sw128_desc(as + wg * 64 * kWgBK + j * 16, 16, 1024);
      // B: N-major, k rows 16j..16j+15, the four 64-column atoms 8 KB apart;
      // K-major, 32 bytes into each of the 256 rows
      const uint64_t db = kBMn ? mma::sw128_desc(bs + j * 16 * 64, kWgBK * 64 * 2, 1024)
                               : mma::sw128_desc(bs + j * 16, 16, 1024);
      mma::wgmma_ss<256, kBMn ? 1 : 0, kAMn ? 1 : 0>(acc, da, db, 1);
    }
    mma::wgmma_commit();
    mma::wgmma_wait<1>();  // tile kt - 1's group is done; tile kt's may run on
    mma::fence_acc(acc);
  }
  mma::wgmma_wait<0>();
  mma::fence_acc(acc);
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
    const int row = m0 + r, col = n0 + c;
    if (row < p.M && col < p.N)
      *reinterpret_cast<uint4*>(out + static_cast<int64_t>(row) * p.N + col) =
          *reinterpret_cast<const uint4*>(os + r * OLD + c);
  }
}

template <bool kAMn, bool kBMn>
cudaError_t launch_wgmma(const WgParams& p, int G, cudaStream_t stream) {
  const int64_t m_tiles = (static_cast<int64_t>(p.M) + kWgBM - 1) / kWgBM;
  if (m_tiles > 65535 || G > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = launch::opt_in_smem<&gmm_wgmma_kernel<kAMn, kBMn>>(kWgSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kWgBN - 1) / kWgBN, static_cast<unsigned>(m_tiles), G);
  gmm_wgmma_kernel<kAMn, kBMn><<<grid, kWgThreads, kWgSmem, stream>>>(p);
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
  // x read K-major, w N-major
  const WgParams q{p.x, p.w, p.out, p.C, p.F, p.d, p.d, p.F,
                   static_cast<int64_t>(p.C) * p.d, static_cast<int64_t>(p.d) * p.F,
                   static_cast<int64_t>(p.C) * p.F};
  return launch_wgmma<false, true>(q, G, stream);
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
  const int64_t cd = static_cast<int64_t>(C) * d, df = static_cast<int64_t>(d) * F,
                cf = static_cast<int64_t>(C) * F;
  const GenParams p{x, w, out, C, F, d, d, 1, F, 1, cd, df, cf};
  return static_cast<int>(dtype == 0 ? launch_fma<float>(p, G, s)
                                     : launch_fma<__nv_bfloat16>(p, G, s));
}

// The backward of out = gmm(x, w) for the output gradient dy (G, C, F):
// `which` 0 writes dx = dy w^T (G, C, d), 1 writes dw = x^T dy (G, d, F),
// each summed in f32 over the whole contraction (F for dx, C for dw) by one
// block, in order, and rounded once.  x, w, dy and out are contiguous and
// of one dtype (0: f32, 1: bf16).  `variant` 0 runs the FMA kernel (any
// shape); 1 the wgmma tile, which needs bf16, d and F multiples of 8 and
// 16-byte aligned bases (the caller checks the bases).  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an empty shape, an unknown dtype, product or
// variant, or a variant the inputs do not fit.
extern "C" int repro_gmm_bwd(const void* x, const void* w, const void* dy, void* out,
                             int dtype, int G, int C, int d, int F, int which, int variant,
                             void* stream) {
  if (G < 1 || C < 1 || d < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || (which != 0 && which != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cd = static_cast<int64_t>(C) * d, df = static_cast<int64_t>(d) * F,
                cf = static_cast<int64_t>(C) * F;
  if (variant == 1) {
    if (dtype != 1 || d % 8 != 0 || F % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    const bf16* dyb = static_cast<const bf16*>(dy);
    bf16* ob = static_cast<bf16*>(out);
    if (which == 0)   // A = dy (K-major), B = w read K-major: B(f, j) = w[j, f]
      return static_cast<int>(
          launch_wgmma<false, false>(WgParams{dyb, wb, ob, C, d, F, F, F, cf, df, cd}, G, s));
    // A = x read M-major: A(j, c) = x[c, j]; B = dy (N-major)
    return static_cast<int>(
        launch_wgmma<true, true>(WgParams{xb, dyb, ob, d, F, C, d, F, cd, cf, df}, G, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const GenParams p = which == 0 ? GenParams{dy, w, out, C, d, F, F, 1, 1, F, cf, df, cd}
                                 : GenParams{x, dy, out, d, F, C, 1, d, F, 1, cd, cf, df};
  return static_cast<int>(dtype == 0 ? launch_fma<float>(p, G, s)
                                     : launch_fma<__nv_bfloat16>(p, G, s));
}
