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
// * Tensor-core prefill tile, wgmma (bf16, C > 16): `gmm_ws_kernel`, the
//   persistent, warp-specialised tile described at its definition below.
//   128 x 256 outputs of one expert a tile, two consumer warpgroups of 64
//   rows each issuing one m64n256k16 wgmma (bf16 in, f32 out) a k16 step
//   with both operands read from shared memory, BK 64; a producer warp
//   feeds a 3-stage ring by TMA (x K-major, w N-major through the
//   instruction's transpose flag, the 128-byte swizzled layouts wgmma
//   reads, zero fill past C, d and F); one block an SM walks the tiles, and
//   the epilogue (rounded once, stored by TMA) overlaps the next tile's
//   loads.  It replaced a tile with the same shape and layouts fed
//   by a 4-stage cp.async ring from all 256 threads, one barrier a step and
//   a non-persistent grid: on an NVIDIA H100 80GB HBM3 at 700.00 W the
//   persistent tile took 0.042-0.045 ms against its 0.067-0.071 at
//   Granite's serving prefill products and 0.132-0.140 against 0.234-0.257
//   at its training products (PERF.md section 6).  Tried on that card and
//   slower than the ring tile: the tile on mma.sync m16n8k16, and 128 x 128
//   wgmma tiles with 3 or 4 stages, 1 or 2 blocks an SM.
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
// tensor-core tiles take run the same persistent tile with dx's B (w) read
// K-major and dw's A (x) read M-major through wgmma's transpose bits, each
// operand's tensor map over its stored layout; the rest runs the FMA kernel
// with the operands' strides.  A block owns an output tile and sums the
// whole contraction itself, in order (no split over C), so a repeat launch
// gives the same bits.  At Granite's training products (capacity 2560)
// each is 85.9 GFLOP against ~285 MB, bound by operations at ~0.087 ms;
// PERF.md has the times.
//
// Bound on the H100 (SXM, 700 W data sheet: 3.35 TB/s HBM, 989 TFLOP/s dense
// bf16, 67 TFLOP/s f32 without tensor cores).  Work is 2*G*C*d*F FLOPs;
// bytes are x and w read once and out written once.  Granite-3.0-1B-A400M's
// prefill (4 x 512 tokens, top-8 of 32 experts, capacity 640): x (32, 640,
// 1024) @ w (32, 1024, 512) in bf16 moves 96.5 MB for 21.5 GFLOP (223 FLOP
// per byte, below the ~295 ridge), bound by bytes at ~28.8 us.  A decode step
// (C = 4) streams the 33.6 MB of weights: ~10 us.
//
// What is still left on the table: the tensor-core tiles run 1.0-1.15x
// torch.bmm (PERF.md section 6): one m64n256 group in flight a warpgroup,
// the epilogue not hidden behind the other warpgroup's products (ping-pong
// on 64 x 256 tiles was slower; 128 x 128 ping-pong tiles are untried),
// three stages (the 64 KB epilogue buffer takes the fourth), no clusters
// sharing an operand's tile by TMA multicast; the capacity buffer
// is dense, so padded slots of lightly loaded experts are computed too (no
// ragged schedule over the experts' real counts); the decode tile computes
// 16 rows for C of them (the tensor cores are idle there anyway: the tile
// is bound by w's bytes).
#include <cuda.h>
#include <cudaTypedefs.h>
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

// BK 64; an operand's tiles in the 128-byte swizzled layouts wgmma reads: a
// K-major operand (the forward's x, dx's dy, dx's w as B) as rows of its M
// or N dimension, 128 bytes of K each; an MN-major one (the forward's w,
// dw's x as A and dy as B) as 64-column atoms of 64 contraction rows, 8 KB
// apart.
constexpr int kWgBN = 256, kWgBK = 64;

// ---------------------------------------------------------------------------
// wgmma (Hopper's warpgroup MMA; the helpers are in mma_bf16.cuh): the
// persistent, warp-specialised tile of the forward's prefill products and of
// the backward's `tc` products
// ---------------------------------------------------------------------------

// The tile is built as Hopper's fast GEMMs are: one block an SM walks
// the output tiles (expert-major: an expert's tiles one after another, so
// the operands the SMs share stay in L2); a producer warpgroup whose one
// thread issues TMA copies (3-d tensor maps over the stored layouts, the
// expert a coordinate, 128-byte swizzle, zero fill past M, N and K) into a
// ring of full/empty mbarriers, across tile boundaries; two consumer
// warpgroups, each issuing one m64n256k16 wgmma a k16 step, one group left
// in flight while the next stage is awaited, a stage handed back as soon as
// its group is done.  setmaxnreg gives the producer 40 registers and each
// consumer 232.  The two consumers share the tensor cores in one of two
// ways (`kPing`):
//
// * cooperative (false, the tree's): 128 x 256 outputs a tile, 64 rows a
//   warpgroup, three stages of 48 KB; both warpgroups take every stage.
// * ping-pong (true): 64 x 256 outputs a tile, the block's tiles taken by
//   the two warpgroups in turn, four stages of 40 KB, each used by one
//   warpgroup; named barriers order their main loops, so one warpgroup's
//   epilogue runs while the other's products run.  Only the tuning
//   harness runs it (`python -m repro_torch.kernels.tune gmm`): on an
//   NVIDIA H100 80GB HBM3 at 700.00 W it took 1.10-1.29x the cooperative
//   tile's time at Granite's training products and 0.94-1.04x at its
//   serving prefill, since half the rows a tile move 1.67x the bytes into
//   shared memory per FLOP (PERF.md section 6).
//
// The epilogue rounds once, writes a warpgroup's 64 x 256 outputs to its
// own 32 KB of shared memory in the swizzled layout (no bank conflict) and
// stores them by TMA (the parts past M and N are not written); the store
// runs while the warpgroup takes its next tile's stages, and is awaited
// only before that buffer is written again.  One warpgroup sums a row's
// whole contraction in order with the same wgmma steps in both layouts (no
// split over K, no atomics): a repeat launch, and the other layout, give
// the same bits.
constexpr int kPsThreads = 384;

template <bool kPing>
struct WsTile {
  static constexpr int BM = kPing ? 64 : 128;          // rows of a tile
  static constexpr int kStages = kPing ? 4 : 3;
  static constexpr int kStage = BM * kWgBK + kWgBK * kWgBN;   // elements of a stage
  static constexpr uint32_t kStageBytes = sizeof(bf16) * kStage;
  static constexpr size_t kSmem = 1024 + size_t{kStageBytes} * kStages +
                                  sizeof(bf16) * 2 * 64 * kWgBN;
};

struct PsMaps {
  CUtensorMap a, b, out;
};

struct PsShape {
  int M, N, K, G;
};

template <bool kAMn, bool kBMn, bool kPing>
__global__ void __launch_bounds__(kPsThreads, 1)
    gmm_ws_kernel(const __grid_constant__ PsMaps maps, PsShape p) {
  using Tile = WsTile<kPing>;
  constexpr int BM = Tile::BM, kStages = Tile::kStages, kStage = Tile::kStage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem =
      reinterpret_cast<bf16*>(smem_raw + ((1024 - (mma::smem_addr(smem_raw) & 1023)) & 1023));
  bf16* outs = smem + kStages * kStage;
  __shared__ alignas(8) uint64_t full[kStages], empty[kStages];
  const int wg = threadIdx.x / 128;
  const int m_tiles = (p.M + BM - 1) / BM, n_tiles = (p.N + kWgBN - 1) / kWgBN;
  const int tiles = p.G * m_tiles * n_tiles, n_k = (p.K + kWgBK - 1) / kWgBK;
  auto tile_at = [&](int tile, int& g, int& m0, int& n0) {
    g = tile / (m_tiles * n_tiles);
    const int r = tile % (m_tiles * n_tiles);
    m0 = (r / n_tiles) * BM;
    n0 = (r % n_tiles) * kWgBN;
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mma::mbar_init(&full[s], 1);
      mma::mbar_init(&empty[s], (kPing ? 1 : 2) * 128);   // every consumer thread of a stage
    }
    mma::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    mma::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int g, m0, n0;
        tile_at(tile, g, m0, n0);
        for (int kt = 0; kt < n_k; ++kt) {
          mma::mbar_wait(&empty[stage], phase ^ 1);   // a fresh ring passes at once
          bf16* as = smem + stage * kStage;
          bf16* bs = as + BM * kWgBK;
          const int k0 = kt * kWgBK;
          mma::mbar_expect_tx(&full[stage], Tile::kStageBytes);
          if constexpr (kAMn) {   // 64-column atoms of 64 contraction rows
#pragma unroll
            for (int a = 0; a < BM / 64; ++a)
              mma::tma_load_3d(as + a * kWgBK * 64, &maps.a, m0 + 64 * a, k0, g, &full[stage]);
          } else {                // BM rows of 128 bytes
            mma::tma_load_3d(as, &maps.a, k0, m0, g, &full[stage]);
          }
          if constexpr (kBMn) {   // four 64-column atoms
#pragma unroll
            for (int a = 0; a < kWgBN / 64; ++a)
              mma::tma_load_3d(bs + a * kWgBK * 64, &maps.b, n0 + 64 * a, k0, g, &full[stage]);
          } else {                // 256 rows of 128 bytes
            mma::tma_load_3d(bs, &maps.b, k0, n0, g, &full[stage]);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {         // consumers
    mma::setmaxnreg_inc<232>();
    const int cw = wg - 1, ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32, g8 = lane / 4, t4 = lane % 4;
    // cooperative: warpgroup cw owns rows [64 cw, 64 cw + 64) of every tile;
    // ping-pong: the block's tiles cw, cw + 2, ... (its rows start at 0)
    const int row0 = kPing ? 0 : 64 * cw;
    bf16* my_out = outs + cw * 64 * kWgBN;   // four atoms of 64 rows x 64 columns
    const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;   // the block's tiles
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    bool stored = false;
    for (int j = kPing ? cw : 0; j < mine; j += kPing ? 2 : 1) {
      int g, m0, n0;
      tile_at(blockIdx.x + j * gridDim.x, g, m0, n0);
      // the ring position of the tile's first stage: every earlier tile of
      // the block took n_k stages (in ping-pong, some of them the other
      // warpgroup's, whose main loop has finished issuing before this one
      // starts, so no full barrier is waited on a phase early)
      const int pos = j * n_k;
      int stage = pos % kStages;
      uint32_t phase = (pos / kStages) & 1;
      if (kPing && j > 0) mma::named_sync(3 + cw, 256);   // the other's main loop is issued
      int prev = 0;
      for (int kt = 0; kt < n_k; ++kt) {
        mma::mbar_wait(&full[stage], phase);
        const bf16* as = smem + stage * kStage;
        const bf16* bs = as + BM * kWgBK;
        mma::wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < kWgBK / 16; ++k16) {
          const uint64_t da =
              kAMn ? mma::sw128_desc(as + (row0 / 64) * (kWgBK * 64) + k16 * 16 * 64,
                                     kWgBK * 64 * 2, 1024)
                   : mma::sw128_desc(as + row0 * kWgBK + k16 * 16, 16, 1024);
          const uint64_t db = kBMn ? mma::sw128_desc(bs + k16 * 16 * 64, kWgBK * 64 * 2, 1024)
                                   : mma::sw128_desc(bs + k16 * 16, 16, 1024);
          mma::wgmma_ss<256, kBMn ? 1 : 0, kAMn ? 1 : 0>(acc, da, db, kt > 0 || k16 > 0);
        }
        mma::wgmma_commit();
        mma::wgmma_wait<1>();   // step kt - 1's group is done: hand its stage back
        mma::fence_acc(acc);
        if (kt > 0) mma::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (kPing && j + 1 < mine) mma::named_arrive(3 + (1 - cw), 256);   // the other's turn
      mma::wgmma_wait<0>();
      mma::fence_acc(acc);
      mma::mbar_arrive(&empty[prev]);

      // epilogue: the previous tile's store has read the buffer; round once
      // into the 128-byte swizzled layout; one thread stores by TMA
      if (ct == 0 && stored) mma::bulk_wait_read<0>();
      mma::named_sync(1 + cw, 128);
      const int r = warp * 16 + g8;
#pragma unroll
      for (int ni = 0; ni < kWgBN / 8; ++ni) {
        bf16* atom = my_out + (ni / 8) * 64 * 64;
        const int c = ((ni % 8) ^ g8) * 8 + 2 * t4;   // r % 8 == (r + 8) % 8 == g8
        *reinterpret_cast<uint32_t*>(atom + r * 64 + c) = mma::pack_bf16(acc[4 * ni], acc[4 * ni + 1]);
        *reinterpret_cast<uint32_t*>(atom + (r + 8) * 64 + c) =
            mma::pack_bf16(acc[4 * ni + 2], acc[4 * ni + 3]);
      }
      mma::fence_proxy_async();
      mma::named_sync(1 + cw, 128);
      if (ct == 0) {
#pragma unroll
        for (int a = 0; a < kWgBN / 64; ++a)
          mma::tma_store_3d(&maps.out, my_out + a * 64 * 64, n0 + 64 * a, m0 + row0, g);
        mma::bulk_commit();
      }
      stored = true;
    }
    if (ct == 0) mma::bulk_wait<0>();
  }
}

// Tensor maps of a bf16 operand of G groups stored row-major as (rows,
// cols), read in boxes of `box_cols` x `box_rows`, 128-byte swizzled.
cudaError_t operand_map(CUtensorMap* map, const bf16* base, int G, int rows, int cols,
                        int box_cols, int box_rows, CUtensorMapL2promotion promotion) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  return launch::bf16_tensor_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                                 promotion);
}

// out[g] (M x N) = A[g] (M x K) B[g] (K x N) on the persistent tile, every
// operand contiguous and row-major: A stored (M, K), or (K, M) when kAMn;
// B stored (N, K), or (K, N) when kBMn; out (M, N).  K-major and N-major
// strides are multiples of 16 bytes (the caller checks K, M, N as it reads
// them); bases 16-byte aligned.  The tree runs the cooperative layout.
template <bool kAMn, bool kBMn, bool kPing = false>
cudaError_t launch_ws(const bf16* a, const bf16* b, bf16* out, int M, int N, int K, int G,
                      cudaStream_t stream) {
  using Tile = WsTile<kPing>;
  PsMaps maps;
  constexpr auto L2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  cudaError_t err = kAMn ? operand_map(&maps.a, a, G, K, M, 64, kWgBK, L2)
                         : operand_map(&maps.a, a, G, M, K, kWgBK, Tile::BM, L2);
  if (err == cudaSuccess)
    err = kBMn ? operand_map(&maps.b, b, G, K, N, 64, kWgBK, L2)
               : operand_map(&maps.b, b, G, N, K, kWgBK, kWgBN, L2);
  if (err == cudaSuccess)
    err = operand_map(&maps.out, out, G, M, N, 64, 64, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = launch::sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = launch::opt_in_smem<&gmm_ws_kernel<kAMn, kBMn, kPing>>(Tile::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>(G) * ((M + Tile::BM - 1) / Tile::BM) *
                        ((N + kWgBN - 1) / kWgBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gmm_ws_kernel<kAMn, kBMn, kPing>
      <<<grid, kPsThreads, Tile::kSmem, stream>>>(maps, PsShape{M, N, K, G});
  return cudaGetLastError();
}

// variant 1: the persistent wgmma tile (prefill), 2: the decode tile
cudaError_t launch_tc(const TcParams& p, int G, int variant, cudaStream_t stream) {
  if (p.d % 8 != 0 || p.F % 8 != 0) return cudaErrorInvalidValue;
  if (variant == 2) {
    if (p.C > 16) return cudaErrorInvalidValue;
    if (G > 65535) return cudaErrorInvalidConfiguration;
    cudaError_t err = launch::opt_in_smem<&gmm_tc_decode_kernel>(kDSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.F + kDBN - 1) / kDBN, G);
    gmm_tc_decode_kernel<<<grid, kDThreads, kDSmem, stream>>>(p);
    return cudaGetLastError();
  }
  // x read K-major, w N-major
  return launch_ws<false, true>(p.x, p.w, p.out, p.C, p.F, p.d, G, stream);
}

}  // namespace

// x: (G, C, d); w: (G, d, F); out: (G, C, F); all contiguous and of one dtype
// (0: f32, 1: bf16).  `variant` 0 runs the FMA kernel (any shape); 1 and 2
// the bf16 tensor-core tiles (the persistent wgmma tile, and the decode tile
// for C <= 16), which need d and F multiples of 8 and 16-byte aligned bases
// (the caller checks the bases).
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
// shape); 1 the persistent wgmma tile, which needs bf16, d and F multiples
// of 8 and 16-byte aligned bases (the caller checks the bases).  Launches on
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
      return static_cast<int>(launch_ws<false, false>(dyb, wb, ob, C, d, F, G, s));
    // A = x read M-major: A(j, c) = x[c, j]; B = dy (N-major)
    return static_cast<int>(launch_ws<true, true>(xb, dyb, ob, d, F, C, G, s));
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const GenParams p = which == 0 ? GenParams{dy, w, out, C, d, F, F, 1, 1, F, cf, df, cd}
                                 : GenParams{x, dy, out, d, F, C, 1, d, F, 1, cd, cf, df};
  return static_cast<int>(dtype == 0 ? launch_fma<float>(p, G, s)
                                     : launch_fma<__nv_bfloat16>(p, G, s));
}
