// Grouped matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` / `gmm` of
// src/repro/kernels/moe_gmm.py and computes what it computes:
//
//   out[g] = x[g] @ w[g]      x (G, C, d), w (G, d, F) -> out (G, C, F)
//
// with the products summed in f32 over the whole contraction and the result
// rounded once, to x's dtype.  x, w and out share one dtype (f32 or bf16) and
// are contiguous.  In the MoE layer G is the expert count, C the capacity
// (tokens per expert) and d, F the expert's input and hidden widths: the
// three "ecd,edf->ecf" products of models/moe._expert_compute.
//
// Design.  The TPU kernel walks the contraction as the innermost, sequential
// grid axis and carries the f32 sum in VMEM scratch across grid steps, after
// padding C, F and d to its tiles.  Blocks on the GPU run in no order, so here
// one block owns one (BM x 64) output tile of one expert (grid: F tiles,
// C tiles, G) and loops over d itself, staging a BM x 16 tile of x and a
// 16 x 64 tile of w in shared memory as f32 per step; each weight tile is
// read once per C tile.  Each of the 256 threads keeps a TM x 4 block of f32
// accumulators in registers and reads its operands from shared memory as
// 16-byte vectors.  Nothing is padded: rows beyond C, columns beyond F and the
// contraction tail beyond d are masked on load (read as 0) and on store.
// Global loads take 4 consecutive elements at once (16 bytes f32, 8 bytes
// bf16) when the row length is a multiple of 4 and the base is aligned, else
// one element at a time.  A small C (decode: C = batch) takes 16-row tiles
// (TM = 1) so that fewer padded rows are computed; otherwise 64-row tiles.
//
// Bound on the H100 (SXM, 700 W data sheet: 3.35 TB/s HBM, 989 TFLOP/s dense
// bf16, 67 TFLOP/s f32 without tensor cores).  Work is 2*G*C*d*F FLOPs;
// bytes are x and w read once and out written once.  Granite-3.0-1B-A400M's
// prefill (4 x 512 tokens, top-8 of 32 experts, capacity 640): x (32, 640,
// 1024) @ w (32, 1024, 512) in bf16 moves 96.5 MB for 21.5 GFLOP (223 FLOP
// per byte, below the ~295 ridge), bound by bytes at ~28.8 us.  A decode step
// (C = 4) streams the 33.6 MB of weights: ~10 us.
//
// What this simple design leaves on the table: the products run on the f32
// FMA pipes, not the tensor cores (no mma.sync / wgmma), so prefill is bound
// by FMA issue (~0.32 ms at the f32 peak) far above its byte bound; loads are
// synchronous (no cp.async / TMA, no double buffering), so memory latency is
// hidden only by the other resident blocks; the capacity buffer is dense, so
// padded slots of lightly loaded experts are computed too (no ragged
// schedule over the experts' real counts).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

bool aligned4(const void* ptr, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % (4 * elem_bytes) == 0;
}

}  // namespace

// x: (G, C, d); w: (G, d, F); out: (G, C, F); all contiguous and of one dtype
// (0: f32, 1: bf16).  Launches on `stream` and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for an empty shape or unknown dtype.
extern "C" int repro_gmm(const void* x, const void* w, void* out, int dtype, int G, int C,
                         int d, int F, void* stream) {
  if (G < 1 || C < 1 || d < 1 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? dispatch<float>(p, s)
                                     : dispatch<__nv_bfloat16>(p, s));
}
