// Fused LSTM cell for Hopper (sm_90a), hand-written CUDA C++: the forward
// step and the pointwise part of its backward.
//
// Replaces the Pallas TPU kernel `_lstm_kernel` / `lstm_cell` of
// src/repro/kernels/lstm_cell.py and computes what it computes: one step
//
//   gates = x @ Wx + h @ Wh + b           (accumulated in f32)
//   c'    = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//   h'    = sigmoid(o) * tanh(c')
//
// with the gate order i, f, g, o and the weights gate-major, (d_in, 4, H)
// and (d_h, 4, H): a zero-copy view of the model's (d, 4H) matrices.  Both
// products and the cell update run in one kernel, so the (B, 4H) gates never
// go to device memory in inference.  When autograd needs them the kernel also
// writes the activated gates (sigmoid(i), sigmoid(f + 1), tanh(g), sigmoid(o))
// in f32 to `gates` (B, 4, H).  x, h, c, the weights and the outputs share one
// dtype (f32 or bf16), b is f32; h' and c' are rounded to that dtype on write.
// Unlike the TPU kernel nothing is padded: B and H may be any size.
//
// The JAX package has no backward kernel (it trains by AD through the plain
// cell of src/repro/models/lstm.py).  `lstm_bwd_kernel` is the pointwise
// part of the cell's backward: from the saved gates, c and the incoming
// dh', dc' it gives dgates (B, 4, H) and dc.  c' is recomputed in f32 from
// the gates and c, not read back rounded.  The products that remain (dx, dh,
// dWx, dWh, db) are plain GEMMs and sums outside the kernels.
//
// Bound on the H100 (SXM, 700 W data sheet: 3.35 TB/s HBM, 989 TFLOP/s
// dense bf16, 67 TFLOP/s f32 without tensor cores).  At BigLSTM's training
// shape (B 16, d_in 1024, d_h 1024, H 8192, bf16) a step reads 134.2 MB of
// weights for 2.15 GFLOP: 16 FLOP per byte, so it is bound by bytes, ~40 us.
// The backward's pointwise kernel moves ~4 MB: ~1.2 us, bound by bytes.
//
// Design of the forward.  One block of 256 threads owns 32 hidden units, all
// four gates of them (128 weight columns), for up to 16 batch rows, so it
// reads its weight columns once and reuses each weight for every row.  At
// H = 8192 that is 256 blocks, two resident per SM on the 132 SMs (the TPU's
// 128-wide tile would give only 64).  Each lane owns 4 consecutive columns
// (one 8-byte bf16 or 16-byte f32 load per weight row) and 16 x 4 f32
// accumulators; the 8 warps split the 2048-long contraction (x and h rows
// back to back) between them.  The inputs are staged in shared memory as f32,
// transposed so that one broadcast 16-byte load gives 4 batch rows of one k.
// The 8 partial sums meet in shared memory, and the cell update runs as the
// epilogue.  Rows beyond B and columns beyond H are masked; H % 4 != 0 or
// misaligned weights take scalar weight loads.
//
// What this simple design leaves on the table: the products run on the f32
// FMA pipes, not the tensor cores (no mma.sync / wgmma), and loads are
// synchronous (no cp.async / TMA pipeline), so it is far from the byte bound;
// x @ Wx does not depend on the recurrence and could be one GEMM over all
// time steps instead of being recomputed step by step with the weights
// re-read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // contraction slices
constexpr int kBH = 32;                 // hidden units per block
constexpr int kCols = 4 * kBH;          // weight columns per block (i, f, g, o)
constexpr int kCPT = kCols / 32;        // columns per lane
constexpr int kBB = 16;                 // batch rows per block
constexpr int kKC = 256;                // contraction rows staged per chunk
constexpr int kZS = kBB + 4;            // padded stride of a staged row (16-byte aligned)
constexpr int kUnroll = 4;              // weight rows loaded ahead
constexpr size_t kSmemFloats =
    (kKC * kZS > kWarps * kBB * kCols) ? kKC * kZS : kWarps * kBB * kCols;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kCPT == 4, "a lane loads 4 consecutive weights");
static_assert(kKC % (kWarps * kUnroll) == 0, "chunk split");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void load4(const float* p, float w[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float w[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

struct FwdParams {
  const void* x;
  const void* h;
  const void* c;
  const void* wx;
  const void* wh;
  const float* b;
  void* h_out;
  void* c_out;
  float* gates;  // null: not written
  int64_t ldx, ldh, ldc, ldho, ldco;  // row strides in elements
  int B, d_in, d_h, H;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) lstm_fwd_kernel(FwdParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* zs = smem;   // kKC x kZS: staged [x | h] rows, transposed
  float* red = smem;  // kWarps x kBB x kCols: partial sums, after the contraction

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * kBH;
  const int r0 = blockIdx.y * kBB;
  const int K = p.d_in + p.d_h;
  const int64_t ldw = 4 * static_cast<int64_t>(p.H);
  // lane's columns lane*4 .. lane*4+3 of the block: gate lane/8, hidden
  // units h0 + (lane%8)*4 + e
  const int hcol = h0 + (lane & 7) * kCPT;
  const int64_t wcol = static_cast<int64_t>(lane >> 3) * p.H + hcol;
  const T* X = static_cast<const T*>(p.x);
  const T* Hs = static_cast<const T*>(p.h);
  const T* WX = static_cast<const T*>(p.wx);
  const T* WH = static_cast<const T*>(p.wh);

  float acc[kBB][kCPT];
#pragma unroll
  for (int r = 0; r < kBB; ++r)
#pragma unroll
    for (int e = 0; e < kCPT; ++e) acc[r][e] = 0.f;

  for (int kc = 0; kc < K; kc += kKC) {
    const int kn = min(kKC, K - kc);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kKC * kBB; i += kThreads) {
      const int kk = i % kKC, r = i / kKC, k = kc + kk, row = r0 + r;
      float v = 0.f;
      if (kk < kn && row < p.B)
        v = k < p.d_in ? to_f32(X[row * p.ldx + k]) : to_f32(Hs[row * p.ldh + (k - p.d_in)]);
      zs[kk * kZS + r] = v;
    }
    __syncthreads();
    const int ks0 = warp * (kKC / kWarps);
    const int ks1 = min(ks0 + kKC / kWarps, kn);
    for (int kk = ks0; kk < ks1; kk += kUnroll) {
      float w[kUnroll][kCPT];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kc + kk + u;
        const T* row = k < p.d_in ? WX + k * ldw : WH + (k - p.d_in) * ldw;
        if (kk + u < ks1 && kVec && hcol < p.H) {
          load4(row + wcol, w[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kCPT; ++e)
            w[u][e] = (kk + u < ks1 && hcol + e < p.H) ? to_f32(row[wcol + e]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4* zr = reinterpret_cast<const float4*>(zs + (kk + u) * kZS);
#pragma unroll
        for (int q = 0; q < kBB / 4; ++q) {
          const float4 z = zr[q];
#pragma unroll
          for (int e = 0; e < kCPT; ++e) {
            acc[4 * q + 0][e] = fmaf(z.x, w[u][e], acc[4 * q + 0][e]);
            acc[4 * q + 1][e] = fmaf(z.y, w[u][e], acc[4 * q + 1][e]);
            acc[4 * q + 2][e] = fmaf(z.z, w[u][e], acc[4 * q + 2][e]);
            acc[4 * q + 3][e] = fmaf(z.w, w[u][e], acc[4 * q + 3][e]);
          }
        }
      }
    }
  }

  __syncthreads();  // the staged rows are no longer read
#pragma unroll
  for (int r = 0; r < kBB; ++r)
    reinterpret_cast<float4*>(red + (warp * kBB + r) * kCols)[lane] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();

  const T* C = static_cast<const T*>(p.c);
  T* Ho = static_cast<T*>(p.h_out);
  T* Co = static_cast<T*>(p.c_out);
  for (int cell = tid; cell < kBB * kBH; cell += kThreads) {
    const int r = cell / kBH, j = cell % kBH, row = r0 + r, hh = h0 + j;
    if (row >= p.B || hh >= p.H) continue;
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = p.b[q * p.H + hh];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[(w * kBB + r) * kCols + q * kBH + j];
      s[q] = v;
    }
    const float ig = sigmoid(s[0]), fg = sigmoid(s[1] + 1.f);
    const float gg = tanhf(s[2]), og = sigmoid(s[3]);
    const float cn = fg * to_f32(C[row * p.ldc + hh]) + ig * gg;
    store(Ho + row * p.ldho + hh, og * tanhf(cn));
    store(Co + row * p.ldco + hh, cn);
    if (p.gates != nullptr) {
      float* g = p.gates + static_cast<int64_t>(row) * 4 * p.H + hh;
      g[0] = ig;
      g[p.H] = fg;
      g[2 * p.H] = gg;
      g[3 * p.H] = og;
    }
  }
}

struct BwdParams {
  const float* gates;  // (B, 4, H) activated gates from the forward
  const void* c;       // (B, H) the step's input cell state
  const void* dh;      // (B, H) gradient of h'
  const void* dc;      // (B, H) gradient of c', or null for zero
  void* dgates;        // (B, 4, H) gradient of the pre-activation gates
  void* dc_prev;       // (B, H) gradient of c
  int B, H;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(BwdParams p) {
  const int64_t n = static_cast<int64_t>(p.B) * p.H;
  const T* C = static_cast<const T*>(p.c);
  const T* DH = static_cast<const T*>(p.dh);
  const T* DC = static_cast<const T*>(p.dc);
  T* DG = static_cast<T*>(p.dgates);
  T* DCP = static_cast<T*>(p.dc_prev);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / p.H, j = i % p.H;
    const float* g = p.gates + r * 4 * p.H + j;
    const float ig = g[0], fg = g[p.H], gg = g[2 * p.H], og = g[3 * p.H];
    const float cp = to_f32(C[i]);
    const float tc = tanhf(fg * cp + ig * gg);
    const float dhn = to_f32(DH[i]);
    const float dct = (DC != nullptr ? to_f32(DC[i]) : 0.f) + dhn * og * (1.f - tc * tc);
    T* dg = DG + r * 4 * p.H + j;
    store(dg, dct * gg * ig * (1.f - ig));
    store(dg + p.H, dct * cp * fg * (1.f - fg));
    store(dg + 2 * p.H, dct * ig * (1.f - gg * gg));
    store(dg + 3 * p.H, dhn * tc * og * (1.f - og));
    store(DCP + i, dct * fg);
  }
}

constexpr int kMaxDevices = 64;

template <typename T, bool kVec>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  // The shared-memory opt-in is a per-device attribute of each instance:
  // set it at the first launch on a device, not on every launch.
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(lstm_fwd_kernel<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((p.H + kBH - 1) / kBH, (p.B + kBB - 1) / kBB);
  lstm_fwd_kernel<T, kVec><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const FwdParams& p, cudaStream_t stream) {
  const bool vec = p.H % 4 == 0 && reinterpret_cast<uintptr_t>(p.wx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.wh) % 16 == 0;
  return vec ? launch_fwd<T, true>(p, stream) : launch_fwd<T, false>(p, stream);
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(p.B) * p.H;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
  lstm_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One LSTM step.  x: (B, d_in), h: (B, d_h), c: (B, H), h_out, c_out: (B, H),
// each with its own row stride (ld*, in elements) and unit column stride;
// wx: (d_in, 4, H) and wh: (d_h, 4, H) contiguous; b: (4, H) f32 contiguous;
// gates: (B, 4, H) f32 contiguous or null.  dtype 0: f32, 1: bf16.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int repro_lstm_cell_fwd(const void* x, int64_t ldx, const void* h, int64_t ldh,
                                   const void* c, int64_t ldc, const void* wx, const void* wh,
                                   const float* b, void* h_out, int64_t ldho, void* c_out,
                                   int64_t ldco, float* gates, int dtype, int B, int d_in,
                                   int d_h, int H, void* stream) {
  if (B < 1 || d_in < 1 || d_h < 1 || H < 1 || (B + kBB - 1) / kBB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.x = x;
  p.h = h;
  p.c = c;
  p.wx = wx;
  p.wh = wh;
  p.b = b;
  p.h_out = h_out;
  p.c_out = c_out;
  p.gates = gates;
  p.ldx = ldx;
  p.ldh = ldh;
  p.ldc = ldc;
  p.ldho = ldho;
  p.ldco = ldco;
  p.B = B;
  p.d_in = d_in;
  p.d_h = d_h;
  p.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_fwd<float>(p, s));
    case 1: return static_cast<int>(dispatch_fwd<__nv_bfloat16>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pointwise backward of one step.  gates: (B, 4, H) f32; c, dh, dc, dc_prev:
// (B, H); dgates: (B, 4, H); all contiguous, dc may be null (zero).  dtype as
// above for c, dh, dc, dgates and dc_prev.  Returns cudaGetLastError().
extern "C" int repro_lstm_cell_bwd_pointwise(const float* gates, const void* c, const void* dh,
                                             const void* dc, void* dgates, void* dc_prev,
                                             int dtype, int B, int H, void* stream) {
  if (B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.gates = gates;
  p.c = c;
  p.dh = dh;
  p.dc = dc;
  p.dgates = dgates;
  p.dc_prev = dc_prev;
  p.B = B;
  p.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_bwd<float>(p, s));
    case 1: return static_cast<int>(launch_bwd<__nv_bfloat16>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
