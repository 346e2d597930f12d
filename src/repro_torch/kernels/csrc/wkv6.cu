// RWKV6 WKV recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` / `wkv6` of
// src/repro/kernels/rwkv_scan.py and computes the recurrence it computes (the
// sequential form of src/repro/models/rwkv.py:wkv_scan), per (batch, head):
//
//   kv  = k_t^T v_t                           (hd x hd, outer product)
//   o_t = r_t (S + diag(u) kv)                out[b, t, h, :]
//   S   = diag(w_t) S + kv                    S[key_dim, value_dim], f32
//
// r, k, v are (B, T, H, hd), contiguous, f32 or bf16 (one dtype); w (B, T, H,
// hd) f32; u (H, hd) f32; out (B, T, H, hd) f32, the TPU kernel's out_shape.
// Unlike the TPU kernel it takes an initial state (zeros when none is given)
// and writes the final state (B, H, hd, hd) f32, since decode starts from it;
// it takes any T >= 1 (no chunk multiple, no padding).  The final state may
// be written over the initial one: every thread reads its own part of S into
// registers before the first token and writes the same part back after the
// last, so the alias is safe.
//
// Design.  The TPU kernel walks T as a sequential grid axis, carries S in
// VMEM across chunks of 128 tokens and does each chunk's cross-token term as
// a (chunk x chunk) masked product on the MXU, with decay factors exp(+-cum)
// that overflow f32 for strong decays (src/repro/models/rwkv.py:116-121).
// Here one block owns one (b, h) and walks T itself in its own loop: the
// plain sequential recurrence, in f32, with no exp at all.  The block has
// 4 * hd threads; thread (q, j) keeps rows q*hd/4 .. (q+1)*hd/4 - 1 of state
// column j (and u of those rows) in registers, so the state never leaves the
// SM between the first token and the last.  Tokens are staged 1024/hd at a
// time: r, k, w, v of the chunk land in shared memory (coalesced loads, bf16
// widened to f32 once), and the loads of the next chunk are issued into
// registers before the current chunk's steps run, so their latency hides
// behind the arithmetic.  Within a chunk a step needs no barrier: every warp
// reads the same r, k, w rows of shared memory (16-byte broadcasts) and its
// own v; each thread's partial sum over its rows goes to shared memory, and
// after the chunk the 4 partials of each output are added and written as one
// coalesced row per token.
//
// Bound on the H100 (SXM, 700 W data sheet: 3.35 TB/s HBM, 67 TFLOP/s f32
// without tensor cores).  Bytes: r, k, v, w read once, out and the final
// state written once (and the initial state read when given).  Operations:
// 4 * hd^2 a token and head (one FMA for the output, one for the state
// update, in f32).  RWKV6-7B's prefill (B 4, T 512, H 64, hd 64; r, k, v
// bf16): 121.6 MB against 2.1 GFLOP, bound by bytes at ~0.036 ms, the FMAs
// alone ~0.032 ms.  A decode step (T 1) reads and writes the 8.4 MB state:
// ~0.0025 ms.
//
// What this simple design leaves on the table: it takes ~0.2 ms at that
// prefill and ~0.005 ms at decode on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 3; PERF.md), ~5.5x and ~1.9x the bound.  At prefill a warp reads r, k
// and w of its rows as 12 shared-memory broadcasts a token for 64 FMAs, and
// the shared-memory pipe rather than the FMA pipes likely sets the pace;
// giving a thread several columns would read each row once for all of them,
// and the chunked form would put the intra-chunk products on the tensor
// cores (ROADMAP item 16).  One block per (b, h) gives 256 blocks at B 4, H 64,
// about two per SM, so a smaller batch leaves SMs idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;  // threads sharing one state column, each with hd/4 rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s_in;  // initial state (B, H, hd, hd), or null for zeros
  float* s_out;       // final state (B, H, hd, hd); may be s_in
  float* out;         // (B, T, H, hd)
  int B, T, H;
};

template <typename T, int HD>
__global__ void __launch_bounds__(HD * kSplit) wkv6_kernel(Params p) {
  constexpr int kThreads = HD * kSplit;
  constexpr int kRows = HD / kSplit;                // state rows a thread keeps
  constexpr int kChunk = 1024 / HD;                 // tokens staged at a time
  constexpr int kLoads = kChunk * HD / kThreads;    // elements a thread stages per tensor
  static_assert(kRows % 4 == 0 && kLoads >= 1, "hd must be 32 or 64");

  __shared__ __align__(16) float rs[kChunk][HD];
  __shared__ __align__(16) float ks[kChunk][HD];
  __shared__ __align__(16) float ws[kChunk][HD];
  __shared__ float vs[kChunk][HD];
  __shared__ float part[kSplit][kChunk][HD];        // partial outputs by row group

  const int tid = threadIdx.x;
  const int j = tid % HD;           // the state column (value index) of this thread
  const int q = tid / HD;           // its row group
  const int i0 = q * kRows;         // its first state row (key index)
  const int bh = blockIdx.x;        // b * H + h
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int64_t step = static_cast<int64_t>(p.H) * HD;            // token t -> t + 1
  const int64_t base = (static_cast<int64_t>(b) * p.T * p.H + h) * HD;  // (b, 0, h, 0)
  const T* r = static_cast<const T*>(p.r) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const float* w = p.w + base;
  float* out = p.out + base;
  const int64_t s_base = static_cast<int64_t>(bh) * HD * HD;

  float u[kRows];
  float S[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    u[ii] = p.u[h * HD + i0 + ii];
    S[ii] = p.s_in ? p.s_in[s_base + static_cast<int64_t>(i0 + ii) * HD + j] : 0.f;
  }

  // element m of this thread in a chunk: token e / HD, column e % HD
  float fr[kLoads], fk[kLoads], fv[kLoads], fw[kLoads];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int e = tid + m * kThreads;
      const int t = t0 + e / HD;
      if (t < p.T) {
        const int64_t off = t * step + e % HD;
        fr[m] = to_f32(r[off]);
        fk[m] = to_f32(k[off]);
        fv[m] = to_f32(v[off]);
        fw[m] = w[off];
      } else {
        fr[m] = fk[m] = fv[m] = fw[m] = 0.f;
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < p.T; t0 += kChunk) {
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int e = tid + m * kThreads;
      rs[e / HD][e % HD] = fr[m];
      ks[e / HD][e % HD] = fk[m];
      vs[e / HD][e % HD] = fv[m];
      ws[e / HD][e % HD] = fw[m];
    }
    __syncthreads();
    if (t0 + kChunk < p.T) fetch(t0 + kChunk);   // in flight during this chunk's steps
    const int n = min(kChunk, p.T - t0);
    for (int s = 0; s < n; ++s) {
      const float vj = vs[s][j];
      float o = 0.f;
#pragma unroll
      for (int ii = 0; ii < kRows; ii += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[s][i0 + ii]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[s][i0 + ii]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[s][i0 + ii]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float kv = kk[x] * vj;
          o = fmaf(rr[x], fmaf(u[ii + x], kv, S[ii + x]), o);   // r_i (S_ij + u_i k_i v_j)
          S[ii + x] = fmaf(ww[x], S[ii + x], kv);               // w_i S_ij + k_i v_j
        }
      }
      part[q][s][j] = o;
    }
    __syncthreads();
    for (int e = tid; e < n * HD; e += kThreads) {
      const int s = e / HD;
      const int c = e % HD;
      float o = 0.f;
#pragma unroll
      for (int g = 0; g < kSplit; ++g) o += part[g][s][c];
      out[(t0 + s) * step + c] = o;
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    p.s_out[s_base + static_cast<int64_t>(i0 + ii) * HD + j] = S[ii];
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<p.B * p.H, HD * kSplit, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (B, T, H, hd) of `dtype` (0: f32, 1: bf16); w: (B, T, H, hd) f32;
// u: (H, hd) f32; s_in: (B, H, hd, hd) f32 or null (zeros); s_out: (B, H, hd,
// hd) f32, may equal s_in; out: (B, T, H, hd) f32; all contiguous.  hd is 32
// or 64.  Launches on `stream` and returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for an empty shape, an unknown dtype or head size,
// or a grid too large.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s_in, void* s_out, void* out,
                          int dtype, int B, int T, int H, int hd, void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * H > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s_in = static_cast<const float*>(s_in);
  p.s_out = static_cast<float*>(s_out);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.T = T;
  p.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? dispatch<float>(p, hd, s)
                                     : dispatch<__nv_bfloat16>(p, hd, s));
}
