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
// be written over the initial one: every thread of either variant reads its
// own part of S before the first token and writes the same part back after
// the last, so the alias is safe.
//
// Two variants, chosen by the caller (`wkv_variant` in kernels/wkv6.py) from
// the inputs alone: `scan` for a decode step and short prompts, `chunked`
// for prompts of 16 tokens or more.  The TPU kernel walks T as a sequential
// grid axis, carries S in VMEM across chunks of 128 tokens and does each
// chunk's cross-token term as a (chunk x chunk) masked product on the MXU,
// with decay factors exp(+-cum) that overflow f32 for strong decays
// (src/repro/models/rwkv.py:116-121).  Neither variant takes an exp.
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
// * `scan`: the plain sequential recurrence, in f32.  One block owns one
//   (b, h) and walks T in its own loop.  The block has 4 * hd threads;
//   thread (q, j) keeps rows q*hd/4 .. (q+1)*hd/4 - 1 of state column j (and
//   u of those rows) in registers, so the state never leaves the SM between
//   the first token and the last.  Tokens are staged 1024/hd at a time: r,
//   k, w, v of the chunk land in shared memory (coalesced loads, bf16
//   widened to f32 once), and the loads of the next chunk are issued into
//   registers before the current chunk's steps run.  Within a chunk a step
//   needs no barrier: every warp reads the same r, k, w rows of shared
//   memory (16-byte broadcasts) and its own v; each thread's partial sum
//   over its rows goes to shared memory, and after the chunk the 4 partials
//   of each output are added and written as one coalesced row per token.
//   ~0.005 ms at decode (~1.9x the bound) and ~0.2 ms at the prefill above
//   (PERF.md): there a warp reads r, k and w of its rows as 12 shared-memory
//   broadcasts a token for 64 FMAs.
//
// * `chunked`: the chunked form, the state carried from one sub-chunk of 16
//   tokens to the next.  Within a sub-chunk, with every decay a running
//   product of w (no factor above 1, so nothing overflows and strong decays
//   underflow to the right answer, 0):
//
//     out = (r_t prod_{q<t} w_q) S + P V,
//     P[t][s] = sum_i r_t k_s prod_{s<q<t} w_q (s < t), sum_i r_t u k_t (s = t)
//     S  <- diag(prod_q w_q) S + (k_s prod_{q>s} w_q)^T V.
//
//   The three products run on the tensor cores (mma.sync m16n8k8) in split
//   TF32 (hi*hi + hi*lo + lo*hi, ~21 bits, as CUTLASS's 3xTF32; bf16 v is
//   exact in TF32 and needs no lo), so the error stays near f32's.  The
//   diagonal block P is computed directly, off the tensor cores: a thread
//   builds k_s prod_{s<q<t} w_q token by token for its s and 8 keys.  One
//   block of 4 * hd threads owns one (b, h).  Half of it (hd / 16 math
//   warps) runs the products of sub-chunk n - 1 while the other half (the
//   prep warps) fills a 3-stage cp.async ring and computes sub-chunk n's
//   decays and P, which do not depend on the state; one barrier a
//   sub-chunk hands the buffer over.  The math warps solve the transposed
//   problem (out^T = S^T r~^T + V^T P^T, S^T <- S^T diag + V^T k~) so that a
//   warp's 16 value rows of S^T stay in registers as the update's
//   accumulator tiles, and those same registers, with the keys of each
//   group of 8 read in the order 0 2 4 6 1 3 5 7, are the A fragment of the
//   next S^T r~^T: the state never goes through shared memory.  The final
//   state may be written over the initial one: each thread reads and writes
//   the same elements.  Any T: the last sub-chunk's tokens past T decay by 1
//   and carry zeros.
//
// The backward (`repro_wkv6_bwd`, three kernels, no TPU kernel: JAX
// differentiates the scan) is described at its section below.
//
// What the chunked form still leaves on the table: it is bound by issued
// instructions, not bytes: the split-TF32 conversions of the operands, the
// direct diagonal block (~L/2 products a token and key) and address
// arithmetic; mma.sync TF32 rather than wgmma; and one block per (b, h), so
// B * H < 264 leaves SMs idle (a split of the value columns over two blocks
// would double the grid).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kSplit = 4;  // threads sharing one state column, each with hd/4 rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s_in;  // initial state (B, H, hd, hd), or null for zeros
  float* s_out;       // final state (B, H, hd, hd), may be s_in; null: not written (scan)
  void* out;          // (B, T, H, hd), f32 (the backward's dv: r's dtype)
  int B, T, H;
};

// The sequential scan.  r and k are T, v TV, out TO; kRev walks the tokens
// from the last to the first.  The forward is <T, T, float, HD, false>; the
// backward's dv is the same recurrence in reverse with k and r swapped and
// dO for v (dv_t = k_t (G_t + diag(u) r_t^T dO_t), G_{t-1} = diag(w_t) G_t
// + r_t^T dO_t), <T, float, T, HD, true>.
template <typename T, typename TV, typename TO, int HD, bool kRev>
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
  const TV* v = static_cast<const TV*>(p.v) + base;
  const float* w = p.w + base;
  TO* out = static_cast<TO*>(p.out) + base;
  const int64_t s_base = static_cast<int64_t>(bh) * HD * HD;
  auto tok = [&](int t) { return kRev ? p.T - 1 - t : t; };   // the t-th token walked

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
        const int64_t off = tok(t) * step + e % HD;
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
      store(out + tok(t0 + s) * step + c, o);
    }
  }

  if (p.s_out) {
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
      p.s_out[s_base + static_cast<int64_t>(i0 + ii) * HD + j] = S[ii];
  }
}

// ---------------------------------------------------------------------------
// The chunked form on the tensor cores: variant `chunked`
// ---------------------------------------------------------------------------

constexpr int kL = 16;   // tokens of a sub-chunk: one m16 tile of rows

// Split TF32 for mma.sync m16n8k8 (as CUTLASS's 3xTF32): hi is x rounded to
// TF32's 10-bit mantissa (add half an ulp, clear the low 13 bits), lo = x -
// hi exactly in f32.  lo goes to the tensor cores as it is: they read the
// top 19 bits of a TF32 operand, so hi + lo carries ~21 bits of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, TF32 operands, f32 accumulator.  Fragments (g = lane / 4,
// t = lane % 4): A (16 x 8, row) a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B (8 x 8, col) b0 (k t, n g), b1 (k t+4, n g); C as for
// m16n8k16: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma_1688(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in split TF32: lo*hi + hi*lo + hi*hi (the lo*lo term, ~2^-20 of
// the product, is dropped).  An operand exact in TF32 (v widened from
// bf16) has a zero lo, and its term is skipped.
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     const uint32_t bh[2], const uint32_t bl[2]) {
  if (!kAExact) mma_1688(c, al, bh);
  if (!kBExact) mma_1688(c, ah, bl);
  mma_1688(c, ah, bh);
}

// x split into TF32 hi and lo, or, when kExact, x as it is (lo unused).
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact)
    hi = __float_as_uint(x);
  else
    split_tf32(x, hi, lo);
}

__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// Shared memory of the chunked kernel: NS stages of raw r, k, v (T) and w
// (f32), [kL][HD] each; two buffers of what the prep warps make of a
// sub-chunk (f32 r~, k~, v, P and the total decay); the diagonal block's
// partial sums.
template <typename T, int HD, int NS>
struct ChunkSmem {
  static constexpr int kLd = HD + 8;     // r~, k~, v rows: fragment loads free of conflicts
  static constexpr int kPLd = kL + 4;
  static constexpr int kQ = HD / 8;      // 8-key groups of a row: partial sums of P
  static constexpr int kStage = kL * HD * (3 * static_cast<int>(sizeof(T)) + 4);   // bytes
  static constexpr int kBuf = 3 * kL * kLd + kL * kPLd + HD;                       // floats
  static constexpr int kFloats = 2 * kBuf + kL * kL * kQ;
  static constexpr size_t kBytes = static_cast<size_t>(NS) * kStage + sizeof(float) * kFloats;
  static_assert(kStage % 16 == 0 && kBuf % 4 == 0, "16-byte aligned stages and buffers");
};

// One sub-chunk as the prep warps leave it for the math warps.
struct SubChunk {
  float* rt;    // [kL][kLd]   r_t prod_{q<t} w_q
  float* kt;    // [kL][kLd]   k_s prod_{q>s} w_q
  float* vf;    // [kL][kLd]   v_s
  float* P;     // [kL][kPLd]  the diagonal block
  float* dec;   // [HD]        prod_q w_q
};

template <int kLd, int kPLd>
__device__ __forceinline__ SubChunk sub_chunk(float* buf) {
  SubChunk c;
  c.rt = buf;
  c.kt = c.rt + kL * kLd;
  c.vf = c.kt + kL * kLd;
  c.P = c.vf + kL * kLd;
  c.dec = c.P + kL * kPLd;
  return c;
}

// grid B * H: one block of 4 * HD threads per (b, h).  The first 2 * HD
// threads (HD / 16 math warps) run the tensor-core products of sub-chunk
// n - 1 while the other 2 * HD (the prep warps) load sub-chunk n and compute
// its decays and diagonal block, which do not depend on the state; one
// barrier a sub-chunk hands the buffer over.
template <typename T, int HD, int NS>
__global__ void __launch_bounds__(4 * HD) wkv6_chunked_kernel(Params p) {
  using Sm = ChunkSmem<T, HD, NS>;
  constexpr int kLd = Sm::kLd, kPLd = Sm::kPLd;
  constexpr int kPrep = 2 * HD;                   // prep threads
  constexpr int kQ = Sm::kQ;
  constexpr int kPiecesT = HD * sizeof(T) / 16;   // 16-byte pieces of a row of r, k, v
  constexpr int kPiecesW = HD * 4 / 16;
  constexpr bool kVExact = sizeof(T) == 2;        // bf16 v is exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* bufs = reinterpret_cast<float*>(smem_raw + NS * Sm::kStage);
  float* part = bufs + 2 * Sm::kBuf;              // [kL t][kL s][kQ]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int64_t step = static_cast<int64_t>(p.H) * HD;
  const int64_t base = (static_cast<int64_t>(b) * p.T * p.H + h) * HD;
  const int64_t s_base = static_cast<int64_t>(bh) * HD * HD;
  const int n_sub = (p.T + kL - 1) / kL;

  if (tid >= kPrep) {
    // ---- prep warps: staging ring, decays, diagonal block ----------------
    const int pt = tid - kPrep;
    const T* r = static_cast<const T*>(p.r) + base;
    const T* k = static_cast<const T*>(p.k) + base;
    const T* v = static_cast<const T*>(p.v) + base;
    const float* w = p.w + base;
    // tokens [16 n, 16 n + 16) of r, k, v, w into stage n % NS, whole
    // 16-byte pieces a thread; tokens past T are zero-filled
    constexpr int kItT = kL * kPiecesT / kPrep, kItW = kL * kPiecesW / kPrep;
    static_assert(kItT * kPrep == kL * kPiecesT && kItW * kPrep == kL * kPiecesW,
                  "every prep thread copies the same number of pieces");
    auto load = [&](int n) {
      unsigned char* st = smem_raw + (n % NS) * Sm::kStage;
      T* rs = reinterpret_cast<T*>(st);
      T* ks = rs + kL * HD;
      T* vs = ks + kL * HD;
      float* ws = reinterpret_cast<float*>(vs + kL * HD);
      const int t0 = n * kL;
      const int64_t g0 = t0 * step;
#pragma unroll
      for (int it = 0; it < kItT; ++it) {
        const int i = pt + it * kPrep;
        const int s = i / kPiecesT, c = (i % kPiecesT) * (16 / static_cast<int>(sizeof(T)));
        const bool ok = t0 + s < p.T;
        const int64_t off = ok ? g0 + s * step + c : 0;
        mma::cp_async16(rs + s * HD + c, r + off, ok);
        mma::cp_async16(ks + s * HD + c, k + off, ok);
        mma::cp_async16(vs + s * HD + c, v + off, ok);
      }
#pragma unroll
      for (int it = 0; it < kItW; ++it) {
        const int i = pt + it * kPrep;
        const int s = i / kPiecesW, c = (i % kPiecesW) * 4;
        const bool ok = t0 + s < p.T;
        mma::cp_async16(ws + s * HD + c, w + (ok ? g0 + s * step + c : 0), ok);
      }
    };
    // this thread's part of the diagonal block: token ps, keys [8 q, 8 q + 8)
    const int q = pt % kQ, ps = pt / kQ;
    float u8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) u8[e] = p.u[h * HD + 8 * q + e];
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (s < n_sub) load(s);
      mma::cp_async_commit();
    }
    for (int n = 0; n <= n_sub; ++n) {
      if (n < n_sub) {
        mma::cp_async_wait<NS - 2>();
        asm volatile("bar.sync 1, %0;\n" ::"n"(kPrep));   // stage n landed for every prep thread
        if (n + NS - 1 < n_sub) load(n + NS - 1);
        mma::cp_async_commit();
        unsigned char* st = smem_raw + (n % NS) * Sm::kStage;
        const T* rs = reinterpret_cast<const T*>(st);
        const T* ks = rs + kL * HD;
        const T* vs = ks + kL * HD;
        float* ws = reinterpret_cast<float*>(st + 3 * kL * HD * sizeof(T));
        const int nv = min(kL, p.T - n * kL);   // valid tokens
        if (nv < kL) {   // the tokens past T decay by 1 (r, k, v are zero there)
          for (int e = pt; e < (kL - nv) * HD; e += kPrep) ws[nv * HD + e] = 1.f;
          asm volatile("bar.sync 1, %0;\n" ::"n"(kPrep));
        }
        const SubChunk c = sub_chunk<kLd, kPLd>(bufs + (n % 2) * Sm::kBuf);

        // 1. Decays as running products of w, each factor <= 1.
        if (pt < HD) {
          const int i = pt;
          float d = 1.f;
#pragma unroll
          for (int s = 0; s < kL; ++s) {
            c.rt[s * kLd + i] = to_f32(rs[s * HD + i]) * d;
            d *= ws[s * HD + i];
          }
          c.dec[i] = d;
        } else {
          const int i = pt - HD;
          float d = 1.f;
#pragma unroll
          for (int s = kL - 1; s >= 0; --s) {
            c.kt[s * kLd + i] = to_f32(ks[s * HD + i]) * d;
            c.vf[s * kLd + i] = to_f32(vs[s * HD + i]);
            d *= ws[s * HD + i];
          }
        }

        // 2. The diagonal block, off the tensor cores: P[t][s] = sum_i r_t
        // k_s prod_{s<q<t} w_q for s < t (k_s times the products, built
        // token by token, <= 1), P[t][t] = sum_i r_t u k_t (the bonus), 0
        // above the diagonal.  This thread walks t = ps + 1 .. 15 for its
        // token s = ps; partial sums over 8 keys go to `part`.
        {
          float kf[8], rr[8], ww[8];
          load8(ks + ps * HD + 8 * q, kf);
          load8(rs + ps * HD + 8 * q, rr);
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) x = fmaf(rr[e] * u8[e], kf[e], x);
          part[(ps * kL + ps) * kQ + q] = x;
          const T* rp = rs + (ps + 1) * HD + 8 * q;     // r_t, t = ps + 1 + j
          const float* wp = ws + ps * HD + 8 * q;      // w_{t-1}
          float* pp = part + ((ps + 1) * kL + ps) * kQ + q;
          for (int j = 0; j < kL - 1 - ps; ++j) {
            if (j > 0) {
              load8(wp + j * HD, ww);
#pragma unroll
              for (int e = 0; e < 8; ++e) kf[e] *= ww[e];
            }
            load8(rp + j * HD, rr);
            x = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) x = fmaf(rr[e], kf[e], x);
            pp[j * kL * kQ] = x;
          }
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(kPrep));   // the partial sums are written
#pragma unroll
        for (int it = 0; it < kL * kL / kPrep; ++it) {
          const int e = pt + it * kPrep, t = e / kL, s = e % kL;
          float x = 0.f;
          if (s <= t) {
            const float4* pp = reinterpret_cast<const float4*>(part + e * kQ);
#pragma unroll
            for (int j = 0; j < kQ / 4; ++j) {
              const float4 y = pp[j];
              x += (y.x + y.y) + (y.z + y.w);
            }
          }
          c.P[t * kPLd + s] = x;
        }
      }
      __syncthreads();   // hand sub-chunk n to the math warps, take back n - 1's buffer
    }
    mma::cp_async_wait<0>();
    return;
  }

  // ---- math warps, on the transposed problem -------------------------------
  // out^T = S^T r~^T + V^T P^T,  S^T <- S^T diag(dec) + V^T k~.  A warp owns
  // value rows [j0, j0 + 16) of S^T and of out^T.  S^T stays in registers as
  // the update's m16n8 accumulator tiles (n tile kn: keys 8 kn..8 kn + 7),
  // c0, c1 at (j0 + g, keys 2t, 2t + 1) and c2, c3 at (j0 + g + 8, ...).
  // Read with the keys of each group of 8 in the order 0, 2, 4, 6, 1, 3, 5,
  // 7, those registers are the A fragment of S^T r~^T as they stand
  // (a0 = c0, a1 = c2, a2 = c1, a3 = c3), so S never goes through shared
  // memory; r~ is read with its keys in the same order.
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int j0 = 16 * warp;
  float* out = static_cast<float*>(p.out) + base;
  float St[HD / 8][4];
#pragma unroll
  for (int kn = 0; kn < HD / 8; ++kn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * kn + 2 * t4 + e % 2, j = j0 + g8 + 8 * (e / 2);
      St[kn][e] = p.s_in ? p.s_in[s_base + key * HD + j] : 0.f;
    }
  __syncthreads();   // the prep warps' first sub-chunk
  for (int n = 0; n < n_sub; ++n) {
    const SubChunk c = sub_chunk<kLd, kPLd>(bufs + (n % 2) * Sm::kBuf);
    // inter: three accumulators (lo hi, hi lo, hi hi) keep the dependent
    // chains 8 products long; token tiles tn: tokens 8 tn..8 tn + 7
    float o[3][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ah[4], al[4];
      split<false>(St[kk][0], ah[0], al[0]);
      split<false>(St[kk][2], ah[1], al[1]);
      split<false>(St[kk][1], ah[2], al[2]);
      split<false>(St[kk][3], ah[3], al[3]);
#pragma unroll
      for (int tn = 0; tn < 2; ++tn) {
        const float2 rv =
            *reinterpret_cast<const float2*>(c.rt + (8 * tn + g8) * kLd + 8 * kk + 2 * t4);
        uint32_t bh2[2], bl2[2];
        split<false>(rv.x, bh2[0], bl2[0]);
        split<false>(rv.y, bh2[1], bl2[1]);
        mma_1688(o[0][tn], al, bh2);
        mma_1688(o[1][tn], ah, bl2);
        mma_1688(o[2][tn], ah, bh2);
      }
    }
    // intra: V^T P^T; the V^T fragments (value rows, tokens s) feed the update too
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* v0 = c.vf + (8 * ks + t4) * kLd + j0 + g8;
      const float* v1 = v0 + 4 * kLd;
      split<kVExact>(v0[0], vh[ks][0], vl[ks][0]);
      split<kVExact>(v0[8], vh[ks][1], vl[ks][1]);
      split<kVExact>(v1[0], vh[ks][2], vl[ks][2]);
      split<kVExact>(v1[8], vh[ks][3], vl[ks][3]);
#pragma unroll
      for (int tn = 0; tn < 2; ++tn) {
        const float* pr = c.P + (8 * tn + g8) * kPLd + 8 * ks + t4;
        uint32_t bh2[2], bl2[2];
        split<false>(pr[0], bh2[0], bl2[0]);
        split<false>(pr[4], bh2[1], bl2[1]);
        mma3<kVExact, false>(o[ks][tn], vh[ks], vl[ks], bh2, bl2);
      }
    }
#pragma unroll
    for (int tn = 0; tn < 2; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = n * kL + 8 * tn + 2 * t4 + e % 2;
        if (t < p.T)
          out[t * step + j0 + g8 + 8 * (e / 2)] = o[0][tn][e] + o[1][tn][e] + o[2][tn][e];
      }
    // update: S^T diag(dec) + V^T k~ (keys as the n tiles)
#pragma unroll
    for (int kn = 0; kn < HD / 8; ++kn) {
      const float2 d = *reinterpret_cast<const float2*>(c.dec + 8 * kn + 2 * t4);
      St[kn][0] *= d.x;
      St[kn][1] *= d.y;
      St[kn][2] *= d.x;
      St[kn][3] *= d.y;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* kr = c.kt + (8 * ks + t4) * kLd + 8 * kn + g8;
        uint32_t bh2[2], bl2[2];
        split<false>(kr[0], bh2[0], bl2[0]);
        split<false>(kr[4 * kLd], bh2[1], bl2[1]);
        mma3<kVExact, false>(St[kn], vh[ks], vl[ks], bh2, bl2);
      }
    }
    __syncthreads();   // take sub-chunk n + 1, give back n's buffer
  }

#pragma unroll
  for (int kn = 0; kn < HD / 8; ++kn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * kn + 2 * t4 + e % 2, j = j0 + g8 + 8 * (e / 2);
      p.s_out[s_base + key * HD + j] = St[kn][e];
    }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  wkv6_kernel<T, T, float, HD, false><<<p.B * p.H, HD * kSplit, 0, stream>>>(p);
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

constexpr int kChunkStages = 3;   // sub-chunks of r, k, v, w in the cp.async ring

template <typename T, int HD, int NS>
cudaError_t launch_chunked(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = ChunkSmem<T, HD, NS>::kBytes;
  cudaError_t err = launch::opt_in_smem<&wkv6_chunked_kernel<T, HD, NS>>(smem);
  if (err != cudaSuccess) return err;
  wkv6_chunked_kernel<T, HD, NS><<<p.B * p.H, 4 * HD, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chunked(const Params& p, int hd, cudaStream_t stream) {
  for (const void* ptr : {p.r, p.k, p.v, static_cast<const void*>(p.w)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_chunked<T, 32, kChunkStages>(p, stream);
    case 64: return launch_chunked<T, 64, kChunkStages>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------
//
// From a zero initial state, the final state unused, for the output gradient
// dO (B, T, H, hd) f32, with G_t = dL/dS_t (G_{T-1} = 0, G_{t-1} = r_t^T dO_t
// + diag(w_t) G_t) and vdo_t = v_t . dO_t:
//
//   dr_t = S_{t-1} dO_t + u k_t vdo_t      dk_t = G_t v_t + u r_t vdo_t
//   dv_t = k_t (G_t + diag(u) r_t^T dO_t)   dw_t = sum_j G_t[., j] S_{t-1}[., j]
//   du   = sum_{b, t} r_t k_t vdo_t
//
// Three kernels, one launch of `repro_wkv6_bwd`:
//
// * `wkv6_bwd_rows_kernel`, for dr, dk, dw and du's partials.  Rows of S and
//   G are independent (row i decays by w[., i] alone), so a block owns kRB
//   rows of one (b, h) and nothing crosses blocks.  A thread keeps 8
//   columns of its row of S, then of G, in registers; sums over the columns
//   are its own and a shuffle over the HD / 8 threads of the row.  Tokens
//   go through shared memory 16 at a time (a sub-chunk).  A forward pass
//   writes dr, adds du's partial and saves S at every chunk start (64
//   tokens) to a workspace of (B H, T / 64 - 1, hd, hd) f32 (130 MB at B 4
//   x T 2048 x H 64 x hd 64).  The reverse pass walks the chunks from the
//   last: it recomputes S forward from the chunk's saved state to each
//   sub-chunk's start (kept in shared memory, a thread's own elements), then
//   walks the sub-chunks backward with G.  S_{t-1} is never recovered from
//   S_t (that divides by w, which underflows to 0 under strong decays):
//   within a sub-chunk from t0,
//
//     dw_t = D(t0..t-1) (G_t . S_{t0-1}) + sum_{t0<=s<t} D(s+1..t-1) k_s (G_t . v_s)
//
//   per row, D(a..b) = prod_{a<=q<=b} w_q, the products built from 1 token
//   by token, each factor <= 1.
// * `wkv6_kernel<..., true>`, the scan in reverse, for dv (above).
// * `wkv6_bwd_du_kernel`, du = the partials summed over b in order.
//
// Every sum is taken in a fixed order (no atomics), so a repeat launch gives
// the same bits.  Bound on the H100 (3.35 TB/s): r, k, v (bf16), w and dO
// (f32) read, dr, dk, dv (bf16) and dw (f32) written, 24 bytes an element,
// 0.80 GB at B 4 x T 2048 x H 64 x hd 64: ~0.24 ms, plus the saved states
// written and read (0.26 GB).  What it leaves on the table: the reverse
// pass's sum over s costs ~L / 2 extra column sums a token (L = 16), the
// forward state is computed twice, everything runs on the FMA pipes, and a
// thread walks T alone (its latency is hidden only by the other blocks).

constexpr int kBwdChunk = 64;     // tokens between saved states
constexpr int kBwdSub = 16;       // tokens of a sub-chunk
constexpr int kBwdThreads = 128;  // 8 threads a token when staging
constexpr int kBwdCols = 8;       // columns of a row a thread keeps

struct BwdParams {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* dout;  // dO (B, T, H, hd)
  void* dr;           // (B, T, H, hd), r's dtype
  void* dk;
  float* dw;          // (B, T, H, hd)
  float* du_part;     // (B, H, hd)
  float* saved;       // (B H, n_chunks - 1, hd, hd): S before chunk c at c - 1
  int B, T, H;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads) wkv6_bwd_rows_kernel(BwdParams p) {
  constexpr int kQ = HD / kBwdCols;          // threads of a row
  constexpr int kRB = kBwdThreads / kQ;      // rows a block owns
  constexpr int L = kBwdSub;
  constexpr int kSubs = kBwdChunk / L;
  static_assert(HD % kRB == 0 && kBwdThreads == 8 * L && kBwdCols == 8, "block shape");
  __shared__ __align__(16) float rs[L][kRB];
  __shared__ __align__(16) float ks[L][kRB];
  __shared__ __align__(16) float ws[L][kRB];
  __shared__ __align__(16) float vs[L][HD];
  __shared__ __align__(16) float dos[L][HD];
  __shared__ float vdo[L];
  __shared__ float outs[2][L][kRB];          // a sub-chunk's dr, or its dk and dw
  __shared__ float first[kSubs][kBwdCols][kBwdThreads];   // S before each sub-chunk

  const int tid = threadIdx.x;
  const int ri = tid / kQ, q = tid % kQ;     // this thread's row of the block, column group
  const int c0 = q * kBwdCols;
  constexpr int kBlocksPerHead = HD / kRB;
  const int bh = blockIdx.x / kBlocksPerHead, rb = blockIdx.x % kBlocksPerHead;
  const int b = bh / p.H, h = bh % p.H;
  const int i = rb * kRB + ri;               // the state row (key index)
  const int64_t step = static_cast<int64_t>(p.H) * HD;
  const int64_t base = (static_cast<int64_t>(b) * p.T * p.H + h) * HD;
  const T* r = static_cast<const T*>(p.r) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  const float* w = p.w + base;
  const float* dout = p.dout + base;
  T* dr = static_cast<T*>(p.dr) + base;
  T* dk = static_cast<T*>(p.dk) + base;
  float* dw = p.dw + base;
  const int n_chunks = (p.T + kBwdChunk - 1) / kBwdChunk;
  float* saved = p.saved + static_cast<int64_t>(bh) * (n_chunks - 1) * HD * HD;
  const float ui = p.u[h * HD + i];

  // tokens [t0, t0 + L) into shared memory (zeros, and decays of 1, past T)
  // and vdo; ends with a barrier
  auto stage = [&](int t0) {
    const int n = min(L, p.T - t0);
    for (int e = tid; e < L * kRB; e += kBwdThreads) {
      const int s = e / kRB, c = e % kRB;
      float x = 0.f, y = 0.f, z = 1.f;
      if (s < n) {
        const int64_t off = (t0 + s) * step + rb * kRB + c;
        x = to_f32(r[off]);
        y = to_f32(k[off]);
        z = w[off];
      }
      rs[s][c] = x;
      ks[s][c] = y;
      ws[s][c] = z;
    }
    for (int e = tid; e < L * HD; e += kBwdThreads) {
      const int s = e / HD, c = e % HD;
      float x = 0.f, y = 0.f;
      if (s < n) {
        const int64_t off = (t0 + s) * step + c;
        x = to_f32(v[off]);
        y = dout[off];
      }
      vs[s][c] = x;
      dos[s][c] = y;
    }
    __syncthreads();
    {   // vdo: 8 threads a token, HD / 8 columns each, added in a fixed order
      const int s = tid / 8, part = tid % 8;
      float x = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) x = fmaf(vs[s][part * (HD / 8) + c], dos[s][part * (HD / 8) + c], x);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      if (part == 0) vdo[s] = x;
    }
    __syncthreads();
  };
  // the sum over a row's kQ threads (consecutive lanes)
  auto row_sum = [](float x) {
#pragma unroll
    for (int o = 1; o < kQ; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  };
  auto load8 = [](const float* src, float x[kBwdCols]) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  };
  auto advance = [&](float S[kBwdCols], int s) {   // S_t from S_{t-1}, token s staged
    float vv[kBwdCols];
    load8(&vs[s][c0], vv);
    const float kk = ks[s][ri], ww = ws[s][ri];
#pragma unroll
    for (int e = 0; e < kBwdCols; ++e) S[e] = fmaf(ww, S[e], kk * vv[e]);
  };
  // a sub-chunk's outputs (outs[0] to o0, outs[1] to o1 if given), coalesced
  auto write_out = [&](int t0, auto* o0, float* o1) {
    const int n = min(L, p.T - t0);
    for (int e = tid; e < n * kRB; e += kBwdThreads) {
      const int s = e / kRB, c = e % kRB;
      const int64_t off = (t0 + s) * step + rb * kRB + c;
      store(o0 + off, outs[0][s][c]);
      if (o1) o1[off] = outs[1][s][c];
    }
  };

  // ---- forward: dr, du's partial, the saved states --------------------------
  float S[kBwdCols];
#pragma unroll
  for (int e = 0; e < kBwdCols; ++e) S[e] = 0.f;
  float du = 0.f;
  for (int t0 = 0; t0 < p.T; t0 += L) {
    if (t0 % kBwdChunk == 0 && t0 > 0) {
      float4* dst = reinterpret_cast<float4*>(
          saved + (static_cast<int64_t>(t0 / kBwdChunk - 1) * HD + i) * HD + c0);
      dst[0] = make_float4(S[0], S[1], S[2], S[3]);
      dst[1] = make_float4(S[4], S[5], S[6], S[7]);
    }
    stage(t0);
    const int n = min(L, p.T - t0);
    for (int s = 0; s < n; ++s) {
      float dd[kBwdCols];
      load8(&dos[s][c0], dd);
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) x = fmaf(dd[e], S[e], x);
      x = row_sum(x);
      if (q == 0) {
        outs[0][s][ri] = fmaf(ui * ks[s][ri], vdo[s], x);
        du = fmaf(rs[s][ri] * ks[s][ri], vdo[s], du);
      }
      advance(S, s);
    }
    __syncthreads();
    write_out(t0, dr, nullptr);
  }
  if (q == 0) p.du_part[static_cast<int64_t>(bh) * HD + i] = du;

  // ---- reverse: dk, dw ------------------------------------------------------
  float G[kBwdCols];
#pragma unroll
  for (int e = 0; e < kBwdCols; ++e) G[e] = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int tc = c * kBwdChunk;
    const int n_sub = min(kSubs, (p.T - tc + L - 1) / L);
    if (c == 0) {
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) S[e] = 0.f;
    } else {
      load8(saved + (static_cast<int64_t>(c - 1) * HD + i) * HD + c0, S);
    }
    // the state before each sub-chunk (a thread reads back only its own)
    for (int m = 0; m < n_sub; ++m) {
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) first[m][e][tid] = S[e];
      if (m + 1 < n_sub) {           // sub-chunk m is whole
        stage(tc + m * L);
        for (int s = 0; s < L; ++s) advance(S, s);
        __syncthreads();
      }
    }
    for (int m = n_sub - 1; m >= 0; --m) {
      const int t0 = tc + m * L;
      const int n = min(L, p.T - t0);
      stage(t0);
      float s0[kBwdCols];
#pragma unroll
      for (int e = 0; e < kBwdCols; ++e) s0[e] = first[m][e][tid];
      for (int s = n - 1; s >= 0; --s) {
        float vv[kBwdCols], dd[kBwdCols];
        load8(&vs[s][c0], vv);
        float dkx = 0.f, y = 0.f;
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) {
          dkx = fmaf(G[e], vv[e], dkx);
          y = fmaf(G[e], s0[e], y);
        }
        float acc = 0.f, prod = 1.f;
        for (int j = s - 1; j >= 0; --j) {
          load8(&vs[j][c0], vv);
          float z = 0.f;
#pragma unroll
          for (int e = 0; e < kBwdCols; ++e) z = fmaf(G[e], vv[e], z);
          acc = fmaf(prod * ks[j][ri], z, acc);
          prod *= ws[j][ri];
        }
        float dwx = fmaf(prod, y, acc);
        dkx = row_sum(dkx);
        dwx = row_sum(dwx);
        const float rr = rs[s][ri], ww = ws[s][ri];
        if (q == 0) {
          outs[0][s][ri] = fmaf(ui * rr, vdo[s], dkx);
          outs[1][s][ri] = dwx;
        }
        load8(&dos[s][c0], dd);
#pragma unroll
        for (int e = 0; e < kBwdCols; ++e) G[e] = fmaf(ww, G[e], rr * dd[e]);
      }
      __syncthreads();
      write_out(t0, dk, dw);
    }
  }
}

// du[h, i] = sum_b du_part[b, h, i], b in order
__global__ void wkv6_bwd_du_kernel(const float* du_part, float* du, int B, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float x = 0.f;
  for (int b = 0; b < B; ++b) x += du_part[static_cast<int64_t>(b) * n + e];
  du[e] = x;
}

template <typename T, int HD>
cudaError_t launch_bwd(const BwdParams& p, void* dv, float* du, cudaStream_t stream) {
  constexpr int kRB = kBwdThreads / (HD / kBwdCols);
  const int64_t blocks = static_cast<int64_t>(p.B) * p.H * (HD / kRB);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  wkv6_bwd_rows_kernel<T, HD><<<static_cast<unsigned>(blocks), kBwdThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dv: the scan in reverse, k and r swapped, dO for v, no initial or final state
  Params s;
  s.r = p.k;
  s.k = p.r;
  s.v = p.dout;
  s.w = p.w;
  s.u = p.u;
  s.s_in = nullptr;
  s.s_out = nullptr;
  s.out = dv;
  s.B = p.B;
  s.T = p.T;
  s.H = p.H;
  wkv6_kernel<T, float, T, HD, true><<<p.B * p.H, HD * kSplit, 0, stream>>>(s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = p.H * HD;
  wkv6_bwd_du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(p.du_part, du, p.B, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const BwdParams& p, int hd, void* dv, float* du, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_bwd<T, 32>(p, dv, du, stream);
    case 64: return launch_bwd<T, 64>(p, dv, du, stream);
    default: return cudaErrorInvalidValue;
  }
}

// du's partials, then the saved states: what `repro_wkv6_bwd_workspace` reports
int64_t bwd_workspace_bytes(int B, int T, int H, int hd) {
  const int64_t bh = static_cast<int64_t>(B) * H;
  const int64_t saves = (T + kBwdChunk - 1) / kBwdChunk - 1;
  return 4 * (bh * hd + bh * saves * hd * hd);
}

}  // namespace

// r, k, v: (B, T, H, hd) of `dtype` (0: f32, 1: bf16); w: (B, T, H, hd) f32;
// u: (H, hd) f32; s_in: (B, H, hd, hd) f32 or null (zeros); s_out: (B, H, hd,
// hd) f32, may equal s_in; out: (B, T, H, hd) f32; all contiguous.  hd is 32
// or 64.  `variant` 0 runs the sequential scan, 1 the chunked form on the
// tensor cores, which needs r, k, v and w 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an empty shape, an unknown dtype, head size or
// variant, a variant the inputs do not fit, or a grid too large.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s_in, void* s_out, void* out,
                          int dtype, int B, int T, int H, int hd, int variant,
                          void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * H > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s_in = static_cast<const float*>(s_in);
  p.s_out = static_cast<float*>(s_out);
  p.out = out;
  p.B = B;
  p.T = T;
  p.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return static_cast<int>(dtype == 0 ? dispatch_chunked<float>(p, hd, s)
                                       : dispatch_chunked<__nv_bfloat16>(p, hd, s));
  return static_cast<int>(dtype == 0 ? dispatch<float>(p, hd, s)
                                     : dispatch<__nv_bfloat16>(p, hd, s));
}

// Bytes of scratch `repro_wkv6_bwd` needs at (B, T, H, hd): du's partials,
// (B, H, hd) f32, then the state at every chunk start but the first, (B H) x
// (ceil(T / 64) - 1) x hd x hd f32 (130 MB at B 4 x T 2048 x H 64 x hd 64).
// -1 for a shape the backward does not take.
extern "C" long long repro_wkv6_bwd_workspace(int B, int T, int H, int hd) {
  if (B < 1 || T < 1 || H < 1 || (hd != 32 && hd != 64)) return -1;
  return bwd_workspace_bytes(B, T, H, hd);
}

// The backward of (out, _) = wkv6(r, k, v, w, u) from a zero state, the final
// state unused, for dO = dL/dout: r, k, v (B, T, H, hd) of `dtype` (0: f32,
// 1: bf16); w, dout (B, T, H, hd) and u (H, hd) f32.  Writes dr, dk, dv in
// `dtype`, dw (B, T, H, hd) and du (H, hd) f32; `workspace` is scratch of
// `workspace_bytes`, at least `repro_wkv6_bwd_workspace(B, T, H, hd)`, 16-byte
// aligned.  All contiguous; hd 32 or 64.  Three kernels on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for an empty
// shape, an unknown dtype or head size, a workspace too small, or a grid too
// large.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* dout, void* dr, void* dk, void* dv,
                              void* dw, void* du, void* workspace, long long workspace_bytes,
                              int dtype, int B, int T, int H, int hd, void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * H > 0x7fffffff / 8) return static_cast<int>(cudaErrorInvalidValue);
  if ((hd != 32 && hd != 64) || workspace_bytes < bwd_workspace_bytes(B, T, H, hd) ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.dout = static_cast<const float*>(dout);
  p.dr = dr;
  p.dk = dk;
  p.dw = static_cast<float*>(dw);
  p.du_part = static_cast<float*>(workspace);
  p.saved = p.du_part + static_cast<int64_t>(B) * H * hd;
  p.B = B;
  p.T = T;
  p.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* duf = static_cast<float*>(du);
  return static_cast<int>(dtype == 0 ? dispatch_bwd<float>(p, hd, dv, duf, s)
                                     : dispatch_bwd<__nv_bfloat16>(p, hd, dv, duf, s));
}
