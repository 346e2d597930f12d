// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py and computes what it computes:
// online-softmax attention over (B, T, H, hd) with the running max m, sum l
// and accumulator kept in f32 for f32 and bf16 inputs, scale 1/sqrt(hd)
// applied to q, causal masking aligned top-left (query i sees keys j <= i),
// an optional sliding window (keys j > i - window), the `kpos < seq_len` pad
// mask, and masked scores set to the finite -1e30 (never -inf), so a row with
// no valid key in a tile gives no NaN.  The output is written in q's dtype.
//
// Design.  The TPU kernel walks the kv grid axis in sequence and carries
// m/l/acc in VMEM scratch across grid steps.  Blocks on the GPU run in no
// order, so here one thread block owns one (b, h, q-tile) and loops over the
// kv tiles itself; m and l live in shared memory, acc in registers.  Per kv
// tile: K and V are staged in shared memory as f32, S = Q K^T is computed
// with plain FMAs (16x16 thread grid), one warp per row does the online
// softmax with shuffles, and P V is accumulated into the registers.  A kv
// tile that lies wholly above the causal diagonal is skipped (the TPU's
// block skip).  Every (B, T, H, hd) stride is taken as given, so a decode
// step attends over a view `cache[:, :pos+1]` without a copy, and the KV head
// of query head h is h / (H / Hkv): grouped-query attention reads the
// un-repeated cache.  Tiny query counts (decode: Tq = 1) use 16-row q tiles
// instead of 64 so that fewer padded rows are computed; padded rows are never
// written.
//
// Bound on the H100 (SXM, 700 W data sheet: 989 TFLOP/s dense bf16, 67
// TFLOP/s f32 without tensor cores, 3.35 TB/s HBM).  Work is 4*B*H*Tq*Tk*hd
// FLOPs (about half of that when causal); bytes are q, k, v read once and o
// written once.  Prefill at the serving shape (B=4, T=512, H=32, Hkv=8,
// hd=64, bf16, causal) is bound by its bytes: 21 MB take ~6.3 us, its 4.3
// GFLOP ~4.4 us (205 FLOP/B, below the ~295 FLOP/B ridge, because GQA keeps
// k and v small).  A decode step (Tq = 1, Tk = 513) is bound by the bytes of
// the KV read, ~1.3 us.
//
// What this simple design leaves on the table: it runs on the FMA pipes, not
// the tensor cores (no mma.sync / wgmma), so prefill is far from the bf16
// bound; loads are scalar and synchronous (no cp.async / TMA, no double
// buffering), so memory latency is exposed; decode wastes 15 of 16 q rows
// per block instead of packing the H/Hkv query heads that share a KV head
// into one tile, and one block per (b, h) reads only Tk keys with no split
// over the kv axis, so a short batch leaves most SMs idle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // keys per kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  int64_t b, t, h, d;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int B, Tq, Tk, H, Hkv;
  int causal, window;
  float sm_scale;
};

template <int HD, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + BQ * (kBK + 1) + 3 * BQ);
}

template <typename T, int HD, int BQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  static_assert(BQ % 16 == 0 && kThreads % BQ == 0, "tile shape");
  constexpr int QS = HD + 1;   // padded row strides: column walks hit distinct banks
  constexpr int SS = kBK + 1;
  constexpr int TPR = kThreads / BQ;  // threads sharing one accumulator row
  constexpr int NACC = HD / TPR;      // accumulator columns per thread
  constexpr int RI = BQ / 16;         // score rows per thread

  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x QS, q * sm_scale
  float* Ks = Qs + BQ * QS;      // kBK x QS
  float* Vs = Ks + kBK * QS;     // kBK x HD
  float* Ss = Vs + kBK * HD;     // BQ x SS: scores, then probabilities
  float* row_m = Ss + BQ * SS;   // running max
  float* row_l = row_m + BQ;     // running sum
  float* row_c = row_l + BQ;     // this tile's rescale factor exp(m_prev - m_new)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, t = q0 + r;
    Qs[r * QS + c] = t < p.Tq ? to_f32(qg[t * p.sq.t + c * p.sq.d]) * p.sm_scale : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }

  const int ar = tid / TPR, ac0 = tid % TPR;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  // causal block skip: tiles starting past the tile's last query row are
  // fully masked for every row
  const int kv_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's reads of Ks / Vs / Ss are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, t = k0 + r;
      const bool ok = t < p.Tk;
      Ks[r * QS + c] = ok ? to_f32(kg[t * p.sk.t + c * p.sk.d]) : 0.f;
      Vs[r * HD + c] = ok ? to_f32(vg[t * p.sv.t + c * p.sv.d]) : 0.f;
    }
    __syncthreads();

    {  // S = Q K^T, masked
      const int ty = tid / 16, tx = tid % 16;
      float s[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float qv = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const int qpos = q0 + r, kpos = k0 + c;
          bool ok = kpos < p.Tk;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          Ss[r * SS + c] = ok ? s[i][j] : kNegInf;
        }
    }
    __syncthreads();

    {  // online softmax, one warp per row (kBK == 64: two scores a lane)
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < BQ; r += kThreads / 32) {
        const float a = Ss[r * SS + lane], c = Ss[r * SS + lane + 32];
        float mx = fmaxf(a, c);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = row_m[r];
        const float m_new = fmaxf(m_prev, mx);
        const float pa = __expf(a - m_new), pc = __expf(c - m_new);
        Ss[r * SS + lane] = pa;
        Ss[r * SS + lane + 32] = pc;
        float sum = pa + pc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float corr = __expf(m_prev - m_new);
          row_c[r] = corr;
          row_l[r] = row_l[r] * corr + sum;
          row_m[r] = m_new;
        }
      }
    }
    __syncthreads();

    {  // acc = acc * corr + P V
      const float corr = row_c[ar];
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] *= corr;
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float pv = Ss[ar * SS + kk];
#pragma unroll
        for (int j = 0; j < NACC; ++j) acc[j] = fmaf(pv, Vs[kk * HD + ac0 + TPR * j], acc[j]);
      }
    }
  }

  const int t = q0 + ar;
  if (t < p.Tq) {  // padded query rows are dropped
    const float l = fmaxf(row_l[ar], 1e-30f);
    T* og = static_cast<T*>(p.o) + b * p.so.b + t * p.so.t + h * p.so.h;
#pragma unroll
    for (int j = 0; j < NACC; ++j) store(og + (ac0 + TPR * j) * p.so.d, acc[j] / l);
  }
}

constexpr int kMaxDevices = 64;

template <typename T, int HD, int BQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ>();
  // The shared-memory opt-in is a per-device attribute of each instance:
  // set it at the first launch on a device, not on every launch.
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, HD, BQ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_bq(const Params& p, cudaStream_t stream) {
  return p.Tq <= 16 ? launch<T, HD, 16>(p, stream) : launch<T, HD, 64>(p, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_bq<T, 32>(p, stream);
    case 64: return dispatch_bq<T, 64>(p, stream);
    case 128: return dispatch_bq<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Tq, H, hd); k, v: (B, Tk, Hkv, hd); o: (B, Tq, H, hd), all of one
// dtype (0: f32, 1: bf16), addressed through `strides`: 16 element strides,
// (b, t, h, d) for q, k, v, o in that order.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int dtype, int B, int Tq, int Tk, int H, int Hkv,
                                         int hd, const int64_t* strides, int causal,
                                         int window, float sm_scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sq = Strides{strides[0], strides[1], strides[2], strides[3]};
  p.sk = Strides{strides[4], strides[5], strides[6], strides[7]};
  p.sv = Strides{strides[8], strides[9], strides[10], strides[11]};
  p.so = Strides{strides[12], strides[13], strides[14], strides[15]};
  p.B = B;
  p.Tq = Tq;
  p.Tk = Tk;
  p.H = H;
  p.Hkv = Hkv;
  p.causal = causal;
  p.window = window;
  p.sm_scale = sm_scale;
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_hd<float>(hd, p, s));
    case 1: return static_cast<int>(dispatch_hd<__nv_bfloat16>(hd, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
