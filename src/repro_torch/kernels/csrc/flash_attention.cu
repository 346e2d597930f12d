// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py and computes what it computes:
// online-softmax attention over (B, T, H, hd) with the running max m, sum l
// and accumulator kept in f32 for f32 and bf16 inputs, scale 1/sqrt(hd),
// causal masking aligned top-left (query i sees keys j <= i), an optional
// sliding window (keys j > i - window), the `kpos < seq_len` pad mask, and
// masked scores set to the finite -1e30 after scaling (never -inf), so a row
// with no valid key in a tile gives no NaN; l is floored at 1e-30.  The
// output is written in q's dtype.  Every (B, T, H, hd) stride is taken as
// given, so a decode step attends over a view `cache[:, :pos+1]` without a
// copy, and the KV head of query head h is h / (H / Hkv): grouped-query
// attention reads the un-repeated cache.
//
// Three variants, chosen by the wrapper (kernels/flash_attention.py,
// `variant`), each a kernel of its own:
//
// * FMA (f32 inputs, and bf16 inputs whose rows cannot take 16-byte async
//   copies).  One block of 256 threads owns one (b, h, q tile) and loops over
//   the kv tiles; K and V are staged in shared memory as f32, S = Q K^T on
//   the FMA pipes, one warp per row runs the online softmax, P V accumulates
//   in registers.  Tq <= 16 takes 16-row q tiles.
// * Tensor-core prefill tile (bf16, Tq * H / Hkv > 16), FlashAttention-2
//   style.  One block of 4 warps owns 64 query rows of one (b, h), 16 rows a
//   warp.  Q is loaded once with cp.async and kept as ldmatrix A fragments in
//   registers; K and V tiles of 64 keys stream through a 2-stage cp.async
//   ring in shared memory whose rows are padded by 16 bytes, so ldmatrix has
//   no bank conflicts.  S = Q K^T runs on mma.sync m16n8k16 (bf16 in, f32
//   out), is scaled into the log2 domain (exp2f), masked, and the online
//   softmax runs in registers: a row lives in a quad of lanes, so its max
//   takes two shuffles, and the quad adds its l only once, at the end.  P is
//   rounded to bf16 in registers and is the A fragment of P V as it stands
//   (the m16n8k16 accumulator layout is the A layout); V comes in by
//   ldmatrix.trans.  Neither S nor P touches shared memory, and a kv tile
//   needs one barrier.  The causal tile skip is kept, and the q tiles are
//   launched last (heaviest) first, so the causal imbalance leaves no tail.
// * Tensor-core decode tile (bf16, Tq * H / Hkv <= 16).  The H / Hkv query
//   heads that share a KV head, times Tq, are packed into the 16 rows of one
//   m16 tile, so each KV tile is read once per (b, hkv) and not once per
//   query head.  K and V stream through a 3-stage ring; the 4 warps take 16
//   keys each of every 64-key tile and are merged in shared memory at the
//   end.  B * Hkv blocks would leave most SMs idle (32 at Llama's and
//   Granite's decode), so the wrapper splits the kv tiles over about one
//   block per SM; each block writes its (m, l, o) partial, and the last
//   block of its (b, hkv) to arrive merges them in the same launch (an
//   atomic count, set back to 0 by that block), so a decode step launches
//   one kernel per layer as before.
//
// The bf16 variants round P to bf16 for P V, as tensor-core flash kernels
// do; the TPU kernel and the FMA variant keep P in f32.  The bf16 tolerance
// (2e-2) covers both.
//
// Bound on the H100 (SXM, 700 W data sheet: 989 TFLOP/s dense bf16, 67
// TFLOP/s f32 without tensor cores, 3.35 TB/s HBM).  Work is 4*B*H*Tq*Tk*hd
// FLOPs (about half of that when causal); bytes are q, k, v read once and o
// written once.  Prefill at Llama-3.2-1B's serving shape (B=4, T=512, H=32,
// Hkv=8, hd=64, bf16, causal) is bound by its bytes: 21 MB take ~6.3 us, its
// 4.3 GFLOP ~4.4 us (205 FLOP/B, below the ~295 FLOP/B ridge, because GQA
// keeps k and v small).  A decode step (Tq = 1, Tk = 513) is bound by the
// bytes of the KV read, ~1.3 us.
//
// What is still left on the table: mma.sync reaches at most about two
// thirds of the bf16 peak on Hopper (wgmma, TMA and warp specialisation are
// the way to the rest); every prefill block re-reads its KV head's tiles
// from L2 (H / Hkv blocks share one KV head, no cluster multicast); the
// decode tile computes 16 rows for rep * Tq of them, and its launch, a few
// microseconds, is most of its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // both tiles: 4 warps
constexpr int kTcBK = 64;        // keys per kv tile
constexpr int kTcBQ = 64;        // prefill tile: query rows, 16 a warp
constexpr int kTcPrefillStages = 2;
constexpr int kTcDecodeStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Shared-memory rows are padded by 16 bytes: row strides of HD + 8 elements
// (80, 144, 272 bytes) put the 8 rows an ldmatrix reads on 8 distinct
// 16-byte bank groups, and keep every row 16-byte aligned for cp.async.
template <int HD>
__host__ __device__ constexpr int row_ld() { return HD + 8; }

// Rows [r0, r0 + n) of one (b, head) of a bf16 (B, T, H, hd) tensor with
// d-stride 1 into shared memory at stride LD; rows past `t_end` are zero.
template <int HD, int NTHREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t t_stride, int r0,
                                          int n, int t_end) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  constexpr int LD = row_ld<HD>();
  for (int i = threadIdx.x; i < n * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8, t = r0 + r;
    const bool ok = t < t_end;
    mma::cp_async16(dst + r * LD + c, ok ? src + t * t_stride + c : src, ok);
  }
}

// Scale to the log2 domain, then mask: the -1e30 of masked scores is set
// after scaling, as in the f32 kernel.  s holds NB n8 tiles of one warp's 16
// rows; row g + 8 * (e / 2), key kpos0 + 8 * nb + 2t + (e % 2).
template <int NB>
__device__ __forceinline__ void scale_mask(float (&s)[NB][4], float scale, bool need_mask,
                                           int Tk, int causal, int window, int qpos_lo,
                                           int qpos_hi, int kpos0) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nb][e] * scale;
      if (need_mask) {
        const int qpos = e < 2 ? qpos_lo : qpos_hi;
        const int kpos = kpos0 + nb * 8 + 2 * t + (e & 1);
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) x = kNegInf;
      }
      s[nb][e] = x;
    }
}

// The online softmax of one tile for a thread's two rows (g, g + 8): the
// running max m over the quad's lanes, P = exp2(s - m) in place, the running
// sums l (this lane's share; the quad adds them at the end) and the rescale
// of the accumulator o.
template <int NB, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NB][4], float (&o)[NO][4],
                                               float (&m)[2], float (&l)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  const float corr[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nb][e] = exp2f(s[nb][e] - mx[e / 2]);
      sum[e / 2] += s[nb][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l[i] * corr[i] + sum[i];
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
}

// o += P V for one k16 step of a warp's 16 rows: P is the bf16 A fragment
// made of the S tiles 2kk and 2kk + 1; V rows [v_row0, v_row0 + 16) of the
// staged tile come in by ldmatrix.trans, two n8 tiles of hd per x4.
template <int HD, int NB>
__device__ __forceinline__ void pv_step(float (&o)[HD / 8][4], const float (&s)[NB][4], int kk,
                                        const bf16* vs, int v_row0) {
  constexpr int LD = row_ld<HD>();
  const int lane = threadIdx.x % 32;
  uint32_t a[4];
  a[0] = mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  const bf16* base = vs + (v_row0 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    uint32_t vf[4];
    mma::ldmatrix_x4_trans(vf, base + j * 16);
    mma::mma_16816(o[2 * j], a, vf);
    mma::mma_16816(o[2 * j + 1], a, vf + 2);
  }
}

// s = Q K^T for a warp's 16 rows against keys [k_row0, k_row0 + 8 NB) of the
// staged tile; qf holds Q's A fragments for the HD / 16 k16 steps.
template <int HD, int NB>
__device__ __forceinline__ void qk(float (&s)[NB][4], const uint32_t (&qf)[HD / 16][4],
                                   const bf16* ks, int k_row0) {
  constexpr int LD = row_ld<HD>();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
  const bf16* base = ks + (k_row0 + (lane % 8) + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kstep = 0; kstep < HD / 16; ++kstep)
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      uint32_t kf[4];
      mma::ldmatrix_x4(kf, base + j * 16 * LD + kstep * 16);
      mma::mma_16816(s[2 * j], qf[kstep], kf);
      mma::mma_16816(s[2 * j + 1], qf[kstep], kf + 2);
    }
}

template <int HD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[HD / 16][4], const bf16* qs,
                                             int row0) {
  constexpr int LD = row_ld<HD>();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kstep = 0; kstep < HD / 16; ++kstep)
    mma::ldmatrix_x4(qf[kstep], qs + (row0 + lane % 16) * LD + kstep * 16 + (lane / 16) * 8);
}

template <int HD>
constexpr size_t tc_prefill_smem() {
  return sizeof(bf16) * row_ld<HD>() * (kTcBQ + 2 * kTcPrefillStages * kTcBK);
}

// Prefill tile: one block per (h, b, q tile of 64 rows), 16 rows a warp.
// grid (H, B, q tiles); the q tile runs from the last (the heaviest under
// the causal mask) to the first in launch order.
template <int HD>
__global__ void __launch_bounds__(kTcThreads) flash_tc_prefill_kernel(Params p) {
  constexpr int LD = row_ld<HD>();
  constexpr int NB = kTcBK / 8;  // n8 tiles of S
  constexpr int NO = HD / 8;     // n8 tiles of O
  constexpr int BQ = kTcBQ, S = kTcPrefillStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * LD;
  bf16* vs = ks + S * kTcBK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (p.H / p.Hkv);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h;

  const int kv_end = p.causal ? min(p.Tk, q0 + BQ) : p.Tk;
  const int n_tiles = (kv_end + kTcBK - 1) / kTcBK;
  auto load_tile = [&](int tile) {
    const int stage = tile % S;
    load_rows<HD, kTcThreads>(ks + stage * kTcBK * LD, kg, p.sk.t, tile * kTcBK, kTcBK, p.Tk);
    load_rows<HD, kTcThreads>(vs + stage * kTcBK * LD, vg, p.sv.t, tile * kTcBK, kTcBK, p.Tk);
  };
  load_rows<HD, kTcThreads>(qs, qg, p.sq.t, q0, BQ, p.Tq);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    mma::cp_async_commit();
  }

  const float scale = p.sm_scale * kLog2e;
  const int row0 = warp * 16;  // the warp's first row in the q tile
  uint32_t qf[HD / 16][4];
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    mma::cp_async_wait<S - 2>();  // this tile (and Q) have landed
    // all copies of this tile are visible, and every warp is done with the
    // previous tile, whose stage the next load refills: one barrier a tile
    __syncthreads();
    if (tile + S - 1 < n_tiles) load_tile(tile + S - 1);
    mma::cp_async_commit();
    if (tile == 0) load_q_frags<HD>(qf, qs, row0);
    const int k0 = tile * kTcBK;
    const bf16* kt = ks + (tile % S) * kTcBK * LD;
    const bf16* vt = vs + (tile % S) * kTcBK * LD;
    float s[NB][4];
    qk<HD, NB>(s, qf, kt, 0);
    const bool need_mask = (p.causal && k0 + kTcBK - 1 > q0) || k0 + kTcBK > p.Tk ||
                           p.window > 0;
    const int qpos = q0 + row0 + g;
    scale_mask<NB>(s, scale, need_mask, p.Tk, p.causal, p.window, qpos, qpos + 8, k0);
    online_softmax<NB, NO>(s, o, m, l);
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) pv_step<HD, NB>(o, s, kk, vt, kk * 16);
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li = 1.f / fmaxf(li, 1e-30f);
    const int qpos = q0 + row0 + g + 8 * i;
    if (qpos >= p.Tq) continue;  // padded query rows are dropped
    bf16* og = static_cast<bf16*>(p.o) + b * p.so.b + qpos * p.so.t + h * p.so.h;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(og + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * i] * li, o[j][2 * i + 1] * li);
  }
}

template <int HD>
constexpr size_t tc_decode_smem() {
  constexpr size_t ring = sizeof(bf16) * row_ld<HD>() * (16 + 2 * kTcDecodeStages * kTcBK);
  constexpr size_t combine = sizeof(float) * 4 * 16 * (HD + 2);
  return ring > combine ? ring : combine;
}

// Decode tile: the rep = H / Hkv query heads of one KV head, times Tq, are
// packed into the 16 rows of one m16 tile (row r: head hk * rep + r / Tq,
// query r % Tq), so each KV tile is read once per (b, hk).  grid (n_split,
// Hkv, B): split s walks kv tiles [s * tiles_per_split, ...), warp w takes
// keys 16w .. 16w + 15 of each tile.  The 4 warps' (m, l, o) are merged in
// shared memory; with n_split > 1 each block then writes its partial to
// `ws`, and the last block of its (b, hk) to arrive (an atomic count in
// `counters`, which it sets back to 0) merges the n_split partials and
// writes the output: one launch.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_tc_decode_kernel(Params p, int tiles_per_split, float* ws, int* counters) {
  constexpr int LD = row_ld<HD>();
  constexpr int NO = HD / 8;
  constexpr int S = kTcDecodeStages;
  constexpr int PS = HD + 2;  // floats per row of a partial: m, l, o[HD]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + 16 * LD;
  bf16* vs = ks + S * kTcBK * LD;
  __shared__ int is_last;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int split = blockIdx.x, n_split = gridDim.x, hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.Hkv;
  const int rows = rep * p.Tq;  // <= 16
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h;

  const int kv_end = p.causal ? min(p.Tk, p.Tq) : p.Tk;
  const int n_tiles = (kv_end + kTcBK - 1) / kTcBK;
  const int tile0 = split * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  auto load_tile = [&](int tile) {
    const int stage = (tile - tile0) % S;
    load_rows<HD, kTcThreads>(ks + stage * kTcBK * LD, kg, p.sk.t, tile * kTcBK, kTcBK, p.Tk);
    load_rows<HD, kTcThreads>(vs + stage * kTcBK * LD, vg, p.sv.t, tile * kTcBK, kTcBK, p.Tk);
  };
  {  // the packed query rows
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b;
    constexpr int CH = HD / 8;
    for (int i = threadIdx.x; i < 16 * CH; i += kTcThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r < rows;
      const bf16* src = qg + (r % p.Tq) * p.sq.t + (hk * rep + r / p.Tq) * p.sq.h + c;
      mma::cp_async16(qs + r * LD + c, ok ? src : qg, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (tile0 + i < tile1) load_tile(tile0 + i);
    mma::cp_async_commit();
  }

  const float scale = p.sm_scale * kLog2e;
  // query positions of the thread's two rows (rows past `rows` are padding)
  const int qpos_lo = g % p.Tq, qpos_hi = (g + 8) % p.Tq;
  uint32_t qf[HD / 16][4];
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = tile0; tile < tile1; ++tile) {
    mma::cp_async_wait<S - 2>();
    __syncthreads();
    if (tile + S - 1 < tile1) load_tile(tile + S - 1);
    mma::cp_async_commit();
    if (tile == tile0) load_q_frags<HD>(qf, qs, 0);
    const int k0 = tile * kTcBK;
    const bf16* kt = ks + ((tile - tile0) % S) * kTcBK * LD;
    const bf16* vt = vs + ((tile - tile0) % S) * kTcBK * LD;
    float s[2][4];
    qk<HD, 2>(s, qf, kt, warp * 16);
    const bool need_mask = p.causal || p.window > 0 || k0 + kTcBK > p.Tk;
    scale_mask<2>(s, scale, need_mask, p.Tk, p.causal, p.window, qpos_lo, qpos_hi,
                  k0 + warp * 16);
    online_softmax<2, NO>(s, o, m, l);
    pv_step<HD, 2>(o, s, 0, vt, warp * 16);
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is reused below

  // merge the 4 warps: part[w][row] = (m, l, o[HD]) in shared memory
  float* part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    float* row = part + (warp * 16 + g + 8 * i) * PS;
    if (t == 0) {
      row[0] = m[i];
      row[1] = l[i];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      row[2 + j * 8 + 2 * t] = o[j][2 * i];
      row[2 + j * 8 + 2 * t + 1] = o[j][2 * i + 1];
    }
  }
  __syncthreads();

  auto out_ptr = [&](int r) {
    return static_cast<bf16*>(p.o) + b * p.so.b + (r % p.Tq) * p.so.t +
           (hk * rep + r / p.Tq) * p.so.h;
  };
  float* mine = n_split > 1 ? ws + ((static_cast<int64_t>(b) * p.Hkv + hk) * n_split) * 16 * PS
                            : nullptr;
  for (int i = threadIdx.x; i < 16 * HD; i += kTcThreads) {
    const int r = i / HD, c = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, part[(w * 16 + r) * PS]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* row = part + (w * 16 + r) * PS;
      const float f = exp2f(row[0] - mx);
      lsum += f * row[1];
      acc += f * row[2 + c];
    }
    if (n_split == 1) {
      if (r < rows) out_ptr(r)[c] = __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
    } else {
      float* dst = mine + (split * 16 + r) * PS;
      if (c == 0) {
        __stcg(dst, mx);
        __stcg(dst + 1, lsum);
      }
      __stcg(dst + 2 + c, acc);
    }
  }
  if (n_split == 1) return;

  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    int* count = counters + b * p.Hkv + hk;
    is_last = atomicAdd(count, 1) == n_split - 1;
    if (is_last) *count = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < rows * HD; i += kTcThreads) {
    const int r = i / HD, c = i % HD;
    float mx = kNegInf;
    for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, __ldcg(mine + (sp * 16 + r) * PS));
    float lsum = 0.f, acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* row = mine + (sp * 16 + r) * PS;
      const float f = exp2f(__ldcg(row) - mx);
      lsum += f * __ldcg(row + 1);
      acc += f * __ldcg(row + 2 + c);
    }
    out_ptr(r)[c] = __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD, int BQ>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, BQ>();
  cudaError_t err = launch::opt_in_smem<&flash_fwd_kernel<T, HD, BQ>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, HD, BQ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc_prefill(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = tc_prefill_smem<HD>();
  cudaError_t err = launch::opt_in_smem<&flash_tc_prefill_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (p.Tq + kTcBQ - 1) / kTcBQ;
  if (q_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(p.H, p.B, q_tiles);
  flash_tc_prefill_kernel<HD><<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc_decode(const Params& p, int n_split, int tiles_per_split, float* ws,
                             int* counters, cudaStream_t stream) {
  constexpr size_t smem = tc_decode_smem<HD>();
  cudaError_t err = launch::opt_in_smem<&flash_tc_decode_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  if ((p.H / p.Hkv) * p.Tq > 16 || n_split < 1 || tiles_per_split < 1 ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid(n_split, p.Hkv, p.B);
  flash_tc_decode_kernel<HD><<<grid, kTcThreads, smem, stream>>>(p, tiles_per_split, ws,
                                                                  counters);
  return cudaGetLastError();
}

struct Launch {
  int variant;  // 0: FMA, 1: tensor-core prefill tile, 2: tensor-core decode tile
  int n_split, tiles_per_split;
  float* ws;
  int* counters;
};

template <typename T, int HD>
cudaError_t dispatch_variant(const Params& p, const Launch& L, cudaStream_t stream) {
  if (L.variant == 0)
    return p.Tq <= 16 ? launch_fma<T, HD, 16>(p, stream) : launch_fma<T, HD, 64>(p, stream);
  if constexpr (std::is_same_v<T, bf16>) {
    if (p.sq.d != 1 || p.sk.d != 1 || p.sv.d != 1 || p.so.d != 1) return cudaErrorInvalidValue;
    if (L.variant == 1) return launch_tc_prefill<HD>(p, stream);
    if (L.variant == 2)
      return launch_tc_decode<HD>(p, L.n_split, L.tiles_per_split, L.ws, L.counters, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Params& p, const Launch& L, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_variant<T, 32>(p, L, stream);
    case 64: return dispatch_variant<T, 64>(p, L, stream);
    case 128: return dispatch_variant<T, 128>(p, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Tq, H, hd); k, v: (B, Tk, Hkv, hd); o: (B, Tq, H, hd), all of one
// dtype (0: f32, 1: bf16), addressed through `strides`: 16 element strides,
// (b, t, h, d) for q, k, v, o in that order.  `variant` 0 runs the FMA
// kernel (any dtype, any strides); 1 and 2 the bf16 tensor-core prefill and
// decode tiles, which need d-strides of 1 and 16-byte aligned rows (the
// caller checks the alignment).  The decode tile splits the kv tiles into
// `n_split` runs of `tiles_per_split`; with n_split > 1 it needs `ws`, B *
// Hkv * n_split * 16 * (hd + 2) floats, and `counters`, B * Hkv ints that are
// 0 and are left 0.  Launches on `stream` and returns cudaGetLastError() (0
// on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int dtype, int B, int Tq, int Tk, int H, int Hkv,
                                         int hd, const int64_t* strides, int causal,
                                         int window, float sm_scale, int variant, int n_split,
                                         int tiles_per_split, void* ws, void* counters,
                                         void* stream) {
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
  const Launch L{variant, n_split, tiles_per_split, static_cast<float*>(ws),
                 static_cast<int*>(counters)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_hd<float>(hd, p, L, s));
    case 1: return static_cast<int>(dispatch_hd<bf16>(hd, p, L, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
