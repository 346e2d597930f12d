// Flash attention for Hopper (sm_90a), hand-written CUDA C++: the forward,
// and its backward (at the end of this file).
//
// The forward replaces the Pallas TPU kernel `_flash_kernel` /
// `flash_attention` of src/repro/kernels/flash_attention.py and computes
// what it computes:
// online-softmax attention over (B, T, H, hd) with the running max m, sum l
// and accumulator kept in f32 for f32 and bf16 inputs, scale 1/sqrt(hd),
// causal masking aligned top-left (query i sees keys j <= i), an optional
// sliding window (keys j > i - window), the `kpos < seq_len` pad mask, and
// masked scores set to the finite -1e30 after scaling (never -inf), so a row
// with no valid key in a tile gives no NaN, and a row that sees no key at
// all averages V over its Tk keys, as softmax over the plain version's
// -1e30 does (the pad keys of the last tile, past Tk, score -inf and add
// nothing); l is floored at 1e-30.  The output is written in q's dtype.
// With `lse` the FMA and prefill kernels also write each row's
// log-sum-exp, m + log l in natural-log units of the scaled, masked scores
// (f32, (B, H, Tq); -1e30 for a row that sees no key), for the backward;
// the output is the same bits with or without it.  The prefill tile keeps m
// in log2 units (exp2f) and converts once, at the store: (m + log2 l) ln 2.  Every (B, T, H, hd) stride is taken as
// given, so a decode step attends over a view `cache[:, :pos+1]` without a
// copy, and the KV head of query head h is h / (H / Hkv): grouped-query
// attention reads the un-repeated cache.
//
// Per-row key lengths (`kv_lens`, for serving from a slotted cache: a
// decode tick over rows at different positions, a prefill chunk appended
// to a row's prefix; no backward takes them).  Row b then attends to keys
// [0, kv_lens[b]) and its query i sits at kv_lens[b] - Tq + i, so causal is
// aligned bottom-right on the row's prefix and the window counts from
// there (JAX's slot-mode mask once the new keys sit in the cache).  Every
// variant reads the lengths on the device (`row_span`), skips the tiles
// past a row's length and, under a window, those before it; the decode
// tile's split is still planned from the static Tk, so a row's bits do not
// depend on the other rows' lengths.  Without kv_lens each kernel runs as
// before, to the bit.
//
// An explicit query start (`q_mode` 1: one host int `q_off` for every row,
// as a hop of the windowed context ring passes; 2: `q_start`, B int32 on
// the device, as the context-parallel prefill chunk's cache partial
// passes): query i of row b sits at q_start[b] + i, key t is kept iff t <
// kv_lens[b] (Tk without kv_lens), then t <= qpos when causal, then t >
// qpos - window.  The two alignments above are q_start = 0 and q_start =
// kv_lens - Tq.  A row may then see no key at all (a past block wholly left
// of the window, an empty cache): it writes out 0 and lse -inf, so a merge
// of partial softmaxes weighs it by exp(-inf) = 0.  The tiles wholly left
// of the window and past the causal diagonal are skipped; a launch without
// a query start keeps its bits.  The backward takes the host int (`q_off`),
// and a row that sees no key has P = 0 there.
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
//
// The backward has no TPU kernel: JAX differentiates
// src/repro/models/layers.py:160 (`attention`), whose Pallas forward has no
// VJP.  So it is written from the algorithm (FlashAttention-2's): given q,
// k, v, o, dO and the forward's lse, P = exp(S - lse) is recomputed tile by
// tile, never stored, and
//   D = rowsum(dO o O)   (O as stored, in its own dtype),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),
// with the forward's masks; a pair the masks drop has dS = 0, and a row
// that sees no key has P = 1/Tk on every key (the gradient of the forward's
// average under the -1e30 mask, which autograd of the plain version gives).
// Three kernels, each output written by one block in a fixed order, so two
// launches on the same inputs give the same bits (no atomics):
// (a) D, one warp a row (hd / 8 threads a row on the bf16 path); (b) dK
// and dV, one block per (b, hkv, key tile of 64), which walks the H / Hkv
// query heads of its KV head and their query tiles from the causal
// diagonal on, so GQA's sum over heads stays in registers; the key tiles
// launch first to last, the first seeing the most rows under the causal
// mask; (c) dQ, one block per (b, h, query tile), the last (heaviest)
// first.  S and dP are computed twice, once in (b) and
// once in (c): seven products of 2 hd FLOPs a kept pair instead of five,
// the price of no atomics.  f32 inputs, and bf16 rows that cannot take
// 16-byte copies, run FMA kernels over tiles staged as f32.
//
// The bf16 variant runs every product on wgmma (Hopper's warpgroup MMA),
// FlashAttention-3's arrangement.  A block is one warpgroup (the tiles are
// `WgBwdTiles`, templates timed by kernels/tune.py); it owns 64 keys in (b)
// and 64 query rows in (c), keeps K and V (or Q and dO) in shared memory,
// and streams Q and dO (or K and V) in tiles of 64 rows through a ring of
// 3-4 stages filled by TMA from one thread, each stage an mbarrier; lse and
// D come by 4-byte cp.async.  Every tile sits in the 128-byte-swizzled
// layout wgmma reads either way: K-major as the B of S^T = K Q^T and dP^T =
// V dO^T (both operands from shared memory), MN-major as the B of dV +=
// P^T dO and dK += dS^T Q, whose A is P and dS rounded to bf16 straight
// from the accumulator registers.  So each streamed tile is read from
// shared memory once a warpgroup for each product, and no product goes
// through ldmatrix.  (c) splits dS into a bf16 high part and the bf16 rest
// and runs dQ = hi K + lo K: a row's dS sums to 0, and that cancellation
// magnified a single bf16 rounding of dS past FlashAttention-2's error rule
// on small rows.  The walk is software-pipelined: once P and dS of a tile
// are packed, the products of the next tile are issued with the dK, dV (or
// dQ) products of this one, and the block barrier, which frees a stage for
// the next copy, and the copy itself run while they do.  Three things keep
// ptxas from serializing the wgmmas: no branch around one that it cannot
// prove uniform over the warpgroup (a warpgroup computes a fully masked
// tile rather than skip it), no plain instruction writing a register that
// an in-flight wgmma accumulates into (P and dS are packed, never written
// back into S and dP; the accumulators are zeroed before the first issue),
// and matrix descriptors built once and moved by an add.
//
// Bound of the backward at Llama-3.2-1B's training shape (bf16, B 4, T
// 2048, H 32/8, hd 64, causal): 10 hd FLOPs a kept pair (five products),
// 172 GFLOP, take 0.174 ms at 989 TFLOP/s; its ~170 MB (q, k, v, o, dO read
// once, dq, dk, dv written once) take 0.05 ms at 3.35 TB/s.  It is bound by
// operations.  What is still left (PERF.md): the two recomputed products
// and dQ's second (lo) product, nine products of the five's work; each
// warpgroup runs its P and dS (32 exp2 a thread a tile) while its own
// tensor work waits, so the overlap comes only from the 2 (b) or 3 (c)
// blocks an SM that registers allow; the products are m64n64 and short
// chains; five products need dQ summed across key tiles, by atomics (not
// the same bits on a repeat launch) or an ordered sum; a producer warp with
// setmaxnreg and two consumer warpgroups in ping-pong, as FlashAttention-3
// does, would hide the exp2 and the barrier.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // keys per kv tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// The score of a pair the masks drop: the finite -1e30 for a key of the
// sequence, as the plain version's mask, and -inf for a pad key past Tk, so
// a row that sees no key averages V over its Tk keys (softmax over -1e30)
// and the pad keys of the last tile add nothing to its sum.
__device__ __forceinline__ float masked_score(int kpos, int Tk) {
  return kpos < Tk ? kNegInf : -INFINITY;
}

// log(sum_j exp(s_j)) of a row from its running max m (in the units of the
// scores) and sum l of exp(s - m); a row that saw no key keeps m = -1e30,
// and its lse is -1e30 too (m + log(l) rounds to it in f32).
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == kNegInf ? kNegInf : m + logf(l);
}

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
  float* lse;  // (B, H, Tq) log-sum-exp of each row, or null (no gradient wanted)
  const int* kv_lens;  // (B,) keys of each row, or null (every row keeps Tk)
  Strides sq, sk, sv, so;
  int B, Tq, Tk, H, Hkv;
  int causal, window;
  float sm_scale;
  int q_mode = 0;                // 0: row_span's alignment; 1: q_off; 2: q_start[b]
  int q_off = 0;                 // every row's first query position (q_mode 1)
  const int* q_start = nullptr;  // (B,) each row's first query position (q_mode 2)
};

// The keys row b attends to and the absolute position of its first query.
// Without kv_lens every row keeps its Tk keys and query i sits at i (causal
// aligned top-left).  With kv_lens row b keeps keys [0, kv_lens[b]) and
// query i sits at kv_lens[b] - Tq + i: causal aligned bottom-right on the
// row's prefix, as a slotted cache's rows at their own positions need.  The
// length is read on the device (no host sync) and cut to [0, Tk], so a bad
// one cannot read past the tensor; without a query start the wrapper
// documents Tq <= kv_lens <= Tk.  An explicit query start (q_mode 1 or 2)
// puts query i at q_start + i whatever the lengths.
struct RowSpan {
  int tk, qoff;
};

__device__ __forceinline__ RowSpan row_span(const Params& p, int b) {
  const int tk = p.kv_lens == nullptr ? p.Tk : max(0, min(p.kv_lens[b], p.Tk));
  if (p.q_mode == 1) return {tk, p.q_off};
  if (p.q_mode == 2) return {tk, p.q_start[b]};
  return {tk, p.kv_lens == nullptr ? 0 : tk - p.Tq};
}

// The first kv tile of `bk` keys that a query at absolute position `qpos` or
// later can see under the window.  Tiles before it are wholly masked and
// skipped; that is done only with kv_lens or a query start, so the bits of
// a launch with neither stay as they were (a skipped tile would add
// exp(-1e30 - m) = 0).
__device__ __forceinline__ int first_tile(const Params& p, int qpos, int bk) {
  if ((p.kv_lens == nullptr && p.q_mode == 0) || p.window <= 0) return 0;
  return max(0, qpos - p.window + 1) / bk;
}

// The end of the keys rows [qpos, qpos + n) can see: under the causal mask
// none past the last row's position (none at all when it is negative).
__device__ __forceinline__ int kv_end_of(const Params& p, const RowSpan& rs, int qpos, int n) {
  return p.causal ? max(0, min(rs.tk, qpos + n)) : rs.tk;
}

// A row that saw no key under an explicit query start writes out 0 and lse
// -inf (its running max stayed at the -1e30 it started from).
__device__ __forceinline__ bool dead_row(const Params& p, float m) {
  return p.q_mode != 0 && m == kNegInf;
}

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
  const RowSpan rs = row_span(p, b);

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
  const int kv_end = kv_end_of(p, rs, rs.qoff + q0, BQ);
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int tile = first_tile(p, rs.qoff + q0, kBK); tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's reads of Ks / Vs / Ss are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD, t = k0 + r;
      const bool ok = t < rs.tk;
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
          const int qpos = rs.qoff + q0 + r, kpos = k0 + c;
          bool ok = kpos < rs.tk;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          Ss[r * SS + c] = ok ? s[i][j] : masked_score(kpos, rs.tk);
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

  __syncthreads();  // row_m and row_l are final (a row may have run no tile)
  const int t = q0 + ar;
  if (t < p.Tq) {  // padded query rows are dropped
    const bool dead = dead_row(p, row_m[ar]);
    const float l = fmaxf(row_l[ar], 1e-30f);
    T* og = static_cast<T*>(p.o) + b * p.so.b + t * p.so.t + h * p.so.h;
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      store(og + (ac0 + TPR * j) * p.so.d, dead ? 0.f : acc[j] / l);
    if (p.lse != nullptr && ac0 == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Tq + t] =
          dead ? -INFINITY : row_lse(row_m[ar], row_l[ar]);
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
        if (!ok) x = masked_score(kpos, Tk);
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
  const RowSpan rs = row_span(p, b);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h;

  const int kv_end = kv_end_of(p, rs, rs.qoff + q0, BQ);
  const int n_tiles = (kv_end + kTcBK - 1) / kTcBK;
  const int tile_lo = first_tile(p, rs.qoff + q0, kTcBK);
  auto load_tile = [&](int tile) {
    const int stage = tile % S;
    load_rows<HD, kTcThreads>(ks + stage * kTcBK * LD, kg, p.sk.t, tile * kTcBK, kTcBK, rs.tk);
    load_rows<HD, kTcThreads>(vs + stage * kTcBK * LD, vg, p.sv.t, tile * kTcBK, kTcBK, rs.tk);
  };
  load_rows<HD, kTcThreads>(qs, qg, p.sq.t, q0, BQ, p.Tq);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (tile_lo + i < n_tiles) load_tile(tile_lo + i);
    mma::cp_async_commit();
  }

  const float scale = p.sm_scale * kLog2e;
  const int row0 = warp * 16;  // the warp's first row in the q tile
  uint32_t qf[HD / 16][4];
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = tile_lo; tile < n_tiles; ++tile) {
    mma::cp_async_wait<S - 2>();  // this tile (and Q) have landed
    // all copies of this tile are visible, and every warp is done with the
    // previous tile, whose stage the next load refills: one barrier a tile
    __syncthreads();
    if (tile + S - 1 < n_tiles) load_tile(tile + S - 1);
    mma::cp_async_commit();
    if (tile == tile_lo) load_q_frags<HD>(qf, qs, row0);
    const int k0 = tile * kTcBK;
    const bf16* kt = ks + (tile % S) * kTcBK * LD;
    const bf16* vt = vs + (tile % S) * kTcBK * LD;
    float s[NB][4];
    qk<HD, NB>(s, qf, kt, 0);
    const bool need_mask = (p.causal && k0 + kTcBK - 1 > rs.qoff + q0) || k0 + kTcBK > rs.tk ||
                           p.window > 0;
    const int qpos = rs.qoff + q0 + row0 + g;
    scale_mask<NB>(s, scale, need_mask, rs.tk, p.causal, p.window, qpos, qpos + 8, k0);
    online_softmax<NB, NO>(s, o, m, l);
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) pv_step<HD, NB>(o, s, kk, vt, kk * 16);
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lsum = l[i];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const bool dead = dead_row(p, m[i]);
    const float li = dead ? 0.f : 1.f / fmaxf(lsum, 1e-30f);
    const int qrow = q0 + row0 + g + 8 * i;
    if (qrow >= p.Tq) continue;  // padded query rows are dropped
    // m is in log2 units here: the row's lse in natural-log units is
    // (m + log2 l) ln 2, converted once, at the store
    if (p.lse != nullptr && t == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Tq + qrow] =
          dead ? -INFINITY : m[i] == kNegInf ? kNegInf : (m[i] + log2f(lsum)) * kLn2;
    bf16* og = static_cast<bf16*>(p.o) + b * p.so.b + qrow * p.so.t + h * p.so.h;
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
  const RowSpan rs = row_span(p, b);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h;

  // The split runs are planned on the host from the static Tk, so a row's
  // bits do not depend on the other rows' lengths; this row's run is the
  // split's tiles cut to the tiles the row sees.  A run left empty still
  // writes its partial (m = -1e30, l = 0, o = 0) and arrives on the count.
  const int kv_end = kv_end_of(p, rs, rs.qoff, p.Tq);
  const int n_tiles = (kv_end + kTcBK - 1) / kTcBK;
  const int tile0 = max(split * tiles_per_split, first_tile(p, rs.qoff, kTcBK));
  const int tile1 = min(n_tiles, split * tiles_per_split + tiles_per_split);
  auto load_tile = [&](int tile) {
    const int stage = (tile - tile0) % S;
    load_rows<HD, kTcThreads>(ks + stage * kTcBK * LD, kg, p.sk.t, tile * kTcBK, kTcBK, rs.tk);
    load_rows<HD, kTcThreads>(vs + stage * kTcBK * LD, vg, p.sv.t, tile * kTcBK, kTcBK, rs.tk);
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
  const int qpos_lo = rs.qoff + g % p.Tq, qpos_hi = rs.qoff + (g + 8) % p.Tq;
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
    const bool need_mask = p.causal || p.window > 0 || k0 + kTcBK > rs.tk;
    scale_mask<2>(s, scale, need_mask, rs.tk, p.causal, p.window, qpos_lo, qpos_hi,
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
      if (r < rows)
        out_ptr(r)[c] = __float2bfloat16(dead_row(p, mx) ? 0.f : acc / fmaxf(lsum, 1e-30f));
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
    out_ptr(r)[c] = __float2bfloat16(dead_row(p, mx) ? 0.f : acc / fmaxf(lsum, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // (B, H, Tq), from the forward
  float* delta;      // (B, H, Tq): D = rowsum(dO o O), written by the first kernel
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, Tq, Tk, H, Hkv;
  int causal, window;
  int dead_lo;  // the first query row that sees no key (Tq when every row sees one)
  float sm_scale;
  float inv_tk;  // 1 / Tk
  int q_off = 0;  // query row i sits at position q_off + i (an explicit query start)
};

// The masks of the forward for one (query row, key) pair of the sequence.
__device__ __forceinline__ bool keeps(const BwdParams& p, int row, int kpos) {
  const int qpos = row + p.q_off;
  bool ok = row < p.Tq && kpos < p.Tk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// P of a pair the masks drop: 1/Tk on every key of a row that sees none
// (the forward's softmax over the finite -1e30 gives such a row uniform
// weights), 0 elsewhere.  Under a query start dead_lo is Tq: such a row's
// output is 0, so its P is 0 too.
__device__ __forceinline__ float dropped_p(const BwdParams& p, int row, int kpos) {
  return row >= p.dead_lo && row < p.Tq && kpos < p.Tk ? p.inv_tk : 0.f;
}

// (a) D = rowsum(dO o O) in f32, from O as stored: one warp per (b, h, t) row.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(BwdParams p, int hd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp;
  if (row >= static_cast<int64_t>(p.B) * p.H * p.Tq) return;
  const int t = static_cast<int>(row % p.Tq);
  const int bh = static_cast<int>(row / p.Tq);
  const int h = bh % p.H, b = bh / p.H;
  const T* og = static_cast<const T*>(p.o) + b * p.so.b + t * p.so.t + h * p.so.h;
  const T* dg = static_cast<const T*>(p.dout) + b * p.sdo.b + t * p.sdo.t + h * p.sdo.h;
  float sum = 0.f;
  for (int c = lane; c < hd; c += 32) sum += to_f32(og[c * p.so.d]) * to_f32(dg[c * p.sdo.d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[row] = sum;
}

// (a) for the bf16 tensor-core path, whose rows are 16-byte aligned with
// d-stride 1: HD / 8 threads a row, 16 bytes of O and of dO each.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_tc_kernel(BwdParams p) {
  constexpr int TPR = HD / 8, RPB = kThreads / TPR;  // threads a row, rows a block
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Tq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * RPB + threadIdx.x / TPR;
  float sum = 0.f;
  if (row < rows) {
    const int t = static_cast<int>(row % p.Tq), bh = static_cast<int>(row / p.Tq);
    const int h = bh % p.H, b = bh / p.H, c = (threadIdx.x % TPR) * 8;
    const uint4 o = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.o) + b * p.so.b +
                                                    t * p.so.t + h * p.so.h + c);
    const uint4 d = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.dout) +
                                                    b * p.sdo.b + t * p.sdo.t + h * p.sdo.h + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), g = __bfloat1622float2(d2[i]);
      sum = fmaf(a.x, g.x, fmaf(a.y, g.y, sum));
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && threadIdx.x % TPR == 0) p.delta[row] = sum;
}

// The query rows [q_lo, q_hi) whose P against the keys [k0, k0 + bk) can be
// non-zero: from position k0 under the causal mask, below position k0 + bk
// - 1 + window under the window (rows sit at q_off + their index), and
// every row down to Tq when some rows see no key (they weigh every key by
// 1/Tk).
__device__ __forceinline__ void kv_tile_rows(const BwdParams& p, int k0, int bk, int& q_lo,
                                             int& q_hi) {
  q_lo = p.causal ? min(max(k0 - p.q_off, 0), p.Tq) : 0;
  q_hi = p.window > 0 && p.dead_lo >= p.Tq
             ? min(p.Tq, max(0, k0 + bk - 1 + p.window - p.q_off))
             : p.Tq;
  q_hi = max(q_hi, q_lo);
}

// The kv tiles [tile0, tile1) of width bk that rows [q0, q0 + bq) see.
__device__ __forceinline__ void q_tile_keys(const BwdParams& p, int q0, int bq, int bk,
                                            int& tile0, int& tile1) {
  const int qa = q0 + p.q_off;  // the rows' first position
  const int kv_lo = p.window > 0 ? max(0, qa - p.window + 1) : 0;
  const int kv_hi = p.causal ? max(0, min(p.Tk, qa + bq)) : p.Tk;
  tile0 = min(kv_lo, kv_hi) / bk;
  tile1 = (kv_hi + bk - 1) / bk;
}

// FMA backward (f32 inputs, and bf16 rows that cannot take 16-byte copies):
// query tiles of kFBQ rows against key tiles of kFBK keys, staged as f32 in
// shared memory with rows padded by one float.
constexpr int kFBQ = 32;
constexpr int kFBK = 64;

template <int HD>
constexpr size_t fma_bwd_smem() {
  return sizeof(float) *
         (2 * kFBK * (HD + 1) + 2 * kFBQ * (HD + 1) + 2 * kFBK * (kFBQ + 1) + 2 * kFBQ);
}

template <typename T, int HD>
__device__ __forceinline__ void stage_rows_f32(float* dst, const T* src, Strides s, int r0, int n,
                                               int t_end) {
  for (int i = threadIdx.x; i < n * HD; i += kThreads) {
    const int r = i / HD, c = i % HD, t = r0 + r;
    dst[r * (HD + 1) + c] = t < t_end ? to_f32(src[t * s.t + c * s.d]) : 0.f;
  }
}

// (b) dK, dV on the FMA pipes: one block per (hkv, b, key tile of kFBK); it
// walks the H / Hkv query heads of its KV head and their query tiles and
// sums dV += P^T dO and dK += dS^T Q in registers (thread: key row tid / 4,
// columns tid % 4 + 4 j), so GQA's sum over heads needs no atomics.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_fma_kernel(BwdParams p) {
  constexpr int LH = HD + 1, LP = kFBQ + 1, NA = HD / 4;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kFBK * LH;
  float* Qs = Vs + kFBK * LH;
  float* dOs = Qs + kFBQ * LH;
  float* Ps = dOs + kFBQ * LH;   // P^T: kFBK x kFBQ
  float* dSs = Ps + kFBK * LP;   // dS^T
  float* ls = dSs + kFBK * LP;   // lse of the tile's rows
  float* ds = ls + kFBQ;         // D of the tile's rows

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kFBK;
  const int rep = p.H / p.Hkv;
  stage_rows_f32<T, HD>(Ks, static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h, p.sk, k0,
                        kFBK, p.Tk);
  stage_rows_f32<T, HD>(Vs, static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h, p.sv, k0,
                        kFBK, p.Tk);
  int q_lo, q_hi;
  kv_tile_rows(p, k0, kFBK, q_lo, q_hi);
  const int qt0 = q_lo / kFBQ, qt1 = (q_hi + kFBQ - 1) / kFBQ;

  const int kr = tid / 4, c0 = tid % 4;  // S^T rows and columns c0 + 4 j; dK, dV rows
  const int kpos = k0 + kr;
  float dk[NA], dv[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) dk[j] = dv[j] = 0.f;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* dog = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.Tq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kFBQ;
      __syncthreads();  // the previous tile's reads are done
      stage_rows_f32<T, HD>(Qs, qg, p.sq, q0, kFBQ, p.Tq);
      stage_rows_f32<T, HD>(dOs, dog, p.sdo, q0, kFBQ, p.Tq);
      for (int i = tid; i < kFBQ; i += kThreads) {
        const bool ok = q0 + i < p.Tq;
        ls[i] = ok ? p.lse[row0 + q0 + i] : 0.f;
        ds[i] = ok ? p.delta[row0 + q0 + i] : 0.f;
      }
      __syncthreads();
      float s[kFBQ / 4], dp[kFBQ / 4];
#pragma unroll
      for (int j = 0; j < kFBQ / 4; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float kv = Ks[kr * LH + d], vv = Vs[kr * LH + d];
#pragma unroll
        for (int j = 0; j < kFBQ / 4; ++j) {
          s[j] = fmaf(kv, Qs[(c0 + 4 * j) * LH + d], s[j]);
          dp[j] = fmaf(vv, dOs[(c0 + 4 * j) * LH + d], dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kFBQ / 4; ++j) {
        const int c = c0 + 4 * j, qpos = q0 + c;
        const bool ok = keeps(p, qpos, kpos);
        const float pv = ok ? __expf(s[j] * p.sm_scale - ls[c]) : dropped_p(p, qpos, kpos);
        Ps[kr * LP + c] = pv;
        dSs[kr * LP + c] = ok ? pv * (dp[j] - ds[c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kFBQ; ++c) {
        const float pv = Ps[kr * LP + c], dsv = dSs[kr * LP + c];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
          dv[j] = fmaf(pv, dOs[c * LH + c0 + 4 * j], dv[j]);
          dk[j] = fmaf(dsv, Qs[c * LH + c0 + 4 * j], dk[j]);
        }
      }
    }
  }
  if (kpos < p.Tk) {
    T* dkg = static_cast<T*>(p.dk) + b * p.sdk.b + kpos * p.sdk.t + hk * p.sdk.h;
    T* dvg = static_cast<T*>(p.dv) + b * p.sdv.b + kpos * p.sdv.t + hk * p.sdv.h;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      store(dkg + (c0 + 4 * j) * p.sdk.d, dk[j] * p.sm_scale);
      store(dvg + (c0 + 4 * j) * p.sdv.d, dv[j]);
    }
  }
}

// (c) dQ on the FMA pipes: one block per (h, b, query tile of kFBQ), last
// (heaviest under the causal mask) first; it walks the key tiles its rows
// see and sums dQ += dS K in registers (thread: row tid / 8, columns
// tid % 8 + 8 j).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_q_fma_kernel(BwdParams p) {
  constexpr int LH = HD + 1, LS = kFBK + 1, NA = HD / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kFBK * LH;
  float* Qs = Vs + kFBK * LH;
  float* dOs = Qs + kFBQ * LH;
  float* dSs = dOs + kFBQ * LH;  // kFBQ x kFBK

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFBQ;
  const int hk = h / (p.H / p.Hkv);
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + hk * p.sv.h;
  stage_rows_f32<T, HD>(Qs, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq, q0, kFBQ,
                        p.Tq);
  stage_rows_f32<T, HD>(dOs, static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h, p.sdo,
                        q0, kFBQ, p.Tq);
  const int qr = tid / 8, c0 = tid % 8;  // S rows and key columns c0 + 8 j; dQ rows
  const int qpos = q0 + qr;
  const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.Tq + qpos;
  const float lse = qpos < p.Tq ? p.lse[row] : 0.f;
  const float dl = qpos < p.Tq ? p.delta[row] : 0.f;
  float acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;
  int tile0, tile1;
  q_tile_keys(p, q0, kFBQ, kFBK, tile0, tile1);

  for (int tile = tile0; tile < tile1; ++tile) {
    const int k0 = tile * kFBK;
    __syncthreads();
    stage_rows_f32<T, HD>(Ks, kg, p.sk, k0, kFBK, p.Tk);
    stage_rows_f32<T, HD>(Vs, vg, p.sv, k0, kFBK, p.Tk);
    __syncthreads();
    float s[kFBK / 8], dp[kFBK / 8];
#pragma unroll
    for (int j = 0; j < kFBK / 8; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qv = Qs[qr * LH + d], ov = dOs[qr * LH + d];
#pragma unroll
      for (int j = 0; j < kFBK / 8; ++j) {
        s[j] = fmaf(qv, Ks[(c0 + 8 * j) * LH + d], s[j]);
        dp[j] = fmaf(ov, Vs[(c0 + 8 * j) * LH + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kFBK / 8; ++j) {
      const int c = c0 + 8 * j;
      const bool ok = keeps(p, qpos, k0 + c);
      dSs[qr * LS + c] = ok ? __expf(s[j] * p.sm_scale - lse) * (dp[j] - dl) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kFBK; ++c) {
      const float dsv = dSs[qr * LS + c];
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[j] = fmaf(dsv, Ks[c * LH + c0 + 8 * j], acc[j]);
    }
  }
  if (qpos < p.Tq) {
    T* dqg = static_cast<T*>(p.dq) + b * p.sdq.b + qpos * p.sdq.t + h * p.sdq.h;
#pragma unroll
    for (int j = 0; j < NA; ++j) store(dqg + (c0 + 8 * j) * p.sdq.d, acc[j] * p.sm_scale);
  }
}

// bf16 backward on wgmma.  Q, dO, K and V tiles live in shared memory in
// the 128-byte-swizzled layout (mma_bf16.cuh) that wgmma reads both ways: a
// tile of R rows is HS / 64 atoms of R rows x 64 columns (HS = hd, or 64 for
// hd 32, whose columns past 32 are zero-filled and add nothing), the chunk
// of 8 columns c of row r at chunk c ^ (r % 8) of its row.  Read K-major,
// its rows are the M or N of a product over hd (S^T = K Q^T, S = Q K^T);
// read MN-major, its rows are the contraction and hd the N (dV += P^T dO,
// dK += dS^T Q, dQ += dS K).  So each streamed tile feeds two products and
// is read once a warpgroup for each.
constexpr int kWgRows = 64;  // rows of one warpgroup's wgmma tile (M)
constexpr int kWgBwdBQ = 64;  // query rows a streamed tile of the dK/dV kernel

template <int HD>
__host__ __device__ constexpr int sw_cols() { return HD < 64 ? 64 : HD; }

// Element offset of (r, c) in a swizzled tile of R rows; c a multiple of 8.
__device__ __forceinline__ int sw_off(int r, int c, int R) {
  return (c / 64) * R * 64 + r * 64 + ((((c % 64) / 8) ^ (r & 7)) * 8);
}

// Rows [r0, r0 + R) of one (b, head) of a bf16 (B, T, H, hd) tensor with
// d-stride 1 into a swizzled tile of HS columns, by cp.async (the tiles a
// block keeps; the streamed ones come by TMA); rows past `t_end` and
// columns past HD are zero.  Each of the NT threads copies the same number
// of 16-byte chunks, so the loop has a constant trip count.
template <int HD, int R, int NT>
__device__ __forceinline__ void load_sw(bf16* dst, const bf16* src, int64_t t_stride, int r0,
                                        int t_end) {
  constexpr int CH = sw_cols<HD>() / 8, N = R * CH / NT;
  static_assert(R * CH % NT == 0, "every thread copies N chunks");
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = threadIdx.x + k * NT;
    const int r = i / CH, c = (i % CH) * 8, t = r0 + r;
    const bool ok = t < t_end && c < HD;
    mma::cp_async16(dst + sw_off(r, c, R), ok ? src + t * t_stride + c : src, ok);
  }
}

// Matrix descriptors are built once a kernel, at element 0 of a tile
// (mma_bf16.cuh: sw128_desc), and moved by adding an element offset (a
// multiple of 8) to the start-address field, in 16-byte units.
__device__ __forceinline__ uint64_t desc_plus(uint64_t d, int elems) {
  return d + static_cast<uint64_t>(elems >> 3);
}
// A tile of R rows read K-major (the LBO is unused): its descriptor at
// element 0, and the offset of k-step j (hd columns 16 j .. 16 j + 15).
__device__ __forceinline__ uint64_t desc_kmajor(const bf16* tile) {
  return mma::sw128_desc(tile, 16, 1024);
}
template <int R>
__host__ __device__ constexpr int kstep_k(int j) { return (j / 4) * R * 64 + (j % 4) * 16; }
// Read MN-major: N runs over its columns, 64-column atoms R * 128 bytes
// apart; k-step j is rows 16 j .. 16 j + 15, at element offset 1024 j.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const bf16* tile) {
  return mma::sw128_desc(tile, R * 128, 1024);
}

// 2^x on the special-function unit (one instruction; ~2 ulp, denormal
// results flushed to 0): P of the backward, rounded to bf16 for its products.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P and dS of n8 tile j of the dK/dV kernel's S^T and dP^T accumulators
// (keys x query rows), straight into the bf16 A fragments: an instruction
// that writes a register wgmma accumulates into, inside the pipelined walk,
// makes ptxas serialize every wgmma of the kernel.  Columns are query rows
// (lse and D of column 8 j + 2 t + (e % 2)); n8 tile j is k-step j / 2 of
// the next products, fragment registers 2 (j % 2) and 2 (j % 2) + 1.
template <bool MASK, int NA>
__device__ __forceinline__ void kv_tile_pds(const BwdParams& p, const float (&st)[NA],
                                            const float (&dpt)[NA], uint32_t (&pa)[NA / 8][4],
                                            uint32_t (&dsa)[NA / 8][4], int j, const float* ls,
                                            const float* dl, float scale2, int q0, int krow) {
  const int t = threadIdx.x % 4;
  const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
  const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
  const float la = l2.x * kLog2e, lb = l2.y * kLog2e;
  float pv[4], ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    pv[e] = exp2_approx(fmaf(st[4 * j + e], scale2, -((e & 1) ? lb : la)));
    ds[e] = pv[e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
    if (MASK) {
      const int qpos = q0 + 8 * j + 2 * t + (e & 1), kpos = krow + 8 * (e >> 1);
      if (!keeps(p, qpos, kpos)) {
        pv[e] = dropped_p(p, qpos, kpos);
        ds[e] = 0.f;
      }
    }
  }
  pa[j / 2][2 * (j % 2)] = mma::pack_bf16(pv[0], pv[1]);
  pa[j / 2][2 * (j % 2) + 1] = mma::pack_bf16(pv[2], pv[3]);
  dsa[j / 2][2 * (j % 2)] = mma::pack_bf16(ds[0], ds[1]);
  dsa[j / 2][2 * (j % 2) + 1] = mma::pack_bf16(ds[2], ds[3]);
}

// dS of n8 tile j of the dQ kernel's S and dP accumulators (query rows x
// keys), straight into bf16 A fragments as above, split in two: dS rounded
// to bf16 (hi) and the rest, dS - hi, rounded again (lo).  dQ = hi K + lo K
// keeps dS to about 16 bits: a row's dS sums to 0 over its keys, and the
// cancellation in dS K magnifies the rounding of a single bf16 dS.
template <bool MASK, int NA>
__device__ __forceinline__ void q_tile_ds(const BwdParams& p, const float (&s)[NA],
                                          const float (&dp)[NA], uint32_t (&hi)[NA / 8][4],
                                          uint32_t (&lo)[NA / 8][4], int j,
                                          const float (&lse2)[2], const float (&dl)[2],
                                          float scale2, int qrow, int k0) {
  const int t = threadIdx.x % 4;
  float ds[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ds[e] = exp2_approx(fmaf(s[4 * j + e], scale2, -lse2[e >> 1])) * (dp[4 * j + e] - dl[e >> 1]);
    if (MASK && !keeps(p, qrow + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1))) ds[e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t h = mma::pack_bf16(ds[2 * i], ds[2 * i + 1]);
    const float2 hf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h));
    hi[j / 2][2 * (j % 2) + i] = h;
    lo[j / 2][2 * (j % 2) + i] = mma::pack_bf16(ds[2 * i] - hf.x, ds[2 * i + 1] - hf.y);
  }
}

// 4-byte async copy, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mma::smem_addr(dst)),
               "l"(src), "r"(n));
}

// The dynamic shared memory of a kernel whose tiles need 1024-byte alignment.
__device__ __forceinline__ bf16* smem_1024(unsigned char* raw) {
  return reinterpret_cast<bf16*>(raw + ((1024 - (mma::smem_addr(raw) & 1023)) & 1023));
}

// The tensor maps of the two tiles a walk streams (Q and dO for (b), K and
// V for (c)), passed as __grid_constant__ kernel parameters.
struct BwdMaps {
  CUtensorMap a, b;
};

// The tensor map of a bf16 (B, T, H, hd) tensor with element strides `s`
// (d-stride 1): boxes of 64 columns x `rows` rows of one (b, head), written
// 128-byte swizzled; columns past hd (hd 32) and rows past T are zero.
cudaError_t rows_map(CUtensorMap* map, const void* base, const Strides& s, int B, int T, int H,
                     int hd, int rows) {
  // a dimension of extent 1 is never stepped: any multiple of 16 bytes will do
  auto bytes = [](int64_t stride, int extent) {
    return static_cast<cuuint64_t>(extent > 1 ? stride * 2 : 16);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(s.t, T), bytes(s.h, H), bytes(s.b, B)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return launch::bf16_tensor_map(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// The tree's choices: warpgroups a block (each owns 64 keys of the dK/dV
// kernel, 64 query rows of the dQ kernel), ring stages, keys a streamed
// tile of the dQ kernel, and the blocks an SM the registers are capped
// for.  Both kernels are templates over these; kernels/tune.py times other
// choices at Llama-3.2-1B's training shape.
template <int HD>
struct WgBwdTiles {
  static constexpr int kv_wgs = 1, kv_stages = 4, kv_min_blocks = 1;
  static constexpr int q_wgs = 1, q_keys = 64, q_stages = 3, q_min_blocks = HD == 128 ? 1 : 3;
};

template <int HD, int NWG, int STAGES>
constexpr size_t wg_bwd_kv_smem() {
  constexpr int HS = sw_cols<HD>(), BQ = kWgBwdBQ;
  return 1024 + sizeof(bf16) * HS * (2 * kWgRows * NWG + 2 * STAGES * BQ) +
         sizeof(float) * 2 * STAGES * BQ;
}

// (b) dK, dV on wgmma: one block of NWG warpgroups per (hkv, b, key tile of
// 64 NWG), warpgroup w owning keys 64 w .. 64 w + 63, the key tiles launched
// first to last (the first sees the most query rows under the causal mask).
// K and V stay in shared memory; the block walks the H / Hkv query heads
// and their query tiles of 64 rows, Q and dO streaming through a
// STAGES-deep ring that one thread fills by TMA (lse and D by cp.async).
// Per tile and warpgroup: S^T = K Q^T and dP^T = V dO^T (SS, Q and dO read
// K-major); P = exp2(S^T scale log2 e - lse log2 e) and dS = P o (dP - D)
// from those accumulators into bf16 A fragments; then dV += P^T dO and dK
// += dS^T Q (RS, the same Q and dO tiles read MN-major).  The walk is
// software-pipelined: once P and dS of tile i are packed, the S^T and dP^T
// accumulators are free, so the products of tile i + 1 are issued with dV
// and dK of tile i, and the barrier and the next copies run while they do.
template <int HD, int NWG, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(128 * NWG, MIN_BLOCKS)
    flash_wg_bwd_kv_kernel(BwdParams p, const __grid_constant__ BwdMaps maps) {
  constexpr int HS = sw_cols<HD>(), BQ = kWgBwdBQ, BKV = kWgRows * NWG, NT = 128 * NWG;
  static_assert(STAGES >= 3 && NT >= 2 * BQ, "ring of a pipelined walk, lse and D copies");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = smem_1024(smem_raw);
  bf16* vs = ks + BKV * HS;
  bf16* ring = vs + BKV * HS;  // STAGES x (Q tile, dO tile)
  float* lse_s = reinterpret_cast<float*>(ring + STAGES * 2 * BQ * HS);
  float* del_s = lse_s + STAGES * BQ;
  __shared__ alignas(8) uint64_t full[STAGES];  // a stage's Q and dO tiles have landed

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int kw0 = k0 + kWgRows * wg;  // the warpgroup's first key
  const int rep = p.H / p.Hkv;
  int q_lo, q_hi;
  kv_tile_rows(p, k0, BKV, q_lo, q_hi);
  const int qt0 = q_lo / BQ, n_qt = (q_hi + BQ - 1) / BQ - qt0;
  const int n_iter = rep * n_qt;  // tile i: head hk rep + i / n_qt, query tile qt0 + i % n_qt

  auto first_row = [&](int i) { return (qt0 + i % n_qt) * BQ; };
  auto load_iter = [&](int i) {  // Q, dO by TMA; lse, D by cp.async
    const int stage = i % STAGES, h = hk * rep + i / n_qt, q0 = first_row(i);
    if (threadIdx.x == 0) {
      bf16* qs = ring + stage * 2 * BQ * HS;
      mma::mbar_expect_tx(&full[stage], 2 * BQ * HS * sizeof(bf16));
#pragma unroll
      for (int a = 0; a < HS / 64; ++a) {
        mma::tma_load_4d(qs + a * BQ * 64, &maps.a, 64 * a, q0, h, b, &full[stage]);
        mma::tma_load_4d(qs + BQ * HS + a * BQ * 64, &maps.b, 64 * a, q0, h, b, &full[stage]);
      }
    }
    if (threadIdx.x < 2 * BQ) {  // lse and D of the tile's rows
      const int r = threadIdx.x % BQ;
      const bool ok = q0 + r < p.Tq;
      const float* src = (threadIdx.x < BQ ? p.lse : p.delta) +
                         (static_cast<int64_t>(b) * p.H + h) * p.Tq;
      cp_async4((threadIdx.x < BQ ? lse_s : del_s) + stage * BQ + r, ok ? src + q0 + r : src,
                ok);
    }
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mma::mbar_init(&full[s], 1);
    mma::fence_mbar_init();
  }
  __syncthreads();
  load_sw<HD, BKV, NT>(ks, static_cast<const bf16*>(p.k) + b * p.sk.b + hk * p.sk.h, p.sk.t, k0,
                       p.Tk);
  load_sw<HD, BKV, NT>(vs, static_cast<const bf16*>(p.v) + b * p.sv.b + hk * p.sv.h, p.sv.t, k0,
                       p.Tk);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iter) load_iter(s);
    mma::cp_async_commit();
  }

  const float scale2 = p.sm_scale * kLog2e;
  const int krow = kw0 + 16 * warp + g;  // the key of a thread's accumulator rows: + 8 (e / 2)
  const uint64_t k_desc = desc_kmajor(ks + kWgRows * wg * 64);
  const uint64_t v_desc = desc_kmajor(vs + kWgRows * wg * 64);
  const uint64_t ring_k = desc_kmajor(ring), ring_mn = desc_mnmajor<BQ>(ring);
  float dk[HS / 2], dv[HS / 2];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) dk[i] = dv[i] = 0.f;
  // zeroed before the first wgmma is issued: ptxas serializes every wgmma
  // of a kernel in which another instruction writes an accumulator while
  // one is in flight, and the compiler would otherwise sink these below it
  mma::fence_acc(dk);
  mma::fence_acc(dv);
  float st[BQ / 2], dpt[BQ / 2];  // S^T, dP^T; each tile's first k-step ignores their values
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];  // P^T, dS^T as bf16 A fragments

  auto issue_s_dp = [&](int i) {  // S^T = K Q^T, dP^T = V dO^T: 64 keys x BQ rows
    const int q_off = (i % STAGES) * 2 * BQ * HS, do_off = q_off + BQ * HS;
#pragma unroll
    for (int j = 0; j < HS / 16; ++j)
      mma::wgmma_ss<BQ, 0>(st, desc_plus(k_desc, kstep_k<BKV>(j)),
                           desc_plus(ring_k, q_off + kstep_k<BQ>(j)), j > 0);
#pragma unroll
    for (int j = 0; j < HS / 16; ++j)
      mma::wgmma_ss<BQ, 0>(dpt, desc_plus(v_desc, kstep_k<BKV>(j)),
                           desc_plus(ring_k, do_off + kstep_k<BQ>(j)), j > 0);
  };

  if (n_iter > 0) {
    mma::cp_async_wait<STAGES - 2>();  // K, V and tile 0's lse and D have landed,
    mma::fence_proxy_async();         // K and V visible to wgmma,
    mma::mbar_wait(&full[0], 0);      // and tile 0's Q and dO
    __syncthreads();
    mma::wgmma_fence();
    issue_s_dp(0);
    mma::wgmma_commit();
  }
  // Every tile is computed by every warpgroup: a branch around a wgmma that
  // the compiler cannot prove uniform over the warpgroup serializes all of
  // them, and a warpgroup's keys past Tk or above the causal diagonal give
  // P = 0 and dS = 0 through the masks (P = 1/Tk for rows that see no key).
  for (int it = 0; it < n_iter; ++it) {
    mma::wgmma_wait<0>();  // S^T, dP^T of this tile; dV, dK of the previous one
    mma::fence_acc(st);
    mma::fence_acc(dpt);
    mma::fence_acc(dv);
    mma::fence_acc(dk);
    mma::fence_frags(pa);
    mma::fence_frags(dsa);
    const int stage = it % STAGES, q0 = first_row(it);
    {
      const float* ls = lse_s + stage * BQ;
      const float* dl = del_s + stage * BQ;
      const bool need_mask = q0 + BQ > p.Tq || kw0 + kWgRows > p.Tk || p.window > 0 ||
                             (p.causal && kw0 + kWgRows - 1 > q0 + p.q_off);
      // one branch a tile: the masks' code is a second copy of the loop
      if (!need_mask) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
          kv_tile_pds<false>(p, st, dpt, pa, dsa, j, ls, dl, scale2, q0, krow);
      } else {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
          kv_tile_pds<true>(p, st, dpt, pa, dsa, j, ls, dl, scale2, q0, krow);
      }
    }
    if (it + 1 < n_iter) {
      mma::cp_async_wait<STAGES - 3>();  // the next tile's lse and D
      mma::mbar_wait(&full[(it + 1) % STAGES], ((it + 1) / STAGES) & 1);  // and Q, dO
      // lse and D of the next tile are visible, and every warpgroup's
      // products of the previous tile, whose stage the next load refills,
      // are done (the wait above)
      __syncthreads();
      if (it + STAGES - 1 < n_iter) load_iter(it + STAGES - 1);
      mma::cp_async_commit();
    }
    mma::fence_frags(pa);
    mma::fence_frags(dsa);
    mma::fence_acc(dv);
    mma::fence_acc(dk);
    mma::wgmma_fence();
    {
      const int q_off = stage * 2 * BQ * HS, do_off = q_off + BQ * HS;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dV += P^T dO
        mma::wgmma_rs<HS, 1>(dv, pa[kk], desc_plus(ring_mn, do_off + 1024 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dS^T Q
        mma::wgmma_rs<HS, 1>(dk, dsa[kk], desc_plus(ring_mn, q_off + 1024 * kk), 1);
    }
    if (it + 1 < n_iter) issue_s_dp(it + 1);
    mma::wgmma_commit();
  }
  mma::wgmma_wait<0>();
  mma::fence_acc(dv);
  mma::fence_acc(dk);
  mma::fence_frags(pa);
  mma::fence_frags(dsa);
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = krow + 8 * i;
    if (kpos >= p.Tk) continue;  // pad keys are dropped
    bf16* dkg = static_cast<bf16*>(p.dk) + b * p.sdk.b + kpos * p.sdk.t + hk * p.sdk.h;
    bf16* dvg = static_cast<bf16*>(p.dv) + b * p.sdv.b + kpos * p.sdv.t + hk * p.sdv.h;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + j * 8 + 2 * t) = __floats2bfloat162_rn(
          dk[4 * j + 2 * i] * p.sm_scale, dk[4 * j + 2 * i + 1] * p.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

template <int HD, int NWG, int BK, int STAGES>
constexpr size_t wg_bwd_q_smem() {
  return 1024 + sizeof(bf16) * sw_cols<HD>() * (2 * kWgRows * NWG + 2 * STAGES * BK);
}

// (c) dQ on wgmma: one block of NWG warpgroups per (h, b, query tile of
// 64 NWG), warpgroup w owning rows 64 w .. 64 w + 63, the last (heaviest)
// tile first.  Q and dO stay in shared memory, K and V tiles of BK keys
// stream through a STAGES-deep ring filled by TMA; per tile and warpgroup S =
// Q K^T and dP = dO V^T (SS), dS = P o (dP - D) in the accumulators, then
// dQ += dS K (RS, K read MN-major), pipelined as in (b).
template <int HD, int NWG, int BK, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(128 * NWG, MIN_BLOCKS)
    flash_wg_bwd_q_kernel(BwdParams p, const __grid_constant__ BwdMaps maps) {
  static_assert(STAGES >= 3 && (BK == 64 || BK == 128), "ring of a pipelined walk, key tile");
  constexpr int HS = sw_cols<HD>(), BQB = kWgRows * NWG, NT = 128 * NWG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = smem_1024(smem_raw);
  bf16* dos = qs + BQB * HS;
  bf16* ring = dos + BQB * HS;  // STAGES x (K tile, V tile)
  __shared__ alignas(8) uint64_t full[STAGES];  // a stage's K and V tiles have landed

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQB;
  const int qw0 = q0 + kWgRows * wg;  // the warpgroup's first row
  const int hk = h / (p.H / p.Hkv);
  int tile0, tile1;
  q_tile_keys(p, q0, BQB, BK, tile0, tile1);
  const int n_tiles = max(0, tile1 - tile0);
  auto load_tile = [&](int i) {  // K, V by TMA, from one thread
    if (threadIdx.x != 0) return;
    const int stage = i % STAGES, kt0 = (tile0 + i) * BK;
    bf16* kt = ring + stage * 2 * BK * HS;
    mma::mbar_expect_tx(&full[stage], 2 * BK * HS * sizeof(bf16));
#pragma unroll
    for (int a = 0; a < HS / 64; ++a) {
      mma::tma_load_4d(kt + a * BK * 64, &maps.a, 64 * a, kt0, hk, b, &full[stage]);
      mma::tma_load_4d(kt + BK * HS + a * BK * 64, &maps.b, 64 * a, kt0, hk, b, &full[stage]);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mma::mbar_init(&full[s], 1);
    mma::fence_mbar_init();
  }
  __syncthreads();
  load_sw<HD, BQB, NT>(qs, static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.t, q0,
                       p.Tq);
  load_sw<HD, BQB, NT>(dos, static_cast<const bf16*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
                       p.sdo.t, q0, p.Tq);
  mma::cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < n_tiles) load_tile(s);

  const float scale2 = p.sm_scale * kLog2e;
  const int qrow = qw0 + 16 * warp + g;  // the row of a thread's accumulator rows: + 8 (e / 2)
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow + 8 * i;
    const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.Tq + qpos;
    lse2[i] = qpos < p.Tq ? p.lse[row] * kLog2e : 0.f;
    dl[i] = qpos < p.Tq ? p.delta[row] : 0.f;
  }
  const uint64_t q_desc = desc_kmajor(qs + kWgRows * wg * 64);
  const uint64_t do_desc = desc_kmajor(dos + kWgRows * wg * 64);
  const uint64_t ring_k = desc_kmajor(ring), ring_mn = desc_mnmajor<BK>(ring);
  float dq[HS / 2];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) dq[i] = 0.f;
  mma::fence_acc(dq);  // before the first wgmma, as in (b)
  float s[BK / 2], dp[BK / 2];  // each tile's first k-step ignores their values
  uint32_t dsa[BK / 16][4], dsl[BK / 16][4];  // dS as bf16 A fragments: hi, lo

  auto issue_s_dp = [&](int i) {  // S = Q K^T, dP = dO V^T: 64 rows x BK keys
    const int k_off = (i % STAGES) * 2 * BK * HS, v_off = k_off + BK * HS;
#pragma unroll
    for (int j = 0; j < HS / 16; ++j)
      mma::wgmma_ss<BK, 0>(s, desc_plus(q_desc, kstep_k<BQB>(j)),
                           desc_plus(ring_k, k_off + kstep_k<BK>(j)), j > 0);
#pragma unroll
    for (int j = 0; j < HS / 16; ++j)
      mma::wgmma_ss<BK, 0>(dp, desc_plus(do_desc, kstep_k<BQB>(j)),
                           desc_plus(ring_k, v_off + kstep_k<BK>(j)), j > 0);
  };

  if (n_tiles > 0) {
    mma::cp_async_wait<0>();       // Q and dO have landed,
    mma::fence_proxy_async();      // are visible to wgmma,
    mma::mbar_wait(&full[0], 0);   // and so is tile 0
    __syncthreads();
    mma::wgmma_fence();
    issue_s_dp(0);
    mma::wgmma_commit();
  }
  // every warpgroup computes every tile (see (b)): rows past Tq, or keys
  // above the diagonal or before the window, give dS = 0 through the masks
  for (int i = 0; i < n_tiles; ++i) {
    mma::wgmma_wait<0>();  // S, dP of this tile; dQ of the previous one
    mma::fence_acc(s);
    mma::fence_acc(dp);
    mma::fence_acc(dq);
    mma::fence_frags(dsa);
    mma::fence_frags(dsl);
    const int k0 = (tile0 + i) * BK;
    {
      const bool need_mask = qw0 + kWgRows > p.Tq || k0 + BK > p.Tk || p.window > 0 ||
                             (p.causal && k0 + BK - 1 > qw0 + p.q_off);
      if (!need_mask) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          q_tile_ds<false>(p, s, dp, dsa, dsl, j, lse2, dl, scale2, qrow, k0);
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          q_tile_ds<true>(p, s, dp, dsa, dsl, j, lse2, dl, scale2, qrow, k0);
      }
    }
    if (i + 1 < n_tiles) {
      mma::mbar_wait(&full[(i + 1) % STAGES], ((i + 1) / STAGES) & 1);  // the next tile
      __syncthreads();  // every warpgroup is done with the stage the next load refills
      if (i + STAGES - 1 < n_tiles) load_tile(i + STAGES - 1);
    }
    mma::fence_frags(dsa);
    mma::fence_frags(dsl);
    mma::fence_acc(dq);
    mma::wgmma_fence();
    {
      const int k_off = (i % STAGES) * 2 * BK * HS;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // dQ += dS K, as hi K + lo K
        mma::wgmma_rs<HS, 1>(dq, dsa[kk], desc_plus(ring_mn, k_off + 1024 * kk), 1);
        mma::wgmma_rs<HS, 1>(dq, dsl[kk], desc_plus(ring_mn, k_off + 1024 * kk), 1);
      }
    }
    if (i + 1 < n_tiles) issue_s_dp(i + 1);
    mma::wgmma_commit();
  }
  mma::wgmma_wait<0>();
  mma::fence_acc(dq);
  mma::fence_frags(dsa);
  mma::fence_frags(dsl);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow + 8 * i;
    if (qpos >= p.Tq) continue;
    bf16* dqg = static_cast<bf16*>(p.dq) + b * p.sdq.b + qpos * p.sdq.t + h * p.sdq.h;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqg + j * 8 + 2 * t) = __floats2bfloat162_rn(
          dq[4 * j + 2 * i] * p.sm_scale, dq[4 * j + 2 * i + 1] * p.sm_scale);
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

template <typename T, int HD>
cudaError_t launch_bwd_fma(const BwdParams& p, cudaStream_t stream) {
  const int64_t blocks =
      (static_cast<int64_t>(p.B) * p.H * p.Tq + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = fma_bwd_smem<HD>();
  err = launch::opt_in_smem<&flash_bwd_kv_fma_kernel<T, HD>>(smem);
  if (err != cudaSuccess) return err;
  err = launch::opt_in_smem<&flash_bwd_q_fma_kernel<T, HD>>(smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (p.Tk + kFBK - 1) / kFBK, q_tiles = (p.Tq + kFBQ - 1) / kFBQ;
  if (k_tiles > 65535 || q_tiles > 65535) return cudaErrorInvalidConfiguration;
  flash_bwd_kv_fma_kernel<T, HD><<<dim3(p.Hkv, p.B, k_tiles), kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_q_fma_kernel<T, HD><<<dim3(p.H, p.B, q_tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, int NWG, int STAGES, int MIN_BLOCKS>
cudaError_t launch_wg_bwd_kv(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = wg_bwd_kv_smem<HD, NWG, STAGES>();
  cudaError_t err =
      launch::opt_in_smem<&flash_wg_bwd_kv_kernel<HD, NWG, STAGES, MIN_BLOCKS>>(smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (p.Tk + kWgRows * NWG - 1) / (kWgRows * NWG);
  if (k_tiles > 65535) return cudaErrorInvalidConfiguration;
  BwdMaps maps;
  err = rows_map(&maps.a, p.q, p.sq, p.B, p.Tq, p.H, HD, kWgBwdBQ);
  if (err == cudaSuccess) err = rows_map(&maps.b, p.dout, p.sdo, p.B, p.Tq, p.H, HD, kWgBwdBQ);
  if (err != cudaSuccess) return err;
  flash_wg_bwd_kv_kernel<HD, NWG, STAGES, MIN_BLOCKS>
      <<<dim3(p.Hkv, p.B, k_tiles), 128 * NWG, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int HD, int NWG, int BK, int STAGES, int MIN_BLOCKS>
cudaError_t launch_wg_bwd_q(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = wg_bwd_q_smem<HD, NWG, BK, STAGES>();
  cudaError_t err =
      launch::opt_in_smem<&flash_wg_bwd_q_kernel<HD, NWG, BK, STAGES, MIN_BLOCKS>>(smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (p.Tq + kWgRows * NWG - 1) / (kWgRows * NWG);
  if (q_tiles > 65535) return cudaErrorInvalidConfiguration;
  BwdMaps maps;
  err = rows_map(&maps.a, p.k, p.sk, p.B, p.Tk, p.Hkv, HD, BK);
  if (err == cudaSuccess) err = rows_map(&maps.b, p.v, p.sv, p.B, p.Tk, p.Hkv, HD, BK);
  if (err != cudaSuccess) return err;
  flash_wg_bwd_q_kernel<HD, NWG, BK, STAGES, MIN_BLOCKS>
      <<<dim3(p.H, p.B, q_tiles), 128 * NWG, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_tc(const BwdParams& p, cudaStream_t stream) {
  using T = WgBwdTiles<HD>;
  constexpr int rows_a_block = kThreads / (HD / 8);
  const int64_t blocks =
      (static_cast<int64_t>(p.B) * p.H * p.Tq + rows_a_block - 1) / rows_a_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_bwd_delta_tc_kernel<HD><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_wg_bwd_kv<HD, T::kv_wgs, T::kv_stages, T::kv_min_blocks>(p, stream);
  if (err != cudaSuccess) return err;
  return launch_wg_bwd_q<HD, T::q_wgs, T::q_keys, T::q_stages, T::q_min_blocks>(p, stream);
}

template <typename T, int HD>
cudaError_t bwd_variant(const BwdParams& p, int variant, cudaStream_t stream) {
  if (variant == 0) return launch_bwd_fma<T, HD>(p, stream);
  if constexpr (std::is_same_v<T, bf16>) {
    if (variant == 1) {
      const Strides* all[] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
      for (const Strides* s : all)
        if (s->d != 1) return cudaErrorInvalidValue;
      return launch_bwd_tc<HD>(p, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_dispatch(int hd, const BwdParams& p, int variant, cudaStream_t stream) {
  switch (hd) {
    case 32: return bwd_variant<T, 32>(p, variant, stream);
    case 64: return bwd_variant<T, 64>(p, variant, stream);
    case 128: return bwd_variant<T, 128>(p, variant, stream);
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
// 0 and are left 0.  `kv_lens`, null or B int32 on the device, gives each
// row's keys (row_span: Tq <= kv_lens[b] <= Tk, its queries aligned to the
// end of them); the split is still planned from Tk.  `q_mode` 1 puts every
// row's first query at `q_off`, 2 row b's at `q_start`[b] (B int32 on the
// device); 0 keeps the alignment above.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int dtype, int B, int Tq, int Tk, int H, int Hkv,
                                         int hd, const int64_t* strides, int causal,
                                         int window, float sm_scale, int variant, int n_split,
                                         int tiles_per_split, void* ws, void* counters,
                                         const void* kv_lens, int q_mode, int q_off,
                                         const void* q_start, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.kv_lens = static_cast<const int*>(kv_lens);
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
  p.q_mode = q_mode;
  p.q_off = q_off;
  p.q_start = static_cast<const int*>(q_start);
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || H % Hkv != 0 ||
      (lse != nullptr && variant == 2) || q_mode < 0 || q_mode > 2 ||
      (q_mode == 2 && q_start == nullptr))
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

// The gradients of the forward above: given q, k, v, its output o and lse
// (written by a forward launch with `lse`), and dO, writes dq (B, Tq, H, hd)
// and dk, dv (B, Tk, Hkv, hd) in the inputs' dtype (0: f32, 1: bf16), with
// the forward's masks and scale.  `strides` holds 32 element strides, (b, t,
// h, d) for q, k, v, o, dO, dq, dk, dv in that order; lse and `delta` are f32
// (B, H, Tq), contiguous, and `delta` is scratch.  `variant` 0 runs the FMA
// kernels (any dtype, any strides), 1 the bf16 tensor-core kernels (d-strides
// of 1 and 16-byte aligned rows; the caller checks the alignment).  Launches
// three kernels on `stream` (D, then dK and dV, then dQ), each output written
// by one block in a fixed order, and returns cudaGetLastError() (0 on
// success).  `q_mode` 1 puts query row i at position `q_off` + i (the
// forward's host-int query start: a row that sees no key has P = 0).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         void* dq, void* dk, void* dv, float* delta, int dtype,
                                         int B, int Tq, int Tk, int H, int Hkv, int hd,
                                         const int64_t* strides, int causal, int window,
                                         float sm_scale, int variant, int q_mode, int q_off,
                                         void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || H % Hkv != 0 || window < 0 || lse == nullptr ||
      delta == nullptr || q_mode < 0 || q_mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  Strides* all[] = {&p.sq, &p.sk, &p.sv, &p.so, &p.sdo, &p.sdq, &p.sdk, &p.sdv};
  for (int i = 0; i < 8; ++i)
    *all[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  p.B = B;
  p.Tq = Tq;
  p.Tk = Tk;
  p.H = H;
  p.Hkv = Hkv;
  p.causal = causal;
  p.window = window;
  // rows from Tk + window - 1 on see no key, under either mask; under a
  // query start such a row's output is 0 and its P is 0 (dead_lo = Tq)
  const int64_t dead_lo =
      window > 0 && q_mode == 0 ? static_cast<int64_t>(Tk) + window - 1 : Tq;
  p.dead_lo = dead_lo < Tq ? static_cast<int>(dead_lo) : Tq;
  p.q_off = q_mode == 1 ? q_off : 0;
  p.sm_scale = sm_scale;
  p.inv_tk = 1.f / Tk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(bwd_dispatch<float>(hd, p, variant, s));
    case 1: return static_cast<int>(bwd_dispatch<bf16>(hd, p, variant, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
