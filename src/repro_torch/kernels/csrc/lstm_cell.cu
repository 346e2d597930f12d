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
// The forward has two variants, chosen by the caller (`lstm_variant` in
// kernels/lstm_cell.py) from the inputs alone:
//
// * `fma` (f32, and bf16 that the tensor-core tile does not take).  One
//   block of 256 threads owns 32 hidden units, all four gates of them (128
//   weight columns), for up to 16 batch rows, so it reads its weight columns
//   once and reuses each weight for every row.  At H = 8192 that is 256
//   blocks, two resident per SM on the 132 SMs (the TPU's 128-wide tile
//   would give only 64).  Each lane owns 4 consecutive columns (one 8-byte
//   bf16 or 16-byte f32 load per weight row) and 16 x 4 f32 accumulators;
//   the 8 warps split the 2048-long contraction (x and h rows back to back)
//   between them.  The inputs are staged in shared memory as f32, transposed
//   so that one broadcast 16-byte load gives 4 batch rows of one k.  The 8
//   partial sums meet in shared memory, and the cell update runs as the
//   epilogue.  Rows beyond B and columns beyond H are masked; H % 4 != 0 or
//   misaligned weights take scalar weight loads.  It uses the f32 FMA pipes
//   and synchronous loads: 0.199 ms at BigLSTM's shape on an H100 80GB HBM3
//   at 700 W (PERF.md), 4.8x the byte bound.
//
// * `tc` (bf16 with d_in, d_h and H multiples of 8, x and h rows and all
//   four bases 16-byte aligned).  The job at 16 FLOP per byte is to stream
//   the weights at close to HBM bandwidth, so the tile is the grouped
//   matmul's decode tile (moe_gmm.cu) with the cell update as its epilogue.
//   The block's 16 batch rows are one m16 tile of mma.sync m16n8k16 (bf16
//   operands, f32 accumulators).  A block owns 64 hidden units, all four
//   gates of them (256 columns, four 128-byte runs of each weight row), so
//   the gate pre-activations never leave the SM; 16 warps own 16 columns
//   each over the whole contraction, so no partial sums meet.  Each stage
//   of a 3-deep cp.async.cg ring holds 64 rows of [x | h] (16 x 64, 2 KB,
//   read from L2 by every block) and of the weights (64 x 256, 32 KB), two
//   stages in flight while one is used; at H = 8192 the 128 blocks are one
//   wave, one block on each of 128 SMs with ~66 KB of weights in flight.
//   ldmatrix gives the A fragments and ldmatrix.trans the B fragments of
//   the N-major (d, 4, H) weights; rows padded by 16 bytes keep both free
//   of bank conflicts.  After the ring, the f32 accumulators go through
//   shared memory to the same epilogue as `fma`.  B > 16 takes a second
//   grid dimension of 16-row tiles, as `fma` does.  Timed on the H100
//   (kernels/tune.py; PERF.md): 32 units a block with 3-6 stages (2
//   blocks an SM), 16 units with 4-8 stages, and 64 units with 2-8 stages
//   of 32-128 rows were no faster.
//
// The gx entry (`repro_lstm_cell_fwd_gx`) is the same two kernels with no
// x and no Wx: d_in is 0, so the contraction is h @ Wh alone, and the
// epilogue adds a precomputed input pre-activation gx (B, 4, H) before the
// bias.  The overlapped tensor-MP BigLSTM layer computes x @ Wx for all T
// steps at once on a collective-matmul ring (JAX's lstm_layer_overlapped,
// src/repro/models/lstm.py:81, whose recurrence is plain ops there) and runs
// each step on this entry.  At a rank's shape of BigLSTM at 2-way MP (B 16,
// d_h 1024, H 4096, bf16) a step reads 33.6 MB of Wh: bound by bytes, ~10 us.
//
// What is left on the table: x @ Wx does not depend on the recurrence and
// could be one GEMM over all T steps before the time loop (a second
// hand-written GEMM; ROADMAP item 16), leaving h @ Wh per step and halving
// the bytes a step streams; the ring is filled by every thread with
// cp.async (no TMA, no producer warp), 4 of the 132 SMs are idle at H =
// 8192, and B > 16 re-reads the weights once per 16-row tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
  // the gx entry: a precomputed input pre-activation (B, 4, H) with row
  // stride ldgx, in place of x @ Wx (then d_in is 0 and x, wx are unread)
  const void* gx = nullptr;
  int64_t ldgx = 0;
};

// The gate sum of one (row, gate q, hidden unit) that the cell update
// takes starts from the bias and adds the products' partial sums; the gx
// entry starts from gx instead and adds the bias last (gx + h @ Wh + b, in
// that order, in f32).
template <typename T>
__device__ __forceinline__ float gate_start(const FwdParams& p, int row, int q, int hh) {
  if (p.gx == nullptr) return p.b[q * p.H + hh];
  return to_f32(static_cast<const T*>(p.gx)[row * p.ldgx + q * p.H + hh]);
}

__device__ __forceinline__ float gate_end(const FwdParams& p, int q, int hh, float v) {
  return p.gx == nullptr ? v : v + p.b[q * p.H + hh];
}

// The cell update of one (row, hidden unit) from its four gate sums (bias
// included): h', c' and, when asked, the activated gates.
template <typename T>
__device__ __forceinline__ void cell_update(const FwdParams& p, int row, int hh,
                                            const float s[4]) {
  const float ig = sigmoid(s[0]), fg = sigmoid(s[1] + 1.f);
  const float gg = tanhf(s[2]), og = sigmoid(s[3]);
  const float cn = fg * to_f32(static_cast<const T*>(p.c)[row * p.ldc + hh]) + ig * gg;
  store(static_cast<T*>(p.h_out) + row * p.ldho + hh, og * tanhf(cn));
  store(static_cast<T*>(p.c_out) + row * p.ldco + hh, cn);
  if (p.gates != nullptr) {
    float* g = p.gates + static_cast<int64_t>(row) * 4 * p.H + hh;
    g[0] = ig;
    g[p.H] = fg;
    g[2 * p.H] = gg;
    g[3 * p.H] = og;
  }
}

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

  for (int cell = tid; cell < kBB * kBH; cell += kThreads) {
    const int r = cell / kBH, j = cell % kBH, row = r0 + r, hh = h0 + j;
    if (row >= p.B || hh >= p.H) continue;
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = gate_start<T>(p, row, q, hh);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[(w * kBB + r) * kCols + q * kBH + j];
      s[q] = gate_end(p, q, hh, v);
    }
    cell_update<T>(p, row, hh, s);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: variant `tc`
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// A block owns BH hidden units (4 * BH weight columns, one warp per 16) for
// 16 batch rows and streams its columns through a ring of STAGES stages of
// KS contraction rows.
template <int BH, int STAGES, int KS>
struct TcTile {
  static constexpr int kCols = 4 * BH;
  static constexpr int kWarps = kCols / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kALd = KS + 8;      // padded rows: ldmatrix without bank conflicts
  static constexpr int kWLd = kCols + 8;
  static constexpr int kStage = 16 * kALd + KS * kWLd;   // bf16 elements
  static constexpr size_t kSmem = sizeof(bf16) * STAGES * kStage;
  static constexpr int kRedLd = kCols + 4;               // f32 gate sums, after the ring
  static_assert(BH % 8 == 0 && KS % 16 == 0, "16-byte pieces, k16 steps");
  static_assert(16 * kRedLd * sizeof(float) <= kSmem, "the gate sums fit the ring");
};

// Rows [r0, r0 + 16) of [x | h] and the block's weight columns (gate q's
// units [h0, h0 + BH) at column q * H + h0) over contraction rows [k0, k0 +
// KS), into shared memory by 16-byte cp.async.  d_in, d_h and H are
// multiples of 8, so a piece lies wholly in x or h, in one gate, and in or
// out of range; pieces out of range are zero-filled.
template <class Tile, int BH, int KS>
__device__ __forceinline__ void load_tc_stage(bf16* as, bf16* ws, const FwdParams& p, int r0,
                                              int h0, int k0) {
  const bf16* X = static_cast<const bf16*>(p.x);
  const bf16* Hs = static_cast<const bf16*>(p.h);
  const bf16* WX = static_cast<const bf16*>(p.wx);
  const bf16* WH = static_cast<const bf16*>(p.wh);
  const int K = p.d_in + p.d_h;
  const int64_t ldw = 4 * static_cast<int64_t>(p.H);
  constexpr int ACH = KS / 8, WCH = Tile::kCols / 8;
  for (int i = threadIdx.x; i < 16 * ACH; i += Tile::kThreads) {
    const int r = i / ACH, c = (i % ACH) * 8, k = k0 + c, row = r0 + r;
    const bool ok = row < p.B && k < K;
    const bf16* src = X;
    if (ok) src = k < p.d_in ? X + row * p.ldx + k : Hs + row * p.ldh + (k - p.d_in);
    mma::cp_async16(as + r * Tile::kALd + c, src, ok);
  }
  for (int i = threadIdx.x; i < KS * WCH; i += Tile::kThreads) {
    const int r = i / WCH, c = (i % WCH) * 8, k = k0 + r, hh = h0 + c % BH;
    const bool ok = k < K && hh < p.H;
    const bf16* src = WX;
    if (ok)
      src = (k < p.d_in ? WX + k * ldw : WH + (k - p.d_in) * ldw) +
            static_cast<int64_t>(c / BH) * p.H + hh;
    mma::cp_async16(ws + r * Tile::kWLd + c, src, ok);
  }
}

// grid (H / BH, B / 16), both rounded up.
template <int BH, int STAGES, int KS>
__global__ void __launch_bounds__(TcTile<BH, STAGES, KS>::kThreads)
    lstm_fwd_tc_kernel(FwdParams p) {
  using Tile = TcTile<BH, STAGES, KS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int h0 = blockIdx.x * BH, r0 = blockIdx.y * 16;
  const int n_k = (p.d_in + p.d_h + KS - 1) / KS;

  auto load = [&](int kt) {
    bf16* as = smem + (kt % STAGES) * Tile::kStage;
    load_tc_stage<Tile, BH, KS>(as, as + 16 * Tile::kALd, p, r0, h0, kt * KS);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s);
    mma::cp_async_commit();
  }
  float acc[2][4] = {};
  for (int kt = 0; kt < n_k; ++kt) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is no longer read
    if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1);
    mma::cp_async_commit();
    const bf16* as = smem + (kt % STAGES) * Tile::kStage;
    const bf16* ws = as + 16 * Tile::kALd;
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      uint32_t a[4], b[4];
      mma::ldmatrix_x4(a, as + (lane % 16) * Tile::kALd + ks * 16 + (lane / 16) * 8);
      mma::ldmatrix_x4_trans(b, ws + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * Tile::kWLd +
                                    warp * 16 + (lane / 16) * 8);
      mma::mma_16816(acc[0], a, b);
      mma::mma_16816(acc[1], a, b + 2);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();   // the ring is no longer read: it holds the gate sums now
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int ni = 0; ni < 2; ++ni) {
    const int col = warp * 16 + ni * 8 + 2 * t4;
    *reinterpret_cast<float2*>(red + g8 * Tile::kRedLd + col) = make_float2(acc[ni][0], acc[ni][1]);
    *reinterpret_cast<float2*>(red + (g8 + 8) * Tile::kRedLd + col) =
        make_float2(acc[ni][2], acc[ni][3]);
  }
  __syncthreads();
  for (int cell = tid; cell < 16 * BH; cell += Tile::kThreads) {
    const int r = cell / BH, j = cell % BH, row = r0 + r, hh = h0 + j;
    if (row >= p.B || hh >= p.H) continue;
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s[q] = gate_end(p, q, hh,
                      gate_start<bf16>(p, row, q, hh) + red[r * Tile::kRedLd + q * BH + j]);
    cell_update<bf16>(p, row, hh, s);
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

template <typename T, bool kVec>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  cudaError_t err = launch::opt_in_smem<&lstm_fwd_kernel<T, kVec>>(kSmemBytes);
  if (err != cudaSuccess) return err;
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

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The tensor-core tile's shape: 64 hidden units (256 columns, 16 warps) a
// block, a 3-stage ring of 64 contraction rows: the fastest of the tiles
// kernels/tune.py timed on the H100 (PERF.md).
constexpr int kTcBH = 64, kTcStages = 3, kTcKS = 64;

template <int BH, int STAGES, int KS>
cudaError_t launch_tc(const FwdParams& p, cudaStream_t stream) {
  using Tile = TcTile<BH, STAGES, KS>;
  if (p.d_in % 8 || p.d_h % 8 || p.H % 8 || (p.B > 1 && (p.ldx % 8 || p.ldh % 8)) ||
      !aligned16(p.x) || !aligned16(p.h) || !aligned16(p.wx) || !aligned16(p.wh))
    return cudaErrorInvalidValue;
  cudaError_t err = launch::opt_in_smem<&lstm_fwd_tc_kernel<BH, STAGES, KS>>(Tile::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.H + BH - 1) / BH, (p.B + 15) / 16);
  lstm_fwd_tc_kernel<BH, STAGES, KS><<<grid, Tile::kThreads, Tile::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The forward's variant on checked params: 0 the FMA kernel, 1 the bf16
// tensor-core tile.
cudaError_t run_fwd(const FwdParams& p, int dtype, int variant, cudaStream_t s) {
  if (variant == 1)
    return dtype == 1 ? launch_tc<kTcBH, kTcStages, kTcKS>(p, s) : cudaErrorInvalidValue;
  if (variant != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return dispatch_fwd<float>(p, s);
    case 1: return dispatch_fwd<__nv_bfloat16>(p, s);
    default: return cudaErrorInvalidValue;
  }
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
// gates: (B, 4, H) f32 contiguous or null.  dtype 0: f32, 1: bf16.
// `variant` 0 runs the FMA kernel (any shape), 1 the bf16 tensor-core tile,
// which needs d_in, d_h, H and (for B > 1) ldx and ldh multiples of 8 and
// x, h, wx, wh 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for an empty
// shape, an unknown dtype or a variant the inputs do not fit.
extern "C" int repro_lstm_cell_fwd(const void* x, int64_t ldx, const void* h, int64_t ldh,
                                   const void* c, int64_t ldc, const void* wx, const void* wh,
                                   const float* b, void* h_out, int64_t ldho, void* c_out,
                                   int64_t ldco, float* gates, int dtype, int B, int d_in,
                                   int d_h, int H, int variant, void* stream) {
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
  return static_cast<int>(run_fwd(p, dtype, variant, static_cast<cudaStream_t>(stream)));
}

// One LSTM step from a precomputed input pre-activation: gates = gx + h @ Wh
// + b, then the cell update, as repro_lstm_cell_fwd with x @ Wx replaced by
// gx (B, 4, H) of the dtype of h, row stride ldgx, unit stride within a row
// (the overlapped tensor-MP layer computes x @ Wx for all steps at once on a
// collective-matmul ring).  No x and no Wx are read.  `variant` as above:
// 1 (tc) needs d_h, H and (for B > 1) ldh multiples of 8 and h, wh 16-byte
// aligned; gx is read in the epilogue and needs no alignment.
extern "C" int repro_lstm_cell_fwd_gx(const void* gx, int64_t ldgx, const void* h, int64_t ldh,
                                      const void* c, int64_t ldc, const void* wh,
                                      const float* b, void* h_out, int64_t ldho, void* c_out,
                                      int64_t ldco, float* gates, int dtype, int B, int d_h,
                                      int H, int variant, void* stream) {
  if (gx == nullptr || B < 1 || d_h < 1 || H < 1 || (B + kBB - 1) / kBB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.x = h;     // never read: d_in is 0
  p.wx = wh;
  p.h = h;
  p.c = c;
  p.wh = wh;
  p.b = b;
  p.h_out = h_out;
  p.c_out = c_out;
  p.gates = gates;
  p.ldx = ldh;
  p.ldh = ldh;
  p.ldc = ldc;
  p.ldho = ldho;
  p.ldco = ldco;
  p.B = B;
  p.d_in = 0;
  p.d_h = d_h;
  p.H = H;
  p.gx = gx;
  p.ldgx = ldgx;
  return static_cast<int>(run_fwd(p, dtype, variant, static_cast<cudaStream_t>(stream)));
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
