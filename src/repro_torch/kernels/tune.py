"""Time other tile shapes of the tensor-core kernels beside the ones in the
tree, on the card:

    PYTHONPATH=src python -m repro_torch.kernels.tune [lstm] [wkv] [flash_bwd]

(all three when none is named):

- the LSTM forward's ``tc`` tile (``csrc/lstm_cell.cu``, ``launch_tc<BH,
  STAGES, KS>``: hidden units a block, ring stages, contraction rows a
  stage) at BigLSTM's training shape (B 16, d_in 1024, d_h 1024, H 8192,
  bf16);
- the ``chunked`` WKV kernel's ring depth (``csrc/wkv6.cu``,
  ``launch_chunked<T, 64, NS>``) at RWKV6-7B's prefill (B 4, T 512, H 64,
  hd 64), bf16 and f32 r, k, v;
- the flash backward's wgmma kernels (``csrc/flash_attention.cu``,
  ``launch_wg_bwd_kv<64, WGS, STAGES, MIN_BLOCKS>`` and
  ``launch_wg_bwd_q<64, WGS, BK, STAGES, MIN_BLOCKS>``: warpgroups a block,
  ring stages, keys a streamed tile of the dQ kernel, and the blocks an SM
  their registers are capped for) at Llama-3.2-1B's training shape (B 4,
  T 2048, H 32/8, hd 64, causal, bf16).

A harness that ``#include``s each source instantiates the other shapes, so
the tree keeps one tile; it is built with the kernels' own nvcc flags into
``_build/`` (ptxas's report beside it, ``libtune_harness.so.log``), and
only with the sources of the kernels named.  Each shape must give the
tree's output bits; the times are
CUDA-event milliseconds per call (20 calls after 3 warm-up calls, three
repeats), each beside the tree's kernel timed in the same run.  Prints one
JSON line per shape.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import wkv6 as wk

LSTM_TILES = [(32, 4, 64), (32, 3, 64), (32, 5, 64), (32, 6, 32), (16, 4, 64), (16, 6, 64),
              (16, 8, 32), (64, 3, 64), (64, 4, 64), (64, 5, 64), (64, 6, 32), (64, 8, 32),
              (64, 2, 128), (32, 3, 128)]
WKV_STAGES = [2, 3, 4, 6]
# (WGS, STAGES, MIN_BLOCKS) of the dK/dV kernel; the tree's first
FLASH_BWD_KV = [(1, 4, 1), (1, 3, 1), (1, 4, 3), (2, 4, 1), (2, 3, 1)]
# (WGS, BK, STAGES, MIN_BLOCKS) of the dQ kernel; the tree's first
FLASH_BWD_Q = [(1, 64, 3, 3), (1, 64, 3, 1), (1, 64, 4, 2), (2, 64, 3, 1), (1, 128, 3, 1)]


def _flash_harness() -> str:
    kv_cases = "\n".join(f"    case {i}: return launch_wg_bwd_kv<64, {w}, {st}, {mb}>(p, s);"
                         for i, (w, st, mb) in enumerate(FLASH_BWD_KV))
    q_cases = "\n".join(
        f"    case {100 + i}: return launch_wg_bwd_q<64, {w}, {bk}, {st}, {mb}>(p, s);"
        for i, (w, bk, st, mb) in enumerate(FLASH_BWD_Q))
    return f'''
namespace flash {{
#include "{build.CSRC / 'flash_attention.cu'}"
// causal, no window, contiguous (B, T, H, 64) q, o, dO, dq and (B, T, Hkv, 64)
// k, v, dk, dv; lse and delta (B, H, T) as the tree's entry wrote them
extern "C" int tune_flash_bwd(int cfg, const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const float* lse, void* dq,
                              void* dk, void* dv, float* delta, int B, int T, int H, int Hkv,
                              void* stream) {{
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = lse; p.delta = delta;
  const Strides sh{{int64_t(T) * H * 64, int64_t(H) * 64, 64, 1}};
  const Strides skv{{int64_t(T) * Hkv * 64, int64_t(Hkv) * 64, 64, 1}};
  p.sq = p.so = p.sdo = p.sdq = sh;
  p.sk = p.sv = p.sdk = p.sdv = skv;
  p.B = B; p.Tq = T; p.Tk = T; p.H = H; p.Hkv = Hkv;
  p.causal = 1; p.window = 0; p.dead_lo = T; p.sm_scale = 0.125f; p.inv_tk = 1.f / T;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg) {{
{kv_cases}
{q_cases}
    default: return -1;
  }}
}}
}}  // namespace flash
'''


def _harness(which) -> str:
    lstm_cases = "\n".join(f"    case {i}: return launch_tc<{bh}, {st}, {ks}>(p, s);"
                           for i, (bh, st, ks) in enumerate(LSTM_TILES))
    wkv_cases = "\n".join(
        f"    case {2 * i}: return launch_chunked<float, 64, {ns}>(p, s);\n"
        f"    case {2 * i + 1}: return launch_chunked<__nv_bfloat16, 64, {ns}>(p, s);"
        for i, ns in enumerate(WKV_STAGES))
    return f'''
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "{build.CSRC / 'mma_bf16.cuh'}"
namespace lstm {{
#include "{build.CSRC / 'lstm_cell.cu'}"
extern "C" int tune_lstm(int cfg, const void* x, const void* h, const void* c, const void* wx,
                         const void* wh, const float* b, void* h_out, void* c_out, float* gates,
                         int B, int d_in, int d_h, int H, void* stream) {{
  FwdParams p;
  p.x = x; p.h = h; p.c = c; p.wx = wx; p.wh = wh; p.b = b;
  p.h_out = h_out; p.c_out = c_out; p.gates = gates;
  p.ldx = d_in; p.ldh = d_h; p.ldc = H; p.ldho = H; p.ldco = H;
  p.B = B; p.d_in = d_in; p.d_h = d_h; p.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg) {{
{lstm_cases}
    default: return -1;
  }}
}}
}}  // namespace lstm
namespace wkv {{
#include "{build.CSRC / 'wkv6.cu'}"
extern "C" int tune_wkv(int cfg, const void* r, const void* k, const void* v, const void* w,
                        const void* u, void* s_out, void* out, int B, int T, int H,
                        void* stream) {{
  Params p;
  p.r = r; p.k = k; p.v = v; p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u); p.s_in = nullptr;
  p.s_out = static_cast<float*>(s_out); p.out = static_cast<float*>(out);
  p.B = B; p.T = T; p.H = H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg) {{
{wkv_cases}
    default: return -1;
  }}
}}
}}  // namespace wkv
''' + (_flash_harness() if "flash_bwd" in which else "")


def _load(which) -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "tune_harness.cu"
    src.write_text(_harness(which))
    lib = build.BUILD_DIR / "libtune_harness.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"tuning harness build failed:\n{proc.stdout}")
    (lib.with_name(lib.name + ".log")).write_text(proc.stdout)
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.tune_lstm.restype = dll.tune_wkv.restype = i32
    dll.tune_lstm.argtypes = [i32] + [vp] * 9 + [i32] * 4 + [vp]
    dll.tune_wkv.argtypes = [i32] + [vp] * 7 + [i32] * 3 + [vp]
    if "flash_bwd" not in which:
        return dll
    dll.tune_flash_bwd.restype = i32
    dll.tune_flash_bwd.argtypes = [i32] + [vp] * 10 + [i32] * 4 + [vp]
    dll.repro_flash_attention_bwd.restype = i32
    dll.repro_flash_attention_bwd.argtypes = ([vp] * 10 + [i32] * 7
                                              + [ctypes.POINTER(ctypes.c_int64), i32, i32,
                                                 ctypes.c_float, i32, vp])
    return dll


def _ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tune_lstm(dll, stream):
    gen = torch.Generator(device="cuda").manual_seed(0)
    bsz, d_in, d_h, hh = 16, 1024, 1024, 8192

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale)

    x, h = rnd(bsz, d_in).bfloat16(), rnd(bsz, d_h).bfloat16()
    c = rnd(bsz, hh, scale=0.5).bfloat16()
    wx = rnd(d_in, 4, hh, scale=d_in ** -0.5).bfloat16()
    wh = rnd(d_h, 4, hh, scale=d_h ** -0.5).bfloat16()
    b = rnd(4, hh, scale=0.1)
    outs = [torch.empty(bsz, hh, dtype=torch.bfloat16, device="cuda") for _ in range(2)]
    gates = torch.empty(bsz, 4, hh, device="cuda")

    def tree():
        return lc._launch_fwd(x, h, c, wx, wh, b, *outs, gates, "tc")

    tree()
    want = [t.clone() for t in (*outs, gates)]
    for cfg, (bh, st, ks) in enumerate(LSTM_TILES):
        def call(cfg=cfg):
            return dll.tune_lstm(cfg, x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
                                 wh.data_ptr(), b.data_ptr(), outs[0].data_ptr(),
                                 outs[1].data_ptr(), gates.data_ptr(), bsz, d_in, d_h, hh,
                                 stream)

        err = call()
        torch.cuda.synchronize()
        same = err == 0 and all(torch.equal(g, w) for g, w in zip((*outs, gates), want))
        print(json.dumps({"kernel": "lstm_cell_fwd tc", "units_a_block": bh, "stages": st,
                          "rows_a_stage": ks, "same_bits_as_tree": same,
                          "ms": [_ms(call) for _ in range(3)], "tree_ms": _ms(tree)}),
              flush=True)


def tune_wkv(dll, stream):
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, hd = 4, 512, 64, 64

    def inputs(dtype):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda") * 0.5
        r, k, v = (rnd(b, t, h, hd).to(dtype) for _ in range(3))
        return r, k, v, torch.exp(-torch.exp(rnd(b, t, h, hd) - 2)), rnd(h, hd) * 0.2

    for dtype in (torch.bfloat16, torch.float32):
        sets = [inputs(dtype) for _ in range(3)]   # more than twice the 50 MB L2
        out = torch.empty(b, t, h, hd, device="cuda")
        s_out = torch.empty(b, h, hd, hd, device="cuda")
        want = wk._launch(*sets[0], None, "chunked")
        for i, ns in enumerate(WKV_STAGES):
            cfg = 2 * i + (dtype == torch.bfloat16)
            cycle = itertools.cycle(sets)

            def call(cfg=cfg, cycle=cycle):
                r, k, v, w, u = next(cycle)
                return dll.tune_wkv(cfg, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                                    u.data_ptr(), s_out.data_ptr(), out.data_ptr(), b, t, h,
                                    stream)

            err = dll.tune_wkv(cfg, *(x.data_ptr() for x in sets[0]), s_out.data_ptr(),
                               out.data_ptr(), b, t, h, stream)
            torch.cuda.synchronize()
            same = err == 0 and torch.equal(out, want[0]) and torch.equal(s_out, want[1])
            tree_cycle = itertools.cycle(sets)
            print(json.dumps({"kernel": "wkv6 chunked", "dtype": str(dtype).removeprefix("torch."),
                              "stages": ns, "same_bits_as_tree": same,
                              "ms": [_ms(call) for _ in range(3)],
                              "tree_ms": _ms(lambda: wk._launch(*next(tree_cycle), None,
                                                                "chunked"))}), flush=True)


def tune_flash_bwd(dll, stream):
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, hkv = 4, 2048, 32, 8

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, do = rnd(b, t, h, 64), rnd(b, t, h, 64)
    k, v = rnd(b, t, hkv, 64), rnd(b, t, hkv, 64)
    out, lse = fa._forward(q, k, v, True, 0, want_lse=True)
    want = [torch.empty_like(x) for x in (q, k, v)]
    grads = [torch.empty_like(x) for x in (q, k, v)]
    delta = torch.empty((b, h, t), device="cuda")
    ptrs = [x.data_ptr() for x in (q, k, v, out, do, lse)]
    strides = (ctypes.c_int64 * 32)(*(s for x in (q, k, v, out, do, *want) for s in x.stride()))

    def tree():   # the tree's three kernels through this harness's copy of the entry
        return dll.repro_flash_attention_bwd(*ptrs, *(x.data_ptr() for x in want),
                                             delta.data_ptr(), 1, b, t, t, h, hkv, 64, strides,
                                             1, 0, 0.125, 1, stream)

    if tree() != 0:
        raise RuntimeError("the tree's flash backward failed in the harness")
    torch.cuda.synchronize()
    for cfg, kernel, tiles, outs in (
            [(i, "flash_attention_bwd tc dK/dV",
              {"warpgroups": w, "stages": st, "min_blocks": mb}, (1, 2))
             for i, (w, st, mb) in enumerate(FLASH_BWD_KV)]
            + [(100 + i, "flash_attention_bwd tc dQ",
                {"warpgroups": w, "keys_a_tile": bk, "stages": st, "min_blocks": mb}, (0,))
               for i, (w, bk, st, mb) in enumerate(FLASH_BWD_Q)]):
        def call(cfg=cfg):
            return dll.tune_flash_bwd(cfg, *ptrs, *(x.data_ptr() for x in grads),
                                      delta.data_ptr(), b, t, h, hkv, stream)

        err = call()
        torch.cuda.synchronize()
        same = err == 0 and all(torch.equal(grads[i], want[i]) for i in outs)
        print(json.dumps({"kernel": kernel, **tiles, "same_bits_as_tree": same,
                          "ms": [_ms(call) for _ in range(3)], "tree_bwd_ms": _ms(tree)}),
              flush=True)


KERNELS = {"lstm": tune_lstm, "wkv": tune_wkv, "flash_bwd": tune_flash_bwd}


def main(argv=None):
    which = list(sys.argv[1:] if argv is None else argv) or list(KERNELS)
    unknown = set(which) - set(KERNELS)
    if unknown:
        raise SystemExit(f"tune: unknown kernels {sorted(unknown)}; choose from {list(KERNELS)}")
    if not torch.cuda.is_available():
        raise SystemExit("tune: needs a CUDA card")
    dll = _load(which)
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip(), flush=True)
    for name in which:
        KERNELS[name](dll, stream)


if __name__ == "__main__":
    main()
