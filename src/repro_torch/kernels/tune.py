"""Time other tile shapes of two tensor-core kernels beside the ones in the
tree, on the card:

    PYTHONPATH=src python -m repro_torch.kernels.tune

- the LSTM forward's ``tc`` tile (``csrc/lstm_cell.cu``, ``launch_tc<BH,
  STAGES, KS>``: hidden units a block, ring stages, contraction rows a
  stage) at BigLSTM's training shape (B 16, d_in 1024, d_h 1024, H 8192,
  bf16);
- the ``chunked`` WKV kernel's ring depth (``csrc/wkv6.cu``,
  ``launch_chunked<T, 64, NS>``) at RWKV6-7B's prefill (B 4, T 512, H 64,
  hd 64), bf16 and f32 r, k, v.

A harness that ``#include``s each source instantiates the other shapes, so
the tree keeps one tile; it is built with the kernels' own nvcc flags into
``_build/``.  Each shape must give the tree's output bits; the times are
CUDA-event milliseconds per call (20 calls after 3 warm-up calls, three
repeats), each beside the tree's kernel timed in the same run.  Prints one
JSON line per shape.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import wkv6 as wk

LSTM_TILES = [(32, 4, 64), (32, 3, 64), (32, 5, 64), (32, 6, 32), (16, 4, 64), (16, 6, 64),
              (16, 8, 32), (64, 3, 64), (64, 4, 64), (64, 5, 64), (64, 6, 32), (64, 8, 32),
              (64, 2, 128), (32, 3, 128)]
WKV_STAGES = [2, 3, 4, 6]


def _harness() -> str:
    lstm_cases = "\n".join(f"    case {i}: return launch_tc<{bh}, {st}, {ks}>(p, s);"
                           for i, (bh, st, ks) in enumerate(LSTM_TILES))
    wkv_cases = "\n".join(
        f"    case {2 * i}: return launch_chunked<float, 64, {ns}>(p, s);\n"
        f"    case {2 * i + 1}: return launch_chunked<__nv_bfloat16, 64, {ns}>(p, s);"
        for i, ns in enumerate(WKV_STAGES))
    return f'''
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
'''


def _load() -> ctypes.CDLL:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "tune_harness.cu"
    src.write_text(_harness())
    lib = build.BUILD_DIR / "libtune_harness.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"tuning harness build failed:\n{proc.stdout}")
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.tune_lstm.restype = dll.tune_wkv.restype = i32
    dll.tune_lstm.argtypes = [i32] + [vp] * 9 + [i32] * 4 + [vp]
    dll.tune_wkv.argtypes = [i32] + [vp] * 7 + [i32] * 3 + [vp]
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune: needs a CUDA card")
    dll = _load()
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip(), flush=True)
    tune_lstm(dll, stream)
    tune_wkv(dll, stream)


if __name__ == "__main__":
    main()
