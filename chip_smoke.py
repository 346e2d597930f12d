#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA / nvcc
   versions;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (full-width Llama-3.2-1B prefill and a decode step
   on a strided cache view) and at edge shapes, fp32 and bf16; time the
   kernel, the plain version and one PyTorch library call computing the same
   function (a yardstick the port never calls);
4. serve full-width, full-depth Llama-3.2-1B from a seeded random init
   through ``ServeEngine.generate`` (4 prompts of 512 tokens, 32 new tokens,
   greedy) with the launch counters set to 0 just before and read just after,
   then profile one prefill and one decode step (torch.profiler: wall time,
   device busy time, idle share, top kernels);
5. hold the model path against its plain path: the same weights at 2 layers
   of full width in f32, kernels on the card against the plain versions on
   the CPU;
6. print one JSON line of kernels, then the device line.

Needs one card and exits non-zero, printing no result, without one.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BATCH, PROMPT, NEW = 4, 512, 32


def _phase(name):
    print(f"== {name}", flush=True)


def time_ms(fn, reps=20, warmup=3):
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


def attention_bound_ms(q, k, v, causal, window):
    """Least time on the card: q, k, v read once and o written once, against
    4*hd FLOPs for every (query, key) pair the masks keep."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    qpos = torch.arange(tq)[:, None]
    kpos = torch.arange(tk)[None, :]
    keep = torch.ones((tq, tk), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    flops = 4.0 * b * h * int(keep.sum()) * hd
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_attention(fa, case, q, k, v, *, causal, window=0, timed=False):
    """Kernel against plain version on the same inputs; optionally timed."""
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[q.dtype]
    row = {"shape": case, "dtype": str(q.dtype).removeprefix("torch."),
           "max_abs_err": err, "tol": tol}
    if not err < tol or not torch.isfinite(out).all():
        raise AssertionError(f"flash_attention {case}: max abs err {err} >= {tol}")
    if timed:
        row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                       window=window))
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_ref(
            q, k, v, causal=causal, window=window))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, v, causal, window)
    print(json.dumps(row), flush=True)
    return row


def phase_kernels(fa):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf = torch.bfloat16
    rows = []
    # prefill at full Llama-3.2-1B width: 32 query heads over 8 KV heads
    q, k, v = rnd(BATCH, PROMPT, 32, 64, dtype=bf), rnd(BATCH, PROMPT, 8, 64, dtype=bf), \
        rnd(BATCH, PROMPT, 8, 64, dtype=bf)
    rows.append(check_attention(fa, "prefill B4 T512 H32/8 hd64 causal", q, k, v,
                                causal=True, timed=True))
    # decode: one query against the valid prefix, a strided view of the cache
    cap, n = PROMPT + NEW + 8, PROMPT + 1
    kc, vc = rnd(BATCH, cap, 8, 64, dtype=bf), rnd(BATCH, cap, 8, 64, dtype=bf)
    rows.append(check_attention(fa, "decode B4 Tq1 Tk513(view of 552) H32/8 hd64",
                                rnd(BATCH, 1, 32, 64, dtype=bf), kc[:, :n], vc[:, :n],
                                causal=False, timed=True))
    # edge shapes (tests/test_kernels.py), windows, Tq != Tk, head dims, fp32
    f32 = torch.float32
    for b, tq, tk, h, hkv, hd, causal, window, dt in [
            (1, 70, 70, 2, 2, 32, True, 0, f32), (2, 130, 130, 2, 2, 32, True, 3, f32),
            (1, 7, 7, 2, 2, 32, False, 0, f32), (1, 1, 1, 2, 2, 32, True, 0, f32),
            (2, 100, 260, 2, 2, 64, False, 0, f32), (2, 40, 100, 4, 2, 64, True, 0, f32),
            (2, 300, 300, 8, 2, 128, True, 64, bf), (2, 256, 256, 32, 8, 64, True, 0, f32),
            (3, 5, 77, 4, 1, 128, False, 0, bf)]:
        rows.append(check_attention(
            fa, f"B{b} Tq{tq} Tk{tk} H{h}/{hkv} hd{hd} causal={causal} window={window}",
            rnd(b, tq, h, hd, dtype=dt), rnd(b, tk, hkv, hd, dtype=dt),
            rnd(b, tk, hkv, hd, dtype=dt), causal=causal, window=window))
    return rows


def phase_serve(fa, api_mod, engine_mod, cfg):
    api = api_mod.build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = api.init(0)
    torch.cuda.synchronize()
    print(f"init {cfg.name}: {time.perf_counter() - t0:.3f} s", flush=True)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen).cuda()
    batch = {"tokens": tokens}
    with torch.inference_mode():            # warm-up; also checks the logits
        logits, cache = api.prefill(params, batch, capacity=PROMPT + NEW + 8)
        if logits.shape != (BATCH, PROMPT, cfg.vocab_padded) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
        logits_d, _ = api.decode_fn(params, cache, {"tokens": tokens[:, -1:]})
        if not torch.isfinite(logits_d).all():
            raise AssertionError("decode logits not finite")
    del logits, cache, logits_d
    engine = engine_mod.ServeEngine(api, params)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    res = engine.generate(batch, max_new_tokens=NEW)
    launches = fa.flash_attention.launches
    want = cfg.n_layers * (1 + NEW)
    if launches != want:
        raise AssertionError(f"flash_attention launched {launches} times, want {want}")
    if not torch.isfinite(res.logprobs).all() or res.tokens.shape != (BATCH, NEW) \
            or int(res.tokens.min()) < 0 or int(res.tokens.max()) >= cfg.vocab_size:
        raise AssertionError("generate returned bad tokens or logprobs")
    step_ms = res.decode_ms / res.decode_steps
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": BATCH, "prompt": PROMPT,
           "new": NEW, "prefill_ms": res.prefill_ms, "decode_ms_per_step": step_ms,
           "tok_per_s": BATCH * NEW / ((res.prefill_ms + res.decode_ms) / 1e3),
           "decode_tok_per_s": BATCH * res.decode_steps / (res.decode_ms / 1e3),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "flash_attention_launches": launches}
    print(json.dumps(out), flush=True)
    print("first sequence:", res.tokens[0].tolist(), flush=True)
    phase_profile(api, params, batch)
    del params, engine
    torch.cuda.empty_cache()
    return launches


def phase_profile(api, params, batch):
    """Where one prefill and one decode step spend their time: wall time on
    the host clock (ending in a synchronize), device busy time as the sum of
    the CUDA kernels the profiler saw, and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        _, cache = api.prefill(params, batch, capacity=PROMPT + NEW + 8)
        step = {"tokens": batch["tokens"][:, -1:]}
        calls = {"prefill": lambda: api.prefill(params, batch, capacity=PROMPT + NEW + 8),
                 "decode_step": lambda: api.decode_fn(params, dict(cache), step)}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            unprofiled_ms = (time.perf_counter() - t0) * 1e3 / 3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            by_name = {}
            for e in kern:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            print(json.dumps({"profile": name, "unprofiled_wall_ms": unprofiled_ms,
                              "wall_ms": wall_ms, "device_busy_ms": busy,
                              "idle_share": 1 - busy / unprofiled_ms, "kernels": len(kern),
                              "top": [[n[:80], ms] for n, ms in top]}), flush=True)


def phase_model_vs_plain(api_mod, cfg):
    """2 layers at full width in f32: the card's kernels against the plain
    versions on the CPU, same weights and tokens; logits within 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    gpu, cpu = (api_mod.build_model(cfg2, device=d) for d in ("cuda", "cpu"))
    params = gpu.init(1)
    params_cpu = _tree_to(params, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    worst = 0.0
    with torch.inference_mode():
        lg, cg = gpu.prefill(params, {"tokens": tokens.cuda()}, capacity=56)
        lc, cc = cpu.prefill(params_cpu, {"tokens": tokens}, capacity=56)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        nxt = lc[:, -1].argmax(-1)[:, None]
        for _ in range(3):
            lg, cg = gpu.decode_fn(params, cg, {"tokens": nxt.cuda()})
            lc, cc = cpu.decode_fn(params_cpu, cc, {"tokens": nxt})
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
            nxt = lc[:, -1].argmax(-1)[:, None]
    print(json.dumps({"model_vs_plain_max_abs_logit_diff": worst, "tol": 1e-3}), flush=True)
    if not worst <= 1e-3:
        raise AssertionError(f"model path disagrees with its plain path: {worst}")
    return worst


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api as api_mod
    from repro_torch.serve import engine as engine_mod

    _phase("1 card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {nvcc} "
          f"python {sys.version.split()[0]}", flush=True)
    print(smi, flush=True)

    _phase("2 build")
    t0 = time.perf_counter()
    build.build("flash_attention")
    print(f"built flash_attention in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.build_log("flash_attention").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  flash_attention: {line.strip()}")

    _phase("3 kernels against their plain versions")
    rows = phase_kernels(fa)

    _phase("4 serve llama3_2_1b, full width and depth")
    cfg = get_config("llama3_2_1b")
    launches = phase_serve(fa, api_mod, engine_mod, cfg)

    _phase("5 model path against its plain path")
    phase_model_vs_plain(api_mod, cfg)

    _phase("6 result")
    main_row = rows[0]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": [r for r in rows if "ms" in r],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
