#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA / nvcc
   versions;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc, one
   process per source, all started together, and print ptxas' registers and
   spills;
3. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at edge shapes, fp32 and bf16, each row naming the
   kernel variant it launched; every edge shape runs through the variant
   the wrapper picks and, where the other variant takes it too, that one
   forced:
   flash attention at full-width Llama-3.2-1B and Granite-3.0-1B-A400M
   prefill and a decode step on a strided cache view, and bf16 rows whose
   rows cannot take 16-byte copies;
   the LSTM cell's forward (tensor-core ``tc`` tile and FMA kernel) and
   pointwise backward at full-width BigLSTM (B 16, d_in 1024, d_h 1024, H
   8192) and at shapes where B and H are no tile multiples, h' and c' the
   same bits with and without the gates, and the cell's autograd function
   (dx, dh, dc, dWx, dWh, db) against autograd of the plain oracle; the
   grouped matmul at full-width Granite-3.0-1B-A400M's four expert products
   (prefill at capacity 640, decode at C 4) and at edge shapes (odd C, d, F;
   G, C and d of 1); the RWKV6 WKV recurrence (``chunked`` form on the
   tensor cores and sequential ``scan``) at full-width RWKV6-7B prefill (B
   4, T 512, H 64, hd 64, r, k, v in bf16 and f32) and a decode step (T 1,
   from a non-zero state, in place), at edge shapes (T 1, 7, 16, 17, 33,
   130; hd 32; B 1, H 1) and over long prompts from a state (decays near 1
   over T 2048 and 8192, strong decays down to 1e-38 over T 2048), outputs
   and final state.  Time each kernel variant at the main shape, its plain
   version and one PyTorch library call computing the same function where
   there is one (a yardstick the port never calls): device time per call
   from torch.profiler (``ms``) and CUDA-event time per call, host gaps
   included (``call_ms``);
4. serve full-width, full-depth Llama-3.2-1B from a seeded random init
   through ``ServeEngine.generate`` (4 prompts of 512 tokens, 32 new tokens,
   greedy) with the launch counters set to 0 just before and read just after
   (every bf16 flash launch on a tensor-core variant), then profile one
   prefill and one decode step (torch.profiler: wall time, device busy time,
   idle share, top kernels; no more kernels a decode step than in PR 14);
5. hold the serving model path against its plain path: the same weights at 2
   layers of full width in f32, kernels on the card against the plain
   versions on the CPU;
6. train full-width, full-depth BigLSTM (1.78 B parameters) from a seeded
   init through the launcher (``repro_torch.launch.train.main``: 5 steps at
   B 16, T 64, AdamW over warmup-cosine, clip 1.0) with the launch counters
   set to 0 just before and read just after (640 forward launches, all on
   the ``tc`` variant, and 640 backward cell launches); then time steps
   (ms, tokens/s, peak memory) and profile one;
7. hold the train step against its plain path: one step at the full LSTM
   width, 2 layers, f32, vocab cut to 32768, kernels on the card against the
   plain versions on the CPU (loss and gradient norm within 1e-4 relative,
   LSTM parameters after the update within 1e-3);
8. serve full-width, full-depth Granite-3.0-1B-A400M (MoE, 1.39 B
   parameters) as phase 4 serves Llama: 2376 gmm and 792 flash-attention
   launches per ``generate``, all on the tensor-core variants, then the same
   profile;
9. hold the MoE model path against its plain path: 2 layers at full width in
   f32, prefill and one decode step, logits within 1e-3, and the count of
   (token, k) routing ids that differ between the card and the CPU;
10. serve full-width, full-depth RWKV6-7B (7.53 B parameters, 30.1 GB in
   f32) as phase 4 serves Llama: 1056 wkv6 launches per ``generate`` (32
   layers: 32 ``chunked`` in prefill, 1024 ``scan`` in 32 decode steps),
   then the same profile, and free its weights;
11. hold the RWKV model path against its plain path: 2 layers at full width
   in f32, prefill and 3 decode steps, logits within 1e-3 and the cache's
   WKV state within 1e-4 of its largest entry;
12. print one JSON line of kernels, then the device line.

Needs one card and exits non-zero, printing no result, without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
L2_BYTES = 50e6
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BATCH, PROMPT, NEW = 4, 512, 32
TRAIN_B, TRAIN_T, TRAIN_STEPS = 16, 64, 5
LSTM_FULL = (TRAIN_B, 1024, 1024, 8192)         # B, d_in, d_h, H of BigLSTM's cell
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}   # tests/test_kernels.py::test_gmm_sweep
# G, C, d, F of full-width Granite-3.0-1B-A400M's expert products: 32 experts,
# capacity ceil(4 * 512 * 8 / 32 * 1.25) = 640 in prefill, C = 4 (no drop) in decode
GMM_SERVE = [("prefill wg/wi", (32, 640, 1024, 512)), ("prefill wo", (32, 640, 512, 1024)),
             ("decode wg/wi", (32, 4, 1024, 512)), ("decode wo", (32, 4, 512, 1024))]
GMM_EDGE = [(8, 37, 130, 70), (4, 100, 192, 160), (1, 1, 1, 1), (1, 20, 64, 64),
            (3, 1, 64, 48), (2, 17, 1, 9)]
# tests/test_kernels.py::test_wkv6_sweep's tolerance, on the error over max(1,
# the largest reference value): the kernel adds the same f32 terms as the
# plain scan in another order (FMAs, the row sum split four ways)
WKV_TOL = 2e-4
# B, T, H, hd of full-width RWKV6-7B's WKV: prefill of 4 x 512 tokens, a decode step
WKV_SERVE = [("prefill", (BATCH, PROMPT, 64, 64)), ("decode", (BATCH, 1, 64, 64))]
WKV_EDGE = [(1, 1, 1, 32), (2, 7, 3, 64), (2, 130, 2, 32), (1, 33, 2, 64), (1, 7, 1, 64),
            (2, 16, 3, 64), (1, 17, 2, 32)]
# T, decays and dtype of the long-prompt rows (B 1, H 2, hd 64, from a state)
WKV_LONG = [(2048, "near1", torch.bfloat16), (8192, "near1", torch.float32),
            (2048, "strong", torch.bfloat16)]
# kernels a decode step on PR 14's tree (PERF.md section 5): Llama and
# Granite the same in four profiles of one step, RWKV the most a PR 14
# profile saw.  A single profile may see fewer: torch.profiler drops events
# now and then, never adds them.
PR14_DECODE_KERNELS = {"llama3.2-1b": 1262, "granite-moe-1b-a400m": 3254, "rwkv6-7b": 2955}


def _phase(name):
    print(f"== {name}", flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Milliseconds per call between CUDA events around ``reps`` calls: the
    device time plus any gap where the device waited for the host."""
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


def device_ms(fn, reps=20, warmup=3):
    """Device milliseconds per call: the time of the CUDA kernels (and
    copies) that torch.profiler saw over ``reps`` calls.  Unlike
    ``time_ms`` it leaves out the host's launch gaps, which for a kernel of
    a few microseconds are most of a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profiling session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / reps
    raise RuntimeError("torch.profiler recorded no device time in three sessions")


def time_into(row, key, fn, reps=20):
    """row[key]: device ms per call; row[key with "call_ms"]: event ms."""
    row[key] = device_ms(fn, reps)
    row[key.removesuffix("ms") + "call_ms"] = time_ms(fn, reps)


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


def launched_variant(fn, call):
    """``call()``'s result and the one variant of ``fn`` whose launch counter
    it moved (each launch adds one to ``fn.launches`` and to its variant's)."""
    before = dict(fn.variant_launches)
    out = call()
    moved = {n: c - before[n] for n, c in fn.variant_launches.items() if c != before[n]}
    if len(moved) != 1 or list(moved.values()) != [1]:
        raise AssertionError(f"one call moved the variant counters by {moved}")
    return out, next(iter(moved))


def check_attention(fa, case, q, k, v, *, causal, window=0, timed=False):
    """Kernel against plain version on the same inputs; optionally timed."""
    out, variant = launched_variant(fa.flash_attention, lambda: fa.flash_attention(
        q, k, v, causal=causal, window=window))
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[q.dtype]
    row = {"shape": case, "dtype": str(q.dtype).removeprefix("torch."), "variant": variant,
           "max_abs_err": err, "tol": tol}
    if variant != fa.flash_variant(q, k, v):
        raise AssertionError(f"flash_attention {case}: launched {variant}, "
                             f"flash_variant says {fa.flash_variant(q, k, v)}")
    if not err < tol or not torch.isfinite(out).all():
        raise AssertionError(f"flash_attention {case}: max abs err {err} >= {tol}")
    if timed:
        time_into(row, "ms", lambda: fa.flash_attention(q, k, v, causal=causal,
                                                         window=window))
        time_into(row, "plain_ms", lambda: fa.flash_attention_ref(
            q, k, v, causal=causal, window=window))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        time_into(row, "library_ms", lambda: sdpa(qt, kt, vt, is_causal=causal,
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
    # prefill and a decode step at full width: Llama-3.2-1B's 32 query heads
    # over 8 KV heads, then Granite-3.0-1B-A400M's 16 over 8 (both hd 64)
    for h in (32, 16):
        q, k, v = rnd(BATCH, PROMPT, h, 64, dtype=bf), rnd(BATCH, PROMPT, 8, 64, dtype=bf), \
            rnd(BATCH, PROMPT, 8, 64, dtype=bf)
        rows.append(check_attention(fa, f"prefill B4 T512 H{h}/8 hd64 causal", q, k, v,
                                    causal=True, timed=True))
        # decode: one query against the valid prefix, a strided view of the cache
        cap, n = PROMPT + NEW + 8, PROMPT + 1
        kc, vc = rnd(BATCH, cap, 8, 64, dtype=bf), rnd(BATCH, cap, 8, 64, dtype=bf)
        rows.append(check_attention(fa, f"decode B4 Tq1 Tk513(view of 552) H{h}/8 hd64",
                                    rnd(BATCH, 1, h, 64, dtype=bf), kc[:, :n], vc[:, :n],
                                    causal=False, timed=True))
    # bf16 rows that cannot take 16-byte async copies (q's base 2 bytes off):
    # the FMA kernel at Llama's prefill shape
    qm = torch.empty(1 + q.numel(), dtype=bf, device=dev)[1:].view(BATCH, PROMPT, 16, 64)
    qm.copy_(q)
    rows.append(check_attention(fa, "prefill B4 T512 H16/8 hd64 causal, q misaligned", qm, k, v,
                                causal=True))
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


def bound_ms(nbytes, flops, dtype):
    """Least time on the card: the bytes moved (each input read once, each
    output written once) at the HBM rate, or the FLOPs at the dtype's peak."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _max_err(got, want):
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def _lstm_row(name, case, dtype, got, want, tol):
    err = _max_err(got, want)
    row = {"kernel": name, "shape": case, "dtype": str(dtype).removeprefix("torch."),
           "max_abs_err": err, "tol": tol}
    if not err < tol or not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{name} {case}: max abs err {err} >= {tol} or not finite")
    return row


def lstm_inputs(gen, b, d_in, d_h, hh, dtype):
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return [rnd(b, d_in).to(dtype), rnd(b, d_h).to(dtype), rnd(b, hh, scale=0.5).to(dtype),
            rnd(d_in, 4, hh, scale=d_in ** -0.5).to(dtype),
            rnd(d_h, 4, hh, scale=d_h ** -0.5).to(dtype), rnd(4, hh, scale=0.1)]


def check_lstm_fwd(lc, args, case, timed=False, variant=None):
    """The forward kernel (writing its gates, as in training) against its
    plain version, through the variant ``lstm_variant`` picks or, when
    ``variant`` is given, that one forced; h' and c' must come out the same
    bits without the gates.  Timed against the plain version, the bound
    and PyTorch's own LSTM cell path (two GEMMs and
    ``_thnn_fused_lstm_cell``: ``torch.lstm_cell`` itself refuses a cell
    state wider than its recurrent input, and BigLSTM's is 8192 against
    1024)."""
    x, h, c, wx, wh, b = args
    dt = x.dtype

    def run(want_gates=True):
        if variant is None:
            return lc.lstm_cell_fwd(*args, want_gates=want_gates)
        bsz, hh = c.shape
        outs = [torch.empty((bsz, hh), dtype=dt, device=x.device) for _ in range(2)]
        gates = torch.empty((bsz, 4, hh), device=x.device) if want_gates else None
        return lc._launch_fwd(*args, *outs, gates, variant)

    (hn, cn, gates), launched = launched_variant(lc.lstm_cell_fwd, run)
    torch.cuda.synchronize()
    if launched != (variant or lc.lstm_variant(x, h, wx, wh)):
        raise AssertionError(f"lstm_cell_fwd {case}: launched {launched}")
    rh, rc, ract = lc.lstm_cell_plain(*args, with_gates=True)
    row = _lstm_row("lstm_cell_fwd", case, dt, (hn, cn), (rh, rc), TOL[dt])
    row["variant"] = launched
    row["gates_max_abs_err"] = float((gates - ract).abs().max())
    if not row["gates_max_abs_err"] < 1e-4:
        raise AssertionError(f"lstm_cell_fwd {case}: gates off by {row['gates_max_abs_err']}")
    hn2, cn2, _ = run(want_gates=False)
    if not (torch.equal(hn2, hn) and torch.equal(cn2, cn)):
        raise AssertionError(f"lstm_cell_fwd {case}: h', c' differ without the gates")
    if timed:
        bsz, d_in, d_h, hh = x.shape[0], x.shape[1], h.shape[1], c.shape[1]
        time_into(row, "ms", run)
        time_into(row, "plain_ms", lambda: lc.lstm_cell_plain(*args, with_gates=True))
        wx_t = wx.reshape(d_in, 4 * hh).t().contiguous()
        wh_t = wh.reshape(d_h, 4 * hh).t().contiguous()
        b_fold = b.clone()
        b_fold[1] += 1.0                                   # the forget bias, folded in
        b_fold = b_fold.reshape(-1).to(dt)
        zero_b = torch.zeros_like(b_fold)
        lin = torch.nn.functional.linear

        def library():
            return torch.ops.aten._thnn_fused_lstm_cell(lin(x, wx_t), lin(h, wh_t), c,
                                                        b_fold, zero_b)

        lh, lcn, _ = library()
        row["library_max_abs_err"] = _max_err((lh, lcn), (rh, rc))
        time_into(row, "library_ms", library)
        row["library"] = "linear x2 + aten._thnn_fused_lstm_cell (torch.lstm_cell's CUDA path)"
        row["bound_ms"], row["bound_by"] = bound_ms(
            _nbytes(x, h, c, wx, wh, b, hn, cn, gates), 2.0 * bsz * (d_in + d_h) * 4 * hh, dt)
    print(json.dumps(row), flush=True)
    return row, (hn, cn, gates)


def check_lstm_bwd(lc, gates, c, c_new, dh, dc, case, timed=False):
    """The pointwise backward kernel against its plain version; timed against
    the plain version, the bound and PyTorch's fused LSTM-cell backward
    (``_thnn_fused_lstm_cell_backward_impl``, which also sums db)."""
    dt = c.dtype
    dg, dcp = lc.lstm_cell_bwd_pointwise(gates, c, dh, dc)
    torch.cuda.synchronize()
    rg, rcp = lc.lstm_cell_bwd_pointwise_plain(gates, c, dh, dc)
    row = _lstm_row("lstm_cell_bwd_pointwise", case, dt, (dg, dcp), (rg, rcp), TOL[dt])
    if timed:
        bsz, hh = c.shape
        time_into(row, "ms", lambda: lc.lstm_cell_bwd_pointwise(gates, c, dh, dc))
        time_into(row, "plain_ms", lambda: lc.lstm_cell_bwd_pointwise_plain(gates, c, dh, dc))
        workspace = gates.reshape(bsz, 4 * hh).to(dt)

        def library():
            return torch.ops.aten._thnn_fused_lstm_cell_backward_impl(dh, dc, c, c_new,
                                                                      workspace, True)

        lg, lcp, _ = library()
        row["library_max_abs_err"] = _max_err((lg, lcp), (rg.reshape(bsz, 4 * hh), rcp))
        time_into(row, "library_ms", library)
        row["library"] = "aten._thnn_fused_lstm_cell_backward_impl"
        row["bound_ms"], row["bound_by"] = bound_ms(
            _nbytes(gates, c, dh, dc, dg, dcp), 20.0 * bsz * hh, torch.float32)
    print(json.dumps(row), flush=True)
    return row


def check_cell_grads(lc, ref_mod, args):
    """dx, dh, dc, dWx, dWh, db of ``LSTMCellFunction`` (the two kernels and
    plain GEMMs) against autograd through the plain oracle, both on the card
    in f32 with TF32 off; each within 1e-4 of max(1, its largest value)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    d_out = [torch.randn(args[2].shape, generator=gen, device="cuda") for _ in range(2)]
    ours = [t.clone().requires_grad_() for t in args]
    refs = [t.clone().requires_grad_() for t in args]
    got = torch.autograd.grad(lc.lstm_cell(*ours), ours, d_out)
    want = torch.autograd.grad(ref_mod.lstm_cell_ref(*refs), refs, d_out)
    errs = {}
    for name, g, w in zip(("dx", "dh", "dc", "dwx", "dwh", "db"), got, want):
        errs[name] = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
    print(json.dumps({"lstm_cell_function_grads": "B16 din1024 dh1024 H8192 f32",
                      "rel_err": errs, "tol": 1e-4}), flush=True)
    if not max(errs.values()) < 1e-4:
        raise AssertionError(f"LSTMCellFunction grads disagree with autograd: {errs}")
    return max(errs.values())


def phase_lstm_kernels(lc, ref_mod):
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_rows, bwd_rows = [], []
    for dt in (torch.bfloat16, torch.float32):   # BigLSTM's training cell, full width
        args = lstm_inputs(gen, *LSTM_FULL, dtype=dt)
        row, (hn, cn, gates) = check_lstm_fwd(lc, args, "B16 din1024 dh1024 H8192", timed=True)
        fwd_rows.append(row)
        if row["variant"] == "tc":   # the FMA kernel on the same bf16 inputs
            fwd_rows.append(check_lstm_fwd(lc, args, "B16 din1024 dh1024 H8192", timed=True,
                                           variant="fma")[0])
        dh, dc = (torch.randn(hn.shape, generator=gen, device="cuda").to(dt) for _ in range(2))
        bwd_rows.append(check_lstm_bwd(lc, gates, args[2], cn, dh, dc, "B16 H8192",
                                       timed=True))
    # edge shapes: B and H no tile multiples, widths that the tensor-core
    # tile does not take (fma) and that it does (tc, then fma forced)
    for b, d_in, d_h, hh in [(1, 24, 16, 70), (5, 64, 40, 33), (17, 40, 12, 130),
                             (3, 16, 8, 1), (1, 1024, 1024, 8192), (1, 24, 16, 72),
                             (5, 64, 40, 72), (17, 40, 16, 136), (33, 128, 64, 264)]:
        for dt in (torch.float32, torch.bfloat16):
            args = lstm_inputs(gen, b, d_in, d_h, hh, dtype=dt)
            case = f"B{b} din{d_in} dh{d_h} H{hh}"
            row, (hn, cn, gates) = check_lstm_fwd(lc, args, case)
            fwd_rows.append(row)
            if row["variant"] == "tc":
                fwd_rows.append(check_lstm_fwd(lc, args, case, variant="fma")[0])
            dh = torch.randn(hn.shape, generator=gen, device="cuda").to(dt)
            bwd_rows.append(check_lstm_bwd(lc, gates, args[2], cn, dh, None,
                                           f"B{b} H{hh} dc=None"))
    # x one element past a 16-byte boundary: the FMA kernel at bf16
    x, *rest = lstm_inputs(gen, *LSTM_FULL, dtype=torch.bfloat16)
    xm = torch.empty(1 + x.numel(), dtype=x.dtype, device=x.device)[1:].view(x.shape)
    xm.copy_(x)
    fwd_rows.append(check_lstm_fwd(lc, [xm, *rest], "B16 din1024 dh1024 H8192, x misaligned")[0])
    grads_err = check_cell_grads(lc, ref_mod, lstm_inputs(gen, *LSTM_FULL, dtype=torch.float32))
    return fwd_rows, bwd_rows, grads_err


def gmm_inputs(gen, g, c, d, f, dtype):
    x = torch.randn((g, c, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((g, d, f), generator=gen, device="cuda") * d ** -0.5).to(dtype)
    return x, w


def check_gmm(gm, ref_mod, case, x, w, gen, timed=False):
    """The grouped matmul against its plain version; timed against the plain
    version, the bound and ``torch.bmm`` on the same tensors.  The timed
    calls rotate over enough input sets (more than twice the 50 MB L2) that
    each finds its weights cold, as each layer of the model does."""
    out, variant = launched_variant(gm.gmm, lambda: gm.gmm(x, w))
    torch.cuda.synchronize()
    ref = ref_mod.gmm_ref(x, w)
    err = float((out.float() - ref.float()).abs().max())
    tol = GMM_TOL[x.dtype]
    row = {"kernel": "gmm", "shape": f"{case} {tuple(x.shape)}@{tuple(w.shape)}",
           "dtype": str(x.dtype).removeprefix("torch."), "variant": variant,
           "max_abs_err": err, "tol": tol}
    if variant != gm.gmm_variant(x, w):
        raise AssertionError(f"gmm {case}: launched {variant}, gmm_variant says "
                             f"{gm.gmm_variant(x, w)}")
    if not err < tol or not torch.isfinite(out).all():
        raise AssertionError(f"gmm {case}: max abs err {err} >= {tol} or not finite")
    if timed:
        g, c, d = x.shape
        f = w.shape[2]
        n_sets = max(1, math.ceil(2 * L2_BYTES / _nbytes(x, w)))
        sets = [(x, w)] + [gmm_inputs(gen, g, c, d, f, x.dtype) for _ in range(n_sets - 1)]

        def rotating(fn):
            cycle = itertools.cycle(sets)
            return lambda: fn(*next(cycle))

        time_into(row, "ms", rotating(gm.gmm))
        time_into(row, "plain_ms", rotating(ref_mod.gmm_ref))
        time_into(row, "library_ms", rotating(torch.bmm))
        row["library"] = "torch.bmm"
        row["input_sets"] = n_sets
        row["bound_ms"], row["bound_by"] = bound_ms(_nbytes(x, w, out), 2.0 * g * c * d * f,
                                                    x.dtype)
    print(json.dumps(row), flush=True)
    return row


def phase_gmm_kernels(gm, ref_mod):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case, (g, c, d, f) in GMM_SERVE:   # bf16 timed first: the main path's dtype
        rows.append(check_gmm(gm, ref_mod, case, *gmm_inputs(gen, g, c, d, f, torch.bfloat16),
                              gen, timed=True))
    for case, (g, c, d, f) in GMM_SERVE:
        rows.append(check_gmm(gm, ref_mod, case, *gmm_inputs(gen, g, c, d, f, torch.float32),
                              gen))
    # bf16 with x's base 2 bytes off: the FMA kernel at the prefill shape
    x, w = gmm_inputs(gen, *GMM_SERVE[0][1], torch.bfloat16)
    xm = torch.empty(1 + x.numel(), dtype=x.dtype, device=x.device)[1:].view(x.shape)
    xm.copy_(x)
    rows.append(check_gmm(gm, ref_mod, f"{GMM_SERVE[0][0]}, x misaligned", xm, w, gen))
    for g, c, d, f in GMM_EDGE:
        for dt in (torch.float32, torch.bfloat16):
            rows.append(check_gmm(gm, ref_mod, "edge", *gmm_inputs(gen, g, c, d, f, dt), gen))
    return rows


def wkv_inputs(gen, b, t, h, hd, dtype, state, decay="sweep"):
    """r, k, v, w, u as tests/test_kernels.py::test_wkv6_sweep draws them (r,
    k, v in ``dtype``) and, if ``state``, a non-zero initial state.
    ``decay`` "near1" draws w in [0.999, 1), "strong" log-uniform in [1e-38,
    1e-3] (log w down to -87.5 a token)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.5

    r, k, v = (rnd(b, t, h, hd).to(dtype) for _ in range(3))
    uni = torch.rand((b, t, h, hd), generator=gen, device="cuda")
    w = {"sweep": lambda: torch.exp(-torch.exp(rnd(b, t, h, hd) - 2)),
         "near1": lambda: 1 - uni * 1e-3,
         "strong": lambda: torch.exp(math.log(1e-38) + uni * (math.log(1e-3) - math.log(1e-38)))
         }[decay]()
    u = rnd(h, hd) * 0.2
    return r, k, v, w, u, (rnd(b, h, hd, hd) * 4 if state else None)


def check_wkv(wk, ref_mod, case, inputs, gen, timed=False, variant=None):
    """The WKV kernel against its plain version, outputs and final state,
    through the variant ``wkv_variant`` picks or, when ``variant`` is given,
    that one forced; a given state is written in place.  Timed calls
    rotate over enough input sets (more than twice the 50 MB L2) that each
    finds its state and inputs cold, as each layer does."""
    r, k, v, w, u, s0 = inputs

    def run(r, k, v, w, u, s):
        return wk.wkv6(r, k, v, w, u, s) if variant is None else \
            wk._launch(r, k, v, w, u, s, variant)

    state = None if s0 is None else s0.clone()
    (out, s), launched = launched_variant(wk.wkv6, lambda: run(r, k, v, w, u, state))
    torch.cuda.synchronize()
    if launched != (variant or wk.wkv_variant(r, k, v, w)):
        raise AssertionError(f"wkv6 {case}: launched {launched}")
    want_out, want_s = ref_mod.wkv6_ref(r, k, v, w, u, s0)
    errs = [float((g - x).abs().max()) for g, x in ((out, want_out), (s, want_s))]
    rel = max(e / max(1.0, float(x.abs().max())) for e, x in zip(errs, (want_out, want_s)))
    b, t, h, hd = r.shape
    row = {"kernel": "wkv6", "shape": f"{case} B{b} T{t} H{h} hd{hd}"
           + (" from a state, in place" if s0 is not None else ""),
           "dtype": str(r.dtype).removeprefix("torch."), "variant": launched,
           "max_abs_err": max(errs), "state_max_abs_err": errs[1], "rel_err": rel,
           "tol": WKV_TOL}
    if not rel < WKV_TOL or not torch.isfinite(out).all() or \
            (state is not None and s is not state):
        raise AssertionError(f"wkv6 {case} ({launched}): error {rel} over max(1, |ref|) >= "
                             f"{WKV_TOL}, not finite, or the state was not written in place")
    if timed:
        n_sets = max(1, math.ceil(2 * L2_BYTES / _nbytes(*inputs, out)))
        sets = [inputs] + [wkv_inputs(gen, b, t, h, hd, r.dtype, s0 is not None)
                           for _ in range(n_sets - 1)]

        def rotating(fn):
            cycle = itertools.cycle(sets)
            return lambda: fn(*next(cycle))

        time_into(row, "ms", rotating(run))
        # the plain scan launches ~7 small kernels a token: fewer calls
        time_into(row, "plain_ms", rotating(ref_mod.wkv6_ref), reps=5)
        row["library_ms"] = None
        row["library"] = "none: no single PyTorch call computes the WKV recurrence"
        row["input_sets"] = n_sets
        # r, k, v, w, u (and the initial state) read once, out and the final
        # state written once; one FMA for the output and one for the state
        # update per (token, head, row, column), in f32
        row["bound_ms"], row["bound_by"] = bound_ms(_nbytes(*inputs, out, s),
                                                    4.0 * b * t * h * hd * hd, torch.float32)
    print(json.dumps(row), flush=True)
    return row


def phase_wkv_kernels(wk, ref_mod):
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    rows = []   # bf16 timed first: the main path's dtype
    for case, shape in WKV_SERVE:
        inputs = wkv_inputs(gen, *shape, bf, case == "decode")
        rows.append(check_wkv(wk, ref_mod, case, inputs, gen, timed=True))
        if case == "prefill":   # the scan on the same inputs
            rows.append(check_wkv(wk, ref_mod, case, inputs, gen, timed=True, variant="scan"))
    for case, shape in WKV_SERVE:
        rows.append(check_wkv(wk, ref_mod, case, wkv_inputs(gen, *shape, f32, case == "decode"),
                              gen))
    # edge shapes through the variant wkv_variant picks and the other forced
    for shape in WKV_EDGE:
        for dt, state in ((f32, False), (bf, True)):
            inputs = wkv_inputs(gen, *shape, dt, state)
            picked = wk.wkv_variant(*inputs[:4])
            rows.append(check_wkv(wk, ref_mod, "edge", inputs, gen))
            rows += [check_wkv(wk, ref_mod, "edge", inputs, gen, variant=v)
                     for v in wk.VARIANTS if v != picked]
    # long prompts from a non-zero state: decays near 1, and strong decays
    for t, decay, dt in WKV_LONG:
        inputs = wkv_inputs(gen, 1, t, 2, 64, dt, True, decay=decay)
        for variant in wk.VARIANTS:
            rows.append(check_wkv(wk, ref_mod, f"{decay} decays", inputs, gen, variant=variant))
    return rows


def reset_counters(counters):
    for fn in counters.values():
        fn.launches = 0
        for name in getattr(fn, "variant_launches", {}):
            fn.variant_launches[name] = 0


def variant_launches(counters):
    return {name: dict(fn.variant_launches) for name, fn in counters.items()
            if hasattr(fn, "variant_launches")}


def phase_serve(counters, api_mod, engine_mod, cfg):
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
    reset_counters(counters)
    res = engine.generate(batch, max_new_tokens=NEW)
    launches = {name: fn.launches for name, fn in counters.items()}
    variants = variant_launches(counters)
    calls = cfg.n_layers * (1 + NEW)           # one prefill and NEW decode steps
    want = {"flash_attention": 0 if cfg.rwkv else calls,
            "gmm": 3 * calls if cfg.is_moe else 0, "wkv6": calls if cfg.rwkv else 0}
    if launches != want:
        raise AssertionError(f"generate launched {launches}, want {want}")
    # every bf16 flash and gmm launch of the serving path runs on the tensor
    # cores: the prefill tile in prefill, the decode tile in each decode step;
    # wkv6 runs the chunked form in prefill and the scan in decode
    want_variants = {name: dict.fromkeys(v, 0) for name, v in variants.items()}
    if not cfg.rwkv:
        want_variants["flash_attention"].update(tc_prefill=cfg.n_layers,
                                                tc_decode=cfg.n_layers * NEW)
    if cfg.is_moe:
        want_variants["gmm"].update(tc_prefill=3 * cfg.n_layers, tc_decode=3 * cfg.n_layers * NEW)
    if cfg.rwkv:   # the chunked form in prefill, the scan in each decode step
        want_variants["wkv6"].update(chunked=cfg.n_layers, scan=cfg.n_layers * NEW)
    if cfg.dtype != "bfloat16" or variants != want_variants:
        raise AssertionError(f"generate launched the variants {variants} ({cfg.dtype}), "
                             f"want {want_variants}")
    if not torch.isfinite(res.logprobs).all() or res.tokens.shape != (BATCH, NEW) \
            or int(res.tokens.min()) < 0 or int(res.tokens.max()) >= cfg.vocab_size:
        raise AssertionError("generate returned bad tokens or logprobs")
    step_ms = res.decode_ms / res.decode_steps
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": BATCH, "prompt": PROMPT,
           "new": NEW, "prefill_ms": res.prefill_ms, "decode_ms_per_step": step_ms,
           "tok_per_s": BATCH * NEW / ((res.prefill_ms + res.decode_ms) / 1e3),
           "decode_tok_per_s": BATCH * res.decode_steps / (res.decode_ms / 1e3),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "variant_launches": variants}
    print(json.dumps(out), flush=True)
    print("first sequence:", res.tokens[0].tolist(), flush=True)
    _, decode = phase_profile(api, params, batch)
    # the split decode tile merges its partials in the same launch: no more
    # kernels a decode step than PR 14's profile saw (the profiler may drop
    # events, never add them)
    if decode["kernels"] > PR14_DECODE_KERNELS[cfg.name]:
        raise AssertionError(f"{decode['kernels']} kernels a decode step, PR 14 ran "
                             f"{PR14_DECODE_KERNELS[cfg.name]}")
    del params, engine
    torch.cuda.empty_cache()
    return launches, variants


def profile_call(name, fn, reps=3):
    """Where one call spends its time: wall time on the host clock (ending in
    a synchronize) unprofiled over ``reps`` calls and profiled over one,
    device busy time as the sum of the CUDA kernels the profiler saw, the
    idle share against the unprofiled wall time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / reps
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"profile": name, "unprofiled_wall_ms": unprofiled_ms, "wall_ms": wall_ms,
           "device_busy_ms": busy, "idle_share": 1 - busy / unprofiled_ms,
           "kernels": len(kern), "top": [[n[:80], ms] for n, ms in top]}
    print(json.dumps(out), flush=True)
    return out


def phase_profile(api, params, batch):
    """One prefill and one decode step through ``profile_call``; returns both
    profiles."""
    with torch.inference_mode():
        _, cache = api.prefill(params, batch, capacity=PROMPT + NEW + 8)
        step = {"tokens": batch["tokens"][:, -1:]}
        return (profile_call("prefill",
                             lambda: api.prefill(params, batch, capacity=PROMPT + NEW + 8)),
                profile_call("decode_step", lambda: api.decode_fn(params, dict(cache), step)))


@contextlib.contextmanager
def recorded_routes(moe_mod):
    """Collects the (t, k) expert ids of every ``moe._route`` call."""
    routes, route = [], moe_mod._route

    def recording(*args, **kw):
        out = route(*args, **kw)
        routes.append(out[0].cpu())
        return out

    moe_mod._route = recording
    try:
        yield routes
    finally:
        moe_mod._route = route


def _route_mismatch(card_routes, cpu_routes, shape):
    """(number of (token, k) ids the card chose that the CPU did not, a
    (B, T) mask of the tokens routed alike in every layer)."""
    n_diff, same = 0, torch.ones(shape[0] * shape[1], dtype=torch.bool)
    for g, c in zip(card_routes, cpu_routes, strict=True):
        missing = (g[:, :, None] != c[:, None, :]).all(-1)        # (t, k)
        n_diff += int(missing.sum())
        same &= ~missing.any(-1)
    return n_diff, same.view(shape)


def phase_model_vs_plain(api_mod, moe_mod, cfg, decode_steps=3):
    """2 layers at full width in f32: the card's kernels against the plain
    versions on the CPU, same weights and tokens; logits within 1e-3.  For
    an MoE model also count the (token, k) routing ids that differ between
    the two; where some do, the logits are compared on the tokens routed
    alike in every layer, and the others are counted.  For an RWKV model
    also hold the cache's WKV state after prefill and after the last decode
    step within 1e-4 of its largest entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    gpu, cpu = (api_mod.build_model(cfg2, device=d) for d in ("cuda", "cpu"))
    params = gpu.init(1)
    params_cpu = _tree_to(params, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    worst, n_route_diff, n_tokens_apart, state_rel = 0.0, 0, 0, 0.0

    def compare(run_card, run_cpu, shape):
        nonlocal worst, n_route_diff, n_tokens_apart
        with recorded_routes(moe_mod) as card_routes:
            out_g = run_card()
        with recorded_routes(moe_mod) as cpu_routes:
            out_c = run_cpu()
        diff, same = _route_mismatch(card_routes, cpu_routes, shape)
        n_route_diff += diff
        n_tokens_apart += int((~same).sum())
        gap = (out_g[0].cpu() - out_c[0]).abs().amax(-1)          # (B, T)
        worst = max(worst, float(gap[same].max()))
        return out_g, out_c

    def compare_state(cache_card, cache_cpu):
        nonlocal state_rel
        want = cache_cpu["wkv_S"]
        gap = float((cache_card["wkv_S"].cpu() - want).abs().max())
        state_rel = max(state_rel, gap / float(want.abs().max()))

    with torch.inference_mode():
        (_, cg), (lc, cc) = compare(
            lambda: gpu.prefill(params, {"tokens": tokens.cuda()}, capacity=56),
            lambda: cpu.prefill(params_cpu, {"tokens": tokens}, capacity=56), tokens.shape)
        if cfg.rwkv:
            compare_state(cg, cc)
        nxt = lc[:, -1].argmax(-1)[:, None]
        for _ in range(decode_steps):
            (_, cg), (lc, cc) = compare(
                lambda: gpu.decode_fn(params, cg, {"tokens": nxt.cuda()}),
                lambda: cpu.decode_fn(params_cpu, cc, {"tokens": nxt}), nxt.shape)
            nxt = lc[:, -1].argmax(-1)[:, None]
        if cfg.rwkv:
            compare_state(cg, cc)
    out = {"arch": cfg.name, "model_vs_plain_max_abs_logit_diff": worst, "tol": 1e-3}
    if cfg.is_moe:
        out.update(routing_ids_differing=n_route_diff, tokens_routed_apart=n_tokens_apart)
    if cfg.rwkv:
        out.update(wkv_state_rel_diff=state_rel, wkv_state_tol=1e-4)
    print(json.dumps(out), flush=True)
    if not worst <= 1e-3 or not state_rel <= 1e-4:
        raise AssertionError(f"model path disagrees with its plain path: logits {worst}, "
                             f"WKV state {state_rel}")
    return out


def _tree_to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device, copy=True), tree)


def _lm_batch(seq, batch, epoch=0):
    """One batch of the launcher's data: the Markov LM over 64 symbols."""
    from repro_torch.data import make_lm_dataset
    b = next(make_lm_dataset(vocab=64, seq_len=seq).epoch(epoch, batch))
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def phase_train(train_launch, lc, counters, api_mod, cfg):
    """Full-width, full-depth BigLSTM through the launcher, counters set to 0
    just before and read just after; then step time and a profile of one
    step, continuing from the trained state."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters({"lstm_cell_fwd": lc.lstm_cell_fwd,
                    "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters})
    t0 = time.perf_counter()
    summary = train_launch.main(["--arch", "biglstm", "--steps", str(TRAIN_STEPS),
                                 "--batch", str(TRAIN_B), "--seq", str(TRAIN_T)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"lstm_cell_fwd": lc.lstm_cell_fwd.launches,
                "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise.launches,
                **{name: fn.launches for name, fn in counters.items()}}
    fwd_variants = dict(lc.lstm_cell_fwd.variant_launches)
    want = TRAIN_STEPS * cfg.n_layers * TRAIN_T
    if launches != {"lstm_cell_fwd": want, "lstm_cell_bwd_pointwise": want,
                    **{name: 0 for name in counters}}:
        raise AssertionError(f"training launched {launches}, want {want} forward and "
                             f"{want} backward cell kernels")
    # every forward launch of the bf16 model runs on the tensor cores
    if fwd_variants != {"fma": 0, "tc": want}:
        raise AssertionError(f"training's forward launches took {fwd_variants}, want all "
                             f"{want} on tc")
    state = summary["state"]
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    losses = summary["history"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or state.step != TRAIN_STEPS \
            or not all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)):
        raise AssertionError(f"training gave losses {losses} or non-finite parameters")
    out = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers, "batch": TRAIN_B,
           "seq": TRAIN_T, "steps": TRAIN_STEPS, "losses": losses,
           "launcher_wall_s": wall_s, "launches": launches,
           "lstm_cell_fwd_variant_launches": fwd_variants,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(out), flush=True)

    api = api_mod.build_model(cfg, device="cuda")
    step_fn = make_train_step(api, adamw(warmup_cosine(3e-3, 20, TRAIN_STEPS)), clip_norm=1.0)
    batch = {k: v.cuda() for k, v in _lm_batch(TRAIN_T, TRAIN_B, epoch=1).items()}
    box = [state]

    def one_step():
        box[0], metrics = step_fn(box[0], batch)
        return metrics

    prof = profile_call("train_step", one_step, reps=3)
    timing = {"step_ms": prof["unprofiled_wall_ms"],
              "tok_per_s": TRAIN_B * TRAIN_T / (prof["unprofiled_wall_ms"] / 1e3),
              "idle_share": prof["idle_share"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps({"train_step": timing}), flush=True)
    del summary, state, box
    torch.cuda.empty_cache()
    return launches, fwd_variants, timing


def phase_train_vs_plain(api_mod, cfg):
    """One train step at the full LSTM width, 2 layers, f32, vocab cut to
    32768: the card's kernels against the plain versions on the CPU from the
    same weights and batch."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, vocab_size=32768, dtype="float32")
    gpu, cpu = (api_mod.build_model(cfg2, device=d) for d in ("cuda", "cpu"))
    params = gpu.init(1)
    batch = _lm_batch(8, 4)
    results = {}
    for name, api, p, b in (("cuda", gpu, params, {k: v.cuda() for k, v in batch.items()}),
                            ("cpu", cpu, _tree_to(params, "cpu"), batch)):
        opt = adamw(warmup_cosine(3e-3, 20, TRAIN_STEPS))
        step = make_train_step(api, opt, clip_norm=1.0)
        state, metrics = step(TrainState(params=p, opt_state=opt.init(p), step=0), b)
        results[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                         [lp[k].cpu() for lp in state.params["lstm"] for k in sorted(lp)])
    (gl, gn, gp), (cl, cn, cp) = results["cuda"], results["cpu"]
    out = {"train_vs_plain": {"loss_rel": abs(gl - cl) / abs(cl),
                              "grad_norm_rel": abs(gn - cn) / abs(cn),
                              "lstm_params_max_abs": max(float((a - b).abs().max())
                                                         for a, b in zip(gp, cp)),
                              "loss": gl, "grad_norm": gn},
           "tol": {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "lstm_params_max_abs": 1e-3}}
    print(json.dumps(out), flush=True)
    r = out["train_vs_plain"]
    if not (r["loss_rel"] <= 1e-4 and r["grad_norm_rel"] <= 1e-4
            and r["lstm_params_max_abs"] <= 1e-3):
        raise AssertionError(f"train step on the card disagrees with its plain path: {r}")
    return r


def _kernel_entry(name, source, replaces, launches, rows, **extra):
    main_row = rows[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "variant": main_row.get("variant"), **extra,
            "shapes": [r for r in rows if "ms" in r]}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.launch import train as train_launch
    from repro_torch.models import api as api_mod
    from repro_torch.models import moe as moe_mod
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
    libs = build.build_all()
    print(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    _phase("3 kernels against their plain versions")
    rows = phase_kernels(fa)
    fwd_rows, bwd_rows, _ = phase_lstm_kernels(lc, ref_mod)
    gmm_rows = phase_gmm_kernels(gm, ref_mod)
    wkv_rows = phase_wkv_kernels(wk, ref_mod)
    counters = {"flash_attention": fa.flash_attention, "gmm": gm.gmm, "wkv6": wk.wkv6}

    _phase("4 serve llama3_2_1b, full width and depth")
    cfg = get_config("llama3_2_1b")
    launches, variants = phase_serve(counters, api_mod, engine_mod, cfg)

    _phase("5 model path against its plain path")
    phase_model_vs_plain(api_mod, moe_mod, cfg)

    _phase("6 train biglstm, full width and depth")
    lstm_cfg = get_config("biglstm")
    train_launches, train_variants, _ = phase_train(train_launch, lc, counters, api_mod,
                                                    lstm_cfg)

    _phase("7 train step against its plain path")
    phase_train_vs_plain(api_mod, lstm_cfg)

    _phase("8 serve granite_moe_1b_a400m, full width and depth")
    moe_cfg = get_config("granite_moe_1b_a400m")
    moe_launches, moe_variants = phase_serve(counters, api_mod, engine_mod, moe_cfg)

    _phase("9 MoE model path against its plain path")
    phase_model_vs_plain(api_mod, moe_mod, moe_cfg, decode_steps=1)

    _phase("10 serve rwkv6_7b, full width and depth")
    rwkv_cfg = get_config("rwkv6_7b")
    rwkv_launches, rwkv_variants = phase_serve(counters, api_mod, engine_mod, rwkv_cfg)

    _phase("11 RWKV model path against its plain path")
    phase_model_vs_plain(api_mod, moe_mod, rwkv_cfg)

    _phase("12 result")
    lstm_src = "src/repro_torch/kernels/csrc/lstm_cell.cu"
    kernels = [
        _kernel_entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:33",
                      launches["flash_attention"], rows,
                      launches_by_path={"serve llama3_2_1b": launches["flash_attention"],
                                        "serve granite_moe_1b_a400m":
                                            moe_launches["flash_attention"]},
                      variant_launches_by_path={
                          "serve llama3_2_1b": variants["flash_attention"],
                          "serve granite_moe_1b_a400m": moe_variants["flash_attention"]}),
        _kernel_entry("lstm_cell_fwd", lstm_src, "src/repro/kernels/lstm_cell.py:24",
                      train_launches["lstm_cell_fwd"], fwd_rows,
                      variant_launches=train_variants),
        _kernel_entry("lstm_cell_bwd_pointwise", lstm_src,
                      "src/repro/kernels/lstm_cell.py:24", train_launches[
                          "lstm_cell_bwd_pointwise"], bwd_rows,
                      note="no TPU backward kernel: JAX differentiates the plain cell "
                           "(src/repro/models/lstm.py:53)"),
        _kernel_entry("gmm", "src/repro_torch/kernels/csrc/moe_gmm.cu",
                      "src/repro/kernels/moe_gmm.py:23", moe_launches["gmm"], gmm_rows,
                      variant_launches=moe_variants["gmm"]),
        _kernel_entry("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                      "src/repro/kernels/rwkv_scan.py:25", rwkv_launches["wkv6"], wkv_rows,
                      library=wkv_rows[0]["library"], variant_launches=rwkv_variants["wkv6"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
