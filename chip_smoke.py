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
   prefill and a decode step on a strided cache view, over long prompts (T
   2048 and 8192, causal, Llama's heads), bf16 rows whose rows cannot
   take 16-byte copies, and SmolLM-360M's phase-15 micro-batch (B 2, T 512,
   15 query heads over 5);
   the flash-attention backward (tensor-core ``tc`` and FMA kernels) at the
   Llama training shape (B 4, T 2048, H 32/8, hd 64, causal; bf16 and f32),
   Granite's heads, SmolLM-360M's phase-15 micro-batch (B 2, T 512, H
   15/5) and edge shapes, with the forward's lse against its plain
   value, the output the same bits with and without lse, the gradients the
   same bits on a repeat launch, in f32 within 1e-4 of max(1, |ref|) and in
   bf16 within FlashAttention-2's rule (at most twice the error of autograd
   through the plain forward in bf16, plus 1e-3 max|ref|), timed against
   its plain version, its bound and the backward of
   ``F.scaled_dot_product_attention``;
   the two hops of phase 19's context ring (B 2, Tq = Tk 1024, H 32/8, hd
   64, bf16): the forward with lse on the diagonal block (causal) and on a
   block wholly in the past (not causal), and the backward of each given
   the global output and lse of attention over T 2048, each timed against
   its plain version, its bound and SDPA's call;
   the flash forward with lse and the backward at a tensor-MP rank's shape
   in phase 20 (a) (B 4, T 2048, H 16/4: Llama's 32/8 heads over 2 ranks,
   hd 64, bf16, causal), each timed against its plain version, its bound
   and SDPA's call;
   the LSTM cell's forward (tensor-core ``tc`` tile and FMA kernel) and
   pointwise backward at full-width BigLSTM (B 16, d_in 1024, d_h 1024, H
   8192; also at the pipeline's micro-batch rows B 4 and B 1), at GNMT's
   cells (B 128, d_in 1024 and 2048, H 1024, x a strided row of the layer
   input as the decoder's concat gives it; bf16 on ``tc``, f32 on ``fma``,
   timed against ``torch.lstm_cell``) and at shapes
   where B and H are no tile multiples, h' and c' the
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
12. train full-width, full-depth Llama-3.2-1B (1.50 B parameters) through
   the launcher (5 steps at B 4, T 2048) with the launch counters set to 0
   just before and read just after (80 forward launches, all ``tc_prefill``,
   and 80 backward calls, all ``tc``; the loss falls); then time steps (ms,
   tokens/s, peak memory) and profile one;
13. hold the Llama train step against its plain path: 2 layers at full
   width, f32, vocab cut to 32768, kernels on the card against the plain
   versions on the CPU (phase 7's limits);
14. the planner on the card: measure the card's memory, its HBM rate (a
   device-to-device copy of 2 GiB), the rate of a bf16 8192^3
   ``torch.matmul`` and the MFU of phase 12's Llama step, each beside the
   ``core.comm.HardwareModel`` default; set the planner's step-time and
   memory models beside phases 6 and 12's measured steps and peaks (findings,
   not limits); print the best H100 plan of Inception-V3, GNMT, BigLSTM and
   Llama-3.2-1B at 1, 8, 64, 256 and 1024 cards and each arch's crossover
   (every speedup finite, every chosen plan within the card's memory); then
   train full-width BigLSTM through ``--parallel auto --devices 1`` with the
   launch counters set to 0 just before and read just after (2 steps: 256
   forward launches, all ``tc``, and 256 backward), then train it 2 steps
   through ``--devices 64``: the H100 model's 1f1b 8 x 4 x 2 K16 plan,
   clamped to 1 DP x 2 stages on 2 ranks that share the card (K 16: 8192
   forward launches, all ``tc``, and 4096 backward, summed over the ranks),
   and record Llama's context plans at 8 cards (1 x 4 x 2, which phase 19
   trains) and at 64 (8 x 1 x 8: a ring of 8 full replicas does not fit the
   one card);
15. DP and pipeline ranks on the card, each run in its own ranks through the
   launcher (``launch.train``), which share the card (gloo, host-staged
   messages; their step times are not multi-card step times):
   (a) full-width, full-depth BigLSTM at ``pipe=2,micro=4,sched=1f1b``, B 16
   x T 64, 3 steps: the LSTM forward launches summed over the ranks are 2 L
   T K a step (the forward units and the backward's recompute), all on
   ``tc``, the pointwise backward L T K, stage 0's store high-water mark 2 =
   min(K, S); (b) the same at ``sched=gpipe``, stage 0's mark K = 4; (c)
   full-width, full-depth SmolLM-360M at ``dp=2,pipe=2,micro=2,sched=1f1b``,
   B 8 x T 512, 3 steps on 4 ranks: 2 L K dp flash-attention forward
   launches a step, all ``tc_prefill``, and L K dp backward calls, all
   ``tc``; each rank's peak memory, store mark and step ms beside the
   planner's per-device memory model, and the LSTM forward's device and
   event time at the micro-batch rows (B 4 and 1), its weights cold; (d) in
   phase 7's cell (2 full-width BigLSTM layers, f32, vocab 32768: the FMA
   LSTM kernel, not ``tc``) one step at ``pipe=2,micro=4,sched=1f1b`` and
   one at ``dp=2`` with the bucketed sync (``--comm-runtime overlapped``),
   each held against the single-process step on the card from the same
   seeded weights: loss and grad norm within 1e-4 relative, parameters
   within 5e-5 (under one AdamW step);
16. train full-width, full-depth GNMT (4 + 4 LSTM layers of 1024, vocab
   32000, 170.7 M parameters) through ``models.api.build_model`` +
   ``train.steps.make_train_step`` (5 steps at B 128, S = T = 50 of
   ``SyntheticSeq2Seq``, AdamW, clip 1.0) with the launch counters set to 0
   just before and read just after (2000 forward cell launches, all ``tc``,
   2000 backward, no other kernel); then time steps (ms, target tokens/s,
   peak memory) and profile one;
17. train full-width, full-depth Inception-V3 (11 blocks, 1000 classes) the
   same way, 5 steps at B 64 x 299 x 299 x 3 of seeded images, every
   hand-written kernel's counter 0 (its convolutions are cuDNN's, as JAX's
   are XLA's); then the same timing and profile;
18. (a) one f32 step of GNMT at full width and 2 + 2 layers (B 16, S = T =
   50) and of full-depth Inception-V3 (B 4 x 299) on the card against the
   plain path on the CPU from the same seeded weights (phase 7's limits),
   TF32 off; (b) the same cells at dp = 2 on 2 ranks sharing the card
   against the single-process card step (phase 15 (d)'s limits; Inception
   in f64 there, where no round-off flips the sign of AdamW's first step);
19. Llama-3.2-1B's context plan on ranks sharing the card (gloo,
   host-staged messages; no step time there is a multi-card step time):
   (a) full width and depth through ``--parallel auto --devices 8`` at B 2
   x T 2048, 2 steps: the 8-card plan (context 1 x 4 x 2) clamped to 1 DP x
   a ring of 2, with the counters set to 0 just before and read just after
   (96 flash forward launches summed over the ranks, all ``tc_prefill``,
   and 96 backward calls, all ``tc``: L m (m + 1) / 2 a step), finite
   losses, each rank's peak beside the planner's memory model; (b)
   ``ring_attention`` alone on 2 ranks at (a)'s shapes against
   single-process ``flash_attention`` at T 2048, forward and backward
   (bf16 within 2e-2 of max(1, |ref|), f32 within 1e-4), and (a)'s
   gradient sync alone on those ranks, timed; (c) 2 full-width
   layers in f32, vocab 32768, B 4 x T 512: a ``cp=2`` and a ``dp=2,cp=2``
   step against the single-process card step (phase 15 (d)'s limits);
20. tensor MP on ranks sharing the card (gloo, host-staged messages; no
   step time there is a multi-card step time): (a) full-width, full-depth
   Llama-3.2-1B through the launcher at ``--parallel mp=2 --comm-runtime
   overlapped --comm-chunks 2`` and at ``mp=2`` (``gspmd``), B 4 x T 2048,
   2 steps each on 2 ranks, with the counters set to 0 just before and
   read just after (L m flash forward launches a step summed over the
   ranks, all ``tc_prefill``, and as many backward calls, all ``tc``), each
   rank's peak GiB and step ms, the losses finite and equal on both ranks,
   and the wall time of one of those runs' all-reduces and ring hops
   alone; (b) 2 full-width layers in f32, vocab 32768, B 4 x T 512: ``mp=2``
   gspmd, ``mp=2`` overlapped with 1 and 2 chunks and ``dp=2,mp=2``
   overlapped, each step against the single-process card step (phase 15
   (d)'s limits), every leaf the rules replicate the same bits on every
   rank of a model group; (c) Inception-V3's 256-card plan from the
   planner (tensor 1 x 8 x 32) clamped to a model axis of 2 ranks: 2 bf16
   steps at B 64 x 299 (peak, step ms, no hand-written kernel), and one
   step in f64 at phase 18 (b)'s cell (B 4 x 299) against the single card
   step (phase 15 (d)'s limits; replicated leaves the same bits);
21. print one JSON line of kernels, then the device line.

Needs one card and exits non-zero, printing no result, without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import re
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
AUTO_STEPS = 2                                  # BigLSTM steps through --parallel auto
RANK_STEPS = 3                                  # steps of each phase-15 run
# phase 15 (d)'s parameters after one step: under the 1.5e-4 that AdamW's
# first step at lr(0) moves an element, so a skipped or mis-scaled update shows
RANK_PARAMS_TOL = 5e-5
SMOL_B, SMOL_T = 8, 512                         # the hybrid SmolLM-360M run's batch
LLAMA_B, LLAMA_T = 4, 2048                      # the dense decoder's training shape
# phase 19: Llama's 8-card context plan on a ring of 2 ranks sharing the card,
# B 2 (two ranks' parameters and AdamW state, 22.35 GiB each, and their
# activations fit the 80 GB card at B 2, not at B 4); its 2-layer f32 cell
RING_B, RING_T, RING_STEPS = 2, 2048, 2
RING_CELL_B, RING_CELL_T = 4, 512
# phase 20: Llama-3.2-1B on a tensor-MP pair sharing the card, B 4 (each
# rank holds half the parameters and AdamW state, 11.2 GiB, and about half
# the activations); its 2-layer f32 cells are phase 19 (c)'s
TP_B, TP_T, TP_STEPS, TP_M = 4, 2048, 2, 2
BWD_F32_TOL = 1e-4    # f32 backward: sums of up to 2048 terms in another order
# flash backward rows: B, Tq, Tk, H, Hkv, hd, causal, window (T 1, 4, 17, 130,
# Tq != Tk both ways, hd 32 and 128, B 1, H = Hkv, windows with rows that see
# no key, non-causal).  T 1 attends over 33 keys, as a decode step: under the
# causal mask a single query sees one key, its dq and dk are exactly 0, and
# the bf16 rule would admit no round-off at all.  Then the edges of the bf16
# kernels' tiles (64 rows a warpgroup, blocks of 128 keys or query rows,
# streamed tiles of 64): T 63, 65, 127, 129, 191 causal and not, Tq != Tk
# with the diagonal off a tile edge, hd 128 with rep 8, grids of 2–16 blocks.
FLASH_BWD_EDGE = [(1, 1, 33, 2, 2, 64, False, 0), (2, 4, 4, 8, 2, 64, True, 0),
                  (2, 17, 17, 4, 2, 32, True, 0), (2, 130, 130, 8, 2, 128, True, 0),
                  (1, 100, 260, 4, 4, 64, False, 0), (2, 200, 70, 4, 1, 64, True, 0),
                  (1, 300, 300, 8, 2, 128, True, 64), (2, 90, 30, 4, 2, 64, False, 16),
                  (1, 150, 40, 4, 2, 32, True, 8),
                  (1, 63, 63, 4, 2, 64, True, 0), (1, 63, 63, 4, 2, 64, False, 0),
                  (2, 65, 65, 4, 1, 64, True, 0), (2, 65, 65, 4, 1, 64, False, 0),
                  (1, 127, 127, 8, 2, 32, True, 0), (1, 127, 127, 8, 2, 32, False, 0),
                  (1, 129, 129, 4, 2, 128, True, 0), (1, 129, 129, 4, 2, 128, False, 0),
                  (1, 191, 191, 4, 2, 64, True, 0), (1, 191, 191, 4, 2, 64, False, 0),
                  (1, 191, 129, 4, 2, 64, True, 0), (1, 129, 191, 4, 2, 64, True, 0),
                  (1, 200, 200, 16, 2, 128, True, 0), (1, 256, 256, 2, 1, 64, True, 0),
                  (1, 2048, 2048, 1, 1, 64, True, 0)]
LSTM_FULL = (TRAIN_B, 1024, 1024, 8192)         # B, d_in, d_h, H of BigLSTM's cell
# GNMT: B 128 (the paper's per-GPU mini-batch), S = T = 50 (GNMTv2's length
# limit); its cells are B 128 x d_in 1024 (2048 for the first decoder
# layer's [target, zero context] concat) x H 1024, with no projection
GNMT_B, GNMT_T = 128, 50
LSTM_GNMT = [(GNMT_B, 1024, 1024, 1024), (GNMT_B, 2048, 1024, 1024)]
INCEPTION_B, INCEPTION_PX = 64, 299             # the paper's per-GPU mini-batch, config size
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
# the kernels of csrc/*.cu, by their function names in a profiler's kernel names
OWN_KERNEL = re.compile(r"\b((?:flash|gmm|lstm|wkv6)\w*_kernel)\b")


T0 = time.perf_counter()


def _phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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
    """(device milliseconds per call, how they were timed).  The time of the
    CUDA kernels (and copies) that torch.profiler saw over ``reps`` calls:
    unlike ``time_ms`` it leaves out the host's launch gaps, which for a
    kernel of a few microseconds are most of a call.  A profiling session
    now and then records no device event, even several in a row; each retry
    profiles four times as many calls, and after three empty sessions the
    time is taken between CUDA events (``time_ms``) instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        n = reps * 4 ** attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / n, "profiler"
    print("[timing] torch.profiler recorded no device time in three sessions; "
          "timed between CUDA events", file=sys.stderr, flush=True)
    return time_ms(fn, reps, warmup=0), "cuda events"


def time_into(row, key, fn, reps=20):
    """row[key]: device ms per call; row[key with "call_ms"]: event ms.
    Where the profiler saw no device time, row[key with "timed_by"] says
    that row[key] was taken between CUDA events."""
    row[key], how = device_ms(fn, reps)
    if how != "profiler":
        row[key.removesuffix("ms") + "timed_by"] = how
    row[key.removesuffix("ms") + "call_ms"] = time_ms(fn, reps)


def attention_bound_ms(q, k, v, causal, window):
    """Least time on the card: q, k, v read once and o written once, against
    4*hd FLOPs for every (query, key) pair the masks keep."""
    b, tq, h, hd = q.shape
    flops = 4.0 * b * h * _keep_pairs(tq, k.shape[1], causal, window) * hd
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
    # long prompts on the prefill tile: the training shape, and T 8192
    for b, t in ((LLAMA_B, LLAMA_T), (1, 8192)):
        rows.append(check_attention(fa, f"prefill B{b} T{t} H32/8 hd64 causal",
                                    rnd(b, t, 32, 64, dtype=bf), rnd(b, t, 8, 64, dtype=bf),
                                    rnd(b, t, 8, 64, dtype=bf), causal=True))
    # bf16 rows that cannot take 16-byte async copies (q's base 2 bytes off):
    # the FMA kernel at Llama's prefill shape
    qm = torch.empty(1 + q.numel(), dtype=bf, device=dev)[1:].view(BATCH, PROMPT, 16, 64)
    qm.copy_(q)
    rows.append(check_attention(fa, "prefill B4 T512 H16/8 hd64 causal, q misaligned", qm, k, v,
                                causal=True))
    # edge shapes (tests/test_kernels.py), windows, Tq != Tk, head dims, fp32,
    # and SmolLM-360M's micro-batch in phase 15 (c): 15 query heads over 5
    f32 = torch.float32
    for b, tq, tk, h, hkv, hd, causal, window, dt in [
            (1, 70, 70, 2, 2, 32, True, 0, f32), (2, 130, 130, 2, 2, 32, True, 3, f32),
            (1, 7, 7, 2, 2, 32, False, 0, f32), (1, 1, 1, 2, 2, 32, True, 0, f32),
            (2, 100, 260, 2, 2, 64, False, 0, f32), (2, 40, 100, 4, 2, 64, True, 0, f32),
            (2, 300, 300, 8, 2, 128, True, 64, bf), (2, 256, 256, 32, 8, 64, True, 0, f32),
            (3, 5, 77, 4, 1, 128, False, 0, bf), (2, 512, 512, 15, 5, 64, True, 0, bf)]:
        rows.append(check_attention(
            fa, f"B{b} Tq{tq} Tk{tk} H{h}/{hkv} hd{hd} causal={causal} window={window}",
            rnd(b, tq, h, hd, dtype=dt), rnd(b, tk, hkv, hd, dtype=dt),
            rnd(b, tk, hkv, hd, dtype=dt), causal=causal, window=window))
    return rows


def _keep_pairs(tq, tk, causal, window):
    """The (query, key) pairs the masks keep."""
    qpos = torch.arange(tq)[:, None]
    kpos = torch.arange(tk)[None, :]
    keep = torch.ones((tq, tk), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return int(keep.sum())


def attention_bwd_bound_ms(q, k, v, causal, window):
    """Least time on the card for the backward: q, k, v, o, dO and lse read
    once, dq, dk, dv written once, against 10*hd FLOPs for every kept pair
    (S recomputed, dP, dV, dK, dQ: five products of 2*hd)."""
    b, tq, h, hd = q.shape
    flops = 10.0 * b * h * _keep_pairs(tq, k.shape[1], causal, window) * hd
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * b * h * tq
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _autograd_of_ref(fa, q, k, v, do, causal, window):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_ref(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, do)


def check_flash_bwd(fa, case, q, k, v, do, *, causal, window=0, timed=False):
    """The forward with lse and the backward kernels against their plain
    versions on the same inputs: lse within 1e-4 of max(1, |ref|) (rows
    that see no key exactly -1e30), out the same bits with and without lse,
    the gradients the same bits on a repeat launch, each variant that takes
    the inputs (the FMA kernels forced on bf16 rows too); optionally timed."""
    kw = dict(causal=causal, window=window)
    (out, lse), fwd_variant = launched_variant(fa.flash_attention, lambda: fa._forward(
        q, k, v, causal, window, want_lse=True))
    out2, _ = fa._forward(q, k, v, causal, window, want_lse=False, variant=fwd_variant)
    want_lse = fa.flash_attention_lse_plain(q, k, **kw)
    dead = want_lse < -1e29
    lse_err = float((lse - want_lse)[~dead].abs().max()) / max(
        1.0, float(want_lse[~dead].abs().max()))
    if fwd_variant == "tc_decode" or not torch.equal(out, out2) or \
            not torch.equal(lse < -1e29, dead) or not lse_err < BWD_F32_TOL:
        raise AssertionError(f"flash forward with lse {case}: {fwd_variant}, out bits equal "
                             f"{torch.equal(out, out2)}, lse error {lse_err}")
    oracle = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                          do.float(), lse, **kw)
    bf = q.dtype == torch.bfloat16
    base = _autograd_of_ref(fa, q, k, v, do, causal, window) if bf else None
    picked = fa.flash_bwd_variant(q, k, v, out, do)
    rows = []
    for variant in (picked, "fma") if picked == "tc" else (picked,):
        grads, launched = launched_variant(fa.flash_attention_bwd, lambda: fa._launch_bwd(
            q, k, v, out, do, lse, causal, window, variant))
        again = fa._launch_bwd(q, k, v, out, do, lse, causal, window, variant)
        torch.cuda.synchronize()
        errs = [float((g.float() - w).abs().max()) for g, w in zip(grads, oracle)]
        scale = [max(1.0, float(w.abs().max())) for w in oracle]
        row = {"kernel": "flash_attention_bwd", "shape": case,
               "dtype": str(q.dtype).removeprefix("torch."), "variant": launched,
               "forward_variant": fwd_variant, "max_abs_err": max(errs),
               "rel_err": {n: e / sc for n, e, sc in zip(("dq", "dk", "dv"), errs, scale)},
               "lse_rel_err": lse_err}
        if bf:   # FlashAttention-2's rule against the same f32 oracle
            limit = [2 * float((bs.float() - w).abs().max()) + 1e-3 * float(w.abs().max())
                     for bs, w in zip(base, oracle)]
            row["limit"] = dict(zip(("dq", "dk", "dv"), limit))
            ok = all(e <= lim for e, lim in zip(errs, limit))
        else:
            row["tol"] = BWD_F32_TOL
            ok = all(e / sc < BWD_F32_TOL for e, sc in zip(errs, scale))
        same_bits = all(torch.equal(g, g2) for g, g2 in zip(grads, again))
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        if launched != variant or not (ok and same_bits and finite):
            raise AssertionError(f"flash_attention_bwd {case} ({launched}): {row}, same bits "
                                 f"on a repeat launch {same_bits}, finite {finite}")
        if timed:
            time_into(row, "ms", lambda: fa._launch_bwd(q, k, v, out, do, lse, causal, window,
                                                        variant))
            time_into(row, "plain_ms", lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, do, lse, **kw), reps=5)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            time_into(row, "library_ms", lambda: torch.autograd.grad(
                sdpa, (qt, kt, vt), dot, retain_graph=True))
            row["library"] = ("backward of F.scaled_dot_product_attention(is_causal=True, "
                              "enable_gqa=True)")
            time_into(row, "forward_with_lse_ms", lambda: fa._forward(
                q, k, v, causal, window, want_lse=True))
            qf, kf, vf = (x.transpose(1, 2) for x in (q, k, v))
            time_into(row, "forward_library_ms", lambda: torch.nn.functional.
                      scaled_dot_product_attention(qf, kf, vf, is_causal=causal,
                                                   enable_gqa=True))
            row["forward_bound_ms"], row["forward_bound_by"] = attention_bound_ms(
                q, k, v, causal, window)
            row["bound_ms"], row["bound_by"] = attention_bwd_bound_ms(q, k, v, causal, window)
            del sdpa
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def phase_flash_bwd(fa):
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rows = []
    # the training shape, bf16 first (the main path's dtype), then Granite's heads
    for dt in (torch.bfloat16, torch.float32):
        b, t = LLAMA_B, LLAMA_T
        rows += check_flash_bwd(fa, f"train B{b} T{t} H32/8 hd64 causal",
                                rnd(b, t, 32, 64, dtype=dt), rnd(b, t, 8, 64, dtype=dt),
                                rnd(b, t, 8, 64, dtype=dt), rnd(b, t, 32, 64, dtype=dt),
                                causal=True, timed=True)
        torch.cuda.empty_cache()
    bf = torch.bfloat16
    rows += check_flash_bwd(fa, "B4 T512 H16/8 hd64 causal", rnd(4, 512, 16, 64, dtype=bf),
                            rnd(4, 512, 8, 64, dtype=bf), rnd(4, 512, 8, 64, dtype=bf),
                            rnd(4, 512, 16, 64, dtype=bf), causal=True)
    # SmolLM-360M's micro-batch in phase 15 (c): 15 query heads over 5 (ratio 3)
    rows += check_flash_bwd(fa, "B2 T512 H15/5 hd64 causal", rnd(2, 512, 15, 64, dtype=bf),
                            rnd(2, 512, 5, 64, dtype=bf), rnd(2, 512, 5, 64, dtype=bf),
                            rnd(2, 512, 15, 64, dtype=bf), causal=True)
    for b, tq, tk, h, hkv, hd, causal, window in FLASH_BWD_EDGE:
        for dt in (torch.float32, torch.bfloat16):
            rows += check_flash_bwd(
                fa, f"B{b} Tq{tq} Tk{tk} H{h}/{hkv} hd{hd} causal={causal} window={window}",
                rnd(b, tq, h, hd, dtype=dt), rnd(b, tk, hkv, hd, dtype=dt),
                rnd(b, tk, hkv, hd, dtype=dt), rnd(b, tq, h, hd, dtype=dt),
                causal=causal, window=window)
    return rows


def phase_ring_hops(fa):
    """The two kinds of hop of phase 19 (a)'s ring (B 2, T/m = 1024 rows a
    rank, H 32/8, hd 64, bf16): the forward with lse on the diagonal block
    (causal) and on a block wholly in the past (not causal), against the
    plain output (``TOL``) and lse (``BWD_F32_TOL`` of max(1, |ref|)); the
    backward of both given the *global* output and lse of attention over T
    2048 (the ring's hop backward), against the plain backward on the same
    inputs within 2e-2 of max(1, |ref|).  Each timed against its plain
    version, its bound and SDPA's call at the hop's shape."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    bf = torch.bfloat16
    b, t, h, hkv, hd = RING_B, RING_T, 32, 8, 64
    n = t // 2

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    q, k, v, do = rnd(b, t, h, hd), rnd(b, t, hkv, hd), rnd(b, t, hkv, hd), rnd(b, t, h, hd)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_rows, bwd_rows = [], []
    # rank 1's queries: its diagonal block (keys n..t) and the past block (keys 0..n)
    qh, oh, doh = (x[:, n:].contiguous() for x in (q, out, do))
    lseh = lse[:, :, n:].contiguous()
    for causal, lo in ((True, n), (False, 0)):
        kh, vh = k[:, lo:lo + n].contiguous(), v[:, lo:lo + n].contiguous()
        case = f"ring hop B{b} Tq{n} Tk{n} H{h}/{hkv} hd{hd} causal={causal}"
        (o_s, lse_s), variant = launched_variant(fa.flash_attention, lambda: fa.flash_attention_lse(
            qh, kh, vh, causal=causal))
        want_o = fa.flash_attention_ref(qh, kh, vh, causal=causal)
        want_lse = fa.flash_attention_lse_plain(qh, kh, causal=causal)
        err = float((o_s.float() - want_o.float()).abs().max())
        lse_err = float((lse_s - want_lse).abs().max()) / max(1.0, float(want_lse.abs().max()))
        row = {"shape": case, "dtype": "bfloat16", "variant": variant, "max_abs_err": err,
               "tol": TOL[bf], "lse_rel_err": lse_err, "lse_tol": BWD_F32_TOL}
        if variant != "tc_prefill" or not (err < TOL[bf] and lse_err < BWD_F32_TOL):
            raise AssertionError(f"flash_attention_lse {case}: {row}")
        time_into(row, "ms", lambda: fa.flash_attention_lse(qh, kh, vh, causal=causal))
        time_into(row, "plain_ms", lambda: (fa.flash_attention_ref(qh, kh, vh, causal=causal),
                                            fa.flash_attention_lse_plain(qh, kh, causal=causal)))
        qt, kt, vt = (x.transpose(1, 2) for x in (qh, kh, vh))
        time_into(row, "library_ms", lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True))
        flops = 4.0 * b * h * _keep_pairs(n, n, causal, 0) * hd
        row["bound_ms"], row["bound_by"] = bound_ms(_nbytes(qh, kh, vh, o_s, lse_s), flops, bf)
        print(json.dumps(row), flush=True)
        fwd_rows.append(row)
        # the hop backward, given the global output and lse
        grads, variant = launched_variant(fa.flash_attention_bwd, lambda: fa.flash_attention_bwd(
            qh, kh, vh, oh, doh, lseh, causal=causal))
        torch.cuda.synchronize()
        oracle = fa.flash_attention_bwd_plain(qh.float(), kh.float(), vh.float(), oh.float(),
                                              doh.float(), lseh, causal=causal)
        errs = [float((g.float() - w).abs().max()) for g, w in zip(grads, oracle)]
        scale = [max(1.0, float(w.abs().max())) for w in oracle]
        row = {"kernel": "flash_attention_bwd", "shape": case + ", global lse",
               "dtype": "bfloat16", "variant": variant, "max_abs_err": max(errs),
               "rel_err": {nm: e / sc for nm, e, sc in zip(("dq", "dk", "dv"), errs, scale)},
               "tol": TOL[bf]}
        if variant != "tc" or not all(e / sc < TOL[bf] for e, sc in zip(errs, scale)):
            raise AssertionError(f"flash_attention_bwd {case}, global lse: {row}")
        time_into(row, "ms", lambda: fa.flash_attention_bwd(qh, kh, vh, oh, doh, lseh,
                                                            causal=causal))
        time_into(row, "plain_ms", lambda: fa.flash_attention_bwd_plain(
            qh, kh, vh, oh, doh, lseh, causal=causal), reps=5)
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (qh, kh, vh))
        lib = sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True)
        time_into(row, "library_ms", lambda: torch.autograd.grad(
            lib, (ql, kl, vl), doh.transpose(1, 2), retain_graph=True))
        row["bound_ms"], row["bound_by"] = attention_bwd_bound_ms(qh, kh, vh, causal, 0)
        print(json.dumps(row), flush=True)
        bwd_rows.append(row)
        del lib
    return fwd_rows, bwd_rows


def phase_tp_attention(fa):
    """The flash forward with lse and the backward at a tensor-MP rank's
    shape in phase 20 (a): B 4, T 2048, Llama's 32/8 heads over 2 ranks (H
    16/4), hd 64, bf16, causal.  The forward against its plain output
    (``TOL``) and lse (``BWD_F32_TOL`` of max(1, |ref|)), timed against its
    plain version, its bound and SDPA's call; the backward through
    ``check_flash_bwd`` (timed the same way)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    bf = torch.bfloat16
    b, t, h, hkv, hd = TP_B, TP_T, 32 // TP_M, 8 // TP_M, 64

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    q, k, v, do = rnd(b, t, h, hd), rnd(b, t, hkv, hd), rnd(b, t, hkv, hd), rnd(b, t, h, hd)
    case = f"tensor-MP rank B{b} T{t} H{h}/{hkv} hd{hd} causal"
    (o, lse), variant = launched_variant(fa.flash_attention, lambda: fa.flash_attention_lse(
        q, k, v, causal=True))
    want_o = fa.flash_attention_ref(q, k, v, causal=True)
    want_lse = fa.flash_attention_lse_plain(q, k, causal=True)
    err = float((o.float() - want_o.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max()) / max(1.0, float(want_lse.abs().max()))
    row = {"shape": case + ", with lse", "dtype": "bfloat16", "variant": variant,
           "max_abs_err": err, "tol": TOL[bf], "lse_rel_err": lse_err, "lse_tol": BWD_F32_TOL}
    if variant != "tc_prefill" or not (err < TOL[bf] and lse_err < BWD_F32_TOL):
        raise AssertionError(f"flash_attention_lse {case}: {row}")
    del want_o, want_lse
    time_into(row, "ms", lambda: fa.flash_attention_lse(q, k, v, causal=True))
    time_into(row, "plain_ms", lambda: (fa.flash_attention_ref(q, k, v, causal=True),
                                        fa.flash_attention_lse_plain(q, k, causal=True)),
              reps=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    time_into(row, "library_ms", lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    row["bound_ms"], row["bound_by"] = bound_ms(
        _nbytes(q, k, v, o, lse), 4.0 * b * h * _keep_pairs(t, t, True, 0) * hd, bf)
    print(json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    bwd_rows = check_flash_bwd(fa, case, q, k, v, do, causal=True, timed=True)
    torch.cuda.empty_cache()
    return [row], bwd_rows


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


def lstm_inputs(gen, b, d_in, d_h, hh, dtype, seq=0):
    """x (B, d_in), h, c, wx, wh, b on the card; with ``seq`` x is the row
    view ``xs[:, seq // 2]`` of a (B, seq, d_in) layer input, as a layer's
    time loop reads it (row stride seq * d_in)."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = rnd(b, seq, d_in).to(dtype)[:, seq // 2] if seq else rnd(b, d_in).to(dtype)
    return [x, rnd(b, d_h).to(dtype), rnd(b, hh, scale=0.5).to(dtype),
            rnd(d_in, 4, hh, scale=d_in ** -0.5).to(dtype),
            rnd(d_h, 4, hh, scale=d_h ** -0.5).to(dtype), rnd(4, hh, scale=0.1)]


def check_lstm_fwd(lc, args, case, timed=False, variant=None):
    """The forward kernel (writing its gates, as in training) against its
    plain version, through the variant ``lstm_variant`` picks or, when
    ``variant`` is given, that one forced; h' and c' must come out the same
    bits without the gates.  Timed against the plain version, the bound
    and PyTorch's own LSTM cell: ``torch.lstm_cell`` where the cell state
    is as wide as the recurrent input (GNMT's), else its CUDA path (two
    GEMMs and ``_thnn_fused_lstm_cell``: ``torch.lstm_cell`` refuses a cell
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

        if d_h == hh:
            def library():
                return torch.lstm_cell(x, (h, c), wx_t, wh_t, b_fold, zero_b)

            row["library"] = "torch.lstm_cell"
        else:
            def library():
                return torch.ops.aten._thnn_fused_lstm_cell(lin(x, wx_t), lin(h, wh_t), c,
                                                            b_fold, zero_b)[:2]

            row["library"] = ("linear x2 + aten._thnn_fused_lstm_cell (torch.lstm_cell's "
                              "CUDA path)")
        row["library_max_abs_err"] = _max_err(library(), (rh, rc))
        time_into(row, "library_ms", library)
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
    # GNMT's cells, x a strided row of the layer input: bf16 on tc (then fma
    # forced), f32 on fma; the weights stay in L2 over the timed calls, as
    # over a layer's 50 steps
    for b, d_in, d_h, hh in LSTM_GNMT:
        case = f"B{b} din{d_in} dh{d_h} H{hh}, x row of (B, {GNMT_T}, {d_in})"
        for dt in (torch.bfloat16, torch.float32):
            args = lstm_inputs(gen, b, d_in, d_h, hh, dtype=dt, seq=GNMT_T)
            row, (hn, cn, gates) = check_lstm_fwd(lc, args, case, timed=True)
            if row["variant"] != ("tc" if dt == torch.bfloat16 else "fma"):
                raise AssertionError(f"lstm_cell_fwd {case} {dt} launched {row['variant']}")
            fwd_rows.append(row)
            if row["variant"] == "tc":
                fwd_rows.append(check_lstm_fwd(lc, args, case, timed=True, variant="fma")[0])
            if d_in == 1024:
                dh, dc = (torch.randn(hn.shape, generator=gen, device="cuda").to(dt)
                          for _ in range(2))
                bwd_rows.append(check_lstm_bwd(lc, gates, args[2], cn, dh, dc,
                                               f"B{b} H{hh}", timed=True))
    # edge shapes: B and H no tile multiples, widths that the tensor-core
    # tile does not take (fma) and that it does (tc, then fma forced)
    for b, d_in, d_h, hh in [(1, 24, 16, 70), (5, 64, 40, 33), (17, 40, 12, 130),
                             (3, 16, 8, 1), (1, 1024, 1024, 8192), (4, 1024, 1024, 8192),
                             (1, 24, 16, 72),
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
    want = {"flash_attention": 0 if cfg.rwkv else calls, "flash_attention_bwd": 0,
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
    idle share against the unprofiled wall time, the top kernels, and the
    ms of each kernel of csrc/*.cu (summed over its template instances).
    Where three profiled calls saw no device event, busy time and idle share
    are None: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    for _ in range(3):   # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kern:
            break
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    own = {}
    for n, ms in by_name.items():
        m = OWN_KERNEL.search(n)
        if m:
            own[m.group(1)] = own.get(m.group(1), 0.0) + ms
    out = {"profile": name, "unprofiled_wall_ms": unprofiled_ms, "wall_ms": wall_ms,
           "device_busy_ms": busy if kern else None,
           "idle_share": 1 - busy / unprofiled_ms if kern else None,
           "kernels": len(kern), "top": [[n[:80], ms] for n, ms in top],
           "own_kernels_ms": own}
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
    timing = time_train_steps(api_mod, cfg, state, TRAIN_B, TRAIN_T, "train_step")
    del summary, state
    torch.cuda.empty_cache()
    return launches, fwd_variants, timing


def time_train_steps(api_mod, cfg, state, batch_size, seq, name, batch=None, unit="tok"):
    """Step time, ``unit``s/s (tokens of the LM batch of the next epoch, or
    of ``batch``: ``batch_size * seq`` of them) and peak memory over 3 steps
    continuing from ``state``, after one untimed step, and a profile of one
    step (``profile_call``)."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step

    api = api_mod.build_model(cfg, device="cuda")
    step_fn = make_train_step(api, adamw(warmup_cosine(3e-3, 20, TRAIN_STEPS)), clip_norm=1.0)
    batch = {k: v.cuda() for k, v in (batch or _lm_batch(seq, batch_size, epoch=1)).items()}
    box = [state]

    def one_step():
        box[0], metrics = step_fn(box[0], batch)
        return metrics

    prof = profile_call(name, one_step, reps=3)
    timing = {"step_ms": prof["unprofiled_wall_ms"],
              f"{unit}_per_s": batch_size * seq / (prof["unprofiled_wall_ms"] / 1e3),
              "idle_share": prof["idle_share"], "device_busy_ms": prof["device_busy_ms"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps({name: timing}), flush=True)
    return timing


def phase_train_llama(train_launch, lc, counters, api_mod, cfg):
    """Full-width, full-depth Llama-3.2-1B through the launcher at B 4, T
    2048, counters set to 0 just before and read just after: one forward
    launch (``tc_prefill``, with lse) and one backward call (``tc``) a layer
    a step, and a falling loss; then step time and a profile of one step."""
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    reset_counters(every)
    t0 = time.perf_counter()
    summary = train_launch.main(["--arch", "llama3_2_1b", "--steps", str(TRAIN_STEPS),
                                 "--batch", str(LLAMA_B), "--seq", str(LLAMA_T)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in every.items()}
    variants = variant_launches(every)
    want = TRAIN_STEPS * cfg.n_layers
    want_launches = dict.fromkeys(every, 0)
    want_launches.update(flash_attention=want, flash_attention_bwd=want)
    want_variants = {name: dict.fromkeys(v, 0) for name, v in variants.items()}
    want_variants["flash_attention"]["tc_prefill"] = want
    want_variants["flash_attention_bwd"]["tc"] = want
    if launches != want_launches or variants != want_variants:
        raise AssertionError(f"training launched {launches} {variants}, want {want} forward "
                             f"launches on tc_prefill and {want} backward calls on tc")
    state = summary["state"]
    losses = summary["history"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0] or state.step != TRAIN_STEPS or \
            not all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)):
        raise AssertionError(f"training gave losses {losses} or non-finite parameters")
    out = {"arch": cfg.name, "params": sum(p.numel() for p in tree_leaves(state.params)),
           "layers": cfg.n_layers, "batch": LLAMA_B, "seq": LLAMA_T, "steps": TRAIN_STEPS,
           "losses": losses, "launcher_wall_s": wall_s, "launches": launches,
           "variant_launches": {n: variants[n] for n in ("flash_attention",
                                                         "flash_attention_bwd")},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(out), flush=True)
    timing = time_train_steps(api_mod, cfg, state, LLAMA_B, LLAMA_T,
                              f"train_step {cfg.name}")
    del summary, state
    torch.cuda.empty_cache()
    return launches, variants, timing


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


def phase_llama_train_vs_plain(fa, api_mod, cfg):
    """One Llama train step at full width, 2 layers, f32, vocab cut to 32768,
    B 2 x T 128: the card's kernels (the FMA forward and backward, f32)
    against the plain versions on the CPU from the same weights and batch;
    loss and gradient norm within 1e-4 relative, every parameter after the
    update within 1e-3."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, n_layers=2, vocab_size=32768, dtype="float32")
    gpu, cpu = (api_mod.build_model(cfg2, device=d) for d in ("cuda", "cpu"))
    params = gpu.init(1)
    batch = _lm_batch(128, 2)
    bwd_before = dict(fa.flash_attention_bwd.variant_launches)
    results = {}
    for name, api, p, b in (("cuda", gpu, params, {k: v.cuda() for k, v in batch.items()}),
                            ("cpu", cpu, _tree_to(params, "cpu"), batch)):
        opt = adamw(warmup_cosine(3e-3, 20, TRAIN_STEPS))
        step = make_train_step(api, opt, clip_norm=1.0)
        state, metrics = step(TrainState(params=p, opt_state=opt.init(p), step=0), b)
        results[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                         [t.cpu() for t in tree_leaves(state.params)])
    bwd_calls = {n: c - bwd_before[n] for n, c in fa.flash_attention_bwd.variant_launches.items()}
    (gl, gn, gp), (cl, cn, cp) = results["cuda"], results["cpu"]
    out = {"llama_train_vs_plain": {"loss_rel": abs(gl - cl) / abs(cl),
                                    "grad_norm_rel": abs(gn - cn) / abs(cn),
                                    "params_max_abs": max(float((a - b).abs().max())
                                                          for a, b in zip(gp, cp)),
                                    "loss": gl, "grad_norm": gn,
                                    "flash_attention_bwd_calls": bwd_calls},
           "tol": {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": 1e-3}}
    print(json.dumps(out), flush=True)
    r = out["llama_train_vs_plain"]
    if bwd_calls != {"fma": cfg2.n_layers, "tc": 0} or not (
            r["loss_rel"] <= 1e-4 and r["grad_norm_rel"] <= 1e-4 and r["params_max_abs"] <= 1e-3):
        raise AssertionError(f"Llama train step on the card disagrees with its plain path: {r}")
    return r


def measure_card_constants(hw, llama_cfg, llama_timing):
    """The card's memory, HBM rate, bf16 matmul rate and the MFU of phase
    12's Llama step, each beside the ``HardwareModel`` default."""
    props = torch.cuda.get_device_properties(0)
    nbytes = 2 * 2**30                   # a 2 GiB copy: read once, written once
    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda").fill_(1)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), reps=10)
    del src, dst
    n = 8192
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((n, n), device="cuda", dtype=torch.bfloat16, generator=gen)
    b = torch.randn((n, n), device="cuda", dtype=torch.bfloat16, generator=gen)
    mm_ms = time_ms(lambda: torch.matmul(a, b), reps=10)
    del a, b
    torch.cuda.empty_cache()
    llama_tokens = LLAMA_B * LLAMA_T
    mfu = (6.0 * llama_cfg.n_active_params() * llama_tokens
           / (llama_timing["step_ms"] / 1e3 * hw.peak_flops))
    constants = {
        "hbm_bytes": {"measured": props.total_memory, "default": hw.hbm_bytes},
        "hbm_bw": {"measured": 2 * nbytes / (copy_ms / 1e3), "copy_ms": copy_ms,
                   "default": hw.hbm_bw},
        "bf16_matmul_flops": {"measured": 2.0 * n ** 3 / (mm_ms / 1e3), "matmul_ms": mm_ms,
                              "peak_flops_default": hw.peak_flops},
        "mfu": {"measured": mfu, "default": hw.mfu,
                "from": f"{llama_cfg.name} step {llama_timing['step_ms']:.2f} ms at "
                        f"B {LLAMA_B} x T {LLAMA_T}"}}
    print(json.dumps({"planner_constants": constants}), flush=True)
    return constants


def phase_planner(train_launch, lc, counters, lstm_cfg, llama_cfg, lstm_timing,
                  llama_timing):
    """The planner's hardware model and cost models against the card, its
    H100 plans, and BigLSTM through ``--parallel auto --devices 1``."""
    from repro_torch.configs import get_config
    from repro_torch.core import comm, planner
    from repro_torch.tree import tree_leaves

    hw = comm.HardwareModel()
    total_memory = measure_card_constants(hw, llama_cfg, llama_timing)["hbm_bytes"][
        "measured"]

    # the planner's models against the measured steps: findings, not limits
    model_vs_card = {}
    for cfg, bsz, seq, timing in ((lstm_cfg, TRAIN_B, TRAIN_T, lstm_timing),
                                  (llama_cfg, LLAMA_B, LLAMA_T, llama_timing)):
        step_s = planner.step_time_single(cfg, bsz, seq, hw)
        mem = planner.per_device_mem_bytes(
            cfg, mini_batch=bsz, seq_len=seq, remat=False,
            opt_bytes_per_param=planner.default_opt_bytes_per_param(cfg))
        model_vs_card[cfg.name] = {
            "batch": bsz, "seq": seq, "model_step_ms": step_s * 1e3,
            "measured_step_ms": timing["step_ms"],
            "measured_over_model": timing["step_ms"] / (step_s * 1e3),
            "model_mem_gib": mem / 2**30, "measured_peak_gib": timing["peak_mem_gib"],
            "measured_over_model_mem": timing["peak_mem_gib"] / (mem / 2**30)}
    print(json.dumps({"planner_model_vs_card": model_vs_card}), flush=True)

    plans, chosen = {}, {}
    for arch in ("inception_v3", "gnmt", "biglstm", "llama3_2_1b"):
        cfg = get_config(arch)
        p = planner.HybridPlanner(cfg, epoch_model=planner.default_epoch_model(cfg))
        rows = []
        for devices in (1, 8, 64, 256, 1024):
            choices = p.choices(devices)
            if not all(math.isfinite(c.speedup) for c in choices):
                raise AssertionError(f"{arch} at {devices} cards: a non-finite speedup")
            best = choices[0]
            if best.mem_bytes > min(hw.hbm_bytes, total_memory):
                raise AssertionError(f"{arch} at {devices} cards: the plan needs "
                                     f"{best.mem_bytes} bytes a card")
            chosen[(arch, devices)] = best
            rows.append({"devices": devices, "kind": best.mp_kind,
                         "pods_dp_mp": f"{best.pods} x {best.dp} x {best.mp}",
                         "K": best.microbatches, "schedule": best.schedule,
                         "SU": best.speedup, "SU_M": best.su_m, "SE_N": best.se_n,
                         "GiB": best.mem_bytes / 2**30})
        plans[arch] = {"plans": rows, "crossover": p.crossover()}
    print(json.dumps({"planner_h100_plans": plans}), flush=True)

    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    torch.cuda.empty_cache()
    reset_counters(every)
    summary = train_launch.main(["--arch", "biglstm", "--parallel", "auto", "--devices", "1",
                                 "--steps", str(AUTO_STEPS)])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in every.items()}
    variants = variant_launches(every)
    want = AUTO_STEPS * lstm_cfg.n_layers * TRAIN_T
    want_launches = dict.fromkeys(every, 0)
    want_launches.update(lstm_cell_fwd=want, lstm_cell_bwd_pointwise=want)
    if launches != want_launches or variants["lstm_cell_fwd"] != {"fma": 0, "tc": want}:
        raise AssertionError(f"--parallel auto launched {launches} {variants}, want {want} "
                             f"forward launches on tc and {want} backward")
    losses = summary["history"]
    if len(losses) != AUTO_STEPS or not all(np.isfinite(losses)) or             not all(bool(torch.isfinite(p).all()) for p in tree_leaves(summary["state"].params)):
        raise AssertionError(f"--parallel auto training gave losses {losses}")
    del summary
    torch.cuda.empty_cache()
    # the 64-card plan: 1f1b 8 x 4 x 2 K16, clamped to the one card's ranks
    best = chosen[("biglstm", 64)]
    k = best.microbatches
    if (best.mp_kind, best.schedule, best.mp, k) != ("pipeline", "1f1b", 2, 16):
        raise AssertionError(f"BigLSTM at 64 cards: the plan is {best}")
    summary = train_launch.main(["--arch", "biglstm", "--parallel", "auto", "--devices", "64",
                                 "--steps", str(AUTO_STEPS)])
    at_64 = check_rank_run(summary, "--devices 64", lstm_cfg, steps=AUTO_STEPS, stages=2,
                           micro=k, lstm=True, high_water=min(k, 2))
    # Llama's context plans: the 8-card ring of 2 trains in phase 19 (a); the
    # 64-card ring of 8 would hold 8 replicas of the parameters and AdamW
    # state (22.35 GiB each) on the one card, and is recorded, not run
    llama_plans = {}
    for devices, ring in ((8, 2), (64, 8)):
        c = chosen[("llama3_2_1b", devices)]
        if (c.mp_kind, c.mp) != ("context", ring):
            raise AssertionError(f"Llama at {devices} cards: the plan is {c}")
        llama_plans[devices] = {"kind": c.mp_kind, "pods_dp_mp": f"{c.pods} x {c.dp} x {c.mp}",
                                "SU": c.speedup, "SU_M": c.su_m, "GiB": c.mem_bytes / 2**30,
                                "runs": "phase 19 (a), clamped to 1 DP x a ring of 2"
                                        if devices == 8 else "not run: 8 replicas on one card"}
    out = {"arch": lstm_cfg.name, "devices": 1, "steps": AUTO_STEPS, "losses": losses,
           "launches": launches, "lstm_cell_fwd_variant_launches": variants["lstm_cell_fwd"],
           "at_64": at_64, "llama_context_plans": llama_plans}
    print(json.dumps({"parallel_auto": out}), flush=True)
    return launches, at_64["launches"]


def check_rank_run(summary, name, cfg, *, steps, stages, micro, dp=1, seq=TRAIN_T, lstm,
                   high_water, ring=False, tensor=False):
    """A multi-rank launcher run: the shared-card transport, the kernel
    launches summed over the ranks (LSTM: 2 L T K forward a step, all on
    ``tc``, and L T K backward; attention: 2 L K dp forward launches a step,
    all ``tc_prefill``, and L K dp backward calls, all ``tc``; on a context
    ring of m = ``stages`` ranks, L m (m + 1) / 2 dp of each: the hops the
    causal mask does not skip; on a tensor-MP group of m ranks, L m dp of
    each: every rank attends over its heads once a layer), stage 0's store
    high-water mark, finite losses (on a tensor-MP group, every rank's the
    same).  Returns the run's record."""
    t = summary["transport"]
    if (t.backend, t.placement, len(summary["ranks"])) != ("gloo", "shared", dp * stages):
        raise AssertionError(f"{name}: ran on {t} with {len(summary['ranks'])} ranks")
    launches, variants = summary["launches"], summary["variants"]
    want = dict.fromkeys(launches, 0)
    want_variants = {n: dict.fromkeys(v, 0) for n, v in variants.items()}
    if lstm:
        per_step = cfg.n_layers * seq * micro * dp
        want.update(lstm_cell_fwd=2 * steps * per_step, lstm_cell_bwd_pointwise=steps * per_step)
        want_variants["lstm_cell_fwd"]["tc"] = 2 * steps * per_step
    elif ring or tensor:
        per_step = cfg.n_layers * (stages if tensor else stages * (stages + 1) // 2) * dp
        want.update(flash_attention=steps * per_step, flash_attention_bwd=steps * per_step)
        want_variants["flash_attention"]["tc_prefill"] = steps * per_step
        want_variants["flash_attention_bwd"]["tc"] = steps * per_step
    else:
        per_step = cfg.n_layers * micro * dp
        want.update(flash_attention=2 * steps * per_step, flash_attention_bwd=steps * per_step)
        want_variants["flash_attention"]["tc_prefill"] = 2 * steps * per_step
        want_variants["flash_attention_bwd"]["tc"] = steps * per_step
    if launches != want or variants != want_variants:
        raise AssertionError(f"{name} launched {launches} {variants}, want {want} "
                             f"{want_variants}")
    marks = [r["store_high_water"] for r in summary["ranks"]]
    if marks[0] != high_water:
        raise AssertionError(f"{name}: stage 0's store high-water mark {marks[0]}, want "
                             f"{high_water}")
    losses = summary["history"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    if tensor and any(r["losses"] != losses for r in summary["ranks"]):
        raise AssertionError(f"{name}: the ranks' losses differ: "
                             f"{[r['losses'] for r in summary['ranks']]}")
    return {"run": name, "transport": t.describe(len(summary["ranks"])), "losses": losses,
            "launches": launches, "variant_launches": variants,
            "ranks": [{"rank": r["rank"], "data": r["data"], "stage": r["stage"],
                       "peak_mem_gib": r["peak_mem_bytes"] / 2**30,
                       "store_high_water": r["store_high_water"],
                       "step_ms": r["step_ms"], "losses": r["losses"],
                       "launches": r["launches"],
                       "median_step_ms_after_first": float(np.median(r["step_ms"][1:]))}
                      for r in summary["ranks"]]}


def phase_ranks(train_launch, lc, lstm_cfg):
    """Phase 15 (a)-(c): full-width DP and pipeline runs through the
    launcher on ranks that share the card, beside the planner's memory
    model and bubble fraction."""
    from repro_torch.configs import get_config
    from repro_torch.core import planner as planner_mod
    from repro_torch.parallel.pipeline import pipeline_bubble_fraction

    runs = {}
    for tag, sched, mark in (("a", "1f1b", 2), ("b", "gpipe", 4)):
        torch.cuda.empty_cache()
        spec = f"pipe=2,micro=4,sched={sched}"
        summary = train_launch.main(["--arch", "biglstm", "--parallel", spec, "--batch",
                                     str(TRAIN_B), "--seq", str(TRAIN_T), "--steps",
                                     str(RANK_STEPS)])
        rec = check_rank_run(summary, f"({tag}) biglstm {spec}", lstm_cfg, steps=RANK_STEPS,
                             stages=2, micro=4, lstm=True, high_water=mark)
        rec["planner_per_device_mem_gib"] = planner_mod.per_device_mem_bytes(
            lstm_cfg, mp=2, mp_kind="pipeline", mini_batch=TRAIN_B, seq_len=TRAIN_T,
            microbatches=4, schedule=sched, remat=False,
            opt_bytes_per_param=planner_mod.default_opt_bytes_per_param(lstm_cfg)) / 2**30
        rec["planner_bubble_fraction"] = pipeline_bubble_fraction(4, 2, sched)
        runs[tag] = rec
        print(json.dumps({"ranks_" + tag: rec}), flush=True)
    smol = get_config("smollm_360m")
    spec = "dp=2,pipe=2,micro=2,sched=1f1b"
    torch.cuda.empty_cache()
    summary = train_launch.main(["--arch", "smollm_360m", "--parallel", spec, "--batch",
                                 str(SMOL_B), "--seq", str(SMOL_T), "--steps", str(RANK_STEPS),
                                 "--max-local-devices", "4"])
    rec = check_rank_run(summary, f"(c) smollm_360m {spec}", smol, steps=RANK_STEPS,
                         stages=2, micro=2, dp=2, seq=SMOL_T, lstm=False, high_water=2)
    rec["planner_per_device_mem_gib"] = planner_mod.per_device_mem_bytes(
        smol, mp=2, mp_kind="pipeline", mini_batch=SMOL_B // 2, seq_len=SMOL_T,
        microbatches=2, schedule="1f1b", remat=False,
        opt_bytes_per_param=planner_mod.default_opt_bytes_per_param(smol)) / 2**30
    rec["planner_bubble_fraction"] = pipeline_bubble_fraction(2, 2, "1f1b")
    runs["c"] = rec
    print(json.dumps({"ranks_c": rec}), flush=True)
    # the LSTM forward at the micro-batch rows (B 16 / K 4; the 64-card
    # plan's K 16 gives 1 row), with gates, beside its byte bound: device ms
    # and CUDA-event ms (host gaps included) a launch over 200 launches that
    # rotate over weight sets larger together than twice the 50 MB L2, so
    # each launch finds its weights cold, as each layer and time step does
    gen = torch.Generator(device="cuda").manual_seed(5)
    per_launch = {}
    for rows in (4, 1):
        args = lstm_inputs(gen, rows, *LSTM_FULL[1:], dtype=torch.bfloat16)
        if lc.lstm_variant(*args[:2], *args[3:5]) != "tc":
            raise AssertionError(f"the LSTM forward at B {rows} would not run on tc")
        h_new, c_new, gates = lc.lstm_cell_fwd(*args, want_gates=True)
        x, h, c, wx, wh, b = args
        nbytes = _nbytes(x, h, c, wx, wh, b, h_new, c_new, gates)
        bound, by = bound_ms(nbytes, 2.0 * rows * (x.shape[1] + h.shape[1]) * 4 * c.shape[1],
                             torch.bfloat16)
        n_sets = max(2, math.ceil(2 * L2_BYTES / nbytes))
        cycle = itertools.cycle([args] + [
            lstm_inputs(gen, rows, *LSTM_FULL[1:], dtype=torch.bfloat16)
            for _ in range(n_sets - 1)])
        rec = {"input_sets": n_sets, "bound_ms": bound, "bound_by": by}
        time_into(rec, "ms", lambda: lc.lstm_cell_fwd(*next(cycle), want_gates=True), reps=200)
        per_launch[f"B{rows}"] = rec
        del cycle
    fwd_per_step = 2 * lstm_cfg.n_layers * TRAIN_T * 4
    runs["lstm_fwd_per_launch"] = per_launch
    print(json.dumps({"ranks_lstm_fwd": {
        "per_launch": per_launch, "launches_a_step_at_K4": fwd_per_step,
        "device_ms_a_step_at_K4": fwd_per_step * per_launch["B4"]["ms"],
        "bound_ms_a_step_at_K4": fwd_per_step * per_launch["B4"]["bound_ms"]}}), flush=True)
    torch.cuda.empty_cache()
    return runs


def phase_ranks_vs_plain(train_launch, api_mod, cfg):
    """Phase 15 (d): one pipelined step and one DP step (bucketed sync) on
    ranks sharing the card, each against the single-process step on the
    card from the same seeded weights (the launcher's seed 0) and batch, in
    phase 7's cell and within its limits."""
    cfg2 = dataclasses.replace(cfg, vocab_size=32768, dtype="float32")
    return ranks_vs_single(train_launch, api_mod, cfg2, 8, TRAIN_T, [
        ("pipe=2,micro=4,sched=1f1b", "pipe=2,micro=4,sched=1f1b", None),
        ("dp=2 overlapped", "dp=2,mp=1", "overlapped")], "ranks_vs_single")


def ranks_vs_single(train_launch, api_mod, cfg2, batch_size, seq, specs, key):
    """One step of each of ``specs`` ((name, --parallel spec, comm runtime or
    None[, ring chunks])) through the launcher's ranks, sharing the card,
    against the single-process step on the card from the same seeded weights
    (the launcher's seed 0) and batch: loss and grad norm within 1e-4
    relative, every rank's parameters (a pipelined rank's stage, a tensor-MP
    rank's part) within ``RANK_PARAMS_TOL``, and on a tensor-MP group every
    leaf the rules replicate the same bits on each of its ranks; TF32 off.
    Prints ``{key: results}``."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = 3e-3
    api = api_mod.build_model(cfg2, device="cuda")
    opt = adamw(warmup_cosine(lr, 20, 1))
    state = init_train_state(api, opt, 0)
    batch = {k: v.cuda() for k, v in _lm_batch(seq, batch_size).items()}
    state, metrics = make_train_step(api, opt, clip_norm=1.0)(state, batch)
    ref = (float(metrics["loss"]), float(metrics["grad_norm"]),
           _tree_to(state.params, "cpu"))
    del state, metrics, batch
    torch.cuda.empty_cache()
    results = {}
    for name, spec, comm, *chunks in specs:
        plan, mp, dp = train_launch.parse_parallel(spec, 1, cfg2)
        plan = dataclasses.replace(plan, dp_axes=("data",),
                                   comm_runtime=comm or plan.comm_runtime,
                                   comm_chunks=chunks[0] if chunks else 1)
        tensor = plan.mp_kind == "tensor" and mp > 1
        stages = mp if plan.is_pipeline or plan.is_context or tensor else 1
        run = train_launch.RankRun(cfg=cfg2, plan=plan, steps=1, batch=batch_size,
                                   seq=seq, lr=lr, return_params=True)
        summary = train_launch.run_ranks(run, dp, stages, "cuda")
        loss, gnorm = summary["history"][0], summary["grad_norms"][0]
        rules = SH.ShardingRules(cfg2, {"data": dp, "model": mp}, plan) if tensor else None
        err = 0.0
        for r, params in zip(summary["ranks"], summary["rank_params"]):
            if plan.is_pipeline:
                want = api.pipeline_stage_params(ref[2], stages, 1, r["stage"])
            elif tensor:
                want = SH.shard_params(ref[2], rules, r["stage"])
            else:
                want = ref[2]
            err = max(err, _max_err(tree_leaves(params), tree_leaves(want)))
        results[name] = {"loss_rel": abs(loss - ref[0]) / abs(ref[0]),
                         "grad_norm_rel": abs(gnorm - ref[1]) / abs(ref[1]),
                         "params_max_abs": err, "loss": loss, "grad_norm": gnorm,
                         "transport": summary["transport"].describe(dp * stages)}
        if tensor:
            results[name]["replicated_same_bits"] = _replicated_same_bits(
                summary["rank_params"], [r["data"] for r in summary["ranks"]], cfg2, rules)
    out = {key: results, "single": {"loss": ref[0], "grad_norm": ref[1]},
           "tol": {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": RANK_PARAMS_TOL}}
    print(json.dumps(out), flush=True)
    for name, r in results.items():
        if not (r["loss_rel"] <= 1e-4 and r["grad_norm_rel"] <= 1e-4
                and r["params_max_abs"] <= RANK_PARAMS_TOL
                and r.get("replicated_same_bits", True)):
            raise AssertionError(f"{name} on ranks disagrees with the single-process step: {r}")
    return results


def _replicated_same_bits(parts, data_index, cfg, rules):
    """Whether every leaf the rules replicate over the model axis holds the
    same bits on every rank of each model group (``parts`` in rank order,
    ``data_index`` each rank's data index)."""
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import tree_leaves

    flags = SH.replicated_leaves(parts[0], SH.param_specs(cfg, rules), rules)
    if not any(flags):
        raise AssertionError("no replicated leaf to compare")
    for d in set(data_index):
        group = [tree_leaves(p) for p, i in zip(parts, data_index) if i == d]
        for n, rep in enumerate(flags):
            if rep and not all(torch.equal(g[n], group[0][n]) for g in group[1:]):
                return False
    return True


def paper_batches(cfg, batch_size, n, seed, *, seq=GNMT_T, px=INCEPTION_PX):
    """``n`` seeded CPU batches of a paper model: GNMT's source/target pairs
    in order from ``SyntheticSeq2Seq(vocab, seq, seed)``; Inception's numpy
    images at ``px`` with labels in [0, classes) (the image dataset takes
    only sides that are multiples of 8, so not the config's 299)."""
    if cfg.family == "cnn":
        rng = np.random.default_rng(seed)
        return [{"images": torch.from_numpy(
                     rng.standard_normal((batch_size, px, px, 3), dtype=np.float32)),
                 "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, batch_size))}
                for _ in range(n)]
    from repro_torch.data import SyntheticSeq2Seq
    data = SyntheticSeq2Seq(vocab=cfg.vocab_size, seq_len=seq, seed=seed)
    return [{k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}
            for b in itertools.islice(data.epoch(0, batch_size), n)]


def phase_train_paper(lc, counters, api_mod, cfg, batch_size):
    """Full-width, full-depth GNMT (S = T = 50) or Inception-V3 (299 px)
    through ``build_model`` + ``make_train_step`` (AdamW over warmup-cosine,
    clip 1.0) from a seeded init, 5 steps, counters set to 0 just before and
    read just after: GNMT launches the LSTM forward (all ``tc``) and the
    pointwise backward once a cell step, 2 L T a step, and no other kernel;
    Inception launches none.  Then step time, target tokens or images a
    second and peak memory, and a profile of one step."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    api = api_mod.build_model(cfg, device="cuda")
    opt = adamw(warmup_cosine(3e-3, 20, TRAIN_STEPS))
    state = init_train_state(api, opt, 0)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    seq, unit = (1, "image") if cfg.family == "cnn" else (GNMT_T, "tok")
    *batches, timed_batch = paper_batches(cfg, batch_size, TRAIN_STEPS + 1, 0)
    batches = [{k: v.cuda() for k, v in b.items()} for b in batches]
    step = make_train_step(api, opt, clip_norm=1.0)
    torch.cuda.synchronize()
    reset_counters(every)
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in every.items()}
    variants = variant_launches(every)
    want = dict.fromkeys(every, 0)
    want_variants = {name: dict.fromkeys(v, 0) for name, v in variants.items()}
    if cfg.family == "rnn":
        cells = TRAIN_STEPS * 2 * cfg.n_layers * seq          # encoder + decoder, S = T
        want.update(lstm_cell_fwd=cells, lstm_cell_bwd_pointwise=cells)
        want_variants["lstm_cell_fwd"]["tc"] = cells
    if launches != want or variants != want_variants:
        raise AssertionError(f"training {cfg.name} launched {launches} {variants}, want "
                             f"{want} {want_variants}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            state.step != TRAIN_STEPS or \
            not all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)):
        raise AssertionError(f"training {cfg.name} gave losses {losses} or non-finite "
                             f"parameters")
    out = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
           "input": {k: list(v.shape) for k, v in batches[0].items()}, "steps": TRAIN_STEPS,
           "losses": losses, "wall_s_5_steps": wall_s, "launches": launches,
           "lstm_cell_fwd_variant_launches": variants["lstm_cell_fwd"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(out), flush=True)
    timing = time_train_steps(api_mod, cfg, state, batch_size, seq, f"train_step {cfg.name}",
                              batch=timed_batch, unit=unit)
    del state, batches, step
    torch.cuda.empty_cache()
    return launches, timing


def paper_step(api_mod, cfg, batch, *, params=None, device="cuda", mesh=None, seed=0):
    """One AdamW step (warmup-cosine, clip 1.0) of a paper model on
    ``batch`` from ``params`` (default: the seeded init on the device); on
    the ranks of ``mesh``, pure DP with the bucketed sync, each rank taking
    its rows.  Returns (loss, grad norm, parameters on the CPU)."""
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import TrainState, make_train_step

    api = api_mod.build_model(cfg, device=mesh.device if mesh else device)
    params = api.init(seed) if params is None else params
    opt = adamw(warmup_cosine(3e-3, 20, 1))
    plan = ParallelPlan(model_axis=None, comm_runtime="overlapped") if mesh else None
    step = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0)
    if mesh is None:
        batch = {k: v.to(api.device) for k, v in batch.items()}
    state, metrics = step(TrainState(params, opt.init(params), 0), batch)
    return float(metrics["loss"]), float(metrics["grad_norm"]), _tree_to(state.params, "cpu")


def _paper_rank(mesh, cells):
    """Phase 18 (b) on one rank: a dp = 2 step of each cell (TF32 off in
    this fresh process too)."""
    from repro_torch.models import api as api_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {name: paper_step(api_mod, cfg, batch, mesh=mesh)
            for name, (cfg, batch) in cells.items()}


def _step_errors(got, want):
    from repro_torch.tree import tree_leaves

    (gl, gn, gp), (wl, wn, wp) = got, want
    return {"loss_rel": abs(gl - wl) / abs(wl), "grad_norm_rel": abs(gn - wn) / abs(wn),
            "params_max_abs": _max_err(tree_leaves(gp), tree_leaves(wp)),
            "loss": gl, "grad_norm": gn}


def phase_paper_vs_plain(api_mod, gnmt_cfg, inc_cfg):
    """(a) One f32 step of full-width GNMT at 2 + 2 layers (B 16, S = T =
    50) and of full-depth Inception-V3 (B 4 x 299), the card's kernels and
    cuDNN against the plain path on the CPU from the same seeded weights:
    loss and grad norm within 1e-4 relative, parameters within 1e-3 (phase
    7's limits).  (b) The same cells at dp = 2 on 2 ranks sharing the card
    against the single-process card step: loss and grad norm within 1e-4
    relative, parameters within 5e-5 (phase 15 (d)'s limits).  Inception's
    (b) runs in f64: one AdamW step moves an element by lr(0) * sign(g), and
    at 299 px enough of its f32 gradients sum to within round-off of zero
    that the other batch split flips some signs, moving them 2 lr(0) = 3e-4
    apart (28 of 29.7 M elements on an H100); GNMT's LSTM kernels take
    f32 and bf16 only, and its f32 step holds.  TF32 is off: cuDNN's TF32
    convolutions would miss 1e-4."""
    from repro_torch.parallel import dist as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = {"gnmt 2+2 B16": dataclasses.replace(gnmt_cfg, n_layers=2, encoder_layers=2,
                                               dtype="float32"),
           "inception_v3 B4 x 299": dataclasses.replace(inc_cfg, dtype="float32")}
    batches = {name: paper_batches(cfg, 16 if cfg.family == "rnn" else 4, 1, 7)[0]
               for name, cfg in f32.items()}
    on_ranks = {name: (dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
                       if cfg.family == "cnn" else cfg, batches[name])
                for name, cfg in f32.items()}
    vs_cpu, card = {}, {}
    for name, cfg in f32.items():
        params = api_mod.build_model(cfg, device="cuda").init(1)
        cpu_params = _tree_to(params, "cpu")
        got = paper_step(api_mod, cfg, batches[name], params=params)
        want = paper_step(api_mod, cfg, batches[name], params=cpu_params, device="cpu")
        vs_cpu[name] = _step_errors(got, want)
        card[name] = paper_step(api_mod, *on_ranks[name])        # seed 0, the ranks' init
        del params, cpu_params, got, want
        torch.cuda.empty_cache()
    ranks = D.spawn_ranks(_paper_rank, 2, "cuda", args=(on_ranks,))
    dp = {f"{name} dp=2 ({cfg.dtype}), rank {r}": _step_errors(res[name], card[name])
          for r, res in enumerate(ranks) for name, (cfg, _) in on_ranks.items()}
    tol_cpu = {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": 1e-3}
    tol_ranks = {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": RANK_PARAMS_TOL}
    print(json.dumps({"paper_vs_plain": vs_cpu, "tol": tol_cpu}), flush=True)
    print(json.dumps({"paper_ranks_vs_single": dp, "tol": tol_ranks}), flush=True)
    for results, tol in ((vs_cpu, tol_cpu), (dp, tol_ranks)):
        for name, r in results.items():
            if not all(r[k] <= tol[k] for k in tol):
                raise AssertionError(f"{name} disagrees with its reference: {r}, limits {tol}")
    return vs_cpu, dp


def _ring_inputs(dtype, seed=23):
    """Phase 19 (b)'s q, k, v, dO at (a)'s shapes (B 2, T 2048, H 32/8, hd
    64), from a CPU generator: every rank and the single process draw the
    same."""
    gen = torch.Generator().manual_seed(seed)
    b, t = RING_B, RING_T
    return [torch.randn(shape, generator=gen).to(dtype)
            for shape in ((b, t, 32, 64), (b, t, 8, 64), (b, t, 8, 64), (b, t, 32, 64))]


def _ring_rank(mesh, cfg):
    """Phase 19 (b) on one rank: its rows of q, k, v, dO through
    ``ring_attention`` and back, in bf16 and f32; the output rows and dq, dk,
    dv on the CPU, and this rank's flash launches.  Then the wall time of
    (a)'s gradient sync alone: one all-reduce a leaf over every rank of
    ``cfg``'s f32 parameters (through host memory, as in (a)), twice."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import build_model
    from repro_torch.parallel.collectives import all_reduce_grads
    from repro_torch.parallel.context import ring_attention

    j, m = mesh.ring("model")[:2]
    n = RING_T // m
    out = {}
    for layer, dtype in enumerate((torch.bfloat16, torch.float32)):
        q, k, v, do = (x[:, j * n:(j + 1) * n].to(mesh.device) for x in _ring_inputs(dtype))
        leaves = [x.requires_grad_() for x in (q, k, v)]
        o = ring_attention(*leaves, mesh=mesh, causal=True, layer=layer)
        grads = torch.autograd.grad(o, leaves, do)
        out[str(dtype)] = [t.detach().cpu() for t in (o, *grads)]
    out["launches"] = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    leaves = build_model(cfg, device=mesh.device).init(0)   # the values do not matter
    out["grad_sync_ms"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_grads(leaves, mesh, axis=None)
        torch.cuda.synchronize()
        out["grad_sync_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def phase_context(train_launch, lc, counters, api_mod, cfg):
    """Phase 19: Llama-3.2-1B's 8-card context plan on ranks sharing the
    card.  (a) Full width and depth through ``--parallel auto --devices 8``
    (context 1 x 4 x 2, clamped to 1 DP x a ring of 2 ranks), B 2 x T 2048,
    2 steps, with the counters set to 0 just before and read just after:
    L m (m + 1) / 2 flash forward launches a step summed over the ranks, all
    ``tc_prefill``, and as many backward calls, all ``tc``; finite losses;
    each rank's peak beside the planner's memory model.  (b)
    ``ring_attention`` alone on 2 ranks at (a)'s shapes against
    single-process ``flash_attention`` at T 2048, out and dq, dk, dv: bf16
    within 2e-2 of max(1, |ref|), f32 within ``BWD_F32_TOL``; and the wall
    time of (a)'s gradient sync alone on those ranks.  (c) 2
    full-width layers in f32, vocab 32768, B 4 x T 512: one step at ``cp=2``
    and one at ``dp=2,cp=2`` (4 ranks) against the single-process card step
    (phase 15 (d)'s limits)."""
    from repro_torch.core import planner as planner_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.parallel import dist as D

    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    torch.cuda.empty_cache()
    reset_counters(every)
    summary = train_launch.main(["--arch", "llama3_2_1b", "--parallel", "auto", "--devices",
                                 "8", "--batch", str(RING_B), "--seq", str(RING_T),
                                 "--steps", str(RING_STEPS)])
    ring = 2
    rec = check_rank_run(summary, "(a) llama3_2_1b --parallel auto --devices 8", cfg,
                         steps=RING_STEPS, stages=ring, micro=1, seq=RING_T, lstm=False,
                         high_water=0, ring=True)
    rec["planner_per_device_mem_gib"] = planner_mod.per_device_mem_bytes(
        cfg, mp=ring, mp_kind="context", mini_batch=RING_B, seq_len=RING_T, remat=False,
        opt_bytes_per_param=planner_mod.default_opt_bytes_per_param(cfg)) / 2**30
    rec["batch"], rec["seq"] = RING_B, RING_T
    print(json.dumps({"context_a": rec}), flush=True)
    del summary
    torch.cuda.empty_cache()

    # (b) the ring alone against one process
    ranks = D.spawn_ranks(_ring_rank, ring, "cuda", args=(cfg,), stages=ring)
    ring_check = {"launches_a_rank": [r["launches"] for r in ranks],
                  "grad_sync_ms_a_rank": [r["grad_sync_ms"] for r in ranks]}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (x.cuda() for x in _ring_inputs(dtype))
        leaves = [x.requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=True)
        want = [t.detach().float() for t in (o, *torch.autograd.grad(o, leaves, do))]
        tol = TOL[torch.bfloat16] if dtype == torch.bfloat16 else BWD_F32_TOL
        errs = {}
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            got = torch.cat([r[str(dtype)][i] for r in ranks], dim=1).cuda().float()
            errs[name] = float((got - want[i]).abs().max()) / max(1.0, float(
                want[i].abs().max()))
        ring_check[str(dtype).removeprefix("torch.")] = {"rel_err": errs, "tol": tol}
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"ring_attention ({dtype}) against one process: {errs}")
        del q, k, v, do, leaves, o, want
    print(json.dumps({"context_b": ring_check}), flush=True)
    torch.cuda.empty_cache()

    # (c) the step on ranks against one process, in f32
    cfg2 = dataclasses.replace(cfg, n_layers=2, vocab_size=32768, dtype="float32")
    steps = ranks_vs_single(train_launch, api_mod, cfg2, RING_CELL_B, RING_CELL_T,
                            [("cp=2", "cp=2", None), ("dp=2,cp=2", "dp=2,cp=2", None)],
                            "context_c")
    torch.cuda.empty_cache()
    return rec, ring_check, steps


def _tensor_inception_rank(mesh, plan, cfg, cfg64, cell_batch):
    """Phase 20 (c) on one rank: 2 bf16 steps of full Inception-V3 at B 64 x
    299 on the planner's tensor plan (its part of the seeded init; step ms,
    peak, losses, its kernel launches), then one f64 step of ``cfg64`` at
    ``cell_batch`` from seed 0 (TF32 off): loss, grad norm, its part on the
    CPU."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import api as api_mod
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step

    api = api_mod.build_model(cfg, device=mesh.device)
    opt = adamw(warmup_cosine(3e-3, 20, TP_STEPS))
    state = init_train_state(api, opt, 0, mesh=mesh, plan=plan)
    step = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0)
    batches = paper_batches(cfg, INCEPTION_B, TP_STEPS, 0)
    cuda = mesh.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {"step_ms": [], "losses": []}
    for b in batches:
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(metrics["loss"]))
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    out["launches"] = {n: f.launches for n, f in (
        ("flash_attention", fa.flash_attention), ("flash_attention_bwd",
                                                  fa.flash_attention_bwd),
        ("lstm_cell_fwd", lc.lstm_cell_fwd), ("gmm", gm.gmm), ("wkv6", wk.wkv6))}
    del state, step, batches
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    api = api_mod.build_model(cfg64, device=mesh.device)
    opt = adamw(warmup_cosine(3e-3, 20, 1))
    state = init_train_state(api, opt, 0, mesh=mesh, plan=plan)
    state, metrics = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0)(
        state, cell_batch)
    out["f64"] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                  _tree_to(state.params, "cpu"))
    return out


def _tp_comm_rank(mesh, d_model):
    """The wall time of phase 20 (a)'s messages alone on ranks sharing the
    card: an all-reduce of a (B, T, d) bf16 activation (the gspmd block's,
    after each row-parallel product and in each ``copy_to_model``
    backward) and one ring hop of a chunk of rows (B, T / 2m, d), the
    overlapped block's message at 2 chunks; 2 warm-ups, then 5 of each."""
    from repro_torch.parallel import collectives as CL
    from repro_torch.parallel import dist as D

    x = torch.randn((TP_B, TP_T, d_model), device=mesh.device).to(torch.bfloat16)
    piece = x[:, :TP_T // (2 * TP_M)].contiguous()
    out = {}
    tag = D.tp_message_tag(0, 0, 0, 0, 0)
    for name, fn in (("all_reduce_ms", lambda: D.all_reduce(mesh, x, "model")),
                     ("ring_hop_ms", lambda: CL._pass_on(mesh, "model", [piece],
                                                         lambda i: tag))):
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times[2:]
    out["all_reduce_bytes"], out["ring_hop_bytes"] = _nbytes(x), _nbytes(piece)
    return out


def phase_tensor(train_launch, lc, counters, api_mod, cfg, inc_cfg):
    """Phase 20: tensor MP on ranks sharing the card.  (a) Full-width,
    full-depth Llama-3.2-1B through the launcher at ``mp=2`` overlapped (2
    chunks) and gspmd, B 4 x T 2048, 2 steps each, counters set to 0 just
    before and read just after: L m flash forward launches a step summed
    over the ranks (``tc_prefill``) and as many backward calls (``tc``),
    every rank's losses finite and the same, its peak and step ms, and the
    wall time of one all-reduce and one ring hop of those runs' messages
    alone (``_tp_comm_rank``).  (b) 2 full-width f32 layers, vocab 32768, B
    4 x T 512, at ``mp=2`` gspmd, overlapped with 1 and 2 chunks and
    ``dp=2,mp=2`` overlapped against the single-process card step.  (c)
    Inception-V3's 256-card plan clamped to 2 ranks: 2 bf16 steps at B 64 x
    299, and an f64 step at phase 18 (b)'s cell against the single card
    step (phase 15 (d)'s limits, replicated leaves the same bits)."""
    from repro_torch.core.planner import HybridPlanner, default_epoch_model
    from repro_torch.parallel import dist as D
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import tree_leaves

    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    runs = {}
    for comm, extra in (("overlapped", ["--comm-chunks", "2"]), ("gspmd", [])):
        torch.cuda.empty_cache()
        reset_counters(every)
        name = f"(a) llama3_2_1b --parallel mp={TP_M} --comm-runtime {comm} {' '.join(extra)}"
        summary = train_launch.main(["--arch", "llama3_2_1b", "--parallel", f"mp={TP_M}",
                                     "--comm-runtime", comm, *extra, "--batch", str(TP_B),
                                     "--seq", str(TP_T), "--steps", str(TP_STEPS)])
        rec = check_rank_run(summary, name, cfg, steps=TP_STEPS, stages=TP_M, micro=1,
                             seq=TP_T, lstm=False, high_water=0, tensor=True)
        rec["per_step"] = {"flash_attention": rec["launches"]["flash_attention"] // TP_STEPS,
                           "flash_attention_bwd":
                               rec["launches"]["flash_attention_bwd"] // TP_STEPS}
        rec["batch"], rec["seq"] = TP_B, TP_T
        print(json.dumps({f"tensor_a_{comm}": rec}), flush=True)
        runs[comm] = rec
        del summary
    torch.cuda.empty_cache()
    comm_ms = D.spawn_ranks(_tp_comm_rank, TP_M, "cuda", args=(cfg.d_model,), stages=TP_M)
    print(json.dumps({"tensor_a_messages": comm_ms}), flush=True)

    # (b) steps on ranks against one process, in f32
    cfg2 = dataclasses.replace(cfg, n_layers=2, vocab_size=32768, dtype="float32")
    steps = ranks_vs_single(train_launch, api_mod, cfg2, RING_CELL_B, RING_CELL_T, [
        ("mp=2 gspmd", "mp=2", "gspmd"), ("mp=2 overlapped c1", "mp=2", "overlapped", 1),
        ("mp=2 overlapped c2", "mp=2", "overlapped", 2),
        ("dp=2,mp=2 overlapped c2", "dp=2,mp=2", "overlapped", 2)], "tensor_b")
    torch.cuda.empty_cache()

    # (c) Inception-V3's planned tensor plan, clamped to a model axis of 2
    choice = HybridPlanner(inc_cfg, epoch_model=default_epoch_model(inc_cfg)).choices(256)[0]
    plan = dataclasses.replace(choice.plan, dp_axes=("data",))
    if choice.mp_kind != "tensor":
        raise AssertionError(f"the planner's 256-card Inception plan is {choice.mp_kind}, "
                             f"not tensor")
    cfg64 = dataclasses.replace(inc_cfg, dtype="float64", param_dtype="float64")
    cell_batch = paper_batches(inc_cfg, 4, 1, 7)[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    single = paper_step(api_mod, cfg64, cell_batch)
    ranks = D.spawn_ranks(_tensor_inception_rank, TP_M, "cuda",
                          args=(plan, inc_cfg, cfg64, cell_batch), stages=TP_M)
    rules = SH.ShardingRules(inc_cfg, {"data": 1, "model": TP_M}, plan)
    errs = []
    for j, r in enumerate(ranks):
        loss, gnorm, part = r["f64"]
        e = _step_errors((loss, gnorm, part),
                         (single[0], single[1], SH.shard_params(single[2], rules, j)))
        errs.append(e)
    same_bits = _replicated_same_bits([r["f64"][2] for r in ranks], [0] * TP_M, cfg64, rules)
    rec = {"planner_256": {"mesh": list(choice.mesh_shape), "kind": choice.mp_kind,
                           "mp": choice.mp, "dp": choice.pods * choice.dp,
                           "speedup": choice.speedup},
           "clamped_to": {"data": 1, "model": TP_M},
           "bf16_B64": [{k: r[k] for k in ("step_ms", "losses", "peak_mem_gib", "launches")}
                        for r in ranks],
           "f64_vs_single": errs, "replicated_same_bits": same_bits,
           "tol": {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": RANK_PARAMS_TOL}}
    print(json.dumps({"tensor_c": rec}), flush=True)
    losses = [r["losses"] for r in ranks]
    if not all(np.isfinite(losses[0])) or any(x != losses[0] for x in losses) or \
            any(any(r["launches"].values()) for r in ranks):
        raise AssertionError(f"Inception-V3's tensor plan: losses {losses}, launches "
                             f"{[r['launches'] for r in ranks]}")
    if not same_bits or not all(e[k] <= rec["tol"][k] for e in errs for k in rec["tol"]):
        raise AssertionError(f"Inception-V3's tensor plan disagrees with the single step: {rec}")
    torch.cuda.empty_cache()
    return runs, steps, rec


def _by_path(paths, kernel):
    return {path: launches[kernel] for path, launches in paths.items()}


def _tp_paths(runs, kernel, key="launches"):
    """Phase 20 (a)'s runs as ``launches_by_path`` (or variant) entries."""
    return {f"train llama3_2_1b mp=2 {comm} (ranks)": run[key][kernel]
            for comm, run in runs.items()}


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
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "Performance Loss" in line):
                print(f"  {name}: {line.strip()}")

    _phase("3 kernels against their plain versions")
    rows = phase_kernels(fa)
    fwd_rows, bwd_rows, _ = phase_lstm_kernels(lc, ref_mod)
    gmm_rows = phase_gmm_kernels(gm, ref_mod)
    wkv_rows = phase_wkv_kernels(wk, ref_mod)
    flash_bwd_rows = phase_flash_bwd(fa)
    hop_fwd_rows, hop_bwd_rows = phase_ring_hops(fa)
    rows += hop_fwd_rows
    flash_bwd_rows += hop_bwd_rows
    tp_fwd_rows, tp_bwd_rows = phase_tp_attention(fa)
    rows += tp_fwd_rows
    flash_bwd_rows += tp_bwd_rows
    counters = {"flash_attention": fa.flash_attention,
                "flash_attention_bwd": fa.flash_attention_bwd, "gmm": gm.gmm, "wkv6": wk.wkv6}

    _phase("4 serve llama3_2_1b, full width and depth")
    cfg = get_config("llama3_2_1b")
    launches, variants = phase_serve(counters, api_mod, engine_mod, cfg)

    _phase("5 model path against its plain path")
    phase_model_vs_plain(api_mod, moe_mod, cfg)

    _phase("6 train biglstm, full width and depth")
    lstm_cfg = get_config("biglstm")
    train_launches, train_variants, lstm_timing = phase_train(train_launch, lc, counters,
                                                              api_mod, lstm_cfg)

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

    _phase("12 train llama3_2_1b, full width and depth")
    llama_launches, llama_variants, llama_timing = phase_train_llama(train_launch, lc,
                                                                     counters, api_mod, cfg)

    _phase("13 Llama train step against its plain path")
    phase_llama_train_vs_plain(fa, api_mod, cfg)

    _phase("14 the planner on the card")
    auto_launches, auto64_launches = phase_planner(train_launch, lc, counters, lstm_cfg, cfg,
                                                   lstm_timing, llama_timing)

    _phase("15 DP and pipeline ranks on the card")
    rank_runs = phase_ranks(train_launch, lc, lstm_cfg)
    phase_ranks_vs_plain(train_launch, api_mod, lstm_cfg)

    _phase("16 train gnmt, full width and depth")
    gnmt_cfg = get_config("gnmt")
    gnmt_launches, _ = phase_train_paper(lc, counters, api_mod, gnmt_cfg, GNMT_B)

    _phase("17 train inception_v3, full width and depth")
    inc_cfg = get_config("inception_v3")
    inc_launches, _ = phase_train_paper(lc, counters, api_mod, inc_cfg, INCEPTION_B)

    _phase("18 GNMT and Inception-V3 steps against the plain path and on ranks")
    phase_paper_vs_plain(api_mod, gnmt_cfg, inc_cfg)

    _phase("19 Llama's context plan on a ring of ranks")
    context_run, _, _ = phase_context(train_launch, lc, counters, api_mod, cfg)

    _phase("20 tensor MP on ranks")
    tp_runs, _, _ = phase_tensor(train_launch, lc, counters, api_mod, cfg, inc_cfg)

    _phase("21 result")
    paper_paths = {"train gnmt": gnmt_launches, "train inception_v3": inc_launches}
    lstm_src = "src/repro_torch/kernels/csrc/lstm_cell.cu"
    kernels = [
        _kernel_entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:33",
                      launches["flash_attention"], rows,
                      launches_by_path={"serve llama3_2_1b": launches["flash_attention"],
                                        "serve granite_moe_1b_a400m":
                                            moe_launches["flash_attention"],
                                        "train llama3_2_1b": llama_launches["flash_attention"],
                                        "train smollm_360m dp=2,pipe=2 (ranks)":
                                            rank_runs["c"]["launches"]["flash_attention"],
                                        "train llama3_2_1b context ring of 2 (ranks)":
                                            context_run["launches"]["flash_attention"],
                                        **_tp_paths(tp_runs, "flash_attention"),
                                        **_by_path(paper_paths, "flash_attention")},
                      variant_launches_by_path={
                          "serve llama3_2_1b": variants["flash_attention"],
                          "serve granite_moe_1b_a400m": moe_variants["flash_attention"],
                          "train llama3_2_1b": llama_variants["flash_attention"],
                          "train llama3_2_1b context ring of 2 (ranks)":
                              context_run["variant_launches"]["flash_attention"],
                          **_tp_paths(tp_runs, "flash_attention", "variant_launches")}),
        _kernel_entry("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/models/layers.py:160",
                      llama_launches["flash_attention_bwd"], flash_bwd_rows,
                      library=flash_bwd_rows[0]["library"],
                      launches_by_path={
                          "train llama3_2_1b": llama_launches["flash_attention_bwd"],
                          "train biglstm": train_launches["flash_attention_bwd"],
                          "train smollm_360m dp=2,pipe=2 (ranks)":
                              rank_runs["c"]["launches"]["flash_attention_bwd"],
                          "train llama3_2_1b context ring of 2 (ranks)":
                              context_run["launches"]["flash_attention_bwd"],
                          **_tp_paths(tp_runs, "flash_attention_bwd"),
                          **_by_path(paper_paths, "flash_attention_bwd")},
                      variant_launches_by_path={
                          "train llama3_2_1b": llama_variants["flash_attention_bwd"],
                          "train llama3_2_1b context ring of 2 (ranks)":
                              context_run["variant_launches"]["flash_attention_bwd"],
                          **_tp_paths(tp_runs, "flash_attention_bwd", "variant_launches")},
                      note="no TPU kernel: JAX differentiates src/repro/models/layers.py:160 "
                           "(attention)"),
        _kernel_entry("lstm_cell_fwd", lstm_src, "src/repro/kernels/lstm_cell.py:24",
                      train_launches["lstm_cell_fwd"], fwd_rows,
                      variant_launches=train_variants,
                      launches_by_path={
                          "train biglstm": train_launches["lstm_cell_fwd"],
                          "train biglstm --parallel auto": auto_launches["lstm_cell_fwd"],
                          "train biglstm --parallel auto --devices 64 (ranks)":
                              auto64_launches["lstm_cell_fwd"],
                          "train biglstm pipe=2 1f1b (ranks)":
                              rank_runs["a"]["launches"]["lstm_cell_fwd"],
                          "train biglstm pipe=2 gpipe (ranks)":
                              rank_runs["b"]["launches"]["lstm_cell_fwd"],
                          **_by_path(paper_paths, "lstm_cell_fwd")}),
        _kernel_entry("lstm_cell_bwd_pointwise", lstm_src,
                      "src/repro/kernels/lstm_cell.py:24", train_launches[
                          "lstm_cell_bwd_pointwise"], bwd_rows,
                      launches_by_path={
                          "train biglstm": train_launches["lstm_cell_bwd_pointwise"],
                          "train biglstm --parallel auto":
                              auto_launches["lstm_cell_bwd_pointwise"],
                          "train biglstm --parallel auto --devices 64 (ranks)":
                              auto64_launches["lstm_cell_bwd_pointwise"],
                          "train biglstm pipe=2 1f1b (ranks)":
                              rank_runs["a"]["launches"]["lstm_cell_bwd_pointwise"],
                          "train biglstm pipe=2 gpipe (ranks)":
                              rank_runs["b"]["launches"]["lstm_cell_bwd_pointwise"],
                          **_by_path(paper_paths, "lstm_cell_bwd_pointwise")},
                      note="no TPU backward kernel: JAX differentiates the plain cell "
                           "(src/repro/models/lstm.py:53)"),
        _kernel_entry("gmm", "src/repro_torch/kernels/csrc/moe_gmm.cu",
                      "src/repro/kernels/moe_gmm.py:23", moe_launches["gmm"], gmm_rows,
                      variant_launches=moe_variants["gmm"],
                      launches_by_path={"serve granite_moe_1b_a400m": moe_launches["gmm"],
                                        **_by_path(paper_paths, "gmm")}),
        _kernel_entry("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                      "src/repro/kernels/rwkv_scan.py:25", rwkv_launches["wkv6"], wkv_rows,
                      library=wkv_rows[0]["library"], variant_launches=rwkv_variants["wkv6"],
                      launches_by_path={"serve rwkv6_7b": rwkv_launches["wkv6"],
                                        **_by_path(paper_paths, "wkv6")}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
