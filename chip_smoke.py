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
   flash attention with per-row key lengths (``kv_lens``) at phase 22's
   shapes, bf16 and f32, window 0 and 256: the decode tick (B 8, Tq 1,
   capacity 1064, H 32/8, hd 64, lengths 1, 63, 64, 65, 1063, 1064 and two
   seeded ones, so some split runs lie wholly past a row's length) and a
   prefill chunk (B 1, Tq 256 at pos 0, 256 and 768, causal), each timed
   against its plain version, the bound of the keys the rows keep and SDPA
   with the same boolean ``attn_mask``; and one row's output the same bits
   whatever the other rows' lengths;
   flash attention with an explicit query start (``q_start``) at the
   sharded serving steps' shapes, bf16: the context-parallel chunk's cache
   partial (B 1, the 128 rows of ring place 1 of a 256-token chunk against
   the 1064-slot cache, ``kv_lens = pos``, ``q_start = pos + 128``, not
   causal) at pos 0 (every row sees no key), 256 and 768, window 0 and 256;
   a tensor-MP rank's tick (B 8, Tq 1, capacity 1064, H 16/4, ``kv_lens``);
   the windowed ring's past-block hop at phase 19's hop shape (B 2, T/m
   1024, H 32/8, window 256, ``q_start`` 1024), forward with lse and the
   backward given the global output and lse; each timed against its plain
   version, its bound and SDPA's call (with the boolean mask where the
   masks are per row); and the bits of a launch with ``q_start = 0`` equal
   to one without;
   the LSTM cell's forward (tensor-core ``tc`` tile and FMA kernel) and
   pointwise backward at full-width BigLSTM (B 16, d_in 1024, d_h 1024, H
   8192; also at the pipeline's micro-batch rows B 4 and B 1), at GNMT's
   cells (B 128, d_in 1024 and 2048, H 1024, x a strided row of the layer
   input as the decoder's concat gives it; bf16 on ``tc``, f32 on ``fma``,
   timed against ``torch.lstm_cell``) and at shapes
   where B and H are no tile multiples, h' and c' the
   same bits with and without the gates, and the cell's autograd function
   (dx, dh, dc, dWx, dWh, db) against autograd of the plain oracle; the
   LSTM forward's gx entry (x @ Wx precomputed, as the overlapped tensor-MP
   layer gives it) at a 2-way MP rank's cells of BigLSTM (B 16, d_h 1024,
   H 4096, gx a row of the (B, T, 4, H) ring output) and GNMT (B 128, d_h
   1024, H 512), ``tc`` and ``fma`` forced, against its plain twin (gates
   within 1e-4, a repeat launch the same bits), timed against its bound and
   one ``torch.mm`` plus ``_thnn_fused_lstm_cell``, and at edge shapes; the
   grouped matmul at full-width Granite-3.0-1B-A400M's four expert products
   (prefill at capacity 640, decode at C 4), its forward at Granite's
   training products (capacity 2560; bf16 prefill on the persistent TMA
   ``wgmma`` tile, which the phase prints) and at edge shapes (odd C, d, F;
   G, C and d of 1); the RWKV6 WKV recurrence (``chunked`` form on the
   tensor cores and sequential ``scan``) at full-width RWKV6-7B prefill (B
   4, T 512, H 64, hd 64, r, k, v in bf16 and f32) and a decode step (T 1,
   from a non-zero state, in place), at edge shapes (T 1, 7, 16, 17, 33,
   130; hd 32; B 1, H 1) and over long prompts from a state (decays near 1
   over T 2048 and 8192, strong decays down to 1e-38 over T 2048), outputs
   and final state; the grouped matmul's backward (dx = dy w^T and dw = x^T
   dy, a launch each) at Granite's training products (B 4 x T 2048: capacity
   2560; bf16 on the persistent wgmma tile ``tc``, then the FMA kernel forced on the
   same inputs; f32; a misaligned bf16 x), at an expert-parallel rank's
   products (16 of the 32 experts, phase 20 (a); forward and backward on the
   wgmma tile, timed against ``torch.bmm``) and at edge shapes (C 1, odd d and
   F, tiles ragged in every dimension), against the plain twin within 1e-4
   (f32) or 2e-2 (bf16) of max(1, |ref|), timed against ``torch.bmm``; the
   WKV backward (dr, dk, dv, dw, du) at RWKV6-7B's training shape (B 4, T
   2048, H 64, hd 64, bf16; chunk-parallel: a state pass and a block per
   64-token chunk), T no multiple of its chunk, hd 32 and
   strong decays, within 2e-4 (f32) or 2e-2 (bf16) of max(1, |ref|); both
   backwards the same bits on a repeat launch.  Time each kernel variant at the main shape, its plain
   version and one PyTorch library call computing the same function where
   there is one (a yardstick the port never calls): device time per call
   from torch.profiler (``ms``) and CUDA-event time per call, host gaps
   included (``call_ms``);
4. serve full-width, full-depth Llama-3.2-1B from a seeded random init
   through ``ServeEngine.generate`` (4 prompts of 512 tokens, 32 new tokens,
   greedy) with the launch counters set to 0 just before and read just after
   (every bf16 flash launch on a tensor-core variant), then profile one
   prefill and one decode step (torch.profiler after a warm-up cycle: wall
   time, device busy time, idle share, top kernels; no more kernels a decode
   step than commit f4893cd runs, and the step's kernels by name);
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
   versions on the CPU (phase 7's limits, and every gradient leaf within
   ``STEP_GRAD_LEAF_TOL`` of the CPU's);
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
   step (phase 15 (d)'s limits; replicated leaves the same bits).  Expert
   parallelism on the same spawns: (a) full-width, full-depth
   Granite-3.0-1B-A400M through ``--parallel auto --devices 8`` (the
   planner's tensor 4 x 2, clamped to 1 DP x a model axis of 2), B 4 x T
   2048, 2 steps after the Llama runs: each rank's own launches exact a
   step (3 L gmm forward on its 16 experts, ``tc_prefill``, 3 L ``tc_dx``
   and 3 L ``tc_dw``, L flash forward and L backward calls), the losses
   finite and equal on both ranks, each rank's peak and step ms; (b) 2
   full-width Granite layers in f32, vocab 32768: ``mp=2`` at the default
   capacity and ``dp=2,mp=2`` with and without fsdp at capacity None, each
   against the single-process card step of that capacity; (c) f32
   Adafactor steps of (b)'s Llama cell at ``mp=2``, ``pipe=2`` and ``dp=2``
   with fsdp against the single-process card Adafactor step (all at phase
   15 (d)'s limits);
21. checkpoints and fault tolerance: (a) full-width, full-depth SmolLM-360M
   (B 8 x T 512, 4 steps, a checkpoint every 2) through the launcher in
   three processes (the third beside the first two on the card):
   ``--fault kill@4`` exits 17 and leaves
   ``ckpt_00000002``, ``--resume`` restores it and ends at step 4, and a
   straight run with ``--background-save``; the two final checkpoints are
   bit-equal leaf for leaf (read with the port's codec), and each process
   that finishes launched 32 flash forward (``tc_prefill``) and 32 backward
   (``tc``) kernels a step it ran, counted from 0 in that process; then, in
   this process on a SmolLM-360M state on the card, the temp directory's
   free bytes and filesystem, the checkpoint's bytes, a sync save's time
   split into host copy, CRC and write, and fsync, the time a background
   save takes to return (the step's stall) and ``restore_latest_valid``'s
   time until the state is on the card, bit-equal to the saved state; (b)
   2 full-width SmolLM layers in f32 on ranks sharing the card, 4 steps at
   ``dp=2`` and at ``pipe=2,micro=2,sched=1f1b`` with a checkpoint every 2,
   run while (a)'s launchers run: the step-2 file restores in one process bit-equal to the file (the
   stage gather gives JAX's layout), and one process resumed from it to
   step 4 ends within JAX's elastic tolerance (rtol 2e-4, atol 1e-5) of
   the ranks' step-4 file;
22. continuous batching: (a) full-width, full-depth Llama-3.2-1B through
   ``serve.continuous.ContinuousEngine`` (8 slots of 1064 positions,
   prefill chunks of 256, 16 greedy requests with seeded prompt lengths in
   64-1024 and 32 new tokens each) with the counters set to 0 just before
   and read just after (16 flash launches a decode tick, all ``tc_decode``,
   and 16 a prefill chunk, all ``tc_prefill`` but for a chunk of at most 4
   tokens, which the decode tile takes), tok/s, ms a tick, the median time
   to first token, peak GiB and one tick's profile; 4 of the requests,
   each served alone in an engine of the same shape, give the same tokens
   and logprobs bit for bit; (b) ``python -m repro_torch.launch.serve
   --continuous --slots 4 --prefill-chunk 128 --batch 8 --prompt-len 512
   --max-new 32`` in a process of its own exits 0 with 16 flash launches a
   tick and a chunk; (c) 2 full-width layers in f32, vocab 32768: a slot
   decode tick at mixed positions, a prefill chunk at pos 256, a ragged
   ``prompt_lens`` generate (the same greedy tokens) and a window-64 ring
   decode over a 200-token prompt on the card against the plain path on
   the CPU, logits within 1e-3 (phase 5's limit);
23. train full-width, full-depth Granite-3.0-1B-A400M (1.39 B parameters)
   through the launcher at B 4 x T 2048 (capacity 2560), 5 steps, with the
   counters set to 0 just before and read just after (360 gmm forward
   launches on ``tc_prefill``, 360 dx and 360 dw launches on ``tc_dx`` and
   ``tc_dw``, 120 flash forward and 120 backward calls; the loss falls),
   then time steps and profile one;
24. hold Granite's train step against the CPU: 2 full-width layers, f32,
   vocab 32768, B 2 x T 128 (phase 13's limits), and count the (token, k)
   routing ids that differ between card and CPU (where some do, the CPU
   step is run again with the card's ids replayed);
25. train RWKV6-7B at full width (d 4096, H 64, hd 64) on 8 of its 32 layers
   through the launcher's run function (the config cut in depth only: the
   whole model's AdamW state, ~120 GB, does not fit the card), B 4 x T
   2048, 5 steps (40 ``wkv6`` launches on ``chunked`` and 40 ``wkv6_bwd``
   calls; the loss falls), then time steps and profile one; and ``--arch
   rwkv6_7b --reduced`` through the launcher's command line;
26. hold RWKV's train step against the CPU at phase 24's cell;
27. sharded continuous serving on a pair sharing the card
   (``phase_sharded_serving``): (a) full-width, full-depth Llama-3.2-1B,
   bf16, through the serve launcher's run function (``run_continuous``) on
   2 gloo ranks: phase 22's engine (8 slots of 1064, chunks of 256) over 8
   of its requests with 16 new tokens, at ``tp=2``, ``tp=2`` with comm
   chunks 2 and ``cp=2``; the flash launches of each rank exactly (16 a
   tick and 16 a chunk on a TP rank; under CP 16 a tick on each rank and,
   summed over the pair, 16 (3 + 2 [pos > 0]) a chunk), each rank's tick ms,
   median first-token s, tok/s and peak GiB, and the greedy tokens that
   differ from phase 22's single-process run (counted, not asserted: bf16
   sums in another order); (b) 2 full-width layers, f32, vocab 32768: TP
   with comm chunks 1 and 2, CP and CP with window 64, with prompts whose
   last chunk the ring's grid pads, each against the single-process card
   engine: the tokens equal, the logprobs and the first tick's logits
   within 1e-3 (phase 5's limit);
28. tensor MP of the recurrent families on a model pair sharing the card
   (``phase_tensor_recurrent``): full-width BigLSTM through the launcher at
   ``mp=2``, gspmd and overlapped with 2 chunks (256 LSTM forward launches
   a step on ``tc``, of the gx entry when overlapped, and 256 backward),
   full-width GNMT (800 and 800) and RWKV6-7B at full width on 2 layers (4
   ``wkv6`` and 4 ``wkv6_bwd``) on 2 ranks, each rank's peak and step ms;
   then f32 steps of each on a dp 2 x mp 2 run against the single-process
   card step at phase 15 (d)'s limits;
29. the multi-replica router (``phase_router``): (a) full-width Llama-3.2-1B
   on two replicas of phase 22's engine in one process, sharing the card
   and the weights, on phase 22's 16 requests: unfaulted, then a kill, NaN
   logits and a stall past the watchdog at a tick picked from the
   unfaulted run, each with phase 22 (a)'s tokens and logprobs bit for bit,
   exact stats, states and fault log, and L flash launches a decode tick
   and a chunk of every engine, dead ones included; (b) the launcher's
   ``--replicas 2 --fault kill@5:0`` in a process of its own, beside (c)'s
   ranks (its checks are exact; its rate is taken on a shared card); (c)
   replicas 2 x tp 2 on 4 ranks sharing the card, 2 full-width layers in
   f32: a kill with the bits of an unfaulted tensor-MP engine on replica
   group 1, each rank's launches exact;
30. the fsdp plans on ranks sharing the card (``phase_fsdp``): (a) the
   planner's 2-card RWKV6-7B plan (DP, the parameters and AdamW state
   sharded over ``data``) through the launcher at full width on 2 of 32
   layers, B 4 x T 2048, 3 steps, then plain ``dp=2`` for 1 on the same
   spawn: exact ``wkv6`` / ``wkv6_bwd`` launches, each rank's resident
   state within 5 % of its shard's 12 B a parameter and below plain
   dp=2's, its peak beside the planner's model and the launcher's floor
   for the port's fsdp step (``fsdp_step_bytes``); (b) f32 fsdp steps against
   the single-process card step at phase 15 (d)'s limits, run on the
   spawns of phases 15 (d) (BigLSTM ``dp=2``), 19 (c) (Llama ``dp=2,cp=2``)
   and 20 (b) (Llama ``dp=2``, ``dp=2,mp=2`` both runtimes);
31. print one JSON line of kernels, then the device line.

Needs one card and exits non-zero, printing no result, without one.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import math
import os
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
# kv_lens rows: each (row, query, head) output vector's max error against
# that vector's max |ref| (bf16 rounding is 2**-8 of it; a lost or extra
# 64-key tile at the end of a 1000-key row moves it by about a quarter)
KV_VEC_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BATCH, PROMPT, NEW = 4, 512, 32
TRAIN_B, TRAIN_T, TRAIN_STEPS = 16, 64, 5
AUTO_STEPS = 2                                  # BigLSTM steps through --parallel auto
RANK_STEPS = 3                                  # steps of each phase-15 run
# phases 13, 24 and 26: each gradient leaf of the card's f32 step against the
# CPU's, |g_card - g_cpu| / |g_cpu|; a zeroed or mis-scaled leaf reads 1, a
# flipped one 2
STEP_GRAD_LEAF_TOL = 2e-4
# phase 15 (d)'s parameters after one step: under the 1.5e-4 that AdamW's
# first step at lr(0) moves an element, so a skipped or mis-scaled update shows
RANK_PARAMS_TOL = 5e-5
SMOL_B, SMOL_T = 8, 512                         # the hybrid SmolLM-360M run's batch
# phase 21: SmolLM-360M's kill-and-resume, 4 steps, a checkpoint every 2;
# JAX's elastic tolerance (tests/test_fault.py's dp 16 -> 8 or 32 resume)
CKPT_STEPS, CKPT_EVERY = 4, 2
ELASTIC_TOL = {"rtol": 2e-4, "atol": 1e-5}
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
# phase 28: the recurrent families on a tensor-MP pair sharing the card, 2
# steps each: BigLSTM at phase 6's B 16 x T 64, GNMT at phase 16's B 128 x S =
# T = 50, RWKV6-7B at phase 25's B 4 x T 2048 on 2 of its 32 layers (4 took
# 21.6 GiB a rank and 4.5 s a step, most of it host-staged messages, and put
# the whole script over 1100 s)
RNN_TP_M, RNN_TP_STEPS, RWKV_TP_LAYERS = 2, 2, 2
# the gx entry's rows: B, d_h, H of a rank's cell at 2-way MP, BigLSTM's
# (H 8192 / 2, the 1024 projection as its recurrent input) and GNMT's (H
# 1024 / 2, h whole)
LSTM_GX = [(TRAIN_B, 1024, 4096), (GNMT_B, 1024, 512)]
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
# the backward rows (no TPU kernel: JAX differentiates the expert einsums and
# the scan): the error over max(1, the largest reference value), in f32 at the
# forwards' tolerances (sums of up to 2560 terms in another order), in bf16
# with the outputs rounded to bf16 (2**-8 of the value)
GMM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
WKV_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# G, C, d, F of full-width Granite-3.0-1B-A400M's training products: B 4 x T
# 2048, capacity ceil(8192 * 8 / 32 * 1.25) = 2560
GRANITE_B, GRANITE_T = 4, 2048
GMM_TRAIN = [("train wg/wi", (32, 2560, 1024, 512)), ("train wo", (32, 2560, 512, 1024))]
# an expert-parallel rank's products at B 4 x T 2048 (phase 20 (a)): 16 of 32 experts
GMM_EP = [("train EP rank wg/wi", (16, 2560, 1024, 512)), ("train EP rank wo",
                                                         (16, 2560, 512, 1024))]
GMM_BWD_EDGE = [(8, 37, 130, 70), (1, 1, 1, 1), (3, 1, 64, 48), (2, 17, 1, 9),
                (2, 300, 136, 264)]
# RWKV6-7B's training cell: full width (d 4096, H 64, hd 64), 8 of its 32
# layers (2.4 B parameters: 38 GB of parameters and AdamW state; the whole
# model's 120 GB does not fit the card), B 4 x T 2048
RWKV_B, RWKV_T, RWKV_LAYERS = 4, 2048, 8
# phase 30 (a): the planner's RWKV6-7B plan, 2 steps after one, beside plain
# dp=2's first (2 layers, not 4: host-staged fsdp steps take 28 s a step at
# 4, and the script must stay under 1100 s)
FSDP_LAYERS, FSDP_B, FSDP_T, FSDP_STEPS, FSDP_PLAIN_STEPS = 2, 4, 2048, 3, 1
FSDP_RESIDENT_TOL = 0.05
# the WKV backward rows besides the training shape: T no multiple of the
# 64-token chunk, hd 32, strong decays (w down to 1e-38) over T 2048
WKV_BWD_EDGE = [((2, 300, 8, 64), torch.float32, "sweep"), ((2, 130, 4, 32), torch.float32, "sweep"),
                ((2, 130, 4, 32), torch.bfloat16, "sweep"), ((1, 2048, 2, 64), torch.float32, "strong"),
                ((1, 2048, 2, 64), torch.bfloat16, "strong")]
# the continuous engine's cell (phase 22): slots, capacity (the longest
# prompt, 1024, + 32 new + 8), prefill chunk, requests, prompt lengths, new
# tokens a request, and the requests also served alone
CONT_SLOTS, CONT_CAP, CONT_CHUNK = 8, 1064, 256
CONT_REQUESTS, CONT_PROMPTS, CONT_NEW, CONT_SOLO = 16, (64, 1024), 32, 4
# phase 27: the first SHARD_REQUESTS of phase 22's requests with SHARD_NEW
# new tokens, on a pair of ranks; its 2-layer f32 cells' prompts (last
# chunks of 9, 13, 2 and 5 tokens: the grids of 2 and 4 pad them), chunk,
# new tokens, slots and capacity
SHARD_REQUESTS, SHARD_NEW = 8, 16
SHARD_CELL_LENS, SHARD_CELL_CHUNK, SHARD_CELL_NEW = [201, 77, 130, 5], 64, 4
SHARD_CELL_SLOTS, SHARD_CELL_CAP = 4, 264
# phase 29: two replicas of phase 22's engine; the stall and the watchdog
# (seconds, far above a healthy step's 0.02-0.04); (c)'s 2-layer f32 cell
# on replica groups of a tensor-MP pair: prompts (replica 0 takes the first
# and third: one decodes, one waits to prefill when the kill fires before
# tick ROUTER_CELL_KILL), chunk, new tokens, slots a replica, capacity
ROUTER_REPLICAS, ROUTER_STALL_S, ROUTER_WATCHDOG_S = 2, 2.0, 1.0
ROUTER_CELL_LENS, ROUTER_CELL_CHUNK, ROUTER_CELL_NEW = [70, 33, 90, 20], 64, 8
ROUTER_CELL_SLOTS, ROUTER_CELL_CAP, ROUTER_CELL_KILL = 4, 128, 3
# kernels a decode step on commit f4893cd (the tree that first served all
# three models), counted by torch.profiler after a warm-up cycle: Llama 1262
# and RWKV 2957 in each of three profiles, Granite 3254 in two of three (the
# third saw 3197; PERF.md section 6).  A profile started cold may miss the
# step's first kernels (the embedding's gather, then the first weight
# cast): that tree's own cold profiles saw at most 2955 of RWKV's 2957.  A
# profile may see fewer, never more.
DECODE_KERNELS = {"llama3.2-1b": 1262, "granite-moe-1b-a400m": 3254, "rwkv6-7b": 2957}
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


def kv_lens_bound_ms(q, k, keep):
    """Least time on the card for attention with per-row key lengths: q read
    and o written once, and of K and V only the keys some query of the row
    keeps (``keep`` (B, Tq, Tk)), against 4*hd FLOPs a kept (query, key)
    pair and query head."""
    b, tq, h, hd = q.shape
    hkv = k.shape[2]
    keys = int(keep.any(1).sum())                     # keys read, summed over the rows
    nbytes = (2 * q.numel() + 2 * keys * hkv * hd) * q.element_size()
    flops = 4.0 * h * int(keep.sum()) * hd
    return bound_ms(nbytes, flops, q.dtype)


def vec_rel_err(out, ref):
    """The largest error of an output vector (one row, query and head) over
    that vector's max |ref|."""
    ref = ref.float()
    return float(((out.float() - ref).abs().amax(-1)
                  / ref.abs().amax(-1).clamp_min(1e-30)).max())


def check_kv_lens(fa, case, q, k, v, kv_lens, *, causal, window=0, timed=True, q_start=None):
    """The kernel with per-row key lengths against its plain version, each
    row naming the variant it launched: the max abs error within ``TOL`` and
    each output vector's within ``KV_VEC_TOL`` of its own size.  For a
    decode tick (Tq 1) the row also shows that the vector check would
    reject the loss of the last 64-key tile of every row of 128 keys or
    more (``tile_loss_min_rel``: the least, over those rows, of the plain
    version's move).  Timed against the plain version, the bound of the
    keys the rows keep and SDPA with the same boolean ``attn_mask`` (a
    yardstick the port never calls).  With ``q_start`` the queries sit
    there (rows that see no key: out 0)."""
    kw = dict(causal=causal, window=window, kv_lens=kv_lens, q_start=q_start)
    call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    out, variant = launched_variant(fa.flash_attention, call)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, **kw)
    err = float((out.float() - ref.float()).abs().max())
    tol, vec_tol = TOL[q.dtype], KV_VEC_TOL[q.dtype]
    vec_err = vec_rel_err(out, ref)
    row = {"shape": case, "dtype": str(q.dtype).removeprefix("torch."), "variant": variant,
           "kv_lens": kv_lens.tolist(), "max_abs_err": err, "tol": tol,
           "vec_rel_err": vec_err, "vec_tol": vec_tol}
    if q_start is not None:
        row["q_start"] = q_start.tolist() if isinstance(q_start, torch.Tensor) else q_start
    if q.shape[1] == 1 and q_start is None:
        long_rows = kv_lens >= 128
        lost = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      kv_lens=torch.where(long_rows, kv_lens - 64, kv_lens))
        row["tile_loss_min_rel"] = min(vec_rel_err(lost[b], ref[b])
                                       for b in long_rows.nonzero()[:, 0].tolist())
        if not row["tile_loss_min_rel"] > vec_tol:
            raise AssertionError(f"flash_attention {case}: the vector check would pass a "
                                 f"lost tile ({row['tile_loss_min_rel']} <= {vec_tol})")
    if variant != fa.flash_variant(q, k, v):
        raise AssertionError(f"flash_attention {case}: launched {variant}, "
                             f"flash_variant says {fa.flash_variant(q, k, v)}")
    if not err < tol or not vec_err < vec_tol or not torch.isfinite(out).all():
        raise AssertionError(f"flash_attention {case}: max abs err {err} (tol {tol}), "
                             f"vector rel err {vec_err} (tol {vec_tol})")
    if timed:
        from repro_torch.kernels.ref import keep_mask
        keep = keep_mask(q.shape[1], k.shape[1], causal, window, q.device, kv_lens, q_start)
        time_into(row, "ms", call)
        time_into(row, "plain_ms", lambda: fa.flash_attention_ref(q, k, v, **kw))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        time_into(row, "library_ms", lambda: sdpa(qt, kt, vt, attn_mask=keep[:, None],
                                                   enable_gqa=True))
        row["bound_ms"], row["bound_by"] = kv_lens_bound_ms(q, k, keep)
    print(json.dumps(row), flush=True)
    return row


def phase_kv_lens(fa):
    """Flash attention with per-row key lengths at the continuous engine's
    shapes (full-width Llama-3.2-1B, H 32/8, hd 64, capacity CONT_CAP), bf16
    and f32: the decode tick (B CONT_SLOTS, Tq 1; lengths that leave the
    split runs past a row's length empty, and long rows one key off a tile
    boundary) and a prefill chunk (B 1, Tq CONT_CHUNK at pos 0, 256, 768 and
    769), window 0 and 256; then one row's output bits against the other
    rows' lengths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    lens_gen = torch.Generator().manual_seed(25)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # 1 and 63-65 fill only the first of the split's runs; 1063 and 1064 the
    # last tile; two seeded lengths between
    tick_lens = [1, 63, 64, 65, 1063, 1064] + torch.randint(
        2, CONT_CAP, (CONT_SLOTS - 6,), generator=lens_gen).tolist()
    # long rows one key either side of a tile boundary
    off_by_one = [1023, 1025, 959, 961, 1, 129, 127, 640]
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        k, v = rnd(CONT_SLOTS, CONT_CAP, 8, 64, dtype=dt), rnd(CONT_SLOTS, CONT_CAP, 8, 64, dtype=dt)
        q = rnd(CONT_SLOTS, 1, 32, 64, dtype=dt)
        for lens_list in (tick_lens, off_by_one):
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            for window in (0, 256):
                rows.append(check_kv_lens(
                    fa, f"tick B{CONT_SLOTS} Tq1 cap{CONT_CAP} H32/8 hd64 window={window}",
                    q, k, v, lens, causal=True, window=window))
        qc = rnd(1, CONT_CHUNK, 32, 64, dtype=dt)
        for pos in (0, 256, 768, 769):
            lens = torch.tensor([pos + CONT_CHUNK], dtype=torch.int32, device=dev)
            for window in (0, 256):
                rows.append(check_kv_lens(
                    fa, f"chunk B1 Tq{CONT_CHUNK} pos{pos} cap{CONT_CAP} H32/8 hd64 causal "
                        f"window={window}", qc, k[:1], v[:1], lens, causal=True, window=window))
        # row 0's bits do not hang on the other rows' lengths (the split is
        # planned from the capacity)
        outs = [fa.flash_attention(q, k, v, causal=True, kv_lens=torch.tensor(
                    [700] + rest, dtype=torch.int32, device=dev))[0]
                for rest in ([1] * 7, [1064] * 7, tick_lens[1:])]
        same = all(torch.equal(o, outs[0]) for o in outs[1:])
        print(json.dumps({"check": "kv_lens row bits independent of other rows",
                          "dtype": str(dt).removeprefix("torch."), "same_bits": same}),
              flush=True)
        if not same:
            raise AssertionError(f"flash_attention kv_lens ({dt}): row 0's output changed "
                                 f"with the other rows' lengths")
    return rows


def phase_q_start(fa):
    """Flash attention with an explicit query start at the sharded serving
    steps' shapes (full-width Llama-3.2-1B, hd 64, bf16): the context-
    parallel chunk's cache partial at pos 0, 256 and 768, window 0 and 256
    (ring place 1's 128 rows of a CONT_CHUNK chunk, ``kv_lens = pos``,
    ``q_start = pos + 128``, not causal); a tensor-MP rank's tick (B
    CONT_SLOTS, Tq 1, H 16/4, phase 3's tick lengths); the windowed ring's
    past-block hop (B 2, T/m 1024, H 32/8, window 256, ``q_start`` 1024):
    the forward with lse against its plain output (``TOL``) and lse
    (``BWD_F32_TOL`` of max(1, |ref|), -inf exactly where a row sees no
    key), the backward given the global output and lse against the plain
    backward within 2e-2 of max(1, |ref|).  Each timed against its plain
    version, its bound and SDPA's call.  Then the bits: ``q_start = 0``
    (with a window, where its tile skip is on) against none.  Each row
    carries ``path`` for the launches phase 27 counts."""
    from repro_torch.kernels.ref import keep_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    fwd_rows, bwd_rows = [], []
    k, v = rnd(1, CONT_CAP, 8, 64), rnd(1, CONT_CAP, 8, 64)
    q = rnd(1, CONT_CHUNK // 2, 32, 64)
    for pos in (0, 256, 768):
        lens = torch.tensor([pos], dtype=torch.int32, device=dev)
        starts = torch.tensor([pos + CONT_CHUNK // 2], dtype=torch.int32, device=dev)
        for window in (0, 256):
            row = check_kv_lens(fa, f"CP chunk cache partial B1 Tq{CONT_CHUNK // 2} pos{pos} "
                                    f"cap{CONT_CAP} H32/8 hd64 window={window}", q, k, v, lens,
                                causal=False, window=window, q_start=starts)
            fwd_rows.append(dict(row, path="cp_partial" if pos else "cp_partial_pos0"))
    kt, vt = rnd(CONT_SLOTS, CONT_CAP, 4, 64), rnd(CONT_SLOTS, CONT_CAP, 4, 64)
    lens = torch.tensor([1, 63, 64, 65, 1063, 1064, 300, 700], dtype=torch.int32, device=dev)
    row = check_kv_lens(fa, f"tensor-MP rank tick B{CONT_SLOTS} Tq1 cap{CONT_CAP} H16/4 hd64",
                        rnd(CONT_SLOTS, 1, 16, 64), kt, vt, lens, causal=True)
    fwd_rows.append(dict(row, path="tp_tick"))
    del k, v, kt, vt

    # the windowed ring's past-block hop: rank 1's rows against block 0
    b, t, h, hkv, hd, w = RING_B, RING_T, 32, 8, 64, 256
    n = t // 2
    q, k, v, do = rnd(b, t, h, hd), rnd(b, t, hkv, hd), rnd(b, t, hkv, hd), rnd(b, t, h, hd)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True, window=w)
    qh, oh, doh = (x[:, n:].contiguous() for x in (q, out, do))
    lseh = lse[:, :, n:].contiguous()
    kh, vh = k[:, :n].contiguous(), v[:, :n].contiguous()
    kw = dict(causal=True, window=w, q_start=n)
    case = f"windowed ring past hop B{b} Tq{n} Tk{n} H{h}/{hkv} hd{hd} window={w} q_start={n}"
    (o_s, lse_s), variant = launched_variant(fa.flash_attention, lambda: fa.flash_attention_lse(
        qh, kh, vh, **kw))
    want_o = fa.flash_attention_ref(qh, kh, vh, **kw)
    want_lse = fa.flash_attention_lse_plain(qh, kh, **kw)
    dead = torch.isneginf(want_lse)
    err = float((o_s.float() - want_o.float()).abs().max())
    lse_err = float((lse_s - want_lse)[~dead].abs().max()) / max(
        1.0, float(want_lse[~dead].abs().max()))
    row = {"shape": case, "dtype": "bfloat16", "variant": variant, "max_abs_err": err,
           "tol": TOL[bf], "lse_rel_err": lse_err, "lse_tol": BWD_F32_TOL,
           "rows_without_keys": int(dead.sum()), "path": "ring_past_hop"}
    if variant != "tc_prefill" or not (err < TOL[bf] and lse_err < BWD_F32_TOL) or \
            not torch.equal(torch.isneginf(lse_s), dead):
        raise AssertionError(f"flash_attention_lse {case}: {row}")
    keep = keep_mask(n, n, True, w, dev, q_start=n)
    pairs = int(keep.sum())
    keys = int(keep.any(0).sum())
    time_into(row, "ms", lambda: fa.flash_attention_lse(qh, kh, vh, **kw))
    time_into(row, "plain_ms", lambda: (fa.flash_attention_ref(qh, kh, vh, **kw),
                                        fa.flash_attention_lse_plain(qh, kh, **kw)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (qh, kh, vh))
    time_into(row, "library_ms", lambda: sdpa(qt, kt, vt, attn_mask=keep, enable_gqa=True))
    row["bound_ms"], row["bound_by"] = bound_ms(
        _nbytes(qh, o_s, lse_s) + 2 * b * keys * hkv * hd * 2, 4.0 * b * h * pairs * hd, bf)
    print(json.dumps(row), flush=True)
    fwd_rows.append(row)
    grads, variant = launched_variant(fa.flash_attention_bwd, lambda: fa.flash_attention_bwd(
        qh, kh, vh, oh, doh, lseh, **kw))
    torch.cuda.synchronize()
    oracle = fa.flash_attention_bwd_plain(qh.float(), kh.float(), vh.float(), oh.float(),
                                          doh.float(), lseh, **kw)
    errs = [float((g.float() - x).abs().max()) for g, x in zip(grads, oracle)]
    scale = [max(1.0, float(x.abs().max())) for x in oracle]
    row = {"kernel": "flash_attention_bwd", "shape": case + ", global lse", "dtype": "bfloat16",
           "variant": variant, "max_abs_err": max(errs),
           "rel_err": {nm: e / sc for nm, e, sc in zip(("dq", "dk", "dv"), errs, scale)},
           "tol": TOL[bf], "path": "ring_past_hop"}
    if variant != "tc" or not all(e / sc < TOL[bf] for e, sc in zip(errs, scale)):
        raise AssertionError(f"flash_attention_bwd {case}, global lse: {row}")
    time_into(row, "ms", lambda: fa.flash_attention_bwd(qh, kh, vh, oh, doh, lseh, **kw))
    time_into(row, "plain_ms", lambda: fa.flash_attention_bwd_plain(
        qh, kh, vh, oh, doh, lseh, **kw), reps=5)
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in (qh, kh, vh))
    lib = sdpa(ql, kl, vl, attn_mask=keep, enable_gqa=True)
    time_into(row, "library_ms", lambda: torch.autograd.grad(
        lib, (ql, kl, vl), doh.transpose(1, 2), retain_graph=True))
    row["bound_ms"], row["bound_by"] = bound_ms(
        2 * _nbytes(qh, oh) + 2 * b * keys * hkv * hd * 2 * 2 + 4 * b * h * n,
        10.0 * b * h * pairs * hd, bf)
    print(json.dumps(row), flush=True)
    bwd_rows.append(row)
    del lib

    # q_start = 0 against none: the forward (with and without lse, a
    # window's tile skip on) and the backward
    qd, kd, vd = q[:, :n], k[:, :n], v[:, :n]
    same = {}
    for window in (0, w):
        a = fa.flash_attention(qd, kd, vd, causal=True, window=window)
        same[f"forward window={window}"] = torch.equal(
            a, fa.flash_attention(qd, kd, vd, causal=True, window=window, q_start=0))
        o1, l1 = fa.flash_attention_lse(qd, kd, vd, causal=True, window=window)
        o2, l2 = fa.flash_attention_lse(qd, kd, vd, causal=True, window=window, q_start=0)
        same[f"with lse window={window}"] = torch.equal(o1, o2) and torch.equal(l1, l2)
        g1 = fa.flash_attention_bwd(qd, kd, vd, o1, doh, l1, causal=True, window=window)
        g2 = fa.flash_attention_bwd(qd, kd, vd, o1, doh, l1, causal=True, window=window,
                                    q_start=0)
        same[f"backward window={window}"] = all(map(torch.equal, g1, g2))
    print(json.dumps({"check": "q_start=0 the same bits as none", **same}), flush=True)
    if not all(same.values()):
        raise AssertionError(f"flash attention with q_start=0 changed its bits: {same}")
    return fwd_rows, bwd_rows


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


def check_lstm_gx(lc, args, case, variant, timed=False):
    """The forward kernel's gx entry (writing its gates, as in training),
    ``variant`` forced, against its plain twin; the same bits on a repeat
    launch.  Timed against the plain twin, the bound (gx, h, c, Wh, b read
    once, h', c' and the gates written once, 2 B d_h 4H FLOPs) and PyTorch's
    own step from the same pre-activation: one ``torch.mm`` for h @ Wh and
    ``_thnn_fused_lstm_cell(gx, hgates, c, b)`` (torch.lstm_cell's CUDA
    path, the forget bias +1 folded into b)."""
    gx, h, c, wh, b = args
    dt, (bsz, hh) = h.dtype, c.shape

    def run():
        outs = [torch.empty((bsz, hh), dtype=dt, device=h.device) for _ in range(2)]
        gates = torch.empty((bsz, 4, hh), device=h.device)
        return lc._launch_fwd_gx(gx, h, c, wh, b, *outs, gates, variant)

    (hn, cn, gates), launched = launched_variant(lc.lstm_cell_fwd_gx, run)
    hn2, cn2, gates2 = run()
    torch.cuda.synchronize()
    if launched != variant:
        raise AssertionError(f"lstm_cell_fwd_gx {case}: launched {launched}")
    rh, rc, ract = lc.lstm_cell_gx_plain(gx, h, c, wh, b, with_gates=True)
    row = _lstm_row("lstm_cell_fwd_gx", case, dt, (hn, cn), (rh, rc), TOL[dt])
    row["variant"] = launched
    row["gates_max_abs_err"] = float((gates - ract).abs().max())
    if not row["gates_max_abs_err"] < 1e-4:
        raise AssertionError(f"lstm_cell_fwd_gx {case}: gates off by "
                             f"{row['gates_max_abs_err']}")
    if not (torch.equal(hn, hn2) and torch.equal(cn, cn2) and torch.equal(gates, gates2)):
        raise AssertionError(f"lstm_cell_fwd_gx {case}: a repeat launch gave other bits")
    if timed:
        d_h = h.shape[1]
        time_into(row, "ms", run)
        time_into(row, "plain_ms", lambda: lc.lstm_cell_gx_plain(gx, h, c, wh, b,
                                                                 with_gates=True))
        wh2 = wh.reshape(d_h, 4 * hh)
        gx2 = gx.reshape(bsz, 4 * hh)
        b_fold = b.clone()
        b_fold[1] += 1.0
        b_fold = b_fold.reshape(-1).to(dt)
        zero_b = torch.zeros_like(b_fold)

        def library():
            return torch.ops.aten._thnn_fused_lstm_cell(gx2, torch.mm(h, wh2), c, b_fold,
                                                        zero_b)[:2]

        row["library"] = "torch.mm + aten._thnn_fused_lstm_cell (torch.lstm_cell's CUDA path)"
        row["library_max_abs_err"] = _max_err(library(), (rh, rc))
        time_into(row, "library_ms", library)
        row["bound_ms"], row["bound_by"] = bound_ms(
            _nbytes(gx, h, c, wh, b, hn, cn, gates), 2.0 * bsz * d_h * 4 * hh, dt)
    print(json.dumps(row), flush=True)
    return row


def phase_lstm_gx(lc):
    """Phase 3's rows of the gx entry: a tensor-MP rank's cells (BigLSTM's,
    gx a row of the (B, T, 4, H) ring output as the overlapped layer reads
    it, and GNMT's), bf16 on ``tc`` and ``fma``, f32 on ``fma``, then edge
    shapes."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = torch.device("cuda")

    def inputs(b, d_h, hh, dt, seq=0):
        def rnd(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        gx = rnd(b, seq, 4, hh).to(dt)[:, seq // 2] if seq else rnd(b, 4, hh).to(dt)
        return [gx, rnd(b, d_h).to(dt), rnd(b, hh, scale=0.5).to(dt),
                rnd(d_h, 4, hh, scale=d_h ** -0.5).to(dt), rnd(4, hh, scale=0.1)]

    rows = []
    for (b, d_h, hh), seq in zip(LSTM_GX, (TRAIN_T, 0)):
        case = f"B{b} dh{d_h} H{hh}" + (f", gx row of (B, {seq}, 4, H)" if seq else "")
        args = inputs(b, d_h, hh, torch.bfloat16, seq)
        if lc.lstm_gx_variant(args[1], args[3]) != "tc":
            raise AssertionError(f"lstm_cell_fwd_gx {case}: the wrapper would not take tc")
        rows.append(check_lstm_gx(lc, args, case, "tc", timed=True))
        rows.append(check_lstm_gx(lc, args, case, "fma", timed=True))
        rows.append(check_lstm_gx(lc, inputs(b, d_h, hh, torch.float32, seq), case, "fma",
                                  timed=True))
    for b, d_h, hh in [(1, 16, 72), (5, 40, 8), (17, 24, 136), (3, 12, 33)]:
        for dt in (torch.float32, torch.bfloat16):
            args = inputs(b, d_h, hh, dt)
            case = f"B{b} dh{d_h} H{hh}"
            for variant in ("tc", "fma"):
                if variant == "fma" or lc.lstm_gx_variant(args[1], args[3]) == "tc":
                    rows.append(check_lstm_gx(lc, args, case, variant))
    return rows


def gmm_inputs(gen, g, c, d, f, dtype):
    x = torch.randn((g, c, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((g, d, f), generator=gen, device="cuda") * d ** -0.5).to(dtype)
    return x, w


def _misaligned(x):
    """A copy of x whose base is one element past a 16-byte boundary."""
    xm = torch.empty(1 + x.numel(), dtype=x.dtype, device=x.device)[1:].view(x.shape)
    return xm.copy_(x)


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
        sets = [(x, w)]
        for _ in range(n_sets - 1):          # x as misaligned as the first: one variant
            xs, ws = gmm_inputs(gen, g, c, d, f, x.dtype)
            sets.append((_misaligned(xs) if x.data_ptr() % 16 else xs, ws))

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
    print("gmm forward tile (tc_prefill): the persistent wgmma tile fed by TMA "
          "(gmm_ws_kernel), as the backward's tc products", flush=True)
    # bf16 timed first: the main path's dtype; serving, then Granite's training
    # products, whole and on an expert-parallel rank
    for case, (g, c, d, f) in GMM_SERVE + GMM_TRAIN + GMM_EP:
        rows.append(check_gmm(gm, ref_mod, case, *gmm_inputs(gen, g, c, d, f, torch.bfloat16),
                              gen, timed=True))
    for case, (g, c, d, f) in GMM_SERVE:   # the FMA kernel: f32 (phase 9's path)
        rows.append(check_gmm(gm, ref_mod, case, *gmm_inputs(gen, g, c, d, f, torch.float32),
                              gen, timed=True))
    # bf16 with x's base 2 bytes off: the FMA kernel at the prefill shape
    x, w = gmm_inputs(gen, *GMM_SERVE[0][1], torch.bfloat16)
    rows.append(check_gmm(gm, ref_mod, f"{GMM_SERVE[0][0]}, x misaligned", _misaligned(x), w,
                          gen, timed=True))
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


def check_gmm_bwd(gm, ref_mod, case, x, w, dy, timed=False, variant=None):
    """dx and dw against the plain twin: one launch a product on the variant
    ``gmm_bwd_variant`` picks (or ``variant`` forced), the same bits on a
    repeat launch; timed product by product against its plain half, its
    bound and ``torch.bmm`` on the same tensors (transposed views)."""
    def run():
        return gm.gmm_bwd(x, w, dy) if variant is None else gm._launch_bwd(x, w, dy, variant)

    before = dict(gm.gmm_bwd.variant_launches)
    grads = run()
    torch.cuda.synchronize()
    picked = variant or gm.gmm_bwd_variant(x, w, dy)
    moved = {n: c - before[n] for n, c in gm.gmm_bwd.variant_launches.items() if c != before[n]}
    if moved != {f"{picked}_dx": 1, f"{picked}_dw": 1}:
        raise AssertionError(f"gmm_bwd {case}: moved {moved}, want one {picked} launch a product")
    same_bits = all(torch.equal(a, b) for a, b in zip(run(), grads))
    g, c, d = x.shape
    f = w.shape[2]
    plain = ref_mod.gmm_bwd_plain(x, w, dy)
    rows = []
    for name, got, want, library, operands in (
            ("dx", grads[0], plain[0], lambda: torch.bmm(dy, w.transpose(1, 2)), (dy, w)),
            ("dw", grads[1], plain[1], lambda: torch.bmm(x.transpose(1, 2), dy), (x, dy))):
        err = float((got.float() - want.float()).abs().max())
        rel = err / max(1.0, float(want.float().abs().max()))
        tol = GMM_BWD_TOL[x.dtype]
        row = {"kernel": "gmm_bwd", "product": name,
               "shape": f"{case} x {tuple(x.shape)} w {tuple(w.shape)}",
               "dtype": str(x.dtype).removeprefix("torch."), "variant": f"{picked}_{name}",
               "max_abs_err": err, "rel_err": rel, "tol": tol, "same_bits_on_repeat": same_bits}
        if not rel < tol or not torch.isfinite(got).all() or not same_bits:
            raise AssertionError(f"gmm_bwd {case} {name}: error {rel} over max(1, |ref|) >= "
                                 f"{tol}, not finite, or other bits on a repeat launch")
        if timed:
            need = {"need_dx": name == "dx", "need_dw": name == "dw"}
            time_into(row, "ms", lambda: gm._launch_bwd(x, w, dy, picked, **need))
            time_into(row, "plain_ms", lambda: ref_mod.gmm_bwd_plain(x, w, dy, **need))
            time_into(row, "library_ms", library)
            row["library"] = "torch.bmm"
            row["bound_ms"], row["bound_by"] = bound_ms(_nbytes(*operands, got),
                                                        2.0 * g * c * d * f, x.dtype)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def phase_gmm_bwd(gm, ref_mod):
    """The gmm backward at Granite's training products (bf16 on the wgmma
    tile, then the FMA kernel forced on the same inputs) and at an
    expert-parallel rank's (the wgmma tile), in f32 and with a misaligned
    bf16 x (the FMA kernel), and at edge shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def inputs(g, c, d, f, dtype):
        x, w = gmm_inputs(gen, g, c, d, f, dtype)
        return x, w, torch.randn((g, c, f), generator=gen, device="cuda").to(dtype)

    rows = []
    for case, shape in GMM_TRAIN:   # bf16 timed first: the main path's dtype
        x, w, dy = inputs(*shape, bf)
        rows += check_gmm_bwd(gm, ref_mod, case, x, w, dy, timed=True)
        rows += check_gmm_bwd(gm, ref_mod, case, x, w, dy, timed=True, variant="fma")
    for case, shape in GMM_EP:      # an expert-parallel rank's products (phase 20 (a))
        rows += check_gmm_bwd(gm, ref_mod, case, *inputs(*shape, bf), timed=True)
    case, shape = GMM_TRAIN[0]
    rows += check_gmm_bwd(gm, ref_mod, case, *inputs(*shape, f32), timed=True)
    x, w, dy = inputs(*shape, bf)
    rows += check_gmm_bwd(gm, ref_mod, f"{case}, x misaligned", _misaligned(x), w, dy)
    for shape in GMM_BWD_EDGE:
        for dt in (f32, bf):
            rows += check_gmm_bwd(gm, ref_mod, "edge", *inputs(*shape, dt))
    return rows


def check_wkv_bwd(wk, ref_mod, case, inputs, do, timed=False):
    """dr, dk, dv, dw, du against the plain twin (one count a call), the same
    bits on a repeat launch; timed against the plain twin (one call, CUDA
    events: it launches some hundred thousand small kernels) and the bound
    (no library call computes it)."""
    before = wk.wkv6_bwd.launches
    got = wk.wkv6_bwd(*inputs, do)
    torch.cuda.synchronize()
    if wk.wkv6_bwd.launches != before + 1:
        raise AssertionError(f"wkv6_bwd {case}: {wk.wkv6_bwd.launches - before} launches")
    same_bits = all(torch.equal(a, b) for a, b in zip(wk.wkv6_bwd(*inputs, do), got))
    want = ref_mod.wkv6_bwd_plain(*inputs, do)
    names = ("dr", "dk", "dv", "dw", "du")
    errs = {n: float((g.float() - x.float()).abs().max()) for n, g, x in zip(names, got, want)}
    rels = {n: errs[n] / max(1.0, float(x.float().abs().max())) for n, x in zip(names, want)}
    r = inputs[0]
    b, t, h, hd = r.shape
    tol = WKV_BWD_TOL[r.dtype]
    row = {"kernel": "wkv6_bwd", "shape": f"{case} B{b} T{t} H{h} hd{hd}",
           "dtype": str(r.dtype).removeprefix("torch."), "max_abs_err": max(errs.values()),
           "rel_err": rels, "tol": tol, "same_bits_on_repeat": same_bits,
           "workspace_bytes": wk.bwd_workspace_bytes(b, t, h, hd)}
    if not max(rels.values()) < tol or not same_bits or \
            not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"wkv6_bwd {case}: errors {rels} over max(1, |ref|) >= {tol}, "
                             f"not finite, or other bits on a repeat launch")
    if timed:
        time_into(row, "ms", lambda: wk.wkv6_bwd(*inputs, do), reps=10)
        row["plain_ms"] = time_ms(lambda: ref_mod.wkv6_bwd_plain(*inputs, do), reps=1, warmup=0)
        row["plain_timed_by"] = "cuda events, one call"
        row["library_ms"] = None
        row["library"] = "none: no single PyTorch call computes the WKV backward"
        # r, k, v, w, u, dO read once, dr, dk, dv, dw, du written once; per
        # (token, head, row, column) one FMA each for S, G, dr, dk, dv and dw
        row["bound_ms"], row["bound_by"] = bound_ms(_nbytes(*inputs, do, *got),
                                                    12.0 * b * t * h * hd * hd, torch.float32)
    print(json.dumps(row), flush=True)
    return row


def phase_wkv_bwd(wk, ref_mod):
    """The WKV backward at RWKV6-7B's training shape (bf16, timed), with T
    no multiple of the chunk, hd 32 and strong decays."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def dout(shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.5

    inputs = wkv_inputs(gen, RWKV_B, RWKV_T, 64, 64, torch.bfloat16, False)[:5]
    rows = [check_wkv_bwd(wk, ref_mod, "train", inputs, dout(inputs[0].shape), timed=True)]
    for shape, dt, decay in WKV_BWD_EDGE:
        inputs = wkv_inputs(gen, *shape, dt, False, decay=decay)[:5]
        rows.append(check_wkv_bwd(wk, ref_mod, f"{decay} decays", inputs, dout(shape)))
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
    want = {**dict.fromkeys(counters, 0), "flash_attention": 0 if cfg.rwkv else calls,
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
    print(json.dumps({"decode_step_kernels_by_name": dict(sorted(decode["count_by_name"].items()))}),
          flush=True)
    # the split decode tile merges its partials in the same launch: no more
    # kernels a decode step than PR 14's profile saw (the profiler may drop
    # events, never add them)
    if decode["kernels"] > DECODE_KERNELS[cfg.name]:
        raise AssertionError(f"{decode['kernels']} kernels a decode step, commit f4893cd "
                             f"ran {DECODE_KERNELS[cfg.name]}")
    del params, engine
    torch.cuda.empty_cache()
    return launches, variants


def profile_call(name, fn, reps=3):
    """Where one call spends its time: wall time on the host clock (ending in
    a synchronize) unprofiled over ``reps`` calls and profiled over one,
    device busy time as the sum of the CUDA kernels the profiler saw, the
    idle share against the unprofiled wall time, the top kernels, and the
    ms of each kernel of csrc/*.cu (summed over its template instances).
    The recorded call follows a warm-up cycle of the profiler (one call
    whose events are dropped): a profile started cold may miss the call's
    first kernels.  Where three profiled calls saw no device event, busy
    time and idle share are None: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    for _ in range(3):   # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        # the cycle's step marker is a device event too: not a kernel
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("ProfilerStep")]
        if kern:
            break
    by_name, count = {}, {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        count[e.name] = count.get(e.name, 0) + 1
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
    out["count_by_name"] = count
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


def train_lm_phase(lc, counters, api_mod, cfg, run, *, batch, seq, want, want_variants):
    """``run()`` trains ``cfg`` for TRAIN_STEPS steps at ``batch`` x ``seq``
    on the card through the launcher and returns its summary.  The counters
    are set to 0 just before and read just after: each kernel's launches are
    ``want``'s (0 if it is not named) and each named variant's
    ``want_variants``'s (every other variant 0); the loss falls and the
    parameters stay finite.  Then step time and a profile of one step,
    continuing from the trained state."""
    from repro_torch.tree import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    reset_counters(every)
    t0 = time.perf_counter()
    summary = run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in every.items()}
    variants = variant_launches(every)
    want_launches = {**dict.fromkeys(every, 0), **want}
    want_all = {name: dict.fromkeys(v, 0) for name, v in variants.items()}
    for name, counts in want_variants.items():
        want_all[name].update(counts)
    if launches != want_launches or variants != want_all:
        raise AssertionError(f"training {cfg.name} launched {launches} {variants}, want "
                             f"{want_launches} {want_all}")
    state = summary["state"]
    losses = summary["history"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0] or state.step != TRAIN_STEPS or \
            not all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)):
        raise AssertionError(f"training gave losses {losses} or non-finite parameters")
    out = {"arch": cfg.name, "params": sum(p.numel() for p in tree_leaves(state.params)),
           "layers": cfg.n_layers, "batch": batch, "seq": seq, "steps": TRAIN_STEPS,
           "losses": losses, "launcher_wall_s": wall_s, "launches": launches,
           "variant_launches": {n: variants[n] for n in want_variants},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(out), flush=True)
    timing = time_train_steps(api_mod, cfg, state, batch, seq, f"train_step {cfg.name}")
    del summary, state
    torch.cuda.empty_cache()
    return launches, variants, timing


def phase_train_llama(train_launch, lc, counters, api_mod, cfg):
    """Full-width, full-depth Llama-3.2-1B through the launcher at B 4, T
    2048: one forward launch (``tc_prefill``, with lse) and one backward call
    (``tc``) a layer a step, and a falling loss; then step time and a
    profile of one step."""
    per = TRAIN_STEPS * cfg.n_layers
    return train_lm_phase(
        lc, counters, api_mod, cfg,
        lambda: train_launch.main(["--arch", "llama3_2_1b", "--steps", str(TRAIN_STEPS),
                                   "--batch", str(LLAMA_B), "--seq", str(LLAMA_T)]),
        batch=LLAMA_B, seq=LLAMA_T, want={"flash_attention": per, "flash_attention_bwd": per},
        want_variants={"flash_attention": {"tc_prefill": per},
                       "flash_attention_bwd": {"tc": per}})


def phase_train_granite(train_launch, gm, lc, counters, api_mod, cfg):
    """Full-width, full-depth Granite-3.0-1B-A400M through the launcher at B
    4, T 2048 (capacity 2560): a layer a step, three expert products on the
    gmm forward (``tc_prefill``), their dx and dw on the same persistent
    wgmma tile (``tc_dx``, ``tc_dw``), one flash forward (``tc_prefill``) and one
    backward call (``tc``); a falling loss; then step time and a profile."""
    per = TRAIN_STEPS * cfg.n_layers
    copies = gm.gmm_bwd.dy_copies
    out = train_lm_phase(
        lc, counters, api_mod, cfg,
        lambda: train_launch.main(["--arch", "granite_moe_1b_a400m", "--steps",
                                   str(TRAIN_STEPS), "--batch", str(GRANITE_B),
                                   "--seq", str(GRANITE_T)]),
        batch=GRANITE_B, seq=GRANITE_T,
        want={"flash_attention": per, "flash_attention_bwd": per, "gmm": 3 * per,
              "gmm_bwd": 6 * per},
        want_variants={"flash_attention": {"tc_prefill": per},
                       "flash_attention_bwd": {"tc": per}, "gmm": {"tc_prefill": 3 * per},
                       "gmm_bwd": {"tc_dx": 3 * per, "tc_dw": 3 * per}})
    print(json.dumps({"gmm_bwd_dy_copies": gm.gmm_bwd.dy_copies - copies}), flush=True)
    return out


def phase_train_rwkv(train_launch, wk, lc, counters, api_mod, cfg):
    """RWKV6-7B at full width on RWKV_LAYERS of its layers (the config cut in
    depth only) through the launcher's run function at B 4, T 2048: a layer
    a step, one ``wkv6`` forward (``chunked``) and one backward call; a
    falling loss; then step time and a profile.  Then ``--arch rwkv6_7b
    --reduced`` through the launcher's command line, its counters from 0:
    one forward and one backward call a layer a step."""
    cfg8 = dataclasses.replace(cfg, n_layers=RWKV_LAYERS)
    per = TRAIN_STEPS * RWKV_LAYERS
    copies = wk.wkv6_bwd.dout_copies
    # the launcher's default plan (--parallel dp=1,mp=1) and learning rate
    plan = dataclasses.replace(train_launch.parse_parallel("dp=1,mp=1", 1, cfg8)[0],
                               dp_axes=("data",))
    run = train_launch.RankRun(cfg=cfg8, plan=plan, steps=TRAIN_STEPS, batch=RWKV_B,
                               seq=RWKV_T, lr=3e-3, device="cuda")
    out = train_lm_phase(lc, counters, api_mod, cfg8, lambda: train_launch._train(None, run),
                         batch=RWKV_B, seq=RWKV_T, want={"wkv6": per, "wkv6_bwd": per},
                         want_variants={"wkv6": {"chunked": per}})
    print(json.dumps({"wkv6_bwd_dout_copies": wk.wkv6_bwd.dout_copies - copies}), flush=True)
    reduced = cfg.reduced()
    reset_counters(counters)
    summary = train_launch.main(["--arch", "rwkv6_7b", "--reduced", "--steps", "3",
                                 "--batch", "4", "--seq", "64"])
    want = 3 * reduced.n_layers
    got = {n: counters[n].launches for n in ("wkv6", "wkv6_bwd")}
    if got != {"wkv6": want, "wkv6_bwd": want} or not all(np.isfinite(summary["history"])):
        raise AssertionError(f"rwkv6_7b --reduced launched {got}, want {want} of each; "
                             f"losses {summary['history']}")
    print(json.dumps({"rwkv6_7b --reduced": {"launches": got, "losses": summary["history"]}}),
          flush=True)
    return out


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


@contextlib.contextmanager
def replayed_routes(moe_mod, routes):
    """``moe._route`` with the (t, k) expert ids of ``routes`` (one a call, in
    order) in place of its own top-k; the router's probabilities, the
    weights of those ids and the aux loss computed as ``moe._route`` does."""
    route, queue = moe_mod._route, iter(routes)

    def replaying(router_w, xf, n_experts, k):
        probs = torch.softmax(xf.float() @ router_w, dim=-1)
        ids = next(queue).to(xf.device)
        w = probs.gather(1, ids)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        f = torch.zeros((n_experts,), dtype=torch.float32, device=xf.device)
        f.index_add_(0, ids.reshape(-1), torch.ones(ids.numel(), device=xf.device))
        f = f / f.sum().clamp(min=1.0)
        return ids, w.to(xf.dtype), n_experts * (f * probs.mean(0)).sum()

    moe_mod._route = replaying
    try:
        yield
    finally:
        moe_mod._route = route


def phase_step_vs_plain(api_mod, moe_mod, cfg, counters, want_calls):
    """One train step at full width, 2 layers, f32, vocab cut to 32768, B 2
    x T 128 (phases 13, 24 and 26): the card's kernels (their f32 variants)
    against the plain versions on the CPU from the same weights and batch,
    at phase 7's limits (loss and gradient norm within 1e-4 relative, every
    parameter after the update within 1e-3) and, leaf by leaf, the clipped
    gradient the optimizer is given: |g_card - g_cpu| over |g_cpu| (L2 norms
    of the leaf) within ``STEP_GRAD_LEAF_TOL``.  AdamW's first step moves an
    element by about lr(0) = 1.5e-4 whatever its gradient's size, so the
    parameters alone cannot see a zeroed, mis-scaled or flipped gradient.
    ``want_calls``: each kernel's
    launches in the card step and, for a kernel with variants, the launches
    of each (every other kernel and variant 0).  For an MoE model also the (token, k) routing ids that
    differ between card and CPU (as phase 9 counts them); where some do, the
    CPU step is run again with the card's ids replayed, and that step is the
    one held to the limits."""
    from repro_torch.optim import Optimizer, adamw, warmup_cosine
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, n_layers=2, vocab_size=32768, dtype="float32")
    gpu, cpu = (api_mod.build_model(cfg2, device=d) for d in ("cuda", "cpu"))
    params = gpu.init(1)
    params_cpu = _tree_to(params, "cpu")
    batch = _lm_batch(128, 2)

    def step(api, p, b):
        opt = adamw(warmup_cosine(3e-3, 20, TRAIN_STEPS))
        grads = []

        def update(g, *args):               # keeps the clipped gradients it is given
            grads.extend(t.detach().cpu() for t in tree_leaves(g))
            return opt.update(g, *args)

        state, metrics = make_train_step(api, Optimizer(opt.init, update), clip_norm=1.0)(
            TrainState(params=p, opt_state=opt.init(p), step=0), b)
        return (float(metrics["loss"]), float(metrics["grad_norm"]),
                [t.cpu() for t in tree_leaves(state.params)], grads)

    before = {n: (fn.launches, dict(getattr(fn, "variant_launches", {})))
              for n, fn in counters.items()}
    with recorded_routes(moe_mod) as card_routes:
        gl, gn, gp, gg = step(gpu, params, {k: v.cuda() for k, v in batch.items()})
    calls = {n: fn.launches - before[n][0] for n, fn in counters.items()}
    on_variants = {n: {v: c - before[n][1][v] for v, c in fn.variant_launches.items()
                       if c != before[n][1][v]}
                   for n, fn in counters.items() if hasattr(fn, "variant_launches")}
    with recorded_routes(moe_mod) as cpu_routes:
        cl, cn, cp, cg = step(cpu, params_cpu, batch)
    out = {"arch": cfg.name, "kernel_calls": calls, "variant_calls": on_variants}
    if cfg.is_moe:
        n_diff, same = _route_mismatch(card_routes, cpu_routes, batch["tokens"].shape)
        out.update(routing_ids_differing=n_diff, tokens_routed_apart=int((~same).sum()))
        if n_diff:
            out["cpu_loss_own_routes"] = cl
            with replayed_routes(moe_mod, card_routes):
                cl, cn, cp, cg = step(cpu, params_cpu, batch)
            out["cpu_step"] = "the card's routing ids replayed"
    leaf_rel = [float((a - b).norm() / b.norm().clamp(min=1e-30)) for a, b in zip(gg, cg)]
    worst = max(range(len(leaf_rel)), key=leaf_rel.__getitem__)
    out.update(loss_rel=abs(gl - cl) / abs(cl), grad_norm_rel=abs(gn - cn) / abs(cn),
               params_max_abs=max(float((a - b).abs().max()) for a, b in zip(gp, cp)),
               grad_leaf_max_rel=leaf_rel[worst], grad_leaf_worst_shape=list(cg[worst].shape),
               grad_leaves=len(leaf_rel), loss=gl, grad_norm=gn,
               tol={"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": 1e-3,
                    "grad_leaf_max_rel": STEP_GRAD_LEAF_TOL})
    print(json.dumps({"train_step_vs_plain": out}), flush=True)
    want_counts = {n: 0 for n in counters}
    want_variants = {}
    for name, (count, variants) in want_calls.items():
        want_counts[name] = count
        if variants:
            want_variants[name] = variants
    got_variants = {n: v for n, v in on_variants.items() if v}
    if calls != want_counts or got_variants != want_variants or not (
            out["loss_rel"] <= 1e-4 and out["grad_norm_rel"] <= 1e-4
            and out["params_max_abs"] <= 1e-3
            and out["grad_leaf_max_rel"] <= STEP_GRAD_LEAF_TOL):
        raise AssertionError(f"{cfg.name} train step on the card disagrees with its plain path "
                             f"or launched {calls} {got_variants}, want {want_counts} "
                             f"{want_variants}: {out}")
    return out


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
    launcher on ranks that share the card ((a) and (b) planned by the
    launcher and run one after the other on one spawn), beside the
    planner's memory model and bubble fraction."""
    from repro_torch.configs import get_config
    from repro_torch.core import planner as planner_mod
    from repro_torch.parallel.pipeline import pipeline_bubble_fraction

    runs = {}
    pipes = (("a", "1f1b", 2), ("b", "gpipe", 4))
    torch.cuda.empty_cache()
    summaries, _ = _launcher_runs(train_launch, [
        ["--arch", "biglstm", "--parallel", f"pipe=2,micro=4,sched={sched}", "--batch",
         str(TRAIN_B), "--seq", str(TRAIN_T), "--steps", str(RANK_STEPS)]
        for _, sched, _ in pipes])
    for (tag, sched, mark), summary in zip(pipes, summaries):
        spec = f"pipe=2,micro=4,sched={sched}"
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
    ranks sharing the card, and phase 30 (b)'s DP step with the state
    sharded over ``data`` (fsdp), each against the single-process step on the
    card from the same seeded weights (the launcher's seed 0) and batch, in
    phase 7's cell and within its limits."""
    cfg2 = dataclasses.replace(cfg, vocab_size=32768, dtype="float32")
    return ranks_vs_single(train_launch, api_mod, cfg2, 8, TRAIN_T, [
        RankCell("pipe=2,micro=4,sched=1f1b", "pipe=2,micro=4,sched=1f1b"),
        RankCell("dp=2 overlapped", "dp=2,mp=1", "overlapped"),
        RankCell("dp=2 fsdp (phase 30 (b))", "dp=2,mp=1", fsdp=True)], "ranks_vs_single")


def _concurrently(*thunks):
    """Call each of ``thunks`` on a thread of its own (each starts processes
    and waits on them) and return their results in order; the first that
    raised raises here once all have ended."""
    with concurrent.futures.ThreadPoolExecutor(len(thunks)) as pool:
        futures = [pool.submit(fn) for fn in thunks]
        concurrent.futures.wait(futures)
    return [f.result() for f in futures]


def _train_runs_rank(mesh, runs, then=None, then_args=()):
    """Each of ``runs`` in turn through the launcher's rank body
    (``launch.train._train``) on this rank's mesh, then ``then(mesh,
    *then_args)`` if given; the launch counters set to 0 before each, and
    one run's memory freed before the next: one spawn for several runs on
    one mesh shape.  Returns {"runs": each run's rank result, "then": ...}."""
    import gc

    from repro_torch.launch import train as train_launch

    out = {"runs": [], "then": None}
    for run in runs:
        reset_counters(train_launch._counter_fns())
        out["runs"].append(train_launch._train(mesh, run))
        gc.collect()
        torch.cuda.empty_cache()
    if then is not None:
        reset_counters(train_launch._counter_fns())
        out["then"] = then(mesh, *then_args)
    return out


def _launcher_runs(train_launch, argvs, then=None, then_args=(), edit=None):
    """The launcher's runs of ``argvs``, planned as its ``main`` plans them
    (``plan_run``: the flags, the plan, the ``[plan]`` line), each passed
    through ``edit`` if given (a cut in depth) and then, as in ``main``,
    ``check_fsdp_fits``, on one spawn of the mesh
    they share, one after another, then ``then`` on that spawn
    (``_train_runs_rank``).  Returns (each run's summary as ``main`` returns
    it, ``then``'s result on each rank)."""
    from repro_torch.parallel import dist as D

    planned = [train_launch.plan_run(argv) for argv in argvs]
    shapes = {(dp, stages) for _, dp, stages in planned}
    if len(shapes) != 1:
        raise ValueError(f"runs on more than one mesh: {shapes}")
    (dp, stages), = shapes
    runs = [edit(run) if edit else run for run, _, _ in planned]
    for run in runs:
        train_launch.check_fsdp_fits(run, dp, stages)
    ranks = D.spawn_ranks(_train_runs_rank, dp * stages, "cuda", args=(runs, then, then_args),
                          stages=stages)
    return ([train_launch.rank_summary(run, [r["runs"][i] for r in ranks])
             for i, run in enumerate(runs)], [r["then"] for r in ranks])


# a cell of ``ranks_vs_single``: its name, its --parallel spec, the comm
# runtime (None: the spec's), the ring chunks, whether the plan shards the
# state over ``data`` (fsdp), its config (None: the call's), an MoE model's
# capacity factor and the optimizer
RankCell = collections.namedtuple("RankCell", "name spec comm chunks fsdp cfg capacity opt",
                                  defaults=(None, 1, False, None, 1.25, "adamw"))


def ranks_vs_single(train_launch, api_mod, cfg2, batch_size, seq, specs, key):
    """One step of each of ``specs`` (``RankCell`` records) through the
    launcher's rank body, sharing the card, against the single-process step
    on the card of the cell's config, capacity and optimizer from the same
    seeded weights (the launcher's seed 0) and batch: loss and grad norm
    within 1e-4 relative, every rank's parameters (a pipelined rank's
    stage, a tensor-MP rank's part, and under a true ``fsdp`` the plan
    sharding the state over ``data``: the rank's data shard of that) within
    ``RANK_PARAMS_TOL``, and on a tensor-MP group every leaf the rules
    replicate the same bits on each of its ranks; TF32 off.  The specs of
    one mesh shape share a spawn, and the spawns run at once (these cells
    check values, not times).  Prints ``{key: results}``."""
    from repro_torch.optim import OPTIMIZERS, warmup_cosine
    from repro_torch.parallel import dist as D
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = 3e-3
    singles = {}

    def single(cfg, capacity, opt_name):
        """The single-process step of a (config, capacity, optimizer)."""
        at = (cfg.name, cfg.n_layers, capacity, opt_name)
        if at not in singles:
            api = api_mod.build_model(cfg, device="cuda", capacity_factor=capacity)
            opt = OPTIMIZERS[opt_name](warmup_cosine(lr, 20, 1))
            state = init_train_state(api, opt, 0)
            batch = {k: v.cuda() for k, v in _lm_batch(seq, batch_size).items()}
            state, metrics = make_train_step(api, opt, clip_norm=1.0)(state, batch)
            singles[at] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                           _tree_to(state.params, "cpu"), api)
            del state, metrics, batch
            torch.cuda.empty_cache()
        return singles[at]

    cells, shapes = [], {}
    for name, spec, comm, chunks, fsdp, cfg, capacity, opt_name in specs:
        cfg = cfg or cfg2
        plan, mp, dp = train_launch.parse_parallel(spec, 1, cfg)
        plan = dataclasses.replace(plan, dp_axes=("data",),
                                   comm_runtime=comm or plan.comm_runtime,
                                   comm_chunks=chunks, fsdp_axes=("data",) if fsdp else ())
        tensor = plan.mp_kind == "tensor" and mp > 1
        stages = mp if plan.is_pipeline or plan.is_context or tensor else 1
        run = train_launch.RankRun(cfg=cfg, plan=plan, steps=1, batch=batch_size, seq=seq,
                                   lr=lr, return_params=True, capacity_factor=capacity,
                                   optimizer=opt_name)
        single(cfg, capacity, opt_name)
        shapes.setdefault((dp, stages), []).append(len(cells))
        cells.append((name, plan, mp, dp, stages, tensor, run))
    spawned = _concurrently(*(
        (lambda dp=dp, stages=stages, idx=idx: D.spawn_ranks(
            _train_runs_rank, dp * stages, "cuda",
            args=([cells[i][-1] for i in idx],), stages=stages))
        for (dp, stages), idx in shapes.items()))
    per_cell = {}
    for ((dp, stages), idx), ranks in zip(shapes.items(), spawned):
        for n, i in enumerate(idx):
            per_cell[i] = [r["runs"][n] for r in ranks]
    results = {}
    for i, (name, plan, mp, dp, stages, tensor, run) in enumerate(cells):
        ranks = per_cell[i]
        ref = single(run.cfg, run.capacity_factor, run.optimizer)
        api = ref[3]
        loss, gnorm = ranks[0]["history"][0], ranks[0]["grad_norms"][0]
        rules = (SH.ShardingRules(run.cfg, {"data": dp, "model": mp}, plan)
                 if tensor or plan.fsdp_axes else None)
        err = 0.0
        for r in ranks:
            if plan.is_pipeline:
                want = api.pipeline_stage_params(ref[2], stages, 1, r["rank"]["stage"])
            elif tensor:
                want = SH.shard_params(ref[2], rules, r["rank"]["stage"])
            else:
                want = ref[2]
            if plan.fsdp_axes:
                want = SH.shard_fsdp(want, rules, r["rank"]["data"],
                                     SH.param_specs(run.cfg, rules))
            err = max(err, _max_err(tree_leaves(r["params"]), tree_leaves(want)))
        results[name] = {"loss_rel": abs(loss - ref[0]) / abs(ref[0]),
                         "grad_norm_rel": abs(gnorm - ref[1]) / abs(ref[1]),
                         "params_max_abs": err, "loss": loss, "grad_norm": gnorm,
                         "arch": run.cfg.name, "optimizer": run.optimizer,
                         "capacity_factor": run.capacity_factor,
                         "transport": ranks[0]["transport"].describe(dp * stages)}
        if tensor:
            results[name]["replicated_same_bits"] = _replicated_same_bits(
                [r["params"] for r in ranks], [r["rank"]["data"] for r in ranks], run.cfg,
                rules)
    out = {key: results, "single": {f"{a} {n}L cf {c} {o}": {"loss": v[0], "grad_norm": v[1]}
                                    for (a, n, c, o), v in singles.items()},
           "tol": {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": RANK_PARAMS_TOL},
           "spawns": [{"mesh": list(shape), "cells": [cells[i][0] for i in idx]}
                      for shape, idx in shapes.items()]}
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
    ``cfg``'s f32 parameters (through host memory, as in (a)), once."""
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
    for _ in range(1):
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
    and one at ``dp=2,cp=2`` (4 ranks), with and without fsdp (phase 30
    (b)), against the single-process card step (phase 15 (d)'s limits)."""
    from repro_torch.core import planner as planner_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.parallel import dist as D

    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    torch.cuda.empty_cache()
    reset_counters(every)
    ring = 2
    # (a), then (b)'s ring and gradient sync on the same spawn
    (summary,), ranks = _launcher_runs(
        train_launch, [["--arch", "llama3_2_1b", "--parallel", "auto", "--devices", "8",
                        "--batch", str(RING_B), "--seq", str(RING_T), "--steps",
                        str(RING_STEPS)]], then=_ring_rank, then_args=(cfg,))
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
                            [RankCell("cp=2", "cp=2"), RankCell("dp=2,cp=2", "dp=2,cp=2"),
                             RankCell("dp=2,cp=2 fsdp (phase 30 (b))", "dp=2,cp=2", fsdp=True)],
                            "context_c")
    torch.cuda.empty_cache()
    return rec, ring_check, steps


def _tensor_inception_rank(mesh, plan, cfg, cfg64, cell_batch, d_model):
    """Phase 20 (c) on one rank of (a)'s spawn, after (a)'s runs and (a)'s
    messages alone (``_tp_comm_rank`` at Llama's ``d_model``; nothing else
    runs on the card meanwhile): 2 bf16 steps of full Inception-V3 at B
    64 x 299 on the planner's tensor plan (its part of the seeded init; step
    ms, peak, losses, its kernel launches), then one f64 step of ``cfg64``
    at ``cell_batch`` from seed 0 (TF32 off): loss, grad norm, its part on
    the CPU."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import api as api_mod
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step

    out = {"messages": _tp_comm_rank(mesh, d_model), "step_ms": [], "losses": []}
    torch.cuda.empty_cache()
    api = api_mod.build_model(cfg, device=mesh.device)
    opt = adamw(warmup_cosine(3e-3, 20, TP_STEPS))
    state = init_train_state(api, opt, 0, mesh=mesh, plan=plan)
    step = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0)
    batches = paper_batches(cfg, INCEPTION_B, TP_STEPS, 0)
    cuda = mesh.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
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
    card (on (a)'s spawn, after its runs): an all-reduce of a (B, T, d) bf16
    activation (the gspmd block's, after each row-parallel product and in
    each ``copy_to_model`` backward) and one ring hop of a chunk of rows (B, T / 2m, d), the
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


def phase_tensor(train_launch, lc, counters, api_mod, cfg, inc_cfg, moe_cfg):
    """Phase 20: tensor MP on ranks sharing the card.  (a) Full-width,
    full-depth Llama-3.2-1B through the launcher at ``mp=2`` overlapped (2
    chunks) and gspmd, B 4 x T 2048, 2 steps each, counters set to 0 just
    before and read just after: L m flash forward launches a step summed
    over the ranks (``tc_prefill``) and as many backward calls (``tc``),
    every rank's losses finite and the same, its peak and step ms, and the
    wall time of one all-reduce and one ring hop of those runs' messages
    alone (``_tp_comm_rank``); both runs, the messages and (c) on one spawn,
    one after another.  (b) 2 full-width f32 layers, vocab 32768, B
    4 x T 512, at ``mp=2`` gspmd, overlapped with 1 and 2 chunks and
    ``dp=2,mp=2`` overlapped, and phase 30 (b)'s fsdp cells (``dp=2``,
    ``dp=2,mp=2`` gspmd and overlapped c 2), against the single-process card
    step.  (c)
    Inception-V3's 256-card plan clamped to 2 ranks: 2 bf16 steps at B 64 x
    299, and an f64 step at phase 18 (b)'s cell against the single card
    step (phase 15 (d)'s limits, replicated leaves the same bits)."""
    from repro_torch.core.planner import HybridPlanner, default_epoch_model
    from repro_torch.parallel import sharding as SH

    every = {"lstm_cell_fwd": lc.lstm_cell_fwd,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, **counters}
    # (c)'s plan and single-process f64 step first: (c) runs on (a)'s spawn
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
    torch.cuda.empty_cache()

    # (a) both runtimes planned by the launcher and Granite's expert-parallel
    # plan, one after the other on one spawn, then on it (a)'s messages alone
    # and (c) (``_tensor_inception_rank``)
    runs = {}
    comms = (("overlapped", ["--comm-chunks", "2"]), ("gspmd", []))
    reset_counters(every)
    summaries, ranks = _launcher_runs(
        train_launch, [["--arch", "llama3_2_1b", "--parallel", f"mp={TP_M}", "--comm-runtime",
                        comm, *extra, "--batch", str(TP_B), "--seq", str(TP_T), "--steps",
                        str(TP_STEPS)] for comm, extra in comms] + [EP_ARGV],
        then=_tensor_inception_rank, then_args=(plan, inc_cfg, cfg64, cell_batch, cfg.d_model))
    ep = check_ep_run(summaries.pop(), moe_cfg)
    print(json.dumps({"tensor_a_granite_ep": ep}), flush=True)
    for (comm, extra), summary in zip(comms, summaries):
        name = f"(a) llama3_2_1b --parallel mp={TP_M} --comm-runtime {comm} {' '.join(extra)}"
        rec = check_rank_run(summary, name, cfg, steps=TP_STEPS, stages=TP_M, micro=1,
                             seq=TP_T, lstm=False, high_water=0, tensor=True)
        rec["per_step"] = {"flash_attention": rec["launches"]["flash_attention"] // TP_STEPS,
                           "flash_attention_bwd":
                               rec["launches"]["flash_attention_bwd"] // TP_STEPS}
        rec["batch"], rec["seq"] = TP_B, TP_T
        print(json.dumps({f"tensor_a_{comm}": rec}), flush=True)
        runs[comm] = rec
    del summaries
    print(json.dumps({"tensor_a_messages": [r["messages"] for r in ranks]}), flush=True)

    # (b) steps on ranks against one process, in f32
    cfg2 = dataclasses.replace(cfg, n_layers=2, vocab_size=32768, dtype="float32")
    granite2 = dataclasses.replace(moe_cfg, n_layers=2, vocab_size=32768, dtype="float32")
    steps = ranks_vs_single(train_launch, api_mod, cfg2, RING_CELL_B, RING_CELL_T, [
        RankCell("mp=2 gspmd", "mp=2", "gspmd"),
        RankCell("mp=2 overlapped c1", "mp=2", "overlapped", chunks=1),
        RankCell("mp=2 overlapped c2", "mp=2", "overlapped", chunks=2),
        RankCell("dp=2,mp=2 overlapped c2", "dp=2,mp=2", "overlapped", chunks=2),
        RankCell("dp=2 fsdp (phase 30 (b))", "dp=2,mp=1", fsdp=True),
        RankCell("dp=2,mp=2 gspmd fsdp (phase 30 (b))", "dp=2,mp=2", "gspmd", fsdp=True),
        RankCell("dp=2,mp=2 overlapped c2 fsdp (phase 30 (b))", "dp=2,mp=2", "overlapped",
                 chunks=2, fsdp=True),
        # (b) expert parallelism: Granite's experts over the model axis
        RankCell("granite mp=2 (EP)", "mp=2", cfg=granite2),
        RankCell("granite dp=2,mp=2 (EP) cf None", "dp=2,mp=2", cfg=granite2, capacity=None),
        RankCell("granite dp=2,mp=2 (EP) fsdp cf None", "dp=2,mp=2", fsdp=True, cfg=granite2,
                 capacity=None),
        # (c) Adafactor, its statistics over the whole of each cut leaf
        RankCell("adafactor mp=2", "mp=2", opt="adafactor"),
        RankCell("adafactor pipe=2", "pipe=2,micro=2,sched=1f1b", opt="adafactor"),
        RankCell("adafactor dp=2 fsdp", "dp=2,mp=1", fsdp=True, opt="adafactor")],
        "tensor_b")
    torch.cuda.empty_cache()

    # (c) Inception-V3's planned tensor plan, clamped to a model axis of 2,
    # against the single f64 step
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
    return runs, steps, rec, ep


EP_ARGV = ["--arch", "granite_moe_1b_a400m", "--parallel", "auto", "--devices", "8", "--batch",
           str(GRANITE_B), "--seq", str(GRANITE_T), "--steps", str(TP_STEPS)]


def check_ep_run(summary, cfg):
    """Phase 20 (a)'s Granite run (``EP_ARGV``): the planner's 8-card plan,
    tensor 4 x 2, clamped to 1 DP x a model axis of 2 on ranks sharing the
    card; each rank's own launches exact, a step: 3 L gmm forward (its 16
    of 32 experts, ``tc_prefill``), 3 L dx and 3 L dw (``tc_dx``,
    ``tc_dw``), L flash forward (``tc_prefill``) and L backward calls
    (``tc``); the losses finite and the same on both ranks.  Returns the
    run's record with each rank's peak and step ms."""
    t = summary["transport"]
    if (t.backend, t.placement, len(summary["ranks"])) != ("gloo", "shared", TP_M):
        raise AssertionError(f"granite EP: ran on {t} with {len(summary['ranks'])} ranks")
    per = TP_STEPS * cfg.n_layers
    want = {**dict.fromkeys(summary["launches"], 0), "flash_attention": per,
            "flash_attention_bwd": per, "gmm": 3 * per, "gmm_bwd": 6 * per}
    want_variants = {n: dict.fromkeys(v, 0) for n, v in summary["variants"].items()}
    want_variants["flash_attention"]["tc_prefill"] = TP_M * per
    want_variants["flash_attention_bwd"]["tc"] = TP_M * per
    want_variants["gmm"]["tc_prefill"] = TP_M * 3 * per
    want_variants["gmm_bwd"].update(tc_dx=TP_M * 3 * per, tc_dw=TP_M * 3 * per)
    losses = summary["history"]
    bad = [r["rank"] for r in summary["ranks"] if r["launches"] != want]
    if bad or summary["variants"] != want_variants:
        raise AssertionError(f"granite EP: ranks {bad} launched "
                             f"{[r['launches'] for r in summary['ranks']]} "
                             f"{summary['variants']}, want {want} a rank, {want_variants}")
    if len(losses) != TP_STEPS or not all(np.isfinite(losses)) or \
            any(r["losses"] != losses for r in summary["ranks"]):
        raise AssertionError(f"granite EP: losses {[r['losses'] for r in summary['ranks']]}")
    return {"run": " ".join(EP_ARGV), "transport": t.describe(TP_M), "losses": losses,
            "per_rank_per_step": {n: c // TP_STEPS for n, c in want.items() if c},
            "launches": summary["launches"], "variant_launches": summary["variants"],
            "ranks": [{"rank": r["rank"], "stage": r["stage"],
                       "peak_mem_gib": r["peak_mem_bytes"] / 2**30,
                       "resident_gib": r["resident_bytes"] / 2**30, "step_ms": r["step_ms"],
                       "losses": r["losses"], "launches": r["launches"]}
                      for r in summary["ranks"]]}


def _pair_view(mesh):
    """A rank of phase 28 (d)'s dp 2 x mp 2 run seen as a run of one
    replica: its model group, the real process group, computes the whole
    batch on its own."""
    from repro_torch.parallel import dist as D

    class PairMesh(D.RankMesh):
        @property
        def data_index(self) -> int:
            return 0

        def members(self, axis):
            s = self.shape["model"]
            if axis == "model":
                return [self.rank // s * s + j for j in range(s)]
            if axis == "data":
                return [self.rank]
            return super().members(axis)

    fields = {f.name: getattr(mesh, f.name) for f in dataclasses.fields(mesh)}
    return PairMesh(**dict(fields, shape={"data": 1, "model": mesh.shape["model"]}))


def _recurrent_rank(mesh, gnmt_cfg, gnmt_batches, rwkv_cfg, cells):
    """Phase 28 (b)–(d) on one rank of a dp 2 x mp 2 run sharing the card.
    First the model pair of ranks 0 and 1 alone (the others wait at a
    barrier, so nothing else runs on the card): 2 bf16 steps of full GNMT
    (B 128, S = T = 50) and of RWKV6-7B at full width on
    ``RWKV_TP_LAYERS`` layers (B 4 x T 2048, the launcher's data) through
    ``init_train_state`` + ``make_train_step`` on the gspmd tensor plan,
    each from a seeded init: the rank's step ms, peak memory, losses and
    kernel launches (counters set to 0 just before).  Then (d): one f32
    step (TF32 off) of each of ``cells`` from the seeded init (seed 0), a
    dp-1 cell on the first pair, a dp-2 cell on all four ranks: (loss,
    grad norm, this rank's parameters on the CPU) a cell it ran."""
    from repro_torch.kernels import lstm_cell as lc
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import api as api_mod
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.parallel import dist as D
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import init_train_state, make_train_step

    m = mesh.shape["model"]
    first_pair = mesh.rank < m
    out = {"runs": {}, "cells": {}}
    every = {"lstm_cell_fwd": lc.lstm_cell_fwd, "lstm_cell_fwd_gx": lc.lstm_cell_fwd_gx,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, "wkv6": wk.wkv6,
             "wkv6_bwd": wk.wkv6_bwd}
    rwkv_batches = [_lm_batch(RWKV_T, RWKV_B, epoch=e) for e in range(RNN_TP_STEPS)]
    runs = (("gnmt", gnmt_cfg, gnmt_batches), ("rwkv6_7b", rwkv_cfg, rwkv_batches))
    for name, cfg, batches in runs if first_pair else ():
        view = _pair_view(mesh)
        plan = ParallelPlan(model_axis="model")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        api = api_mod.build_model(cfg, device=mesh.device)
        opt = adamw(warmup_cosine(3e-3, 20, RNN_TP_STEPS))
        state = init_train_state(api, opt, 0, mesh=view, plan=plan)
        step = make_train_step(api, opt, mesh=view, plan=plan, clip_norm=1.0)
        reset_counters(every)
        rec = {"step_ms": [], "losses": []}
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(float(metrics["loss"]))
        rec["launches"] = {n: fn.launches for n, fn in every.items()}
        rec["variant_launches"] = variant_launches(every)
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["runs"][name] = rec
        del state, step, api
    torch.cuda.empty_cache()
    D.barrier(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (cfg, batch, dp, comm, chunks) in cells.items():
        if dp == 1 and not first_pair:
            continue
        view = mesh if dp == mesh.shape["data"] else _pair_view(mesh)
        plan = ParallelPlan(model_axis="model", comm_runtime=comm, comm_chunks=chunks)
        api = api_mod.build_model(cfg, device=mesh.device)
        opt = adamw(warmup_cosine(3e-3, 20, 1))
        state = init_train_state(api, opt, 0, mesh=view, plan=plan)
        state, metrics = make_train_step(api, opt, mesh=view, plan=plan, clip_norm=1.0)(
            state, batch)
        out["cells"][name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                              _tree_to(state.params, "cpu"))
        del state, api
        torch.cuda.empty_cache()
    return out


def phase_tensor_recurrent(train_launch, lc, wk, api_mod, lstm_cfg, gnmt_cfg, rwkv_cfg):
    """Phase 28: tensor MP of the recurrent families on a model pair sharing
    the card (gloo, messages through host memory: these step times are not
    multi-card step times), counters set to 0 just before each run and read
    just after.

    (a) Full-width, full-depth BigLSTM through the launcher at ``mp=2``,
    gspmd and overlapped with 2 chunks (planned by the launcher, one after
    the other on one spawn), B 16 x T 64, 2 steps each: L T m =
    256 LSTM forward launches a step summed over the ranks, all ``tc``, of
    ``lstm_cell_fwd`` (gspmd) or of its gx entry (overlapped: x @ Wx on the
    gather ring), and 256 pointwise backward launches; every rank's losses
    finite and the same.  (b) Full-width, full-depth GNMT, B 128 x S = T =
    50, 2 steps through ``make_train_step`` on a model pair: 2 L T m = 800
    forward launches a step (all ``tc``) and 800 backward.  (c) RWKV6-7B at
    full width on ``RWKV_TP_LAYERS`` layers, B 4 x T 2048, 2 steps: L m
    ``wkv6`` launches a step (``chunked``) and L m ``wkv6_bwd``.  (b) and (c)
    run on the first pair of (d)'s spawn while the second waits.  (d) f32
    steps (TF32 off) on a dp 2 x mp 2 run against the single-process card
    step from the same seeded weights and batch, phase 15 (d)'s limits (loss
    and grad norm within 1e-4 relative, each rank's part within 5e-5 after
    one AdamW step, replicated leaves the same bits on each model pair):
    BigLSTM at phase 15 (d)'s cell (2 full-width layers, vocab 32768, B 8 x
    T 64) at ``mp=2`` gspmd, overlapped with 1 and 2 chunks and
    ``dp=2,mp=2`` overlapped, GNMT at phase 18's 2 + 2 layer cell (B 16, S =
    T = 50) and RWKV at phase 24's 2-layer cell (vocab 32768, B 2 x T 128),
    both ``mp=2`` gspmd."""
    from repro_torch.parallel import dist as D
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.plan import ParallelPlan

    every = {"lstm_cell_fwd": lc.lstm_cell_fwd, "lstm_cell_fwd_gx": lc.lstm_cell_fwd_gx,
             "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise, "wkv6": wk.wkv6,
             "wkv6_bwd": wk.wkv6_bwd}
    m, steps = RNN_TP_M, RNN_TP_STEPS
    out = {"transport": "gloo, ranks sharing the card (host-staged messages)"}
    per_step = lstm_cfg.n_layers * TRAIN_T * m
    comms = (("gspmd", []), ("overlapped", ["--comm-chunks", "2"]))
    torch.cuda.empty_cache()
    reset_counters(every)
    summaries, _ = _launcher_runs(train_launch, [
        ["--arch", "biglstm", "--parallel", f"mp={m}", "--comm-runtime", comm, *extra,
         "--batch", str(TRAIN_B), "--seq", str(TRAIN_T), "--steps", str(steps)]
        for comm, extra in comms])
    for (comm, extra), summary in zip(comms, summaries):
        launches, variants = summary["launches"], summary["variants"]
        fwd = "lstm_cell_fwd_gx" if comm == "overlapped" else "lstm_cell_fwd"
        want = dict.fromkeys(launches, 0)
        want.update({fwd: steps * per_step, "lstm_cell_bwd_pointwise": steps * per_step})
        want_variants = {n: dict.fromkeys(v, 0) for n, v in variants.items()}
        want_variants[fwd]["tc"] = steps * per_step
        losses = summary["history"]
        t = summary["transport"]
        rec = {"run": f"biglstm --parallel mp={m} --comm-runtime {comm} {' '.join(extra)}",
               "batch": TRAIN_B, "seq": TRAIN_T, "losses": losses, "launches": launches,
               "per_step": {fwd: launches[fwd] // steps,
                            "lstm_cell_bwd_pointwise":
                                launches["lstm_cell_bwd_pointwise"] // steps},
               "variant_launches": variants, "transport": t.describe(len(summary["ranks"])),
               "ranks": [{"rank": r["rank"], "peak_mem_gib": r["peak_mem_bytes"] / 2**30,
                          "step_ms": r["step_ms"], "losses": r["losses"],
                          "launches": r["launches"]} for r in summary["ranks"]]}
        print(json.dumps({f"recurrent_tp_a_{comm}": rec}), flush=True)
        if launches != want or variants != want_variants:
            raise AssertionError(f"{rec['run']} launched {launches} {variants}, want {want} "
                                 f"{want_variants}")
        if (t.backend, t.placement) != ("gloo", "shared") or len(losses) != steps or \
                not all(np.isfinite(losses)) or \
                any(r["losses"] != losses for r in summary["ranks"]):
            raise AssertionError(f"{rec['run']}: {t}, losses "
                                 f"{[r['losses'] for r in summary['ranks']]}")
        out[f"a_biglstm_{comm}"] = rec
    del summaries

    # (d)'s single-process references, then (b)-(d) in one spawn of 4 ranks
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lstm2 = dataclasses.replace(lstm_cfg, vocab_size=32768, dtype="float32")
    gnmt2 = dataclasses.replace(gnmt_cfg, n_layers=2, encoder_layers=2, dtype="float32")
    rwkv2 = dataclasses.replace(rwkv_cfg, n_layers=2, vocab_size=32768, dtype="float32")
    lstm_batch, gnmt_batch = _lm_batch(TRAIN_T, 8), paper_batches(gnmt2, 16, 1, 7)[0]
    rwkv_batch = _lm_batch(128, 2)
    cells = {"biglstm mp=2 gspmd": (lstm2, lstm_batch, 1, "gspmd", 1),
             "biglstm mp=2 overlapped c1": (lstm2, lstm_batch, 1, "overlapped", 1),
             "biglstm mp=2 overlapped c2": (lstm2, lstm_batch, 1, "overlapped", 2),
             "gnmt 2+2 mp=2 gspmd": (gnmt2, gnmt_batch, 1, "gspmd", 1),
             "rwkv 2 layers mp=2 gspmd": (rwkv2, rwkv_batch, 1, "gspmd", 1),
             "biglstm dp=2,mp=2 overlapped c2": (lstm2, lstm_batch, 2, "overlapped", 2)}
    single = {}
    for cfg in (lstm2, gnmt2, rwkv2):
        batch = next(c[1] for c in cells.values() if c[0] is cfg)
        single[cfg.name] = paper_step(api_mod, cfg, batch)
        torch.cuda.empty_cache()
    rwkv_cut = dataclasses.replace(rwkv_cfg, n_layers=RWKV_TP_LAYERS)
    gnmt_batches = paper_batches(gnmt_cfg, GNMT_B, steps, 0)
    ranks = D.spawn_ranks(_recurrent_rank, 2 * m, "cuda",
                          args=(gnmt_cfg, gnmt_batches, rwkv_cut, cells), stages=m)
    pair = [r["runs"] for r in ranks[:m]]
    lstm_cells = 2 * gnmt_cfg.n_layers * GNMT_T * m
    wkv = RWKV_TP_LAYERS * m
    for key, name, want in (
            ("gnmt", f"(b) gnmt mp={m} B{GNMT_B} S=T={GNMT_T}",
             {"lstm_cell_fwd": lstm_cells, "lstm_cell_bwd_pointwise": lstm_cells}),
            ("rwkv6_7b", f"(c) rwkv6_7b {RWKV_TP_LAYERS} layers mp={m} B{RWKV_B} T{RWKV_T}",
             {"wkv6": wkv, "wkv6_bwd": wkv})):
        summed = {n: sum(r[key]["launches"][n] for r in pair) for n in every}
        per = {n: c // steps for n, c in summed.items()}
        variants = {n: {v: sum(r[key]["variant_launches"][n][v] for r in pair) // steps
                        for v in pair[0][key]["variant_launches"][n]}
                    for n in pair[0][key]["variant_launches"]}
        rec = {"run": name, "per_step": per, "variants_per_step": variants,
               "ranks": [{"rank": r, **{k: res[key][k] for k in ("peak_mem_gib", "step_ms",
                                                                  "losses", "launches")}}
                         for r, res in enumerate(pair)]}
        print(json.dumps({f"recurrent_tp_{key}": rec}), flush=True)
        full = dict.fromkeys(every, 0)
        full.update(want)
        want_var = "tc" if key == "gnmt" else "chunked"
        var_of = "lstm_cell_fwd" if key == "gnmt" else "wkv6"
        losses = [r[key]["losses"] for r in pair]
        if per != full or variants[var_of][want_var] != want[var_of] or \
                any(x != losses[0] for x in losses) or not all(np.isfinite(losses[0])):
            raise AssertionError(f"{name}: launches a step {per} {variants}, want {full}; "
                                 f"losses {losses}")
        out[key] = rec

    # (d) f32 steps on ranks against the single-process card step
    tol = {"loss_rel": 1e-4, "grad_norm_rel": 1e-4, "params_max_abs": RANK_PARAMS_TOL}
    results = {}
    for name, (cfg, _, dp, comm, chunks) in cells.items():
        rules = SH.ShardingRules(cfg, {"data": dp, "model": m},
                                 ParallelPlan(model_axis="model", comm_runtime=comm,
                                              comm_chunks=chunks))
        ref = single[cfg.name]
        ran = ranks[:dp * m]
        errs = [_step_errors(r["cells"][name], (ref[0], ref[1],
                                                SH.shard_params(ref[2], rules, j % m)))
                for j, r in enumerate(ran)]
        worst = {k: max(e[k] for e in errs) for k in tol}
        same = _replicated_same_bits([r["cells"][name][2] for r in ran],
                                     [j // m for j in range(dp * m)], cfg, rules)
        results[name] = dict(worst, replicated_same_bits=same)
    print(json.dumps({"recurrent_tp_d": results, "tol": tol,
                      "single": {k: v[:2] for k, v in single.items()}}), flush=True)
    for name, r in results.items():
        if not (all(r[k] <= tol[k] for k in tol) and r["replicated_same_bits"]):
            raise AssertionError(f"{name} on ranks disagrees with the single-process step: {r}")
    out["d"] = results
    del ranks
    torch.cuda.empty_cache()
    return out


def _start_launcher(args):
    """``python -m repro_torch.launch.train`` started in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return (subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env), args, time.perf_counter())


def _launcher_result(started, expect_rc=0, timeout=600):
    """(stdout, its ``[kernels]`` counts, its ``[variants]`` counts, wall s) of
    a started launcher once it ends; the counts are None for a process that
    printed none (one killed).  The process is stopped on any failure."""
    proc, args, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall_s = time.perf_counter() - t0
    if proc.returncode != expect_rc:
        raise AssertionError(f"launcher {args} exited {proc.returncode}, want {expect_rc}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    launches = variants = None
    for line in out.splitlines():
        if line.startswith("[kernels] "):
            launches = {k: int(v) for k, v in (w.split("=") for w in line.split()[1:])}
        if line.startswith("[variants] "):
            variants = {}
            for part in line[len("[variants] "):].split(" | "):
                name, rest = part.split(": ")
                variants[name] = {k: int(v) for k, v in (w.split("=") for w in rest.split())}
    return out, launches, variants, wall_s


def _check_flash_counts(name, cfg, launches, variants, steps):
    """A one-process dense-decoder run: L flash forward launches a step, all
    ``tc_prefill``, and L backward calls, all ``tc``, no other kernel."""
    want = dict.fromkeys(launches, 0)
    per = cfg.n_layers * steps
    want.update(flash_attention=per, flash_attention_bwd=per)
    want_variants = {n: dict.fromkeys(v, 0) for n, v in variants.items()}
    want_variants["flash_attention"]["tc_prefill"] = per
    want_variants["flash_attention_bwd"]["tc"] = per
    if launches != want or variants != want_variants:
        raise AssertionError(f"{name} launched {launches} {variants}, want {want} "
                             f"{want_variants}")


def _compare_files(a, b, tol=None):
    """Leaf by leaf, read with the port's codec (CRCs checked): the count of
    leaves that are not the same bits and the largest difference, and with
    ``tol`` the largest excess over allclose's bound among them (<= 0 or
    None: within)."""
    from repro_torch import checkpoint as C

    la, lb = C.read_leaves(a), C.read_leaves(b)
    if [(x.dtype, x.shape) for x in la] != [(y.dtype, y.shape) for y in lb]:
        raise AssertionError(f"{a} and {b} hold different leaves")
    differ, max_abs, excess = 0, 0.0, None
    for x, y in zip(la, lb):
        if torch.equal(x, y):
            continue
        differ += 1
        d = (x.double() - y.double()).abs()
        max_abs = max(max_abs, float(d.max()))
        if tol is not None:
            over = float((d - tol["atol"] - tol["rtol"] * y.double().abs()).max())
            excess = over if excess is None else max(excess, over)
    return {"leaves": len(la), "differ": differ, "max_abs": max_abs, "excess": excess}


def _filesystem(path):
    """(mount point, type) of the filesystem that holds ``path``."""
    best = ("?", "?")
    try:
        for line in Path("/proc/mounts").read_text().splitlines():
            _, mnt, fstype = line.split()[:3]
            if path.startswith(mnt) and len(mnt) >= len(best[0].replace("?", "")):
                best = (mnt, fstype)
    except OSError:
        pass
    return best


def phase_checkpoints(train_launch, api_mod, cfg):
    """Phase 21: (a) SmolLM-360M's kill, resume and straight runs through the
    launcher in processes of their own, then the save, stall and restore
    times of its state in this process; (b) the dp=2 and pipe=2 files of 2
    f32 layers on ranks sharing the card, written while (a)'s launchers run,
    restored and continued in one process."""
    import shutil
    import tempfile

    from repro_torch import checkpoint as C
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import eval_train_state, init_train_state, place_state
    from repro_torch.tree import tree_leaves

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        mount, fstype = _filesystem(root)
        out["temp_dir"] = {"free_bytes": shutil.disk_usage(root).free, "mount": mount,
                           "fstype": fstype}
        print(json.dumps({"checkpoints_temp_dir": out["temp_dir"]}), flush=True)
        # (b)'s two rank runs (dp=2 and pipe=2 files of 2 f32 layers, their
        # times unused) start first and write their files while (a)'s
        # launchers run: both spend most of their wall starting processes
        cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
        cells = []
        for i, spec in enumerate(("dp=2,mp=1", "pipe=2,micro=2,sched=1f1b")):
            plan, mp, dp = train_launch.parse_parallel(spec, 1, cfg2)
            plan = dataclasses.replace(plan, dp_axes=("data",))
            stages = mp if plan.is_pipeline else 1
            run = train_launch.RankRun(cfg=cfg2, plan=plan, steps=CKPT_STEPS, batch=SMOL_B,
                                       seq=SMOL_T, lr=3e-3, ckpt_dir=f"{root}/ranks_{i}",
                                       ckpt_every=CKPT_EVERY)
            cells.append((spec, dp, stages, run, f"{root}/one_{i}"))

        # (a) kill at step 4, resume, straight with background saves
        base = ["--arch", cfg.name, "--batch", str(SMOL_B), "--seq", str(SMOL_T), "--steps",
                str(CKPT_STEPS), "--ckpt-every", str(CKPT_EVERY), "--keep-last", "1"]
        kill_dir, straight_dir = f"{root}/kill", f"{root}/straight"

        def launchers():
            # the straight run shares the card with the kill and resume runs
            straight = _start_launcher(base + ["--ckpt-dir", straight_dir, "--background-save"])
            try:
                _, counts, _, kill_s = _launcher_result(_start_launcher(
                    base + ["--ckpt-dir", kill_dir, "--fault", f"kill@{CKPT_STEPS}"]),
                    expect_rc=17)
                left = [os.path.basename(f) for f in C.list_checkpoints(kill_dir)]
                if counts is not None or left != [f"ckpt_{CKPT_EVERY:08d}.msgpack"]:
                    raise AssertionError(f"the killed run left {left} and counts {counts}")
                resumed = _launcher_result(_start_launcher(
                    base + ["--ckpt-dir", kill_dir, "--resume"]))
            except BaseException:
                straight[0].kill()
                straight[0].wait()
                raise
            return kill_s, resumed, _launcher_result(straight)

        (kill_s, (text, res_launches, res_variants, resume_s),
         (_, st_launches, st_variants, straight_s)), _ = _concurrently(
            launchers, lambda: _concurrently(*(
                lambda c=c: train_launch.run_ranks(c[3], c[1], c[2], "cuda") for c in cells)))
        if (f"restored ckpt_{CKPT_EVERY:08d}" not in text
                or f"resuming at step {CKPT_EVERY}" not in text):
            raise AssertionError(f"the resumed run did not restore step {CKPT_EVERY}:\n"
                                 f"{text[-2000:]}")
        _check_flash_counts("the resumed run", cfg, res_launches, res_variants,
                            CKPT_STEPS - CKPT_EVERY)
        _check_flash_counts("the straight run", cfg, st_launches, st_variants, CKPT_STEPS)
        final = f"ckpt_{CKPT_STEPS:08d}.msgpack"
        same = _compare_files(f"{kill_dir}/{final}", f"{straight_dir}/{final}")
        out["a"] = {"arch": cfg.name, "batch": SMOL_B, "seq": SMOL_T, "steps": CKPT_STEPS,
                    "ckpt_every": CKPT_EVERY, "kill_rc": 17, "kill_wall_s": kill_s,
                    "resume_wall_s": resume_s, "straight_wall_s": straight_s,
                    "resume_vs_straight": same,
                    "resume_launches": res_launches, "resume_variants": res_variants,
                    "straight_launches": st_launches, "straight_variants": st_variants}
        print(json.dumps({"checkpoints_a": out["a"]}), flush=True)
        if same["differ"]:
            raise AssertionError(f"the resumed run's step-{CKPT_STEPS} file differs from the "
                                 f"straight run's: {same}")
        shutil.rmtree(kill_dir)
        shutil.rmtree(straight_dir)

        # (a) the save, stall and restore of a SmolLM-360M state on the card
        torch.cuda.empty_cache()
        api = api_mod.build_model(cfg, device="cuda")
        opt = adamw(warmup_cosine(3e-3, 20, CKPT_STEPS))
        state = init_train_state(api, opt, 0)
        leaves = tree_leaves(state.params) + tree_leaves(state.opt_state)
        sync = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fname = C.save_checkpoint(f"{root}/sync", state, 1, timings=sync)
        sync["total_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        C.save_checkpoint(f"{root}/bg", state, 2, background=True)
        stall_s = time.perf_counter() - t0
        C.wait_for_saves()
        bg_s = time.perf_counter() - t0
        shutil.rmtree(f"{root}/bg")
        read_s = []

        def place(s):       # the read (mmap, CRC, a host copy a leaf) ends here
            read_s.append(time.perf_counter() - t0)
            return place_state(s, api)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, got = C.restore_latest_valid(f"{root}/sync", eval_train_state(api, opt),
                                               place)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        back = tree_leaves(restored.params) + tree_leaves(restored.opt_state)
        if got != fname or restored.step != state.step or not all(
                a.device.type == "cuda" and torch.equal(a, b) for a, b in zip(back, leaves)):
            raise AssertionError("the restored SmolLM-360M state is not the saved one")
        out["save"] = {"bytes": os.path.getsize(fname),
                       "leaf_bytes": sum(t.numel() * t.element_size() for t in leaves) + 4,
                       "params": sum(t.numel() for t in tree_leaves(state.params)),
                       "sync_save": sync, "background_return_s": stall_s,
                       "background_total_s": bg_s, "restore_s": restore_s,
                       "restore_read_s": read_s[0], "restore_upload_s": restore_s - read_s[0],
                       "note": "the restore reads a file written just before (page cache)"}
        print(json.dumps({"checkpoints_save": out["save"]}), flush=True)
        del state, restored, leaves, back
        shutil.rmtree(f"{root}/sync")
        torch.cuda.empty_cache()

        # (b) the rank runs' files restored and continued in one process
        api2 = api_mod.build_model(cfg2, device="cuda")
        opt2 = adamw(warmup_cosine(3e-3, 20, CKPT_STEPS))
        for spec, dp, stages, run, one_dir in cells:
            ranks_dir = run.ckpt_dir
            mid = f"{ranks_dir}/ckpt_{CKPT_EVERY:08d}.msgpack"
            state = C.restore_checkpoint(mid, eval_train_state(api2, opt2),
                                         lambda s: place_state(s, api2))
            got = [t.cpu() for t in tree_leaves(state.params) + tree_leaves(state.opt_state)]
            want = C.read_leaves(mid)
            restore_same = (state.step == CKPT_EVERY and len(got) == len(want) - 1
                            and all(torch.equal(a, b) for a, b in zip(got, want)))
            del state, got, want
            os.makedirs(one_dir)
            shutil.copy(mid, one_dir)
            one = dataclasses.replace(run, plan=ParallelPlan(), ckpt_dir=one_dir, resume=True)
            summary = train_launch._train(None, one)
            if summary["start_step"] != CKPT_EVERY or summary["steps"] != CKPT_STEPS:
                raise AssertionError(f"{spec}: the one-process resume ran {summary['start_step']}"
                                     f" -> {summary['steps']}")
            del summary
            cont = _compare_files(f"{one_dir}/ckpt_{CKPT_STEPS:08d}.msgpack",
                                  f"{ranks_dir}/ckpt_{CKPT_STEPS:08d}.msgpack", ELASTIC_TOL)
            rec = {"spec": spec, "ranks": dp * stages, "restore_bit_equal": restore_same,
                   "continuation_vs_ranks": cont, "tol": ELASTIC_TOL}
            out[f"b {spec}"] = rec
            print(json.dumps({"checkpoints_b": rec}), flush=True)
            if not restore_same or (cont["excess"] or 0.0) > 0:
                raise AssertionError(f"{spec} -> one process: {rec}")
            shutil.rmtree(ranks_dir)
            shutil.rmtree(one_dir)
            torch.cuda.empty_cache()
    return out


def _start_serve_launcher(args):
    """``python -m repro_torch.launch.serve`` started in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return (subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env), args, time.perf_counter())


def _chunks(n, chunk):
    """The prefill chunks of an n-token prompt."""
    return [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])


def _want_cont_variants(cfg, ticks, chunk_sizes, variants):
    """Flash launches of a continuous run: L a decode tick on the decode
    tile, L a prefill chunk on the prefill tile, except a chunk so short
    that (H / Hkv) t query rows fit the decode tile's 16."""
    rep = cfg.n_heads // cfg.n_kv_heads
    small = sum(1 for t in chunk_sizes if rep * t <= 16)
    want = dict.fromkeys(variants, 0)
    want.update(tc_decode=cfg.n_layers * (ticks + small),
                tc_prefill=cfg.n_layers * (len(chunk_sizes) - small))
    return want


def _cont_requests(cont_mod, cfg, n, seed):
    """n greedy requests of CONT_NEW tokens, their prompt lengths drawn in
    CONT_PROMPTS and their tokens from the vocabulary, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(CONT_PROMPTS[0], CONT_PROMPTS[1] + 1, (n,), generator=gen).tolist()
    return [cont_mod.Request(rid=i, tokens=torch.randint(0, cfg.vocab_size, (m,),
                                                         generator=gen).tolist(),
                             max_new_tokens=CONT_NEW) for i, m in enumerate(lens)]


def phase_continuous(counters, api_mod, cont_mod, engine_mod, cfg):
    """(a) Full-width, full-depth Llama-3.2-1B through ``ContinuousEngine``
    (CONT_SLOTS slots of CONT_CAP, chunks of CONT_CHUNK, CONT_REQUESTS
    greedy requests): launches counted from 0, tok/s, ms a tick, median
    time to first token, peak GiB, one tick's profile; CONT_SOLO of the
    requests served alone in an engine of the same shape, the same tokens
    and logprobs bit for bit.  (b) The launcher's ``--continuous`` run in a
    process of its own (started during the solo runs).  (c) 2 full-width
    layers in f32, vocab 32768: a slot decode tick at mixed positions, a
    prefill chunk at pos 256, a ragged ``prompt_lens`` generate and a
    window-64 ring decode over a 200-token prompt, each on the card against
    the plain path on the CPU from the same weights, logits within 1e-3."""
    fa_fn = counters["flash_attention"]
    api = api_mod.build_model(cfg, device="cuda")
    params = api.init(0)
    reqs = _cont_requests(cont_mod, cfg, CONT_REQUESTS, seed=25)
    chunk_sizes = [t for r in reqs for t in _chunks(len(r.tokens), CONT_CHUNK)]

    def engine():
        return cont_mod.ContinuousEngine(api, params, n_slots=CONT_SLOTS, capacity=CONT_CAP,
                                         prefill_chunk=CONT_CHUNK)

    warm = engine()                    # the first calls pay cuBLAS's and the build's set-up
    warm.run(_cont_requests(cont_mod, cfg, 2, seed=26))
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    reset_counters(counters)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    variants = variant_launches(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_variants = _want_cont_variants(cfg, eng.decode_ticks, chunk_sizes,
                                        variants["flash_attention"])
    want_launches = dict.fromkeys(launches, 0)
    want_launches["flash_attention"] = sum(want_variants.values())
    if eng.prefill_chunks != len(chunk_sizes) or launches != want_launches or \
            variants["flash_attention"] != want_variants:
        raise AssertionError(f"continuous run: {eng.prefill_chunks} chunks ({len(chunk_sizes)} "
                             f"planned), launched {launches} {variants}, want {want_launches} "
                             f"flash {want_variants}")
    bad = [r.rid for r in results if len(r.tokens) != CONT_NEW or r.finished_reason != "length"
           or not all(math.isfinite(x) for x in r.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if bad or len(results) != CONT_REQUESTS:
        raise AssertionError(f"continuous run: bad results for requests {bad}")
    toks = sum(len(r.tokens) for r in results)
    ttft = sorted(r.first_token_s for r in results)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "slots": CONT_SLOTS, "capacity": CONT_CAP,
           "prefill_chunk": CONT_CHUNK, "requests": CONT_REQUESTS, "new": CONT_NEW,
           "prompt_lens": [len(r.tokens) for r in reqs], "wall_s": wall_s,
           "tok_per_s": toks / wall_s, "steps": eng.ticks, "decode_ticks": eng.decode_ticks,
           "prefill_chunks": eng.prefill_chunks,
           "ms_per_tick": eng.tick_ms_sum / eng.decode_ticks,
           "tick_ms_min_max": [eng.tick_ms_min, eng.tick_ms_max],
           "median_ttft_s": ttft[len(ttft) // 2], "ttft_s_min_max": [ttft[0], ttft[-1]],
           "peak_mem_gib": peak, "launches": launches, "variant_launches": variants}
    print(json.dumps(out), flush=True)

    # one tick at mid-run positions (the first slots' prompts plus 16 tokens)
    with torch.inference_mode():
        cache = eng.cache
        cache["pos"] = torch.tensor([len(r.tokens) + 16 for r in reqs[:CONT_SLOTS]],
                                    dtype=torch.int32, device="cuda")
        tokens = torch.ones(CONT_SLOTS, dtype=torch.long, device="cuda")
        active = torch.ones(CONT_SLOTS, dtype=torch.bool, device="cuda")
        profile_call("continuous decode tick",
                     lambda: eng._decode_tick(params, cache, tokens, active, None))
    del eng, cache

    # (b) starts now, beside the solo runs
    cli = _start_serve_launcher(["--arch", "llama3_2_1b", "--continuous", "--slots", "4",
                                 "--prefill-chunk", "128", "--batch", "8", "--prompt-len",
                                 "512", "--max-new", "32"])
    try:
        by_rid = {r.rid: r for r in results}
        solo_rids = torch.randperm(CONT_REQUESTS, generator=torch.Generator().manual_seed(27))[
            :CONT_SOLO].tolist()
        for rid in solo_rids:
            alone = engine().run([reqs[rid]])[0]
            same = (alone.tokens == by_rid[rid].tokens and alone.logprobs == by_rid[rid].logprobs)
            print(json.dumps({"check": "request alone == in the 16-request run", "rid": rid,
                              "prompt_len": len(reqs[rid].tokens), "same_bits": same}),
                  flush=True)
            if not same:
                raise AssertionError(f"request {rid} alone gave {alone.tokens} "
                                     f"{alone.logprobs}, in the run {by_rid[rid].tokens} "
                                     f"{by_rid[rid].logprobs}")
        del params, api
        torch.cuda.empty_cache()
        phase_continuous_vs_plain(api_mod, engine_mod, cfg)
    finally:
        proc, args, t_cli = cli
        try:
            cli_out, cli_err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cli_wall = time.perf_counter() - t_cli
    if proc.returncode != 0:
        raise AssertionError(f"serve launcher {args} exited {proc.returncode}:\n"
                             f"{cli_out[-3000:]}\n{cli_err[-3000:]}")
    line = next(x for x in cli_out.splitlines() if x.startswith("[serve] continuous"))
    kernels_line = next(x for x in cli_out.splitlines() if x.startswith("[kernels] "))
    cli_launches = {k: int(v) for k, v in (w.split("=") for w in kernels_line.split()[1:])}
    fields = dict(w.split("=") for w in line.split() if "=" in w)
    want = cfg.n_layers * (int(fields["decode_ticks"]) + int(fields["prefill_chunks"]))
    print(json.dumps({"launcher": "serve --continuous", "wall_s": cli_wall, "line": line,
                      "launches": cli_launches}), flush=True)
    if cli_launches["flash_attention"] != want or "256 tokens" not in line:
        raise AssertionError(f"the continuous launcher printed {line!r} {cli_launches}, "
                             f"want {want} flash launches and 256 tokens")
    return launches, variants, results


def phase_continuous_vs_plain(api_mod, engine_mod, cfg):
    """Phase 22 (c): slot mode, the chunked-prefill extend step, a ragged
    batch and the window ring on the card against the plain path on the
    CPU, 2 full-width layers in f32, vocab 32768, from the same seeded
    weights; logits (and the ragged generate's logprobs) within 1e-3, its
    greedy tokens equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32", vocab_size=32768)
    gpu, cpu = (api_mod.build_model(cfg2, device=d) for d in ("cuda", "cpu"))
    params = gpu.init(3)
    params_cpu = _tree_to(params, "cpu")
    gen = torch.Generator().manual_seed(3)
    gaps = {}

    def gap(name, a, b):
        gaps[name] = max(gaps.get(name, 0.0), float((a.float().cpu() - b.float()).abs().max()))

    with torch.inference_mode():
        # a decode tick at mixed positions: 4 rows prefilled, then each at its own pos
        tokens = torch.randint(0, cfg2.vocab_size, (4, 200), generator=gen)
        caches = [api.prefill(p, {"tokens": tokens.to(api.device)}, capacity=264)[1]
                  for api, p in ((gpu, params), (cpu, params_cpu))]
        lens = torch.tensor([200, 77, 130, 5], dtype=torch.int32)
        step = torch.randint(0, cfg2.vocab_size, (4, 1), generator=gen)
        out = []
        for api, p, c in zip((gpu, cpu), (params, params_cpu), caches):
            c["pos"] = lens.to(api.device)
            for _ in range(2):
                lg, c = api.decode_fn(p, c, {"tokens": step.to(api.device)})
            out.append(lg)
        gap("slot decode tick", *out)
        # a prefill chunk at pos 256 of a slot (after one at pos 0)
        chunk = torch.randint(0, cfg2.vocab_size, (1, 512), generator=gen)
        out = []
        for api, p in ((gpu, params), (cpu, params_cpu)):
            sc = api_mod.make_slot_cache(cfg2, 2, 520, device=api.device)
            sl = api_mod.cache_extract_slot(sc, 1)
            _, sl = api.decode_fn(p, sl, {"tokens": chunk[:, :256].to(api.device)})
            api_mod.cache_insert_slot(sc, sl, 1)
            lg, sl = api.decode_fn(p, api_mod.cache_extract_slot(sc, 1),
                                   {"tokens": chunk[:, 256:].to(api.device)})
            out.append(lg)
        gap("prefill chunk at pos 256", *out)
        # a ragged batch through the static engine
        ragged = torch.randint(0, cfg2.vocab_size, (4, 64), generator=gen)
        res = [engine_mod.ServeEngine(api, p).generate(
                   {"tokens": ragged.to(api.device)}, max_new_tokens=4,
                   prompt_lens=[64, 17, 40, 33])
               for api, p in ((gpu, params), (cpu, params_cpu))]
        gap("ragged generate logprobs", res[0].logprobs, res[1].logprobs)
        same_tokens = torch.equal(res[0].tokens.cpu(), res[1].tokens)
        # the window-64 ring over a 200-token prompt, then 3 decode steps
        ring_steps = torch.randint(0, cfg2.vocab_size, (3, 2, 1), generator=gen)
        out = []
        for api, p in ((gpu, params), (cpu, params_cpu)):
            lg0, c = api.prefill(p, {"tokens": tokens[:2].to(api.device)}, window=64)
            lgs = [lg0]
            for nxt in ring_steps:
                lg, c = api.decode_fn(p, c, {"tokens": nxt.to(api.device)}, window=64)
                lgs.append(lg)
            out.append(lgs)
        for a, b in zip(*out):
            gap("window-64 ring", a, b)
    res = {"arch": cfg.name, "continuous_vs_plain_max_abs_diff": gaps, "tol": 1e-3,
           "ragged_tokens_equal": same_tokens}
    print(json.dumps(res), flush=True)
    if not all(g <= 1e-3 for g in gaps.values()) or not same_tokens:
        raise AssertionError(f"continuous batching on the card disagrees with the plain "
                             f"path: {res}")
    return res


def _cell_prompts(vocab, seed=29):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab, (n,), generator=gen).tolist() for n in SHARD_CELL_LENS]


def _probe_tick(tf_mod, api, eng, prompts, tokens, kw):
    """The first tick's logits of ``eng`` (a single-process engine, or this
    rank's with ``kw``'s routing): each prompt prefilled into its slot
    through the engine's chunk, then one tick over every slot."""
    with torch.inference_mode():
        for slot, prompt in enumerate(prompts):
            for lo in range(0, len(prompt), SHARD_CELL_CHUNK):
                toks = torch.tensor([prompt[lo:lo + SHARD_CELL_CHUNK]], device="cuda")
                eng.cache, _ = eng._prefill_chunk(eng.params, eng.cache, toks, slot)
        batch = {"tokens": tokens[:, None]}
        if kw.get("model_axis"):
            logits, _ = tf_mod.decode_slots_tp(
                api.cfg, eng.params, eng.cache, batch, mesh=eng.mesh, model_axis="model",
                batch_axes=("data",), comm_chunks=kw.get("comm_chunks", 1),
                window_override=kw.get("window"))
        else:
            logits, _ = api.decode_fn(eng.params, eng.cache, batch, None, kw.get("window"))
    return logits[:, 0].float().cpu()


def _sharded_cell_rank(mesh, cfg2, runs):
    """Phase 27 (b) on one rank: for each run's routing, the first tick's
    logits after the cell's prompts and the engine's results on them."""
    from repro_torch.models import api as api_mod
    from repro_torch.models import transformer as tf_mod
    from repro_torch.serve import continuous as cont_mod

    api = api_mod.build_model(cfg2, device="cuda")
    params = api.init(3)
    prompts = _cell_prompts(cfg2.vocab_size)
    tokens = torch.ones(SHARD_CELL_SLOTS, dtype=torch.long, device="cuda")
    out = []
    for kw in runs:
        def engine():
            return cont_mod.ContinuousEngine(
                api, params, n_slots=SHARD_CELL_SLOTS, capacity=SHARD_CELL_CAP,
                prefill_chunk=SHARD_CELL_CHUNK, mesh=mesh, batch_axes=("data",), **kw)
        logits = _probe_tick(tf_mod, api, engine(), prompts, tokens, kw)
        res = engine().run([cont_mod.Request(rid=i, tokens=p, max_new_tokens=SHARD_CELL_NEW)
                            for i, p in enumerate(prompts)])
        out.append((logits, [(r.tokens, r.logprobs) for r in res]))
    return out


def phase_sharded_serving(serve_launch, api_mod, cont_mod, cfg, single):
    """Phase 27: (a) full-width Llama-3.2-1B through ``run_continuous`` on 2
    ranks sharing the card, at tp=2, tp=2 with comm chunks 2 and cp=2, the
    launches of each rank exact and the greedy tokens against phase 22's
    single-process run (``single``, by rid) counted; (b) the 2-layer f32
    cells against the single-process card engine.  Returns (a)'s runs."""
    from repro_torch.models import transformer as tf_mod
    from repro_torch.parallel import dist as D

    L = cfg.n_layers
    reqs = [dataclasses.replace(r, max_new_tokens=SHARD_NEW)
            for r in _cont_requests(cont_mod, cfg, CONT_REQUESTS, seed=25)[:SHARD_REQUESTS]]
    lens = [len(r.tokens) for r in reqs]
    n_chunks = sum(len(_chunks(n, CONT_CHUNK)) for n in lens)
    n_keyed = n_chunks - len(lens)             # chunks whose slot already holds keys
    names = ["tp=2", "tp=2 c=2", "cp=2"]
    spec = {"cfg": cfg, "seed": 0, "slots": CONT_SLOTS, "capacity": CONT_CAP,
            "prefill_chunk": CONT_CHUNK, "requests": reqs,
            "runs": [{"model_axis": "model"}, {"model_axis": "model", "comm_chunks": 2},
                     {"context_axis": "model"}]}
    t0 = time.perf_counter()
    dp, outs = serve_launch.run_continuous(spec, tp=2, device="cuda", timeout_s=600)
    runs = {}
    for i, name in enumerate(names):
        per_rank = [o[i] for o in outs]
        first = per_rank[0]
        ticks = first["decode_ticks"]
        if name.startswith("tp"):
            want = [L * (ticks + n_chunks)] * 2
        else:   # rank 0: its diagonal hop (its past block lies in the future)
            want = [L * (ticks + n_chunks + n_keyed), L * (ticks + 2 * n_chunks + n_keyed)]
        got = [r["launches"]["flash_attention"] for r in per_rank]
        same = all([(x["tokens"], x["logprobs"]) for x in r["results"]] ==
                   [(x["tokens"], x["logprobs"]) for x in first["results"]] for r in per_rank)
        if got != want or first["prefill_chunks"] != n_chunks or not same or \
                any(r["launches"]["gmm"] or r["launches"]["wkv6"] for r in per_rank):
            raise AssertionError(f"phase 27 (a) {name}: flash launches {got}, want {want}; "
                                 f"{first['prefill_chunks']} chunks of {n_chunks}; ranks "
                                 f"agree {same}")
        diff = sum(a != b for r in first["results"]
                   for a, b in zip(r["tokens"], single[r["rid"]].tokens[:SHARD_NEW]))
        bad = [r["rid"] for r in first["results"] if len(r["tokens"]) != SHARD_NEW
               or not all(math.isfinite(x) for x in r["logprobs"])]
        if bad:
            raise AssertionError(f"phase 27 (a) {name}: bad results for requests {bad}")
        toks = sum(len(r["tokens"]) for r in first["results"])
        run = {"run": name, "dp": dp, "requests": len(reqs), "new": SHARD_NEW,
               "prompt_lens": lens, "decode_ticks": ticks, "prefill_chunks": n_chunks,
               "launches_per_rank": got, "flash_variants_per_rank":
                   [r["flash_variants"] for r in per_rank],
               "tick_ms": [{"sum": r["tick_ms_sum"], "min": r["tick_ms_min"],
                            "max": r["tick_ms_max"], "mean": r["tick_ms_sum"] / ticks}
                           for r in per_rank],
               "median_first_token_s": [sorted(x["first_token_s"] for x in r["results"])[
                   len(reqs) // 2] for r in per_rank],
               "tok_per_s": [toks / r["wall_s"] for r in per_rank],
               "wall_s": [r["wall_s"] for r in per_rank],
               "peak_gib": [r["peak_gib"] for r in per_rank],
               "tokens_differing_from_single_process": diff,
               "tokens": toks}
        print(json.dumps(run), flush=True)
        runs[name] = run
    print(json.dumps({"phase 27 (a) s": time.perf_counter() - t0}), flush=True)

    # (b) the 2-layer f32 cells against the single-process card engine
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32", vocab_size=32768)
    cells = [{"model_axis": "model"}, {"model_axis": "model", "comm_chunks": 2},
             {"context_axis": "model"}, {"context_axis": "model", "window": 64}]
    ranks = D.spawn_ranks(_sharded_cell_rank, 2, "cuda", args=(cfg2, cells), stages=2,
                          timeout_s=600)
    api = api_mod.build_model(cfg2, device="cuda")
    params = api.init(3)
    prompts = _cell_prompts(cfg2.vocab_size)
    tokens = torch.ones(SHARD_CELL_SLOTS, dtype=torch.long, device="cuda")
    gaps = {}
    for i, kw in enumerate(cells):
        def engine():
            return cont_mod.ContinuousEngine(api, params, n_slots=SHARD_CELL_SLOTS,
                                             capacity=SHARD_CELL_CAP,
                                             prefill_chunk=SHARD_CELL_CHUNK,
                                             window=kw.get("window"))
        want_logits = _probe_tick(tf_mod, api, engine(), prompts, tokens,
                                  {"window": kw.get("window")})
        want = engine().run([cont_mod.Request(rid=j, tokens=p, max_new_tokens=SHARD_CELL_NEW)
                             for j, p in enumerate(prompts)])
        name = " ".join(f"{k}={v}" for k, v in kw.items())
        for r, rank in enumerate(ranks):
            logits, res = rank[i]
            lg = float((logits - want_logits).abs().max())
            lp = max(abs(a - b) for (_, got), w in zip(res, want)
                     for a, b in zip(got, w.logprobs))
            same = all(tok == w.tokens for (tok, _), w in zip(res, want))
            gaps[f"{name} rank {r}"] = {"first_tick_logits": lg, "logprobs": lp,
                                        "tokens_equal": same}
    out = {"phase 27 (b)": gaps, "tol": 1e-3, "prompt_lens": SHARD_CELL_LENS,
           "chunk": SHARD_CELL_CHUNK}
    print(json.dumps(out), flush=True)
    if not all(g["tokens_equal"] and g["first_tick_logits"] <= 1e-3 and g["logprobs"] <= 1e-3
               for g in gaps.values()):
        raise AssertionError(f"phase 27 (b): a sharded cell disagrees with one process: {out}")
    return runs


def _drive_router(rt, reqs, counters):
    """Every request through router ``rt`` from counters at 0: the results
    by rid, each rid's finish second, the rids that failed over, after each
    tick the (decoding, waiting) requests on each replica, the wall seconds
    and peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    t0 = time.perf_counter()
    for r in reqs:
        rt.submit(r)
    done_at, ticks, failed = {}, [], set()
    try:
        more = True
        while more:
            more = rt.step()
            now = time.perf_counter() - t0
            for res in rt.results[len(done_at):]:
                done_at[res.rid] = now
            failed |= {rid for rid, tr in rt.tracked.items() if tr.failovers}
            ticks.append([(sum(1 for tr in rt.tracked.values() if tr.replica == i and tr.tokens),
                           sum(1 for tr in rt.tracked.values()
                               if tr.replica == i and not tr.tokens))
                          for i in range(len(rt.replicas))])
    finally:
        rt.close()
    return ({r.rid: r for r in rt.results}, done_at, sorted(failed), ticks,
            time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30)


def _router_cell_rank(mesh, cfg2):
    """Phase 29 (c) on one rank: the router over replica groups of this
    mesh under a kill of replica 0, then on replica group 1 the unfaulted
    tensor-MP engine; each with this rank's flash launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api as api_mod
    from repro_torch.serve import continuous as cont_mod
    from repro_torch.serve import router as router_mod
    from repro_torch.train.fault import parse_fault_schedule

    api = api_mod.build_model(cfg2, device="cuda")
    params = api.init(3)
    gen = torch.Generator().manual_seed(31)
    reqs = [cont_mod.Request(rid=i, tokens=torch.randint(0, cfg2.vocab_size, (n,),
                                                         generator=gen).tolist(),
                             max_new_tokens=ROUTER_CELL_NEW)
            for i, n in enumerate(ROUTER_CELL_LENS)]
    kw = dict(n_slots=ROUTER_CELL_SLOTS, capacity=ROUTER_CELL_CAP,
              prefill_chunk=ROUTER_CELL_CHUNK)
    before = fa.flash_attention.launches
    rt = router_mod.ReplicaRouter(
        api, params, replicas=mesh.shape["data"], mesh=mesh, retry_backoff_s=0.0,
        faults=parse_fault_schedule(f"kill@{ROUTER_CELL_KILL}:0"), **kw)
    res = rt.run(reqs)
    out = {"results": [(r.rid, r.tokens, r.logprobs) for r in res], "stats": rt.stats,
           "states": rt.replica_states, "fault_log": rt.fault_log,
           "engines": [(r.decode_ticks, r.prefill_chunks) for r in rt.replicas],
           "launches": fa.flash_attention.launches - before}
    if mesh.data_index == 1:
        eng = cont_mod.ContinuousEngine(api, params, mesh=mesh, model_axis="model",
                                        batch_axes=(), **kw)
        before = fa.flash_attention.launches
        out["group_1"] = [(r.rid, r.tokens, r.logprobs) for r in eng.run(reqs)]
        out["group_1_launches"] = fa.flash_attention.launches - before
        out["group_1_engine"] = (eng.decode_ticks, eng.prefill_chunks)
    return out


def phase_router(counters, api_mod, cont_mod, router_mod, cfg, single):
    """Phase 29: (a) the router in this process, two replicas of phase 22's
    engine on its requests (``single``: phase 22 (a)'s results by rid),
    unfaulted, then kill, NaN logits and a stall at tick K; (b) the
    launcher's router run, started beside (c) (exact checks; its rate is
    taken on a card (c)'s ranks share); (c) replicas 2 x tp 2 on 4 ranks
    sharing the card.  Returns (a)'s runs."""
    from repro_torch.parallel import dist as D
    from repro_torch.train.fault import parse_fault_schedule

    t_phase = time.perf_counter()
    L = cfg.n_layers
    rep = cfg.n_heads // cfg.n_kv_heads
    reqs = _cont_requests(cont_mod, cfg, CONT_REQUESTS, seed=25)
    # every chunk of these prompts takes the prefill tile (none fits the
    # decode tile's 16 rows), so a run's launches split by its own counts
    if any(rep * t <= 16 for r in reqs for t in _chunks(len(r.tokens), CONT_CHUNK)):
        raise AssertionError("phase 29: a prompt's last chunk would take the decode tile")
    api = api_mod.build_model(cfg, device="cuda")
    params = api.init(0)

    def router(faults="", **kw):
        return router_mod.ReplicaRouter(
            api, params, replicas=ROUTER_REPLICAS, n_slots=CONT_SLOTS, capacity=CONT_CAP,
            prefill_chunk=CONT_CHUNK, retry_backoff_s=0.0,
            faults=parse_fault_schedule(faults) if faults else (), **kw)

    router().run(_cont_requests(cont_mod, cfg, 4, seed=26))       # warm up
    runs, base = {}, None
    for name in ("none", "kill", "nanlogits", "stall"):
        if name == "none":
            faults, kw = "", {}
        else:
            k = base["K"]
            faults, kw = {"kill": (f"kill@{k}:0", {}),
                          "nanlogits": (f"nanlogits@{k}:1", {}),
                          "stall": (f"stall@{k}:0:{ROUTER_STALL_S}",
                                    {"watchdog_timeout_s": ROUTER_WATCHDOG_S})}[name]
        rt = router(faults, **kw)
        results, done_at, failed_over, ticks, wall, peak = _drive_router(rt, reqs, counters)
        if name == "none":
            # K: the first armed tick before which replica 0 holds a decoding
            # and a waiting request and replica 1 a decoding one
            k = next(t for t in range(3, len(ticks) + 1)
                     if min(ticks[t - 2][0]) > 0 and ticks[t - 2][1][0] > 0)
            base = {"K": k, "done_at": done_at, "ticks": ticks}
        k = base["K"]
        want_failovers = {"none": 0, "kill": sum(base["ticks"][k - 2][0]),
                          "nanlogits": sum(base["ticks"][k - 2][1]),
                          "stall": sum(base["ticks"][k - 1][0])}[name]
        want_states = {"none": ["healthy", "healthy"], "kill": ["dead", "healthy"],
                       "nanlogits": ["healthy", "degraded"],
                       "stall": ["degraded", "healthy"]}[name]
        want_log = [] if name == "none" else [(name, k, 1 if name == "nanlogits" else 0)]
        want_stats = {"completed": CONT_REQUESTS, "shed": 0, "timed_out": 0,
                      "failovers": want_failovers}
        launches = {n: fn.launches for n, fn in counters.items()}
        variants = variant_launches(counters)["flash_attention"]
        want_variants = dict.fromkeys(variants, 0)
        want_variants.update(tc_decode=L * rt.decode_ticks, tc_prefill=L * rt.prefill_chunks)
        want_launches = dict.fromkeys(launches, 0)
        want_launches["flash_attention"] = L * (rt.decode_ticks + rt.prefill_chunks)
        differ = [rid for rid, r in results.items()
                  if (r.tokens, r.logprobs) != (single[rid].tokens, single[rid].logprobs)]
        recover = [done_at[rid] - base["done_at"][rid] for rid in failed_over]
        toks = sum(len(r.tokens) for r in results.values())
        ttft = sorted(r.first_token_s for r in results.values())
        run = {"run": name, "faults": faults, "K": k, "tok_per_s": toks / wall, "wall_s": wall,
               "router_ticks": rt.ticks, "ms_per_router_tick": wall / rt.ticks * 1e3,
               "decode_ticks": rt.decode_ticks, "prefill_chunks": rt.prefill_chunks,
               "engine_ms_per_tick": [r.engine.tick_ms_sum / max(r.engine.decode_ticks, 1)
                                      if r.engine is not None else None
                                      for r in rt.replicas],
               "median_first_token_s": ttft[len(ttft) // 2],
               "first_token_s_min_max": [ttft[0], ttft[-1]], "stats": rt.stats,
               "states": rt.replica_states, "fault_log": rt.fault_log,
               "failed_over": failed_over, "recover_s_max": max(recover, default=0.0),
               "recover_s_mean": sum(recover) / len(recover) if recover else 0.0,
               "peak_gib": peak, "launches": launches, "flash_variants": variants,
               "requests_differing_from_phase_22": differ}
        print(json.dumps(run), flush=True)
        if differ or len(results) != CONT_REQUESTS or rt.stats != want_stats or \
                rt.replica_states != want_states or rt.fault_log != want_log or \
                len(failed_over) != want_failovers or launches != want_launches or \
                variants != want_variants:
            raise AssertionError(f"phase 29 (a) {name}: want stats {want_stats}, states "
                                 f"{want_states}, fault log {want_log}, launches "
                                 f"{want_launches} {want_variants}: {run}")
        runs[name] = run
    del api, params
    torch.cuda.empty_cache()
    print(json.dumps({"phase 29 (a) s": time.perf_counter() - t_phase}), flush=True)

    # (b) beside (c)
    cli = _start_serve_launcher(["--arch", "llama3_2_1b", "--continuous", "--replicas", "2",
                                 "--slots", str(CONT_SLOTS), "--prefill-chunk", str(CONT_CHUNK),
                                 "--batch", "16", "--prompt-len", "512", "--max-new", "32",
                                 "--fault", "kill@5:0"])
    try:
        cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32", vocab_size=32768)
        ranks = D.spawn_ranks(_router_cell_rank, 4, "cuda", args=(cfg2,), stages=2,
                              timeout_s=300)
    finally:
        proc, args, t_cli = cli
        try:
            cli_out, cli_err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    first, group_1 = ranks[0], ranks[2]
    want_launches = [cfg2.n_layers * sum(first["engines"][r // 2]) for r in range(4)]
    cell = {"phase 29 (c)": {
        "stats": first["stats"], "states": first["states"], "fault_log": first["fault_log"],
        "engines": first["engines"], "launches_per_rank": [r["launches"] for r in ranks],
        "ranks_agree": all(r["results"] == first["results"] and r["stats"] == first["stats"]
                           for r in ranks),
        "same_bits_as_group_1": first["results"] == group_1["group_1"],
        "group_1_launches": [group_1["group_1_launches"], ranks[3]["group_1_launches"]],
        "group_1_engine": group_1["group_1_engine"]}}
    print(json.dumps(cell), flush=True)
    c = cell["phase 29 (c)"]
    if not (c["ranks_agree"] and c["same_bits_as_group_1"]
            and c["launches_per_rank"] == want_launches
            and first["states"] == ["dead", "healthy"] and first["stats"]["failovers"] > 0
            and first["stats"]["completed"] == len(ROUTER_CELL_LENS)
            and c["group_1_launches"] == [cfg2.n_layers * sum(group_1["group_1_engine"])] * 2):
        raise AssertionError(f"phase 29 (c): want launches {want_launches}: {cell}")

    cli_wall = time.perf_counter() - t_cli
    if proc.returncode != 0:
        raise AssertionError(f"serve launcher {args} exited {proc.returncode}:\n"
                             f"{cli_out[-3000:]}\n{cli_err[-3000:]}")
    line = next(x for x in cli_out.splitlines() if x.startswith("[serve] router:"))
    kernels_line = next(x for x in cli_out.splitlines() if x.startswith("[kernels] "))
    cli_launches = {k: int(v) for k, v in (w.split("=") for w in kernels_line.split()[1:])}
    fields = dict(w.rstrip(",").split("=", 1) for w in line.split() if "=" in w)
    want = L * (int(fields["decode_ticks"]) + int(fields["prefill_chunks"]))
    print(json.dumps({"launcher": "serve --continuous --replicas 2 --fault kill@5:0",
                      "wall_s": cli_wall, "line": line, "launches": cli_launches}), flush=True)
    if cli_launches["flash_attention"] != want or "completed=16," not in line or \
            int(fields["failovers"]) <= 0 or "states=['dead', 'healthy']" not in line:
        raise AssertionError(f"the router launcher printed {line!r} {cli_launches}, want "
                             f"{want} flash launches, completed=16, failovers > 0 and "
                             f"states=['dead', 'healthy']")
    runs["launcher"] = {"launches": cli_launches["flash_attention"], "line": line}
    runs["ranks"] = {"launches": sum(c["launches_per_rank"])}
    print(json.dumps({"phase 29 s": time.perf_counter() - t_phase}), flush=True)
    return runs


def phase_fsdp(train_launch, wk, api_mod, rwkv_cfg):
    """Phase 30: the fsdp plans on ranks sharing the card.  (a) The
    planner's 2-card plan of RWKV6-7B (DP with the parameters and AdamW
    state sharded over ``data``) through the launcher, at full width on
    ``FSDP_LAYERS`` of its 32 layers, B 4 x T 2048 global, bf16, AdamW, clip
    1.0, ``FSDP_STEPS`` steps, then plain ``dp=2`` on the same spawn, the
    ``wkv6`` / ``wkv6_bwd`` counters set to 0 just before each and read just
    after (exact: a call a layer a step a rank).  Per rank: the memory
    allocated after the last step (the resident state) within
    ``FSDP_RESIDENT_TOL`` of 12 B x P_div / 2 + 12 B x P_whole (P_div the
    parameters of the leaves JAX's rules shard over ``data``) and below
    plain dp=2's, the peak beside the planner's ``per_device_mem_bytes(
    fsdp=2)`` and the launcher's floor for the port's step
    (``fsdp_step_bytes``, which its check passes), step ms.  Plain dp=2 runs ``FSDP_PLAIN_STEPS`` steps: its
    resident state and peak are those of its first step.  (b), the f32
    value cells of the fsdp plans, run on the spawns of the cells they sit
    beside: BigLSTM ``dp=2`` + fsdp in phase 15 (d), Llama ``dp=2,cp=2`` +
    fsdp in 19 (c), Llama ``dp=2`` and ``dp=2,mp=2`` (both runtimes) + fsdp
    in 20 (b)."""
    from repro_torch.core.planner import (HybridPlanner, default_epoch_model,
                                          per_device_mem_bytes)
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import tree_leaves

    choice = HybridPlanner(rwkv_cfg, epoch_model=default_epoch_model(rwkv_cfg)).best(2)
    if not (choice.plan.fsdp_axes and choice.mp == 1 and choice.pods * choice.dp == 2):
        raise AssertionError(f"the planner's 2-card RWKV6-7B plan is {choice.mesh_shape} "
                             f"{choice.mp_kind} fsdp={choice.plan.fsdp_axes}, not DP + fsdp")
    cfg4 = dataclasses.replace(rwkv_cfg, n_layers=FSDP_LAYERS)
    rules = SH.ShardingRules(cfg4, {"data": 2, "model": 1},
                             dataclasses.replace(choice.plan, fsdp_axes=("data",)))
    meta = api_mod.build_model(cfg4, device="cpu").init(0, device="meta")
    dims = SH.fsdp_dims(meta, SH.param_specs(cfg4, rules), rules)
    p_div = sum(t.numel() for t, d in zip(tree_leaves(meta), dims) if d is not None)
    p_whole = sum(t.numel() for t, d in zip(tree_leaves(meta), dims) if d is None)
    want_resident = 12 * p_div / 2 + 12 * p_whole
    model_peak = per_device_mem_bytes(cfg4, mp=1, fsdp=2, mini_batch=FSDP_B // 2,
                                      seq_len=FSDP_T)
    port_floor = train_launch.fsdp_step_bytes(
        train_launch.RankRun(cfg=cfg4, plan=rules.plan, steps=FSDP_STEPS, batch=FSDP_B,
                             seq=FSDP_T, lr=3e-3), 2, 1)
    common = ["--arch", "rwkv6_7b", "--batch", str(FSDP_B), "--seq", str(FSDP_T),
              "--max-local-devices", "2"]
    names, steps = ("auto +fsdp", "dp=2"), (FSDP_STEPS, FSDP_PLAIN_STEPS)
    summaries, _ = _launcher_runs(
        train_launch, [common + ["--parallel", "auto", "--devices", "2", "--steps",
                                 str(FSDP_STEPS)],
                       common + ["--parallel", "dp=2,mp=1", "--steps", str(FSDP_PLAIN_STEPS)]],
        edit=lambda run: dataclasses.replace(run, cfg=cfg4))
    rec = {"planner_2": {"mesh": list(choice.mesh_shape), "kind": choice.mp_kind,
                         "fsdp": list(choice.plan.fsdp_axes), "speedup": choice.speedup,
                         "mem_gib": choice.mem_bytes / 2**30},
           "layers": FSDP_LAYERS, "batch": FSDP_B, "seq": FSDP_T, "steps": dict(zip(names, steps)),
           "p_div": p_div, "p_whole": p_whole, "want_resident_gib": want_resident / 2**30,
           "planner_peak_gib": model_peak / 2**30, "port_peak_floor_gib": port_floor / 2**30,
           "runs": {}}
    for name, n_steps, summary in zip(names, steps, summaries):
        per = n_steps * FSDP_LAYERS * 2
        t = summary["transport"]
        got = {n: summary["launches"][n] for n in ("wkv6", "wkv6_bwd")}
        if (t.backend, t.placement, len(summary["ranks"])) != ("gloo", "shared", 2) or \
                got != {"wkv6": per, "wkv6_bwd": per} or \
                summary["variants"]["wkv6"].get("chunked") != per or \
                not all(np.isfinite(summary["history"])):
            raise AssertionError(f"(a) rwkv6_7b {name}: {t}, launches {got} "
                                 f"{summary['variants']['wkv6']} (want {per} of each, all "
                                 f"chunked), losses {summary['history']}")
        rec["runs"][name] = {
            "losses": summary["history"], "launches": got,
            "ranks": [{"rank": r["rank"], "resident_gib": r["resident_bytes"] / 2**30,
                       "peak_gib": r["peak_mem_bytes"] / 2**30, "step_ms": r["step_ms"],
                       "median_step_ms_after_first": (float(np.median(r["step_ms"][1:]))
                                                      if len(r["step_ms"]) > 1 else None)}
                      for r in summary["ranks"]]}
    fs, plain = (rec["runs"][n]["ranks"] for n in names)
    rec["resident_rel_err"] = [abs(r["resident_gib"] * 2**30 - want_resident) / want_resident
                               for r in fs]
    print(json.dumps({"fsdp_a": rec}), flush=True)
    if not all(e <= FSDP_RESIDENT_TOL for e in rec["resident_rel_err"]) or \
            not all(f["resident_gib"] < p["resident_gib"] for f, p in zip(fs, plain)):
        raise AssertionError(f"(a) a fsdp rank's resident state is not its shard: "
                             f"{[r['resident_gib'] for r in fs]} GiB, want "
                             f"{want_resident / 2**30:.3f} within {FSDP_RESIDENT_TOL} and below "
                             f"plain dp=2's {[r['resident_gib'] for r in plain]}")
    torch.cuda.empty_cache()
    return rec


def _ckpt_paths(runs, kernel):
    return {f"train {runs['a']['arch']} --resume (process)": runs["a"]["resume_launches"][kernel],
            f"train {runs['a']['arch']} --background-save (process)":
                runs["a"]["straight_launches"][kernel]}


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
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.models import api as api_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import continuous as cont_mod
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import router as router_mod

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
    rows += phase_kv_lens(fa)
    fwd_rows, bwd_rows, _ = phase_lstm_kernels(lc, ref_mod)
    gx_rows = phase_lstm_gx(lc)
    gmm_rows = phase_gmm_kernels(gm, ref_mod)
    wkv_rows = phase_wkv_kernels(wk, ref_mod)
    gmm_bwd_rows = phase_gmm_bwd(gm, ref_mod)
    wkv_bwd_rows = phase_wkv_bwd(wk, ref_mod)
    flash_bwd_rows = phase_flash_bwd(fa)
    hop_fwd_rows, hop_bwd_rows = phase_ring_hops(fa)
    rows += hop_fwd_rows
    flash_bwd_rows += hop_bwd_rows
    tp_fwd_rows, tp_bwd_rows = phase_tp_attention(fa)
    rows += tp_fwd_rows
    flash_bwd_rows += tp_bwd_rows
    qs_fwd_rows, qs_bwd_rows = phase_q_start(fa)
    rows += qs_fwd_rows
    flash_bwd_rows += qs_bwd_rows
    counters = {"flash_attention": fa.flash_attention,
                "flash_attention_bwd": fa.flash_attention_bwd, "gmm": gm.gmm,
                "gmm_bwd": gm.gmm_bwd, "wkv6": wk.wkv6, "wkv6_bwd": wk.wkv6_bwd}

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
    phase_step_vs_plain(api_mod, moe_mod, cfg, counters,
                        {"flash_attention": (2, {"fma": 2}),
                         "flash_attention_bwd": (2, {"fma": 2})})

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

    _phase("20 tensor MP and expert parallelism on ranks")
    tp_runs, _, _, ep_run = phase_tensor(train_launch, lc, counters, api_mod, cfg, inc_cfg,
                                         get_config("granite_moe_1b_a400m"))

    _phase("21 checkpoints and fault tolerance")
    ckpt_runs = phase_checkpoints(train_launch, api_mod, get_config("smollm_360m"))

    _phase("22 continuous batching")
    cont_launches, cont_variants, cont_results = phase_continuous(counters, api_mod, cont_mod,
                                                                  engine_mod, cfg)

    _phase("23 train granite_moe_1b_a400m, full width and depth")
    granite_launches, granite_variants, _ = phase_train_granite(train_launch, gm, lc, counters,
                                                                api_mod, moe_cfg)

    _phase("24 Granite train step against its plain path")
    phase_step_vs_plain(api_mod, moe_mod, moe_cfg, counters,
                        {"flash_attention": (2, {"fma": 2}),
                         "flash_attention_bwd": (2, {"fma": 2}), "gmm": (6, {"fma": 6}),
                         "gmm_bwd": (12, {"fma_dx": 6, "fma_dw": 6})})

    _phase(f"25 train rwkv6_7b, full width, {RWKV_LAYERS} layers")
    rwkv_train_launches, rwkv_train_variants, _ = phase_train_rwkv(train_launch, wk, lc,
                                                                   counters, api_mod, rwkv_cfg)

    _phase("26 RWKV train step against its plain path")
    phase_step_vs_plain(api_mod, moe_mod, rwkv_cfg, counters,
                        {"wkv6": (2, {"chunked": 2}), "wkv6_bwd": (2, None)})

    _phase("27 sharded continuous serving on a pair sharing the card")
    shard_runs = phase_sharded_serving(serve_launch, api_mod, cont_mod, cfg,
                                       {r.rid: r for r in cont_results})
    # the launches each new phase-3 row's shape makes on phase 27 (a)'s
    # runs, summed over the pair (the windowed hop: (b)'s window-64 cell)
    shard_paths = {
        "tp_tick": {f"serve llama3_2_1b continuous {n} (ranks)":
                    2 * cfg.n_layers * shard_runs[n]["decode_ticks"]
                    for n in ("tp=2", "tp=2 c=2")},
        "cp_partial": {"serve llama3_2_1b continuous cp=2 (ranks)":
                       2 * cfg.n_layers * (shard_runs["cp=2"]["prefill_chunks"]
                                           - SHARD_REQUESTS)},
        "cp_partial_pos0": {"serve llama3_2_1b continuous cp=2 (ranks)": 0},
        "ring_past_hop": {"serve llama3_2_1b continuous cp=2 (ranks)": 0}}
    for row in rows + flash_bwd_rows:
        if "path" in row:
            row["launches"] = shard_paths[row.pop("path")]

    _phase("28 tensor MP of the recurrent families on ranks")
    rnn_tp = phase_tensor_recurrent(train_launch, lc, wk, api_mod, lstm_cfg, gnmt_cfg, rwkv_cfg)

    _phase("29 the multi-replica router")
    router_runs = phase_router(counters, api_mod, cont_mod, router_mod, cfg,
                               {r.rid: r for r in cont_results})
    del cont_results

    _phase("30 the fsdp plans on ranks")
    fsdp_a = phase_fsdp(train_launch, wk, api_mod, rwkv_cfg)

    _phase("31 result")
    rnn_tp_paths = {"train biglstm mp=2 gspmd (ranks)": rnn_tp["a_biglstm_gspmd"]["launches"],
                    "train biglstm mp=2 overlapped c=2 (ranks)":
                        rnn_tp["a_biglstm_overlapped"]["launches"],
                    "train gnmt mp=2 (ranks)": {n: c * RNN_TP_STEPS for n, c in
                                                rnn_tp["gnmt"]["per_step"].items()},
                    f"train rwkv6_7b {RWKV_TP_LAYERS} layers mp=2 (ranks)":
                        {n: c * RNN_TP_STEPS for n, c in rnn_tp["rwkv6_7b"]["per_step"].items()}}
    paper_paths = {"train gnmt": gnmt_launches, "train inception_v3": inc_launches,
                   "train granite_moe_1b_a400m --parallel auto --devices 8 (ranks)":
                       ep_run["launches"]}
    fsdp_paths = {f"train rwkv6_7b {FSDP_LAYERS} layers {n} (ranks)": run["launches"]
                  for n, run in fsdp_a["runs"].items()}
    lstm_src = "src/repro_torch/kernels/csrc/lstm_cell.cu"
    kernels = [
        _kernel_entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:33",
                      launches["flash_attention"], rows,
                      launches_by_path={"serve llama3_2_1b": launches["flash_attention"],
                                        "serve llama3_2_1b continuous":
                                            cont_launches["flash_attention"],
                                        "serve granite_moe_1b_a400m":
                                            moe_launches["flash_attention"],
                                        "train llama3_2_1b": llama_launches["flash_attention"],
                                        "train smollm_360m dp=2,pipe=2 (ranks)":
                                            rank_runs["c"]["launches"]["flash_attention"],
                                        "train llama3_2_1b context ring of 2 (ranks)":
                                            context_run["launches"]["flash_attention"],
                                        **_tp_paths(tp_runs, "flash_attention"),
                                        **{f"serve llama3_2_1b continuous {n} (ranks)":
                                               sum(run["launches_per_rank"])
                                           for n, run in shard_runs.items()},
                                        **{f"serve llama3_2_1b router 2 replicas {n}":
                                               router_runs[n]["launches"]["flash_attention"]
                                           for n in ("none", "kill", "nanlogits", "stall")},
                                        "serve llama3_2_1b router --fault kill@5:0 (process)":
                                            router_runs["launcher"]["launches"],
                                        "serve llama3_2_1b 2 layers f32 router 2 x tp 2 "
                                        "kill (ranks)": router_runs["ranks"]["launches"],
                                        **_ckpt_paths(ckpt_runs, "flash_attention"),
                                        **_by_path(paper_paths, "flash_attention")},
                      variant_launches_by_path={
                          "serve llama3_2_1b": variants["flash_attention"],
                          "serve llama3_2_1b continuous": cont_variants["flash_attention"],
                          "serve granite_moe_1b_a400m": moe_variants["flash_attention"],
                          "train llama3_2_1b": llama_variants["flash_attention"],
                          "train llama3_2_1b context ring of 2 (ranks)":
                              context_run["variant_launches"]["flash_attention"],
                          **_tp_paths(tp_runs, "flash_attention", "variant_launches"),
                          **{f"serve llama3_2_1b router 2 replicas {n}":
                                 router_runs[n]["flash_variants"]
                             for n in ("none", "kill", "nanlogits", "stall")}}),
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
                          **_ckpt_paths(ckpt_runs, "flash_attention_bwd"),
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
                          **_by_path(paper_paths, "lstm_cell_fwd"),
                          **_by_path(rnn_tp_paths, "lstm_cell_fwd")}),
        _kernel_entry("lstm_cell_fwd_gx", lstm_src, "src/repro/kernels/lstm_cell.py:24",
                      rnn_tp["a_biglstm_overlapped"]["launches"]["lstm_cell_fwd_gx"], gx_rows,
                      variant_launches=rnn_tp["a_biglstm_overlapped"]["variant_launches"][
                          "lstm_cell_fwd_gx"],
                      launches_by_path=_by_path(rnn_tp_paths, "lstm_cell_fwd_gx"),
                      note="the forward kernel's gx entry (x @ Wx precomputed on the "
                           "overlapped layer's gather ring), the step of JAX's "
                           "lstm_layer_overlapped (src/repro/models/lstm.py:81), whose "
                           "recurrence is plain ops there"),
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
                          **_by_path(paper_paths, "lstm_cell_bwd_pointwise"),
                          **_by_path(rnn_tp_paths, "lstm_cell_bwd_pointwise")},
                      note="no TPU backward kernel: JAX differentiates the plain cell "
                           "(src/repro/models/lstm.py:53)"),
        _kernel_entry("gmm", "src/repro_torch/kernels/csrc/moe_gmm.cu",
                      "src/repro/kernels/moe_gmm.py:23", moe_launches["gmm"], gmm_rows,
                      variant_launches=moe_variants["gmm"],
                      launches_by_path={"serve granite_moe_1b_a400m": moe_launches["gmm"],
                                        "train granite_moe_1b_a400m": granite_launches["gmm"],
                                        **_by_path(paper_paths, "gmm")},
                      variant_launches_by_path={
                          "serve granite_moe_1b_a400m": moe_variants["gmm"],
                          "train granite_moe_1b_a400m": granite_variants["gmm"],
                          "train granite_moe_1b_a400m --parallel auto --devices 8 (ranks)":
                              ep_run["variant_launches"]["gmm"]}),
        _kernel_entry("gmm_bwd", "src/repro_torch/kernels/csrc/moe_gmm.cu",
                      "src/repro/models/moe.py:92", granite_launches["gmm_bwd"], gmm_bwd_rows,
                      library=gmm_bwd_rows[0]["library"],
                      variant_launches=granite_variants["gmm_bwd"],
                      launches_by_path={"train granite_moe_1b_a400m":
                                            granite_launches["gmm_bwd"],
                                        "serve granite_moe_1b_a400m": moe_launches["gmm_bwd"],
                                        **_by_path(paper_paths, "gmm_bwd")},
                      note="no TPU backward kernel: JAX differentiates the expert einsums "
                           "(src/repro/models/moe.py:92-94) of the gmm kernel "
                           "(src/repro/kernels/moe_gmm.py:23)"),
        _kernel_entry("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                      "src/repro/kernels/rwkv_scan.py:25", rwkv_launches["wkv6"], wkv_rows,
                      library=wkv_rows[0]["library"], variant_launches=rwkv_variants["wkv6"],
                      launches_by_path={"serve rwkv6_7b": rwkv_launches["wkv6"],
                                        f"train rwkv6_7b {RWKV_LAYERS} layers":
                                            rwkv_train_launches["wkv6"],
                                        **_by_path(paper_paths, "wkv6"),
                                        **_by_path(rnn_tp_paths, "wkv6"),
                                        **_by_path(fsdp_paths, "wkv6")},
                      variant_launches_by_path={
                          "serve rwkv6_7b": rwkv_variants["wkv6"],
                          f"train rwkv6_7b {RWKV_LAYERS} layers": rwkv_train_variants["wkv6"]}),
        _kernel_entry("wkv6_bwd", "src/repro_torch/kernels/csrc/wkv6.cu",
                      "src/repro/models/rwkv.py:69", rwkv_train_launches["wkv6_bwd"],
                      wkv_bwd_rows, library=wkv_bwd_rows[0]["library"],
                      launches_by_path={f"train rwkv6_7b {RWKV_LAYERS} layers":
                                            rwkv_train_launches["wkv6_bwd"],
                                        "serve rwkv6_7b": rwkv_launches["wkv6_bwd"],
                                        **_by_path(paper_paths, "wkv6_bwd"),
                                        **_by_path(rnn_tp_paths, "wkv6_bwd"),
                                        **_by_path(fsdp_paths, "wkv6_bwd")},
                      note="no TPU backward kernel: JAX differentiates the scan "
                           "(src/repro/models/rwkv.py:69, wkv_scan) of the wkv kernel "
                           "(src/repro/kernels/rwkv_scan.py:25)"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
