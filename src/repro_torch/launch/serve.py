"""Serving launcher (port of ``repro/launch/serve.py``): initialise a model
from a seed and decode a batch of random prompts, as one static batch or,
with ``--continuous``, as requests through the continuous-batching engine
(``serve.continuous``: ``--slots`` request slots, prefill chunks of
``--prefill-chunk`` tokens interleaved with decode ticks)::

    python -m repro_torch.launch.serve --arch llama3_2_1b \
        --batch 4 --prompt-len 512 --max-new 32
    python -m repro_torch.launch.serve --arch granite_moe_1b_a400m \
        --batch 4 --prompt-len 512 --max-new 32
    python -m repro_torch.launch.serve --arch rwkv6_7b \
        --batch 4 --prompt-len 512 --max-new 32
    python -m repro_torch.launch.serve --arch granite_moe_1b_a400m --reduced --device cpu
    python -m repro_torch.launch.serve --arch llama3_2_1b --continuous \
        --slots 4 --prefill-chunk 128 --batch 8 --prompt-len 512 --max-new 32

Runs on the card by default; ``--device cpu --reduced`` is the CPU smoke run.
The static path prints prefill ms, decode ms per step and generated tokens
per second, the continuous one tokens per second, ticks and ms a tick; then
the launches of each kernel during ``generate`` (``[kernels]``; zero on the
CPU, where the plain twins run) and of each variant of the flash-attention,
grouped-matmul and WKV kernels (``[variants]``: FMA, tensor-core prefill and
decode tiles; the WKV scan and its chunked form).  The tensor-MP tick
(``--tp`` > 1) is ROADMAP.md Queue 1 item 7b, the multi-replica router
(``--replicas``, ``--fault``, ``--max-queue``, ``--watchdog``) item 10.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.api import build_model
from repro_torch.models.transformer import SERVING_TP, unported
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.serve.engine import ServeEngine

ROUTER = "ROADMAP.md Queue 1 item 10 (multi-replica serving: serve/router.py)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continuous", action="store_true",
                    help="slotted continuous-batching engine")
    ap.add_argument("--slots", type=int, default=4,
                    help="request slots (continuous engine)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="max prompt tokens per prefill step (0 = one shot)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-MP ways for the decode tick (item 7b)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind a router (item 10)")
    ap.add_argument("--fault", default="", help="replica fault schedule (item 10)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound on queued requests per replica (item 10)")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    help="router health watchdog seconds (item 10)")
    args = ap.parse_args(argv)
    if args.tp > 1:
        raise unported("the tensor-MP serving tick (--tp > 1)", SERVING_TP)
    if args.replicas > 1 or args.fault or args.max_queue or args.watchdog:
        raise unported("the multi-replica router (--replicas, --fault, --max-queue, "
                       "--watchdog)", ROUTER)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device=args.device)
    params = api.init(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(api.device)

    counters = {"flash_attention": fa.flash_attention, "gmm": moe_gmm.gmm, "wkv6": wk.wkv6}
    before = {name: fn.launches for name, fn in counters.items()}
    by_variant = {name: dict(fn.variant_launches) for name, fn in counters.items()
                  if hasattr(fn, "variant_launches")}
    if args.continuous:
        res = _continuous(args, cfg, api, params, tokens)
    else:
        res = _static(args, cfg, api, params, tokens)
    launched = " ".join(f"{name}={fn.launches - before[name]}"
                        for name, fn in counters.items())
    variants = "; ".join(
        f"{name}: " + " ".join(f"{v}={n - by_variant[name][v]}"
                               for v, n in counters[name].variant_launches.items())
        for name in by_variant)
    print(f"[kernels] {launched}")
    print(f"[variants] {variants}")
    return res


def _static(args, cfg, api, params, tokens):
    engine = ServeEngine(api, params, temperature=args.temperature, seed=args.seed)
    res = engine.generate({"tokens": tokens}, max_new_tokens=args.max_new)
    toks = args.batch * args.max_new
    step_ms = res.decode_ms / max(res.decode_steps, 1)
    total_s = (res.prefill_ms + res.decode_ms) / 1e3
    print(f"[serve] {cfg.name} on {api.device}: batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new}  "
          f"prefill {res.prefill_ms:.3f} ms  decode {step_ms:.3f} ms/step  "
          f"{toks / total_s:.1f} tok/s")
    print("first sequence:", res.tokens[0].tolist())
    return res


def _continuous(args, cfg, api, params, tokens):
    """Every prompt a request, through ``ContinuousEngine``; the wall time
    ends with the last request's tokens on the host."""
    capacity = args.prompt_len + args.max_new + 8
    engine = ContinuousEngine(api, params, n_slots=args.slots, capacity=capacity,
                              prefill_chunk=args.prefill_chunk,
                              temperature=args.temperature, seed=args.seed)
    reqs = [Request(rid=i, tokens=tokens[i].tolist(), max_new_tokens=args.max_new)
            for i in range(args.batch)]
    t0 = time.perf_counter()
    results = engine.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    tick_ms = engine.tick_ms_sum / max(engine.decode_ticks, 1)
    print(f"[serve] continuous {cfg.name} on {api.device}: requests={args.batch} "
          f"slots={args.slots} prompt={args.prompt_len} new={args.max_new} "
          f"chunk={args.prefill_chunk}  {toks} tokens in {dt:.3f} s "
          f"({toks / dt:.1f} tok/s)  ticks={engine.ticks} "
          f"decode_ticks={engine.decode_ticks} prefill_chunks={engine.prefill_chunks}  "
          f"{tick_ms:.3f} ms/tick")
    print("first sequence:", results[0].tokens)
    return results


if __name__ == "__main__":
    main()
