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
    python -m repro_torch.launch.serve --arch llama3_2_1b --continuous --tp 2 \
        --slots 8 --prefill-chunk 256 --batch 8 --prompt-len 512 --max-new 16

Runs on the card by default; ``--device cpu --reduced`` is the CPU smoke run.
The static path prints prefill ms, decode ms per step and generated tokens
per second, the continuous one tokens per second, ticks and ms a tick; then
the launches of each kernel during ``generate`` (``[kernels]``; zero on the
CPU, where the plain twins run) and of each variant of the flash-attention,
grouped-matmul and WKV kernels (``[variants]``: FMA, tensor-core prefill and
decode tiles; the WKV scan and its chunked form).

``--continuous --tp N`` serves on ranks (``run_continuous``): JAX's mesh of
(devices / N, N), clamped to the ranks there are (one data group on one
card, whose N ranks share it), started by ``parallel.dist.spawn_ranks``;
each rank runs the engine on its part of the weights and the slot cache,
the tick and the prefill chunks on the tensor-MP rings.  Rank 0's line
carries ``tp=`` and the ``[kernels]`` counts are summed over the ranks.
The context-parallel chunk is the engine's ``context_axis``, which the
rank function takes and the command line does not (JAX's launcher has no
such flag).

``--continuous`` with ``--replicas N`` (N > 1), ``--fault`` or
``--max-queue`` serves through ``serve.router.ReplicaRouter`` (JAX's
condition): N engine replicas behind least-loaded dispatch, a replica-keyed
fault schedule (``kill@5:0``, ``stall@7:1:0.5``, ``nanlogits@9:0``), a bound
on each replica's queue and, with ``--watchdog SECS``, a health watchdog
(alone, ``--watchdog`` is refused: it watches a router's replicas)::

    python -m repro_torch.launch.serve --arch llama3_2_1b --continuous \
        --replicas 2 --slots 8 --prefill-chunk 256 --batch 16 --prompt-len 512 \
        --max-new 32 --fault kill@5:0

At ``--tp 1`` the replicas share this process, its card and one weight
tree; with ``--tp N`` each replica is a tensor-MP group of N ranks
(``run_router``: replicas x N ranks, sharing the card where cards are
fewer).  Rank 0 prints JAX's ``[serve] router:`` line, then the ticks of
the router and the decode ticks and prefill chunks of every engine it ran
(dead ones included); the ``[kernels]`` counts are those engines' launches,
summed over the ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.api import build_model
from repro_torch.parallel import dist as D
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.router import ReplicaRouter
from repro_torch.train.fault import parse_fault_schedule


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
                    help="tensor-MP ways of the continuous engine's tick and chunks (ranks)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="continuous-engine replicas (tp ranks each) behind the "
                    "fault-tolerant router")
    ap.add_argument("--fault", default="",
                    help="replica-keyed fault schedule, e.g. "
                    "'kill@5:0, stall@7:1:0.5, nanlogits@9:0'")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound on queued requests per replica; overflow is shed "
                    "(0 = unbounded)")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    help="router health watchdog seconds (0 = off)")
    args = ap.parse_args(argv)
    router = bool(args.replicas > 1 or args.fault or args.max_queue)
    if (args.tp > 1 or router) and not args.continuous:
        raise SystemExit("--tp, --replicas, --fault and --max-queue serve through the "
                         "continuous engine: add --continuous")
    if args.watchdog and not router:
        raise SystemExit("--watchdog watches the replicas of a router: add --replicas N "
                         "(N > 1), --fault or --max-queue")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.tp > 1:
        return _router_ranks(args, cfg) if router else _continuous_ranks(args, cfg)
    api = build_model(cfg, device=args.device)
    params = api.init(args.seed)
    tokens = _prompts(args, cfg).to(api.device)

    counters = {"flash_attention": fa.flash_attention, "gmm": moe_gmm.gmm, "wkv6": wk.wkv6}
    before = {name: fn.launches for name, fn in counters.items()}
    by_variant = {name: dict(fn.variant_launches) for name, fn in counters.items()
                  if hasattr(fn, "variant_launches")}
    if router:
        res = _router(args, cfg, api, params, tokens)
    elif args.continuous:
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


def _prompts(args, cfg):
    gen = torch.Generator().manual_seed(args.seed)
    return torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen)


def continuous_rank(mesh, spec):
    """One rank of a continuous run on ranks: the model of ``spec["cfg"]``
    from ``spec["seed"]`` on this rank's device, then for each engine
    keyword set of ``spec["runs"]`` (``model_axis``, ``comm_chunks``,
    ``context_axis``, ``window``) one ``ContinuousEngine`` over ``spec``'s
    slots, capacity and prefill chunk, run on ``spec["requests"]``.
    Returns, per run, the results (as dicts), the wall seconds, the tick
    and chunk counts, the host ms a tick (sum, min, max), the kernel
    launches of the run and its peak device GiB (None on the CPU)."""
    cfg = spec["cfg"]
    api = build_model(cfg, device=mesh.device)
    params = api.init(spec["seed"])
    counters = {"flash_attention": fa.flash_attention, "gmm": moe_gmm.gmm, "wkv6": wk.wkv6}
    cuda = mesh.device.type == "cuda"
    outs = []
    for run in spec["runs"]:
        eng = ContinuousEngine(api, params, n_slots=spec["slots"], capacity=spec["capacity"],
                               prefill_chunk=spec["prefill_chunk"],
                               temperature=spec.get("temperature", 0.0), seed=spec["seed"],
                               mesh=mesh, batch_axes=("data",), **run)
        before = {n: fn.launches for n, fn in counters.items()}
        variants = dict(fa.flash_attention.variant_launches)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = eng.run(spec["requests"])
        wall = time.perf_counter() - t0
        outs.append({
            "run": run, "results": [dataclasses.asdict(r) for r in results], "wall_s": wall,
            "ticks": eng.ticks, "decode_ticks": eng.decode_ticks,
            "prefill_chunks": eng.prefill_chunks, "tick_ms_sum": eng.tick_ms_sum,
            "tick_ms_min": eng.tick_ms_min, "tick_ms_max": eng.tick_ms_max,
            "launches": {n: fn.launches - before[n] for n, fn in counters.items()},
            "flash_variants": {v: c - variants[v]
                               for v, c in fa.flash_attention.variant_launches.items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None})
        del eng
    return outs


def run_continuous(spec, *, tp: int, device="cuda", timeout_s: float = D.DEFAULT_TIMEOUT_S):
    """``continuous_rank`` on JAX's serving mesh of (devices / tp, tp) ranks,
    clamped to the ranks there are: one data group of ``tp`` ranks on one
    card or on the CPU, devices / tp groups of a card a rank otherwise.
    Returns (dp, every rank's ``continuous_rank`` result in rank order)."""
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    dp = max(1, cards // tp)
    outs = D.spawn_ranks(continuous_rank, dp * tp, device=device, args=(spec,), stages=tp,
                         timeout_s=timeout_s)
    return dp, outs


def _continuous_ranks(args, cfg):
    """``--continuous --tp N``: every prompt a request, through the engine on
    ranks (``run_continuous``); rank 0's run printed with ``tp=``, the
    launches summed over the ranks."""
    tokens = _prompts(args, cfg)
    spec = {"cfg": cfg, "seed": args.seed, "slots": args.slots,
            "capacity": args.prompt_len + args.max_new + 8,
            "prefill_chunk": args.prefill_chunk, "temperature": args.temperature,
            "requests": _requests(args, tokens),
            "runs": [{"model_axis": "model"}]}
    dp, outs = run_continuous(spec, tp=args.tp, device=args.device)
    first = outs[0][0]
    toks = sum(len(r["tokens"]) for r in first["results"])
    dt = first["wall_s"]
    print(f"[serve] continuous {cfg.name} on {args.device}: requests={args.batch} "
          f"slots={args.slots} prompt={args.prompt_len} new={args.max_new} "
          f"chunk={args.prefill_chunk} tp={args.tp} dp={dp}  {toks} tokens in {dt:.3f} s "
          f"({toks / dt:.1f} tok/s)  ticks={first['ticks']} "
          f"decode_ticks={first['decode_ticks']} prefill_chunks={first['prefill_chunks']}  "
          f"{first['tick_ms_sum'] / max(first['decode_ticks'], 1):.3f} ms/tick")
    print("first sequence:", first["results"][0]["tokens"])
    _print_launches([o[0] for o in outs])
    return outs


def _continuous(args, cfg, api, params, tokens):
    """Every prompt a request, through ``ContinuousEngine``; the wall time
    ends with the last request's tokens on the host."""
    capacity = args.prompt_len + args.max_new + 8
    engine = ContinuousEngine(api, params, n_slots=args.slots, capacity=capacity,
                              prefill_chunk=args.prefill_chunk,
                              temperature=args.temperature, seed=args.seed)
    t0 = time.perf_counter()
    results = engine.run(_requests(args, tokens))
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


def _router_kw(args):
    """The router's arguments from the command line (JAX's capacity)."""
    return dict(n_slots=args.slots, capacity=args.prompt_len + args.max_new + 8,
                prefill_chunk=args.prefill_chunk, temperature=args.temperature,
                seed=args.seed, max_queue=args.max_queue or None,
                faults=parse_fault_schedule(args.fault) if args.fault else (),
                watchdog_timeout_s=args.watchdog or None)


def _requests(args, tokens):
    """Every prompt a request of ``--max-new`` tokens."""
    return [Request(rid=i, tokens=tokens[i].tolist(), max_new_tokens=args.max_new)
            for i in range(args.batch)]


def _print_router(args, run):
    """JAX's ``[serve] router:`` line of ``run`` (a ``router_rank`` result),
    then the router's ticks and every engine's decode ticks and chunks."""
    toks = sum(len(r["tokens"]) for r in run["results"])
    dt, stats = run["wall_s"], run["stats"]
    print(f"[serve] router: {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"replicas={args.replicas}, tp={args.tp}, completed={stats['completed']}, "
          f"shed={stats['shed']}, timed_out={stats['timed_out']}, "
          f"failovers={stats['failovers']}, states={run['states']})  "
          f"ticks={run['ticks']} decode_ticks={run['decode_ticks']} "
          f"prefill_chunks={run['prefill_chunks']}")
    print("first sequence:", run["results"][0]["tokens"])


def _serve_router(router, requests, cuda):
    """``router.run(requests)`` timed, as a ``router_rank`` result without
    the launches."""
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = router.run(requests)
    finally:
        router.close()
    return {"results": [dataclasses.asdict(r) for r in results],
            "wall_s": time.perf_counter() - t0, "stats": dict(router.stats),
            "states": router.replica_states, "fault_log": list(router.fault_log),
            "ticks": router.ticks, "decode_ticks": router.decode_ticks,
            "prefill_chunks": router.prefill_chunks,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}


def router_rank(mesh, spec):
    """One rank of a router run on replica groups: the model of
    ``spec["cfg"]`` from ``spec["seed"]`` on this rank's device, a
    ``ReplicaRouter`` of ``mesh.shape["data"]`` replicas of
    ``mesh.shape["model"]`` tensor-MP ranks with ``spec["router"]``'s
    arguments, run on ``spec["requests"]``.  Returns the results (as
    dicts), the wall seconds, stats, replica states, fault log, the router's
    ticks and its engines' decode ticks and chunks, this rank's kernel
    launches of the run (per flash variant too) and its peak device GiB
    (None on the CPU)."""
    cfg = spec["cfg"]
    api = build_model(cfg, device=mesh.device)
    params = api.init(spec["seed"])
    counters = {"flash_attention": fa.flash_attention, "gmm": moe_gmm.gmm, "wkv6": wk.wkv6}
    before = {n: fn.launches for n, fn in counters.items()}
    variants = dict(fa.flash_attention.variant_launches)
    router = ReplicaRouter(api, params, replicas=mesh.shape["data"], mesh=mesh,
                           log_fn=print if mesh.rank == 0 else (lambda m: None),
                           **spec["router"])
    out = _serve_router(router, spec["requests"], mesh.device.type == "cuda")
    out["launches"] = {n: fn.launches - before[n] for n, fn in counters.items()}
    out["flash_variants"] = {v: c - variants[v]
                             for v, c in fa.flash_attention.variant_launches.items()}
    return out


def run_router(spec, *, replicas: int, tp: int, device="cuda",
               timeout_s: float = D.DEFAULT_TIMEOUT_S):
    """``router_rank`` on replicas x tp ranks (``spawn_ranks`` with
    ``stages=tp``: replica r is the ranks r tp ... r tp + tp - 1), which
    share the card where cards are fewer.  Returns every rank's result in
    rank order."""
    return D.spawn_ranks(router_rank, replicas * tp, device=device, args=(spec,), stages=tp,
                         timeout_s=timeout_s)


def _print_launches(outs):
    first = outs[0]
    launched = {n: sum(o["launches"][n] for o in outs) for n in first["launches"]}
    variants = {v: sum(o["flash_variants"][v] for o in outs) for v in first["flash_variants"]}
    print("[kernels] " + " ".join(f"{n}={c}" for n, c in launched.items()))
    print("[variants] flash_attention: " + " ".join(f"{v}={c}" for v, c in variants.items()))


def _router_ranks(args, cfg):
    """``--continuous --tp N`` with a router: ``--replicas`` groups of N
    ranks (``run_router``); rank 0's run printed, the launches summed over
    the ranks."""
    spec = {"cfg": cfg, "seed": args.seed, "router": _router_kw(args),
            "requests": _requests(args, _prompts(args, cfg))}
    outs = run_router(spec, replicas=args.replicas, tp=args.tp, device=args.device)
    _print_router(args, outs[0])
    _print_launches(outs)
    return outs


def _router(args, cfg, api, params, tokens):
    """The router in this process: ``--replicas`` engines sharing the
    device and the weights."""
    router = ReplicaRouter(api, params, replicas=args.replicas, log_fn=print,
                           **_router_kw(args))
    run = _serve_router(router, _requests(args, tokens), api.device.type == "cuda")
    _print_router(args, run)
    return run


if __name__ == "__main__":
    main()
