"""Training launcher (port of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch biglstm --steps 5
    python -m repro_torch.launch.train --arch llama3_2_1b --batch 4 --seq 2048 --steps 5
    python -m repro_torch.launch.train --arch biglstm --reduced --device cpu --steps 3
    python -m repro_torch.launch.train --arch biglstm --parallel dp=1,mp=1,accum=2
    python -m repro_torch.launch.train --arch biglstm --parallel pipe=2,micro=4,sched=1f1b
    python -m repro_torch.launch.train --arch smollm_360m --batch 8 --seq 512 \
        --parallel dp=2,pipe=2,micro=2,sched=1f1b --max-local-devices 4
    python -m repro_torch.launch.train --arch biglstm --parallel auto --devices 64
    python -m repro_torch.launch.train --arch llama3_2_1b --parallel cp=2 --batch 2 --seq 2048
    python -m repro_torch.launch.train --arch llama3_2_1b --parallel auto --devices 8 \
        --batch 2 --seq 2048
    python -m repro_torch.launch.train --arch llama3_2_1b --parallel mp=2 \
        --comm-runtime overlapped --comm-chunks 2 --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch biglstm --parallel mp=2 \
        --comm-runtime overlapped --comm-chunks 2 --steps 2
    python -m repro_torch.launch.train --arch granite_moe_1b_a400m --parallel auto \
        --devices 8 --batch 4 --seq 2048 --steps 2

Feeds the JAX launcher's data (the order-2 Markov LM over min(V, 64)
symbols) with its optimizer, AdamW over ``warmup_cosine(lr, 20, steps)``
with the global-norm clip at 1.0, from a seeded init, and prints the JAX
launcher's ``[data]`` and ``[done]`` lines, then the launch count of each
kernel (``[kernels]``; zero on the CPU, where the plain twins run) and of
each variant of the LSTM forward, the flash-attention forward and backward,
the grouped matmul's forward and its backward products and the WKV
recurrence (``[variants]``).  Runs on the card by default; ``--device cpu
--reduced`` is the CPU smoke run.

``--parallel auto`` runs the paper's HybridPlanner (``core.planner``, on the
H100 ``HardwareModel``) over a budget of ``--devices`` cards (default 256,
as in JAX) and prints the JAX launcher's ``[planner]`` line.  Explicit specs
take ``dp=N,mp=M[,accum=A]`` (DP x M-way tensor MP, with the §4.2
accumulation), ``pipe=S[,micro=K,sched=gpipe|1f1b|interleaved,v=V,dp=N]``
(DP x pipeline MP) and ``cp=M[,dp=N,accum=A]`` (DP x a context ring of M
ranks).  As in JAX, the DP degree is clamped to what
``--max-local-devices`` affords (default: the cards on ``cuda``, 8 on the
CPU) and must divide the batch, model axes (stages, rings, tensor MP) are
always realised, and the micro-batch count is clamped to divide each
replica's rows.  ``--comm-runtime gspmd|overlapped`` picks a tensor plan's
collectives (monolithic all-reduces, or the chunked collective-matmul rings
with ``--comm-chunks`` chunks) and a DP plan's gradient sync; a context plan
needs ``--seq`` divisible by the ring and takes neither flag (the ring is
its comm schedule), and ``--comm-chunks`` needs ``overlapped``, as in JAX.
A run of more than one rank starts dp x M ``torch.distributed`` ranks
(``parallel.dist.spawn_ranks``); where there are fewer cards than ranks
they share the cards and their messages cross host memory, which the
``[dist]`` line says.  Every rank builds the same seeded data and takes its
DP shard (and a ring rank its T/m columns); a pipelined rank holds only its
stage's parameters, a tensor-MP rank its part of each, a ring rank all of
them.  Rank 0 prints ``[data]``, ``[dist]``, ``[done]`` and the
``[kernels]`` / ``[variants]`` counts summed over the ranks; the launcher
then prints each rank's peak device memory, pipeline store high-water mark
and kernel launches (``[ranks]``, each rank's stage, place on the ring or
on the model axis, and its memory allocated after its last step: the
resident state).  Tensor MP trains the dense, MoE and RWKV decoders and
BigLSTM (``--parallel mp=2``; with ``--comm-runtime overlapped`` BigLSTM's
layers run JAX's overlapped LSTM layer, and RWKV and an MoE model warn and
run the gspmd form, as JAX does); an MoE model's experts are split over the
model axis (expert parallelism: each rank's on ``gmm``), which must divide
them.  ``--pipe-runtime ad`` raises NotImplementedError naming ROADMAP.md
Queue 1 item 6b.  A
planner's plan that shards the parameters and optimizer state over DP
(``+fsdp`` in the ``[plan]`` line; its ``("pod", "data")`` narrows to the
ranks' ``data`` axis) runs so on the ranks (``train.steps``), where the JAX
launcher drops ``fsdp_axes``: the numbers are those of plain DP, and each
rank holds 1/dp of the sharded state.  The step gathers the whole tree and
keeps full-size gradients, so a run whose step cannot fit a rank's memory
(``fsdp_step_bytes``: the planner's full-depth RWKV6-7B and StableLM-12B
plans) exits naming ROADMAP.md Queue 1 item 23.

Fault tolerance, as in JAX: ``--ckpt-dir``/``--ckpt-every`` write
CRC-manifested checkpoints of the global state in JAX's v2 format
(``--keep-last`` retention, ``--background-save`` off the step path) with a
guaranteed final checkpoint; on ranks every rank gathers and rank 0 writes.
``--resume`` restores the newest valid one and cuts this run's parts out of
it, so a run saved at one plan resumes on another (``dp=2`` onto one
process, pipeline stages onto one process); a bare ``--resume`` keeps the
default plan and ``--parallel auto --resume`` re-runs the planner for
``--devices`` or ``--max-local-devices``.  ``--fault`` injects a seeded
failure schedule (``train.fault``; a ``kill`` exits 17, on ranks too),
``--max-retries`` bounds in-place step retries, ``--max-restarts`` runs the
loop under the checkpoint-restoring supervisor and ``--watchdog`` flags hung
steps (start the kill run on an empty ``--ckpt-dir``: a resume restores the
newest file it finds there):

    python -m repro_torch.launch.train --arch llama3_2_1b --reduced --device cpu \
        --steps 12 --ckpt-dir "$TMPDIR/ck" --ckpt-every 5 --fault kill@9  # exits 17
    python -m repro_torch.launch.train --arch llama3_2_1b --reduced --device cpu \
        --steps 12 --ckpt-dir "$TMPDIR/ck" --ckpt-every 5 --resume

On the card
every decoder and BigLSTM train through the hand-written kernels, forward
and backward (an MoE decoder through ``gmm`` and ``gmm_bwd``, RWKV through
``wkv6`` and ``wkv6_bwd``); on the CPU through the kernels' plain versions.
GNMT and Inception-V3 need source/target
pairs and images, which this launcher (like JAX's) does not feed: it
refuses them, and they train through ``models.api.build_model`` +
``train.steps.make_train_step``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time
from typing import Dict, Tuple

import torch

from repro_torch.checkpoint import restore_latest_valid, wait_for_saves
from repro_torch.configs import get_config
from repro_torch.core.comm import HardwareModel
from repro_torch.core.planner import HybridPlanner, default_epoch_model, per_device_mem_bytes
from repro_torch.data import DataPipeline, make_lm_dataset
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.api import (build_model, pipeline_applicable, resolve_device,
                                    supports_pipeline)
from repro_torch.models.transformer import cp_arch_supported
from repro_torch.optim import OPTIMIZERS, warmup_cosine
from repro_torch.parallel import dist as D
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.train.fault import FaultInjector, parse_fault_schedule, run_supervised
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import (check_plan, checkpoint_saver, eval_train_state,
                                     init_train_state, make_train_step, place_state)
from repro_torch.tree import tree_map

SPEC_KEYS = ("dp", "mp", "accum", "pipe", "micro", "sched", "v", "cp")
DEFAULT_DEVICES = 256


def parse_parallel(spec: str, devices: int, cfg, comm_runtime: str = "gspmd",
                   context_parallel: bool = False) -> Tuple[ParallelPlan, int, int]:
    """Resolve a --parallel spec to (plan, mp_degree, dp_hint), as the JAX
    launcher's ``parse_parallel``: ``auto`` runs the planner over
    ``devices`` (``comm_runtime`` keys its overlap terms,
    ``context_parallel`` keeps only context points); an explicit spec reads
    its ``dp=/mp=/accum=``, ``pipe=/micro=/sched=/v=`` or ``cp=`` keys.  A
    key the JAX launcher does not know exits naming the keys it knows."""
    if spec == "auto":
        planner = HybridPlanner(cfg, epoch_model=default_epoch_model(cfg),
                                comm_runtime=comm_runtime)
        choices = planner.choices(devices)
        if context_parallel:
            choices = [c for c in choices if c.mp_kind == "context"]
            if not choices:
                raise SystemExit(
                    f"[planner] no memory-feasible context-parallel strategy "
                    f"for {cfg.name} at {devices} devices (needs the dense "
                    f"decoder CP path and a ring that divides the sequence)")
        if not choices:
            raise SystemExit(f"[planner] no memory-feasible strategy for "
                             f"{cfg.name} at {devices} devices")
        choice = next((c for c in choices if c.mp_kind != "pipeline"
                       or supports_pipeline(cfg)), None)
        if choice is None:
            choice = choices[0]
        if choice is not choices[0]:
            print(f"[planner] best plan ({choices[0].mp_kind}) lacks runtime "
                  f"support for {cfg.name}; using next feasible choice")
        print(f"[planner] {choice.mesh_shape} kind={choice.mp_kind} "
              f"sched={choice.schedule} micro={choice.microbatches} "
              f"SU={choice.speedup:.1f} "
              f"(SU^M={choice.su_m:.2f}, SE_N={choice.se_n:.3f}, "
              f"E1/EN={choice.epochs_ratio:.3f}, "
              f"mem={choice.mem_bytes / 2**30:.2f} GiB)")
        return choice.plan, choice.mp, choice.pods * choice.dp
    try:
        kv = dict(p.split("=") for p in spec.split(","))
        unknown = sorted(set(kv) - set(SPEC_KEYS))
        if unknown:
            raise SystemExit(f"[plan] --parallel keys {unknown} are unknown: the JAX launcher "
                             f"reads only {', '.join(SPEC_KEYS)} (and ignores the rest)")
        pipe = int(kv.get("pipe", 0))
        cp = int(kv.get("cp", 0))
        if context_parallel and cp <= 1:
            cp = int(kv.pop("mp", 0))         # --context-parallel: mp= is the ring
        if cp > 1:
            if pipe > 1 or int(kv.get("mp", 1)) > 1:
                raise SystemExit(
                    "[plan] cp= is its own model axis: it cannot combine with "
                    "mp= (tensor) or pipe= (pipeline) in one spec")
            plan = ParallelPlan(dp_axes=("data",), model_axis="model",
                                mp_kind="context",
                                microbatches=int(kv.get("accum", 1)))
            return plan, cp, int(kv.get("dp", 1))
        if pipe > 1:
            sched = kv.get("sched", "gpipe")
            v = int(kv.get("v", 2 if sched == "interleaved" else 1))
            if (sched == "interleaved") != (v > 1):
                raise SystemExit(
                    f"[plan] sched={sched} incompatible with v={v} "
                    f"(interleaved needs v>=2; gpipe/1f1b take v=1)")
            plan = ParallelPlan(dp_axes=("data",), model_axis="model",
                                mp_kind="pipeline",
                                microbatches=int(kv.get("micro", 4)),
                                schedule=sched, virtual_stages=v)
            return plan, pipe, int(kv.get("dp", 1))
        mp = int(kv.get("mp", 1))
        plan = ParallelPlan(dp_axes=("data",),
                            model_axis="model" if mp > 1 else None,
                            microbatches=int(kv.get("accum", 1)))
        return plan, mp, int(kv.get("dp", 1))
    except ValueError:
        raise SystemExit(f"[plan] cannot parse --parallel {spec!r}") from None


def clamp_dp(dp_hint: int, mp: int, batch: int, max_local: int, what: str) -> int:
    """Realise as much of the plan's DP degree as the local budget of
    ``max_local`` ranks affords, as the JAX launcher's ``clamp_dp``: dp must
    also divide the batch (it is sharded over "data")."""
    dp_cap = min(max(dp_hint, 1), max(1, max_local // mp))
    got = max(d for d in range(1, dp_cap + 1) if batch % d == 0)
    if got < dp_hint:
        print(f"[plan] clamped DP {dp_hint} -> {got} (local budget {max_local}, {what})")
    return got


def clamp_micro(plan: ParallelPlan, shard_rows: int) -> ParallelPlan:
    """The planner models micro-batches against its reference batch; the run
    uses the largest count up to the plan's that divides each replica's
    ``shard_rows``."""
    micro = max(k for k in range(1, min(plan.microbatches, shard_rows) + 1)
                if shard_rows % k == 0)
    if micro != plan.microbatches:
        print(f"[plan] clamped micro-batches {plan.microbatches} -> {micro} "
              f"(rows a replica={shard_rows})")
        plan = dataclasses.replace(plan, microbatches=micro)
    return plan


@dataclasses.dataclass(frozen=True)
class RankRun:
    """What a training run needs (pickled to the ranks of a multi-rank run)."""
    cfg: object
    plan: ParallelPlan
    steps: int
    batch: int
    seq: int
    lr: float
    device: str = "cuda"
    seed: int = 0
    return_params: bool = False
    # an MoE model's expert capacity (None: no drop); a rank's comes from
    # its own tokens, as in JAX, so DP ranks drop other tokens than one
    # process does
    capacity_factor: float | None = 1.25
    # the optimizer (``optim.OPTIMIZERS``) over the launcher's schedule; the
    # command line, as JAX's, trains with AdamW
    optimizer: str = "adamw"
    # checkpoints and faults (the JAX launcher's flags)
    ckpt_dir: str = ""
    ckpt_every: int = 100
    keep_last: int = 0
    background_save: bool = False
    resume: bool = False
    max_retries: int = 0
    max_restarts: int = 0
    watchdog: float = 0.0
    fault: str = ""


def _counter_fns():
    return {"lstm_cell_fwd": lc.lstm_cell_fwd, "lstm_cell_fwd_gx": lc.lstm_cell_fwd_gx,
            "lstm_cell_bwd_pointwise": lc.lstm_cell_bwd_pointwise,
            "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "gmm": moe_gmm.gmm, "gmm_bwd": moe_gmm.gmm_bwd,
            "wkv6": wk.wkv6, "wkv6_bwd": wk.wkv6_bwd}


def _launch_counts() -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
    fns = _counter_fns()
    variants = {n: dict(fns[n].variant_launches)
                for n in ("lstm_cell_fwd", "lstm_cell_fwd_gx", "flash_attention",
                          "flash_attention_bwd", "gmm", "gmm_bwd", "wkv6")}
    return {n: fn.launches for n, fn in fns.items()}, variants


def _print_counts(launches, variants) -> None:
    print("[kernels] " + " ".join(f"{n}={c}" for n, c in launches.items()))
    print("[variants] " + " | ".join(f"{n}: " + " ".join(f"{v}={c}" for v, c in vs.items())
                                     for n, vs in variants.items()), flush=True)


def _train(mesh, run: RankRun) -> dict:
    """The training run, in one process (``mesh`` None) or as one rank of a
    DP x pipeline run: its stage (or replica), its DP shard of the same
    seeded data, the loop; a rank's kernel counts are summed over the
    ranks.  One process returns the loop's summary with its ``state``."""
    device = resolve_device(run.device) if mesh is None else mesh.device
    api = build_model(run.cfg, device=device, capacity_factor=run.capacity_factor)
    lead = mesh is None or mesh.rank == 0
    data = make_lm_dataset(vocab=min(run.cfg.vocab_size, 64), seq_len=run.seq)
    if lead:
        print(f"[data] markov-lm entropy floor = {data.entropy:.4f} nats/token", flush=True)
    opt = OPTIMIZERS[run.optimizer](warmup_cosine(run.lr, 20, run.steps))
    step_fn = make_train_step(api, opt, clip_norm=1.0, mesh=mesh, plan=run.plan)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    step_ms, grad_norms, high_water, resident = [], [], [0], [0]

    def timed_step(st, batch):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = step_fn(st, batch)
        if cuda:
            torch.cuda.synchronize(device)
            resident[0] = torch.cuda.memory_allocated(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grad_norms.append(float(out[1]["grad_norm"]))
        high_water[0] = max(high_water[0], int(out[1].get("store_high_water", 0)))
        return out

    # one process feeds the card; a rank moves its own shard (train.steps)
    pipeline = DataPipeline(lambda e: data.epoch(e, run.batch),
                            device=api.device if mesh is None else None,
                            steps_per_epoch=data.steps_per_epoch(run.batch))
    summary = _loop(api, opt, mesh, run, timed_step, pipeline, lead)
    launches, variants = _launch_counts()
    own_launches = dict(launches)
    if mesh is not None:
        names = list(launches) + [(n, v) for n, vs in variants.items() for v in vs]
        counts = torch.tensor(list(launches.values())
                              + [c for vs in variants.values() for c in vs.values()],
                              dtype=torch.int64)
        summed = dict(zip(names, D.all_reduce(mesh, counts).tolist()))
        launches = {n: summed[n] for n in launches}
        variants = {n: {v: summed[(n, v)] for v in vs} for n, vs in variants.items()}
    if lead:
        flags = "".join(f" {k}={summary[k]}" for k in ("retries", "hangs", "restarts")
                        if summary.get(k))
        print(f"[done] steps={summary['steps']} final_loss={summary['final_loss']:.4f} "
              f"wall={summary['wall_s']:.1f}s (floor {data.entropy:.4f}){flags}")
        _print_counts(launches, variants)
    summary.update(launches=launches, variants=variants, grad_norms=grad_norms,
                   step_ms=step_ms)
    if mesh is None:
        return summary
    final = summary.pop("state")
    out = dict(summary, transport=mesh.transport, rank={
        "rank": mesh.rank, "data": mesh.data_index, "stage": mesh.model_index,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
        "resident_bytes": resident[0],
        "store_high_water": high_water[0], "step_ms": step_ms, "launches": own_launches,
        "losses": list(summary["history"])})
    if run.return_params:
        out["params"] = tree_map(lambda t: t.detach().cpu(), final.params)
    return out


def _loop(api, opt, mesh, run: RankRun, step_fn, pipeline, lead: bool) -> dict:
    """The loop of ``_train`` with JAX's fault-tolerance wiring: the
    injector around the step, the resume, the supervisor.  On ranks every
    rank runs the same injector and loop; the saver gathers on every rank
    and rank 0 writes, the ``after_save`` hook runs on rank 0 alone and a
    barrier follows it, and the supervisor waits at a barrier before every
    restore."""
    log = print if lead else (lambda line: None)
    cfg = LoopConfig(total_steps=run.steps,
                     ckpt_every=run.ckpt_every if run.ckpt_dir else 0,
                     ckpt_dir=run.ckpt_dir, keep_last=run.keep_last,
                     background_save=run.background_save, max_retries=run.max_retries,
                     watchdog_timeout_s=run.watchdog)
    on_ckpt = save = sync = None
    if run.fault:
        injector = FaultInjector(parse_fault_schedule(run.fault), log_fn=log)
        step_fn = injector.wrap_step(step_fn)
        on_ckpt = injector.after_save
    if mesh is not None:
        save = checkpoint_saver(api, mesh, run.plan)
        hook = on_ckpt

        def sync():
            wait_for_saves()
            D.barrier(mesh)

        if hook is not None:
            def on_ckpt(fname, step):
                if lead:
                    hook(fname, step)
                D.barrier(mesh)

    def init():
        return init_train_state(api, opt, run.seed, mesh=mesh, plan=run.plan)

    def place(state):
        return place_state(state, api, mesh, run.plan)

    like = eval_train_state(api, opt) if run.ckpt_dir else None
    state = None
    if run.resume:
        restored, fname = restore_latest_valid(run.ckpt_dir, like, place)
        if restored is not None:
            state = restored
            dp, mp = (1, 1) if mesh is None else (mesh.shape["data"], mesh.shape["model"])
            log(f"[resume] restored {os.path.basename(fname)} at step {state.step} "
                f"onto {dp}-way DP x {mp}-way MP")
        else:
            log("[resume] no valid checkpoint found; starting fresh")
    if run.max_restarts > 0:
        del state
        return run_supervised(step_fn, pipeline, cfg, init_fn=init, like=like, place=place,
                              max_restarts=run.max_restarts, log_fn=log,
                              on_checkpoint=on_ckpt, save=save, sync=sync)
    return train_loop(step_fn, state if state is not None else init(), pipeline, cfg,
                      log_fn=log, on_checkpoint=on_ckpt, save=save)


def run_ranks(run: RankRun, dp: int, stages: int, device) -> dict:
    """``run`` on dp x ``stages`` ranks (``parallel.dist.spawn_ranks``);
    returns rank 0's summary (losses, grad norms, kernel counts summed over
    the ranks, the ``transport``) with every rank's memory, store and step
    times (``ranks``) and, with ``run.return_params``, every rank's
    parameters on the CPU (``rank_params``), and prints the ``[ranks]``
    line."""
    return rank_summary(run, D.spawn_ranks(_train, dp * stages, device, args=(run,),
                                           stages=stages))


def rank_summary(run: RankRun, results: list) -> dict:
    """``run_ranks``'s summary of every rank's ``_train`` result, in rank
    order, with its ``[ranks]`` line."""
    summary = dict(results[0])
    summary.pop("params", None)
    summary["ranks"] = [r["rank"] for r in results]
    if run.return_params:
        summary["rank_params"] = [r["params"] for r in results]
    place = {"context": "ring", "tensor": "model"}.get(run.plan.mp_kind, "stage")
    print("[ranks] " + " | ".join(
        f"r{r['rank']} (data {r['data']}, {place} {r['stage']}): peak "
        f"{r['peak_mem_bytes'] / 2**30:.2f} GiB, resident {r['resident_bytes'] / 2**30:.2f} "
        f"GiB, store high-water {r['store_high_water']}, "
        f"median step after the first {statistics.median(r['step_ms'][1:] or r['step_ms']):.1f}"
        f" ms, launches " + (" ".join(f"{n}={c}" for n, c in r["launches"].items() if c)
                             or "0")
        for r in summary["ranks"]), flush=True)
    return summary


FSDP_RESIDENCY = "ROADMAP.md Queue 1 item 23 (fsdp residency: a layer at a time)"


def fsdp_step_bytes(run: RankRun, dp: int, stages: int) -> float:
    """A lower bound on a fsdp rank's step peak in the port: the planner's
    ZeRO-2 working set (``per_device_mem_bytes``: the rank's shard of the
    f32 parameters and AdamW state, its gradient shard, the activations
    remat keeps) plus what the port holds beyond it, the rank's f32
    parameters gathered whole once a step and its gradients at full size
    until they are reduce-scattered."""
    tensor = run.plan.mp_kind == "tensor" and stages > 1
    p = float(run.cfg.n_params()) / (stages if tensor else 1)
    zero2 = per_device_mem_bytes(run.cfg, mp=stages, mp_kind=run.plan.mp_kind, fsdp=dp,
                                 mini_batch=max(run.batch // dp, 1), seq_len=run.seq)
    return zero2 + 4.0 * p + 4.0 * p * (1.0 - 1.0 / dp)


def check_fsdp_fits(run: RankRun, dp: int, stages: int) -> None:
    """Exit, naming the ROADMAP item that would make it fit, where a fsdp
    run's ``fsdp_step_bytes`` exceed a rank's memory: its card's share
    (ranks sharing a card split it), or on the CPU the budget of the card
    the planner plans for (``HardwareModel.hbm_bytes``)."""
    if not run.plan.fsdp_axes or dp == 1:
        return
    need = fsdp_step_bytes(run, dp, stages)
    device = torch.device(run.device)
    if device.type == "cuda":
        sharing = -(-dp * stages // max(torch.cuda.device_count(), 1))
        have = torch.cuda.get_device_properties(device.index or 0).total_memory / sharing
    else:
        have = HardwareModel().hbm_bytes
    if need > have:
        raise SystemExit(
            f"[plan] {run.cfg.name} +fsdp on {dp} x {stages} ranks: the port's fsdp step "
            f"gathers the whole tree and keeps full-size gradients, at least "
            f"{need / 2**30:.1f} GiB a rank against {have / 2**30:.1f} GiB; it fits only "
            f"with a layer-at-a-time gather: {FSDP_RESIDENCY}")


def main(argv=None):
    run, dp, stages = plan_run(argv)
    check_fsdp_fits(run, dp, stages)
    if dp * stages > 1:
        try:
            return run_ranks(run, dp, stages, run.device)
        except D.RankExitError as e:     # an injected kill ends every rank
            if e.exit_code <= 0:
                raise
            sys.exit(e.exit_code)
    return _train(None, run)


def plan_run(argv=None) -> Tuple[RankRun, int, int]:
    """The command line's run and its mesh: (``RankRun``, dp, stages), with
    the ``[plan]`` line; ``main`` runs it on dp x stages ranks, or in this
    process when that is 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="2-layer small config (CPU)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parallel", default="dp=1,mp=1",
                    help="'auto', 'dp=N,mp=M[,accum=A]', "
                         "'pipe=S[,micro=K,sched=gpipe|1f1b|interleaved,v=V,dp=N]' or "
                         "'cp=M[,dp=N,accum=A]'")
    ap.add_argument("--devices", type=int, default=0,
                    help=f"planner device budget for --parallel auto (default: "
                         f"{DEFAULT_DEVICES}, as in the JAX launcher)")
    ap.add_argument("--max-local-devices", type=int, default=0,
                    help="ranks this run may realise: DP is clamped to it, stages are "
                         "always realised (default: the cards on cuda, 8 on the CPU)")
    ap.add_argument("--pipe-runtime", choices=["scheduled", "ad"], default=None,
                    help="pipeline runtime: 'scheduled' (default) hand-executes the "
                         "fwd+bwd WorkUnit table; 'ad' is not ported (ROADMAP item 6b)")
    ap.add_argument("--comm-runtime", choices=["gspmd", "overlapped"], default=None,
                    help="the collectives of tensor MP and the DP gradient sync: "
                         "'overlapped' runs the Megatron products on the chunked "
                         "collective-matmul rings and reduce-scatters and all-gathers "
                         "the gradients bucket by bucket, 'gspmd' (default) all-reduces "
                         "after each row-parallel product and each gradient leaf; with "
                         "--parallel auto, the runtime the planner costs")
    ap.add_argument("--context-parallel", action="store_true",
                    help="with --parallel auto, search only context-parallel "
                         "plans; with an explicit spec, mp= is the ring size")
    ap.add_argument("--comm-chunks", type=int, default=None,
                    help="ring chunks per shard for --comm-runtime overlapped (default 1)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="checkpoint cadence in steps (with --ckpt-dir); a final "
                         "checkpoint at loop exit is guaranteed either way")
    ap.add_argument("--keep-last", type=int, default=0,
                    help="retain only the N newest checkpoints (0 = all)")
    ap.add_argument("--background-save", action="store_true",
                    help="write checkpoints on a worker thread, off the step path "
                         "(the device-to-host copy stays on it)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest VALID checkpoint under --ckpt-dir (corrupt "
                         "files are skipped with a warning) and continue with exact data "
                         "order; the file holds the global state, so a run saved at one "
                         "plan resumes on another (elastic grow/shrink)")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="bounded in-place retries per failed step (exponential backoff)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="> 0: run under the fault supervisor, which restarts a crashed "
                         "attempt from the newest valid checkpoint up to N times")
    ap.add_argument("--watchdog", type=float, default=0.0,
                    help="> 0: flag (log + count) steps exceeding this many seconds")
    ap.add_argument("--fault", default="",
                    help="seeded fault-injection schedule, e.g. "
                         "'fail@5x2,kill@7,corrupt@10:bitflip,stall@3:0.4' "
                         "(see repro_torch.train.fault)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.resume and not args.ckpt_dir:
        raise SystemExit("[resume] --resume needs --ckpt-dir")
    if args.fault:
        parse_fault_schedule(args.fault)        # a bad schedule fails before any work
    auto = args.parallel == "auto"
    budget = args.devices or DEFAULT_DEVICES
    max_local = args.max_local_devices or (torch.cuda.device_count()
                                           if torch.device(args.device).type == "cuda" else 8)
    if auto and args.resume:
        # elastic resume: the checkpoint holds the global state and each run
        # cuts its own parts out of it, so the plan comes from the planner at
        # the budget this run has (a bare --resume keeps the default plan, so
        # a same-topology resume stays bit-reproducible)
        budget = args.devices or max_local
        print(f"[plan] --parallel auto with --resume: re-running the planner for the "
              f"current {budget}-device budget")
    plan, mp, dp_hint = parse_parallel(args.parallel, budget,
                                       cfg, comm_runtime=args.comm_runtime or "gspmd",
                                       context_parallel=args.context_parallel)
    # a tensor plan of an arch the port does not shard names its item first
    check_plan(plan, mp, cfg)
    if cfg.family == "cnn" or cfg.encoder_layers:
        # the launcher feeds the token LM only, as JAX's, which refuses cnn
        # archs and fails on GNMT's source/target pairs with a KeyError
        raise SystemExit(f"[data] {cfg.name}: the train CLI feeds the token-LM data "
                         f"pipeline only; {cfg.name} trains through "
                         f"models.api.build_model + train.steps.make_train_step (as "
                         f"chip_smoke.py's GNMT and Inception-V3 phases do)")
    pipeline = plan.is_pipeline and mp > 1
    context = plan.is_context and mp > 1
    tensor = plan.mp_kind == "tensor" and mp > 1
    if context:
        if args.seq % mp:
            raise SystemExit(f"[plan] context parallelism shards the sequence: --seq "
                             f"({args.seq}) must divide by the {mp}-way ring")
        if args.comm_runtime == "overlapped" or args.comm_chunks:
            raise SystemExit("[plan] --comm-runtime/--comm-chunks do not apply to "
                             "context-parallel plans (the KV ring IS the comm schedule)")
        if not cp_arch_supported(cfg):
            raise SystemExit(f"[plan] {cfg.name}: context parallelism needs a homogeneous "
                             f"dense decoder without logit softcap")
    if args.pipe_runtime:
        if not plan.is_pipeline:
            raise SystemExit("[plan] --pipe-runtime only applies to pipeline plans "
                             "(--parallel pipe=... or a planner choice with kind=pipeline)")
        plan = dataclasses.replace(plan, runtime=args.pipe_runtime)
    if args.comm_runtime or args.comm_chunks:
        if args.comm_chunks and (args.comm_runtime or plan.comm_runtime) != "overlapped":
            raise SystemExit("[plan] --comm-chunks only applies with --comm-runtime "
                             "overlapped")
        if pipeline and not auto:
            raise SystemExit("[plan] --comm-runtime/--comm-chunks apply to tensor-MP / DP "
                             "plans; pipeline stages exchange activations over their own "
                             "ring (see --pipe-runtime)")
        if pipeline:
            print("[plan] note: planner chose a pipeline plan; --comm-runtime/--comm-chunks "
                  "do not apply to it")
        elif not context:
            # an auto plan keeps the planner's runtime stamp (gspmd for archs
            # the overlapped runtime cannot execute)
            plan = dataclasses.replace(
                plan, comm_runtime=plan.comm_runtime if auto else (args.comm_runtime
                                                                   or plan.comm_runtime),
                comm_chunks=args.comm_chunks or plan.comm_chunks)
    check_plan(plan, mp, cfg)
    device = resolve_device(args.device)
    if pipeline:
        if not pipeline_applicable(cfg, mp, plan.virtual_stages):
            raise SystemExit(
                f"[plan] {cfg.name}: {mp} pipeline stages (x{max(plan.virtual_stages, 1)} "
                f"chunks) need a supported arch with n_layers % (stages*v) == 0 "
                f"(n_layers={cfg.n_layers})")
        dp = clamp_dp(dp_hint, mp, args.batch, max_local, f"{mp} stages")
        plan = clamp_micro(plan, args.batch // dp)
    elif context:
        dp = clamp_dp(dp_hint, mp, args.batch, max_local, f"a {mp}-way context ring")
    else:
        dp = clamp_dp(dp_hint, mp, args.batch, max_local, f"{mp}-way MP") \
            if dp_hint > 1 else 1
    stages = mp if pipeline or context or tensor else 1
    plan = plan.one_pod()       # the planner's pod axis narrows to the ranks' data axis
    print(f"[plan] {plan.describe({'data': dp, 'model': stages})} on {device}")
    run = RankRun(cfg=cfg, plan=plan, steps=args.steps, batch=args.batch, seq=args.seq,
                  lr=args.lr, device=str(device), ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, keep_last=args.keep_last,
                  background_save=args.background_save, resume=args.resume,
                  max_retries=args.max_retries, max_restarts=args.max_restarts,
                  watchdog=args.watchdog, fault=args.fault)
    return run, dp, stages

if __name__ == "__main__":
    main()
