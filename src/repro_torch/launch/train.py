"""Training launcher (single-process port of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch biglstm --steps 5
    python -m repro_torch.launch.train --arch llama3_2_1b --batch 4 --seq 2048 --steps 5
    python -m repro_torch.launch.train --arch biglstm --reduced --device cpu --steps 3
    python -m repro_torch.launch.train --arch biglstm --parallel dp=1,mp=1,accum=2
    python -m repro_torch.launch.train --arch biglstm --parallel auto --devices 1

Feeds the JAX launcher's data (the order-2 Markov LM over min(V, 64)
symbols) with its optimizer, AdamW over ``warmup_cosine(lr, 20, steps)``
with the global-norm clip at 1.0, from a seeded init, and prints the JAX
launcher's ``[data]`` and ``[done]`` lines, then the launch count of each
kernel (``[kernels]``; zero on the CPU, where the plain twins run) and of
each variant of the LSTM forward and of the flash-attention forward and
backward (``[variants]``).  Runs on the card by default; ``--device cpu
--reduced`` is the CPU smoke run.

``--parallel auto`` runs the paper's HybridPlanner (``core.planner``, on the
H100 ``HardwareModel``) over a budget of ``--devices`` cards (default 256,
as in JAX) and prints the JAX launcher's ``[planner]`` line.  A winning
plan with one-way MP trains on this one card, its DP degree clamped to 1
as the JAX launcher clamps to its local devices; a plan with MP > 1 raises
NotImplementedError naming the runtime it needs (ROADMAP.md Queue 1 item 6
pipeline, 7 tensor, 8 context).  Explicit specs take ``dp=1,mp=1`` with an
optional ``accum=N`` (the §4.2 delayed-gradient accumulation); every other
spec raises NotImplementedError naming its ROADMAP item.  On the card
BigLSTM and the dense decoder train; an MoE decoder needs the gmm backward
kernel and RWKV a wkv backward.  On the CPU every decoder trains through
the kernels' plain versions.
"""
from __future__ import annotations

import argparse
from typing import Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core.planner import HybridPlanner, default_epoch_model
from repro_torch.data import DataPipeline, make_lm_dataset
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.api import build_model, supports_pipeline
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import init_train_state, make_train_step

DATA_PARALLEL = "ROADMAP.md Queue 1 item 5 (data parallelism)"
# the ROADMAP item of the runtime each kind of model parallelism needs
MP_ITEMS = {"pipeline": "ROADMAP.md Queue 1 item 6 (pipeline runtime)",
            "tensor": "ROADMAP.md Queue 1 item 7 (tensor MP)",
            "context": "ROADMAP.md Queue 1 item 8 (context parallelism)"}
SPEC_KEYS = ("dp", "mp", "accum", "pipe", "micro", "sched", "v", "cp")
DEFAULT_DEVICES = 256


def parse_parallel(spec: str, devices: int, cfg, comm_runtime: str = "gspmd",
                   context_parallel: bool = False) -> Tuple[ParallelPlan, int, int]:
    """Resolve a --parallel spec to (plan, mp_degree, dp_hint), as the JAX
    launcher's ``parse_parallel``: ``auto`` runs the planner over
    ``devices`` (``comm_runtime`` keys its overlap terms,
    ``context_parallel`` keeps only context points); an explicit spec reads
    its ``dp=/mp=/accum=``, ``pipe=/micro=/sched=/v=`` or ``cp=`` keys.  A
    key the JAX launcher does not know raises NotImplementedError."""
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
            raise NotImplementedError(
                f"--parallel keys {unknown} are not ported to repro_torch yet: "
                f"ROADMAP.md Queue 1 items 5-8")
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


def single_card_accum(plan: ParallelPlan, mp: int, dp_hint: int, *,
                      auto: bool) -> int:
    """The accumulation count of a plan this one card runs.  A plan with
    MP > 1, or one whose parameters shard over DP, raises
    NotImplementedError naming the runtime it needs; a planner plan's DP
    degree is clamped to the card (as the JAX launcher clamps to its local
    devices), an explicit ``dp=`` > 1 raises."""
    if mp > 1:
        raise NotImplementedError(
            f"a {dp_hint}-way DP x {mp}-way {plan.mp_kind} MP plan is not ported "
            f"to repro_torch yet: {MP_ITEMS[plan.mp_kind]}")
    if plan.fsdp_axes:
        raise NotImplementedError(
            f"a {dp_hint}-way DP plan that shards parameters over DP is not "
            f"ported to repro_torch yet: {DATA_PARALLEL}")
    if dp_hint > 1:
        if not auto:
            raise NotImplementedError(f"--parallel dp={dp_hint} is not ported to "
                                      f"repro_torch yet: {DATA_PARALLEL}")
        print(f"[plan] clamped DP {dp_hint} -> 1 (one card; DP across cards is "
              f"{DATA_PARALLEL})")
    return plan.microbatches


def check_trainable(cfg, device: torch.device) -> None:
    """On the card the LSTM family and the dense decoder train; the MoE
    layer's grouped matmuls and the RWKV recurrence have no backward kernels
    yet."""
    if device.type != "cuda":
        return
    if cfg.rwkv:
        raise NotImplementedError(
            f"training {cfg.name} on the card needs the wkv6 backward kernel, not "
            f"ported yet: {wk.RWKV_TRAIN}")
    if cfg.is_moe:
        raise NotImplementedError(
            f"training {cfg.name} on the card needs the gmm backward kernel, not "
            f"ported yet: {moe_gmm.MOE_TRAIN}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="2-layer small config (CPU)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parallel", default="dp=1,mp=1",
                    help="'auto' or dp=1,mp=1[,accum=N] (other specs are not "
                         "ported yet)")
    ap.add_argument("--devices", type=int, default=0,
                    help=f"planner device budget for --parallel auto (default: "
                         f"{DEFAULT_DEVICES}, as in the JAX launcher)")
    ap.add_argument("--comm-runtime", choices=["gspmd", "overlapped"], default="gspmd",
                    help="the collective runtime --parallel auto costs its DP "
                         "gradient sync and tensor-MP matmuls with")
    ap.add_argument("--context-parallel", action="store_true",
                    help="with --parallel auto, search only context-parallel "
                         "plans; with an explicit spec, mp= is the ring size")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "cnn":
        raise SystemExit(f"[data] {cfg.name}: the train CLI drives the token-LM data "
                         f"pipeline; cnn archs train through benchmarks/fig4_epochs.py")
    plan, mp, dp_hint = parse_parallel(args.parallel, args.devices or DEFAULT_DEVICES,
                                       cfg, comm_runtime=args.comm_runtime,
                                       context_parallel=args.context_parallel)
    accum = single_card_accum(plan, mp, dp_hint, auto=args.parallel == "auto")
    api = build_model(cfg, device=args.device)
    check_trainable(cfg, api.device)
    print(f"[plan] {plan.describe({'data': 1})} on {api.device}")

    data = make_lm_dataset(vocab=min(cfg.vocab_size, 64), seq_len=args.seq)
    print(f"[data] markov-lm entropy floor = {data.entropy:.4f} nats/token")
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    train_step = make_train_step(api, opt, clip_norm=1.0, microbatches=accum)
    state = init_train_state(api, opt, 0)

    pipeline = DataPipeline(lambda e: data.epoch(e, args.batch), device=api.device,
                            steps_per_epoch=data.steps_per_epoch(args.batch))
    summary = train_loop(train_step, state, pipeline, LoopConfig(total_steps=args.steps))
    print(f"[done] steps={summary['steps']} final_loss="
          f"{summary['final_loss']:.4f} wall={summary['wall_s']:.1f}s "
          f"(floor {data.entropy:.4f})")
    print(f"[kernels] lstm_cell_fwd={lc.lstm_cell_fwd.launches} "
          f"lstm_cell_bwd_pointwise={lc.lstm_cell_bwd_pointwise.launches} "
          f"flash_attention={fa.flash_attention.launches} "
          f"flash_attention_bwd={fa.flash_attention_bwd.launches} "
          f"gmm={moe_gmm.gmm.launches} wkv6={wk.wkv6.launches}")
    print("[variants] " + " | ".join(
        f"{fn.__name__}: " + " ".join(f"{v}={n}" for v, n in fn.variant_launches.items())
        for fn in (lc.lstm_cell_fwd, fa.flash_attention, fa.flash_attention_bwd)))
    return summary


if __name__ == "__main__":
    main()
