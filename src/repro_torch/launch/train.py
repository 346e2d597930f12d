"""Training launcher (single-process port of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch biglstm --steps 5
    python -m repro_torch.launch.train --arch llama3_2_1b --batch 4 --seq 2048 --steps 5
    python -m repro_torch.launch.train --arch biglstm --reduced --device cpu --steps 3
    python -m repro_torch.launch.train --arch biglstm --parallel dp=1,mp=1,accum=2

Feeds the JAX launcher's data (the order-2 Markov LM over min(V, 64)
symbols) with its optimizer, AdamW over ``warmup_cosine(lr, 20, steps)``
with the global-norm clip at 1.0, from a seeded init, and prints the JAX
launcher's ``[data]`` and ``[done]`` lines, then the launch count of each
kernel (``[kernels]``; zero on the CPU, where the plain twins run) and of
each variant of the LSTM forward and of the flash-attention forward and
backward (``[variants]``).  Runs on the card by default; ``--device cpu
--reduced`` is the CPU smoke run.  ``--parallel`` takes only ``dp=1,mp=1``
with an optional ``accum=N`` (the §4.2 delayed-gradient accumulation);
every other spec raises NotImplementedError naming its ROADMAP item.  On the
card BigLSTM and the dense decoder train; an MoE decoder needs the gmm
backward kernel and RWKV a wkv backward.  On the CPU every decoder trains
through the kernels' plain versions.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, make_lm_dataset
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lstm_cell as lc
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import init_train_state, make_train_step

PLANNER = "ROADMAP.md Queue 1 item 4 (the core planner)"
SPEC_ITEMS = {"dp": "ROADMAP.md Queue 1 item 5 (data parallelism)",
              "pipe": "ROADMAP.md Queue 1 item 6 (pipeline runtime)",
              "mp": "ROADMAP.md Queue 1 item 7 (tensor MP)",
              "cp": "ROADMAP.md Queue 1 item 8 (context parallelism)"}


def parse_parallel(spec: str) -> int:
    """The accumulation count of a ``dp=1,mp=1[,accum=N]`` spec; any other
    spec raises NotImplementedError naming its ROADMAP item."""
    if spec == "auto":
        raise NotImplementedError(f"--parallel auto is not ported to repro_torch yet: "
                                  f"{PLANNER}")
    try:
        kv = {k: int(v) for k, v in (p.split("=") for p in spec.split(","))}
    except ValueError:
        raise SystemExit(f"[plan] cannot parse --parallel {spec!r}") from None
    for key, item in SPEC_ITEMS.items():
        if kv.get(key, 1) > 1:
            raise NotImplementedError(f"--parallel {key}={kv[key]} is not ported to "
                                      f"repro_torch yet: {item}")
    unknown = set(kv) - set(SPEC_ITEMS) - {"accum"}
    if unknown:
        raise NotImplementedError(f"--parallel keys {sorted(unknown)} are not ported to "
                                  f"repro_torch yet: ROADMAP.md Queue 1 items 5-8")
    return kv.get("accum", 1)


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
                    help="dp=1,mp=1[,accum=N] (other specs are not ported yet)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "cnn":
        raise SystemExit(f"[data] {cfg.name}: the train CLI drives the token-LM data "
                         f"pipeline; cnn archs train through benchmarks/fig4_epochs.py")
    accum = parse_parallel(args.parallel)
    api = build_model(cfg, device=args.device)
    check_trainable(cfg, api.device)
    print(f"[plan] 1-way DP x 1-way MP on {api.device}"
          + (f", {accum} accumulated micro-batches" if accum > 1 else ""))

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
