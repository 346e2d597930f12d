"""Supervised restarts on gloo ranks on the CPU: one ``spawn_ranks`` call a
variant runs, in the same ranks, the launcher's loop straight to step 6 and
then under ``fail@5x3, corrupt@4:bitflip`` with one retry and two restarts
(the attempt dies at step 5 after the step-4 checkpoint, which is
corrupted, so the supervisor warns, falls back to step 2 and runs on); the
two final checkpoints are bit-equal, parameters and AdamW state alike.
Every rank gathers at each save and rank 0 writes; every rank restores the
file and cuts its own part.

Each variant also holds ``train.steps.global_state`` of the seeded rank
init (a pipeline stage's pieces, a tensor-MP rank's slices) against the
whole single-process init and its zero AdamW state, bit for bit: the
gathered tree is JAX's layout.

Variants: reduced Llama (tied embedding, on the first and the last stage)
at ``pipe=2`` gpipe and 1f1b, ``dp=2`` overlapped, ``mp=2`` gspmd and
``cp=2``, and reduced BigLSTM at ``pipe=2`` 1f1b (its layers a list of
dicts in the file, stacked on a stage).
"""
import dataclasses

import pytest
import torch

from repro_torch import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.launch import train as TL
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.parallel import dist as D
from repro_torch.train.steps import global_state, init_train_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

STEPS = 6
FAULTS = "fail@5x3, corrupt@4:bitflip"


def _rank(mesh, straight, faulty):
    api = build_model(straight.cfg, device=mesh.device)
    opt = adamw(warmup_cosine(straight.lr, 20, straight.steps))
    init = init_train_state(api, opt, straight.seed, mesh=mesh, plan=straight.plan)
    whole = global_state(init, api, mesh, straight.plan)
    layout = None
    if mesh.rank == 0:
        ref = init_train_state(api, opt, straight.seed)
        layout = (C._paths(whole) == C._paths(ref)
                  and all(torch.equal(a, b)
                          for a, b in zip(C._leaves(whole), C._leaves(ref))))
    TL._train(mesh, straight)
    summary = TL._train(mesh, faulty)
    return {"layout": layout, "restarts": summary.get("restarts"),
            "retries": summary["retries"], "steps": summary["steps"]}


VARIANTS = [("llama-pipe-gpipe", "llama3_2_1b", "pipe=2,micro=2,sched=gpipe", {}),
            ("llama-pipe-1f1b", "llama3_2_1b", "pipe=2,micro=2,sched=1f1b", {}),
            ("llama-dp-overlapped", "llama3_2_1b", "dp=2,mp=1",
             {"comm_runtime": "overlapped"}),
            ("llama-mp-gspmd", "llama3_2_1b", "dp=1,mp=2", {}),
            ("llama-cp", "llama3_2_1b", "cp=2", {}),
            ("biglstm-pipe-1f1b", "biglstm", "pipe=2,micro=2,sched=1f1b", {})]


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
def test_supervised_restart_on_ranks_is_bit_equal(variant, tmp_path):
    _, arch, spec, extra = variant
    cfg = get_config(arch).reduced()
    plan, mp, dp = TL.parse_parallel(spec, 1, cfg)
    plan = dataclasses.replace(plan, dp_axes=("data",), **extra)
    straight = TL.RankRun(cfg=cfg, plan=plan, steps=STEPS, batch=4, seq=8, lr=3e-3,
                          device="cpu", ckpt_dir=str(tmp_path / "straight"), ckpt_every=2)
    faulty = dataclasses.replace(straight, ckpt_dir=str(tmp_path / "faulty"), fault=FAULTS,
                                 max_retries=1, max_restarts=2)
    out = D.spawn_ranks(_rank, dp * mp, "cpu", args=(straight, faulty), stages=mp,
                        threads=1)
    assert out[0]["layout"] is True
    assert [(r["restarts"], r["steps"]) for r in out] == [(1, STEPS)] * (dp * mp)
    assert all(r["retries"] == 1 for r in out)      # step 5's third try, after the restart
    a = C.read_leaves(C.latest_checkpoint(str(tmp_path / "straight")))
    b = C.read_leaves(C.latest_checkpoint(str(tmp_path / "faulty")))
    assert C.checkpoint_step(C.latest_checkpoint(str(tmp_path / "faulty"))) == STEPS
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"leaf {i} differs"
