"""The port's fault tolerance (``repro_torch.train.fault``, the loop's
checkpoint and watchdog hooks, the launcher's flags) on the CPU, the port's
counterparts of ``tests/test_fault.py``:

- ``parse_fault_schedule`` (the replica forms and the errors too) and
  ``corrupt_checkpoint`` agree with the JAX package's;
- the loop: exact data-order resume, an injected ``fail`` retried in place,
  retry exhaustion propagating, the watchdog flagging a ``stall``, the
  guaranteed final checkpoint, the summary's keys;
- the supervisor: ``fail@5x3, corrupt@4:bitflip`` on a reduced Llama warns
  ``skipping ckpt_00000004``, restarts once and ends bit-equal to a straight
  run; its backoff is pinned;
- the launcher through subprocesses (``--device cpu --reduced``): ``kill@9``
  exits 17 and ``--resume`` ends bit-equal to a straight run, in one
  process and at ``dp=2`` on gloo ranks (the exit code survives
  ``spawn_ranks``); an elastic ``dp=2`` -> one-process restore is bit-equal
  to the file and its continuation within JAX's elastic tolerance.

The supervised restarts on pipeline, DP, tensor and context ranks are in
``tests/test_torch_fault_ranks.py``.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as C
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline, make_lm_dataset
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, constant_lr, warmup_cosine
from repro_torch.train import LoopConfig, train_loop
from repro_torch.train.fault import (KILL_EXIT_CODE, Fault, FaultInjector, InjectedFault,
                                     corrupt_checkpoint, parse_fault_schedule,
                                     run_supervised)
from repro_torch.train.steps import (TrainState, eval_train_state, init_train_state,
                                     make_train_step, place_state)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ELASTIC_TOL = {"rtol": 2e-4, "atol": 1e-5}       # tests/test_fault.py's
SILENT = {"log_fn": lambda m: None}


# -- the grammar and the corruption ------------------------------------------

def test_parse_fault_schedule():
    faults = parse_fault_schedule(
        "fail@5x2, kill@7, corrupt@10:truncate, stall@3:0.4, corrupt@12")
    assert [(f.kind, f.step) for f in faults] == [
        ("fail", 5), ("kill", 7), ("corrupt", 10), ("stall", 3), ("corrupt", 12)]
    assert faults[0].times == 2
    assert faults[2].mode == "truncate" and faults[4].mode == "bitflip"
    assert faults[3].seconds == pytest.approx(0.4)
    with pytest.raises(ValueError, match="kind@step"):
        parse_fault_schedule("fail5")
    with pytest.raises(ValueError, match="unknown fault kind"):
        parse_fault_schedule("explode@3")
    with pytest.raises(ValueError, match="unknown corrupt mode"):
        Fault("corrupt", 3, mode="scribble")


def test_parse_replica_fault_schedule():
    faults = parse_fault_schedule(
        "kill@5:1, stall@7:0:0.5, nanlogits@9:1, stall@3:0.4, kill@8")
    assert [(f.kind, f.step, f.replica) for f in faults] == [
        ("kill", 5, 1), ("stall", 7, 0), ("nanlogits", 9, 1), ("stall", 3, None),
        ("kill", 8, None)]
    assert faults[1].seconds == pytest.approx(0.5)
    with pytest.raises(ValueError, match="nanlogits.*replica"):
        parse_fault_schedule("nanlogits@9")
    with pytest.raises(ValueError, match="replica must be >= 0"):
        Fault("kill", 5, replica=-1)
    with pytest.raises(ValueError):
        parse_fault_schedule("fail@5:1")


SPECS = ["fail@5x2, kill@7, corrupt@10:truncate, stall@3:0.4, corrupt@12",
         "kill@5:1, stall@7:0:0.5, nanlogits@9:1", "fail@1", " , stall@2", "fail@0",
         "corrupt@3:a:b", "stall@1:2:3:4", "kill@1:2:3", "nanlogits@1:2:3", "x@1",
         "fail@2x", "corrupt@4:truncate"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_agrees_with_jax(spec):
    from repro.train.fault import parse_fault_schedule as j_parse

    def run(fn):
        try:
            return [dataclasses.astuple(f) for f in fn(spec)]
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(parse_fault_schedule) == run(j_parse)


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
@pytest.mark.parametrize("size", [1, 7, 448, 100003])
def test_corrupt_checkpoint_damages_as_jax_does(tmp_path, mode, size):
    from repro.train.fault import corrupt_checkpoint as j_corrupt

    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    ours, theirs = tmp_path / "a", tmp_path / "b"
    ours.write_bytes(data)
    theirs.write_bytes(data)
    corrupt_checkpoint(str(ours), mode)
    j_corrupt(str(theirs), mode)
    assert ours.read_bytes() == theirs.read_bytes()
    assert (ours.read_bytes() == data) == (size == 1 and mode == "truncate")


# -- the loop ----------------------------------------------------------------

def _recording_pipeline(n_per_epoch=5, known_spe=True):
    def epoch_fn(e):
        return iter([{"eid": np.asarray(e), "bid": np.asarray(i)} for i in range(n_per_epoch)])
    return DataPipeline(epoch_fn, steps_per_epoch=n_per_epoch if known_spe else None)


def _recording_step(log):
    def step(state, batch):
        log.append((int(batch["eid"]), int(batch["bid"])))
        return TrainState(state.params, state.opt_state, state.step + 1), \
            {"loss": torch.tensor(1.0)}
    return step


def _zero_state(step=0):
    return TrainState(params={"w": torch.zeros(())}, opt_state=(), step=step)


@pytest.mark.parametrize("known_spe", [True, False])
def test_exact_data_order_resume(known_spe):
    straight, resumed = [], []
    cfg = LoopConfig(total_steps=12, log_every=100)
    train_loop(_recording_step(straight), _zero_state(0),
               _recording_pipeline(known_spe=known_spe), cfg, **SILENT)
    train_loop(_recording_step(resumed), _zero_state(7),
               _recording_pipeline(known_spe=known_spe), cfg, **SILENT)
    assert straight[7:] == resumed
    assert straight == [(e, i) for e in range(3) for i in range(5)][:12]


def test_injected_failure_retried_in_place():
    log = []
    inj = FaultInjector(parse_fault_schedule("fail@3"), **SILENT)
    cfg = LoopConfig(total_steps=6, max_retries=1, retry_backoff_s=0.0)
    summary = train_loop(inj.wrap_step(_recording_step(log)), _zero_state(0),
                         _recording_pipeline(), cfg, **SILENT)
    assert summary["retries"] == 1 and inj.fired == [("fail", 3)]
    assert summary["steps"] == 6 and log == [(0, i) for i in range(5)] + [(1, 0)]


def test_retry_exhaustion_kills_attempt_and_propagates():
    inj = FaultInjector([Fault("fail", 2, times=5)], **SILENT)
    with pytest.raises(InjectedFault):
        train_loop(inj.wrap_step(_recording_step([])), _zero_state(0),
                   _recording_pipeline(),
                   LoopConfig(total_steps=4, max_retries=1, retry_backoff_s=0.0), **SILENT)


def test_watchdog_flags_injected_stall():
    logs = []
    inj = FaultInjector(parse_fault_schedule("stall@2:0.25"), **SILENT)
    cfg = LoopConfig(total_steps=4, watchdog_timeout_s=0.05)
    summary = train_loop(inj.wrap_step(_recording_step([])), _zero_state(0),
                         _recording_pipeline(), cfg, log_fn=logs.append)
    assert summary["hangs"] >= 1 and summary["steps"] == 4
    assert inj.fired == [("stall", 2)]
    assert any(m.startswith("[watchdog] step 2 exceeded 0.05s") for m in logs)


def test_final_checkpoint_guaranteed_at_loop_exit(tmp_path):
    cfg = LoopConfig(total_steps=5, ckpt_every=0, ckpt_dir=str(tmp_path))
    summary = train_loop(_recording_step([]), _zero_state(0), _recording_pipeline(), cfg,
                         **SILENT)
    f = C.latest_checkpoint(str(tmp_path))
    assert f is not None and C.checkpoint_step(f) == 5
    assert summary["last_checkpoint_step"] == 5 and summary["checkpoints"] == 1
    assert set(summary) >= {"hangs", "checkpoints", "last_checkpoint_step", "retries",
                            "start_step", "converged", "wall_s", "history", "epochs"}


def test_loop_checkpoints_on_cadence_through_the_callers_saver(tmp_path):
    """``save`` replaces ``save_checkpoint``; a background save is joined
    before ``on_checkpoint`` sees its file, and the loop never saves a step
    twice."""
    calls, hooked = [], []

    def save(path, state, step, *, keep_last, background):
        calls.append((step, keep_last, background))
        return C.save_checkpoint(path, state, step, keep_last=keep_last,
                                 background=background)

    def hook(fname, step):
        hooked.append((step, C.verify_checkpoint(fname)["step"]))

    cfg = LoopConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(tmp_path), keep_last=1,
                     background_save=True)
    summary = train_loop(_recording_step([]), _zero_state(0), _recording_pipeline(), cfg,
                         on_checkpoint=hook, save=save, **SILENT)
    assert calls == [(3, 1, True), (6, 1, True)] and hooked == [(3, 3), (6, 6)]
    assert summary["checkpoints"] == 2 and summary["last_checkpoint_step"] == 6
    assert [C.checkpoint_step(f) for f in C.list_checkpoints(str(tmp_path))] == [6]


def test_final_sync_save_survives_a_background_save_in_flight(tmp_path, monkeypatch):
    """The step-4 background write finishes (and sweeps orphaned ``.tmp``
    files) while the final step-5 sync write is still open: the sweep must
    spare it."""
    write = C._write

    def slow_write(tmp, step, *args):
        if step == 4:
            time.sleep(0.2)
            write(tmp, step, *args)
        else:
            write(tmp, step, *args)
            time.sleep(0.6)

    monkeypatch.setattr(C, "_write", slow_write)
    cfg = LoopConfig(total_steps=5, ckpt_every=4, ckpt_dir=str(tmp_path),
                     background_save=True)
    summary = train_loop(_recording_step([]), _zero_state(0), _recording_pipeline(), cfg,
                         **SILENT)
    files = C.list_checkpoints(str(tmp_path))
    assert [C.checkpoint_step(f) for f in files] == [4, 5]
    assert C.verify_checkpoint(files[-1])["step"] == 5
    assert summary["checkpoints"] == 2 and summary["last_checkpoint_step"] == 5
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


# -- the supervisor ----------------------------------------------------------

def _lm_setup(batch=4, seq=8):
    cfg = dataclasses.replace(get_config("llama3_2_1b").reduced(), vocab_size=32)
    api = build_model(cfg, device="cpu")
    opt = adamw(constant_lr(3e-3))
    data = make_lm_dataset(vocab=32, seq_len=seq, n_items=64)
    pipe = DataPipeline(lambda e: iter(list(data.epoch(e, batch))),
                        steps_per_epoch=data.steps_per_epoch(batch))
    return api, opt, pipe, make_train_step(api, opt), lambda: init_train_state(api, opt, 0)


def _state_leaves(state):
    return C._leaves(state)


def test_supervisor_recovers_bit_equal_to_uninterrupted(tmp_path):
    api, opt, pipe, step_fn, init_fn = _lm_setup()
    cfg = LoopConfig(total_steps=8, ckpt_every=2, ckpt_dir=str(tmp_path), max_retries=1,
                     retry_backoff_s=0.0, log_every=100)
    straight = train_loop(step_fn, init_fn(), pipe, dataclasses.replace(cfg, ckpt_dir=""),
                          **SILENT)
    inj = FaultInjector(parse_fault_schedule("fail@5x3, corrupt@4:bitflip"), **SILENT)
    logs = []
    with pytest.warns(UserWarning, match="skipping ckpt_00000004"):
        summary = run_supervised(inj.wrap_step(step_fn), pipe, cfg, init_fn=init_fn,
                                 like=eval_train_state(api, opt),
                                 place=lambda s: place_state(s, api),
                                 max_restarts=2, restart_backoff_s=0.0,
                                 log_fn=logs.append, on_checkpoint=inj.after_save)
    assert summary["restarts"] == 1 and summary["steps"] == 8
    assert ("corrupt", 4) in inj.fired and ("fail", 5) in inj.fired
    assert "[supervisor] restart 1/2 from ckpt_00000002.msgpack" in logs
    for x, y in zip(_state_leaves(straight["state"]), _state_leaves(summary["state"])):
        assert torch.equal(x, y)


def test_supervisor_backoff_sequence_pinned():
    waits = []
    inj = FaultInjector([Fault("fail", 2, times=100)], **SILENT)
    cfg = LoopConfig(total_steps=4, max_retries=0, retry_backoff_s=0.0)
    with pytest.raises(InjectedFault):
        run_supervised(inj.wrap_step(_recording_step([])), _recording_pipeline(), cfg,
                       init_fn=_zero_state, max_restarts=3, restart_backoff_s=0.05,
                       sleep_fn=waits.append, **SILENT)
    assert waits == pytest.approx([0.05, 0.10, 0.20])


def test_supervisor_replans_before_every_attempt(tmp_path):
    seen = []

    def replan(n):
        seen.append(n)
        return None

    run_supervised(_recording_step([]), _recording_pipeline(),
                   LoopConfig(total_steps=2, ckpt_dir=str(tmp_path)), init_fn=_zero_state,
                   replan_fn=replan, **SILENT)
    assert seen == [1]


# -- the launcher, through subprocesses ---------------------------------------

def _run_cli(args, expect_rc=0, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"] + args,
                       capture_output=True, text=True, env=env, timeout=timeout)
    assert r.returncode == expect_rc, (f"rc={r.returncode} (expected {expect_rc})\n"
                                       f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}")
    return r.stdout


def _cli_base(ckpt_dir, extra=()):
    return ["--arch", "llama3_2_1b", "--reduced", "--device", "cpu", "--steps", "12",
            "--batch", "8", "--seq", "16", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", "5"] + list(extra)


def _final(ckpt_dir, step=12):
    f = C.latest_checkpoint(str(ckpt_dir))
    assert f is not None and C.checkpoint_step(f) == step, ckpt_dir
    return C.read_leaves(f)


def _bit_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), f"leaf {i} differs"


def test_cli_kill_and_resume_bit_equal(tmp_path):
    _run_cli(_cli_base(tmp_path / "kill", ["--fault", "kill@9"]), expect_rc=KILL_EXIT_CODE)
    assert C.checkpoint_step(C.latest_checkpoint(str(tmp_path / "kill"))) == 5
    out = _run_cli(_cli_base(tmp_path / "kill", ["--resume"]))
    assert "[resume] restored ckpt_00000005" in out and "onto 1-way DP x 1-way MP" in out
    assert "resuming at step 5" in out
    _run_cli(_cli_base(tmp_path / "straight", ["--background-save", "--keep-last", "1"]))
    assert [os.path.basename(f) for f in C.list_checkpoints(str(tmp_path / "straight"))] \
        == ["ckpt_00000012.msgpack"]
    _bit_equal(_final(tmp_path / "kill"), _final(tmp_path / "straight"))


def test_cli_refusals_and_an_elastic_fresh_resume(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "llama3_2_1b", "--reduced", "--device", "cpu", "--resume"],
                       capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
                       timeout=120)
    assert r.returncode == 1 and "[resume] --resume needs --ckpt-dir" in r.stderr
    out = _run_cli(_cli_base(tmp_path, ["--resume", "--steps", "2", "--max-retries", "1",
                                        "--max-restarts", "1", "--watchdog", "60",
                                        "--fault", "fail@2", "--parallel", "auto",
                                        "--devices", "1"]))
    assert ("[plan] --parallel auto with --resume: re-running the planner for the current "
            "1-device budget") in out
    assert "[resume] no valid checkpoint found; starting fresh" in out
    assert "[done] steps=2" in out and "retries=1" in out


DP2 = ["--parallel", "dp=2,mp=1"]


@pytest.fixture(scope="module")
def dp2_runs(tmp_path_factory):
    """A dp=2 run killed at step 9 (a copy of its directory kept for the
    elastic resume) and a straight dp=2 run to step 12."""
    root = tmp_path_factory.mktemp("dp2")
    _run_cli(_cli_base(root / "kill", DP2 + ["--fault", "kill@9"]), expect_rc=KILL_EXIT_CODE)
    shutil.copytree(root / "kill", root / "elastic")
    _run_cli(_cli_base(root / "straight", DP2))
    return root


def test_cli_kill_and_resume_bit_equal_on_dp_ranks(dp2_runs):
    assert C.checkpoint_step(C.latest_checkpoint(str(dp2_runs / "kill"))) == 5
    out = _run_cli(_cli_base(dp2_runs / "kill", DP2 + ["--resume"]))
    assert "restored ckpt_00000005" in out and "onto 2-way DP x 1-way MP" in out
    assert "resuming at step 5" in out
    _bit_equal(_final(dp2_runs / "kill"), _final(dp2_runs / "straight"))


def test_elastic_dp2_checkpoint_resumes_in_one_process(dp2_runs):
    ck = C.latest_checkpoint(str(dp2_runs / "elastic"))
    assert C.checkpoint_step(ck) == 5
    cfg = get_config("llama3_2_1b").reduced()
    api = build_model(cfg, device="cpu")
    opt = adamw(warmup_cosine(3e-3, 20, 12))
    state = C.restore_checkpoint(ck, eval_train_state(api, opt), lambda s: place_state(s, api))
    assert state.step == 5
    _bit_equal(_state_leaves(state), C.read_leaves(ck))
    out = _run_cli(_cli_base(dp2_runs / "elastic", ["--resume"]))
    assert "onto 1-way DP x 1-way MP" in out and "resuming at step 5" in out
    fin, ref = _final(dp2_runs / "elastic"), _final(dp2_runs / "straight")
    for i, (a, b) in enumerate(zip(fin, ref)):
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), **ELASTIC_TOL,
                                   err_msg=f"leaf {i} diverged across dp=2 -> dp=1")
