"""Deterministic fault injection and the process-level training supervisor
(port of ``repro/train/fault.py``).

Every failure mode the fault-tolerant runtime must survive is reproducible
from a seeded schedule, so recovery is a *test*, not an anecdote:

    faults = parse_fault_schedule("fail@5x2, corrupt@10:bitflip, kill@15")
    inj = FaultInjector(faults)
    summary = run_supervised(inj.wrap_step(train_step), pipeline, cfg,
                             init_fn=..., like=eval_train_state(api, opt),
                             on_checkpoint=inj.after_save)

Fault kinds (``kind@step`` grammar, comma-separated):

- ``fail@N`` / ``fail@NxT`` — the wrapped train step raises
  ``InjectedFault`` when step N is about to run, T consecutive times
  (default 1).  Exercises the loop's bounded retry and, when T exceeds
  ``max_retries``, the supervisor's checkpoint-restore restart.
- ``kill@N`` — simulated preemption: ``os._exit(KILL_EXIT_CODE)`` before
  step N completes — no atexit, no cleanup, like SIGKILL.  Recovery is a
  fresh process resuming from the newest valid checkpoint
  (``launch.train --resume``).
- ``corrupt@N`` / ``corrupt@N:truncate`` — damages the checkpoint written
  *at* step N right after its save completes (``after_save`` hook):
  ``bitflip`` flips one byte in the back half of the file at a seeded
  offset, ``truncate`` cuts the file in half (JAX's offsets and cut).
  Exercises CRC detection and ``restore_latest_valid``'s fallback to the
  previous checkpoint.
- ``stall@N:SECS`` — the step stalls SECS seconds before running (a hung
  data pipeline / collective).  Exercises the loop's watchdog flagging.

A fault at step N fires when step N is *about to run* (the last completed
step is N-1), so "kill@N, resume" and an uninterrupted run execute the
exact same sequence of step transitions.

**Replica-keyed serving faults** (run by ``serve.router.ReplicaRouter``,
in one process and on replica groups of ranks, and by ``launch.serve
--continuous --fault``): the same grammar addresses a replica group instead
of the training loop — ``N`` is the router tick about to run, ``R`` the
replica index:

- ``kill@N:R`` — replica R dies before router tick N (its engine is gone;
  in-flight requests fail over to a healthy replica).
- ``stall@N:R:SECS`` — replica R hangs SECS seconds inside tick N; the
  router's per-replica ``Watchdog`` flags it.  Disambiguated from the
  training form by arg count (two ``:`` args = replica form).
- ``nanlogits@N:R`` — replica R's tick N produces NaN logprobs (a silent
  numerical fault, e.g. a flipped bit in an accumulator); the router's
  logit health check marks the replica degraded.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import zlib
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.checkpoint import restore_latest_valid

KILL_EXIT_CODE = 17     # distinctive exit for injected preemption

FAULT_KINDS = ("fail", "kill", "corrupt", "stall", "nanlogits")
CORRUPT_MODES = ("bitflip", "truncate")


class InjectedFault(RuntimeError):
    """Raised by the injector's wrapped step for ``fail`` faults."""


@dataclasses.dataclass
class Fault:
    kind: str                 # "fail" | "kill" | "corrupt" | "stall" | "nanlogits"
    step: int                 # the step (or router tick) the fault is keyed to
    times: int = 1            # fail: consecutive raises before clearing
    mode: str = "bitflip"     # corrupt: "bitflip" | "truncate"
    seconds: float = 0.25     # stall: sleep duration
    replica: Optional[int] = None   # serving faults: target replica index

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.kind == "corrupt" and self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode {self.mode!r}; "
                             f"expected one of {CORRUPT_MODES}")
        if self.step < 1:
            raise ValueError(f"fault step must be >= 1, got {self.step}")
        if self.kind == "nanlogits" and self.replica is None:
            raise ValueError("nanlogits faults are replica-keyed: "
                             "use nanlogits@N:R")
        if self.replica is not None and self.replica < 0:
            raise ValueError(f"fault replica must be >= 0, got {self.replica}")


def parse_fault_schedule(spec: str) -> List[Fault]:
    """Parse ``"fail@5x2, kill@7, corrupt@10:truncate, stall@3:0.4"``.

    Replica-keyed serving forms (``serve.router``): ``kill@N:R``,
    ``stall@N:R:SECS``, ``nanlogits@N:R``.  ``stall`` is disambiguated by
    arg count — one ``:`` arg is the training form (seconds), two is the
    replica form (replica, seconds)."""
    faults = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(f"fault {item!r}: expected kind@step[...]")
        kind, _, rest = item.partition("@")
        kind = kind.strip()
        parts = rest.split(":")
        rest, args = parts[0], parts[1:]
        times = 1
        if "x" in rest:
            rest, _, t = rest.partition("x")
            times = int(t)
        step = int(rest)
        if kind == "corrupt":
            if len(args) > 1:
                raise ValueError(f"fault {item!r}: corrupt takes at most "
                                 f"one ':' arg (the mode)")
            faults.append(Fault(kind, step, mode=args[0] if args else "bitflip"))
        elif kind == "stall":
            if len(args) == 2:          # replica form: stall@N:R:SECS
                faults.append(Fault(kind, step, replica=int(args[0]),
                                    seconds=float(args[1])))
            elif len(args) <= 1:
                faults.append(Fault(kind, step,
                                    seconds=float(args[0]) if args else 0.25))
            else:
                raise ValueError(f"fault {item!r}: stall takes SECS or "
                                 f"R:SECS after the step")
        elif kind == "kill":
            if len(args) > 1:
                raise ValueError(f"fault {item!r}: kill takes at most "
                                 f"one ':' arg (the replica)")
            faults.append(Fault(kind, step,
                                replica=int(args[0]) if args else None))
        elif kind == "nanlogits":
            if len(args) != 1:
                raise ValueError(f"fault {item!r}: nanlogits is "
                                 f"replica-keyed — use nanlogits@N:R")
            faults.append(Fault(kind, step, replica=int(args[0])))
        else:
            if args:
                raise ValueError(f"fault {item!r}: {kind} takes no ':' arg")
            faults.append(Fault(kind, step, times=times))
    return faults


def corrupt_checkpoint(fname: str, mode: str = "bitflip",
                       seed: int = 0) -> None:
    """Deterministically damage a checkpoint file in place."""
    size = os.path.getsize(fname)
    if mode == "truncate":
        with open(fname, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return
    if mode != "bitflip":
        raise ValueError(f"unknown corrupt mode {mode!r}")
    # land in the back half of the file — the leaf-data region, past the
    # msgpack header — at a seed-deterministic offset
    off = size // 2 + (zlib.crc32(str(seed).encode()) % max(size // 4, 1))
    with open(fname, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([(b[0] if b else 0) ^ 0xFF]))


class FaultInjector:
    """Wraps the training step / checkpoint hook to fire a ``Fault``
    schedule at reproducible points.  ``fired`` records ``(kind, step)`` in
    firing order for assertions.  On ranks every rank runs the same
    injector, so a fault fires on all of them at the same step and they
    stay in step (a fault on one rank alone is not modelled, as in JAX's
    single-controller run); only the writing rank runs ``after_save``."""

    def __init__(self, faults: Sequence[Fault],
                 log_fn: Callable[[str], None] = print):
        self.faults = [dataclasses.replace(f) for f in faults]
        self.log_fn = log_fn
        self.fired: List[tuple] = []

    def _pending(self, kind: str, step: int) -> List[Fault]:
        return [f for f in self.faults
                if f.kind == kind and f.step == step and f.times > 0]

    def wrap_step(self, train_step: Callable) -> Callable:
        """Checks the schedule against the step ABOUT to run
        (``state.step + 1``) before delegating.  Raising or killing happens
        before the real step, so the held state stays retryable."""

        def wrapped(state, batch):
            step = int(state.step) + 1
            for f in self._pending("stall", step):
                f.times = 0
                self.fired.append(("stall", step))
                self.log_fn(f"[fault] stalling {f.seconds:.2f}s before "
                            f"step {step}")
                time.sleep(f.seconds)
            for f in self._pending("kill", step):
                self.fired.append(("kill", step))
                self.log_fn(f"[fault] killing process before step {step} "
                            f"(exit {KILL_EXIT_CODE})")
                sys.stdout.flush()
                os._exit(KILL_EXIT_CODE)
            for f in self._pending("fail", step):
                f.times -= 1
                self.fired.append(("fail", step))
                raise InjectedFault(
                    f"injected step failure at step {step} "
                    f"({f.times} repeats left)")
            return train_step(state, batch)

        return wrapped

    def after_save(self, fname: str, step: int) -> None:
        """``on_checkpoint`` hook: corrupts the checkpoint written at the
        scheduled step, right after its write completed."""
        for f in self._pending("corrupt", step):
            f.times = 0
            self.fired.append(("corrupt", step))
            self.log_fn(f"[fault] corrupting ({f.mode}) checkpoint "
                        f"{os.path.basename(fname)}")
            corrupt_checkpoint(fname, f.mode)


class Watchdog:
    """Arms a timer around each step; fires ``on_timeout(tag)`` if the step
    does not ``disarm()`` within ``timeout_s``.  Detection only — it never
    kills the step (a slow step completes; the flag marks it)."""

    def __init__(self, timeout_s: float, on_timeout: Callable):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None

    def arm(self, tag) -> None:
        self.disarm()
        self._timer = threading.Timer(self.timeout_s, self.on_timeout, (tag,))
        self._timer.daemon = True
        self._timer.start()

    def disarm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def close(self) -> None:
        self.disarm()


def _device_count() -> int:
    """The cards this process sees (1 on a machine without one)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def run_supervised(train_step: Callable, pipeline, cfg, *,
                   init_fn: Callable[[], object],
                   like=None, place=None, max_restarts: int = 2,
                   restart_backoff_s: float = 0.05,
                   log_fn: Callable[[str], None] = print,
                   on_checkpoint: Optional[Callable] = None,
                   replan_fn: Optional[Callable] = None,
                   sleep_fn: Callable[[float], None] = time.sleep,
                   save: Optional[Callable] = None,
                   sync: Optional[Callable[[], None]] = None) -> dict:
    """Process-level supervisor: run ``train_loop`` to completion, restarting
    from the newest *valid* checkpoint (``restore_latest_valid`` skips
    corrupt files) when an attempt dies, up to ``max_restarts`` times with
    exponential backoff (``sleep_fn`` injects the backoff sleep so tests can
    pin the wait sequence without wall-clock time).
    ``init_fn() -> state`` builds the step-0 state when no checkpoint
    exists; ``like`` types the restore (``train.steps.eval_train_state``
    allocates nothing; by default one ``init_fn()`` state is built for its
    shapes); ``place`` maps a restored global state to this process's part
    on its device (``train.steps.place_state``).

    ``replan_fn(device_count) -> (train_step, place) | None`` closes the
    elastic loop: it is called before every attempt with the cards this
    process sees, so a resume after a DP grow or shrink can re-plan for
    them, and returns the re-planned step and ``place`` (or None to keep
    the current pair).

    On ranks the caller passes the loop's ``save`` (every rank gathers,
    one writes) and ``sync``, called before every restore so that no rank
    reads the directory before the writer's files are whole.

    Returns the completing attempt's summary plus ``restarts``."""
    from repro_torch.train.loop import train_loop

    if like is None and cfg.ckpt_dir:
        like = init_fn()
    attempt = 0
    while True:
        if replan_fn is not None:
            replanned = replan_fn(_device_count())
            if replanned is not None:
                train_step, place = replanned
        state, source = None, "fresh init"
        if cfg.ckpt_dir:
            if sync is not None:
                sync()
            restored, fname = restore_latest_valid(cfg.ckpt_dir, like, place)
            if restored is not None:
                state, source = restored, os.path.basename(fname)
        if state is None:
            state = init_fn()
        if attempt:
            log_fn(f"[supervisor] restart {attempt}/{max_restarts} "
                   f"from {source}")
        try:
            summary = train_loop(train_step, state, pipeline, cfg,
                                 log_fn=log_fn, on_checkpoint=on_checkpoint,
                                 save=save)
            summary["restarts"] = attempt
            return summary
        except Exception as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            state = None
            delay = restart_backoff_s * (2 ** (attempt - 1))
            log_fn(f"[supervisor] attempt died ({type(e).__name__}: {e}); "
                   f"restarting in {delay:.2f}s")
            sleep_fn(delay)
