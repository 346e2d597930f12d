"""Pipeline schedules and their analytic model (port of the pure-Python
half of ``repro/parallel/pipeline.py``).

A ``PipelineSchedule`` emits the per-tick (stage, micro-batch, chunk,
direction) table of S stages fed K micro-batches, plus the closed forms the
planner reads:

    ============  =======================  ==============================
    schedule      bubble fraction          activation residency
    ============  =======================  ==============================
    gpipe         (S-1)/(K+S-1)            K
    1f1b          (S-1)/(K+S-1)            min(K, S)
    interleaved   (S-1)/(vK+S-1)  [S | K]  min(K, S + (S-1)/v)
    ============  =======================  ==============================

``gpipe`` runs all forwards, then the time-mirrored backwards; ``1f1b``
drains a backward whenever one is ready under a per-stage in-flight cap
min(K, S-s); ``interleaved`` puts v non-contiguous layer chunks on each
device and wraps micro-batches around the stage ring v times.  The tick
diagrams are in the JAX module's docstring.  The runtime that executes a
schedule on several cards (``pipeline_apply``, ``pipeline_value_and_grad``,
``stack_to_stages``) is ROADMAP.md Queue 1 item 6 and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

SCHEDULE_KINDS = ("gpipe", "1f1b", "interleaved")


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One scheduled cell of the full fwd+bwd table."""
    tick: int
    stage: int       # physical device on the stage axis
    micro: int
    chunk: int       # virtual-chunk index on that device (0 for v=1)
    direction: str   # "fwd" | "bwd"


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """A pipeline schedule: placement tables + analytic cost/memory model.

    ``n_virtual_per_stage`` (v) is the interleaved chunk count per device;
    gpipe/1f1b require v == 1.
    """

    kind: str
    n_stages: int
    n_micro: int
    n_virtual_per_stage: int = 1

    def __post_init__(self):
        if self.kind not in SCHEDULE_KINDS:
            raise ValueError(f"unknown schedule {self.kind!r}; "
                             f"expected one of {SCHEDULE_KINDS}")
        if self.kind != "interleaved" and self.n_virtual_per_stage != 1:
            raise ValueError(f"{self.kind} takes no virtual stages")
        if self.kind == "interleaved" and self.n_virtual_per_stage < 2:
            raise ValueError("interleaved needs >= 2 chunks per device")
        if self.n_stages < 1 or self.n_micro < 1:
            raise ValueError((self.n_stages, self.n_micro))

    # -- geometry ----------------------------------------------------------

    @property
    def v(self) -> int:
        return self.n_virtual_per_stage

    @property
    def n_virtual(self) -> int:
        """Total virtual stages; chunk j//S of virtual stage j on device j%S."""
        return self.n_stages * self.v

    def _wave(self) -> Tuple[int, int]:
        """(round size R, round stride) of the forward wave.

        v == 1 admits the full single wave (micro m enters stage 0 at tick
        m).  v > 1 wraps activations around the stage ring, so at most S
        micro-batches may be in flight per chunk round; when S | K the
        rounds pack back-to-back (stride S*v — the Megatron interleaved
        wave), otherwise they are spaced so the wrap edge stays
        conflict-free (stride R + vS - 1).
        """
        S, K, v = self.n_stages, self.n_micro, self.v
        if v == 1:
            return K, 0
        R = min(S, K)
        stride = S * v if K % S == 0 else R + self.n_virtual - 1
        return R, stride

    def _fwd_tick(self, m: int, j: int) -> int:
        """Tick at which micro ``m`` runs virtual stage ``j`` forward."""
        R, stride = self._wave()
        return (m // R) * stride + (m % R) + j

    @property
    def fwd_ticks(self) -> int:
        return self._fwd_tick(self.n_micro - 1, self.n_virtual - 1) + 1

    # -- tables ------------------------------------------------------------

    def forward_table(self) -> Dict[str, np.ndarray]:
        """The executable forward placement, as (T, S) int32 arrays.

        ``micro[t, s]`` — micro-batch processed by stage s at tick t (-1 if
        idle); ``chunk[t, s]`` — which of the device's v layer chunks;
        ``inject[t, s]`` — 1 when the input comes from the local micro-batch
        buffer (virtual stage 0) instead of the ppermute ring; ``emit[t, s]``
        — 1 when the output is a finished micro-batch (virtual stage vS-1).
        """
        S, K, V = self.n_stages, self.n_micro, self.n_virtual
        T = self.fwd_ticks
        micro = np.full((T, S), -1, np.int32)
        chunk = np.zeros((T, S), np.int32)
        inject = np.zeros((T, S), np.int32)
        emit = np.zeros((T, S), np.int32)
        for m in range(K):
            for j in range(V):
                t, s = self._fwd_tick(m, j), j % S
                assert micro[t, s] == -1, ("schedule conflict", self, t, s)
                micro[t, s] = m
                chunk[t, s] = j // S
                inject[t, s] = int(j == 0)
                emit[t, s] = int(j == V - 1)
        return {"micro": micro, "chunk": chunk, "inject": inject, "emit": emit}

    def table(self) -> List[WorkUnit]:
        """Full fwd+bwd schedule, one WorkUnit per busy (tick, stage) cell.

        gpipe: forward wave + time-mirrored backward wave.  1f1b: event
        simulation of the one-forward-one-backward policy with the per-stage
        in-flight cap min(K, S-s).  interleaved: the packed forward wave +
        the 1f1b-style simulated backward with the Megatron per-device
        in-flight chunk cap min(Kv, (v-1)S + 2(S-1-d) + 1).  Backward ticks
        are costed equal to forward ticks (the classic idealization behind
        the closed-form bubbles; real bwd ~ 2x fwd changes the constants,
        not the fractions).
        """
        if self.kind == "gpipe":
            return self._mirrored_table()
        return self._simulated_table()

    def _mirrored_table(self) -> List[WorkUnit]:
        S, V, Tf = self.n_stages, self.n_virtual, self.fwd_ticks
        units = []
        for m in range(self.n_micro):
            for j in range(V):
                tf = self._fwd_tick(m, j)
                units.append(WorkUnit(tf, j % S, m, j // S, "fwd"))
                units.append(WorkUnit(2 * Tf - 1 - tf, j % S, m, j // S,
                                      "bwd"))
        return sorted(units, key=lambda u: (u.tick, u.stage))

    def _inflight_cap(self, device: int) -> int:
        """Max fwd-done-not-yet-bwd chunks device ``device`` may hold."""
        S, K, v = self.n_stages, self.n_micro, self.v
        if self.v == 1:
            return min(K, S - device)
        return min(K * v, (v - 1) * S + 2 * (S - 1 - device) + 1)

    def _simulated_table(self) -> List[WorkUnit]:
        """Greedy event simulation of the 1F1B policy over virtual stages.

        Ready rule: fwd(m, j) needs fwd(m, j-1) done at an earlier tick;
        bwd(m, j) needs bwd(m, j+1) (or, for j = vS-1, fwd(m, vS-1)) done at
        an earlier tick.  Each device runs one unit per tick, preferring
        backward (that is the 1F1B drain), and refusing forwards that would
        exceed its in-flight cap.  A safety valve lifts the cap if the whole
        machine ever stalls, guaranteeing termination.
        """
        S, K, V = self.n_stages, self.n_micro, self.n_virtual
        fwd_done = {}   # (m, j) -> completion tick
        bwd_done = {}
        inflight = [0] * S
        units: List[WorkUnit] = []
        t = 0
        limit = 4 * (2 * K * V + 2 * self.fwd_ticks) + 16
        while len(bwd_done) < K * V:
            for relax_cap in (False, True):
                scheduled_any = False
                for s in range(S):
                    unit = self._pick(s, t, fwd_done, bwd_done, inflight,
                                      relax_cap)
                    if unit is None:
                        continue
                    m, j, d = unit
                    units.append(WorkUnit(t, s, m, j // S, d))
                    if d == "fwd":
                        fwd_done[(m, j)] = t
                        inflight[s] += 1
                    else:
                        bwd_done[(m, j)] = t
                        inflight[s] -= 1
                    scheduled_any = True
                if scheduled_any:
                    break
                # nothing schedulable: dependencies only ever complete when a
                # unit is scheduled, so a fully idle strict tick is a cap
                # deadlock — retry this tick with the cap lifted
            t += 1
            assert t < limit, ("schedule simulation diverged", self)
        return sorted(units, key=lambda u: (u.tick, u.stage))

    def _pick(self, s: int, t: int, fwd_done, bwd_done, inflight,
              relax_cap: bool) -> Optional[Tuple[int, int, str]]:
        S, K, V = self.n_stages, self.n_micro, self.n_virtual
        my_vstages = range(s, V, S)
        # 1F1B: drain a backward first whenever one is ready
        best = None
        for j in my_vstages:
            for m in range(K):
                if (m, j) in bwd_done or (m, j) not in fwd_done:
                    continue
                if j == V - 1:
                    ready = fwd_done[(m, j)] < t
                else:
                    ready = (m, j + 1) in bwd_done and bwd_done[(m, j + 1)] < t
                if ready and (best is None or (m, j) < best):
                    best = (m, j)
        if best is not None:
            return (*best, "bwd")
        if inflight[s] >= self._inflight_cap(s) and not relax_cap:
            return None
        for j in my_vstages:
            for m in range(K):
                if (m, j) in fwd_done:
                    continue
                ready = (j == 0 or ((m, j - 1) in fwd_done
                                    and fwd_done[(m, j - 1)] < t))
                if ready and (best is None or (m, j) < best):
                    best = (m, j)
        return None if best is None else (*best, "fwd")

    # -- analytics ---------------------------------------------------------

    def total_ticks(self) -> int:
        tbl = self.table()
        return tbl[-1].tick + 1 if tbl else 0

    def bubble_fraction(self) -> float:
        """Idle fraction of the steady schedule (closed form; the planner's
        SU^M input).  gpipe/1f1b: (S-1)/(K+S-1).  interleaved: derived from
        the forward wave — (S-1)/(vK+S-1) when S | K, the relaxed-wave
        equivalent otherwise."""
        S, K, v = self.n_stages, self.n_micro, self.v
        if S <= 1:
            return 0.0
        if self.v == 1:
            return (S - 1) / (K + S - 1)
        return 1.0 - (K * v) / self.fwd_ticks

    def activation_residency(self) -> float:
        """Peak live micro-batches of per-device layer activations (closed
        form; the planner's memory-filter input).  Derivable from table():
        see test_pipeline_schedule."""
        S, K, v = self.n_stages, self.n_micro, self.v
        if self.kind == "gpipe":
            return float(K)
        if self.kind == "1f1b":
            return float(min(K, S))
        return min(float(K), S + (S - 1) / v)

    def residency_from_table(self) -> float:
        """Peak fwd-done-not-yet-bwd chunks per device, from table(), in
        micro-batch units (chunks / v) — the cross-check for
        activation_residency()."""
        peak = 0
        live = {}
        for u in self.table():
            key = u.stage
            live.setdefault(key, 0)
            live[key] += 1 if u.direction == "fwd" else -1
            peak = max(peak, live[key])
        return peak / self.v

    def describe(self) -> str:
        v = f" v={self.v}" if self.v > 1 else ""
        return (f"{self.kind}[{self.n_stages} stages x {self.n_micro} micro"
                f"{v}] bubble={self.bubble_fraction():.3f} "
                f"resid={self.activation_residency():.1f}")


def make_schedule(kind: str, n_stages: int, n_micro: int,
                  virtual_stages: int = 1) -> PipelineSchedule:
    """Normalizing constructor: v is forced to 1 for gpipe/1f1b and defaults
    to 2 for interleaved when unspecified."""
    if kind != "interleaved":
        virtual_stages = 1
    elif virtual_stages <= 1:
        virtual_stages = 2
    return PipelineSchedule(kind=kind, n_stages=n_stages, n_micro=n_micro,
                            n_virtual_per_stage=virtual_stages)


# ---------------------------------------------------------------------------
# analytic model (planner inputs)
# ---------------------------------------------------------------------------

def pipeline_bubble_fraction(n_micro: int, n_stages: int,
                             schedule: str = "gpipe",
                             virtual_stages: int = 1) -> float:
    """Idle fraction of the schedule — the analytic SU^M input for
    pipeline-MP in the planner (per-step speedup = m * (1 - bubble))."""
    if n_stages <= 1:
        return 0.0
    return make_schedule(schedule, n_stages, n_micro,
                         virtual_stages).bubble_fraction()


def pipeline_activation_residency(n_micro: int, n_stages: int,
                                  schedule: str = "gpipe",
                                  virtual_stages: int = 1,
                                  runtime: str = "scheduled") -> float:
    """Peak live micro-batches of per-device activations — the planner's
    schedule-aware memory-filter input, keyed off the runtime that will
    actually execute the plan: the hand-scheduled runtime realizes the
    schedule's residency bound, while the ad runtime keeps all K
    micro-batch boundaries live across the fwd->bwd transpose regardless
    of schedule (so 1f1b buys nothing there)."""
    if runtime == "ad":
        return float(max(n_micro, 1))
    return make_schedule(schedule, n_stages, n_micro,
                         virtual_stages).activation_residency()


def pipeline_step_speedup(m: int, n_micro: int, comm_fraction: float = 0.0,
                          schedule: str = "gpipe",
                          virtual_stages: int = 1) -> float:
    """SU^M of m-stage pipelining with n_micro micro-batches: perfect split
    minus bubble minus inter-stage activation-transfer overhead (the caller
    scales ``comm_fraction`` by v for interleaved's extra ring traffic)."""
    if m <= 1:
        return 1.0
    eff = 1.0 - pipeline_bubble_fraction(n_micro, m, schedule, virtual_stages)
    return m * eff / (1.0 + comm_fraction)
