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
diagrams are in the JAX module's docstring.

The **scheduled** runtime executes a schedule on ``torch.distributed``
ranks, one stage a rank (``parallel.dist``): ``plan_scheduled_runtime``
compiles ``PipelineSchedule.table()`` into per-tick tables and store sizes
(the JAX tables, cell for cell), and ``pipeline_value_and_grad`` walks them
on each rank.  ``stack_to_stages`` / ``stages_to_stack`` convert a stacked
(L, ...) layer tree to the (S, v, L/(S v), ...) stage layout and back.  The
``ad`` runtime (``pipeline_apply``: JAX autodiff through the forward ring)
needs a differentiable point-to-point send and is ROADMAP.md Queue 1 item
6b.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

AD_RUNTIME = ("ROADMAP.md Queue 1 item 6b (the ad pipeline runtime: autodiff through a "
              "differentiable point-to-point ring)")

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
# stage layouts
# ---------------------------------------------------------------------------

def stack_to_stages(stacked_params, n_stages: int, virtual_stages: int = 1):
    """(L, ...) stacked layer params -> (n_stages, v, L/(n_stages*v), ...).

    Chunk c on device s holds virtual stage j = c*S + s, i.e. layers
    [j*Lc, (j+1)*Lc) — contiguous blocks, so index s of the leading dim is
    exactly stage s's parameters.  The leaves are views of the stack.
    """
    v = max(virtual_stages, 1)

    def re(a):
        L = a.shape[0]
        if L % (n_stages * v):
            raise ValueError(
                f"stack_to_stages: leading (layer) axis of size {L} is not "
                f"divisible by n_stages * virtual_stages = {n_stages} * {v} "
                f"= {n_stages * v}; pick a stage/chunk count that evenly "
                f"partitions the stack (models.api.pipeline_applicable)")
        lc = L // (n_stages * v)
        return a.reshape((v, n_stages, lc) + tuple(a.shape[1:])).transpose(0, 1)

    return tree_map(re, stacked_params)


def stages_to_stack(stage_tree, n_stages: int, virtual_stages: int = 1):
    """Inverse of ``stack_to_stages``: (n_stages, v, L/(n_stages*v), ...) ->
    (L, ...)."""
    v = max(virtual_stages, 1)

    def re(a):
        if tuple(a.shape[:2]) != (n_stages, v):
            raise ValueError(
                f"stages_to_stack: leading dims {tuple(a.shape[:2])} do not match "
                f"(n_stages={n_stages}, v={v})")
        a = a.transpose(0, 1)                  # (v, S, Lc, ...)
        return a.reshape((n_stages * v * a.shape[2],) + tuple(a.shape[3:]))

    return tree_map(re, stage_tree)


def stage_layers(n_layers: int, n_stages: int, virtual_stages: int, stage: int) -> List[int]:
    """The layers stage ``stage`` holds, in its (chunk, layer) order: chunk c
    is virtual stage c*S + stage."""
    v = max(virtual_stages, 1)
    lc = n_layers // (n_stages * v)
    return [(c * n_stages + stage) * lc + i for c in range(v) for i in range(lc)]


# ---------------------------------------------------------------------------
# hand-scheduled fwd+bwd runtime
# ---------------------------------------------------------------------------

_ZERO_TABLES = ("op", "micro", "chunk", "f_inject", "f_emit", "b_first")
_SLOT_TABLES = ("f_slot", "b_seed", "f_arr", "b_arr", "b_rd", "b_act")


@dataclasses.dataclass(frozen=True)
class ScheduledRuntimePlan:
    """Static executable form of the full fwd+bwd ``WorkUnit`` table.

    ``tables`` are (n_ticks, n_stages) int32 arrays the runtime walks:

    - ``op``        0 idle | 1 forward unit | 2 backward unit
    - ``micro`` / ``chunk``  the unit's micro-batch / device-chunk index
    - ``f_inject`` / ``f_emit``  forward unit is virtual stage 0 / vS-1
    - ``f_slot``    activation-store slot holding the forward unit's stage
                    input (written from the local micro-batch for injected
                    units, by the ring arrival otherwise)
    - ``f_arr``     slot an arriving forward activation lands in (-1 none)
    - ``b_seed``    cotangent-store slot the emit tick's loss seed lands in
    - ``b_arr``     slot an arriving ring cotangent lands in (-1 none)
    - ``b_rd``      backward unit's incoming-cotangent slot (freed)
    - ``b_act``     backward unit's stashed stage-input slot (freed)
    - ``b_first``   backward unit is virtual stage 0 (dx -> input cotangent)

    ``fwd_slots`` is the activation store size — the live-buffer high-water
    mark across stages and ticks, in stage-input (micro-batch x chunk)
    buffers.  For the v=1 schedules it equals ``activation_residency()``
    exactly: min(K, S) for 1f1b vs K for gpipe.  Interleaved stores chunk
    inputs (1/v micro-batch units each) and may buffer up to v-1
    *in-transit* chunks above residency * v.
    """
    schedule: PipelineSchedule
    n_ticks: int
    fwd_slots: int
    bwd_slots: int
    stage_high_water: Tuple[int, ...]
    tables: Dict[str, Any] = dataclasses.field(repr=False, compare=False,
                                               default_factory=dict)

    @property
    def high_water(self) -> int:
        """Peak live stashed stage-input buffers across stages (== the
        allocated store size)."""
        return max(self.stage_high_water)


class _SlotAllocator:
    """Per-stage linear-scan slot allocator (smallest free index first)."""

    def __init__(self):
        self.free: List[int] = []
        self.n = 0
        self.live = 0
        self.peak = 0

    def get(self) -> int:
        self.live += 1
        self.peak = max(self.peak, self.live)
        if self.free:
            return heapq.heappop(self.free)
        self.n += 1
        return self.n - 1

    def put(self, slot: int) -> None:
        self.live -= 1
        heapq.heappush(self.free, slot)


def plan_scheduled_runtime(sched: PipelineSchedule) -> ScheduledRuntimePlan:
    """Compile ``sched.table()`` into the per-tick tables + store sizes.

    Slot lifetimes follow the dataflow, not the unit placement: a stage
    input is allocated when it *arrives* over the ring (production tick + 1
    of the upstream forward unit) or, for injected units, at the forward
    tick itself, and freed when the mirrored backward unit consumes it.
    Within a tick every allocation lands before any free (the runtime lands
    arrivals before executing the tick's unit), so a slot freed by this
    tick's backward is not reusable by this tick's arrival.
    """
    S, K, V = sched.n_stages, sched.n_micro, sched.n_virtual
    units = sched.table()
    T = units[-1].tick + 1
    fwd_exec: Dict[Tuple[int, int], Tuple[int, int]] = {}
    bwd_exec: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for u in units:
        j = u.chunk * S + u.stage
        ex = fwd_exec if u.direction == "fwd" else bwd_exec
        ex[(u.micro, j)] = (u.tick, u.stage)
    assert len(fwd_exec) == len(bwd_exec) == K * V, sched

    tbl = {n: np.zeros((T, S), np.int32) for n in _ZERO_TABLES}
    tbl.update({n: np.full((T, S), -1, np.int32) for n in _SLOT_TABLES})

    # allocation / free events, bucketed by tick
    allocs: Dict[int, list] = {}
    frees: Dict[int, list] = {}
    for (m, j), (te, s) in sorted(fwd_exec.items()):
        if j == 0:
            allocs.setdefault(te, []).append((s, 0, "f_stash", m, j, te))
        else:
            tp, _ = fwd_exec[(m, j - 1)]
            assert tp < te, (sched, m, j)
            allocs.setdefault(tp + 1, []).append((s, 0, "f_arr", m, j, tp + 1))
        if j == V - 1:
            allocs.setdefault(te, []).append((s, 1, "b_seed", m, j, te))
    for (m, j), (tb, s) in sorted(bwd_exec.items()):
        if j < V - 1:
            tp, _ = bwd_exec[(m, j + 1)]
            assert tp < tb, (sched, m, j)
            allocs.setdefault(tp + 1, []).append((s, 1, "b_arr", m, j, tp + 1))
        frees.setdefault(tb, []).append((s, m, j))

    fsl = [_SlotAllocator() for _ in range(S)]
    bsl = [_SlotAllocator() for _ in range(S)]
    f_slot_of: Dict[Tuple[int, int], int] = {}
    b_slot_of: Dict[Tuple[int, int], int] = {}
    for t in range(T):
        for s, _, kind, m, j, ta in sorted(allocs.get(t, [])):
            if kind in ("f_stash", "f_arr"):
                slot = fsl[s].get()
                f_slot_of[(m, j)] = slot
                if kind == "f_arr":
                    assert tbl["f_arr"][ta, s] == -1, (sched, ta, s)
                    tbl["f_arr"][ta, s] = slot
            else:
                slot = bsl[s].get()
                b_slot_of[(m, j)] = slot
                if kind == "b_arr":
                    assert tbl["b_arr"][ta, s] == -1, (sched, ta, s)
                    tbl["b_arr"][ta, s] = slot
        for s, m, j in sorted(frees.get(t, [])):
            fsl[s].put(f_slot_of[(m, j)])
            bsl[s].put(b_slot_of[(m, j)])
    assert all(a.live == 0 for a in fsl + bsl), sched

    for (m, j), (te, s) in fwd_exec.items():
        tbl["op"][te, s] = 1
        tbl["micro"][te, s] = m
        tbl["chunk"][te, s] = j // S
        tbl["f_inject"][te, s] = int(j == 0)
        tbl["f_emit"][te, s] = int(j == V - 1)
        tbl["f_slot"][te, s] = f_slot_of[(m, j)]
        if j == V - 1:
            tbl["b_seed"][te, s] = b_slot_of[(m, j)]
    for (m, j), (tb, s) in bwd_exec.items():
        tbl["op"][tb, s] = 2
        tbl["micro"][tb, s] = m
        tbl["chunk"][tb, s] = j // S
        tbl["b_first"][tb, s] = int(j == 0)
        tbl["b_rd"][tb, s] = b_slot_of[(m, j)]
        tbl["b_act"][tb, s] = f_slot_of[(m, j)]

    return ScheduledRuntimePlan(
        schedule=sched, n_ticks=T,
        fwd_slots=max(a.n for a in fsl),
        bwd_slots=max(a.n for a in bsl),
        stage_high_water=tuple(a.peak for a in fsl),
        tables=tbl)


@dataclasses.dataclass
class PipelineGrads:
    """What ``pipeline_value_and_grad`` leaves on one rank."""
    loss: torch.Tensor          # 0-d f32: the summed loss, on every stage
    stage_grads: Any            # like this rank's stage_params
    loss_param_grads: Any       # like loss_params on the last stage, else None
    dx: Optional[torch.Tensor]  # cotangent of x on stage 0, else None
    high_water: int             # peak stashed stage inputs on this rank


_TAG_FWD, _TAG_BWD = 0, 1


def _seed(loss_fn: Callable, loss_params, y, target):
    """The emit tick: the loss of one finished micro-batch, its cotangent
    with respect to ``y`` and to the loss params."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(loss_params)]
    with torch.enable_grad():
        y_ = y.detach().requires_grad_()
        contrib = loss_fn(tree_unflatten(loss_params, leaves), y_, target)
        grads = torch.autograd.grad(contrib, [y_] + leaves, allow_unused=True)
    dlp = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads[1:])]
    return contrib.detach().float(), grads[0], dlp


def _stage_vjp(stage_fn: Callable, chunk_params, inp, g):
    """A backward unit: recompute ``stage_fn`` from its stashed input under
    grad and pull ``g`` back to the chunk's parameters and its input."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(chunk_params)]
    with torch.enable_grad():
        x_ = inp.detach().requires_grad_()
        y = stage_fn(tree_unflatten(chunk_params, leaves), x_)
        grads = torch.autograd.grad(y, leaves + [x_], grad_outputs=g, allow_unused=True)
    dparams = [torch.zeros_like(p) if d is None else d for p, d in zip(leaves, grads[:-1])]
    return dparams, grads[-1]


def pipeline_value_and_grad(mesh, stage_fn: Callable, stage_params, x, *,
                            loss_fn: Callable, loss_params=None, targets=None,
                            n_micro: int, schedule="gpipe",
                            virtual_stages: int = 1) -> PipelineGrads:
    """Hand-scheduled fwd+bwd pipeline step on this rank (the **scheduled**
    runtime): walks the ``plan_scheduled_runtime`` tables and runs this
    stage's ``WorkUnit`` at each tick.

    - ``mesh``: the ``parallel.dist.RankMesh``; this rank is stage
      ``mesh.model_index`` of the ``model`` axis.
    - ``stage_fn(chunk_params, x) -> y`` applies one device-chunk of layers
      (shape-preserving).  ``stage_params`` is this stage's index of the
      ``stack_to_stages`` layout: leaves (v, layers_per_chunk, ...).
    - ``x``: the stage input (B, ...) on stage 0; on the other stages any
      tensor of its shape and dtype (a ``meta`` tensor will do), since only
      the micro-batch messages are sized from it.
    - ``loss_fn(loss_params, y_micro, target_micro) -> scalar`` maps one
      finished micro-batch to its additive loss contribution; it runs on
      the last stage at the emit tick and seeds that micro-batch's backward
      wave.  ``loss_params`` and ``targets`` (B, ...) are read on the last
      stage only.

    Semantics are JAX's: the store holds stage inputs in ``fwd_slots``
    buffers; a forward unit runs ``stage_fn`` with no graph; at an emit tick
    the loss head runs and ``torch.autograd.grad`` seeds the cotangent; a
    backward unit recomputes ``stage_fn`` from the stashed input under grad,
    accumulates this chunk's parameter gradients and hands dx upstream.  A
    rank sends only the messages the tables say a peer will land (JAX's
    ``ppermute`` sends one on every tick), each tick's sends and receives in
    one ``batch_isend_irecv``; with v > 1 the ring wraps from the last
    stage to the first.  The stage gradients are this rank's (the DP sum is
    the train step's); the loss is summed over the stages.
    """
    from repro_torch.parallel import dist as D

    n_stages, stage = mesh.shape["model"], mesh.model_index
    sched = (schedule if isinstance(schedule, PipelineSchedule)
             else make_schedule(schedule, n_stages, n_micro, virtual_stages))
    if (sched.n_stages, sched.n_micro) != (n_stages, n_micro):
        raise ValueError(f"schedule {sched.describe()} does not match {n_stages} stages "
                         f"x {n_micro} micro-batches")
    v = sched.v
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != v:
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} does not match v={v} for "
                f"schedule {sched.kind!r}; pass stage {stage} of stack_to_stages(params, "
                f"{n_stages}, {v})")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} micro-batches")
    mb = b // n_micro
    act = ((mb,) + tuple(x.shape[1:]), x.dtype)
    first, last = stage == 0, stage == n_stages - 1
    xm = x.reshape((n_micro, mb) + tuple(x.shape[1:])) if first else None
    tm = (tree_map(lambda a: a.reshape((n_micro, a.shape[0] // n_micro)
                                       + tuple(a.shape[1:])), targets) if last else None)
    lp = loss_params if last and loss_params is not None else {}
    prev_rank = mesh.rank_of(mesh.data_index, stage - 1)
    next_rank = mesh.rank_of(mesh.data_index, stage + 1)

    rtp = plan_scheduled_runtime(sched)
    tb = {k: a[:, stage].tolist() for k, a in rtp.tables.items()}
    fstore: List[Optional[torch.Tensor]] = [None] * rtp.fwd_slots
    bstore: List[Optional[torch.Tensor]] = [None] * rtp.bwd_slots
    live = peak = 0
    gacc = tree_map(torch.zeros_like, stage_params)
    gacc_leaves = tree_leaves(gacc)
    lpg = [torch.zeros_like(p) for p in tree_leaves(lp)]
    dxm: List[Optional[torch.Tensor]] = [None] * n_micro
    loss_acc = torch.zeros((), dtype=torch.float32, device=mesh.device)

    def chunk(c):
        return tree_map(lambda a: a[c], stage_params)

    def put(store, slot, val):
        if store[slot] is not None:
            raise RuntimeError(f"pipeline store slot {slot} is still live")
        store[slot] = val

    for t in range(rtp.n_ticks):
        op, m, c = tb["op"][t], tb["micro"][t], tb["chunk"][t]
        sends = []
        if op == 1:                          # forward unit
            slot = tb["f_slot"][t]
            if tb["f_inject"][t]:
                put(fstore, slot, xm[m])
                live += 1
                peak = max(peak, live)
            with torch.no_grad():
                y = stage_fn(chunk(c), fstore[slot])
            if tb["f_emit"][t]:
                target = tree_map(lambda a: a[m], tm)
                contrib, dy, dlp = _seed(loss_fn, lp, y, target)
                put(bstore, tb["b_seed"][t], dy)
                loss_acc += contrib
                for acc, d in zip(lpg, dlp):
                    acc.add_(d)
            else:
                sends.append((y, next_rank, _TAG_FWD))
        elif op == 2:                        # backward unit
            g, bstore[tb["b_rd"][t]] = bstore[tb["b_rd"][t]], None
            inp, fstore[tb["b_act"][t]] = fstore[tb["b_act"][t]], None
            live -= 1
            dparams, dx = _stage_vjp(stage_fn, chunk(c), inp, g)
            for acc, d in zip(gacc_leaves, dparams):
                acc[c].add_(d)
            if tb["b_first"][t]:
                dxm[m] = dx
            else:
                sends.append((dx, prev_rank, _TAG_BWD))
        recvs = []
        if t + 1 < rtp.n_ticks:
            if tb["f_arr"][t + 1] >= 0:
                recvs.append((*act, prev_rank, _TAG_FWD))
            if tb["b_arr"][t + 1] >= 0:
                recvs.append((*act, next_rank, _TAG_BWD))
        got = iter(D.exchange(mesh, sends, recvs))
        if t + 1 < rtp.n_ticks:              # land the arrivals of tick t + 1
            if tb["f_arr"][t + 1] >= 0:
                put(fstore, tb["f_arr"][t + 1], next(got))
                live += 1
                peak = max(peak, live)
            if tb["b_arr"][t + 1] >= 0:
                put(bstore, tb["b_arr"][t + 1], next(got))
    if live or any(s is not None for s in fstore + bstore):
        raise RuntimeError("pipeline store not empty after the last tick")

    loss = D.all_reduce(mesh, loss_acc, "model")
    dx = torch.cat(dxm).reshape(x.shape) if first else None
    return PipelineGrads(loss=loss, stage_grads=gacc,
                         loss_param_grads=tree_unflatten(lp, lpg) if last else None,
                         dx=dx, high_water=peak)


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
