"""Fault-tolerant multi-replica request router over ``ContinuousEngine``
(port of ``repro/serve/router.py``).

This is the serving side of the planner's ``replicas`` axis:
``HybridPlanner.best_inference`` picks a (replicas x tp, slots) layout and
``ReplicaRouter.from_choice`` builds it: N independent continuous-batching
engines, each on its own group of tp ranks when tp > 1, behind one
admission front door with least-loaded dispatch.  Robustness is the point:
at the scale where multi-group layouts win, replica failure is the norm,
and a replica dying must not lose its in-flight requests.

Failover state machine
======================

Per replica::

    healthy --kill fault/process loss--------------> dead
    healthy --watchdog timeout (stall)-------------> degraded
    healthy --non-finite logprob (nanlogits)-------> degraded
    healthy --drain_replica()----------------------> draining --empty--> removed

- **healthy**: dispatchable, stepped every router tick.  Health is
  observed, not assumed: each engine step runs inside an armed
  ``train.fault.Watchdog`` (tick-progress heartbeat), and every logprob
  the replica emits is checked for NaN/Inf.
- **dead**: the engine is gone (simulated SIGKILL).  Its state is
  unreachable: recovery uses only the ROUTER-side streaming records
  (progress through the replica's last completed tick).
- **degraded**: the engine object still exists but is quarantined: a
  replica that hangs past the watchdog or emits non-finite logits cannot
  be trusted with further work.  Its requests are harvested exactly like
  a dead replica's (for nanlogit faults the generated suffix from the
  first non-finite logprob onward is discarded: those tokens came from
  poisoned math).
- **draining/removed**: elastic shrink: no new dispatch, in-flight work
  finishes, then the replica is removed.  ``add_replica()`` is the
  matching grow.

Per request::

    submitted --dispatch--> on replica r --finish--> result (exactly once)
        |                        |
        | projected wait >       | replica dead/degraded
        |   deadline             v
        +--> shed            retry wait (capped exponential backoff)
                                 |  deadline-aware: a retry that cannot
                                 |  start before the deadline times out
                                 v
                             re-dispatched with replay_tokens

Failover re-dispatch is **bit-identical** to an unfaulted run: every
replica engine shares the same base seed, sampling draws are (seed, rid,
n_gen)-keyed (independent of batch and replica placement), a row's bits
never depend on the other rows or on its slot (the flash kernel's split is
planned from the capacity), and the new replica re-prefills the prompt in
the same chunks as a fresh run, then REPLAYS the already-generated tokens
through the same decode ticks that produced them (``Request.replay_tokens``)
instead of re-prefilling prompt + generated in one shot (which would
reorder attention reductions and drift in the last bits).

Fault injection reuses the ``train.fault`` schedule grammar, replica-keyed:
``kill@N:R`` (replica R dies before router tick N), ``stall@N:R:SECS``
(replica R hangs inside tick N; the watchdog flags it), ``nanlogits@N:R``
(replica R's tick N emits NaN logprobs).  A fault at tick N fires when
tick N is *about to run*, so schedules are reproducible.

Load shedding: admission is bounded twice: per-engine ``max_queue`` (hard
bound on queued requests) and, for deadline-carrying requests, a
projected-wait check: ``backlog_tokens x EWMA(step seconds)`` on the
least-loaded replica; if that already overshoots the deadline the request
is shed at the door (``finished_reason="shed"``) instead of timing out
after consuming resources.  Every submitted rid lands in ``results``
exactly once: completed, shed, or timed out.

What the router reads of an engine
==================================

After each tick a replica leaves a ``_Record``: the tokens and logprobs of
every request it holds, its finished results, its queue and active counts,
its backlog tokens, the tick's seconds and the watchdog's flag.  Dispatch,
shedding, the mirror and the health checks read only these records and the
router's own count of what it dispatched since, never an engine.  Each
result's ``first_token_s`` is the router's: from its ``submit`` to the
first token it mirrors, kept across a failover (the user's wait, not the
last engine's).

In one process (``mesh=None``) every replica's engine lives here, all on
``api.device`` and all holding the same ``params`` tensors (weights are
not copied per replica); the replicas step one after another.

On ranks (``mesh``: this rank's ``parallel.dist.RankMesh`` of shape
``{"data": replicas, "model": tp}``) replica r is the group of ranks whose
``data_index`` is r, and each rank builds only its own replica's engine
(tensor-parallel over its ``"model"`` group, no batch axes: the group holds all its
slots).  JAX's single controller takes each decision once; here every rank
holds the whole router state and takes each decision itself, so they must
agree or the rings hang:

- the router reads rank 0's clock, broadcast over all ranks at each
  ``step()`` and ``submit()``;
- after each tick every rank's record is gathered over all ranks
  (``dist.all_gather_objects``): a replica's record is its group's first
  rank's, with the watchdog flag of any rank of the group; the EWMA is
  updated from them in replica order, as one process does;
- faults are known to every rank from the schedule; a dead or degraded
  replica's ranks stop stepping but join every broadcast and gather until
  the run ends;
- ``add_replica`` raises: a replica's ranks are fixed with the mesh.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import dist as D
from repro_torch.serve.continuous import (ContinuousEngine, Request, RequestResult,
                                          check_request)
from repro_torch.train.fault import Fault, Watchdog

REPLICA_FAULT_KINDS = ("kill", "stall", "nanlogits")


@dataclasses.dataclass
class _Replica:
    idx: int
    engine: Optional[ContinuousEngine]   # None when dead, or on another group's ranks
    state: str = "healthy"   # healthy|degraded|dead|draining|removed
    stalled: bool = False    # set by the watchdog thread, read post-step
    # the router's view of the engine: its last record plus what was
    # dispatched to it since
    queued: int = 0
    active: int = 0
    backlog: int = 0         # tokens still to generate: queued budgets + active remainders
    decode_ticks: int = 0    # the engine's counts, kept after it is dropped
    prefill_chunks: int = 0

    @property
    def live(self) -> bool:
        return self.state in ("healthy", "draining")


@dataclasses.dataclass
class _Record:
    """What one replica's tick left behind: all the router reads of it."""
    progress: Dict[int, Tuple[List[int], List[float]]]   # rid -> tokens, logprobs
    results: List[RequestResult]
    queued: int
    active: int
    backlog: int
    seconds: float           # the step's seconds, an injected stall included
    stalled: bool
    decode_ticks: int
    prefill_chunks: int


@dataclasses.dataclass
class _Tracked:
    """Router-side streaming record for one in-flight rid: the original
    request plus progress mirrored after every completed replica tick,
    the only thing failover from a DEAD replica can recover from."""
    req: Request
    replica: Optional[int]           # None while waiting for a retry slot
    submitted: float                 # host perf_counter() at submit()
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    failovers: int = 0
    ready_at: float = 0.0            # retry backoff gate (absolute)
    deadline: Optional[float] = None  # absolute; None = no deadline
    first_token_s: Optional[float] = None


def _valid_prefix(tokens: Sequence[int], logprobs: Sequence[float]):
    """Progress up to (excluding) the first non-finite logprob: everything
    from poisoned math onward is untrusted and must be regenerated."""
    for i, lp in enumerate(logprobs):
        if not math.isfinite(lp):
            return list(tokens[:i]), list(logprobs[:i])
    return list(tokens), list(logprobs)


class ReplicaRouter:
    """See module docstring.  ``faults`` takes replica-keyed ``Fault``s
    (``train.fault.parse_fault_schedule`` forms ``kill@N:R`` /
    ``stall@N:R:SECS`` / ``nanlogits@N:R``); training-form faults (no
    replica) are rejected.  ``mesh`` puts the replicas on rank groups (JAX
    takes a mesh a replica, ``meshes``): each engine is tensor-parallel over
    the mesh's ``"model"`` axis.  ``clock``/``sleep_fn``
    are injectable for deterministic tests; the watchdog and injected
    stalls use real time (the watchdog is a timer thread)."""

    def __init__(self, api, params, *, replicas: int, n_slots: int,
                 capacity: int, prefill_chunk: int = 0,
                 temperature: float = 0.0, seed: int = 0, mesh=None,
                 max_queue: Optional[int] = None,
                 faults: Sequence[Fault] = (),
                 watchdog_timeout_s: Optional[float] = None,
                 watchdog_warmup_ticks: int = 2,
                 retry_backoff_s: float = 0.05,
                 max_retry_backoff_s: float = 1.0,
                 est_step_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 log_fn: Callable[[str], None] = lambda m: None):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if mesh is not None and mesh.shape["data"] != replicas:
            raise ValueError(f"a mesh of {mesh.shape['data']} replica groups "
                             f"({mesh.shape}) for {replicas} replicas")
        for f in faults:
            if f.kind not in REPLICA_FAULT_KINDS or f.replica is None:
                raise ValueError(
                    f"router faults must be replica-keyed "
                    f"{REPLICA_FAULT_KINDS} (kind@tick:replica...), got "
                    f"{f.kind}@{f.step} with replica={f.replica}")
        self._api, self._params, self._mesh = api, params, mesh
        self._engine_kw = dict(
            n_slots=n_slots, capacity=capacity, prefill_chunk=prefill_chunk,
            temperature=temperature, seed=seed, max_queue=max_queue, clock=clock)
        self._max_queue = max_queue
        self.replicas: List[_Replica] = []
        for r in range(replicas):
            self.replicas.append(_Replica(r, self._make_engine(r)))
        # every engine has one geometry: requests are checked against it on
        # every rank, whichever replica takes them
        eng = next(r.engine for r in self.replicas if r.engine is not None)
        self._geometry = (capacity, prefill_chunk, eng._prefill_grid)
        self.faults = [dataclasses.replace(f) for f in faults]
        self.fault_log: List[tuple] = []     # (kind, tick, replica)
        self._clock, self._sleep, self._log = clock, sleep_fn, log_fn
        self._watchdog = (Watchdog(watchdog_timeout_s, self._on_stall)
                          if watchdog_timeout_s is not None else None)
        # the first steps pay the kernels' build and cuBLAS's set-up
        # (seconds, against milliseconds warm): arming the heartbeat there
        # would flag them as a stall on every replica
        self._watchdog_warmup = watchdog_warmup_ticks
        self.retry_backoff_s = retry_backoff_s
        self.max_retry_backoff_s = max_retry_backoff_s
        self._est_step_s = est_step_s        # EWMA seconds per engine step
        self.ticks = 0
        self.tracked: Dict[int, _Tracked] = {}
        self.results: List[RequestResult] = []
        self.stats = {"completed": 0, "shed": 0, "timed_out": 0,
                      "failovers": 0}

    def _make_engine(self, idx: int) -> Optional[ContinuousEngine]:
        if self._mesh is None:
            return ContinuousEngine(self._api, self._params, **self._engine_kw)
        if idx != self._mesh.data_index:
            return None                      # another group's ranks hold it
        return ContinuousEngine(self._api, self._params, mesh=self._mesh, model_axis="model",
                                batch_axes=(), **self._engine_kw)

    @classmethod
    def from_choice(cls, api, params, choice, *, capacity: int, mesh=None, **kw):
        """Build the router an ``InferenceChoice`` plans: ``choice.replicas``
        engines with ``choice.slots`` request lanes each, in this process
        at ``choice.tp`` 1 without a ``mesh``; else each on a group of tp
        ranks of ``mesh`` (this rank's ``RankMesh`` of shape (replicas,
        tp)), tensor-parallel inside the group."""
        if choice.tp == 1 and mesh is None:
            return cls(api, params, replicas=choice.replicas, n_slots=choice.slots,
                       capacity=capacity, **kw)
        need = choice.replicas * choice.tp
        shape = None if mesh is None else (mesh.shape["data"], mesh.shape["model"])
        if shape != (choice.replicas, choice.tp):
            raise ValueError(
                f"choice needs {choice.replicas} x {choice.tp} = {need} ranks: "
                f"a RankMesh of shape ({choice.replicas}, {choice.tp}) (data, model), "
                f"got {'no mesh' if mesh is None else shape}")
        return cls(api, params, replicas=choice.replicas, n_slots=choice.slots,
                   capacity=capacity, mesh=mesh, **kw)

    # -- health ---------------------------------------------------------------

    def _on_stall(self, idx: int) -> None:
        self.replicas[idx].stalled = True

    @property
    def replica_states(self) -> List[str]:
        return [r.state for r in self.replicas]

    @property
    def decode_ticks(self) -> int:
        """Decode ticks run by every engine of the router, dead ones included."""
        return sum(r.decode_ticks for r in self.replicas)

    @property
    def prefill_chunks(self) -> int:
        """Prefill chunks run by every engine of the router, dead ones included."""
        return sum(r.prefill_chunks for r in self.replicas)

    def _healthy(self) -> List[_Replica]:
        return [r for r in self.replicas if r.state == "healthy"]

    def _now(self) -> float:
        """The router's clock; on ranks rank 0's, broadcast to every rank."""
        if self._mesh is None:
            return self._clock()
        t = torch.tensor([self._clock()], dtype=torch.float64, device=self._mesh.device)
        return float(D.broadcast(self._mesh, t, None))

    # -- admission ------------------------------------------------------------

    def submit(self, req: Request) -> Optional[RequestResult]:
        """Admit ``req``.  Returns ``None`` on acceptance or the shaped
        shed/timeout result on rejection; duplicate in-flight rids and
        requests no engine of the router's geometry can serve raise (as
        ``ContinuousEngine.submit``)."""
        if req.rid in self.tracked:
            raise ValueError(
                f"request {req.rid}: a request with rid {req.rid} is "
                f"already in flight on the router")
        check_request(req, *self._geometry)
        now = self._now()
        tr = _Tracked(req=req, replica=None, submitted=time.perf_counter(),
                      deadline=(now + req.deadline_s
                                if req.deadline_s is not None else None))
        self.tracked[req.rid] = tr
        return self._dispatch(tr, now)

    def _dispatch(self, tr: _Tracked, now: float):
        """Least-loaded dispatch with projected-wait shedding.  Returns the
        shaped result on shed/timeout, else None."""
        cands = self._healthy()
        if not cands:
            if any(r.state == "draining" for r in self.replicas):
                # shrink in progress: hold in the retry queue until the
                # drain finishes or the deadline expires
                tr.replica, tr.ready_at = None, now
                return None
            return self._finalize(tr, "shed")
        rep = min(cands, key=lambda r: (r.queued + r.active, r.idx))
        if tr.deadline is not None:
            remaining = tr.deadline - now
            if remaining <= 0:
                return self._finalize(tr, "timed_out")
            projected = rep.backlog * self._est_step_s
            if projected > remaining:
                self._log(f"[router] shed rid={tr.req.rid}: projected wait "
                          f"{projected:.3f}s > deadline {remaining:.3f}s")
                return self._finalize(tr, "shed")
        if self._max_queue is not None and rep.queued >= self._max_queue:
            return self._finalize(tr, "shed")        # the engine's bounded queue
        req = dataclasses.replace(
            tr.req, replay_tokens=tuple(tr.tokens),
            replay_logprobs=tuple(tr.logprobs),
            deadline_s=(tr.deadline - now
                        if tr.deadline is not None else None))
        if rep.engine is not None and rep.engine.submit(req) is not None:
            raise RuntimeError(f"replica {rep.idx} shed request {req.rid} with "
                               f"{rep.queued} queued by the router's count")
        rep.queued += 1
        rep.backlog += req.max_new_tokens
        tr.replica = rep.idx
        return None

    def _finalize(self, tr: _Tracked, reason: str,
                  res: Optional[RequestResult] = None) -> RequestResult:
        if res is None:
            res = RequestResult(rid=tr.req.rid,
                                prompt_len=len(tr.req.tokens),
                                tokens=list(tr.tokens),
                                logprobs=list(tr.logprobs),
                                finished_reason=reason,
                                first_token_s=tr.first_token_s)
        self.results.append(res)
        self.stats["completed" if reason in ("eos", "length")
                   else reason] += 1
        del self.tracked[tr.req.rid]
        return res

    # -- failover -------------------------------------------------------------

    def _failover(self, tr: _Tracked, now: float) -> None:
        """Replica loss: keep the trusted progress prefix, park the request
        behind a capped exponential backoff, deadline-aware."""
        tr.tokens, tr.logprobs = _valid_prefix(tr.tokens, tr.logprobs)
        if not tr.tokens:
            tr.first_token_s = None          # its first token was poisoned
        tr.replica = None
        tr.failovers += 1
        self.stats["failovers"] += 1
        backoff = min(self.retry_backoff_s * (2 ** (tr.failovers - 1)),
                      self.max_retry_backoff_s)
        tr.ready_at = now + backoff
        if tr.deadline is not None and tr.ready_at >= tr.deadline:
            self._finalize(tr, "timed_out")  # retry could never finish
            return
        self._log(f"[router] failover rid={tr.req.rid} "
                  f"({len(tr.tokens)} tokens kept, retry in {backoff:.3f}s)")

    def _harvest(self, rep: _Replica, now: float) -> None:
        """Pull every request assigned to ``rep`` back into the retry
        queue.  Uses the ROUTER-side records: a dead replica's engine
        state is unreachable by definition."""
        for tr in [t for t in self.tracked.values()
                   if t.replica == rep.idx]:
            self._failover(tr, now)

    def drain_replica(self, idx: int) -> None:
        """Elastic shrink: stop dispatching to replica ``idx``; its
        in-flight work finishes, then it is removed."""
        rep = self.replicas[idx]
        if rep.state == "healthy":
            rep.state = "draining"

    def add_replica(self) -> int:
        """Elastic grow: append a fresh healthy replica (same engine
        geometry; same seed, so failover onto it stays bit-identical)."""
        if self._mesh is not None:
            raise ValueError("add_replica on ranks: a replica's ranks are fixed when the "
                             "mesh is made; start the run with the replica groups it needs")
        idx = len(self.replicas)
        self.replicas.append(_Replica(idx, self._make_engine(idx)))
        return idx

    # -- one router tick ------------------------------------------------------

    def _pending_faults(self, kind: str, tick: int, idx: int) -> List[Fault]:
        return [f for f in self.faults if f.kind == kind and f.step == tick
                and f.replica == idx and f.times > 0]

    def _run_engine(self, rep: _Replica, stall_s: float) -> _Record:
        """One engine step under the armed watchdog heartbeat, and its record."""
        armed = (self._watchdog is not None
                 and self.ticks >= self._watchdog_warmup)
        if armed:
            self._watchdog.arm(rep.idx)
        if stall_s > 0.0:
            self._sleep(stall_s)         # hang INSIDE the armed window
        t0 = self._clock()
        eng = rep.engine
        eng.step()
        dt = self._clock() - t0 + stall_s
        if armed:
            self._watchdog.disarm()
        rec = _Record(
            progress={st.req.rid: (list(st.tokens), list(st.logprobs))
                      for st in eng.active.values()},
            results=list(eng.results), queued=len(eng.queue), active=len(eng.active),
            backlog=(sum(r.max_new_tokens for r in eng.queue)
                     + sum(st.req.max_new_tokens - st.n_gen for st in eng.active.values())),
            seconds=dt, stalled=rep.stalled, decode_ticks=eng.decode_ticks,
            prefill_chunks=eng.prefill_chunks)
        eng.results.clear()
        return rec

    def _gather(self, mine: Dict[int, _Record], idxs: List[int]) -> Dict[int, _Record]:
        """Every stepped replica's record on every rank: its group's first
        rank's, flagged stalled if any rank of the group's watchdog fired."""
        every = D.all_gather_objects(self._mesh, mine.get(self._mesh.data_index))
        tp = self._mesh.shape["model"]
        out = {}
        for idx in idxs:
            group = every[idx * tp:(idx + 1) * tp]
            out[idx] = dataclasses.replace(group[0], stalled=any(r.stalled for r in group))
        return out

    def _absorb(self, rep: _Replica, rec: _Record, now: float) -> None:
        """Mirror a replica's tick into the router: the EWMA, the load, each
        request's progress (what failover from a dead replica recovers),
        finished results (poisoned ones are NOT delivered), and the health
        checks."""
        self._est_step_s = (rec.seconds if self._est_step_s <= 0.0
                            else 0.8 * self._est_step_s + 0.2 * rec.seconds)
        rep.queued, rep.active, rep.backlog = rec.queued, rec.active, rec.backlog
        rep.decode_ticks, rep.prefill_chunks = rec.decode_ticks, rec.prefill_chunks
        seen = time.perf_counter()
        poisoned = False
        for rid, (tokens, logprobs) in rec.progress.items():
            tr = self.tracked.get(rid)
            if tr is not None:
                tr.tokens, tr.logprobs = list(tokens), list(logprobs)
                if tr.tokens and tr.first_token_s is None:
                    tr.first_token_s = seen - tr.submitted
                if logprobs and not math.isfinite(logprobs[-1]):
                    poisoned = True
        for res in rec.results:
            tr = self.tracked.get(res.rid)
            if tr is None:
                continue                 # already accounted (defensive)
            if any(not math.isfinite(lp) for lp in res.logprobs):
                poisoned = True
                tr.tokens, tr.logprobs = _valid_prefix(res.tokens, res.logprobs)
            else:
                if res.tokens and tr.first_token_s is None:
                    tr.first_token_s = seen - tr.submitted
                self._finalize(tr, res.finished_reason,
                               dataclasses.replace(res, first_token_s=tr.first_token_s))
        if rec.stalled or poisoned:
            why = "stalled past watchdog" if rec.stalled else "NaN/Inf logits"
            self._log(f"[router] replica {rep.idx} degraded ({why})")
            rep.state = "degraded"
            self._harvest(rep, now)
        elif rep.state == "draining" and not (rep.active or rep.queued):
            rep.state, rep.engine = "removed", None

    def step(self) -> bool:
        """One router tick: fire scheduled faults, re-dispatch ready
        retries, step every live replica under the watchdog, mirror
        progress, collect results, quarantine unhealthy replicas.
        Returns True while any request is in flight."""
        tick = self.ticks + 1
        now = self._now()

        # (1) re-dispatch retries whose backoff has elapsed
        for tr in list(self.tracked.values()):
            if tr.replica is None:
                if tr.deadline is not None and now >= tr.deadline:
                    self._finalize(tr, "timed_out")
                elif now >= tr.ready_at:
                    self._dispatch(tr, now)

        # (2) scheduled faults fire when tick N is about to run
        stepped: List[Tuple[_Replica, float]] = []
        for rep in self.replicas:
            if not rep.live:
                continue
            killed = False
            for f in self._pending_faults("kill", tick, rep.idx):
                f.times = 0
                killed = True
            if killed:
                self.fault_log.append(("kill", tick, rep.idx))
                self._log(f"[router] replica {rep.idx} killed before "
                          f"tick {tick}")
                rep.state, rep.engine = "dead", None
                self._harvest(rep, now)
                continue
            for f in self._pending_faults("nanlogits", tick, rep.idx):
                f.times = 0
                self.fault_log.append(("nanlogits", tick, rep.idx))
                if rep.engine is not None:
                    rep.engine.poison_decode_ticks(1)
            stall_s = 0.0
            for f in self._pending_faults("stall", tick, rep.idx):
                f.times = 0
                self.fault_log.append(("stall", tick, rep.idx))
                stall_s += f.seconds
            stepped.append((rep, stall_s))

        # (3) one step of each live engine held here, then (on ranks) every
        # replica's record on every rank; (4) mirrored in replica order
        records = {rep.idx: self._run_engine(rep, stall_s)
                   for rep, stall_s in stepped if rep.engine is not None}
        if self._mesh is not None:
            records = self._gather(records, [rep.idx for rep, _ in stepped])
        for rep, _ in stepped:
            self._absorb(rep, records[rep.idx], now)

        self.ticks = tick
        if self.tracked and not any(r.live for r in self.replicas):
            raise RuntimeError(
                f"{len(self.tracked)} request(s) in flight but no live "
                f"replica remains (states: {self.replica_states})")
        return bool(self.tracked)

    def run(self, requests: Sequence[Request]) -> List[RequestResult]:
        """Submit everything, step until every rid has a result (exactly
        one per submitted rid), return results ordered by rid."""
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return sorted(self.results, key=lambda r: r.rid)

    def close(self) -> None:
        if self._watchdog is not None:
            self._watchdog.close()
