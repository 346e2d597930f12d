r"""Continuous-batching serving engine over a slotted KV cache (port of
``repro/serve/continuous.py``).

Slot/admission model
====================

The engine owns ONE slotted cache (``models.api.make_slot_cache``):
``n_slots`` independent request lanes, each a linear KV region of
``capacity`` positions with its own write position (``cache["pos"]`` is
(n_slots,) int32 on the device).  Requests flow through three states:

    queued --admit--> prefilling --last chunk--> decoding --eos/budget--> done
                       (slot held)                (slot held)            (slot freed)
         \________________________ deadline_s ________________________/
          an expired request exits from ANY state at the next step():
          slot freed, partial tokens returned flagged "timed_out"

Per ``step()`` the engine (1) **admits** queued requests into free slots,
(2) runs ONE prefill chunk for the head-of-line prefilling request (so a
long prompt does not stall the running batch: decode ticks interleave
between its chunks), (3) runs ONE decode tick over ALL slots with an
active-row mask, (4) **evicts** finished requests (EOS or token budget)
and frees their slots for the next admission.  Every launch has a fixed
shape: admission and eviction only edit slot rows and the mask, and a
row's attention reads only its own keys (the flash kernel's per-row key
lengths, its split planned from the capacity), so joining requests never
perturb the tokens of requests already in flight.

The tick and the chunk are ``train.steps.make_continuous_steps``'s: both
run attention on the hand-written flash kernel with per-row key lengths
(``kernels.flash_attention``, ``kv_lens``).  The multi-replica router is
ROADMAP.md item 10.

On ranks
========

With ``mesh`` (this rank's ``parallel.dist.RankMesh``) every rank of the
mesh runs an engine with the same arguments and the same requests; each
holds its part of the slot cache (``parallel.sharding.slot_cache_part``:
its data group's slots, its KV heads under tensor MP) and, under a
``model_axis``, its part of the weights (``serve_tp_part`` of the whole
tree it is given).  The tick runs on the tensor-MP rings (or whole on each
rank of a context ring), a chunk on the data group that holds its slot
(tensor-MP or context-parallel).  JAX's single controller takes every
decision once; here each rank takes them itself, so they must agree or the
rings hang:

- the scheduler reads one clock: rank 0's, broadcast to every rank at each
  ``step()`` and at each ``submit()`` of a request with a deadline, so
  admission, eviction, shedding and expiry are the same everywhere;
- each data group samples only its own slots and the tokens and logprobs
  are all-gathered over the data axes before any engine reads them (the
  tick's return), and a chunk's last logits come from the group that holds
  the slot; under tensor MP every model rank computes the head on the same
  gathered rows, so it samples the same bits.

A sharded prefill pads a chunk to the ring's grid; ``submit`` refuses a
request whose padded prompt would overflow its slot (JAX's guard).

Sampling: greedy is argmax, as JAX's (the same tokens on the same logits).
With a temperature each draw comes from a ``torch.Generator`` seeded from
``(seed, request id, tokens generated)``, so a request's random stream does
not depend on which other requests share its batch (JAX's property; the
bits are not JAX's, whose keys fold the same triple into a PRNGKey).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.api import ModelApi, cache_evict_slot
from repro_torch.parallel import dist as D
from repro_torch.parallel.sharding import serve_tp_part, slot_cache_part, slot_range
from repro_torch.train.steps import make_continuous_steps, sample_tokens


@dataclasses.dataclass
class Request:
    rid: int
    tokens: Sequence[int]            # prompt token ids
    max_new_tokens: int
    eos_id: Optional[int] = None
    # TTL in seconds from submit().  Once expired the request is evicted,
    # queued or mid-flight, its slot freed, and its result returned with
    # finished_reason="timed_out" and whatever tokens were generated.
    deadline_s: Optional[float] = None
    # Failover resume: tokens this request already generated elsewhere, and
    # their logprobs.  The engine prefills the prompt as a fresh run would,
    # then REPLAYS these tokens through the same decode ticks that produced
    # them (forced instead of sampled), so the continuation is bit-identical
    # to a run that never failed over.
    replay_tokens: Sequence[int] = ()
    replay_logprobs: Sequence[float] = ()


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: List[int]                # generated ids (stop token included)
    logprobs: List[float]
    finished_reason: str             # "eos" | "length" | "timed_out" | "shed"
    # host seconds from submit() to the first token; None if none came
    first_token_s: Optional[float] = None


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    submitted: float                 # host perf_counter() at submit()
    consumed: int = 0                # prompt tokens prefilled so far
    n_gen: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    last_logits: Optional[torch.Tensor] = None   # set once prefill completes
    first_token_s: Optional[float] = None

    @property
    def decoding(self) -> bool:
        return self.last_logits is not None


class ContinuousEngine:
    """See module docstring.  ``prefill_chunk=0`` prefills each prompt in
    one shot (still interleaved with decode ticks); > 0 caps the tokens per
    prefill step.  ``mesh`` / ``model_axis`` / ``batch_axes`` /
    ``comm_chunks`` put the tick (and the chunk) on the tensor-MP rings,
    ``context_axis`` the chunk on the context ring (``make_continuous_steps``
    routes).  ``params`` is the whole tree on every rank.  ``clock`` drives
    the deadlines (injectable for tests; on ranks, rank 0's is read).

    Host-clock timings, kept for the launcher and the chip run, in bounded
    state: ``tick_ms_sum`` / ``tick_ms_min`` / ``tick_ms_max`` over the
    ``decode_ticks`` ticks (each ending with its tokens on the host), and each
    result's ``first_token_s``."""

    def __init__(self, api: ModelApi, params, *, n_slots: int, capacity: int,
                 prefill_chunk: int = 0, temperature: float = 0.0,
                 seed: int = 0, mesh=None, model_axis: Optional[str] = None,
                 batch_axes=(), comm_chunks: int = 1,
                 window=None, context_axis: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.api = api
        self.mesh = mesh
        self.device = api.device
        self.n_slots = n_slots
        self.capacity = capacity
        self.prefill_chunk = prefill_chunk
        self.temperature = temperature
        self.seed = seed
        self.max_queue = max_queue    # bound on queued (not yet admitted) requests
        self._clock = clock
        self._deadline: Dict[int, float] = {}    # rid -> absolute deadline
        (self._decode_tick, self._prefill_chunk,
         self._prefill_grid) = make_continuous_steps(
            api, n_slots=n_slots, temperature=temperature, mesh=mesh,
            model_axis=model_axis, batch_axes=batch_axes, comm_chunks=comm_chunks,
            window=window, context_axis=context_axis)
        if mesh is not None and model_axis is not None:
            j, m = mesh.ring(model_axis)[:2]
            params = serve_tp_part(params, api.cfg, j, m)
        self.params = params
        self._slots = slot_range(n_slots, mesh, batch_axes)
        self.cache = slot_cache_part(api.cfg, n_slots, capacity, mesh=mesh,
                                     model_axis=model_axis, batch_axes=batch_axes,
                                     device=self.device)
        self.queue: List[Request] = []
        self.active: Dict[int, _Active] = {}       # slot -> state
        self.results: List[RequestResult] = []
        self.ticks = 0                # completed step() count (heartbeat)
        self.decode_ticks = 0         # steps that ran a decode tick
        self.prefill_chunks = 0
        self.tick_ms_sum = 0.0
        self.tick_ms_min = float("inf")
        self.tick_ms_max = 0.0
        self._submitted: Dict[int, float] = {}   # rid -> submit time, while queued
        self._poison_ticks = 0        # fault hook: decode ticks to NaN out

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request) -> Optional[RequestResult]:
        """Enqueue ``req``.  Returns ``None`` on acceptance; when
        ``max_queue`` is set and the queue is full, the request is REJECTED
        with ``RequestResult(finished_reason="shed")`` (appended to
        ``results`` and returned).  A rid already in flight raises:
        deadlines and results are keyed by rid."""
        in_flight = ({r.rid for r in self.queue}
                     | {st.req.rid for st in self.active.values()})
        if req.rid in in_flight:
            raise ValueError(
                f"request {req.rid}: a request with rid {req.rid} is already "
                f"in flight (queued or holding a slot) — rids key deadlines "
                f"and results, so submit each rid at most once until its "
                f"result is returned")
        n = len(req.tokens)
        if n + req.max_new_tokens > self.capacity:
            raise ValueError(
                f"request {req.rid}: prompt ({n}) + max_new_tokens "
                f"({req.max_new_tokens}) = {n + req.max_new_tokens} exceeds "
                f"slot capacity {self.capacity}")
        if len(req.replay_tokens) != len(req.replay_logprobs):
            raise ValueError(
                f"request {req.rid}: {len(req.replay_tokens)} replay tokens "
                f"but {len(req.replay_logprobs)} replay logprobs — the "
                f"failover resume needs one logprob per replayed token")
        if len(req.replay_tokens) > req.max_new_tokens:
            raise ValueError(
                f"request {req.rid}: {len(req.replay_tokens)} replay tokens "
                f"exceed max_new_tokens ({req.max_new_tokens})")
        if self._prefill_grid > 1:
            # a sharded prefill pads the final chunk up to the ring's grid;
            # the pad rows must still land inside the slot's linear region
            t_f = (n if self.prefill_chunk <= 0
                   else (n % self.prefill_chunk or self.prefill_chunk))
            pad = -t_f % self._prefill_grid
            if n + pad > self.capacity:
                raise ValueError(
                    f"request {req.rid}: prompt ({n}) + sharded-prefill pad "
                    f"({pad}, grid {self._prefill_grid}) exceeds slot "
                    f"capacity {self.capacity} — grow capacity by the pad "
                    f"slack or align the prompt to the chunk grid")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            res = RequestResult(rid=req.rid, prompt_len=n, tokens=[],
                                logprobs=[], finished_reason="shed")
            self.results.append(res)
            return res
        if req.deadline_s is not None:
            self._deadline[req.rid] = self._now() + req.deadline_s
        self._submitted[req.rid] = time.perf_counter()
        self.queue.append(req)
        return None

    def take_queued(self) -> List[Request]:
        """Remove and return every not-yet-admitted request (a router's
        drain/failover hook: queued requests hold no slot state)."""
        out, self.queue = self.queue, []
        for r in out:
            self._deadline.pop(r.rid, None)
            self._submitted.pop(r.rid, None)
        return out

    def poison_decode_ticks(self, n: int = 1) -> None:
        """Fault hook: the next ``n`` decode ticks return NaN logprobs (and
        token 0) for every live row, as a replica whose math went bad would.
        Consumed only by ticks that decode."""
        self._poison_ticks += n

    def _now(self) -> float:
        """The scheduler's clock: ``clock()``, on ranks rank 0's (broadcast to
        every rank, so every rank's decisions agree)."""
        if self.mesh is None:
            return self._clock()
        t = torch.tensor([self._clock()], dtype=torch.float64, device=self.mesh.device)
        return float(D.broadcast(self.mesh, t, None))

    def _expire(self):
        """Evict every request past its deadline: mid-flight requests free
        their slot (partial tokens returned), queued ones never admit."""
        now = self._now()
        for st in list(self.active.values()):
            dl = self._deadline.get(st.req.rid)
            if dl is not None and now >= dl:
                self._finish(st, "timed_out")
        kept = []
        for req in self.queue:
            dl = self._deadline.get(req.rid)
            if dl is not None and now >= dl:
                self._deadline.pop(req.rid, None)
                self._submitted.pop(req.rid, None)
                self.results.append(RequestResult(
                    rid=req.rid, prompt_len=len(req.tokens), tokens=[],
                    logprobs=[], finished_reason="timed_out"))
            else:
                kept.append(req)
        self.queue = kept

    def _admit(self):
        free = [s for s in range(self.n_slots) if s not in self.active]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.pop(0)
            lo, n = self._slots
            if lo <= slot < lo + n:           # this rank's data group holds the slot
                cache_evict_slot(self.cache, slot - lo)
            self.active[slot] = _Active(req=req, slot=slot,
                                        submitted=self._submitted.pop(req.rid))

    def _finish(self, st: _Active, reason: str):
        self._deadline.pop(st.req.rid, None)
        self.results.append(RequestResult(
            rid=st.req.rid, prompt_len=len(st.req.tokens),
            tokens=st.tokens, logprobs=st.logprobs, finished_reason=reason,
            first_token_s=st.first_token_s))
        del self.active[st.slot]

    # -- one scheduler step --------------------------------------------------

    def _generator(self, st: _Active) -> Optional[torch.Generator]:
        """The draw of st's next token: a generator seeded from (seed, rid,
        n_gen), so the stream does not depend on the batch; None when
        greedy."""
        if self.temperature <= 0.0:
            return None
        state = np.random.SeedSequence([self.seed, st.req.rid, st.n_gen]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(state >> 1))

    def _record(self, st: _Active, token: int, logprob: float):
        if not st.tokens:
            st.first_token_s = time.perf_counter() - st.submitted
        st.tokens.append(token)
        st.logprobs.append(logprob)
        st.n_gen += 1

    @torch.inference_mode()
    def step(self) -> bool:
        """Expire / admit / one prefill chunk / one decode tick / evict.
        Returns True while any work remains."""
        self._expire()     # before admit: a freed slot admits THIS step
        self._admit()

        # (2) one prefill chunk for the head-of-line prefilling request
        pre = next((st for st in self.active.values() if not st.decoding), None)
        if pre is not None:
            n = len(pre.req.tokens)
            chunk = (n - pre.consumed if self.prefill_chunk <= 0
                     else min(self.prefill_chunk, n - pre.consumed))
            toks = torch.tensor([list(pre.req.tokens[pre.consumed:pre.consumed + chunk])],
                                dtype=torch.long, device=self.device)
            self.cache, last = self._prefill_chunk(self.params, self.cache, toks, pre.slot)
            self.prefill_chunks += 1
            pre.consumed += chunk
            if pre.consumed == n:
                pre.last_logits = last[0]        # prefill done -> decoding

        # (3) one decode tick over every decoding slot
        deco = [st for st in self.active.values() if st.decoding]
        if deco:
            for st in deco:
                # the token a tick consumes is sampled from the PREVIOUS
                # position's logits: held here at the prefill -> decode seam,
                # in the tick afterwards; a failover resume splices its
                # recorded token instead of sampling
                if not st.tokens:
                    if st.req.replay_tokens:
                        self._record(st, int(st.req.replay_tokens[0]),
                                     float(st.req.replay_logprobs[0]))
                    else:
                        nxt, lp = sample_tokens(st.last_logits[None], self.temperature,
                                                [self._generator(st)])
                        self._record(st, int(nxt[0]), float(lp[0]))
            live = [st for st in deco
                    if not self._hit_stop(st) and st.n_gen < st.req.max_new_tokens]
            if live:
                tokens = [0] * self.n_slots
                active = [False] * self.n_slots
                gens: List[Optional[torch.Generator]] = [None] * self.n_slots
                for st in live:
                    tokens[st.slot] = st.tokens[-1]
                    active[st.slot] = True
                    gens[st.slot] = self._generator(st)
                t0 = time.perf_counter()
                self.cache, nxt, lp = self._decode_tick(
                    self.params, self.cache,
                    torch.tensor(tokens, dtype=torch.long, device=self.device),
                    torch.tensor(active, dtype=torch.bool, device=self.device), gens)
                nxt, lp = nxt.tolist(), lp.tolist()
                ms = (time.perf_counter() - t0) * 1e3
                self.tick_ms_sum += ms
                self.tick_ms_min = min(self.tick_ms_min, ms)
                self.tick_ms_max = max(self.tick_ms_max, ms)
                self.decode_ticks += 1
                poisoned = self._poison_ticks > 0
                if poisoned:
                    self._poison_ticks -= 1
                for st in live:
                    k = st.n_gen
                    if k < len(st.req.replay_tokens):
                        # replay: the tick ran (extending the cache exactly as
                        # the original decode did) but the output is the
                        # recorded token, not a fresh sample
                        self._record(st, int(st.req.replay_tokens[k]),
                                     float(st.req.replay_logprobs[k]))
                    elif poisoned:
                        self._record(st, 0, float("nan"))
                    else:
                        self._record(st, int(nxt[st.slot]), float(lp[st.slot]))

        # (4) evict finished requests, freeing slots for the next admit
        for st in list(self.active.values()):
            if not st.decoding:
                continue
            if self._hit_stop(st):
                self._finish(st, "eos")
            elif st.n_gen >= st.req.max_new_tokens:
                st.tokens = st.tokens[:st.req.max_new_tokens]
                st.logprobs = st.logprobs[:st.req.max_new_tokens]
                self._finish(st, "length")
        self.ticks += 1            # progress heartbeat
        return bool(self.active or self.queue)

    def _hit_stop(self, st: _Active) -> bool:
        return bool(st.req.eos_id is not None and st.tokens
                    and st.tokens[-1] == st.req.eos_id)

    def run(self, requests: Sequence[Request]) -> List[RequestResult]:
        """Submit everything, step until drained, return results by rid."""
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return sorted(self.results, key=lambda r: r.rid)
