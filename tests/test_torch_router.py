"""The port's multi-replica router (``repro_torch.serve.router``) in one
process, each case of ``tests/test_serve_router.py`` held against JAX's
``ReplicaRouter`` on the same weights (``interop.params_from_jax``) and
requests:

- greedy tokens equal, logprobs within TOL = 1e-4 (tests/test_torch_continuous.py's
  limit: fp32 sums in another order), finish reasons equal;
- ``stats``, ``replica_states`` and ``fault_log`` equal;
- every failover (kill mid-decode, stall past the watchdog, NaN logits,
  drain and grow) gives the port's own unfaulted engine's bits exactly,
  also under a temperature (the port's (seed, rid, n_gen) generators).

Config: reduced llama3_2_1b (2 layers, d_model 256, fp32).  JAX's router
runs are computed once for the module.  The port runs with one intra-op
thread, so a healthy step stays far under the stall case's watchdog.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.api import build_model as j_build_model
from repro.serve import ReplicaRouter as JRouter
from repro.serve import Request as JRequest
from repro.train.fault import parse_fault_schedule as j_faults
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.planner import InferenceChoice
from repro_torch.interop import params_from_jax
from repro_torch.models.api import build_model as t_build_model
from repro_torch.parallel.plan import serve_plan
from repro_torch.serve import ContinuousEngine, ReplicaRouter, Request
from repro_torch.train.fault import Fault, parse_fault_schedule

TOL = 1e-4
STALL = "stall@3:0:1.5"          # a stall of 1.5 s under a 0.5 s watchdog
WATCHDOG_S = 0.5

# each JAX router run of the module: (router keywords, fault schedule,
# requests (n, max_new, extra keywords))
CASES = {
    "no_fault": (dict(replicas=2, n_slots=2), "", (4, 6, {})),
    "kill": (dict(replicas=2, n_slots=2, retry_backoff_s=0.0), "kill@3:0", (4, 6, {})),
    "stall": (dict(replicas=2, n_slots=2, retry_backoff_s=0.0,
                   watchdog_timeout_s=WATCHDOG_S), STALL, (4, 6, {})),
    "nanlogits": (dict(replicas=2, n_slots=2, retry_backoff_s=0.0), "nanlogits@2:1",
                  (4, 6, {})),
    "deadline": (dict(replicas=2, n_slots=2, retry_backoff_s=100.0,
                      max_retry_backoff_s=100.0, clock=lambda: 0.0), "kill@2:0",
                 (4, 6, {"deadline_s": 5.0})),
}


def _reqs(cls, n=4, max_new=6, **kw):
    return [cls(rid=i, tokens=[1 + i, 2 + i, 3 + i, 4 + i], max_new_tokens=max_new, **kw)
            for i in range(n)]


def _summary(rt, results):
    return {"results": [(r.rid, list(r.tokens), list(r.logprobs), r.finished_reason)
                        for r in sorted(results, key=lambda r: r.rid)],
            "stats": dict(rt.stats), "states": list(rt.replica_states),
            "fault_log": list(rt.fault_log)}


def _shed_runs(router_cls, req_cls, api, params):
    """JAX's shedding test on one package: a projected wait over the
    deadline at the door, then a bounded queue's overflow."""
    rt = router_cls(api, params, replicas=1, n_slots=1, capacity=32, est_step_s=10.0)
    first = rt.submit(req_cls(rid=0, tokens=[1, 2, 3], max_new_tokens=4))
    shed = rt.submit(req_cls(rid=1, tokens=[1, 2, 3], max_new_tokens=4, deadline_s=1.0))
    while rt.step():
        pass
    rt2 = router_cls(api, params, replicas=1, n_slots=1, capacity=32, max_queue=1)
    answers = [rt2.submit(req_cls(rid=i, tokens=[1, 2], max_new_tokens=2)) for i in range(3)]
    while rt2.step():
        pass
    return {"door": (first, shed.finished_reason, _summary(rt, rt.results)),
            "queue": ([a is None for a in answers], _summary(rt2, rt2.results))}


def _drain_and_grow(router_cls, req_cls, api, params):
    """JAX's elastic test: drain replica 0 after a tick, grow a third,
    submit two more; returns the summary and the replicas the last two
    requests went to."""
    rt = router_cls(api, params, replicas=2, n_slots=2, capacity=32)
    reqs = _reqs(req_cls, n=6)
    for r in reqs[:4]:
        rt.submit(r)
    rt.step()
    rt.drain_replica(0)
    grown = rt.add_replica()
    for r in reqs[4:]:
        rt.submit(r)
    placed = sorted(tr.replica for tr in rt.tracked.values() if tr.req.rid >= 4)
    while rt.step():
        pass
    return grown, placed, _summary(rt, rt.results)


@pytest.fixture(scope="module")
def models():
    """The JAX package's router runs (once for the module) and the port's
    weights of the same model."""
    jcfg = j_get_config("llama3_2_1b").reduced()
    tcfg = t_get_config("llama3_2_1b").reduced()
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    ref = {}
    for name, (kw, faults, (n, new, rkw)) in CASES.items():
        rt = JRouter(japi, jparams, capacity=32, faults=j_faults(faults) if faults else (),
                     **kw)
        ref[name] = _summary(rt, rt.run(_reqs(JRequest, n, new, **rkw)))
        rt.close()
    ref["shed"] = _shed_runs(JRouter, JRequest, japi, jparams)
    ref["drain"] = _drain_and_grow(JRouter, JRequest, japi, jparams)
    api = t_build_model(tcfg, device="cpu")
    return {"ref": ref, "api": api,
            "params": params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _solo(models, n=4, max_new=6, **kw):
    """The port's unfaulted single engine: the bitwise target of every failover."""
    eng = ContinuousEngine(models["api"], models["params"], n_slots=2, capacity=32, **kw)
    return {r.rid: r for r in eng.run(_reqs(Request, n, max_new))}


def _hold(got, want):
    """The port's summary against JAX's: rids, reasons, greedy tokens equal,
    logprobs within TOL; stats, states and fault log equal."""
    assert [r[0] for r in got["results"]] == [r[0] for r in want["results"]]
    for (rid, toks, lps, why), (_, jtoks, jlps, jwhy) in zip(got["results"], want["results"]):
        assert (toks, why) == (jtoks, jwhy), rid
        assert len(lps) == len(jlps) and (not lps or np.abs(np.subtract(lps, jlps)).max() <= TOL)
    assert {k: got[k] for k in ("stats", "states", "fault_log")} == \
        {k: want[k] for k in ("stats", "states", "fault_log")}


def _same_bits(results, ref):
    assert sorted(r.rid for r in results) == sorted(ref)
    for r in results:
        assert (r.tokens, r.logprobs) == (ref[r.rid].tokens, ref[r.rid].logprobs), r.rid
        assert r.finished_reason in ("eos", "length")


def _router(models, name):
    kw, faults, _ = CASES[name]
    return ReplicaRouter(models["api"], models["params"], capacity=32,
                         faults=parse_fault_schedule(faults) if faults else (), **kw)


def test_no_fault_router_matches_solo_and_accounts_every_rid(models):
    rt = _router(models, "no_fault")
    out = rt.run(_reqs(Request))
    _same_bits(out, _solo(models))
    _hold(_summary(rt, out), models["ref"]["no_fault"])
    assert rt.stats == {"completed": 4, "shed": 0, "timed_out": 0, "failovers": 0}
    assert all(r.first_token_s is not None and r.first_token_s > 0 for r in out)


def test_kill_midflight_failover_bit_identical(models):
    """Replica 0 dies with requests mid-decode; they complete on replica 1
    with the unfaulted run's bits, and each keeps the time to its first
    token that the router saw before the kill."""
    rt = _router(models, "kill")
    for r in _reqs(Request):
        rt.submit(r)
    rt.step()
    rt.step()
    pre = {rid: (list(tr.tokens), tr.first_token_s) for rid, tr in rt.tracked.items()
           if tr.replica == 0}
    assert pre and all(len(t) > 0 and s is not None for t, s in pre.values())
    rt.step()                              # tick 3: the kill fires
    assert rt.replica_states[0] == "dead" and rt.replicas[0].engine is None
    assert rt.fault_log == [("kill", 3, 0)]
    assert rt.stats["failovers"] == len(pre)
    while rt.step():
        pass
    out = sorted(rt.results, key=lambda r: r.rid)
    _same_bits(out, _solo(models))
    _hold(_summary(rt, out), models["ref"]["kill"])
    assert all(r.first_token_s == pre[r.rid][1] for r in out if r.rid in pre)


def test_stall_past_watchdog_failover_bit_identical(models):
    """A replica hanging past the watchdog is degraded and its requests
    fail over with the unfaulted bits; the stalled tick's own output is
    still valid (detection only)."""
    rt = _router(models, "stall")
    out = rt.run(_reqs(Request))
    rt.close()
    assert rt.replica_states == ["degraded", "healthy"]
    assert rt.stats["failovers"] > 0
    _same_bits(out, _solo(models))
    _hold(_summary(rt, out), models["ref"]["stall"])


def test_nanlogits_degrades_replica_and_regenerates_poisoned_suffix(models):
    rt = _router(models, "nanlogits")
    out = rt.run(_reqs(Request))
    assert rt.replica_states == ["healthy", "degraded"]
    assert all(np.isfinite(lp) for r in out for lp in r.logprobs)
    _same_bits(out, _solo(models))
    _hold(_summary(rt, out), models["ref"]["nanlogits"])


def test_projected_wait_and_bounded_queue_shed_exactly_once(models):
    got = _shed_runs(ReplicaRouter, Request, models["api"], models["params"])
    want = models["ref"]["shed"]
    assert got["door"][:2] == want["door"][:2] == (None, "shed")
    _hold(got["door"][2], want["door"][2])
    assert got["door"][2]["stats"]["shed"] == 1 and got["door"][2]["stats"]["completed"] == 1
    assert got["queue"][0] == want["queue"][0] == [True, False, False]
    _hold(got["queue"][1], want["queue"][1])
    assert [r[0] for r in got["queue"][1]["results"]] == [0, 1, 2]


def test_deadline_aware_retry_times_out_instead_of_wasted_dispatch(models):
    rt = _router(models, "deadline")
    out = rt.run(_reqs(Request, deadline_s=5.0))
    assert "timed_out" in {r.finished_reason for r in out}
    assert rt.stats["timed_out"] == rt.stats["failovers"] > 0
    _hold(_summary(rt, out), models["ref"]["deadline"])


def test_drain_and_grow_bit_identical(models):
    grown, placed, got = _drain_and_grow(ReplicaRouter, Request, models["api"],
                                         models["params"])
    assert (grown, placed) == models["ref"]["drain"][:2]
    assert grown == 2 and 2 in placed
    assert got["states"] == ["removed", "healthy", "healthy"]
    _hold(got, models["ref"]["drain"][2])
    solo = _solo(models, n=6)
    assert all((toks, lps) == (solo[rid].tokens, solo[rid].logprobs)
               for rid, toks, lps, _ in got["results"])


def test_router_rejects_training_form_faults_and_duplicate_rids(models):
    api, params = models["api"], models["params"]
    for faults in ([Fault("kill", 3)], parse_fault_schedule("fail@3")):
        with pytest.raises(ValueError, match="replica-keyed"):
            ReplicaRouter(api, params, replicas=1, n_slots=1, capacity=32, faults=faults)
    rt = ReplicaRouter(api, params, replicas=1, n_slots=2, capacity=32)
    rt.submit(Request(rid=7, tokens=[1, 2], max_new_tokens=2))
    with pytest.raises(ValueError, match="already in flight"):
        rt.submit(Request(rid=7, tokens=[3, 4], max_new_tokens=2))
    with pytest.raises(ValueError, match="exceeds slot capacity 32"):
        rt.submit(Request(rid=8, tokens=list(range(30)), max_new_tokens=4))
    assert sorted(rt.tracked) == [7]


def test_from_choice_executes_replicas_axis(models):
    """``InferenceChoice.build_router`` at tp 1: one engine a planned
    replica, all on the same weight tensors, serving as JAX's no-fault
    router does (the same router, 2 x 2 slots)."""
    choice = InferenceChoice(replicas=2, tp=1, slots=2, step_latency=1e-3,
                             tokens_per_s=1.0, mem_bytes=0.0, mesh_shape=(2, 1),
                             plan=serve_plan(1))
    rt = choice.build_router(models["api"], models["params"], capacity=32)
    assert len(rt.replicas) == choice.replicas
    assert all(r.engine.n_slots == choice.slots and r.engine.params is models["params"]
               for r in rt.replicas)
    out = rt.run(_reqs(Request))
    _same_bits(out, _solo(models))
    _hold(_summary(rt, out), models["ref"]["no_fault"])


def test_kill_under_temperature_keeps_the_unfaulted_bits(models):
    """At a temperature each draw comes from (seed, rid, n_gen): a request
    failed over mid-decode continues with the draws it would have had."""
    ref = _solo(models, temperature=0.8, seed=3)
    rt = ReplicaRouter(models["api"], models["params"], replicas=2, n_slots=2, capacity=32,
                       temperature=0.8, seed=3, retry_backoff_s=0.0,
                       faults=parse_fault_schedule("kill@3:0"))
    out = rt.run(_reqs(Request))
    assert rt.stats["failovers"] > 0 and rt.replica_states == ["dead", "healthy"]
    _same_bits(out, ref)
    greedy = _solo(models)
    assert any(ref[rid].tokens != greedy[rid].tokens for rid in ref)
