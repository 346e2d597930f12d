"""The multi-replica router on replica groups of tensor-MP ranks: one spawn
of 4 gloo ranks on the CPU, 2 replicas x tp 2 (each rank's flash launches
take their plain versions), the port of JAX's
``test_from_choice_tp_replica_groups_kill_failover_subprocess``:

- ``kill@3:0`` (mid-decode) and ``nanlogits@2:1`` through
  ``InferenceChoice.build_router`` on the rank mesh: every rank holds the
  same router results, stats, states and fault log; the tokens and
  logprobs equal, bit for bit, an unfaulted tensor-MP engine run on replica
  group 1 in the same spawn; the greedy tokens equal JAX's single-device
  router under the same faults on the same weights
  (``interop.params_from_jax``), logprobs within 2e-4 (JAX's own limit for
  its TP engine, tests/test_serve_continuous.py:199), its stats, states and
  fault log equal;
- ``add_replica`` raises on ranks, and ``build_router`` with a mesh of the
  wrong shape raises naming the ranks the choice needs;
- the launcher's ``--continuous --replicas 2 --tp 2 --fault kill@3:0`` line
  on 4 ranks of its own.

Config: reduced llama3_2_1b (2 layers, d_model 256, 4 query heads over 4
KV heads, fp32).  JAX is imported inside the fixture only, so the spawned
ranks do not load it.
"""
import warnings

import numpy as np
import pytest

from repro_torch.configs import get_config as t_get_config
from repro_torch.core.planner import InferenceChoice
from repro_torch.launch import serve as launch_serve
from repro_torch.models.api import build_model
from repro_torch.parallel import dist as D
from repro_torch.parallel.plan import serve_plan
from repro_torch.serve import ContinuousEngine, Request
from repro_torch.train.fault import parse_fault_schedule

LP_TOL = 2e-4
SPAWN_S = 180
FAULTS = {"kill": "kill@3:0", "nanlogits": "nanlogits@2:1"}
ROUTER_KW = dict(capacity=32, retry_backoff_s=0.0)


def _reqs(cls):
    return [cls(rid=i, tokens=[1 + i, 2 + i, 3 + i, 4 + i], max_new_tokens=5)
            for i in range(4)]


def _choice(replicas, tp):
    return InferenceChoice(replicas=replicas, tp=tp, slots=2, step_latency=1e-3,
                           tokens_per_s=1.0, mem_bytes=0.0, mesh_shape=(replicas, tp),
                           plan=serve_plan(tp))


def _summary(rt, results):
    return {"results": [(r.rid, list(r.tokens), list(r.logprobs), r.finished_reason)
                        for r in sorted(results, key=lambda r: r.rid)],
            "stats": dict(rt.stats), "states": list(rt.replica_states),
            "fault_log": list(rt.fault_log)}


def _rank(mesh, spec):
    """This rank's router runs under each fault, the refusals, and (on group
    1's ranks) the unfaulted tensor-MP engine's results."""
    warnings.simplefilter("ignore")
    api = build_model(spec["cfg"], device="cpu")
    params = spec["params"]
    out = {"runs": {}}
    for name, faults in FAULTS.items():
        rt = _choice(2, 2).build_router(api, params, mesh=mesh,
                                        faults=parse_fault_schedule(faults), **ROUTER_KW)
        out["runs"][name] = _summary(rt, rt.run(_reqs(Request)))
        out["engine_on_rank"] = [r.engine is not None for r in rt.replicas]
    try:
        rt.add_replica()
    except ValueError as e:
        out["add_replica"] = str(e)
    try:
        _choice(1, 4).build_router(api, params, mesh=mesh, **ROUTER_KW)
    except ValueError as e:
        out["wrong_mesh"] = str(e)
    if mesh.data_index == 1:
        eng = ContinuousEngine(api, params, n_slots=2, capacity=32, mesh=mesh,
                               model_axis="model", batch_axes=())
        out["group_1"] = {r.rid: (r.tokens, r.logprobs) for r in eng.run(_reqs(Request))}
    return out


@pytest.fixture(scope="module")
def models():
    """JAX's single-device router under each fault and the port's weights of
    the same model."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.serve import ReplicaRouter as JRouter
    from repro.serve import Request as JRequest
    from repro.train.fault import parse_fault_schedule as j_faults
    from repro_torch.interop import params_from_jax

    jcfg = j_get_config("llama3_2_1b").reduced()
    tcfg = t_get_config("llama3_2_1b").reduced()
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    ref = {}
    for name, faults in FAULTS.items():
        rt = JRouter(japi, jparams, replicas=2, n_slots=2, faults=j_faults(faults),
                     **ROUTER_KW)
        ref[name] = _summary(rt, rt.run(_reqs(JRequest)))
    return {"cfg": tcfg, "ref": ref,
            "params": params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")}


def test_replica_groups_fail_over_with_group_ones_bits(models):
    ranks = D.spawn_ranks(_rank, 4, "cpu", args=({"cfg": models["cfg"],
                                                  "params": models["params"]},),
                          stages=2, timeout_s=SPAWN_S)
    # each rank holds its own group's engine only (the last run's: nanlogits
    # leaves replica 1 degraded, its engine quarantined, not dropped)
    assert [r["engine_on_rank"] for r in ranks] == [[True, False]] * 2 + [[False, True]] * 2
    group_1 = ranks[2]["group_1"]
    assert ranks[3]["group_1"] == group_1
    for name, want in models["ref"].items():
        got = ranks[0]["runs"][name]
        assert all(r["runs"][name] == got for r in ranks[1:]), name     # every rank agrees
        assert {k: got[k] for k in ("stats", "states", "fault_log")} == \
            {k: want[k] for k in ("stats", "states", "fault_log")}, name
        assert got["stats"]["completed"] == 4 and got["stats"]["failovers"] > 0
        for (rid, toks, lps, why), (_, jtoks, jlps, _) in zip(got["results"],
                                                               want["results"]):
            assert (toks, lps) == group_1[rid], (name, rid)              # the same bits
            assert toks == jtoks and why == "length", (name, rid)
            np.testing.assert_allclose(lps, jlps, rtol=LP_TOL, atol=LP_TOL)
    assert got["states"] == ["healthy", "degraded"]
    assert "add_replica on ranks" in ranks[0]["add_replica"]
    assert "1 x 4 = 4 ranks" in ranks[0]["wrong_mesh"] and "got (2, 2)" in ranks[0]["wrong_mesh"]


def test_launcher_routes_over_replica_groups(capfd):
    launch_serve.main(["--arch", "llama3_2_1b", "--reduced", "--device", "cpu", "--continuous",
                       "--replicas", "2", "--tp", "2", "--slots", "2", "--fault", "kill@3:0",
                       "--batch", "4", "--prompt-len", "8", "--max-new", "4"])
    out = capfd.readouterr().out
    assert "[dist] backend=gloo ranks=4 cards=0 (cpu)" in out
    line = next(x for x in out.splitlines() if x.startswith("[serve] router:"))
    assert "replicas=2, tp=2, completed=4" in line and "states=['dead', 'healthy']" in line
    assert int(line.split("failovers=")[1].split(",")[0]) > 0
    assert "[kernels] flash_attention=0" in out
