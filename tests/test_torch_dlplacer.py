"""The port's DLPlacer (``repro_torch.core.dlplacer``, no ``networkx``)
against the JAX package's: the cases of ``tests/test_core.py`` go through
both solvers with the JAX ``HardwareGraph`` values, and give the same
placement, makespan, lower bound and optimality flag; the port's topological
order is networkx's on random DAGs; the Inception-V3 DFG comes from the
port's ``models.inception.inception_dfg`` (equal to JAX's,
``tests/test_torch_inception.py``) as plain dicts."""
import dataclasses
import random

import networkx as nx
import pytest

from repro.core import dlplacer as JD
from repro_torch.core import dlplacer as TD
from repro_torch.models.inception import inception_dfg


def _pair(nodes, edges):
    """The same DFG in both packages, from (flops, bytes_out, mem) tuples."""
    return (JD.DFG({n: JD.OpCost(*c) for n, c in nodes.items()}, list(edges)),
            TD.DFG({n: TD.OpCost(*c) for n, c in nodes.items()}, list(edges)))


def _hw(n_devices, **kw):
    jhw = JD.HardwareGraph(n_devices=n_devices, **kw)
    return jhw, TD.HardwareGraph(**dataclasses.asdict(jhw))


def chain(n=6, flops=1e9):
    return ({f"n{i}": (flops, 1e6) for i in range(n)},
            [(f"n{i}", f"n{i+1}") for i in range(n - 1)])


def diamond(width=2, flops=1e9, bytes_out=1e4):
    nodes = {"src": (flops / 10, bytes_out)}
    edges = []
    for i in range(width):
        nodes[f"b{i}"] = (flops, bytes_out)
        edges.append(("src", f"b{i}"))
    nodes["sink"] = (flops / 10, bytes_out)
    edges += [(f"b{i}", "sink") for i in range(width)]
    return nodes, edges


def _inception():
    nodes, edges = inception_dfg(batch=32)
    return ({n: (float(v["flops"]), float(v["bytes_out"]), float(v.get("mem", 0.0)))
             for n, v in nodes.items()}, [tuple(e) for e in edges])


# the cases of tests/test_core.py's DLPlacer section: (dfg, devices, kw,
# budget).  The Inception DFG (59 ops) exhausts any budget in both solvers,
# so what each returns would depend on its speed; a budget of 0 compares
# their warm starts, which the exact search only ever improves on.
CASES = {
    "chain": (chain(), 2, {}, 20),
    "diamond2": (diamond(2), 2, {}, 20),
    "diamond4": (diamond(4), 2, {}, 20),
    "silly_split": (({f"n{i}": (1e8, 1e9) for i in range(4)},
                     [(f"n{i}", f"n{i+1}") for i in range(3)]), 2, {}, 20),
    "memory": (({f"n{i}": (1e9, 1e3, 10e9) for i in range(4)}, []), 4,
               {"mem_capacity": 16e9}, 30),
    "inception": (_inception(), 2, {}, 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_placement_matches_jax(case):
    (nodes, edges), n_dev, kw, budget = CASES[case]
    jdfg, tdfg = _pair(nodes, edges)
    jhw, thw = _hw(n_dev, **kw)
    want = JD.solve_placement(jdfg, jhw, time_budget_s=budget)
    got = TD.solve_placement(tdfg, thw, time_budget_s=budget)
    assert got.optimal == want.optimal == (budget > 0)
    assert got.placement == want.placement
    assert got.makespan == want.makespan
    assert got.lower_bound == want.lower_bound
    assert got.single_device_time == want.single_device_time
    assert got.speedup_vs_single == want.speedup_vs_single
    assert TD.memory_ok(tdfg, thw, got.placement)
    for op_overhead, overlap in ((0.0, True), (30e-6, False)):
        assert TD.list_schedule(tdfg, thw, got.placement, op_overhead=op_overhead,
                                comm_overlap=overlap) == \
            JD.list_schedule(jdfg, jhw, want.placement, op_overhead=op_overhead,
                             comm_overlap=overlap)
    assert TD.simulated_silicon(tdfg, thw, got.placement) == \
        JD.simulated_silicon(jdfg, jhw, want.placement)


def test_paper_claims_hold_on_the_port():
    """tests/test_core.py's DLPlacer claims, from the port's solver."""
    hw = TD.HardwareGraph(**dataclasses.asdict(JD.HardwareGraph(n_devices=2)))
    res = TD.solve_placement(_pair(*chain())[1], hw, time_budget_s=20)
    assert res.makespan == pytest.approx(res.single_device_time, rel=1e-6)
    res = TD.solve_placement(_pair(*diamond(2))[1], hw, time_budget_s=20)
    assert res.makespan < 0.65 * res.single_device_time and res.optimal
    dfg = _pair(*diamond(4))[1]
    res = TD.solve_placement(dfg, hw, time_budget_s=20)
    assert res.makespan <= TD.list_schedule(dfg, hw, {n: 0 for n in dfg.nodes}) + 1e-9
    assert res.makespan >= res.lower_bound - 1e-6
    dfg = _pair(*_inception())[1]
    res = TD.solve_placement(dfg, hw, time_budget_s=0.0)
    sil = TD.simulated_silicon(dfg, hw, res.placement)
    assert abs(sil - res.makespan) / res.makespan < 0.15
    assert res.speedup_vs_single > 1.0


@pytest.mark.parametrize("seed", range(8))
def test_topological_order_is_networkx(seed):
    """Random DAGs (edges from lower to higher index, in a shuffled order,
    some repeated): the port's order equals networkx.topological_sort of
    the JAX DFG's DiGraph, and so do the successor and predecessor lists."""
    rng = random.Random(seed)
    names = [f"op{i}" for i in range(rng.randint(1, 30))]
    order = names[:]
    rng.shuffle(order)
    edges = [(order[i], order[j]) for i in range(len(order)) for j in range(i + 1, len(order))
             if rng.random() < 0.2]
    edges += rng.sample(edges, min(3, len(edges)))
    rng.shuffle(edges)
    jdfg, tdfg = _pair({n: (1e9, 1e4) for n in names}, edges)
    g, dag = jdfg.graph(), tdfg.graph()
    assert list(dag.topological_sort()) == list(nx.topological_sort(g))
    for n in names:
        assert list(dag.successors(n)) == list(g.successors(n))
        assert list(dag.predecessors(n)) == list(g.predecessors(n))
    jhw, thw = _hw(2)
    assert TD._critical_path_lb(tdfg, thw) == JD._critical_path_lb(jdfg, jhw)


def test_cycles_and_unknown_nodes_raise():
    with pytest.raises(ValueError, match="cycle"):
        TD.DFG({"a": TD.OpCost(1, 1), "b": TD.OpCost(1, 1)}, [("a", "b"), ("b", "a")]).graph()
    with pytest.raises(ValueError, match="cycle"):
        TD.DFG({"a": TD.OpCost(1, 1)}, [("a", "a")]).graph()
    with pytest.raises(ValueError, match="lacks"):
        TD.DFG({"a": TD.OpCost(1, 1)}, [("a", "b")]).graph()
