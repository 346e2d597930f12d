"""DLPlacer (paper §6): operation-to-device placement for model parallelism
(port of ``repro/core/dlplacer.py``, without ``networkx``).

Faithful encoding of the paper's ILP — placement variables P_kn (Eq. 7),
activation routing C_el (Eqs. 8-9), dependency + communication scheduling
(Eqs. 10-11), device serialization (Eq. 12), and memory capacity (Eq. 13) —
solved with exact branch-and-bound over placements (the offline container has
no ILP solver; B&B with critical-path/workload lower bounds gives the same
optimal solutions with a certificate, for the DFG sizes the paper uses).
Routing on the all-to-all NVLink topology of the paper's DGX-1 collapses to
the direct link, so Eqs. 8-9 reduce to a per-edge delay D(e)/B(l) + L(l); for
multi-hop topologies the schedule uses shortest-path link chains.

The *simulated executor* replays a placement with per-op launch overheads and
imperfect comm/compute overlap — the stand-in for the paper's "silicon"
measurements in the Fig. 8 validation benchmark.

The JAX solver walks a ``networkx.DiGraph``; ``DFG.graph()`` here builds a
``Dag`` with the same topological order (networkx's: Kahn's algorithm in
generations, nodes and edges in insertion order), so ``solve_placement``
explores the same placements in the same order and returns the same
makespan, lower bound and optimality flag.  ``HardwareGraph`` defaults to
one NVIDIA H100 and its NVLink (``core.comm``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.comm import (H100_HBM_BYTES, H100_MFU, H100_NVLINK_BW,
                                   H100_NVLINK_LATENCY, H100_PEAK_FLOPS)


@dataclasses.dataclass(frozen=True)
class OpCost:
    flops: float
    bytes_out: float
    mem: float = 0.0


@dataclasses.dataclass(frozen=True)
class Dag:
    """Adjacency of a DFG in edge insertion order (a repeated edge counts
    once) and one topological order of its nodes."""
    order: Tuple[str, ...]
    succ: Dict[str, Tuple[str, ...]]
    pred: Dict[str, Tuple[str, ...]]

    def topological_sort(self) -> Tuple[str, ...]:
        return self.order

    def successors(self, n: str) -> Tuple[str, ...]:
        return self.succ[n]

    def predecessors(self, n: str) -> Tuple[str, ...]:
        return self.pred[n]


@dataclasses.dataclass
class DFG:
    nodes: Dict[str, OpCost]
    edges: List[Tuple[str, str]]

    def graph(self) -> Dag:
        """The DFG's ``Dag``; raises ValueError for an edge that names an
        unknown node or for a cycle."""
        succ: Dict[str, Dict[str, None]] = {n: {} for n in self.nodes}
        pred: Dict[str, Dict[str, None]] = {n: {} for n in self.nodes}
        for u, v in self.edges:
            if u not in succ or v not in succ:
                raise ValueError(f"edge {(u, v)} names a node the DFG lacks")
            succ[u][v] = None
            pred[v][u] = None
        # Kahn's algorithm in generations, as networkx.topological_sort
        indegree = {n: len(p) for n, p in pred.items()}
        order: List[str] = []
        generation = [n for n, d in indegree.items() if d == 0]
        while generation:
            order.extend(generation)
            nxt = []
            for n in generation:
                for child in succ[n]:
                    indegree[child] -= 1
                    if indegree[child] == 0:
                        nxt.append(child)
            generation = nxt
        if len(order) != len(self.nodes):
            raise ValueError("the DFG has a cycle")
        return Dag(tuple(order), {n: tuple(s) for n, s in succ.items()},
                   {n: tuple(p) for n, p in pred.items()})

    @classmethod
    def from_analytic(cls, nodes: Dict[str, dict], edges) -> "DFG":
        return cls({n: OpCost(v["flops"], v["bytes_out"], v.get("mem", 0.0))
                    for n, v in nodes.items()}, list(edges))


@dataclasses.dataclass(frozen=True)
class HardwareGraph:
    """n_devices compute nodes joined all to all by direct links (NVLink
    through NVSwitch)."""

    n_devices: int
    # H100 dense bf16 peak (data sheet) times the fraction the port's
    # training step reaches on the card (measured)
    flops_per_s: float = H100_PEAK_FLOPS * H100_MFU
    bw: float = H100_NVLINK_BW             # NVLink 4 per direction (data sheet)
    latency: float = H100_NVLINK_LATENCY   # assumption
    mem_capacity: float = H100_HBM_BYTES   # measured on the card

    def comm_time(self, bytes_: float, src: int, dst: int) -> float:
        if src == dst:
            return 0.0
        return bytes_ / self.bw + self.latency


def exec_time(cost: OpCost, hw: HardwareGraph) -> float:
    return cost.flops / hw.flops_per_s


def list_schedule(dfg: DFG, hw: HardwareGraph,
                  placement: Dict[str, int], *, op_overhead: float = 0.0,
                  comm_overlap: bool = True) -> float:
    """Makespan of a placement under the paper's scheduling constraints
    (Eqs. 10-12): deps + comm delays + per-device serialization.

    ``comm_overlap=True`` is DLPlacer assumption 2 (transfers hidden behind
    compute); False serializes transfers onto the source device — one of the
    'framework-induced overheads' knobs of the simulated executor.
    """
    g = dfg.graph()
    ready_t: Dict[str, float] = {}
    dev_free = [0.0] * hw.n_devices
    finish: Dict[str, float] = {}
    for n in g.topological_sort():
        dev = placement[n]
        t_ready = 0.0
        for pred in g.predecessors(n):
            c = hw.comm_time(dfg.nodes[pred].bytes_out, placement[pred], dev)
            t_ready = max(t_ready, finish[pred] + c)
            if not comm_overlap and placement[pred] != dev:
                # transfer occupies the source device after the op finishes
                dev_free[placement[pred]] = max(dev_free[placement[pred]],
                                                finish[pred] + c)
        start = max(t_ready, dev_free[dev])
        finish[n] = start + exec_time(dfg.nodes[n], hw) + op_overhead
        dev_free[dev] = finish[n]
    return max(finish.values())


def memory_ok(dfg: DFG, hw: HardwareGraph, placement: Dict[str, int]) -> bool:
    use = [0.0] * hw.n_devices
    for n, c in dfg.nodes.items():
        use[placement[n]] += c.mem
    return all(u <= hw.mem_capacity for u in use)


@dataclasses.dataclass
class PlacementResult:
    placement: Dict[str, int]
    makespan: float
    lower_bound: float
    explored: int
    optimal: bool
    solve_s: float

    @property
    def speedup_vs_single(self) -> float:
        return self.single_device_time / self.makespan if self.makespan else 0.0

    single_device_time: float = 0.0


def _critical_path_lb(dfg: DFG, hw: HardwareGraph) -> float:
    g = dfg.graph()
    lb = {}
    for n in reversed(g.topological_sort()):
        succ = [lb[s] for s in g.successors(n)]
        lb[n] = exec_time(dfg.nodes[n], hw) + (max(succ) if succ else 0.0)
    return max(lb.values())


def solve_placement(dfg: DFG, hw: HardwareGraph, *, time_budget_s: float = 60.0,
                    op_overhead: float = 0.0) -> PlacementResult:
    """Exact B&B over placements in topological order.

    Bounds: (a) work-balance LB = remaining-flops / (devices * rate) combined
    with committed device loads; (b) critical-path LB.  Symmetry broken by
    pinning the first node to device 0.  Falls back to best-found (with the
    proven bound) if the time budget expires — `optimal` records which.
    """
    g = dfg.graph()
    topo = list(g.topological_sort())
    n_dev = hw.n_devices
    t_single = sum(exec_time(c, hw) for c in dfg.nodes.values()) \
        + op_overhead * len(dfg.nodes)
    cp_lb = _critical_path_lb(dfg, hw)

    # greedy warm start: HEFT-ish earliest-finish-time assignment
    best_place: Dict[str, int] = {}
    for n in topo:
        cands = []
        for d in range(n_dev):
            trial = dict(best_place, **{n: d})
            # complete greedily is expensive; assign by local EFT estimate
            cands.append((local_eft(dfg, hw, g, trial, n, d), d))
        best_place[n] = min(cands)[1]
    best_cost = list_schedule(dfg, hw, best_place, op_overhead=op_overhead)

    t0 = time.time()
    explored = 0
    suffix_work = {}
    acc = 0.0
    for n in reversed(topo):
        acc += exec_time(dfg.nodes[n], hw)
        suffix_work[n] = acc

    optimal = True

    def bnb(idx: int, placement: Dict[str, int], loads: List[float]):
        nonlocal best_cost, best_place, explored, optimal
        if time.time() - t0 > time_budget_s:
            optimal = False
            return
        explored += 1
        if idx == len(topo):
            cost = list_schedule(dfg, hw, placement, op_overhead=op_overhead)
            if cost < best_cost and memory_ok(dfg, hw, placement):
                best_cost, best_place = cost, dict(placement)
            return
        n = topo[idx]
        # lower bound: committed max load + perfectly parallel remaining work
        remaining = suffix_work[n]
        lb = max(max(loads), (sum(loads) + remaining) / n_dev, cp_lb)
        if lb >= best_cost:
            return
        devices = range(1 if idx == 0 else n_dev)  # symmetry breaking
        for d in devices:
            placement[n] = d
            loads[d] += exec_time(dfg.nodes[n], hw)
            bnb(idx + 1, placement, loads)
            loads[d] -= exec_time(dfg.nodes[n], hw)
        del placement[n]

    bnb(0, {}, [0.0] * n_dev)
    return PlacementResult(placement=best_place, makespan=best_cost,
                           lower_bound=max(cp_lb, t_single / n_dev),
                           explored=explored, optimal=optimal,
                           solve_s=time.time() - t0,
                           single_device_time=t_single)


def local_eft(dfg, hw, g, partial: Dict[str, int], node: str, dev: int) -> float:
    """Earliest finish time of `node` on `dev` given committed predecessors."""
    finish: Dict[str, float] = {}
    dev_free = [0.0] * hw.n_devices
    for n in g.topological_sort():
        if n not in partial:
            break
        d = partial[n]
        t_ready = max((finish[p] + hw.comm_time(dfg.nodes[p].bytes_out,
                                                partial[p], d)
                       for p in g.predecessors(n) if p in finish), default=0.0)
        start = max(t_ready, dev_free[d])
        finish[n] = start + exec_time(dfg.nodes[n], hw)
        dev_free[d] = finish[n]
    return finish.get(node, 0.0)


def simulated_silicon(dfg: DFG, hw: HardwareGraph, placement: Dict[str, int],
                      *, op_overhead: float = 30e-6,
                      comm_overlap: bool = False) -> float:
    """The Fig. 8 'silicon' stand-in: same schedule with framework-style
    overheads (kernel launch cost, unoverlapped transfers)."""
    return list_schedule(dfg, hw, placement, op_overhead=op_overhead,
                         comm_overlap=comm_overlap)
