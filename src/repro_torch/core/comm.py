"""Communication cost models (paper §3.1, §3.4 inputs); port of
``repro/core/comm.py`` with the constants of an NVIDIA H100 SXM node.

Ring all-reduce time (Thakur et al. 2005; Patarasuk & Yuan 2009) over N
devices for B bytes:  t = 2 * (N-1)/N * B / bw + (N-1) * latency — the model
behind the paper's scaling-efficiency term SE_N, which it conservatively set
to 1; we compute it (and also expose the SE_N=1 mode for the paper-faithful
reproduction).

Hierarchical topologies: rings inside one NVSwitch domain (the JAX model's
intra-pod ICI) vs rings that cross nodes over InfiniBand (its DCI) — the
bandwidth cliff that makes SE_{M*N}/SE_N < 1 at domain boundaries, which is
exactly the regime where the paper's hybrid strategy wins (Eq. 6).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Optional

# --- NVIDIA H100 SXM 80GB (HGX H100 8-GPU node) -----------------------------
# Data sheet, not measured: dense bf16 peak and HBM3 rate (the figures
# chip_smoke.py bounds its kernels with); NVLink 4 at 900 GB/s both ways per
# GPU, 450 GB/s each way; 8 GPUs behind the NVSwitches of one node; one
# 400 Gb/s InfiniBand NDR port per GPU.  One card cannot measure the two
# links.
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9
H100_IB_BW = 50e9
H100_GPUS_PER_NODE = 8
# Assumptions, not measured: the per-hop launch and rendezvous latency of a
# collective inside an NVSwitch domain and across InfiniBand.
H100_NVLINK_LATENCY = 3e-6
H100_IB_LATENCY = 10e-6
# Measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
# chip_smoke.py phase 14 (PERF.md section 5): the card's memory as
# torch.cuda.get_device_properties(0).total_memory reports it (79.18 GiB),
# and the fraction of H100_PEAK_FLOPS that the port's full-width
# Llama-3.2-1B training step reaches, 6 * N_active * B * T / (step s *
# peak) at B 4 x T 2048 (0.2914 from a 255.54 ms step).
H100_HBM_BYTES = 85_017_493_504
H100_MFU = 0.2914


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-device hardware constants + topology (NVIDIA H100 SXM defaults).

    The field names are the JAX model's, so the two map one to one: ``ici``
    is NVLink through the NVSwitches of one node, ``dci`` the inter-node
    fabric (InfiniBand), and ``chips_per_pod`` the GPUs of one NVSwitch
    domain.  ``p2p_links`` divides ``ici_bw`` for one point-to-point hop:
    4 reproduces the JAX model's 2D torus (a neighbour gets one of four
    links); 1 fits NVSwitch, where one neighbour gets the full NVLink
    bandwidth.
    """

    peak_flops: float = H100_PEAK_FLOPS
    hbm_bw: float = H100_HBM_BW
    ici_bw: float = H100_NVLINK_BW
    dci_bw: float = H100_IB_BW
    ici_latency: float = H100_NVLINK_LATENCY
    dci_latency: float = H100_IB_LATENCY
    chips_per_pod: int = H100_GPUS_PER_NODE
    mfu: float = H100_MFU                 # achievable fraction of peak in T_1
    hbm_bytes: float = H100_HBM_BYTES     # per-device memory budget
    p2p_links: int = 1


# Fraction of collective time hidden under partial-matmul compute / backward
# compute for each collective runtime: the GSPMD-style monolithic all-reduce
# is fully exposed; the chunked rings and the bucketed DP sync overlap part
# of theirs.  No GPU measurement of the "overlapped" entry exists until the
# DP and tensor-MP runtimes (ROADMAP.md Queue 1 items 5 and 7) run on
# several cards, so the default is the JAX model's placeholder.  A measured
# artifact is read only when its path is given: the JAX package's
# BENCH_collectives.json was measured on a CPU host mesh and does not
# describe this card.
OVERLAP_FALLBACK = 0.6


def load_measured_overlap(path: Optional[str] = None) -> dict:
    """{"gspmd": 0.0, "overlapped": <measured|fallback>}: the overlapped
    entry is ``tensor_mp.overlap_constant_proxy`` of the JSON artifact at
    ``path`` when one is given and readable, else ``OVERLAP_FALLBACK``.
    Clamped to [0, 0.95]: a degenerate measurement must not let the planner
    cost collectives as free (or negative)."""
    overlapped = OVERLAP_FALLBACK
    if path is not None:
        try:
            with open(path) as f:
                proxy = json.load(f)["tensor_mp"]["overlap_constant_proxy"]
            overlapped = min(max(float(proxy), 0.0), 0.95)
        except (OSError, KeyError, TypeError, ValueError):
            pass
    return {"gspmd": 0.0, "overlapped": overlapped}


MEASURED_OVERLAP: Mapping[str, float] = load_measured_overlap()


def ring_all_reduce_time(bytes_: float, n: int, bw: float,
                         latency: float) -> float:
    """Bandwidth term + the latency (alpha) term: (n-1) hops of the ring,
    each paying one launch/rendezvous latency — without it the model is a
    pure bandwidth term that understates small transfers (and lets the
    planner pick arbitrarily small buckets / micro-batches for free)."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * bytes_ / bw + (n - 1) * latency


def bucketed_all_reduce_time(bytes_: float, n: int, bw: float, latency: float,
                             bucket_bytes: float) -> float:
    """Ring all-reduce split into ceil(bytes/bucket) reduce-scatter +
    all-gather bucket pairs (the bucketed DP gradient sync): the wire bytes
    are unchanged but every bucket pays its own 2*(n-1) hop latencies — the
    alpha cost of bucketing that the overlap win must beat (this is what
    penalizes tiny buckets in the planner)."""
    if n <= 1:
        return 0.0
    n_buckets = max(1, math.ceil(bytes_ / max(bucket_bytes, 1.0)))
    return (2.0 * (n - 1) / n * bytes_ / bw
            + n_buckets * 2.0 * (n - 1) * latency)


def p2p_transfer_time(bytes_: float, hw: HardwareModel, *,
                      inter_pod: bool = False) -> float:
    """Point-to-point neighbour transfer (between adjacent pipeline stages):
    one hop, over ``1 / p2p_links`` of the NVLink bandwidth inside a node,
    or over the inter-node fabric."""
    if inter_pod:
        return bytes_ / hw.dci_bw + hw.dci_latency
    per_hop_bw = hw.ici_bw / hw.p2p_links
    return bytes_ / per_hop_bw + hw.ici_latency


def cp_ring_time(hop_bytes: float, m: int, hw: HardwareModel, *,
                 rings: float = 3.0, inter_pod: bool = False) -> float:
    """Per-layer wire time of the context-parallel KV ring: ``m - 1``
    neighbour hops, each carrying one sequence shard's bf16 K+V block
    (``p2p_transfer_time``: per-hop bandwidth + the alpha launch latency
    that dominates small shards).  ``rings`` counts the rotations per train
    step: 1 forward (KV) + 2 backward (KV again, and the dK/dV accumulators
    riding the ring home) = 3."""
    if m <= 1:
        return 0.0
    return rings * (m - 1) * p2p_transfer_time(hop_bytes, hw,
                                               inter_pod=inter_pod)


def hierarchical_all_reduce_time(bytes_: float, n: int, hw: HardwareModel,
                                 intra_pod_degree: int,
                                 bucket_bytes: float = 0.0) -> float:
    """reduce-scatter inside a node, all-reduce across nodes, all-gather
    inside a node.

    ``bucket_bytes`` > 0 models the bucketed runtime: the intra-node phases
    pay per-bucket hop latencies instead of one fused ring's."""
    def intra(b: float, k: int) -> float:
        if bucket_bytes > 0:
            return bucketed_all_reduce_time(b, k, hw.ici_bw, hw.ici_latency,
                                            bucket_bytes)
        return ring_all_reduce_time(b, k, hw.ici_bw, hw.ici_latency)

    if n <= intra_pod_degree:
        return intra(bytes_, n)
    n_pods = n // intra_pod_degree
    t_intra = intra(bytes_, intra_pod_degree)
    t_inter = ring_all_reduce_time(bytes_ / intra_pod_degree, n_pods,
                                   hw.dci_bw, hw.dci_latency)
    return t_intra + t_inter


def scaling_efficiency(grad_bytes: float, step_compute_time: float, n: int,
                       hw: HardwareModel, *, overlap: float = 0.0,
                       bucket_bytes: float = 0.0,
                       assume_perfect: bool = False) -> float:
    """SE_N = T_1 / T_N for N-way DP (paper §3.1).

    ``assume_perfect`` reproduces the paper's conservative SE_N = 1.
    ``overlap`` in [0,1): fraction of the gradient exchange hidden under
    backward compute (0 for the monolithic all-reduce;
    ``MEASURED_OVERLAP["overlapped"]`` for the bucketed sync, whose
    ``bucket_bytes`` also charges the per-bucket alpha cost).
    """
    if assume_perfect or n <= 1:
        return 1.0
    t_ar = hierarchical_all_reduce_time(grad_bytes, n, hw, hw.chips_per_pod,
                                        bucket_bytes=bucket_bytes)
    t_ar *= (1.0 - overlap)
    return step_compute_time / (step_compute_time + t_ar)
