"""The paper's analytical framework (§3, Eqs. 1-6), as executable code
(port of ``repro/core/analytical.py``).

    C = T x S x E                                   (Eq. 1)
    SU_N = SE_N * N * E_1/E_N                       (Eq. 3, N-way DP)
    SU_{M*N} = SE_{M*N} * M * N * E_1/E_{M*N}       (Eq. 4, DP-only at M*N)
    SU_N^M = SU^M * SE_N * N * E_1/E_N              (Eq. 5, hybrid)
    hybrid wins iff  SU^M > M * SE_{M*N}/SE_N * E_N/E_{M*N}   (Eq. 6)

``TrainingRun`` carries the per-network inputs (step time on one device, grad
bytes, epoch model, mini-batch size); the functions below evaluate the
speedup curves the paper plots in Fig. 3/5 and the crossover criterion.

The per-step MP speedup SU^M comes in two flavors, mirroring the paper's two
MP implementations (§4.3/§4.4):

- **tensor** MP (``mp_speedup``: M -> SU^M) — intra-layer sharding, the
  Megatron/DLPlacer style the paper measures for Inception-V3;
- **pipeline** MP (``pipe_speedup``: (M, K, schedule) -> SU^M for M stages,
  K micro-batches and a pipeline schedule) — layer pipelining, the style
  the paper uses for GNMT and BigLSTM, with SU^M = M * (1 - bubble) /
  (1 + comm), where bubble is the schedule's idle fraction
  ((M-1)/(K+M-1) for gpipe/1f1b, (M-1)/(vK+M-1) for interleaved — see
  ``repro_torch.parallel.pipeline``) and comm is the inter-stage
  activation-transfer time as a fraction of per-micro-batch stage compute.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.comm import HardwareModel, scaling_efficiency
from repro_torch.core.stateff import EpochModel


@dataclasses.dataclass(frozen=True)
class TrainingRun:
    """Inputs of the analytical model for one network on one system."""

    name: str
    t1: float                      # time per step on a single device (s)
    grad_bytes: float              # gradient exchange size (bytes)
    mini_batch: int                # per-worker batch (constant, paper §3.1)
    epoch_model: EpochModel
    dataset_size: int              # items per epoch
    mp_speedup: Dict[int, float]   # M -> tensor-MP SU^M (Table 1 / DLPlacer)
    hw: HardwareModel = HardwareModel()
    se_perfect: bool = True        # paper's conservative SE_N = 1
    # (M stages, K micro-batches, schedule) -> pipeline-MP SU^M (per-schedule
    # bubble model); plain (M, K) keys are accepted as gpipe for back-compat
    pipe_speedup: Dict[Tuple, float] = \
        dataclasses.field(default_factory=dict)
    # M -> context-parallel SU^M (sequence-sharded KV ring, planner's
    # cp_step_speedup; empty when the arch has no CP path)
    cp_speedup: Dict[int, float] = dataclasses.field(default_factory=dict)
    # Measured fraction of the DP gradient exchange hidden under backward
    # compute (comm.MEASURED_OVERLAP keyed by the selected comm runtime: 0
    # for GSPMD's monolithic all-reduce) and the runtime's bucket size (> 0
    # charges the bucketed sync's per-bucket alpha cost).
    comm_overlap: float = 0.0
    bucket_bytes: float = 0.0


def se(run: TrainingRun, n: int, *, overlap: Optional[float] = None,
       grad_scale: float = 1.0, hybrid: bool = False) -> float:
    """Scaling efficiency SE_N of N-way DP.  ``grad_scale`` shrinks the
    gradient exchange for hybrid points (each M-way-MP worker owns — and
    all-reduces — only 1/M of the parameters).  ``overlap`` defaults to the
    run's measured comm overlap (keyed off the selected comm runtime) —
    EXCEPT for ``hybrid`` points: the bucketed/overlapped DP grad sync only
    executes for pure-DP plans (the JAX train step gates it on model-axis
    size 1), so MP workers' exchanges are costed as the fused exposed
    all-reduce.
    The planner must never credit a speedup the runtime cannot deliver."""
    if overlap is None:
        overlap = 0.0 if hybrid else run.comm_overlap
    bucket = 0.0 if hybrid else run.bucket_bytes
    return scaling_efficiency(run.grad_bytes * grad_scale, run.t1, n, run.hw,
                              overlap=overlap, bucket_bytes=bucket,
                              assume_perfect=run.se_perfect)


def epochs_ratio(run: TrainingRun, n_workers: int) -> float:
    """E_1 / E_N where N workers give global batch N * mini_batch."""
    e1 = run.epoch_model.epochs(run.mini_batch)
    en = run.epoch_model.epochs(n_workers * run.mini_batch)
    if en == float("inf"):
        return 0.0
    return e1 / en


def speedup_dp(run: TrainingRun, n: int) -> float:
    """Eq. 3: SU_N of N-way DP over a single device."""
    return se(run, n) * n * epochs_ratio(run, n)


def speedup_hybrid(run: TrainingRun, n_workers: int, m: int) -> float:
    """Eq. 5: N-way DP of M-way-MP workers, M*N devices total."""
    su_m = run.mp_speedup.get(m, 0.0) if m > 1 else 1.0
    return (su_m * se(run, n_workers, grad_scale=1.0 / max(m, 1),
                      hybrid=m > 1)
            * n_workers * epochs_ratio(run, n_workers))


def speedup_context(run: TrainingRun, n_workers: int, m: int) -> float:
    """Eq. 5 with context-parallel workers: N-way DP of M-device KV rings,
    M*N devices total.  CP REPLICATES the parameters across the ring, so —
    unlike tensor-MP's 1/M grad discount — every one of the M*N devices
    all-reduces the FULL gradient (the ring members see different tokens of
    the same sequences, so their grads must sum): SE is evaluated at M*N
    workers with grad_scale=1.  CP buys its per-step 1/M at full sync cost,
    which is exactly why the planner only picks it when the sequence axis
    is what blows the memory budget."""
    if m <= 1:
        return speedup_dp(run, n_workers)
    su_m = run.cp_speedup.get(m, 0.0)
    return (su_m * se(run, n_workers * m, grad_scale=1.0, hybrid=True)
            * n_workers * epochs_ratio(run, n_workers))


def speedup_pipeline(run: TrainingRun, n_workers: int, m: int,
                     n_micro: int, schedule: str = "gpipe") -> float:
    """Eq. 5 with pipeline-MP workers: N-way DP of M-stage pipelines fed with
    ``n_micro`` micro-batches each under ``schedule``, M*N devices total."""
    if m <= 1:
        return speedup_dp(run, n_workers)
    su_m = run.pipe_speedup.get((m, n_micro, schedule),
                                run.pipe_speedup.get((m, n_micro), 0.0)
                                if schedule == "gpipe" else 0.0)
    return (su_m * se(run, n_workers, grad_scale=1.0 / m, hybrid=True)
            * n_workers * epochs_ratio(run, n_workers))


def hybrid_wins(run: TrainingRun, n: int, m: int) -> bool:
    """Eq. 6 at M*N total devices: is N-way DP x M-way MP better than
    (M*N)-way DP?"""
    return speedup_hybrid(run, n, m) > speedup_dp(run, m * n)


def crossover_device_count(run: TrainingRun, m: int = 2,
                           max_devices: int = 4096) -> Optional[int]:
    """Smallest total device count D (power of 2) where the hybrid strategy
    (D/m-way DP x m-way MP) beats DP-only at D devices — the paper's 'tipping
    point'."""
    d = m
    while d <= max_devices:
        if hybrid_wins(run, d // m, m):
            return d
        d *= 2
    return None


def best_strategy(run: TrainingRun, total_devices: int) -> Dict:
    """Arg-max over all factorizations total = N * M (M in mp_speedup U {1}):
    the paper's §3.4 choice, generalized to every available M."""
    best = {"m": 1, "n": total_devices,
            "speedup": speedup_dp(run, total_devices)}
    for m, su in sorted(run.mp_speedup.items()):
        if total_devices % m:
            continue
        n = total_devices // m
        s = speedup_hybrid(run, n, m)
        if s > best["speedup"]:
            best = {"m": m, "n": n, "speedup": s}
    best["convergence_time"] = convergence_time(run, best["n"], best["m"])
    return best


def convergence_time(run: TrainingRun, n_workers: int, m: int = 1) -> float:
    """Eq. 1 evaluated for a hybrid configuration, in seconds."""
    su_m = run.mp_speedup.get(m, 1.0) if m > 1 else 1.0
    t = run.t1 / (se(run, n_workers, grad_scale=1.0 / max(m, 1),
                     hybrid=m > 1) * su_m)
    global_batch = n_workers * run.mini_batch
    s = run.dataset_size / global_batch
    e = run.epoch_model.epochs(global_batch)
    return t * s * e
