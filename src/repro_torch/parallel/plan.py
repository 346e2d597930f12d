"""ParallelPlan: the executable description of a hybrid DP x MP strategy
(port of ``repro/parallel/plan.py``).

This is the object the paper's planner (``repro_torch.core.planner``) emits
and a runtime consumes: which mesh axes carry data parallelism (the paper's N), which
axis carries model parallelism (the paper's M), and whether parameters /
optimizer state are additionally sharded over the DP axes (ZeRO-style "fsdp" —
a beyond-paper addition required to *fit* 2025-scale models; the paper-faithful
baseline keeps it off).

The JAX plan reads its degrees off a ``jax.sharding.Mesh``; here
``describe`` and ``plan_degrees`` take a mapping of axis name to size (the
planner's ``mesh_shape`` named ``("pod", "data", "model")``), since the port
has no mesh until the multi-card runtimes (ROADMAP.md Queue 1 items 5-8).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    dp_axes: Tuple[str, ...] = ("data",)   # batch sharded over these (paper's N)
    model_axis: Optional[str] = "model"    # tensor/pipeline MP axis (paper's M)
    fsdp_axes: Tuple[str, ...] = ()        # params/opt additionally sharded here
    # "tensor": Megatron head/FFN sharding over model_axis.
    # "pipeline": model_axis carries pipeline stages.
    # "context": model_axis carries the sequence-sharded KV ring
    #   (parallel.context) — params stay REPLICATED across it; the residual
    #   stream is sequence-sharded and attention rotates KV on a ppermute
    #   ring.  Mutually exclusive with the overlapped tensor-MP comm runtime
    #   (the ring IS the comm schedule).
    mp_kind: str = "tensor"                # "tensor" | "pipeline" | "context"
    # For mp_kind="tensor": delayed-gradient accumulation count (§4.2).
    # For mp_kind="pipeline": pipeline micro-batches fed through the stages.
    microbatches: int = 1
    # Pipeline schedule ("gpipe" | "1f1b" | "interleaved") and, for
    # interleaved, the virtual layer chunks per device (v).
    schedule: str = "gpipe"
    virtual_stages: int = 1
    # Which pipeline runtime executes the schedule: "scheduled" runs the
    # complete fwd+bwd WorkUnit table by hand (pipeline_value_and_grad —
    # realizes the schedule's activation residency, e.g. 1f1b's min(K, S));
    # "ad" runs the forward placement and lets automatic differentiation
    # synthesize the backward (GPipe-like K-micro residency regardless of
    # schedule; kept for bit-for-bit differential testing).
    runtime: str = "scheduled"
    # Which collective runtime carries the tensor-MP matmuls and the DP
    # gradient sync: "gspmd" leaves both to the partitioner (monolithic
    # all-reduces, the escape hatch); "overlapped" routes the Megatron
    # row/column matmuls through parallel.collectives' chunked ppermute
    # rings and the DP grad exchange through the bucketed
    # reduce-scatter/all-gather sync.
    comm_runtime: str = "gspmd"
    comm_chunks: int = 1          # ring chunks per shard for "overlapped"
    remat: bool = True

    PIPE_RUNTIMES = ("scheduled", "ad")
    COMM_RUNTIMES = ("gspmd", "overlapped")
    MP_KINDS = ("tensor", "pipeline", "context")

    def __post_init__(self):
        if self.mp_kind not in self.MP_KINDS:
            raise ValueError(f"unknown mp_kind {self.mp_kind!r}; "
                             f"expected one of {self.MP_KINDS}")
        if self.runtime not in self.PIPE_RUNTIMES:
            raise ValueError(f"unknown pipeline runtime {self.runtime!r}; "
                             f"expected one of {self.PIPE_RUNTIMES}")
        if self.comm_runtime not in self.COMM_RUNTIMES:
            raise ValueError(f"unknown comm runtime {self.comm_runtime!r}; "
                             f"expected one of {self.COMM_RUNTIMES}")
        if self.comm_chunks < 1:
            raise ValueError(f"comm_chunks must be >= 1, "
                             f"got {self.comm_chunks}")
        if self.mp_kind == "context" and self.comm_runtime == "overlapped":
            raise ValueError(
                "mp_kind='context' already schedules its own KV ring; "
                "it cannot combine with comm_runtime='overlapped' "
                "(use the default 'gspmd' for everything outside the ring)")

    @property
    def is_pipeline(self) -> bool:
        return self.mp_kind == "pipeline" and self.model_axis is not None

    @property
    def is_context(self) -> bool:
        return self.mp_kind == "context" and self.model_axis is not None

    def describe(self, axis_sizes: Mapping[str, int]) -> str:
        dp, mp = plan_degrees(self, axis_sizes)
        unit = "micro" if self.is_pipeline else "accum"
        sched = ""
        if self.is_pipeline:
            v = f" v={self.virtual_stages}" if self.virtual_stages > 1 else ""
            sched = f" [{self.schedule}{v}, {self.runtime} runtime]"
        elif self.is_context:
            sched = " [kv ring]"
        comm = ""
        if self.comm_runtime != "gspmd":
            c = f" c={self.comm_chunks}" if self.comm_chunks > 1 else ""
            comm = f" [{self.comm_runtime} comm{c}]"
        return (f"{dp}-way DP x {mp}-way {self.mp_kind} MP{sched}{comm}"
                f"{' +fsdp' if self.fsdp_axes else ''}"
                f"{f' x{self.microbatches} {unit}' if self.microbatches > 1 else ''}")


def plan_degrees(plan: ParallelPlan,
                 axis_sizes: Mapping[str, int]) -> Tuple[int, int]:
    """(N, M) = (data-parallel ways, model-parallel ways) of plan over the
    named axis sizes."""
    n = 1
    for a in plan.dp_axes:
        n *= axis_sizes[a]
    m = axis_sizes[plan.model_axis] if plan.model_axis else 1
    return n, m


def serve_plan(tp: int, *, comm_runtime: str = "overlapped",
               comm_chunks: int = 1) -> ParallelPlan:
    """The decode-mesh plan for one serving replica: slots shard over
    ``data``, the layer matmuls over a ``tp``-way ``model`` axis riding the
    collective rings (tp == 1 degenerates to a single-device replica)."""
    return ParallelPlan(
        dp_axes=("data",),
        model_axis="model" if tp > 1 else None,
        mp_kind="tensor",
        comm_runtime=comm_runtime if tp > 1 else "gspmd",
        comm_chunks=comm_chunks,
        remat=False)


PAPER_BASELINE = ParallelPlan()                                  # DP x tensor-MP
PAPER_DP_ONLY = ParallelPlan(model_axis=None)                    # pure DP
OPTIMIZED = ParallelPlan(fsdp_axes=("data",))                    # + ZeRO-3
PAPER_PIPELINE = ParallelPlan(mp_kind="pipeline", microbatches=4)  # §4.4 GPipe
CONTEXT = ParallelPlan(mp_kind="context")                        # DP x KV-ring CP
