"""Parallelism plans, pipeline schedules and the DP, scheduled pipeline,
context-parallel and tensor-MP runtimes on ``torch.distributed`` ranks
(port of ``repro/parallel``): ``plan``, ``sharding`` (the tensor-MP rules
and a rank's part of the parameters), ``pipeline``, ``collectives`` (the DP
gradient sync and the tensor-MP collectives and rings), ``context`` (ring
attention) and ``dist`` (the rank mesh, its transport and
``spawn_ranks``)."""
from repro_torch.parallel.context import merge_attention, ring_attention
from repro_torch.parallel.pipeline import (SCHEDULE_KINDS, PipelineSchedule,
                                           make_schedule,
                                           pipeline_activation_residency,
                                           pipeline_bubble_fraction,
                                           pipeline_step_speedup)
from repro_torch.parallel.plan import ParallelPlan, plan_degrees

__all__ = ["ParallelPlan", "plan_degrees", "ring_attention", "merge_attention",
           "PipelineSchedule",
           "SCHEDULE_KINDS", "make_schedule", "pipeline_bubble_fraction",
           "pipeline_activation_residency", "pipeline_step_speedup"]
