"""Parallelism plans, pipeline schedules and the DP, scheduled pipeline and
context-parallel runtimes on ``torch.distributed`` ranks (port of
``repro/parallel``): ``plan``, ``pipeline``, ``collectives`` (the DP
gradient sync), ``context`` (ring attention) and ``dist`` (the rank mesh,
its transport and ``spawn_ranks``).  Tensor MP is ROADMAP.md Queue 1 item
7."""
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
