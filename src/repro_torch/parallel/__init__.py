"""Parallelism plans, pipeline schedules and the DP and scheduled pipeline
runtimes on ``torch.distributed`` ranks (port of ``repro/parallel``):
``plan``, ``pipeline``, ``collectives`` (the DP gradient sync) and ``dist``
(the rank mesh, its transport and ``spawn_ranks``).  Tensor MP and context
parallelism are ROADMAP.md Queue 1 items 7 and 8."""
from repro_torch.parallel.pipeline import (SCHEDULE_KINDS, PipelineSchedule,
                                           make_schedule,
                                           pipeline_activation_residency,
                                           pipeline_bubble_fraction,
                                           pipeline_step_speedup)
from repro_torch.parallel.plan import ParallelPlan, plan_degrees

__all__ = ["ParallelPlan", "plan_degrees", "PipelineSchedule",
           "SCHEDULE_KINDS", "make_schedule", "pipeline_bubble_fraction",
           "pipeline_activation_residency", "pipeline_step_speedup"]
