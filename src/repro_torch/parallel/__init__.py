"""Parallelism plans and pipeline schedules (the pure-Python half of
``repro/parallel``); the multi-card runtimes are ROADMAP.md Queue 1 items
5-8."""
from repro_torch.parallel.pipeline import (SCHEDULE_KINDS, PipelineSchedule,
                                           make_schedule,
                                           pipeline_activation_residency,
                                           pipeline_bubble_fraction,
                                           pipeline_step_speedup)
from repro_torch.parallel.plan import ParallelPlan, plan_degrees

__all__ = ["ParallelPlan", "plan_degrees", "PipelineSchedule",
           "SCHEDULE_KINDS", "make_schedule", "pipeline_bubble_fraction",
           "pipeline_activation_residency", "pipeline_step_speedup"]
