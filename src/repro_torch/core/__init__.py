"""The paper's contribution: analytical hybrid-parallelism framework,
DLPlacer and the HybridPlanner (port of ``repro/core`` on an H100 hardware
model; the JAX package's roofline machinery is ROADMAP.md Queue 1 item 12)."""
from repro_torch.core.analytical import (TrainingRun, best_strategy,
                                         crossover_device_count, hybrid_wins,
                                         speedup_dp, speedup_hybrid)
from repro_torch.core.comm import (HardwareModel, ring_all_reduce_time,
                                   scaling_efficiency)
from repro_torch.core.planner import HybridPlanner, default_epoch_model
from repro_torch.core.stateff import (EpochModel, fit_epoch_model,
                                      paper_epoch_model)

__all__ = ["TrainingRun", "best_strategy", "crossover_device_count",
           "hybrid_wins", "speedup_dp", "speedup_hybrid", "HardwareModel",
           "ring_all_reduce_time", "scaling_efficiency", "HybridPlanner",
           "default_epoch_model", "EpochModel", "fit_epoch_model",
           "paper_epoch_model"]
