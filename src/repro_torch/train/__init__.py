"""Training: the train step (one device, or one rank of a DP x pipeline,
DP x context-parallel or DP x tensor-MP run), the loop, and fault tolerance
(the injector and the checkpoint-restoring supervisor)."""
from repro_torch.train.fault import (Fault, FaultInjector, InjectedFault, Watchdog,
                                     corrupt_checkpoint, parse_fault_schedule,
                                     run_supervised)
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import (TrainState, checkpoint_saver, eval_train_state,
                                     global_state, init_train_state, make_train_step,
                                     place_state)

__all__ = ["LoopConfig", "train_loop", "TrainState", "init_train_state",
           "eval_train_state", "make_train_step", "global_state", "place_state",
           "checkpoint_saver", "Fault", "FaultInjector", "InjectedFault", "Watchdog",
           "corrupt_checkpoint", "parse_fault_schedule", "run_supervised"]
