"""Training: the train step (one device, or one rank of a DP x pipeline or
DP x context-parallel run) and the loop."""
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import TrainState, init_train_state, make_train_step

__all__ = ["LoopConfig", "train_loop", "TrainState", "init_train_state",
           "make_train_step"]
