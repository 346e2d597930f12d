"""Optimizers and LR schedules (port of ``repro/optim``): momentum-SGD with
the linear batch-size/LR scaling rule (Goyal et al., used for Inception-V3),
exponential warmup + step decay (GNMT), and AdamW / Adafactor for the modern
archs."""
from repro_torch.optim.optimizers import (
    OPTIMIZERS,
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    momentum_sgd,
    sgd,
)
from repro_torch.optim.schedules import (
    constant_lr,
    cosine_decay,
    exp_warmup_step_decay,
    linear_scaled_lr,
    warmup_cosine,
)

__all__ = [
    "OPTIMIZERS", "Optimizer", "adafactor", "adamw", "apply_updates",
    "clip_by_global_norm", "momentum_sgd", "sgd", "constant_lr", "cosine_decay",
    "exp_warmup_step_decay", "linear_scaled_lr", "warmup_cosine",
]
