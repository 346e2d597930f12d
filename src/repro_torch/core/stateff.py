"""Statistical efficiency: epochs-to-converge E(B) versus global batch size
(paper §3.1, Fig. 4); port of ``repro/core/stateff.py``.

Two sources, mirroring the paper's methodology:

1. **Measured**: ``measure_epochs_to_converge`` trains a real (small) model on
   a synthetic-but-learnable task at different global batch sizes, using the
   paper's §4.2 delayed-gradient trick to emulate batch sizes larger than the
   physical device count, and records epochs until the loss target.  It
   drives any step of the form ``step(state, batch) -> (state, metrics)``,
   such as the port's ``train.steps.make_train_step``.

2. **Fitted model**: E(B) = E_inf * (1 + (B / B_crit)^alpha) — the
   critical-batch-size form (Shallue et al. / McCandlish et al.), fitted to
   measured points, plus calibration tables digitized from the paper's Fig. 4
   so the planner can reproduce the paper's Inception-V3 / GNMT / BigLSTM
   projections exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class EpochModel:
    """E(B) = e_inf * (1 + (B / b_crit) ** alpha), clipped at b_max where the
    paper reports divergence ("did not converge in meaningful time")."""

    e_inf: float
    b_crit: float
    alpha: float = 2.0
    b_max: Optional[float] = None

    def epochs(self, global_batch: float) -> float:
        if self.b_max is not None and global_batch > self.b_max:
            return float("inf")
        return self.e_inf * (1.0 + (global_batch / self.b_crit) ** self.alpha)

    def ratio(self, b1: float, b2: float) -> float:
        """E(b1) / E(b2) — the paper's E_N / E_{M*N} style terms."""
        return self.epochs(b1) / self.epochs(b2)


# --- calibration: digitized from the paper's Fig. 4 (epochs vs GPUs) -------
# mini-batch per GPU: Inception-V3 = 64, GNMT = 128, BigLSTM = 128.
PAPER_FIG4: Dict[str, Dict[int, float]] = {
    # global batch -> epochs
    "inception_v3": {512: 4, 1024: 4, 2048: 4.0, 4096: 7, 8192: 12, 16384: 23},
    "gnmt": {256: 5.5, 512: 5.0, 1024: 5.0, 2048: 5.2, 4096: 5.5, 8192: 6.5,
             16384: 9.0, 32768: 17.0},
    "biglstm": {512: 5.0, 1024: 5.5, 2048: 6.5, 4096: 21.0},
}
PAPER_MINI_BATCH = {"inception_v3": 64, "gnmt": 128, "biglstm": 128}


@dataclasses.dataclass(frozen=True)
class EpochTable:
    """Exact E(B) lookup over digitized points with geometric interpolation —
    used to replay the paper's own Fig. 5 projections without smoothing
    error (the fitted EpochModel is for planner extrapolation)."""

    points: tuple                      # ((batch, epochs), ...) sorted
    b_max: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Dict[int, float], b_max=None) -> "EpochTable":
        return cls(tuple(sorted(d.items())), b_max)

    def epochs(self, global_batch: float) -> float:
        if self.b_max is not None and global_batch > self.b_max:
            return float("inf")
        pts = self.points
        if global_batch <= pts[0][0]:
            return pts[0][1]
        if global_batch >= pts[-1][0]:
            # extrapolate with the final segment's log-log slope
            (b0, e0), (b1, e1) = pts[-2], pts[-1]
            slope = math.log(e1 / e0) / math.log(b1 / b0)
            return e1 * (global_batch / b1) ** slope
        for (b0, e0), (b1, e1) in zip(pts, pts[1:]):
            if b0 <= global_batch <= b1:
                f = math.log(global_batch / b0) / math.log(b1 / b0)
                return e0 * (e1 / e0) ** f
        raise AssertionError

    def ratio(self, b1: float, b2: float) -> float:
        return self.epochs(b1) / self.epochs(b2)


def paper_epoch_table(network: str) -> EpochTable:
    b_max = 4097.0 if network == "biglstm" else None
    return EpochTable.from_dict(PAPER_FIG4[network], b_max=b_max)


def fit_epoch_model(points: Dict[int, float], b_max: Optional[float] = None,
                    alphas: Sequence[float] = (1.0, 1.5, 2.0, 2.5, 3.0)) -> EpochModel:
    """Least-squares fit of (e_inf, b_crit) over a small alpha grid."""
    bs = np.array(sorted(points), dtype=np.float64)
    es = np.array([points[int(b)] for b in bs], dtype=np.float64)
    best = None
    e_inf0 = float(es.min())
    for alpha in alphas:
        for b_crit in np.geomspace(bs.min() / 2, bs.max() * 8, 64):
            pred_unit = 1.0 + (bs / b_crit) ** alpha
            e_inf = float((es * pred_unit).sum() / (pred_unit ** 2).sum())
            resid = float(((es - e_inf * pred_unit) ** 2).sum())
            if best is None or resid < best[0]:
                best = (resid, EpochModel(e_inf, float(b_crit), alpha, b_max))
    return best[1]


def paper_epoch_model(network: str) -> EpochModel:
    pts = PAPER_FIG4[network]
    b_max = 4096.0 if network == "biglstm" else None
    return fit_epoch_model(pts, b_max=b_max)


# --- measured convergence ------------------------------------------------------

def measure_epochs_to_converge(train_step_fn, init_state, data_epochs_fn,
                               *, target_loss: float, max_epochs: int,
                               accum: int = 1) -> float:
    """Train until mean epoch loss <= target; return (possibly fractional)
    epochs.  ``data_epochs_fn(epoch)`` yields the step batches of one epoch;
    ``accum`` emulates `accum`x larger global batch via delayed gradient
    update (paper §4.2) — the caller builds train_step_fn with that
    microbatch count.
    """
    state = init_state
    for epoch in range(max_epochs):
        losses = []
        for batch in data_epochs_fn(epoch):
            state, metrics = train_step_fn(state, batch)
            losses.append(float(metrics["loss"]))
        # mean loss over the trailing half of the epoch = current quality
        half = losses[len(losses) // 2:]
        cur = sum(half) / max(len(half), 1)
        if cur <= target_loss:
            # linear interpolation within the epoch for fractional credit
            below = [i for i, l in enumerate(losses) if l <= target_loss]
            frac = below[0] / len(losses) if below else 1.0
            return epoch + frac
    return float(max_epochs)
