"""The train step (port of ``make_train_step`` in ``repro/train/steps.py``).

``make_train_step(api, optimizer)`` returns ``train_step(state, batch) ->
(state, metrics)``: the loss and its gradients by autograd, the paper's §4.2
delayed-gradient accumulation (``microbatches`` > 1 splits the batch,
accumulates the gradients in f32 and updates once), the global-norm clip and
the optimizer update.  PyTorch runs eagerly, so there is no jit; the update
writes the state's tensors in place, and the returned state holds the same
tensors with ``step + 1``.

Single device only: a mesh, a plan or a ParallelCtx raises, naming the
ROADMAP items of the multi-device runtimes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.api import ModelApi
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

MULTI_DEVICE = "ROADMAP.md Queue 1 items 5-8 (multi-device runtimes)"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    # True while the optimizer writes the tensors in place: a step that
    # fails then has left a state that cannot be retried
    in_update: bool = False


def init_train_state(api: ModelApi, optimizer: Optimizer, seed: int = 0) -> TrainState:
    params = api.init(seed)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_train_step(api: ModelApi, optimizer: Optimizer, *, mesh=None, plan=None,
                    clip_norm: float = 1.0, pctx=None, microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics hold
    0-d tensors ``loss`` and, with ``clip_norm``, ``grad_norm``."""
    if mesh is not None or plan is not None or pctx is not None:
        raise NotImplementedError(f"a mesh, plan or ParallelCtx is not ported to "
                                  f"repro_torch yet: {MULTI_DEVICE}")
    micro = int(microbatches)
    if micro < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grads_of(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = api.loss_fn(leaves, batch, None)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def total_grads(params, batch):
        if micro == 1:
            return grads_of(params, batch)
        # delayed gradient update (paper §4.2): split the per-step batch into
        # `micro` micro-batches, accumulate grads, update once
        b = next(iter(batch.values())).shape[0]
        if b % micro:
            raise ValueError(f"batch {b} does not split into {micro} micro-batches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        losses = []
        for i in range(micro):
            mb = {k: v.reshape(micro, b // micro, *v.shape[1:])[i] for k, v in batch.items()}
            loss, _, grads = grads_of(params, mb)
            tree_map(lambda a, g: a.add_(g), acc, grads)
            losses.append(loss)
            del grads
        tree_map(lambda a: a.div_(micro), acc)
        loss = torch.stack(losses).mean()
        return loss, {"loss": loss}, acc

    def train_step(state: TrainState, batch):
        params = state.params
        loss, metrics, grads = total_grads(params, batch)
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        state.in_update = True
        updates, opt_state = optimizer.update(grads, state.opt_state, params, state.step)
        del grads
        apply_updates(params, updates)
        state.in_update = False
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step
