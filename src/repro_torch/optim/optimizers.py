"""Optimizers (port of ``repro/optim/optimizers.py``) with the same
two-function API:

    opt = adamw(lr_schedule, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

Params, grads and states are trees (dicts, lists) of tensors.  The state is
updated in place and ``apply_updates`` adds the updates into the params in
place, all under ``torch.no_grad()``: no second copy of a 1.8 B-parameter
model is made.  Scalars (step, bias corrections, learning rate) are computed
in f32 on the host, as the JAX optimizers compute them, and enter the device
arithmetic as exact f32 values.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params, step) -> (updates, state)
    # each element's update reads only that element's gradient, state and
    # parameter, so it runs on any shard of a leaf (Adafactor's does not)
    elementwise: bool = True


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


def _scalar(x) -> float:
    """An f32 host scalar as the Python float that holds it exactly."""
    return float(_f32(x))


@torch.no_grad()
def apply_updates(params, updates):
    """p <- (p.f32 + u).astype(p.dtype), in place; returns ``params``."""
    def add(p, u):
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_(p.float() + u)
    tree_map(add, params, updates)
    return params


@torch.no_grad()
def sum_of_squares(tree) -> torch.Tensor:
    """The sum of squares of every leaf, in f32, on the leaves' device."""
    total = None
    for x in tree_leaves(tree):
        v = x.float().reshape(-1)
        s = torch.dot(v, v)
        total = s if total is None else total + s
    return total


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` in place by min(1, max_norm / norm); returns (grads,
    norm).  ``norm`` defaults to the global norm of ``grads``' own leaves; a
    caller whose leaves are one part of a model (a pipeline stage) passes the
    whole model's.  The scale stays on the device (no host sync)."""
    if norm is None:
        norm = torch.sqrt(sum_of_squares(grads))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    tree_map(lambda g: g.mul_(scale), grads)
    return grads, norm


def sgd(lr: Callable) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        neg_lr = -_scalar(lr(step))
        return tree_map(lambda g: g.float() * neg_lr, grads), state

    return Optimizer(init, update)


def momentum_sgd(lr: Callable, momentum: float = 0.9,
                 dtype=torch.float32) -> Optimizer:
    """The paper's CNN/LSTM optimizer.  Momentum kept in ``dtype`` (bf16 option
    halves optimizer memory for the giant archs)."""

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                                    device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        neg_lr = -_scalar(lr(step))

        def upd(g, m):
            m32 = m if m.dtype == torch.float32 else m.float()
            m32.mul_(momentum).add_(g.float())
            if m32 is not m:
                m.copy_(m32)
            return m32 * neg_lr

        return tree_map(upd, grads, state["m"]), state

    return Optimizer(init, update)


def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        bc1 = _scalar(1 - _f32(b1) ** t)
        bc2 = _scalar(1 - _f32(b2) ** t)
        lr_t = _f32(lr(step))
        neg_lr = -_scalar(lr_t)
        wd = _scalar(lr_t * weight_decay) if weight_decay else 0.0

        def upd(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / bc2).sqrt_().add_(eps)
            u = (m / bc1).mul_(neg_lr).div_(denom)
            if weight_decay:
                u.sub_(p.float() * wd)
            return u

        return tree_map(upd, grads, state["m"], state["v"], params), state

    return Optimizer(init, update)


def adafactor(lr: Callable, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018).

    For a (.., r, c) weight, keeps only row/col second-moment accumulators —
    O(r + c) instead of O(r*c) state."""

    def init(params):
        def z(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
        return {"acc": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = _f32(step) + 1.0
        beta = _f32(1.0 - t ** (-decay))
        b, one_b = _scalar(beta), _scalar(1 - beta)
        neg_lr = -_scalar(lr(step))

        def upd(g, acc):
            g = g.float()
            g2 = g.square() + eps
            if g.dim() >= 2:
                vr = acc["vr"].mul_(b).add_(one_b * g2.mean(-1))
                vc = acc["vc"].mul_(b).add_(one_b * g2.mean(-2))
                denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                                   / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                                 min=eps))
                u = g / torch.clamp(denom, min=eps)
            else:
                v = acc["v"].mul_(b).add_(one_b * g2)
                u = g / torch.sqrt(v + eps)
            rms = torch.sqrt(torch.mean(u.square()) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return u * neg_lr

        return tree_map(upd, grads, state["acc"]), state

    return Optimizer(init, update, elementwise=False)


OPTIMIZERS = {
    "sgd": sgd,
    "momentum": momentum_sgd,
    "adamw": adamw,
    "adafactor": adafactor,
}
