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

On a rank that holds only a part of some leaves (tensor MP, fsdp, a
pipeline stage), ``init`` and ``update`` take ``cuts``, one ``LeafCuts`` a
leaf in ``tree_leaves`` order: where the rest of the leaf lies.  Every
update but Adafactor's reads only each element's own gradient, state and
parameter and ignores them; Adafactor's means (its row and column
statistics, the mean of the row statistic and the RMS clip) are taken over
the whole leaf.  Without ``cuts`` every update is the single-process one,
bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable            # (params, cuts=None) -> state
    update: Callable          # (grads, state, params, step, cuts=None) -> (updates, state)


@dataclasses.dataclass(frozen=True)
class LeafCuts:
    """Where the rest of one leaf lies when a rank holds a part of it.  The
    optimizer reads the rank's part viewed as ``view_shape``: ``fold`` leading dims
    (after ``lead``) merged into the one dim of the whole leaf they are (a
    pipeline stage's (v, Lc) chunks of the stacked layer dim), and ``lead``
    leading dims that index separate leaves of the whole model (a stage's
    stacked layers of a model whose tree holds one leaf a layer).
    ``parts[dim]`` is the number of parts the whole leaf is cut into along
    ``dim`` of the view (absent: whole along it), and ``sum(t, dims)`` sums
    ``t`` in place over the ranks that hold the other parts along any of
    ``dims``."""
    parts: Mapping[int, int] = dataclasses.field(default_factory=dict)
    sum: Callable = None
    lead: int = 0
    fold: int = 1

    def view_shape(self, shape) -> tuple:
        shape = tuple(shape)
        if self.fold == 1:
            return shape
        end = self.lead + self.fold
        return shape[:self.lead] + (math.prod(shape[self.lead:end]),) + shape[end:]

    def unfold(self, leaf_shape, shape) -> tuple:
        """A view-shaped state's shape in the leaf's own dims, where the
        state keeps the view's folded dim (``shape`` is then that dim's and
        the rest's)."""
        if self.fold == 1:
            return tuple(shape)
        return tuple(leaf_shape[:self.lead + self.fold]) + tuple(shape[self.lead + 1:])


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
    def init(params, cuts=None):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step, cuts=None):
        neg_lr = -_scalar(lr(step))
        return tree_map(lambda g: g.float() * neg_lr, grads), state

    return Optimizer(init, update)


def momentum_sgd(lr: Callable, momentum: float = 0.9,
                 dtype=torch.float32) -> Optimizer:
    """The paper's CNN/LSTM optimizer.  Momentum kept in ``dtype`` (bf16 option
    halves optimizer memory for the giant archs)."""

    def init(params, cuts=None):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                                    device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, step, cuts=None):
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
    def init(params, cuts=None):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step, cuts=None):
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
    O(r + c) instead of O(r*c) state.  With ``cuts`` each statistic is the
    whole leaf's: the sums are completed over the ranks that hold the other
    parts (``LeafCuts.sum``) and divided by the whole dim's size.  A rank's
    ``vr`` and ``vc`` are then its parts of the whole leaf's, as JAX's
    ``opt_specs`` place them: ``vr`` cut as the leaf's leading dims, ``vc``
    as all but its second-to-last."""

    def init(params, cuts=None):
        leaves = tree_leaves(params)
        cuts = cuts or [None] * len(leaves)

        def z(p, c):
            c = c or LeafCuts()
            shape, lead = c.view_shape(p.shape), c.lead
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=p.device)  # noqa: E731
            unfold = lambda s: c.unfold(p.shape, s)  # noqa: E731
            if len(shape) - lead >= 2:
                vc = shape[:-2] + shape[-1:]
                return {"vr": zeros(unfold(shape[:-1])),
                        "vc": zeros(unfold(vc) if len(shape) - lead >= 3 else vc)}
            return {"v": zeros(unfold(shape))}
        return {"acc": tree_unflatten(params, [z(p, c) for p, c in zip(leaves, cuts)])}

    @torch.no_grad()
    def update(grads, state, params, step, cuts=None):
        t = _f32(step) + 1.0
        beta = _f32(1.0 - t ** (-decay))
        b, one_b = _scalar(beta), _scalar(1 - beta)
        neg_lr = -_scalar(lr(step))
        it = iter(cuts or ())

        def upd(g, acc):
            c = next(it, None)
            shape = g.shape
            g = g.float() if c is None else g.float().reshape(c.view_shape(shape))
            lead = 0 if c is None else c.lead
            nd = g.dim()
            g2 = g.square() + eps
            if nd - lead >= 2:
                row = _whole_mean(g2, -1, nd - 1, c)
                col = _whole_mean(g2, -2, nd - 2, c)
                vr = acc["vr"].view(g.shape[:-1]).mul_(b).add_(one_b * row)
                vc = acc["vc"].view(g.shape[:-2] + g.shape[-1:]).mul_(b).add_(one_b * col)
                vr_mean = _whole_mean(vr, -1, nd - 2, c, keepdim=True)
                denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                                   / torch.clamp(vr_mean[..., None], min=eps))
                u = g / torch.clamp(denom, min=eps)
            else:
                v = acc["v"].view(g.shape).mul_(b).add_(one_b * g2)
                u = g / torch.sqrt(v + eps)
            if c is None:
                ms = torch.mean(u.square())
            else:
                dims = tuple(range(lead, nd))
                cut = tuple(d for d in dims if c.parts.get(d, 1) > 1)
                ms = u.square().sum(dims, keepdim=True)
                if cut:
                    ms = c.sum(ms, cut)
                ms = ms / (math.prod(u.shape[lead:]) * math.prod(c.parts.get(d, 1) for d in cut))
            rms = torch.sqrt(ms + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (u * neg_lr).reshape(shape)

        return tree_map(upd, grads, state["acc"]), state

    return Optimizer(init, update)


def _whole_mean(t, axis: int, dim: int, c, keepdim: bool = False):
    """The mean of ``t`` over ``axis``, which is view dim ``dim`` of a leaf
    cut as ``c`` says: the local sum completed over the ranks that hold the
    other parts along it, over the whole dim's size (the local mean where
    the dim is whole, or without ``c``)."""
    n = 1 if c is None else c.parts.get(dim, 1)
    if n == 1:
        return t.mean(axis, keepdim=keepdim)
    return c.sum(t.sum(axis, keepdim=keepdim), (dim,)) / (t.shape[axis] * n)


OPTIMIZERS = {
    "sgd": sgd,
    "momentum": momentum_sgd,
    "adamw": adamw,
    "adafactor": adafactor,
}
