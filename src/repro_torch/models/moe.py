"""Mixture-of-Experts FFN with capacity-bounded, sort-based dispatch (port of
``repro/models/moe.py``).

Dispatch is the JAX package's: flatten the (token, k) assignments, rank each
within its expert by a stable sort, and gather the kept tokens into a dense
``(E_local, capacity, d)`` buffer, so the three expert products are
fixed-shape grouped matmuls (``kernels.moe_gmm.gmm``: the CUDA kernel on the
card, its plain version on the CPU).  Tokens beyond an expert's capacity
are dropped; ``capacity_factor=None`` gives capacity = tokens, so nothing
drops.

Every shape is fixed by (tokens, k, E_local), so the dispatch makes no host
sync (no ``.item()``, ``nonzero`` or boolean mask).  Ties are settled as JAX
settles them: top-k prefers the lower expert id, the argsort is stable, the
scatters collide only in the drop bin, which is thrown away, and the
combine sums each token's k contributions as ``view(t, k, d).sum(1)``, with
no atomics.

Expert parallelism (``model_axis`` over a ``parallel.dist.RankMesh``, JAX's
``shard_map`` branch): each rank of the model axis holds E/m experts, the
contiguous slice [lo, lo + E/m) with lo = its place times E/m, and computes
only the assignments routed there (the others go to a sentinel, JAX's
``[lo, lo + E_local)`` slice); the shared expert is a column/row-parallel
MLP; the tokens, the same on every rank of the axis, enter through
``copy_to_model`` and the partial outputs are summed over the axis in the
activation dtype.  ``ff_axes`` (JAX's 2-D decode EP) additionally slices
each expert's hidden dim over those axes, whose ranks hold the same tokens,
and the sum spans them too.  The router runs whole on every rank; its aux
loss is counted once across the ranks that compute it alike
(``collectives.mean_over``, JAX's ``pmean``) and, where the tokens are
sharded over ``batch_axes``, taken over the global batch: the expert counts
and the router probabilities are summed over those axes, so the aux equals
the single-process one (JAX's shard_map returns one data shard's aux with
the gradient of the shards' mean instead).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm import gmm
from repro_torch.models import layers as L
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import dist as D


def moe_init(gen: torch.Generator, cfg, *, lead=(), dtype=torch.float32, device=None):
    """Router (d, E) in f32, experts wi/wg (E, d, ff) and wo (E, ff, d), and
    the shared expert when ``cfg.n_shared_experts`` > 0; every leaf with the
    leading dims ``lead`` (the layer stack)."""
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    kw = dict(lead=lead, device=device)
    experts = dict(lead=(*lead, e), dtype=dtype, device=device)
    params = {"router": L.dense_init(gen, d, e, dtype=torch.float32, **kw),
              "wi": L.dense_init(gen, d, ff, **experts),
              "wg": L.dense_init(gen, d, ff, **experts),
              "wo": L.dense_init(gen, ff, d, **experts)}
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        params["shared"] = {"wi": L.dense_init(gen, d, sff, dtype=dtype, **kw),
                            "wg": L.dense_init(gen, d, sff, dtype=dtype, **kw),
                            "wo": L.dense_init(gen, sff, d, dtype=dtype, **kw)}
    return params


def _route(router_w, xf, n_experts: int, k: int, *, mesh=None, data_axis=None):
    """Top-k routing over the f32 softmax.  Returns (ids (t, k), weights
    (t, k) renormalised, in xf's dtype, Switch load-balance aux loss).  With a
    ``data_axis`` group of ``mesh`` over which the tokens are sharded, the
    aux is the global batch's: the expert counts and the probability sums
    are summed over the group (the sums through ``collectives.psum``)."""
    probs = torch.softmax(xf.float() @ router_w, dim=-1)          # (t, E)
    # a stable descending sort breaks ties by the lower expert id, as
    # jax.lax.top_k does; torch.topk leaves the order of ties unspecified
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    f = torch.zeros((n_experts,), dtype=torch.float32, device=xf.device)
    f.index_add_(0, ids.reshape(-1), torch.ones(ids.numel(), device=xf.device))
    if data_axis is None:
        p = probs.mean(0)
    else:
        D.all_reduce(mesh, f, data_axis)
        p = CL.psum(probs.sum(0), mesh, data_axis) / (probs.shape[0] * mesh.size(data_axis))
    f = f / f.sum().clamp(min=1.0)
    aux = n_experts * (f * p).sum()
    return ids, w.to(xf.dtype), aux


def _expert_compute(xf, ids, w, wi, wg, wo, cap: int, lo: Optional[int] = None):
    """Routed-expert output of the experts [lo, lo + E_local) (every expert
    where ``lo`` is None: one device).

    xf: (t, d); ids, w: (t, k); wi, wg: (E_local, d, ff); wo: (E_local, ff,
    d).  Returns the partial (t, d) of the local experts' contributions."""
    t, d = xf.shape
    k = ids.shape[1]
    e = wi.shape[0]
    dev = xf.device
    local_ids = ids.reshape(-1)                                   # (t*k,)
    if lo is not None:
        # another rank's expert goes to the sentinel bin e, ranked after them all
        local = (local_ids >= lo) & (local_ids < lo + e)
        local_ids = torch.where(local, local_ids - lo, torch.full_like(local_ids, e))
    # rank within the expert's group, on the stably sorted order
    order = torch.argsort(local_ids, stable=True)
    counts = torch.zeros((e + (lo is not None),), dtype=torch.long, device=dev)
    counts.index_add_(0, local_ids, torch.ones_like(local_ids))
    starts = torch.cumsum(counts, 0) - counts
    arange = torch.arange(t * k, device=dev)
    rank = torch.empty_like(order).scatter_(0, order, arange - starts[local_ids[order]])
    # slot in the (E_local * cap) buffer; assignments beyond capacity (and
    # to other ranks' experts) go to the drop bin, one row past the end,
    # which is thrown away
    drop_bin = e * cap
    keep = rank < cap if lo is None else local & (rank < cap)
    slot = torch.where(keep, local_ids * cap + rank, torch.full_like(rank, drop_bin))
    # token of each buffer slot; t (the zero row) for empty slots
    buf_tok = torch.full((drop_bin + 1,), t, dtype=torch.long, device=dev)
    buf_tok.scatter_(0, slot, arange // k)
    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    # the gathers are F.embedding: its backward sums the copies of a row in
    # parallel segments, where indexing's backward adds them one after
    # another, and the buffer's empty slots are thousands of copies of the
    # zero row (B 4 x T 2048: 2.4 s of a 2.6 s step on the card)
    xb = F.embedding(buf_tok[:-1], xpad).reshape(e, cap, d)
    # expert FFN (swiglu), three grouped matmuls
    h = F.silu(gmm(xb, wg.to(xf.dtype)))
    h = h * gmm(xb, wi.to(xf.dtype))
    y = gmm(h, wo.to(xf.dtype)).reshape(drop_bin, d)
    # combine back, weighted (a dropped assignment reads the zero row past
    # y); token i's k contributions are rows i*k .. i*k+k-1
    ypad = torch.cat([y, y.new_zeros((1, d))], 0)
    contrib = F.embedding(slot, ypad) * w.reshape(-1, 1)
    return contrib.view(t, k, d).sum(1)


def _shared_expert(params, x):
    h = F.silu(x @ params["wg"].to(x.dtype)) * (x @ params["wi"].to(x.dtype))
    return h @ params["wo"].to(x.dtype)


def check_expert_parallel(cfg, m: int, ff: int = 1) -> None:
    """Raise ValueError where a model axis of ``m`` ranks (and ``ff`` ranks
    on the ff axes) cannot split ``cfg``'s experts: the bank's E, the expert
    and shared hidden dims must divide, as the in_specs of JAX's shard_map
    demand (the sharding rules would replicate the bank instead, which the
    shard_map then cannot split either).  A shared expert under ff axes is
    refused: JAX's sum over the ff axes would add its output once a rank of
    them (its weights are not sliced over them)."""
    if m <= 1 and ff <= 1:
        return
    sff = cfg.expert_d_ff * cfg.n_shared_experts
    for n, what, by in ((cfg.n_experts, "n_experts", m), (cfg.expert_d_ff, "expert_d_ff", ff),
                        (sff, "the shared expert's hidden dim", m)):
        if n and n % by:
            raise ValueError(f"{cfg.name}: {what} ({n}) does not divide over {by} ranks; "
                             f"expert parallelism needs it to (JAX's shard_map in_specs)")
    if sff and ff > 1:
        raise ValueError(f"{cfg.name}: a shared expert under ff_axes would be summed once a "
                         f"rank of the ff axes (JAX's psum over them); the port refuses it")


def _capacity(cfg, t: int, capacity_factor) -> int:
    if capacity_factor is None:
        return t          # no drop: an expert receives each token at most once
    return max(1, math.ceil(t * cfg.experts_per_token / cfg.n_experts * capacity_factor))


def moe_ffn(params, x, cfg, *, model_axis: Optional[str] = None, ff_axes=None,
            capacity_factor: Optional[float] = 1.25, mesh=None, batch_axes=("data",)):
    """MoE FFN.  x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    Without ``model_axis`` every expert is local.  With one (a ``mesh``, this
    rank's ``parallel.dist.RankMesh``), ``params`` are this rank's part: the
    expert banks' E/m experts (each hidden dim sliced over ``ff_axes`` too),
    the shared expert's column (``wi``, ``wg``) and row (``wo``) slices, the
    router whole; ``x`` is this rank's tokens, the same on every rank of the
    model axis and of ``ff_axes``, sharded over ``batch_axes`` otherwise.
    The capacity comes from the rank's own token count, as in JAX.  Returns
    the whole output and the aux on every rank."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    k = cfg.experts_per_token
    cap = _capacity(cfg, t, capacity_factor)
    lo, xin, router, data = None, xf, params["router"], None
    if model_axis is None and ff_axes:
        raise ValueError(f"ff_axes {ff_axes!r} slice the experts beside a model axis; none "
                         f"was given")
    if model_axis is not None:
        if mesh is None:
            raise ValueError(f"model_axis {model_axis!r} shards the experts over a mesh; none "
                             f"was given")
        ff = tuple(a for a in ff_axes or () if a and mesh.size(a) > 1)
        j, m = mesh.ring(model_axis)[:2]
        check_expert_parallel(cfg, m, math.prod(mesh.size(a) for a in ff))
        group = CL.axes_group(mesh, (model_axis, *ff))
        lo = j * params["wi"].shape[0]
        if params["wi"].shape[0] * m != cfg.n_experts:
            raise ValueError(f"this rank holds {params['wi'].shape[0]} experts; a {m}-way "
                             f"model axis gives each rank {cfg.n_experts // m}")
        xin = CL.copy_to_model(xf, mesh, group)
        router = CL.copy_to_model(router, mesh, group)
        # tokens replicated over the ff axes see the global batch already
        data = None if ff else next((a for a in batch_axes or () if a and mesh.size(a) > 1),
                                    None)
    ids, w, aux = (_route(router, xin, cfg.n_experts, k) if data is None else
                   _route(router, xin, cfg.n_experts, k, mesh=mesh, data_axis=data))
    out = _expert_compute(xin, ids, w, params["wi"], params["wg"], params["wo"], cap, lo)
    if "shared" in params:
        out = out + _shared_expert(params["shared"], xin)
    if model_axis is None:
        return out.reshape(b, s, d), aux
    # reduce in the activation dtype, as JAX does
    out = CL.reduce_from_model(out.to(x.dtype), mesh, group)
    return out.reshape(b, s, d), CL.mean_over(aux, mesh, group)


def moe_ffn_dense_oracle(params, x, cfg):
    """Reference: every expert computes every token; combine by router weights."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    ids, w, aux = _route(params["router"], xf, cfg.n_experts, cfg.experts_per_token)
    h = F.silu(torch.einsum("td,edf->etf", xf, params["wg"].to(xf.dtype)))
    h = h * torch.einsum("td,edf->etf", xf, params["wi"].to(xf.dtype))
    y = torch.einsum("etf,efd->etd", h, params["wo"].to(xf.dtype))    # (E, t, d)
    comb = torch.zeros((xf.shape[0], cfg.n_experts), dtype=xf.dtype, device=xf.device)
    comb.scatter_(1, ids, w)
    out = torch.einsum("te,etd->td", comb, y)
    if "shared" in params:
        out = out + _shared_expert(params["shared"], xf)
    return out.reshape(b, s, d), aux
