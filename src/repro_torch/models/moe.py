"""Mixture-of-Experts FFN with capacity-bounded, sort-based dispatch (port of
the single-device path of ``repro/models/moe.py``).

Dispatch is the JAX package's: flatten the (token, k) assignments, rank each
within its expert by a stable sort, and gather the kept tokens into a dense
``(E, capacity, d)`` buffer, so the three expert products are fixed-shape
grouped matmuls (``kernels.moe_gmm.gmm``: the CUDA kernel on the card, its
plain version on the CPU).  Tokens beyond an expert's capacity are dropped;
``capacity_factor=None`` gives capacity = tokens, so nothing drops.

Every shape is fixed by (tokens, k, E), so the dispatch makes no host sync
(no ``.item()``, ``nonzero`` or boolean mask).  Ties are settled as JAX
settles them: top-k prefers the lower expert id, the argsort is stable, the
scatters collide only in the drop bin, which is thrown away, and the
combine sums each token's k contributions as ``view(t, k, d).sum(1)``, with
no atomics.

Only the single-device path is ported: every expert is local, so the JAX
dispatch's [lo, lo + E_local) slice is not kept.  Expert parallelism
(``model_axis``, ``ff_axes``) raises ``NotImplementedError`` naming its
ROADMAP.md item.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm import gmm
from repro_torch.models import layers as L

EXPERT_PARALLEL = "ROADMAP.md Queue 1 item 15 (expert parallelism)"


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


def _route(router_w, xf, n_experts: int, k: int):
    """Top-k routing over the f32 softmax.  Returns (ids (t, k), weights
    (t, k) renormalised, in xf's dtype, Switch load-balance aux loss)."""
    probs = torch.softmax(xf.float() @ router_w, dim=-1)          # (t, E)
    # a stable descending sort breaks ties by the lower expert id, as
    # jax.lax.top_k does; torch.topk leaves the order of ties unspecified
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    f = torch.zeros((n_experts,), dtype=torch.float32, device=xf.device)
    f.index_add_(0, ids.reshape(-1), torch.ones(ids.numel(), device=xf.device))
    f = f / f.sum().clamp(min=1.0)
    aux = n_experts * (f * probs.mean(0)).sum()
    return ids, w.to(xf.dtype), aux


def _expert_compute(xf, ids, w, wi, wg, wo, cap: int):
    """Routed-expert output on one device, where every expert is local.

    xf: (t, d); ids, w: (t, k); wi, wg: (E, d, ff); wo: (E, ff, d).
    Returns (t, d)."""
    t, d = xf.shape
    k = ids.shape[1]
    e = wi.shape[0]
    dev = xf.device
    flat_ids = ids.reshape(-1)                                    # (t*k,)
    # rank within the expert's group, on the stably sorted order
    order = torch.argsort(flat_ids, stable=True)
    counts = torch.zeros((e,), dtype=torch.long, device=dev)
    counts.index_add_(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts
    arange = torch.arange(t * k, device=dev)
    rank = torch.empty_like(order).scatter_(0, order, arange - starts[flat_ids[order]])
    # slot in the (E * cap) buffer; assignments beyond capacity go to the
    # drop bin, one row past the end, which is thrown away
    drop_bin = e * cap
    slot = torch.where(rank < cap, flat_ids * cap + rank, torch.full_like(rank, drop_bin))
    # token of each buffer slot; t (the zero row) for empty slots
    buf_tok = torch.full((drop_bin + 1,), t, dtype=torch.long, device=dev)
    buf_tok.scatter_(0, slot, arange // k)
    xpad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xb = xpad[buf_tok[:-1]].reshape(e, cap, d)
    # expert FFN (swiglu), three grouped matmuls
    h = F.silu(gmm(xb, wg.to(xf.dtype)))
    h = h * gmm(xb, wi.to(xf.dtype))
    y = gmm(h, wo.to(xf.dtype)).reshape(drop_bin, d)
    # combine back, weighted (a dropped assignment reads the zero row past
    # y); token i's k contributions are rows i*k .. i*k+k-1
    ypad = torch.cat([y, y.new_zeros((1, d))], 0)
    contrib = ypad[slot] * w.reshape(-1, 1)
    return contrib.view(t, k, d).sum(1)


def _shared_expert(params, x):
    h = F.silu(x @ params["wg"].to(x.dtype)) * (x @ params["wi"].to(x.dtype))
    return h @ params["wo"].to(x.dtype)


def moe_ffn(params, x, cfg, *, model_axis: Optional[str] = None, ff_axes=None,
            capacity_factor: Optional[float] = 1.25):
    """MoE FFN.  x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    if model_axis is not None or ff_axes:
        raise NotImplementedError(f"expert-parallel MoE (model_axis={model_axis!r}, "
                                  f"ff_axes={ff_axes!r}) is not ported to repro_torch "
                                  f"yet: {EXPERT_PARALLEL}")
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    k = cfg.experts_per_token
    ids, w, aux = _route(params["router"], xf, cfg.n_experts, k)
    if capacity_factor is None:
        cap = t          # no drop: an expert receives each token at most once
    else:
        cap = max(1, math.ceil(t * k / cfg.n_experts * capacity_factor))
    out = _expert_compute(xf, ids, w, params["wi"], params["wg"], params["wo"], cap)
    if "shared" in params:
        out = out + _shared_expert(params["shared"], xf)
    return out.reshape(b, s, d), aux


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
