"""Shared layers (port of ``repro/models/layers.py``): initializers, RMS norm,
RoPE, GQA head repeat, dense masked attention, the KV-cache inserts (linear,
per-row slots, the sliding-window ring), and the MLP variants (``mlp_apply_overlapped``: the tensor-MP MLP on the
collective-matmul rings).  Plain functions over tensors; weights keep the JAX
(d_in, d_out) layout, so a projection is ``x @ w``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# initializers (same scales as the JAX package; the draws differ)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, lead=(),
               dtype=torch.float32, device=None):
    """N(0, 1/d_in) weights of shape (*lead, d_in, d_out)."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32, device=None):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

def embed_lookup(table, ids):
    """The rows ``ids`` of ``table``.  Its backward adds each row's gradients
    in one fixed order on the CPU and on CUDA, so two runs from the same
    state are the same bits (a kill-and-resume equals a straight run);
    indexing's backward (``index_put_`` with accumulate) on the CPU adds
    them in an order that depends on its threads."""
    return F.embedding(ids, table)


def rms_norm(x, gamma, eps: float = 1e-5):
    """Computed in f32, returned in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * gamma.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: broadcastable to (..., T).  Split-halves
    rotation with angles computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., T, hd/2)
    sin = torch.sin(angles)[..., None, :]                        # (..., T, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def repeat_kv(k, n_rep: int):
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd); KV head i serves query heads
    i*n_rep .. (i+1)*n_rep - 1."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention(q, k, v, *, causal: bool = True, q_start: int = 0,
              window: int = 0, kv_mask=None):
    """Dense GQA attention (the JAX ``attention`` below its dense threshold).
    q: (B,Tq,Hq,hd); k,v: (B,Tk,Hkv,hd); ``kv_mask`` an optional (B, Tk)
    bool of valid keys.  Scores and softmax in f32; the probabilities are
    cast to v's dtype before the value product.  The port's model does not
    call this: its attention goes through ``kernels.flash_attention``."""
    hq, hkv = q.shape[2], k.shape[2]
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
    qpos = q_start + torch.arange(tq, device=q.device)
    kpos = torch.arange(tk, device=q.device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask = mask[None, None]
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# KV cache (linear buffer, per-row slots, sliding-window ring)
# ---------------------------------------------------------------------------

def cache_insert_full(cache, k_new, v_new, pos: int):
    """Write (B,t,KV,hd) at absolute position ``pos`` of a (B,cap,KV,hd)
    cache.  Unlike the JAX function this writes IN PLACE (no cache copy per
    token) and returns the same tensors; it raises where JAX's
    dynamic_update_slice would silently clamp an out-of-range position."""
    t, cap = k_new.shape[1], cache["k"].shape[1]
    if not 0 <= pos <= cap - t:
        raise ValueError(f"cache insert of {t} token(s) at position {pos} "
                         f"overflows capacity {cap}")
    cache["k"][:, pos:pos + t] = k_new
    cache["v"][:, pos:pos + t] = v_new
    return cache


def cache_insert_at(cache, k_new, v_new, pos):
    """Write (B,t,KV,hd) at per-row positions ``pos`` (B,) of a (B,cap,KV,hd)
    cache: row b's t tokens land at pos[b] .. pos[b] + t - 1 (the slotted
    cache's insert; JAX vmaps a dynamic_update_slice over the rows).  One
    ``index_put_`` on device positions, in place, no host loop over rows.
    A scalar ``pos`` is ``cache_insert_full``.  JAX's dynamic_update_slice
    would clamp a position past cap - t; this does not: on the CPU it raises,
    and on the card the positions are never read on the host, so a caller
    must keep pos[b] + t <= cap (the continuous engine's capacity check at
    submit does)."""
    if not isinstance(pos, torch.Tensor) or pos.dim() == 0:
        return cache_insert_full(cache, k_new, v_new, int(pos))
    b, t = k_new.shape[:2]
    cap = cache["k"].shape[1]
    if pos.shape != (b,):
        raise ValueError(f"per-row positions {tuple(pos.shape)} for a batch of {b}")
    if pos.device.type == "cpu" and (int(pos.min()) < 0 or int(pos.max()) > cap - t):
        raise ValueError(f"cache insert of {t} token(s) at positions {pos.tolist()} "
                         f"overflows capacity {cap}")
    rows = torch.arange(b, device=pos.device)[:, None]
    cols = pos.long()[:, None] + torch.arange(t, device=pos.device)[None]
    cache["k"].index_put_((rows, cols), k_new)
    cache["v"].index_put_((rows, cols), v_new)
    return cache


def cache_insert_window(cache, k_new, v_new):
    """Shift-left ring insert for sliding-window caches (keys stored roped):
    the (B,W,KV,hd) ring drops its oldest slot and the new token lands in
    the last, as JAX's concatenate([cache[:, 1:], new]).  In place; one
    token a step (JAX's ring holds W slots only for t = 1)."""
    if k_new.shape[1] != 1:
        raise ValueError(f"a sliding-window ring takes one token a step, got "
                         f"{k_new.shape[1]}")
    for name, new in (("k", k_new), ("v", v_new)):
        ring = cache[name]
        ring[:, :-1] = ring[:, 1:].clone()
        ring[:, -1:] = new
    return cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, kind: str, *, lead=(),
             dtype=torch.float32, device=None):
    kw = dict(lead=lead, dtype=dtype, device=device)
    if kind == "swiglu":
        return {"wi": dense_init(gen, d, d_ff, **kw),
                "wg": dense_init(gen, d, d_ff, **kw),
                "wo": dense_init(gen, d_ff, d, **kw)}
    return {"wi": dense_init(gen, d, d_ff, **kw),
            "wo": dense_init(gen, d_ff, d, **kw)}


def mlp_apply(params, x, kind: str):
    if kind == "swiglu":
        h = F.silu(x @ params["wg"].to(x.dtype)) * (x @ params["wi"].to(x.dtype))
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"].to(x.dtype), approximate="tanh")
    elif kind == "sqrelu":
        h = torch.square(F.relu(x @ params["wi"].to(x.dtype)))
    else:
        raise ValueError(kind)
    return h @ params["wo"].to(x.dtype)


def mlp_apply_overlapped(params, x, kind: str, *, mesh, axis: str = "model",
                         chunks: int = 1, layer: int = 0):
    """The Megatron column/row-parallel MLP on the collective-matmul rings
    (``parallel.collectives``): ``x`` is (..., T/m, d), this rank's rows;
    ``wi``/``wg`` are its column slices, ``wo`` its row slice.  The gate and
    up products share one gather ring (their weights concatenated, so x
    travels the ring once).  Returns (..., T/m, d), this rank's rows.  The
    rings' messages are tagged (layer, 2) and (layer, 3)."""
    from repro_torch.parallel.collectives import all_gather_matmul, matmul_reduce_scatter

    kw = dict(mesh=mesh, axis=axis, chunks=chunks)
    if kind == "swiglu":
        ff = params["wi"].shape[-1]
        w2 = torch.cat([params["wg"], params["wi"]], dim=-1).to(x.dtype)
        gi = all_gather_matmul(x, w2, tag=(layer, 2), **kw)
        h = F.silu(gi[..., :ff]) * gi[..., ff:]
    elif kind == "gelu":
        h = F.gelu(all_gather_matmul(x, params["wi"].to(x.dtype), tag=(layer, 2), **kw),
                   approximate="tanh")
    elif kind == "sqrelu":
        h = torch.square(F.relu(all_gather_matmul(x, params["wi"].to(x.dtype),
                                                  tag=(layer, 2), **kw)))
    else:
        raise ValueError(kind)
    return matmul_reduce_scatter(h, params["wo"].to(x.dtype), tag=(layer, 3), **kw)
