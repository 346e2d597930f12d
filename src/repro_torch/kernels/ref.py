"""Plain PyTorch oracles for the port's kernels (counterpart of
``repro/kernels/ref.py``): small, obviously-right definitions of what each
kernel computes, used by the CPU path and held against the kernels on the
card."""
from __future__ import annotations

import math

import torch


def keep_mask(tq: int, tk: int, causal: bool, window: int, device, kv_lens=None):
    """The (query, key) pairs the masks keep: (Tq, Tk) bool, or (B, Tq, Tk)
    with per-row key lengths ``kv_lens`` (B,).  Without them query i sits at
    position i (causal aligned top-left); with them row b keeps keys
    [0, kv_lens[b]) and its query i sits at kv_lens[b] - Tq + i (causal
    aligned bottom-right on the row's prefix).  ``window`` keeps keys
    j > qpos - window."""
    qpos = torch.arange(tq, device=device)[:, None]
    kpos = torch.arange(tk, device=device)[None, :]
    keep = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if kv_lens is not None:
        lens = kv_lens.to(device=device, dtype=torch.long)[:, None, None]
        qpos = qpos[None] + lens - tq                                # (B, Tq, 1)
        keep = kpos[None] < lens
    if causal:
        keep = keep & (kpos <= qpos)
    if window > 0:
        keep = keep & (kpos > qpos - window)
    return keep


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, kv_lens=None):
    """q: (B,Tq,H,hd); k,v: (B,Tk,H,hd) — dense softmax attention in f32,
    returned in ``q.dtype``.  Masks as the JAX oracle (``keep_mask``):
    causal is aligned top-left (query i sees keys j <= i) and ``window``
    keeps keys j > i - w; with ``kv_lens`` each row's mask is JAX's
    slot-mode mask over its first kv_lens[b] keys."""
    tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    mask = keep_mask(tq, tk, causal, window, q.device, kv_lens)
    if kv_lens is not None:
        mask = mask[:, None]                                         # (B, 1, Tq, Tk)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def gmm_ref(x, w):
    """Grouped matmul: x (G, C, d) @ w (G, d, F) -> (G, C, F), summed in f32
    (f64 for f64 inputs) and returned in x's dtype."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.einsum("gcd,gdf->gcf", x.to(ct), w.to(ct)).to(x.dtype)


def gmm_bwd_plain(x, w, dy, *, need_dx: bool = True, need_dw: bool = True):
    """Gradients of ``gmm_ref(x, w)`` for the output gradient dy (G, C, F):
    dx = dy w^T (G, C, d) and dw = x^T dy (G, d, F), each summed in f32 (f64
    for f64 inputs) and rounded once, to x's and w's dtypes; None for a
    product not asked for."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    dyc = dy.to(ct)
    dx = torch.einsum("gcf,gdf->gcd", dyc, w.to(ct)).to(x.dtype) if need_dx else None
    dw = torch.einsum("gcd,gcf->gdf", x.to(ct), dyc).to(w.dtype) if need_dw else None
    return dx, dw


def lstm_cell_ref(x, h, c, wx, wh, b):
    """x: (B, d_in); h: (B, H_in); c: (B, H); wx: (d_in, 4, H); wh: (H_in, 4, H).

    Gate order (i, f, g, o); forget bias +1 (as ``models/lstm.py``).  Computed
    in f32 (f64 for f64 inputs); returns (h', c') in h's and c's dtypes."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    gates = torch.einsum("bd,dgh->bgh", x.to(ct), wx.to(ct)) \
        + torch.einsum("bd,dgh->bgh", h.to(ct), wh.to(ct)) + b.to(ct)
    i, f, g, o = gates[:, 0], gates[:, 1], gates[:, 2], gates[:, 3]
    c_new = torch.sigmoid(f + 1.0) * c.to(ct) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def wkv6_ref(r, k, v, w, u, state=None):
    """Sequential RWKV6 WKV recurrence.  r, k, v, w: (B, T, H, hd); u: (H, hd);
    ``state``: the initial (B, H, hd, hd) state, zeros when None, laid out
    S[key_dim, value_dim].  Per token, with kv = k_t^T v_t:

        o_t = r_t (S + diag(u) kv),    S <- diag(w_t) S + kv

    Computed in f32 (f64 for f64 inputs); returns (out (B, T, H, hd),
    S_final) in that dtype.  ``state`` is read, never written."""
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    b, t, h, hd = r.shape
    r, k, v, w = (x.to(ct) for x in (r, k, v, w))
    bonus = u.to(ct)[None, :, :, None]
    if state is None:
        s = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device)
    else:
        s = state.to(ct)
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, i], s + bonus * kv))
        s = w[:, i, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv6_chunked_plain(r, k, v, w, u, state=None, *, sub: int = 16):
    """The chunked arithmetic of the ``chunked`` WKV kernel (``csrc/wkv6.cu``)
    in plain PyTorch: the same recurrence as ``wkv6_ref``, sub-chunk by
    sub-chunk of ``sub`` tokens (the last one partial), the state carried
    between them.  Within a sub-chunk, with every decay a running product of
    w (no factor above 1, so nothing overflows where the split
    exp(cum_t) * exp(-cum_s) would):

        out   = (r_t prod_{q<t} w_q) S + sum_{s<=t} P[t, s] v_s
        P     = sum_i r_t k_s prod_{s<q<t} w_q  (s < t),  sum_i r_t u k_t  (s = t)
        S    <- diag(prod_q w_q) S + sum_s (k_s prod_{q>s} w_q)^T v_s

    with k_s prod_{s<q<t} w_q built token by token, as the kernel builds it.
    Computed in f32 (f64 for f64 inputs); returns (out (B, T, H, hd),
    S_final) in that dtype.  ``state`` is read, never written."""
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    b, t, h, hd = r.shape
    r, k, v, w = (x.to(ct).transpose(1, 2) for x in (r, k, v, w))   # (B, H, T, hd)
    bonus = u.to(ct)[None, :, None, :]
    s = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device) if state is None \
        else state.to(ct)
    outs = []
    for t0 in range(0, t, sub):
        rc, kc, vc, wc = (x[:, :, t0:t0 + sub] for x in (r, k, v, w))
        n = rc.shape[2]
        ones = torch.ones_like(wc[:, :, :1])
        dec_in = torch.cumprod(torch.cat([ones, wc[:, :, :-1]], 2), 2)         # prod_{q<t}
        dec_out = torch.cumprod(torch.cat([ones, wc[:, :, 1:].flip(2)], 2), 2).flip(2)
        p = torch.zeros((b, h, n, n), dtype=ct, device=r.device)
        f = kc.clone()                        # f[s] = k_s prod_{s<q<t}, built token by token
        for i in range(n):
            p[:, :, i, i] = (rc[:, :, i] * bonus[:, :, 0] * kc[:, :, i]).sum(-1)
            if i > 1:
                f[:, :, :i - 1] = f[:, :, :i - 1] * wc[:, :, i - 1:i]
            if i > 0:
                p[:, :, i, :i] = torch.einsum("bhk,bhsk->bhs", rc[:, :, i], f[:, :, :i])
        outs.append((rc * dec_in) @ s + p @ vc)
        total = dec_in[:, :, -1] * wc[:, :, -1]
        s = total[..., None] * s + (kc * dec_out).transpose(2, 3) @ vc
    return torch.cat(outs, 2).transpose(1, 2), s


WKV_BWD_CHUNK = 64   # tokens between the saved states (csrc/wkv6.cu's kBwdChunk)
WKV_BWD_SUB = 16     # tokens of a sub-chunk (its kBwdSub)


def wkv6_bwd_plain(r, k, v, w, u, do):
    """The arithmetic of the WKV backward kernels (``csrc/wkv6.cu``) in plain
    PyTorch: the gradients of ``wkv6_ref(r, k, v, w, u)[0]`` (zero initial
    state, final state unused) for the output gradient ``do`` (B, T, H, hd).
    With G_t = dL/dS_t (G_{T-1} = 0, G_{t-1} = r_t^T do_t + diag(w_t) G_t)
    and vdo_t = v_t . do_t:

        dr_t = S_{t-1} do_t + u k_t vdo_t           (forward, saving S at
                                                      every chunk start)
        dv_t = k_t (G_t + diag(u) r_t^T do_t)        (reverse)
        dk_t = G_t v_t + u r_t vdo_t                 (reverse)
        dw_t = sum_j G_t S_{t-1}                     (reverse)
        du   = sum_{b,t} r_t k_t vdo_t               (over t, then over b)

    S_{t-1} is never recovered from S_t (that divides by w, which underflows
    to 0 under strong decays): within a sub-chunk of 16 tokens from
    t0, S_{t-1} = D(t0..t-1) S_{t0-1} + sum_{t0<=s<t} D(s+1..t-1) k_s^T v_s
    with D(a..b) = prod_{a<=q<=b} w_q, so

        dw_t = D(t0..t-1) (G_t . S_{t0-1}) + sum_{t0<=s<t} D(s+1..t-1) k_s (G_t v_s),

    the products of w built from 1 token by token; S_{t0-1} is recomputed
    forward from the saved state of its chunk.  Computed in f32 (f64 for
    f64 inputs); returns (dr, dk, dv) in r's dtype and (dw, du) in f32 (f64
    for f64 inputs)."""
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    b, t, h, hd = r.shape
    rf, kf, vf, wf, dof = (x.to(ct) for x in (r, k, v, w, do))
    uf = u.to(ct)
    vdo = (vf * dof).sum(-1, keepdim=True)                          # (B, T, H, 1)
    zeros = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device)

    def advance(s, i):                        # S_i from S_{i-1}
        return wf[:, i, :, :, None] * s + kf[:, i, :, :, None] * vf[:, i, :, None, :]

    dr, dk, dv, dw = (torch.empty((b, t, h, hd), dtype=ct, device=r.device)
                      for _ in range(4))
    saved, s = {}, zeros
    for i in range(t):
        if i % WKV_BWD_CHUNK == 0 and i > 0:
            saved[i // WKV_BWD_CHUNK] = s
        dr[:, i] = torch.einsum("bhij,bhj->bhi", s, dof[:, i]) + uf * kf[:, i] * vdo[:, i]
        s = advance(s, i)
    du = (rf * kf * vdo).sum(1).sum(0)
    g = zeros
    for i in reversed(range(t)):
        rdo = rf[:, i, :, :, None] * dof[:, i, :, None, :]
        dv[:, i] = torch.einsum("bhi,bhij->bhj", kf[:, i], g + uf[None, :, :, None] * rdo)
        g = wf[:, i, :, :, None] * g + rdo
    g = zeros
    chunk, sub = WKV_BWD_CHUNK, WKV_BWD_SUB
    for c in reversed(range(-(-t // chunk))):
        starts = list(range(c * chunk, min((c + 1) * chunk, t), sub))
        s, firsts = saved.get(c, zeros), []
        for t0 in starts:                     # the state before each sub-chunk
            firsts.append(s)
            for i in range(t0, min(t0 + sub, t)):
                s = advance(s, i)
        for t0, s0 in reversed(list(zip(starts, firsts))):
            for i in reversed(range(t0, min(t0 + sub, t))):
                dk[:, i] = torch.einsum("bhij,bhj->bhi", g, vf[:, i]) + uf * rf[:, i] * vdo[:, i]
                y = (g * s0).sum(-1)
                acc, prod = torch.zeros_like(y), torch.ones_like(y)
                for j in reversed(range(t0, i)):
                    acc = acc + prod * kf[:, j] * torch.einsum("bhij,bhj->bhi", g, vf[:, j])
                    prod = prod * wf[:, j]
                dw[:, i] = prod * y + acc
                g = wf[:, i, :, :, None] * g + rf[:, i, :, :, None] * dof[:, i, :, None, :]
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du
