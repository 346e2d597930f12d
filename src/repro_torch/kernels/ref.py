"""Plain PyTorch oracles for the port's kernels (counterpart of
``repro/kernels/ref.py``): small, obviously-right definitions of what each
kernel computes, used by the CPU path and held against the kernels on the
card."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,Tq,H,hd); k,v: (B,Tk,H,hd) — dense softmax attention in f32,
    returned in ``q.dtype``.  Masks as the JAX oracle: causal is aligned
    top-left (query i sees keys j <= i) and ``window`` keeps keys j > i - w."""
    tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    qpos = torch.arange(tq, device=q.device)[:, None]
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def gmm_ref(x, w):
    """Grouped matmul: x (G, C, d) @ w (G, d, F) -> (G, C, F), summed in f32
    (f64 for f64 inputs) and returned in x's dtype."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    return torch.einsum("gcd,gdf->gcf", x.to(ct), w.to(ct)).to(x.dtype)


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
