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


WKV_BWD_CHUNK = 64   # tokens a block of the chunk kernel owns (csrc/wkv6.cu's kBwdChunk)
WKV_BWD_SUB = 16     # tokens of a sub-chunk (its kBwdSub)
_PLAIN_SAVE_EVERY = 64   # the sequential oracle keeps S every 64 tokens (memory only)


def wkv6_bwd_plain(r, k, v, w, u, do):
    """The sequential WKV backward in plain PyTorch, the oracle the backward
    kernels (``csrc/wkv6.cu``) are held against and the CPU path of
    ``wkv6_bwd``: the gradients of ``wkv6_ref(r, k, v, w, u)[0]`` (zero
    initial state, final state unused) for the output gradient ``do`` (B, T,
    H, hd).
    With G_t = dL/dS_t (G_{T-1} = 0, G_{t-1} = r_t^T do_t + diag(w_t) G_t)
    and vdo_t = v_t . do_t:

        dr_t = S_{t-1} do_t + u k_t vdo_t            (forward)
        dv_t = k_t (G_t + diag(u) r_t^T do_t)        (reverse)
        dk_t = G_t v_t + u r_t vdo_t                 (reverse)
        dw_t = sum_j G_t S_{t-1}                     (reverse)
        du   = sum_{b,t} r_t k_t vdo_t               (over t, then over b)

    S_{t-1} is never recovered from S_t (that divides by w, which underflows
    to 0 under strong decays).  To bound its memory the forward keeps S only
    every 64 tokens, and the reverse walk recomputes the states of one such
    stretch forward from its saved start before it walks them back, token by
    token.  Computed in f32 (f64 for f64 inputs); returns (dr, dk, dv) in r's
    dtype and (dw, du) in f32 (f64 for f64 inputs)."""
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
    saved, s = [], zeros
    for i in range(t):
        if i % _PLAIN_SAVE_EVERY == 0:
            saved.append(s)
        dr[:, i] = torch.einsum("bhij,bhj->bhi", s, dof[:, i]) + uf * kf[:, i] * vdo[:, i]
        s = advance(s, i)
    du = (rf * kf * vdo).sum(1).sum(0)
    g = zeros
    for c in reversed(range(len(saved))):
        lo, hi = c * _PLAIN_SAVE_EVERY, min((c + 1) * _PLAIN_SAVE_EVERY, t)
        before, s = [], saved[c]              # S_{i-1} for i in [lo, hi)
        for i in range(lo, hi):
            before.append(s)
            s = advance(s, i)
        for i in reversed(range(lo, hi)):
            rdo = rf[:, i, :, :, None] * dof[:, i, :, None, :]
            dv[:, i] = torch.einsum("bhi,bhij->bhj", kf[:, i], g + uf[None, :, :, None] * rdo)
            dk[:, i] = torch.einsum("bhij,bhj->bhi", g, vf[:, i]) + uf * rf[:, i] * vdo[:, i]
            dw[:, i] = (g * before[i - lo]).sum(-1)
            g = wf[:, i, :, :, None] * g + rdo
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du


def _sub_decays(w):
    """w (B, H, L, hd) of one sub-chunk -> (A, B, total): A[:, :, a] =
    prod_{q<a} w_q and B[:, :, a] = prod_{q>a} w_q within the sub-chunk,
    built from 1 token by token, and total = prod_q w_q."""
    n = w.shape[2]
    pre, suf = [], [None] * n
    p = torch.ones_like(w[:, :, 0])
    for a in range(n):
        pre.append(p)
        p = p * w[:, :, a]
    q = torch.ones_like(p)
    for a in reversed(range(n)):
        suf[a] = q
        q = q * w[:, :, a]
    return torch.stack(pre, 2), torch.stack(suf, 2), p


def _diag_block(r, k, w, u):
    """The forward's diagonal block of one sub-chunk (``wkv6_chunked_plain``):
    P[t, s] = sum_i r_t k_s prod_{s<q<t} w_q (s < t), sum_i r_t u k_t (s =
    t), 0 above; r, k, w (B, H, L, hd), u (1, H, 1, hd)."""
    b, h, n, _ = r.shape
    p = torch.zeros((b, h, n, n), dtype=r.dtype, device=r.device)
    f = k.clone()                         # f[s] = k_s prod_{s<q<t}, built token by token
    for i in range(n):
        p[:, :, i, i] = (r[:, :, i] * u[:, :, 0] * k[:, :, i]).sum(-1)
        if i > 1:
            f[:, :, :i - 1] = f[:, :, :i - 1] * w[:, :, i - 1:i]
        if i > 0:
            p[:, :, i, :i] = torch.einsum("bhk,bhsk->bhs", r[:, :, i], f[:, :, :i])
    return p


def wkv6_bwd_chunked_plain(r, k, v, w, u, do):
    """The chunk-parallel arithmetic of the WKV backward kernels
    (``csrc/wkv6.cu``) in plain PyTorch: the same gradients as
    ``wkv6_bwd_plain`` (zero initial state, the final state unused; (dr, dk,
    dv) in r's dtype, (dw, du) in f32, f64 for f64 inputs).  T is padded to
    whole chunks with r = k = v = dO = 0 and w = 1, which changes nothing.

    1. The state S at every chunk start and G = dL/dS at every chunk end,
       carried sub-chunk by sub-chunk (A, B the prefix and suffix products
       of w within a sub-chunk, built from 1; D their total):
           S <- diag(D) S + (k o B)^T V,     G <- diag(D) G + (r o A)^T dO.
    2. Each chunk alone, from its S and G: S carried forward to each
       sub-chunk's start S_b, then the sub-chunks walked backward carrying G
       (G_e after the sub-chunk's last token).  With Y = dO S_b^T, Z = V
       G_e^T, M = dO V^T and P the forward's diagonal block (bonus on its
       diagonal), for token a of the sub-chunk and key i:
           dr_a = A_a Y_a + E_a(a) + u k_a M[a, a]
           dk_a = B_a Z_a + E'_a(a) + u r_a M[a, a]
           dv   = (k o B) G_e + P^T dO
           dw_a = A_a B_a (G_e . S_b) + A_a R(a) + B_a Q(a) + T4(a)
       with the within-sub-chunk sums, every decay a product of w from 1
       (no division by w, which underflows to 0 under strong decays):
           E_s'(a)  = sum_{s<a} prod_{s<q<a} w_q k_s M[s', s]
           E'_s(a)  = sum_{s'>a} prod_{a<q<s'} w_q r_s' M[s', s]
           Q(a)     = sum_{s<a} prod_{s<q<a} w_q k_s Z_s
           R(a)     = sum_{s>a} prod_{a<q<s} w_q r_s Y_s
           T4(a)    = sum_{s'>a} (r_s' prod_{a<q<s'} w_q) E_s'(a)
       (G_e . S_b the row-wise dot over values), each a recurrence in a:
       E and Q walked up, E' and R down.  du = sum_{b, t} r_t k_t M[t, t].
    """
    ct = torch.float64 if r.dtype == torch.float64 else torch.float32
    b, t, h, hd = r.shape
    chunk, sub = WKV_BWD_CHUNK, WKV_BWD_SUB
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    per = chunk // sub

    def prep(x, fill):                     # (B, H, T + pad, hd)
        x = x.to(ct).transpose(1, 2)
        return torch.cat([x, x.new_full((b, h, pad, hd), fill)], 2) if pad else x

    rf, kf, vf, dof = (prep(x, 0.0) for x in (r, k, v, do))
    wf = prep(w, 1.0)
    uf = u.to(ct)[None, :, None, :]

    def tokens(n, *xs):
        return [x[:, :, n * sub:(n + 1) * sub] for x in xs]

    def carry_s(s, n):
        kc, vc, wc = tokens(n, kf, vf, wf)
        _, suf, tot = _sub_decays(wc)
        return tot[..., None] * s + (kc * suf).transpose(2, 3) @ vc

    def carry_g(g, n):
        rc, dc, wc = tokens(n, rf, dof, wf)
        pre, _, tot = _sub_decays(wc)
        return tot[..., None] * g + (rc * pre).transpose(2, 3) @ dc

    zeros = torch.zeros((b, h, hd, hd), dtype=ct, device=r.device)
    starts, s = [zeros], zeros             # 1. S at each chunk start
    for n in range((n_chunks - 1) * per):
        s = carry_s(s, n)
        if (n + 1) % per == 0:
            starts.append(s)
    ends, g = [zeros] * n_chunks, zeros    # G at each chunk end
    for n in reversed(range(per, n_chunks * per)):
        if (n + 1) % per == 0:
            ends[(n + 1) // per - 1] = g
        g = carry_g(g, n)
    if n_chunks > 1:
        ends[0] = g

    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros((b, h, hd), dtype=ct, device=r.device)
    for c in range(n_chunks):              # 2. each chunk alone
        s_b = [starts[c]]
        for m in range(per - 1):
            s_b.append(carry_s(s_b[-1], c * per + m))
        g = ends[c]
        for m in reversed(range(per)):
            n = c * per + m
            rc, kc, vc, wc, dc = tokens(n, rf, kf, vf, wf, dof)
            pre, suf, tot = _sub_decays(wc)
            y = dc @ s_b[m].transpose(2, 3)
            z = vc @ g.transpose(2, 3)
            mm = dc @ vc.transpose(2, 3)
            x = (g * s_b[m]).sum(-1)
            p = _diag_block(rc, kc, wc, uf)
            sl = slice(n * sub, (n + 1) * sub)
            dv[:, :, sl] = (kc * suf) @ g + p.transpose(2, 3) @ dc
            diag = torch.diagonal(mm, dim1=2, dim2=3)            # v_a . dO_a
            du += (rc * kc * diag[..., None]).sum(2)
            e = torch.zeros_like(rc)       # E_s'(a), s' > a, walked up
            q = torch.zeros_like(x)
            for a in range(sub):
                dr[:, :, n * sub + a] = pre[:, :, a] * y[:, :, a] + e[:, :, a] \
                    + uf[:, :, 0] * kc[:, :, a] * diag[:, :, a, None]
                t4, prod = torch.zeros_like(x), torch.ones_like(x)
                for s2 in range(a + 1, sub):
                    t4 = t4 + rc[:, :, s2] * prod * e[:, :, s2]
                    prod = prod * wc[:, :, s2]
                dw[:, :, n * sub + a] = suf[:, :, a] * q + t4
                q = wc[:, :, a] * q + kc[:, :, a] * z[:, :, a]
                e[:, :, a + 1:] = wc[:, :, a, None] * e[:, :, a + 1:] \
                    + kc[:, :, a, None] * mm[:, :, a + 1:, a, None]
            e = torch.zeros_like(rc)       # E'_s(a), s <= a, walked down
            rr = torch.zeros_like(x)
            for a in reversed(range(sub)):
                dk[:, :, n * sub + a] = suf[:, :, a] * z[:, :, a] + e[:, :, a] \
                    + uf[:, :, 0] * rc[:, :, a] * diag[:, :, a, None]
                dw[:, :, n * sub + a] += pre[:, :, a] * suf[:, :, a] * x + pre[:, :, a] * rr
                rr = wc[:, :, a] * rr + rc[:, :, a] * y[:, :, a]
                e[:, :, :a] = wc[:, :, a, None] * e[:, :, :a] \
                    + rc[:, :, a, None] * mm[:, :, a, :a, None]
            g = carry_g(g, n)

    def out(x, dtype):
        return x[:, :, :t].transpose(1, 2).to(dtype)

    wt = torch.float64 if ct == torch.float64 else torch.float32
    return (out(dr, r.dtype), out(dk, r.dtype), out(dv, r.dtype), out(dw, wt),
            du.sum(0).to(wt))
