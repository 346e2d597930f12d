"""RWKV-6 ("Finch") blocks (port of ``repro/models/rwkv.py``): attention-free,
with a data-dependent decay [arXiv:2404.05892].

Time-mix recurrence per head (key dim = value dim = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the decay w_t = exp(-exp(w0 + LoRA(x_t))) in (0, 1), receptance r, key
k and value v from token-shifted projections, and the bonus u for the
current token.  The recurrence runs in ``kernels.wkv6`` (the CUDA kernel on
the card, the plain sequential scan on the CPU) for train, prefill and
decode alike; the JAX package's chunked form (``wkv_chunked``) is the same
function.  Decode carries (S, last_x): the kernel writes S in place into
the state it is given.

Parameters keep the JAX paths and layouts, stacked over layers by ``lead``.
Two JAX quirks are kept on purpose: ``ln_x`` is an RMS norm over all of d
(not RWKV's per-head group norm), and every call casts the f32 weights to
the activation dtype.

Under tensor MP (``tp_time_mix``, ``tp_channel_mix``) a rank holds its part
of a layer as the rules cut it (``parallel.sharding``): ``tm.wr``, ``wk``,
``wv``, ``wg`` its whole heads' columns, ``tm.wo`` their rows, ``cm.wk`` and
``cm.wr`` its columns, ``cm.wv`` its rows, everything else replicated.  JAX
has no explicit path: GSPMD partitions the plain mixes by those rules.  The
port writes the Megatron form of the same math: the input enters through
``copy_to_model``, w is computed for all of d and the rank takes its heads,
``wkv6`` runs on them, ``ln_x``'s sum of squares over all of d is summed over
the model group (forward and backward) before the norm, ``wo``'s partial
product is all-reduced; in the channel mix ``k @ wv`` is reduce-scattered to
the rank's columns, multiplied by its r and all-gathered.  A replicated leaf
used only for the rank's columns enters through ``copy_to_model``, so its
gradient is whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import layers as L
from repro_torch.parallel import collectives as CL


def heads(cfg):
    """(head count, head_dim) of an RWKV config (head_dim 64 when unset)."""
    hd = cfg.head_dim or 64
    return cfg.d_model // hd, hd


def lora_rank(cfg) -> int:
    return max(32, cfg.d_model // 64)


def rwkv_layer_init(gen: torch.Generator, cfg, *, lead=(), dtype=torch.float32,
                    device=None):
    """One RWKV layer's parameters at the JAX init's scales (the draws
    differ), every leaf with the leading dims ``lead``.  The projections take
    ``dtype``; the decay LoRA, u and the norms and mixes stay f32."""
    d, ff = cfg.d_model, cfg.d_ff
    n_heads, hd = heads(cfg)
    lora = lora_rank(cfg)
    kw = dict(lead=lead, dtype=dtype, device=device)

    def full(value, *shape):
        return torch.full((*lead, *shape), value, dtype=torch.float32, device=device)

    def normal(scale, *shape):
        return torch.randn((*lead, *shape), generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)

    w0 = torch.linspace(-6.0, -1.0, d, dtype=torch.float32, device=device)
    return {
        "ln1": full(1.0, d), "ln2": full(1.0, d),
        "tm": {
            **{f"mu_{n}": full(0.5, d) for n in "rkvwg"},
            **{n: L.dense_init(gen, d, d, **kw) for n in ("wr", "wk", "wv", "wg", "wo")},
            "w0": w0.expand(*lead, d).clone(),
            "wa1": L.dense_init(gen, d, lora, lead=lead, device=device),
            "wa2": normal(0.01, lora, d),
            "u": normal(0.1, n_heads, hd),
            "ln_x": full(1.0, d),
        },
        "cm": {
            "mu_k": full(0.5, d), "mu_r": full(0.5, d),
            "wk": L.dense_init(gen, d, ff, **kw),
            "wv": L.dense_init(gen, ff, d, **kw),
            "wr": L.dense_init(gen, d, d, **kw),
        },
    }


def _token_shift(x, last_x):
    """x: (B, T, d); last_x: (B, d) from the previous step or segment.
    Returns (the previous token of each position, the last token)."""
    prev = torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)
    return prev, x[:, -1, :]


def rwkv_time_mix(p, x, last_x, state, cfg):
    """x: (B, T, d); last_x: (B, d); ``state``: the (B, H, hd, hd) f32 WKV
    state, overwritten in place with the final one, or None to start from
    zeros.  Returns (out, new_last_x, final state)."""
    b, t, d = x.shape
    h, hd = heads(cfg)
    prev, new_last = _token_shift(x, last_x)

    def mix(mu):
        return x + (prev - x) * mu.to(x.dtype)

    r = (mix(p["mu_r"]) @ p["wr"].to(x.dtype)).view(b, t, h, hd)
    k = (mix(p["mu_k"]) @ p["wk"].to(x.dtype)).view(b, t, h, hd)
    v = (mix(p["mu_v"]) @ p["wv"].to(x.dtype)).view(b, t, h, hd)
    g = F.silu(mix(p["mu_g"]) @ p["wg"].to(x.dtype))
    xw = mix(p["mu_w"]).float()
    dec = p["w0"] + torch.tanh(xw @ p["wa1"]) @ p["wa2"]
    w = torch.exp(-torch.exp(dec)).view(b, t, h, hd)          # (0, 1), f32
    o, s_new = wkv6(r, k, v, w, p["u"], state)
    o = L.rms_norm(o.view(b, t, d).to(x.dtype), p["ln_x"], 1e-5) * g
    return o @ p["wo"].to(x.dtype), new_last, s_new


def rwkv_channel_mix(p, x, last_x):
    """x: (B, T, d); last_x: (B, d).  Returns (out, new_last_x)."""
    prev, new_last = _token_shift(x, last_x)
    xk = x + (prev - x) * p["mu_k"].to(x.dtype)
    xr = x + (prev - x) * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    r = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    return r * (k @ p["wv"].to(x.dtype)), new_last



# ---------------------------------------------------------------------------
# tensor MP
# ---------------------------------------------------------------------------

def tp_time_mix(p, x, cfg, pctx):
    """The train time mix of a tensor-MP rank from zero state: ``x`` (B, T,
    d), the normed block input, whole on every rank of the model group;
    ``p`` the rank's part of the layer.  Returns the whole output, the same
    on every rank.  Where the rules replicate the projections (heads that
    do not divide) every rank computes the whole mix."""
    b, t, d = x.shape
    n_heads, hd = heads(cfg)
    if p["wr"].shape[-1] == d:
        return rwkv_time_mix(p, x, x.new_zeros((b, d)), None, cfg)[0]
    mesh, axis = pctx.mesh, pctx.model_axis
    j, m = mesh.ring(axis)[:2]
    hm, dm = n_heads // m, d // m
    lo = j * dm

    def whole(name):          # a replicated leaf this rank uses in part
        return CL.copy_to_model(p[name], mesh, axis)

    x = CL.copy_to_model(x, mesh, axis)
    prev, _ = _token_shift(x, x.new_zeros((b, d)))

    def mix(mu):
        return x + (prev - x) * whole(mu).to(x.dtype)

    r = (mix("mu_r") @ p["wr"].to(x.dtype)).view(b, t, hm, hd)
    k = (mix("mu_k") @ p["wk"].to(x.dtype)).view(b, t, hm, hd)
    v = (mix("mu_v") @ p["wv"].to(x.dtype)).view(b, t, hm, hd)
    g = F.silu(mix("mu_g") @ p["wg"].to(x.dtype))
    xw = mix("mu_w").float()
    dec = whole("w0") + torch.tanh(xw @ whole("wa1")) @ whole("wa2")
    w = torch.exp(-torch.exp(dec[..., lo:lo + dm])).contiguous().view(b, t, hm, hd)
    u = whole("u")[j * hm:(j + 1) * hm].contiguous()
    o, _ = wkv6(r, k, v, w, u, None)
    o = o.view(b, t, dm).to(x.dtype)
    # ln_x: the RMS over all of d, its sum of squares summed over the ranks
    o32 = o.float()
    ss = (o32 * o32).sum(-1, keepdim=True)
    ss = CL.copy_to_model(CL.reduce_from_model(ss, mesh, axis), mesh, axis)
    normed = (o32 * torch.rsqrt(ss / d + 1e-5) * whole("ln_x")[lo:lo + dm].float()).to(x.dtype)
    return CL.reduce_from_model((normed * g) @ p["wo"].to(x.dtype), mesh, axis)


def tp_channel_mix(p, x, pctx):
    """The train channel mix of a tensor-MP rank from zero state: ``x`` (B,
    T, d) whole; returns the whole output.  ``k @ wv`` (partial over the
    rank's d_ff rows) is reduce-scattered to this rank's d/m columns,
    multiplied by its columns of r, and the product all-gathered.  Where
    the rules replicate the projections every rank computes the whole mix."""
    b, _, d = x.shape
    if p["wr"].shape[-1] == d:
        return rwkv_channel_mix(p, x, x.new_zeros((b, d)))[0]
    mesh, axis = pctx.mesh, pctx.model_axis
    x = CL.copy_to_model(x, mesh, axis)
    prev, _ = _token_shift(x, x.new_zeros((b, d)))
    xk = x + (prev - x) * CL.copy_to_model(p["mu_k"], mesh, axis).to(x.dtype)
    xr = x + (prev - x) * CL.copy_to_model(p["mu_r"], mesh, axis).to(x.dtype)
    k = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    r = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    kv = CL.reduce_scatter_sequence(k @ p["wv"].to(x.dtype), mesh, -1, axis)
    return CL.gather_from_model(r * kv, mesh, -1, axis)
