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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import layers as L


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

