"""Carry parameters between the JAX package and the port as numpy arrays.

The port keeps the JAX parameter paths and layouts unchanged, so the bridge
is a leaf-by-leaf copy: nothing is transposed.  The decoder stacks its
layers with a leading L dim; an MoE layer has ``moe/{router, wi, wg, wo}``
(and ``moe/shared/{wi, wg, wo}`` with shared experts) in place of ``mlp``;
an RWKV layer has ``ln1``, ``ln2``, ``tm/{mu_r, mu_k, mu_v, mu_w, mu_g, wr,
wk, wv, wg, wo, w0, wa1, wa2, u, ln_x}`` and ``cm/{mu_k, mu_r, wk, wv, wr}``.
BigLSTM keeps ``params["lstm"]`` as a list of per-layer dicts (wx (d, 4H),
wh (d_proj or H, 4H), b (4H,), and wp (H, d_proj) when d_proj > 0); GNMT
has ``src_embed``, ``tgt_embed``, the lists ``enc`` and ``dec`` of such
dicts without wp (the first decoder layer's wx is (2d, 4d)), ``attn_q`` and
``head``.  Inception-V3 has ``stem[i]``, ``blocks[b][branch][op]`` (a
pool-only branch is an empty list), each conv a dict ``{w (kh, kw, cin,
cout), scale, bias}``, and ``head.fc``.  Neither side's module is
imported; the caller converts the JAX pytree to numpy first
(``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import inception as inc_mod
from repro_torch.models.rwkv import heads, lora_rank


def param_shapes(cfg) -> dict:
    """The shape of every parameter of ``cfg``'s model, in its tree: tuples
    at the leaves, lists where the tree has lists."""
    if cfg.family == "cnn":
        return _inception_shapes(cfg)
    if cfg.name == "gnmt":
        return _gnmt_shapes(cfg)
    if cfg.family == "rnn":
        return _lstm_shapes(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    layers = _rwkv_shapes(cfg) if cfg.rwkv else _decoder_shapes(cfg)
    shapes = {"embed": (v, d), "final_norm": (d,), "layers": layers}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def _decoder_shapes(cfg) -> dict:
    d, n = cfg.d_model, cfg.n_layers
    hd, nh, nkv, ff = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    layers = {"ln1": (n, d), "ln2": (n, d),
              "attn": {"wq": (n, d, nh * hd), "wk": (n, d, nkv * hd),
                       "wv": (n, d, nkv * hd), "wo": (n, nh * hd, d)}}
    if cfg.is_moe:
        e, eff = cfg.n_experts, cfg.expert_d_ff
        layers["moe"] = {"router": (n, d, e), "wi": (n, e, d, eff), "wg": (n, e, d, eff),
                         "wo": (n, e, eff, d)}
        if cfg.n_shared_experts:
            sff = eff * cfg.n_shared_experts
            layers["moe"]["shared"] = {"wi": (n, d, sff), "wg": (n, d, sff),
                                       "wo": (n, sff, d)}
    else:
        layers["mlp"] = {"wi": (n, d, ff), "wo": (n, ff, d)}
        if cfg.mlp_kind == "swiglu":
            layers["mlp"]["wg"] = (n, d, ff)
    return layers


def _rwkv_shapes(cfg) -> dict:
    d, n, ff = cfg.d_model, cfg.n_layers, cfg.d_ff
    n_heads, hd = heads(cfg)
    lora = lora_rank(cfg)
    vec = (n, d)
    tm = {f"mu_{c}": vec for c in "rkvwg"}
    tm.update({w: (n, d, d) for w in ("wr", "wk", "wv", "wg", "wo")})
    tm.update(w0=vec, wa1=(n, d, lora), wa2=(n, lora, d), u=(n, n_heads, hd), ln_x=vec)
    cm = {"mu_k": vec, "mu_r": vec, "wk": (n, d, ff), "wv": (n, ff, d), "wr": (n, d, d)}
    return {"ln1": vec, "ln2": vec, "tm": tm, "cm": cm}


def _gnmt_shapes(cfg) -> dict:
    d, v, n = cfg.d_model, cfg.vocab_padded, cfg.n_layers

    def cell(d_in):
        return {"wx": (d_in, 4 * d), "wh": (d, 4 * d), "b": (4 * d,)}

    return {"src_embed": (v, d), "tgt_embed": (v, d), "enc": [cell(d) for _ in range(n)],
            "dec": [cell(2 * d if i == 0 else d) for i in range(n)], "attn_q": (d, d),
            "head": (d, v)}


def _inception_shapes(cfg) -> dict:
    def conv(shape):
        return {"w": shape, "scale": shape[-1:], "bias": shape[-1:]}

    stem, blocks, cin = inc_mod.conv_shapes(inc_mod.is_reduced(cfg))
    return {"stem": [conv(s) for s in stem],
            "blocks": [[[conv(s) for s in ops] for ops in branches] for branches in blocks],
            "head": {"fc": (cin, cfg.vocab_size)}}


def _lstm_shapes(cfg) -> dict:
    d, v, dh = cfg.d_model, cfg.vocab_padded, cfg.d_ff
    layer = {"wx": (d, 4 * dh), "wh": (d, 4 * dh), "b": (4 * dh,), "wp": (dh, d)}
    return {"embed": (v, d), "lstm": [dict(layer) for _ in range(cfg.n_layers)],
            "head": (d, v)}


def _convert(tree, shapes, fn, path=""):
    if isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            raise ValueError(f"{path}: expected a list of {len(shapes)} entries")
        return [_convert(t, s, fn, f"{path}/{i}") for i, (t, s) in
                enumerate(zip(tree, shapes))]
    if set(tree) != set(shapes):
        raise ValueError(f"parameter keys at '{path or '/'}' are {sorted(tree)}, "
                         f"expected {sorted(shapes)}")
    out = {}
    for k, want in shapes.items():
        p = f"{path}/{k}"
        if isinstance(want, (dict, list)):
            out[k] = _convert(tree[k], want, fn, p)
        elif tuple(tree[k].shape) != want:
            raise ValueError(f"{p}: shape {tuple(tree[k].shape)} != {want}")
        else:
            out[k] = fn(tree[k])
    return out


def params_from_jax(np_params, cfg, device) -> dict:
    """The port's parameters from the JAX init's pytree given as numpy arrays
    (dense, MoE or RWKV decoder, BigLSTM, GNMT or Inception-V3, by ``cfg``)."""
    return _convert(np_params, param_shapes(cfg),
                    lambda a: torch.from_numpy(np.array(a)).to(device))


def params_to_numpy(params, cfg) -> dict:
    """The port's parameters as a numpy pytree in the JAX layout."""
    return _convert(params, param_shapes(cfg),
                    lambda t: t.detach().cpu().numpy())
