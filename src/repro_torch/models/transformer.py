"""Decoder stack (port of the dense, MoE and RWKV paths of
``repro/models/transformer.py``).

Parameters are a nested dict with the JAX package's paths and layouts,
stacked over layers (leading L dim on every leaf of ``params["layers"]``);
the JAX layer scan becomes a Python loop over per-layer views.  Entry points:

    forward(mode="train")    (B,S) tokens -> (B,S,V) logits
    forward(mode="prefill")  also fills a linear KV cache of given capacity
    decode_step              t tokens against the cache (scalar ``pos``)

An RWKV config stacks ``models/rwkv.py`` blocks instead: its cache holds
the recurrent state (``wkv_S``, ``tm_x``, ``cm_x``), not K/V, and ignores
the capacity.  Attention goes through ``kernels.flash_attention``, the MoE
layer's expert products through ``kernels.moe_gmm`` and the RWKV recurrence
through ``kernels.wkv6`` (the CUDA kernels on the card, their plain twins on
the CPU).  Under a context-parallel ``ParallelCtx`` a rank's train forward
runs its T/m columns through ``cp_block_apply``, attention on the KV ring of
``parallel.context``.  Configs and modes the port does not run yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.parallel.context import ring_attention
from repro_torch.tree import tree_leaves

SERVING_EXT = "ROADMAP.md Queue 1 item 3 (window, ring and slot caches)"
FAMILIES = "ROADMAP.md Queue 1 item 11 (remaining model families)"
TENSOR_MP = "ROADMAP.md Queue 1 item 7 (tensor MP)"
CONTEXT_SERVE = ("ROADMAP.md Queue 1 item 8b (context-parallel prefill: "
                 "ring_attention_stats, prefill_chunk_cp)")


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The rank mesh of a context-parallel run (JAX's ``ParallelCtx`` with
    ``model_axis=None``): the ``context_axis`` group of ``mesh`` (a
    ``parallel.dist.RankMesh``) is the KV ring, every parameter is
    replicated across it, and each rank's ``forward`` gets its own T/m
    columns of the tokens.  The port has no tensor-MP ctx (item 7)."""
    mesh: Any
    context_axis: str = "model"

    @property
    def ring_size(self) -> int:
        return self.mesh.size(self.context_axis)


def unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet: {item}")


def check_supported(cfg, *, window: int = 0, pctx=None) -> None:
    """Raise NotImplementedError for any config or mode outside the dense,
    MoE or RWKV, full-attention decoder the port runs (on one device, or a
    dense decoder on a context ring), and ValueError for the CNN and LSTM
    families, which other modules run, and for a context ring over an arch
    that ``cp_arch_supported`` rejects."""
    if cfg.family == "cnn":
        raise ValueError(f"{cfg.name} is a CNN: models.inception runs it, not the "
                         f"transformer stack")
    if cfg.family == "rnn":
        raise ValueError(f"{cfg.name} is an LSTM model: models.lstm runs it, not the "
                         f"transformer stack")
    if pctx is not None:
        if not isinstance(pctx, ParallelCtx):
            raise unported("a ParallelCtx other than a context ring (tensor MP)", TENSOR_MP)
        if not cp_arch_supported(cfg):
            raise ValueError(f"{cfg.name}: context parallelism needs a homogeneous dense "
                             f"decoder without logit softcap (cp_arch_supported); the "
                             f"port has no GSPMD to fall back to")
    if window or cfg.sliding_window:
        raise unported(f"sliding-window attention ({cfg.name})", SERVING_EXT)
    for flag, what, item in (
            (cfg.family == "hybrid", "the hybrid SSM block", FAMILIES),
            (cfg.encoder_layers, "the encoder-decoder path", FAMILIES),
            (cfg.n_prefix_embeds, "prefix embeddings (VLM)", FAMILIES),
            (cfg.attn_logit_softcap, "attention logit softcap", FAMILIES)):
        if flag:
            raise unported(f"{what} ({cfg.name})", item)


def overlapped_arch_supported(cfg) -> bool:
    """Arch classes whose decoder block the overlap-scheduled collective
    matmuls can execute: homogeneous dense blocks only (no MoE / SSM / RWKV
    / enc-dec / VLM prefix / CNN / RNN).  The planner's credit gate
    (``core.planner.comm_runtime_supported``) reads it, and so will the
    tensor-MP runtime (ROADMAP.md Queue 1 item 7), so the two cannot drift."""
    return not (cfg.is_moe or cfg.rwkv
                or cfg.family in ("hybrid", "ssm", "cnn", "rnn")
                or cfg.encoder_layers or cfg.n_prefix_embeds)


def cp_arch_supported(cfg) -> bool:
    """The config half of the JAX ``cp_supported``: context-parallel ring
    attention needs an ``overlapped_arch_supported`` decoder with no logit
    softcap (the ring's online-softmax merge has no capped variant).  The
    planner's ``context_mp_supported`` and ``cp_supported`` read it."""
    return (overlapped_arch_supported(cfg) and not cfg.attn_logit_softcap
            and cfg.n_heads > 0)


def cp_supported(cfg, pctx, t: int) -> bool:
    """Can this (arch, ring, global sequence length ``t``) run
    context-parallel ring attention?  A ring of more than one rank, a
    ``cp_arch_supported`` arch and ``t`` divisible by the ring size, so the
    residual stream stays sequence-sharded between blocks (JAX's
    ``cp_supported``)."""
    if not isinstance(pctx, ParallelCtx) or pctx.ring_size <= 1:
        return False
    return cp_arch_supported(cfg) and t % pctx.ring_size == 0


# ---------------------------------------------------------------------------
# init and cache
# ---------------------------------------------------------------------------

def model_init(gen: torch.Generator, cfg, *, device=None, keep=None):
    """Random parameters at the JAX init's scales, drawn from ``gen``
    (a generator on ``device``).

    ``keep(path, tree)`` (default: keep all) sees each piece as soon as it is
    drawn (``("embed",)``, ``("final_norm",)``, ``("lm_head",)``, then the
    stacked layer pieces ``("layers", "ln1")``, ``("layers", "attn", "wq")``,
    ..., ``("layers", "mlp")``) and returns what to hold of it (None:
    nothing).  Every piece is drawn either way, so the pieces kept are
    bit-equal to those of the whole init."""
    check_supported(cfg)
    keep = keep or (lambda path, tree: tree)
    dtype = getattr(torch, cfg.param_dtype)
    d, v, n = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    kw = dict(dtype=dtype, device=device)
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)  # noqa: E731
    params = {"embed": keep(("embed",), L.embed_init(gen, v, d, **kw)),
              "final_norm": keep(("final_norm",), ones(d))}
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(("lm_head",), L.dense_init(gen, d, v, **kw))
    if cfg.rwkv:
        params["layers"] = keep(("layers",), rwkv_mod.rwkv_layer_init(gen, cfg, lead=(n,),
                                                                      **kw))
        return params
    layers = {"ln1": keep(("layers", "ln1"), ones(n, d)),
              "ln2": keep(("layers", "ln2"), ones(n, d)), "attn": {}}
    for name, (d_in, d_out) in (("wq", (d, nh * hd)), ("wk", (d, nkv * hd)),
                                ("wv", (d, nkv * hd)), ("wo", (nh * hd, d))):
        layers["attn"][name] = keep(("layers", "attn", name),
                                    L.dense_init(gen, d_in, d_out, lead=(n,), **kw))
    if cfg.is_moe:
        layers["moe"] = keep(("layers", "moe"), moe_mod.moe_init(gen, cfg, lead=(n,), **kw))
    else:
        layers["mlp"] = keep(("layers", "mlp"),
                             L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_kind, lead=(n,), **kw))
    params["layers"] = layers
    return params


def make_cache(cfg, batch: int, capacity: int, *, dtype=None, device=None):
    """Linear decode cache stacked over layers: k, v (L, B, cap, KV, hd) and
    the scalar write position ``pos`` (a Python int).  An RWKV cache holds
    the recurrent state instead, for any capacity: wkv_S (L, B, H, hd, hd)
    f32 and the last normed inputs of the time and channel mixes, tm_x and
    cm_x (L, B, d), all zeros."""
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    if cfg.rwkv:
        h, hd = rwkv_mod.heads(cfg)
        x_shape = (cfg.n_layers, batch, cfg.d_model)
        return {"pos": 0,
                "wkv_S": torch.zeros((cfg.n_layers, batch, h, hd, hd),
                                     dtype=torch.float32, device=device),
                "tm_x": torch.zeros(x_shape, dtype=dtype, device=device),
                "cm_x": torch.zeros(x_shape, dtype=dtype, device=device)}
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _unstack(stacked, n: int):
    """The n layers' parameter dicts of the stacked (n, ...) leaves, as
    views: one ``unbind`` a leaf, whose backward stacks the n layers'
    gradients once.  (Indexing ``leaf[i]`` layer by layer would give each
    layer's gradient as a zero-padded copy of the whole stack, and autograd
    would add n of them: O(n^2) traffic, 16 copies of the 3.9 GB f32 stack
    in a Llama-3.2-1B step.)"""
    per_leaf = {k: (_unstack(v, n) if isinstance(v, dict) else torch.unbind(v, 0))
                for k, v in stacked.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _cache_layer(cache, i: int):
    """Layer i's views of every stacked tensor of the cache (not ``pos``)."""
    return {k: v[i] for k, v in cache.items() if k != "pos"}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _self_attention(p, x, cfg, *, pos0: int, cache_kv=None, pctx=None, layer: int = 0):
    """Self-attention over x, or (decode) over the cache plus x, or (a
    context-parallel ``pctx``) over the ring's whole sequence, x being this
    rank's rows from position ``pos0``.

    Decode writes the new roped K/V into the cache at ``pos0`` first and
    then attends over the view ``cache[:, :pos0 + t]`` with causal=False:
    the same keys as the JAX path's concat(cache, new) under a kv_mask
    (the sum runs in another order, so the two agree to round-off, not
    bitwise).  Returns (out, (k_roped, v))."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).view(b, t, nh, hd)
    k = (x @ p["wk"].to(x.dtype)).view(b, t, nkv, hd)
    v = (x @ p["wv"].to(x.dtype)).view(b, t, nkv, hd)
    positions = (pos0 + torch.arange(t, device=x.device)).expand(b, t)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if pctx is not None:
        out = ring_attention(q, k, v, mesh=pctx.mesh, axis=pctx.context_axis, causal=True,
                             layer=layer)
    elif cache_kv is None:
        out = flash_attention(q, k, v, causal=True)
    else:
        L.cache_insert_full(cache_kv, k, v, pos0)
        n = pos0 + t
        out = flash_attention(q, cache_kv["k"][:, :n], cache_kv["v"][:, :n],
                              causal=False)
    return out.reshape(b, t, nh * hd) @ p["wo"].to(x.dtype), (k, v)


def block_apply(cfg, p, x, *, mode: str, pos0: int = 0, cache=None,
                capacity_factor=1.25):
    """One decoder block.  ``cache`` is this layer's {"k", "v"} view
    (B, cap, KV, hd): decode reads and updates it in place, prefill fills
    its first S positions (the rest stays zero, the JAX pad to capacity).
    An MoE block drops tokens beyond ``capacity_factor`` in train and
    prefill and none in decode.  Returns (x, cache or None, aux): aux is
    ``cfg.router_aux_loss`` times the router's load-balance loss, None for a
    dense block.  An RWKV block's ``cache`` is this layer's {"wkv_S",
    "tm_x", "cm_x"} view: train starts from zero state and has none, prefill
    starts from the zero cache and writes its final state there, decode
    reads and updates it in place."""
    if cfg.rwkv:
        return _rwkv_block(cfg, p, x, cache), cache, None
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        attn_out, _ = _self_attention(p["attn"], h, cfg, pos0=pos0, cache_kv=cache)
    else:
        attn_out, (k_new, v_new) = _self_attention(p["attn"], h, cfg, pos0=0)
        if mode == "prefill":
            s = k_new.shape[1]
            cache["k"][:, :s] = k_new
            cache["v"][:, :s] = v_new
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if not cfg.is_moe:
        return x + L.mlp_apply(p["mlp"], h2, cfg.mlp_kind), cache, None
    # decode batches are tiny: the no-drop capacity makes cached decoding
    # agree with the teacher-forced forward
    cf = None if mode == "decode" else capacity_factor
    mlp_out, moe_aux = moe_mod.moe_ffn(p["moe"], h2, cfg, capacity_factor=cf)
    return x + mlp_out, cache, cfg.router_aux_loss * moe_aux


def cp_block_apply(cfg, p, x, *, pctx, layer: int):
    """``block_apply``'s dense train path on this rank's T/m rows of the
    residual stream: RoPE at positions j T/m + arange(T/m) for ring place j,
    attention on the KV ring (``parallel.context.ring_attention``); every
    weight is replicated, so the projections and the MLP are local."""
    j = pctx.mesh.ring(pctx.context_axis)[0]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, _ = _self_attention(p["attn"], h, cfg, pos0=j * x.shape[1], pctx=pctx,
                                  layer=layer)
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h2, cfg.mlp_kind)


def _rwkv_block(cfg, p, x, cache):
    if cache is None:
        zero = x.new_zeros((x.shape[0], x.shape[-1]))
        tm_last, cm_last, state = zero, zero, None
    else:
        tm_last, cm_last, state = cache["tm_x"], cache["cm_x"], cache["wkv_S"]
    tm_out, tm_x, _ = rwkv_mod.rwkv_time_mix(
        p["tm"], L.rms_norm(x, p["ln1"], cfg.norm_eps), tm_last, state, cfg)
    x = x + tm_out
    cm_out, cm_x = rwkv_mod.rwkv_channel_mix(
        p["cm"], L.rms_norm(x, p["ln2"], cfg.norm_eps), cm_last)
    if cache is not None:      # the state went into wkv_S in place
        cache["tm_x"].copy_(tm_x)
        cache["cm_x"].copy_(cm_x)
    return x + cm_out


# ---------------------------------------------------------------------------
# top-level entry points
# ---------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    x = params["embed"][tokens].to(getattr(torch, cfg.dtype))
    return x * (cfg.d_model ** 0.5 if cfg.tie_embeddings else 1.0)


def _head(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] += L.NEG_INF
    return logits


def forward(cfg, params, batch, *, mode: str = "train", window_override=None,
            pctx=None, cache_capacity: int = 0, capacity_factor=1.25):
    """batch: dict(tokens (B,S)).  mode "train": returns (logits, aux);
    mode "prefill": returns (logits, cache, aux) with a cache of
    ``cache_capacity`` positions (default S).  aux is the blocks' summed
    router aux loss (0 for a dense model).  Under a context-parallel
    ``pctx`` (train only) the tokens are this rank's (B, S/m) columns and
    every block is ``cp_block_apply``."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}")
    check_supported(cfg, window=window_override or 0, pctx=pctx)
    if pctx is not None and mode == "prefill":
        raise unported("context-parallel prefill", CONTEXT_SERVE)
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    b, s = tokens.shape
    cache = None
    if mode == "prefill":
        cap = cache_capacity or s
        if cap < s and not cfg.rwkv:
            raise ValueError(f"cache capacity {cap} < prompt length {s}")
        cache = make_cache(cfg, b, cap, dtype=x.dtype, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    for i in range(cfg.n_layers):
        if pctx is not None:
            x = cp_block_apply(cfg, layers[i], x, pctx=pctx, layer=i)
            continue
        csl = None if cache is None else _cache_layer(cache, i)
        x, _, a = block_apply(cfg, layers[i], x, mode=mode, cache=csl,
                              capacity_factor=capacity_factor)
        if a is not None:
            aux = aux + a
    logits = _head(cfg, params, x)
    if mode == "prefill":
        cache["pos"] = s
        return logits, cache, aux
    return logits, aux


def pipeline_stage_fn(cfg):
    """One pipeline chunk of the decoder stack as a shape-preserving
    ``(chunk_params, x) -> y``: chunk_params holds the chunk's layers stacked
    (Lc, ...), as ``params["layers"]`` stacks all L."""
    check_supported(cfg)

    def stage_fn(sp, x):
        lc = tree_leaves(sp)[0].shape[0]
        for lp in _unstack(sp, lc):
            x, _, _ = block_apply(cfg, lp, x, mode="train")
        return x

    return stage_fn


def decode_step(cfg, params, cache, batch, *, window_override=None, pctx=None):
    """batch: dict(tokens (B,t)) against a cache with scalar ``pos``.
    Returns (logits (B,t,V), cache): the K/V (or RWKV state) tensors are
    updated in place and the returned dict carries pos + t."""
    if pctx is not None:
        raise unported("decoding over a ParallelCtx (a sequence-sharded cache)", TENSOR_MP)
    check_supported(cfg, window=window_override or 0)
    pos = cache["pos"]
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        raise unported("slot mode (per-row cache positions)", SERVING_EXT)
    pos = int(pos)
    x = _embed(cfg, params, batch["tokens"])
    layers = _unstack(params["layers"], cfg.n_layers)
    for i in range(cfg.n_layers):
        csl = _cache_layer(cache, i)
        x, _, _ = block_apply(cfg, layers[i], x, mode="decode",
                              pos0=pos, cache=csl)
    logits = _head(cfg, params, x)
    return logits, {**cache, "pos": pos + batch["tokens"].shape[1]}
