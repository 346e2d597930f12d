"""Decoder stack (port of the dense, MoE and RWKV paths of
``repro/models/transformer.py``).

Parameters are a nested dict with the JAX package's paths and layouts,
stacked over layers (leading L dim on every leaf of ``params["layers"]``);
the JAX layer scan becomes a Python loop over per-layer views.  Entry points:

    forward(mode="train")    (B,S) tokens -> (B,S,V) logits
    forward(mode="prefill")  also fills a linear KV cache of given capacity
                             (with a window, a shift-left ring of that length)
    decode_step              t tokens against the cache: a scalar ``pos`` is
                             the static batch's step (the ring's with a
                             window); a (B,) int32 ``pos`` on the device is
                             slot mode (continuous batching), each row at its
                             own position in a linear cache, t > 1 the
                             chunked-prefill extend step

An RWKV config stacks ``models/rwkv.py`` blocks instead: its cache holds
the recurrent state (``wkv_S``, ``tm_x``, ``cm_x``), not K/V, and ignores
the capacity.  Attention goes through ``kernels.flash_attention``, the MoE
layer's expert products through ``kernels.moe_gmm`` and the RWKV recurrence
through ``kernels.wkv6`` (the CUDA kernels on the card, their plain twins on
the CPU).  Under a context-parallel ``ParallelCtx`` a rank's train forward
runs its T/m columns through ``cp_block_apply``, attention on the KV ring of
``parallel.context``.

Under a tensor-MP ``ParallelCtx`` (``model_axis`` set) a rank's train
forward holds its part of the parameters (``parallel.sharding``) and runs
the Megatron decomposition with the collectives written out
(``parallel.collectives``; the port has no GSPMD):

- ``comm_runtime="gspmd"``: ``tp_block_apply``, replicated activations, one
  all-reduce after each row-parallel product: monolithic collectives around
  the Megatron products, as the JAX docstring describes GSPMD's;
- ``"overlapped"``: ``overlapped_block_apply``, the residual stream
  sequence-sharded between the blocks and every product on the chunked
  collective-matmul rings, where ``overlapped_supported`` holds; elsewhere
  it warns as JAX does and takes the gspmd block.

Attention runs the hand-written flash kernels over the rank's query heads
(and its KV heads, or a q-aligned slice of the replicated ones).  An MoE
block runs expert parallelism in the MLP's place (``moe.moe_ffn`` over the
model axis, JAX's shard_map branch: the rank's E/m experts on ``gmm``, the
partial outputs summed over the axis), in the gspmd block under both
runtimes, as JAX's overlapped block excludes MoE.  The
embedding is vocab-parallel and the head vocab-sharded where the rules
shard them; a leaf the rules replicate is computed whole on every rank, and
one whose rank-local use makes its gradient a partial sum enters through
``copy_to_model``, so every replicated leaf's gradient is whole on every
rank.  Configs and modes the port does not run yet raise
``NotImplementedError`` naming their ROADMAP.md item.

The continuous engine's sharded steps (JAX's ``decode_slots_tp``,
``prefill_chunk_tp`` and ``prefill_chunk_cp``) run on one rank's part of
the slot cache (``parallel.sharding.slot_cache_part``), each rank calling
them with the same arguments:

- ``decode_slots_tp``: one tick of its data group's slots under tensor MP,
  the slot dim in the ring-row role: the residual stream slot-sharded over
  the model axis between blocks, every Megatron product on the collective-
  matmul rings, attention per slot on the flash kernel with ``kv_lens``
  over the rank's head slice of the cache, one ``ring_all_gather`` before
  the replicated head;
- ``prefill_chunk_tp``: one slot's chunk the same way, its sequence dim in
  the ring-row role;
- ``prefill_chunk_cp``: one slot's chunk context-parallel: its rows
  sequence-sharded over the ring, in-chunk attention on
  ``parallel.context.ring_attention_stats``, the cache's part one flash
  launch with ``kv_lens = pos`` and ``q_start = pos + j t/m`` merged in by
  lse, the chunk's new K/V reassembled by ``ring_all_gather`` for the
  replicated cache.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_lse
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.parallel import collectives as CL
from repro_torch.parallel.context import merge_attention, ring_attention, ring_attention_stats
from repro_torch.tree import tree_leaves

FAMILIES = "ROADMAP.md Queue 1 item 11 (remaining model families)"
SERVING_TP = ("ROADMAP.md Queue 1 item 7b (the static ServeEngine's prefill and decode "
              "under a ParallelCtx)")


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The rank mesh of a multi-rank forward (JAX's ``ParallelCtx``), over
    ``mesh``, a ``parallel.dist.RankMesh``:

    - tensor MP when ``model_axis`` is set: each rank holds its part of the
      parameters, the batch is sharded over ``batch_axes``, and
      ``comm_runtime`` / ``comm_chunks`` pick the collectives (the
      ``context_axis`` is then unused);
    - otherwise context parallelism: the ``context_axis`` group is the KV
      ring, every parameter is replicated across it, and each rank's
      ``forward`` gets its own T/m columns of the tokens."""
    mesh: Any = None
    context_axis: Optional[str] = "model"
    batch_axes: tuple = ("data",)
    model_axis: Optional[str] = None
    comm_runtime: str = "gspmd"
    comm_chunks: int = 1

    @property
    def is_tensor(self) -> bool:
        return self.model_axis is not None

    @property
    def ring_size(self) -> int:
        return self.mesh.size(self.context_axis)


def is_tensor_ctx(pctx) -> bool:
    """A tensor-MP ctx over a model axis of more than one rank."""
    return (isinstance(pctx, ParallelCtx) and pctx.is_tensor and pctx.mesh is not None
            and pctx.mesh.shape[pctx.model_axis] > 1)


def tensor_mp_item(cfg) -> Optional[str]:
    """None where the port runs a tensor-MP train plan of ``cfg`` (the dense,
    MoE and RWKV decoders, the LSTM family, the CNN), else the ROADMAP item
    that would: the other families, item 11."""
    if cfg.family in ("cnn", "rnn") or cfg.rwkv:
        return None
    if (cfg.family == "hybrid" or cfg.encoder_layers or cfg.n_prefix_embeds
            or cfg.attn_logit_softcap or not cfg.n_heads):
        return FAMILIES
    return None


def unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet: {item}")


def check_supported(cfg, *, window: int = 0, pctx=None) -> None:
    """Raise NotImplementedError for any config or mode outside the dense,
    MoE or RWKV decoder the port runs (on one device, a dense decoder on a
    context ring, or under tensor MP, with or without a sliding window:
    other archs under a tensor ctx name ``tensor_mp_item``), and ValueError
    for the CNN and LSTM families, which other modules run, and for a
    context ring over an arch that ``cp_arch_supported`` rejects."""
    if cfg.family == "cnn":
        raise ValueError(f"{cfg.name} is a CNN: models.inception runs it, not the "
                         f"transformer stack")
    if cfg.family == "rnn":
        raise ValueError(f"{cfg.name} is an LSTM model: models.lstm runs it, not the "
                         f"transformer stack")
    if pctx is not None:
        if not isinstance(pctx, ParallelCtx):
            raise unported(f"a pctx other than the port's ParallelCtx "
                           f"({type(pctx).__name__})", SERVING_TP)
        if pctx.is_tensor:
            item = tensor_mp_item(cfg)
            if item is not None:
                raise unported(f"tensor MP of {cfg.name}", item)
        elif not cp_arch_supported(cfg):
            raise ValueError(f"{cfg.name}: context parallelism needs a homogeneous dense "
                             f"decoder without logit softcap (cp_arch_supported); the "
                             f"port has no GSPMD to fall back to")
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
    (``core.planner.comm_runtime_supported``) and ``overlapped_supported``
    both read it, so the two cannot drift."""
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
    if not isinstance(pctx, ParallelCtx) or pctx.is_tensor or pctx.ring_size <= 1:
        return False
    return cp_arch_supported(cfg) and t % pctx.ring_size == 0


def overlapped_supported(cfg, pctx, t: int) -> bool:
    """Can this (arch, mesh, sequence length ``t``) run the overlapped block
    (JAX's ``overlapped_supported``)?  An ``overlapped`` tensor ctx over a
    model axis of more than one rank, an ``overlapped_arch_supported`` arch,
    query heads and the FFN hidden divisible by the axis, and ``t`` divisible
    by it into rows that the chunks divide, so the residual stream stays
    sequence-sharded between the blocks."""
    if (pctx is None or pctx.comm_runtime != "overlapped" or pctx.mesh is None
            or pctx.model_axis is None):
        return False
    msz = pctx.mesh.shape[pctx.model_axis]
    if msz <= 1 or not overlapped_arch_supported(cfg):
        return False
    return (cfg.n_heads > 0 and cfg.n_heads % msz == 0 and cfg.d_ff % msz == 0
            and t % msz == 0 and t // msz % max(pctx.comm_chunks, 1) == 0)


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


def make_cache(cfg, batch: int, capacity: int, *, window: int = 0, dtype=None, device=None,
               kv_heads: Optional[int] = None):
    """Linear decode cache stacked over layers: k, v (L, B, cap, KV, hd) and
    the scalar write position ``pos`` (a Python int); with ``window`` > 0 a
    shift-left ring of ``window`` slots instead of cap; ``kv_heads`` (default
    ``n_kv_heads``) holds a tensor-MP rank's part of the KV heads.  An RWKV
    cache holds the recurrent state instead, for any capacity: wkv_S (L, B,
    H, hd, hd) f32 and the last normed inputs of the time and channel mixes,
    tm_x and cm_x (L, B, d), all zeros."""
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
    shape = (cfg.n_layers, batch, window or capacity, kv_heads or cfg.n_kv_heads, cfg.head_dim)
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

def _is_slot_pos(pos) -> bool:
    """A (B,) tensor of per-row positions: slot mode."""
    return isinstance(pos, torch.Tensor) and pos.dim() > 0


def _self_attention(p, x, cfg, *, pos0, window: int = 0, cache_kv=None, pctx=None,
                    layer: int = 0):
    """Self-attention over x, or (decode) over the cache plus x, or (a
    context-parallel ``pctx``) over the ring's whole sequence, x being this
    rank's rows from position ``pos0``.

    Decode writes the new roped K/V into the cache first and then attends,
    in one of three modes (the sum runs in another order than the JAX
    path's concat(cache, new) under a mask, so the two agree to round-off,
    not bitwise):

    - scalar ``pos0``, no window: insert at ``pos0``, attend over the view
      ``cache[:, :pos0 + t]`` with causal=False;
    - scalar ``pos0`` with a window: the shift-left ring insert, then attend
      over its last min(pos0, window - 1) + 1 slots with causal=False;
    - slot mode, ``pos0`` a (B,) int32 device tensor: insert each row's t
      tokens at its own position, then attend over the whole capacity with
      ``kv_lens = pos0 + t``, causal and windowed from each row's position
      (JAX's slot-mode mask; t > 1 is the chunked-prefill extend step).

    Returns (out, (k_roped, v))."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).view(b, t, nh, hd)
    k = (x @ p["wk"].to(x.dtype)).view(b, t, nkv, hd)
    v = (x @ p["wv"].to(x.dtype)).view(b, t, nkv, hd)
    slot = _is_slot_pos(pos0)
    steps = torch.arange(t, device=x.device)
    positions = pos0.long()[:, None] + steps[None] if slot else (pos0 + steps).expand(b, t)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if pctx is not None:
        out = ring_attention(q, k, v, mesh=pctx.mesh, axis=pctx.context_axis, causal=True,
                             window=window, layer=layer)
    elif cache_kv is None:
        out = flash_attention(q, k, v, causal=True, window=window)
    elif slot:
        L.cache_insert_at(cache_kv, k, v, pos0)
        out = flash_attention(q, cache_kv["k"], cache_kv["v"], causal=True, window=window,
                              kv_lens=pos0 + t)
    elif window:
        L.cache_insert_window(cache_kv, k, v)
        n = min(pos0, window - 1) + 1
        out = flash_attention(q, cache_kv["k"][:, -n:], cache_kv["v"][:, -n:], causal=False)
    else:
        L.cache_insert_full(cache_kv, k, v, pos0)
        n = pos0 + t
        out = flash_attention(q, cache_kv["k"][:, :n], cache_kv["v"][:, :n],
                              causal=False)
    return out.reshape(b, t, nh * hd) @ p["wo"].to(x.dtype), (k, v)


def block_apply(cfg, p, x, *, mode: str, pos0=0, window: int = 0, cache=None,
                capacity_factor=1.25):
    """One decoder block.  ``cache`` is this layer's {"k", "v"} view
    (B, cap, KV, hd): decode reads and updates it in place, prefill fills
    its first S positions (the rest stays zero, the JAX pad to capacity);
    with a ``window``, a (B, window, KV, hd) ring that prefill fills with the
    last min(S, window) keys right-aligned (JAX's shift-left layout).
    ``pos0`` is decode's scalar position or slot mode's (B,) positions.
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
        attn_out, _ = _self_attention(p["attn"], h, cfg, pos0=pos0, window=window,
                                      cache_kv=cache)
    else:
        attn_out, (k_new, v_new) = _self_attention(p["attn"], h, cfg, pos0=0, window=window)
        if mode == "prefill":
            s = k_new.shape[1]
            n = min(s, window) if window else s
            lo = window - n if window else 0      # the ring's left pad stays zero
            cache["k"][:, lo:lo + n] = k_new[:, s - n:]
            cache["v"][:, lo:lo + n] = v_new[:, s - n:]
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if not cfg.is_moe:
        return x + L.mlp_apply(p["mlp"], h2, cfg.mlp_kind), cache, None
    # decode batches are tiny: the no-drop capacity makes cached decoding
    # (slot mode's ticks and prefill chunks too) agree with the
    # teacher-forced forward
    cf = None if mode == "decode" else capacity_factor
    mlp_out, moe_aux = moe_mod.moe_ffn(p["moe"], h2, cfg, capacity_factor=cf)
    return x + mlp_out, cache, cfg.router_aux_loss * moe_aux


def cp_block_apply(cfg, p, x, *, pctx, layer: int, window: int = 0):
    """``block_apply``'s dense train path on this rank's T/m rows of the
    residual stream: RoPE at positions j T/m + arange(T/m) for ring place j,
    attention on the KV ring (``parallel.context.ring_attention``, windowed
    when asked); every weight is replicated, so the projections and the MLP
    are local."""
    j = pctx.mesh.ring(pctx.context_axis)[0]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, _ = _self_attention(p["attn"], h, cfg, pos0=j * x.shape[1], window=window,
                                  pctx=pctx, layer=layer)
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h2, cfg.mlp_kind)


# ---------------------------------------------------------------------------
# tensor-MP blocks
# ---------------------------------------------------------------------------

def _model_place(pctx):
    """(j, m): this rank's place on the model axis and the axis size."""
    return pctx.mesh.ring(pctx.model_axis)[:2]


def _rope_heads(q, k, cfg):
    """RoPE at positions arange(T) of (B, T, H, hd) q and k."""
    b, t = q.shape[:2]
    positions = torch.arange(t, device=q.device).expand(b, t)
    return L.apply_rope(q, positions, cfg.rope_theta), L.apply_rope(k, positions, cfg.rope_theta)


def _kv_slice(k, v, cfg, j: int, hpm: int):
    """The q-aligned slice of replicated KV heads (JAX's
    ``repeat_kv(k)[:, :, j*hpm:(j+1)*hpm]``), made contiguous for the
    kernel's 16-byte rows."""
    rep = cfg.n_heads // cfg.n_kv_heads
    return tuple(L.repeat_kv(t, rep)[:, :, j * hpm:(j + 1) * hpm].contiguous() for t in (k, v))


def _kv_weights(p, kv_sharded: bool, pctx):
    """``wk`` and ``wv`` as a rank uses them: its column slices, or the
    replicated whole entering through ``copy_to_model`` (each rank uses only
    its q-aligned heads, so the gradients are partial sums)."""
    if kv_sharded:
        return p["wk"], p["wv"]
    return tuple(CL.copy_to_model(p[n], pctx.mesh, pctx.model_axis) for n in ("wk", "wv"))


def _tp_attention(p, h, cfg, pctx, window: int = 0):
    """Megatron attention over replicated ``h`` (B, T, d): this rank's query
    heads (and KV heads, or the slice of the replicated ones) on the flash
    kernels, the row-parallel ``wo`` summed over the model axis.  Where the
    rules replicate ``wq``, attention is computed whole on every rank."""
    b, t, _ = h.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if p["wq"].shape[-1] == nh * hd:
        return _self_attention(p, h, cfg, pos0=0, window=window)[0]
    mesh, axis = pctx.mesh, pctx.model_axis
    j, m = _model_place(pctx)
    hpm = nh // m
    kv_sharded = p["wk"].shape[-1] != nkv * hd
    wk, wv = _kv_weights(p, kv_sharded, pctx)
    hin = CL.copy_to_model(h, mesh, axis)
    q = (hin @ p["wq"].to(h.dtype)).view(b, t, hpm, hd)
    k = (hin @ wk.to(h.dtype)).view(b, t, -1, hd)
    v = (hin @ wv.to(h.dtype)).view(b, t, -1, hd)
    q, k = _rope_heads(q, k, cfg)
    if not kv_sharded:
        k, v = _kv_slice(k, v, cfg, j, hpm)
    out = flash_attention(q, k, v, causal=True, window=window).reshape(b, t, hpm * hd)
    return CL.reduce_from_model(out @ p["wo"].to(h.dtype), mesh, axis)


def _tp_mlp(p, h, cfg, pctx):
    """The column/row-parallel MLP over replicated ``h``, summed over the
    model axis; computed whole on every rank where the rules replicate it."""
    if p["wi"].shape[-1] == cfg.d_ff:
        return L.mlp_apply(p, h, cfg.mlp_kind)
    mesh, axis = pctx.mesh, pctx.model_axis
    return CL.reduce_from_model(L.mlp_apply(p, CL.copy_to_model(h, mesh, axis), cfg.mlp_kind),
                                mesh, axis)


def tp_block_apply(cfg, p, x, *, pctx, layer: int, window: int = 0, capacity_factor=1.25):
    """The ``gspmd`` tensor-MP block (and the overlapped runtime's
    fallback): ``block_apply``'s train path with replicated activations,
    Megatron attention and MLP, one all-reduce after each row-parallel
    product.  An MoE block runs the expert-parallel FFN instead of the MLP
    (``moe.moe_ffn`` over the model axis: the rank's experts on ``gmm``,
    the partial outputs summed over the axis) and returns (x, aux) where
    a dense block returns x."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _tp_attention(p["attn"], h, cfg, pctx, window)
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if not cfg.is_moe:
        return x + _tp_mlp(p["mlp"], h2, cfg, pctx)
    out, aux = moe_mod.moe_ffn(p["moe"], h2, cfg, model_axis=pctx.model_axis,
                               capacity_factor=capacity_factor, mesh=pctx.mesh,
                               batch_axes=pctx.batch_axes)
    return x + out, cfg.router_aux_loss * aux


def _self_attention_overlapped(p, x, cfg, *, pctx, layer: int, window: int = 0):
    """Self-attention with q/k/v/o on the collective-matmul rings (JAX's
    ``_self_attention_overlapped``).  ``x``: (B, T/m, d), this rank's rows.
    One gather ring computes this rank's query heads and its KV heads (or
    all of them, where they do not divide, then its q-aligned slice);
    RoPE runs at positions arange(T) over the gathered sequence, attention
    on the flash kernels, and ``wo`` returns through the reduce ring."""
    mesh, axis, chunks = pctx.mesh, pctx.model_axis, max(pctx.comm_chunks, 1)
    j, m = _model_place(pctx)
    b, t_loc, _ = x.shape
    t = t_loc * m
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hpm = nh // m
    kv_sharded = nkv % m == 0
    kvpm = nkv // m if kv_sharded else nkv
    wk, wv = _kv_weights(p, kv_sharded, pctx)
    w_qkv = torch.cat([p["wq"], wk, wv], dim=-1).to(x.dtype)
    qkv = CL.all_gather_matmul(x, w_qkv, mesh=mesh, axis=axis, chunks=chunks, tag=(layer, 0))
    q = qkv[..., :hpm * hd].view(b, t, hpm, hd)
    k = qkv[..., hpm * hd:(hpm + kvpm) * hd].view(b, t, kvpm, hd)
    v = qkv[..., (hpm + kvpm) * hd:].view(b, t, kvpm, hd)
    q, k = _rope_heads(q, k, cfg)
    if not kv_sharded:
        k, v = _kv_slice(k, v, cfg, j, hpm)
    out = flash_attention(q, k, v, causal=True, window=window).reshape(b, t, hpm * hd)
    return CL.matmul_reduce_scatter(out, p["wo"].to(x.dtype), mesh=mesh, axis=axis,
                                    chunks=chunks, tag=(layer, 1))


def overlapped_block_apply(cfg, p, x, *, pctx, layer: int, window: int = 0):
    """One dense decoder block with every Megatron product on the chunked
    collective-matmul rings (JAX's ``overlapped_block_apply``): ``x`` enters
    and leaves as this rank's (B, T/m, d) rows of the residual stream.  The
    norms run on this rank's rows, so their weights' gradients are partial
    sums: they enter through ``copy_to_model``."""
    mesh, axis = pctx.mesh, pctx.model_axis
    ln1 = CL.copy_to_model(p["ln1"], mesh, axis)
    ln2 = CL.copy_to_model(p["ln2"], mesh, axis)
    x = x + _self_attention_overlapped(p["attn"], L.rms_norm(x, ln1, cfg.norm_eps), cfg,
                                       pctx=pctx, layer=layer, window=window)
    return x + L.mlp_apply_overlapped(p["mlp"], L.rms_norm(x, ln2, cfg.norm_eps),
                                      cfg.mlp_kind, mesh=mesh, axis=axis,
                                      chunks=max(pctx.comm_chunks, 1), layer=layer)


def tp_rwkv_block(cfg, p, x, *, pctx, layer: int, window: int = 0):
    """An RWKV block of a tensor-MP rank's train forward (the gspmd form of
    both runtimes): ``x`` whole on every rank, the norms computed whole (so
    their weights' gradients are whole), the mixes ``rwkv.tp_time_mix`` and
    ``rwkv.tp_channel_mix`` (no attention, so no ``window``)."""
    x = x + rwkv_mod.tp_time_mix(p["tm"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg, pctx)
    return x + rwkv_mod.tp_channel_mix(p["cm"], L.rms_norm(x, p["ln2"], cfg.norm_eps), pctx)


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
    x = L.embed_lookup(params["embed"], tokens).to(getattr(torch, cfg.dtype))
    return x * (cfg.d_model ** 0.5 if cfg.tie_embeddings else 1.0)


def _head(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab_size:
        logits[..., cfg.vocab_size:] += L.NEG_INF
    return logits


def tp_lookup(emb, tokens, vocab_padded: int, dt, pctx):
    """(x, partial): the rows of ``tokens`` under a tensor ctx, in ``dt``.
    A vocab-sharded table looks up this rank's row range and gives zeros
    elsewhere (``partial``: the sum over the model axis is the embedding); a
    replicated one gives the whole embedding."""
    if emb.shape[0] == vocab_padded:
        return L.embed_lookup(emb, tokens).to(dt), False
    n = emb.shape[0]
    local = tokens - _model_place(pctx)[0] * n
    mine = ((local >= 0) & (local < n))[..., None].to(dt)
    return L.embed_lookup(emb, local.clamp(0, n - 1)).to(dt) * mine, True


def _tp_embed(cfg, params, tokens, pctx):
    """(x, partial): the decoder's embedding of ``tokens`` under a tensor
    ctx (``tp_lookup``, scaled as ``_embed`` scales it)."""
    scale = cfg.d_model ** 0.5 if cfg.tie_embeddings else 1.0
    x, partial = tp_lookup(params["embed"], tokens, cfg.vocab_padded,
                           getattr(torch, cfg.dtype), pctx)
    return x * scale, partial


def _tp_head(cfg, params, x, pctx, *, seq_sharded: bool):
    """The final norm and the head under a tensor ctx: logits over this
    rank's vocab columns where the rules shard the head (the tied
    ``embed.T`` or ``lm_head``), else whole.  Sequence-sharded rows are
    gathered first."""
    mesh, axis = pctx.mesh, pctx.model_axis
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    sharded = w.shape[1] != cfg.vocab_padded
    gamma = params["final_norm"]
    if seq_sharded:
        if sharded:     # the rows feed rank-local columns: partial input gradients
            x = CL.gather_sequence(x, mesh, 1, axis)
            gamma = CL.copy_to_model(gamma, mesh, axis)
        else:
            x = CL.gather_from_model(x, mesh, 1, axis)
        h = L.rms_norm(x, gamma, cfg.norm_eps)
    else:
        h = L.rms_norm(x, gamma, cfg.norm_eps)
        if sharded:
            h = CL.copy_to_model(h, mesh, axis)
    logits = h @ w.to(h.dtype)
    lo = _model_place(pctx)[0] * logits.shape[-1] if sharded else 0
    pad = cfg.vocab_size - lo          # this slice's first padded column
    if pad < logits.shape[-1]:
        logits[..., max(pad, 0):] += L.NEG_INF
    return logits


def tp_forward(cfg, params, tokens, pctx, window: int = 0, capacity_factor=1.25):
    """The train forward of one tensor-MP rank: ``params`` its part, the
    tokens (B, S) of its data shard.  Returns (logits, aux): its logits,
    (B, S, V/m) where the head is vocab-sharded, and the blocks' summed
    router aux loss (0 for a dense model; the global batch's, whole on every
    rank).  The overlapped runtime runs ``overlapped_block_apply`` where
    ``overlapped_supported`` holds (the embedding reduce-scattered to this
    rank's rows, gathered again before the head); anything else runs
    ``tp_block_apply`` (an RWKV config ``tp_rwkv_block``): an MoE model
    warns and takes it, as JAX's does."""
    mesh, axis = pctx.mesh, pctx.model_axis
    m = mesh.shape[axis]
    s = tokens.shape[1]
    overlapped = overlapped_supported(cfg, pctx, s)
    if not overlapped and pctx.comm_runtime == "overlapped" and m > 1:
        warnings.warn(
            f"[collectives] {cfg.name}: comm_runtime='overlapped' requested "
            f"but the overlapped block cannot engage (needs a homogeneous "
            f"dense decoder with n_heads ({cfg.n_heads}) and d_ff "
            f"({cfg.d_ff}) divisible by the {m}-way model axis, seq "
            f"({s}) % {m} == 0 and (seq/mp) % comm_chunks "
            f"({pctx.comm_chunks}) == 0); falling back to GSPMD's "
            f"monolithic collectives", stacklevel=3)
    x, partial = _tp_embed(cfg, params, tokens, pctx)
    if overlapped:
        x = (CL.reduce_scatter_sequence if partial else CL.scatter_sequence)(x, mesh, 1, axis)
    elif partial:
        x = CL.reduce_from_model(x, mesh, axis)
    block = (overlapped_block_apply if overlapped
             else tp_rwkv_block if cfg.rwkv else tp_block_apply)
    kw = {"capacity_factor": capacity_factor} if cfg.is_moe else {}
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    for i in range(cfg.n_layers):
        x = block(cfg, layers[i], x, pctx=pctx, layer=i, window=window, **kw)
        if cfg.is_moe:
            x, a = x
            aux = aux + a
    return _tp_head(cfg, params, x, pctx, seq_sharded=overlapped), aux


def forward(cfg, params, batch, *, mode: str = "train", window_override=None,
            pctx=None, cache_capacity: int = 0, capacity_factor=1.25):
    """batch: dict(tokens (B,S)).  mode "train": returns (logits, aux);
    mode "prefill": returns (logits, cache, aux) with a cache of
    ``cache_capacity`` positions (default S), or with a window (the config's
    ``sliding_window`` unless ``window_override`` is given) a ring of that
    many, whatever the capacity.  aux is the blocks' summed
    router aux loss (0 for a dense model).  Under a context-parallel
    ``pctx`` (train only) the tokens are this rank's (B, S/m) columns and
    every block is ``cp_block_apply``; under a tensor-MP one (train only)
    the forward is ``tp_forward``."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode {mode!r}")
    window = cfg.sliding_window if window_override is None else window_override
    check_supported(cfg, window=window, pctx=pctx)
    if pctx is not None and mode == "prefill":
        raise unported("prefill under a ParallelCtx (the continuous engine's sharded chunks "
                       "serve instead: prefill_chunk_tp, prefill_chunk_cp)", SERVING_TP)
    tokens = batch["tokens"]
    if pctx is not None and pctx.is_tensor:
        return tp_forward(cfg, params, tokens, pctx, window, capacity_factor)
    x = _embed(cfg, params, tokens)
    b, s = tokens.shape
    cache = None
    if mode == "prefill":
        cap = cache_capacity or s
        if cap < s and not cfg.rwkv and not window:
            raise ValueError(f"cache capacity {cap} < prompt length {s}")
        cache = make_cache(cfg, b, cap, window=window, dtype=x.dtype, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unstack(params["layers"], cfg.n_layers)
    for i in range(cfg.n_layers):
        if pctx is not None:
            x = cp_block_apply(cfg, layers[i], x, pctx=pctx, layer=i, window=window)
            continue
        csl = None if cache is None else _cache_layer(cache, i)
        x, _, a = block_apply(cfg, layers[i], x, mode=mode, window=window, cache=csl,
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
            x, _, _ = block_apply(cfg, lp, x, mode="train", window=cfg.sliding_window)
        return x

    return stage_fn


def decode_step(cfg, params, cache, batch, *, window_override=None, pctx=None):
    """batch: dict(tokens (B,t)) against the cache.  Returns (logits
    (B,t,V), cache): the K/V (or RWKV state) tensors are updated in place and
    the returned dict carries pos + t.

    ``cache["pos"]`` a scalar: the static batch's step, on a linear cache or,
    with a window (the config's unless ``window_override`` is given), on the
    shift-left ring of that many slots (one token a step).  ``cache["pos"]``
    a (B,) int32 tensor on the cache's device: slot mode, each row at its
    own position in a linear cache of full capacity, the window a mask;
    t > 1 is the chunked-prefill extend step (causal within the chunk).  The
    positions stay on the device: nothing here reads them on the host."""
    if pctx is not None:
        raise unported("decoding over a ParallelCtx (the continuous engine's sharded tick "
                       "serves instead: decode_slots_tp)", SERVING_TP)
    window = cfg.sliding_window if window_override is None else window_override
    check_supported(cfg, window=window)
    pos = cache["pos"]
    slot = _is_slot_pos(pos)
    if not slot:
        pos = int(pos)
        if window and not cfg.rwkv and cache["k"].shape[2] != window:
            raise ValueError(f"window {window} decode over a cache of "
                             f"{cache['k'].shape[2]} slots: a scalar-position window "
                             f"decode takes the ring that a windowed prefill makes")
    elif pos.dtype != torch.int32 or pos.shape != (batch["tokens"].shape[0],):
        raise ValueError(f"slot-mode positions must be ({batch['tokens'].shape[0]},) int32, "
                         f"got {pos.dtype} {tuple(pos.shape)}")
    x = _embed(cfg, params, batch["tokens"])
    layers = _unstack(params["layers"], cfg.n_layers)
    for i in range(cfg.n_layers):
        csl = _cache_layer(cache, i)
        x, _, _ = block_apply(cfg, layers[i], x, mode="decode", pos0=pos, window=window,
                              cache=csl)
    logits = _head(cfg, params, x)
    return logits, {**cache, "pos": pos + batch["tokens"].shape[1]}


# ---------------------------------------------------------------------------
# the continuous engine's sharded steps
# ---------------------------------------------------------------------------

def _axes_size(mesh, axes) -> int:
    n = 1
    for a in (axes or ()):
        if a:
            n *= mesh.size(a)
    return n


def decode_slots_tp_supported(cfg, mesh, model_axis, batch_axes, n_slots: int,
                              chunks: int = 1) -> bool:
    """Can the slot tick run on this (arch, mesh, slots) (JAX's
    ``decode_slots_tp_supported``)?  ``overlapped_supported`` with the slot
    dim in the sequence's role: a model axis of more than one rank, an
    ``overlapped_arch_supported`` arch, query heads and the FFN hidden
    divisible by the axis, and n_slots divisible over dp x mp x chunks."""
    if mesh is None or model_axis is None:
        return False
    msz = mesh.size(model_axis)
    if msz <= 1 or not overlapped_arch_supported(cfg):
        return False
    dp = _axes_size(mesh, batch_axes)
    return (cfg.n_heads > 0 and cfg.n_heads % msz == 0 and cfg.d_ff % msz == 0
            and n_slots % (dp * msz) == 0 and (n_slots // (dp * msz)) % max(chunks, 1) == 0)


def prefill_chunk_tp_supported(cfg, mesh, model_axis, t: int, chunks: int = 1) -> bool:
    """Can one slot's chunk of ``t`` tokens run on the collective-matmul
    rings (JAX's ``prefill_chunk_tp_supported``: the training block's
    conditions with t the chunk length)?"""
    if mesh is None or model_axis is None:
        return False
    msz = mesh.size(model_axis)
    if msz <= 1 or not overlapped_arch_supported(cfg):
        return False
    return (cfg.n_heads > 0 and cfg.n_heads % msz == 0 and cfg.d_ff % msz == 0
            and t % msz == 0 and (t // msz) % max(chunks, 1) == 0)


def prefill_chunk_cp_supported(cfg, mesh, context_axis, t: int) -> bool:
    """Can one slot's chunk of ``t`` tokens run context-parallel (JAX's
    ``prefill_chunk_cp_supported``): a ring of more than one rank, a
    ``cp_arch_supported`` arch and t divisible by the ring."""
    if mesh is None or context_axis is None:
        return False
    csz = mesh.size(context_axis)
    return csz > 1 and cp_arch_supported(cfg) and t % csz == 0


def _tp_slot_attention(p, x, cfg, cache_kv, pos, positions, shape, *, mesh, axis: str,
                       chunks: int, window: int, layer: int):
    """Slot-mode attention of a tensor-MP rank (the body of JAX's
    ``decode_slots_tp`` / ``prefill_chunk_tp`` layer): ``x`` (..., R/m, d),
    this rank's rows; one gather ring gives its query heads' and its KV
    heads' (or all KV heads') columns for all R rows, viewed as ``shape`` =
    (B, T); RoPE at ``positions`` (B, T); the new K/V written at ``pos`` of
    the rank's cache; the flash kernel over its head slice with ``kv_lens =
    pos + T`` (causal within the new tokens, windowed); ``wo`` back through
    the reduce ring to (..., R/m, d)."""
    j, m = mesh.ring(axis)[:2]
    b, t = shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hpm = nh // m
    kvh = p["wk"].shape[-1] // hd
    w_qkv = torch.cat([p["wq"], p["wk"], p["wv"]], dim=-1).to(x.dtype)
    qkv = CL.all_gather_matmul(x, w_qkv, mesh=mesh, axis=axis, chunks=chunks, tag=(layer, 0))
    lead = qkv.shape[:-1]
    qkv = qkv.reshape(b, t, -1)
    q = qkv[..., :hpm * hd].view(b, t, hpm, hd)
    k = qkv[..., hpm * hd:(hpm + kvh) * hd].view(b, t, kvh, hd)
    v = qkv[..., (hpm + kvh) * hd:].view(b, t, kvh, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    L.cache_insert_at(cache_kv, k, v, pos)
    kc, vc = cache_kv["k"], cache_kv["v"]
    if nkv % m:             # replicated KV: this rank's q-aligned slice (JAX's, a copy)
        kc, vc = _kv_slice(kc, vc, cfg, j, hpm)
    out = flash_attention(q, kc, vc, causal=True, window=window, kv_lens=pos + t)
    return CL.matmul_reduce_scatter(out.reshape(*lead, hpm * hd), p["wo"].to(x.dtype),
                                    mesh=mesh, axis=axis, chunks=chunks, tag=(layer, 1))


def _tp_slot_stack(cfg, params, cache, xl, pos, positions, shape, *, mesh, axis: str,
                   chunks: int, window: int):
    """The layer stack of the tensor-MP tick or chunk on this rank's rows
    ``xl``; returns the rows after the last block, gathered whole by
    ``ring_all_gather``."""
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = L.rms_norm(xl, lp["ln1"], cfg.norm_eps)
        xl = xl + _tp_slot_attention(lp["attn"], h, cfg, _cache_layer(cache, i), pos,
                                     positions, shape, mesh=mesh, axis=axis, chunks=chunks,
                                     window=window, layer=i)
        h2 = L.rms_norm(xl, lp["ln2"], cfg.norm_eps)
        xl = xl + L.mlp_apply_overlapped(lp["mlp"], h2, cfg.mlp_kind, mesh=mesh, axis=axis,
                                         chunks=chunks, layer=i)
    return CL.ring_all_gather(xl, mesh=mesh, axis=axis, chunks=chunks, layer=cfg.n_layers)


@torch.inference_mode()
def decode_slots_tp(cfg, params, cache, batch, *, mesh, model_axis: str = "model",
                    batch_axes=(), comm_chunks: int = 1, window_override=None):
    """One continuous-batching decode tick of this rank's data group's
    slots under tensor MP (JAX's ``decode_slots_tp``).  ``params``: the
    rank's part of the weights (``parallel.sharding.serve_tp_part``);
    ``cache``: its part of the slot cache (its data group's B_loc slots,
    its KV heads where they divide over the model axis, else all), ``pos``
    (B_loc,) int32 on the device; batch: dict(tokens (B_loc, 1)), the same
    on every model rank.  Model rank j takes slot rows [j B_loc/m, (j + 1)
    B_loc/m) of the residual stream; each block's products ride the rings
    (``_tp_slot_attention``, ``layers.mlp_apply_overlapped``) and one
    ``ring_all_gather`` before the replicated head reassembles every slot,
    so every model rank computes the same logits.  Writes the new K/V in
    place and returns (logits (B_loc, 1, V), cache with pos + 1)."""
    window = cfg.sliding_window if window_override is None else window_override
    tokens, pos = batch["tokens"], cache["pos"]
    j, m = mesh.ring(model_axis)[:2]
    b_loc = tokens.shape[0]
    rows = b_loc // m
    x = _embed(cfg, params, tokens)[:, 0]                      # (B_loc, d)
    xl = x[j * rows:(j + 1) * rows]
    x_full = _tp_slot_stack(cfg, params, cache, xl, pos, pos.long()[:, None], (b_loc, 1),
                            mesh=mesh, axis=model_axis, chunks=max(comm_chunks, 1),
                            window=window)
    return _head(cfg, params, x_full[:, None]), {**cache, "pos": pos + 1}


@torch.inference_mode()
def prefill_chunk_tp(cfg, params, cache, batch, *, mesh, model_axis: str = "model",
                     comm_chunks: int = 1, window_override=None,
                     n_valid: Optional[int] = None):
    """One slot's chunked-prefill extend step under tensor MP (JAX's
    ``prefill_chunk_tp``): the chunk's sequence dim in the ring-row role,
    model rank j holding rows [j t/m, (j + 1) t/m) between the blocks.
    ``cache``: the rank's part of one slot (``models.api.cache_extract_slot``
    of its slot cache part, ``pos`` (1,)); batch: dict(tokens (1, t)).
    ``n_valid`` (default t) marks a padded chunk: only the first n_valid
    tokens are real, the logits are taken at n_valid - 1 and ``pos``
    advances by n_valid (the pad rows written past it are masked by every
    later step's ``kv_lens`` and overwritten by the next insert).  Returns
    (logits (1, 1, V), slot cache)."""
    window = cfg.sliding_window if window_override is None else window_override
    tokens, pos = batch["tokens"], cache["pos"]
    b, t = tokens.shape
    nv = t if n_valid is None else int(n_valid)
    j, m = mesh.ring(model_axis)[:2]
    t_loc = t // m
    x = _embed(cfg, params, tokens)                            # (1, t, d)
    xl = x[:, j * t_loc:(j + 1) * t_loc]
    positions = pos.long()[:, None] + torch.arange(t, device=tokens.device)[None]
    x_full = _tp_slot_stack(cfg, params, cache, xl, pos, positions, (b, t), mesh=mesh,
                            axis=model_axis, chunks=max(comm_chunks, 1), window=window)
    return _head(cfg, params, x_full[:, nv - 1:nv]), {**cache, "pos": pos + nv}


@torch.inference_mode()
def prefill_chunk_cp(cfg, params, cache, batch, *, mesh, context_axis: str = "model",
                     window_override=None, n_valid: Optional[int] = None):
    """One slot's chunked-prefill extend step context-parallel (JAX's
    ``prefill_chunk_cp``): ring place j holds the chunk's rows [j t/m,
    (j + 1) t/m) at positions pos + j t/m + i; weights and the slot cache
    are whole on every rank.  Per block, in-chunk attention rides
    ``ring_attention_stats`` (chunk-relative positions: the request's offset
    cancels in the masks), the cache's part is one flash launch over the
    keys [0, pos) with ``kv_lens = pos`` and ``q_start = pos + j t/m`` (not
    causal: every cache key is older; windowed when asked), skipped while
    the slot holds no key, and the two are merged by lse; the chunk's new
    K/V rows are reassembled by ``ring_all_gather`` and written into the
    cache at pos on every rank.  Same arguments and ``n_valid`` contract as
    ``prefill_chunk_tp`` (pad rows land on the ring's tail ranks).  Returns
    (logits (1, 1, V), slot cache)."""
    window = cfg.sliding_window if window_override is None else window_override
    tokens, pos = batch["tokens"], cache["pos"]
    b, t = tokens.shape
    nv = t if n_valid is None else int(n_valid)
    j, m = mesh.ring(context_axis)[:2]
    t_loc = t // m
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    has_keys = bool((pos > 0).any())       # one host read a chunk: the slot's position
    x = _embed(cfg, params, tokens)[:, j * t_loc:(j + 1) * t_loc]
    q_start = (pos + j * t_loc).to(torch.int32)
    positions = q_start.long()[:, None] + torch.arange(t_loc, device=tokens.device)[None]
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        p, csl = lp["attn"], _cache_layer(cache, i)
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = (h @ p["wq"].to(h.dtype)).view(b, t_loc, nh, hd)
        k = (h @ p["wk"].to(h.dtype)).view(b, t_loc, nkv, hd)
        v = (h @ p["wv"].to(h.dtype)).view(b, t_loc, nkv, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        out, lse = ring_attention_stats(q, k, v, mesh=mesh, axis=context_axis, causal=True,
                                        window=window, layer=i)
        if has_keys:
            o_c, lse_c = flash_attention_lse(q, csl["k"], csl["v"], causal=False,
                                             window=window, kv_lens=pos, q_start=q_start)
            out, lse = merge_attention(out, lse, o_c, lse_c)
        x = x + out.to(x.dtype).reshape(b, t_loc, nh * hd) @ p["wo"].to(x.dtype)
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.mlp_apply(lp["mlp"], h2, cfg.mlp_kind)
        kv = CL.ring_all_gather(torch.cat([k, v], dim=2).reshape(b, t_loc, 2 * nkv * hd),
                                mesh=mesh, axis=context_axis, layer=i).view(b, t, 2 * nkv, hd)
        L.cache_insert_at(csl, kv[:, :, :nkv], kv[:, :, nkv:], pos)
    x_full = CL.ring_all_gather(x, mesh=mesh, axis=context_axis, layer=cfg.n_layers)
    return _head(cfg, params, x_full[:, nv - 1:nv]), {**cache, "pos": pos + nv}
