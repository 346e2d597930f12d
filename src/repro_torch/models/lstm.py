"""The paper's RNN models (port of ``repro/models/lstm.py``): BigLSTM
(embedding 1024, 2 LSTM layers of hidden 8192 with a 1024 projection, a big
softmax) and GNMT (a residual LSTM encoder, a decoder whose first layer
drives a Luong attention over the encoder states, a vocab head).

Parameters keep the JAX paths and layouts: ``params["lstm"]`` (BigLSTM) and
``params["enc"]``, ``params["dec"]`` (GNMT) are lists of per-layer dicts
with wx (d_in, 4H), wh (d_proj or H, 4H), b (4H,) f32 and, when d_proj > 0,
wp (H, d_proj).  Every cell step runs on the CUDA kernel of
``kernels.lstm_cell`` (its plain twin on the CPU); the projection is a plain
GEMM.  The JAX ``lax.scan`` over time becomes a Python loop.

A layer's weights are cast to the activation dtype once per forward, outside
the time loop (the JAX cell casts on every call and XLA hoists it).  Under
autograd a layer runs as one ``_LSTMLayer`` function: the forward kernel
writes each step's gates, the backward walks the steps in reverse with the
pointwise kernel and forms the weight gradients once over all steps (one
GEMM per weight, accumulated in f32 inside the GEMM) instead of T GEMMs
summed in the activation dtype.

``biglstm_stage_fn`` is one pipeline chunk of the residual LSTM stack for
the scheduled pipeline runtime (``parallel.pipeline``); its parameters are
the per-layer dicts stacked with a leading layer dim (``stack_layer_params``).

Under a tensor-MP ``ParallelCtx`` (``models.transformer.ParallelCtx`` with
``model_axis`` set) a rank holds its part of the parameters
(``parallel.sharding.shard_params``: ``wx`` and ``wh`` cut gate-major, so
its cell owns H/m hidden units of every gate; ``wp`` its H/m rows; ``b``
replicated).  Its layer is ``tp_lstm_layer`` (JAX's GSPMD partitioning of
``lstm_layer`` written out, one ``_TPLSTMLayer`` function a layer): x and h
whole on every rank, the cell on the rank's slice, then every step h =
all-reduce(out @ wp_rank) (JAX's ``psum``) or, without a projection, the
all-gather of the slices; the backward all-reduces dh every step and dx
once.  Every per-step message is one blocking, tagged exchange
(``parallel.collectives.step_all_reduce`` / ``step_all_gather``,
``parallel.dist.rnn_message_tag``).  BigLSTM under the ``overlapped``
runtime runs ``lstm_layer_overlapped`` (JAX's): x @ Wx for all steps on the
``all_gather_matmul`` ring over the time dim, each step on the forward
kernel's gx entry (``kernels.lstm_cell.lstm_cell_fwd_gx``); where
``lstm_overlapped_ok`` fails it warns, as JAX does, and takes the gspmd
layer.  GNMT ignores the runtime (JAX's ``gnmt_forward`` takes no pctx) and
runs the gspmd layer.  The embeddings are vocab-parallel and the head
column-parallel where the rules shard them; the logits stay unmasked.

Not ported here (it raises NotImplementedError naming its ROADMAP item):
the forward through the ``ad`` pipeline runtime.
"""
from __future__ import annotations

import math
import warnings

import torch

from repro_torch.kernels import lstm_cell as K
from repro_torch.models import layers as L
from repro_torch.models.transformer import tp_lookup
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import dist as D
from repro_torch.parallel.pipeline import AD_RUNTIME
from repro_torch.tree import tree_map


def unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet: {item}")


def lstm_cell_init(gen: torch.Generator, d_in: int, d_h: int, d_proj: int = 0, *,
                   dtype=torch.float32, device=None):
    p = {"wx": L.dense_init(gen, d_in, 4 * d_h, dtype=dtype, device=device),
         "wh": L.dense_init(gen, d_proj or d_h, 4 * d_h, dtype=dtype, device=device),
         "b": torch.zeros((4 * d_h,), dtype=torch.float32, device=device)}
    if d_proj:
        p["wp"] = L.dense_init(gen, d_h, d_proj, dtype=dtype, device=device)
    return p


def _cell_weights(p, dtype):
    """(wx (d_in, 4, H), wh (d_h, 4, H), b (4, H) f32, wp or None), the
    matrices cast to ``dtype``: gate-major views of the (d, 4H) weights."""
    d_h = p["wx"].shape[1] // 4
    wx = p["wx"].to(dtype).view(-1, 4, d_h)
    wh = p["wh"].to(dtype).view(-1, 4, d_h)
    b = p["b"].float().view(4, d_h)
    wp = p["wp"].to(dtype) if "wp" in p else None
    return wx, wh, b, wp


def lstm_cell(p, x, state):
    """x: (B, d_in); state: (h, c).  Returns (new_state, output): the cell
    step on the kernel, then the projection ``out @ wp`` as a plain GEMM."""
    h, c = state
    wx, wh, b, wp = _cell_weights(p, x.dtype)
    out, c = K.lstm_cell(x, h, c, wx, wh, b)
    if wp is not None:
        out = out @ wp
    return (out, c), out


class _LSTMLayer(torch.autograd.Function):
    """A whole layer over time: ys (B, T, d_out), h_T, c_T from xs (B, T, d_in),
    the initial state and the layer's cast weights."""

    @staticmethod
    def forward(ctx, xs, h0, c0, wx, wh, b, wp):
        bsz, t_len, _ = xs.shape
        d_h = c0.shape[1]
        d_out = h0.shape[1]
        dev, dt = xs.device, xs.dtype
        ctx.set_materialize_grads(False)
        gates = torch.empty((t_len, bsz, 4, d_h), dtype=K.compute_dtype(dt), device=dev)
        cs = torch.empty((t_len + 1, bsz, d_h), dtype=dt, device=dev)   # c_0 .. c_T
        hs = torch.empty((t_len + 1, bsz, d_out), dtype=dt, device=dev)  # h_0 .. h_T
        raw = torch.empty((t_len, bsz, d_h), dtype=dt, device=dev) if wp is not None else None
        cs[0] = c0
        hs[0] = h0
        for t in range(t_len):
            h_out = raw[t] if wp is not None else hs[t + 1]
            K.lstm_cell_fwd(xs[:, t], hs[t], cs[t], wx, wh, b, want_gates=True,
                            h_out=h_out, c_out=cs[t + 1], gates_out=gates[t])
            if wp is not None:
                torch.mm(raw[t], wp, out=hs[t + 1])
        ctx.save_for_backward(xs, hs, cs, gates, raw, wx, wh, wp)
        ctx.b_dtype = b.dtype
        return hs[1:].transpose(0, 1).contiguous(), hs[t_len].clone(), cs[t_len].clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dys, dh_t, dc_t):
        xs, hs, cs, gates, raw, wx, wh, wp = ctx.saved_tensors
        t_len, bsz, d_h = cs.shape[0] - 1, cs.shape[1], cs.shape[2]
        d_in, d_out = xs.shape[2], hs.shape[2]
        dt, dev = xs.dtype, xs.device
        dgates = torch.empty((t_len, bsz, 4, d_h), dtype=dt, device=dev)
        dys_t = (dys.transpose(0, 1) if dys is not None
                 else torch.zeros((t_len, bsz, d_out), dtype=dt, device=dev))
        dy_total = torch.empty((t_len, bsz, d_out), dtype=dt, device=dev) \
            if wp is not None else None
        dh = dh_t if dh_t is not None else torch.zeros((bsz, d_out), dtype=dt, device=dev)
        dc = dc_t.contiguous() if dc_t is not None else None
        wh2t = wh.view(d_out, 4 * d_h).t()
        for t in reversed(range(t_len)):
            gy = dys_t[t] + dh                                  # dL/dh_t
            if wp is not None:
                dy_total[t] = gy
                d_raw = gy @ wp.t()
            else:
                d_raw = gy.contiguous()
            _, dc = K.lstm_cell_bwd_pointwise(gates[t], cs[t], d_raw, dc,
                                              dgates_out=dgates[t])
            dh = dgates[t].view(bsz, 4 * d_h) @ wh2t
        n = t_len * bsz
        dg2 = dgates.view(n, 4 * d_h)
        x_rows = xs.transpose(0, 1).reshape(n, d_in)
        dwx, dwh, db = K.weight_grads(x_rows, hs[:-1].reshape(n, d_out), dgates.view(n, 4, d_h),
                                      ctx.b_dtype)
        dxs = (dg2 @ wx.view(d_in, 4 * d_h).t()).view(t_len, bsz, d_in).transpose(0, 1)
        dwp = None
        if wp is not None:
            dwp = raw.reshape(n, d_h).t() @ dy_total.view(n, d_out)
        return dxs, dh, dc, dwx, dwh, db, dwp


def lstm_layer(p, xs, state=None):
    """xs: (B, T, d_in) -> (ys (B, T, d_out), (h, c)): a loop over time."""
    bsz = xs.shape[0]
    d_h = p["wx"].shape[1] // 4
    d_out = p["wp"].shape[1] if "wp" in p else d_h
    if state is None:
        state = (torch.zeros((bsz, d_out), dtype=xs.dtype, device=xs.device),
                 torch.zeros((bsz, d_h), dtype=xs.dtype, device=xs.device))
    h, c = state
    wx, wh, b, wp = _cell_weights(p, xs.dtype)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xs, h, c, wx, wh, b, wp)):
        ys, h, c = _LSTMLayer.apply(xs, h, c, wx, wh, b, wp)
        return ys, (h, c)
    ys = []
    for t in range(xs.shape[1]):
        out, c, _ = K.lstm_cell_fwd(xs[:, t], h, c, wx, wh, b)
        h = out @ wp if wp is not None else out
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


# ---------------------------------------------------------------------------
# tensor MP
# ---------------------------------------------------------------------------

class _TPLSTMLayer(torch.autograd.Function):
    """One tensor-MP layer over time on a rank of the model group: ys (B, T,
    d_out), whole on every rank, from ``inp`` and the rank's cast weights wx
    (d_in, 4, H/m), wh (d_out, 4, H/m), b (4, H/m) f32 and wp (H/m, d_out)
    or None.  With ``wx`` None, ``inp`` is the input pre-activation gx (B, T,
    4, H/m) and each step runs the gx entry; else ``inp`` is xs (B, T,
    d_in).  The state starts at zero."""

    @staticmethod
    def forward(ctx, inp, wx, wh, b, wp, mesh, axis, layer):
        bsz, t_len = inp.shape[:2]
        hm = wh.shape[2]
        d_out = wh.shape[0]
        dev, dt = inp.device, inp.dtype
        ctx.set_materialize_grads(False)
        gates = torch.empty((t_len, bsz, 4, hm), dtype=K.compute_dtype(dt), device=dev)
        cs = torch.zeros((t_len + 1, bsz, hm), dtype=dt, device=dev)      # c_0 .. c_T
        hs = torch.zeros((t_len + 1, bsz, d_out), dtype=dt, device=dev)   # h_0 .. h_T
        outs = torch.empty((t_len, bsz, hm), dtype=dt, device=dev)        # the cells' h
        for t in range(t_len):
            if wx is None:
                K.lstm_cell_fwd_gx(inp[:, t], hs[t], cs[t], wh, b, h_out=outs[t],
                                   c_out=cs[t + 1], gates_out=gates[t])
            else:
                K.lstm_cell_fwd(inp[:, t], hs[t], cs[t], wx, wh, b, h_out=outs[t],
                                c_out=cs[t + 1], gates_out=gates[t])
            tag = D.rnn_message_tag(layer, t, 0)
            if wp is not None:
                hs[t + 1] = CL.step_all_reduce(mesh, axis, outs[t] @ wp, tag)
            else:
                hs[t + 1] = CL.step_all_gather(mesh, axis, outs[t], tag)
        ctx.save_for_backward(inp if wx is not None else None, hs, cs, gates, outs, wx, wh,
                              wp)
        ctx.mesh, ctx.axis, ctx.layer, ctx.b_dtype = mesh, axis, layer, b.dtype
        ctx.gx_shape = None if wx is not None else inp.shape
        return hs[1:].transpose(0, 1).contiguous()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dys):
        xs, hs, cs, gates, outs, wx, wh, wp = ctx.saved_tensors
        mesh, axis, layer = ctx.mesh, ctx.axis, ctx.layer
        t_len, bsz, hm = outs.shape
        d_out = hs.shape[2]
        dt, dev = hs.dtype, hs.device
        j = mesh.ring(axis)[0]
        dgates = torch.empty((t_len, bsz, 4, hm), dtype=dt, device=dev)
        dys_t = (dys.transpose(0, 1) if dys is not None
                 else torch.zeros((t_len, bsz, d_out), dtype=dt, device=dev))
        dy_total = torch.empty((t_len, bsz, d_out), dtype=dt, device=dev) \
            if wp is not None else None
        dh = torch.zeros((bsz, d_out), dtype=dt, device=dev)
        dc = None
        wh2t = wh.view(d_out, 4 * hm).t()
        for t in reversed(range(t_len)):
            gy = dys_t[t] + dh                         # dL/dh_t, whole on every rank
            if wp is not None:
                dy_total[t] = gy
                d_out_t = gy @ wp.t()
            else:
                d_out_t = gy[:, j * hm:(j + 1) * hm].contiguous()
            _, dc = K.lstm_cell_bwd_pointwise(gates[t], cs[t], d_out_t, dc,
                                              dgates_out=dgates[t])
            # a partial sum over the rank's gate columns: summed every step
            dh = CL.step_all_reduce(mesh, axis, dgates[t].view(bsz, 4 * hm) @ wh2t,
                                    D.rnn_message_tag(layer, t, 1))
        n = t_len * bsz
        dwp = None
        if wp is not None:
            dwp = outs.reshape(n, hm).t() @ dy_total.view(n, d_out)
        x_rows = None if xs is None else xs.transpose(0, 1).reshape(n, -1)
        dwx, dwh, db = K.weight_grads(x_rows, hs[:-1].reshape(n, d_out),
                                      dgates.view(n, 4, hm), ctx.b_dtype)
        if wx is None:       # the gx entry: the gradient of gx is dgates
            return (dgates.transpose(0, 1).reshape(ctx.gx_shape), None, dwh, db, dwp,
                    None, None, None)
        d_in = xs.shape[2]
        dxs = CL.step_all_reduce(mesh, axis, dgates.view(n, 4 * hm) @ wx.view(d_in, -1).t(),
                                 D.rnn_message_tag(layer, 0, 2))
        return (dxs.view(t_len, bsz, d_in).transpose(0, 1), dwx, dwh, db, dwp,
                None, None, None)


def _tp_cell_weights(p, dtype, pctx):
    """(wx (d_in, 4, H/m), wh (d_out, 4, H/m), b (4, H/m) f32, wp or None): a
    rank's cast gate-major weights and its columns of the replicated bias,
    which enters through ``copy_to_model`` (its gradient is summed over the
    model group, so it is whole on every rank)."""
    mesh, axis = pctx.mesh, pctx.model_axis
    j = mesh.ring(axis)[0]
    hh = p["b"].shape[0] // 4
    hm = p["wx"].shape[1] // 4
    wx = p["wx"].to(dtype).view(-1, 4, hm)
    wh = p["wh"].to(dtype).view(-1, 4, hm)
    b = CL.copy_to_model(p["b"], mesh, axis).float().view(4, hh)[:, j * hm:(j + 1) * hm]
    wp = p["wp"].to(dtype) if "wp" in p else None
    return wx, wh, b.contiguous(), wp


def _gate_sharded(p) -> bool:
    """Whether the rules cut this cell's gate columns (a rank holds H/m)."""
    return p["wx"].shape[1] != p["b"].shape[0]


def tp_lstm_layer(p, xs, pctx, layer: int):
    """The ``gspmd`` tensor-MP layer: xs (B, T, d_in), whole on every rank
    of the model group, -> ys (B, T, d_out), whole on every rank.  Where the
    rules replicate the gate leaves every rank runs the whole layer."""
    if not _gate_sharded(p):
        return lstm_layer(p, xs)[0]
    wx, wh, b, wp = _tp_cell_weights(p, xs.dtype, pctx)
    return _TPLSTMLayer.apply(xs, wx, wh, b, wp, pctx.mesh, pctx.model_axis, layer)


def lstm_layer_overlapped(p, xs, pctx, layer: int):
    """JAX's ``lstm_layer_overlapped`` on a rank: the input projection x @ Wx
    for all T steps rides ``all_gather_matmul`` over the time dim (this
    rank's T/m rows of xs against its gate-major columns of wx, ``comm_chunks``
    chunks a shard), giving gx (B, T, 4, H/m); the recurrence runs each step
    on the forward kernel's gx entry, h replicated, c sharded, the per-step
    ``wp`` psum (or all-gather) as in ``tp_lstm_layer``.  xs (B, T, d_in)
    whole on every rank (T % m == 0); returns ys (B, T, d_out), whole."""
    mesh, axis = pctx.mesh, pctx.model_axis
    wx, wh, b, wp = _tp_cell_weights(p, xs.dtype, pctx)
    bsz, t_len, d_in = xs.shape
    hm = wh.shape[2]
    rows = CL.scatter_sequence(xs, mesh, 1, axis)
    gx = CL.all_gather_matmul(rows, wx.view(d_in, 4 * hm), mesh=mesh, axis=axis,
                              chunks=max(pctx.comm_chunks, 1), tag=(layer, 0))
    return _TPLSTMLayer.apply(gx.view(bsz, t_len, 4, hm), None, wh, b, wp, mesh, axis, layer)


def lstm_overlapped_ok(cfg, pctx, t: int) -> bool:
    """Gate for the overlapped tensor-MP LSTM path (JAX's): an ``overlapped``
    tensor ctx over a model axis of more than one rank, the hidden dim
    divisible by it (gate-major sharding), and the time dim divisible (the
    input projection rides a time-dim gather ring) into rows that the
    chunks divide."""
    if (pctx is None or getattr(pctx, "comm_runtime", "gspmd") != "overlapped"
            or pctx.mesh is None or pctx.model_axis is None):
        return False
    m = pctx.mesh.shape[pctx.model_axis]
    if m <= 1:
        return False
    chunks = max(getattr(pctx, "comm_chunks", 1), 1)
    return cfg.d_ff % m == 0 and t % m == 0 and (t // m) % chunks == 0


def _tp_embed(cfg, table, tokens, pctx):
    """The embedding of ``tokens``, whole on every rank: a vocab-sharded
    table's rows summed over the model group, or a replicated table's."""
    x, partial = tp_lookup(table, tokens, cfg.vocab_padded, getattr(torch, cfg.dtype), pctx)
    return CL.reduce_from_model(x, pctx.mesh, pctx.model_axis) if partial else x


def _tp_logits(cfg, x, head, pctx):
    """``x @ head`` under a tensor ctx: this rank's vocab columns where the
    rules shard the head (x enters through ``copy_to_model``: its gradient
    is a partial sum), else whole.  No column is masked, as in JAX."""
    if head.shape[1] != cfg.vocab_padded:
        x = CL.copy_to_model(x, pctx.mesh, pctx.model_axis)
    return x @ head.to(x.dtype)


# ---------------------------------------------------------------------------
# GNMT
# ---------------------------------------------------------------------------

def gnmt_init(gen: torch.Generator, cfg, *, device=None):
    """Random parameters at the JAX init's scales, drawn from ``gen``:
    ``cfg.n_layers`` encoder and decoder layers of width d_model with no
    projection, the first decoder layer reading 2 d_model (its input and an
    attention context)."""
    dtype = getattr(torch, cfg.param_dtype)
    d, v, n = cfg.d_model, cfg.vocab_padded, cfg.n_layers

    def cell(d_in):
        return lstm_cell_init(gen, d_in, d, 0, dtype=dtype, device=device)

    return {"src_embed": L.embed_init(gen, v, d, dtype=dtype, device=device),
            "tgt_embed": L.embed_init(gen, v, d, dtype=dtype, device=device),
            "enc": [cell(d) for _ in range(n)],
            "dec": [cell(2 * d if i == 0 else d) for i in range(n)],
            "attn_q": L.dense_init(gen, d, d, dtype=dtype, device=device),
            "head": L.dense_init(gen, d, v, dtype=dtype, device=device)}


def gnmt_forward(cfg, params, batch, pctx=None):
    """batch: dict(src (B, S), tgt (B, T)) -> logits (B, T, V_padded).

    As JAX: the encoder is residual from its second layer on; the first
    decoder layer reads ``concat([tgt, zeros])``, so the context half of its
    input is zero; a Luong attention of its output over all S encoder states
    (one head of d_model, scaled by 1/sqrt(d_model), no source mask) is added
    to it; the later decoder layers are residual; the head has no final
    norm.  The attention is plain ops, as JAX's ``einsum``s.

    Under a tensor ``pctx`` (a rank's part of the parameters) every layer
    is ``tp_lstm_layer`` (encoder layer i is recurrence i, decoder layer i
    is n + i), the embeddings vocab-parallel and the head column-parallel
    where the rules shard them: the logits are this rank's vocab columns.
    JAX's GNMT takes no pctx, so the ``overlapped`` runtime changes
    nothing."""
    dt = getattr(torch, cfg.dtype)
    n = len(params["enc"])

    def layer(lp, x, i):
        return lstm_layer(lp, x)[0] if pctx is None else tp_lstm_layer(lp, x, pctx, i)

    def embed(name, ids):
        if pctx is None:
            return L.embed_lookup(params[name], ids).to(dt)
        return _tp_embed(cfg, params[name], ids, pctx)

    x = embed("src_embed", batch["src"])
    for i, lp in enumerate(params["enc"]):
        y = layer(lp, x, i)
        x = y if i == 0 else x + y
    enc_out = x                                              # (B, S, d)
    tgt = embed("tgt_embed", batch["tgt"])
    y0 = layer(params["dec"][0], torch.cat([tgt, torch.zeros_like(tgt)], -1), n)
    q = y0 @ params["attn_q"].to(dt)
    scores = q @ enc_out.transpose(1, 2) / math.sqrt(cfg.d_model)
    x = y0 + torch.softmax(scores, -1) @ enc_out
    for i, lp in enumerate(params["dec"][1:]):
        x = x + layer(lp, x, n + 1 + i)
    if pctx is not None:
        return _tp_logits(cfg, x, params["head"], pctx)
    return x @ params["head"].to(dt)


# ---------------------------------------------------------------------------
# BigLSTM
# ---------------------------------------------------------------------------

def biglstm_init(gen: torch.Generator, cfg, *, device=None, keep=None):
    """Random parameters at the JAX init's scales, drawn from ``gen``.

    ``keep(path, tree)`` (default: keep all) sees each piece as soon as it is
    drawn, ``("embed",)``, ``("lstm", i)`` for layer i's dict and
    ``("head",)``, and returns what to hold of it (None: nothing).  Every
    piece is drawn either way, so the pieces kept are bit-equal to those of
    the whole init, and only one unkept piece is held at a time."""
    keep = keep or (lambda path, tree: tree)
    dtype = getattr(torch, cfg.param_dtype)
    d, v, dh = cfg.d_model, cfg.vocab_padded, cfg.d_ff
    params = {"embed": keep(("embed",), L.embed_init(gen, v, d, dtype=dtype, device=device)),
              "lstm": [keep(("lstm", i), lstm_cell_init(gen, d, dh, d, dtype=dtype,
                                                        device=device))
                       for i in range(cfg.n_layers)]}
    params["head"] = keep(("head",), L.dense_init(gen, d, v, dtype=dtype, device=device))
    return params


def stack_layer_params(layer_list):
    """Homogeneous per-layer param dicts -> one stacked (L, ...) tree, the
    layout ``parallel.pipeline.stack_to_stages`` partitions into stages."""
    return tree_map(lambda *ls: torch.stack(ls), *layer_list)


def biglstm_stage_fn(cfg):
    """One pipeline chunk of BigLSTM's residual LSTM stack as a
    shape-preserving ``(chunk_params, x) -> y``: chunk_params holds the
    chunk's layers stacked (Lc, ...), as ``stack_layer_params`` stacks
    them."""

    def stage_fn(sp, x):
        per_leaf = {k: torch.unbind(a, 0) for k, a in sp.items()}
        for i in range(next(iter(sp.values())).shape[0]):
            y, _ = lstm_layer({k: a[i] for k, a in per_leaf.items()}, x)
            x = x + y
        return x

    return stage_fn


def biglstm_forward(cfg, params, batch, pctx=None):
    """batch: dict(tokens (B, T)) -> logits (B, T, V_padded): embedding, a
    residual stack of LSTM layers, the softmax projection (padded vocab
    columns are not masked, as in JAX).

    Under a tensor ``pctx`` (a rank's part of the parameters): the
    embedding vocab-parallel and the head column-parallel where the rules
    shard them (the logits are this rank's vocab columns), each layer
    ``lstm_layer_overlapped`` where ``lstm_overlapped_ok`` holds, else
    ``tp_lstm_layer`` (with a warning, as JAX's, when ``overlapped`` was
    asked for)."""
    dt = getattr(torch, cfg.dtype)
    if pctx is None:
        x = L.embed_lookup(params["embed"], batch["tokens"]).to(dt)
        for lp in params["lstm"]:
            y, _ = lstm_layer(lp, x)
            x = x + y
        return x @ params["head"].to(dt)
    t = batch["tokens"].shape[1]
    overlapped = lstm_overlapped_ok(cfg, pctx, t)
    if (not overlapped and pctx.comm_runtime == "overlapped"
            and pctx.mesh.shape[pctx.model_axis] > 1):
        warnings.warn(
            f"[collectives] biglstm: comm_runtime='overlapped' requested but "
            f"the overlapped LSTM layer cannot engage (needs hidden "
            f"({cfg.d_ff}) and seq ({t}) divisible "
            f"by the model axis and (seq/mp) % comm_chunks == 0); falling "
            f"back to GSPMD's monolithic collectives", stacklevel=2)
    x = _tp_embed(cfg, params["embed"], batch["tokens"], pctx)
    for i, lp in enumerate(params["lstm"]):
        if overlapped and _gate_sharded(lp):
            x = x + lstm_layer_overlapped(lp, x, pctx, i)
        else:
            x = x + tp_lstm_layer(lp, x, pctx, i)
    return _tp_logits(cfg, x, params["head"], pctx)


def biglstm_forward_pipeline(*args, **kwargs):
    raise unported("the BigLSTM forward through the ad pipeline runtime", AD_RUNTIME)
