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

Not ported here (they raise NotImplementedError naming their ROADMAP item):
the tensor-MP ``lstm_layer_overlapped`` and the forward through the ``ad``
pipeline runtime.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import lstm_cell as K
from repro_torch.models import layers as L
from repro_torch.parallel.pipeline import AD_RUNTIME

TENSOR_MP = "ROADMAP.md Queue 1 item 7b (tensor MP of the LSTM family)"


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


def lstm_layer_overlapped(*args, **kwargs):
    raise unported("the overlapped tensor-MP LSTM layer", TENSOR_MP)


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


def gnmt_forward(cfg, params, batch):
    """batch: dict(src (B, S), tgt (B, T)) -> logits (B, T, V_padded).

    As JAX: the encoder is residual from its second layer on; the first
    decoder layer reads ``concat([tgt, zeros])``, so the context half of its
    input is zero; a Luong attention of its output over all S encoder states
    (one head of d_model, scaled by 1/sqrt(d_model), no source mask) is added
    to it; the later decoder layers are residual; the head has no final
    norm.  The attention is plain ops, as JAX's ``einsum``s."""
    dt = getattr(torch, cfg.dtype)
    x = params["src_embed"][batch["src"]].to(dt)
    for i, lp in enumerate(params["enc"]):
        y, _ = lstm_layer(lp, x)
        x = y if i == 0 else x + y
    enc_out = x                                              # (B, S, d)
    tgt = params["tgt_embed"][batch["tgt"]].to(dt)
    y0, _ = lstm_layer(params["dec"][0], torch.cat([tgt, torch.zeros_like(tgt)], -1))
    q = y0 @ params["attn_q"].to(dt)
    scores = q @ enc_out.transpose(1, 2) / math.sqrt(cfg.d_model)
    x = y0 + torch.softmax(scores, -1) @ enc_out
    for lp in params["dec"][1:]:
        y, _ = lstm_layer(lp, x)
        x = x + y
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
    return {k: torch.stack([lp[k] for lp in layer_list]) for k in layer_list[0]}


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
    columns are not masked, as in JAX)."""
    if pctx is not None:
        raise unported("a ParallelCtx (mesh execution)", TENSOR_MP)
    dt = getattr(torch, cfg.dtype)
    x = params["embed"][batch["tokens"]].to(dt)
    for lp in params["lstm"]:
        y, _ = lstm_layer(lp, x)
        x = x + y
    return x @ params["head"].to(dt)


def biglstm_forward_pipeline(*args, **kwargs):
    raise unported("the BigLSTM forward through the ad pipeline runtime", AD_RUNTIME)
