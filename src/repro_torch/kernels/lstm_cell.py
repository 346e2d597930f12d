"""Fused LSTM cell: wrappers of the CUDA kernels ``csrc/lstm_cell.cu`` (the
port of ``repro/kernels/lstm_cell.py:_lstm_kernel``) and their autograd.

``lstm_cell(x, h, c, wx, wh, b)`` keeps the JAX signature: x (B, d_in),
h (B, d_h), c (B, H), wx (d_in, 4, H), wh (d_h, 4, H), b (4, H); it returns
(h', c') and is differentiable through ``LSTMCellFunction``.  The two
kernels are reached through

    lstm_cell_fwd(x, h, c, wx, wh, b, want_gates=)  -> (h', c', gates or None)
    lstm_cell_bwd_pointwise(gates, c, dh, dc)        -> (dgates, dc_prev)

each with a launch counter (``.launches``) and a plain twin
(``lstm_cell_plain``, ``lstm_cell_bwd_pointwise_plain``).  On CPU tensors a
wrapper takes its plain twin; on CUDA tensors it launches its kernel or
raises.  There is no switch that puts the plain version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 16        # batch rows of one forward block (csrc kBB)


def compute_dtype(dtype):
    """The plain twins compute in f32, or in f64 for f64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _require_cuda(what: str, *ts) -> None:
    dev = ts[0].device
    if not (dev.type == "cuda" and all(t is None or t.device == dev for t in ts)):
        raise ValueError(f"{what} needs every tensor on one CUDA device (or all "
                         f"on the CPU); got {[str(t.device) for t in ts if t is not None]}")


def _require_rows(what: str, t, shape, dtype) -> None:
    """A (rows, cols) tensor of ``dtype`` with unit column stride."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or (t.shape[1] > 1
                                                               and t.stride(1) != 1):
        raise ValueError(f"{what}: expected {tuple(shape)} {dtype} with unit column "
                         f"stride, got {tuple(t.shape)} {t.dtype} strides {t.stride()}")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def lstm_cell_plain(x, h, c, wx, wh, b, *, with_gates: bool = False):
    """Plain version of the forward kernel: the products and the cell update
    in f32 (f64 for f64 inputs).  Returns (h', c') in h's and c's dtypes, and
    with ``with_gates`` also the activated gates (B, 4, H) in the compute
    dtype."""
    ct = compute_dtype(x.dtype)
    bsz, hh = c.shape
    gates = (x.to(ct) @ wx.reshape(wx.shape[0], 4 * hh).to(ct)
             + h.to(ct) @ wh.reshape(wh.shape[0], 4 * hh).to(ct)).view(bsz, 4, hh) \
        + b.to(ct).view(4, hh)
    act = torch.stack([torch.sigmoid(gates[:, 0]), torch.sigmoid(gates[:, 1] + 1.0),
                       torch.tanh(gates[:, 2]), torch.sigmoid(gates[:, 3])], dim=1)
    c_new = act[:, 1] * c.to(ct) + act[:, 0] * act[:, 2]
    h_new = act[:, 3] * torch.tanh(c_new)
    out = (h_new.to(h.dtype), c_new.to(c.dtype))
    return out + (act,) if with_gates else out


def lstm_cell_bwd_pointwise_plain(gates, c, dh, dc=None):
    """Plain version of the pointwise backward: from the activated gates
    (B, 4, H), the step's input c and the gradients dh', dc' (dc' None for
    zero), the gradient of the pre-activation gates (B, 4, H) in dh's dtype
    and of c in c's dtype.  c' is recomputed from the gates and c."""
    ct = gates.dtype
    ig, fg, gg, og = gates.unbind(1)
    cp = c.to(ct)
    tc = torch.tanh(fg * cp + ig * gg)
    dhn = dh.to(ct)
    dct = dhn * og * (1.0 - tc * tc)
    if dc is not None:
        dct = dc.to(ct) + dct
    dgates = torch.stack([dct * gg * ig * (1.0 - ig), dct * cp * fg * (1.0 - fg),
                          dct * ig * (1.0 - gg * gg), dhn * tc * og * (1.0 - og)], dim=1)
    return dgates.to(dh.dtype), (dct * fg).to(c.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def lstm_cell_fwd(x, h, c, wx, wh, b, *, want_gates: bool = False, h_out=None,
                  c_out=None, gates_out=None):
    """One LSTM step.  Returns (h', c', gates): gates are the activated gates
    (B, 4, H) in f32 when ``want_gates`` or ``gates_out`` is given (what the
    backward needs), else None.  ``h_out``/``c_out`` are optional (B, H)
    tensors (unit column stride) and ``gates_out`` an optional contiguous
    (B, 4, H) tensor that receive the results.

    On CUDA: x, h, c and the weights share one dtype (f32 or bf16), b is f32,
    the weights are contiguous (d, 4, H), and x, h, c may be row views."""
    bsz, hh = c.shape
    d_in, d_h = x.shape[1], h.shape[1]
    if x.shape[0] != bsz or h.shape[0] != bsz or tuple(wx.shape) != (d_in, 4, hh) \
            or tuple(wh.shape) != (d_h, 4, hh) or tuple(b.shape) != (4, hh):
        raise ValueError(f"lstm_cell: shapes x {tuple(x.shape)}, h {tuple(h.shape)}, "
                         f"c {tuple(c.shape)}, wx {tuple(wx.shape)}, wh {tuple(wh.shape)}, "
                         f"b {tuple(b.shape)} do not fit (B, d_in), (B, d_h), (B, H), "
                         f"(d_in, 4, H), (d_h, 4, H), (4, H)")
    want_gates = want_gates or gates_out is not None
    if _on_cpu(x, h, c, wx, wh, b, h_out, c_out, gates_out):
        hn, cn, *g = lstm_cell_plain(x, h, c, wx, wh, b, with_gates=want_gates)
        if h_out is not None:
            hn = h_out.copy_(hn)
        if c_out is not None:
            cn = c_out.copy_(cn)
        if gates_out is not None:
            g[0] = gates_out.copy_(g[0])
        return hn, cn, (g[0] if want_gates else None)
    _require_cuda("lstm_cell", x, h, c, wx, wh, b, h_out, c_out, gates_out)
    dt = x.dtype
    if dt not in _DTYPE_CODE or not (h.dtype == c.dtype == wx.dtype == wh.dtype == dt):
        raise TypeError(f"lstm_cell takes x, h, c, wx, wh of one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {h.dtype}, {c.dtype}, {wx.dtype}, "
                        f"{wh.dtype}")
    if b.dtype != torch.float32 or not b.is_contiguous():
        raise TypeError(f"lstm_cell takes a contiguous float32 bias, got {b.dtype}")
    if not (wx.is_contiguous() and wh.is_contiguous()):
        raise ValueError("lstm_cell takes contiguous (d, 4, H) weights")
    if min(bsz, d_in, d_h, hh) < 1 or -(-bsz // _ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"lstm_cell: batch {bsz} is empty or exceeds the launch grid")
    for name, t, d in (("x", x, d_in), ("h", h, d_h), ("c", c, hh)):
        _require_rows(f"lstm_cell {name}", t, (bsz, d), dt)
    if h_out is None:
        h_out = torch.empty((bsz, hh), dtype=dt, device=x.device)
    if c_out is None:
        c_out = torch.empty((bsz, hh), dtype=dt, device=x.device)
    _require_rows("lstm_cell h_out", h_out, (bsz, hh), dt)
    _require_rows("lstm_cell c_out", c_out, (bsz, hh), dt)
    gates = gates_out
    if gates is None and want_gates:
        gates = torch.empty((bsz, 4, hh), dtype=torch.float32, device=x.device)
    if gates is not None and (tuple(gates.shape) != (bsz, 4, hh) or not gates.is_contiguous()
                              or gates.dtype != torch.float32):
        raise ValueError(f"lstm_cell gates_out: expected contiguous ({bsz}, 4, {hh}) "
                         f"float32, got {tuple(gates.shape)} {gates.dtype}")
    fn = _entries.get("fwd") or _bind()["fwd"]
    with torch.cuda.device(x.device):   # the kernel launches on the current device
        err = fn(x.data_ptr(), x.stride(0), h.data_ptr(), h.stride(0), c.data_ptr(),
                 c.stride(0), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
                 h_out.data_ptr(), h_out.stride(0), c_out.data_ptr(), c_out.stride(0),
                 gates.data_ptr() if gates is not None else None, _DTYPE_CODE[dt],
                 bsz, d_in, d_h, hh, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell_fwd kernel launch failed: CUDA error {err}")
    lstm_cell_fwd.launches += 1
    return h_out, c_out, gates


lstm_cell_fwd.launches = 0


def lstm_cell_bwd_pointwise(gates, c, dh, dc=None, *, dgates_out=None):
    """Pointwise backward of one step: (dgates (B, 4, H) in dh's dtype,
    dc_prev (B, H) in c's dtype) from the forward's gates (B, 4, H), the
    step's input c and the gradients dh', dc' (dc' None for zero).
    ``dgates_out``, a contiguous (B, 4, H) tensor, receives dgates if given.

    On CUDA: gates f32, c, dh, dc of one dtype (f32 or bf16), all
    contiguous."""
    bsz, hh = c.shape
    if tuple(gates.shape) != (bsz, 4, hh) or tuple(dh.shape) != (bsz, hh) \
            or (dc is not None and tuple(dc.shape) != (bsz, hh)):
        raise ValueError(f"lstm_cell backward: gates {tuple(gates.shape)}, c "
                         f"{tuple(c.shape)}, dh {tuple(dh.shape)} do not fit "
                         f"(B, 4, H), (B, H), (B, H)")
    if _on_cpu(gates, c, dh, dc, dgates_out):
        dgates, dc_prev = lstm_cell_bwd_pointwise_plain(gates, c, dh, dc)
        if dgates_out is not None:
            dgates = dgates_out.copy_(dgates)
        return dgates, dc_prev
    _require_cuda("lstm_cell backward", gates, c, dh, dc, dgates_out)
    dt = c.dtype
    if dt not in _DTYPE_CODE or dh.dtype != dt or (dc is not None and dc.dtype != dt) \
            or gates.dtype != torch.float32:
        raise TypeError(f"lstm_cell backward takes f32 gates and c, dh, dc of one "
                        f"dtype, float32 or bfloat16; got {gates.dtype}, {c.dtype}, "
                        f"{dh.dtype}, {None if dc is None else dc.dtype}")
    if not all(t is None or t.is_contiguous() for t in (gates, c, dh, dc)):
        raise ValueError("lstm_cell backward takes contiguous tensors")
    dgates = dgates_out
    if dgates is None:
        dgates = torch.empty((bsz, 4, hh), dtype=dt, device=c.device)
    elif tuple(dgates.shape) != (bsz, 4, hh) or dgates.dtype != dt \
            or not dgates.is_contiguous():
        raise ValueError(f"lstm_cell backward dgates_out: expected contiguous "
                         f"({bsz}, 4, {hh}) {dt}, got {tuple(dgates.shape)} {dgates.dtype}")
    dc_prev = torch.empty((bsz, hh), dtype=dt, device=c.device)
    fn = _entries.get("bwd") or _bind()["bwd"]
    with torch.cuda.device(c.device):
        err = fn(gates.data_ptr(), c.data_ptr(), dh.data_ptr(),
                 dc.data_ptr() if dc is not None else None, dgates.data_ptr(),
                 dc_prev.data_ptr(), _DTYPE_CODE[dt], bsz, hh,
                 torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_cell_bwd_pointwise kernel launch failed: CUDA error {err}")
    lstm_cell_bwd_pointwise.launches += 1
    return dgates, dc_prev


lstm_cell_bwd_pointwise.launches = 0

_entries: dict = {}   # the bound C entry points, once the library is built and loaded


def _bind():
    lib = build.load("lstm_cell")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fwd = lib.repro_lstm_cell_fwd
    fwd.restype = i32
    fwd.argtypes = [vp, i64, vp, i64, vp, i64, vp, vp, vp, vp, i64, vp, i64, vp,
                    i32, i32, i32, i32, i32, vp]
    bwd = lib.repro_lstm_cell_bwd_pointwise
    bwd.restype = i32
    bwd.argtypes = [vp] * 6 + [i32, i32, i32, vp]
    _entries.update(fwd=fwd, bwd=bwd)
    return _entries


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def weight_grads(x, h, dgates, b_dtype):
    """dWx = xᵀ·dgates, dWh = hᵀ·dgates, db = Σ dgates over the rows, for
    (N, d) inputs and (N, 4, H) gate gradients (N rows: one step's batch, or
    every step of a layer at once).  Plain GEMMs, as JAX's AD leaves them."""
    n, _, hh = dgates.shape
    dg2 = dgates.reshape(n, 4 * hh)
    dwx = (x.t() @ dg2).view(x.shape[1], 4, hh)
    dwh = (h.t() @ dg2).view(h.shape[1], 4, hh)
    db = dg2.to(compute_dtype(dg2.dtype)).sum(0).view(4, hh).to(b_dtype)
    return dwx, dwh, db


class LSTMCellFunction(torch.autograd.Function):
    """One differentiable LSTM step: the forward kernel (writing its gates),
    then in the backward the pointwise kernel and the plain products
    dx = dgates·Wxᵀ, dh = dgates·Whᵀ, dWx, dWh, db."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.set_materialize_grads(False)    # an unused output's gradient stays None
        hn, cn, gates = lstm_cell_fwd(x, h, c, wx, wh, b, want_gates=True)
        ctx.save_for_backward(x, h, c, wx, wh, gates)
        ctx.b_dtype = b.dtype
        return hn, cn

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhn, dcn):
        x, h, c, wx, wh, gates = ctx.saved_tensors
        if dhn is None:
            dhn = torch.zeros(c.shape, dtype=x.dtype, device=c.device)
        dgates, dc = lstm_cell_bwd_pointwise(gates, c, dhn.contiguous(),
                                             None if dcn is None else dcn.contiguous())
        dg2 = dgates.view(c.shape[0], -1)
        dx = dg2 @ wx.reshape(wx.shape[0], -1).t()
        dh = dg2 @ wh.reshape(wh.shape[0], -1).t()
        dwx, dwh, db = weight_grads(x, h, dgates, ctx.b_dtype)
        return dx, dh, dc, dwx, dwh, db


def lstm_cell(x, h, c, wx, wh, b):
    """x: (B, d_in); h: (B, d_h); c: (B, H); wx: (d_in, 4, H); wh: (d_h, 4, H);
    b: (4, H).  Returns (h' (B, H), c' (B, H)), differentiable.  Without
    autograd the forward kernel writes no gates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, h, c, wx, wh, b)):
        return LSTMCellFunction.apply(x, h, c, wx, wh, b)
    hn, cn, _ = lstm_cell_fwd(x, h, c, wx, wh, b)
    return hn, cn
