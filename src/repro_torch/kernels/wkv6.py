"""RWKV6 WKV recurrence: wrapper of the CUDA kernel ``csrc/wkv6.cu`` (the
port of ``repro/kernels/rwkv_scan.py:_wkv_kernel``).

``wkv6(r, k, v, w, u, state=None) -> (out, state)``: r, k, v (B, T, H, hd)
of one dtype, w (B, T, H, hd) and u (H, hd) -> out (B, T, H, hd) f32 and the
final state (B, H, hd, hd) f32, laid out S[key_dim, value_dim].  Any T >= 1.
Unlike the TPU kernel it starts from a state and returns the final one:
when ``state`` is given it is read as the initial state and overwritten
with the final one (the decode cache's layer view), and that same tensor is
returned; when it is None the recurrence starts from zeros and a new tensor
is returned.  On CUDA tensors it launches the kernel (or raises); on CPU
tensors it takes the plain version ``ref.wkv6_ref``, with the same in-place
state write.  There is no switch that puts the plain version on a CUDA
tensor.

The kernel has two variants (``VARIANTS``), each a hand-written kernel,
chosen here by ``wkv_variant`` from the inputs alone: a prompt of at least
``CHUNKED_MIN_T`` tokens with 16-byte aligned r, k, v and w runs the chunked
form on the tensor cores (``chunked``; its plain twin is
``ref.wkv6_chunked_plain``), a decode step and short prompts the sequential
scan (``scan``).  ``wkv6.launches`` counts every launch and
``wkv6.variant_launches`` each variant's.

On CUDA tensors that need a gradient ``wkv6`` runs ``WKV6Function`` from a
zero state (training; a given state under autograd raises, and the final
state is not differentiable): the forward kernel, then ``wkv6_bwd``, the
backward kernels of the same source (one count in ``wkv6_bwd.launches`` a
call, three kernels), whose plain twin is ``ref.wkv6_bwd_plain``.  On CPU
tensors autograd runs through ``ref.wkv6_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import wkv6_bwd_plain, wkv6_ref

HEAD_DIMS = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("scan", "chunked")   # the C entry's variant codes 0, 1
CHUNKED_MIN_T = 16               # tokens from which the chunked form runs: one sub-chunk


def wkv_variant(r, k, v, w) -> str:
    """The kernel variant ``wkv6`` launches for contiguous r, k, v, w (B, T,
    H, hd): T >= ``CHUNKED_MIN_T`` with every base 16-byte aligned runs the
    chunked form on the tensor cores; a decode step, short T and misaligned
    bases run the sequential scan."""
    if r.shape[1] < CHUNKED_MIN_T or any(x.data_ptr() % 16 for x in (r, k, v, w)):
        return "scan"
    return "chunked"


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4:
        raise ValueError(f"expected r, k, v, w of shape (B, T, H, hd), got r {tuple(r.shape)}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} differs from r {tuple(r.shape)}")
    b, t, h, hd = r.shape
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u {tuple(u.shape)} is not (H, hd) = {(h, hd)}")
    if state is not None and tuple(state.shape) != (b, h, hd, hd):
        raise ValueError(f"state {tuple(state.shape)} is not (B, H, hd, hd) = "
                         f"{(b, h, hd, hd)}")
    if min(b, t, h, hd) < 1:
        raise ValueError(f"empty WKV recurrence: r {tuple(r.shape)}")


def wkv6(r, k, v, w, u, state=None):
    """r, k, v: (B, T, H, hd), f32 or bf16; w: (B, T, H, hd) f32; u: (H, hd)
    f32; ``state``: (B, H, hd, hd) f32 or None; all contiguous.  Returns
    (out (B, T, H, hd) f32, final state)."""
    _check(r, k, v, w, u, state)
    tensors = (r, k, v, w, u) if state is None else (r, k, v, w, u, state)
    if all(x.device.type == "cpu" for x in tensors):
        out, s = wkv6_ref(r, k, v, w, u, state)
        if state is None:
            return out, s
        state.copy_(s)
        return out, state
    _check_cuda(r, k, v, tensors)
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        if state is not None:
            raise NotImplementedError("wkv6 differentiates from a zero initial state only "
                                      "(training); a given state is a decode cache's, "
                                      "which takes no gradient")
        return WKV6Function.apply(r, k, v, w, u)
    return _launch(r, k, v, w, u, state, wkv_variant(r, k, v, w))


def _check_cuda(r, k, v, tensors) -> None:
    if not (r.is_cuda and all(x.device == r.device for x in tensors)):
        raise ValueError(f"wkv6 needs every tensor on one CUDA device (or all on the "
                         f"CPU); got {sorted({str(x.device) for x in tensors})}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 takes float32 or bfloat16 r, k, v of one dtype; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in tensors[3:]):
        raise TypeError(f"wkv6 takes float32 w, u and state; got "
                        f"{[str(x.dtype) for x in tensors[3:]]}")
    hd = r.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6's kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("wkv6's kernels take contiguous tensors")


class WKV6Function(torch.autograd.Function):
    """The WKV recurrence from a zero state with its gradient on the card:
    the forward kernel, then the backward kernels; the final state is
    returned but not differentiable."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        out, state = _launch(r, k, v, w, u, None, wkv_variant(r, k, v, w))
        ctx.save_for_backward(r, k, v, w, u)
        ctx.mark_non_differentiable(state)
        return out, state

    @staticmethod
    def backward(ctx, dout, _dstate):
        r, k, v, w, u = ctx.saved_tensors
        if not dout.is_contiguous():
            dout = dout.contiguous()
            wkv6_bwd.dout_copies += 1
        return wkv6_bwd(r, k, v, w, u, dout)


def wkv6_bwd(r, k, v, w, u, dout):
    """Gradients of ``wkv6(r, k, v, w, u)[0]`` from a zero state (the final
    state unused) for the output gradient ``dout`` (B, T, H, hd) f32: (dr,
    dk, dv) in r's dtype, dw (B, T, H, hd) and du (H, hd) in f32.  On CUDA
    tensors it launches the backward kernels (or raises); on CPU tensors it
    takes the plain version ``ref.wkv6_bwd_plain``.  Scratch on the card:
    the bytes the C entry asks for (``repro_wkv6_bwd_workspace``), mostly
    the state at every chunk start, (B H) x (ceil(T / 64) - 1) x hd^2 f32
    (130 MB at B 4 x T 2048 x H 64 x hd 64)."""
    _check(r, k, v, w, u, None)
    if dout.shape != r.shape:
        raise ValueError(f"dout {tuple(dout.shape)} differs from r {tuple(r.shape)}")
    tensors = (r, k, v, w, u, dout)
    if all(x.device.type == "cpu" for x in tensors):
        return wkv6_bwd_plain(*tensors)
    _check_cuda(r, k, v, tensors)
    b, t, h, hd = r.shape
    dev = r.device
    dr, dk, dv = (torch.empty(r.shape, dtype=r.dtype, device=dev) for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=dev)
    du = torch.empty((h, hd), dtype=torch.float32, device=dev)
    fn, size_fn = _bwd_entry or _bind_bwd()
    n_bytes = size_fn(b, t, h, hd)   # the layout is the C entry's own
    workspace = torch.empty((n_bytes,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = fn(*(x.data_ptr() for x in (r, k, v, w, u, dout, dr, dk, dv, dw, du, workspace)),
                 n_bytes, _DTYPE_CODE[r.dtype], b, t, h, hd,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward launch failed: CUDA error {err}")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du


def _launch(r, k, v, w, u, state, variant: str):
    """Launch ``variant`` of the kernel on CUDA tensors that ``wkv6`` has
    checked; ``chunked`` needs what ``wkv_variant`` asks of it."""
    b, t, h, hd = r.shape
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device) \
        if state is None else state
    fn = _entry or _bind()
    with torch.cuda.device(r.device):   # the kernel launches on the current device
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 None if state is None else state.data_ptr(), s_out.data_ptr(),
                 out.data_ptr(), _DTYPE_CODE[r.dtype], b, t, h, hd, VARIANTS.index(variant),
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed ({variant}): CUDA error {err}")
    wkv6.launches += 1
    wkv6.variant_launches[variant] += 1
    return out, s_out


wkv6.launches = 0
wkv6.variant_launches = dict.fromkeys(VARIANTS, 0)
wkv6_bwd.launches = 0
wkv6_bwd.dout_copies = 0   # output gradients autograd handed over non-contiguous

_entry = None   # the bound C entry points, once the library is built and loaded
_bwd_entry = None   # (the backward, its workspace size)


def _bind():
    global _entry
    fn = build.load("wkv6").repro_wkv6
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _entry = fn
    return fn


def _bind_bwd():
    global _bwd_entry
    lib = build.load("wkv6")
    fn, size_fn = lib.repro_wkv6_bwd, lib.repro_wkv6_bwd_workspace
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    size_fn.restype = ctypes.c_longlong
    size_fn.argtypes = [ctypes.c_int] * 4
    _bwd_entry = fn, size_fn
    return _bwd_entry
