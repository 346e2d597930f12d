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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import wkv6_ref

RWKV_TRAIN = "ROADMAP.md Queue 1 item 17 (RWKV training on the card: a wkv backward kernel)"
HEAD_DIMS = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError(f"the wkv6 backward kernel is not ported yet ({RWKV_TRAIN})")
    if not (r.is_cuda and all(x.device == r.device for x in tensors)):
        raise ValueError(f"wkv6 needs every tensor on one CUDA device (or all on the "
                         f"CPU); got {sorted({str(x.device) for x in tensors})}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 takes float32 or bfloat16 r, k, v of one dtype; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in tensors[3:]):
        raise TypeError(f"wkv6 takes float32 w, u and state; got "
                        f"{[str(x.dtype) for x in tensors[3:]]}")
    b, t, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6's kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("wkv6's kernel takes contiguous r, k, v, w, u and state")
    out = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device) \
        if state is None else state
    fn = _entry or _bind()
    with torch.cuda.device(r.device):   # the kernel launches on the current device
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 None if state is None else state.data_ptr(), s_out.data_ptr(),
                 out.data_ptr(), _DTYPE_CODE[r.dtype], b, t, h, hd,
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return out, s_out


wkv6.launches = 0

_entry = None   # the bound C entry point, once the library is built and loaded


def _bind():
    global _entry
    fn = build.load("wkv6").repro_wkv6
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    _entry = fn
    return fn
