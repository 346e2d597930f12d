"""Flash attention forward: wrapper of the CUDA kernel ``csrc/flash_attention.cu``
(the port of ``repro/kernels/flash_attention.py:_flash_kernel``).

``flash_attention(q, k, v, causal=, window=)`` keeps the JAX signature and
its (B, T, H, hd) layout, and extends it with grouped-query attention: k and
v may carry Hkv heads with H % Hkv == 0, query head h reading KV head
h // (H / Hkv).  On CUDA tensors it launches the kernel (or raises); on CPU
tensors it takes the plain version ``flash_attention_ref``.  There is no
switch that puts the plain version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version: repeat the KV heads, then the dense f32 oracle."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return attention_ref(q, k, v, causal=causal, window=window)


def _check(q, k, v, window: int) -> None:
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError(f"expected (B, T, H, hd) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, tq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"on batch or head_dim")
    hkv = k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if tq < 1 or k.shape[1] < 1:
        raise ValueError("empty query or key sequence")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Tq, H, hd); k, v: (B, Tk, Hkv, hd), any strides.

    Returns (B, Tq, H, hd) in q's dtype.  Causal masking is aligned top-left
    (query i sees keys j <= i, as the TPU kernel's), so a decode step attends
    with ``causal=False`` over the valid prefix of its cache."""
    _check(q, k, v, window)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"flash_attention needs q, k, v on one CUDA device "
                         f"(or all on the CPU); got {q.device}, {k.device}, "
                         f"{v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, tq, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the flash-attention backward kernel is not ported yet "
            "(ROADMAP.md Queue 1 item 2b, flash-attention backward kernel + "
            "Llama training)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride())
    fn = _entry or _bind()
    with torch.cuda.device(q.device):   # the kernel launches on the current device
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, tq, k.shape[1], h, k.shape[2], hd,
                 strides, int(causal), int(window), 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

_entry = None   # the bound C entry point, once the library is built and loaded


def _bind():
    global _entry
    fn = build.load("flash_attention").repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    _entry = fn
    return fn
