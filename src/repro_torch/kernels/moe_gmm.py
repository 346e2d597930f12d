"""Grouped matmul: wrapper of the CUDA kernel ``csrc/moe_gmm.cu`` (the port of
``repro/kernels/moe_gmm.py:_gmm_kernel``).

``gmm(x, w)`` keeps the JAX signature: x (G, C, d) @ w (G, d, F) ->
(G, C, F), the f32 sum over d rounded once to x's dtype.  Nothing is padded:
any C, d and F.  On CUDA tensors it launches the kernel (or raises); on CPU
tensors it takes the plain version ``ref.gmm_ref``.  There is no switch that
puts the plain version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gmm_ref

MOE_TRAIN = "ROADMAP.md Queue 1 item 14 (MoE training on the card: a gmm backward)"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, w) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected x (G, C, d) and w (G, d, F), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} disagree on the "
                         f"group count or the contraction")
    if min(*x.shape, w.shape[2]) < 1:
        raise ValueError(f"empty grouped matmul: x {tuple(x.shape)}, w {tuple(w.shape)}")


def gmm(x, w):
    """x: (G, C, d); w: (G, d, F), contiguous, of one dtype -> (G, C, F)."""
    _check(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return gmm_ref(x, w)
    if not (x.is_cuda and x.device == w.device):
        raise ValueError(f"gmm needs x and w on one CUDA device (or both on the "
                         f"CPU); got {x.device}, {w.device}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gmm takes float32 or bfloat16 x and w of one dtype; got "
                        f"{x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm's kernel takes contiguous x and w")
    g, c, d = x.shape
    f = w.shape[2]
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(f"the gmm backward kernel is not ported yet ({MOE_TRAIN})")
    out = torch.empty((g, c, f), dtype=x.dtype, device=x.device)
    fn = _entry or _bind()
    with torch.cuda.device(x.device):   # the kernel launches on the current device
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
                 g, c, d, f, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {err}")
    gmm.launches += 1
    return out


gmm.launches = 0

_entry = None   # the bound C entry point, once the library is built and loaded


def _bind():
    global _entry
    fn = build.load("moe_gmm").repro_gmm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    _entry = fn
    return fn
