"""Grouped matmul: wrapper of the CUDA kernel ``csrc/moe_gmm.cu`` (the port of
``repro/kernels/moe_gmm.py:_gmm_kernel``).

``gmm(x, w)`` keeps the JAX signature: x (G, C, d) @ w (G, d, F) ->
(G, C, F), the f32 sum over d rounded once to x's dtype.  Nothing is padded:
any C, d and F.  On CUDA tensors it launches the kernel (or raises); on CPU
tensors it takes the plain version ``ref.gmm_ref``.  There is no switch that
puts the plain version on a CUDA tensor.

The kernel has three variants (``VARIANTS``), each a hand-written kernel,
chosen here by ``gmm_variant`` from the inputs alone: bf16 inputs with d and
F multiples of 8 and 16-byte aligned bases run on the tensor cores, in the
decode tile when C <= 16, else in the prefill tile; f32 and other bf16
inputs run the FMA kernel.  ``gmm.launches`` counts every launch and
``gmm.variant_launches`` each variant's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gmm_ref

MOE_TRAIN = "ROADMAP.md Queue 1 item 14 (MoE training on the card: a gmm backward)"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("fma", "tc_prefill", "tc_decode")   # the C entry's variant codes 0, 1, 2
DECODE_ROWS = 16     # C up to which the decode tile (one m16 tile of rows) runs


def gmm_variant(x, w) -> str:
    """The kernel variant ``gmm`` launches for contiguous x (G, C, d) and w
    (G, d, F): bf16 with d and F multiples of 8 (16-byte rows) and 16-byte
    aligned bases run on the tensor cores, in the decode tile when C <= 16,
    else in the prefill tile; everything else runs the FMA kernel."""
    g, c, d = x.shape
    f = w.shape[2]
    if not (x.dtype == w.dtype == torch.bfloat16) or d % 8 or f % 8 \
            or x.data_ptr() % 16 or w.data_ptr() % 16:
        return "fma"
    return "tc_decode" if c <= DECODE_ROWS else "tc_prefill"


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
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(f"the gmm backward kernel is not ported yet ({MOE_TRAIN})")
    return _launch(x, w, gmm_variant(x, w))


def _launch(x, w, variant: str):
    """Launch ``variant`` of the kernel on CUDA x, w that ``gmm`` has
    checked; a tensor-core variant needs what ``gmm_variant`` asks of it."""
    g, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((g, c, f), dtype=x.dtype, device=x.device)
    fn = _entry or _bind()
    with torch.cuda.device(x.device):   # the kernel launches on the current device
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
                 g, c, d, f, VARIANTS.index(variant),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed ({variant}): CUDA error {err}")
    gmm.launches += 1
    gmm.variant_launches[variant] += 1
    return out


gmm.launches = 0
gmm.variant_launches = dict.fromkeys(VARIANTS, 0)

_entry = None   # the bound C entry point, once the library is built and loaded


def _bind():
    global _entry
    fn = build.load("moe_gmm").repro_gmm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _entry = fn
    return fn
