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

On CUDA tensors that need a gradient ``gmm`` runs ``GmmFunction``: the
forward kernel, then ``gmm_bwd``, whose two products dx = dy w^T and dw =
x^T dy are kernels of the same source reading dy, w and x in their stored
layouts (no transposed copy), each counted in ``gmm_bwd.launches`` and
``gmm_bwd.variant_launches`` (``tc_dx``, ``tc_dw`` on the wgmma tile for
the inputs the forward's tensor-core tiles take, ``fma_dx``, ``fma_dw``
else); its plain twin is ``ref.gmm_bwd_plain``.  On CPU tensors autograd
runs through ``ref.gmm_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gmm_bwd_plain, gmm_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("fma", "tc_prefill", "tc_decode")   # the C entry's variant codes 0, 1, 2
BWD_VARIANTS = ("fma_dx", "fma_dw", "tc_dx", "tc_dw")   # a count per product launch
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
        return GmmFunction.apply(x, w)
    return _launch(x, w, gmm_variant(x, w))


class GmmFunction(torch.autograd.Function):
    """The grouped matmul with its gradient on the card: the forward kernel,
    then the backward kernels for the products autograd asks for."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _launch(x, w, gmm_variant(x, w))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if not dy.is_contiguous():
            dy = dy.contiguous()
            gmm_bwd.dy_copies += 1
        return gmm_bwd(x, w, dy, need_dx=ctx.needs_input_grad[0],
                       need_dw=ctx.needs_input_grad[1])


def gmm_bwd_variant(x, w, dy) -> str:
    """The backward kernel ``gmm_bwd`` launches: ``tc`` (the wgmma tile, for
    both products) for bf16 with d and F multiples of 8 and 16-byte aligned
    x, w and dy, the inputs whose rows the forward's tensor-core tiles copy
    16 bytes at a time; ``fma`` for everything else."""
    d, f = x.shape[2], w.shape[2]
    if not (x.dtype == w.dtype == dy.dtype == torch.bfloat16) or d % 8 or f % 8 \
            or any(t.data_ptr() % 16 for t in (x, w, dy)):
        return "fma"
    return "tc"


def gmm_bwd(x, w, dy, *, need_dx: bool = True, need_dw: bool = True):
    """Gradients of ``gmm(x, w)`` for the output gradient dy (G, C, F), all
    contiguous and of one dtype: (dx = dy w^T (G, C, d), dw = x^T dy (G, d,
    F)) in that dtype, each summed in f32 and rounded once; None for a
    product not asked for.  On CUDA tensors it launches one kernel a product
    (or raises); on CPU tensors it takes the plain version
    ``ref.gmm_bwd_plain``."""
    _check(x, w)
    g, c, _ = x.shape
    if tuple(dy.shape) != (g, c, w.shape[2]):
        raise ValueError(f"dy {tuple(dy.shape)} is not gmm's output shape "
                         f"{(g, c, w.shape[2])}")
    if all(t.device.type == "cpu" for t in (x, w, dy)):
        return gmm_bwd_plain(x, w, dy, need_dx=need_dx, need_dw=need_dw)
    if not (x.is_cuda and x.device == w.device == dy.device):
        raise ValueError(f"gmm_bwd needs x, w and dy on one CUDA device (or all on the "
                         f"CPU); got {x.device}, {w.device}, {dy.device}")
    if not (x.dtype == w.dtype == dy.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gmm_bwd takes float32 or bfloat16 x, w and dy of one dtype; got "
                        f"{x.dtype}, {w.dtype}, {dy.dtype}")
    if not all(t.is_contiguous() for t in (x, w, dy)):
        raise ValueError("gmm_bwd's kernels take contiguous x, w and dy")
    return _launch_bwd(x, w, dy, gmm_bwd_variant(x, w, dy), need_dx, need_dw)


def _launch_bwd(x, w, dy, variant: str, need_dx: bool = True, need_dw: bool = True):
    """Launch ``variant`` (``tc`` or ``fma``) of the backward for each product
    asked for, on CUDA tensors that ``gmm_bwd`` has checked; ``tc`` needs
    what ``gmm_bwd_variant`` asks of it."""
    g, c, d = x.shape
    f = w.shape[2]
    fn = _bwd_entry or _bind_bwd()
    grads = []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for which, (name, need, shape) in enumerate((("dx", need_dx, (g, c, d)),
                                                     ("dw", need_dw, (g, d, f)))):
            if not need:
                grads.append(None)
                continue
            out = torch.empty(shape, dtype=x.dtype, device=x.device)
            err = fn(x.data_ptr(), w.data_ptr(), dy.data_ptr(), out.data_ptr(),
                     _DTYPE_CODE[x.dtype], g, c, d, f, which, ("fma", "tc").index(variant),
                     stream)
            if err != 0:
                raise RuntimeError(f"gmm backward launch failed ({variant}, {name}): "
                                   f"CUDA error {err}")
            gmm_bwd.launches += 1
            gmm_bwd.variant_launches[f"{variant}_{name}"] += 1
            grads.append(out)
    return tuple(grads)


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
gmm_bwd.launches = 0
gmm_bwd.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)
gmm_bwd.dy_copies = 0   # output gradients autograd handed over non-contiguous

_entry = None   # the bound C entry points, once the library is built and loaded
_bwd_entry = None


def _bind():
    global _entry
    fn = build.load("moe_gmm").repro_gmm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _entry = fn
    return fn


def _bind_bwd():
    global _bwd_entry
    fn = build.load("moe_gmm").repro_gmm_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    _bwd_entry = fn
    return fn
