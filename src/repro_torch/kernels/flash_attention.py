"""Flash attention forward: wrapper of the CUDA kernel ``csrc/flash_attention.cu``
(the port of ``repro/kernels/flash_attention.py:_flash_kernel``).

``flash_attention(q, k, v, causal=, window=)`` keeps the JAX signature and
its (B, T, H, hd) layout, and extends it with grouped-query attention: k and
v may carry Hkv heads with H % Hkv == 0, query head h reading KV head
h // (H / Hkv).  On CUDA tensors it launches the kernel (or raises); on CPU
tensors it takes the plain version ``flash_attention_ref``.  There is no
switch that puts the plain version on a CUDA tensor.

The kernel has three variants (``VARIANTS``), each a hand-written kernel,
chosen here by ``flash_variant`` from the inputs alone: bf16 inputs whose rows
take 16-byte async copies run on the tensor cores, in the prefill tile or,
when the query heads of one KV head times Tq fit in 16 rows, in the packed
decode tile; f32 inputs and other bf16 inputs run the FMA kernel.
``flash_attention.launches`` counts every launch and
``flash_attention.variant_launches`` each variant's.  The decode tile splits
the kv tiles over blocks (``decode_split``) and merges the partial softmax
sums in the same launch; ``combine_partials`` is that merge in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref

HEAD_DIMS = (32, 64, 128)
VARIANTS = ("fma", "tc_prefill", "tc_decode")   # the C entry's variant codes 0, 1, 2
DECODE_ROWS = 16     # rows of the decode tile: (H / Hkv) * Tq query rows packed
KV_TILE = 64         # keys per kv tile of the tensor-core kernels
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version: repeat the KV heads, then the dense f32 oracle."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return attention_ref(q, k, v, causal=causal, window=window)


def combine_partials(m, l, acc):
    """Merge partial softmax sums over disjoint key ranges, as the decode
    tile's last block does.  m, l: (S, ...) each split's row max of the
    scaled, masked scores and its sum of exp(s - m); acc: (S, ..., hd) its
    sum of exp(s - m) v.  Returns sum_s e^(m_s - M) acc_s / max(sum_s
    e^(m_s - M) l_s, 1e-30), M the max over splits."""
    top = m.max(0).values
    f = torch.exp(m - top)
    lsum = (f * l).sum(0)
    return (f[..., None] * acc).sum(0) / lsum.clamp(min=1e-30)[..., None]


def attention_partials(q, k, v, bounds, *, causal: bool = True, window: int = 0):
    """Plain version of the decode tile's per-block work: for each key range
    [lo, hi) of ``bounds``, (m, l, acc) of q against those keys (grouped
    heads repeated), in f32, with the kernel's masks (-1e30 after scaling).
    Returns m, l: (S, B, Tq, H) and acc: (S, B, Tq, H, hd)."""
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2).float()
    v = torch.repeat_interleave(v, rep, dim=2).float()
    tq, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k) / math.sqrt(hd)
    qpos = torch.arange(tq)[:, None, None]        # (Tq, 1, Tk) against (B, Tq, H, Tk)
    kpos = torch.arange(k.shape[1])[None, None, :]
    keep = torch.ones((tq, 1, k.shape[1]), dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    ms, ls, accs = [], [], []
    for lo, hi in bounds:
        part = s[..., lo:hi]
        m = part.max(-1).values
        p = torch.exp(part - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bqhk,bkhd->bqhd", p, v[:, lo:hi]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def _rows_take_async_copies(t) -> bool:
    """Every (b, t, h) row of ``t`` starts 16 bytes aligned and its hd
    elements are contiguous: d-stride 1, the other strides of dims longer
    than 1 multiples of 8 elements (16 bytes of bf16), the base aligned."""
    if t.stride(3) != 1 or t.data_ptr() % 16:
        return False
    return all(t.stride(i) % 8 == 0 for i in range(3) if t.shape[i] > 1)


def flash_variant(q, k, v) -> str:
    """The kernel variant ``flash_attention`` launches for these inputs:
    bf16 q, k, v whose rows take 16-byte async copies run on the tensor
    cores, in the packed decode tile when (H / Hkv) * Tq <= 16 query rows
    fit in one m16 tile, else in the prefill tile; everything else (f32, a
    d-stride other than 1, a misaligned row) runs the FMA kernel."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or \
            not all(_rows_take_async_copies(t) for t in (q, k, v)):
        return "fma"
    rep = q.shape[2] // k.shape[2]
    return "tc_decode" if rep * q.shape[1] <= DECODE_ROWS else "tc_prefill"


def decode_split(b: int, hkv: int, n_tiles: int, n_sm: int):
    """(n_split, tiles_per_split) of the decode tile: the n_tiles kv tiles
    of each (b, hkv) cut into runs of equal length so that about one block
    an SM is launched, and no run is empty.  (At Llama's and Granite's
    decode, B 4 x Hkv 8 over 9 tiles, that is 5 runs of 2 tiles, which ran
    faster on the H100 than 9 runs of 1 or 1 run of 9.)"""
    want = max(1, -(-n_sm // (b * hkv)))
    per = -(-n_tiles // min(n_tiles, want))
    return -(-n_tiles // per), per


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
    tk, hkv = k.shape[1], k.shape[2]
    variant = flash_variant(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride())
    n_split, per, ws, counters = 1, 1, None, None
    with torch.cuda.device(q.device):   # the kernel launches on the current device
        stream = torch.cuda.current_stream(q.device)
        if variant == "tc_decode":
            kv_end = min(tk, tq) if causal else tk
            n_tiles = -(-kv_end // KV_TILE)
            n_split, per = decode_split(b, hkv, n_tiles, _sm_count(q.device))
            if n_split > 1:
                ws = torch.empty(b * hkv * n_split * DECODE_ROWS * (hd + 2),
                                 dtype=torch.float32, device=q.device)
                counters = _split_counters(q.device, stream, b * hkv)
        fn = _entry or _bind()
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, tq, tk, h, hkv, hd, strides, int(causal),
                 int(window), 1.0 / math.sqrt(hd), VARIANTS.index(variant), n_split, per,
                 None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({variant}): "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)

_entry = None   # the bound C entry point, once the library is built and loaded
# (device index, stream) -> int32 arrival counts of the split decode tile:
# zeroed once, and set back to 0 by the kernel's last block of each (b, hkv)
_counters = {}


_sms = {}   # device index -> multiprocessor count


def _sm_count(device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _split_counters(device, stream, n: int):
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _bind():
    global _entry
    fn = build.load("flash_attention").repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    _entry = fn
    return fn
