"""Flash attention: wrappers of the CUDA kernels of ``csrc/flash_attention.cu``,
the forward (the port of ``repro/kernels/flash_attention.py:_flash_kernel``)
and its backward (no TPU kernel: JAX differentiates
``repro/models/layers.py:attention``).

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

Under autograd (CUDA tensors that need a gradient) ``flash_attention`` runs
``FlashAttentionFunction``: its forward launches the kernel with the rows'
log-sum-exp (never on the decode tile), its backward ``flash_attention_bwd``,
which launches the backward kernels (``BWD_VARIANTS``: bf16 rows that take
16-byte copies on the tensor cores, the rest on FMA kernels) and counts one
launch a call in ``flash_attention_bwd.launches`` and
``.variant_launches``.  Their plain versions are ``flash_attention_lse_plain``
and ``flash_attention_bwd_plain``.  On CPU tensors autograd runs through
``flash_attention_ref``.  ``flash_attention_lse`` is that forward alone,
returning the output and lse (the hop of the context ring).

``kv_lens`` (B,) int32 gives each row its own key length, for serving from
a slotted cache: row b attends to keys [0, kv_lens[b]) with its queries at
the last Tq of those positions (causal aligned bottom-right, the window
counted from there).  Every variant reads the lengths on the device; the
decode tile's split is still planned from the static Tk, so a row's bits do
not depend on the other rows' lengths.  It has no backward
(``SERVING_REST``).

``q_start`` places the queries explicitly: query i of row b sits at
q_start[b] + i (a (B,) int32 tensor on q's device, read there, or one host
int for every row, as a hop of the windowed context ring passes), key t is
kept iff t < kv_lens[b] (Tk without kv_lens), then t <= qpos when causal,
then t > qpos - window.  The two alignments above are q_start = 0 and
q_start = kv_lens - Tq.  A row may then see no key at all (the cache partial
of a slot at position 0, a past block wholly left of the window): it
returns 0 and lse -inf, never NaN, so ``parallel.context.merge_attention``
weighs it by 0.  The backward takes the host int (``flash_attention_bwd``),
where such a row has P = 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref, keep_mask

HEAD_DIMS = (32, 64, 128)
VARIANTS = ("fma", "tc_prefill", "tc_decode")   # the C entry's variant codes 0, 1, 2
BWD_VARIANTS = ("fma", "tc")                    # the backward entry's codes 0, 1
DECODE_ROWS = 16     # rows of the decode tile: (H / Hkv) * Tq query rows packed
KV_TILE = 64         # keys per kv tile of the tensor-core kernels
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SERVING_REST = "ROADMAP.md Queue 1 item 3b (the flash backward with kv_lens)"


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, kv_lens=None,
                        q_start=None):
    """Plain version: repeat the KV heads, then the dense f32 oracle (with
    ``kv_lens``, each row's slot-mode mask; with ``q_start``, the queries
    placed there and a row that sees no key 0)."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return attention_ref(q, k, v, causal=causal, window=window, kv_lens=kv_lens,
                         q_start=q_start)


def _scores(q, k, causal: bool, window: int, kv_lens=None, q_start=None):
    """Scaled scores (B, H, Tq, Tk) in f32 over repeated KV heads, masked to
    the finite -1e30, and the keep mask ((Tq, Tk), or (B, 1, Tq, Tk) with
    per-row lengths or starts)."""
    rep = q.shape[2] // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(q.shape[-1])
    keep = keep_mask(q.shape[1], k.shape[1], causal, window, q.device, kv_lens, q_start)
    if keep.dim() == 3:
        keep = keep[:, None]
    return torch.where(keep, s, torch.full_like(s, -1e30)), keep


def flash_attention_lse_plain(q, k, *, causal: bool = True, window: int = 0, kv_lens=None,
                              q_start=None):
    """Plain version of the forward's ``lse``: (B, H, Tq) f32, the
    log-sum-exp in natural-log units of each row's scaled, masked scores (a
    row that sees no key has -1e30 + log Tk, which is -1e30 in f32; under a
    ``q_start`` it has -inf)."""
    s, keep = _scores(q, k, causal, window, kv_lens, q_start)
    lse = torch.logsumexp(s, dim=-1)
    if q_start is not None:
        lse = torch.where(keep.any(-1), lse, torch.full_like(lse, -math.inf))
    return lse


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True, window: int = 0,
                              q_start=None):
    """Plain version of the backward kernels, step by step in f32: P =
    exp(S - lse) where the masks keep a pair, 1/Tk on every key of a row that
    sees none (the forward's softmax over the finite -1e30; 0 under a
    ``q_start``, whose forward gives such a row 0), 0 elsewhere;
    D = rowsum(dO o O) from O as stored; dV = P^T dO, dP = dO V^T, dS = P o
    (dP - D) on kept pairs (0 elsewhere), dQ = dS K / sqrt(hd), dK = dS^T Q /
    sqrt(hd), the query heads of each KV head summed.  Returns (dq, dk, dv)
    in q's, k's and v's dtypes."""
    b, tq, h, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    s, keep = _scores(q, k, causal, window, q_start=q_start)
    dead = ~keep.any(-1, keepdim=True)
    if q_start is not None:
        dead = torch.zeros_like(dead)
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.where(dead, 1.0 / tk, 0.0).to(s.dtype))
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)              # (B, H, Tq)
    kr = torch.repeat_interleave(k, rep, dim=2).float()
    vr = torch.repeat_interleave(v, rep, dim=2).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = torch.where(keep, p * (dp - delta[..., None]), torch.zeros_like(p))
    scale = 1.0 / math.sqrt(hd)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dk = dk.view(b, tk, hkv, rep, hd).sum(3)
    dv = dv.view(b, tk, hkv, rep, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    keep = keep_mask(tq, k.shape[1], causal, window, s.device)[:, None, :]   # (Tq, 1, Tk)
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


def flash_variant(q, k, v, *, want_lse: bool = False) -> str:
    """The kernel variant ``flash_attention`` launches for these inputs:
    bf16 q, k, v whose rows take 16-byte async copies run on the tensor
    cores, in the packed decode tile when (H / Hkv) * Tq <= 16 query rows
    fit in one m16 tile and no ``lse`` is wanted, else in the prefill tile;
    everything else (f32, a d-stride other than 1, a misaligned row) runs
    the FMA kernel."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or \
            not all(_rows_take_async_copies(t) for t in (q, k, v)):
        return "fma"
    rep = q.shape[2] // k.shape[2]
    return "tc_decode" if rep * q.shape[1] <= DECODE_ROWS and not want_lse else "tc_prefill"


def flash_bwd_variant(q, k, v, o, do) -> str:
    """The backward kernels ``flash_attention_bwd`` launches: ``tc`` when q,
    k, v, o and dO are bf16 rows that take 16-byte async copies, else
    ``fma``."""
    ts = (q, k, v, o, do)
    if all(t.dtype == torch.bfloat16 for t in ts) and all(map(_rows_take_async_copies, ts)):
        return "tc"
    return "fma"


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


def _check_rows(q, t, name: str) -> None:
    """``t`` must be a contiguous (B,) int32 tensor on q's device (the
    kernel reads it by pointer)."""
    b = q.shape[0]
    if not isinstance(t, torch.Tensor) or t.shape != (b,) or \
            t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({b},) int32 tensor, got "
                         f"{getattr(t, 'dtype', type(t).__name__)} "
                         f"{tuple(getattr(t, 'shape', ()))}")
    if t.device != q.device:
        raise ValueError(f"{name} on {t.device}, q on {q.device}")


def _check_kv_lens(q, k, kv_lens, q_start=None) -> None:
    """kv_lens must be a contiguous (B,) int32 tensor on q's device.  On the
    CPU its values are checked too: Tq <= kv_lens[b] <= Tk, so every query
    sees at least its own key (with a ``q_start``, 0 <= kv_lens[b] <= Tk: a
    row may see none).  On the card that check would need a host sync, so
    the kernel takes the lengths as given (cut to [0, Tk])."""
    tq, tk = q.shape[1], k.shape[1]
    _check_rows(q, kv_lens, "kv_lens")
    if kv_lens.device.type == "cpu":
        lo, hi = int(kv_lens.min()), int(kv_lens.max())
        if q_start is not None and (lo < 0 or hi > tk):
            raise ValueError(f"kv_lens must lie in [0, Tk] = [0, {tk}]; got "
                             f"{kv_lens.tolist()}")
        if q_start is None and (lo < tq or hi > tk):
            raise ValueError(f"kv_lens must lie in [Tq, Tk] = [{tq}, {tk}] (every query "
                             f"sees its own key); got {kv_lens.tolist()}")


def _check_q_start(q, q_start) -> None:
    """A host int, or a (B,) int32 tensor on q's device."""
    if isinstance(q_start, torch.Tensor):
        _check_rows(q, q_start, "q_start")
    elif not isinstance(q_start, int) or isinstance(q_start, bool):
        raise ValueError(f"q_start must be an int or a ({q.shape[0]},) int32 tensor, got "
                         f"{type(q_start).__name__}")


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_cuda(q, k, v) -> None:
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


def _check_args(q, k, v, window: int, kv_lens, q_start) -> None:
    _check(q, k, v, window)
    if q_start is not None:
        _check_q_start(q, q_start)
    if kv_lens is not None:
        _check_kv_lens(q, k, kv_lens, q_start)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, kv_lens=None,
                    q_start=None):
    """q: (B, Tq, H, hd); k, v: (B, Tk, Hkv, hd), any strides.

    Returns (B, Tq, H, hd) in q's dtype.  Causal masking is aligned top-left
    (query i sees keys j <= i, as the TPU kernel's), so a decode step attends
    with ``causal=False`` over the valid prefix of its cache.  With
    ``kv_lens`` (B,) int32 on q's device, row b attends to its first
    kv_lens[b] keys and its queries sit at the last Tq of those positions
    (Tq <= kv_lens[b] <= Tk: checked on the CPU, taken as given on the card,
    where checking would sync).  ``q_start`` (a host int or (B,) int32 on
    q's device) puts query i at q_start + i instead, and a row that sees no
    key returns 0.  Differentiable without ``kv_lens`` and with a host-int
    or no ``q_start``: on CUDA tensors that need a gradient it runs
    ``FlashAttentionFunction``."""
    _check_args(q, k, v, window, kv_lens, q_start)
    if _on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window, kv_lens=kv_lens,
                                   q_start=q_start)
    _check_cuda(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if kv_lens is not None or isinstance(q_start, torch.Tensor):
            raise NotImplementedError(f"the flash backward with kv_lens or per-row q_start "
                                      f"is not ported to repro_torch yet: {SERVING_REST}")
        return FlashAttentionFunction.apply(q, k, v, causal, window, q_start)
    return _forward(q, k, v, causal, window, want_lse=False, kv_lens=kv_lens,
                    q_start=q_start)[0]


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0, kv_lens=None,
                        q_start=None):
    """The forward and its rows' log-sum-exp: (out (B, Tq, H, hd) in q's
    dtype, lse (B, H, Tq) f32), the partial softmax a hop of the context
    ring folds in (``parallel.context``), with ``window``, ``kv_lens`` and
    ``q_start`` as ``flash_attention`` takes them (a row that sees no key
    under a ``q_start``: out 0, lse -inf).  On CUDA tensors it launches what
    ``FlashAttentionFunction.forward`` launches (``tc_prefill`` for bf16
    rows that take 16-byte copies, else ``fma``), counted in
    ``flash_attention.launches`` and ``.variant_launches``; on CPU tensors
    it takes ``flash_attention_ref`` and ``flash_attention_lse_plain``.  Not
    differentiable: the ring's backward calls ``flash_attention_bwd``."""
    _check_args(q, k, v, window, kv_lens, q_start)
    if _on_cpu(q, k, v):
        kw = dict(causal=causal, window=window, kv_lens=kv_lens, q_start=q_start)
        return flash_attention_ref(q, k, v, **kw), flash_attention_lse_plain(q, k, **kw)
    _check_cuda(q, k, v)
    return _forward(q, k, v, causal, window, want_lse=True, kv_lens=kv_lens, q_start=q_start)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient on the card: the forward kernel
    writes each row's log-sum-exp beside the output, and the backward
    kernels recompute P from it (nothing of size Tq x Tk is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_start=None):
        out, lse = _forward(q, k, v, causal, window, want_lse=True, q_start=q_start)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_start = causal, window, q_start
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         causal=ctx.causal, window=ctx.window,
                                         q_start=ctx.q_start)
        return dq, dk, dv, None, None, None


def _q_mode(q_start):
    """(q_mode, q_off, q_start pointer) of the C entries: 0 without a query
    start, 1 for a host int, 2 for a (B,) device tensor."""
    if q_start is None:
        return 0, 0, None
    if isinstance(q_start, torch.Tensor):
        return 2, 0, q_start.data_ptr()
    return 1, int(q_start), None


def _forward(q, k, v, causal: bool, window: int, *, want_lse: bool, variant=None,
             kv_lens=None, q_start=None):
    """Launch the forward kernel, through the variant ``flash_variant`` picks
    or, for a test, ``variant`` forced; returns (out, lse or None), lse (B,
    H, Tq) f32 when ``want_lse``.  The decode tile's split is planned from
    Tk (with ``kv_lens`` or a ``q_start``, the whole capacity), never from
    the lengths or starts."""
    b, tq, h, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    variant = variant or flash_variant(q, k, v, want_lse=want_lse)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if want_lse else None
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride())
    n_split, per, ws, counters = 1, 1, None, None
    with torch.cuda.device(q.device):   # the kernel launches on the current device
        stream = torch.cuda.current_stream(q.device)
        if variant == "tc_decode":
            kv_end = min(tk, tq) if causal and kv_lens is None and q_start is None else tk
            n_tiles = -(-kv_end // KV_TILE)
            n_split, per = decode_split(b, hkv, n_tiles, _sm_count(q.device))
            if n_split > 1:
                ws = torch.empty(b * hkv * n_split * DECODE_ROWS * (hd + 2),
                                 dtype=torch.float32, device=q.device)
                counters = _split_counters(q.device, stream, b * hkv)
        fn = _entry or _bind()
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype], b, tq, tk,
                 h, hkv, hd, strides, int(causal), int(window), 1.0 / math.sqrt(hd),
                 VARIANTS.index(variant), n_split, per,
                 None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 None if kv_lens is None else kv_lens.data_ptr(), *_q_mode(q_start),
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({variant}): "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, window: int = 0,
                        q_start=None):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` at its output
    ``o`` and the forward's ``lse`` (B, H, Tq), for the output gradient
    ``do`` (B, Tq, H, hd); in the inputs' dtypes.  ``q_start``, a host int,
    places the queries as the forward's did (a row that sees no key has P =
    0).  On CUDA tensors it launches the backward kernels (or raises); on CPU
    tensors it takes the plain version ``flash_attention_bwd_plain``."""
    _check(q, k, v, window)
    if q_start is not None and (isinstance(q_start, (torch.Tensor, bool))
                                or not isinstance(q_start, int)):
        raise ValueError(f"flash_attention_bwd takes a host-int q_start, got "
                         f"{type(q_start).__name__} ({SERVING_REST})")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must have q's "
                         f"shape {tuple(q.shape)}")
    b, tq, h, hd = q.shape
    if lse.shape != (b, h, tq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 of shape {(b, h, tq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if _on_cpu(q, k, v, o, do, lse):
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal, window=window,
                                         q_start=q_start)
    _check_cuda(q, k, v)
    if not all(t.device == q.device for t in (o, do, lse)):
        raise ValueError("flash_attention_bwd needs every tensor on q's device")
    if not all(t.dtype == q.dtype for t in (k, v, o, do)):
        raise TypeError(f"flash_attention_bwd takes q, k, v, o, dO of one dtype; got "
                        f"{[t.dtype for t in (q, k, v, o, do)]}")
    return _launch_bwd(q, k, v, o, do, lse, causal, window, flash_bwd_variant(q, k, v, o, do),
                       q_start=q_start)


def _launch_bwd(q, k, v, o, do, lse, causal: bool, window: int, variant: str, *,
                q_start=None):
    """Launch the backward kernels of ``variant`` (a test may force ``fma``
    on inputs that ``tc`` takes); returns (dq, dk, dv)."""
    b, tq, h, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    lse = lse.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 32)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        fn = _bwd_entry or _bind_bwd()
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), _DTYPE_CODE[q.dtype], b, tq, tk, h, hkv, hd, strides,
                 int(causal), int(window), 1.0 / math.sqrt(hd), BWD_VARIANTS.index(variant),
                 *_q_mode(q_start)[:2], stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed ({variant}): "
                           f"CUDA error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[variant] += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.variant_launches = dict.fromkeys(BWD_VARIANTS, 0)

_entry = None   # the bound C entry points, once the library is built and loaded
_bwd_entry = None
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    _entry = fn
    return fn


def _bind_bwd():
    global _bwd_entry
    fn = build.load("flash_attention").repro_flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                      ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _bwd_entry = fn
    return fn
