"""Context-parallel ring attention (port of ``ring_attention`` in
``repro/parallel/context.py``): the sequence is sharded over a ring of m
ranks, each holding T/m query rows for the whole layer stack, and K/V
blocks go round the ring while each rank folds them into its partial
softmax.

Ring schedule (as in JAX): at step s, rank j holds KV block ``src = (j - s)
mod m``; step 0 is the diagonal block.  Under the causal mask block ``src``
is wholly in the future when src > j, and the hop is skipped (the block is
still passed on); a block wholly in the past attends without a mask, and
the diagonal block with the kernel's top-left causal mask, so a hop needs no
query offset.  Under a sliding window (JAX's ``_block_skip`` and
``_hop_mask``) a block wholly left of every row's window is skipped too, and
a past block the window cuts runs the kernel with its rows' query start,
``q_start = (j - src) T/m``, relative to the block's first key; its rows
that see none of the block's keys return 0 and lse -inf.  Every computed
hop runs the hand-written flash forward with
its rows' log-sum-exp (``kernels.flash_attention.flash_attention_lse``) and
is folded in f32 by ``merge_attention``, the merge rule of JAX's
``models.layers.merge_softmax_stats`` written over (out, lse) pairs.

``ring_attention_stats`` is the forward-only ring (the context-parallel
prefill chunk's in-chunk attention), returning the (out f32, lse) it folds;
``gathered_attention`` is the all-gather-then-attend foil (one all-gather of
K/V, then the kernel with ``q_start = j T/m``).

The backward is the reverse ring: K/V rotate as in the forward, each
computed hop calls the flash backward kernels with the *global* output and
lse (``flash_attention_bwd`` recomputes P = exp(S - lse) and D = rowsum(dO o
O) from them, which is JAX's hop backward), dq is summed in f32, and the
f32 dK/dV accumulators ride the ring one hop a step, m hops in all, so each
lands on its owner carrying every rank's part.  Messages carry the
un-repeated Hkv heads, K and V stacked in one message; each has its own tag
(``dist.message_tag``) per layer, hop and direction.  A message is one
blocking ``dist.exchange``, so a hop's transfer does not overlap its
attention (ROADMAP.md item 16).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_lse)
from repro_torch.parallel import dist as D


def merge_attention(out, lse, out_s, lse_s):
    """Fold a partial attention over other keys into (out, lse): out (B, T,
    H, hd) f32, lse (B, H, T) f32, the partials in any float dtype.  Returns
    the f32 pair over the union of the keys: LSE = logaddexp(lse, lse_s),
    out rescaled by exp(lse - LSE) and exp(lse_s - LSE)."""
    new = torch.logaddexp(lse, lse_s)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    b = torch.exp(lse_s - new).transpose(1, 2)[..., None]
    return out * a + out_s.float() * b, new


def _hop_computed(src: int, j: int, t_loc: int, causal: bool, window: int) -> bool:
    """``_block_skip`` of JAX, negated: under the causal mask a block wholly
    in the future (src > j) contributes nothing, and under a window neither
    does one whose newest key, (src + 1) t_loc - 1, is left of the oldest
    row's window (j t_loc sees keys in (j t_loc - window, j t_loc])."""
    if causal and src > j:
        return False
    return not (window > 0 and (src + 1) * t_loc - 1 + window <= j * t_loc)


def _hop_kw(src: int, j: int, t_loc: int, causal: bool, window: int) -> dict:
    """The kernel's masks for the hop of block ``src`` on ring place j:
    without a window a past block attends whole (no mask); under one, the
    block's keys sit at 0.. and the rows at (j - src) t_loc.. (JAX's
    ``_hop_mask`` of absolute positions, shifted by the block's first key)."""
    if not window:
        return {"causal": False}
    return {"causal": causal, "window": window, "q_start": (j - src) * t_loc}


def _pass_on(mesh, ring, tensors, tag_of):
    """Send each tensor to the next rank of the ring and receive the same
    shapes from the previous one, in one exchange; ``tag_of(i)`` is the tag
    of the i-th message."""
    _, _, nxt, prev = ring
    return D.exchange(mesh, [(t, nxt, tag_of(i)) for i, t in enumerate(tensors)],
                      [(t.shape, t.dtype, prev, tag_of(i)) for i, t in enumerate(tensors)])


class RingAttentionFunction(torch.autograd.Function):
    """The ring's forward and reverse-ring backward (JAX's custom vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis: str, causal: bool, window: int, layer: int):
        out, lse = _ring_forward(q, k, v, mesh, axis, causal, window, layer)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis, ctx.layer = mesh, axis, layer
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.mesh.ring(ctx.axis)
        j, m = ring[0], ring[1]
        t_loc, causal, window = q.shape[1], ctx.causal, ctx.window
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
        dq, dkv = dq.float(), torch.stack((dk, dv)).float()
        kv = torch.stack((k, v))
        for s in range(1, m):
            # block (j - s) mod m arrives with its accumulator, one hop on
            dkv, kv = _pass_on(ctx.mesh, ring, [dkv, kv],
                               lambda i: D.message_tag(ctx.layer, s, True, part=i))
            src = (j - s) % m
            if _hop_computed(src, j, t_loc, causal, window):
                dq_s, dk_s, dv_s = flash_attention_bwd(q, kv[0], kv[1], out, dout, lse,
                                                       **_hop_kw(src, j, t_loc, causal, window))
                dq += dq_s
                dkv[0] += dk_s
                dkv[1] += dv_s
        # the m-th hop takes each accumulator home, every rank's part in it
        dkv, = _pass_on(ctx.mesh, ring, [dkv], lambda i: D.message_tag(ctx.layer, 0, True))
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def _ring_forward(q, k, v, mesh, axis: str, causal: bool, window: int, layer: int):
    """The forward ring: (out f32, lse) of this rank's rows over every
    block the masks reach.  Step 0 is the diagonal block (every row sees its
    own key there, so the fold starts finite)."""
    ring = mesh.ring(axis)
    j, m = ring[0], ring[1]
    t_loc = q.shape[1]
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    out = out.float()
    kv = torch.stack((k, v))
    for s in range(1, m):
        kv, = _pass_on(mesh, ring, [kv], lambda i: D.message_tag(layer, s, False))
        src = (j - s) % m
        if _hop_computed(src, j, t_loc, causal, window):
            o_s, lse_s = flash_attention_lse(q, kv[0], kv[1],
                                             **_hop_kw(src, j, t_loc, causal, window))
            out, lse = merge_attention(out, lse, o_s, lse_s)
    return out, lse


def ring_attention(q, k, v, *, mesh, axis: str = "model", causal: bool = True,
                   window: int = 0, layer: int = 0):
    """Context-parallel GQA attention over the ring of ``mesh``'s ``axis``.

    q: (B, T/m, Hq, hd), this rank's query rows (ring place j holds rows
    j T/m to (j + 1) T/m); k, v: (B, T/m, Hkv, hd), this rank's KV block.
    Returns (B, T/m, Hq, hd), this rank's output rows, in q's dtype;
    differentiable.  ``window > 0`` keeps keys j > i - window (JAX's ring:
    blocks wholly left of it skipped, the others on the kernel's query
    start).  ``layer`` keys the messages' tags.  A ring of one rank is
    ``flash_attention``."""
    if mesh.size(axis) == 1:
        return flash_attention(q, k, v, causal=causal, window=window)
    return RingAttentionFunction.apply(q, k, v, mesh, axis, bool(causal), int(window),
                                       int(layer))


@torch.no_grad()
def ring_attention_stats(q, k, v, *, mesh, axis: str = "model", causal: bool = True,
                         window: int = 0, layer: int = 0):
    """The forward-only ring (JAX's ``ring_attention_stats``, inference
    only): this rank's rows folded over every block the masks reach, as
    (out (B, T/m, Hq, hd) f32, lse (B, Hq, T/m) f32) rather than JAX's
    unnormalised (m, l, acc).  The two say the same: JAX's triple is (lse,
    1, out transposed to (B, Hq, T/m, hd)) up to a common factor, so
    ``merge_softmax_stats`` of it with another triple is ``merge_attention``
    of (out, lse) with that triple's (acc / l, m + log l).  Positions are
    chunk-relative: a request's absolute offset cancels in the masks.  A
    ring of one rank is ``flash_attention_lse``."""
    if mesh.size(axis) == 1:
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        return out.float(), lse
    return _ring_forward(q, k, v, mesh, axis, bool(causal), int(window), int(layer))


@torch.no_grad()
def gathered_attention(q, k, v, *, mesh, axis: str = "model", causal: bool = True,
                       window: int = 0):
    """The all-gather-then-attend foil of ``ring_attention`` (JAX's
    ``gathered_attention``, what GSPMD lowers a sequence-sharded attention
    to), inference only: one all-gather of this rank's K/V blocks over
    ``axis``, then the flash kernel over the whole K/V with this rank's rows
    at ``q_start = j T/m``.  Returns (B, T/m, Hq, hd) in q's dtype."""
    j, m = mesh.ring(axis)[:2]
    if m == 1:
        return flash_attention(q, k, v, causal=causal, window=window)
    kv = torch.stack((k, v)).contiguous()                          # (2, B, T/m, Hkv, hd)
    full = kv.new_empty((m * 2, *kv.shape[1:]))
    D.all_gather(mesh, full, kv, axis)
    full = full.view(m, *kv.shape)
    kf, vf = (full[:, i].transpose(0, 1).reshape(kv.shape[1], m * kv.shape[2], *kv.shape[3:])
              for i in range(2))
    return flash_attention(q, kf, vf, causal=causal, window=window, q_start=j * q.shape[1])
