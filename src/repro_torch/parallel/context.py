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
query offset.  Every computed hop runs the hand-written flash forward with
its rows' log-sum-exp (``kernels.flash_attention.flash_attention_lse``) and
is folded in f32 by ``merge_attention``, the merge rule of JAX's
``models.layers.merge_softmax_stats`` written over (out, lse) pairs.

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

WINDOW = "ROADMAP.md Queue 1 item 3 (window, ring and slot caches)"


def merge_attention(out, lse, out_s, lse_s):
    """Fold a partial attention over other keys into (out, lse): out (B, T,
    H, hd) f32, lse (B, H, T) f32, the partials in any float dtype.  Returns
    the f32 pair over the union of the keys: LSE = logaddexp(lse, lse_s),
    out rescaled by exp(lse - LSE) and exp(lse_s - LSE)."""
    new = torch.logaddexp(lse, lse_s)
    a = torch.exp(lse - new).transpose(1, 2)[..., None]
    b = torch.exp(lse_s - new).transpose(1, 2)[..., None]
    return out * a + out_s.float() * b, new


def _hop_computed(src: int, j: int, causal: bool) -> bool:
    """``_block_skip`` of JAX, negated: under the causal mask a block wholly
    in the future (src > j) contributes nothing."""
    return not (causal and src > j)


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
    def forward(ctx, q, k, v, mesh, axis: str, causal: bool, layer: int):
        ring = mesh.ring(axis)
        j, m = ring[0], ring[1]
        out, lse = flash_attention_lse(q, k, v, causal=causal)   # step 0: the diagonal
        out = out.float()
        kv = torch.stack((k, v))
        for s in range(1, m):
            kv, = _pass_on(mesh, ring, [kv], lambda i: D.message_tag(layer, s, False))
            if _hop_computed((j - s) % m, j, causal):      # a block wholly in the past
                o_s, lse_s = flash_attention_lse(q, kv[0], kv[1], causal=False)
                out, lse = merge_attention(out, lse, o_s, lse_s)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.layer = mesh, axis, causal, layer
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.mesh.ring(ctx.axis)
        j, m = ring[0], ring[1]
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=ctx.causal)
        dq, dkv = dq.float(), torch.stack((dk, dv)).float()
        kv = torch.stack((k, v))
        for s in range(1, m):
            # block (j - s) mod m arrives with its accumulator, one hop on
            dkv, kv = _pass_on(ctx.mesh, ring, [dkv, kv],
                               lambda i: D.message_tag(ctx.layer, s, True, part=i))
            if _hop_computed((j - s) % m, j, ctx.causal):
                dq_s, dk_s, dv_s = flash_attention_bwd(q, kv[0], kv[1], out, dout, lse,
                                                       causal=False)
                dq += dq_s
                dkv[0] += dk_s
                dkv[1] += dv_s
        # the m-th hop takes each accumulator home, every rank's part in it
        dkv, = _pass_on(ctx.mesh, ring, [dkv], lambda i: D.message_tag(ctx.layer, 0, True))
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, *, mesh, axis: str = "model", causal: bool = True,
                   window: int = 0, layer: int = 0):
    """Context-parallel GQA attention over the ring of ``mesh``'s ``axis``.

    q: (B, T/m, Hq, hd), this rank's query rows (ring place j holds rows
    j T/m to (j + 1) T/m); k, v: (B, T/m, Hkv, hd), this rank's KV block.
    Returns (B, T/m, Hq, hd), this rank's output rows, in q's dtype;
    differentiable.  ``layer`` keys the messages' tags.  A ring of one rank
    is ``flash_attention``.  ``window > 0`` raises: the kernel takes no
    query offset, and the port's models refuse windows (ROADMAP.md item 3)."""
    if window:
        raise NotImplementedError(f"sliding-window ring attention is not ported to "
                                  f"repro_torch yet: {WINDOW}")
    if mesh.size(axis) == 1:
        return flash_attention(q, k, v, causal=causal)
    return RingAttentionFunction.apply(q, k, v, mesh, axis, bool(causal), int(layer))
