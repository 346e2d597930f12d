"""Collective runtimes (port of ``repro/parallel/collectives.py``): the DP
gradient sync and the tensor-MP collectives of a ``parallel.dist.RankMesh``.

The DP gradient sync, in the two forms a ``ParallelPlan``'s
``comm_runtime`` names:

- ``"overlapped"``: ``bucketed_grad_sync``.  Leaves in reverse flatten order
  (the order the backward retires them) are packed into buckets
  (``grad_bucket_sizes``); each bucket is one flat f32 buffer, padded to a
  multiple of the DP degree, and goes through a reduce-scatter then an
  all-gather over the ``data`` group: the ZeRO split of the all-reduce.
  There is one pod, so JAX's pod-level psum has no counterpart.  Like the
  JAX function, the sync runs after the backward; launching a bucket's
  collective as it fills is ROADMAP.md Queue 1 item 16.
- ``"gspmd"``: ``all_reduce_grads``, one all-reduce a leaf (the monolithic
  sync the JAX partitioner inserts).

Tensor MP over the ``model`` group.  The port has no GSPMD, so every
collective the JAX partitioner would insert is written out as a
``torch.autograd.Function``:

- the ``gspmd`` runtime's Megatron conjugate pairs: ``copy_to_model``
  (identity forward, all-reduce backward) before a column-parallel product,
  ``reduce_from_model`` (all-reduce forward, identity backward) after a
  row-parallel one, ``gather_from_model`` (all-gather a dim forward, this
  rank's slice backward), and for a sequence-sharded residual stream
  ``gather_sequence`` (all-gather forward, reduce-scatter backward),
  ``reduce_scatter_sequence`` (its conjugate) and ``scatter_sequence``
  (this rank's rows forward, all-gather backward);
- the ``overlapped`` runtime's collective matmuls, ``all_gather_matmul``
  (column-parallel: x sequence-sharded, W column-sharded) and
  ``matmul_reduce_scatter`` (row-parallel, the output sequence-scattered):
  chunked point-to-point rings in JAX's schedule, each hop's product a
  ``torch.matmul`` (JAX computes them outside any Pallas kernel), with
  JAX's backward rings (``_ag_mm_bwd``: a reduce ring for dx and a re-gather
  ring for dW; ``_mm_rs_bwd``: one gather ring for dh and dW), not autograd
  through the forward.  Every message has its own tag
  (``dist.tp_message_tag``: layer, op, phase, hop, chunk).  A hop is one
  blocking ``dist.exchange``, so its transfer does not overlap its product
  (launching it before the product is ROADMAP.md Queue 1 item 16).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.parallel import dist as D
from repro_torch.tree import tree_leaves

# Size target for one DP gradient bucket (torch-DDP-style default: large
# enough to amortize per-collective latency, small enough that several
# buckets are in flight over one backward).
DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024


def grad_bucket_sizes(grads, bucket_bytes: float = DEFAULT_BUCKET_BYTES) -> List[int]:
    """Bucket assignment (list of per-bucket leaf counts) for a grad tree:
    leaves in REVERSE flatten order, greedily packed into buckets of at most
    ``bucket_bytes`` (every bucket holds at least one leaf, so oversized
    leaves get a bucket of their own)."""
    sizes = [g.numel() * g.element_size() for g in reversed(tree_leaves(grads))]
    buckets, cur, cur_bytes = [], 0, 0
    for s in sizes:
        if cur and cur_bytes + s > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = 0, 0
        cur += 1
        cur_bytes += s
    if cur:
        buckets.append(cur)
    return buckets


@torch.no_grad()
def bucketed_grad_sync(grads, mesh, *, axis: str = "data",
                       bucket_bytes: float = DEFAULT_BUCKET_BYTES):
    """Sum each rank's gradients over the ``axis`` group, bucket by bucket
    (reduce-scatter, then all-gather).  The sums are written into the
    leaves in place; returns ``grads``, identical on every rank of the
    group."""
    n = mesh.size(axis)
    if n == 1:
        return grads
    rev = list(reversed(tree_leaves(grads)))
    i = 0
    for count in grad_bucket_sizes(grads, bucket_bytes):
        group, i = rev[i:i + count], i + count
        flat = torch.cat([g.float().reshape(-1) for g in group])
        pad = (-flat.numel()) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        shard = flat.new_empty(flat.numel() // n)
        D.reduce_scatter(mesh, shard, flat, axis)
        D.all_gather(mesh, flat, shard, axis)
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()
    return grads


@torch.no_grad()
def all_reduce_grads(grads, mesh, *, axis: str = "data"):
    """Sum each leaf over the ``axis`` group in place, one all-reduce a
    leaf; returns ``grads``."""
    for g in tree_leaves(grads):
        D.all_reduce(mesh, g, axis)
    return grads


# ---------------------------------------------------------------------------
# tensor MP: the gspmd runtime's Megatron conjugate pairs
# ---------------------------------------------------------------------------

def _gather_dim(mesh, x, dim: int, axis: str):
    """The ``x`` of every rank of ``axis``, concatenated along ``dim``."""
    m = mesh.size(axis)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] * m, *front.shape[1:]))
    D.all_gather(mesh, out, front, axis)
    return out.movedim(0, dim)


def _reduce_scatter_dim(mesh, x, dim: int, axis: str):
    """This rank's 1/m slice along ``dim`` of the sum of ``x`` over ``axis``."""
    m = mesh.size(axis)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // m, *front.shape[1:]))
    D.reduce_scatter(mesh, out, front, axis)
    return out.movedim(0, dim)


def _own_slice(mesh, x, dim: int, axis: str):
    j, m = mesh.ring(axis)[:2]
    n = x.shape[dim] // m
    return x.narrow(dim, j * n, n).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.all_reduce(ctx.mesh, g.contiguous().clone(), ctx.axis), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return D.all_reduce(mesh, x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, split_back):
        ctx.mesh, ctx.axis, ctx.dim, ctx.split_back = mesh, axis, dim, split_back
        return _gather_dim(mesh, x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.split_back:
            dx = _own_slice(ctx.mesh, g, ctx.dim, ctx.axis)
        else:
            dx = _reduce_scatter_dim(ctx.mesh, g, ctx.dim, ctx.axis)
        return dx, None, None, None, None


class _ReduceScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter_dim(mesh, x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(ctx.mesh, g, ctx.dim, ctx.axis), None, None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_slice(mesh, x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(ctx.mesh, g, ctx.dim, ctx.axis), None, None, None


def copy_to_model(x, mesh, axis: str = "model"):
    """``x`` (the same on every rank of ``axis``) entering rank-local work:
    identity forward, the gradient summed over ``axis`` backward."""
    if mesh.size(axis) == 1:
        return x
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(x, mesh, axis: str = "model"):
    """The sum over ``axis`` of each rank's partial ``x``: all-reduce
    forward, identity backward (the sum feeds work every rank repeats)."""
    if mesh.size(axis) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh, axis)


def gather_from_model(x, mesh, dim: int = -1, axis: str = "model"):
    """Every rank's ``x`` concatenated along ``dim`` (all-gather forward);
    the gathered tensor feeds work every rank repeats, so the backward takes
    this rank's slice of the gradient."""
    if mesh.size(axis) == 1:
        return x
    return _GatherFromModel.apply(x, mesh, axis, dim % x.dim(), True)


def gather_sequence(x, mesh, dim: int = 1, axis: str = "model"):
    """Sequence-sharded rows gathered whole (all-gather forward) for
    rank-local work whose input gradients are partial sums: the backward
    reduce-scatters them."""
    if mesh.size(axis) == 1:
        return x
    return _GatherFromModel.apply(x, mesh, axis, dim % x.dim(), False)


def reduce_scatter_sequence(x, mesh, dim: int = 1, axis: str = "model"):
    """This rank's rows of the sum over ``axis`` of partial ``x``
    (reduce-scatter forward, all-gather backward)."""
    if mesh.size(axis) == 1:
        return x
    return _ReduceScatterToModel.apply(x, mesh, axis, dim % x.dim())


def scatter_sequence(x, mesh, dim: int = 1, axis: str = "model"):
    """This rank's rows of ``x`` (the same on every rank): a slice forward,
    all-gather backward."""
    if mesh.size(axis) == 1:
        return x
    return _ScatterToModel.apply(x, mesh, axis, dim % x.dim())


# ---------------------------------------------------------------------------
# tensor MP: the overlapped runtime's collective-matmul rings
# ---------------------------------------------------------------------------

def _pass_on(mesh, axis: str, tensors, tag_of):
    """Send each tensor to the next rank of the ring and receive the same
    shapes from the previous one, in one exchange; ``tag_of(i)`` is the tag
    of the i-th message."""
    _, _, nxt, prev = mesh.ring(axis)
    return D.exchange(mesh, [(t, nxt, tag_of(i)) for i, t in enumerate(tensors)],
                      [(t.shape, t.dtype, prev, tag_of(i)) for i, t in enumerate(tensors)])


def _flat2(x):
    """(..., T, D) -> (prod(...) * T, D) for the batch-summed weight grads."""
    return x.reshape(-1, x.shape[-1])


def _rows(x, start: int, n: int):
    return x.narrow(-2, start, n)


def _mm_rs(mesh, axis, chunks, h, w, tag: Tuple[int, int], phase: int):
    """Rows j of sum_i h_i @ w_i on rank j (JAX's ``_mm_rs``): the
    accumulator of chunk (j - 1 - s) mod m arrives at step s, this rank's
    partial product for it is added and the sum moves on."""
    j, m = mesh.ring(axis)[:2]
    t_loc = h.shape[-2] // m
    piece = t_loc // chunks
    accs = [_rows(h, ((j - 1) % m) * t_loc + ci * piece, piece) @ w for ci in range(chunks)]
    for s in range(m - 1):
        accs = _pass_on(mesh, axis, accs,
                        lambda ci, s=s: D.tp_message_tag(*tag, phase, s, ci))
        c = (j - 2 - s) % m
        accs = [a + _rows(h, c * t_loc + ci * piece, piece) @ w for ci, a in enumerate(accs)]
    return torch.cat(accs, dim=-2) if chunks > 1 else accs[0]


def _gather_ring(mesh, axis, chunks, x, tag, phase: int, visit):
    """The gather ring of JAX's ``_ag_mm_fwd``: at step s this rank holds
    the pieces of rank (j - s) mod m's rows and calls ``visit(src_row, piece)``
    for each, while passing them on."""
    j, m = mesh.ring(axis)[:2]
    t_loc = x.shape[-2]
    piece = t_loc // chunks
    pieces = list(x.split(piece, dim=-2))
    for s in range(m):
        src = (j - s) % m
        nxt = (_pass_on(mesh, axis, pieces, lambda ci, s=s: D.tp_message_tag(*tag, phase, s, ci))
               if s < m - 1 else None)
        for ci, p in enumerate(pieces):
            visit(src * t_loc + ci * piece, p)
        pieces = nxt


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, axis, chunks, tag):
        m = mesh.size(axis)
        out = x.new_empty((*x.shape[:-2], x.shape[-2] * m, w.shape[-1]),
                          dtype=torch.result_type(x, w))

        def visit(start, p):
            _rows(out, start, p.shape[-2]).copy_(p @ w)

        _gather_ring(mesh, axis, chunks, x, tag, 0, visit)
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.axis, ctx.chunks, ctx.tag = mesh, axis, chunks, tag
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        mesh, axis, chunks, tag = ctx.mesh, ctx.axis, ctx.chunks, ctx.tag
        # dx: this rank's rows of sum_j dy_j @ W_j^T, on a reduce ring
        dx = _mm_rs(mesh, axis, chunks, dy, w.transpose(-1, -2), tag, 1)
        # dW = all_gather(x)^T @ dy: x re-gathered on a second ring (each
        # hop's product in the inputs' dtype, summed in f32)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)

        def visit(start, p):
            dw.add_(_flat2(p).transpose(0, 1) @ _flat2(_rows(dy, start, p.shape[-2])))

        _gather_ring(mesh, axis, chunks, x, tag, 2, visit)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, mesh, axis, chunks, tag):
        ctx.save_for_backward(h, w)
        ctx.mesh, ctx.axis, ctx.chunks, ctx.tag = mesh, axis, chunks, tag
        return _mm_rs(mesh, axis, chunks, h, w, tag, 0)

    @staticmethod
    def backward(ctx, dy):
        # one gather ring of the sequence-sharded output gradient gives
        # dh = all_gather(dy) @ W^T and dW = h^T @ all_gather(dy)
        h, w = ctx.saved_tensors
        wt = w.transpose(-1, -2)
        dh = h.new_empty(h.shape, dtype=torch.result_type(dy, w))
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)

        def visit(start, p):
            n = p.shape[-2]
            _rows(dh, start, n).copy_(p @ wt)
            dw.add_(_flat2(_rows(h, start, n)).transpose(0, 1) @ _flat2(p))

        _gather_ring(ctx.mesh, ctx.axis, ctx.chunks, dy.contiguous(), ctx.tag, 1, visit)
        return dh.to(h.dtype), dw.to(w.dtype), None, None, None, None


def all_gather_matmul(x, w, *, mesh, axis: str = "model", chunks: int = 1,
                      tag: Tuple[int, int] = (0, 0)):
    """``all_gather(x, axis) @ w`` on a chunked ring.  ``x``: (..., T/m, d),
    this rank's rows; ``w``: (d, F/m), its column slice.  Returns (..., T,
    F/m).  ``tag`` = (layer, op) keys the messages."""
    m = mesh.size(axis)
    if m <= 1:
        return x @ w
    if x.shape[-2] % chunks:
        raise ValueError(f"chunks={chunks} must divide the local row count {x.shape[-2]}")
    return _AllGatherMatmul.apply(x, w, mesh, axis, int(chunks), tuple(tag))


def matmul_reduce_scatter(h, w, *, mesh, axis: str = "model", chunks: int = 1,
                          tag: Tuple[int, int] = (0, 1)):
    """``reduce_scatter(h @ w, axis)`` on a chunked reduce ring.  ``h``:
    (..., T, F/m), this rank's column slice of the activations; ``w``: (F/m,
    d), its row slice.  Returns (..., T/m, d): this rank's rows of the sum
    over the ranks."""
    m = mesh.size(axis)
    if m <= 1:
        return h @ w
    if h.shape[-2] % m:
        raise ValueError(f"rows {h.shape[-2]} not divisible by axis_size {m}")
    if (h.shape[-2] // m) % chunks:
        raise ValueError(f"chunks={chunks} must divide the per-shard row count "
                         f"{h.shape[-2] // m}")
    return _MatmulReduceScatter.apply(h, w, mesh, axis, int(chunks), tuple(tag))
