"""Collective runtimes (port of the DP half of ``repro/parallel/collectives.py``).

The DP gradient sync of a ``parallel.dist.RankMesh``, in the two forms a
``ParallelPlan``'s ``comm_runtime`` names:

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

The chunked collective-matmul rings of the same JAX module are tensor MP,
ROADMAP.md Queue 1 item 7.
"""
from __future__ import annotations

from typing import List

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
