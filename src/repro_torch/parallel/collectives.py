"""Collective runtimes (port of ``repro/parallel/collectives.py``).

Only the bucket size that the planner's cost model reads is here.  The
bucketed DP gradient sync and the chunked collective-matmul rings are
ROADMAP.md Queue 1 items 5 and 7.
"""

# Size target for one DP gradient bucket (torch-DDP-style default: large
# enough to amortize per-collective latency, small enough that several
# buckets are in flight over one backward).
DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024
