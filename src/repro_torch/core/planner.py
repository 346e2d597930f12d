"""HybridPlanner — the paper's strategy search as a first-class feature
(port of ``repro/core/planner.py``, on the H100 ``HardwareModel``).

Given an architecture config, a device budget, and hardware constants, the
planner runs a unified **3-way search** over every factorization of the
budget into

    total = pods x N (data parallel) x M (model parallel),

where the M-way model parallelism is either **tensor-MP** (intra-layer
sharding over NVLink, the paper's §4.3 / DLPlacer style) or
**pipeline-MP** (layer pipelining with K micro-batches under a searched
**schedule** — gpipe / 1f1b / interleaved, see ``parallel.pipeline`` — the
paper's §4.4 implementation for GNMT and BigLSTM).  For each point it

(a) builds a per-step cost model from the arch's FLOPs/bytes:
    tensor SU^M from the Megatron all-reduce pattern, pipeline SU^M from the
    schedule's analytic bubble fraction ((M-1)/(K+M-1) for gpipe/1f1b,
    (M-1)/(vK+M-1) for interleaved) plus the inter-stage ``ppermute``
    activation-transfer time (scaled by v for interleaved's extra rings);
(b) derives SE_N from the (hierarchical) ring-all-reduce model, with the
    gradient exchange scaled by 1/M because each MP worker owns 1/M of the
    parameters;
(c) takes E(B) from measured curves or the fitted inflation model;
(d) applies a per-device **memory-feasibility filter** — f32 master params +
    optimizer state + gradients + remat boundary activations, ZeRO/fsdp-aware
    and **schedule-aware** (gpipe holds all K micro-batch activations, 1f1b
    at most min(K, S) — so 1f1b keeps micro-batch counts feasible that gpipe
    cannot fit), keyed off the **pipeline runtime** that will execute the
    plan (``pipe_runtime="scheduled"`` realizes the schedule's residency
    bound; ``"ad"`` holds all K for every
    schedule, so 1f1b's memory edge vanishes there): a point that only fits
    with params/opt sharded over DP is emitted with ``fsdp_axes`` set, and a
    point that does not fit even then is pruned rather than ranked;
(e) evaluates Eq. 4 vs Eq. 5 over the surviving points and returns them
    best-first, each as an executable ``ParallelPlan`` (tensor plans with
    ``model_axis``, pipeline plans additionally with ``mp_kind="pipeline"``,
    ``microbatches=K``, ``schedule``, ``virtual_stages``) + mesh shape.

``launch/train.py --parallel auto`` calls this and runs the winning plan
when it is one card's (M = 1, DP clamped to the card); a plan with M > 1
raises NotImplementedError naming the runtime it needs (ROADMAP.md Queue 1
items 6-8).

Two inputs are explicit here where the JAX planner reads module state: the
collective overlap table (``overlap``, default ``comm.MEASURED_OVERLAP``)
and the hop divisor (``HardwareModel.p2p_links``).  Given the JAX
``HardwareModel()`` values with ``p2p_links=4`` and the JAX
``MEASURED_OVERLAP``, every choice equals the JAX planner's
(``tests/test_torch_planner.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.analytical import (TrainingRun, crossover_device_count,
                                         epochs_ratio, se, speedup_context,
                                         speedup_dp, speedup_hybrid,
                                         speedup_pipeline)
from repro_torch.core.comm import (MEASURED_OVERLAP, HardwareModel,
                                   cp_ring_time, p2p_transfer_time,
                                   ring_all_reduce_time)
from repro_torch.core.stateff import EpochModel
from repro_torch.parallel.collectives import DEFAULT_BUCKET_BYTES
from repro_torch.parallel.pipeline import (pipeline_activation_residency,
                                           pipeline_step_speedup)
from repro_torch.parallel.plan import ParallelPlan, serve_plan

MULTI_REPLICA = "ROADMAP.md Queue 1 item 10 (multi-replica serving)"

# interleaved virtual chunks per device the planner searches (Megatron's v)
INTERLEAVE_CHUNKS = 2


@dataclasses.dataclass(frozen=True)
class PlannerChoice:
    pods: int
    dp: int                        # per-pod DP degree (N = pods * dp)
    mp: int
    mp_kind: str                   # "none" | "tensor" | "pipeline" | "context"
    microbatches: int              # pipeline micro-batches K (1 otherwise)
    schedule: str                  # pipeline schedule ("-" for non-pipeline)
    virtual_stages: int            # interleaved chunks per device (v)
    speedup: float                 # projected SU over a single device (Eq. 5)
    su_m: float                    # per-step MP speedup used
    se_n: float
    epochs_ratio: float
    mem_bytes: float               # projected per-device working set
    mesh_shape: Tuple[int, ...]
    plan: ParallelPlan

    @property
    def n_workers(self) -> int:
        return self.pods * self.dp


@dataclasses.dataclass(frozen=True)
class InferenceChoice:
    """One point of the latency-SLO-constrained serving search: ``replicas``
    independent decode groups of ``tp`` chips, each running a continuous-
    batching engine with ``slots`` request lanes."""
    replicas: int
    tp: int
    slots: int                     # concurrent requests per replica
    step_latency: float            # modeled s/token for the full batch
    tokens_per_s: float            # sustained: replicas * slots / step
    mem_bytes: float               # per-chip weights + KV working set
    mesh_shape: Tuple[int, ...]    # (replicas, tp) decode mesh per group
    plan: ParallelPlan

    @property
    def n_devices(self) -> int:
        return self.replicas * self.tp

    def build_router(self, api, params, *, capacity: int, **kw):
        """The JAX package executes this choice behind a fault-tolerant
        replica router; the port has none yet."""
        raise NotImplementedError(
            f"InferenceChoice.build_router is not ported to repro_torch yet: "
            f"{MULTI_REPLICA}")


def kv_bytes(cfg: ModelConfig, slots: int, context: int) -> float:
    """bf16 KV cache bytes for ``slots`` requests of ``context`` positions."""
    return (2.0 * cfg.n_layers * slots * context
            * cfg.n_kv_heads * cfg.head_dim * 2.0)


def decode_step_time(cfg: ModelConfig, tp: int, hw: HardwareModel, *,
                     slots: int, context: int,
                     comm_runtime: str = "gspmd",
                     overlap: Mapping[str, float] = MEASURED_OVERLAP) -> float:
    """Modeled latency of ONE decode tick (all ``slots`` advance a token) on
    a ``tp``-way tensor-MP group.

    Decode is bandwidth-bound: every tick streams this chip's 1/tp of the
    bf16 weights plus its share of the KV cache from HBM; the matmul FLOPs
    (2 * params * slots / tp) only bind at large batch.  On top rides the
    Megatron exchange — 2 activation all-reduces per layer of the (slots, d)
    residual — on the same ring model as training
    (``core.comm.ring_all_reduce_time``), with ``overlap[comm_runtime]`` of
    the wire time hidden when the overlapped collective rings carry the step
    (the per-hop alpha latency is what dominates at decode sizes, which is
    exactly why the SLO search favors modest tp)."""
    p = float(cfg.n_active_params())
    t_mem = (2.0 * p / tp + kv_bytes(cfg, slots, context) / tp) / hw.hbm_bw
    t_flops = 2.0 * p * slots / (tp * hw.peak_flops * hw.mfu)
    t_comm = 0.0
    if tp > 1:
        act_bytes = slots * cfg.d_model * 2.0
        t_comm = (2.0 * cfg.n_layers
                  * ring_all_reduce_time(act_bytes, tp, hw.ici_bw,
                                         hw.ici_latency)
                  * (1.0 - overlap[comm_runtime]))
    return max(t_mem, t_flops) + t_comm


def mp_step_speedup(cfg: ModelConfig, m: int, hw: HardwareModel,
                    comm_runtime: str = "gspmd",
                    overlap: Mapping[str, float] = MEASURED_OVERLAP) -> float:
    """Tensor-MP SU^M over NVLink: compute scales 1/m, plus the
    per-layer all-reduce of the (b, s, d) activations (2 per layer fwd, 2 bwd,
    Megatron pattern), with the ring's per-hop latency (alpha) term.  Uses
    bytes/FLOP analytics per arch family — the analytic stand-in for the
    paper's measured Table 1 / DLPlacer estimates.  ``comm_runtime=
    "overlapped"`` hides ``overlap["overlapped"]`` of the transfer under the
    chunked collective-matmul's partial matmuls."""
    if m <= 1:
        return 1.0
    # reference per-device micro-batch: 16 sequences of 4k tokens
    b, s = 16, 4096
    tokens = b * s
    flops = 6.0 * cfg.n_active_params() / cfg.n_layers * tokens  # per layer
    t_layer = flops / (hw.peak_flops * hw.mfu)
    act_bytes = tokens * cfg.d_model * 2
    n_ar = 4  # 2 fwd + 2 bwd all-reduces per layer (attn + mlp row-parallel)
    t_ar = n_ar * ring_all_reduce_time(act_bytes, m, hw.ici_bw,
                                       hw.ici_latency)
    t_ar *= 1.0 - overlap[comm_runtime]
    return (t_layer) / (t_layer / m + t_ar)


def pipeline_step_speedup_model(cfg: ModelConfig, m: int, n_micro: int,
                                hw: HardwareModel, *, mini_batch: int,
                                seq_len: int, schedule: str = "gpipe",
                                virtual_stages: int = 1) -> float:
    """Pipeline-MP SU^M for an m-stage schedule with ``n_micro``
    micro-batches: the schedule's bubble fraction ((m-1)/(n_micro+m-1) for
    gpipe/1f1b, (m-1)/(v*n_micro+m-1) for interleaved) plus the inter-stage
    ``ppermute`` activation transfer (one (b/K, s, d) tensor forward and its
    gradient backward per boundary per micro-batch; interleaved rings the
    activations v times, so its transfer scales by v)."""
    if m <= 1:
        return 1.0
    v = max(virtual_stages, 1) if schedule == "interleaved" else 1
    tokens = mini_batch * seq_len
    t_step = 6.0 * cfg.n_active_params() * tokens / (hw.peak_flops * hw.mfu)
    t_stage_micro = t_step / (m * n_micro)
    act_bytes = tokens / n_micro * cfg.d_model * 2   # bf16 boundary activation
    t_xfer = 2.0 * v * p2p_transfer_time(act_bytes, hw)  # fwd act + bwd grad
    comm_fraction = t_xfer / max(t_stage_micro, 1e-30)
    return pipeline_step_speedup(m, n_micro, comm_fraction,
                                 schedule=schedule, virtual_stages=v)


def cp_step_speedup(cfg: ModelConfig, m: int, hw: HardwareModel, *,
                    mini_batch: int = 16, seq_len: int = 4096) -> float:
    """Context-parallel SU^M on the ppermute KV ring
    (``parallel.context.ring_attention``): ALL per-token compute scales 1/m
    — the residual stream is sequence-sharded end to end, so the matmuls
    split like the tokens do — and on top rides the per-layer ring cost
    (``core.comm.cp_ring_time``): (m-1) neighbor hops each carrying one
    sequence shard's bf16 K+V block, forward KV rotation plus the
    backward's KV + dK/dV rings.  GQA keeps the wire narrow: hop bytes
    scale with n_kv_heads, not n_heads, which is why CP's ring is so much
    cheaper than all-gathering KV."""
    if m <= 1:
        return 1.0
    tokens = mini_batch * seq_len
    flops = 6.0 * cfg.n_active_params() / cfg.n_layers * tokens  # per layer
    t_layer = flops / (hw.peak_flops * hw.mfu)
    # one shard's K + V block in bf16: (b, s/m, n_kv_heads, head_dim) x 2
    hop_bytes = 2.0 * mini_batch * (seq_len / m) * cfg.n_kv_heads \
        * cfg.head_dim * 2.0
    t_ring = cp_ring_time(hop_bytes, m, hw)
    return t_layer / (t_layer / m + t_ring)


def context_mp_supported(cfg: ModelConfig) -> bool:
    """Does the KV-ring context-parallel runtime execute this arch?  The
    SAME homogeneous-dense-decoder predicate the runtime gates on
    (``models.transformer.cp_arch_supported``): the overlapped-arch family
    minus logit softcap (the ring's online-softmax merge has no softcap
    path)."""
    from repro_torch.models.transformer import cp_arch_supported
    return cp_arch_supported(cfg)


def pipeline_stage_candidates(cfg: ModelConfig,
                              mp_candidates: Tuple[int, ...]) -> Tuple[int, ...]:
    """Stage counts that evenly partition the arch's layer stack(s)."""
    ok = []
    for m in mp_candidates:
        if m <= 1 or m > cfg.n_layers or cfg.n_layers % m:
            continue
        if cfg.encoder_layers and cfg.encoder_layers % m:
            continue
        ok.append(m)
    return tuple(ok)


def pipeline_schedule_candidates(cfg: ModelConfig, m: int,
                                 n_micro: int) -> Tuple[Tuple[str, int], ...]:
    """(schedule, v) points searchable at m stages with n_micro micros.

    gpipe and 1f1b partition any stack m already divides; interleaved
    additionally needs v chunks per device (layers % (m*v) == 0) and the
    packed Megatron wave (m | n_micro) for its (m-1)/(v*K+m-1) bubble."""
    out = [("gpipe", 1), ("1f1b", 1)]
    v = INTERLEAVE_CHUNKS
    if (n_micro % m == 0 and cfg.n_layers % (m * v) == 0
            and (not cfg.encoder_layers or cfg.encoder_layers % (m * v) == 0)):
        out.append(("interleaved", v))
    return tuple(out)


def tensor_mp_supported(cfg: ModelConfig) -> bool:
    """The paper implements MP for the RNN models (GNMT, BigLSTM) as
    pipeline parallelism only (§4.4); tensor-MP factorizations are searched
    for the other families."""
    return cfg.family != "rnn"


def comm_runtime_supported(cfg: ModelConfig) -> bool:
    """Does the overlapped collective runtime have an executable tensor-MP
    path for this arch?  The SAME arch predicate the runtime gates on
    (``models.transformer.overlapped_arch_supported`` — homogeneous dense
    decoder blocks) plus the gate-major BigLSTM layer; everything else
    falls back to GSPMD at runtime, so the planner must not credit it with
    the matmul overlap (the bucketed DP grad sync is arch-independent and
    stays available to every pure-DP point)."""
    from repro_torch.models.transformer import overlapped_arch_supported
    return cfg.name == "biglstm" or overlapped_arch_supported(cfg)


def grad_bytes(cfg: ModelConfig) -> float:
    return 4.0 * cfg.n_params()          # f32 gradients, paper-style sync-SGD


def step_time_single(cfg: ModelConfig, mini_batch: int, seq: int,
                     hw: HardwareModel) -> float:
    return 6.0 * cfg.n_active_params() * mini_batch * seq / (hw.peak_flops * hw.mfu)


def per_device_mem_bytes(cfg: ModelConfig, *, mp: int = 1,
                         mp_kind: str = "tensor", fsdp: int = 1,
                         mini_batch: int, seq_len: int,
                         opt_bytes_per_param: float = 8.0,
                         remat: bool = True, microbatches: int = 1,
                         schedule: str = "gpipe",
                         virtual_stages: int = 1,
                         pipe_runtime: str = "scheduled") -> float:
    """Projected per-device working set of one training step.

    f32 master params + optimizer state shard over (mp x fsdp); gradients
    shard over mp, and over fsdp too when it is on (ZeRO-2: grads are
    reduce-scattered, never fully materialized per rank); boundary
    activations kept by remat shard over the model axis for tensor-MP.

    Pipeline-MP activations are **schedule-aware** and keyed off the
    runtime that will execute the plan: each in-flight micro-batch holds
    keep_per_layer boundaries for this stage's L/mp layers, and the
    schedule bounds how many micro-batches are in flight
    (``pipeline_activation_residency``: K for gpipe — the full mini-batch,
    the seed's flat model — but only min(K, S) for 1f1b, which is what lets
    1f1b run micro-batch counts gpipe cannot fit).  That bound is only real
    on the hand-scheduled runtime (``pipe_runtime="scheduled"``); the
    AD-through-scan runtime holds all K boundaries for every schedule, so
    planning for it must cost K.
    """
    p = float(cfg.n_params())
    # context-parallel replicates params/opt/grads across the ring (only
    # activations shard 1/mp — CP is the axis to buy when the SEQUENCE is
    # what blows the budget, not the parameters)
    mp_param_shard = 1.0 if mp_kind == "context" else float(max(mp, 1))
    shard = mp_param_shard * max(fsdp, 1)
    state = (4.0 + opt_bytes_per_param) * p / shard
    grads = 4.0 * p / shard
    tokens = float(mini_batch) * float(seq_len)
    boundary = tokens * cfg.d_model * 2.0            # one bf16 (b, s, d)
    keep_per_layer = 1.0 if remat else 8.0           # remat keeps boundaries
    if mp_kind == "pipeline":
        k = max(microbatches, 1)
        per_micro = boundary / k                     # one micro-batch (b/K,s,d)
        resid = pipeline_activation_residency(k, max(mp, 1), schedule,
                                              virtual_stages,
                                              runtime=pipe_runtime)
        act = keep_per_layer * (cfg.n_layers / max(mp, 1)) * per_micro * resid
        # ring in/out buffers, plus the scheduled runtime's up-to-(v-1)
        # in-transit wrap chunks (plan_scheduled_runtime measures them);
        # v = 1 keeps the historical 2-buffer term
        act += (1.0 + max(virtual_stages, 1)) * per_micro
    else:
        act = keep_per_layer * cfg.n_layers * boundary / max(mp, 1)
    return state + grads + act


def default_opt_bytes_per_param(cfg: ModelConfig) -> float:
    """Adam (m + v, f32) for everything that fits; the giant archs train with
    factored adafactor state (the JAX package's
    ``launch/dryrun.ADAFACTOR_ARCHS``)."""
    return 1.0 if cfg.n_params() > 1e11 else 8.0


class HybridPlanner:
    """Unified search over every (pods, N, M, kind, K, schedule) point of
    the device budget: DP-only, N-way DP x M-way tensor-MP, N-way DP x
    M-stage pipeline-MP with K micro-batches under each feasible pipeline
    schedule (gpipe / 1f1b / interleaved), and N-way DP x M-device
    **context parallelism** (sequence-sharded ppermute KV rings,
    ``parallel.context`` — searched where the arch has the CP path and M
    divides the sequence; params replicated, so its memory filter shards
    only activations and its SE pays the full-gradient sync)."""

    def __init__(self, cfg: ModelConfig, *, epoch_model: EpochModel,
                 mini_batch: int = 16, seq_len: int = 4096,
                 dataset_tokens: int = 2 ** 33,
                 hw: HardwareModel = HardwareModel(),
                 se_perfect: bool = False,
                 mp_candidates: Tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                 micro_candidates: Tuple[int, ...] = (2, 4, 8, 16),
                 remat: bool = True,
                 opt_bytes_per_param: Optional[float] = None,
                 pipe_runtime: str = "scheduled",
                 comm_runtime: str = "gspmd",
                 overlap: Mapping[str, float] = MEASURED_OVERLAP):
        self.cfg = cfg
        self.hw = hw
        self.overlap = overlap
        if pipe_runtime not in ("scheduled", "ad"):
            raise ValueError(f"unknown pipe_runtime {pipe_runtime!r}")
        if comm_runtime not in ("gspmd", "overlapped"):
            raise ValueError(f"unknown comm_runtime {comm_runtime!r}")
        # the runtime that will execute pipeline plans: the memory filter
        # must model what the executor actually holds live (the scheduled
        # runtime realizes each schedule's residency bound; AD-through-scan
        # holds all K micro-batches for every schedule)
        self.pipe_runtime = pipe_runtime
        # the collective runtime that will carry tensor-MP matmuls and the
        # DP grad sync: "overlapped" hides overlap["overlapped"] of the wire time
        # (chunked collective-matmul rings / bucketed reduce-scatter sync,
        # with the bucketed alpha cost charged), shifting both SU^M and
        # SE_N — and with them the DP-vs-hybrid crossover.  The matmul
        # overlap is only credited to archs the overlapped runtime actually
        # executes (comm_runtime_supported — everything else runs GSPMD's
        # monolithic collectives no matter what the plan asks for)
        self.comm_runtime = comm_runtime
        self.mp_comm_runtime = (comm_runtime if comm_runtime_supported(cfg)
                                else "gspmd")
        self.epoch_model = epoch_model
        self.mini_batch = mini_batch
        self.seq_len = seq_len
        self.se_perfect = se_perfect
        self.mp_candidates = mp_candidates
        self.micro_candidates = tuple(
            k for k in micro_candidates if k > 1 and mini_batch % k == 0)
        self.remat = remat
        self.opt_bytes_per_param = (default_opt_bytes_per_param(cfg)
                                    if opt_bytes_per_param is None
                                    else opt_bytes_per_param)
        self.pipe_candidates = pipeline_stage_candidates(cfg, mp_candidates)
        t1 = step_time_single(cfg, mini_batch, seq_len, hw)
        tensor_ms = (tuple(m for m in mp_candidates if m > 1)
                     if tensor_mp_supported(cfg) else ())
        # CP's feasibility filter is SEQUENCE divisibility, not heads: the
        # ring shards the token axis, so m must divide the training seq_len
        cp_ms = (tuple(m for m in mp_candidates
                       if m > 1 and seq_len % m == 0)
                 if context_mp_supported(cfg) else ())
        self.run = TrainingRun(
            name=cfg.name, t1=t1, grad_bytes=grad_bytes(cfg),
            mini_batch=mini_batch,
            epoch_model=epoch_model,
            dataset_size=dataset_tokens // seq_len,
            mp_speedup={m: mp_step_speedup(cfg, m, hw, self.mp_comm_runtime,
                                           overlap)
                        for m in tensor_ms},
            cp_speedup={m: cp_step_speedup(cfg, m, hw, mini_batch=mini_batch,
                                           seq_len=seq_len)
                        for m in cp_ms},
            hw=hw, se_perfect=se_perfect,
            comm_overlap=overlap[comm_runtime],
            bucket_bytes=(DEFAULT_BUCKET_BYTES
                          if comm_runtime == "overlapped" else 0.0),
            pipe_speedup={(m, k, sched): pipeline_step_speedup_model(
                              cfg, m, k, hw, mini_batch=mini_batch,
                              seq_len=seq_len, schedule=sched,
                              virtual_stages=v)
                          for m in self.pipe_candidates
                          for k in self.micro_candidates
                          for sched, v in pipeline_schedule_candidates(
                              cfg, m, k)})

    # ---- search ------------------------------------------------------------

    def choices(self, total_devices: int) -> List[PlannerChoice]:
        """All memory-feasible strategy points for the budget, best first."""
        out: List[PlannerChoice] = []
        for m in self.mp_candidates:
            if total_devices % m:
                continue
            n = total_devices // m
            kinds: List[Tuple[str, int, str, int]] = []
            if m == 1:
                kinds.append(("none", 1, "-", 1))
            else:
                if m in self.run.mp_speedup:
                    kinds.append(("tensor", 1, "-", 1))
                if m in self.run.cp_speedup:
                    kinds.append(("context", 1, "-", 1))
                if m in self.pipe_candidates:
                    kinds.extend(
                        ("pipeline", k, sched, v)
                        for k in self.micro_candidates
                        for sched, v in pipeline_schedule_candidates(
                            self.cfg, m, k))
            for kind, k, sched, v in kinds:
                choice = self._evaluate(total_devices, n, m, kind, k, sched, v)
                if choice is not None:
                    out.append(choice)
        # deterministic order: best speedup first, then smaller MP, then the
        # cheaper-to-run kind, then fewer micro-batches; speedup ties between
        # schedules (gpipe vs 1f1b at the same (M, K) are *exactly* equal)
        # break toward the smaller per-device working set — more headroom at
        # identical projected step time
        return sorted(out, key=lambda c: (-c.speedup, c.mp, c.mp_kind,
                                          c.microbatches, c.mem_bytes,
                                          c.schedule))

    def _evaluate(self, total: int, n: int, m: int, kind: str, n_micro: int,
                  sched: str = "-", v: int = 1) -> Optional[PlannerChoice]:
        pipe = kind == "pipeline"
        ctx = kind == "context"
        mp_kind = "pipeline" if pipe else ("context" if ctx else "tensor")
        mem_kw = dict(
            mp=m, mp_kind=mp_kind,
            mini_batch=self.mini_batch, seq_len=self.seq_len,
            opt_bytes_per_param=self.opt_bytes_per_param, remat=self.remat,
            microbatches=n_micro if pipe else 1,
            schedule=sched if pipe else "gpipe",
            virtual_stages=v if pipe else 1,
            pipe_runtime=self.pipe_runtime)
        mem = per_device_mem_bytes(self.cfg, fsdp=1, **mem_kw)
        fsdp = False
        if mem > self.hw.hbm_bytes and n > 1:
            mem = per_device_mem_bytes(self.cfg, fsdp=n, **mem_kw)
            fsdp = True
        if mem > self.hw.hbm_bytes:
            return None                           # pruned: does not fit
        if pipe:
            su = speedup_pipeline(self.run, n, m, n_micro, sched)
            su_m = self.run.pipe_speedup.get((m, n_micro, sched), 0.0)
        elif ctx:
            su = speedup_context(self.run, n, m)
            su_m = self.run.cp_speedup.get(m, 0.0)
        elif kind == "tensor":
            su = speedup_hybrid(self.run, n, m)
            su_m = self.run.mp_speedup.get(m, 1.0)
        else:
            su = speedup_dp(self.run, n)
            su_m = 1.0
        pods = self._pods(total, n)
        dp_axes = ("pod", "data") if pods > 1 else ("data",)
        # stamp each plan with the comm runtime that will actually carry it:
        # pure-DP points get the (arch-independent) bucketed sync, tensor
        # points the matmul rings iff the arch has the overlapped path,
        # pipeline/context points their own ppermute rings (comm_runtime
        # inert for pipeline; the KV ring IS context's comm schedule)
        if pipe or ctx:
            point_comm = "gspmd"
        elif m > 1:
            point_comm = self.mp_comm_runtime
        else:
            point_comm = self.comm_runtime
        plan = ParallelPlan(
            dp_axes=dp_axes,
            model_axis="model" if m > 1 else None,
            fsdp_axes=dp_axes if fsdp else (),
            mp_kind=mp_kind,
            microbatches=n_micro if pipe else 1,
            schedule=sched if pipe else "gpipe",
            virtual_stages=v if pipe else 1,
            runtime=self.pipe_runtime,
            comm_runtime=point_comm,
            remat=self.remat)
        mesh_shape = (pods, n // pods, m) if pods > 1 else (n, m)
        return PlannerChoice(
            pods=pods, dp=n // pods, mp=m, mp_kind=kind,
            microbatches=n_micro if pipe else 1,
            schedule=sched if pipe else "-",
            virtual_stages=v if pipe else 1,
            speedup=su, su_m=su_m,
            se_n=self._se(n, m, context=ctx),
            epochs_ratio=self._eratio(n), mem_bytes=mem,
            mesh_shape=mesh_shape, plan=plan)

    def _pods(self, total: int, n: int) -> int:
        pods = max(1, total // self.hw.chips_per_pod)
        return pods if (total % self.hw.chips_per_pod == 0
                        and n % pods == 0) else 1

    def best(self, total_devices: int) -> PlannerChoice:
        cs = self.choices(total_devices)
        if not cs:
            raise ValueError(
                f"{self.cfg.name}: no memory-feasible strategy for "
                f"{total_devices} devices ({self.hw.hbm_bytes / 2**30:.0f} "
                f"GiB/device)")
        return cs[0]

    def _se(self, n: int, m: int = 1, context: bool = False) -> float:
        if context:
            # params replicated across the ring: full grad bytes over all
            # n*m devices (speedup_context uses the same evaluation)
            return se(self.run, n * m, grad_scale=1.0, hybrid=True)
        return se(self.run, n, grad_scale=1.0 / max(m, 1), hybrid=m > 1)

    def _eratio(self, n: int) -> float:
        return epochs_ratio(self.run, n)

    def crossover(self, m: int = 2, max_devices: int = 4096) -> Optional[int]:
        return crossover_device_count(self.run, m, max_devices)

    # ---- inference-plan search (latency-SLO-constrained) -------------------

    def inference_choices(self, total_devices: int, *, slo_ms: float,
                          context: Optional[int] = None,
                          slot_candidates: Tuple[int, ...] = (
                              1, 2, 4, 8, 16, 32, 64, 128, 256),
                          comm_chunks: int = 1) -> List["InferenceChoice"]:
        """All (DP replicas x TP, slots) serving layouts meeting the
        per-token latency SLO, best sustained tokens/s first.

        The device budget factors into ``replicas`` independent decode
        groups of ``tp`` cards each (SplitBrain's hybrid worker layout);
        for each feasible tp this grows the slot count while the modeled
        decode-step latency stays under ``slo_ms`` and the weights + slot
        KV fit in HBM — both are monotone in slots, so the largest feasible
        count is the per-tp throughput argmax.  Tensor-MP is only searched
        for archs with a tensor path (``tensor_mp_supported``), and the
        ring-overlap credit only where the overlapped runtime actually
        executes (``self.mp_comm_runtime`` — same gate as training)."""
        context = self.seq_len if context is None else context
        out: List[InferenceChoice] = []
        tps = sorted({1, *self.mp_candidates})
        for tp in tps:
            if tp < 1 or total_devices % tp:
                continue
            if tp > 1 and not tensor_mp_supported(self.cfg):
                continue
            if tp > 1 and self.cfg.n_heads % tp:
                continue
            replicas = total_devices // tp
            weight_bytes = 2.0 * self.cfg.n_params() / tp   # bf16 serving
            if weight_bytes > self.hw.hbm_bytes:
                continue
            best = None
            for slots in sorted(slot_candidates):
                t_step = decode_step_time(
                    self.cfg, tp, self.hw, slots=slots, context=context,
                    comm_runtime=self.mp_comm_runtime if tp > 1 else "gspmd",
                    overlap=self.overlap)
                mem = weight_bytes + kv_bytes(self.cfg, slots, context) / tp
                if t_step * 1e3 > slo_ms or mem > self.hw.hbm_bytes:
                    break                       # both monotone in slots
                best = (slots, t_step, mem)
            if best is None:
                continue
            slots, t_step, mem = best
            comm = self.mp_comm_runtime if tp > 1 else "gspmd"
            out.append(InferenceChoice(
                replicas=replicas, tp=tp, slots=slots,
                step_latency=t_step,
                tokens_per_s=replicas * slots / t_step,
                mem_bytes=mem,
                mesh_shape=(replicas if replicas > 1 else 1, tp),
                plan=serve_plan(tp, comm_runtime=comm,
                                comm_chunks=comm_chunks)))
        return sorted(out, key=lambda c: (-c.tokens_per_s, c.tp))

    def best_inference(self, total_devices: int, *, slo_ms: float,
                       context: Optional[int] = None,
                       **kw) -> "InferenceChoice":
        cs = self.inference_choices(total_devices, slo_ms=slo_ms,
                                    context=context, **kw)
        if not cs:
            raise ValueError(
                f"{self.cfg.name}: no serving layout over {total_devices} "
                f"devices meets a {slo_ms:g} ms/token SLO at context "
                f"{context if context is not None else self.seq_len} "
                f"({self.hw.hbm_bytes / 2**30:.0f} GiB/device) — raise the "
                f"SLO, shrink the context, or add devices")
        return cs[0]


def default_epoch_model(cfg: ModelConfig, mini_batch: int = 16) -> EpochModel:
    """Generic LM epoch-inflation prior: critical batch ~ 2-4M tokens for the
    ~1B archs, scaled by sqrt(params) (McCandlish-style heuristic)."""
    b_crit_tokens = 2e6 * math.sqrt(max(cfg.n_active_params(), 1e8) / 1e9)
    return EpochModel(e_inf=1.0, b_crit=b_crit_tokens / 4096, alpha=2.0)
