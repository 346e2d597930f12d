"""The train step (port of ``make_train_step`` in ``repro/train/steps.py``).

``make_train_step(api, optimizer)`` returns ``train_step(state, batch) ->
(state, metrics)``: the loss and its gradients by autograd, the paper's §4.2
delayed-gradient accumulation (a count > 1, ``plan.microbatches`` or
without a plan ``microbatches``, splits the batch, accumulates the
gradients in f32 and updates once), the global-norm clip and the optimizer
update.  PyTorch runs eagerly, so there is no jit; the update
writes the state's tensors in place, and the returned state holds the same
tensors with ``step + 1``.

Given a ``parallel.dist.RankMesh`` and a ``ParallelPlan``, the step is one
rank's part of a DP x pipeline-MP, DP x context-parallel or DP x tensor-MP
step; ``batch`` is the global batch on every rank, and the rank takes its
DP shard (rows of its ``data`` index):

- *pipelined* (``plan.is_pipeline`` over a ``model`` axis > 1): the rank
  holds only its stage's parameters (``init_train_state``) and their
  optimizer state, and its gradients come from the arch's
  ``pipeline_value_and_grad_fn`` (the scheduled runtime; the ``ad`` runtime
  raises, ROADMAP.md Queue 1 item 6b); stage 0 reads the tokens, the last
  stage the labels;
- *context-parallel* (``plan.is_context`` over a ``model`` axis > 1): the
  rank also takes its T/m columns of the tokens and labels (its place on
  the ring, ``model_index``) and runs the forward under a ``ParallelCtx``
  (``_make_pctx``): attention on the KV ring, parameters replicated.  Its
  loss is its masked NLL sum over the valid labels of all ranks, so the
  ranks' losses and gradients sum to the global masked mean's: both are
  summed over every rank, one all-reduce a gradient leaf;
- *tensor MP* (``mp_kind="tensor"`` over a ``model`` axis > 1, or a
  caller's tensor ``pctx``): the rank holds its part of the parameters
  (``init_train_state`` cuts it from the seeded init with
  ``parallel.sharding.shard_params``) and their optimizer state, and runs
  the forward under a tensor ``ParallelCtx`` (``_make_pctx``, JAX's).  Its
  loss is its data shard's share of the global masked mean, so the
  gradients are summed over ``data`` (bucketed or one all-reduce a leaf, per
  model shard) and the loss too.  The model makes every replicated leaf's
  gradient whole on every rank (``copy_to_model`` where its use is
  rank-local); the step then gives each such gradient the bits of the
  group's first rank (a broadcast over ``model``: cuDNN may not compute the
  same bits twice), so replicated leaves leave the step the same on every
  rank;
- *pure DP*: the rank's shard through autograd;
- otherwise the gradients are then summed over the ``data`` group, bucket
  by bucket (``comm_runtime="overlapped"``) or one all-reduce a leaf
  (``"gspmd"``).  Pure DP averages them as the shards' mean losses average;
  a pipelined loss is already scaled by the global token count.  The loss
  is averaged (pure DP) or summed (pipelined) over DP, as JAX's ``pmean``
  and ``psum`` do.

A plan with ``fsdp_axes`` (pure DP, tensor MP or context; the planner's
``("pod", "data")`` narrows to the one-pod mesh's ``data``) also shards the
state over DP, as JAX's ``ShardingRules`` place it: the rank holds its data
shard (``sharding.shard_fsdp``, cut out of its tensor-MP part) of every
leaf the rules give an fsdp dim, f32 master parameters and AdamW's ``m`` and
``v`` alike (Adafactor's ``vr`` and ``vc`` cut as JAX's ``opt_specs`` cut
them), and the other leaves whole.  A step gathers the shards into
the rank's working leaves over ``data`` (``collectives.fsdp_all_gather``),
runs the loss and gradient path above on them, and in place of the sum
over ``data`` reduce-scatters each sharded leaf's gradient to the shard
(``collectives.fsdp_grad_sync``, under either runtime: JAX keeps GSPMD's
sync for fsdp plans); the optimizer then updates the shards.  A pipelined
plan with fsdp raises naming ROADMAP.md Queue 1 item 5b.

Where a rank's leaves are parts, ``_layout`` records where the rest of each
lies (``sharding.leaf_cuts``: the axes that cut it; on a pipeline stage the
stacked layer dim cut over the stages).  The clip sees the global norm,
the single-process one: each rank's sum of squares of a leaf is summed
over the axes that cut the leaf (``data`` for a fsdp shard, ``model`` for a
tensor-MP part, and on a pipelined rank over the stages, a tied embedding
counted once); a leaf that is whole on every rank is counted once (a
context-parallel rank's gradients are already whole).  The optimizer gets
the same record (``optim.LeafCuts``): Adafactor's statistics are the whole
leaf's.  Tensor MP runs the dense, MoE (expert parallelism) and RWKV
decoders, BigLSTM, GNMT and Inception-V3; of another arch it raises naming
its item (``check_plan``).  The ``loss`` metric is the loss function's, as
JAX's (an MoE model's without its aux loss), summed or averaged as the
loss is.

Checkpoints hold a state's global form, JAX's layout (``interop.
param_shapes``: stacked (L, ...) decoder leaves, BigLSTM's list of layer
dicts, an f32 ``m`` and ``v`` a parameter, Adafactor's accumulators a
parameter): ``eval_train_state`` is the
``like`` tree of a restore, ``global_state`` gathers a run's state to its
writing rank, ``place_state`` cuts a rank's part back out of a restored
global state, and ``checkpoint_saver`` is the loop's saver on ranks.

``make_continuous_steps`` is the serving side's pair of steps (JAX keeps it
here too): the continuous engine's decode tick and prefill chunk over a
slotted cache, on one device or on a rank's part of it (the tensor-MP tick
and chunk, the context-parallel chunk).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import transformer as tf_mod
from repro_torch.models.api import ModelApi, cache_extract_slot, cache_insert_slot
from repro_torch.models.transformer import (ParallelCtx, cp_arch_supported, cp_supported,
                                            is_tensor_ctx, tensor_mp_item, unported)
from repro_torch.optim.optimizers import (LeafCuts, Optimizer, apply_updates,
                                          clip_by_global_norm, sum_of_squares)
from repro_torch.models.moe import check_expert_parallel
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import dist as D
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.collectives import (DEFAULT_BUCKET_BYTES, all_reduce_grads,
                                              bucketed_grad_sync, fsdp_all_gather,
                                              fsdp_grad_sync)
from repro_torch.parallel.pipeline import AD_RUNTIME, stages_to_stack
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

FSDP_REST = "ROADMAP.md Queue 1 item 5b (the fsdp plans: pipelined plans with fsdp)"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int
    # True while the optimizer writes the tensors in place: a step that
    # fails then has left a state that cannot be retried
    in_update: bool = False


def check_plan(plan, model: int, cfg=None) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a plan the
    port's ranks do not run over a ``model`` axis of that size: tensor MP of
    an arch that ``tensor_mp_item`` names (the other families; ``cfg``, not
    checked without one), parameters sharded over DP across pipeline stages,
    the ``ad`` pipeline runtime; and ValueError for a tensor plan whose model
    axis cannot split an MoE model's experts (``moe.check_expert_parallel``)."""
    if plan.fsdp_axes and plan.is_pipeline and model > 1:
        raise NotImplementedError(f"a pipelined plan with parameters sharded over DP is "
                                  f"not ported to repro_torch yet: {FSDP_REST}")
    if plan.model_axis is None or model == 1:
        return
    if plan.mp_kind == "tensor":
        item = tensor_mp_item(cfg) if cfg is not None else None
        if item is not None:
            raise NotImplementedError(f"tensor MP of {cfg.name} is not ported to "
                                      f"repro_torch yet: {item}")
        if cfg is not None and cfg.is_moe:
            check_expert_parallel(cfg, model)
        return
    if plan.runtime == "ad":
        raise NotImplementedError(f"the ad pipeline runtime is not ported to repro_torch "
                                  f"yet: {AD_RUNTIME}")


def _pipelined(plan, mesh) -> bool:
    return (plan is not None and mesh is not None and plan.is_pipeline
            and mesh.shape["model"] > 1)


def _make_pctx(mesh, plan):
    """JAX's ``_make_pctx`` over a ``model`` axis of more than one rank: a
    context plan's ctx (the axis hosts the KV ring) or a tensor plan's (the
    axis shards the parameters, the batch lies over ``data``); None
    otherwise (a pipelined plan, one rank on the axis)."""
    if plan is None or mesh is None or plan.model_axis is None or mesh.shape["model"] == 1:
        return None
    if plan.is_context:
        return ParallelCtx(mesh=mesh, context_axis=plan.model_axis)
    if plan.mp_kind == "tensor":
        return ParallelCtx(mesh=mesh, context_axis=None, batch_axes=("data",),
                           model_axis=plan.model_axis, comm_runtime=plan.comm_runtime,
                           comm_chunks=plan.comm_chunks)
    return None


def _rules(cfg, mesh, plan) -> SH.ShardingRules:
    return SH.ShardingRules(cfg, dict(mesh.shape), (plan or ParallelPlan()).one_pod())


def _fsdp_rules(cfg, mesh, plan):
    """The sharding rules of a plan that shards the state over more than one
    data rank, else None."""
    if mesh is None or plan is None or not plan.fsdp_axes or mesh.shape["data"] == 1:
        return None
    return _rules(cfg, mesh, plan)


def init_train_state(api: ModelApi, optimizer: Optimizer, seed: int = 0, *,
                     mesh=None, plan=None) -> TrainState:
    """The seeded init and its optimizer state; a pipelined rank's holds
    only its stage (``api.init_pipeline_stage``), a tensor-MP rank only its
    part (``parallel.sharding.shard_params`` of the whole seeded init), and
    a fsdp rank only its data shard of that (``sharding.shard_fsdp``)."""
    if _pipelined(plan, mesh):
        params = api.init_pipeline_stage(seed, mesh.shape["model"], plan.virtual_stages,
                                         mesh.model_index)
    elif is_tensor_ctx(_make_pctx(mesh, plan)):
        params = SH.shard_params(api.init(seed), _rules(api.cfg, mesh, plan),
                                 mesh.model_index)
    else:
        params = api.init(seed)
    frules = _fsdp_rules(api.cfg, mesh, plan)
    if frules is not None:
        params = SH.shard_fsdp(params, frules, mesh.data_index,
                               SH.param_specs(api.cfg, frules))
    return TrainState(params=params, opt_state=optimizer.init(
        params, _layout(api.cfg, params, mesh, plan)[1]), step=0)


def _layout(cfg, params, mesh, plan):
    """Where the rest of each leaf of this rank's ``params`` lies, in
    ``tree_leaves`` order: (cuts, opt_cuts).  ``cuts`` maps each leaf's cut
    dims to the axis each is cut over (``sharding.leaf_cuts``: a tensor-MP
    part's model dim, a fsdp shard's data dim), None for a pipelined rank
    or where nothing is cut; ``opt_cuts`` are the optimizer's
    ``LeafCuts`` (None where every leaf is whole): those cuts, and on a
    pipeline stage its part of each stacked leaf, the (v, Lc) chunks of the
    decoder's layer dim folded into one dim cut over the stages, and
    BigLSTM's stacked layers separate leaves, as one process holds them."""
    if mesh is None or plan is None:
        return None, None
    if _pipelined(plan, mesh):
        key = "lstm" if cfg.family == "rnn" else "layers"
        stages = mesh.shape["model"]

        def over_stages(t, dims):
            return D.all_reduce(mesh, t, "model")

        stacked = (LeafCuts(lead=2) if key == "lstm" else
                   LeafCuts(parts={0: stages}, sum=over_stages, fold=2))
        return None, [stacked if k == key else LeafCuts()
                      for k in sorted(params) for _ in tree_leaves(params[k])]
    tensor = is_tensor_ctx(_make_pctx(mesh, plan))
    if not tensor and _fsdp_rules(cfg, mesh, plan) is None:
        return None, None
    rules = _rules(cfg, mesh, plan)
    cuts = SH.leaf_cuts(params, SH.param_specs(cfg, rules), rules)

    def cut_sum(axes):
        def total(t, dims):
            return D.all_reduce(mesh, t, CL.axes_group(mesh, [axes[d] for d in dims]))
        return total

    return cuts, [LeafCuts(parts={d: mesh.size(a) for d, a in c.items()}, sum=cut_sum(c))
                  for c in cuts]


def eval_train_state(api: ModelApi, optimizer: Optimizer) -> TrainState:
    """The global state's shapes and dtypes with no storage (meta tensors):
    the ``like`` tree of ``checkpoint.restore_checkpoint``.  Its parameters
    are the init's on the meta device, checked against
    ``interop.param_shapes``, then ``optimizer.init`` of them, step 0."""
    from repro_torch.interop import param_shapes

    params = api.init(0, device="meta")
    shapes = tree_map(lambda t: tuple(t.shape), params)
    if shapes != _shape_leaves(param_shapes(api.cfg)):
        raise ValueError(f"{api.cfg.name}: the init's parameter tree differs from "
                         f"interop.param_shapes (the checkpoint layout)")
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _shape_leaves(shapes):
    """``interop.param_shapes``' tree with the shape tuples as leaves."""
    if isinstance(shapes, dict):
        return {k: _shape_leaves(v) for k, v in sorted(shapes.items())}
    if isinstance(shapes, list):
        return [_shape_leaves(v) for v in shapes]
    return tuple(shapes)


def _state_trees(state: TrainState) -> dict:
    """The trees of a state that mirror the parameter tree: the parameters
    and each entry of the optimizer state (AdamW's ``m`` and ``v``,
    momentum's ``m``: parameter-shaped; Adafactor's ``acc``: a dict of its
    accumulators a parameter, ``sharding.state_specs``)."""
    opt = state.opt_state
    if opt in ((), None):
        return {"params": state.params}
    if not isinstance(opt, dict):
        raise ValueError(f"a checkpoint on ranks needs a dict optimizer state, got "
                         f"{type(opt).__name__}")
    return {"params": state.params, **{f"opt/{k}": v for k, v in opt.items()}}


def _from_trees(trees: dict, state: TrainState) -> TrainState:
    """``state`` with the trees of ``_state_trees`` replaced by ``trees``."""
    opt = state.opt_state
    if isinstance(opt, dict):
        opt = {k: trees[f"opt/{k}"] for k in opt}
    return TrainState(params=trees["params"], opt_state=opt, step=state.step)


def _whole_on_stages(path, t) -> bool:
    """Adafactor's column statistic of a stacked decoder leaf (L, d): (d,),
    a mean over every layer, whole on every pipeline stage (JAX's ``vc``
    spec drops the stage-cut dim)."""
    return path[0] == "layers" and path[-1] == "vc" and t.dim() == 1


def _map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_path(fn, t, path + (str(i),)) for i, t in enumerate(tree))
    return fn(path, tree)


def _stages_to_global(parts, cfg, n_stages: int, v: int):
    """The global tree from every stage's part (in stage order): the stage
    leaves stacked (S, v, Lc, ...) and reassembled as (L, ...) (a leaf
    ``_whole_on_stages`` from the first stage), BigLSTM's back into one dict
    a layer; the embedding from the first stage (a tied one is on the last
    too, the same bits), the head from the last."""
    key = "lstm" if cfg.family == "rnn" else "layers"
    out = {}
    for part in parts:
        for k, t in part.items():
            if k != key and k not in out:
                out[k] = t
    rest = iter(zip(*(tree_leaves(p[key]) for p in parts[1:])))

    def join(path, t):
        others = next(rest, ())
        if _whole_on_stages(path, t):
            return t
        return stages_to_stack(torch.stack((t, *others)), n_stages, v)

    stacked = _map_path(join, parts[0][key], (key,))
    if key == "lstm":
        stacked = [tree_map(lambda t, i=i: t[i], stacked) for i in range(cfg.n_layers)]
    out[key] = stacked
    return {k: out[k] for k in sorted(out)}


def _stage_part(api, tree, n_stages: int, v: int, stage: int):
    """``api.pipeline_stage_params`` of a state tree: a leaf
    ``_whole_on_stages`` kept whole on every stage."""
    whole = {}

    def stash(path, t):
        if not _whole_on_stages(path, t):
            return t
        whole[path] = t
        return t.expand(api.cfg.n_layers, *t.shape)      # cut as a stacked leaf, then undone

    part = api.pipeline_stage_params(_map_path(stash, tree), n_stages, v, stage)
    return _map_path(lambda path, t: whole.get(path, t), part)


def _gathered(state: TrainState, mesh, axis: str, join) -> TrainState | None:
    """``state`` joined over this rank's ``axis`` group on the group's first
    rank (``join(parts, tree)`` a tree of ``_state_trees``, from the parts
    in group order, on the host, and this rank's own); None on the
    others."""
    trees = _state_trees(state)
    parts = D.gather_tree(mesh, trees, axis)
    if parts is None:
        return None
    # the peers' parts arrive where the transport carries them: assemble on
    # the host, where the writer reads every leaf anyway
    parts = [tree_map(lambda t: t.detach().cpu(), p) for p in parts]
    return _from_trees({k: join([p[k] for p in parts], trees[k]) for k in trees}, state)


def global_state(state: TrainState, api: ModelApi, mesh, plan):
    """The whole state in JAX's layout on the writing rank (rank 0; on the
    host where it was gathered), None on every other rank.  Every rank calls
    it at the same step: the gathers are collectives.  A fsdp rank's shards
    are first gathered over its data group (``sharding.gather_fsdp``); DP and
    context ranks then hold replicas (rank 0's is the state); a tensor-MP
    rank's parts are gathered over the model group of the first replica
    (``sharding.gather_params``); a pipeline stage's are sent to rank 0 and
    reassembled (``pipeline.stages_to_stack``).  In one process (``mesh``
    None) it is the state itself."""
    if mesh is None:
        return state
    if plan is not None:
        check_plan(plan, mesh.shape["model"], api.cfg)
    pipelined, tensor = _pipelined(plan, mesh), is_tensor_ctx(_make_pctx(mesh, plan))
    frules = _fsdp_rules(api.cfg, mesh, plan)
    if frules is not None:
        specs = SH.param_specs(api.cfg, frules)
        state = _gathered(state, mesh, "data", lambda parts, tree: SH.gather_fsdp(
            parts, frules, SH.state_specs(tree, specs)))
        if state is None:
            return None
    if not (pipelined or tensor):
        return state if mesh.rank == 0 else None
    if mesh.data_index != 0:
        return None
    if pipelined:
        return _gathered(state, mesh, "model", lambda parts, tree: _stages_to_global(
            parts, api.cfg, mesh.shape["model"], max(plan.virtual_stages, 1)))
    rules = _rules(api.cfg, mesh, plan)
    specs = SH.param_specs(api.cfg, rules)
    return _gathered(state, mesh, "model", lambda parts, tree: SH.gather_params(
        parts, rules, SH.state_specs(tree, specs)))


def place_state(state: TrainState, api: ModelApi, mesh=None, plan=None) -> TrainState:
    """This rank's part of a global state on its device, cut as
    ``init_train_state`` cuts the init: a pipeline stage's pieces
    (``api.pipeline_stage_params``), a tensor-MP rank's slices
    (``sharding.shard_params``), or the whole tree (one process, DP and
    context ranks), and of that a fsdp rank's data shard
    (``sharding.shard_fsdp``).  Cuts are made on the host, then moved."""
    device = api.device if mesh is None else mesh.device
    trees = _state_trees(state)
    if _pipelined(plan, mesh):
        s, v = mesh.shape["model"], plan.virtual_stages
        trees = {k: _stage_part(api, t, s, v, mesh.model_index) for k, t in trees.items()}
    elif is_tensor_ctx(_make_pctx(mesh, plan)):
        rules = _rules(api.cfg, mesh, plan)
        specs = SH.param_specs(api.cfg, rules)
        trees = {k: SH.shard_params(t, rules, mesh.model_index, SH.state_specs(t, specs))
                 for k, t in trees.items()}
    frules = _fsdp_rules(api.cfg, mesh, plan)
    if frules is not None:
        specs = SH.param_specs(api.cfg, frules)
        trees = {k: SH.shard_fsdp(t, frules, mesh.data_index, SH.state_specs(t, specs))
                 for k, t in trees.items()}
    trees = tree_map(lambda t: t.to(device), trees)
    return _from_trees(trees, state)


def checkpoint_saver(api: ModelApi, mesh, plan):
    """The loop's ``save`` on ranks: every rank gathers (``global_state``),
    rank 0 writes (or, in the background, starts to), then every rank waits
    at a barrier, so that after a sync save no rank reads the directory
    before the file is whole.  Returns the file name on every rank."""
    from repro_torch.checkpoint import checkpoint_path, save_checkpoint

    def save(path, state, step, *, keep_last=0, background=False):
        whole = global_state(state, api, mesh, plan)
        if mesh.rank == 0:
            save_checkpoint(path, whole, step, keep_last=keep_last, background=background)
        del whole
        D.barrier(mesh)
        return checkpoint_path(path, step)

    return save


def _dp_shard(batch, mesh):
    """The rows of ``batch`` this rank's ``data`` index owns."""
    dp, d = mesh.shape["data"], mesh.data_index
    b = next(iter(batch.values())).shape[0]
    if b % dp:
        raise ValueError(f"batch {b} does not split over {dp} DP ranks")
    n = b // dp
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def _cp_shard(batch, pctx, cfg):
    """This rank's T/m columns of every (B, T) entry of ``batch``: those of
    its place j on the ring; raises where the ring cannot run (JAX falls
    back to GSPMD there, which the port does not have)."""
    j, m = pctx.mesh.ring(pctx.context_axis)[:2]
    t = next(iter(batch.values())).shape[1]
    if not cp_supported(cfg, pctx, t):
        raise ValueError(f"{cfg.name}: a context ring of {m} cannot run a sequence of {t} "
                         f"(cp_supported)")
    n = t // m
    return {k: v[:, j * n:(j + 1) * n] for k, v in batch.items()}


def make_train_step(api: ModelApi, optimizer: Optimizer, *, mesh=None, plan=None,
                    clip_norm: float = 1.0, pctx=None, microbatches: int = 1,
                    bucket_bytes=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics hold
    0-d tensors ``loss`` and, with ``clip_norm``, ``grad_norm`` (and, on a
    pipelined rank, ``store_high_water``: the peak stashed stage inputs).
    The §4.2 accumulation count is ``plan.microbatches`` where a plan is
    given (as in JAX) and ``microbatches`` otherwise."""
    if pctx is not None:      # a caller's ctx: tensor MP over its mesh
        item = tensor_mp_item(api.cfg)
        if item is not None:
            raise NotImplementedError(f"tensor MP of {api.cfg.name} is not ported to "
                                      f"repro_torch yet: {item}")
        if not is_tensor_ctx(pctx):
            raise ValueError("a caller's pctx must be a tensor-MP ParallelCtx over a "
                             "model axis of more than one rank (a context plan makes its "
                             "own)")
        mesh = pctx.mesh if mesh is None else mesh
        plan = plan or ParallelPlan(model_axis=pctx.model_axis,
                                    comm_runtime=pctx.comm_runtime,
                                    comm_chunks=pctx.comm_chunks)
    if plan is not None:
        check_plan(plan, mesh.shape["model"] if mesh is not None else 1, api.cfg)
    pipelined = _pipelined(plan, mesh)
    pctx = pctx or _make_pctx(mesh, plan)
    tensor = is_tensor_ctx(pctx)
    if pctx is not None and not tensor and not cp_arch_supported(api.cfg):
        raise ValueError(f"{api.cfg.name}: a context-parallel plan needs a homogeneous "
                         f"dense decoder without logit softcap (cp_arch_supported)")
    if plan is not None and microbatches not in (1, plan.microbatches):
        raise ValueError(f"microbatches={microbatches} disagrees with the plan's "
                         f"{plan.microbatches}: a plan carries its own count")
    # a pipelined plan's microbatches are in-flight micro-batches, not accumulation
    micro = 1 if pipelined else int(plan.microbatches if plan is not None else microbatches)
    if micro < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    dp = mesh.shape["data"] if mesh is not None else 1
    comm = plan.comm_runtime if plan is not None else "gspmd"
    bkt = DEFAULT_BUCKET_BYTES if bucket_bytes is None else bucket_bytes
    # a tied embedding lives on the first and the last stage: count it once
    skip_in_norm = ("embed",) if (pipelined and api.cfg.tie_embeddings
                                  and mesh.model_index == mesh.shape["model"] - 1) else ()
    # per leaf, in tree_leaves order, set at the first step (``_layout``):
    # the axes each is cut over, the optimizer's cuts, the fsdp dims
    cuts, opt_cuts, fdims = [], [], []
    frules = _fsdp_rules(api.cfg, mesh, plan)

    def grads_of(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = api.loss_fn(leaves, batch, pctx)
            flat = tree_leaves(leaves)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def total_grads(params, batch):
        if pipelined:
            (loss, metrics), grads = api.pipeline_value_and_grad_fn(
                params, batch, mesh=mesh, n_micro=max(plan.microbatches, 1),
                schedule=plan.schedule, virtual_stages=plan.virtual_stages)
            return loss, metrics, grads
        if micro == 1:
            return grads_of(params, batch)
        # delayed gradient update (paper §4.2): split the per-step batch into
        # `micro` micro-batches, accumulate grads, update once
        b = next(iter(batch.values())).shape[0]
        if b % micro:
            raise ValueError(f"batch {b} does not split into {micro} micro-batches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        losses = []
        for i in range(micro):
            mb = {k: v.reshape(micro, b // micro, *v.shape[1:])[i] for k, v in batch.items()}
            loss, _, grads = grads_of(params, mb)
            tree_map(lambda a, g: a.add_(g), acc, grads)
            losses.append(loss)
            del grads
        tree_map(lambda a: a.div_(micro), acc)
        loss = torch.stack(losses).mean()
        return loss, {"loss": loss}, acc

    def data_sum(grads):
        """The gradients summed over the data group: a fsdp leaf's
        reduce-scattered to the rank's shard, the rest bucket by bucket or
        one all-reduce a leaf."""
        if frules is not None:
            return fsdp_grad_sync(grads, fdims, mesh)
        if comm == "overlapped":
            return bucketed_grad_sync(grads, mesh, bucket_bytes=bkt)
        return all_reduce_grads(grads, mesh)

    def synced_grads(params, batch):
        """The rank's metrics and gradients, summed over DP (and the ring);
        the ``loss`` metric is the loss function's (without the aux loss, as
        JAX's) summed or averaged as the loss is."""
        if mesh is None:
            return total_grads(params, batch)[1:]
        batch = _dp_shard(batch, mesh)
        if pctx is not None and not tensor:
            batch = _cp_shard(batch, pctx, api.cfg)
        if not pipelined:
            batch = {k: v.to(mesh.device) for k, v in batch.items()}
        _, metrics, grads = total_grads(params, batch)
        loss = metrics["loss"].detach().clone()
        if tensor:              # shares of the global mean: sum over the data shards
            if dp > 1:
                grads = data_sum(grads)
                loss = D.all_reduce(mesh, loss, "data")
            for g, c in zip(tree_leaves(grads), cuts):
                if "model" not in c.values():   # whole on every rank: the same bits
                    D.broadcast(mesh, g, "model")
            return dict(metrics, loss=loss), grads
        if pctx is not None:    # shares of the global mean: sum over every rank
            if frules is not None:
                grads = data_sum(all_reduce_grads(grads, mesh, axis="model"))
            else:
                all_reduce_grads(grads, mesh, axis=None)
            return dict(metrics, loss=D.all_reduce(mesh, loss)), grads
        if dp > 1:
            grads = data_sum(grads)
            loss = D.all_reduce(mesh, loss, "data")
            if not pipelined:       # the mean of the shards' mean losses
                tree_map(lambda g: g.div_(dp), grads)
                loss = loss / dp
            metrics = dict(metrics, loss=loss)
        return metrics, grads

    def global_norm(grads) -> torch.Tensor:
        if pipelined:
            sq = sum_of_squares({k: g for k, g in grads.items() if k not in skip_in_norm})
            return torch.sqrt(D.all_reduce(mesh, sq, "model"))
        # each leaf's squares summed over the axes that shard it, a whole leaf once
        leaves = tree_leaves(grads)
        zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        axes = [set(c.values()) for c in cuts] if cuts else [set()] * len(leaves)
        on_data = ["data" in a for a in axes]
        on_model = ["model" in a for a in axes]

        def squares(data: bool, model: bool):
            sel = [g for g, d, m in zip(leaves, on_data, on_model) if d == data and m == model]
            return (sum_of_squares(sel) if sel else zero).clone()

        total = squares(False, False)
        if any(on_model):
            total = D.all_reduce(mesh, squares(False, True), "model") + total
        if any(on_data):
            part = squares(True, False)
            if any(on_model):
                part = part + D.all_reduce(mesh, squares(True, True), "model")
            total = total + D.all_reduce(mesh, part, "data")
        return torch.sqrt(total)

    def train_step(state: TrainState, batch):
        params = state.params
        if mesh is not None and not opt_cuts:
            c, oc = _layout(api.cfg, params, mesh, plan)
            cuts.extend(c or ())
            opt_cuts.append(oc)
            fdims.extend(next((d for d, a in x.items() if a == "data"), None) for x in cuts)
        if frules is not None:      # the shards gathered into the working leaves
            metrics, grads = synced_grads(fsdp_all_gather(params, fdims, mesh), batch)
        else:
            metrics, grads = synced_grads(params, batch)
        if clip_norm:
            norm = global_norm(grads) if pipelined or tensor or frules is not None else None
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm=norm)
            metrics = dict(metrics, grad_norm=gnorm)
        state.in_update = True
        updates, opt_state = optimizer.update(grads, state.opt_state, params, state.step,
                                              opt_cuts[0] if opt_cuts else None)
        del grads
        apply_updates(params, updates)
        state.in_update = False
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step


def sample_tokens(logits, temperature: float, generators=None):
    """(next token (B,) int64, its log-probability (B,) f32) from ``logits``
    (B, V): greedy (the first largest, as ``jnp.argmax``) when temperature
    <= 0, else row r drawn from softmax(logits / temperature) with
    ``generators[r]`` (rows whose generator is None take the greedy token).
    Everything stays on the logits' device."""
    lg = logits.float()
    nxt = lg.argmax(-1)
    if temperature > 0.0 and generators is not None:
        probs = torch.softmax(lg / temperature, dim=-1)
        for r, gen in enumerate(generators):
            if gen is not None:
                nxt[r] = torch.multinomial(probs[r], 1, generator=gen)[0]
    lp = torch.gather(torch.log_softmax(lg, dim=-1), 1, nxt[:, None])[:, 0]
    return nxt, lp


def make_continuous_steps(api: ModelApi, *, n_slots: int, temperature: float = 0.0,
                          mesh=None, model_axis=None, batch_axes=(), comm_chunks: int = 1,
                          window=None, context_axis=None):
    """``(decode_tick, prefill_chunk, prefill_grid)`` for the continuous
    engine (``serve.continuous``), on one device or, with ``mesh`` (this
    rank's ``parallel.dist.RankMesh``), on this rank's part of the slot
    cache (``parallel.sharding.slot_cache_part``), routed as JAX's
    ``make_continuous_steps`` routes:

    - the tick runs ``transformer.decode_slots_tp`` when a ``model_axis`` of
      more than one rank is given (``decode_slots_tp_supported`` must hold:
      the port has no GSPMD to fall back to, so a mesh it cannot shard
      raises), else the one-device tick on the rank's slots (under a
      ``context_axis``, on every rank of the ring);
    - the chunk runs ``prefill_chunk_cp`` under a ``context_axis`` whose
      ring ``prefill_chunk_cp_supported`` accepts, else ``prefill_chunk_tp``
      under the model axis, else the one-device extend step;
    - a sharded chunk that does not divide ``prefill_grid`` (m x
      ``comm_chunks`` for TP, m for CP) is padded up to it and runs the same
      sharded path with ``n_valid``; ``prefill_grid`` (1 unsharded) is
      returned for the engine's pad guard.

    Every rank calls the steps with the same arguments.
    ``decode_tick(params, cache, tokens, active, generators)`` runs ONE
    token step for every slot (``tokens`` and ``active`` (n_slots,) on the
    device, ``generators`` a list of n_slots per-slot generators or None):
    each data group ticks and samples its own slots (``sample_tokens``) and
    the tokens and logprobs are all-gathered over the data axes, so every
    rank returns the same (n_slots,) pair.  ``pos`` advances only for
    ``active`` slots; an inactive slot writes at min(pos, capacity - 1) (its
    write is overwritten at its next admission or chunk).
    ``prefill_chunk(params, cache, tokens (1, t), slot)`` extends global
    slot ``slot`` by a chunk on the data group that holds it and returns the
    chunk's last-position logits (1, V) on every rank (summed over the data
    axes with the other groups' zeros).  Both update the cache in place and
    return it.  ``params`` is this rank's part: the whole tree, or under TP
    ``parallel.sharding.serve_tp_part``'s."""
    cfg = api.cfg
    chunks = max(comm_chunks, 1)
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    if mesh is None and (model_axis is not None or context_axis is not None):
        raise ValueError("model_axis and context_axis shard over a mesh; none was given")
    if model_axis is not None and context_axis is not None:
        raise ValueError(f"model_axis {model_axis!r} and context_axis {context_axis!r}: the "
                         f"port's rank mesh has one axis beside the data axis, so a run "
                         f"shards the model or the context, not both")
    if mesh is not None and model_axis is None and context_axis is None and not batch_axes:
        raise ValueError("a mesh with no model_axis, context_axis or batch_axes shards "
                         "nothing: name the axes the engine runs over")
    lo, n_loc = SH.slot_range(n_slots, mesh, batch_axes)
    dp = n_slots // n_loc
    use_tp = model_axis is not None and mesh.size(model_axis) > 1
    if use_tp and tensor_mp_item(cfg) is not None:
        raise unported(f"tensor-MP serving of {cfg.name}", tensor_mp_item(cfg))
    if use_tp and not tf_mod.decode_slots_tp_supported(cfg, mesh, model_axis, batch_axes,
                                                       n_slots, chunks):
        raise ValueError(
            f"{cfg.name}: the tensor-MP tick needs a homogeneous dense decoder with n_heads "
            f"({cfg.n_heads}) and d_ff ({cfg.d_ff}) divisible by the "
            f"{mesh.size(model_axis)}-way model axis and n_slots ({n_slots}) divisible over "
            f"dp x mp x comm_chunks ({dp} x {mesh.size(model_axis)} x {chunks}) "
            f"(decode_slots_tp_supported); the port has no GSPMD to fall back to")
    cp_grid = tp_grid = 0
    if context_axis is not None and tf_mod.prefill_chunk_cp_supported(
            cfg, mesh, context_axis, mesh.size(context_axis)):
        cp_grid = mesh.size(context_axis)
    if use_tp and tf_mod.prefill_chunk_tp_supported(
            cfg, mesh, model_axis, mesh.size(model_axis) * chunks, chunks):
        tp_grid = mesh.size(model_axis) * chunks

    def gather_slots(nxt, lp):
        """Every data group's (token, logprob) pairs, in slot order."""
        if dp == 1:
            return nxt, lp
        mine = torch.stack([nxt.double(), lp.double()], dim=1)       # exact in f64
        out = mine.new_empty((n_slots, 2))
        D.all_gather(mesh, out, mine, "data")
        return out[:, 0].long(), out[:, 1].float()

    @torch.inference_mode()
    def decode_tick(params, cache, tokens, active, generators=None):
        tok, act = tokens[lo:lo + n_loc], active[lo:lo + n_loc]
        pos = cache["pos"]
        cap = cache["k"].shape[2]
        write = {**cache, "pos": torch.where(act, pos, pos.clamp(max=cap - 1))}
        if use_tp:
            logits, _ = tf_mod.decode_slots_tp(cfg, params, write, {"tokens": tok[:, None]},
                                               mesh=mesh, model_axis=model_axis,
                                               batch_axes=batch_axes, comm_chunks=chunks,
                                               window_override=window)
        else:
            logits, _ = api.decode_fn(params, write, {"tokens": tok[:, None]}, None, window)
        gens = None if generators is None else list(generators)[lo:lo + n_loc]
        nxt, lp = sample_tokens(logits[:, -1], temperature, gens)
        cache["pos"] = torch.where(act, pos + 1, pos)
        return (cache, *gather_slots(nxt, lp))

    @torch.inference_mode()
    def prefill_chunk(params, cache, tokens, slot: int):
        last = None
        if lo <= slot < lo + n_loc:
            sl = cache_extract_slot(cache, slot - lo)
            t = tokens.shape[1]
            grid = cp_grid or tp_grid
            if grid:
                t_pad = -(-t // grid) * grid
                toks = torch.nn.functional.pad(tokens, (0, t_pad - t)) if t_pad != t else tokens
                kw = dict(mesh=mesh, window_override=window, n_valid=t)
                if cp_grid:
                    logits, sl = tf_mod.prefill_chunk_cp(cfg, params, sl, {"tokens": toks},
                                                         context_axis=context_axis, **kw)
                else:
                    logits, sl = tf_mod.prefill_chunk_tp(cfg, params, sl, {"tokens": toks},
                                                         model_axis=model_axis,
                                                         comm_chunks=chunks, **kw)
            else:
                logits, sl = api.decode_fn(params, sl, {"tokens": tokens}, None, window)
            cache = cache_insert_slot(cache, sl, slot - lo)
            last = logits[:, -1]
        if dp > 1:      # the holder's logits on every data group: the others add zeros
            part = (last.float() if last is not None else
                    torch.zeros((1, cfg.vocab_padded), dtype=torch.float32,
                                device=cache["pos"].device))
            last = D.all_reduce(mesh, part.contiguous(), "data")
        return cache, last

    return decode_tick, prefill_chunk, cp_grid or tp_grid or 1
