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

The clip sees the global norm: each rank's sum of squares (a tied embedding
counted once) is summed over the ``model`` group after the DP sync, so the
clip scale is the single-process one (a context-parallel rank's
gradients are already whole; a tensor-MP rank sums its sharded leaves over
``model`` and counts the replicated ones once).  Tensor MP of an arch the
port does not shard raises naming its item (``check_plan``), and
parameters sharded over DP raise (item 5's remainder, fsdp).

Checkpoints hold a state's global form, JAX's layout (``interop.
param_shapes``: stacked (L, ...) decoder leaves, BigLSTM's list of layer
dicts, an f32 ``m`` and ``v`` a parameter): ``eval_train_state`` is the
``like`` tree of a restore, ``global_state`` gathers a run's state to its
writing rank, ``place_state`` cuts a rank's part back out of a restored
global state, and ``checkpoint_saver`` is the loop's saver on ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.api import ModelApi
from repro_torch.models.transformer import (ParallelCtx, cp_arch_supported, cp_supported,
                                            is_tensor_ctx, tensor_mp_item)
from repro_torch.optim.optimizers import (Optimizer, apply_updates, clip_by_global_norm,
                                          sum_of_squares)
from repro_torch.parallel import dist as D
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.collectives import (DEFAULT_BUCKET_BYTES, all_reduce_grads,
                                              bucketed_grad_sync)
from repro_torch.parallel.pipeline import AD_RUNTIME, stages_to_stack
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

FSDP = "ROADMAP.md Queue 1 item 5 (data parallelism: the fsdp plans are its remainder)"


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
    an arch other than the dense decoder and the CNN (``cfg``; not checked
    without one), parameters sharded over DP, the ``ad`` pipeline
    runtime."""
    if plan.fsdp_axes:
        raise NotImplementedError(f"parameters sharded over DP are not ported to "
                                  f"repro_torch yet: {FSDP}")
    if plan.model_axis is None or model == 1:
        return
    if plan.mp_kind == "tensor":
        item = tensor_mp_item(cfg) if cfg is not None else None
        if item is not None:
            raise NotImplementedError(f"tensor MP of {cfg.name} is not ported to "
                                      f"repro_torch yet: {item}")
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


def _tensor_rules(cfg, mesh, plan) -> SH.ShardingRules:
    return SH.ShardingRules(cfg, dict(mesh.shape), plan or ParallelPlan())


def init_train_state(api: ModelApi, optimizer: Optimizer, seed: int = 0, *,
                     mesh=None, plan=None) -> TrainState:
    """The seeded init and its optimizer state; a pipelined rank's holds
    only its stage (``api.init_pipeline_stage``), a tensor-MP rank only its
    part (``parallel.sharding.shard_params`` of the whole seeded init)."""
    if _pipelined(plan, mesh):
        params = api.init_pipeline_stage(seed, mesh.shape["model"], plan.virtual_stages,
                                         mesh.model_index)
    elif is_tensor_ctx(_make_pctx(mesh, plan)):
        params = SH.shard_params(api.init(seed), _tensor_rules(api.cfg, mesh, plan),
                                 mesh.model_index)
    else:
        params = api.init(seed)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


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
    """The parameter-shaped trees of a state: the parameters and each entry
    of the optimizer state (AdamW's ``m`` and ``v``, momentum's ``m``)."""
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


def _stages_to_global(parts, cfg, n_stages: int, v: int):
    """The global tree from every stage's part (in stage order): the stage
    leaves stacked (S, v, Lc, ...) and reassembled as (L, ...), BigLSTM's
    back into one dict a layer; the embedding from the first stage (a tied
    one is on the last too, the same bits), the head from the last."""
    key = "lstm" if cfg.family == "rnn" else "layers"
    out = {}
    for part in parts:
        for k, t in part.items():
            if k != key and k not in out:
                out[k] = t
    stacked = stages_to_stack(tree_map(lambda *ls: torch.stack(ls), parts[0][key],
                                       *(p[key] for p in parts[1:])), n_stages, v)
    if key == "lstm":
        stacked = [tree_map(lambda t, i=i: t[i], stacked) for i in range(cfg.n_layers)]
    out[key] = stacked
    return {k: out[k] for k in sorted(out)}


def global_state(state: TrainState, api: ModelApi, mesh, plan):
    """The whole state in JAX's layout on the writing rank (rank 0; on the
    host where it was gathered), None on every other rank.  Every rank calls
    it at the same step: the gathers are collectives.  DP and context ranks
    hold replicas (rank 0's is the state); a tensor-MP rank's parts are
    gathered over the model group of the first replica
    (``sharding.gather_params``); a pipeline stage's are sent to rank 0 and
    reassembled (``pipeline.stages_to_stack``).  In one process (``mesh``
    None) it is the state itself."""
    if mesh is None:
        return state
    if plan is not None:
        check_plan(plan, mesh.shape["model"], api.cfg)
    pipelined, tensor = _pipelined(plan, mesh), is_tensor_ctx(_make_pctx(mesh, plan))
    if not (pipelined or tensor):
        return state if mesh.rank == 0 else None
    if mesh.data_index != 0:
        return None
    trees = _state_trees(state)
    parts = D.gather_tree(mesh, trees, "model")
    if parts is None:
        return None
    # the peers' parts arrive where the transport carries them: assemble on
    # the host, where the writer reads every leaf anyway
    parts = [tree_map(lambda t: t.detach().cpu(), p) for p in parts]
    if pipelined:
        whole = {k: _stages_to_global([p[k] for p in parts], api.cfg, mesh.shape["model"],
                                      max(plan.virtual_stages, 1)) for k in trees}
    else:
        rules = _tensor_rules(api.cfg, mesh, plan)
        specs = SH.param_specs(api.cfg, rules)
        whole = {k: SH.gather_params([p[k] for p in parts], rules, specs) for k in trees}
    return _from_trees(whole, state)


def place_state(state: TrainState, api: ModelApi, mesh=None, plan=None) -> TrainState:
    """This rank's part of a global state on its device, cut as
    ``init_train_state`` cuts the init: a pipeline stage's pieces
    (``api.pipeline_stage_params``), a tensor-MP rank's slices
    (``sharding.shard_params``), or the whole tree (one process, DP and
    context ranks).  Cuts are made on the host, then moved."""
    device = api.device if mesh is None else mesh.device
    trees = _state_trees(state)
    if _pipelined(plan, mesh):
        s, v = mesh.shape["model"], plan.virtual_stages
        trees = {k: api.pipeline_stage_params(t, s, v, mesh.model_index)
                 for k, t in trees.items()}
    elif is_tensor_ctx(_make_pctx(mesh, plan)):
        rules = _tensor_rules(api.cfg, mesh, plan)
        trees = {k: SH.shard_params(t, rules, mesh.model_index) for k, t in trees.items()}
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
    if tensor:
        rules = _tensor_rules(api.cfg, mesh, plan)
        specs = SH.param_specs(api.cfg, rules)
        replicated = []         # per leaf, in tree_leaves order; set at the first step

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

    def synced_grads(params, batch):
        """The rank's loss and gradients, summed over DP (and the ring)."""
        if mesh is None:
            return total_grads(params, batch)
        batch = _dp_shard(batch, mesh)
        if pctx is not None and not tensor:
            batch = _cp_shard(batch, pctx, api.cfg)
        if not pipelined:
            batch = {k: v.to(mesh.device) for k, v in batch.items()}
        loss, metrics, grads = total_grads(params, batch)
        if tensor:              # shares of the global mean: sum over the data shards
            if dp > 1:
                if comm == "overlapped":
                    bucketed_grad_sync(grads, mesh, bucket_bytes=bkt)
                else:
                    all_reduce_grads(grads, mesh)
                loss = D.all_reduce(mesh, loss.detach().clone(), "data")
            if not replicated:
                replicated.extend(SH.replicated_leaves(grads, specs, rules))
            for g, rep in zip(tree_leaves(grads), replicated):
                if rep:         # whole on every rank: give them the same bits
                    D.broadcast(mesh, g, "model")
            return loss, dict(metrics, loss=loss), grads
        if pctx is not None:    # shares of the global mean: sum over every rank
            all_reduce_grads(grads, mesh, axis=None)
            loss = D.all_reduce(mesh, loss.detach().clone())
            return loss, dict(metrics, loss=loss), grads
        if dp > 1:
            if comm == "overlapped":
                bucketed_grad_sync(grads, mesh, bucket_bytes=bkt)
            else:
                all_reduce_grads(grads, mesh)
            loss = D.all_reduce(mesh, loss.detach().clone(), "data")
            if not pipelined:       # the mean of the shards' mean losses
                tree_map(lambda g: g.div_(dp), grads)
                loss = loss / dp
            metrics = dict(metrics, loss=loss)
        return loss, metrics, grads

    def global_norm(grads) -> torch.Tensor:
        if tensor:      # sharded leaves summed over the model group, replicated once
            leaves = tree_leaves(grads)
            zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            sharded = [g for g, rep in zip(leaves, replicated) if not rep]
            whole = [g for g, rep in zip(leaves, replicated) if rep]
            sq = D.all_reduce(mesh, (sum_of_squares(sharded) if sharded else zero).clone(),
                              "model")
            return torch.sqrt(sq + (sum_of_squares(whole) if whole else zero))
        sq = sum_of_squares({k: g for k, g in grads.items() if k not in skip_in_norm})
        return torch.sqrt(D.all_reduce(mesh, sq, "model"))

    def train_step(state: TrainState, batch):
        params = state.params
        loss, metrics, grads = synced_grads(params, batch)
        if clip_norm:
            norm = global_norm(grads) if pipelined or tensor else None
            grads, gnorm = clip_by_global_norm(grads, clip_norm, norm=norm)
            metrics = dict(metrics, grad_norm=gnorm)
        state.in_update = True
        updates, opt_state = optimizer.update(grads, state.opt_state, params, state.step)
        del grads
        apply_updates(params, updates)
        state.in_update = False
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step
