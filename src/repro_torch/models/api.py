"""Model API (port of ``repro/models/api.py``).

``build_model(cfg, device=, capacity_factor=1.25)`` returns a ``ModelApi``
whose members are plain functions over the parameter dict; the serving
engine and the train step consume models only through it.  An arch the
scheduled pipeline runtime can partition (``supports_pipeline``) also has
``init_pipeline_stage`` (one stage's parameters, bit-equal to the matching
slices of ``init``), ``pipeline_stage_params`` (one stage's part of a whole
model's parameters) and ``pipeline_value_and_grad_fn`` (one rank's loss and
gradients through ``parallel.pipeline.pipeline_value_and_grad``).  The dense, MoE
and RWKV decoders go through ``models/transformer.py`` (RWKV's cache holds
its recurrent state); BigLSTM and GNMT (``models/lstm.py``) and
Inception-V3 (``models/inception.py``) have a loss and no serving path (as
in JAX).  Under a tensor-MP ``ParallelCtx`` the dense decoder's and
Inception-V3's losses are the rank's share of the global masked mean
(``tensor_mp_loss``; vocab-sharded logits through
``vocab_parallel_nll_sum``), and ``init`` is still the whole seeded init:
``parallel.sharding.shard_params`` cuts a rank's part from it.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; asking
for CUDA where there is none raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import inception as inc_mod
from repro_torch.models import lstm as lstm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import dist as D
from repro_torch.parallel.pipeline import (make_schedule, pipeline_value_and_grad,
                                           stage_layers)
from repro_torch.tree import tree_map


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and no card is
    visible (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def masked_nll_sum(logits, labels):
    """Summed token NLL in f32 (labels < 0 masked)."""
    logits = logits.float()
    mask = labels >= 0
    labels = labels.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def cross_entropy(logits, labels, n_valid_vocab: int):
    """Mean token NLL in f32; labels < 0 are masked out."""
    mask = labels >= 0
    return masked_nll_sum(logits, labels) / mask.sum().clamp(min=1)


def global_label_count(labels, mesh, axes=(None,)):
    """The labels >= 0 over the ranks of ``axes`` of ``mesh`` (None: every
    rank; at least 1), as f32: the divisor that makes the ranks' loss shares
    sum to the global masked mean."""
    n = (labels >= 0).sum().to(torch.float32).reshape(1)
    for axis in axes:
        D.all_reduce(mesh, n, axis)
    return n[0].clamp(min=1)


def vocab_parallel_nll_sum(logits, labels, *, mesh, model_axis: str = "model"):
    """``masked_nll_sum`` over vocab-sharded logits without gathering them
    (JAX's ``vocab_parallel_cross_entropy``): ``logits`` (B, S, V/m) are
    this rank's contiguous vocab columns; the row max (a shift without
    gradient), the sum of exponentials and the gold logit are reduced over
    ``model_axis``.  Every rank of the axis gets the same sum, and each
    rank's columns their own gradient."""
    lg = logits.float()
    j = mesh.ring(model_axis)[0]
    v_loc = lg.shape[-1]
    lo = j * v_loc
    with torch.no_grad():
        top = D.all_reduce(mesh, lg.max(-1).values.contiguous(), model_axis, op="max")
    z = CL.reduce_from_model(torch.exp(lg - top[..., None]).sum(-1), mesh, model_axis)
    logz = top + torch.log(z)
    mask = labels >= 0
    lb = labels.clamp(min=0)
    mine = (lb >= lo) & (lb < lo + v_loc)
    gold_loc = torch.gather(lg, -1, (lb - lo).clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = CL.reduce_from_model(torch.where(mine, gold_loc, torch.zeros_like(gold_loc)),
                                mesh, model_axis)
    return ((logz - gold) * mask).sum()


def tensor_mp_loss(logits, labels, cfg, pctx):
    """A tensor-MP rank's share of the global masked mean NLL: its data
    shard's NLL sum over the valid labels of every data shard (the model
    ranks of a shard hold the same labels and the same share), so the sum
    over the data axes is JAX's loss.  Vocab-sharded logits go through
    ``vocab_parallel_nll_sum`` (JAX's condition: a model axis that divides
    ``vocab_padded``), whole ones through ``masked_nll_sum``."""
    count = global_label_count(labels, pctx.mesh, tuple(a for a in pctx.batch_axes if a))
    if logits.shape[-1] * pctx.mesh.shape[pctx.model_axis] == cfg.vocab_padded and \
            pctx.mesh.shape[pctx.model_axis] > 1:
        return vocab_parallel_nll_sum(logits, labels, mesh=pctx.mesh,
                                      model_axis=pctx.model_axis) / count
    return masked_nll_sum(logits, labels) / count


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable                    # seed -> params
    loss_fn: Callable                 # (params, batch, pctx) -> (loss, metrics)
    prefill: Optional[Callable]       # (params, batch, pctx, capacity, window) -> (logits, cache)
    decode_fn: Optional[Callable]     # (params, cache, batch, pctx, window) -> (logits, cache)
    # (seed, n_stages, v, stage) -> that stage's parameters
    init_pipeline_stage: Optional[Callable] = None
    # (params, n_stages, v, stage) -> that stage's part of a whole model's params
    pipeline_stage_params: Optional[Callable] = None
    # (params, batch, *, mesh, n_micro, schedule, virtual_stages)
    #   -> ((loss, metrics), grads) of this rank
    pipeline_value_and_grad_fn: Optional[Callable] = None


def build_model(cfg: ModelConfig, *, device="cuda", capacity_factor=1.25) -> ModelApi:
    """``capacity_factor`` bounds the tokens per expert of an MoE model in
    train and prefill (None: no drop); decode never drops."""
    dev = resolve_device(device)
    if cfg.family == "cnn":
        return _build_inception(cfg, dev)
    if cfg.family == "rnn":
        return _build_lstm(cfg, dev)
    tf_mod.check_supported(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tf_mod.model_init(gen, cfg, device=dev)

    def loss_fn(params, batch, pctx=None):
        fwd_batch = {k: v for k, v in batch.items() if k != "labels"}
        logits, aux = tf_mod.forward(cfg, params, fwd_batch, mode="train", pctx=pctx,
                                     capacity_factor=capacity_factor)
        if pctx is None:
            loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        elif pctx.is_tensor:
            loss = tensor_mp_loss(logits, batch["labels"], cfg, pctx)
        else:   # this rank's share of the global masked mean: sum over the ranks
            loss = masked_nll_sum(logits, batch["labels"]) / global_label_count(
                batch["labels"], pctx.mesh)
        # aux: the blocks' router_aux_loss-weighted load-balance losses
        return loss + aux, {"loss": loss, "aux": aux}

    def prefill(params, batch, pctx=None, capacity: int = 0, window=None):
        fwd_batch = {k: v for k, v in batch.items() if k != "labels"}
        logits, cache, _ = tf_mod.forward(cfg, params, fwd_batch, mode="prefill",
                                          window_override=window, pctx=pctx,
                                          cache_capacity=capacity,
                                          capacity_factor=capacity_factor)
        return logits, cache

    def decode_fn(params, cache, batch, pctx=None, window=None):
        return tf_mod.decode_step(cfg, params, cache, batch,
                                  window_override=window, pctx=pctx)

    api = ModelApi(cfg, dev, init, loss_fn, prefill, decode_fn)
    if supports_pipeline(cfg):
        head_keys = ("final_norm", "embed" if cfg.tie_embeddings else "lm_head")
        _add_pipeline(api, "layers", tf_mod.pipeline_stage_fn(cfg),
                      pre_fn=lambda op, tokens: tf_mod._embed(cfg, op, tokens),
                      head_fn=lambda op, y: tf_mod._head(cfg, op, y),
                      pre_keys=("embed",), head_keys=head_keys,
                      init_fn=lambda gen, keep: tf_mod.model_init(gen, cfg, device=dev,
                                                                  keep=keep))
    return api


def _build_inception(cfg: ModelConfig, dev: torch.device) -> ModelApi:
    reduced = inc_mod.is_reduced(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return inc_mod.inception_init(gen, cfg, reduced=reduced, device=dev)

    def loss_fn(params, batch, pctx=None):
        if pctx is not None and not pctx.is_tensor:
            raise ValueError(f"{cfg.name}: a context ring needs a decoder")
        logits = inc_mod.inception_forward(cfg, params, batch, reduced=reduced, pctx=pctx)
        labels = batch["labels"][:, None]
        if pctx is None:
            loss = cross_entropy(logits[:, None, :], labels, cfg.vocab_size)
        else:   # the logits are whole: this rank's share of the global mean
            loss = masked_nll_sum(logits[:, None, :], labels) / global_label_count(
                labels, pctx.mesh, tuple(a for a in pctx.batch_axes if a))
        return loss, {"loss": loss}

    return ModelApi(cfg, dev, init, loss_fn, None, None)


def _build_lstm(cfg: ModelConfig, dev: torch.device) -> ModelApi:
    if cfg.name == "gnmt":
        def gnmt_init(seed: int = 0):
            gen = torch.Generator(device=dev).manual_seed(seed)
            return lstm_mod.gnmt_init(gen, cfg, device=dev)

        def gnmt_loss(params, batch, pctx=None):
            logits = lstm_mod.gnmt_forward(cfg, params, batch)
            loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
            return loss, {"loss": loss}

        return ModelApi(cfg, dev, gnmt_init, gnmt_loss, None, None)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return lstm_mod.biglstm_init(gen, cfg, device=dev)

    def loss_fn(params, batch, pctx=None):
        logits = lstm_mod.biglstm_forward(cfg, params, batch, pctx=pctx)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        return loss, {"loss": loss}

    api = ModelApi(cfg, dev, init, loss_fn, None, None)
    dt = getattr(torch, cfg.dtype)
    _add_pipeline(api, "lstm", lstm_mod.biglstm_stage_fn(cfg),
                  pre_fn=lambda op, tokens: op["embed"][tokens].to(dt),
                  head_fn=lambda op, y: y @ op["head"].to(y.dtype),
                  pre_keys=("embed",), head_keys=("head",),
                  init_fn=lambda gen, keep: lstm_mod.biglstm_init(gen, cfg, device=dev,
                                                                  keep=keep))
    return api


def supports_pipeline(cfg: ModelConfig) -> bool:
    """Archs whose layer stack a pipeline runtime can partition: BigLSTM's
    residual LSTM stack and homogeneous decoder-only transformers.  GNMT's
    encoder/decoder split and the CNN block graph need stage functions the
    runtime does not model (the planner still *costs* pipeline-MP for GNMT;
    the launcher then takes the best supported plan), as in JAX.  The
    scheduled runtime (``parallel.pipeline.pipeline_value_and_grad``) runs
    the stacks; the ``ad`` runtime is ROADMAP.md Queue 1 item 6b."""
    if cfg.name == "biglstm":
        return True
    if cfg.family == "cnn" or cfg.name == "gnmt":
        return False
    return not (cfg.encoder_layers or cfg.n_prefix_embeds or cfg.is_moe)


def pipeline_applicable(cfg: ModelConfig, n_stages: int, virtual_stages: int = 1) -> bool:
    """Can this arch run as ``n_stages`` pipeline stages (each holding
    ``virtual_stages`` interleaved layer chunks)?"""
    return (supports_pipeline(cfg) and n_stages > 1
            and cfg.n_layers % (n_stages * max(virtual_stages, 1)) == 0)


def _add_pipeline(api: ModelApi, stage_key: str, stage_fn: Callable, *,
                  pre_fn: Callable, head_fn: Callable, pre_keys, head_keys,
                  init_fn: Callable) -> None:
    """Give ``api`` what the scheduled pipeline runtime needs:
    ``init_pipeline_stage``, ``pipeline_stage_params`` and
    ``pipeline_value_and_grad_fn`` (the port of JAX's
    ``_pipeline_vag_builder``), from ``pre_fn(outer, tokens) -> x`` (the
    embedding), ``stage_fn(chunk_params, x) -> y`` per WorkUnit and
    ``head_fn(outer, y_micro) -> logits`` feeding the per-micro NLL.

    Placement differs from JAX's on purpose: JAX replicates the outer
    parameters on every stage; here ``pre_keys`` live on the first stage's
    rank and ``head_keys`` on the last's, where their work runs (a tied
    embedding is in both, and its two gradients are summed over the two,
    JAX's leaf-wise sum).  The per-micro loss is the summed NLL scaled by
    the inverse valid-token count of the global batch (summed over the DP
    group), so the micro-batches' and the replicas' losses sum to the batch
    mean.  The DP sum of the gradients is the train step's."""
    cfg = api.cfg
    tied = stage_key == "layers" and cfg.tie_embeddings

    def keep_for(n_stages: int, v: int, stage: int):
        """The ``keep`` of the init that holds stage ``stage``'s pieces:
        its layers (the decoder's stacked leaves cut to them, (v, Lc, ...)),
        the embedding on the first stage and the head on the last."""
        layers = stage_layers(cfg.n_layers, n_stages, v, stage)
        first, last = stage == 0, stage == n_stages - 1

        def keep(path, tree):
            if path[0] == stage_key:
                if stage_key == "lstm":          # one dict a layer
                    return tree if path[1] in layers else None
                return tree_map(lambda a: a[torch.tensor(layers, device=a.device)].reshape(
                    (v, -1) + tuple(a.shape[1:])), tree)
            if (first and path[0] in pre_keys) or (last and path[0] in head_keys):
                return tree
            return None

        return keep, layers

    def assemble(kept, layers, v: int):
        params = {k: t for k, t in kept.items() if k != stage_key and t is not None}
        stack = kept[stage_key]
        if stage_key == "lstm":
            stack = tree_map(lambda a: a.reshape((v, -1) + tuple(a.shape[1:])),
                             lstm_mod.stack_layer_params([stack[i] for i in layers]))
        params[stage_key] = stack
        return params

    def init_pipeline_stage(seed: int, n_stages: int, virtual_stages: int, stage: int):
        v = max(virtual_stages, 1)
        keep, layers = keep_for(n_stages, v, stage)
        gen = torch.Generator(device=api.device).manual_seed(seed)
        return assemble(init_fn(gen, keep), layers, v)

    def pipeline_stage_params(params, n_stages: int, virtual_stages: int, stage: int):
        v = max(virtual_stages, 1)
        keep, layers = keep_for(n_stages, v, stage)
        kept = {k: ([keep((k, i), lp) for i, lp in enumerate(t)] if k == "lstm"
                    else keep((k,), t)) for k, t in params.items()}
        return assemble(kept, layers, v)

    def pipeline_value_and_grad_fn(params, batch, *, mesh, n_micro: int,
                                   schedule="gpipe", virtual_stages: int = 1):
        n_stages, stage = mesh.shape["model"], mesh.model_index
        first, last = stage == 0, stage == n_stages - 1
        sched = (make_schedule(schedule, n_stages, n_micro, virtual_stages)
                 if isinstance(schedule, str) else schedule)
        dev = mesh.device
        b, t = batch["tokens"].shape
        if first:
            pre = {k: params[k].detach().requires_grad_() for k in pre_keys}
            with torch.enable_grad():
                x_graph = pre_fn(pre, batch["tokens"].to(dev))
            x = x_graph.detach()
        else:
            x = torch.empty((b, t, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                            device="meta")
        loss_fn = head = labels = None
        if last:
            labels = batch["labels"].to(dev)
            count = D.all_reduce(mesh, (labels >= 0).sum().float(), "data")
            inv_count = 1.0 / count.clamp(min=1.0)
            head = {k: params[k] for k in head_keys}

            def loss_fn(hp, y_m, lbl_m):
                return masked_nll_sum(head_fn(hp, y_m), lbl_m) * inv_count

        res = pipeline_value_and_grad(mesh, stage_fn, params[stage_key], x,
                                      loss_fn=loss_fn, loss_params=head, targets=labels,
                                      n_micro=n_micro, schedule=sched)
        grads = {stage_key: res.stage_grads}
        if last:
            grads.update(res.loss_param_grads)
        if first:
            pre_grads = torch.autograd.grad(x_graph, list(pre.values()), grad_outputs=res.dx)
            for k, g in zip(pre, pre_grads):
                grads[k] = grads[k] + g if k in grads else g
        if tied and (first or last):
            D.all_reduce(mesh, grads["embed"], "ends")
        return (res.loss, {"loss": res.loss, "store_high_water": res.high_water}), grads

    api.init_pipeline_stage = init_pipeline_stage
    api.pipeline_stage_params = pipeline_stage_params
    api.pipeline_value_and_grad_fn = pipeline_value_and_grad_fn

