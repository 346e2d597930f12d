"""Divisibility-aware sharding rules: parameter path -> partition spec (port
of ``ShardingRules`` in ``repro/parallel/sharding.py``).

The rule table is the JAX package's, kept whole: the Megatron tensor-MP
decomposition per family (attention heads, FFN hidden, experts and vocab on
the model axis), the fallback to replication wherever a dim does not divide
by the axis (it warns once per rule, in JAX's words), ZeRO-style sharding of
the remaining dim over the fsdp axes, the stage-dim rules of a pipeline plan
and the all-replicated parameters of a context plan.

A spec is a tuple with one entry per dim: None (replicated), an axis name or
a tuple of axis names, as a ``PartitionSpec`` lists them; a leaf of the
stacked layers gets a leading None.  The port has no JAX mesh, so the rules
read a mapping of axis name to size, as ``ParallelPlan.describe`` does.

``shard_params(params, rules, model_index)`` is a rank's part of a whole
parameter tree (the contiguous slice of each leaf along its model dim) and
``gather_params`` its inverse over every rank's part; ``shard_fsdp`` and
``gather_fsdp`` are their counterparts over the data axis (a fsdp plan's
rank holds the contiguous 1/dp slice of each leaf along the dim the rules
give the fsdp axes, cut out of its tensor-MP part where it has one, and
``fsdp_dims`` lists those dims a leaf).  The continuous
engine's ranks hold JAX's serving layouts instead: ``serve_tp_part`` is a
tensor-MP rank's part of the weights under ``decode_slots_tp``'s specs, and
``slot_cache_part`` a rank's part of the slot cache (``slot_range`` its
slots).  An LSTM cell's gate
leaves ``wx`` and ``wh`` (d, 4H) are cut gate-major: a rank takes the
columns [j H/m, (j + 1) H/m) of each of the four gates, as JAX's overlapped
layer shards the (d, 4, H) view (``repro/models/lstm.py:114-118``), so each
rank's cell is whole; a contiguous slice of the 4H columns would give rank
0 the i and f gates and rank 1 the g and o gates.  The spec tuples stay
JAX's.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.parallel.plan import ParallelPlan


def _axis_size(axis_sizes: Mapping[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= axis_sizes[a]
    return n


class ShardingRules:
    """Assigns a spec to every leaf of a model's parameter tree."""

    def __init__(self, cfg, axis_sizes: Mapping[str, int], plan: ParallelPlan):
        self.cfg = cfg
        self.axis_sizes = dict(axis_sizes)
        self.plan = plan
        # a context plan's model axis carries the KV ring: parameters stay
        # replicated across it, only the fsdp rules apply
        self.ms = None if plan.mp_kind == "context" else plan.model_axis
        self.msz = _axis_size(self.axis_sizes, self.ms) if self.ms else 1
        self.fs = plan.fsdp_axes or None
        self.fsz = _axis_size(self.axis_sizes, self.fs) if self.fs else 1
        self._path: Tuple[str, ...] = ()
        self._warned = set()

    # -- helpers ----------------------------------------------------------
    def _m(self, dim: int, head_groups: Optional[int] = None):
        """The model axis if ``dim`` (and ``head_groups``, when given)
        divides by it; otherwise None, with a warning once per rule: the
        fallback multiplies this leaf's memory and compute per device by the
        axis size."""
        if not self.ms or self.msz == 1:
            return None
        blocked = None
        if dim % self.msz:
            blocked = f"dim {dim}"
        elif head_groups is not None and head_groups % self.msz:
            blocked = f"head groups {head_groups} (dim {dim})"
        if blocked is None:
            return self.ms
        key = (".".join(self._path), dim, head_groups)
        if key not in self._warned:
            self._warned.add(key)
            warnings.warn(
                f"[sharding] {'.'.join(self._path) or '<input>'}: {blocked} "
                f"not divisible by the {self.msz}-way model axis "
                f"{self.ms!r}; replicating this param across tensor-MP "
                f"(per-device memory/compute x{self.msz} for it)",
                stacklevel=3)
        return None

    def _f(self, dim: int):
        if not self.fs or self.fsz == 1 or dim % self.fsz:
            return None
        return self.fs

    def _matmul(self, d_in: int, d_out: int, head_groups=None, row_shard: bool = False):
        """A (d_in, d_out) weight: column-parallel on the model axis, or
        row-parallel with ``row_shard`` (its output is a partial sum)."""
        if row_shard:
            return (self._m(d_in, head_groups), self._f(d_out))
        return (self._f(d_in), self._m(d_out, head_groups))

    # -- per-leaf rule ----------------------------------------------------
    def leaf_spec(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> tuple:
        names = [str(p) for p in path]
        self._path = tuple(names)
        stacked = "layers" in names          # the leading L dim of the layer stack
        if self.plan.is_pipeline:
            spec = self._pipeline_spec(stacked, tuple(shape))
        else:
            core = tuple(shape[1:] if stacked else shape)
            spec = self._leaf_spec_core(names, names[-1], core)
            spec = (None, *spec) if stacked else tuple(spec)
        # as a PartitionSpec holds them: a one-axis tuple is the axis name
        return tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s for s in spec)

    def _pipeline_spec(self, stacked: bool, shape: Tuple[int, ...]) -> tuple:
        """Stage residency: the stacked layer dim splits into contiguous
        blocks of L/S layers a stage; embed and head (and stacks the stages
        do not divide) stay replicated; fsdp takes a remaining trailing dim."""
        nd = len(shape)
        if nd == 0:
            return ()
        spec = [None] * nd
        lo = 0
        if stacked and self.ms and self.msz > 1 and shape[0] % self.msz == 0:
            spec[0] = self.ms
            lo = 1
        if self.fs and self.fsz > 1:
            for i in range(nd - 1, lo - 1, -1):
                if shape[i] % self.fsz == 0:
                    spec[i] = self.fs
                    break
        return tuple(spec)

    def _leaf_spec_core(self, names, name, shape):
        cfg = self.cfg
        nd = len(shape)
        if nd <= 1:
            if nd == 1 and name in ("D", "dt_bias") and self._m(shape[0]):
                return (self.ms,)
            return ()
        # embeddings: vocab rows on the model axis (vocab-parallel)
        if name in ("embed", "src_embed", "tgt_embed", "pos_embed"):
            if name == "pos_embed":
                return (None, None)
            return (self._m(shape[0]), self._f(shape[1]))
        if name in ("lm_head", "head", "fc"):
            return (self._f(shape[0]), self._m(shape[1]))
        # MoE expert banks (E, d, ff) / (E, ff, d): expert-parallel
        if "moe" in names:
            if name in ("wi", "wg") and nd == 3:
                return (self._m(shape[0]), None, self._f(shape[2]))
            if name == "wo" and nd == 3:
                return (self._m(shape[0]), self._f(shape[1]), None)
            if name == "router":
                return (None, None)
            if "shared" in names:
                if name in ("wi", "wg"):
                    return (self._f(shape[0]), self._m(shape[1]))
                return (self._m(shape[0]), self._f(shape[1]))
        if "attn" in names or "xattn" in names:
            if name == "wq":
                return self._matmul(*shape, head_groups=cfg.n_heads)
            if name in ("wk", "wv"):
                return self._matmul(*shape, head_groups=cfg.n_kv_heads)
            if name == "wo":
                return self._matmul(*shape, head_groups=cfg.n_heads, row_shard=True)
        # RWKV time mix and channel mix
        if "tm" in names:
            heads = cfg.d_model // (cfg.head_dim or 64)
            if name in ("wr", "wk", "wv", "wg"):
                return self._matmul(*shape, head_groups=heads)
            if name == "wo":
                return self._matmul(*shape, head_groups=heads, row_shard=True)
            if name in ("wa1", "wa2"):
                return (None, None)
        if "cm" in names:
            if name in ("wk", "wr"):
                return self._matmul(*shape)
            if name == "wv":
                return self._matmul(*shape, row_shard=True)
        # SSM (mamba)
        if "ssm" in names or name in ("in_proj", "x_proj", "dt_proj", "out_proj",
                                      "conv_w", "A_log"):
            if name == "in_proj":
                return self._matmul(*shape)
            if name == "conv_w":
                return (None, self._m(shape[1]))
            if name == "x_proj":
                return (self._m(shape[0]), None)
            if name == "dt_proj":
                return (None, self._m(shape[1]))
            if name == "A_log":
                return (self._m(shape[0]), None)
            if name == "out_proj":
                return self._matmul(*shape, row_shard=True)
        # MLP
        if name in ("wi", "wg"):
            return self._matmul(*shape)
        if name == "wo":
            return self._matmul(*shape, row_shard=True)
        # LSTM cells: gate projections column-sharded, the projection row-sharded
        if name in ("wx", "wh"):
            return (self._f(shape[0]), self._m(shape[1]))
        if name == "wp":
            return self._matmul(*shape, row_shard=True)
        if name == "w" and nd == 4:        # conv HWIO: output channels
            return (None, None, None, self._m(shape[3]))
        if name == "attn_q":
            return (self._f(shape[0]), None)
        return (None,) * nd

    # -- trees --------------------------------------------------------------
    def params_specs(self, params):
        """The spec tree of a parameter tree (leaves: tensors or anything
        with a ``shape``); list entries are named by their index, as in JAX."""
        def walk(path, node):
            if isinstance(node, dict):
                return {k: walk(path + (k,), v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(path + (str(i),), v) for i, v in enumerate(node))
            return self.leaf_spec(path, tuple(node.shape))

        return walk((), params)

    def model_dim(self, spec: tuple) -> Optional[int]:
        """The dim of ``spec`` sharded over the model axis, or None."""
        for i, s in enumerate(spec):
            if s == self.ms or (isinstance(s, tuple) and self.ms in s):
                return i
        return None

    def fsdp_dim(self, spec: tuple) -> Optional[int]:
        """The dim of ``spec`` sharded over the fsdp axes, or None (no fsdp
        axes, or one rank on them)."""
        if not self.fs or self.fsz == 1:
            return None
        want = self.fs[0] if len(self.fs) == 1 else tuple(self.fs)
        return next((i for i, s in enumerate(spec) if s == want), None)


class _Shape:
    """A leaf of a shape tree: what ``params_specs`` reads of a tensor."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _shape_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _shape_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_shape_tree(v) for v in shapes]
    return _Shape(shapes)


def param_specs(cfg, rules: ShardingRules):
    """The spec tree of the whole parameter tree of ``cfg`` (from its shapes,
    without an init): what a rank's part of the parameters is cut by."""
    from repro_torch.interop import param_shapes

    return rules.params_specs(_shape_tree(param_shapes(cfg)))


def _map_with_spec(fn, params, specs, path=()):
    if isinstance(params, dict):
        return {k: _map_with_spec(fn, params[k], specs[k], path + (k,)) for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(_map_with_spec(fn, p, s, path + (str(i),))
                            for i, (p, s) in enumerate(zip(params, specs)))
    return fn(params, specs, path)


GATE_LEAVES = ("wx", "wh")


def _gate_major(path, leaf, dim) -> bool:
    """An LSTM gate leaf (d, 4H), or its Adafactor column statistic (4H,),
    cut over its 4H columns (its last dim)."""
    if not path or dim != leaf.dim() - 1:
        return False
    if path[-1] == "vc" and len(path) > 1:
        return path[-2] in GATE_LEAVES and leaf.dim() == 1
    return path[-1] in GATE_LEAVES and leaf.dim() == 2


def shard_params(params, rules: ShardingRules, model_index: int, specs=None):
    """Rank ``model_index``'s part of the whole tree ``params``: each leaf
    the rules shard over the model axis cut to its contiguous slice of that
    dim (an LSTM gate leaf to its gate-major columns), a copy; every other
    leaf as it is.  ``specs`` (default ``params``' own) are the tree's, as
    ``state_specs`` gives an optimizer state's."""
    m = rules.msz

    def cut(leaf, spec, path):
        dim = rules.model_dim(spec)
        if dim is None or m == 1:
            return leaf
        if _gate_major(path, leaf, dim):
            lead, hm = leaf.shape[:-1], leaf.shape[-1] // (4 * m)
            return leaf.reshape(*lead, 4, m * hm).narrow(
                -1, model_index * hm, hm).reshape(*lead, 4 * hm).clone()
        n = leaf.shape[dim] // m
        return leaf.narrow(dim, model_index * n, n).clone()

    return _map_with_spec(cut, params, rules.params_specs(params) if specs is None else specs)


def _join_parts(fn, parts: List, specs, path=()):
    """``fn(leaves, spec, path)`` over the matching leaves of every tree of
    ``parts``: one tree."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _join_parts(fn, [p[k] for p in parts], specs[k], path + (k,))
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_join_parts(fn, [p[i] for p in parts], specs[i], path + (str(i),))
                           for i in range(len(first)))
    return fn(parts, specs, path)


def gather_params(parts: List, rules: ShardingRules, specs):
    """The whole tree from every rank's part (in model order), the inverse
    of ``shard_params``: leaves that ``specs`` (the whole tree's, as
    ``param_specs`` gives them) shard over the model axis are concatenated
    along that dim (an LSTM gate leaf gate by gate), the others taken from
    the first part."""
    def join(leaves, spec, path):
        first, dim = leaves[0], rules.model_dim(spec)
        if dim is None:
            return first
        if _gate_major(path, first, dim):
            lead = first.shape[:-1]
            return torch.cat([p.reshape(*lead, 4, -1) for p in leaves], dim=-1).reshape(*lead, -1)
        return torch.cat(list(leaves), dim=dim)

    return _join_parts(join, parts, specs)


def shard_fsdp(tree, rules: ShardingRules, data_index: int, specs=None):
    """Data rank ``data_index``'s shard of ``tree`` (the whole tree, or a
    tensor-MP rank's part of it): each leaf that the rules shard over the
    fsdp axes cut to its contiguous 1/dp slice of that dim, a copy; every
    other leaf as it is.  ``specs`` are the whole tree's (``param_specs``;
    default ``tree``'s own).  An LSTM gate leaf keeps its gate-major model
    cut, and its fsdp cut falls on its rows (JAX's ``P(fsdp, model)``)."""
    n = rules.fsz

    def cut(leaf, spec, path):
        dim = rules.fsdp_dim(spec)
        if dim is None:
            return leaf
        k = leaf.shape[dim] // n
        return leaf.narrow(dim, data_index * k, k).clone()

    return _map_with_spec(cut, tree, rules.params_specs(tree) if specs is None else specs)


def gather_fsdp(parts: List, rules: ShardingRules, specs):
    """The tree the shards ``parts`` (every data rank's, in data order) were
    cut from, the inverse of ``shard_fsdp``: fsdp-sharded leaves
    concatenated along their fsdp dim, the others taken from the first."""
    def join(leaves, spec, path):
        dim = rules.fsdp_dim(spec)
        return leaves[0] if dim is None else torch.cat(list(leaves), dim=dim)

    return _join_parts(join, parts, specs)


def leaf_cuts(tree, specs, rules: ShardingRules) -> List[Dict[int, str]]:
    """For each leaf of ``tree`` (whole, a part or a shard), in
    ``tree_leaves`` order: the dims that ``specs`` (the whole tree's) cut,
    each mapped to the rank mesh's axis it is cut over: the model dim over
    ``"model"`` (a tensor plan's), the fsdp dim over ``"data"``.  The one
    record of where a rank's part of a leaf lies: the train step's gradient
    sums, global norm and optimizer cuts read it."""
    def walk(node, spec):
        if isinstance(node, dict):
            return [c for k in sorted(node) for c in walk(node[k], spec[k])]
        if isinstance(node, (list, tuple)):
            return [c for n, sp in zip(node, spec) for c in walk(n, sp)]
        cuts = {}
        if rules.ms and rules.msz > 1 and rules.model_dim(spec) is not None:
            cuts[rules.model_dim(spec)] = "model"
        if rules.fsdp_dim(spec) is not None:
            cuts[rules.fsdp_dim(spec)] = "data"
        return [cuts]

    return walk(tree, specs)


def fsdp_dims(tree, specs, rules: ShardingRules) -> List[Optional[int]]:
    """For each leaf of ``tree`` (whole, a part or a shard), in
    ``tree_leaves`` order: its fsdp dim under ``specs`` (the whole tree's),
    or None."""
    return [next((d for d, a in c.items() if a == "data"), None)
            for c in leaf_cuts(tree, specs, rules)]


def replicated_leaves(params, specs, rules: ShardingRules) -> List[bool]:
    """For each leaf of ``params`` (whole or a rank's part), in
    ``tree_leaves`` order: True where ``specs`` (the whole tree's) replicate
    it over the model axis."""
    return ["model" not in c.values() for c in leaf_cuts(params, specs, rules)]


ACC_KEYS = ("v", "vc", "vr")


def state_specs(tree, specs):
    """The spec tree of an optimizer-state tree that mirrors the parameter
    tree (``specs``, the whole tree's): a parameter-shaped entry (AdamW's
    ``m``, ``v``) takes its parameter's spec, Adafactor's accumulators
    JAX's ``opt_specs``: ``vr`` the spec without its last dim, ``vc``
    without its second-to-last, ``v`` the spec itself."""
    if isinstance(tree, dict) and isinstance(specs, tuple) and set(tree) <= set(ACC_KEYS):
        return {k: {"vr": specs[:-1], "vc": specs[:-2] + specs[-1:], "v": specs}[k]
                for k in tree}
    if isinstance(tree, dict):
        return {k: state_specs(tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_specs(t, s) for t, s in zip(tree, specs))
    return specs


# ---------------------------------------------------------------------------
# the continuous engine's ranks
# ---------------------------------------------------------------------------

def _batch_size(mesh, batch_axes) -> int:
    return 1 if mesh is None else math.prod(mesh.size(a) for a in (batch_axes or ()) if a)


def slot_range(n_slots: int, mesh=None, batch_axes=()) -> Tuple[int, int]:
    """(first slot, slots) of the engine's ``n_slots`` that this rank's data
    group holds: the slots split over the data axes in contiguous blocks
    (JAX's ``P(bspec)`` of the slot dim), all of them without a mesh."""
    dp = _batch_size(mesh, batch_axes)
    if n_slots % dp:
        raise ValueError(f"{n_slots} slots do not split over {dp} data groups")
    n = n_slots // dp
    return (mesh.data_index * n if dp > 1 else 0), n


def slot_cache_part(cfg, n_slots: int, capacity: int, *, mesh=None, model_axis=None,
                    batch_axes=(), dtype=None, device="cuda"):
    """This rank's part of a slotted cache of ``n_slots`` x ``capacity``
    (JAX's ``c_spec`` of ``decode_slots_tp``): its data group's slots
    (``slot_range``), and of the KV heads its contiguous 1/m where
    n_kv_heads divides over a tensor-MP ``model_axis`` of m ranks, else
    all of them.  Under a context axis (no ``model_axis``) the cache is
    replicated over the ring.  ``pos`` is (slots,) int32 on the device."""
    from repro_torch.models.api import make_slot_cache

    _, n = slot_range(n_slots, mesh, batch_axes)
    m = mesh.size(model_axis) if mesh is not None and model_axis is not None else 1
    kv_heads = cfg.n_kv_heads // m if m > 1 and cfg.n_kv_heads % m == 0 else None
    return make_slot_cache(cfg, n, capacity, dtype=dtype, device=device, kv_heads=kv_heads)


def serve_tp_part(params, cfg, model_index: int, m: int):
    """Model rank ``model_index``'s part of the whole serving weights under
    the specs of JAX's ``decode_slots_tp`` (and ``prefill_chunk_tp``): the
    column slices of ``wq`` and the MLP's ``wi`` / ``wg``, the row slices of
    the ``wo``s, the column slices of ``wk`` / ``wv`` where n_kv_heads
    divides by m (else whole), every other leaf (the embedding, the norms,
    the head) whole.  Sliced leaves are copies."""
    if m <= 1:
        return params

    def cols(t):
        n = t.shape[-1] // m
        return t.narrow(-1, model_index * n, n).clone()

    def rows(t):
        n = t.shape[-2] // m
        return t.narrow(-2, model_index * n, n).clone()

    layers = params["layers"]
    attn = layers["attn"]
    kv = cols if cfg.n_kv_heads % m == 0 else (lambda t: t)
    part = {"wq": cols(attn["wq"]), "wk": kv(attn["wk"]), "wv": kv(attn["wv"]),
            "wo": rows(attn["wo"])}
    mlp = {k: rows(t) if k == "wo" else cols(t) for k, t in layers["mlp"].items()}
    return {**params, "layers": {**layers, "attn": part, "mlp": mlp}}
