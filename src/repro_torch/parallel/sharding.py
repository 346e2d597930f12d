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
``gather_params`` its inverse over every rank's part.
"""
from __future__ import annotations

import warnings
from typing import List, Mapping, Optional, Tuple

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


def _map_with_spec(fn, params, specs):
    if isinstance(params, dict):
        return {k: _map_with_spec(fn, params[k], specs[k]) for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(_map_with_spec(fn, p, s) for p, s in zip(params, specs))
    return fn(params, specs)


def shard_params(params, rules: ShardingRules, model_index: int):
    """Rank ``model_index``'s part of the whole tree ``params``: each leaf
    the rules shard over the model axis cut to its contiguous slice of that
    dim (a copy), every other leaf as it is."""
    m = rules.msz

    def cut(leaf, spec):
        dim = rules.model_dim(spec)
        if dim is None or m == 1:
            return leaf
        n = leaf.shape[dim] // m
        return leaf.narrow(dim, model_index * n, n).clone()

    return _map_with_spec(cut, params, rules.params_specs(params))


def gather_params(parts: List, rules: ShardingRules, specs):
    """The whole tree from every rank's part (in model order), the inverse
    of ``shard_params``: leaves that ``specs`` (the whole tree's, as
    ``param_specs`` gives them) shard over the model axis are concatenated
    along that dim, the others taken from the first part."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: gather_params([p[k] for p in parts], rules, specs[k]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(gather_params([p[i] for p in parts], rules, specs[i])
                           for i in range(len(first)))
    dim = rules.model_dim(specs)
    return first if dim is None else torch.cat(list(parts), dim=dim)


def replicated_leaves(params, specs, rules: ShardingRules) -> List[bool]:
    """For each leaf of ``params`` (whole or a rank's part), in
    ``tree_leaves`` order: True where ``specs`` (the whole tree's) replicate
    it over the model axis."""
    from repro_torch.tree import tree_leaves, tree_map

    return tree_leaves(tree_map(lambda _, spec: rules.model_dim(spec) is None,
                                params, specs))
