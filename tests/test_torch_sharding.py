"""The port's sharding rules (``repro_torch.parallel.sharding``) and the
overlapped block's gate (``models.transformer.overlapped_supported``)
against the JAX package, with no ranks:

- every config's leaf specs equal JAX's ``ShardingRules.params_specs`` at a
  model axis of 2, 4, 8 and 32 (JAX's rules read only ``mesh.shape``, so a
  stand-in mesh does), for tensor plans, with fsdp, and for pipeline and
  context plans;
- the replication fallback warns once per rule, in JAX's words (JAX's
  ``test_sharding_fallback_warns_once_per_rule``);
- ``gather_params(shard_params(p))`` gives ``p`` back, and each part is the
  rank's contiguous slice;
- ``overlapped_supported`` gives JAX's answer over JAX's
  ``test_overlapped_supported_gating`` grid.

JAX is imported inside the tests only.
"""
import dataclasses
import warnings

import pytest
import torch

from repro_torch.configs import ARCH_IDS, PAPER_IDS
from repro_torch.configs import get_config as t_get_config
from repro_torch.parallel import sharding as S
from repro_torch.parallel.plan import ParallelPlan as TPlan
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODEL_SIZES = (2, 4, 8, 32)


class FakeMesh:
    """What JAX's rules read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


_SHAPES = {}


def _jax_shapes(arch):
    """JAX's abstract init of ``arch`` (cached: eval_shape traces the init)."""
    if arch not in _SHAPES:
        import jax
        from repro.configs import get_config as j_get_config
        from repro.models import build_model as j_build_model

        api = j_build_model(j_get_config(arch))
        _SHAPES[arch] = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    return _SHAPES[arch]


def _jax_specs(tree):
    """JAX's spec tree with each PartitionSpec as a tuple."""
    if isinstance(tree, dict):
        return {k: _jax_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_partitions") and \
            type(tree).__name__ != "PartitionSpec":
        return type(tree)(_jax_specs(v) for v in tree)
    return tuple(tree)


PLANS = {"tensor": dict(model_axis="model"),
         "tensor+fsdp": dict(model_axis="model", fsdp_axes=("data",)),
         "pipeline": dict(model_axis="model", mp_kind="pipeline"),
         "context": dict(model_axis="model", mp_kind="context")}


@pytest.mark.parametrize("plan_kind", list(PLANS))
@pytest.mark.parametrize("arch", ARCH_IDS + PAPER_IDS)
def test_leaf_specs_match_jax(arch, plan_kind):
    """Every leaf's spec of every config, at each model axis size, is JAX's
    (the port walks JAX's own shape tree, so paths and shapes are the
    same)."""
    from repro.parallel.plan import ParallelPlan as JPlan
    from repro.parallel.sharding import ShardingRules as JRules

    shapes = _jax_shapes(arch)
    for m in MODEL_SIZES:
        sizes = {"data": 4, "model": m}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = _jax_specs(JRules(t_get_config(arch), FakeMesh(sizes),
                                     JPlan(**PLANS[plan_kind])).params_specs(shapes))
            got = S.ShardingRules(t_get_config(arch), sizes,
                                  TPlan(**PLANS[plan_kind])).params_specs(shapes)
        assert got == want, (arch, plan_kind, m)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "smollm_360m", "inception_v3", "biglstm"])
def test_param_specs_of_the_port_tree(arch):
    """``param_specs`` (from the port's parameter shapes, no init) equals
    the rules over JAX's tree of the same config."""
    from repro.parallel.plan import ParallelPlan as JPlan
    from repro.parallel.sharding import ShardingRules as JRules

    sizes = {"data": 1, "model": 2}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jax_specs(JRules(t_get_config(arch), FakeMesh(sizes), JPlan())
                          .params_specs(_jax_shapes(arch)))
        got = S.param_specs(t_get_config(arch), S.ShardingRules(t_get_config(arch), sizes,
                                                                TPlan()))
    assert got == want


def test_fallback_warns_once_per_rule():
    """SmolLM's 15 heads on a 16-way axis replicate with a warning naming
    the path and dim, once per rule (JAX's text); a divisible arch warns
    about nothing but heads."""
    shapes = _jax_shapes("smollm_360m")
    rules = S.ShardingRules(t_get_config("smollm_360m"), {"data": 16, "model": 16}, TPlan())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rules.params_specs(shapes)
        msgs = [str(x.message) for x in w if "[sharding]" in str(x.message)]
    assert any("wq" in m and "15" in m and "16-way" in m for m in msgs), msgs
    assert "[sharding] layers.attn.wq: head groups 15 (dim 960) not divisible by the " \
           "16-way model axis 'model'; replicating this param across tensor-MP (per-device " \
           "memory/compute x16 for it)" in msgs
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        rules.params_specs(shapes)
    assert not [x for x in w2 if "[sharding]" in str(x.message)]
    ok = S.ShardingRules(t_get_config("llama3_2_1b"), {"data": 16, "model": 16}, TPlan())
    with warnings.catch_warnings(record=True) as w3:
        warnings.simplefilter("always")
        ok.params_specs(_jax_shapes("llama3_2_1b"))
    assert not [x for x in w3 if "[sharding]" in str(x.message)
                and "head" not in str(x.message)]


def _init(arch, **changes):
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(t_get_config(arch).reduced(), **changes)
    return cfg, build_model(cfg, device="cpu").init(0)


@pytest.mark.parametrize("arch,changes,m", [
    ("llama3_2_1b", {}, 2), ("llama3_2_1b", {"n_kv_heads": 1}, 2),
    ("llama3_2_1b", {}, 4), ("inception_v3", {}, 2), ("smollm_360m", {"n_heads": 3,
                                                                      "n_kv_heads": 1}, 2)])
def test_shard_then_gather_is_the_identity(arch, changes, m):
    """Each rank's part holds the contiguous slice j of every sharded leaf's
    model dim and the whole of every replicated leaf; gathering the parts
    gives the tree back bit for bit."""
    from repro_torch.tree import tree_leaves

    cfg, params = _init(arch, **changes)
    rules = S.ShardingRules(cfg, {"data": 1, "model": m}, TPlan())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        specs = S.param_specs(cfg, rules)
        parts = [S.shard_params(params, rules, j) for j in range(m)]
    back = S.gather_params(parts, rules, specs)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    flags = S.replicated_leaves(params, specs, rules)
    assert any(flags) and not all(flags)
    for j, part in enumerate(parts):
        for leaf, whole, rep in zip(tree_leaves(part), tree_leaves(params), flags):
            if rep:
                assert leaf is whole
            else:
                assert leaf.numel() * m == whole.numel()
    if arch == "llama3_2_1b":
        wq = params["layers"]["attn"]["wq"]
        n = wq.shape[-1] // m
        assert torch.equal(parts[1]["layers"]["attn"]["wq"], wq[..., n:2 * n])
        assert parts[1]["embed"].shape[0] == params["embed"].shape[0] // m


def test_overlapped_supported_matches_jax():
    """The gate of the overlapped block: JAX's answer over JAX's grid (model
    axis, runtime, chunks, sequence, MoE and RWKV)."""
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT

    def mesh(m):
        return FakeMesh({"data": 2, "model": m})

    for arch in ("llama3_2_1b", "granite_moe_1b_a400m", "rwkv6_7b", "smollm_360m"):
        jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
        for m in (1, 2, 4, 8):
            for rt in ("overlapped", "gspmd"):
                for chunks in (1, 2, 3):
                    for t in (30, 32):
                        kw = dict(batch_axes=("data",), model_axis="model",
                                  comm_runtime=rt, comm_chunks=chunks)
                        want = JT.overlapped_supported(jcfg, JT.ParallelCtx(mesh=mesh(m), **kw),
                                                       t)
                        got = TT.overlapped_supported(tcfg, TT.ParallelCtx(mesh=mesh(m), **kw),
                                                      t)
                        assert got == want, (arch, m, rt, chunks, t)
        assert not TT.overlapped_supported(tcfg, None, 32)
