"""Expert parallelism of the port (``models.moe.moe_ffn`` over a model axis,
the MoE branch of ``models.transformer.tp_block_apply``, the tensor plans
of ``train.steps`` and ``launch.train`` over an MoE model) against the JAX
package, on gloo ranks on the CPU, where the expert products take ``gmm``'s
plain version.  Configs: reduced ``granite_moe_1b_a400m`` (4 experts, top-2)
and reduced ``kimi_k2_1t_a32b`` (the same with a shared expert); weights
from the JAX init (``interop.params_from_jax``), inputs from seeded numpy.

One 4-rank spawn holds every value case (a 1 x 4 mesh and the 2 x 2 mesh
made of the same ranks):

- ``moe_ffn`` at mp 2 and 4, and with ``ff_axes`` over the data axis of the
  2 x 2 mesh (each expert's hidden dim sliced over it, the tokens the same
  on every rank), against JAX's local ``moe_ffn``: output and aux within
  ``FFN_TOL``, and the gradients of sum(out c) + 0.3 aux, each rank's slice
  of every leaf and the whole input gradient, within ``FFN_TOL``;
- the loss and gradients of the whole model at dp 2 x mp 2 against JAX's
  single-device ``loss_fn`` at ``capacity_factor=None`` (a rank's capacity
  comes from its own tokens, as in JAX), and at dp 1 x mp 2 at the default
  capacity (the same drops as one device), within ``GRID_TOL``: the port's
  aux is the global batch's at every dp;
- one AdamW and one Adafactor step at dp 2 x mp 2, with and without
  ``fsdp_axes`` (and kimi's AdamW step with them), against JAX's
  single-device step within ``STEP_TOL``, the leaves the rules replicate
  the same bits on both ranks of a model group.

JAX's own expert-parallel shard_map at dp 2 returns one data shard's aux
(its ``out_specs`` P() with replication unchecked); a subprocess with four
forced host devices shows that the port's loss is the single-device one
where JAX's is not.  The launcher trains ``--parallel mp=2`` and (at
capacity None) ``dp=2,mp=2`` as one process trains, its ``mp=2`` checkpoint
restores on one process, and ``--parallel auto --devices 8`` resolves
full-width Granite to the planner's tensor plan.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import train as TL
from repro_torch.parallel import dist as D
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import cli_env, one_torch_thread  # noqa: F401  (autouse: one torch thread)

ARCHS = {"granite": "granite_moe_1b_a400m", "kimi": "kimi_k2_1t_a32b"}
# fp32 round-off: the layer's output and aux (absolute), its gradients over
# max(1, |JAX's|) (tests/test_torch_tensor_mp.py's INC_TOL form)
FFN_TOL = 2e-5
# the whole model's loss (absolute) and gradients (over max(1, |JAX's|))
GRID_TOL = {"loss": 2e-5, "grads": 2e-5}
# one step: the loss absolute, each leaf norm-relative (tests/test_torch_context.py's)
STEP_TOL = {"loss": 5e-5, "params": 5e-5}
AUX_W = 0.3
FFN_B, FFN_S = 2, 16
TENSOR = ParallelPlan(model_axis="model")
FSDP = dataclasses.replace(TENSOR, fsdp_axes=("data",))
# (name, arch, plan): the optimizer is the name's first word
STEP_CASES = (("adamw", "granite", TENSOR), ("adamw fsdp", "granite", FSDP),
              ("adafactor", "granite", TENSOR), ("adafactor fsdp", "granite", FSDP),
              ("adamw fsdp kimi", "kimi", FSDP))


def _batch():
    rng = np.random.default_rng(3)
    return {"tokens": rng.integers(0, 1000, (8, 16)), "labels": rng.integers(0, 1000, (8, 16))}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _opt(module, name):
    return (module.adafactor(module.constant_lr(1e-2)) if name.startswith("adafactor")
            else module.adamw(module.warmup_cosine(1e-3, 2, 10)))


# --- the ranks -------------------------------------------------------------------------

def _mesh_of(mesh, dp: int, s: int):
    """A dp x s ``RankMesh`` over the ranks of ``mesh`` (every rank makes
    every group, in one order)."""
    import torch.distributed as dist

    groups = {a: None for a in ("data", "model", "ends")}
    for axis, ranks in D._group_specs(dp, s):
        g = dist.new_group(ranks)
        if mesh.rank in ranks and groups[axis] is None:
            groups[axis] = g
    return D.RankMesh({"data": dp, "model": s}, mesh.rank, mesh.transport, mesh.device, groups)


def _ffn_case(mesh, ref, arch, ff: bool):
    """``moe_ffn`` on this rank's part: errors of the output, the aux and the
    gradients against JAX's local layer."""
    from repro_torch.models import moe as TM

    cfg = t_get_config(ARCHS[arch]).reduced()
    j, m = mesh.ring("model")[:2]
    e, eff = cfg.n_experts // m, cfg.expert_d_ff
    f, n_f = (mesh.data_index, mesh.shape["data"]) if ff else (0, 1)
    fl = eff // n_f

    def part(name, t):
        t = torch.from_numpy(np.array(t))
        if name in ("wi", "wg", "wo"):
            t = t[j * e:(j + 1) * e]
            return (t[:, f * fl:(f + 1) * fl] if name == "wo" else t[..., f * fl:(f + 1) * fl]
                    ).contiguous()
        return t

    def shared(name, t):
        t = torch.from_numpy(np.array(t))
        n = t.shape[-1 if name != "wo" else 0] // m
        return (t[j * n:(j + 1) * n] if name == "wo" else t[:, j * n:(j + 1) * n]).contiguous()

    params = {k: part(k, v) for k, v in ref["params"].items() if k != "shared"}
    if "shared" in ref["params"]:
        params["shared"] = {k: shared(k, v) for k, v in ref["params"]["shared"].items()}
    leaves = tree_map(lambda t: t.requires_grad_(), params)
    x = torch.from_numpy(ref["x"]).requires_grad_()
    out, aux = TM.moe_ffn(leaves, x, cfg, model_axis="model", ff_axes=("data",) if ff else None,
                          mesh=mesh)
    loss = (out * torch.from_numpy(ref["c"])).sum() + AUX_W * aux
    grads = torch.autograd.grad(loss, [x] + tree_leaves(leaves))
    want_p = {k: part(k, v) for k, v in ref["grads"][0].items() if k != "shared"}
    if "shared" in ref["grads"][0]:
        want_p["shared"] = {k: shared(k, v) for k, v in ref["grads"][0]["shared"].items()}
    want = [torch.from_numpy(ref["grads"][1])] + tree_leaves(want_p)
    return (float((out - torch.from_numpy(ref["out"])).abs().max()),
            abs(float(aux) - ref["aux"]), _grad_err(grads, want))


def _grad_err(grads, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(grads, want))


def _rank_grads(api, params, batch, mesh, plan):
    """This rank's loss and gradients, each summed over its data shards."""
    from repro_torch.train.steps import _dp_shard, _make_pctx

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = api.loss_fn(leaves, _dp_shard(_torch_batch(batch), mesh), _make_pctx(mesh, plan))
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    loss = D.all_reduce(mesh, loss.detach().reshape(1), "data")
    for g in grads:
        D.all_reduce(mesh, g, "data")
    return float(loss), grads


def _ep_rank(mesh, payload):
    """Every value case on one rank of a 1 x 4 spawn."""
    from repro_torch import optim as TO
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainState, global_state, make_train_step, place_state
    from test_torch_tensor_mp import _view

    warnings.simplefilter("ignore")
    m22 = _mesh_of(mesh, 2, 2)
    pair = _view(m22, 1)
    out = {"ffn": {}, "grid": {}, "step": {}, "replicated": {}}
    for arch, ref in payload["ffn"].items():
        out["ffn"][(arch, "mp=4")] = _ffn_case(mesh, ref, arch, False)
        out["ffn"][(arch, "mp=2")] = _ffn_case(pair, ref, arch, False)
    out["ffn"][("granite", "dp=2,mp=2 ff_axes")] = _ffn_case(m22, payload["ffn"]["granite"],
                                                             "granite", True)
    for (arch, cf), (np_params, want_loss, np_grads) in payload["grid"].items():
        cfg = t_get_config(ARCHS[arch]).reduced()
        api = build_model(cfg, device="cpu", capacity_factor=cf)
        view = m22 if cf is None else pair
        rules = SH.ShardingRules(cfg, dict(view.shape), TENSOR)
        params = SH.shard_params(params_from_jax(np_params, cfg, "cpu"), rules, view.model_index)
        want = tree_leaves(SH.shard_params(params_from_jax(np_grads, cfg, "cpu"), rules,
                                           view.model_index))
        loss, grads = _rank_grads(api, params, _batch(), view, TENSOR)
        out["grid"][(arch, cf)] = (abs(loss - want_loss), _grad_err(grads, want))
    for name, arch, plan in STEP_CASES:
        cfg = t_get_config(ARCHS[arch]).reduced()
        api = build_model(cfg, device="cpu", capacity_factor=None)
        opt = _opt(TO, name)
        # the step writes in place, and a whole leaf's part is the leaf itself
        whole = params_from_jax(payload["grid"][(arch, None)][0], cfg, "cpu")
        state = place_state(TrainState(whole, opt.init(whole), 0), api, m22, plan)
        state, metrics = make_train_step(api, opt, mesh=m22, plan=plan, clip_norm=1.0)(
            state, _torch_batch(_batch()))
        g = global_state(state, api, m22, plan)
        out["step"][name] = (float(metrics["loss"]), None if g is None else
                             [t.double().numpy() for t in tree_leaves(g.params)])
        rules = SH.ShardingRules(cfg, dict(m22.shape), plan)
        flags = SH.replicated_leaves(state.params, SH.param_specs(cfg, rules), rules)
        out["replicated"][name] = [t for t, rep in zip(tree_leaves(state.params), flags) if rep]
    return out


# --- the JAX references -----------------------------------------------------------------

def _jax_ffn(arch):
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import moe as JM

    cfg = j_get_config(ARCHS[arch]).reduced()
    params = JM.moe_init(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((FFN_B, FFN_S, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((FFN_B, FFN_S, cfg.d_model)).astype(np.float32)

    def f(p, xx):
        o, a = JM.moe_ffn(p, xx, cfg)
        return (o * c).sum() + AUX_W * a, (o, a)

    (_, (o, a)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    return {"params": jax.tree.map(np.asarray, params), "x": x, "c": c, "out": np.asarray(o),
            "aux": float(a), "grads": jax.tree.map(np.asarray, grads)}


def _jax_grid(arch, cf):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model

    api = j_build_model(j_get_config(ARCHS[arch]).reduced(), remat=False, capacity_factor=cf)
    params = api.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v.astype(np.int32)) for k, v in _batch().items()}
    (loss, _), grads = jax.value_and_grad(api.loss_fn, has_aux=True)(params, batch)
    return jax.tree.map(np.asarray, params), float(loss), jax.tree.map(np.asarray, grads)


def _jax_step(np_params, name, arch):
    import jax
    import jax.numpy as jnp
    from repro import optim as JO
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.train import steps as JS

    api = j_build_model(j_get_config(ARCHS[arch]).reduced(), remat=False,
                        capacity_factor=None)
    params = jax.tree.map(jnp.asarray, np_params)
    opt = _opt(JO, name)
    state = JS.TrainState(params=params, opt_state=opt.init(params),
                          step=jnp.zeros((), jnp.int32))
    state, m = jax.jit(JS.make_train_step(api, opt, clip_norm=1.0))(
        state, {k: jnp.asarray(v.astype(np.int32)) for k, v in _batch().items()})
    return float(m["loss"]), [np.asarray(t, np.float64) for t in jax.tree.leaves(state.params)]


@pytest.fixture(scope="module")
def ep_runs():
    ffn = {arch: _jax_ffn(arch) for arch in ARCHS}
    grid = {(arch, None): _jax_grid(arch, None) for arch in ARCHS}
    grid[("granite", 1.25)] = _jax_grid("granite", 1.25)
    steps = {name: _jax_step(grid[(arch, None)][0], name, arch)
             for name, arch, _ in STEP_CASES}
    ranks = D.spawn_ranks(_ep_rank, 4, "cpu", args=({"ffn": ffn, "grid": grid},),
                          stages=4, threads=1)
    return {"grid": grid, "steps": steps, "ranks": ranks}


# --- the tests ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [("granite", "mp=2"), ("granite", "mp=4"), ("kimi", "mp=2"),
                                  ("kimi", "mp=4"), ("granite", "dp=2,mp=2 ff_axes")])
def test_moe_ffn_on_ranks_matches_jax(ep_runs, case):
    """Each rank's experts (and hidden slice under ff_axes) and the shared
    expert's column/row slices give JAX's layer output and aux on every rank,
    and every rank's gradients are its slices of JAX's."""
    for r in ep_runs["ranks"]:
        out_err, aux_err, grad_err = r["ffn"][case]
        assert max(out_err, aux_err, grad_err) <= FFN_TOL, (case, out_err, aux_err, grad_err)


@pytest.mark.parametrize("case", [("granite", None), ("kimi", None), ("granite", 1.25)])
def test_moe_model_on_ranks_matches_jax(ep_runs, case):
    """The loss and gradients of the model at dp 2 x mp 2 (no drop) and dp 1
    x mp 2 (the default capacity) equal JAX's single-device ``loss_fn``."""
    for r in ep_runs["ranks"]:
        loss_err, grad_err = r["grid"][case]
        assert loss_err <= GRID_TOL["loss"], (case, loss_err)
        assert grad_err <= GRID_TOL["grads"], (case, grad_err)


@pytest.mark.parametrize("name", [c[0] for c in STEP_CASES])
def test_moe_steps_on_ranks_match_jax(ep_runs, name):
    """One AdamW or Adafactor step at dp 2 x mp 2, with and without fsdp
    (kimi's shape: tensor MP and fsdp over an MoE model with a shared
    expert), equals JAX's single-device step; the replicated leaves (the
    router, the norms) keep the same bits on both ranks of each model
    group."""
    want_loss, want = ep_runs["steps"][name]
    ranks = ep_runs["ranks"]
    for r in ranks:
        assert abs(r["step"][name][0] - want_loss) <= STEP_TOL["loss"]
    got = ranks[0]["step"][name][1]
    assert got is not None and len(got) == len(want)
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= STEP_TOL["params"] * max(np.linalg.norm(w), 1e-30)
    for a, b in ((0, 1), (2, 3)):
        assert all(torch.equal(x, y) for x, y in zip(ranks[a]["replicated"][name],
                                                     ranks[b]["replicated"][name]))


def test_jax_ep_returns_one_data_shards_aux(ep_runs):
    """JAX's expert-parallel shard_map at dp 2 x mp 2 returns the aux of the
    first data shard (its loss is that shard's aux over the global NLL),
    while the port's ranks return the single-device loss: the difference
    ROADMAP.md records."""
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from repro.parallel.jaxcompat import make_mesh, set_mesh
        from repro.configs import get_config
        from repro.models import build_model
        from repro.models.transformer import ParallelCtx
        from repro.parallel.plan import ParallelPlan
        from repro.parallel.sharding import ShardingRules
        cfg = get_config("granite_moe_1b_a400m").reduced()
        api = build_model(cfg, remat=False, capacity_factor=None)
        key = jax.random.PRNGKey(0)
        params = api.init(key)
        rng = np.random.default_rng(3)
        batch = {"tokens": jnp.asarray(rng.integers(0, 1000, (8, 16)), jnp.int32),
                 "labels": jnp.asarray(rng.integers(0, 1000, (8, 16)), jnp.int32)}
        nll = float(api.loss_fn(params, batch)[1]["loss"])
        aux0 = float(api.loss_fn(params, {k: v[:4] for k, v in batch.items()})[1]["aux"])
        mesh = make_mesh((2, 2), ("data", "model"))
        pctx = ParallelCtx(mesh=mesh, batch_axes=("data",), model_axis="model")
        rules = ShardingRules(cfg, mesh, ParallelPlan())
        p_sh = rules.params_shardings(jax.eval_shape(api.init, key))
        b_sh = rules.batch_shardings(jax.eval_shape(lambda: batch))
        with set_mesh(mesh):
            ep = jax.jit(lambda p, b: api.loss_fn(p, b, pctx)[0],
                         in_shardings=(p_sh, b_sh))(params, batch)
        print("EP", float(ep), nll + aux0)
    """)
    env = dict(cli_env(), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ep, shard0 = (float(v) for v in r.stdout.split("EP")[1].split())
    single = ep_runs["grid"][("granite", None)][1]
    assert abs(ep - shard0) <= 1e-5 and abs(ep - single) > 1e-4, (ep, shard0, single)
    assert ep_runs["ranks"][0]["grid"][("granite", None)][0] <= GRID_TOL["loss"]


# --- the launcher --------------------------------------------------------------------------

def _argv(*args):
    return ["--arch", ARCHS["granite"], "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", *args]


def test_launcher_trains_mp2_and_its_checkpoint_restores_on_one_process(capfd, tmp_path):
    """``--parallel mp=2`` trains as one process trains (the same drops at
    the default capacity; under ``--comm-runtime overlapped`` it warns and
    runs the gspmd block, as JAX's does), and its final checkpoint, restored
    by one process, holds the single run's parameters."""
    from repro_torch import checkpoint as C
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import eval_train_state

    single = TL.main(_argv())
    summary = TL.main(_argv("--parallel", "mp=2", "--comm-runtime", "overlapped",
                            "--ckpt-dir", str(tmp_path)))
    out, err = capfd.readouterr()
    assert "[plan] 1-way DP x 2-way tensor MP" in out and "[dist] backend=gloo ranks=2" in out
    assert "comm_runtime='overlapped' requested" in err     # MoE runs the gspmd block
    np.testing.assert_allclose(summary["history"], single["history"], rtol=1e-5)
    cfg = t_get_config(ARCHS["granite"]).reduced()
    api = build_model(cfg, device="cpu")
    restored = C.restore_checkpoint(C.checkpoint_path(str(tmp_path), 2),
                                    eval_train_state(api, adamw(warmup_cosine(3e-3, 20, 2))),
                                    lambda s: s)
    assert restored.step == 2
    for a, b in zip(tree_leaves(restored.params), tree_leaves(single["state"].params)):
        assert float(torch.linalg.norm(a - b)) <= 1e-5 * max(float(torch.linalg.norm(b)), 1e-30)


def test_launcher_trains_dp2_mp2_as_one_process():
    """The launcher's ``dp=2,mp=2`` run equals one process's at capacity
    None (at the default capacity each data shard drops by its own tokens,
    as JAX's ranks do)."""
    run, dp, stages = TL.plan_run(_argv("--parallel", "dp=2,mp=2"))
    assert (run.plan.mp_kind, dp, stages) == ("tensor", 2, 2)
    run = dataclasses.replace(run, capacity_factor=None)
    single = TL._train(None, run)
    summary = TL.run_ranks(run, dp, stages, "cpu")
    np.testing.assert_allclose(summary["history"], single["history"], rtol=1e-5)


def test_launcher_plans_the_planners_tensor_choice_for_granite(capsys):
    """Full-width Granite at ``--parallel auto --devices 8``: the planner's
    tensor 4 x 2 plan, its DP clamped to the local budget (2 ranks here),
    its model axis of 2 realised."""
    run, dp, stages = TL.plan_run(["--arch", ARCHS["granite"], "--device", "cpu", "--parallel",
                                   "auto", "--devices", "8", "--max-local-devices", "2"])
    out = capsys.readouterr().out
    assert "kind=tensor" in out and "[plan] clamped DP 4 -> 1" in out
    assert (run.plan.mp_kind, dp, stages) == ("tensor", 1, 2)
