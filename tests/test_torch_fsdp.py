"""The fsdp plans of the port (``ParallelPlan.fsdp_axes``): parameters and
AdamW state sharded over DP, alone and under tensor and context MP, on gloo
ranks on the CPU.

- ``gather_fsdp(shard_fsdp(.))`` is the identity on reduced Llama, BigLSTM,
  GNMT and RWKV6 trees, and each shard's shape follows JAX's
  ``ShardingRules(fsdp_axes=("data",))`` specs;
- on one dp = 2 spawn, two fsdp AdamW steps (clip 1.0) of reduced Llama,
  BigLSTM and RWKV6, and of Llama with the plan's accumulation of 2, equal
  JAX's single-device steps on the full batch (``JAX_STEP_TOL``) and the
  port's plain dp = 2 steps (``STEP_TOL``); each rank keeps 1/2 of every
  leaf the rules shard; a fsdp checkpoint is the one-process file, and it
  restores into plain dp = 2 and back bit for bit;
- on one 2 x 2 spawn, tensor + fsdp (both runtimes) and context + fsdp
  steps of reduced Llama equal JAX's;
- Adafactor under fsdp builds a step, pipelined plans under fsdp name
  ROADMAP item 5b;
- the launcher plans the planner's fsdp choices and says ``+fsdp``.

JAX is imported inside the fixtures and tests only; its references are
computed once a module.
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_dp import JAX_STEP_TOL, STEP_TOL

from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import train as TL
from repro_torch.parallel import dist as D
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ARCHS = ("llama3_2_1b", "biglstm", "rwkv6_7b")
STEPS, BATCH, SEQ = 2, 8, 16
FSDP = ParallelPlan(model_axis=None, fsdp_axes=("data",))
PLAIN = ParallelPlan(model_axis=None)
# (name, plan) of the 2 x 2 spawn's cases, all of reduced Llama
MESH_CASES = (
    ("tensor gspmd", ParallelPlan(fsdp_axes=("data",))),
    ("tensor overlapped", ParallelPlan(fsdp_axes=("data",), comm_runtime="overlapped")),
    ("context", ParallelPlan(mp_kind="context", fsdp_axes=("data",))))


def _cfg(arch, pkg_get_config):
    return pkg_get_config(arch).reduced()


def _batches():
    from repro_torch.data import make_lm_dataset
    it = make_lm_dataset(vocab=64, seq_len=SEQ).epoch(0, BATCH)
    return [{k: v.astype(np.int64) for k, v in next(it).items()} for _ in range(STEPS)]


def _opt(module):
    return module.adamw(module.warmup_cosine(3e-3, 20, STEPS))


def _whole(tree):
    return tree_map(lambda t: t.detach().cpu(), tree)


def _run_steps(api, opt, state, mesh, plan):
    from repro_torch.train import make_train_step

    step = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0)
    losses, norms = [], []
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms


def _max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _placed(api, opt, np_params, mesh, plan):
    """JAX's init, as the port's global state, cut to this rank's part."""
    from repro_torch.interop import params_from_jax
    from repro_torch.train import TrainState, place_state

    params = params_from_jax(np_params, api.cfg, "cpu")
    return place_state(TrainState(params, opt.init(params), 0), api, mesh, plan)


def _resident(api, opt, mesh):
    """(elements this rank holds, elements of the whole tree) over the
    leaves the rules shard over ``data``, and whether every other leaf is
    whole, for ``init_train_state``'s parameters, ``m`` and ``v``."""
    from repro_torch.train import init_train_state

    state = init_train_state(api, opt, 0, mesh=mesh, plan=FSDP)
    whole = api.init(0)
    rules = SH.ShardingRules(api.cfg, dict(mesh.shape), FSDP)
    dims = SH.fsdp_dims(whole, SH.param_specs(api.cfg, rules), rules)
    held = total = 0
    rest_whole = True
    for tree in (state.params, state.opt_state["m"], state.opt_state["v"]):
        for t, w, d in zip(tree_leaves(tree), tree_leaves(whole), dims):
            if d is None:
                rest_whole &= t.shape == w.shape
            else:
                held, total = held + t.numel(), total + w.numel()
    want = SH.shard_fsdp(whole, rules, mesh.data_index)
    return held, total, rest_whole, _max_err(state.params, want) == 0.0


def _dp_rank(mesh, payload):
    """Every dp = 2 case on one rank: the plain and the fsdp steps of each
    arch, the accumulating fsdp step, the resident shares and the checkpoint
    round trip."""
    from repro_torch import checkpoint as C
    from repro_torch import optim as TO
    from repro_torch.models.api import build_model
    from repro_torch.train import checkpoint_saver, eval_train_state, global_state, place_state

    out = {}
    for arch in ARCHS:
        api = build_model(_cfg(arch, t_get_config), device="cpu")
        runs = {}
        for name, plan in (("plain", PLAIN), ("fsdp", FSDP)):
            opt = _opt(TO)
            state = _placed(api, opt, payload["params"][arch], mesh, plan)
            state, losses, norms = _run_steps(api, opt, state, mesh, plan)
            whole = global_state(state, api, mesh, plan)
            runs[name] = (losses, norms, None if whole is None else _whole(whole.params))
        out[arch] = runs
        out[(arch, "resident")] = _resident(api, _opt(TO), mesh)
        if arch == "llama3_2_1b":
            for name, base in (("accum plain", PLAIN), ("accum", FSDP)):
                plan = dataclasses.replace(base, microbatches=2)
                opt = _opt(TO)
                state = _placed(api, opt, payload["params"][arch], mesh, plan)
                state, losses, norms = _run_steps(api, opt, state, mesh, plan)
                whole = global_state(state, api, mesh, plan)
                out[name] = (losses, norms, None if whole is None else _whole(whole.params))
            # the checkpoint round trip: fsdp -> file A -> plain dp = 2 -> file B -> fsdp
            like = eval_train_state(api, opt)
            a = checkpoint_saver(api, mesh, plan)(payload["ckpt"] + "/a", state, STEPS)
            plain = C.restore_checkpoint(a, like, lambda s: place_state(s, api, mesh, PLAIN))
            b = checkpoint_saver(api, mesh, PLAIN)(payload["ckpt"] + "/b", plain, STEPS)
            back = C.restore_checkpoint(b, like, lambda s: place_state(s, api, mesh, plan))
            out["ckpt"] = {"files": (a, b), "back_same_bits": all(
                torch.equal(x, y) for x, y in zip(
                    tree_leaves((back.params, back.opt_state)),
                    tree_leaves((state.params, state.opt_state))))}
    return out


def _mesh_rank(mesh, payload):
    """The 2 x 2 cases on one rank: each rank's shard and, on rank 0, the
    gathered global parameters, against JAX's."""
    from repro_torch import optim as TO
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import global_state

    api = build_model(_cfg("llama3_2_1b", t_get_config), device="cpu")
    want = params_from_jax(payload["after"], api.cfg, "cpu")
    out = {}
    for name, plan in MESH_CASES:
        opt = _opt(TO)
        state = _placed(api, opt, payload["params"], mesh, plan)
        state, losses, norms = _run_steps(api, opt, state, mesh, plan)
        rules = SH.ShardingRules(api.cfg, dict(mesh.shape), plan)
        specs = SH.param_specs(api.cfg, rules)
        mine = want
        if plan.mp_kind == "tensor":
            mine = SH.shard_params(mine, rules, mesh.model_index)
        mine = SH.shard_fsdp(mine, rules, mesh.data_index, specs)
        whole = global_state(state, api, mesh, plan)
        out[name] = (losses, norms, _max_err(state.params, mine),
                     None if whole is None else _max_err(whole.params, want))
    return out


def _jax_steps(arch, batches, microbatches=1):
    """JAX's single-device steps from its seeded init: (init as numpy,
    losses, grad norms, final parameters as numpy)."""
    import jax
    import jax.numpy as jnp
    from repro import optim as JO
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.parallel.plan import ParallelPlan as JPlan
    from repro.train import steps as JS

    japi = j_build_model(_cfg(arch, j_get_config), remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jparams)
    jopt = _opt(JO)
    step = jax.jit(JS.make_train_step(japi, jopt, plan=JPlan(microbatches=microbatches)))
    state = JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                          step=jnp.zeros((), jnp.int32))
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v.astype(np.int32)) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """JAX's steps, then the dp = 2 spawn and the 2 x 2 spawn."""
    batches = _batches()
    ref = {arch: _jax_steps(arch, batches) for arch in ARCHS}
    ref["accum"] = _jax_steps("llama3_2_1b", batches, microbatches=2)
    ckpt = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    dp = D.spawn_ranks(_dp_rank, 2, "cpu", threads=1, args=(
        {"params": {a: ref[a][0] for a in ARCHS}, "ckpt": ckpt},))
    llama = ref["llama3_2_1b"]
    mesh = D.spawn_ranks(_mesh_rank, 4, "cpu", stages=2, threads=1,
                         args=({"params": llama[0], "after": llama[3]},))
    return {"jax": ref, "dp": dp, "mesh": mesh}


def _close(got, want, tol):
    losses, norms = got
    jl, jn = want
    for g, w in zip(losses, jl):
        assert abs(g - w) <= tol["loss"] * abs(w), (losses, jl)
    for g, w in zip(norms, jn):
        assert abs(g - w) <= tol["grad_norm"] * abs(w), (norms, jn)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_trees_round_trip_with_jax_shapes(arch):
    """Each shard of a reduced tree has the shape of JAX's fsdp spec cut over
    2 data ranks, and the shards gather back to the tree (GNMT too)."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.parallel.plan import ParallelPlan as JPlan
    from repro.parallel.sharding import ShardingRules as JRules
    from repro_torch.interop import params_from_jax
    from test_torch_sharding import FakeMesh, _jax_specs

    rng = np.random.default_rng(0)
    for name in (arch, "gnmt") if arch == "biglstm" else (arch,):
        jcfg, cfg = _cfg(name, j_get_config), _cfg(name, t_get_config)
        shapes = jax.eval_shape(j_build_model(jcfg, remat=False).init, jax.random.PRNGKey(0))
        jspecs = _jax_specs(JRules(jcfg, FakeMesh({"data": 2, "model": 1}), JPlan(
            model_axis=None, fsdp_axes=("data",))).params_specs(shapes))
        tree = params_from_jax(jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes), cfg, "cpu")
        rules = SH.ShardingRules(cfg, {"data": 2, "model": 1}, FSDP)
        specs = SH.param_specs(cfg, rules)
        parts = [SH.shard_fsdp(tree, rules, d, specs) for d in range(2)]
        assert _max_err(SH.gather_fsdp(parts, rules, specs), tree) == 0.0
        want = tree_map(lambda t, spec: tuple(
            n // 2 if a in ("data", ("data",)) else n
            for n, a in zip(t.shape, tuple(spec) + (None,) * t.dim())), tree, jspecs)
        assert tree_map(lambda t: tuple(t.shape), parts[1]) == want, name
        assert any(d is not None for d in SH.fsdp_dims(tree, specs, rules)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_step_matches_jax_and_plain_dp(fsdp_runs, arch):
    """Two fsdp steps on 2 ranks: losses, grad norms and the gathered
    parameters against JAX's single-device steps (``JAX_STEP_TOL``) and
    the port's plain dp = 2 steps (``STEP_TOL``)."""
    _, jl, jn, jafter = fsdp_runs["jax"][arch]
    from repro_torch.interop import params_from_jax
    want = params_from_jax(jafter, _cfg(arch, t_get_config), "cpu")
    for r in fsdp_runs["dp"]:
        losses, norms, _ = r[arch]["fsdp"]
        _close((losses, norms), (jl, jn), JAX_STEP_TOL)
        _close((losses, norms), r[arch]["plain"][:2], STEP_TOL)
    fsdp, plain = fsdp_runs["dp"][0][arch]["fsdp"][2], fsdp_runs["dp"][0][arch]["plain"][2]
    assert _max_err(fsdp, want) <= JAX_STEP_TOL["params"]
    assert _max_err(fsdp, plain) <= STEP_TOL["params"]


def test_fsdp_step_accumulates_the_plans_micro_batches(fsdp_runs):
    """Llama with the plan's accumulation count 2 under fsdp against JAX's
    accumulating single-device step and the port's accumulating plain
    dp = 2 step."""
    _, jl, jn, jafter = fsdp_runs["jax"]["accum"]
    from repro_torch.interop import params_from_jax
    for r in fsdp_runs["dp"]:
        _close(r["accum"][:2], (jl, jn), JAX_STEP_TOL)
        _close(r["accum"][:2], r["accum plain"][:2], STEP_TOL)
    want = params_from_jax(jafter, _cfg("llama3_2_1b", t_get_config), "cpu")
    fsdp, plain = fsdp_runs["dp"][0]["accum"][2], fsdp_runs["dp"][0]["accum plain"][2]
    assert _max_err(fsdp, want) <= JAX_STEP_TOL["params"]
    assert _max_err(fsdp, plain) <= STEP_TOL["params"]


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_half_of_the_sharded_state(fsdp_runs, arch):
    """``init_train_state``'s parameters, ``m`` and ``v`` on each rank: 1/2
    of the elements of the leaves the rules shard, the rest whole, and the
    shard the one ``shard_fsdp`` cuts."""
    for r in fsdp_runs["dp"]:
        held, total, rest_whole, same = r[(arch, "resident")]
        assert total > 0 and 2 * held == total and rest_whole and same


def test_fsdp_checkpoint_is_the_one_process_file(fsdp_runs):
    """The fsdp run's file holds the global state: it restores in one
    process, into plain dp = 2 (whose file is the same bits) and back into
    the fsdp shards bit for bit."""
    from repro_torch import checkpoint as C
    from repro_torch import optim as TO
    from repro_torch.models.api import build_model
    from repro_torch.train import eval_train_state, place_state

    a, b = fsdp_runs["dp"][0]["ckpt"]["files"]
    assert all(r["ckpt"]["back_same_bits"] for r in fsdp_runs["dp"])
    la, lb = C.read_leaves(a), C.read_leaves(b)
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))
    api = build_model(_cfg("llama3_2_1b", t_get_config), device="cpu")
    state = C.restore_checkpoint(a, eval_train_state(api, _opt(TO)),
                                 lambda s: place_state(s, api))
    assert state.step == STEPS
    assert _max_err(state.params, fsdp_runs["dp"][0]["accum"][2]) == 0.0


@pytest.mark.parametrize("name", [n for n, _ in MESH_CASES])
def test_fsdp_under_tensor_and_context_mp_matches_jax(fsdp_runs, name):
    """Tensor + fsdp under both runtimes and context + fsdp on 2 x 2 ranks:
    losses, grad norms, each rank's shard and rank 0's gathered parameters
    against JAX's single-device steps."""
    _, jl, jn, _ = fsdp_runs["jax"]["llama3_2_1b"]
    for r in fsdp_runs["mesh"]:
        losses, norms, shard_err, whole_err = r[name]
        _close((losses, norms), (jl, jn), JAX_STEP_TOL)
        assert shard_err <= JAX_STEP_TOL["params"]
    assert fsdp_runs["mesh"][0][name][3] <= JAX_STEP_TOL["params"]


def test_adafactor_and_pipelined_fsdp_name_item_5b():
    """Adafactor under fsdp builds a step (its statistics are the whole
    leaf's: tests/test_torch_optim.py holds its steps on ranks against
    JAX's); a pipelined plan with fsdp names item 5b."""
    from repro_torch import optim as TO
    from repro_torch.models.api import build_model
    from repro_torch.train import make_train_step

    api = build_model(_cfg("llama3_2_1b", t_get_config), device="cpu")
    assert callable(make_train_step(api, TO.adafactor(TO.constant_lr(0.1)), plan=FSDP))
    mesh = type("Mesh", (), {"shape": {"data": 2, "model": 2}})()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 5b"):
        make_train_step(api, _opt(TO), mesh=mesh,
                        plan=ParallelPlan(mp_kind="pipeline", fsdp_axes=("data",)))


@pytest.mark.parametrize("arch,devices", [("rwkv6_7b", 2), ("stablelm_12b", 4)])
def test_launcher_plans_the_planners_fsdp_choice(capsys, arch, devices):
    """The planner's DP plan for RWKV6-7B at 2 cards and StableLM-12B at 4
    shards the state over DP: the launcher keeps it (narrowed to the ranks'
    data axis) and says so in its ``[plan]`` line."""
    run, dp, stages = TL.plan_run(["--arch", arch, "--parallel", "auto", "--devices",
                                   str(devices), "--device", "cpu"])
    assert (dp, stages) == (devices, 1) and run.plan.fsdp_axes == ("data",)
    assert f"[plan] {devices}-way DP x 1-way tensor MP +fsdp on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch,devices", [("rwkv6_7b", 2), ("stablelm_12b", 4)])
def test_launcher_refuses_an_fsdp_step_that_cannot_fit(arch, devices):
    """At full depth the port's fsdp step (the whole tree gathered, the
    gradients full-size) cannot fit the card the planner's ZeRO-2 model
    fits: the launcher exits naming item 23 before it starts a rank.  Cut
    to 2 layers, the same plan fits."""
    argv = ["--arch", arch, "--parallel", "auto", "--devices", str(devices),
            "--device", "cpu", "--steps", "1"]
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 23"):
        TL.main(argv)
    run, dp, stages = TL.plan_run(argv)
    cut = dataclasses.replace(run, cfg=dataclasses.replace(run.cfg, n_layers=2))
    assert TL.fsdp_step_bytes(cut, dp, stages) < TL.fsdp_step_bytes(run, dp, stages)
    TL.check_fsdp_fits(cut, dp, stages)
