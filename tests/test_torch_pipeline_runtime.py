"""The scheduled pipeline runtime of the port (``repro_torch.parallel.pipeline``)
against the JAX package's and against single-process autograd.

- ``plan_scheduled_runtime`` gives JAX's tick tables, store sizes and
  per-stage high-water marks over gpipe, 1f1b and interleaved x S in {2, 4} x
  K in {2, 4, 8} (pure Python);
- ``stack_to_stages`` / ``stages_to_stack`` give JAX's layouts (compared as
  arrays: JAX's own sharding-spec test fails under jax 0.9.0) and its shaped
  errors; a rank's init is bit-equal to the matching slices of the whole
  init;
- on S = 2 gloo ranks (``parallel.dist.spawn_ranks``, one spawn for the
  whole grid), JAX's toy grid (tanh layers, a scaled squared loss) over the
  three schedules and K in {2, 4}: loss, stage grads, loss-param grads and
  dx equal single-process autograd within 1e-5, and each rank's store
  high-water mark is the plan's (``pipeline_activation_residency`` for the
  v = 1 schedules);
- model level: reduced BigLSTM at 2 stages (1f1b, K 2) and a reduced dense
  decoder of 4 layers with tied embeddings at dp 2 x pipe 2, interleaved
  v 2, and at 4 stages, gpipe (4 ranks each), from JAX's weights (``interop.params_from_jax``): one
  pipelined train step's loss, grad norm and updated parameters against
  JAX's single-device step and the port's single-process step.

JAX is imported inside the tests only: the ranks import this module to find
their functions, and need only torch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.parallel import dist as D
from repro_torch.parallel import pipeline as TP
from repro_torch.tree import tree_leaves

KINDS = ("gpipe", "1f1b", "interleaved")
TABLE_GRID = [(kind, S, K) for kind in KINDS for S in (2, 4) for K in (2, 4, 8)]
TOY_GRID = [(kind, K) for kind in KINDS for K in (2, 4)]
TOY_L, TOY_D, TOY_B = 8, 16, 24
TOY_TOL = 1e-5
# one train step of the reduced models: loss and grad norm relative (fp32
# round-off of sums taken in another order); the updated parameters
# absolute, below one AdamW step at lr(0) = 1.5e-4 (the first step moves an
# element by lr * sign(g), except where |g| is near eps, where round-off in
# the gradient moves it by less)
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "params": 1e-4}
JAX_STEP_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "params": 1e-4}


# ---------------------------------------------------------------------------
# tables and layouts (pure)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,S,K", TABLE_GRID)
def test_runtime_tables_equal_jax(kind, S, K):
    from repro.parallel import pipeline as JP

    want = JP.plan_scheduled_runtime(JP.make_schedule(kind, S, K))
    got = TP.plan_scheduled_runtime(TP.make_schedule(kind, S, K))
    assert (got.n_ticks, got.fwd_slots, got.bwd_slots, got.stage_high_water) == \
        (want.n_ticks, want.fwd_slots, want.bwd_slots, want.stage_high_water)
    assert sorted(got.tables) == sorted(want.tables)
    for name, table in want.tables.items():
        assert np.array_equal(got.tables[name], np.asarray(table)), name
    residency = TP.pipeline_activation_residency(K, S, kind, got.schedule.v)
    if kind == "interleaved":
        assert got.schedule.residency_from_table() * got.schedule.v <= got.high_water \
            <= round(residency * got.schedule.v) + got.schedule.v - 1
    else:
        assert got.high_water == residency


@pytest.mark.parametrize("S,v", [(2, 1), (4, 1), (2, 2), (3, 2)])
def test_stage_layouts_equal_jax(S, v):
    from repro.parallel import pipeline as JP

    rng = np.random.default_rng(0)
    L = 2 * S * v
    stack = {"w": rng.standard_normal((L, 3, 5)).astype(np.float32),
             "b": rng.standard_normal((L, 5)).astype(np.float32)}
    want = JP.stack_to_stages(stack, S, v)
    got = TP.stack_to_stages({k: torch.from_numpy(a) for k, a in stack.items()}, S, v)
    for k in stack:
        assert tuple(got[k].shape) == want[k].shape == (S, v, L // (S * v)) + stack[k].shape[1:]
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    back = TP.stages_to_stack(got, S, v)
    assert all(np.array_equal(back[k].numpy(), stack[k]) for k in stack)
    # a stage's layers in its (chunk, layer) order
    for s in range(S):
        rows = TP.stage_layers(L, S, v, s)
        assert np.array_equal(stack["w"][rows].reshape(v, -1, 3, 5), np.asarray(want["w"][s]))


def test_stage_layout_shaped_errors():
    """The JAX test's regexes (tests/test_pipeline_runtime.py)."""
    params = {"w": torch.zeros((6, 3, 3))}
    with pytest.raises(ValueError, match=r"6.*n_stages \* virtual_stages"):
        TP.stack_to_stages(params, 4)
    with pytest.raises(ValueError, match="not\n?.*divisible|divisible"):
        TP.stack_to_stages(params, 2, 2)
    with pytest.raises(ValueError, match="stages_to_stack"):
        TP.stages_to_stack({"w": torch.zeros((2, 2, 1, 3))}, 4, 1)
    assert TP.stages_to_stack(TP.stack_to_stages(params, 3), 3)["w"].shape == (6, 3, 3)


@pytest.mark.parametrize("arch,S,v", [("biglstm", 2, 1), ("smollm_360m", 2, 2),
                                      ("smollm_360m", 4, 1)])
def test_stage_init_is_the_whole_inits_slice(arch, S, v):
    """A rank's init (``init_pipeline_stage``) is bit-equal to its slice of
    the whole init under the same seed: layers by ``stack_to_stages``, the
    embedding on the first stage and the head on the last (a tied embedding
    on both)."""
    from repro_torch.models.api import build_model
    from repro_torch.models.lstm import stack_layer_params

    cfg = t_get_config(arch).reduced()
    if arch != "biglstm":
        cfg = dataclasses.replace(cfg, n_layers=4, tie_embeddings=v > 1)
    api = build_model(cfg, device="cpu")
    full = api.init(3)
    key = "lstm" if arch == "biglstm" else "layers"
    stages = TP.stack_to_stages(stack_layer_params(full[key]) if key == "lstm"
                                else full[key], S, v)
    head = {"biglstm": ["head"]}.get(arch, ["final_norm", "embed" if v > 1 else "lm_head"])
    for s in range(S):
        got = api.init_pipeline_stage(3, S, v, s)
        want_keys = {key} | ({"embed"} if s == 0 else set()) | (set(head) if s == S - 1
                                                                 else set())
        assert set(got) == want_keys
        for k in want_keys - {key}:
            assert torch.equal(got[k], full[k])
        flat_got, flat_want = tree_leaves(got[key]), tree_leaves(stages)
        assert all(torch.equal(a, b[s]) for a, b in zip(flat_got, flat_want))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(api.pipeline_stage_params(full, S, v, s)), tree_leaves(got)))


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _toy_params():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((TOY_L, TOY_D, TOY_D), generator=g) * 0.1,
            "b": torch.randn((TOY_L, TOY_D), generator=g) * 0.1}


def _toy_data():
    g = torch.Generator().manual_seed(1)
    return torch.randn((TOY_B, TOY_D), generator=g), torch.randn((TOY_B, TOY_D), generator=g)


def _toy_stage_fn(sp, x):
    for w, b in zip(sp["w"], sp["b"]):
        x = torch.tanh(x @ w + b)
    return x


def _toy_loss_fn(lp, y_m, t_m):
    return ((y_m * lp["scale"] - t_m) ** 2).sum()


def _toy_reference(kind, K):
    """Loss and grads of the whole stack by single-process autograd."""
    params = {k: p.requires_grad_() for k, p in _toy_params().items()}
    scale = torch.tensor(1.3, requires_grad=True)
    x, tgt = _toy_data()
    x.requires_grad_()
    y = _toy_stage_fn(params, x)
    loss = sum(_toy_loss_fn({"scale": scale}, ym, tm)
               for ym, tm in zip(y.chunk(K), tgt.chunk(K)))
    gw, gb, gs, gx = torch.autograd.grad(loss, [params["w"], params["b"], scale, x])
    return loss.detach(), {"w": gw, "b": gb}, gs, gx


def _toy_rank(mesh):
    """Every toy-grid case on this rank: its loss, its stage's grads (as the
    whole stack's layer rows), dx or loss-param grads, its high-water mark."""
    S, s = mesh.shape["model"], mesh.model_index
    out = {}
    x, tgt = _toy_data()
    for kind, K in TOY_GRID:
        v = 2 if kind == "interleaved" else 1
        stages = TP.stack_to_stages(_toy_params(), S, v)
        mine = {k: a[s].clone() for k, a in stages.items()}
        res = TP.pipeline_value_and_grad(
            mesh, _toy_stage_fn, mine, x if s == 0 else x.to("meta"),
            loss_fn=_toy_loss_fn, loss_params={"scale": torch.tensor(1.3)},
            targets=tgt, n_micro=K, schedule=kind, virtual_stages=v)
        out[(kind, K)] = {"loss": res.loss, "rows": TP.stage_layers(TOY_L, S, v, s),
                          "grads": {k: g.reshape((-1,) + tuple(g.shape[2:]))
                                    for k, g in res.stage_grads.items()},
                          "lp": res.loss_param_grads, "dx": res.dx,
                          "high_water": res.high_water}
    return out


@pytest.fixture(scope="module")
def toy_ranks():
    return D.spawn_ranks(_toy_rank, 2, "cpu", stages=2, threads=1)


@pytest.mark.parametrize("kind,K", TOY_GRID)
def test_toy_grid_matches_autograd(toy_ranks, kind, K):
    loss, grads, gscale, gx = _toy_reference(kind, K)
    r0, r1 = (r[(kind, K)] for r in toy_ranks)
    for r in (r0, r1):
        assert abs(float(r["loss"] - loss)) <= TOY_TOL * abs(float(loss))
        for k, g in r["grads"].items():
            assert float((g - grads[k][r["rows"]]).abs().max()) <= TOY_TOL, (kind, K, k)
    assert r0["lp"] is None and r1["dx"] is None
    assert abs(float(r1["lp"]["scale"] - gscale)) <= TOY_TOL * abs(float(gscale))
    assert float((r0["dx"] - gx).abs().max()) <= TOY_TOL
    plan = TP.plan_scheduled_runtime(TP.make_schedule(kind, 2, K))
    assert (r0["high_water"], r1["high_water"]) == plan.stage_high_water
    if kind != "interleaved":
        assert r0["high_water"] == TP.pipeline_activation_residency(K, 2, kind)


# --- model level ---------------------------------------------------------------

MODEL_CASES = {
    # name: (arch, layers, tied, dp, stages, schedule, micro, v)
    "biglstm_pipe2": ("biglstm", 2, False, 1, 2, "1f1b", 2, 1),
    "decoder_dp2_pipe2_interleaved": ("smollm_360m", 4, True, 2, 2, "interleaved", 2, 2),
    "decoder_pipe4_gpipe": ("smollm_360m", 4, True, 1, 4, "gpipe", 4, 1),
}


def _model_cfg(name, pkg_get_config):
    arch, layers, tied = MODEL_CASES[name][:3]
    cfg = pkg_get_config(arch).reduced()
    return dataclasses.replace(cfg, n_layers=layers, tie_embeddings=tied)


def _batch(batch=8, seq=16):
    from repro_torch.data import make_lm_dataset
    b = next(make_lm_dataset(vocab=64, seq_len=seq).epoch(0, batch))
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _opt():
    from repro_torch import optim as TO
    return TO.adamw(TO.warmup_cosine(3e-3, 20, 1))


def _model_rank(mesh, name, np_params):
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import TrainState, make_train_step

    _, _, _, _, S, kind, K, v = MODEL_CASES[name]
    cfg = _model_cfg(name, t_get_config)
    api = build_model(cfg, device="cpu")
    plan = ParallelPlan(model_axis="model", mp_kind="pipeline", microbatches=K,
                        schedule=kind, virtual_stages=v)
    params = api.pipeline_stage_params(params_from_jax(np_params, cfg, "cpu"), S, v,
                                       mesh.model_index)
    opt = _opt()
    step = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0)
    state, metrics = step(TrainState(params, opt.init(params), 0), _batch())
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "high_water": metrics["store_high_water"], "params": state.params}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def model_step(request):
    """One pipelined step on the ranks, JAX's single-device step and the
    port's single-process step, all from JAX's init."""
    import jax
    import jax.numpy as jnp
    from repro import optim as JO
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.train import steps as JS
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainState, make_train_step

    name = request.param
    _, _, _, dp, S, kind, K, v = MODEL_CASES[name]
    jcfg, tcfg = _model_cfg(name, j_get_config), _model_cfg(name, t_get_config)
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    batch = _batch()
    jopt = JO.adamw(JO.warmup_cosine(3e-3, 20, 1))
    jstate, jm = jax.jit(JS.make_train_step(japi, jopt))(
        JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                      step=jnp.zeros((), jnp.int32)),
        {k: jnp.asarray(b.numpy().astype(np.int32)) for k, b in batch.items()})
    api = build_model(tcfg, device="cpu")
    full = params_from_jax(np_params, tcfg, "cpu")
    opt = _opt()
    state, m = make_train_step(api, opt, clip_norm=1.0)(
        TrainState(full, opt.init(full), 0), batch)
    ranks = D.spawn_ranks(_model_rank, dp * S, "cpu", args=(name, np_params), stages=S,
                          threads=1)
    jax_params = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu")
    return {"name": name, "api": api, "ranks": ranks, "S": S, "v": v, "kind": kind,
            "K": K, "single": (float(m["loss"]), float(m["grad_norm"]), state.params),
            "jax": (float(jm["loss"]), float(jm["grad_norm"]), jax_params)}


@pytest.mark.parametrize("against", ["single_process", "jax"])
def test_pipelined_train_step_matches(model_step, against):
    loss, gnorm, params = model_step["single" if against == "single_process" else "jax"]
    tol = STEP_TOL if against == "single_process" else JAX_STEP_TOL
    api, S, v = model_step["api"], model_step["S"], model_step["v"]
    for rank, r in enumerate(model_step["ranks"]):
        assert abs(r["loss"] - loss) <= tol["loss"] * abs(loss), (rank, r["loss"], loss)
        assert abs(r["grad_norm"] - gnorm) <= tol["grad_norm"] * abs(gnorm), \
            (rank, r["grad_norm"], gnorm)
        want = api.pipeline_stage_params(params, S, v, rank % S)
        assert sorted(want) == sorted(r["params"])
        err = max(float((a - b).abs().max()) for a, b in
                  zip(tree_leaves(r["params"]), tree_leaves(want)))
        assert err <= tol["params"], (rank, err)


def test_pipelined_store_high_water(model_step):
    """Each rank's store peak is its plan's, and stage 0's under 1f1b is
    ``pipeline_activation_residency`` = min(K, S)."""
    plan = TP.plan_scheduled_runtime(
        TP.make_schedule(model_step["kind"], model_step["S"], model_step["K"],
                         model_step["v"]))
    for rank, r in enumerate(model_step["ranks"]):
        assert r["high_water"] == plan.stage_high_water[rank % model_step["S"]]
    if model_step["kind"] == "1f1b":
        assert model_step["ranks"][0]["high_water"] == TP.pipeline_activation_residency(
            model_step["K"], model_step["S"], "1f1b")
