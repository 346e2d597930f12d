"""The port's optimizers and LR schedules against the JAX package's.

Each optimizer takes one update (and a second, to exercise the state) on the
same params, grads and state, made with numpy; updates, new states, the
global-norm clip and ``apply_updates`` agree within 1e-6.  Each schedule
agrees within 1e-6 at steps across its phases.  Both sides compute in f32;
what differs is rounding order (torch's ``add_(alpha=)`` fuses a multiply).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.optim import optimizers as JOO
from repro_torch import optim as TO
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(6, 5), "b": f(5), "stack": f(2, 3, 4), "layers": [{"k": f(4, 3)},
                                                                     {"k": f(4, 3)}]}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port_tree, jax_tree, tol=TOL):
    got = tree_leaves(port_tree)
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        g = g.detach().double().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


SCHED = (lambda m: m.warmup_cosine(3e-3, 4, 20))


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {}),
                                     ("momentum_bf16", {}), ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.1}),
                                     ("adafactor", {})])
def test_optimizer_updates_match_jax(name, kw):
    params, g1, g2 = _tree(0), _tree(1), _tree(2)
    if name == "momentum_bf16":
        jopt = JOO.momentum_sgd(SCHED(JO), dtype=jnp.bfloat16)
        topt = TO.momentum_sgd(SCHED(TO), dtype=torch.bfloat16)
    else:
        jopt = JOO.OPTIMIZERS[name](SCHED(JO), **kw)
        topt = TO.OPTIMIZERS[name](SCHED(TO), **kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in ((0, g1), (5, g2)):
        ju, js = jopt.update(_to_jax(g), js, jp, jnp.asarray(step, jnp.int32))
        tu, ts = topt.update(_to_torch(g), ts, tp, step)
        _close(tu, ju)
        _close(ts, js, tol=1e-2 if name == "momentum_bf16" else TOL)
        jp = JO.apply_updates(jp, ju)
        tp = TO.apply_updates(tp, tu)
        _close(tp, jp)


def test_apply_updates_is_in_place_and_keeps_dtype():
    p = {"a": torch.ones(3), "h": torch.ones(2, dtype=torch.bfloat16)}
    a, h = p["a"], p["h"]
    out = TO.apply_updates(p, {"a": torch.full((3,), 0.5), "h": torch.full((2,), 0.5)})
    assert out["a"] is a and out["h"] is h and h.dtype == torch.bfloat16
    assert torch.equal(a, torch.full((3,), 1.5))
    jh = JO.apply_updates({"h": jnp.ones(2, jnp.bfloat16)}, {"h": jnp.full((2,), 0.5)})
    assert np.array_equal(np.asarray(jh["h"], np.float32), h.float().numpy())


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(3)
    jg, jn = JOO.clip_by_global_norm(_to_jax(g), max_norm)
    tg, tn = TO.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    _close(tg, jg)


@pytest.mark.parametrize("name,args", [
    ("constant_lr", (0.1,)),
    ("linear_scaled_lr", (0.1, 256, 1024, 50)),
    ("exp_warmup_step_decay", (1e-3, 200, 600, 100)),
    ("warmup_cosine", (3e-3, 20, 200)),
    ("cosine_decay", (3e-3, 100)),
])
def test_schedules_match_jax(name, args):
    js, ts = getattr(JO, name)(*args), getattr(TO, name)(*args)
    for step in (0, 1, 7, 19, 20, 21, 99, 150, 199, 200, 250, 650, 1000, 5000):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = ts(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=TOL, atol=1e-12)
        np.testing.assert_allclose(float(ts(torch.tensor(step))), want, rtol=TOL,
                                   atol=1e-12)


# --- Adafactor on ranks ----------------------------------------------------------

# one step in fp32 against JAX's single-device step: the loss absolute, each
# parameter and accumulator leaf norm-relative (tests/test_torch_context.py's
# STEP_TOL)
ADA_TOL = {"loss": 5e-5, "leaf": 5e-5}
ADA_LR = 1e-2


def _ada_cases():
    from repro_torch.parallel.plan import ParallelPlan

    pipe = ParallelPlan(model_axis="model", mp_kind="pipeline", microbatches=2)
    tensor = ParallelPlan(model_axis="model")
    return (("mp=2", "llama3_2_1b", 1, tensor), ("mp=2 lstm", "biglstm", 1, tensor),
            ("dp=2,pipe=2", "llama3_2_1b", 2, pipe), ("dp=2,pipe=2 lstm", "biglstm", 2, pipe),
            ("dp=2,mp=2 fsdp", "llama3_2_1b", 2,
             ParallelPlan(model_axis="model", fsdp_axes=("data",))))


def _ada_batch():
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, 1000, (8, 16)), "labels": rng.integers(0, 1000, (8, 16))}


def _adafactor_rank(mesh, params):
    """Every case's step on one rank of a 2 x 2 run (the dp 1 tensor cases
    on each model pair alone): the loss and, on its writing rank, the
    gathered global state."""
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainState, global_state, make_train_step, place_state
    from test_torch_tensor_mp import _view

    out = {}
    for name, arch, dp, plan in _ada_cases():
        cfg = get_config(arch).reduced()
        api = build_model(cfg, device="cpu")
        view = _view(mesh, dp)
        opt = TO.adafactor(TO.constant_lr(ADA_LR))
        whole = params_from_jax(params[arch], cfg, "cpu")
        state = place_state(TrainState(whole, opt.init(whole), 0), api, view, plan)
        state, m = make_train_step(api, opt, mesh=view, plan=plan, clip_norm=1.0)(
            state, {k: torch.from_numpy(v) for k, v in _ada_batch().items()})
        g = global_state(state, api, view, plan)
        out[name] = (float(m["loss"]), None if g is None else
                     [t.double().numpy() for t in tree_leaves((g.params, g.opt_state))])
    return out


@pytest.fixture(scope="module")
def adafactor_runs():
    """JAX's single-device Adafactor step of each arch, then one 2 x 2
    spawn with every case."""
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.train import steps as JS
    from repro_torch.parallel import dist as D

    ref, init = {}, {}
    for arch in ("llama3_2_1b", "biglstm"):
        japi = j_build_model(j_get_config(arch).reduced(), remat=False)
        jparams = japi.init(jax.random.PRNGKey(0))
        init[arch] = jax.tree.map(np.asarray, jparams)
        jopt = JO.adafactor(JO.constant_lr(ADA_LR))
        state = JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                              step=jnp.zeros((), jnp.int32))
        state, m = jax.jit(JS.make_train_step(japi, jopt, clip_norm=1.0))(
            state, {k: jnp.asarray(v.astype(np.int32)) for k, v in _ada_batch().items()})
        ref[arch] = (float(m["loss"]), [np.asarray(t, np.float64) for t in
                                        jax.tree.leaves((state.params, state.opt_state))])
    ranks = D.spawn_ranks(_adafactor_rank, 4, "cpu", args=(init,), stages=2, threads=1)
    return ref, ranks


@pytest.mark.parametrize("name", [c[0] for c in _ada_cases()])
def test_adafactor_on_ranks_matches_jax(adafactor_runs, name):
    """An Adafactor step on ranks whose leaves are cut (tensor MP with the
    LSTM gates' gate-major cut, a pipeline stage's part of the stacked layers
    and of BigLSTM's, tensor MP with fsdp) takes each statistic over the
    whole leaf: the gathered state equals JAX's single-device step."""
    ref, ranks = adafactor_runs
    arch = next(c[1] for c in _ada_cases() if c[0] == name)
    want_loss, want = ref[arch]
    got = [r[name][1] for r in ranks if r[name][1] is not None]
    assert got
    for r in ranks:
        assert abs(r[name][0] - want_loss) <= ADA_TOL["loss"], (r[name][0], want_loss)
    for leaves in got:
        assert len(leaves) == len(want)
        for g, w in zip(leaves, want):
            assert g.shape == w.shape
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= ADA_TOL["leaf"], (name, g.shape, err)
