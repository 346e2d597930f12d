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
