"""Tensor MP of the port (``parallel.collectives``' tensor-MP half, the
tensor branches of ``models.transformer``, ``models.inception``,
``models.api`` and ``train.steps``, and the launcher's ``mp=`` specs)
against the JAX package, on gloo ranks on the CPU, where attention takes
the flash kernels' plain versions.  Five rank spawns in all (the
launcher's three cases one each):

- the rings at m 2 and 4, chunks 1, 2 and 4, forward and backward, against
  the plain product and autograd within 1e-4 (JAX's
  ``test_collective_matmul_primitives_match_reference``, its shapes);
- reduced ``llama3_2_1b`` and ``stablelm_12b``, each also with one KV head
  (the replicated-KV slice) and Llama with tied embeddings, at (dp, mp) of
  (1, 2) and (2, 2), under ``gspmd`` and ``overlapped`` with chunks 1 and
  2: the loss within 5e-5 and every gradient within 5e-4 of JAX's
  single-device ``value_and_grad`` (JAX's limits, from
  ``test_overlapped_transformer_matches_gspmd_grid``); one AdamW step
  against JAX's ``make_train_step`` at ``STEP_TOL``; every leaf the rules
  replicate the same bits on every rank of the model group; reduced
  Inception-V3 at 75 px on the planner's 256-card tensor plan clamped to
  ``mp=2``: loss and gradients against JAX, and the step against the port's
  single step in f64;
- the launcher trains ``--parallel mp=2`` as one process trains (Llama and
  BigLSTM overlapped with 2 chunks, RWKV gspmd), and refuses a tensor plan
  whose model axis cannot split an MoE model's experts and ``--comm-chunks``
  without ``overlapped``.  The recurrent families' tensor MP against JAX is
  ``tests/test_torch_tensor_mp_recurrent.py``, the MoE decoder's
  ``tests/test_torch_moe_ep.py``.

JAX is imported inside the tests only.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import train as TL
from repro_torch.parallel import collectives as CL
from repro_torch.parallel import dist as D
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

RING_TOL = 1e-4
GRID_TOL = {"loss": 5e-5, "grads": 5e-4}
# tests/test_torch_context.py's STEP_TOL: loss absolute, parameters norm-relative
STEP_TOL = {"loss": 5e-5, "params": 5e-5}
# tests/test_torch_inception.py's limits: loss relative, gradients over max(1, |ref|)
INC_TOL = {"loss": 1e-5, "grads": 1e-4}
GRID = [(1, "gspmd", 1), (1, "overlapped", 1), (1, "overlapped", 2),
        (2, "gspmd", 1), (2, "overlapped", 1), (2, "overlapped", 2)]
CASES = {"llama": ("llama3_2_1b", {}), "llama kv1": ("llama3_2_1b", {"n_kv_heads": 1}),
         "llama tied": ("llama3_2_1b", {"tie_embeddings": True}),
         "stablelm": ("stablelm_12b", {}), "stablelm kv1": ("stablelm_12b", {"n_kv_heads": 1})}
STEP_CASES = [(1, "gspmd", 1), (2, "overlapped", 2)]
INC_PX, INC_B = 75, 4


@dataclasses.dataclass
class _PairMesh(D.RankMesh):
    """A rank of a dp x mp run seen as a run of one replica: its model group
    (the real process group) computes the whole batch on its own."""

    @property
    def data_index(self) -> int:
        return 0

    def members(self, axis):
        s = self.shape["model"]
        if axis == "model":
            return [self.rank // s * s + j for j in range(s)]
        if axis == "data":
            return [self.rank]
        return super().members(axis)


def _view(mesh, dp: int):
    """``mesh`` itself at its DP degree; at dp 1 each model pair of the run
    on its own (``_PairMesh``)."""
    if dp == mesh.shape["data"]:
        return mesh
    fields = {f.name: getattr(mesh, f.name) for f in dataclasses.fields(mesh)}
    return _PairMesh(**dict(fields, shape={"data": 1, "model": mesh.shape["model"]}))


# --- the rings ----------------------------------------------------------------------

RB, RT, RD, RF = 2, 16, 6, 12


def _ring_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((RB, RT, RD)).astype(np.float32),
            (rng.standard_normal((RD, RF)) * 0.3).astype(np.float32),
            (rng.standard_normal((RF, RD)) * 0.3).astype(np.float32))


def _ring_reference(arrays):
    x, w, w2 = (torch.from_numpy(a).requires_grad_() for a in arrays)
    loss = ((torch.tanh(x @ w) @ w2) ** 2).sum()
    return float(loss), torch.autograd.grad(loss, (x, w, w2))


def _ring_rank(mesh, arrays):
    """For m 4 (the whole run) and 2 (its pairs) and chunks 1, 2, 4: this
    rank's loss share and the largest error of its gradient slices."""
    want_loss, want = _ring_reference(arrays)
    out = {}
    for m in (4, 2):
        view = dataclasses.replace(mesh, shape={"data": 4 // m, "model": m})
        j = view.model_index
        n, f = RT // m, RF // m
        for chunks in (1, 2, 4):
            if n % chunks:
                continue
            x, w, w2 = (torch.from_numpy(a) for a in arrays)
            leaves = [x[:, j * n:(j + 1) * n].clone().requires_grad_(),
                      w[:, j * f:(j + 1) * f].clone().requires_grad_(),
                      w2[j * f:(j + 1) * f].clone().requires_grad_()]
            h = CL.all_gather_matmul(leaves[0], leaves[1], mesh=view, chunks=chunks,
                                     tag=(0, 0))
            y = CL.matmul_reduce_scatter(torch.tanh(h), leaves[2], mesh=view, chunks=chunks,
                                         tag=(0, 1))
            local = (y ** 2).sum()
            grads = torch.autograd.grad(local, leaves)
            slices = (want[0][:, j * n:(j + 1) * n], want[1][:, j * f:(j + 1) * f],
                      want[2][j * f:(j + 1) * f])
            out[(m, chunks)] = (float(local), max(float((g - s).abs().max())
                                                  for g, s in zip(grads, slices)))
    return want_loss, out


def test_collective_matmul_rings_match_the_plain_product():
    """``all_gather_matmul`` then ``matmul_reduce_scatter``, forward and
    backward on their own rings, equal the unsharded product and autograd
    within 1e-4 at m 2 and 4 and every chunk count that divides the rows."""
    ranks = D.spawn_ranks(_ring_rank, 4, "cpu", args=(_ring_inputs(),), stages=4, threads=1)
    want_loss = ranks[0][0]
    cases = ranks[0][1]
    assert set(cases) == {(4, 1), (4, 2), (4, 4), (2, 1), (2, 2), (2, 4)}
    for (m, chunks) in cases:
        groups = [range(4)] if m == 4 else [range(0, 2), range(2, 4)]
        for g in groups:
            loss = sum(ranks[r][1][(m, chunks)][0] for r in g)
            assert abs(loss - want_loss) < RING_TOL * max(1.0, abs(want_loss)), (m, chunks)
        assert max(r[1][(m, chunks)][1] for r in ranks) < RING_TOL, (m, chunks)


def test_ring_arguments_are_checked():
    class Mesh2:
        def size(self, axis):
            return 2

    x, w = torch.zeros((1, 3, 4)), torch.zeros((4, 2))
    with pytest.raises(ValueError, match="chunks=2 must divide"):
        CL.all_gather_matmul(x, w, mesh=Mesh2(), chunks=2)
    with pytest.raises(ValueError, match="not divisible by axis_size 2"):
        CL.matmul_reduce_scatter(torch.zeros((1, 3, 2)), torch.zeros((2, 4)), mesh=Mesh2())


def test_tensor_mp_tags_are_distinct_from_the_context_rings():
    """Every (layer, op, phase, hop, chunk) has its own tag, above every
    tag of the context ring."""
    tags = {D.tp_message_tag(layer, op, phase, hop, chunk)
            for layer in range(3) for op in range(D.TP_OPS) for phase in range(D.TP_PHASES)
            for hop in range(4) for chunk in range(D.TP_CHUNKS)}
    assert len(tags) == 3 * D.TP_OPS * D.TP_PHASES * 4 * D.TP_CHUNKS
    assert min(tags) >= D.TP_TAG_BASE > D.message_tag(8000, D.MESSAGE_HOPS - 1, True,
                                                      D.MESSAGE_PARTS - 1)
    with pytest.raises(ValueError):
        D.tp_message_tag(0, D.TP_OPS, 0, 0, 0)


# --- the models on ranks ----------------------------------------------------------------

def _decoder_cfg(get_config, name):
    arch, changes = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _lm_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 1000, (8, 32)), "labels": rng.integers(0, 1000, (8, 32))}


def _inc_batch():
    rng = np.random.default_rng(5)
    return {"images": rng.standard_normal((INC_B, INC_PX, INC_PX, 3)).astype(np.float32),
            "labels": rng.integers(0, 1000, INC_B)}


def _opt(module):
    return module.adamw(module.warmup_cosine(1e-3, 2, 10))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rules(cfg, mesh, plan):
    return SH.ShardingRules(cfg, dict(mesh.shape), plan)


def _rank_grads(api, params, batch, mesh, plan):
    """This rank's loss and gradients, each summed over its data shards (the
    global loss and the gradients of its part)."""
    from repro_torch.train.steps import _dp_shard, _make_pctx

    pctx = _make_pctx(mesh, plan)
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = api.loss_fn(leaves, _dp_shard(_torch_batch(batch), mesh), pctx)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    loss = D.all_reduce(mesh, loss.detach().reshape(1), "data")
    for g in grads:
        D.all_reduce(mesh, g, "data")
    return float(loss), grads


def _replicated(tree, cfg, mesh, plan):
    rules = _rules(cfg, mesh, plan)
    return [t for t, rep in zip(tree_leaves(tree),
                                SH.replicated_leaves(tree, SH.param_specs(cfg, rules), rules))
            if rep]


def _model_rank(mesh, payload):
    """Every case of the decoder grid, the steps and Inception on one rank
    of a dp 2 x mp 2 run; errors against the references, and the leaves the
    rules replicate (to compare bits across the model group)."""
    from repro_torch import optim as TO
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainState, make_train_step

    warnings.simplefilter("ignore")
    out = {"grid": {}, "step": {}, "replicated": {}}
    for name, (np_params, want_loss, np_grads) in payload["grid"].items():
        cfg = _decoder_cfg(t_get_config, name)
        api = build_model(cfg, device="cpu")
        for dp, rt, chunks in GRID:
            view = _view(mesh, dp)
            plan = ParallelPlan(model_axis="model", comm_runtime=rt, comm_chunks=chunks)
            rules = _rules(cfg, view, plan)
            params = SH.shard_params(params_from_jax(np_params, cfg, "cpu"), rules,
                                     view.model_index)
            want = tree_leaves(SH.shard_params(params_from_jax(np_grads, cfg, "cpu"), rules,
                                               view.model_index))
            loss, grads = _rank_grads(api, params, payload["batch"], view, plan)
            out["grid"][(name, dp, rt, chunks)] = (
                abs(loss - want_loss), max(float((g - w).abs().max())
                                           for g, w in zip(grads, want)))
    # one AdamW step of reduced Llama against JAX's
    np_params, want_loss, np_after = payload["step"]
    cfg = _decoder_cfg(t_get_config, "llama kv1")
    api = build_model(cfg, device="cpu")
    for dp, rt, chunks in STEP_CASES:
        view = _view(mesh, dp)
        plan = ParallelPlan(model_axis="model", comm_runtime=rt, comm_chunks=chunks)
        rules = _rules(cfg, view, plan)
        params = SH.shard_params(params_from_jax(np_params, cfg, "cpu"), rules,
                                 view.model_index)
        opt = _opt(TO)
        state, m = make_train_step(api, opt, mesh=view, plan=plan, clip_norm=1.0)(
            TrainState(params, opt.init(params), 0), _torch_batch(payload["batch"]))
        want = tree_leaves(SH.shard_params(params_from_jax(np_after, cfg, "cpu"), rules,
                                           view.model_index))
        flags = SH.replicated_leaves(state.params, SH.param_specs(cfg, rules), rules)
        out["step"][(dp, rt, chunks)] = (
            abs(float(m["loss"]) - want_loss),
            [(float(((a - b) ** 2).sum()), float((b ** 2).sum()), rep)
             for a, b, rep in zip(tree_leaves(state.params), want, flags)])
        out["replicated"][("llama kv1", dp, rt, chunks)] = _replicated(state.params, cfg,
                                                                        view, plan)
    # reduced Inception-V3: loss and gradients against JAX (f32), the step
    # against the port's single step (f64)
    inc = payload["inception"]
    view = _view(mesh, 1)
    plan = inc["plan"]
    cfg = t_get_config("inception_v3").reduced()
    api = build_model(cfg, device="cpu")
    rules = _rules(cfg, view, plan)
    params = SH.shard_params(params_from_jax(inc["np_params"], cfg, "cpu"), rules,
                             view.model_index)
    loss, grads = _rank_grads(api, params, inc["batch"], view, plan)
    want = tree_leaves(SH.shard_params(params_from_jax(inc["np_grads"], cfg, "cpu"), rules,
                                       view.model_index))
    out["inception"] = (abs(loss - inc["loss"]) / abs(inc["loss"]),
                        max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                            for g, w in zip(grads, want)))
    cfg64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    api64 = build_model(cfg64, device="cpu")
    params = SH.shard_params(tree_map(lambda t: t.double(), params_from_jax(
        inc["np_params"], cfg, "cpu")), rules, view.model_index)
    opt = _opt(TO)
    state, m = make_train_step(api64, opt, mesh=view, plan=plan, clip_norm=1.0)(
        TrainState(params, opt.init(params), 0), _torch_batch(inc["batch"]))
    want = tree_leaves(SH.shard_params(inc["single_after"], rules, view.model_index))
    out["inception_step"] = (abs(float(m["loss"]) - inc["single_loss"]),
                             max(float((a - b).abs().max())
                                 for a, b in zip(tree_leaves(state.params), want)))
    out["replicated"]["inception f64"] = _replicated(state.params, cfg, view, plan)
    return out


@pytest.fixture(scope="module")
def model_ranks():
    """JAX's references (each decoder's loss and gradients, one AdamW step,
    Inception's loss and gradients), the port's single f64 Inception step,
    and one spawn of 2 x 2 ranks running every case against them."""
    import jax
    import jax.numpy as jnp
    from repro import optim as JO
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.train import steps as JS
    from repro_torch import optim as TO
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainState, make_train_step

    batch = _lm_batch()
    jbatch = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    payload = {"batch": batch, "grid": {}}
    for name in CASES:
        japi = j_build_model(_decoder_cfg(j_get_config, name), remat=False)
        jparams = japi.init(jax.random.PRNGKey(0))
        loss, grads = jax.value_and_grad(lambda p: japi.loss_fn(p, jbatch)[0])(jparams)
        payload["grid"][name] = (jax.tree.map(np.asarray, jparams), float(loss),
                                 jax.tree.map(np.asarray, grads))
        if name == "llama kv1":
            jopt = _opt(JO)
            state, m = jax.jit(JS.make_train_step(japi, jopt))(
                JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                              step=jnp.zeros((), jnp.int32)), jbatch)
            payload["step"] = (jax.tree.map(np.asarray, jparams), float(m["loss"]),
                               jax.tree.map(np.asarray, state.params))
    # Inception
    jcfg, tcfg = j_get_config("inception_v3").reduced(), t_get_config("inception_v3").reduced()
    japi = j_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(1))
    ibatch = _inc_batch()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True))(
        jparams, {"images": jnp.asarray(ibatch["images"]),
                  "labels": jnp.asarray(ibatch["labels"].astype(np.int32))})
    np_params = jax.tree.map(np.asarray, jparams)
    cfg64 = dataclasses.replace(tcfg, dtype="float64", param_dtype="float64")
    params64 = tree_map(lambda t: t.double(), params_from_jax(np_params, tcfg, "cpu"))
    opt = _opt(TO)
    state, m = make_train_step(build_model(cfg64, device="cpu"), opt, clip_norm=1.0)(
        TrainState(params64, opt.init(params64), 0), _torch_batch(ibatch))
    # the planner's 256-card plan (tensor 1 x 8 x 32), DP narrowed to the data axis
    plan, mp, _ = TL.parse_parallel("auto", 256, t_get_config("inception_v3"))
    assert (plan.mp_kind, mp) == ("tensor", 32)
    payload["inception"] = {"plan": dataclasses.replace(plan, dp_axes=("data",)),
                            "np_params": np_params, "batch": ibatch, "loss": float(jloss),
                            "np_grads": jax.tree.map(np.asarray, jgrads),
                            "single_loss": float(m["loss"]), "single_after": state.params}
    ranks = D.spawn_ranks(_model_rank, 4, "cpu", args=(payload,), stages=2, threads=1)
    return payload, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_decoder_loss_and_grads_match_jax(model_ranks, name):
    """Every rank's loss (summed over the data shards) within 5e-5 of JAX's
    single-device loss and each gradient of its part within 5e-4 of the
    matching slice of JAX's, at (dp, mp) (1, 2) and (2, 2), both runtimes,
    chunks 1 and 2."""
    _, ranks = model_ranks
    for dp, rt, chunks in GRID:
        for r, res in enumerate(ranks):
            loss_err, grad_err = res["grid"][(name, dp, rt, chunks)]
            assert loss_err < GRID_TOL["loss"], (name, dp, rt, chunks, r, loss_err)
            assert grad_err < GRID_TOL["grads"], (name, dp, rt, chunks, r, grad_err)


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_jax(model_ranks, case):
    """One AdamW step on ranks (Llama with one KV head, so wk and wv are
    replicated): the loss and the updated parameters, gathered over the
    model group, at JAX's single-device step's ``STEP_TOL``."""
    _, ranks = model_ranks
    for pair in ((0, 1), (2, 3)):
        loss_err, leaves = ranks[pair[0]]["step"][case]
        assert loss_err < STEP_TOL["loss"], (case, loss_err)
        for i, (_, _, rep) in enumerate(leaves):
            parts = [ranks[r]["step"][case][1][i] for r in pair]
            err = parts[0][0] if rep else sum(p[0] for p in parts)
            ref = parts[0][1] if rep else sum(p[1] for p in parts)
            assert (err / max(ref, 1e-16)) ** 0.5 < STEP_TOL["params"], (case, i)


def test_replicated_leaves_have_the_same_bits_on_every_model_rank(model_ranks):
    """After a step, every leaf the rules replicate over the model axis
    (the norms; wk and wv with one KV head; Inception's folded batch norms)
    is the same bits on both ranks of each model pair."""
    _, ranks = model_ranks
    for key in ranks[0]["replicated"]:
        for pair in ((0, 1), (2, 3)):
            a, b = (ranks[r]["replicated"][key] for r in pair)
            assert len(a) == len(b) > 0
            assert all(torch.equal(x, y) for x, y in zip(a, b)), key


def test_inception_tensor_plan_matches_jax_and_the_single_step(model_ranks):
    """Reduced Inception-V3 at 75 px on the planner's 256-card tensor plan,
    clamped to a model pair: loss and gradients
    against JAX at tests/test_torch_inception.py's limits; one f64 step
    against the port's single-process step (phase 15 (d)'s parameter
    limit)."""
    _, ranks = model_ranks
    for res in ranks:
        loss_rel, grad_err = res["inception"]
        assert loss_rel < INC_TOL["loss"] and grad_err < INC_TOL["grads"], res["inception"]
        loss_err, param_err = res["inception_step"]
        assert loss_err < 1e-12 and param_err < STEP_TOL["params"], res["inception_step"]


# --- the launcher -----------------------------------------------------------------------

def _main(*args, arch="llama3_2_1b"):
    return TL.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "16", *args])


@pytest.mark.parametrize("arch,comm,plan_line", [
    ("llama3_2_1b", ("--comm-runtime", "overlapped", "--comm-chunks", "2"),
     "[overlapped comm c=2]"),
    ("biglstm", ("--comm-runtime", "overlapped", "--comm-chunks", "2"), "[overlapped comm c=2]"),
    ("rwkv6_7b", (), "")])
def test_launcher_trains_a_tensor_spec_on_ranks(capfd, arch, comm, plan_line):
    """``--parallel mp=2`` trains on 2 gloo ranks, each holding its part of
    the parameters, and its losses are those of one process: the dense
    decoder and BigLSTM (gate-major LSTM cells, x @ Wx on the gather ring)
    overlapped with 2 chunks, RWKV on the gspmd form."""
    single = _main(arch=arch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        summary = _main("--parallel", "mp=2", *comm, arch=arch)
    out = capfd.readouterr().out
    assert f"[plan] 1-way DP x 2-way tensor MP {plan_line}".rstrip() + " on cpu" in out
    assert "[dist] backend=gloo ranks=2 cards=0 (cpu)" in out
    assert "[ranks] r0 (data 0, model 0)" in out and "r1 (data 0, model 1)" in out
    assert "launches 0" in out
    assert summary["steps"] == 2 and np.isfinite(summary["history"]).all()
    np.testing.assert_allclose(summary["history"], single["history"], rtol=1e-5)


@pytest.mark.parametrize("arch,args,err,match", [
    ("granite_moe_1b_a400m", ("--parallel", "dp=2,mp=3"), ValueError,
     r"n_experts \(4\) does not divide over 3 ranks"),
    ("llama3_2_1b", ("--parallel", "mp=2", "--comm-chunks", "2"), SystemExit,
     "--comm-chunks only applies with --comm-runtime overlapped")])
def test_launcher_refuses_what_tensor_mp_does_not_run(arch, args, err, match):
    with pytest.raises(err, match=match):
        _main(*args, arch=arch)


def test_unported_tensor_mp_paths_name_their_items():
    """A caller's tensor ctx over an MoE model builds a step (expert
    parallelism, tests/test_torch_moe_ep.py); prefill and decoding under a
    tensor ctx name item 7b (the serving TP)."""
    from repro_torch import optim as TO
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.train import make_train_step

    api = build_model(t_get_config("granite_moe_1b_a400m").reduced(), device="cpu")
    pair = type("Pair", (), {"shape": {"data": 1, "model": 2}})()
    assert callable(make_train_step(api, TO.sgd(TO.constant_lr(0.1)),
                                    pctx=ParallelCtx(mesh=pair, model_axis="model")))
    api = build_model(t_get_config("llama3_2_1b").reduced(), device="cpu")
    pctx = ParallelCtx(mesh=None, model_axis="model", context_axis=None)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7b"):
        api.prefill(api.init(0), {"tokens": tokens}, pctx=pctx)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7b"):
        api.decode_fn(api.init(0), {"pos": 0}, {"tokens": tokens}, pctx=pctx)
    with pytest.raises(ValueError, match="tensor-MP ParallelCtx"):
        make_train_step(api, TO.sgd(TO.constant_lr(0.1)),
                        pctx=ParallelCtx(mesh=None, model_axis="model"))
