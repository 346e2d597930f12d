"""Data parallelism of the port (``repro_torch.parallel.collectives``,
``parallel.dist`` and the DP branches of ``train.steps``) and the launcher's
multi-rank runs, on gloo ranks on the CPU.

- the transport rule, and a rank that raises failing the whole run;
- ``grad_bucket_sizes`` packs as JAX's does;
- ``bucketed_grad_sync`` (and the per-leaf all-reduce) on 2 and 3 ranks
  (3 pads the buckets) equals the sum of the ranks' gradients;
- a dp = 2 train step of reduced BigLSTM and of a reduced dense decoder,
  under ``overlapped`` and ``gspmd``, equals the single-process step on the
  full batch and JAX's single-device step; with the plan's accumulation
  count 2 it runs each rank's shard as 2 micro-batches and equals the
  single-process accumulating step;
- a dp = 2 step of reduced GNMT and of reduced Inception-V3 (75 px), the
  bucketed sync splitting every batch key by rows, equals the
  single-process step on the full batch;
- ``launch.train.main`` runs ``pipe=2`` and the planner's 64-card BigLSTM
  plan on ranks, and still names ROADMAP items for what is not ported.

JAX is imported inside the tests only, as in test_torch_pipeline_runtime.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import train as TL
from repro_torch.parallel import collectives as TC
from repro_torch.parallel import dist as D
from repro_torch.tree import tree_leaves

# one train step: loss and grad norm relative; the updated parameters
# absolute, below one AdamW step at lr(0) = 1.5e-4 (the first step moves an
# element by lr * sign(g), except where |g| is near eps, where round-off in
# the gradient moves it by less)
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "params": 1e-4}
JAX_STEP_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "params": 1e-4}
SHAPES = {"a": (100,), "b": (10, 3), "c": (200,), "d": (5,), "e": (7, 11)}


def test_transport_rule():
    assert D.choose_transport("cpu", 4, 0) == D.Transport("gloo", 0, "cpu")
    shared = D.choose_transport("cuda", 2, 1)
    assert shared == D.Transport("gloo", 1, "shared")
    assert shared.describe(2) == "[dist] backend=gloo ranks=2 cards=1 (shared)"
    assert [shared.device(r).index for r in range(2)] == [0, 0]
    own = D.choose_transport("cuda", 4, 4)
    assert own == D.Transport("nccl", 4, "own")
    assert [own.device(r).index for r in range(4)] == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        D.choose_transport("cuda", 2, 0)


def _raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("boom on rank 1")
    D.all_reduce(mesh, torch.ones(1))     # rank 0 waits on the dead peer
    return mesh.rank


def test_a_failing_rank_fails_the_run():
    with pytest.raises(Exception, match="boom on rank 1"):
        D.spawn_ranks(_raise_on_rank_1, 2, "cpu", threads=1, timeout_s=60)


@pytest.mark.parametrize("bucket_bytes", [1, 480, 1000, 1e9])
def test_grad_bucket_sizes_match_jax(bucket_bytes):
    import jax.numpy as jnp
    from repro.parallel.collectives import grad_bucket_sizes as j_sizes

    jg = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    tg = {k: torch.zeros(s) for k, s in SHAPES.items()}
    assert TC.grad_bucket_sizes(tg, bucket_bytes) == j_sizes(jg, bucket_bytes)


def _rank_grads(rank):
    g = torch.Generator().manual_seed(100 + rank)
    return {k: torch.randn(s, generator=g) for k, s in SHAPES.items()}


def _sync_rank(mesh):
    out = {}
    for name, fn in (("overlapped", TC.bucketed_grad_sync), ("gspmd", TC.all_reduce_grads)):
        kw = {"bucket_bytes": 480} if name == "overlapped" else {}
        out[name] = fn(_rank_grads(mesh.rank), mesh, **kw)
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_grad_sync_equals_the_sum(world):
    got = D.spawn_ranks(_sync_rank, world, "cpu", threads=1)
    want = {k: sum(_rank_grads(r)[k] for r in range(world)) for k in SHAPES}
    for name in ("overlapped", "gspmd"):
        for r in got:
            for k in SHAPES:
                assert torch.allclose(r[name][k], want[k], rtol=0, atol=1e-5), (name, k)


# --- the DP train step ----------------------------------------------------------

ARCHS = {"biglstm": 2, "smollm_360m": 4}      # reduced, with this many layers
COMMS = ("overlapped", "gspmd")


def _cfg(arch, pkg_get_config):
    return dataclasses.replace(pkg_get_config(arch).reduced(), n_layers=ARCHS[arch])


def _batch(batch=8, seq=16):
    from repro_torch.data import make_lm_dataset
    b = next(make_lm_dataset(vocab=64, seq_len=seq).epoch(0, batch))
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _opt():
    from repro_torch import optim as TO
    return TO.adamw(TO.warmup_cosine(3e-3, 20, 1))


PAPER = ("gnmt", "inception_v3")    # reduced: 2 + 2 LSTM layers; blocks a, b, e


def _paper_batch(arch, batch=4):
    if arch == "gnmt":
        from repro_torch.data import SyntheticSeq2Seq
        b = next(SyntheticSeq2Seq(vocab=1024, seq_len=8).epoch(0, batch))
    else:
        rng = np.random.default_rng(0)
        b = {"images": rng.standard_normal((batch, 75, 75, 3)).astype(np.float32),
             "labels": rng.integers(0, 1000, batch)}
    return {k: torch.from_numpy(v if v.dtype == np.float32 else v.astype(np.int64))
            for k, v in b.items()}


def _paper_step(arch, mesh=None):
    """One AdamW step of a reduced paper model from the port's seeded init:
    on the ranks of ``mesh`` (pure DP, bucketed sync) or in one process."""
    from repro_torch.models.api import build_model
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import TrainState, make_train_step

    api = build_model(t_get_config(arch).reduced(), device="cpu")
    params = api.init(0)
    opt = _opt()
    plan = ParallelPlan(model_axis=None, comm_runtime="overlapped") if mesh else None
    step = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0, bucket_bytes=1 << 16)
    state, m = step(TrainState(params, opt.init(params), 0), _paper_batch(arch))
    return float(m["loss"]), float(m["grad_norm"]), state.params


def _dp_rank(mesh, np_params):
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import TrainState, make_train_step

    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch, t_get_config)
        api = build_model(cfg, device="cpu")
        for comm in COMMS:
            params = params_from_jax(np_params[arch], cfg, "cpu")
            opt = _opt()
            step = make_train_step(api, opt, mesh=mesh, clip_norm=1.0, bucket_bytes=4096,
                                   plan=ParallelPlan(model_axis=None, comm_runtime=comm))
            state, m = step(TrainState(params, opt.init(params), 0), _batch())
            out[(arch, comm)] = (float(m["loss"]), float(m["grad_norm"]), state.params)
    # dp = 2 with the plan's accumulation: each rank's 4 rows as 2 micro-batches
    cfg = _cfg("biglstm", t_get_config)
    api = build_model(cfg, device="cpu")
    rows = []

    def counted(params, batch, pctx=None):
        rows.append(next(iter(batch.values())).shape[0])
        return api.loss_fn(params, batch, pctx)

    params = params_from_jax(np_params["biglstm"], cfg, "cpu")
    opt = _opt()
    step = make_train_step(dataclasses.replace(api, loss_fn=counted), opt, mesh=mesh,
                           clip_norm=1.0, plan=ParallelPlan(model_axis=None, microbatches=2,
                                                            comm_runtime="overlapped"))
    state, m = step(TrainState(params, opt.init(params), 0), _batch())
    out["accum"] = (float(m["loss"]), float(m["grad_norm"]), state.params, rows)
    for arch in PAPER:
        out[arch] = _paper_step(arch, mesh)
    return out


@pytest.fixture(scope="module")
def dp_steps():
    """dp = 2 steps on the ranks, the port's single-process step and JAX's
    single-device step, all from JAX's init, on one batch."""
    import jax
    import jax.numpy as jnp
    from repro import optim as JO
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.train import steps as JS
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainState, make_train_step

    batch = _batch()
    np_params, single, ref = {}, {}, {}
    for arch in ARCHS:
        jcfg, tcfg = _cfg(arch, j_get_config), _cfg(arch, t_get_config)
        japi = j_build_model(jcfg, remat=False)
        jparams = japi.init(jax.random.PRNGKey(0))
        np_params[arch] = jax.tree.map(np.asarray, jparams)
        jopt = JO.adamw(JO.warmup_cosine(3e-3, 20, 1))
        jstate, jm = jax.jit(JS.make_train_step(japi, jopt))(
            JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                          step=jnp.zeros((), jnp.int32)),
            {k: jnp.asarray(b.numpy().astype(np.int32)) for k, b in batch.items()})
        ref[arch] = (float(jm["loss"]), float(jm["grad_norm"]),
                     params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu"))
        api = build_model(tcfg, device="cpu")
        full = params_from_jax(np_params[arch], tcfg, "cpu")
        opt = _opt()
        state, m = make_train_step(api, opt, clip_norm=1.0)(
            TrainState(full, opt.init(full), 0), batch)
        single[arch] = (float(m["loss"]), float(m["grad_norm"]), state.params)
    api = build_model(_cfg("biglstm", t_get_config), device="cpu")
    full = params_from_jax(np_params["biglstm"], api.cfg, "cpu")
    opt = _opt()
    state, m = make_train_step(api, opt, clip_norm=1.0, microbatches=2)(
        TrainState(full, opt.init(full), 0), batch)
    single["accum"] = (float(m["loss"]), float(m["grad_norm"]), state.params)
    # on one thread, as each rank runs: the clip's f32 sum of squares over a
    # leaf of millions takes another order on more threads (2e-5 relative on
    # reduced Inception's grad norm)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in PAPER:
            single[arch] = _paper_step(arch)
    finally:
        torch.set_num_threads(threads)
    ranks = D.spawn_ranks(_dp_rank, 2, "cpu", args=(np_params,), threads=1)
    return {"ranks": ranks, "single_process": single, "jax": ref}


@pytest.mark.parametrize("against", ["single_process", "jax"])
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dp_train_step_matches(dp_steps, arch, comm, against):
    loss, gnorm, params = dp_steps[against][arch]
    tol = STEP_TOL if against == "single_process" else JAX_STEP_TOL
    for r in dp_steps["ranks"]:
        rl, rn, rp = r[(arch, comm)]
        assert abs(rl - loss) <= tol["loss"] * abs(loss), (rl, loss)
        assert abs(rn - gnorm) <= tol["grad_norm"] * abs(gnorm), (rn, gnorm)
        err = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(rp), tree_leaves(params)))
        assert err <= tol["params"], err


def test_dp_train_step_accumulates_the_plans_micro_batches(dp_steps):
    """dp = 2 with the plan's accumulation count 2: each rank runs its 4 rows
    as two micro-batches of 2, and the step equals the single-process step
    that accumulates 2 micro-batches of the full batch."""
    loss, gnorm, params = dp_steps["single_process"]["accum"]
    for r in dp_steps["ranks"]:
        rl, rn, rp, rows = r["accum"]
        assert rows == [2, 2], rows
        assert abs(rl - loss) <= STEP_TOL["loss"] * abs(loss), (rl, loss)
        assert abs(rn - gnorm) <= STEP_TOL["grad_norm"] * abs(gnorm), (rn, gnorm)
        err = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(rp), tree_leaves(params)))
        assert err <= STEP_TOL["params"], err


@pytest.mark.parametrize("arch", PAPER)
def test_dp_train_step_of_the_paper_models_matches(dp_steps, arch):
    """GNMT's source, target and labels, and Inception's images and labels,
    each split by rows over the 2 ranks: the step equals the single-process
    step on the full batch."""
    loss, gnorm, params = dp_steps["single_process"][arch]
    for r in dp_steps["ranks"]:
        rl, rn, rp = r[arch]
        assert abs(rl - loss) <= STEP_TOL["loss"] * abs(loss), (rl, loss)
        assert abs(rn - gnorm) <= STEP_TOL["grad_norm"] * abs(gnorm), (rn, gnorm)
        err = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(rp), tree_leaves(params)))
        assert err <= STEP_TOL["params"], err


def test_train_step_refuses_a_count_that_disagrees_with_the_plan():
    from repro_torch.models.api import build_model
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import make_train_step

    api = build_model(_cfg("biglstm", t_get_config), device="cpu")
    with pytest.raises(ValueError, match="a plan carries its own count"):
        make_train_step(api, _opt(), microbatches=4,
                        plan=ParallelPlan(model_axis=None, microbatches=2))


# --- the launcher ----------------------------------------------------------------

def _main(*args):
    return TL.main(["--arch", "biglstm", "--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "16", *args])


def test_launcher_trains_a_pipeline_spec_on_ranks(capfd):
    summary = _main("--parallel", "pipe=2,micro=2,sched=1f1b")
    out = capfd.readouterr().out
    assert "[plan] 1-way DP x 2-way pipeline MP [1f1b, scheduled runtime] x2 micro on cpu" \
        in out
    assert "[dist] backend=gloo ranks=2 cards=0 (cpu)" in out
    assert "[done] steps=2" in out and "[ranks] r0 (data 0, stage 0)" in out
    assert summary["steps"] == 2 and np.isfinite(summary["history"]).all()
    assert [r["store_high_water"] for r in summary["ranks"]] == [2, 2]


def test_launcher_trains_the_64_card_biglstm_plan(capfd):
    """The planner's BigLSTM plan at 64 H100s (1f1b, 8 pods x 4 DP x 2
    stages, K 16) trains, its DP clamped to the local budget and K to the
    rows of a replica."""
    summary = _main("--parallel", "auto", "--devices", "64", "--max-local-devices", "2")
    out = capfd.readouterr().out
    assert "kind=pipeline sched=1f1b micro=16" in out
    assert "[plan] clamped DP 32 -> 1 (local budget 2, 2 stages)" in out
    assert "[plan] clamped micro-batches 16 -> 4" in out
    assert "[dist] backend=gloo ranks=2" in out
    assert summary["steps"] == 2 and np.isfinite(summary["history"]).all()


@pytest.mark.parametrize("arch,args,item", [
    ("biglstm", ("--parallel", "dp=1,mp=2"), "item 7b"),
    ("biglstm", ("--parallel", "pipe=2", "--pipe-runtime", "ad"), "item 6b")])
def test_launcher_names_what_is_not_ported(arch, args, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        TL.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
                 "--batch", "4", "--seq", "16", *args])
