"""Tensor MP of the recurrent families in the port (``models.lstm``'s
``tp_lstm_layer`` and ``lstm_layer_overlapped``, ``models.rwkv``'s
``tp_time_mix`` / ``tp_channel_mix``, the gate-major cut of
``parallel.sharding``) against the JAX package, on gloo ranks on the CPU,
where the LSTM cell and the WKV recurrence take their kernels' plain
versions.  One spawn of 2 x 2 ranks runs every case:

- reduced BigLSTM at (dp, mp) of (1, 2) and (2, 2), under ``gspmd`` and
  ``overlapped`` with chunks 1 and 2; reduced GNMT at (1, 2) ``gspmd``;
  reduced RWKV6 at (1, 2) and (2, 2) ``gspmd``: the loss within 5e-5 and
  every gradient within 1e-3 (absolute) of JAX's single-device
  ``value_and_grad``, the limits of JAX's own
  ``test_overlapped_biglstm_matches_gspmd``, and each gradient also within
  1e-3 of its own largest magnitude (the LSTM gradients are ~1e-4 here);
- one AdamW step of each model against JAX's ``make_train_step`` at
  ``STEP_TOL``, and every leaf the rules replicate the same bits on both
  ranks of each model pair.

Without ranks: the gate-major ``shard_params`` / ``gather_params`` round
trip for every leaf of BigLSTM and GNMT, the gx entry's plain twin against
the plain cell with gx = x @ Wx, and the recurrences' message tags.  Through
the launcher: an ``mp=2`` BigLSTM checkpoint restores on one process and a
one-process checkpoint on ``mp=2``, each with the next loss of a straight
run.

JAX is imported inside the tests only.
"""
import dataclasses
import glob
import os
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import lstm_cell as TLC
from repro_torch.launch import train as TL
from repro_torch.parallel import dist as D
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# JAX's test_overlapped_biglstm_matches_gspmd: loss absolute, gradients max abs
GRID_TOL = {"loss": 5e-5, "grads": 1e-3}
# tests/test_torch_tensor_mp.py's STEP_TOL: loss absolute, parameters norm-relative
STEP_TOL = {"loss": 5e-5, "params": 5e-5}
# the LSTM models' gradients are ~1e-4 at these sizes, under JAX's absolute
# limit: each is also held to 1e-3 of its own largest magnitude (floored)
GRAD_REL_TOL, GRAD_FLOOR = 1e-3, 1e-6
GRIDS = {"biglstm": [(1, "gspmd", 1), (1, "overlapped", 1), (1, "overlapped", 2),
                     (2, "gspmd", 1), (2, "overlapped", 1), (2, "overlapped", 2)],
         "gnmt": [(1, "gspmd", 1)],
         "rwkv6_7b": [(1, "gspmd", 1), (2, "gspmd", 1)]}
CELLS = [(arch, *case) for arch, cases in GRIDS.items() for case in cases]
STEP_CASES = [("biglstm", 1, "gspmd", 1), ("biglstm", 2, "overlapped", 2),
              ("gnmt", 1, "gspmd", 1), ("rwkv6_7b", 2, "gspmd", 1)]
B, T = 8, 16


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


def _batch(arch):
    rng = np.random.default_rng(3)
    if arch == "gnmt":
        return {k: rng.integers(0, 1000, (B, T)) for k in ("src", "tgt", "labels")}
    return {"tokens": rng.integers(0, 1000, (B, T)), "labels": rng.integers(0, 1000, (B, T))}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _opt(module):
    return module.adamw(module.warmup_cosine(1e-3, 2, 10))


def _rules(cfg, mesh, plan):
    return SH.ShardingRules(cfg, dict(mesh.shape), plan)


def _plan(runtime, chunks):
    return ParallelPlan(model_axis="model", comm_runtime=runtime, comm_chunks=chunks)


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


def _rank(mesh, payload):
    """Every cell and step on one rank of a dp 2 x mp 2 run: errors against
    JAX, and the leaves the rules replicate after each step."""
    from repro_torch import optim as TO
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.train import TrainState, make_train_step

    warnings.simplefilter("ignore")
    out = {"grid": {}, "step": {}, "replicated": {}}
    for arch, dp, rt, chunks in CELLS:
        ref = payload[arch]
        cfg = t_get_config(arch).reduced()
        api = build_model(cfg, device="cpu")
        view = _view(mesh, dp)
        plan = _plan(rt, chunks)
        rules = _rules(cfg, view, plan)
        params = SH.shard_params(params_from_jax(ref["params"], cfg, "cpu"), rules,
                                 view.model_index)
        want = tree_leaves(SH.shard_params(params_from_jax(ref["grads"], cfg, "cpu"), rules,
                                           view.model_index))
        loss, grads = _rank_grads(api, params, ref["batch"], view, plan)
        errs = [float((g - w).abs().max()) for g, w in zip(grads, want)]
        out["grid"][(arch, dp, rt, chunks)] = (
            abs(loss - ref["loss"]), max(errs),
            max(e / max(float(w.abs().max()), GRAD_FLOOR) for e, w in zip(errs, want)))
    for arch, dp, rt, chunks in STEP_CASES:
        ref = payload[arch]
        cfg = t_get_config(arch).reduced()
        api = build_model(cfg, device="cpu")
        view = _view(mesh, dp)
        plan = _plan(rt, chunks)
        rules = _rules(cfg, view, plan)
        params = SH.shard_params(params_from_jax(ref["params"], cfg, "cpu"), rules,
                                 view.model_index)
        opt = _opt(TO)
        state, m = make_train_step(api, opt, mesh=view, plan=plan, clip_norm=1.0)(
            TrainState(params, opt.init(params), 0), _torch_batch(ref["batch"]))
        want = tree_leaves(SH.shard_params(params_from_jax(ref["after"], cfg, "cpu"), rules,
                                           view.model_index))
        flags = SH.replicated_leaves(state.params, SH.param_specs(cfg, rules), rules)
        case = (arch, dp, rt, chunks)
        out["step"][case] = (abs(float(m["loss"]) - ref["step_loss"]),
                             [(float(((a - b) ** 2).sum()), float((b ** 2).sum()), rep)
                              for a, b, rep in zip(tree_leaves(state.params), want, flags)])
        out["replicated"][case] = [t for t, rep in zip(tree_leaves(state.params), flags)
                                   if rep]
    return out


@pytest.fixture(scope="module")
def ranks():
    """JAX's references (each model's loss and gradients and one AdamW step)
    and one spawn of 2 x 2 ranks running every case against them."""
    import jax
    import jax.numpy as jnp
    from repro import optim as JO
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.train import steps as JS

    payload = {}
    for arch in GRIDS:
        batch = _batch(arch)
        jbatch = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
        japi = j_build_model(j_get_config(arch).reduced(), remat=False)
        jparams = japi.init(jax.random.PRNGKey(0))
        loss, grads = jax.value_and_grad(lambda p: japi.loss_fn(p, jbatch)[0])(jparams)
        jopt = _opt(JO)
        state, m = jax.jit(JS.make_train_step(japi, jopt))(
            JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                          step=jnp.zeros((), jnp.int32)), jbatch)
        payload[arch] = {"batch": batch, "params": jax.tree.map(np.asarray, jparams),
                         "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
                         "step_loss": float(m["loss"]),
                         "after": jax.tree.map(np.asarray, state.params)}
    return D.spawn_ranks(_rank, 4, "cpu", args=(payload,), stages=2, threads=1)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(map(str, c)))
def test_recurrent_loss_and_grads_match_jax(ranks, cell):
    """Every rank's loss (summed over its data shards) within 5e-5 of JAX's
    single-device loss, and each gradient of its part within 1e-3 of the
    matching slice of JAX's (the gate-major columns of wx and wh, wp's rows,
    the whole of every replicated leaf), and within 1e-3 of that slice's
    largest magnitude."""
    for r, res in enumerate(ranks):
        loss_err, grad_err, grad_rel = res["grid"][cell]
        assert loss_err < GRID_TOL["loss"], (cell, r, loss_err)
        assert grad_err < GRID_TOL["grads"], (cell, r, grad_err)
        assert grad_rel < GRAD_REL_TOL, (cell, r, grad_rel)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_recurrent_train_step_matches_jax(ranks, case):
    """One AdamW step on ranks: the loss and the updated parameters,
    gathered over each model pair, at JAX's single-device step's
    ``STEP_TOL``."""
    for pair in ((0, 1), (2, 3)):
        loss_err, leaves = ranks[pair[0]]["step"][case]
        assert loss_err < STEP_TOL["loss"], (case, loss_err)
        for i, (_, _, rep) in enumerate(leaves):
            parts = [ranks[r]["step"][case][1][i] for r in pair]
            err = parts[0][0] if rep else sum(p[0] for p in parts)
            ref = parts[0][1] if rep else sum(p[1] for p in parts)
            assert (err / max(ref, 1e-16)) ** 0.5 < STEP_TOL["params"], (case, i)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_recurrent_replicated_leaves_have_the_same_bits(ranks, case):
    """After a step every leaf the rules replicate over the model axis (an
    LSTM cell's bias, GNMT's attention query, RWKV's norms, mixes, decay
    LoRA and bonus) is the same bits on both ranks of each model pair."""
    for pair in ((0, 1), (2, 3)):
        a, b = (ranks[r]["replicated"][case] for r in pair)
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b)), case


# --- no ranks -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,m", [("biglstm", 2), ("biglstm", 4), ("gnmt", 2)])
def test_gate_major_cut_round_trips(arch, m):
    """``shard_params`` cuts each LSTM gate leaf gate-major (rank j holds
    columns [j H/m, (j + 1) H/m) of each of the four gates: JAX's (d, 4, H)
    view sharded on its last dim) and ``gather_params`` inverts it: every
    leaf of BigLSTM and GNMT comes back bit for bit."""
    from repro_torch.models.api import build_model

    cfg = t_get_config(arch).reduced()
    params = build_model(cfg, device="cpu").init(0)
    rules = SH.ShardingRules(cfg, {"data": 1, "model": m}, ParallelPlan())
    parts = [SH.shard_params(params, rules, j) for j in range(m)]
    back = SH.gather_params(parts, rules, SH.param_specs(cfg, rules))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))
    cells = params["lstm"] if arch == "biglstm" else params["enc"] + params["dec"]
    part_cells = [p["lstm"] if arch == "biglstm" else p["enc"] + p["dec"] for p in parts]
    for i, cell in enumerate(cells):
        hh = cell["b"].shape[0] // 4
        n = hh // m
        for name in ("wx", "wh"):
            w3 = cell[name].reshape(cell[name].shape[0], 4, hh)
            for j in range(m):
                got = part_cells[j][i][name]
                assert torch.equal(got, w3[:, :, j * n:(j + 1) * n].reshape(-1, 4 * n)), name
        for j in range(m):
            assert part_cells[j][i]["b"] is cell["b"]
            if "wp" in cell:
                assert torch.equal(part_cells[j][i]["wp"], cell["wp"][j * n:(j + 1) * n])


def test_gx_entry_plain_twin_is_the_plain_cell():
    """The gx entry's plain twin with gx = x @ Wx equals the plain cell (h',
    c' and the activated gates), f32 and bf16, and the wrapper on CPU
    tensors takes it."""
    rng = np.random.default_rng(4)
    bsz, d_in, d_h, hh = 5, 24, 16, 40
    for dt in (torch.float32, torch.bfloat16):
        x, h, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
                   for s in ((bsz, d_in), (bsz, d_h), (bsz, hh)))
        wx, wh = (torch.from_numpy((rng.standard_normal((d, 4, hh)) * d ** -0.5)
                                   .astype(np.float32)).to(dt) for d in (d_in, d_h))
        b = torch.from_numpy(rng.standard_normal((4, hh)).astype(np.float32) * 0.1)
        gx = (x.float() @ wx.reshape(d_in, 4 * hh).float()).view(bsz, 4, hh)
        want = TLC.lstm_cell_plain(x, h, c, wx, wh, b, with_gates=True)
        got = TLC.lstm_cell_gx_plain(gx, h, c, wh, b, with_gates=True)
        before = TLC.lstm_cell_fwd_gx.launches
        via = TLC.lstm_cell_fwd_gx(gx, h, c, wh, b, want_gates=True)
        assert TLC.lstm_cell_fwd_gx.launches == before
        tol = 1e-5 if dt == torch.float32 else 2e-2
        for g, v, w in zip(got, via, want):
            assert g.dtype == w.dtype and torch.equal(g, v)
            assert float((g.float() - w.float()).abs().max()) < tol


def test_recurrence_tags_are_distinct_from_the_rings():
    """Every (layer, step, kind) has its own tag, above every tensor-MP ring
    tag and below ``gather_tree``'s."""
    tags = {D.rnn_message_tag(layer, step, kind) for layer in range(4)
            for step in range(70) for kind in range(D.RNN_KINDS)}
    assert len(tags) == 4 * 70 * D.RNN_KINDS
    span = D.TP_OPS * D.TP_PHASES * D.MESSAGE_HOPS * D.TP_CHUNKS
    top_ring = D.tp_message_tag((D.RNN_TAG_BASE - D.TP_TAG_BASE) // span - 1, D.TP_OPS - 1,
                                D.TP_PHASES - 1, D.MESSAGE_HOPS - 1, D.TP_CHUNKS - 1)
    top = D.rnn_message_tag((D.GATHER_TAG_BASE - D.RNN_TAG_BASE)
                            // (D.RNN_KINDS * D.RNN_STEPS) - 1, D.RNN_STEPS - 1,
                            D.RNN_KINDS - 1)
    assert top_ring < D.RNN_TAG_BASE <= min(tags) and top < D.GATHER_TAG_BASE
    for bad in ((0, D.RNN_STEPS, 0), (0, 0, D.RNN_KINDS), (-1, 0, 0)):
        with pytest.raises(ValueError):
            D.rnn_message_tag(*bad)
    with pytest.raises(ValueError):
        D.tp_message_tag((D.RNN_TAG_BASE - D.TP_TAG_BASE) // span, 0, 0, 0, 0)


# --- checkpoints across the cut -------------------------------------------------------------

def _train(ckpt_dir, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TL.main(["--arch", "biglstm", "--reduced", "--device", "cpu", "--steps", "3",
                        "--batch", "4", "--seq", "16", "--ckpt-dir", str(ckpt_dir),
                        "--ckpt-every", "2", *args])


def _drop_last(ckpt_dir):
    """Remove the final (step 3) checkpoint, so a resume restores step 2."""
    files = sorted(glob.glob(os.path.join(str(ckpt_dir), "ckpt_*")))
    assert [os.path.basename(f).split(".")[0] for f in files] == ["ckpt_00000002",
                                                                    "ckpt_00000003"]
    os.remove(files[-1])


def test_mp2_checkpoint_restores_on_one_process_and_back(tmp_path):
    """A BigLSTM state saved by ``mp=2`` ranks (gathered to JAX's layout,
    the gate-major parts put back in place) restores on one process, and one
    process's state restores on ``mp=2`` (cut gate-major again): each
    resumed run's step-3 loss is the straight run's."""
    straight = _train(tmp_path / "one")
    ranks_run = _train(tmp_path / "mp", "--parallel", "mp=2")
    np.testing.assert_allclose(ranks_run["history"], straight["history"], rtol=1e-5)
    _drop_last(tmp_path / "mp")
    on_one = _train(tmp_path / "mp", "--resume")
    _drop_last(tmp_path / "one")
    on_mp = _train(tmp_path / "one", "--resume", "--parallel", "mp=2")
    for resumed in (on_one, on_mp):
        assert resumed["history"][-1] == pytest.approx(straight["history"][-1], rel=1e-5)
