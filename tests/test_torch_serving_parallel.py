"""Sharded continuous serving in the port against the JAX package, on gloo
ranks on the CPU (each rank's flash launches take their plain versions):

- the continuous engine on ranks: the tensor-MP tick and chunk at (dp, mp)
  = (1, 2) and (2, 2), comm chunks 1 and 2, one KV head (the replicated-KV
  slice), a 3-token prefill chunk over 7-token prompts (padded chunks) and
  a window of 8; then the context-parallel chunk on a ring of 2, with and
  without the window.  Each run is held against JAX's single-device
  ``ContinuousEngine`` on the same requests and weights
  (``interop.params_from_jax``): tokens equal, logprobs within 2e-4 (JAX's
  own limit for its TP and CP engines, tests/test_serve_continuous.py:199,
  tests/test_context_parallel.py:402); every rank returns the same bits,
  also when it samples at a temperature;
- JAX's sharded-prefill pad guard at ``submit``;
- the windowed ring (window 8, ring of 2 and 4), ``ring_attention_stats``
  and ``gathered_attention`` against JAX's ``layers.attention(window=)``
  over the whole sequence and its ``jax.grad``, at
  tests/test_torch_context.py's limits;
- a window under a training ``ParallelCtx``: reduced Llama with a sliding
  window of 8 (B 2 x T 16) on a context ring of 2 and under tensor MP
  (gspmd; overlapped with 2 chunks), the loss and every gradient against
  JAX's ``loss_fn`` and ``jax.grad`` (loss 1e-5 relative, gradients 1e-4);
- the plain flash versions with ``q_start`` (rows that see no key among
  them) against JAX's ``attention(q_start=, window=)`` at 2e-5 (no ranks).

Config: reduced llama3_2_1b (2 layers, d_model 256, 4 query heads over 2 KV
heads, or 1), f32.  Three spawns, each with its own timeout.  JAX is
imported inside the tests only, so the spawned ranks do not load it.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.api import build_model
from repro_torch.models.transformer import ParallelCtx
from repro_torch.parallel import context as C
from repro_torch.parallel import dist as D
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.plan import ParallelPlan
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.tree import tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

LP_TOL = 2e-4
RING_TOL = {"loss": 1e-5, "grads": 1e-4}       # tests/test_torch_context.py's
FLASH_TOL = 2e-5
SLOTS, CAP, CHUNK, WINDOW = 8, 32, 3, 8
SPAWN_S = 120
# ten requests for eight slots (two wait for an eviction); prompts of 7
# tokens prefill in chunks of 3, 3 and 1, padded to the ring's grid
PROMPTS = [7, 5, 9, 7, 4, 12, 7, 3, 10, 6]
NEW = [5, 4, 6, 3, 5, 4, 6, 3, 4, 5]
B, T, HQ, HKV, HD = 2, 32, 4, 2, 8              # the ring's inputs
TRAIN_B, TRAIN_T = 2, 16                        # the windowed train forward's batch
TP_PLANS = [("gspmd", 1), ("overlapped", 2)]


def _requests():
    rng = np.random.default_rng(7)
    return [Request(rid=i, tokens=rng.integers(1, 500, n).tolist(), max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPTS, NEW))]


def _cfgs(n_kv_heads):
    from repro.configs import get_config as j_get_config

    return tuple(dataclasses.replace(g("llama3_2_1b").reduced(), n_kv_heads=n_kv_heads,
                                     dtype="float32")
                 for g in (j_get_config, t_get_config))


# the engine runs: (model, engine keywords, JAX reference; None: the ranks
# are held against each other only, as a temperature's draws are the port's)
RUNS_PAIR = [("kv2", {"model_axis": "model"}, "base"),
             ("kv2", {"model_axis": "model", "comm_chunks": 2}, "base"),
             ("kv1", {"model_axis": "model"}, "kv1"),
             ("kv2", {"model_axis": "model", "window": WINDOW}, "window"),
             ("kv2", {"context_axis": "model"}, "base"),
             ("kv2", {"context_axis": "model", "window": WINDOW}, "window"),
             ("kv2", {"model_axis": "model", "temperature": 0.8}, None)]
RUNS_GRID = [("kv2", {"model_axis": "model"}, "base"),
             ("kv2", {"model_axis": "model", "comm_chunks": 2}, "base"),
             ("kv2", {"context_axis": "model"}, "base"),
             ("kv2", {"model_axis": "model", "temperature": 0.8}, None)]


@pytest.fixture(scope="module")
def models():
    """JAX's single-device engine runs (the references) and the port's
    weights of the same models."""
    import jax

    from repro.models.api import build_model as j_build_model
    from repro.serve.continuous import ContinuousEngine as JEngine
    from repro.serve.continuous import Request as JRequest
    from repro_torch.interop import params_from_jax

    reqs = _requests()
    out = {"params": {}, "cfg": {}, "ref": {}}
    for name, nkv in (("kv2", 2), ("kv1", 1)):
        jcfg, tcfg = _cfgs(nkv)
        japi = j_build_model(jcfg, remat=False)
        jparams = japi.init(jax.random.PRNGKey(0))
        out["cfg"][name] = tcfg
        out["params"][name] = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
        for ref, window in (("base", None), ("window", WINDOW)) if name == "kv2" else \
                (("kv1", None),):
            eng = JEngine(japi, jparams, n_slots=SLOTS, capacity=CAP, prefill_chunk=CHUNK,
                          window=window)
            res = eng.run([JRequest(rid=r.rid, tokens=list(r.tokens),
                                    max_new_tokens=r.max_new_tokens) for r in reqs])
            out["ref"][ref] = [(list(r.tokens), np.asarray(r.logprobs, np.float64))
                               for r in res]
    return out


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, HQ, HD), (B, T, HKV, HD), (B, T, HKV, HD))]


def _ring_part(mesh, qkv):
    """This rank's rows through the windowed ring (causal, window 8): the
    loss sum(o^2) over the ranks and this rank's dq, dk, dv; the stats ring's
    (out, lse) and the gathered foil's output of the same rows."""
    j, m = mesh.ring("model")[:2]
    n = T // m
    q, k, v = (torch.from_numpy(x[:, j * n:(j + 1) * n]).requires_grad_() for x in qkv)
    o = C.ring_attention(q, k, v, mesh=mesh, causal=True, window=WINDOW, layer=0)
    local = (o.float() ** 2).sum()
    local.backward()
    loss = float(D.all_reduce(mesh, local.detach().reshape(1))[0])
    stats = C.ring_attention_stats(q.detach(), k.detach(), v.detach(), mesh=mesh,
                                   window=WINDOW, layer=1)
    gathered = C.gathered_attention(q.detach(), k.detach(), v.detach(), mesh=mesh,
                                    window=WINDOW)
    return {"loss": loss, "grads": (q.grad, k.grad, v.grad), "stats": stats,
            "gathered": gathered}


def _engine_runs(mesh, spec):
    """Each run of ``spec``: the engine on this rank over the requests, as
    (tokens, logprobs) per request."""
    out = []
    for name, kw, _ in spec["runs"]:
        cfg, params = spec["cfg"][name], spec["params"][name]
        eng = ContinuousEngine(build_model(cfg, device="cpu"), params, n_slots=SLOTS,
                               capacity=CAP, prefill_chunk=CHUNK, mesh=mesh,
                               batch_axes=("data",), **kw)
        out.append([(r.tokens, r.logprobs) for r in eng.run(spec["requests"])])
    return out


def _loss_grads(api, params, batch, pctx):
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss, _ = api.loss_fn(leaves, batch, pctx)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves))


def _window_train(mesh, train):
    """The windowed model's loss and gradients on this rank: on the context
    ring (this rank's T/2 columns; the loss and gradients summed over the
    ring), then under each tensor-MP plan (the gradients of its part)."""
    from repro_torch.train.steps import _make_pctx

    cfg, params, batch = train["cfg"], train["params"], train["batch"]
    api = build_model(cfg, device="cpu")
    j, m = mesh.ring("model")[:2]
    n = TRAIN_T // m
    cols = {k: v[:, j * n:(j + 1) * n] for k, v in batch.items()}
    loss, grads = _loss_grads(api, params, cols, ParallelCtx(mesh=mesh, context_axis="model"))
    out = {"cp": (float(D.all_reduce(mesh, loss.reshape(1), "model")[0]),
                  [D.all_reduce(mesh, g, "model") for g in grads])}
    for rt, chunks in TP_PLANS:
        plan = ParallelPlan(model_axis="model", comm_runtime=rt, comm_chunks=chunks)
        part = SH.shard_params(params, SH.ShardingRules(cfg, dict(mesh.shape), plan),
                               mesh.model_index)
        loss, grads = _loss_grads(api, part, batch, _make_pctx(mesh, plan))
        out[rt] = (float(loss), grads)
    return out


def _rank(mesh, spec):
    warnings.simplefilter("ignore")
    out = {"engine": _engine_runs(mesh, spec)}
    if spec.get("qkv") is not None:
        out["ring"] = _ring_part(mesh, spec["qkv"])
    if spec.get("train") is not None:
        out["train"] = _window_train(mesh, spec["train"])
    return out


def _spec(models, runs, qkv=None, train=None):
    names = {name for name, _, _ in runs}
    return {"runs": runs, "requests": _requests(), "qkv": qkv, "train": train,
            "cfg": {n: models["cfg"][n] for n in names},
            "params": {n: models["params"][n] for n in names}}


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's unsharded windowed attention over the whole sequence: the loss
    sum(o^2), its grads, the output and each row's lse."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import attention

    qkv = _qkv()

    def loss(q, k, v):
        return (attention(q, k, v, causal=True, window=WINDOW).astype(jnp.float32) ** 2).sum()

    args = [jnp.asarray(x) for x in qkv]
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*args)
    out = attention(*args, causal=True, window=WINDOW)
    q, k = qkv[0], np.repeat(qkv[1], HQ // HKV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(HD)
    pos = np.arange(T)
    keep = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - WINDOW)
    lse = np.asarray(jax.nn.logsumexp(jnp.where(keep, s, -jnp.inf), axis=-1))
    return qkv, float(val), [np.asarray(g) for g in grads], np.asarray(out), lse


def _check_engine(models, runs, ranks, mp):
    for i, (name, kw, ref) in enumerate(runs):
        first = ranks[0]["engine"][i]
        for r, rank in enumerate(ranks):        # every rank returns the same bits
            assert rank["engine"][i] == first, (kw, "rank", r)
        if ref is None:
            assert all(len(tok) == n for (tok, _), n in zip(first, NEW)), kw
            continue
        for (tok, lp), (w_tok, w_lp) in zip(first, models["ref"][ref]):
            assert tok == w_tok, (name, kw, mp, tok, w_tok)
            np.testing.assert_allclose(lp, w_lp, rtol=LP_TOL, atol=LP_TOL)


def _check_ring(jax_ring, ranks, m):
    qkv, want_loss, want_grads, want_out, want_lse = jax_ring
    rings = [r["ring"] for r in ranks]
    for r in rings:
        assert abs(r["loss"] - want_loss) <= RING_TOL["loss"] * abs(want_loss), m
    for i, want in enumerate(want_grads):
        got = torch.cat([r["grads"][i] for r in rings], dim=1).numpy()
        assert np.abs(got - want).max() < RING_TOL["grads"], (m, "qkv"[i])
    out = torch.cat([r["stats"][0] for r in rings], dim=1).numpy()
    lse = torch.cat([r["stats"][1] for r in rings], dim=2).numpy()
    gathered = torch.cat([r["gathered"] for r in rings], dim=1).numpy()
    assert np.abs(out - want_out).max() < RING_TOL["grads"], m
    assert np.abs(lse - want_lse).max() < RING_TOL["grads"], m
    assert np.abs(gathered - want_out).max() < RING_TOL["grads"], m


@pytest.fixture(scope="module")
def jax_window_train():
    """JAX's loss and gradients of reduced Llama with a sliding window of 8,
    and the port's weights and batch."""
    import jax

    from repro.models.api import build_model as j_build_model
    from repro_torch.interop import params_from_jax

    jcfg, tcfg = (dataclasses.replace(c, sliding_window=WINDOW) for c in _cfgs(2))
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, jcfg.vocab_size, (TRAIN_B, TRAIN_T), dtype=np.int32)
             for k in ("tokens", "labels")}
    loss, grads = jax.value_and_grad(lambda p: japi.loss_fn(p, batch)[0])(jparams)
    def to_t(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree), tcfg, "cpu")

    train = {"cfg": tcfg, "params": to_t(jparams),
             "batch": {k: torch.from_numpy(v).long() for k, v in batch.items()}}
    return train, float(loss), to_t(grads)


def _check_window_train(ranks, train, want_loss, want_grads):
    cfg = train["cfg"]
    for r, rank in enumerate(ranks):
        got = rank["train"]
        loss, grads = got["cp"]
        assert abs(loss - want_loss) <= RING_TOL["loss"] * abs(want_loss), ("cp", r)
        for g, w in zip(grads, tree_leaves(want_grads)):
            assert float((g - w).abs().max()) < RING_TOL["grads"], ("cp", r)
        for rt, chunks in TP_PLANS:
            plan = ParallelPlan(model_axis="model", comm_runtime=rt, comm_chunks=chunks)
            rules = SH.ShardingRules(cfg, {"data": 1, "model": 2}, plan)
            want = tree_leaves(SH.shard_params(want_grads, rules, r))
            loss, grads = got[rt]
            assert abs(loss - want_loss) <= RING_TOL["loss"] * abs(want_loss), (rt, r)
            for g, w in zip(grads, want):
                assert float((g - w).abs().max()) < RING_TOL["grads"], (rt, r)


def test_engine_and_ring_on_a_pair(models, jax_ring, jax_window_train):
    """(dp, mp) = (1, 2): the tensor-MP engine with comm chunks 1 and 2, one
    KV head and a window; the context-parallel chunk with and without it;
    the windowed ring, its stats form and the gathered foil at m 2; the
    windowed model's training loss and gradients on the ring and under
    tensor MP."""
    train, want_loss, want_grads = jax_window_train
    spec = _spec(models, RUNS_PAIR, jax_ring[0], train)
    ranks = D.spawn_ranks(_rank, 2, "cpu", args=(spec,), stages=2, timeout_s=SPAWN_S,
                          threads=1)
    _check_engine(models, RUNS_PAIR, ranks, 2)
    _check_ring(jax_ring, ranks, 2)
    _check_window_train(ranks, train, want_loss, want_grads)


def test_engine_on_two_data_groups(models):
    """(dp, mp) = (2, 2): each data group ticks and samples its own 4 slots,
    a chunk runs on the group that holds its slot, the tokens and logprobs
    are gathered over the data axis."""
    ranks = D.spawn_ranks(_rank, 4, "cpu", args=(_spec(models, RUNS_GRID),), stages=2,
                          timeout_s=SPAWN_S, threads=1)
    _check_engine(models, RUNS_GRID, ranks, 2)


def test_windowed_ring_of_four(jax_ring):
    """The windowed ring at m 4: a block two hops back is wholly left of the
    window and skipped, one hop back the window cuts it (rows that see none
    of its keys among them)."""
    ranks = D.spawn_ranks(_rank, 4, "cpu", args=({"runs": [], "qkv": jax_ring[0]},),
                          stages=4, timeout_s=SPAWN_S, threads=1)
    _check_ring(jax_ring, ranks, 4)


class _Pair:
    """What the engine reads of a mesh before any message: place 0 of a
    model axis of 2, one data group."""
    shape = {"data": 1, "model": 2}
    data_index = 0

    def size(self, axis):
        return self.shape[axis]

    def ring(self, axis):
        return 0, 2, 1, 1


def test_sharded_prefill_pad_guard():
    """JAX's guard: a sharded prefill pads a prompt's last chunk to the
    ring's grid, and the padded prompt must fit the slot."""
    cfg = dataclasses.replace(t_get_config("llama3_2_1b").reduced(), dtype="float32")
    api = build_model(cfg, device="cpu")
    eng = ContinuousEngine(api, api.init(0), n_slots=2, capacity=15, mesh=_Pair(),
                           model_axis="model", batch_axes=("data",))
    assert eng._prefill_grid == 2
    with pytest.raises(ValueError, match=r"request 3: prompt \(15\) \+ sharded-prefill pad "
                                         r"\(1, grid 2\) exceeds slot capacity 15"):
        eng.submit(Request(rid=3, tokens=list(range(15)), max_new_tokens=0))
    assert eng.submit(Request(rid=4, tokens=list(range(14)), max_new_tokens=1)) is None


# --- the plain flash versions with a query start (no ranks) -----------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 3), (False, 0)])
@pytest.mark.parametrize("q_start", [-3, 0, 4, 12, "rows"])
def test_plain_flash_with_q_start_matches_jax(causal, window, q_start):
    """``flash_attention_ref``, ``flash_attention_lse_plain`` and
    ``flash_attention_bwd_plain`` with a query start (a host int, or one a
    row) against JAX's ``attention(q_start=, window=)`` and its vjp: the
    rows that see a key within 2e-5; a row that sees none is 0 with lse
    -inf (JAX's dense softmax averages V there), and its output gradient is
    zeroed so that the two gradients compare."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import attention

    rng = np.random.default_rng(3)
    b, tq, tk, h, hkv, hd = 2, 6, 10, 4, 2, 8
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((b, tq, h, hd), (b, tk, hkv, hd), (b, tk, hkv, hd), (b, tq, h, hd)))
    starts = [-3, 7] if q_start == "rows" else [q_start] * b
    qs = torch.tensor(starts, dtype=torch.int32) if q_start == "rows" else q_start
    qpos = np.asarray(starts)[:, None] + np.arange(tq)[None]          # (B, Tq)
    kpos = np.arange(tk)
    keep = np.ones((b, tq, tk), bool)
    if causal:
        keep &= kpos[None, None] <= qpos[..., None]
    if window:
        keep &= kpos[None, None] > qpos[..., None] - window
    live = keep.any(-1)                                               # (B, Tq)
    do = do * live[..., None, None]
    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, window=window, q_start=qs)
    out = fa.flash_attention_ref(tq_, tk_, tv_, **kw).numpy()
    lse = fa.flash_attention_lse_plain(tq_, tk_, **kw).numpy()        # (B, H, Tq)
    grads = fa.flash_attention_bwd_plain(tq_, tk_, tv_, torch.from_numpy(out), tdo,
                                         torch.from_numpy(lse), causal=causal, window=window,
                                         q_start=starts[0]) if q_start != "rows" else None
    for row in range(b):
        args = [jnp.asarray(x[row:row + 1]) for x in (q, k, v)]
        fn = lambda q_, k_, v_: attention(q_, k_, v_, causal=causal,  # noqa: E731
                                          q_start=starts[row], window=window)
        want, vjp = jax.vjp(fn, *args)
        want = np.asarray(want)[0]
        got = out[row]
        assert np.abs(got[live[row]] - want[live[row]]).max(initial=0) < FLASH_TOL
        assert not got[~live[row]].any() and np.isfinite(got).all()
        kr = np.repeat(k[row], h // hkv, axis=1)
        s = np.einsum("qhd,khd->hqk", q[row], kr) / np.sqrt(hd)
        want_lse = np.asarray(jax.nn.logsumexp(jnp.where(keep[row][None], s, -jnp.inf), -1))
        assert np.array_equal(np.isneginf(lse[row]), np.isneginf(want_lse))
        fin = np.isfinite(want_lse)
        assert np.abs(lse[row][fin] - want_lse[fin]).max(initial=0) < FLASH_TOL
        if grads is not None:
            wg = vjp(jnp.asarray(do[row:row + 1]))
            for g, w in zip(grads, wg):
                assert np.abs(g[row].numpy() - np.asarray(w)[0]).max() < FLASH_TOL


def test_q_start_is_checked():
    q = torch.zeros(2, 3, 2, 8)
    with pytest.raises(ValueError, match=r"q_start must be a contiguous \(2,\) int32"):
        fa.flash_attention(q, q, q, q_start=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="q_start must be an int"):
        fa.flash_attention(q, q, q, q_start=1.5)
    with pytest.raises(ValueError, match="host-int q_start"):
        fa.flash_attention_bwd(q, q, q, q, q, torch.zeros(2, 2, 3),
                               q_start=torch.zeros(2, dtype=torch.int32))
    # with a query start, a row may see no key: kv_lens may be 0
    out = fa.flash_attention(q + 1, q, q, kv_lens=torch.tensor([0, 3], dtype=torch.int32),
                             q_start=torch.tensor([0, 0], dtype=torch.int32))
    assert not out[0].any()
