"""Context parallelism of the port (``repro_torch.parallel.context``, the
context branch of ``train.steps`` and of ``launch.train``) against the JAX
package, on gloo ranks on the CPU, where each hop's flash forward and
backward take their plain versions.

- the merge rule: partial (out, lse) pairs over split key ranges, merged,
  equal full attention, and JAX's ``merge_softmax_stats`` of the same
  partials;
- the ring at m = 2 and 4 (JAX's grid of tests/test_context_parallel.py:
  B 2, T 32, Hq 4 over Hkv 2, causal and not) against JAX's unsharded
  ``layers.attention`` and ``jax.vjp``, at JAX's limits; a window raises,
  naming ROADMAP item 3;
- one AdamW step of reduced Llama at B 4 x T 64 at ``cp=2`` and
  ``dp=2,cp=2``, with and without labels at -1, against JAX's
  single-device ``make_train_step`` from the same weights, at JAX's limits;
- the launcher trains ``--parallel cp=2`` on 2 ranks as one process trains,
  and refuses a ``--seq`` the ring does not divide, ``--comm-runtime
  overlapped`` and an arch the ring cannot run.

JAX is imported inside the tests only, as in test_torch_dp.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as TL
from repro_torch.parallel import context as C
from repro_torch.parallel import dist as D
from repro_torch.tree import tree_leaves

# tests/test_context_parallel.py's limits: the ring's loss relative, its
# grads absolute; one train step's loss absolute, parameters norm-relative
RING_TOL = {"loss": 1e-5, "grads": 1e-4}
STEP_TOL = {"loss": 5e-5, "params": 5e-5}
B, T, HQ, HKV, HD = 2, 32, 4, 2, 8
CAUSAL = (True, False)


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, HQ, HD), (B, T, HKV, HD), (B, T, HKV, HD))]


# --- the merge rule ---------------------------------------------------------------

@pytest.mark.parametrize("cuts", [(16,), (5, 20)])
def test_merged_partials_equal_full_attention(cuts):
    """Non-causal partials over the key ranges split at ``cuts``, each from
    ``flash_attention_lse``, folded by ``merge_attention``: the output and
    lse of attention over all keys, and JAX's merge of the same partials as
    (m, l, acc) = (lse, 1, out) triples."""
    import jax.numpy as jnp
    from repro.models.layers import merge_softmax_stats

    q, k, v = (torch.from_numpy(x) for x in _qkv())
    bounds = list(zip((0, *cuts), (*cuts, T)))
    out = lse = None
    stats = None
    for lo, hi in bounds:
        o_s, lse_s = fa.flash_attention_lse(q, k[:, lo:hi], v[:, lo:hi], causal=False)
        assert o_s.dtype == q.dtype and lse_s.shape == (B, HQ, T)
        if out is None:
            out, lse = o_s.float(), lse_s
        else:
            out, lse = C.merge_attention(out, lse, o_s, lse_s)
        part = (jnp.asarray(lse_s.numpy()), jnp.ones((B, HQ, T)),
                jnp.asarray(o_s.numpy().transpose(0, 2, 1, 3)))
        stats = part if stats is None else merge_softmax_stats(stats, part)
    want = fa.flash_attention_ref(q, k, v, causal=False)
    assert float((out - want).abs().max()) < 1e-6
    assert float((lse - fa.flash_attention_lse_plain(q, k, causal=False)).abs().max()) < 1e-5
    m, l, acc = (np.asarray(x) for x in stats)
    jax_out = (acc / l[..., None]).transpose(0, 2, 1, 3)
    assert np.abs(out.numpy() - jax_out).max() < 1e-6


def test_flash_attention_lse_on_the_cpu_is_the_plain_pair():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1))
    for causal in CAUSAL:
        out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        assert torch.equal(out, fa.flash_attention_ref(q, k, v, causal=causal))
        assert torch.equal(lse, fa.flash_attention_lse_plain(q, k, causal=causal))


# --- the ring -----------------------------------------------------------------------

def _ring_rank(mesh, qkv):
    """Each causal case: this rank's rows through the ring; the loss (sum of
    out^2 over all ranks) and this rank's rows of dq, dk, dv."""
    j, m = mesh.ring("model")[:2]
    n = T // m
    out = {}
    for layer, causal in enumerate(CAUSAL):
        q, k, v = (torch.from_numpy(x[:, j * n:(j + 1) * n]).requires_grad_() for x in qkv)
        o = C.ring_attention(q, k, v, mesh=mesh, causal=causal, layer=layer)
        local = (o.float() ** 2).sum()
        local.backward()
        loss = D.all_reduce(mesh, local.detach().reshape(1))[0]
        out[causal] = (float(loss), q.grad, k.grad, v.grad)
    return out


@pytest.fixture(scope="module")
def jax_attention():
    """JAX's unsharded attention: loss sum(o^2) and its grads, per causal."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import attention

    qkv = _qkv()
    ref = {}
    for causal in CAUSAL:
        def loss(q, k, v, causal=causal):
            return (attention(q, k, v, causal=causal).astype(jnp.float32) ** 2).sum()
        val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
        ref[causal] = (float(val), [np.asarray(g) for g in grads])
    return qkv, ref


@pytest.mark.parametrize("m", [2, 4])
def test_ring_attention_matches_jax(jax_attention, m):
    """One spawn of m ranks runs both cases; the ranks' rows, put back in
    ring order, match JAX's loss and grads at JAX's limits."""
    qkv, ref = jax_attention
    ranks = D.spawn_ranks(_ring_rank, m, "cpu", args=(qkv,), stages=m, threads=1)
    for causal in CAUSAL:
        want_loss, want_grads = ref[causal]
        for r in ranks:
            assert abs(r[causal][0] - want_loss) <= RING_TOL["loss"] * abs(want_loss)
        for i, want in enumerate(want_grads):
            got = torch.cat([r[causal][1 + i] for r in ranks], dim=1).numpy()
            err = np.abs(got - want).max()
            assert err < RING_TOL["grads"], (m, causal, "qkv"[i], err)


def test_ring_attention_refuses_a_window():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 3"):
        C.ring_attention(q, k, v, mesh=None, causal=True, window=8)


def test_ring_tags_are_distinct():
    tags = {D.message_tag(layer, hop, bwd, part) for layer in range(16)
            for hop in range(8) for bwd in (False, True) for part in range(2)}
    assert len(tags) == 16 * 8 * 2 * 2
    with pytest.raises(ValueError):
        D.message_tag(0, D.MESSAGE_HOPS, False)


class _Ring:
    """What ``cp_supported`` and ``_cp_shard`` read of a mesh (JAX's
    ``mesh.shape`` too): place j on a ring of m on the ``model`` axis."""

    def __init__(self, m, j=0):
        self.m, self.j, self.shape = m, j, {"data": 1, "model": m}

    def size(self, axis):
        return self.m

    def ring(self, axis):
        return self.j, self.m, (self.j + 1) % self.m, (self.j - 1) % self.m


@pytest.mark.parametrize("arch", ["llama3_2_1b", "smollm_360m", "granite_moe_1b_a400m",
                                  "rwkv6_7b", "whisper_large_v3", "hymba_1_5b"])
@pytest.mark.parametrize("m,t", [(1, 64), (2, 64), (4, 64), (4, 30)])
def test_cp_supported_matches_jax(arch, m, t):
    """The port's ``cp_supported`` gives JAX's answer for each arch, ring
    size and sequence length; where it says no, the step's context shard
    raises instead of falling back (the port has no GSPMD)."""
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    from repro_torch.train import steps as TS

    want = JT.cp_supported(j_get_config(arch),
                           JT.ParallelCtx(mesh=_Ring(m), context_axis="model"), t)
    tcfg = t_get_config(arch)
    pctx = TT.ParallelCtx(mesh=_Ring(m))
    assert TT.cp_supported(tcfg, pctx, t) == want
    batch = {"tokens": torch.zeros((2, t), dtype=torch.long)}
    if want:
        assert TS._cp_shard(batch, pctx, tcfg)["tokens"].shape == (2, t // m)
    elif m > 1:
        with pytest.raises(ValueError, match="cp_supported"):
            TS._cp_shard(batch, pctx, tcfg)


# --- one train step of reduced Llama ------------------------------------------------

def _llama_cfg(get_config):
    return get_config("llama3_2_1b").reduced()


def _batches():
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 1024, (4, 64))
    labels = rng.integers(0, 1024, (4, 64))
    masked = labels.copy()
    masked[0, :40] = -1          # uneven over rows and over the ring's columns
    masked[3, 50:] = -1
    masked[1, 7] = -1
    return {"plain": {"tokens": tokens, "labels": labels},
            "masked": {"tokens": tokens, "labels": masked}}


def _opt(module):
    return module.adamw(module.warmup_cosine(1e-3, 2, 10))


def _cp_step_rank(mesh, np_params):
    from repro_torch import optim as TO
    from repro_torch.interop import params_from_jax
    from repro_torch.models.api import build_model
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.train import TrainState, make_train_step

    cfg = _llama_cfg(t_get_config)
    api = build_model(cfg, device="cpu")
    plan = ParallelPlan(dp_axes=("data",), model_axis="model", mp_kind="context")
    out = {}
    for name, batch in _batches().items():
        params = params_from_jax(np_params, cfg, "cpu")
        opt = _opt(TO)
        step = make_train_step(api, opt, mesh=mesh, plan=plan, clip_norm=1.0)
        state, m = step(TrainState(params, opt.init(params), 0),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
        out[name] = (float(m["loss"]), state.params)
    return out


@pytest.fixture(scope="module")
def jax_step():
    """JAX's single-device step from its init, on each batch."""
    import jax
    import jax.numpy as jnp
    from repro import optim as JO
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.train import steps as JS
    from repro_torch.interop import params_from_jax

    jcfg, tcfg = _llama_cfg(j_get_config), _llama_cfg(t_get_config)
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    jopt = _opt(JO)
    step = jax.jit(JS.make_train_step(japi, jopt))
    ref = {}
    for name, batch in _batches().items():
        state, m = step(JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                                      step=jnp.zeros((), jnp.int32)),
                        {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()})
        ref[name] = (float(m["loss"]),
                     params_from_jax(jax.tree.map(np.asarray, state.params), tcfg, "cpu"))
    return np_params, ref


@pytest.mark.parametrize("dp", [1, 2])
def test_cp_train_step_matches_jax(jax_step, dp):
    """``cp=2`` (2 ranks) and ``dp=2,cp=2`` (4 ranks), with and without
    labels at -1: every rank's loss and updated parameters match JAX's
    single-device step (the global masked mean) at JAX's limits."""
    np_params, ref = jax_step
    ranks = D.spawn_ranks(_cp_step_rank, 2 * dp, "cpu", args=(np_params,), stages=2,
                          threads=1)
    for name, (want_loss, want_params) in ref.items():
        for r in ranks:
            loss, params = r[name]
            assert abs(loss - want_loss) < STEP_TOL["loss"], (dp, name, loss, want_loss)
            err = max(float((a - b).norm() / b.norm().clamp(min=1e-8))
                      for a, b in zip(tree_leaves(params), tree_leaves(want_params)))
            assert err < STEP_TOL["params"], (dp, name, err)


# --- the launcher ---------------------------------------------------------------------

def _main(*args, arch="llama3_2_1b"):
    return TL.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "16", *args])


def test_launcher_trains_a_context_spec_on_ranks(capfd):
    """``--parallel cp=2`` trains on 2 gloo ranks, each holding 8 of the 16
    columns, and its losses are those of one process on the whole batch."""
    single = _main()
    summary = _main("--parallel", "cp=2")
    out = capfd.readouterr().out
    assert "[plan] 1-way DP x 2-way context MP [kv ring] on cpu" in out
    assert "[dist] backend=gloo ranks=2 cards=0 (cpu)" in out
    assert "[ranks] r0 (data 0, ring 0)" in out and "r1 (data 0, ring 1)" in out
    assert summary["steps"] == 2 and np.isfinite(summary["history"]).all()
    np.testing.assert_allclose(summary["history"], single["history"], rtol=1e-5)


@pytest.mark.parametrize("args,arch,match", [
    (("--parallel", "cp=2", "--seq", "15"), "llama3_2_1b", "must divide by the 2-way ring"),
    (("--parallel", "cp=2", "--comm-runtime", "overlapped"), "llama3_2_1b",
     "the KV ring IS the comm schedule"),
    (("--parallel", "cp=2"), "biglstm", "homogeneous dense decoder")])
def test_launcher_refuses_what_a_ring_cannot_run(args, arch, match):
    with pytest.raises(SystemExit, match=match):
        _main(*args, arch=arch)
