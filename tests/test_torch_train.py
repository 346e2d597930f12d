"""The training slice as a whole: the port against the JAX package from the
same init, carried across with ``repro_torch.interop.params_from_jax``.

Reduced BigLSTM (2 layers, d_model 256, hidden 512 with a 256 projection,
vocab 1024, fp32): logits, loss and every gradient against JAX
``value_and_grad`` of ``build_model(...).loss_fn`` within 1e-4; five
launcher-equivalent train steps (B 4, T 16, ``adamw(warmup_cosine)``, clip
1.0, the launcher's Markov-LM batches) with per-step losses within 1e-4
relative, with and without the §4.2 accumulation; three steps of reduced
llama3_2_1b the same way.  Losses, not parameters, are held after several
steps: Adam turns a tiny gradient difference near 0 into a full-size update
of the other sign.  Also the data pipeline's batches and resume arithmetic,
the loop, and the launcher on the CPU.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_config as j_get_config
from repro.data import DataPipeline as JDataPipeline
from repro.data import make_lm_dataset as j_make_lm_dataset
from repro.models.api import build_model as j_build_model
from repro.parallel.plan import ParallelPlan
from repro.train import steps as JS
from repro_torch import optim as TO
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import DataPipeline, make_lm_dataset
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import train as TL
from repro_torch.models.api import build_model as t_build_model
from repro_torch.train import LoopConfig, TrainState, make_train_step, train_loop
from repro_torch.tree import tree_leaves

TOL = 1e-4
B, T = 4, 16


def _batches(n, seq=T, batch=B):
    data = j_make_lm_dataset(vocab=64, seq_len=seq)
    out = []
    for b in data.epoch(0, batch):
        out.append({"tokens": b["tokens"].astype(np.int32),
                    "labels": b["labels"].astype(np.int32)})
        if len(out) == n:
            return out


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _setup(arch):
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tapi = t_build_model(tcfg, device="cpu")
    return jcfg, tcfg, japi, jparams, np_params, tapi


@pytest.fixture(scope="module")
def biglstm():
    return _setup("biglstm")


def _err(a, b):
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b, np.float64)).max())


def test_biglstm_params_round_trip(biglstm):
    _, tcfg, _, _, np_params, _ = biglstm
    tparams = params_from_jax(np_params, tcfg, "cpu")
    assert isinstance(tparams["lstm"], list) and len(tparams["lstm"]) == 2
    back = params_to_numpy(tparams, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t) == 10
    for path, leaf in flat_j:
        assert np.array_equal(leaf, flat_t[path])
    with pytest.raises(ValueError, match="lstm"):
        params_from_jax({**np_params, "lstm": np_params["lstm"][:1]}, tcfg, "cpu")


def test_port_init_matches_jax_shapes(biglstm):
    _, tcfg, _, _, np_params, tapi = biglstm
    ours = tapi.init(0)
    assert [tuple(t.shape) for t in tree_leaves(ours)] == \
        [a.shape for a in jax.tree.leaves(np_params)]
    assert ours["lstm"][0]["b"].dtype == torch.float32


def test_biglstm_logits_loss_grads_match_jax(biglstm):
    from repro.models import lstm as JM
    from repro_torch.models import lstm as TM

    jcfg, tcfg, japi, jparams, np_params, tapi = biglstm
    batch = _batches(1)[0]
    jlogits = JM.biglstm_forward(jcfg, jparams, {"tokens": jnp.asarray(batch["tokens"])})
    tparams = params_from_jax(np_params, tcfg, "cpu")
    with torch.no_grad():
        tlogits = TM.biglstm_forward(tcfg, tparams, _tb(batch))
    assert tlogits.shape == (B, T, tcfg.vocab_padded)
    assert _err(tlogits, jlogits) < TOL

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    leaves = [t.requires_grad_() for t in tree_leaves(tparams)]
    tloss, metrics = tapi.loss_fn(tparams, _tb(batch))
    tgrads = torch.autograd.grad(tloss, leaves)
    tloss = tloss.detach()
    assert abs(float(tloss) - float(jloss)) < TOL * abs(float(jloss))
    assert float(metrics["loss"]) == float(tloss)
    for g, w in zip(tgrads, jax.tree.leaves(jgrads)):
        assert g.shape == w.shape
        assert _err(g, w) < TOL


def _jax_losses(japi, jparams, batches, plan=ParallelPlan()):
    opt = JO.adamw(JO.warmup_cosine(3e-3, 20, len(batches)))
    step = jax.jit(JS.make_train_step(japi, opt, plan=plan))
    state = JS.TrainState(params=jparams, opt_state=opt.init(jparams),
                          step=jnp.zeros((), jnp.int32))
    out = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _port_losses(tapi, tparams, batches, microbatches=1):
    opt = TO.adamw(TO.warmup_cosine(3e-3, 20, len(batches)))
    step = make_train_step(tapi, opt, microbatches=microbatches)
    state = TrainState(params=tparams, opt_state=opt.init(tparams), step=0)
    out = []
    for b in batches:
        state, m = step(state, _tb(b))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    assert state.step == len(batches) and not state.in_update
    return out


def _assert_steps_close(got, want):
    for (tl, tn), (jl, jn) in zip(got, want):
        assert abs(tl - jl) <= TOL * abs(jl), (got, want)
        assert abs(tn - jn) <= TOL * abs(jn), (got, want)


@pytest.mark.parametrize("accum", [1, 2])
def test_biglstm_train_steps_match_jax(biglstm, accum):
    _, tcfg, japi, jparams, np_params, tapi = biglstm
    batches = _batches(5)
    want = _jax_losses(japi, jparams, batches, ParallelPlan(microbatches=accum))
    got = _port_losses(tapi, params_from_jax(np_params, tcfg, "cpu"), batches, accum)
    _assert_steps_close(got, want)
    assert got[-1][0] < got[0][0]


def test_llama_train_steps_match_jax():
    """The model-independent train step on the dense decoder (attention
    through the flash wrapper's plain twin on the CPU)."""
    jcfg, tcfg, japi, jparams, np_params, tapi = _setup("llama3_2_1b")
    batches = _batches(3)
    want = _jax_losses(japi, jparams, batches)
    got = _port_losses(tapi, params_from_jax(np_params, tcfg, "cpu"), batches)
    _assert_steps_close(got, want)


def test_data_pipeline_matches_jax():
    jdata, tdata = j_make_lm_dataset(vocab=64, seq_len=8), make_lm_dataset(vocab=64,
                                                                           seq_len=8)
    assert jdata.entropy == tdata.entropy

    def fn(data):
        return lambda e: data.epoch(e, 16)

    jp = JDataPipeline(fn(jdata), steps_per_epoch=jdata.steps_per_epoch(16))
    tp = DataPipeline(fn(tdata), steps_per_epoch=tdata.steps_per_epoch(16))
    walk_j = JDataPipeline(fn(jdata), prefetch=0)
    walk_t = DataPipeline(fn(tdata), prefetch=0)
    for step in (0, 5, 256, 300):
        assert tp.locate(step) == jp.locate(step) == walk_t.locate(step) \
            == walk_j.locate(step)
    for e, skip in ((0, 0), (0, 250), (1, 3)):
        got = list(tp.epoch(e, skip=skip))
        want = list(jp.epoch(e, skip=skip))
        assert len(got) == len(want) > 0
        for g, w in zip(got[:4] + got[-2:], want[:4] + want[-2:]):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == torch.int64
                assert np.array_equal(g[k].numpy(), np.asarray(w[k]))


def test_data_pipeline_raises_dataset_errors_and_stops_its_producer():
    def broken(e):
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise KeyError("dataset broke")

    with pytest.raises(KeyError, match="dataset broke"):
        list(DataPipeline(broken).epoch(0))
    calls = []

    def endless(e):
        while True:
            calls.append(1)
            yield {"tokens": np.zeros((1, 2), np.int32)}

    it = DataPipeline(endless).epoch(0)
    next(it)
    it.close()                       # the consumer stops early
    import time
    time.sleep(0.05)
    n = len(calls)
    time.sleep(0.05)
    assert len(calls) == n <= 4      # the producer stopped with it


def _toy_step(losses, fail_at=(), in_update_fail=False):
    calls = []

    def step(state, batch):
        calls.append(state.step)
        if state.step in fail_at and calls.count(state.step) == 1:
            if in_update_fail:
                state.in_update = True
            raise RuntimeError("injected")
        return (TrainState(state.params, state.opt_state, state.step + 1),
                {"loss": torch.tensor(losses[state.step])})

    return step, calls


def _toy_pipeline():
    return DataPipeline(lambda e: iter([{"tokens": np.zeros((1, 2))}] * 4),
                        steps_per_epoch=4)


def test_loop_retries_target_loss_and_logging():
    step, calls = _toy_step([5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.1], fail_at=(2,))
    logs = []
    out = train_loop(step, TrainState({}, (), 0), _toy_pipeline(),
                     LoopConfig(total_steps=7, log_every=3, max_retries=1,
                                retry_backoff_s=0.0, target_loss=1.0),
                     log_fn=logs.append)
    assert out["steps"] == 5 and out["converged"] and out["retries"] == 1
    assert out["history"] == [5.0, 4.0, 3.0, 2.0, 1.0] and out["epochs"] == 1
    assert calls == [0, 1, 2, 2, 3, 4]
    assert any("retry 1/1" in m for m in logs) and any(m.startswith("step      3")
                                                       for m in logs)


def test_loop_does_not_retry_a_step_that_failed_in_the_update():
    step, _ = _toy_step([1.0] * 4, fail_at=(1,), in_update_fail=True)
    with pytest.raises(RuntimeError, match="injected"):
        train_loop(step, TrainState({}, (), 0), _toy_pipeline(),
                   LoopConfig(total_steps=3, max_retries=3, retry_backoff_s=0.0))


@pytest.mark.parametrize("kw", [{"ckpt_dir": "ck"}, {"watchdog_timeout_s": 1.0}])
def test_loop_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 9"):
        train_loop(None, TrainState({}, (), 0), _toy_pipeline(),
                   LoopConfig(total_steps=1, **kw))


def test_train_step_refuses_multi_device_arguments(biglstm):
    """What of a multi-device step is not ported raises naming its ROADMAP
    item: a caller's ParallelCtx and a tensor-MP plan over BigLSTM (item 7b:
    the dense decoder's and the CNN's run, tests/test_torch_tensor_mp.py),
    parameters sharded over DP (item 5's remainder) and the ad pipeline
    runtime (item 6b).  DP, the scheduled pipeline and context parallelism
    run on ranks (tests/test_torch_dp.py, tests/test_torch_pipeline_runtime.py,
    tests/test_torch_context.py); a context plan over an arch the ring
    cannot run (BigLSTM) raises ValueError."""
    from repro_torch.parallel.plan import ParallelPlan as TPlan

    tapi = biglstm[5]
    mesh = TM_Mesh({"data": 1, "model": 2})
    for kw, item in (({"pctx": object()}, "item 7b"),
                     ({"mesh": mesh, "plan": TPlan()}, "item 7b"),
                     ({"plan": TPlan(model_axis=None, fsdp_axes=("data",))}, "item 5"),
                     ({"mesh": mesh, "plan": TPlan(mp_kind="pipeline", runtime="ad")},
                      "item 6b")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
            make_train_step(tapi, TO.sgd(TO.constant_lr(0.1)), **kw)
    with pytest.raises(ValueError, match="homogeneous dense decoder"):
        make_train_step(tapi, TO.sgd(TO.constant_lr(0.1)), mesh=mesh,
                        plan=TPlan(mp_kind="context"))


class TM_Mesh:
    """The axis sizes of a rank mesh, all make_train_step reads before a step."""

    def __init__(self, shape):
        self.shape = shape


def _resolve(spec, devices=1, arch="biglstm", runtime=None):
    """The plan of ``spec``, checked as the launcher checks it."""
    plan, mp, dp = TL.parse_parallel(spec, devices, t_get_config(arch))
    if runtime:
        plan = dataclasses.replace(plan, runtime=runtime)
    if spec == "dp=2,mp=1":
        plan = dataclasses.replace(plan, fsdp_axes=("data",))
    TL.check_plan(plan, mp, t_get_config(arch))
    return plan, mp, dp


@pytest.mark.parametrize("spec,item", [("auto", "item 6"), ("dp=2,mp=1", "item 5"),
                                       ("pipe=2,micro=4", "item 6"), ("dp=1,mp=2", "item 7"),
                                       ("dp=1,cp=2", "item 8"), ("dp=1,zz=3", "items 5-8")])
def test_parallel_specs_other_than_single_device_raise(spec, item):
    """What of each multi-device spec is still unported raises naming its
    ROADMAP item: the ad pipeline runtime (item 6b) for the planner's BigLSTM
    plan at 64 H100s and for an explicit pipe= spec, parameters sharded over
    DP (item 5's remainder) for a dp= spec, BigLSTM's tensor MP (7b; the
    dense decoder's runs, tests/test_torch_tensor_mp.py) and an unknown key
    (5-8).  A cp= spec resolves to a context ring, which trains
    (tests/test_torch_context.py); what is left of item 8, the
    context-parallel prefill, raises naming item 8b."""
    if item == "item 8":
        from repro_torch.models.api import build_model
        from repro_torch.models.transformer import ParallelCtx

        plan, mp, _ = _resolve(spec, devices=64)
        assert (plan.mp_kind, mp) == ("context", 2)
        api = build_model(t_get_config("llama3_2_1b").reduced(), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8b"):
            api.prefill(api.init(0), {"tokens": torch.zeros((1, 16), dtype=torch.long)},
                        pctx=ParallelCtx(mesh=None))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        _resolve(spec, devices=64, runtime="ad" if item == "item 6" else None)


def test_parallel_spec_accum():
    assert _resolve("dp=1,mp=1")[0].microbatches == 1
    assert _resolve("dp=1,mp=1,accum=4")[0].microbatches == 4
    assert _resolve("auto", devices=1)[0].microbatches == 1
    with pytest.raises(SystemExit, match="cannot parse"):
        _resolve("dp=1,mp=x")


def test_dense_decoder_training_on_the_card_raises():
    """Training on the card: the dense decoder (flash attention has its
    backward kernel) and BigLSTM pass ``check_trainable``; the MoE decoder
    (no gmm backward) and RWKV (no wkv backward) still raise, naming their
    ROADMAP items.  Every decoder trains on the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for arch in ("llama3_2_1b", "biglstm"):
        TL.check_trainable(t_get_config(arch), cuda)
    with pytest.raises(NotImplementedError, match="item 14"):
        TL.check_trainable(t_get_config("granite_moe_1b_a400m"), cuda)
    with pytest.raises(NotImplementedError, match="item 17"):
        TL.check_trainable(t_get_config("rwkv6_7b"), cuda)
    for arch in ("llama3_2_1b", "granite_moe_1b_a400m", "rwkv6_7b"):
        TL.check_trainable(t_get_config(arch), cpu)


def test_gnmt_and_biglstm_serving_are_not_ported():
    """Both build a loss and, as in JAX, no serving path."""
    for arch in ("gnmt", "biglstm"):
        api = t_build_model(t_get_config(arch), device="cpu")
        assert api.prefill is None and api.decode_fn is None


@pytest.mark.parametrize("arch", ["biglstm", "llama3_2_1b"])
def test_launch_train_cli_runs_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[data] markov-lm entropy floor = " in proc.stdout
    assert "[done] steps=3 final_loss=" in proc.stdout
    # on the CPU the plain versions run: no kernel launches, forward or backward
    assert " flash_attention=0 flash_attention_bwd=0 " in proc.stdout
    assert "flash_attention_bwd: fma=0 tc=0" in proc.stdout
