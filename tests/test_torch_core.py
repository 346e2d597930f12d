"""The port's analytical framework, communication model and statistical
efficiency (``repro_torch.core``) against the JAX package's, function by
function over hypothesis-drawn grids, at 1e-12 relative; the paper claims of
``tests/test_core.py`` re-run on the port; the explicit overlap table; and
``measure_epochs_to_converge`` driving the port's train step against JAX
driving its own."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import optim as JO
from repro.configs import get_config as j_get_config
from repro.core import analytical as JA
from repro.core import comm as JC
from repro.core import stateff as JS
from repro.data import make_lm_dataset
from repro.models.api import build_model as j_build_model
from repro.train import steps as JSTEP
from repro_torch import optim as TO
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import analytical as TA
from repro_torch.core import comm as TC
from repro_torch.core import stateff as TS
from repro_torch.interop import params_from_jax
from repro_torch.models.api import build_model as t_build_model
from repro_torch.train import TrainState, make_train_step

REL = 1e-12
ROOT = os.path.join(os.path.dirname(__file__), "..")
SETTINGS = settings(max_examples=150, deadline=None, derandomize=True, database=None)
JAX_HW = JC.HardwareModel()
PORT_HW = TC.HardwareModel(**dataclasses.asdict(JAX_HW), p2p_links=4)

pos = st.floats(min_value=1.0, max_value=1e12, allow_nan=False)
bw = st.floats(min_value=1e8, max_value=1e13, allow_nan=False)
lat = st.floats(min_value=0.0, max_value=1e-4, allow_nan=False)
devices = st.integers(min_value=1, max_value=4096)
pow2 = st.sampled_from([1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048])


def same(got, want):
    assert got == pytest.approx(want, rel=REL, abs=0.0), (got, want)


# ---- comm -----------------------------------------------------------------

@SETTINGS
@given(pos, devices, bw, lat, pos)
def test_ring_and_bucketed_all_reduce_match_jax(nbytes, n, b, a, bucket):
    same(TC.ring_all_reduce_time(nbytes, n, b, a), JC.ring_all_reduce_time(nbytes, n, b, a))
    same(TC.bucketed_all_reduce_time(nbytes, n, b, a, bucket),
         JC.bucketed_all_reduce_time(nbytes, n, b, a, bucket))


@SETTINGS
@given(pos, st.integers(min_value=1, max_value=64), st.booleans(),
       st.floats(min_value=1.0, max_value=4.0))
def test_p2p_and_cp_ring_match_jax(hop_bytes, m, inter_pod, rings):
    same(TC.p2p_transfer_time(hop_bytes, PORT_HW, inter_pod=inter_pod),
         JC.p2p_transfer_time(hop_bytes, JAX_HW, inter_pod=inter_pod))
    same(TC.cp_ring_time(hop_bytes, m, PORT_HW, rings=rings, inter_pod=inter_pod),
         JC.cp_ring_time(hop_bytes, m, JAX_HW, rings=rings, inter_pod=inter_pod))


@SETTINGS
@given(pos, pow2, pow2, st.sampled_from([0.0, 1e6, 32 * 2**20]),
       st.floats(min_value=1e-4, max_value=10.0), st.floats(min_value=0.0, max_value=0.95),
       st.booleans())
def test_hierarchical_and_scaling_efficiency_match_jax(nbytes, n, degree, bucket, t1,
                                                        overlap, perfect):
    same(TC.hierarchical_all_reduce_time(nbytes, n, PORT_HW, degree, bucket),
         JC.hierarchical_all_reduce_time(nbytes, n, JAX_HW, degree, bucket))
    same(TC.scaling_efficiency(nbytes, t1, n, PORT_HW, overlap=overlap, bucket_bytes=bucket,
                               assume_perfect=perfect),
         JC.scaling_efficiency(nbytes, t1, n, JAX_HW, overlap=overlap, bucket_bytes=bucket,
                               assume_perfect=perfect))


def test_overlap_table_is_explicit():
    """The port reads no artifact unless given its path; given the JAX
    package's BENCH_collectives.json it reads the JAX value."""
    assert TC.load_measured_overlap() == {"gspmd": 0.0, "overlapped": TC.OVERLAP_FALLBACK}
    assert TC.load_measured_overlap(os.path.join(ROOT, "BENCH_collectives.json")) == \
        JC.MEASURED_OVERLAP
    assert TC.load_measured_overlap(os.path.join(ROOT, "no_such_file.json")) == \
        TC.load_measured_overlap()


def test_overlap_artifact_is_clamped(tmp_path):
    for proxy, want in ((1.7, 0.95), (-0.3, 0.0), ("x", TC.OVERLAP_FALLBACK)):
        p = tmp_path / "bench.json"
        p.write_text(json.dumps({"tensor_mp": {"overlap_constant_proxy": proxy}}))
        assert TC.load_measured_overlap(str(p))["overlapped"] == want


# ---- analytical -------------------------------------------------------------

def _runs(t1, grad_bytes, mini, e_inf, b_crit, alpha, b_max, su, se_perfect, overlap,
          bucket):
    kw = dict(name="net", t1=t1, grad_bytes=grad_bytes, mini_batch=mini,
              dataset_size=1_281_167, mp_speedup={2: su, 4: su * 1.3, 8: su * 1.1},
              se_perfect=se_perfect, comm_overlap=overlap, bucket_bytes=bucket,
              pipe_speedup={(2, 4, "gpipe"): su * 1.2, (4, 8): su * 1.5,
                            (4, 8, "1f1b"): su * 1.5, (2, 8, "interleaved"): su * 1.4},
              cp_speedup={2: su * 1.4, 8: su * 2.0})
    return (JA.TrainingRun(epoch_model=JS.EpochModel(e_inf, b_crit, alpha, b_max),
                           hw=JAX_HW, **kw),
            TA.TrainingRun(epoch_model=TS.EpochModel(e_inf, b_crit, alpha, b_max),
                           hw=PORT_HW, **kw))


@SETTINGS
@given(st.floats(min_value=1e-3, max_value=2.0), pos, st.sampled_from([16, 64, 128]),
       st.floats(min_value=1.0, max_value=10.0), st.floats(min_value=64, max_value=1e5),
       st.sampled_from([1.0, 1.5, 2.0, 3.0]), st.sampled_from([None, 4096.0, 65536.0]),
       st.floats(min_value=0.5, max_value=3.0), st.booleans(),
       st.floats(min_value=0.0, max_value=0.9), st.sampled_from([0.0, 32 * 2**20]))
def test_analytical_functions_match_jax(t1, grad_bytes, mini, e_inf, b_crit, alpha, b_max,
                                        su, se_perfect, overlap, bucket):
    jr, tr = _runs(t1, grad_bytes, mini, e_inf, b_crit, alpha, b_max, su, se_perfect,
                   overlap, bucket)
    for n in (1, 2, 8, 64, 256, 1024):
        same(TA.epochs_ratio(tr, n), JA.epochs_ratio(jr, n))
        same(TA.speedup_dp(tr, n), JA.speedup_dp(jr, n))
        same(TA.se(tr, n, grad_scale=0.5, hybrid=True), JA.se(jr, n, grad_scale=0.5,
                                                               hybrid=True))
        for m in (1, 2, 4, 8):
            same(TA.speedup_hybrid(tr, n, m), JA.speedup_hybrid(jr, n, m))
            same(TA.speedup_context(tr, n, m), JA.speedup_context(jr, n, m))
            assert TA.hybrid_wins(tr, n, m) == JA.hybrid_wins(jr, n, m)
            same(TA.convergence_time(tr, n, m), JA.convergence_time(jr, n, m))
            for k, sched in ((4, "gpipe"), (8, "gpipe"), (8, "1f1b"), (8, "interleaved")):
                same(TA.speedup_pipeline(tr, n, m, k, sched),
                     JA.speedup_pipeline(jr, n, m, k, sched))
        tb, jb = TA.best_strategy(tr, n), JA.best_strategy(jr, n)
        assert tb.keys() == jb.keys() and (tb["m"], tb["n"]) == (jb["m"], jb["n"])
        same(tb["speedup"], jb["speedup"])
        same(tb["convergence_time"], jb["convergence_time"])
    for m in (2, 4):
        assert TA.crossover_device_count(tr, m) == JA.crossover_device_count(jr, m)


def test_paper_claim_inception_hybrid_at_scale():
    """tests/test_core.py's paper claim, on the port: with the paper's Fig. 4
    Inception-V3 epochs and SU^2 = 1.32, hybrid beats DP-only by >= 26.5% at
    256 GPUs and >= 15.5% at 64 (paper §5), by the JAX package's numbers."""
    kw = dict(name="inception_v3", t1=0.1, grad_bytes=4 * 25e6, mini_batch=64,
              dataset_size=1_281_167, mp_speedup={2: 1.32}, se_perfect=True)
    run = TA.TrainingRun(epoch_model=TS.paper_epoch_table("inception_v3"), **kw)
    jrun = JA.TrainingRun(epoch_model=JS.paper_epoch_table("inception_v3"), **kw)
    for total, min_gain in [(64, 1.15), (256, 1.26)]:
        gain = TA.speedup_hybrid(run, total // 2, 2) / TA.speedup_dp(run, total)
        assert gain >= min_gain, (total, gain)
        same(gain, JA.speedup_hybrid(jrun, total // 2, 2) / JA.speedup_dp(jrun, total))


def test_paper_claim_biglstm():
    """BigLSTM on the port: hybrid at 32 devices beats DP-only best (paper:
    1.22x), by the JAX package's numbers."""
    kw = dict(name="biglstm", t1=0.5, grad_bytes=4 * 420e6, mini_batch=128,
              dataset_size=768_000, mp_speedup={2: 1.22}, se_perfect=True)
    run = TA.TrainingRun(epoch_model=TS.paper_epoch_table("biglstm"), **kw)
    jrun = JA.TrainingRun(epoch_model=JS.paper_epoch_table("biglstm"), **kw)
    gain = TA.speedup_hybrid(run, 16, 2) / max(TA.speedup_dp(run, n) for n in (8, 16, 32))
    assert gain >= 1.1
    same(gain, JA.speedup_hybrid(jrun, 16, 2) / max(JA.speedup_dp(jrun, n)
                                                   for n in (8, 16, 32)))


# ---- statistical efficiency ---------------------------------------------------

def test_paper_tables_and_fits_match_jax():
    assert TS.PAPER_FIG4 == JS.PAPER_FIG4 and TS.PAPER_MINI_BATCH == JS.PAPER_MINI_BATCH
    for net in TS.PAPER_FIG4:
        assert dataclasses.asdict(TS.paper_epoch_model(net)) == \
            dataclasses.asdict(JS.paper_epoch_model(net))
        tt, jt = TS.paper_epoch_table(net), JS.paper_epoch_table(net)
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        for b in (100, 512, 700, 3000, 4096, 4097, 20000, 70000):
            assert tt.epochs(b) == jt.epochs(b)
            assert tt.ratio(b, 1024) == jt.ratio(b, 1024)
    assert TS.paper_epoch_model("biglstm").epochs(8192) == float("inf")


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(st.dictionaries(st.sampled_from([128, 256, 512, 1024, 2048, 4096, 8192, 16384]),
                       st.floats(min_value=1.0, max_value=40.0), min_size=2, max_size=8),
       st.sampled_from([None, 8192.0]),
       st.floats(min_value=1.0, max_value=1e5), st.floats(min_value=1.0, max_value=1e5))
def test_epoch_models_match_jax(points, b_max, b1, b2):
    tfit, jfit = TS.fit_epoch_model(points, b_max), JS.fit_epoch_model(points, b_max)
    assert dataclasses.asdict(tfit) == dataclasses.asdict(jfit)
    tt, jt = TS.EpochTable.from_dict(points, b_max), JS.EpochTable.from_dict(points, b_max)
    got = [tfit.epochs(b1), tfit.ratio(b1, b2), tt.epochs(b1), tt.ratio(b1, b2)]
    want = [jfit.epochs(b1), jfit.ratio(b1, b2), jt.epochs(b1), jt.ratio(b1, b2)]
    assert np.array_equal(got, want, equal_nan=True), (got, want)   # inf / inf is nan


def test_measure_epochs_to_converge_drives_the_port_train_step():
    """Reduced BigLSTM from one init, 3 epochs of 4 batches (B 4, T 16):
    the port's step under the port's ``measure_epochs_to_converge`` and the
    JAX step under JAX's give the same epochs for targets placed between
    the runs' losses, never within 1e-3 of one."""
    jcfg, tcfg = j_get_config("biglstm").reduced(), t_get_config("biglstm").reduced()
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    tapi = t_build_model(tcfg, device="cpu")
    data = make_lm_dataset(vocab=64, seq_len=16)
    epochs = [[{k: v.astype(np.int32) for k, v in b.items()}
               for _, b in zip(range(4), data.epoch(e, 4))] for e in range(3)]

    jopt = JO.adamw(JO.warmup_cosine(3e-3, 20, 12))
    jstep = jax.jit(JSTEP.make_train_step(japi, jopt))
    jlosses, tlosses = [], []

    def jax_step(state, batch):
        state, m = jstep(state, jax.tree.map(jnp.asarray, batch))
        jlosses.append(float(m["loss"]))
        return state, m

    topt = TO.adamw(TO.warmup_cosine(3e-3, 20, 12))
    tstep = make_train_step(tapi, topt)

    def port_step(state, batch):
        state, m = tstep(state, {k: torch.from_numpy(v.astype(np.int64))
                                 for k, v in batch.items()})
        tlosses.append(float(m["loss"]))
        return state, m

    def jstate():
        return JSTEP.TrainState(params=jparams, opt_state=jopt.init(jparams),
                                step=jnp.zeros((), jnp.int32))

    def tstate():
        params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
        return TrainState(params, topt.init(params), 0)

    JS.measure_epochs_to_converge(jax_step, jstate(), lambda e: epochs[e],
                                  target_loss=-1.0, max_epochs=3)
    TS.measure_epochs_to_converge(port_step, tstate(), lambda e: epochs[e],
                                  target_loss=-1.0, max_epochs=3)
    assert np.allclose(tlosses, jlosses, rtol=1e-4, atol=0)
    cuts = sorted(jlosses)
    targets = [(a + b) / 2 for a, b in zip(cuts, cuts[1:]) if b - a > 2e-3]
    assert len(targets) >= 3
    for target in targets:
        want = JS.measure_epochs_to_converge(jax_step, jstate(), lambda e: epochs[e],
                                             target_loss=target, max_epochs=3)
        got = TS.measure_epochs_to_converge(port_step, tstate(), lambda e: epochs[e],
                                            target_loss=target, max_epochs=3)
        assert got == want, (target, got, want)
