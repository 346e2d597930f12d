"""The port's HybridPlanner (``repro_torch.core.planner``) against the JAX
package's, and its own H100 plans.

Given the JAX ``HardwareModel()`` field values (with the hop divisor
``p2p_links`` set to the JAX module's 4 torus links) and the JAX
``MEASURED_OVERLAP``, every ``PlannerChoice`` the port emits equals JAX's:
floats within 1e-12 relative, plans and mesh shapes field by field, over
1-1024 devices, seven archs, both comm runtimes and both pipeline runtimes.
The golden rows of ``tests/test_planner_golden.py`` are reproduced from that
table.  The port's own defaults are the H100's; its best plans under them
are pinned below like the JAX goldens, and move only with the hardware
model.
"""
import dataclasses
import math
import re

import pytest
from test_planner_golden import GOLDEN, GOLDEN_CROSSOVER

from repro.configs import get_config as j_get_config
from repro.core import comm as JC
from repro.core import planner as JP
from repro.launch import train as JL
from repro.parallel import plan as JPL
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import comm as TC
from repro_torch.core import dlplacer as TD
from repro_torch.core import planner as TP
from repro_torch.launch import train as TL
from repro_torch.parallel import plan as TPL

REL = 1e-12
ARCHS = ["inception_v3", "gnmt", "biglstm", "llama3_2_1b", "smollm_360m",
         "granite_moe_1b_a400m", "rwkv6_7b"]
DEVICES = (1, 2, 8, 64, 256, 1024)
# the JAX HardwareModel's values; 4 is the JAX module's ICI_LINKS hop divisor
JAX_HW = TC.HardwareModel(**dataclasses.asdict(JC.HardwareModel()), p2p_links=4)
JAX_OVERLAP = dict(JC.MEASURED_OVERLAP)


def _planners(arch, **kw):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    jp = JP.HybridPlanner(jcfg, epoch_model=JP.default_epoch_model(jcfg), **kw)
    tp = TP.HybridPlanner(tcfg, epoch_model=TP.default_epoch_model(tcfg),
                          hw=JAX_HW, overlap=JAX_OVERLAP, **kw)
    return jp, tp


def _assert_same(got, want, where):
    """Dataclass fields (nested plans included) equal; floats to REL."""
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.keys() == w.keys(), where
    for k, wv in w.items():
        gv = g[k]
        if isinstance(wv, float):
            assert gv == pytest.approx(wv, rel=REL, abs=0.0), (where, k, gv, wv)
        else:
            assert gv == wv, (where, k, gv, wv)


@pytest.mark.parametrize("pipe_runtime", ["scheduled", "ad"])
@pytest.mark.parametrize("comm_runtime", ["gspmd", "overlapped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_choices_match_jax(arch, comm_runtime, pipe_runtime):
    jp, tp = _planners(arch, comm_runtime=comm_runtime, pipe_runtime=pipe_runtime)
    for d in DEVICES:
        want, got = jp.choices(d), tp.choices(d)
        assert len(got) == len(want), (arch, d)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, (arch, comm_runtime, pipe_runtime, d, i))
            assert g.n_workers == w.n_workers


@pytest.mark.parametrize("arch", ["inception_v3", "gnmt", "biglstm", "llama3_2_1b"])
def test_golden_rows_reproduced(arch):
    """Every GOLDEN row of tests/test_planner_golden.py, from the port."""
    _, tp = _planners(arch)
    for devices in (64, 256, 1024):
        kind, pods, dp, mp, micro, sched, speedup = GOLDEN[(arch, devices)]
        best = tp.best(devices)
        assert (best.mp_kind, best.pods, best.dp, best.mp, best.microbatches,
                best.schedule) == (kind, pods, dp, mp, micro, sched), (arch, devices)
        assert best.speedup == pytest.approx(speedup, rel=1e-3)


def test_golden_crossover_rows_reproduced():
    for (arch, rt, m), want in GOLDEN_CROSSOVER.items():
        _, tp = _planners(arch, comm_runtime=rt)
        assert tp.crossover(m) == want, (arch, rt, m)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "smollm_360m", "granite_moe_1b_a400m",
                                  "biglstm"])
def test_inference_choices_match_jax(arch):
    for rt in ("gspmd", "overlapped"):
        jp, tp = _planners(arch, comm_runtime=rt)
        for devices, slo_ms, context in ((8, 20.0, None), (64, 5.0, 2048),
                                         (16, 50.0, 32768), (4, 0.5, None)):
            want = jp.inference_choices(devices, slo_ms=slo_ms, context=context)
            got = tp.inference_choices(devices, slo_ms=slo_ms, context=context)
            assert len(got) == len(want), (arch, rt, devices, slo_ms)
            for g, w in zip(got, want):
                _assert_same(g, w, (arch, rt, devices, slo_ms))
            if want:
                _assert_same(tp.best_inference(devices, slo_ms=slo_ms, context=context),
                             want[0], (arch, rt, devices, slo_ms))
            else:
                with pytest.raises(ValueError, match="SLO"):
                    tp.best_inference(devices, slo_ms=slo_ms, context=context)


@pytest.mark.parametrize("arch", ARCHS + ["stablelm_12b", "nemotron_4_340b", "hymba_1_5b",
                                          "whisper_large_v3", "internvl2_2b",
                                          "kimi_k2_1t_a32b"])
def test_model_functions_and_predicates_match_jax(arch):
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    jhw = JC.HardwareModel()

    def same(a, b):
        assert b == pytest.approx(a, rel=REL, abs=0.0), (arch, a, b)

    for pred in ("tensor_mp_supported", "comm_runtime_supported", "context_mp_supported",
                 "grad_bytes", "default_opt_bytes_per_param"):
        assert getattr(TP, pred)(tcfg) == getattr(JP, pred)(jcfg), (arch, pred)
    cands = (1, 2, 4, 8, 16, 32, 64)
    assert TP.pipeline_stage_candidates(tcfg, cands) == \
        JP.pipeline_stage_candidates(jcfg, cands)
    for m in cands:
        for k in (1, 2, 4, 8, 16):
            assert TP.pipeline_schedule_candidates(tcfg, m, k) == \
                JP.pipeline_schedule_candidates(jcfg, m, k)
    same(JP.kv_bytes(jcfg, 8, 4096), TP.kv_bytes(tcfg, 8, 4096))
    same(JP.step_time_single(jcfg, 16, 4096, jhw), TP.step_time_single(tcfg, 16, 4096, JAX_HW))
    for m in (1, 2, 4, 8, 32):
        for rt in ("gspmd", "overlapped"):
            same(JP.mp_step_speedup(jcfg, m, jhw, rt),
                 TP.mp_step_speedup(tcfg, m, JAX_HW, rt, JAX_OVERLAP))
            same(JP.decode_step_time(jcfg, m, jhw, slots=8, context=4096, comm_runtime=rt),
                 TP.decode_step_time(tcfg, m, JAX_HW, slots=8, context=4096,
                                     comm_runtime=rt, overlap=JAX_OVERLAP))
        same(JP.cp_step_speedup(jcfg, m, jhw, mini_batch=8, seq_len=2048),
             TP.cp_step_speedup(tcfg, m, JAX_HW, mini_batch=8, seq_len=2048))
        for k, sched, v in ((4, "gpipe", 1), (8, "1f1b", 1), (16, "interleaved", 2)):
            same(JP.pipeline_step_speedup_model(jcfg, m, k, jhw, mini_batch=16, seq_len=4096,
                                                schedule=sched, virtual_stages=v),
                 TP.pipeline_step_speedup_model(tcfg, m, k, JAX_HW, mini_batch=16,
                                                seq_len=4096, schedule=sched,
                                                virtual_stages=v))
            for kind in ("tensor", "pipeline", "context"):
                for remat, fsdp, rt in ((True, 1, "scheduled"), (False, 4, "ad")):
                    kw = dict(mp=m, mp_kind=kind, fsdp=fsdp, mini_batch=16, seq_len=4096,
                              remat=remat, microbatches=k, schedule=sched,
                              virtual_stages=v, pipe_runtime=rt)
                    same(JP.per_device_mem_bytes(jcfg, **kw),
                         TP.per_device_mem_bytes(tcfg, **kw))
    for mb in (8, 16):
        assert dataclasses.asdict(TP.default_epoch_model(tcfg, mb)) == \
            dataclasses.asdict(JP.default_epoch_model(jcfg, mb))


def test_model_predicates_match_jax():
    from repro.models.api import supports_pipeline as j_supports_pipeline
    from repro.models.transformer import overlapped_arch_supported as j_overlapped
    from repro_torch.models.api import supports_pipeline
    from repro_torch.models.transformer import cp_arch_supported, overlapped_arch_supported

    from repro_torch.configs import ARCH_IDS, PAPER_IDS
    for arch in ARCH_IDS + PAPER_IDS:
        jcfg, tcfg = j_get_config(arch), t_get_config(arch)
        assert overlapped_arch_supported(tcfg) is j_overlapped(jcfg), arch
        assert supports_pipeline(tcfg) is j_supports_pipeline(jcfg), arch
        # the config half of JAX cp_supported, as the JAX planner reads it
        assert cp_arch_supported(tcfg) is JP.context_mp_supported(jcfg), arch


def test_plan_validation_and_describe_match_jax():
    for kw in ({"mp_kind": "ring"}, {"runtime": "eager"}, {"comm_runtime": "nccl"},
               {"comm_chunks": 0}, {"mp_kind": "context", "comm_runtime": "overlapped"}):
        with pytest.raises(ValueError) as want:
            JPL.ParallelPlan(**kw)
        with pytest.raises(ValueError) as got:
            TPL.ParallelPlan(**kw)
        assert str(got.value) == str(want.value)

    class Mesh:  # the one attribute JAX's describe reads off a mesh
        shape = {"pod": 2, "data": 8, "model": 4}

    for name in ("PAPER_BASELINE", "PAPER_DP_ONLY", "OPTIMIZED", "PAPER_PIPELINE", "CONTEXT"):
        jplan, tplan = getattr(JPL, name), getattr(TPL, name)
        assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan), name
    _, tp = _planners("biglstm")
    jp, _ = _planners("biglstm")
    for c_t, c_j in zip(tp.choices(1024)[:40], jp.choices(1024)[:40]):
        sizes = dict(zip(("pod", "data", "model") if c_t.pods > 1 else ("data", "model"),
                         c_t.mesh_shape))
        Mesh.shape = sizes
        assert c_t.plan.describe(sizes) == c_j.plan.describe(Mesh)
        assert TPL.plan_degrees(c_t.plan, sizes) == JPL.plan_degrees(c_j.plan, Mesh)
    for tp_deg in (1, 2, 8):
        assert dataclasses.asdict(TPL.serve_plan(tp_deg, comm_chunks=2)) == \
            dataclasses.asdict(JPL.serve_plan(tp_deg, comm_chunks=2))


def test_build_router_names_its_roadmap_item():
    """``InferenceChoice.build_router`` executes the planner's choice: at tp 1
    a router of ``choice.replicas`` engines of ``choice.slots`` slots in this
    process; at tp > 1 without a rank mesh of (replicas, tp) it raises
    naming the ranks the choice needs."""
    from repro_torch.models.api import build_model

    _, tp = _planners("llama3_2_1b")
    choice = tp.best_inference(8, slo_ms=20.0)
    api = build_model(t_get_config("llama3_2_1b").reduced(), device="cpu")
    params = api.init(0)
    wide = dataclasses.replace(choice, tp=2)
    with pytest.raises(ValueError, match=rf"{wide.replicas} x 2 = {2 * wide.replicas} ranks"):
        wide.build_router(api, params, capacity=128)
    one = dataclasses.replace(choice, tp=1, replicas=2, slots=3)
    rt = one.build_router(api, params, capacity=128)
    assert [r.engine.n_slots for r in rt.replicas] == [3, 3]
    assert all(r.engine.params is params for r in rt.replicas)


def test_unknown_runtimes_raise():
    cfg = t_get_config("biglstm")
    for kw in ({"pipe_runtime": "eager"}, {"comm_runtime": "nccl"}):
        with pytest.raises(ValueError, match="unknown"):
            TP.HybridPlanner(cfg, epoch_model=TP.default_epoch_model(cfg), **kw)


# ---- the port's own defaults: one NVIDIA H100 SXM and its node --------------

def test_hardware_defaults_are_the_h100s():
    hw = TC.HardwareModel()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.dci_bw, hw.chips_per_pod,
            hw.p2p_links) == (989e12, 3.35e12, 450e9, 50e9, 8, 1)
    assert hw.hbm_bytes == TC.H100_HBM_BYTES and 79 * 2**30 < hw.hbm_bytes < 80 * 2**30
    # one card cannot measure NVLink or InfiniBand: data-sheet figures
    assert (hw.ici_latency, hw.dci_latency) == (3e-6, 10e-6)   # assumptions
    assert hw.mfu == TC.H100_MFU and 0.0 < hw.mfu < 1.0
    assert TC.MEASURED_OVERLAP == {"gspmd": 0.0, "overlapped": TC.OVERLAP_FALLBACK}
    assert TP.HybridPlanner(t_get_config("biglstm"), epoch_model=TP.default_epoch_model(
        t_get_config("biglstm"))).hw == hw
    g = TD.HardwareGraph(n_devices=2)
    assert (g.flops_per_s, g.bw, g.latency, g.mem_capacity) == (
        989e12 * hw.mfu, hw.ici_bw, hw.ici_latency, hw.hbm_bytes)


def test_p2p_links_divides_the_hop():
    hw1 = TC.HardwareModel()
    hw4 = dataclasses.replace(hw1, p2p_links=4)
    b = 64 * 2**20
    assert TC.p2p_transfer_time(b, hw1) == pytest.approx(b / hw1.ici_bw + hw1.ici_latency)
    assert TC.p2p_transfer_time(b, hw4) == pytest.approx(4 * b / hw1.ici_bw + hw1.ici_latency)
    assert TC.p2p_transfer_time(b, hw4, inter_pod=True) == \
        TC.p2p_transfer_time(b, hw1, inter_pod=True)


# (arch, devices) -> (mp_kind, pods, dp, mp, microbatches, schedule, speedup,
# GiB a card) of the best plan under the port's H100 defaults
H100_GOLDEN = {
    ("inception_v3", 1): ("none", 1, 1, 1, 1, "-", 1.0, 2.8125),
    ("inception_v3", 8): ("none", 1, 8, 1, 1, "-", 4.72136, 2.8125),
    ("inception_v3", 64): ("none", 8, 8, 1, 1, "-", 1.38263, 2.8125),
    ("inception_v3", 256): ("tensor", 1, 8, 32, 1, "-", 0.495541, 0.0878906),
    ("inception_v3", 1024): ("tensor", 1, 32, 32, 1, "-", 0.277262, 0.0878906),
    ("gnmt", 1): ("none", 1, 1, 1, 1, "-", 1.0, 2.53906),
    ("gnmt", 8): ("pipeline", 1, 4, 2, 16, "interleaved", 6.81119, 1.08203),
    ("gnmt", 64): ("pipeline", 8, 2, 4, 16, "1f1b", 17.7034, 0.556641),
    ("gnmt", 256): ("pipeline", 32, 2, 4, 16, "1f1b", 6.41824, 0.556641),
    ("gnmt", 1024): ("pipeline", 128, 2, 4, 16, "1f1b", 1.6486, 0.556641),
    ("biglstm", 1): ("none", 1, 1, 1, 1, "-", 1.0, 25.2188),
    ("biglstm", 8): ("none", 1, 8, 1, 1, "-", 7.60301, 25.2188),
    ("biglstm", 64): ("pipeline", 8, 4, 2, 16, "1f1b", 35.9677, 12.5156),
    ("biglstm", 256): ("pipeline", 32, 4, 2, 16, "1f1b", 20.6925, 12.5156),
    ("biglstm", 1024): ("pipeline", 128, 4, 2, 16, "1f1b", 5.62925, 12.5156),
    ("llama3_2_1b", 1): ("none", 1, 1, 1, 1, "-", 1.0, 26.3281),
    ("llama3_2_1b", 8): ("context", 1, 4, 2, 1, "-", 7.77018, 24.3281),
    ("llama3_2_1b", 64): ("context", 8, 1, 8, 1, "-", 56.7791, 22.8281),
    ("llama3_2_1b", 256): ("context", 1, 16, 16, 1, "-", 188.098, 22.5781),
    ("llama3_2_1b", 1024): ("context", 1, 32, 32, 1, "-", 447.366, 22.4531),
}
H100_CROSSOVER = {"inception_v3": None, "gnmt": None, "biglstm": None, "llama3_2_1b": 8}


@pytest.mark.parametrize("arch", ["inception_v3", "gnmt", "biglstm", "llama3_2_1b"])
def test_h100_golden_plans(arch):
    cfg = t_get_config(arch)
    planner = TP.HybridPlanner(cfg, epoch_model=TP.default_epoch_model(cfg))
    for devices in (1, 8, 64, 256, 1024):
        kind, pods, dp, mp, micro, sched, speedup, gib = H100_GOLDEN[(arch, devices)]
        best = planner.best(devices)
        assert (best.mp_kind, best.pods, best.dp, best.mp, best.microbatches,
                best.schedule) == (kind, pods, dp, mp, micro, sched), (arch, devices, best)
        assert best.speedup == pytest.approx(speedup, rel=1e-3)
        assert best.mem_bytes / 2**30 == pytest.approx(gib, rel=1e-3)
        assert best.mem_bytes <= planner.hw.hbm_bytes
        assert all(math.isfinite(c.speedup) for c in planner.choices(devices))
    assert planner.crossover(2) == H100_CROSSOVER[arch]


# ---- the launcher's --parallel auto -------------------------------------------

@pytest.mark.parametrize("arch", ["biglstm", "llama3_2_1b", "gnmt", "inception_v3"])
def test_parse_parallel_auto_matches_jax(arch, monkeypatch, capsys):
    """Given the JAX constants, the port's --parallel auto resolves to the
    plan, MP degree and DP hint the JAX launcher's does, and prints the same
    [planner] line."""
    monkeypatch.setattr(TL, "HybridPlanner", lambda cfg, **kw: TP.HybridPlanner(
        cfg, hw=JAX_HW, overlap=JAX_OVERLAP, **kw))
    for devices in (1, 8, 64, 256):
        for rt in ("gspmd", "overlapped"):
            try:
                jplan, jmp, jdp = JL.parse_parallel("auto", devices, j_get_config(arch),
                                                    comm_runtime=rt)
            except SystemExit as e:       # no plan fits 16 GiB
                with pytest.raises(SystemExit, match=re.escape(str(e))):
                    TL.parse_parallel("auto", devices, t_get_config(arch), comm_runtime=rt)
                continue
            jax_out = capsys.readouterr().out
            plan, mp, dp = TL.parse_parallel("auto", devices, t_get_config(arch),
                                             comm_runtime=rt)
            assert capsys.readouterr().out == jax_out
            assert (dataclasses.asdict(plan), mp, dp) == (dataclasses.asdict(jplan), jmp, jdp)
    if arch == "llama3_2_1b":
        plan, mp, dp = TL.parse_parallel("auto", 64, t_get_config(arch), context_parallel=True)
        jplan, jmp, jdp = JL.parse_parallel("auto", 64, j_get_config(arch),
                                            context_parallel=True)
        assert (dataclasses.asdict(plan), mp, dp) == (dataclasses.asdict(jplan), jmp, jdp)
    else:
        with pytest.raises(SystemExit, match="context-parallel"):
            TL.parse_parallel("auto", 64, t_get_config(arch), context_parallel=True)


def test_launcher_auto_trains_one_device_on_cpu(capsys):
    summary = TL.main(["--arch", "biglstm", "--reduced", "--device", "cpu", "--parallel",
                       "auto", "--devices", "1", "--steps", "2", "--batch", "4",
                       "--seq", "16"])
    out = capsys.readouterr().out
    assert "[planner] (1, 1) kind=none sched=- micro=1 SU=1.0 " in out
    assert "[plan] 1-way DP x 1-way tensor MP on cpu" in out
    assert summary["steps"] == 2 and all(math.isfinite(x) for x in summary["history"])


def test_launcher_auto_clamps_dp_to_the_card(capsys):
    """The planner's DP degree is clamped to the ranks this run may realise
    (``--max-local-devices``: the cards on the card's machine), as the JAX
    launcher clamps it to its local devices; parameters sharded over DP raise
    naming item 5's remainder."""
    plan, mp, dp = TL.parse_parallel("auto", 8, t_get_config("biglstm"))
    assert mp == 1 and dp == 8 and not plan.fsdp_axes
    assert TL.clamp_dp(dp, mp, 16, 1, f"{mp}-way MP") == 1
    assert "[plan] clamped DP 8 -> 1" in capsys.readouterr().out
    assert TL.clamp_dp(dp, mp, 16, 8, f"{mp}-way MP") == 8
    assert TL.clamp_dp(dp, mp, 12, 8, f"{mp}-way MP") == 6      # dp divides the batch
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 5"):
        TL.check_plan(dataclasses.replace(plan, fsdp_axes=("data",)), 1)


@pytest.mark.parametrize("arch,item", [("biglstm", "item 6"), ("llama3_2_1b", "item 8"),
                                       ("inception_v3", "item 7")])
def test_launcher_auto_names_the_item_of_a_multi_card_plan(arch, item):
    """At 64 H100s the planner picks pipeline MP for BigLSTM, which trains
    on ranks through the scheduled runtime and names item 6b only under
    ``--pipe-runtime ad``; context parallelism for Llama, whose ring trains
    (tests/test_torch_context.py) and serves the continuous engine's chunks
    (tests/test_torch_serving_parallel.py), while the static engine's
    prefill under the ctx names item 7b; at 256 tensor MP for Inception-V3,
    which the port runs
    (item 7; tests/test_torch_tensor_mp.py trains this plan clamped to 2
    ranks): the plan passes, its clamp to a 2-rank model axis builds a
    step, and the launcher refuses Inception only for its data format."""
    if arch == "llama3_2_1b":
        import torch
        from repro_torch.models.api import build_model
        from repro_torch.models.transformer import ParallelCtx

        plan, mp, _ = TL.parse_parallel("auto", 64, t_get_config(arch))
        assert (plan.mp_kind, mp) == ("context", 8)
        TL.check_plan(plan, mp)
        api = build_model(t_get_config(arch).reduced(), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7b"):
            api.prefill(api.init(0), {"tokens": torch.zeros((1, 16), dtype=torch.long)},
                        pctx=ParallelCtx(mesh=None))
        return
    if arch == "inception_v3":
        from repro_torch import optim as TO
        from repro_torch.models.api import build_model
        from repro_torch.train import make_train_step

        cfg = t_get_config(arch)
        plan, mp, dp = TL.parse_parallel("auto", 256, cfg)
        assert (plan.mp_kind, dp, mp) == ("tensor", 8, 32)
        TL.check_plan(plan, mp, cfg)
        clamped = dataclasses.replace(plan, dp_axes=("data",))

        class Mesh:
            shape = {"data": 1, "model": 2}

        api = build_model(cfg.reduced(), device="cpu")
        assert callable(make_train_step(api, TO.sgd(TO.constant_lr(0.1)), mesh=Mesh(),
                                        plan=clamped))
        with pytest.raises(SystemExit, match="feeds the token-LM data pipeline only"):
            TL.main(["--arch", arch, "--reduced", "--device", "cpu", "--parallel", "auto"])
        return
    extra = ["--pipe-runtime", "ad"] if arch == "biglstm" else []
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        TL.main(["--arch", arch, "--reduced", "--device", "cpu", "--parallel", "auto",
                 "--devices", "64", "--steps", "1", "--batch", "4", "--seq", "16", *extra])
