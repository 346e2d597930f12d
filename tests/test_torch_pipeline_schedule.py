"""The port's pipeline schedules (``repro_torch.parallel.pipeline``) against
the JAX package's: the fwd+bwd WorkUnit table, the forward placement
arrays, the closed-form bubble and residency, the residency read off the
table and the tick count, for every schedule kind, 1-8 stages, 1-16
micro-batches and 2-4 interleaved chunks; and the planner's three analytic
functions."""
import dataclasses

import numpy as np
import pytest

from repro.parallel import pipeline as JP
from repro_torch.parallel import pipeline as TP
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MICROS = range(1, 17)


def _virtuals(kind):
    return (2, 3, 4) if kind == "interleaved" else (1,)


@pytest.mark.parametrize("stages", range(1, 9))
@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "interleaved"])
def test_schedule_matches_jax(kind, stages):
    for k in MICROS:
        for v in _virtuals(kind):
            want = JP.PipelineSchedule(kind, stages, k, v)
            got = TP.PipelineSchedule(kind, stages, k, v)
            where = (kind, stages, k, v)
            assert [dataclasses.astuple(u) for u in got.table()] == \
                [dataclasses.astuple(u) for u in want.table()], where
            ft, wt = got.forward_table(), want.forward_table()
            assert ft.keys() == wt.keys()
            for name in wt:
                assert ft[name].dtype == np.int32 and np.array_equal(ft[name], wt[name]), \
                    (where, name)
            assert got.bubble_fraction() == want.bubble_fraction(), where
            assert got.activation_residency() == want.activation_residency(), where
            assert got.residency_from_table() == want.residency_from_table(), where
            assert got.total_ticks() == want.total_ticks(), where
            assert got.fwd_ticks == want.fwd_ticks and got.n_virtual == want.n_virtual
            assert got.describe() == want.describe(), where


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "interleaved"])
def test_analytic_functions_match_jax(kind):
    for stages in range(1, 9):
        for k in MICROS:
            for v in _virtuals(kind):
                assert TP.pipeline_bubble_fraction(k, stages, kind, v) == \
                    JP.pipeline_bubble_fraction(k, stages, kind, v)
                for rt in ("scheduled", "ad"):
                    assert TP.pipeline_activation_residency(k, stages, kind, v, rt) == \
                        JP.pipeline_activation_residency(k, stages, kind, v, rt)
                for comm in (0.0, 0.05, 0.5):
                    assert TP.pipeline_step_speedup(stages, k, comm, kind, v) == \
                        JP.pipeline_step_speedup(stages, k, comm, kind, v)


def test_make_schedule_normalises_as_jax():
    for kind in TP.SCHEDULE_KINDS:
        for v in (0, 1, 2, 3):
            got, want = TP.make_schedule(kind, 4, 8, v), JP.make_schedule(kind, 4, 8, v)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert TP.SCHEDULE_KINDS == JP.SCHEDULE_KINDS


@pytest.mark.parametrize("args", [("zb", 2, 4, 1), ("gpipe", 2, 4, 2), ("1f1b", 2, 4, 3),
                                  ("interleaved", 2, 4, 1), ("gpipe", 0, 4, 1),
                                  ("1f1b", 2, 0, 1)])
def test_invalid_schedules_raise_as_jax(args):
    with pytest.raises(ValueError) as want:
        JP.PipelineSchedule(*args)
    with pytest.raises(ValueError) as got:
        TP.PipelineSchedule(*args)
    assert str(got.value) == str(want.value)
