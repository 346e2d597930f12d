"""The tuning harness's Python (``repro_torch.kernels.tune``) on the CPU: the
C++ it generates for each kernel family and its command line.  Building and
timing the harness needs nvcc and a card (``python -m
repro_torch.kernels.tune`` on the card)."""
import re

import pytest

from repro_torch.kernels import build, tune


def test_harness_instantiates_every_flash_backward_choice_once():
    text = tune._harness(["flash_bwd"])
    assert str(build.CSRC / "flash_attention.cu") in text
    kv = re.findall(r"case (\d+): return launch_wg_bwd_kv<64, (\d+), (\d+), (\d+)>", text)
    q = re.findall(r"case (\d+): return launch_wg_bwd_q<64, (\d+), (\d+), (\d+), (\d+)>", text)
    assert [tuple(map(int, c[1:])) for c in kv] == tune.FLASH_BWD_KV
    assert [tuple(map(int, c[1:])) for c in q] == tune.FLASH_BWD_Q
    # case numbers are what tune_flash_bwd passes: 0.. for dK/dV, 100.. for dQ
    assert [int(c[0]) for c in kv] == list(range(len(tune.FLASH_BWD_KV)))
    assert [int(c[0]) for c in q] == [100 + i for i in range(len(tune.FLASH_BWD_Q))]
    assert len(set(tune.FLASH_BWD_KV)) == len(tune.FLASH_BWD_KV)
    assert len(set(tune.FLASH_BWD_Q)) == len(tune.FLASH_BWD_Q)


@pytest.mark.parametrize("which", [["lstm"], ["wkv"], ["lstm", "wkv"]])
def test_harness_leaves_out_the_flash_backward_unless_named(which):
    text = tune._harness(which)
    assert "flash_attention.cu" not in text and "tune_flash_bwd" not in text
    assert "tune_lstm" in text and "tune_wkv" in text


def test_flash_backward_choices_are_ones_the_kernels_take():
    # the pipelined walks need 3 stages or more; the dQ tile is 64 or 128 keys
    assert all(w >= 1 and st >= 3 and mb >= 1 for w, st, mb in tune.FLASH_BWD_KV)
    assert all(w >= 1 and bk in (64, 128) and st >= 3 and mb >= 1
               for w, bk, st, mb in tune.FLASH_BWD_Q)


def test_cli_rejects_an_unknown_kernel_before_looking_for_a_card():
    with pytest.raises(SystemExit, match="unknown kernels"):
        tune.main(["flash_fwd"])
