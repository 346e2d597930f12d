"""The port's configs are a field-for-field copy of the JAX package's."""
import dataclasses

import pytest

from repro.configs import base as JB
from repro_torch.configs import base as TB

ARCHS = JB.ARCH_IDS + JB.PAPER_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal_full_and_reduced(arch):
    j, t = JB.get_config(arch), TB.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.vocab_padded, t.n_params(), t.n_active_params()) == \
        (j.vocab_padded, j.n_params(), j.n_active_params())


def test_registry_and_shapes_equal():
    assert (TB.ARCH_IDS, TB.PAPER_IDS) == (JB.ARCH_IDS, JB.PAPER_IDS)
    assert {k: dataclasses.asdict(v) for k, v in TB.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JB.INPUT_SHAPES.items()}
    assert [f.name for f in dataclasses.fields(TB.ModelConfig)] == \
        [f.name for f in dataclasses.fields(JB.ModelConfig)]
    assert TB.pad_vocab(49155) == JB.pad_vocab(49155) == 49408
    with pytest.raises(KeyError):
        TB.get_config("gpt5")
