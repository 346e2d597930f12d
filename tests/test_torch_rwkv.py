"""The port's RWKV-6 blocks against the JAX package's on the same weights.

One layer of reduced rwkv6_7b (d_model 256, 4 heads of 64, d_ff 512, LoRA
rank 32, f32) from the JAX init, carried across as numpy.  The time mix and
the channel mix run from zero ``last_x`` and zero state (train and prefill)
and from a carried (last_x, S) (decode), on inputs drawn with numpy from a
seed.  Tolerance 1e-5: the same f32 arithmetic, summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import rwkv as JRW
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import rwkv as TRW

TOL = 1e-5
B = 2


@pytest.fixture(scope="module")
def layer():
    jcfg, tcfg = j_get_config("rwkv6_7b").reduced(), t_get_config("rwkv6_7b").reduced()
    np_p = jax.tree.map(np.asarray, JRW.rwkv_layer_init(jax.random.PRNGKey(0), jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), np_p)
    return dict(jcfg=jcfg, tcfg=tcfg, np_p=np_p, tp=tp)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _err(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


def test_layer_init_matches_jax_layout_and_scales(layer):
    tcfg = layer["tcfg"]
    tp = TRW.rwkv_layer_init(torch.Generator().manual_seed(0), tcfg, lead=(3,))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(layer["np_p"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert set(flat_j) == set(flat_t)
    for path, want in flat_j.items():
        got = flat_t[path].numpy()
        assert got.shape == (3, *want.shape) and got.dtype == want.dtype, path
        name = jax.tree_util.keystr(path)
        if any(n in name for n in ("mu_", "ln")):            # constants: equal
            assert np.array_equal(got[1], want), path
        elif "w0" in name:              # linspace(-6, -1): the two round apart
            assert np.abs(got[1] - want).max() < 1e-6
        else:                                                # draws: same scale
            assert abs(got.std() / want.std() - 1) < 0.1, path
    assert TRW.heads(tcfg) == (4, 64) and TRW.lora_rank(tcfg) == 32


@pytest.mark.parametrize("t", [1, 12])
@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_matches_jax(layer, t, carried):
    jcfg, tcfg = layer["jcfg"], layer["tcfg"]
    d, (h, hd) = tcfg.d_model, TRW.heads(tcfg)
    x = _x(t, B, t, d)
    last = _x(t + 1, B, d) if carried else np.zeros((B, d), np.float32)
    s0 = _x(t + 2, B, h, hd, hd, scale=0.5) if carried else None
    j_out, j_last, j_s = JRW.rwkv_time_mix(
        jax.tree.map(jnp.asarray, layer["np_p"]["tm"]), jnp.asarray(x), jnp.asarray(last),
        None if s0 is None else jnp.asarray(s0), jcfg)
    state = None if s0 is None else torch.from_numpy(s0.copy())
    t_out, t_last, t_s = TRW.rwkv_time_mix(layer["tp"]["tm"], torch.from_numpy(x),
                                           torch.from_numpy(last), state, tcfg)
    assert _err(t_out, j_out) < TOL and _err(t_s, j_s) < TOL
    assert np.array_equal(t_last.numpy(), np.asarray(j_last))
    if carried:
        assert t_s is state                       # the state was updated in place


@pytest.mark.parametrize("t", [1, 12])
@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_jax(layer, t, carried):
    d = layer["tcfg"].d_model
    x = _x(10 + t, B, t, d)
    last = _x(11 + t, B, d) if carried else np.zeros((B, d), np.float32)
    j_out, j_last = JRW.rwkv_channel_mix(jax.tree.map(jnp.asarray, layer["np_p"]["cm"]),
                                         jnp.asarray(x), jnp.asarray(last))
    t_out, t_last = TRW.rwkv_channel_mix(layer["tp"]["cm"], torch.from_numpy(x),
                                         torch.from_numpy(last))
    assert _err(t_out, j_out) < TOL
    assert np.array_equal(t_last.numpy(), np.asarray(j_last))


def test_token_shift_matches_jax():
    x, last = _x(20, B, 5, 8), _x(21, B, 8)
    j_prev, j_last = JRW._token_shift(jnp.asarray(x), jnp.asarray(last))
    t_prev, t_last = TRW._token_shift(torch.from_numpy(x), torch.from_numpy(last))
    assert np.array_equal(t_prev.numpy(), np.asarray(j_prev))
    assert np.array_equal(t_last.numpy(), np.asarray(j_last))
