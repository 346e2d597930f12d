"""``repro_torch.models.layers`` against ``repro.models.layers`` on the same
numpy inputs.  fp32 throughout; tolerance 1e-5 (abs) unless a test says
otherwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_rms_norm():
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    g = rng.standard_normal(64, dtype=np.float32)
    assert _err(TL.rms_norm(_t(x), _t(g), 1e-5).numpy(),
                JL.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)) < TOL
    # bf16 activations: computed in f32, cast back (one bf16 ulp)
    out = TL.rms_norm(_t(x).bfloat16(), _t(g), 1e-5)
    ref = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), 1e-5)
    assert out.dtype == torch.bfloat16
    assert _err(out.float().numpy(), ref.astype(jnp.float32)) < 2e-2


def _rope_f64(x, positions, freqs):
    """The JAX formula with the f32 angles evaluated in float64."""
    angles = (positions[..., None].astype(np.float32) * freqs).astype(np.float64)
    sin, cos = np.sin(angles)[..., None, :], np.cos(angles)[..., None, :]
    x1, x2 = np.split(x.astype(np.float64), 2, axis=-1)
    return np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)


def test_apply_rope_long_positions():
    """Positions up to 4096 with Llama-3's theta 5e5.  The port is held to a
    float64 evaluation of the same formula at 2e-5 (a few f32 ulps of
    outputs up to ~8).  Against JAX the tolerance is 1e-3: the angle
    reaches 4096 rad, where one f32 ulp is 4.9e-4, and one run saw the two
    packages' CPU sin/cos differ by that much (ROADMAP.md Queue 3)."""
    rng = _rng(1)
    x = rng.standard_normal((2, 64, 4, 64), dtype=np.float32)
    freqs = TL.rope_freqs(64, 5e5).numpy()
    assert np.array_equal(freqs, np.asarray(JL.rope_freqs(64, 5e5)))
    for pos in (np.arange(64), np.linspace(0, 4096, 64).astype(np.int32)):
        positions = np.broadcast_to(pos, (2, 64)).astype(np.int32)
        out = TL.apply_rope(_t(x), _t(positions.copy()), 5e5).numpy()
        assert _err(out, _rope_f64(x, positions, freqs)) < 2e-5
        ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(positions), 5e5)
        assert _err(out, ref) < 1e-3


def test_repeat_kv():
    k = _rng(2).standard_normal((2, 3, 2, 8), dtype=np.float32)
    for rep in (1, 4):
        assert np.array_equal(TL.repeat_kv(_t(k), rep).numpy(),
                              np.asarray(JL.repeat_kv(jnp.asarray(k), rep)))


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "sqrelu"])
def test_mlp_apply(kind):
    rng = _rng(3)
    d, ff = 32, 64
    p = {"wi": rng.standard_normal((d, ff), dtype=np.float32) / np.sqrt(d),
         "wg": rng.standard_normal((d, ff), dtype=np.float32) / np.sqrt(d),
         "wo": rng.standard_normal((ff, d), dtype=np.float32) / np.sqrt(ff)}
    if kind != "swiglu":
        del p["wg"]
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    out = TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), kind).numpy()
    ref = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), kind)
    assert _err(out, ref) < TOL
    with pytest.raises(ValueError):
        TL.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), "relu6")


def test_cache_insert_full_in_place():
    rng = _rng(4)
    cache = {"k": rng.standard_normal((2, 10, 2, 8), dtype=np.float32),
             "v": rng.standard_normal((2, 10, 2, 8), dtype=np.float32)}
    kn = rng.standard_normal((2, 1, 2, 8), dtype=np.float32)
    vn = rng.standard_normal((2, 1, 2, 8), dtype=np.float32)
    tc = {k: _t(v.copy()) for k, v in cache.items()}
    k_before = tc["k"]
    out = TL.cache_insert_full(tc, _t(kn), _t(vn), 6)
    ref = JL.cache_insert_full({k: jnp.asarray(v) for k, v in cache.items()},
                               jnp.asarray(kn), jnp.asarray(vn), 6)
    assert out["k"] is k_before                       # written in place
    for name in ("k", "v"):
        assert np.array_equal(out[name].numpy(), np.asarray(ref[name]))
    with pytest.raises(ValueError):
        TL.cache_insert_full(tc, _t(kn), _t(vn), 10)   # past capacity


@pytest.mark.parametrize("causal,q_start,window,masked", [
    (True, 0, 0, False), (True, 3, 4, False), (False, 0, 0, True)])
def test_dense_attention_with_kv_mask(causal, q_start, window, masked):
    rng = _rng(5)
    q = rng.standard_normal((2, 6, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 9, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 9, 2, 16), dtype=np.float32)
    kv_mask = (np.arange(9)[None] < np.array([[5], [9]])) if masked else None
    out = TL.attention(_t(q), _t(k), _t(v), causal=causal, q_start=q_start,
                       window=window,
                       kv_mask=None if kv_mask is None else _t(kv_mask)).numpy()
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, q_start=q_start, window=window,
                       kv_mask=None if kv_mask is None else jnp.asarray(kv_mask))
    assert _err(out, ref) < TOL


def test_init_scales():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, 256, 512, lead=(2,))
    assert w.shape == (2, 256, 512) and w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / 16) < 2e-3
    e = TL.embed_init(g, 1000, 64)
    assert abs(float(e.std()) - 0.02) < 1e-3
