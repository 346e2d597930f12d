"""The port's flash attention against the JAX package's.

On the CPU ``repro_torch.kernels.flash_attention`` takes its plain version;
it is held against the Pallas kernel run in interpret mode (as
tests/test_kernels.py runs it), against ``repro.kernels.ref.attention_ref``
and, for grouped-query and decode-style calls, against
``repro.models.layers.attention``.  Tolerances are those of
tests/test_kernels.py: 2e-5 at fp32, 2e-2 at bf16.  The CUDA kernel itself is
held against the plain version on the card in tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ref as TR

F32_TOL, BF16_TOL = 2e-5, 2e-2


def _qkv(seed, b, tq, tk, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, hd), dtype=np.float32),
            rng.standard_normal((b, tk, hkv, hd), dtype=np.float32),
            rng.standard_normal((b, tk, hkv, hd), dtype=np.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    out = TFA.flash_attention(torch.from_numpy(q).to(dtype),
                              torch.from_numpy(k).to(dtype),
                              torch.from_numpy(v).to(dtype), **kw)
    return out.float().numpy()


def _pallas(q, k, v, dtype=jnp.float32, **kw):
    out = JFA.flash_attention(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                              jnp.asarray(v, dtype), block_q=64, block_k=64,
                              interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _err(a, b):
    return float(np.abs(a - b).max())


@pytest.mark.parametrize("b,t,h,hd", [(1, 70, 2, 32), (2, 130, 2, 32),
                                      (1, 7, 2, 32), (1, 1, 2, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0)])
def test_plain_matches_pallas_edge_shapes(b, t, h, hd, causal, window):
    q, k, v = _qkv(t * 7 + window, b, t, t, h, h, hd)
    out = _port(q, k, v, causal=causal, window=window)
    assert out.shape == (b, t, h, hd)
    assert _err(out, _pallas(q, k, v, causal=causal, window=window)) < F32_TOL
    ref = np.asarray(JR.attention_ref(q, k, v, causal=causal, window=window))
    assert _err(out, ref) < F32_TOL


@pytest.mark.parametrize("tq,tk,causal", [(100, 260, False), (40, 100, True),
                                          (90, 20, True)])
def test_plain_matches_pallas_cross_lengths(tq, tk, causal):
    """Tq != Tk: the causal mask is aligned top-left in both packages."""
    q, k, v = _qkv(tq + tk, 2, tq, tk, 2, 2, 64)
    out = _port(q, k, v, causal=causal)
    assert _err(out, _pallas(q, k, v, causal=causal)) < F32_TOL
    ref = np.asarray(JR.attention_ref(q, k, v, causal=causal))
    assert _err(out, ref) < F32_TOL


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_plain_matches_pallas_bf16(causal, window):
    q, k, v = _qkv(11, 2, 80, 80, 2, 2, 64)
    out = _port(q, k, v, torch.bfloat16, causal=causal, window=window)
    pallas = _pallas(q, k, v, jnp.bfloat16, causal=causal, window=window)
    assert _err(out, pallas) < BF16_TOL
    ref = np.asarray(JR.attention_ref(jnp.asarray(q, jnp.bfloat16),
                                      jnp.asarray(k, jnp.bfloat16),
                                      jnp.asarray(v, jnp.bfloat16),
                                      causal=causal, window=window
                                      ).astype(jnp.float32))
    assert _err(out, ref) < BF16_TOL


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (4, 4)])
def test_gqa_matches_jax_layers_attention(h, hkv):
    """Native GQA (KV head h // (H/Hkv)) equals the JAX model's repeat_kv
    path in ``layers.attention`` (causal prefill)."""
    q, k, v = _qkv(h * 10 + hkv, 2, 33, 33, h, hkv, 32)
    out = _port(q, k, v, causal=True)
    ref = np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True))
    assert _err(out, ref) < F32_TOL


def test_decode_prefix_view_matches_jax_kv_mask():
    """The port's decode call (insert first, then attend non-causally over
    the valid prefix, a strided view of the cache) sees the same keys as the
    JAX decode path's kv_mask over the whole buffer."""
    b, cap, h, hkv, hd, n = 2, 40, 8, 2, 64, 17
    q, k, v = _qkv(5, b, 1, cap, h, hkv, hd)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    out = TFA.flash_attention(torch.from_numpy(q), kt[:, :n], vt[:, :n],
                              causal=False).numpy()
    kv_mask = jnp.broadcast_to(jnp.arange(cap) < n, (b, cap))
    ref = np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=False, kv_mask=kv_mask))
    assert _err(out, ref) < F32_TOL
    # the trap: causal=True with Tq = 1 would see key 0 only
    wrong = TFA.flash_attention(torch.from_numpy(q), kt[:, :n], vt[:, :n],
                                causal=True).numpy()
    assert _err(wrong, ref) > 1e-2


def test_port_attention_ref_matches_jax_ref():
    q, k, v = _qkv(3, 2, 24, 24, 2, 2, 32)
    for causal, window in ((True, 0), (True, 5), (False, 0), (False, 4)):
        out = TR.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window).numpy()
        ref = np.asarray(JR.attention_ref(q, k, v, causal=causal, window=window))
        assert _err(out, ref) < F32_TOL


@pytest.mark.parametrize("shapes,exc", [
    (((1, 4, 4, 32), (1, 4, 3, 32), (1, 4, 3, 32)), ValueError),   # 4 % 3
    (((1, 4, 4, 32), (1, 4, 2, 16), (1, 4, 2, 16)), ValueError),   # head_dim
    (((1, 4, 4, 32), (1, 4, 2, 32), (1, 5, 2, 32)), ValueError),   # k != v
    (((4, 4, 32), (1, 4, 2, 32), (1, 4, 2, 32)), ValueError),      # rank
])
def test_wrapper_rejects_bad_inputs(shapes, exc):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(exc):
        TFA.flash_attention(q, k, v)


def test_cpu_path_takes_plain_version_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 9, 9, 4, 2, 32))
    before = TFA.flash_attention.launches
    out = TFA.flash_attention(q, k, v)
    assert TFA.flash_attention.launches == before
    assert torch.equal(out, TFA.flash_attention_ref(q, k, v))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fall back to the plain
    version."""
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("flash_attention")
    with pytest.raises(FileNotFoundError):
        build.build("no_such_kernel")
