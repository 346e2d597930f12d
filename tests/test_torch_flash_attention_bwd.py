"""The port's flash-attention backward (plain version) against the JAX package.

The JAX package has no backward kernel: its models differentiate
``repro.models.layers.attention``.  So ``flash_attention_bwd_plain`` (the
plain version of the CUDA backward kernels, P recomputed from the forward's
log-sum-exp) is held against ``jax.vjp`` of that function, and
``flash_attention_lse_plain`` against JAX's logsumexp of the scaled, masked
scores, in f32 within 2e-5 of max(1, the largest reference value), the
forward's f32 tolerance.  The cases include rows that see no key (a window
with Tq > Tk), whose forward averages V under the finite -1e30 mask.  The
plain backward is also held against torch.autograd through
``flash_attention_ref``.  The CUDA kernels themselves are held against the
plain version on the card in tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as TFA
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = 2e-5

# B, Tq, Tk, H, Hkv, hd, causal, window: T 1 and 17, GQA rep 1, 2 and 4, the
# three head dims, Tq != Tk both ways, windows, and rows that see no key
# (window > 0 and Tq >= Tk + window: rows from Tk + window - 1 on)
CASES = [(1, 1, 1, 2, 2, 32, True, 0), (2, 17, 17, 4, 2, 64, True, 0),
         (1, 17, 17, 4, 1, 32, True, 5), (1, 4, 4, 8, 2, 64, True, 0),
         (2, 20, 45, 4, 2, 128, False, 0), (1, 40, 24, 2, 2, 64, True, 0),
         (2, 33, 20, 2, 1, 64, False, 4), (1, 30, 12, 4, 4, 32, True, 3)]


def _inputs(seed, b, tq, tk, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, hd), dtype=np.float32),
            rng.standard_normal((b, tk, hkv, hd), dtype=np.float32),
            rng.standard_normal((b, tk, hkv, hd), dtype=np.float32),
            rng.standard_normal((b, tq, h, hd), dtype=np.float32))


def _rel_err(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _jax_lse(q, k, causal, window):
    """logsumexp of the scaled scores under layers.attention's mask (-1e30)."""
    tq, tk, hd = q.shape[1], k.shape[1], q.shape[-1]
    k = JL.repeat_kv(jnp.asarray(k), q.shape[2] // k.shape[2])
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), k) / np.sqrt(hd)
    qpos, kpos = jnp.arange(tq)[:, None], jnp.arange(tk)[None, :]
    mask = jnp.ones((tq, tk), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return jax.nn.logsumexp(jnp.where(mask, s, JL.NEG_INF), axis=-1)


def _plain(q, k, v, do, causal, window):
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o = TFA.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = TFA.flash_attention_lse_plain(q, k, causal=causal, window=window)
    return lse, TFA.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                              window=window)


@pytest.mark.parametrize("b,tq,tk,h,hkv,hd,causal,window", CASES)
def test_plain_backward_matches_jax_vjp(b, tq, tk, h, hkv, hd, causal, window):
    q, k, v, do = _inputs(tq * 31 + tk + window, b, tq, tk, h, hkv, hd)
    lse, grads = _plain(q, k, v, do, causal, window)

    want_lse = np.asarray(_jax_lse(q, k, causal, window))
    dead = want_lse < -1e29                       # rows that see no key
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    assert bool(dead.any()) == (window > 0 and tq >= tk + window)
    assert np.array_equal(lse.numpy() < -1e29, dead)
    assert _rel_err(lse.numpy()[~dead], want_lse[~dead]) < TOL

    _, vjp = jax.vjp(lambda q_, k_, v_: JL.attention(q_, k_, v_, causal=causal,
                                                     window=window), q, k, v)
    for name, got, want in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(do))):
        assert got.shape == want.shape and got.dtype == torch.float32, name
        assert _rel_err(got, want) < TOL, name


@pytest.mark.parametrize("b,tq,tk,h,hkv,hd,causal,window", CASES[1::2])
def test_plain_backward_matches_autograd_of_ref(b, tq, tk, h, hkv, hd, causal, window):
    """The same gradients as torch.autograd through the plain forward, which
    is what ``flash_attention`` differentiates on CPU tensors."""
    q, k, v, do = _inputs(tq + tk * 7 + window, b, tq, tk, h, hkv, hd)
    _, grads = _plain(q, k, v, do, causal, window)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = TFA.flash_attention(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for got, w in zip(grads, want):
        assert _rel_err(got, w) < TOL


def test_backward_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(0, 1, 9, 9, 4, 2, 32))
    o = TFA.flash_attention(q, k, v)
    lse = TFA.flash_attention_lse_plain(q, k)
    before = TFA.flash_attention_bwd.launches
    got = TFA.flash_attention_bwd(q, k, v, o, do, lse)
    want = TFA.flash_attention_bwd_plain(q, k, v, o, do, lse)
    assert TFA.flash_attention_bwd.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="lse"):
        TFA.flash_attention_bwd(q, k, v, o, do, lse[:, :, :-1])
    with pytest.raises(ValueError, match="dO"):
        TFA.flash_attention_bwd(q, k, v, o, do[:, :-1], lse)


def test_variants_with_lse_never_take_the_decode_tile():
    """A forward that writes lse (under autograd) runs the prefill tile where
    the wrapper would otherwise pack the rows into the decode tile; the
    backward's variant follows the dtype and the rows' alignment."""
    q = torch.zeros((2, 3, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 40, 2, 64), dtype=torch.bfloat16)
    assert TFA.flash_variant(q, k, k) == "tc_decode"
    assert TFA.flash_variant(q, k, k, want_lse=True) == "tc_prefill"
    assert TFA.flash_variant(q.float(), k.float(), k.float(), want_lse=True) == "fma"
    assert TFA.flash_bwd_variant(q, k, k, q, q) == "tc"
    assert TFA.flash_bwd_variant(q.float(), k.float(), k.float(), q.float(), q.float()) == "fma"
    head_major = q.transpose(1, 2).contiguous().transpose(1, 2)    # strides of 8-multiples
    assert TFA.flash_bwd_variant(q, k, k, q, head_major) == "tc"
    misaligned = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    assert TFA.flash_bwd_variant(q, k, k, q, misaligned) == "fma"
