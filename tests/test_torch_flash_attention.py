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


def _laid_out(shape, dtype, layout):
    """A zero tensor of ``shape`` in one of the layouts the kernel meets:
    contiguous; d-stride 2; rows padded by 4 elements (row strides no
    multiple of 8); a base 8 or 3 elements into its storage."""
    b, t, h, hd = shape
    if layout == "contiguous":
        return torch.zeros(shape, dtype=dtype)
    if layout == "d-stride 2":
        return torch.zeros((b, t, h, 2 * hd), dtype=dtype)[..., ::2]
    if layout == "rows padded by 4":
        return torch.zeros((b, t, h, hd + 4), dtype=dtype)[..., :hd]
    off = {"offset 8": 8, "offset 3": 3}[layout]
    n = b * t * h * hd
    return torch.zeros(n + off, dtype=dtype)[off:].view(shape)


LAYOUTS = ["contiguous", "d-stride 2", "rows padded by 4", "offset 8", "offset 3"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("h,hkv,tq", [(16, 1, 1), (4, 1, 4), (8, 8, 16),    # rep * Tq = 16
                                      (8, 8, 17), (1, 1, 17), (32, 8, 5)])  # 17, 17, 20
def test_variant_choice(dtype, layout, hd, h, hkv, tq):
    """bf16 rows that take 16-byte async copies go to the tensor cores, the
    packed decode tile while (H / Hkv) * Tq fits 16 rows; all else to FMA."""
    q = _laid_out((2, tq, h, hd), dtype, layout)
    k, v = (_laid_out((2, 9, hkv, hd), dtype, layout) for _ in range(2))
    aligned = layout in ("contiguous", "offset 8")
    if dtype == torch.float32 or not aligned:
        want = "fma"
    else:
        want = "tc_decode" if (h // hkv) * tq <= 16 else "tc_prefill"
    assert TFA.flash_variant(q, k, v) == want
    # the variant choice never reaches the CPU path: no launch, plain result
    before = dict(TFA.flash_attention.variant_launches)
    out = TFA.flash_attention(q, k, v, causal=False)
    assert TFA.flash_attention.variant_launches == before
    assert out.shape == q.shape and out.dtype == dtype


def test_variant_choice_one_misaligned_operand():
    """Any one of q, k, v that cannot take 16-byte copies sends the call to
    the FMA kernel; a strided cache view stays on the tensor cores."""
    bf = torch.bfloat16
    q, k, v = (torch.zeros(s, dtype=bf) for s in ((2, 1, 8, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    assert TFA.flash_variant(q, k[:, :17], v[:, :17]) == "tc_decode"
    assert TFA.flash_variant(q, k, _laid_out(v.shape, bf, "offset 3")) == "fma"
    assert TFA.flash_variant(_laid_out(q.shape, bf, "offset 3"), k, v) == "fma"
    assert TFA.flash_variant(q, k.float(), v) == "fma"


@pytest.mark.parametrize("b,hkv,n_tiles,n_sm", [(4, 8, 9, 132), (1, 1, 1, 132),
                                                (64, 8, 100, 132), (1, 2, 63, 132),
                                                (2, 8, 17, 16), (3, 1, 1000, 132)])
def test_decode_split_covers_every_tile_once(b, hkv, n_tiles, n_sm):
    n_split, per = TFA.decode_split(b, hkv, n_tiles, n_sm)
    assert n_split >= 1 and per >= 1
    assert (n_split - 1) * per < n_tiles <= n_split * per       # no empty split
    assert n_split == 1 or b * hkv * n_split <= n_sm + b * hkv   # ~ one block an SM
    if (b, hkv, n_tiles) == (4, 8, 9):      # Llama / Granite decode at Tk 513
        assert (n_split, per) == (5, 2)


@pytest.mark.parametrize("seed", range(6))
def test_combine_partials_matches_attention_ref(seed):
    """The decode tile's merge of per-split (m, l, acc) over random key
    splits gives dense attention (the plain version of the kernel's last
    block), GQA, masks and all-masked splits included."""
    rng = np.random.default_rng(seed)
    h, hkv = [(8, 2), (4, 4), (16, 8)][seed % 3]
    tq, tk = int(rng.integers(1, 6)), int(rng.integers(2, 200))
    causal, window = bool(seed % 2), int(rng.integers(0, 4)) * (seed > 2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed, 2, tq, tk, h, hkv, 64))
    cuts = np.sort(rng.choice(np.arange(1, tk), size=min(tk - 1, int(rng.integers(1, 9))),
                              replace=False))
    bounds = list(zip([0, *cuts.tolist()], [*cuts.tolist(), tk]))
    m, l, acc = TFA.attention_partials(q, k, v, bounds, causal=causal, window=window)
    got = TFA.combine_partials(m, l, acc)
    want = TFA.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert _err(got.numpy(), want.numpy()) < F32_TOL
    if hkv == h:
        jref = np.asarray(JR.attention_ref(q.numpy(), k.numpy(), v.numpy(), causal=causal,
                                           window=window))
        assert _err(got.numpy(), jref) < F32_TOL
