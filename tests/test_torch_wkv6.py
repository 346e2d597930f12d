"""The port's WKV recurrence against the JAX package's.

On the CPU ``repro_torch.kernels.wkv6.wkv6`` takes its plain version
(``ref.wkv6_ref``, the sequential scan).  It is held against:

- the Pallas kernel ``repro.kernels.rwkv_scan.wkv6`` run in interpret mode
  at the sweep of tests/test_kernels.py::test_wkv6_sweep (T 128/256, chunk
  32/64/128, hd 32/64; B and H cut to keep each interpret call short), at
  that test's tolerance 2e-4: the chunked form sums in another order and
  through exp(+-cum) factors;
- JAX ``wkv_scan`` (from zero state) and ``_wkv_with_init`` (from a given
  state), for the outputs and the final state, at T 1, 7, 12 and 130 (no
  chunk multiple): the same sequential sums in f32, another order of the
  einsum's terms, so 1e-5 from zero state and 4e-5 from a given state of
  entries up to ~8 (the same relative error).

``ref.wkv6_chunked_plain``, the plain twin of the ``chunked`` kernel's
arithmetic (sub-chunks of 16 tokens, decays as running products of w, the
last sub-chunk partial), is held against ``wkv6_ref`` at any T from zeros
and from a state (the same f32 sums in another order: the tolerances
above), against JAX ``wkv_chunked`` and the Pallas kernel where those run
(T a multiple of their chunk, zero state) at 2e-4, and on strong decays
(w down to 1e-38), where it stays finite and the split exp(cum) factors
of ``wkv_chunked`` overflow.  ``wkv_variant`` is held to its rule.

``ref.wkv6_bwd_plain``, the sequential oracle of the backward kernels (the
state kept every 64 tokens, each stretch's states recomputed forward from
it and walked back token by token, no division by w), is held
against ``jax.vjp`` of JAX ``wkv_scan`` (zero state, the final state
unused) for dr, dk, dv, dw and du, with T under and over a chunk, hd 32 and
64, and strong decays (w down to 1e-38), in f32 within 1e-4 of max(1, the
largest reference value): sums over T and hd in another order.
``ref.wkv6_bwd_chunked_plain``, the plain twin of the chunk-parallel
kernels (S at every 64-token chunk start, G = dL/dS at every chunk end, each
chunk's outputs from those two with the within-sub-chunk decays built from
1), is held against the same ``jax.vjp`` at T 1, 63, 64, 65 and 300, hd 32
and 64, in f64 and f32 within 1e-4 of max(1, |ref|) (JAX's scan computes in
f32 whatever it is given), in f64 also against the sequential twin within
1e-10, and on strong decays, where every gradient stays finite.

Inputs are drawn with numpy from a seed, as the JAX sweep draws them.  The
CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rwkv_scan as JWK
from repro.models import rwkv as JRW
from repro_torch.kernels import ref as TR
from repro_torch.kernels import wkv6 as TWK
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PALLAS_TOL = 2e-4
SCAN_TOL = 1e-5
STATE_TOL = 4e-5


def _inputs(seed, b, t, h, hd):
    """r, k, v ~ N(0, 0.25), w = exp(-exp(N(0, 0.25) - 2)), u ~ 0.2 N(0, 0.25)
    (tests/test_kernels.py::test_wkv6_sweep), and a state of the size a
    few hundred tokens of such decays build up."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    r, k, v = rnd(b, t, h, hd), rnd(b, t, h, hd), rnd(b, t, h, hd)
    w = np.exp(-np.exp(rnd(b, t, h, hd) - 2)).astype(np.float32)
    u = rnd(h, hd) * 0.2
    s0 = rnd(b, h, hd, hd) * 4
    return r, k, v, w, u, s0


def _err(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return float(np.abs(a - np.asarray(b, np.float32)).max())


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t,chunk", [(128, 32), (256, 64), (256, 128)])
@pytest.mark.parametrize("hd", [32, 64])
def test_plain_wkv6_matches_pallas_kernel(t, chunk, hd):
    r, k, v, w, u, _ = _inputs(t + hd, 1, t, 2, hd)
    before = TWK.wkv6.launches
    out, s = TWK.wkv6(*_t(r, k, v, w, u))
    assert TWK.wkv6.launches == before           # the CPU path launches no kernel
    assert out.dtype == s.dtype == torch.float32
    assert out.shape == (1, t, 2, hd) and s.shape == (1, 2, hd, hd)
    pallas = JWK.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk,
                      interpret=True)
    assert _err(out, pallas) < PALLAS_TOL


@pytest.mark.parametrize("t", [1, 7, 12, 130])
@pytest.mark.parametrize("hd", [32, 64])
def test_plain_wkv6_matches_jax_scan_from_zero_and_from_a_state(t, hd):
    r, k, v, w, u, s0 = _inputs(t * hd, 2, t, 3, hd)
    j_in = [jnp.asarray(a) for a in (r, k, v, w, u)]
    out, s = TWK.wkv6(*_t(r, k, v, w, u))
    j_out, j_s = JRW.wkv_scan(*j_in)
    assert _err(out, j_out) < SCAN_TOL and _err(s, j_s) < SCAN_TOL
    state = torch.from_numpy(s0.copy())
    out, s = TWK.wkv6(*_t(r, k, v, w, u), state=state)
    j_out, j_s = JRW._wkv_with_init(*j_in, jnp.asarray(s0))
    assert s is state                             # the final state went in place
    assert _err(out, j_out) < STATE_TOL and _err(s, j_s) < STATE_TOL


def test_wkv6_ref_reads_its_state_and_matches_the_wrapper():
    """``wkv6_ref`` never writes its state; the wrapper writes the same final
    state in place that the oracle returns out of place."""
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(3, 2, 9, 2, 32))
    keep = s0.clone()
    out_ref, s_ref = TR.wkv6_ref(r, k, v, w, u, s0)
    assert torch.equal(s0, keep)
    out, s = TWK.wkv6(r, k, v, w, u, state=s0)
    assert s is s0 and torch.equal(s, s_ref) and torch.equal(out, out_ref)


def test_state_carries_across_calls():
    """T tokens at once equal T1 tokens then T - T1 from the carried state
    (prefill then decode, token by token)."""
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _inputs(4, 2, 10, 2, 32))
    out_all, s_all = TWK.wkv6(r, k, v, w, u)
    state = torch.zeros_like(s_all)
    outs = [TWK.wkv6(r[:, :6], k[:, :6], v[:, :6], w[:, :6], u, state)[0]]
    for i in range(6, 10):
        sl = slice(i, i + 1)
        outs.append(TWK.wkv6(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, state)[0])
    assert _err(torch.cat(outs, 1), out_all) < SCAN_TOL
    assert _err(state, s_all) < SCAN_TOL


def test_wkv6_ref_computes_in_f64_for_f64_and_in_f32_for_bf16():
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _inputs(5, 1, 5, 2, 32))
    out64, s64 = TR.wkv6_ref(r.double(), k.double(), v.double(), w.double(), u.double())
    assert out64.dtype == s64.dtype == torch.float64
    out16, _ = TWK.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    assert out16.dtype == torch.float32
    want, _ = TR.wkv6_ref(*(x.bfloat16().float() for x in (r, k, v)), w, u)
    assert torch.equal(out16, want)


def test_wkv6_plain_version_differentiates_on_the_cpu():
    """RWKV training on the CPU runs autograd through the plain version."""
    args = [torch.from_numpy(a).double().requires_grad_()
            for a in _inputs(6, 1, 4, 2, 4)[:5]]
    assert torch.autograd.gradcheck(lambda *a: TWK.wkv6(*a)[0], args)


@pytest.mark.parametrize("case", ["rank", "k_shape", "u_shape", "state_shape", "empty"])
def test_wkv6_refuses_bad_shapes(case):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(7, 2, 3, 2, 32))
    args = {"rank": (r[0], k[0], v[0], w[0], u, None),
            "k_shape": (r, k[:, :2], v, w, u, None),
            "u_shape": (r, k, v, w, u[:1], None),
            "state_shape": (r, k, v, w, u, s0[:1]),
            "empty": (r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, None)}[case]
    with pytest.raises(ValueError):
        TWK.wkv6(*args)


def test_wkv6_never_runs_plain_version_off_the_cpu():
    """The CPU path is chosen by the tensors' device alone; off the CPU the
    forward and the backward launch their kernels or raise, tensors that
    need grad too (there is no fallback to the plain version)."""
    def meta(*shape, grad=False):
        return torch.zeros(shape, device="meta", requires_grad=grad)

    with pytest.raises(ValueError, match="CUDA"):
        TWK.wkv6(*(meta(1, 2, 2, 32),) * 4, meta(2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        TWK.wkv6(*(meta(1, 2, 2, 32),) * 4, torch.zeros(2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        TWK.wkv6(meta(1, 2, 2, 32, grad=True), *(meta(1, 2, 2, 32),) * 3, meta(2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        TWK.wkv6_bwd(*(meta(1, 2, 2, 32),) * 4, meta(2, 32), meta(1, 2, 2, 32))


@pytest.mark.parametrize("t", [1, 7, 63, 64, 65, 130, 512])
@pytest.mark.parametrize("from_state", [False, True])
def test_chunked_plain_matches_scan(t, from_state):
    """The chunked twin against the sequential oracle at any T, the last
    sub-chunk partial, from zeros and from a state."""
    b, h, hd = (1, 2, 32) if t == 512 else (2, 3, 32)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(t + 11, b, t, h, hd))
    state = s0 if from_state else None
    keep = s0.clone()
    out, s = TR.wkv6_chunked_plain(r, k, v, w, u, state)
    want_out, want_s = TR.wkv6_ref(r, k, v, w, u, state)
    tol = STATE_TOL if from_state else SCAN_TOL
    assert out.shape == (b, t, h, hd) and s.shape == (b, h, hd, hd)
    assert _err(out, want_out) < tol and _err(s, want_s) < tol
    assert torch.equal(s0, keep)                  # the twin reads its state, never writes it


@pytest.mark.parametrize("t,chunk,hd", [(128, 32, 32), (128, 64, 64), (256, 128, 64)])
def test_chunked_plain_matches_jax_chunked_and_pallas(t, chunk, hd):
    r, k, v, w, u, _ = _inputs(t + chunk + hd, 1, t, 2, hd)
    out, s = TR.wkv6_chunked_plain(*_t(r, k, v, w, u))
    j_in = [jnp.asarray(a) for a in (r, k, v, w, u)]
    j_out, j_s = JRW.wkv_chunked(*j_in, chunk=chunk)
    assert _err(out, j_out) < PALLAS_TOL and _err(s, j_s) < PALLAS_TOL
    pallas = JWK.wkv6(*j_in, chunk=chunk, interpret=True)
    assert _err(out, pallas) < PALLAS_TOL


def test_chunked_plain_stays_finite_on_strong_decays():
    """w in [1e-38, 1e-3]: log w down to -87.5 a token.  Every factor of the
    twin is a product of w's, at most 1, so it stays finite and matches the
    scan; the split exp(cum_t) * exp(-cum_s) of JAX ``wkv_chunked``
    overflows within a chunk of such tokens."""
    rng = np.random.default_rng(12)
    r, k, v, _, u, s0 = _inputs(12, 2, 64, 2, 32)
    w = np.exp(rng.uniform(np.log(1e-38), np.log(1e-3), r.shape)).astype(np.float32)
    for state in (None, torch.from_numpy(s0)):
        out, s = TR.wkv6_chunked_plain(*_t(r, k, v, w, u), state)
        want_out, want_s = TR.wkv6_ref(*_t(r, k, v, w, u), state)
        assert torch.isfinite(out).all() and torch.isfinite(s).all()
        assert _err(out, want_out) < STATE_TOL and _err(s, want_s) < STATE_TOL
    j_out, _ = JRW.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=32)
    assert not np.isfinite(np.asarray(j_out)).all()


@pytest.mark.parametrize("t,offset,want", [(1, 0, "scan"), (15, 0, "scan"), (16, 0, "chunked"),
                                           (512, 0, "chunked"), (512, 1, "scan"),
                                           (64, 4, "chunked")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_variant_takes_chunked_from_one_sub_chunk_on_aligned_inputs(t, offset, want, dtype):
    """Prefill of at least one sub-chunk with 16-byte aligned bases runs the
    chunked form; a decode step, a short T and a base off 16 bytes run the
    scan.  ``offset`` shifts r's base by that many elements."""
    assert TWK.CHUNKED_MIN_T == 16
    shape = (2, t, 3, 32)
    store = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    r = store[offset:].view(shape)
    k, v = torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype)
    w = torch.ones(shape)
    aligned = (offset * r.element_size()) % 16 == 0
    assert TWK.wkv_variant(r, k, v, w) == (want if aligned or want == "scan" else "scan")


def test_cpu_path_counts_no_variant():
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _inputs(8, 1, 32, 2, 32))
    before = dict(TWK.wkv6.variant_launches)
    TWK.wkv6(r, k, v, w, u)
    assert TWK.wkv6.variant_launches == before
    assert set(before) == set(TWK.VARIANTS) == {"scan", "chunked"}


# B, T, H, hd, decays of the backward: T under one sub-chunk, over a
# sub-chunk and under the chunk, over two chunks (the last one partial),
# hd 32 and 64, strong decays across a chunk boundary
BWD_CASES = [(2, 5, 2, 32, "sweep"), (1, 40, 2, 64, "sweep"), (1, 130, 1, 32, "sweep"),
             (1, 70, 2, 64, "strong")]
BWD_TOL = 1e-4


@pytest.mark.parametrize("b,t,h,hd,decay", BWD_CASES)
def test_wkv6_bwd_plain_matches_jax_vjp(b, t, h, hd, decay):
    r, k, v, w, u, _ = _inputs(t * hd + b, b, t, h, hd)
    rng = np.random.default_rng(t)
    if decay == "strong":
        w = np.exp(rng.uniform(np.log(1e-38), np.log(1e-3), r.shape)).astype(np.float32)
    do = (rng.standard_normal(r.shape) * 0.5).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: JRW.wkv_scan(*a)[0], *(jnp.asarray(a) for a in (r, k, v, w, u)))
    want = vjp(jnp.asarray(do))
    before = TWK.wkv6_bwd.launches
    got = TWK.wkv6_bwd(*_t(r, k, v, w, u, do))
    assert TWK.wkv6_bwd.launches == before        # the CPU path launches no kernel
    assert [g.shape for g in got] == [r.shape] * 4 + [u.shape]
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert torch.isfinite(g).all(), name
        x = np.asarray(x, np.float64)
        err = float(np.abs(g.double().numpy() - x).max()) / max(1.0, float(np.abs(x).max()))
        assert err < BWD_TOL, (name, err)
    # the kernels' arithmetic agrees with autograd through the plain scan
    args = [a.requires_grad_() for a in _t(r, k, v, w, u)]
    auto = torch.autograd.grad(TWK.wkv6(*args)[0], args, torch.from_numpy(do))
    assert all(_err(g, a) < BWD_TOL for g, a in zip(got, auto))


F64_TWIN_TOL = 1e-10   # the two plain backwards in f64: round-off apart


def _jax_vjp(r, k, v, w, u, do):
    """``jax.vjp`` of JAX ``wkv_scan`` (zero state, the final state unused)."""
    _, vjp = jax.vjp(lambda *a: JRW.wkv_scan(*a)[0], *(jnp.asarray(a) for a in (r, k, v, w, u)))
    return [np.asarray(x, np.float64) for x in vjp(jnp.asarray(do))]


def _bwd_case(seed, b, t, h, hd, strong=False):
    r, k, v, w, u, _ = _inputs(seed, b, t, h, hd)
    rng = np.random.default_rng(seed + 1)
    if strong:
        w = np.exp(rng.uniform(np.log(1e-38), np.log(1e-3), r.shape)).astype(np.float32)
    do = (rng.standard_normal(r.shape) * 0.5).astype(np.float32)
    return r, k, v, w, u, do


def _check_chunked_bwd(inputs, dtype):
    args = [torch.from_numpy(a).to(dtype) for a in inputs]
    got = TR.wkv6_bwd_chunked_plain(*args)
    want = _jax_vjp(*inputs)
    r = inputs[0]
    assert [g.shape for g in got] == [r.shape] * 4 + [inputs[4].shape]
    assert all(g.dtype == dtype for g in got)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert torch.isfinite(g).all(), name
        err = float(np.abs(g.double().numpy() - x).max()) / max(1.0, float(np.abs(x).max()))
        assert err < BWD_TOL, (name, err)
    if dtype == torch.float64:
        for name, g, x in zip(("dr", "dk", "dv", "dw", "du"), got, TR.wkv6_bwd_plain(*args)):
            err = float((g - x).abs().max()) / max(1.0, float(x.abs().max()))
            assert err < F64_TWIN_TOL, (name, err)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wkv6_bwd_chunked_plain_matches_jax_vjp(t, hd, dtype):
    """The chunk-parallel algebra against ``jax.vjp``: T under a sub-chunk,
    one token short of, at and one past the 64-token chunk, and over four
    chunks with the last one partial."""
    _check_chunked_bwd(_bwd_case(t + hd, 1, t, 2, hd), dtype)


@pytest.mark.parametrize("t,hd", [(65, 32), (300, 64)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wkv6_bwd_chunked_plain_stays_finite_on_strong_decays(t, hd, dtype):
    """w in [1e-38, 1e-3]: every decay of the twin is a product of w's from
    1 (no division by w, which underflows here), so every gradient stays
    finite and matches ``jax.vjp``."""
    _check_chunked_bwd(_bwd_case(t * 3 + hd, 1, t, 2, hd, strong=True), dtype)


def test_wkv6_bwd_chunked_plain_equals_the_sequential_twin_in_f64():
    """The two plain backwards, sequential and chunk-parallel, agree to f64
    round-off over several chunks, the last one partial."""
    inputs = [torch.from_numpy(a).double() for a in _bwd_case(5, 2, 150, 2, 32)]
    for a, b in zip(TR.wkv6_bwd_chunked_plain(*inputs), TR.wkv6_bwd_plain(*inputs)):
        assert float((a - b).abs().max()) < F64_TWIN_TOL * max(1.0, float(b.abs().max()))
