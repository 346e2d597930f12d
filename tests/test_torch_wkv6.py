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

Inputs are drawn with numpy from a seed, as the JAX sweep draws them.  The
CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rwkv_scan as JWK
from repro.models import rwkv as JRW
from repro_torch.kernels import ref as TR
from repro_torch.kernels import wkv6 as TWK

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
    """The CPU path is chosen by the tensors' device alone; off the CPU a
    tensor that needs grad is refused first (the kernel has no backward)."""
    def meta(*shape, grad=False):
        return torch.zeros(shape, device="meta", requires_grad=grad)

    with pytest.raises(ValueError, match="CUDA"):
        TWK.wkv6(*(meta(1, 2, 2, 32),) * 4, meta(2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        TWK.wkv6(*(meta(1, 2, 2, 32),) * 4, torch.zeros(2, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 17"):
        TWK.wkv6(meta(1, 2, 2, 32, grad=True), *(meta(1, 2, 2, 32),) * 3, meta(2, 32))
