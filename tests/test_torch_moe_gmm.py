"""The port's grouped matmul against the JAX package's.

On the CPU ``repro_torch.kernels.moe_gmm.gmm`` takes its plain twin
(``ref.gmm_ref``).  It is held against the Pallas kernel run in interpret
mode (as tests/test_kernels.py runs it, blocks of 64 so that C, d and F are
padded there) and against ``repro.kernels.ref.gmm_ref``, on the same inputs
drawn with numpy.  Tolerances are those of
tests/test_kernels.py::test_gmm_sweep: 1e-4 at fp32, 5e-2 at bf16.  The
backward's plain twin ``ref.gmm_bwd_plain`` (``gmm_bwd`` on the CPU) is held
against ``jax.vjp`` of ``repro.kernels.ref.gmm_ref`` in f32 within 1e-4 of
max(1, the largest reference value): sums of up to C or F terms in another
order.  The CUDA kernels themselves are held against the plain twins on the
card in tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_gmm as JGM
from repro.kernels import ref as JR
from repro_torch.kernels import moe_gmm as TGM
from repro_torch.kernels import ref as TR
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SHAPES = [(8, 37, 130, 70), (2, 64, 64, 64), (3, 1, 5, 9)]   # G, C, d, F


def _inputs(seed, g, c, d, f):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((g, c, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((g, d, f)) * 0.1).astype(np.float32)
    return x, w


def _err(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return float(np.abs(a - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,c,d,f", SHAPES)
def test_plain_gmm_matches_pallas_and_ref(g, c, d, f, dtype):
    x, w = _inputs(g * c + d, g, c, d, f)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    jx, jw = (jnp.asarray(a).astype(dtype) for a in (x, w))
    before = TGM.gmm.launches
    out = TGM.gmm(tx, tw)
    assert TGM.gmm.launches == before        # the CPU path launches no kernel
    assert out.shape == (g, c, f) and out.dtype == tx.dtype
    pallas = JGM.gmm(jx, jw, block_c=64, block_f=64, block_d=64, interpret=True)
    for theirs in (pallas, JR.gmm_ref(jx, jw)):
        assert _err(out, theirs.astype(jnp.float32)) < TOL[dtype]
    assert torch.equal(out, TR.gmm_ref(tx, tw))


def test_gmm_plain_version_differentiates_on_the_cpu():
    """MoE training on the CPU runs autograd through the plain version."""
    x, w = (torch.from_numpy(a).double().requires_grad_() for a in _inputs(1, 2, 3, 4, 5))
    assert torch.autograd.gradcheck(TGM.gmm, (x, w))


@pytest.mark.parametrize("x_shape,w_shape,err", [
    ((2, 3, 4), (3, 4, 5), ValueError),       # group counts differ
    ((2, 3, 4), (2, 5, 6), ValueError),       # contraction differs
    ((2, 3), (2, 3, 4), ValueError),          # not (G, C, d)
    ((2, 0, 4), (2, 4, 5), ValueError)])      # empty
def test_gmm_refuses_bad_shapes(x_shape, w_shape, err):
    with pytest.raises(err):
        TGM.gmm(torch.zeros(x_shape), torch.zeros(w_shape))


def test_gmm_never_runs_plain_version_off_the_cpu():
    """The CPU path is chosen by the tensors' device alone."""
    x = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TGM.gmm(x, torch.zeros((2, 4, 5), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        TGM.gmm(x, torch.zeros((2, 4, 5)))


def _at_offset(shape, dtype, off):
    """A contiguous zero tensor of ``shape`` whose base is ``off`` elements
    into its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + off, dtype=dtype)[off:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 4, 16, 17, 128])
@pytest.mark.parametrize("d,f", [(8, 8), (1024, 512), (1032, 520), (130, 72), (64, 70)])
@pytest.mark.parametrize("off", [0, 8, 3])
def test_gmm_variant_choice(dtype, c, d, f, off):
    """bf16 with d and F multiples of 8 and 16-byte aligned bases goes to the
    tensor cores, the decode tile for C <= 16; all else to the FMA kernel."""
    x, w = _at_offset((2, c, d), dtype, off), _at_offset((2, d, f), dtype, 0)
    if dtype == torch.float32 or d % 8 or f % 8 or off % 8:
        want = "fma"
    else:
        want = "tc_decode" if c <= 16 else "tc_prefill"
    assert TGM.gmm_variant(x, w) == want
    assert TGM.gmm_variant(_at_offset(x.shape, dtype, 0), _at_offset(w.shape, dtype, off)) == want
    before = dict(TGM.gmm.variant_launches)
    assert TGM.gmm(x, w).shape == (2, c, f)     # the CPU path launches nothing
    assert TGM.gmm.variant_launches == before


# G, C, d, F of the backward: C = 1, odd d and F, and a case the tensor-core
# tile would take on the card (bf16 there)
BWD_SHAPES = [(3, 1, 5, 9), (2, 17, 13, 7), (4, 33, 64, 48)]
BWD_TOL = 1e-4


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("g,c,d,f", BWD_SHAPES)
def test_gmm_bwd_plain_matches_jax_vjp(g, c, d, f):
    x, w = _inputs(g + c + d + f, g, c, d, f)
    dy = np.random.default_rng(f).standard_normal((g, c, f)).astype(np.float32)
    _, vjp = jax.vjp(JR.gmm_ref, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    before = TGM.gmm_bwd.launches
    dx, dw = TGM.gmm_bwd(tx, tw, tdy)
    assert TGM.gmm_bwd.launches == before       # the CPU path launches no kernel
    assert dx.shape == (g, c, d) and dw.shape == (g, d, f)
    assert _rel_err(dx, jdx) < BWD_TOL and _rel_err(dw, jdw) < BWD_TOL
    plain = TR.gmm_bwd_plain(tx, tw, tdy)
    assert torch.equal(dx, plain[0]) and torch.equal(dw, plain[1])
    # autograd through the plain forward (the CPU training path) agrees
    ax, aw = (t.clone().requires_grad_() for t in (tx, tw))
    gx, gw = torch.autograd.grad(TGM.gmm(ax, aw), (ax, aw), tdy)
    assert _rel_err(gx, jdx) < BWD_TOL and _rel_err(gw, jdw) < BWD_TOL
    assert TGM.gmm_bwd(tx, tw, tdy, need_dx=False)[0] is None
    assert TGM.gmm_bwd(tx, tw, tdy, need_dw=False)[1] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,f", [(1024, 512), (512, 1024), (130, 72), (64, 70)])
@pytest.mark.parametrize("off", [0, 8, 3])
def test_gmm_bwd_variant_choice(dtype, d, f, off):
    """The backward takes the tensor-core tile where the forward's tiles take
    the inputs (bf16, d and F multiples of 8, 16-byte aligned x, w and dy),
    whatever C, and the FMA kernel for everything else."""
    c = 5
    x, w, dy = (_at_offset(s, dtype, 0) for s in ((2, c, d), (2, d, f), (2, c, f)))
    want = "fma" if dtype == torch.float32 or d % 8 or f % 8 or off % 8 else "tc"
    for moved in range(3):
        args = [x, w, dy]
        args[moved] = _at_offset(args[moved].shape, dtype, off)
        assert TGM.gmm_bwd_variant(*args) == want
