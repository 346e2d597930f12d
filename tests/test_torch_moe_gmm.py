"""The port's grouped matmul against the JAX package's.

On the CPU ``repro_torch.kernels.moe_gmm.gmm`` takes its plain twin
(``ref.gmm_ref``).  It is held against the Pallas kernel run in interpret
mode (as tests/test_kernels.py runs it, blocks of 64 so that C, d and F are
padded there) and against ``repro.kernels.ref.gmm_ref``, on the same inputs
drawn with numpy.  Tolerances are those of
tests/test_kernels.py::test_gmm_sweep: 1e-4 at fp32, 5e-2 at bf16.  The CUDA
kernel itself is held against the plain twin on the card in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_gmm as JGM
from repro.kernels import ref as JR
from repro_torch.kernels import moe_gmm as TGM
from repro_torch.kernels import ref as TR

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
