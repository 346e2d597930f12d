"""The CUDA flash-attention kernel against its plain version on the card.

Needs a CUDA device and nvcc (the kernel has no CPU mode): every test here
carries the ``cuda`` marker and skips without a card.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.  This file
imports no JAX, so it runs where only PyTorch is installed.  Tolerances are
those of tests/test_kernels.py: 2e-5 at fp32, 2e-2 at bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as TFA

F32_TOL, BF16_TOL = 2e-5, 2e-2


def _qkv(seed, b, tq, tk, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, hd), dtype=np.float32),
            rng.standard_normal((b, tk, hkv, hd), dtype=np.float32),
            rng.standard_normal((b, tk, hkv, hd), dtype=np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,tq,tk,h,hkv,hd,causal,window", [
    (2, 70, 70, 4, 2, 32, True, 0), (1, 1, 1, 2, 2, 64, True, 0),
    (2, 130, 130, 8, 2, 128, True, 3), (2, 100, 260, 4, 4, 64, False, 0),
    (4, 1, 513, 32, 8, 64, False, 0)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, b, tq, tk, h,
                                      hkv, hd, causal, window):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(tq + tk, b, tq, tk, h, hkv, hd))
    before = TFA.flash_attention.launches
    out = TFA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert TFA.flash_attention.launches == before + 1
    ref = TFA.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert float((out.float() - ref.float()).abs().max()) < tol


@pytest.mark.cuda
def test_kernel_reads_strided_cache_view(cuda_device):
    """Decode attends over a view ``cache[:, :n]`` of a (B, cap, KV, hd)
    cache and over a head-transposed layout, without copies."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(1, 2, 1, 40, 8, 2, 64))
    n = 17
    out = TFA.flash_attention(q, k[:, :n], v[:, :n], causal=False)
    ref = TFA.flash_attention_ref(q, k[:, :n].contiguous(), v[:, :n].contiguous(),
                                  causal=False)
    assert float((out.float() - ref.float()).abs().max()) < BF16_TOL
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)      # (B, T, H, hd) view
    out_t = TFA.flash_attention(q, kt, v, causal=False)
    assert torch.equal(out_t, TFA.flash_attention(q, k, v, causal=False))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    def z(*s, dtype=torch.bfloat16):
        return torch.zeros(s, device=cuda_device, dtype=dtype)

    with pytest.raises(ValueError, match="head_dim"):
        TFA.flash_attention(z(1, 4, 2, 48), z(1, 4, 2, 48), z(1, 4, 2, 48))
    with pytest.raises(TypeError):
        TFA.flash_attention(*(z(1, 4, 2, 64, dtype=torch.float16),) * 3)
    with pytest.raises(TypeError):
        TFA.flash_attention(z(1, 4, 2, 64), z(1, 4, 2, 64, dtype=torch.float32),
                            z(1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention(z(1, 4, 2, 64), z(1, 4, 2, 64).cpu(), z(1, 4, 2, 64))
    with pytest.raises(NotImplementedError, match="backward"):
        TFA.flash_attention(z(1, 4, 2, 64).requires_grad_(), z(1, 4, 2, 64),
                            z(1, 4, 2, 64))


@pytest.mark.cuda
def test_build_is_cached_by_source_hash(cuda_device):
    first = build.build("flash_attention")
    mtime = first.stat().st_mtime_ns
    again = build.build("flash_attention")
    assert again == first and again.stat().st_mtime_ns == mtime
    assert "registers" in build.build_log("flash_attention")
