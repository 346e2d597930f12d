"""The CUDA kernels (flash attention, the LSTM cell's forward and pointwise
backward, the grouped matmul, the RWKV6 WKV recurrence) against their plain
versions on the card; for flash attention and the grouped matmul, each of
their variants (FMA, tensor-core prefill and decode tiles), asserting which
variant's launch counter moved.

Needs a CUDA device and nvcc (the kernel has no CPU mode): every test here
carries the ``cuda`` marker and skips without a card.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.  This file
imports no JAX, so it runs where only PyTorch is installed.  Tolerances are
those of tests/test_kernels.py: 2e-5 at fp32, 2e-2 at bf16 (gmm: 1e-4 and
5e-2, as test_gmm_sweep; wkv6: 2e-4 of max(1, the largest reference value),
as test_wkv6_sweep).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import lstm_cell as TLC
from repro_torch.kernels import moe_gmm as TGM
from repro_torch.kernels import wkv6 as TWK
from repro_torch.kernels.ref import gmm_ref, lstm_cell_ref, wkv6_ref

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


# B, d_in, d_h (the recurrent input), H: edge shapes where B and H are no
# tile multiples (B = 1, H % 4 != 0, B > 16), and BigLSTM's full width
LSTM_SHAPES = [(1, 24, 16, 70), (5, 64, 40, 33), (17, 40, 12, 130), (3, 16, 8, 1),
               (16, 1024, 1024, 8192)]


def _lstm_inputs(seed, b, d_in, d_h, hh, device, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32)).to(device)
    x, h, c = f(b, d_in), f(b, d_h), f(b, hh, scale=0.5)
    wx, wh = f(d_in, 4, hh, scale=d_in ** -0.5), f(d_h, 4, hh, scale=d_h ** -0.5)
    return [t.to(dtype) for t in (x, h, c, wx, wh)] + [f(4, hh, scale=0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,d_in,d_h,hh", LSTM_SHAPES)
def test_lstm_fwd_kernel_matches_plain_on_card(cuda_device, dtype, tol, b, d_in, d_h, hh):
    args = _lstm_inputs(b + hh, b, d_in, d_h, hh, cuda_device, dtype)
    before = TLC.lstm_cell_fwd.launches
    hn, cn, gates = TLC.lstm_cell_fwd(*args, want_gates=True)
    torch.cuda.synchronize()
    assert TLC.lstm_cell_fwd.launches == before + 1
    rh, rc, ract = TLC.lstm_cell_plain(*args, with_gates=True)
    assert hn.dtype == cn.dtype == dtype and gates.dtype == torch.float32
    for got, want in ((hn, rh), (cn, rc)):
        assert float((got.float() - want.float()).abs().max()) < tol
    assert float((gates - ract).abs().max()) < F32_TOL * (100 if dtype == torch.bfloat16
                                                          else 1)
    hn2, cn2, none = TLC.lstm_cell_fwd(*args)           # inference: no gates written
    assert none is None and torch.equal(hn2, hn) and torch.equal(cn2, cn)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,hh", [(1, 70), (17, 130), (16, 8192)])
@pytest.mark.parametrize("with_dc", [True, False])
def test_lstm_bwd_pointwise_kernel_matches_plain_on_card(cuda_device, dtype, tol, b, hh,
                                                         with_dc):
    gen = torch.Generator(device=cuda_device).manual_seed(b * hh)
    gates = torch.rand((b, 4, hh), generator=gen, device=cuda_device)
    gates[:, 2] = gates[:, 2] * 2 - 1                      # tanh(g) in (-1, 1)
    c, dh, dc = (torch.randn((b, hh), generator=gen, device=cuda_device).to(dtype)
                 for _ in range(3))
    dc = dc if with_dc else None
    before = TLC.lstm_cell_bwd_pointwise.launches
    dg, dcp = TLC.lstm_cell_bwd_pointwise(gates, c, dh, dc)
    torch.cuda.synchronize()
    assert TLC.lstm_cell_bwd_pointwise.launches == before + 1
    rg, rc = TLC.lstm_cell_bwd_pointwise_plain(gates, c, dh, dc)
    assert dg.dtype == dcp.dtype == dtype
    assert float((dg.float() - rg.float()).abs().max()) < tol
    assert float((dcp.float() - rc.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,d_in,d_h,hh", [(5, 64, 40, 33), (16, 1024, 1024, 8192)])
def test_lstm_cell_function_grads_match_autograd_of_ref_on_card(cuda_device, b, d_in,
                                                                 d_h, hh):
    """dx, dh, dc, dWx, dWh, db of the kernels' autograd function against
    autograd through the plain oracle, both on the card in f32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _lstm_inputs(7, b, d_in, d_h, hh, cuda_device, torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dh_out, dc_out = (torch.randn((b, hh), generator=gen, device=cuda_device)
                      for _ in range(2))
    ours = [t.clone().requires_grad_() for t in args]
    ref = [t.clone().requires_grad_() for t in args]
    hn, cn = TLC.lstm_cell(*ours)
    rh, rc = lstm_cell_ref(*ref)
    got = torch.autograd.grad((hn, cn), ours, (dh_out, dc_out))
    want = torch.autograd.grad((rh, rc), ref, (dh_out, dc_out))
    for name, g, w in zip(("x", "h", "c", "wx", "wh", "b"), got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) < 1e-4 * scale, name


@pytest.mark.cuda
def test_lstm_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, h, c, wx, wh, b = _lstm_inputs(0, 2, 8, 8, 16, cuda_device, torch.float32)
    with pytest.raises(TypeError):
        TLC.lstm_cell_fwd(x.half(), h.half(), c.half(), wx.half(), wh.half(), b)
    with pytest.raises(TypeError):
        TLC.lstm_cell_fwd(x, h, c, wx, wh, b.double())
    with pytest.raises(ValueError, match="CUDA"):
        TLC.lstm_cell_fwd(x, h.cpu(), c, wx, wh, b)
    with pytest.raises(ValueError, match="contiguous"):
        TLC.lstm_cell_fwd(x, h, c, wx.transpose(0, 2).contiguous().transpose(0, 2), wh, b)
    out = TLC.lstm_cell_fwd(torch.cat([x, x], 1)[:, :8], h, c, wx, wh, b)   # row view
    assert torch.equal(out[0], TLC.lstm_cell_fwd(x, h, c, wx, wh, b)[0])


@pytest.mark.cuda
def test_build_all_builds_every_source(cuda_device):
    libs = build.build_all()
    assert set(libs) == {"flash_attention", "lstm_cell", "moe_gmm", "wkv6"}
    assert all(p.exists() for p in libs.values())
    assert "registers" in build.build_log("lstm_cell")


# G, C, d, F: the JAX sweep's odd shapes, G = 1, C = 1, d = 1, d and F % 4 != 0,
# and Granite-3.0-1B-A400M's prefill (capacity 640) and decode (C = 4) products
GMM_SHAPES = [(8, 37, 130, 70), (4, 100, 192, 160), (1, 1, 1, 1), (1, 20, 64, 64),
              (3, 1, 64, 48), (2, 17, 1, 9), (32, 640, 1024, 512), (32, 640, 512, 1024),
              (32, 4, 1024, 512), (32, 4, 512, 1024)]
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _gmm_inputs(seed, g, c, d, f, device, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, c, d)).astype(np.float32)
    w = (rng.standard_normal((g, d, f)) / np.sqrt(d)).astype(np.float32)
    return (torch.from_numpy(a).to(device, dtype) for a in (x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,c,d,f", GMM_SHAPES)
def test_gmm_kernel_matches_plain_on_card(cuda_device, dtype, g, c, d, f):
    x, w = _gmm_inputs(g * c + d * f, g, c, d, f, cuda_device, dtype)
    before = TGM.gmm.launches
    out = TGM.gmm(x, w)
    torch.cuda.synchronize()
    assert TGM.gmm.launches == before + 1
    assert out.shape == (g, c, f) and out.dtype == dtype
    assert float((out.float() - gmm_ref(x, w).float()).abs().max()) < GMM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_reads_misaligned_rows(cuda_device, dtype):
    """d and F multiples of 4 on bases one element off: the FMA kernel's
    scalar loads, not its 4-wide ones.  The aligned inputs, put on the same
    kernel (at bf16 ``gmm`` would take the tensor cores for them), are read
    4 wide and must give the same bits."""
    g, c, d, f = 3, 9, 64, 32
    x, w = _gmm_inputs(5, g, c, d, f, cuda_device, dtype)
    xs = torch.empty(1 + x.numel(), device=cuda_device, dtype=dtype)
    ws = torch.empty(1 + w.numel(), device=cuda_device, dtype=dtype)
    xm, wm = xs[1:].view(g, c, d), ws[1:].view(g, d, f)
    xm.copy_(x)
    wm.copy_(w)
    assert TGM.gmm_variant(xm, wm) == "fma"
    out = TGM.gmm(xm, wm)
    assert torch.equal(out, TGM._launch(x, w, "fma"))
    assert float((out.float() - gmm_ref(x, w).float()).abs().max()) < GMM_TOL[dtype]


@pytest.mark.cuda
def test_gmm_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, w = _gmm_inputs(0, 2, 3, 8, 4, cuda_device, torch.float32)
    with pytest.raises(TypeError):
        TGM.gmm(x.half(), w.half())
    with pytest.raises(TypeError):
        TGM.gmm(x, w.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        TGM.gmm(x, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        TGM.gmm(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(NotImplementedError, match="item 14"):
        TGM.gmm(x.requires_grad_(), w)


# B, T, H, hd: RWKV6-7B's prefill (B 4, T 512, H 64, hd 64) and decode step
# (T 1), and edge shapes: T 1, 7, 33 and 130 (no multiple of the kernel's
# 16- or 32-token chunk), hd 32, B 1, H 1
WKV_SHAPES = [(4, 512, 64, 64), (4, 1, 64, 64), (2, 7, 3, 64), (2, 130, 2, 32),
              (1, 1, 1, 32), (1, 33, 2, 64), (3, 16, 1, 64)]
WKV_TOL = 2e-4


def _wkv_inputs(seed, b, t, h, hd, device, dtype, state=True):
    """r, k, v, w, u as tests/test_kernels.py::test_wkv6_sweep draws them,
    r, k, v in ``dtype``, and a non-zero initial state."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32)).to(device)

    r, k, v = (f(b, t, h, hd).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(f(b, t, h, hd) - 2))
    u = f(h, hd) * 0.2
    s0 = f(b, h, hd, hd) * 4 if state else None
    return r, k, v, w, u, s0


def _wkv_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd", WKV_SHAPES)
@pytest.mark.parametrize("from_state", [False, True])
def test_wkv6_kernel_matches_plain_on_card(cuda_device, dtype, b, t, h, hd, from_state):
    r, k, v, w, u, s0 = _wkv_inputs(b * t + hd, b, t, h, hd, cuda_device, dtype,
                                    state=from_state)
    want_out, want_s = wkv6_ref(r, k, v, w, u, s0)
    state = None if s0 is None else s0.clone()
    before = TWK.wkv6.launches
    out, s = TWK.wkv6(r, k, v, w, u, state)
    torch.cuda.synchronize()
    assert TWK.wkv6.launches == before + 1
    assert out.dtype == s.dtype == torch.float32 and out.shape == (b, t, h, hd)
    assert _wkv_err(out, want_out) < WKV_TOL and _wkv_err(s, want_s) < WKV_TOL
    if from_state:
        assert s is state


@pytest.mark.cuda
def test_wkv6_kernel_in_place_equals_out_of_place(cuda_device):
    """The state written over the initial state (the decode cache) equals the
    state of a run from zeros continued out of place, token by token."""
    r, k, v, w, u, _ = _wkv_inputs(9, 4, 40, 8, 64, cuda_device, torch.bfloat16)
    out_all, s_all = TWK.wkv6(r, k, v, w, u)                  # new state tensor
    state = torch.zeros_like(s_all)
    ptr = state.data_ptr()
    outs = [TWK.wkv6(r[:, :30].contiguous(), k[:, :30].contiguous(), v[:, :30].contiguous(),
                     w[:, :30].contiguous(), u, state)[0]]
    for i in range(30, 40):
        sl = slice(i, i + 1)
        o, s = TWK.wkv6(r[:, sl].contiguous(), k[:, sl].contiguous(), v[:, sl].contiguous(),
                        w[:, sl].contiguous(), u, state)
        assert s is state and s.data_ptr() == ptr
        outs.append(o)
    assert _wkv_err(torch.cat(outs, 1), out_all) < WKV_TOL
    assert _wkv_err(state, s_all) < WKV_TOL


@pytest.mark.cuda
def test_wkv6_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    r, k, v, w, u, s0 = _wkv_inputs(0, 2, 5, 2, 64, cuda_device, torch.float32)
    with pytest.raises(TypeError):
        TWK.wkv6(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError):
        TWK.wkv6(r, k.bfloat16(), v, w, u)
    with pytest.raises(TypeError):
        TWK.wkv6(r, k, v, w.bfloat16(), u)
    with pytest.raises(TypeError):
        TWK.wkv6(r, k, v, w, u, s0.double())
    with pytest.raises(ValueError, match="CUDA"):
        TWK.wkv6(r, k, v, w, u.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        TWK.wkv6(r, k, v, w, u, s0.transpose(2, 3))
    with pytest.raises(ValueError, match="head_dim"):
        TWK.wkv6(*(x[..., :48].contiguous() for x in (r, k, v, w, u)))
    with pytest.raises(NotImplementedError, match="item 17"):
        TWK.wkv6(r.requires_grad_(), k, v, w, u)


def _moved(fn, before):
    """The variants whose launch counters moved since ``before``."""
    return {n: c - before[n] for n, c in fn.variant_launches.items() if c != before[n]}


# the tensor-core flash variants: GQA rep 1/2/4/8 against Tq 1, 4, 16, 17
# (the packed decode tile holds rep * Tq <= 16 rows) and Tk around the kv
# tile (1, 63, 64, 65) and the serving decode length (513)
@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("tq", [1, 4, 16, 17])
@pytest.mark.parametrize("tk", [1, 63, 64, 65, 513])
def test_flash_tensor_core_variants_match_plain_on_card(cuda_device, rep, tq, tk):
    hkv = 2
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(rep * 1000 + tq * 10 + tk, 2, tq, tk, hkv * rep, hkv, 64))
    causal = tq > 1 and tq <= tk                         # decode steps attend non-causally
    want = "tc_decode" if rep * tq <= 16 else "tc_prefill"
    assert TFA.flash_variant(q, k, v) == want
    before = dict(TFA.flash_attention.variant_launches)
    out = TFA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _moved(TFA.flash_attention, before) == {want: 1}
    ref = TFA.flash_attention_ref(q, k, v, causal=causal)
    assert float((out.float() - ref.float()).abs().max()) < BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("tq,window", [(1, 0), (1, 7), (3, 0), (70, 0), (70, 9)])
def test_flash_tensor_core_variants_on_cache_views_and_windows(cuda_device, hd, tq, window):
    """The strided view ``cache[:, :n]`` of a longer cache, windows and the
    head dims, on the decode tile (Tq 1 and 3, rep 4) and the prefill tile."""
    cap, n, h, hkv = 300, 257, 8, 2
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(hd + tq + window, 2, tq, cap, h, hkv, hd))
    kv, vv = k[:, :n], v[:, :n]
    causal = tq > 1
    want = "tc_decode" if (h // hkv) * tq <= 16 else "tc_prefill"
    before = dict(TFA.flash_attention.variant_launches)
    out = TFA.flash_attention(q, kv, vv, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _moved(TFA.flash_attention, before) == {want: 1}
    ref = TFA.flash_attention_ref(q, kv.contiguous(), vv.contiguous(), causal=causal,
                                  window=window)
    assert float((out.float() - ref.float()).abs().max()) < BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout,tq", [
    (torch.float32, "contiguous", 1), (torch.float32, "contiguous", 70),
    (torch.bfloat16, "d-stride 2", 1), (torch.bfloat16, "d-stride 2", 70),
    (torch.bfloat16, "offset 3", 1), (torch.bfloat16, "offset 3", 70)])
def test_flash_fma_variant_on_card(cuda_device, dtype, layout, tq):
    """f32, and bf16 rows that cannot take 16-byte copies, run the FMA
    kernel, at its tolerances."""
    q32, k32, v32 = (torch.from_numpy(a) for a in _qkv(tq, 2, tq, 90, 8, 2, 64))

    def laid(t):
        if layout == "d-stride 2":
            out = torch.zeros((*t.shape[:3], 128), dtype=dtype, device=cuda_device)[..., ::2]
        elif layout == "offset 3":
            out = torch.zeros(t.numel() + 3, dtype=dtype, device=cuda_device)[3:].view(t.shape)
        else:
            out = torch.zeros(t.shape, dtype=dtype, device=cuda_device)
        out.copy_(t)
        return out

    q, k, v = laid(q32), laid(k32), laid(v32)
    before = dict(TFA.flash_attention.variant_launches)
    out = TFA.flash_attention(q, k, v, causal=tq > 1)
    torch.cuda.synchronize()
    assert _moved(TFA.flash_attention, before) == {"fma": 1}
    ref = TFA.flash_attention_ref(q, k, v, causal=tq > 1)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert float((out.float() - ref.float()).abs().max()) < tol


@pytest.mark.cuda
def test_flash_split_decode_leaves_its_counters_at_zero(cuda_device):
    """The split decode tile's last block of each (b, hkv) sets its arrival
    count back to 0, so back-to-back launches agree with each other."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(3, 4, 1, 2000, 32, 8, 64))
    outs = [TFA.flash_attention(q, k, v, causal=False) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    stream = torch.cuda.current_stream(cuda_device)
    assert int(TFA._split_counters(q.device, stream, 32).abs().sum()) == 0


# C around the decode tile (1, 4, 16 | 17) and prefill tiles (128, 640) against
# d and F of 8, 520, 1024 and 1032 (multiples of 8, not of the tiles)
@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4, 16, 17, 128, 640])
@pytest.mark.parametrize("d", [8, 520, 1024, 1032])
@pytest.mark.parametrize("f", [8, 520, 1024, 1032])
def test_gmm_tensor_core_variants_match_plain_on_card(cuda_device, c, d, f):
    x, w = _gmm_inputs(c * d + f, 2, c, d, f, cuda_device, torch.bfloat16)
    want = "tc_decode" if c <= 16 else "tc_prefill"
    before = dict(TGM.gmm.variant_launches)
    out = TGM.gmm(x, w)
    torch.cuda.synchronize()
    assert _moved(TGM.gmm, before) == {want: 1}
    assert float((out.float() - gmm_ref(x, w).float()).abs().max()) < GMM_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,d,f,off", [
    (torch.float32, 640, 1024, 512, 0), (torch.float32, 4, 512, 1024, 0),
    (torch.bfloat16, 37, 130, 70, 0), (torch.bfloat16, 4, 1024, 68, 0),
    (torch.bfloat16, 640, 1024, 512, 1), (torch.bfloat16, 4, 1024, 512, 3)])
def test_gmm_fma_variant_on_card(cuda_device, dtype, c, d, f, off):
    """f32, d or F not a multiple of 8, or a base off 16 bytes: the FMA
    kernel, at its tolerances."""
    x0, w = _gmm_inputs(c + d, 2, c, d, f, cuda_device, dtype)
    x = torch.empty(x0.numel() + off, dtype=dtype, device=cuda_device)[off:].view(x0.shape)
    x.copy_(x0)
    before = dict(TGM.gmm.variant_launches)
    out = TGM.gmm(x, w)
    torch.cuda.synchronize()
    assert _moved(TGM.gmm, before) == {"fma": 1}
    assert float((out.float() - gmm_ref(x, w).float()).abs().max()) < GMM_TOL[dtype]
