"""The CUDA kernels (flash attention's forward and backward, the LSTM cell's
forward and pointwise backward, the grouped matmul, the RWKV6 WKV
recurrence) against their plain versions on the card; for flash attention,
the grouped matmul, the LSTM forward (FMA, tensor-core ``tc``) and the WKV
recurrence (``scan``, ``chunked``), each of their variants, asserting which
variant's launch counter moved.

Needs a CUDA device and nvcc (the kernel has no CPU mode): every test here
carries the ``cuda`` marker and skips without a card.  Run on the card with
``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.  This file
imports no JAX, so it runs where only PyTorch is installed.  Tolerances are
those of tests/test_kernels.py: 2e-5 at fp32, 2e-2 at bf16 (gmm: 1e-4 and
5e-2, as test_gmm_sweep; wkv6: 2e-4 of max(1, the largest reference value),
as test_wkv6_sweep).  The flash backward (no TPU kernel) is held at 1e-4 of
max(1, the largest reference value) in f32, sums of up to 2048 terms taken
in another order, and in bf16 by FlashAttention-2's rule: its error against
the f32 plain version at most twice that of autograd through the plain
forward in bf16, plus 1e-3 of the largest reference value.
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
@pytest.mark.parametrize("dtype,tol,variant", [(torch.float32, F32_TOL, "fma"),
                                               (torch.bfloat16, BF16_TOL, "tc_prefill")])
@pytest.mark.parametrize("tq,tk,causal", [(64, 64, True), (64, 64, False), (1, 33, False)])
def test_flash_attention_lse_launches_the_forward_on_card(cuda_device, dtype, tol, variant,
                                                         tq, tk, causal):
    """A hop of the context ring: one forward launch with lse, on the variant
    the autograd forward takes (never the decode tile, even at Tq 1); out
    against the plain output, lse within 1e-4 of max(1, |ref|)."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(tq + tk, 2, tq, tk, 8, 2, 64))
    before = dict(TFA.flash_attention.variant_launches)
    out, lse = TFA.flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in TFA.flash_attention.variant_launches.items()}
    assert moved == {n: int(n == variant) for n in moved}
    ref = TFA.flash_attention_ref(q, k, v, causal=causal)
    want = TFA.flash_attention_lse_plain(q, k, causal=causal)
    assert float((out.float() - ref.float()).abs().max()) < tol
    assert float((lse - want).abs().max()) < 1e-4 * max(1.0, float(want.abs().max()))


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
    out = TFA.flash_attention(z(1, 4, 2, 64).requires_grad_(), z(1, 4, 2, 64), z(1, 4, 2, 64))
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    lse = torch.zeros((1, 2, 4), device=cuda_device)
    with pytest.raises(ValueError, match="lse"):
        TFA.flash_attention_bwd(*(z(1, 4, 2, 64),) * 5, lse.double())
    with pytest.raises(TypeError):
        TFA.flash_attention_bwd(*(z(1, 4, 2, 64),) * 4, z(1, 4, 2, 64, dtype=torch.float32),
                                lse)


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
# (T 1), and edge shapes: T 1, 7, 33 and 130 (no multiple of the scan's 16-
# or 32-token staging chunk or of the chunked form's 16-token sub-chunk), 16
# and 17 (one sub-chunk, and one past it), hd 32, B 1, H 1
WKV_SHAPES = [(4, 512, 64, 64), (4, 1, 64, 64), (2, 7, 3, 64), (2, 130, 2, 32),
              (1, 1, 1, 32), (1, 33, 2, 64), (3, 16, 1, 64), (2, 17, 2, 32)]
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
    before, by_variant = TWK.wkv6.launches, dict(TWK.wkv6.variant_launches)
    out, s = TWK.wkv6(r, k, v, w, u, state)
    torch.cuda.synchronize()
    assert TWK.wkv6.launches == before + 1
    assert _moved(TWK.wkv6, by_variant) == {TWK.wkv_variant(r, k, v, w): 1}
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


# the tensor-core LSTM forward: B 1, 5, 16 (one m16 tile) and 17 (two)
# against widths the tile takes, BigLSTM's among them
@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5, 16, 17])
@pytest.mark.parametrize("d_in,d_h,hh", [(24, 16, 72), (64, 40, 8), (1024, 1024, 8192)])
def test_lstm_tc_variant_matches_plain_on_card(cuda_device, b, d_in, d_h, hh):
    args = _lstm_inputs(b * hh + d_in, b, d_in, d_h, hh, cuda_device, torch.bfloat16)
    assert TLC.lstm_variant(args[0], args[1], args[3], args[4]) == "tc"
    before = dict(TLC.lstm_cell_fwd.variant_launches)
    hn, cn, gates = TLC.lstm_cell_fwd(*args, want_gates=True)
    torch.cuda.synchronize()
    assert _moved(TLC.lstm_cell_fwd, before) == {"tc": 1}
    rh, rc, ract = TLC.lstm_cell_plain(*args, with_gates=True)
    for got, want in ((hn, rh), (cn, rc)):
        assert float((got.float() - want.float()).abs().max()) < BF16_TOL
    assert float((gates - ract).abs().max()) < 1e-4
    hn2, cn2, none = TLC.lstm_cell_fwd(*args)           # inference: no gates written
    assert none is None and torch.equal(hn2, hn) and torch.equal(cn2, cn)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "d_in 20", "d_h 12", "H 36", "x row stride 28",
                                  "x base 2 bytes off", "wh base 2 bytes off"])
def test_lstm_fma_variant_takes_what_the_tensor_cores_do_not(cuda_device, case):
    """f32, widths that are no multiple of 8, rows or bases off 16 bytes:
    the FMA kernel, at its tolerances."""
    d_in = 20 if case == "d_in 20" else 24
    d_h = 12 if case == "d_h 12" else 16
    hh = 36 if case == "H 36" else 72
    dt = torch.float32 if case == "f32" else torch.bfloat16
    x, h, c, wx, wh, b = _lstm_inputs(3, 5, d_in, d_h, hh, cuda_device, dt)

    def moved_off(t, off, cols=None):
        cols = cols or t.shape[-1]
        store = torch.zeros(off + t.numel() // t.shape[-1] * cols, dtype=t.dtype,
                            device=cuda_device)
        out = store[off:].view(*t.shape[:-1], cols)[..., :t.shape[-1]]
        out.copy_(t)
        return out

    if case == "x row stride 28":
        x = moved_off(x, 0, cols=d_in + 4)
    elif case == "x base 2 bytes off":
        x = moved_off(x, 1)
    elif case == "wh base 2 bytes off":
        wh = moved_off(wh.reshape(d_h, 4 * hh), 1).view(d_h, 4, hh)
    assert TLC.lstm_variant(x, h, wx, wh) == "fma"
    before = dict(TLC.lstm_cell_fwd.variant_launches)
    hn, cn, _ = TLC.lstm_cell_fwd(x, h, c, wx, wh, b)
    torch.cuda.synchronize()
    assert _moved(TLC.lstm_cell_fwd, before) == {"fma": 1}
    rh, rc = TLC.lstm_cell_plain(x, h, c, wx, wh, b)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    for got, want in ((hn, rh), (cn, rc)):
        assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("kind,stride,padding", [("avg", 1, "SAME"), ("max", 2, "VALID")])
def test_inception_pools_backward_on_card_match_cpu(cuda_device, kind, stride, padding):
    """Inception's pools (NHWC, as the model runs them) forward and backward
    on the card against the CPU in f32: the average pool runs on an NCHW
    copy, since torch's CUDA avg_pool2d backward over a channels-last input
    was wrong."""
    from repro_torch.models import inception as TI

    gen = torch.Generator().manual_seed(5)
    x, dy = torch.randn(4, 17, 17, 160, generator=gen), torch.randn(4, 17, 17, 160,
                                                                    generator=gen)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        y = TI.pool(xd, kind, 3, stride, padding)
        (dx,) = torch.autograd.grad(y, xd, dy.to(dev)[:, :y.shape[1], :y.shape[2]])
        outs.append((y.cpu(), dx.cpu()))
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) < F32_TOL


# GNMT's cells: B 128, H 1024, no projection; x is the time-t row view of the
# layer's (B, T, d_in) input, d_in 2048 for the first decoder layer's concat
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,variant", [(torch.float32, F32_TOL, "fma"),
                                               (torch.bfloat16, BF16_TOL, "tc")])
@pytest.mark.parametrize("d_in", [1024, 2048])
def test_lstm_cell_at_gnmt_shapes_on_card(cuda_device, dtype, tol, variant, d_in):
    b, hh, t_len, t = 128, 1024, 50, 7
    x, h, c, wx, wh, bias = _lstm_inputs(d_in + t, b, d_in, hh, hh, cuda_device, dtype)
    xs = torch.zeros((b, t_len, d_in), dtype=dtype, device=cuda_device)
    xs[:, t] = x
    x = xs[:, t]
    assert x.stride(0) == t_len * d_in and TLC.lstm_variant(x, h, wx, wh) == variant
    before = dict(TLC.lstm_cell_fwd.variant_launches)
    hn, cn, gates = TLC.lstm_cell_fwd(x, h, c, wx, wh, bias, want_gates=True)
    torch.cuda.synchronize()
    assert _moved(TLC.lstm_cell_fwd, before) == {variant: 1}
    rh, rc, ract = TLC.lstm_cell_plain(x, h, c, wx, wh, bias, with_gates=True)
    for got, want in ((hn, rh), (cn, rc)):
        assert float((got.float() - want.float()).abs().max()) < tol
    assert float((gates - ract).abs().max()) < 1e-4
    dh, dc = (torch.randn((b, hh), device=cuda_device).to(dtype) for _ in range(2))
    dg, dcp = TLC.lstm_cell_bwd_pointwise(gates, c, dh, dc)
    rg, rcp = TLC.lstm_cell_bwd_pointwise_plain(gates, c, dh, dc)
    assert float((dg.float() - rg.float()).abs().max()) < tol
    assert float((dcp.float() - rcp.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["scan", "chunked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hd", WKV_SHAPES)
def test_wkv6_each_variant_matches_plain_on_card(cuda_device, variant, dtype, b, t, h, hd):
    """Both variants take every shape: each forced on the edge shapes and
    the serving shapes, from a state, written in place."""
    r, k, v, w, u, s0 = _wkv_inputs(b * t + hd + 1, b, t, h, hd, cuda_device, dtype)
    want_out, want_s = wkv6_ref(r, k, v, w, u, s0)
    state = s0.clone()
    before = dict(TWK.wkv6.variant_launches)
    out, s = TWK._launch(r, k, v, w, u, state, variant)
    torch.cuda.synchronize()
    assert _moved(TWK.wkv6, before) == {variant: 1}
    assert s is state
    assert _wkv_err(out, want_out) < WKV_TOL and _wkv_err(s, want_s) < WKV_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["scan", "chunked"])
@pytest.mark.parametrize("t,decay,dtype", [(2048, "near1", torch.bfloat16),
                                           (8192, "near1", torch.float32),
                                           (2048, "strong", torch.bfloat16)])
def test_wkv6_long_prompts_match_plain_on_card(cuda_device, variant, t, decay, dtype):
    """Decays near 1 (w in [0.999, 1)) over T 2048 and 8192, and strong decays
    (w log-uniform in [1e-38, 1e-3]) over T 2048, from a non-zero state, at
    the unchanged tolerance."""
    r, k, v, _, u, s0 = _wkv_inputs(t, 1, t, 2, 64, cuda_device, dtype)
    rng = np.random.default_rng(t + len(decay))
    if decay == "near1":
        w = 1 - rng.uniform(0, 1e-3, r.shape)
    else:
        w = np.exp(rng.uniform(np.log(1e-38), np.log(1e-3), r.shape))
    w = torch.from_numpy(w.astype(np.float32)).to(cuda_device)
    want_out, want_s = wkv6_ref(r, k, v, w, u, s0)
    out, s = TWK._launch(r, k, v, w, u, s0.clone(), variant)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(s).all()
    assert _wkv_err(out, want_out) < WKV_TOL and _wkv_err(s, want_s) < WKV_TOL


@pytest.mark.cuda
def test_wkv6_misaligned_prompt_takes_the_scan(cuda_device):
    r, k, v, w, u, s0 = _wkv_inputs(2, 2, 64, 2, 64, cuda_device, torch.bfloat16)
    rm = torch.empty(1 + r.numel(), dtype=r.dtype, device=cuda_device)[1:].view(r.shape)
    rm.copy_(r)
    assert TWK.wkv_variant(r, k, v, w) == "chunked" and TWK.wkv_variant(rm, k, v, w) == "scan"
    before = dict(TWK.wkv6.variant_launches)
    out, _ = TWK.wkv6(rm, k, v, w, u)
    torch.cuda.synchronize()
    assert _moved(TWK.wkv6, before) == {"scan": 1}
    assert _wkv_err(out, wkv6_ref(r, k, v, w, u)[0]) < WKV_TOL


# the flash backward: B, Tq, Tk, H, Hkv, hd, causal, window.  T 1, 4, 17 and
# 130, Tq != Tk both ways, hd 32 and 128, B 1, H = Hkv, windows (with rows
# that see no key: Tq >= Tk + window), non-causal, and Granite's heads.  T 1
# attends over 33 keys, as a decode step: causal over one key, dq and dk are
# exactly 0 and the bf16 rule would admit no round-off at all.  Then the
# edges of the bf16 kernels' tiles (64 rows a warpgroup, blocks of 128 keys
# or query rows, streamed tiles of 64): T 63, 65, 127, 129 and 191, causal
# and not; Tq != Tk with the causal diagonal off a tile edge, both ways; hd
# 128 with 8 query heads a KV head; and grids of 2 to 16 blocks, most SMs
# idle (one KV head, T 256, and T 2048 walked by 16 blocks).
BWD_CASES = [(1, 1, 33, 2, 2, 64, False, 0), (2, 4, 4, 8, 2, 64, True, 0),
             (2, 17, 17, 4, 2, 32, True, 0), (2, 130, 130, 8, 2, 128, True, 0),
             (1, 100, 260, 4, 4, 64, False, 0), (2, 200, 70, 4, 1, 64, True, 0),
             (1, 300, 300, 8, 2, 128, True, 64), (2, 90, 30, 4, 2, 64, False, 16),
             (1, 150, 40, 4, 2, 32, True, 8), (2, 256, 256, 16, 8, 64, True, 0),
             (1, 63, 63, 4, 2, 64, True, 0), (1, 63, 63, 4, 2, 64, False, 0),
             (2, 65, 65, 4, 1, 64, True, 0), (2, 65, 65, 4, 1, 64, False, 0),
             (1, 127, 127, 8, 2, 32, True, 0), (1, 127, 127, 8, 2, 32, False, 0),
             (1, 129, 129, 4, 2, 128, True, 0), (1, 129, 129, 4, 2, 128, False, 0),
             (1, 191, 191, 4, 2, 64, True, 0), (1, 191, 191, 4, 2, 64, False, 0),
             (1, 191, 129, 4, 2, 64, True, 0), (1, 129, 191, 4, 2, 64, True, 0),
             (1, 200, 200, 16, 2, 128, True, 0), (1, 256, 256, 2, 1, 64, True, 0),
             (1, 2048, 2048, 1, 1, 64, True, 0)]
BWD_F32_TOL = 1e-4


def _bwd_inputs(seed, b, tq, tk, h, hkv, hd, device, dtype):
    rng = np.random.default_rng(seed)
    shapes = ((b, tq, h, hd), (b, tk, hkv, hd), (b, tk, hkv, hd), (b, tq, h, hd))
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, dtype)
            for s in shapes]


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(1.0, float(want.abs().max()))


def _bf16_within(got, base, oracle):
    """FlashAttention-2's rule: the error against the f32 oracle at most twice
    that of the bf16 baseline, plus 1e-3 of the oracle's largest value."""
    err = float((got.float() - oracle).abs().max())
    return err <= 2 * float((base.float() - oracle).abs().max()) + 1e-3 * float(oracle.abs().max())


def _autograd_of_ref(q, k, v, do, causal, window):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = TFA.flash_attention_ref(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,hkv,hd,causal,window", BWD_CASES)
def test_flash_bwd_kernel_matches_plain_on_card(cuda_device, dtype, b, tq, tk, h, hkv, hd,
                                                causal, window):
    """lse against its plain value, out the same bits with and without lse,
    the backward kernels against their plain version (each variant that
    takes the inputs) and the same bits on a repeat launch."""
    q, k, v, do = _bwd_inputs(tq * 7 + tk + window, b, tq, tk, h, hkv, hd, cuda_device, dtype)
    kw = dict(causal=causal, window=window)
    fwd_variant = TFA.flash_variant(q, k, v, want_lse=True)
    assert fwd_variant != "tc_decode"
    out, lse = TFA._forward(q, k, v, causal, window, want_lse=True)
    out_plain, none = TFA._forward(q, k, v, causal, window, want_lse=False, variant=fwd_variant)
    assert none is None and torch.equal(out, out_plain)
    want_lse = TFA.flash_attention_lse_plain(q, k, **kw)
    dead = want_lse < -1e29
    assert torch.equal(lse < -1e29, dead)
    assert _rel(lse[~dead], want_lse[~dead]) < BWD_F32_TOL

    oracle = TFA.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                           do.float(), lse, **kw)
    base = _autograd_of_ref(q, k, v, do, causal, window)
    picked = TFA.flash_bwd_variant(q, k, v, out, do)
    assert picked == ("tc" if dtype == torch.bfloat16 else "fma")
    for variant in (picked, "fma") if picked == "tc" else (picked,):
        before = dict(TFA.flash_attention_bwd.variant_launches)
        grads = TFA._launch_bwd(q, k, v, out, do, lse, causal, window, variant)
        again = TFA._launch_bwd(q, k, v, out, do, lse, causal, window, variant)
        torch.cuda.synchronize()
        assert _moved(TFA.flash_attention_bwd, before) == {variant: 2}
        for name, g, g2, w, bse in zip(("dq", "dk", "dv"), grads, again, oracle, base):
            assert g.dtype == dtype and torch.isfinite(g).all(), (variant, name)
            assert torch.equal(g, g2), (variant, name)          # deterministic
            if dtype == torch.float32:
                assert _rel(g, w) < BWD_F32_TOL, (variant, name)
            else:
                assert _bf16_within(g, bse, w), (variant, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,causal", [(1, 33, False), (2, 2, True), (3, 3, True),
                                          (4, 4, True), (4, 40, False), (70, 70, True)])
def test_flash_attention_function_grads_match_autograd_of_plain(cuda_device, dtype, tq, tk,
                                                                causal):
    """Under autograd ``flash_attention`` runs the forward with lse (never the
    decode tile, though rep * Tq <= 16 for T 1-4) and the backward kernels;
    its gradients against autograd of the plain forward.  T 1 attends over
    33 keys, as a decode step (see BWD_CASES)."""
    q, k, v, do = _bwd_inputs(tq + tk, 2, tq, tk, 8, 2, 64, cuda_device, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd_before = dict(TFA.flash_attention.variant_launches)
    bwd_before = dict(TFA.flash_attention_bwd.variant_launches)
    out = TFA.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    bf = dtype == torch.bfloat16
    assert _moved(TFA.flash_attention, fwd_before) == {"tc_prefill" if bf else "fma": 1}
    assert _moved(TFA.flash_attention_bwd, bwd_before) == {"tc" if bf else "fma": 1}
    oracle = _autograd_of_ref(q.float(), k.float(), v.float(), do.float(), causal, 0)
    base = _autograd_of_ref(q, k, v, do, causal, 0)
    for g, w, bse in zip(got, oracle, base):
        assert g.shape == w.shape and g.dtype == dtype
        assert _bf16_within(g, bse, w) if bf else _rel(g, w) < BWD_F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(4, 2048), (1, 8192)])
def test_flash_long_prompts_match_plain_on_card(cuda_device, b, t):
    """The bf16 prefill tile over long prompts (causal, Llama's 32 query heads
    over 8 KV heads), at the bf16 tolerance."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(t, b, t, t, 32, 8, 64))
    before = dict(TFA.flash_attention.variant_launches)
    out = TFA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _moved(TFA.flash_attention, before) == {"tc_prefill": 1}
    ref = TFA.flash_attention_ref(q, k, v, causal=True)
    assert float((out.float() - ref.float()).abs().max()) < BF16_TOL
