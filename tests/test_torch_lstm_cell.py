"""The port's LSTM cell against the JAX package's.

On the CPU ``repro_torch.kernels.lstm_cell`` takes its plain twins.  The
forward is held against the Pallas kernel run in interpret mode (as
tests/test_kernels.py runs it) and against ``repro.kernels.ref.lstm_cell_ref``;
``LSTMCellFunction``'s backward against ``jax.vjp`` of that oracle, plus a
float64 ``gradcheck``; the model's cell and layer (``models/lstm.py``)
against the JAX model's.  Shapes where B and H are no tile multiples.
Tolerance 1e-5 at fp32 (that of tests/test_kernels.py::test_lstm_cell_sweep).
The CUDA kernels themselves are held against the plain twins on the card in
tests/test_torch_kernels_cuda.py; here ``lstm_variant``, which picks the
forward kernel's variant from the inputs alone, is held to its rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lstm_cell as JLC
from repro.kernels import ref as JR
from repro.models import lstm as JM
from repro_torch.kernels import lstm_cell as TLC
from repro_torch.kernels import ref as TR
from repro_torch.models import lstm as TM

TOL = 1e-5
SHAPES = [(5, 24, 16, 70), (1, 16, 40, 33), (17, 8, 12, 130)]   # B, d_in, d_h, H


def _inputs(seed, b, d_in, d_h, hh):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (f(b, d_in), f(b, d_h), f(b, hh), f(d_in, 4, hh, scale=0.2),
            f(d_h, 4, hh, scale=0.2), f(4, hh, scale=0.1))


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(a):
    return a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a,
                                                                                        np.float64)


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


@pytest.mark.parametrize("b,d_in,d_h,hh", SHAPES)
def test_plain_forward_matches_pallas_and_ref(b, d_in, d_h, hh):
    args = _inputs(b * hh, b, d_in, d_h, hh)
    hn, cn = TLC.lstm_cell(*_t(args))
    assert hn.shape == cn.shape == (b, hh)
    jh, jc = JLC.lstm_cell(*map(jnp.asarray, args), block_b=8, block_h=64, interpret=True)
    rh, rc = JR.lstm_cell_ref(*map(jnp.asarray, args))
    for ours, theirs in ((hn, jh), (cn, jc), (hn, rh), (cn, rc)):
        assert _err(ours, theirs) < TOL
    th, tc = TR.lstm_cell_ref(*_t(args))
    assert _err(hn, th) < TOL and _err(cn, tc) < TOL


def test_plain_forward_gates_and_out_buffers():
    args = _t(_inputs(3, 4, 8, 8, 20))
    h_out, c_out = torch.empty(4, 20), torch.empty(4, 20)
    gates_out = torch.empty(4, 4, 20)
    hn, cn, g = TLC.lstm_cell_fwd(*args, h_out=h_out, c_out=c_out, gates_out=gates_out)
    assert hn is h_out and cn is c_out and g is gates_out
    ref_h, ref_c, act = TLC.lstm_cell_plain(*args, with_gates=True)
    assert torch.equal(hn, ref_h) and torch.equal(cn, ref_c) and torch.equal(g, act)
    x, h, c, wx, wh, b = args
    pre = torch.einsum("bd,dgh->bgh", x, wx) + torch.einsum("bd,dgh->bgh", h, wh) + b
    assert _err(act[:, 1], torch.sigmoid(pre[:, 1] + 1.0)) < TOL   # forget bias +1
    assert TLC.lstm_cell_fwd(*args)[2] is None


@pytest.mark.parametrize("b,d_in,d_h,hh,use_dc", [(*SHAPES[0], True), (*SHAPES[1], False),
                                                   (*SHAPES[2], True)])
def test_backward_matches_jax_vjp(b, d_in, d_h, hh, use_dc):
    args = _inputs(b + hh, b, d_in, d_h, hh)
    rng = np.random.default_rng(7)
    dh = rng.standard_normal((b, hh)).astype(np.float32)
    dc = rng.standard_normal((b, hh)).astype(np.float32) if use_dc else np.zeros((b, hh),
                                                                                 np.float32)
    _, vjp = jax.vjp(JR.lstm_cell_ref, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dh), jnp.asarray(dc)))

    ts = [t.requires_grad_() for t in _t(args)]
    hn, cn = TLC.lstm_cell(*ts)
    outs, grads = [hn], [torch.from_numpy(dh)]
    if use_dc:
        outs.append(cn)
        grads.append(torch.from_numpy(dc))
    got = torch.autograd.grad(outs, ts, grads)
    for name, g, w in zip(("x", "h", "c", "wx", "wh", "b"), got, want):
        assert g.shape == w.shape, name
        assert _err(g, w) < TOL, name


def test_backward_float64_gradcheck():
    args = [t.double().requires_grad_() for t in _t(_inputs(11, 3, 5, 4, 7))]
    assert torch.autograd.gradcheck(lambda *a: TLC.LSTMCellFunction.apply(*a), args,
                                     eps=1e-6, atol=1e-7, rtol=1e-5)


def test_bwd_pointwise_plain_dc_none_equals_zero():
    _, _, c, *_ = _t(_inputs(5, 3, 4, 4, 9))
    gates = torch.rand(3, 4, 9)
    dh = torch.randn(3, 9)
    a = TLC.lstm_cell_bwd_pointwise(gates, c, dh, None)
    z = TLC.lstm_cell_bwd_pointwise(gates, c, dh, torch.zeros(3, 9))
    assert torch.equal(a[0], z[0]) and torch.equal(a[1], z[1])
    assert a[0].shape == (3, 4, 9) and a[1].shape == (3, 9)


def test_cpu_path_launches_no_kernel():
    before = (TLC.lstm_cell_fwd.launches, TLC.lstm_cell_bwd_pointwise.launches)
    ts = [t.requires_grad_() for t in _t(_inputs(2, 2, 4, 4, 6))]
    hn, cn = TLC.lstm_cell(*ts)
    (hn.sum() + cn.sum()).backward()
    assert (TLC.lstm_cell_fwd.launches, TLC.lstm_cell_bwd_pointwise.launches) == before


def test_wrappers_refuse_a_device_that_is_not_cpu_or_cuda():
    """The CPU path is chosen by the tensors' device alone; other devices
    are refused, never given the plain version."""
    x, h, c, wx, wh, b = (t.to("meta") for t in _t(_inputs(1, 2, 4, 4, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        TLC.lstm_cell_fwd(x, h, c, wx, wh, b)
    with pytest.raises(ValueError, match="CUDA"):
        TLC.lstm_cell_bwd_pointwise(torch.zeros(2, 4, 8, device="meta"), c, c)
    with pytest.raises(ValueError, match="shapes"):
        TLC.lstm_cell_fwd(x, h, c, wx[:, :3], wh, b)


def _layer_params(seed, d_in, d_h, d_proj):
    p = JM.lstm_cell_init(jax.random.PRNGKey(seed), d_in, d_h, d_proj)
    p["b"] = jax.random.normal(jax.random.PRNGKey(seed + 1), p["b"].shape) * 0.1
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("d_proj", [12, 0])
def test_model_cell_matches_jax(d_proj):
    jp, tp = _layer_params(0, 10, 20, d_proj)
    rng = np.random.default_rng(1)
    d_out = d_proj or 20
    x, h, c = (rng.standard_normal(s).astype(np.float32) for s in ((3, 10), (3, d_out),
                                                                     (3, 20)))
    (jh, jc), jo = JM.lstm_cell(jp, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    (th, tc), to = TM.lstm_cell(tp, torch.from_numpy(x), (torch.from_numpy(h),
                                                          torch.from_numpy(c)))
    assert _err(th, jh) < TOL and _err(tc, jc) < TOL and _err(to, jo) < TOL


@pytest.mark.parametrize("d_proj,with_state", [(12, True), (0, False)])
def test_model_layer_forward_and_grads_match_jax(d_proj, with_state):
    """The layer's autograd function (kernels per step, weight gradients once
    over all steps) against JAX AD through the scanned plain cell, from a
    given or a zero initial state."""
    jp, tp = _layer_params(2, 10, 20, d_proj)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((3, 7, 10)).astype(np.float32)
    d_out = d_proj or 20
    dys = rng.standard_normal((3, 7, d_out)).astype(np.float32)
    state = tuple(rng.standard_normal(s).astype(np.float32) for s in ((3, d_out), (3, 20)))

    def jfn(p, x, st):
        ys, (h, c) = JM.lstm_layer(p, x, st if with_state else None)
        return ys, h, c

    (jys, jh, jc), vjp = jax.vjp(jfn, jp, jnp.asarray(xs), tuple(map(jnp.asarray, state)))
    dh = rng.standard_normal(jh.shape).astype(np.float32)
    dc = rng.standard_normal(jc.shape).astype(np.float32)
    jg_p, jg_x, jg_s = vjp((jnp.asarray(dys), jnp.asarray(dh), jnp.asarray(dc)))

    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(xs).requires_grad_()
    ts = tuple(torch.from_numpy(a).requires_grad_() for a in state)
    tys, (th, tc) = TM.lstm_layer(tp, tx, ts if with_state else None)
    assert _err(tys, jys) < TOL and _err(th, jh) < TOL and _err(tc, jc) < TOL
    wrt = [tx, *tp.values(), *(ts if with_state else ())]
    grads = torch.autograd.grad((tys, th, tc), wrt, (torch.from_numpy(dys),
                                                     torch.from_numpy(dh),
                                                     torch.from_numpy(dc)))
    assert _err(grads[0], jg_x) < TOL
    for (k, _), g in zip(tp.items(), grads[1:]):
        assert _err(g, jg_p[k]) < TOL, k
    if with_state:
        assert _err(grads[-2], jg_s[0]) < TOL and _err(grads[-1], jg_s[1]) < TOL
    with torch.no_grad():                      # the inference loop, no gates written
        nys, _ = TM.lstm_layer({k: v.detach() for k, v in tp.items()}, tx.detach(),
                               tuple(t.detach() for t in ts) if with_state else None)
    assert _err(nys, jys) < TOL


def test_unported_lstm_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        TM.lstm_layer_overlapped()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 6"):
        TM.biglstm_forward_pipeline()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11"):
        TM.gnmt_forward()


def _variant_inputs(dtype, b=4, d_in=16, d_h=24, hh=32, x_offset=0, x_ld=None):
    """x as a row view (row stride ``x_ld``, base ``x_offset`` elements into
    its storage), h, wx, wh contiguous."""
    x_ld = x_ld or d_in
    store = torch.zeros(x_offset + b * x_ld, dtype=dtype)
    x = store[x_offset:].view(b, x_ld)[:, :d_in]
    return (x, torch.zeros(b, d_h, dtype=dtype), torch.zeros(d_in, 4, hh, dtype=dtype),
            torch.zeros(d_h, 4, hh, dtype=dtype))


@pytest.mark.parametrize("kw,want", [
    ({}, "tc"), ({"b": 1}, "tc"), ({"b": 17}, "tc"),
    ({"x_ld": 48}, "tc"),                          # a row view xs[:, t] of (B, T, d_in)
    ({"b": 1, "x_ld": 21}, "tc"),                  # one row: its stride is never used
    ({"d_in": 20}, "fma"), ({"d_h": 12}, "fma"), ({"hh": 36}, "fma"),
    ({"x_ld": 20}, "fma"),                         # rows 40 bytes apart
    ({"x_offset": 4}, "fma"),                      # base 8 bytes off
    ({"x_offset": 8}, "tc")])
def test_lstm_variant_takes_the_tensor_cores_on_aligned_bf16(kw, want):
    assert TLC.lstm_variant(*_variant_inputs(torch.bfloat16, **kw)) == want
    assert TLC.lstm_variant(*_variant_inputs(torch.float32, **kw)) == "fma"


def test_lstm_variant_of_the_models_layer_views():
    """The layer's per-step views: x = xs[:, t] of (B, T, d_in) and h = hs[t]
    of (T + 1, B, d_out), at BigLSTM's widths cut in H."""
    xs = torch.zeros(16, 5, 1024, dtype=torch.bfloat16)
    hs = torch.zeros(6, 16, 1024, dtype=torch.bfloat16)
    wx = torch.zeros(1024, 4, 64, dtype=torch.bfloat16)
    wh = torch.zeros(1024, 4, 64, dtype=torch.bfloat16)
    assert all(TLC.lstm_variant(xs[:, t], hs[t], wx, wh) == "tc" for t in range(5))
    assert TLC.VARIANTS == ("fma", "tc")


def test_cpu_forward_counts_no_variant():
    before = dict(TLC.lstm_cell_fwd.variant_launches)
    TLC.lstm_cell_fwd(*_t(_inputs(4, 2, 8, 8, 16), torch.bfloat16)[:5],
                      torch.zeros(4, 16))
    assert TLC.lstm_cell_fwd.variant_launches == before
