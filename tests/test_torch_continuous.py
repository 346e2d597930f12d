"""Continuous batching in the port: slot mode, chunked prefill, ragged
prompts and the sliding window, held against the JAX package on the same
weights (``repro_torch.interop.params_from_jax``), and the continuous
engine's lifecycle on its own.

Config: reduced llama3_2_1b (2 layers, d_model 256, fp32) with 2 KV heads
for 4 query heads, as tests/test_torch_serve.py, and one reduced
granite_moe_1b_a400m case.  Tolerance 1e-4 on logits, caches and logprobs:
fp32 sums through 2 layers in another order (the port inserts into the
cache and attends over it with per-row key lengths, where JAX concatenates
the new keys under an explicit mask).  Greedy tokens must be equal.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models.api import build_model as j_build_model
from repro.models.api import cache_evict_slot as j_evict
from repro.models.api import cache_extract_slot as j_extract
from repro.models.api import cache_insert_slot as j_insert
from repro.models.api import make_slot_cache as j_make_slot_cache
from repro.serve.continuous import ContinuousEngine as JContinuousEngine
from repro.serve.continuous import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api as A
from repro_torch.models import layers as L
from repro_torch.models.api import build_model as t_build_model
from repro_torch.serve.continuous import ContinuousEngine, Request
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.steps import make_continuous_steps
from torch_threads import cli_env, one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = 1e-4
B, S = 3, 12
LENS = [12, 7, 9]                # ragged prompts: each row's valid prefix


def _cfgs(arch="llama3_2_1b"):
    return tuple(dataclasses.replace(g(arch).reduced(), n_kv_heads=2)
                 if arch == "llama3_2_1b" else g(arch).reduced()
                 for g in (j_get_config, t_get_config))


def _pair(arch):
    jcfg, tcfg = _cfgs(arch)
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, japi=japi, jparams=jparams,
                tapi=t_build_model(tcfg, device="cpu"), tparams=tparams, tokens=tokens)


@pytest.fixture(scope="module")
def models():
    return _pair("llama3_2_1b")


@pytest.fixture(scope="module")
def port():
    """The port alone (its own seeded init) for the engine's lifecycle."""
    _, tcfg = _cfgs()
    api = t_build_model(tcfg, device="cpu")
    return api, api.init(0)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _slot_caches(m):
    """Both packages' prefill of the (B, S) tokens into a linear cache of
    capacity S + 8, then each row's position set to its ragged length."""
    cap = S + 8
    _, jc = m["japi"].prefill(m["jparams"], {"tokens": jnp.asarray(m["tokens"])}, None,
                              capacity=cap, window=0)
    _, tc = m["tapi"].prefill(m["tparams"], {"tokens": torch.from_numpy(m["tokens"]).long()},
                              None, capacity=cap, window=0)
    jc["pos"] = jnp.asarray(LENS, jnp.int32)
    tc["pos"] = torch.tensor(LENS, dtype=torch.int32)
    return jc, tc


@pytest.mark.parametrize("t,window", [(1, 0), (3, 0), (1, 4), (3, 4)])
def test_slot_decode_matches_jax(models, t, window):
    """Slot mode with mixed per-row positions: t = 1 is the decode tick,
    t = 3 the chunked-prefill extend step (causal within the chunk); a
    window is a mask over the linear cache, counted from each row."""
    m = models
    jc, tc = _slot_caches(m)
    step = np.random.default_rng(t).integers(0, m["jcfg"].vocab_size, (B, t), dtype=np.int32)
    for _ in range(2):
        jlog, jc = m["japi"].decode_fn(m["jparams"], jc, {"tokens": jnp.asarray(step)},
                                       window=window)
        tlog, tc = m["tapi"].decode_fn(m["tparams"], tc, {"tokens": torch.from_numpy(step).long()},
                                       window=window)
        assert _err(tlog, jlog) < TOL
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
        assert tc["pos"].dtype == torch.int32
        step = np.array(jnp.argmax(jlog, -1), np.int32)
    for name in ("k", "v"):
        assert _err(tc[name], jc[name]) < TOL


def test_window_ring_prefill_and_decode_match_jax(models):
    """A scalar-position window: the prefill attends under the window and
    fills the shift-left ring (its last W keys right-aligned), and each
    decode step shifts the ring and attends over its last min(pos, W-1) + 1
    slots."""
    m, w = models, 5
    tok = m["tokens"]
    jlog, jc = m["japi"].prefill(m["jparams"], {"tokens": jnp.asarray(tok)}, None,
                                 capacity=S + 8, window=w)
    tlog, tc = m["tapi"].prefill(m["tparams"], {"tokens": torch.from_numpy(tok).long()}, None,
                                 capacity=S + 8, window=w)
    assert tuple(tc["k"].shape) == jc["k"].shape and tc["k"].shape[2] == w
    assert _err(tlog, jlog) < TOL
    for name in ("k", "v"):
        assert _err(tc[name], jc[name]) < TOL
    nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for _ in range(3):
        jlog, jc = m["japi"].decode_fn(m["jparams"], jc, {"tokens": jnp.asarray(nxt)}, window=w)
        tlog, tc = m["tapi"].decode_fn(m["tparams"], tc, {"tokens": torch.from_numpy(nxt).long()},
                                       window=w)
        assert _err(tlog, jlog) < TOL
        nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for name in ("k", "v"):
        assert _err(tc[name], jc[name]) < TOL
    # a short prompt leaves the ring's left pad zero
    _, tc = m["tapi"].prefill(m["tparams"], {"tokens": torch.from_numpy(tok[:, :3]).long()},
                              None, window=w)
    assert bool((tc["k"][:, :, :w - 3] == 0).all()) and bool((tc["k"][:, :, w - 3:] != 0).any())


def test_granite_slot_decode_matches_jax():
    """Slot mode on the MoE decoder: decode keeps the no-drop capacity."""
    m = _pair("granite_moe_1b_a400m")
    jc, tc = _slot_caches(m)
    step = m["tokens"][:, :2]
    jlog, jc = m["japi"].decode_fn(m["jparams"], jc, {"tokens": jnp.asarray(step)})
    tlog, tc = m["tapi"].decode_fn(m["tparams"], tc, {"tokens": torch.from_numpy(step).long()})
    assert _err(tlog, jlog) < TOL
    for name in ("k", "v"):
        assert _err(tc[name], jc[name]) < TOL


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3), (False, 0), (False, 5)])
def test_flash_ref_kv_lens_matches_jax_mask(causal, window):
    """The plain version with per-row key lengths against JAX's dense
    attention under the slot-mode mask built from the same lengths."""
    rng = np.random.default_rng(7)
    b, tq, tk, h, hkv, hd = 3, 4, 16, 4, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, tq, h, hd), (b, tk, hkv, hd), (b, tk, hkv, hd)))
    lens = np.array([4, 11, 16], np.int32)
    qpos = lens[:, None] - tq + np.arange(tq)[None]                       # (b, tq)
    kpos = np.arange(tk)
    valid = (kpos[None, None] < lens[:, None, None]) & np.ones((b, tq, 1), bool)
    if causal:
        valid &= kpos[None, None] <= qpos[..., None]
    if window:
        valid &= kpos[None, None] > qpos[..., None] - window
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(valid))
    got = flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                              window=window, kv_lens=torch.from_numpy(lens))
    assert _err(got, want) < 1e-5
    # the wrapper takes the plain version on CPU tensors, and checks the lengths
    assert torch.equal(flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                       window=window, kv_lens=torch.from_numpy(lens)), got)


@pytest.mark.parametrize("lens,match", [([3, 11, 16], r"\[Tq, Tk\]"), ([4, 11, 17], r"\[Tq, Tk\]"),
                                        ([4, 11], "int32 tensor")])
def test_flash_kv_lens_checked_on_cpu(lens, match):
    q, k = torch.zeros(3, 4, 4, 32), torch.zeros(3, 16, 2, 32)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k, kv_lens=torch.tensor(lens, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        flash_attention(q, k, k, kv_lens=torch.tensor([4, 11, 16]))
    with pytest.raises(ValueError, match="contiguous"):      # the kernel reads it by pointer
        flash_attention(q, k, k, kv_lens=torch.tensor([4, 0, 11, 0, 16, 0],
                                                      dtype=torch.int32)[::2])


def test_cache_insert_at_matches_jax():
    rng = np.random.default_rng(3)
    cache = {n: rng.standard_normal((3, 10, 2, 8)).astype(np.float32) for n in ("k", "v")}
    kn, vn = (rng.standard_normal((3, 2, 2, 8)).astype(np.float32) for _ in range(2))
    pos = np.array([0, 5, 8], np.int32)
    want = JL.cache_insert_at({n: jnp.asarray(c) for n, c in cache.items()},
                              jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
    tc = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    got = L.cache_insert_at(tc, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(pos))
    assert got is tc                                   # in place
    for n in ("k", "v"):
        assert np.array_equal(_np(got[n]), np.asarray(want[n]))
    # JAX would clamp 9 to 8 silently; the port raises
    with pytest.raises(ValueError, match="overflows capacity"):
        L.cache_insert_at(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.tensor([0, 5, 9], dtype=torch.int32))
    # the ring insert: JAX's shift-left concatenate, in place
    ring = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    jr = JL.cache_insert_window({"k": jnp.asarray(ring), "v": jnp.asarray(ring)},
                                jnp.asarray(kn[:, :1]), jnp.asarray(vn[:, :1]))
    tr = {"k": torch.from_numpy(ring.copy()), "v": torch.from_numpy(ring.copy())}
    L.cache_insert_window(tr, torch.from_numpy(kn[:, :1]), torch.from_numpy(vn[:, :1]))
    for n in ("k", "v"):
        assert np.array_equal(_np(tr[n]), np.asarray(jr[n]))


def test_slot_helpers_match_jax(models):
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    jc = j_make_slot_cache(jcfg, 3, 8, dtype=jnp.float32)
    tc = A.make_slot_cache(tcfg, 3, 8, dtype=torch.float32, device="cpu")
    assert tuple(tc["k"].shape) == jc["k"].shape and tc["pos"].dtype == torch.int32
    rng = np.random.default_rng(5)
    fill = rng.standard_normal(jc["k"].shape).astype(np.float32)
    jc = dict(jc, k=jnp.asarray(fill), v=jnp.asarray(-fill), pos=jnp.asarray([3, 5, 7], jnp.int32))
    tc.update(k=torch.from_numpy(fill.copy()), v=torch.from_numpy(-fill),
              pos=torch.tensor([3, 5, 7], dtype=torch.int32))
    jsl, tsl = j_extract(jc, 1), A.cache_extract_slot(tc, 1)
    for n in ("k", "v", "pos"):
        assert np.array_equal(_np(tsl[n]), np.asarray(jsl[n]))
    # the port's slot is a view: writes land in the slotted cache, and
    # inserting it back only writes the position
    assert tsl["k"].data_ptr() == tc["k"][:, 1:2].data_ptr()
    tsl["k"][:, :, 0] = 9.0
    assert bool((tc["k"][:, 1, 0] == 9.0).all())
    A.cache_insert_slot(tc, {**tsl, "pos": tsl["pos"] + 2}, 1)
    assert tc["pos"].tolist() == [3, 7, 7]
    # slot 1's contents written through slot 2's views, then its pos
    # inserted, give JAX's insert of slot 1 into slot 2
    sl2 = A.cache_extract_slot(tc, 2)
    for n in ("k", "v"):
        sl2[n].copy_(torch.from_numpy(np.array(jsl[n])))
    A.cache_insert_slot(tc, {**sl2, "pos": torch.from_numpy(np.array(jsl["pos"]))}, 2)
    jins = j_insert(jc, jsl, 2)
    for n in ("k", "v"):
        assert np.array_equal(_np(tc[n][:, 2]), np.asarray(jins[n][:, 2]))
    assert tc["pos"][2] == int(jins["pos"][2])
    jev, tev = j_evict(jc, 0), A.cache_evict_slot(tc, 0)
    assert tev is tc and tc["pos"][0] == int(jev["pos"][0]) == 0
    assert bool((tc["k"][:, 0] == 0).all())
    with pytest.raises(ValueError, match="slotted KV serving"):
        A.make_slot_cache(t_get_config("rwkv6_7b").reduced(), 2, 8, device="cpu")


def test_ragged_generate_matches_jax(models):
    m = models
    jres = JServeEngine(m["japi"], m["jparams"]).generate(
        {"tokens": jnp.asarray(m["tokens"])}, max_new_tokens=5, prompt_lens=LENS)
    tres = ServeEngine(m["tapi"], m["tparams"]).generate(
        {"tokens": torch.from_numpy(m["tokens"]).long()}, max_new_tokens=5, prompt_lens=LENS)
    assert np.array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    assert _err(tres.logprobs, jres.logprobs) < TOL


def test_continuous_run_matches_jax(models):
    """More requests than slots, prompts in chunks of 4: every request's
    greedy tokens are JAX's, its logprobs within 1e-4."""
    m = models
    prompts = [m["tokens"][i, :n].tolist() for i, n in enumerate(LENS)]
    kw = dict(n_slots=2, capacity=S + 8, prefill_chunk=4)
    jout = JContinuousEngine(m["japi"], m["jparams"], **kw).run(
        [JRequest(rid=i, tokens=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    tout = ContinuousEngine(m["tapi"], m["tparams"], **kw).run(
        [Request(rid=i, tokens=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    for j, t in zip(jout, tout, strict=True):
        assert (t.rid, t.tokens, t.finished_reason) == (j.rid, j.tokens, j.finished_reason)
        assert _err(t.logprobs, j.logprobs) < TOL


# ---------------------------------------------------------------------------
# the engine's lifecycle (the port's counterparts of tests/test_serve_continuous.py)
# ---------------------------------------------------------------------------

def _solo(port, prompt, max_new, **kw):
    api, params = port
    eng = ContinuousEngine(api, params, n_slots=2, capacity=32, **kw)
    return eng.run([Request(rid=0, tokens=prompt, max_new_tokens=max_new)])[0]


def test_first_token_time_per_lifetime_and_bounded_state(port, monkeypatch):
    """Time to first token is measured per request lifetime (a resubmitted
    rid gets its own), and no per-rid or per-tick timing state outlives its
    request."""
    import repro_torch.serve.continuous as C
    api, params = port
    now = [0.0]
    monkeypatch.setattr(C, "time", type("T", (), {"perf_counter": staticmethod(lambda: now[0])}))
    eng = ContinuousEngine(api, params, n_slots=1, capacity=32)
    firsts = []
    for start, wait in ((0.0, 5.0), (100.0, 2.0)):
        now[0] = start
        eng.submit(Request(rid=7, tokens=[1, 2, 3], max_new_tokens=3))
        now[0] = start + wait
        while eng.step():
            pass
        firsts.append(eng.results[-1].first_token_s)
    assert firsts == [5.0, 2.0]
    assert eng._submitted == {} and eng.decode_ticks == 4
    assert eng.tick_ms_sum == eng.tick_ms_min == eng.tick_ms_max == 0.0
    # a request shed or expired before its first token has none
    eng = ContinuousEngine(api, params, n_slots=1, capacity=32, max_queue=0)
    assert eng.submit(Request(rid=1, tokens=[1], max_new_tokens=2)).first_token_s is None


def test_midflight_join_bit_identical(port):
    """A request joining a busy batch gets exactly its solo tokens and
    logprobs, and the request it joined is not perturbed."""
    api, params = port
    p0, p1 = list(range(1, 6)), list(range(7, 10))
    solo0, solo1 = _solo(port, p0, 6), _solo(port, p1, 6)
    eng = ContinuousEngine(api, params, n_slots=2, capacity=32)
    eng.submit(Request(rid=0, tokens=p0, max_new_tokens=6))
    for _ in range(3):
        eng.step()
    eng.submit(Request(rid=1, tokens=p1, max_new_tokens=6))
    while eng.step():
        pass
    res = {r.rid: r for r in eng.results}
    assert (res[0].tokens, res[0].logprobs) == (solo0.tokens, solo0.logprobs)
    assert (res[1].tokens, res[1].logprobs) == (solo1.tokens, solo1.logprobs)


def test_chunked_prefill_equals_one_shot(port):
    prompt = list(range(1, 8))
    one_shot = _solo(port, prompt, 5)
    for chunk in (1, 3):
        chunked = _solo(port, prompt, 5, prefill_chunk=chunk)
        assert chunked.tokens == one_shot.tokens, chunk
        np.testing.assert_allclose(chunked.logprobs, one_shot.logprobs, rtol=1e-5, atol=1e-5)


def test_slot_eviction_and_reuse(port):
    api, params = port
    eng = ContinuousEngine(api, params, n_slots=2, capacity=32)
    prompts = [[1 + i, 2 + i, 3 + i] for i in range(4)]
    out = eng.run([Request(rid=i, tokens=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert [r.rid for r in out] == [0, 1, 2, 3]
    assert all(r.finished_reason == "length" for r in out)
    for i, r in enumerate(out):
        assert r.tokens == _solo(port, prompts[i], 4).tokens, i


def test_matches_static_engine_greedy(port):
    api, params = port
    prompt = list(range(1, 6))
    ref = ServeEngine(api, params).generate({"tokens": torch.tensor([prompt])},
                                            max_new_tokens=6)
    assert _solo(port, prompt, 6).tokens == ref.tokens[0].tolist()


def test_eos_finishes_and_frees_slot(port):
    api, params = port
    p = list(range(1, 6))
    first = _solo(port, p, 1).tokens[0]
    eng = ContinuousEngine(api, params, n_slots=1, capacity=32)
    out = eng.run([Request(rid=0, tokens=p, max_new_tokens=8, eos_id=first),
                   Request(rid=1, tokens=[9, 8, 7], max_new_tokens=3)])
    assert out[0].finished_reason == "eos" and out[0].tokens == [first]
    assert out[1].tokens == _solo(port, [9, 8, 7], 3).tokens


def test_temperature_reproducible_and_batch_independent(port):
    api, params = port
    p0, p1 = list(range(1, 6)), list(range(7, 10))
    a = _solo(port, p0, 6, temperature=1.0, seed=3)
    assert a.tokens == _solo(port, p0, 6, temperature=1.0, seed=3).tokens
    assert a.tokens != _solo(port, p0, 6, temperature=1.0, seed=4).tokens
    eng = ContinuousEngine(api, params, n_slots=2, capacity=32, temperature=1.0, seed=3)
    out = eng.run([Request(rid=0, tokens=p0, max_new_tokens=6),
                   Request(rid=1, tokens=p1, max_new_tokens=6)])
    assert out[0].tokens == a.tokens


def test_slot_capacity_overflow_rejected(port):
    api, params = port
    eng = ContinuousEngine(api, params, n_slots=2, capacity=8)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        eng.submit(Request(rid=0, tokens=list(range(6)), max_new_tokens=4))


@pytest.mark.parametrize("max_new", [4, 0])
def test_request_filling_capacity_exactly(port, max_new):
    """prompt + max_new == capacity: every write stays inside the slot (the
    port raises where JAX would clamp), beside a request in the other slot
    that keeps decoding; max_new 0 leaves a finished slot at pos ==
    capacity through a tick."""
    api, params = port
    cap = 10
    eng = ContinuousEngine(api, params, n_slots=2, capacity=cap)
    out = eng.run([Request(rid=0, tokens=list(range(1, cap - max_new + 1)),
                           max_new_tokens=max_new),
                   Request(rid=1, tokens=[3, 4], max_new_tokens=6)])
    assert len(out[0].tokens) == max_new and out[0].finished_reason == "length"
    assert out[1].tokens == _solo(port, [3, 4], 6).tokens


def test_deadline_evicts_stalled_request_and_frees_admission(port):
    api, params = port
    now = [0.0]
    eng = ContinuousEngine(api, params, n_slots=1, capacity=64, clock=lambda: now[0])
    eng.submit(Request(rid=0, tokens=[1, 2, 3], max_new_tokens=50, deadline_s=5.0))
    eng.submit(Request(rid=1, tokens=[9, 8, 7], max_new_tokens=3))
    for _ in range(4):
        eng.step()
    assert not any(r.rid == 1 for r in eng.results)
    now[0] = 10.0
    while eng.step():
        pass
    res = {r.rid: r for r in eng.results}
    assert res[0].finished_reason == "timed_out" and 0 < len(res[0].tokens) < 50
    assert len(res[0].logprobs) == len(res[0].tokens)
    assert res[1].finished_reason == "length"
    assert res[1].tokens == _solo(port, [9, 8, 7], 3).tokens


def test_deadline_expires_queued_request_without_admission(port):
    api, params = port
    now = [0.0]
    eng = ContinuousEngine(api, params, n_slots=1, capacity=32, clock=lambda: now[0])
    eng.submit(Request(rid=0, tokens=[1, 2, 3], max_new_tokens=4))
    eng.step()
    eng.submit(Request(rid=1, tokens=[4, 5], max_new_tokens=2, deadline_s=1.0))
    now[0] = 2.0
    while eng.step():
        pass
    res = {r.rid: r for r in eng.results}
    assert res[1].finished_reason == "timed_out" and res[1].tokens == res[1].logprobs == []
    assert res[0].tokens == _solo(port, [1, 2, 3], 4).tokens


def test_state_arch_rejected_with_shaped_error():
    api = t_build_model(t_get_config("rwkv6_7b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="slotted KV serving"):
        ContinuousEngine(api, None, n_slots=2, capacity=32)
    with pytest.raises(ValueError, match="prompt_lens needs per-request cache positions"):
        ServeEngine(api, api.init(0)).generate({"tokens": torch.zeros(2, 4, dtype=torch.long)},
                                               max_new_tokens=1, prompt_lens=[4, 3])


def test_ragged_generate_checks(port):
    api, params = port
    tok = {"tokens": torch.zeros(2, 4, dtype=torch.long)}
    for kw, match in (({"prompt_lens": [4]}, "prompt_lens shape"),
                      ({"prompt_lens": [4, 5]}, r"lie in \[1, 4\]"),
                      ({"prompt_lens": [4, 3], "window": 2}, "sliding-window ring")):
        window = kw.pop("window", None)
        with pytest.raises(ValueError, match=match):
            ServeEngine(api, params, window=window).generate(tok, max_new_tokens=1, **kw)


def test_duplicate_inflight_rid_rejected(port):
    api, params = port
    eng = ContinuousEngine(api, params, n_slots=1, capacity=32)
    eng.submit(Request(rid=3, tokens=[1, 2], max_new_tokens=4))
    with pytest.raises(ValueError, match="rid 3 is already in flight"):
        eng.submit(Request(rid=3, tokens=[5, 6], max_new_tokens=4))
    eng.step()
    with pytest.raises(ValueError, match="rid 3 is already in flight"):
        eng.submit(Request(rid=3, tokens=[5, 6], max_new_tokens=4))
    while eng.step():
        pass
    assert eng.submit(Request(rid=3, tokens=[5, 6], max_new_tokens=2)) is None
    while eng.step():
        pass
    assert sum(r.rid == 3 for r in eng.results) == 2


def test_max_queue_overflow_sheds_with_shaped_result(port):
    api, params = port
    eng = ContinuousEngine(api, params, n_slots=1, capacity=32, max_queue=1)
    assert eng.submit(Request(rid=0, tokens=[1, 2], max_new_tokens=3)) is None
    shed = eng.submit(Request(rid=1, tokens=[3, 4], max_new_tokens=3))
    assert shed is not None and shed.finished_reason == "shed" and shed.tokens == []
    while eng.step():
        pass
    res = {r.rid: r for r in eng.results}
    assert set(res) == {0, 1} and res[1].finished_reason == "shed"
    assert res[0].tokens == _solo(port, [1, 2], 3).tokens


def test_replay_resume_bit_identical(port):
    api, params = port
    prompt = list(range(1, 6))
    solo = _solo(port, prompt, 8)
    for k in (1, 4):
        eng = ContinuousEngine(api, params, n_slots=2, capacity=32)
        res = eng.run([Request(rid=0, tokens=prompt, max_new_tokens=8,
                               replay_tokens=tuple(solo.tokens[:k]),
                               replay_logprobs=tuple(solo.logprobs[:k]))])[0]
        assert (res.tokens, res.logprobs) == (solo.tokens, solo.logprobs), k
    eng = ContinuousEngine(api, params, n_slots=2, capacity=32)
    with pytest.raises(ValueError, match="one logprob per replayed token"):
        eng.submit(Request(rid=0, tokens=prompt, max_new_tokens=8,
                           replay_tokens=(1, 2), replay_logprobs=(0.0,)))
    with pytest.raises(ValueError, match="exceed max_new_tokens"):
        eng.submit(Request(rid=0, tokens=prompt, max_new_tokens=1,
                           replay_tokens=(1, 2), replay_logprobs=(0.0, 0.0)))


def test_poisoned_ticks_return_nan(port):
    api, params = port
    eng = ContinuousEngine(api, params, n_slots=1, capacity=32)
    eng.poison_decode_ticks(1)
    out = eng.run([Request(rid=0, tokens=[1, 2, 3], max_new_tokens=3)])[0]
    assert out.tokens[1] == 0 and np.isnan(out.logprobs[1]) and not np.isnan(out.logprobs[2])


# ---------------------------------------------------------------------------
# routes the port does not run yet, and the launcher
# ---------------------------------------------------------------------------

class _Pair:
    """What ``make_continuous_steps`` reads of a mesh before any message:
    place 0 of a model axis of 2, one data group."""
    shape = {"data": 1, "model": 2}
    data_index = 0

    def size(self, axis):
        return self.shape[axis]

    def ring(self, axis):
        return 0, 2, 1, 1


@pytest.mark.parametrize("kw,err,match", [
    ({"arch": "granite_moe_1b_a400m", "model_axis": "model"}, ValueError,
     "homogeneous dense decoder"),
    ({"model_axis": "model", "context_axis": "model"}, ValueError,
     "one axis beside the data axis"),
    ({"mesh": None, "model_axis": "model"}, ValueError, "none was given")])
def test_sharded_steps_raise_their_items(port, kw, err, match):
    """What the sharded steps do not run: an MoE model under tensor MP (JAX's
    tick has no sharded MoE either: ``decode_slots_tp_supported``), and a
    model and a context axis together, or an axis without a mesh, are
    refused."""
    kw = dict(kw)
    api = port[0]
    if "arch" in kw:
        api = t_build_model(t_get_config(kw.pop("arch")).reduced(), device="cpu")
    kw.setdefault("mesh", _Pair())
    with pytest.raises(err, match=match):
        make_continuous_steps(api, n_slots=2, **kw)


def test_engine_refuses_a_mesh(port):
    # no sharding argument is ignored: a mesh alone raises before any cache is made
    with pytest.raises(ValueError, match="shards nothing"):
        ContinuousEngine(port[0], None, n_slots=2, capacity=32, mesh=object())


@pytest.mark.parametrize("flag,want", [
    (["--replicas", "2"], "replicas=2, tp=1, completed=3, shed=0, timed_out=0, failovers=0, "
                          "states=['healthy', 'healthy']"),
    (["--replicas", "2", "--fault", "kill@2:0"], "failovers=2, states=['dead', 'healthy']"),
    (["--fault", "stall@2:0:0.01"], "replicas=1, tp=1, completed=3"),
    (["--max-queue", "1"], "completed=1, shed=2"),
    (["--watchdog", "1"], SystemExit)])
def test_launch_serve_refuses_unported_flags(flag, want, capsys):
    """The router's flags: ``--replicas``, ``--fault`` and ``--max-queue``
    each serve through ``ReplicaRouter`` on the CPU (JAX's line, with the
    stats and states of the run); ``--watchdog`` alone exits naming the
    flags that build a router."""
    argv = ["--arch", "llama3_2_1b", "--reduced", "--device", "cpu", "--continuous",
            "--slots", "1", "--batch", "3", "--prompt-len", "5", "--max-new", "3", *flag]
    if want is SystemExit:
        with pytest.raises(SystemExit, match="--replicas N .*--fault or --max-queue"):
            launch_serve.main(argv)
        return
    launch_serve.main(argv)
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("[serve] router:"))
    assert want in line, line


def test_launch_serve_router_needs_the_continuous_engine():
    with pytest.raises(SystemExit, match="add --continuous"):
        launch_serve.main(["--arch", "llama3_2_1b", "--reduced", "--device", "cpu",
                           "--replicas", "2"])


def test_launcher_serves_on_ranks(capfd):
    """``--continuous --tp 2`` on the CPU: 2 gloo ranks, rank 0's line with
    tp=2, the kernels' launches summed over the ranks (0 on the CPU)."""
    launch_serve.main(["--arch", "llama3_2_1b", "--reduced", "--device", "cpu", "--continuous",
                       "--tp", "2", "--slots", "2", "--prefill-chunk", "4", "--batch", "3",
                       "--prompt-len", "7", "--max-new", "3"])
    out = capfd.readouterr().out
    assert "[dist] backend=gloo ranks=2 cards=0 (cpu)" in out
    assert "[serve] continuous llama3.2-1b on cpu" in out and "tp=2 dp=1" in out
    assert "9 tokens" in out and "[kernels] flash_attention=0" in out


def test_launch_serve_continuous_cli_runs_on_cpu():
    env = cli_env()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3_2_1b",
         "--reduced", "--device", "cpu", "--continuous", "--slots", "2",
         "--prefill-chunk", "4", "--batch", "3", "--prompt-len", "8", "--max-new", "3"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] continuous llama3.2-1b on cpu" in proc.stdout
    assert "9 tokens" in proc.stdout and "ms/tick" in proc.stdout
    assert "[kernels] flash_attention=0" in proc.stdout
