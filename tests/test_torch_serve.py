"""The serving slice as a whole: the port against the JAX package on the same
weights, carried across with ``repro_torch.interop.params_from_jax``.

Config: reduced llama3_2_1b (2 layers, d_model 256, fp32) with 2 KV heads
for 4 query heads, so grouped-query attention is exercised.  Tolerance 1e-4
on logits, caches and logprobs: the sums run through 2 layers in another
order (and the port's decode inserts into the cache before attending, where
JAX concatenates under a mask).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.api import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models.api import build_model as t_build_model
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = 1e-4
B, S, NEW = 2, 12, 6


def _cfgs():
    return tuple(dataclasses.replace(g("llama3_2_1b").reduced(), n_kv_heads=2)
                 for g in (j_get_config, t_get_config))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tapi = t_build_model(tcfg, device="cpu")
    tparams = params_from_jax(np_params, tcfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S),
                                               dtype=np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, japi=japi, jparams=jparams,
                np_params=np_params, tapi=tapi, tparams=tparams, tokens=tokens)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def test_params_round_trip(models):
    back = params_to_numpy(models["tparams"], models["tcfg"])
    flat_j = jax.tree_util.tree_leaves_with_path(models["np_params"])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        assert np.array_equal(flat_t[path], leaf), path
    bad = dict(models["np_params"], embed=models["np_params"]["embed"][:-1])
    with pytest.raises(ValueError):
        params_from_jax(bad, models["tcfg"], "cpu")


def test_train_forward_loss_matches(models):
    tok = models["tokens"]
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    jl, _ = models["japi"].loss_fn(models["jparams"],
                                   {"tokens": jnp.asarray(tok),
                                    "labels": jnp.asarray(labels)})
    tl, _ = models["tapi"].loss_fn(models["tparams"],
                                   {"tokens": torch.from_numpy(tok).long(),
                                    "labels": torch.from_numpy(labels).long()})
    assert abs(float(jl) - float(tl)) < TOL


def test_prefill_and_decode_match(models):
    cap = S + 8
    tok = models["tokens"]
    jlog, jc = models["japi"].prefill(models["jparams"], {"tokens": jnp.asarray(tok)},
                                      None, capacity=cap)
    tlog, tc = models["tapi"].prefill(models["tparams"],
                                      {"tokens": torch.from_numpy(tok).long()},
                                      None, capacity=cap)
    assert tlog.shape == jlog.shape
    assert _err(tlog, jlog) < TOL
    assert int(jc["pos"]) == tc["pos"] == S
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert _err(tc[name], jc[name]) < TOL
    nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for _ in range(4):
        jlog, jc = models["japi"].decode_fn(models["jparams"], jc,
                                            {"tokens": jnp.asarray(nxt)})
        tlog, tc = models["tapi"].decode_fn(models["tparams"], tc,
                                            {"tokens": torch.from_numpy(nxt).long()})
        assert _err(tlog, jlog) < TOL
        nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    assert int(jc["pos"]) == tc["pos"] == S + 4
    for name in ("k", "v"):
        assert _err(tc[name], jc[name]) < TOL


def test_tied_embeddings_and_padded_vocab_match():
    """Tied embeddings (x scaled by sqrt(d), head = embed^T) and a vocab
    padded from 1000 to 1024, whose padded logits carry the -1e30 bias."""
    jcfg, tcfg = (dataclasses.replace(c, tie_embeddings=True, vocab_size=1000)
                  for c in _cfgs())
    japi = j_build_model(jcfg, remat=False)
    jparams = japi.init(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    assert "lm_head" not in tparams
    tok = np.random.default_rng(1).integers(0, 1000, (B, S), dtype=np.int32)
    jlog, _ = japi.prefill(jparams, {"tokens": jnp.asarray(tok)}, None, capacity=S)
    tlog, _ = t_build_model(tcfg, device="cpu").prefill(
        tparams, {"tokens": torch.from_numpy(tok).long()}, None, capacity=S)
    assert tlog.shape[-1] == 1024
    assert bool((tlog[..., 1000:] <= -1e29).all())
    assert _err(tlog, jlog) < TOL


def _generate_both(models, **kw):
    tok = models["tokens"]
    jres = JServeEngine(models["japi"], models["jparams"]).generate(
        {"tokens": jnp.asarray(tok)}, max_new_tokens=NEW, **kw)
    tres = TServeEngine(models["tapi"], models["tparams"]).generate(
        {"tokens": torch.from_numpy(tok).long()}, max_new_tokens=NEW, **kw)
    return jres, tres


def test_greedy_generate_matches(models):
    jres, tres = _generate_both(models)
    assert np.array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    assert _err(tres.logprobs, jres.logprobs) < TOL
    assert tres.decode_steps == NEW and tres.prefill_len == S


def test_eos_freezing_matches(models):
    jres, _ = _generate_both(models)
    eos = int(jres.tokens[0, 2])            # row 0 stops at its third token
    jres, tres = _generate_both(models, eos_id=eos)
    assert np.array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    assert np.array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    assert _err(tres.logprobs, jres.logprobs) < TOL
    assert int(tres.lengths[0]) <= 3
    # every row stopping on its first token exits before any decode step
    firsts = [int(t) for t in np.asarray(jres.tokens[:, 0])]
    jall, tall = _generate_both(models, stop_tokens=firsts)
    assert np.array_equal(tall.tokens.numpy(), np.asarray(jall.tokens))
    assert tall.decode_steps == 0 and tall.lengths.tolist() == [1, 1]


def test_temperature_sampling_is_seeded(models):
    tok = {"tokens": torch.from_numpy(models["tokens"]).long()}

    def engine():
        return TServeEngine(models["tapi"], models["tparams"], temperature=1.0,
                            seed=3)

    e1, e2 = engine(), engine()
    a1 = e1.generate(tok, max_new_tokens=NEW).tokens
    a2 = e1.generate(tok, max_new_tokens=NEW).tokens
    b1 = e2.generate(tok, max_new_tokens=NEW).tokens
    assert torch.equal(a1, b1)               # same seed, same call index
    assert not torch.equal(a1, a2)           # the call counter moves the stream
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    assert torch.equal(e1.generate(tok, max_new_tokens=NEW, generator=g()).tokens,
                       e2.generate(tok, max_new_tokens=NEW, generator=g()).tokens)


def test_capacity_check(models):
    eng = TServeEngine(models["tapi"], models["tparams"])
    tok = {"tokens": torch.from_numpy(models["tokens"]).long()}
    with pytest.raises(ValueError, match="capacity"):
        eng.generate(tok, max_new_tokens=NEW, capacity=S + NEW - 1)


@pytest.mark.parametrize("case", ["window", "moe", "encdec", "hybrid", "slot_pos",
                                  "prompt_lens", "pctx", "biglstm"])
def test_unported_modes_raise(models, case):
    tapi, tparams, tcfg = models["tapi"], models["tparams"], models["tcfg"]
    tok = torch.from_numpy(models["tokens"]).long()
    item = {"biglstm": "ROADMAP.md Queue 1 item 6",
            "moe": "ROADMAP.md Queue 1 item 15",
            "encdec": "ROADMAP.md Queue 1 item 11"}.get(case, "ROADMAP.md Queue 1")
    with pytest.raises(NotImplementedError, match=item):
        if case == "window":
            tapi.prefill(tparams, {"tokens": tok}, window=4)
        elif case == "moe":     # MoE serves on one device; expert parallelism does not
            from repro_torch.models import moe as moe_mod
            moe_mod.moe_ffn(None, torch.zeros(B, S, 8),
                            t_get_config("granite_moe_1b_a400m").reduced(),
                            model_axis="model")
        elif case == "encdec":  # every TPU kernel's family serves; whisper does not
            t_build_model(t_get_config("whisper_large_v3").reduced(), device="cpu")
        elif case == "hybrid":
            t_build_model(t_get_config("hymba_1_5b").reduced(), device="cpu")
        elif case == "slot_pos":
            _, cache = tapi.prefill(tparams, {"tokens": tok}, capacity=S + 2)
            cache["pos"] = torch.full((B,), S)
            tapi.decode_fn(tparams, cache, {"tokens": tok[:, :1]})
        elif case == "prompt_lens":
            TServeEngine(tapi, tparams).generate({"tokens": tok}, max_new_tokens=2,
                                                 prompt_lens=[S, S - 1])
        elif case == "pctx":
            tapi.prefill(tparams, {"tokens": tok}, pctx=object())
        else:
            from repro_torch.models import lstm as lstm_mod
            lstm_mod.biglstm_forward_pipeline(t_get_config("biglstm"), None, {"tokens": tok},
                                              mesh=None, axis="model", n_micro=2)
    assert tcfg.n_kv_heads == 2


def test_launch_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3_2_1b",
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--max-new", "3"], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] llama3.2-1b on cpu" in proc.stdout and "ms/step" in proc.stdout
