"""The RWKV serving slice as a whole: reduced rwkv6_7b through the port
against the JAX package on the same weights, carried across with
``repro_torch.interop.params_from_jax``.

Config: reduced rwkv6_7b (2 layers, d_model 256, 4 heads of 64, d_ff 512,
vocab 1024, fp32).  The JAX loss runs the sequential scan at T 12 and the
chunked form (``wkv_chunked``, chunk 64) at T 128; its prefill and decode
run the sequential scan from zero and from the cached state.  The port runs
the plain sequential recurrence everywhere (``kernels.wkv6`` on CPU
tensors).  Tolerance 1e-4 on the loss, gradients, logits, caches and
logprobs, as in tests/test_torch_serve.py: fp32 sums in another order
through 2 layers.
"""
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
from repro_torch.launch import train as TL
from repro_torch.models.api import build_model as t_build_model
from repro_torch.serve.engine import ServeEngine as TServeEngine
from torch_threads import cli_env, one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = 1e-4
ARCH = "rwkv6_7b"
B, S, NEW = 2, 12, 6


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = j_get_config(ARCH).reduced(), t_get_config(ARCH).reduced()
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


def _lm_batch(tok):
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    return labels


def test_rwkv_params_round_trip(models):
    layers = models["tparams"]["layers"]
    assert set(layers) == {"ln1", "ln2", "tm", "cm"}
    assert layers["tm"]["u"].shape == (2, 4, 64)
    back = params_to_numpy(models["tparams"], models["tcfg"])
    flat_j = jax.tree_util.tree_leaves_with_path(models["np_params"])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        assert np.array_equal(flat_t[path], leaf), path
    np_layers = dict(models["np_params"]["layers"])
    np_layers["tm"] = dict(np_layers["tm"], wa1=np_layers["tm"]["wa1"][:, :, :-1])
    with pytest.raises(ValueError, match="tm/wa1"):
        params_from_jax(dict(models["np_params"], layers=np_layers), models["tcfg"], "cpu")


def test_port_init_has_the_jax_layout(models):
    tparams = models["tapi"].init(0)
    shapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert shapes == jax.tree.map(lambda a: a.shape, models["np_params"])


@pytest.mark.parametrize("t", [S, 128])
def test_train_loss_matches(models, t):
    """T 12: the JAX loss runs the sequential scan; T 128: ``wkv_chunked``."""
    tok = np.random.default_rng(t).integers(0, models["jcfg"].vocab_size, (B, t),
                                            dtype=np.int32)
    labels = _lm_batch(tok)
    jl, _ = models["japi"].loss_fn(models["jparams"], {"tokens": jnp.asarray(tok),
                                                      "labels": jnp.asarray(labels)})
    tl, tm = models["tapi"].loss_fn(models["tparams"],
                                    {"tokens": torch.from_numpy(tok).long(),
                                     "labels": torch.from_numpy(labels).long()})
    assert float(tm["aux"]) == 0.0
    assert abs(float(jl) - float(tl)) < TOL


def test_loss_gradients_match_jax(models):
    """RWKV trains on the CPU through the plain recurrence: every gradient
    against JAX ``value_and_grad`` of its loss, within 1e-4."""
    tok = models["tokens"]
    labels = _lm_batch(tok)
    (jloss, _), jgrads = jax.value_and_grad(models["japi"].loss_fn, has_aux=True)(
        models["jparams"], {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)})
    tparams = params_from_jax(models["np_params"], models["tcfg"], "cpu")
    paths, leaves = zip(*jax.tree_util.tree_leaves_with_path(tparams))
    for t in leaves:
        t.requires_grad_()
    tloss, _ = models["tapi"].loss_fn(tparams, {"tokens": torch.from_numpy(tok).long(),
                                                "labels": torch.from_numpy(labels).long()})
    keystr = jax.tree_util.keystr
    tgrads = {keystr(p): g for p, g in zip(paths, torch.autograd.grad(tloss, leaves))}
    assert abs(float(tloss.detach()) - float(jloss)) < TOL
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        assert _err(tgrads[keystr(path)], want) < TOL, path
    assert float(tgrads["['layers']['tm']['u']"].abs().max()) > 0


def test_prefill_cache_and_decode_match(models):
    tok = models["tokens"]
    jlog, jc = models["japi"].prefill(models["jparams"], {"tokens": jnp.asarray(tok)},
                                      None, capacity=S + 8)
    tlog, tc = models["tapi"].prefill(models["tparams"],
                                      {"tokens": torch.from_numpy(tok).long()},
                                      None, capacity=S + 8)
    assert tlog.shape == jlog.shape
    assert _err(tlog, jlog) < TOL
    assert set(tc) == set(jc) == {"pos", "wkv_S", "tm_x", "cm_x"}
    assert tc["wkv_S"].shape == (2, B, 4, 64, 64) and tc["wkv_S"].dtype == torch.float32
    for name in ("wkv_S", "tm_x", "cm_x"):
        assert tc[name].shape == jc[name].shape
        assert _err(tc[name], jc[name]) < TOL, name
    assert tc["pos"] == int(jc["pos"]) == S
    state = tc["wkv_S"]
    nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for _ in range(4):
        jlog, jc = models["japi"].decode_fn(models["jparams"], jc,
                                            {"tokens": jnp.asarray(nxt)})
        tlog, tc = models["tapi"].decode_fn(models["tparams"], tc,
                                            {"tokens": torch.from_numpy(nxt).long()})
        assert _err(tlog, jlog) < TOL
        nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    assert tc["wkv_S"] is state                  # decode updated the cache in place
    for name in ("wkv_S", "tm_x", "cm_x"):
        assert _err(tc[name], jc[name]) < TOL, name
    assert int(jc["pos"]) == tc["pos"] == S + 4


def test_greedy_generate_matches(models):
    tok = models["tokens"]
    jres = JServeEngine(models["japi"], models["jparams"]).generate(
        {"tokens": jnp.asarray(tok)}, max_new_tokens=NEW)
    tres = TServeEngine(models["tapi"], models["tparams"]).generate(
        {"tokens": torch.from_numpy(tok).long()}, max_new_tokens=NEW)
    assert np.array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    assert _err(tres.logprobs, jres.logprobs) < TOL
    assert tres.decode_steps == NEW


def test_engine_skips_the_capacity_check(models):
    """An RWKV cache holds state, not positions: any capacity serves, as in
    the JAX engine, with the same tokens as the default one."""
    tok = {"tokens": torch.from_numpy(models["tokens"]).long()}
    eng = TServeEngine(models["tapi"], models["tparams"])
    small = eng.generate(tok, max_new_tokens=NEW, capacity=1)
    assert torch.equal(small.tokens, eng.generate(tok, max_new_tokens=NEW).tokens)


def test_rwkv_training_is_accepted_on_both_devices(monkeypatch):
    """The train launcher hands a RWKV run to its training body on the card
    as on the CPU (the wkv6 backward kernels run under autograd there): no device
    gate is left.  The device is taken as given, so no card is needed."""
    runs = []
    monkeypatch.setattr(TL, "resolve_device", torch.device)
    monkeypatch.setattr(TL, "_train", lambda mesh, run: runs.append((mesh, run)))
    for device in ("cuda", "cpu"):
        TL.main(["--arch", ARCH, "--reduced", "--device", device, "--steps", "1",
                 "--batch", "2", "--seq", "8"])
    assert [(mesh, run.device, run.cfg.name) for mesh, run in runs] == [
        (None, device, t_get_config(ARCH).reduced().name) for device in ("cuda", "cpu")]


def test_launch_serve_rwkv_cli_runs_on_cpu():
    env = cli_env()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
         "--max-new", "3"], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] rwkv6-7b on cpu" in proc.stdout
    assert "[kernels] flash_attention=0 gmm=0 wkv6=0" in proc.stdout
