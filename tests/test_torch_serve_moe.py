"""The MoE serving slice as a whole: reduced granite_moe_1b_a400m through the
port against the JAX package on the same weights, carried across with
``repro_torch.interop.params_from_jax``.

Config: reduced granite_moe_1b_a400m (2 layers, d_model 256, 4 heads, 4
experts top-2, expert d_ff 256, fp32).  Both sides build with the default
capacity factor 1.25, so prefill may drop tokens (and must drop the same
ones) while decode never drops.  Tolerance 1e-4 on the loss, logits, caches
and logprobs, as in tests/test_torch_serve.py: fp32 sums in another order
through 2 layers.
"""
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
from repro_torch.launch import train as TL
from repro_torch.models.api import build_model as t_build_model
from repro_torch.serve.engine import ServeEngine as TServeEngine

TOL = 1e-4
ARCH = "granite_moe_1b_a400m"
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


def test_moe_params_round_trip(models):
    assert set(models["tparams"]["layers"]["moe"]) == {"router", "wi", "wg", "wo"}
    assert "mlp" not in models["tparams"]["layers"]
    back = params_to_numpy(models["tparams"], models["tcfg"])
    flat_j = jax.tree_util.tree_leaves_with_path(models["np_params"])
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        assert np.array_equal(flat_t[path], leaf), path
    layers = dict(models["np_params"]["layers"])
    layers["moe"] = dict(layers["moe"], wo=layers["moe"]["wo"][:, :-1])
    with pytest.raises(ValueError, match="moe/wo"):
        params_from_jax(dict(models["np_params"], layers=layers), models["tcfg"], "cpu")


def test_shared_expert_layout_round_trips():
    jcfg = j_get_config("kimi_k2_1t_a32b").reduced()
    tcfg = t_get_config("kimi_k2_1t_a32b").reduced()
    np_params = jax.tree.map(np.asarray, j_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(np_params, tcfg, "cpu")
    assert set(tparams["layers"]["moe"]["shared"]) == {"wi", "wg", "wo"}
    back = params_to_numpy(tparams, tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(np_params):
        assert np.array_equal(dict(jax.tree_util.tree_leaves_with_path(back))[path], leaf)


def test_train_forward_loss_with_aux_matches(models):
    tok = models["tokens"]
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    jl, jm = models["japi"].loss_fn(models["jparams"],
                                    {"tokens": jnp.asarray(tok),
                                     "labels": jnp.asarray(labels)})
    tl, tm = models["tapi"].loss_fn(models["tparams"],
                                    {"tokens": torch.from_numpy(tok).long(),
                                     "labels": torch.from_numpy(labels).long()})
    assert float(tm["aux"]) > 0                       # the router loss is in
    assert abs(float(jm["aux"]) - float(tm["aux"])) < 1e-6
    assert abs(float(jl) - float(tl)) < TOL


def test_loss_gradients_match_jax(models):
    """MoE training runs on the CPU through the plain path: every gradient,
    the router's through the top-k weights and the aux loss included,
    against JAX ``value_and_grad`` of its loss, within 1e-4."""
    tok = models["tokens"]
    labels = np.roll(tok, -1, axis=1)
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
    assert float(tgrads["['layers']['moe']['router']"].abs().max()) > 0


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
    for name in ("k", "v"):
        assert _err(tc[name], jc[name]) < TOL
    nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for _ in range(3):
        jlog, jc = models["japi"].decode_fn(models["jparams"], jc,
                                            {"tokens": jnp.asarray(nxt)})
        tlog, tc = models["tapi"].decode_fn(models["tparams"], tc,
                                            {"tokens": torch.from_numpy(nxt).long()})
        assert _err(tlog, jlog) < TOL
        nxt = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    assert int(jc["pos"]) == tc["pos"] == S + 3


def test_capacity_factor_reaches_the_model(models):
    """A no-drop build differs from the default (1.25) one on this batch:
    the default prefill drops tokens, and the port agrees with JAX on both."""
    tok = models["tokens"]
    jnd = j_build_model(models["jcfg"], remat=False, capacity_factor=None)
    tnd = t_build_model(models["tcfg"], device="cpu", capacity_factor=None)
    jl, _ = jnd.prefill(models["jparams"], {"tokens": jnp.asarray(tok)}, None, capacity=S)
    tl, _ = tnd.prefill(models["tparams"], {"tokens": torch.from_numpy(tok).long()}, None,
                        capacity=S)
    assert _err(tl, jl) < TOL
    td, _ = models["tapi"].prefill(models["tparams"], {"tokens": torch.from_numpy(tok).long()},
                                   None, capacity=S)
    assert _err(td, tl) > 1e-3


def test_greedy_generate_matches(models):
    tok = models["tokens"]
    jres = JServeEngine(models["japi"], models["jparams"]).generate(
        {"tokens": jnp.asarray(tok)}, max_new_tokens=NEW)
    tres = TServeEngine(models["tapi"], models["tparams"]).generate(
        {"tokens": torch.from_numpy(tok).long()}, max_new_tokens=NEW)
    assert np.array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    assert _err(tres.logprobs, jres.logprobs) < TOL
    assert tres.decode_steps == NEW


def test_moe_training_raises_on_the_card_only():
    cfg = t_get_config(ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 14"):
        TL.check_trainable(cfg, torch.device("cuda"))
    TL.check_trainable(cfg, torch.device("cpu"))


def test_launch_serve_granite_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--max-new", "3"], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] granite-moe-1b-a400m on cpu" in proc.stdout
    assert "[kernels] flash_attention=0 gmm=0" in proc.stdout
