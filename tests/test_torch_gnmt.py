"""GNMT in the port (``repro_torch.models.lstm.gnmt_init`` / ``gnmt_forward``
behind ``models.api.build_model``) against the JAX package from the same
init, carried across with ``repro_torch.interop.params_from_jax``.

Reduced GNMT (d_model 256, 2 encoder + 2 decoder LSTM layers, vocab 1024,
fp32) on the JAX ``SyntheticSeq2Seq`` batches (B 4, S = T = 8): logits, loss
and every gradient against JAX ``value_and_grad`` of ``build_model(...)
.loss_fn`` (loss within 1e-5 relative, logits and gradients within 1e-4 of
max(1, |ref|), the BigLSTM tolerances of ``tests/test_torch_train.py``);
one ``make_train_step`` AdamW step against JAX's; the interop round trip;
the dataset batch for batch; and the launcher refusing ``--arch gnmt``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.configs import get_config as j_get_config
from repro.data.synthetic import SyntheticSeq2Seq as JSeq2Seq
from repro.models import lstm as JM
from repro.models.api import build_model as j_build_model
from repro.train import steps as JS
from repro_torch import optim as TO
from repro_torch.configs import get_config as t_get_config
from repro_torch.data.synthetic import SyntheticSeq2Seq
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import train as TL
from repro_torch.models import lstm as TM
from repro_torch.models.api import build_model as t_build_model
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = 1e-4
LOSS_TOL = 1e-5
B, SEQ = 4, 8


def _err(a, b):
    """max |a - b| over max(1, max |b|)."""
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _batch(vocab, epoch=0):
    return next(JSeq2Seq(vocab=vocab, seq_len=SEQ, seed=0).epoch(epoch, B))


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def gnmt():
    """The JAX reference, computed once: init, logits, loss and gradients."""
    jcfg, tcfg = j_get_config("gnmt").reduced(), t_get_config("gnmt").reduced()
    japi = j_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    batch = _batch(tcfg.vocab_size)
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True))(jparams, jb)
    return {"jcfg": jcfg, "tcfg": tcfg, "japi": japi, "jparams": jparams,
            "np_params": jax.tree.map(np.asarray, jparams), "batch": batch,
            "jlogits": np.asarray(JM.gnmt_forward(jcfg, jparams, jb)),
            "jloss": float(jloss), "jgrads": [np.asarray(g) for g in jax.tree.leaves(jgrads)]}


def test_reduced_config_is_two_plus_two_layers(gnmt):
    cfg = gnmt["tcfg"]
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_model, cfg.vocab_size) == (2, 2, 256, 1024)
    assert cfg.dtype == "float32"


def test_gnmt_params_round_trip(gnmt):
    tcfg, np_params = gnmt["tcfg"], gnmt["np_params"]
    tparams = params_from_jax(np_params, tcfg, "cpu")
    assert tparams["dec"][0]["wx"].shape == (2 * tcfg.d_model, 4 * tcfg.d_model)
    back = params_to_numpy(tparams, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t) == 4 + 3 * 2 * tcfg.n_layers
    for path, leaf in flat_j:
        assert np.array_equal(leaf, flat_t[path])
    with pytest.raises(ValueError, match="enc"):
        params_from_jax({**np_params, "enc": np_params["enc"][:1]}, tcfg, "cpu")


def test_port_init_matches_jax_shapes(gnmt):
    ours = t_build_model(gnmt["tcfg"], device="cpu").init(0)
    assert [tuple(t.shape) for t in tree_leaves(ours)] == \
        [a.shape for a in jax.tree.leaves(gnmt["np_params"])]
    assert all(t.dtype == torch.float32 for t in tree_leaves(ours))
    # the JAX init's scales: N(0, 1/d_in) weights, N(0, 0.02^2) embeddings, zero biases
    assert abs(float(ours["dec"][0]["wx"].std()) - (2 * 256) ** -0.5) < 2e-3
    assert abs(float(ours["src_embed"].std()) - 0.02) < 1e-3
    assert not ours["enc"][1]["b"].any()


def test_gnmt_logits_loss_grads_match_jax(gnmt):
    tcfg, batch = gnmt["tcfg"], gnmt["batch"]
    tparams = params_from_jax(gnmt["np_params"], tcfg, "cpu")
    with torch.no_grad():
        tlogits = TM.gnmt_forward(tcfg, tparams, _tb(batch))
    assert tlogits.shape == (B, SEQ, tcfg.vocab_padded)
    assert _err(tlogits, gnmt["jlogits"]) < TOL
    leaves = [t.requires_grad_() for t in tree_leaves(tparams)]
    tloss, metrics = t_build_model(tcfg, device="cpu").loss_fn(tparams, _tb(batch))
    tgrads = torch.autograd.grad(tloss, leaves)
    tloss = tloss.detach()
    assert abs(float(tloss) - gnmt["jloss"]) < LOSS_TOL * abs(gnmt["jloss"])
    assert float(metrics["loss"].detach()) == float(tloss)
    assert len(tgrads) == len(gnmt["jgrads"])
    for g, w in zip(tgrads, gnmt["jgrads"]):
        assert g.shape == w.shape
        assert _err(g, w) < TOL


def test_gnmt_train_step_matches_jax(gnmt):
    """One AdamW step (warmup-cosine, clip 1.0) of ``make_train_step``
    against JAX's: loss and grad norm within 1e-4 relative, every parameter
    after the update within 1e-4."""
    japi, jparams, tcfg, batch = gnmt["japi"], gnmt["jparams"], gnmt["tcfg"], gnmt["batch"]
    jopt = JO.adamw(JO.warmup_cosine(3e-3, 20, 1))
    jstate, jm = jax.jit(JS.make_train_step(japi, jopt))(
        JS.TrainState(params=jparams, opt_state=jopt.init(jparams),
                      step=jnp.zeros((), jnp.int32)), jax.tree.map(jnp.asarray, batch))
    tparams = params_from_jax(gnmt["np_params"], tcfg, "cpu")
    opt = TO.adamw(TO.warmup_cosine(3e-3, 20, 1))
    state, m = make_train_step(t_build_model(tcfg, device="cpu"), opt, clip_norm=1.0)(
        TrainState(tparams, opt.init(tparams), 0), _tb(batch))
    assert state.step == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu")
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(state.params), tree_leaves(want)))
    assert err <= 1e-4, err


@pytest.mark.parametrize("epoch", [0, 1])
def test_seq2seq_dataset_matches_jax(epoch):
    ours, ref = SyntheticSeq2Seq(vocab=300, seq_len=50, seed=3), JSeq2Seq(vocab=300, seq_len=50,
                                                                          seed=3)
    n = 0
    for a, b in zip(ours.epoch(epoch, 128), ref.epoch(epoch, 128), strict=True):
        assert a.keys() == b.keys() == {"src", "tgt", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        n += 1
    assert n == 2048 // 128


def test_launcher_refuses_gnmt():
    """The launcher feeds the token LM only: GNMT is refused before any
    model is built, naming the path that trains it."""
    with pytest.raises(SystemExit, match="build_model \\+ train.steps.make_train_step"):
        TL.main(["--arch", "gnmt", "--reduced", "--device", "cpu", "--steps", "1",
                 "--batch", "4", "--seq", "8"])
