"""Inception-V3 in the port (``repro_torch.models.inception`` behind
``models.api.build_model``) against the JAX package (``repro.models
.inception``) on seeded numpy inputs, from the same init carried across with
``repro_torch.interop.params_from_jax``, all in fp32:

- ``conv_bn`` at stride 1 "SAME" and stride 2 "VALID", over 3x3, 1x1, 1x7
  and 7x1 kernels, and both pools (the average's in-image counts at the
  edges);
- one block of each kind a-e of the full table;
- reduced Inception (blocks a, b, e; 128 px, B 2): loss and every gradient
  against JAX ``value_and_grad`` of ``build_model(...).loss_fn``;
- the full 11-block model, forward only at 75 px, B 1 (the reduced model
  never reaches blocks c and d);
- ``inception_dfg``, the interop round trip (empty pool branches included),
  the image dataset batch for batch, and the launcher's refusal.

Outputs and gradients within 1e-4 of max(1, |ref|), the loss within 1e-5
relative, as for BigLSTM in ``tests/test_torch_train.py``.  Each JAX
reference is computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.synthetic import SyntheticImageDataset as JImages
from repro.models import inception as JI
from repro.models.api import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.data.synthetic import SyntheticImageDataset
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.launch import train as TL
from repro_torch.models import inception as TI
from repro_torch.models.api import build_model as t_build_model
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-4
LOSS_TOL = 1e-5


def _err(a, b):
    """max |a - b| over max(1, max |b|)."""
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _conv_params(rng, kh, kw, cin, cout):
    """A conv with a non-trivial folded batch norm."""
    return {"w": (rng.standard_normal((kh, kw, cin, cout)) / np.sqrt(kh * kw * cin)
                  ).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
            "bias": rng.uniform(-0.2, 0.2, cout).astype(np.float32)}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("kh,kw,stride,padding,hw", [
    (3, 3, 1, "SAME", (9, 9)), (3, 3, 2, "VALID", (9, 9)), (3, 3, 2, "VALID", (10, 7)),
    (1, 1, 1, "VALID", (6, 6)), (3, 3, 1, "VALID", (8, 8)), (1, 7, 1, "SAME", (8, 9)),
    (7, 1, 1, "SAME", (9, 8)), (5, 5, 1, "SAME", (6, 6))])
def test_conv_bn_matches_jax(kh, kw, stride, padding, hw):
    rng = _rng(1)
    p = _conv_params(rng, kh, kw, 12, 16)
    x = rng.standard_normal((2, *hw, 12)).astype(np.float32)
    want = JI.conv_bn(_j(p), jnp.asarray(x), stride=stride, padding=padding)
    got = TI.conv_bn(_t(p), torch.from_numpy(x), stride=stride, padding=padding)
    assert got.shape == want.shape
    assert _err(got, want) < TOL


@pytest.mark.parametrize("kind,stride,padding,hw", [
    ("max", 2, "VALID", (9, 9)), ("max", 2, "VALID", (8, 11)), ("avg", 1, "SAME", (5, 5)),
    ("avg", 1, "SAME", (4, 7)), ("max", 1, "SAME", (5, 6)), ("avg", 2, "VALID", (7, 7))])
def test_pool_matches_jax(kind, stride, padding, hw):
    x = _rng(2).standard_normal((2, *hw, 5)).astype(np.float32)
    want = JI.pool(jnp.asarray(x), kind, 3, stride, padding)
    got = TI.pool(torch.from_numpy(x), kind, 3, stride, padding)
    assert got.shape == want.shape
    assert _err(got, want) < 1e-6


def test_avg_pool_divides_by_in_image_count():
    """"SAME" average pooling divides by the elements inside the image: a
    corner averages 4, an edge 6, the interior 9."""
    x = torch.arange(25, dtype=torch.float32).view(1, 5, 5, 1)
    y = TI.pool(x, "avg", 3, 1, "SAME")[0, :, :, 0]
    assert torch.allclose(TI.pool(torch.ones(1, 5, 5, 1), "avg")[0], torch.ones(5, 5, 1))
    assert float(y[0, 0]) == pytest.approx((0 + 1 + 5 + 6) / 4)
    assert float(y[0, 2]) == pytest.approx((1 + 2 + 3 + 6 + 7 + 8) / 6)
    assert float(y[2, 2]) == pytest.approx(12.0)


def test_unsupported_padding_raises():
    with pytest.raises(ValueError, match="SAME at stride 1"):
        TI.pool(torch.zeros(1, 5, 5, 1), "max", 3, 2, "SAME")
    with pytest.raises(ValueError, match="SAME at stride 1"):
        TI.conv_bn(_t(_conv_params(_rng(), 2, 2, 1, 1)), torch.zeros(1, 5, 5, 1))


@pytest.fixture(scope="module")
def full():
    """The JAX full-depth init (as numpy) and its forward at 75 px, B 1."""
    cfg = dataclasses.replace(j_get_config("inception_v3"), dtype="float32")
    params = JI.inception_init(jax.random.PRNGKey(0), cfg)
    images = _rng(3).standard_normal((1, 75, 75, 3)).astype(np.float32)
    logits = jax.jit(lambda p, x: JI.inception_forward(cfg, p, {"images": x}))(
        params, jnp.asarray(images))
    return {"np_params": jax.tree.map(np.asarray, params), "images": images,
            "logits": np.asarray(logits)}


def _jax_block(spec, branches, x):
    """One block from the JAX package's ``conv_bn`` and ``pool``, as its
    ``inception_forward`` applies each block."""
    outs = []
    for branch_spec, branch in zip(spec, branches):
        y, convs = x, iter(branch)
        for op in branch_spec:
            if op[0] == "avgpool":
                y = JI.pool(y, "avg", 3, 1, "SAME")
            elif op[0] == "maxpool2":
                y = JI.pool(y, "max", 3, 2, "VALID")
            else:
                y = JI.conv_bn(next(convs), y, stride=op[3],
                               padding="VALID" if op[3] == 2 else "SAME")
        outs.append(y)
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("index,cin,hw", [(0, 192, 7), (3, 288, 9), (4, 768, 5), (8, 768, 7),
                                          (9, 1280, 3)], ids=["a", "b", "c", "d", "e"])
def test_each_block_kind_matches_jax(full, index, cin, hw):
    kind, spec = TI._blocks(reduced=False)[index]
    assert (kind, spec) == JI._blocks(reduced=False)[index]
    branches = full["np_params"]["blocks"][index]
    x = np.abs(_rng(4).standard_normal((2, hw, hw, cin))).astype(np.float32)
    want = _jax_block(spec, _j(branches), jnp.asarray(x))
    got = TI.inception_block(spec, _t(branches), torch.from_numpy(x))
    assert got.shape == want.shape
    assert got.shape[-1] == TI._out_channels(spec, cin)
    assert _err(got, want) < TOL


def test_full_depth_forward_matches_jax(full):
    """All 11 blocks (a x3, b, c x4, d, e x2) at 75 px, the smallest input
    the stem and both reductions take."""
    cfg = dataclasses.replace(t_get_config("inception_v3"), dtype="float32")
    assert cfg.n_layers == 11
    params = params_from_jax(full["np_params"], cfg, "cpu")
    assert len(params["blocks"]) == 11
    with torch.no_grad():
        logits = TI.inception_forward(cfg, params, {"images": torch.from_numpy(full["images"])})
    assert logits.shape == full["logits"].shape == (1, 1000)
    assert _err(logits, full["logits"]) < TOL


def test_full_depth_params_round_trip(full):
    """Nested lists both ways, the empty pool-only branches included; the
    port's own init has the same leaves and shapes."""
    cfg = t_get_config("inception_v3")
    np_params = full["np_params"]
    params = params_from_jax(np_params, cfg, "cpu")
    assert params["blocks"][3][2] == [] and params["blocks"][8][2] == []
    back = params_to_numpy(params, cfg)
    assert back["blocks"][3][2] == []
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t) == len(tree_leaves(params))
    for path, leaf in flat_j:
        assert np.array_equal(leaf, flat_t[path])
    ours = TI.inception_init(torch.Generator().manual_seed(0), cfg)
    assert [tuple(t.shape) for t in tree_leaves(ours)] == [a.shape for a in jax.tree.leaves(
        np_params)]
    n = sum(t.numel() for t in tree_leaves(ours))
    assert 29.5e6 < n < 30e6, n
    broken = {**np_params, "blocks": np_params["blocks"][:-1]}
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax(broken, cfg, "cpu")


@pytest.fixture(scope="module")
def reduced():
    """Reduced Inception (blocks a, b, e) at 128 px, B 2: JAX's init, loss
    and gradients."""
    jcfg, tcfg = j_get_config("inception_v3").reduced(), t_get_config("inception_v3").reduced()
    japi = j_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(1))
    rng = _rng(5)
    batch = {"images": rng.standard_normal((2, 128, 128, 3)).astype(np.float32),
             "labels": rng.integers(0, tcfg.vocab_size, 2).astype(np.int32)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss_fn, has_aux=True))(
        jparams, _j(batch))
    return {"tcfg": tcfg, "np_params": jax.tree.map(np.asarray, jparams), "batch": batch,
            "jloss": float(jloss), "jgrads": [np.asarray(g) for g in jax.tree.leaves(jgrads)]}


def test_reduced_model_loss_and_grads_match_jax(reduced):
    tcfg = reduced["tcfg"]
    assert tcfg.n_layers <= 3 and tcfg.dtype == "float32"
    params = params_from_jax(reduced["np_params"], tcfg, "cpu")
    assert [kind for kind, _ in TI._blocks(True)] == ["a", "b", "e"]
    assert len(params["blocks"]) == 3
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    batch = {"images": torch.from_numpy(reduced["batch"]["images"]),
             "labels": torch.from_numpy(reduced["batch"]["labels"].astype(np.int64))}
    loss, metrics = t_build_model(tcfg, device="cpu").loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    assert abs(float(loss) - reduced["jloss"]) < LOSS_TOL * abs(reduced["jloss"])
    assert float(metrics["loss"].detach()) == float(loss)
    assert len(grads) == len(reduced["jgrads"])
    for g, w in zip(grads, reduced["jgrads"]):
        assert g.shape == w.shape
        assert _err(g, w) < TOL


def test_dfg_matches_jax():
    for kw in ({}, {"batch": 64}):
        nodes, edges = TI.inception_dfg(**kw)
        assert (nodes, edges) == JI.inception_dfg(**kw)


@pytest.mark.parametrize("image_size", [64, 296])
def test_image_dataset_matches_jax(image_size):
    kw = dict(n_classes=1000, image_size=image_size, n_items=16, seed=2)
    n = 0
    for a, b in zip(SyntheticImageDataset(**kw).epoch(1, 4), JImages(**kw).epoch(1, 4),
                    strict=True):
        assert a.keys() == b.keys() == {"images", "labels"}
        assert a["images"].shape == (4, image_size, image_size, 3)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        n += 1
    assert n == 4


def test_image_dataset_refuses_299_as_jax_does():
    """A side that is no multiple of 8 fails in both packages: the 8 x 8
    prototypes upsample by side // 8 (37: 296 px) under 299-px noise."""
    kw = dict(n_classes=1000, image_size=299, n_items=16)
    for ds in (SyntheticImageDataset(**kw), JImages(**kw)):
        with pytest.raises(ValueError, match="could not be broadcast"):
            next(ds.epoch(0, 4))


def test_build_model_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        t_build_model(t_get_config("inception_v3"))
    with pytest.raises(RuntimeError, match="cuda"):
        t_build_model(t_get_config("gnmt"))


def test_launcher_refuses_inception():
    with pytest.raises(SystemExit, match="build_model \\+ train.steps.make_train_step"):
        TL.main(["--arch", "inception_v3", "--reduced", "--device", "cpu", "--steps", "1"])
