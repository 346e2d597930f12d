"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's
on the same weights and inputs.

Configs: reduced granite_moe_1b_a400m (d_model 256, 4 experts, top-2, expert
d_ff 256, fp32) and reduced kimi_k2_1t_a32b for the shared expert.  Weights
are drawn by the JAX init and carried across as numpy arrays.  Tolerance
1e-5 on outputs (fp32 round-off: the port sums each token's k contributions
in another order) and 1e-6 on the aux loss.  With capacity_factor 1.0 the
dispatch drops tokens; the port must drop the same (token, expert) pairs,
which the per-token comparison with the no-drop output pins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as JM
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import moe as TM

TOL = 1e-5


def _setup(arch, seed, b, s):
    jcfg, tcfg = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    jparams = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams)
    x = np.random.default_rng(seed).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, x


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


@pytest.mark.parametrize("cf", [None, 1.25, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_ffn_matches_jax(seed, cf):
    jcfg, tcfg, jparams, tparams, x = _setup("granite_moe_1b_a400m", seed, 2, 16)
    jout, jaux = JM.moe_ffn(jparams, jnp.asarray(x), jcfg, capacity_factor=cf)
    tout, taux = TM.moe_ffn(tparams, torch.from_numpy(x), tcfg, capacity_factor=cf)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    assert _err(tout, jout) < TOL
    assert abs(float(taux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_drops_the_same_tokens(seed):
    """At capacity_factor 1.0 (32 tokens x top-2 over 4 experts: capacity 16)
    tokens are dropped, and the same ones on both sides: the tokens whose
    output moves away from the no-drop output agree."""
    jcfg, tcfg, jparams, tparams, x = _setup("granite_moe_1b_a400m", seed, 2, 16)
    moved = []
    for ffn, params, xin in ((JM.moe_ffn, jparams, jnp.asarray(x)),
                             (TM.moe_ffn, tparams, torch.from_numpy(x))):
        full, _ = ffn(params, xin, jcfg if ffn is JM.moe_ffn else tcfg, capacity_factor=None)
        cut, _ = ffn(params, xin, jcfg if ffn is JM.moe_ffn else tcfg, capacity_factor=1.0)
        moved.append(np.abs(_np(cut) - _np(full)).max(-1) > 1e-4)
    assert moved[0].any(), "capacity 1.0 dropped nothing: the test shows no drop"
    assert np.array_equal(moved[0], moved[1])


def test_tied_router_probabilities_route_as_jax():
    """Zero token rows give every expert the same probability: top-k then
    takes the lowest expert ids, as jax.lax.top_k does (torch.topk alone
    orders ties otherwise), so the capacity ranks and drops agree too."""
    jcfg, tcfg, jparams, tparams, x = _setup("granite_moe_1b_a400m", 4, 2, 16)
    x[:, ::3] = 0.0
    jids, _, _ = JM._route(jparams["router"], jnp.asarray(x.reshape(32, -1)),
                           jcfg.n_experts, jcfg.experts_per_token)
    tids, _, _ = TM._route(tparams["router"], torch.from_numpy(x.reshape(32, -1)),
                           tcfg.n_experts, tcfg.experts_per_token)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert tids[0].tolist() == list(range(tcfg.experts_per_token))
    for cf in (None, 1.0):
        jout, _ = JM.moe_ffn(jparams, jnp.asarray(x), jcfg, capacity_factor=cf)
        tout, _ = TM.moe_ffn(tparams, torch.from_numpy(x), tcfg, capacity_factor=cf)
        assert _err(tout, jout) < TOL


def test_no_drop_dispatch_matches_dense_oracle():
    jcfg, tcfg, jparams, tparams, x = _setup("granite_moe_1b_a400m", 3, 2, 24)
    xt = torch.from_numpy(x)
    out, aux = TM.moe_ffn(tparams, xt, tcfg, capacity_factor=None)
    ref, ref_aux = TM.moe_ffn_dense_oracle(tparams, xt, tcfg)
    jref, _ = JM.moe_ffn_dense_oracle(jparams, jnp.asarray(x), jcfg)
    assert _err(out, ref) < TOL and _err(ref, jref) < TOL
    assert float(aux) == float(ref_aux)


@pytest.mark.parametrize("cf", [None, 1.25])
def test_shared_expert_matches_jax(cf):
    jcfg, tcfg, jparams, tparams, x = _setup("kimi_k2_1t_a32b", 0, 2, 8)
    assert tcfg.n_shared_experts == 1 and "shared" in tparams
    jout, jaux = JM.moe_ffn(jparams, jnp.asarray(x), jcfg, capacity_factor=cf)
    tout, taux = TM.moe_ffn(tparams, torch.from_numpy(x), tcfg, capacity_factor=cf)
    assert _err(tout, jout) < TOL
    assert abs(float(taux) - float(jaux)) < 1e-6
    jref, _ = JM.moe_ffn_dense_oracle(jparams, jnp.asarray(x), jcfg)
    tref, _ = TM.moe_ffn_dense_oracle(tparams, torch.from_numpy(x), tcfg)
    assert _err(tref, jref) < TOL


def test_init_layout_matches_jax():
    """The port's init has the JAX leaves, shapes, dtypes and scales."""
    cfg = t_get_config("kimi_k2_1t_a32b").reduced()
    jparams = JM.moe_init(jax.random.PRNGKey(0), j_get_config("kimi_k2_1t_a32b").reduced())
    tparams = TM.moe_init(torch.Generator().manual_seed(0), cfg, lead=(3,))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jparams))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tparams))
    assert flat_j.keys() == flat_t.keys()
    for path, leaf in flat_j.items():
        t = flat_t[path]
        assert tuple(t.shape) == (3, *leaf.shape) and t.dtype == torch.float32, path
        assert abs(float(t.std()) / float(np.std(leaf)) - 1) < 0.1, path


def test_routing_weights_and_dtype():
    """Top-k weights renormalised to 1 and cast to x's dtype; the router
    itself stays f32 (bf16 x, as on the card)."""
    cfg = t_get_config("granite_moe_1b_a400m").reduced()
    params = TM.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(10, cfg.d_model, generator=torch.Generator().manual_seed(1))
    ids, w, aux = TM._route(params["router"], x.bfloat16(), cfg.n_experts,
                            cfg.experts_per_token)
    assert ids.shape == w.shape == (10, cfg.experts_per_token)
    assert w.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.allclose(w.float().sum(-1), torch.ones(10), atol=1e-2)
    assert bool((ids[:, 0] != ids[:, 1]).all())


def test_expert_parallel_is_not_ported():
    cfg = t_get_config("granite_moe_1b_a400m").reduced()
    params = TM.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros(1, 2, cfg.d_model)
    for kw in ({"model_axis": "model"}, {"ff_axes": ("data",)}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 15"):
            TM.moe_ffn(params, x, cfg, **kw)
