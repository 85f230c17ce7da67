"""The port's MoE layer (`repro_torch.models.layers.apply_moe`) against the
reference's local dispatch (`repro.models.layers._apply_moe_local`), and the
causality of the moe and audio models, on the CPU at float32.

The reference's parameters cross as NumPy arrays (`convert._load`), the
activations are drawn with numpy from a seed. y is held at the model
tests' tolerance (atol 2e-4, rtol 2e-3), aux to float32 resolution. The
kept (expert, token) pairs are compared with the reference's own routing
steps (`layers.py:226-245`, replayed below in JAX); they must be equal, or
differ only where two tokens' gates for one expert lie within float32
resolution of each other at the capacity's edge (a near-tie that the two
frameworks' float32 products may order either way).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget_arch  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import _load, model_params_from_reference  # noqa
from repro_torch.models import layers as L  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
AUX_TOL = dict(rtol=1e-6, atol=1e-7)
NEAR_TIE = 1e-6          # gates closer than this may be ordered either way


def _cfgs(arch, **kw):
    return (rsmoke(rget_arch(arch)).with_(dtype="float32", **kw),
            smoke_config(get_arch(arch)).with_(dtype="float32", **kw))


def _layer(arch, seed, **kw):
    rc, pc = _cfgs(arch, **kw)
    rp = RL.init_moe(jax.random.PRNGKey(seed), rc)
    pp = L.MoE(pc, "cpu")
    assert _load(pp, jax.tree.map(np.asarray, rp)) == 3
    return rc, pc, rp, pp


def _x(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _ref_kept(rp, jx, rc):
    """The reference's kept (expert, token) pairs and its (T, E) gates,
    by its own steps (`_apply_moe_local`, layers.py:226-245)."""
    b, s, d = jx.shape
    e, k, t = rc.n_experts, rc.top_k, b * s
    scores = (jx.reshape(t, d) @ rp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(scores, axis=-1)
    gv, gi = jax.lax.top_k(probs, k)
    gv = gv / jnp.maximum(gv.sum(-1, keepdims=True), 1e-9)
    comb = (jax.nn.one_hot(gi, e, dtype=jnp.float32) * gv[..., None]).sum(1)
    cap = t if s == 1 else min(max(1, int(math.ceil(
        t * k / e * rc.capacity_factor))), t)
    top_w, top_i = jax.lax.top_k(comb.T, cap)
    kept = {(ei, int(ti)) for ei in range(e)
            for ti, w in zip(np.asarray(top_i[ei]), np.asarray(top_w[ei]))
            if w > 0}
    return kept, np.asarray(comb), cap


def _port_kept(route):
    ti, keep = route["top_i"].numpy(), route["keep"].numpy()
    return {(e, int(t)) for e in range(ti.shape[0])
            for t in ti[e][keep[e]]}


def _assert_same_kept(port, ref, comb, cap):
    """Equal kept sets, or differences only at near-ties on the edge of
    an expert's capacity."""
    for e, t in port ^ ref:
        col = np.sort(comb[:, e])[::-1]
        edge = col[cap - 1]
        assert abs(comb[t, e] - edge) <= NEAR_TIE, (
            f"expert {e} token {t}: gate {comb[t, e]} is not a near-tie of "
            f"the capacity edge {edge}")


@torch.no_grad()
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0])
def test_apply_moe_prefill_matches_reference_with_drops(arch,
                                                        capacity_factor):
    """A prefill of 2 x 100 tokens at capacities that drop tokens (0.5
    about half of the choices; 1.0 a few, where the registry's 1.25 drops
    none of these)."""
    rc, pc, rp, pp = _layer(arch, 1, capacity_factor=capacity_factor)
    jx, tx = _x(2, (2, 100, rc.d_model))
    ry, raux = RL._apply_moe_local(rp, jx, rc)
    route = L.moe_route(pp, tx, pc)
    py, paux = L.apply_moe(pp, tx, pc)
    ref_kept, comb, cap = _ref_kept(rp, jx, rc)
    assert route["top_i"].shape == (pc.n_experts, cap)
    _assert_same_kept(_port_kept(route), ref_kept, comb, cap)
    n_choices = 2 * 100 * pc.top_k
    assert int(route["dropped"]) == n_choices - len(_port_kept(route)) > 0
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(float(paux), float(raux), **AUX_TOL)


@torch.no_grad()
def test_apply_moe_decode_is_dropless_and_matches_reference():
    """S = 1: every expert takes every token (cap = T), nothing drops."""
    rc, pc, rp, pp = _layer("granite-moe-1b-a400m", 3)
    jx, tx = _x(4, (5, 1, rc.d_model))
    ry, raux = RL._apply_moe_local(rp, jx, rc)
    route = L.moe_route(pp, tx, pc)
    assert route["top_i"].shape == (pc.n_experts, 5)
    assert int(route["dropped"]) == 0
    assert len(_port_kept(route)) == 5 * pc.top_k
    py, paux = L.apply_moe(pp, tx, pc)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(float(paux), float(raux), **AUX_TOL)


@torch.no_grad()
@pytest.mark.parametrize("case", ["equal_router_scores", "repeated_tokens"])
def test_apply_moe_ties_match_reference(case):
    """Ties: a zero router gives every token equal scores for every expert
    (the top-k of equal probabilities, and the capacity's choice among
    equal gates); repeated token rows give equal gates at the capacity's
    edge. `jax.lax.top_k` puts equal entries in index order, and so does
    the port's `top_k` (a stable sort), so both keep the same tokens and y
    agrees."""
    rc, pc, rp, pp = _layer("granite-moe-1b-a400m", 5, capacity_factor=0.5)
    a = np.random.default_rng(6).standard_normal((2, 40, rc.d_model))
    if case == "equal_router_scores":
        rp = dict(rp, router=jnp.zeros_like(rp["router"]))
        pp.router.zero_()
    else:
        a[:, 1::2] = a[:, ::2]                    # every token twice
    a = a.astype(np.float32)
    jx, tx = jnp.asarray(a), torch.from_numpy(a)
    route = L.moe_route(pp, tx, pc)
    ref_kept, comb, cap = _ref_kept(rp, jx, rc)
    assert _port_kept(route) == ref_kept
    if case == "equal_router_scores":
        # the lowest-index experts and tokens, as jax.lax.top_k orders ties
        assert (route["gate_idx"] == torch.arange(pc.top_k)).all()
        assert set(route["top_i"][0].tolist()) == set(range(cap))
    ry, raux = RL._apply_moe_local(rp, jx, rc)
    py, paux = L.apply_moe(pp, tx, pc)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(float(paux), float(raux), **AUX_TOL)


def test_top_k_orders_ties_as_jax_does():
    """The port's `top_k` against `jax.lax.top_k` on rows full of ties."""
    a = np.random.default_rng(7).integers(0, 4, (50, 40)).astype(np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(a), 8)
    pv, pi = L.top_k(torch.from_numpy(a), 8)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


@torch.no_grad()
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "musicgen-medium"])
def test_causality(arch):
    """The reference's `test_causality` (tests/test_models.py) on the port:
    logits at position t are unchanged by edits to tokens after t. The
    MoE runs at dropless capacity: with a capacity limit, future tokens
    compete for the experts' slots."""
    rc, pc = _cfgs(arch)
    if pc.family == "moe":
        pc = pc.with_(capacity_factor=float(pc.n_experts / pc.top_k))
    params = build_model(rc).init(jax.random.PRNGKey(0))
    pm = model_params_from_reference(pc, jax.tree.map(np.asarray, params),
                                     device="cpu")
    s = 24
    shape = (2, pc.n_codebooks, s) if pc.family == "audio" else (2, s)
    t1 = torch.from_numpy(np.random.default_rng(8).integers(
        0, pc.vocab_size, shape))
    t2 = t1.clone()
    t2[..., -4:] = (t2[..., -4:] + 1) % pc.vocab_size
    l1 = pm.forward({"tokens": t1})
    l2 = pm.forward({"tokens": t2})
    cut = s - 4
    np.testing.assert_allclose(l1[:, :cut - 1].numpy(),
                               l2[:, :cut - 1].numpy(), atol=1e-5, rtol=1e-5)
    assert not torch.allclose(l1[:, cut:], l2[:, cut:], atol=1e-5)
