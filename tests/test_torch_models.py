"""The port's model stack (`repro_torch.models`) against the reference's, on
the CPU at float32.

Per module — rope, attention (prefill and a decode step into a full
sliding-window ring buffer), the MLP, Mamba2, mLSTM and sLSTM (prefill and
a decode step each) — then the whole `Model` on `smoke_config` of zamba2-7b
(hybrid), yi-6b (dense) and xlstm-1.3b (ssm), plus the dense variants the
registry carries (qkv bias with tied embeddings: qwen2.5-3b; the GeLU MLP:
granite-34b). The reference's
parameters cross as NumPy arrays through `convert.model_params_from_
reference`; token ids and activations are drawn with numpy from a seed.
The prompt (100 tokens) is longer than the smoke window (64) and not a
multiple of the chunk (32). Tolerance: atol 2e-4, rtol 2e-3, the
reference's own decode-vs-forward tolerance (tests/test_models.py).
"""
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
from repro_torch.models.model import Model, count_params  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
B, S = 2, 100


def _cfgs(arch):
    return (rsmoke(rget_arch(arch)).with_(dtype="float32"),
            smoke_config(get_arch(arch)).with_(dtype="float32"))


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _x(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_attention_tiers_match_reference(window):
    """naive, chunked (ragged chunks, GQA) and decode attention."""
    from repro.models import attention as RA
    from repro_torch.models import attention as PA
    jq, tq = _x(10, (B, 37, 4, 16))
    jk, tk = _x(11, (B, 37, 2, 16))
    jv, tv = _x(12, (B, 37, 2, 16))
    _close(PA.naive_attention(tq, tk, tv, window=window),
           RA.naive_attention(jq, jk, jv, window=window))
    _close(PA.chunked_attention(tq, tk, tv, window=window, chunk_q=8,
                                chunk_k=16),
           RA.chunked_attention(jq, jk, jv, window=window, chunk_q=8,
                                chunk_k=16))
    kpos = np.array([30, 31, -1, 29] + list(range(33)), np.int32)
    _close(PA.decode_attention(tq[:, :1], tk, tv, 31, window=window,
                               kpos=torch.from_numpy(kpos)),
           RA.decode_attention(jq[:, :1], jk, jv, 31, window=window,
                               kpos=jnp.asarray(kpos)))


def test_linear_scan_tiers_match_reference():
    """The sequential oracle, one decode step and the chunked form (a
    ragged last chunk, a carried-in state)."""
    from repro.models import linear_scan as RS
    from repro_torch.models import linear_scan as PS
    (jq, tq), (jk, tk), (jv, tv) = (_x(20 + i, (B, 45, 3, 8))
                                    for i in range(3))
    la = -np.logaddexp(0.0, np.random.default_rng(23).standard_normal(
        (B, 45, 3))).astype(np.float32)
    bt = np.random.default_rng(24).uniform(0, 1, (B, 45, 3)).astype(
        np.float32)
    j_s0, t_s0 = _x(25, (B, 3, 8, 8))
    ry, rs = RS.linear_scan_ref(jq, jk, jv, jnp.asarray(la), jnp.asarray(bt),
                                s0=j_s0)
    py, ps = PS.linear_scan_ref(tq, tk, tv, torch.from_numpy(la),
                                torch.from_numpy(bt), s0=t_s0)
    _close(py, ry)
    _close(ps, rs)
    cy, cs = PS.linear_scan_chunked(tq, tk, tv, torch.from_numpy(la),
                                    torch.from_numpy(bt), s0=t_s0, chunk=16)
    _close(cy, ry)
    _close(cs, rs)
    sy, ss = PS.linear_scan_step(tq[:, 0], tk[:, 0], tv[:, 0],
                                 torch.from_numpy(la[:, 0]),
                                 torch.from_numpy(bt[:, 0]), t_s0)
    ry1, rs1 = RS.linear_scan_step(jq[:, 0], jk[:, 0], jv[:, 0],
                                   jnp.asarray(la[:, 0]),
                                   jnp.asarray(bt[:, 0]), j_s0)
    _close(sy, ry1)
    _close(ss, rs1)


def test_rope_matches_reference():
    jx, tx = _x(0, (B, S, 4, 32))
    pos = np.arange(S)
    _close(L.rope(tx, torch.from_numpy(pos), 10_000.0),
           RL.rope(jx, jnp.asarray(pos), 10_000.0))
    one = L.rope(tx[:, :1], torch.tensor([S + 3]), 5e6)
    _close(one, RL.rope(jx[:, :1], jnp.asarray(S + 3)[None], 5e6))


@torch.no_grad()
def test_attention_prefill_and_ring_decode_match_reference():
    rc, pc = _cfgs("zamba2-7b")
    rp = RL.init_attention(jax.random.PRNGKey(1), rc)
    pp = L.Attention(pc, "cpu")
    assert _load(pp, _tree(rp)) == 2
    win = rc.sliding_window
    jx, tx = _x(1, (B, S, rc.d_model))
    ry, rcache = RL.apply_attention(rp, jx, rc, positions=jnp.arange(S),
                                    want_cache=True, window=win)
    py, pcache = L.apply_attention(pp, tx, pc, positions=torch.arange(S),
                                   want_cache=True, window=win)
    _close(py, ry)
    for key in ("k", "v", "kpos"):
        _close(pcache[key], rcache[key])
    assert pcache["k"].shape[1] == win              # the ring is full
    jx1, tx1 = _x(2, (B, 1, rc.d_model))
    ry1, rc1 = RL.apply_attention(rp, jx1, rc, positions=jnp.asarray(S),
                                  mode="decode", cache=rcache, window=win)
    py1, pc1 = L.apply_attention(pp, tx1, pc, positions=S, mode="decode",
                                 cache=pcache, window=win)
    _close(py1, ry1)
    for key in ("k", "v", "kpos"):
        _close(pc1[key], rc1[key])
    assert int(pc1["kpos"].max()) == S and pc1["idx"] == S + 1


@pytest.mark.parametrize("arch", ["yi-6b", "granite-34b"])
def test_mlp_matches_reference(arch):
    rc, pc = _cfgs(arch)
    rp = RL.init_mlp(jax.random.PRNGKey(3), rc)
    pp = L.MLP(pc, "cpu")
    assert _load(pp, _tree(rp)) == len(rp)
    jx, tx = _x(3, (B, 7, rc.d_model))
    _close(L.apply_mlp(pp, tx, pc), RL.apply_mlp(rp, jx, rc))


@torch.no_grad()
def test_mamba_prefill_and_decode_match_reference():
    rc, pc = _cfgs("zamba2-7b")
    rp = RL.init_mamba(jax.random.PRNGKey(4), rc)
    pp = L.Mamba(pc, "cpu")
    assert _load(pp, _tree(rp)) == 8
    jx, tx = _x(4, (B, S, rc.d_model))
    ry, rcache = RL.apply_mamba(rp, jx, rc, want_cache=True)
    py, pcache = L.apply_mamba(pp, tx, pc, want_cache=True)
    _close(py, ry)
    _close(pcache["state"], rcache["state"])
    _close(pcache["conv"], rcache["conv"])
    jx1, tx1 = _x(5, (B, 1, rc.d_model))
    ry1, rc1 = RL.apply_mamba(rp, jx1, rc, mode="decode", cache=rcache)
    py1, pc1 = L.apply_mamba(pp, tx1, pc, mode="decode", cache=pcache)
    _close(py1, ry1)
    _close(pc1["state"], rc1["state"])
    _close(pc1["conv"], rc1["conv"])


@torch.no_grad()
def test_mlstm_prefill_and_decode_match_reference():
    """The memory and normaliser scans (prefill) and the two step
    recurrences (decode), with their caches; S = 100 is not a multiple of
    the chunk (32)."""
    rc, pc = _cfgs("xlstm-1.3b")
    rp = RL.init_mlstm(jax.random.PRNGKey(6), rc)
    pp = L.MLSTM(pc, "cpu")
    assert _load(pp, _tree(rp)) == 5
    jx, tx = _x(6, (B, S, rc.d_model))
    ry, rcache = RL.apply_mlstm(rp, jx, rc, want_cache=True)
    py, pcache = L.apply_mlstm(pp, tx, pc, want_cache=True)
    _close(py, ry)
    assert pcache["C"].shape == (B, 4, 32, 32) and pcache["n"].shape == (
        B, 4, 32, 1)
    _close(pcache["C"], rcache["C"])
    _close(pcache["n"], rcache["n"])
    jx1, tx1 = _x(7, (B, 1, rc.d_model))
    ry1, rc1 = RL.apply_mlstm(rp, jx1, rc, mode="decode", cache=rcache)
    py1, pc1 = L.apply_mlstm(pp, tx1, pc, mode="decode", cache=pcache)
    _close(py1, ry1)
    _close(pc1["C"], rc1["C"])
    _close(pc1["n"], rc1["n"])


@torch.no_grad()
@pytest.mark.parametrize("s", [1, 2, 100, 128])
def test_slstm_prefill_and_decode_match_reference(s):
    """The doubling scan against the reference's associative scan (another
    order of summation; float32), at lengths below, at and off a power of
    two, then one decode step from its cache."""
    rc, pc = _cfgs("xlstm-1.3b")
    rp = RL.init_slstm(jax.random.PRNGKey(8), rc)
    pp = L.SLSTM(pc, "cpu")
    assert _load(pp, _tree(rp)) == 1
    jx, tx = _x(8 + s, (B, s, rc.d_model))
    ry, rcache = RL.apply_slstm(rp, jx, rc, want_cache=True)
    py, pcache = L.apply_slstm(pp, tx, pc, want_cache=True)
    _close(py, ry)
    _close(pcache["c"], rcache["c"])
    _close(pcache["n"], rcache["n"])
    jx1, tx1 = _x(9, (B, 1, rc.d_model))
    ry1, rc1 = RL.apply_slstm(rp, jx1, rc, mode="decode", cache=rcache)
    py1, pc1 = L.apply_slstm(pp, tx1, pc, mode="decode", cache=pcache)
    _close(py1, ry1)
    _close(pc1["c"], rc1["c"])
    _close(pc1["n"], rc1["n"])


def test_gated_cumsum_is_the_sequential_recurrence():
    """c_t = f_t c_{t-1} + x_t, against a loop over tokens (float64)."""
    rng = np.random.default_rng(12)
    f = torch.from_numpy(rng.uniform(0, 1, (2, 37, 5)))
    x = torch.from_numpy(rng.standard_normal((2, 37, 5)))
    c, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(37):
        c = f[:, t] * c + x[:, t]
        want.append(c)
    np.testing.assert_allclose(L.gated_cumsum(f, x).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-12)


def _models(arch, seed=0):
    rc, pc = _cfgs(arch)
    rm = build_model(rc)
    params = rm.init(jax.random.PRNGKey(seed))
    pm = model_params_from_reference(pc, _tree(params), device="cpu")
    toks = np.random.default_rng(seed).integers(0, rc.vocab_size,
                                                size=(B, S))
    return rm, params, pm, toks


@pytest.mark.parametrize("arch", ["zamba2-7b", "yi-6b", "qwen2.5-3b",
                                  "granite-34b", "xlstm-1.3b"])
def test_model_prefill_matches_reference_and_decodes_like_forward(arch):
    rm, params, pm, toks = _models(arch)
    rl, _ = rm.prefill(params, {"tokens": jnp.asarray(toks)},
                       cache_len=S + 4)
    pl, cache = pm.prefill({"tokens": torch.from_numpy(toks)},
                           cache_len=S + 4)
    assert pl.shape == (B, 1, pm.cfg.vocab_size) and pl.dtype == torch.float32
    _close(pl, rl)
    # the port's own decode-vs-forward check (the reference's, at float32)
    with torch.no_grad():
        full = pm.forward({"tokens": torch.from_numpy(toks)})
    _, cache = pm.prefill({"tokens": torch.from_numpy(toks[:, :-1])},
                          cache_len=S + 3)
    dl, _ = pm.decode_step(torch.from_numpy(toks[:, -1:]), cache, S - 1)
    np.testing.assert_allclose(dl[:, -1].numpy(), full[:, -1].numpy(), **TOL)


def test_model_structure_and_param_counts():
    """81 Mamba2 blocks and one shared block for zamba2-7b, 42 mLSTM and 6
    sLSTM blocks for xlstm-1.3b; parameter counts equal the reference's at
    full width (no allocation)."""
    from repro.models.model import count_params as rcount
    for arch in ("zamba2-7b", "yi-6b", "xlstm-1.3b"):
        assert count_params(get_arch(arch)) == rcount(rget_arch(arch))
    assert count_params(get_arch("xlstm-1.3b")) == 1_188_386_816
    m = Model(get_arch("zamba2-7b"), device="meta")
    assert len(m.mamba) == 81 and m.shared.attn.wqkv.shape == (3584, 10752)
    x = Model(get_arch("xlstm-1.3b"), device="meta")
    assert len(x.mlstm) == 42 and len(x.slstm) == 6
    assert x.mlstm[0].mlstm.wqkv.shape == (2048, 6144)
    assert x.slstm[0].slstm.w_gates.shape == (2048, 8192)
    for arch in ("granite-moe-1b-a400m", "musicgen-medium",
                 "phi-3-vision-4.2b"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            Model(get_arch(arch), device="cpu")


def test_model_init_from_a_generator():
    """`init` fills every parameter from a torch.Generator, reproducibly;
    the per-block `init_*` helpers do the same for one block; `init_cache`
    has the shapes a padded prefill cache has."""
    cfg = smoke_config(get_arch("zamba2-7b"))
    for make in (L.init_attention, L.init_mlp, L.init_mamba):
        p1 = make(cfg, torch.Generator().manual_seed(1), "cpu")
        p2 = make(cfg, torch.Generator().manual_seed(1), "cpu")
        assert all(torch.equal(x, y) for x, y in zip(p1.parameters(),
                                                     p2.parameters()))
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa).all(), name
    assert float(a.mamba[0].mamba.in_proj.std()) == pytest.approx(
        1 / np.sqrt(cfg.d_model), rel=0.1)
    logits, cache = a.prefill({"tokens": torch.zeros(1, 5, dtype=torch.long)},
                              cache_len=70)
    assert torch.isfinite(logits).all()
    empty = a.init_cache(1, 70)
    for key in ("mamba", "attn"):
        assert len(empty[key]) == len(cache[key])
        for e, c in zip(empty[key], cache[key]):
            assert {n: tuple(t.shape) for n, t in e.items()
                    if isinstance(t, torch.Tensor)} == \
                {n: tuple(t.shape) for n, t in c.items()
                 if isinstance(t, torch.Tensor)}


def test_ssm_model_builds_on_the_cpu_and_its_cache_has_prefill_shapes():
    """`Model(get_arch("xlstm-1.3b"), device="cpu")` builds; on the smoke
    config `init_cache` has the prefill cache's shapes and float32 states,
    and `_pad_attention_caches` passes a cache without attention through."""
    from repro_torch.models.model import _pad_attention_caches
    full = Model(get_arch("xlstm-1.3b"), device="cpu")
    assert len(full.mlstm) == 42 and full.device.type == "cpu"
    del full
    cfg = smoke_config(get_arch("xlstm-1.3b"))
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    _, cache = m.prefill({"tokens": torch.zeros(2, 9, dtype=torch.long)},
                         cache_len=40)
    empty = m.init_cache(2, 40)
    assert set(cache) == set(empty) == {"mlstm", "slstm"}
    for key in ("mlstm", "slstm"):
        assert len(empty[key]) == len(cache[key]) == {"mlstm": 3,
                                                      "slstm": 1}[key]
        for e, c in zip(empty[key], cache[key]):
            assert {n: (tuple(t.shape), t.dtype) for n, t in e.items()} == \
                {n: (tuple(t.shape), t.dtype) for n, t in c.items()}
            assert all(t.dtype == torch.float32 for t in c.values())
    assert _pad_attention_caches(cache, 64, 0) is cache
