"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU with nvcc (the kernels have no CPU mode) and
skip elsewhere. They import nothing of JAX, so they run on a machine with
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: gains within 1e-5 * (1 + |g|) (float32, the two differ only in
the order of the column sums); best_idx equal wherever the m=1 direction
margin exceeds that band.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import grin_moves as G  # noqa: E402

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _states(seed, B, k=4, l=6, n=600):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1.0, 30.0, size=(B, k, l)).astype(np.float32)
    N = np.stack([np.stack([rng.multinomial(int(rng.integers(0, n)),
                                            rng.dirichlet([0.5] * l))
                            for _ in range(k)]) for _ in range(B)])
    return N.astype(np.float32), mu, (0.7 * mu ** 0.5).astype(np.float32)


@pytest.mark.parametrize("objective", [G.OBJ_X, G.OBJ_XE, G.OBJ_E, G.OBJ_EDP,
                                       G.OBJ_E_GUARD])
def test_block_move_kernel_matches_plain_version(cuda, objective):
    N, mu, P = _states(11 + objective, B=257)
    sizes = 2.0 ** np.arange(9, -1, -1, dtype=np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (N, mu, sizes, P)]
    before = G.launches["block_move_gains"]
    kg, kbi, kbg, kbase = G.block_move_scores(
        *args[:3], P=args[3], objective=objective)
    assert G.launches["block_move_gains"] == before + 1
    pg, pbi, pbg, pbase = G.block_move_scores_reference(
        *args[:3], P=args[3], objective=objective)
    torch.cuda.synchronize()
    fin = torch.isfinite(pg)
    assert torch.equal(torch.isfinite(kg), fin)
    assert ((kg[fin] - pg[fin]).abs() <= TOL * (1 + pg[fin].abs())).all()
    fb = torch.isfinite(pbase)
    assert torch.equal(torch.isfinite(kbase), fb)
    assert ((kbase[fb] - pbase[fb]).abs() <= TOL * (1 + pbase[fb].abs())).all()
    if objective != G.OBJ_XE:       # the energy tie-break band decides there
        g1 = pg.reshape(len(N), len(sizes), -1)[:, -1]
        top2 = torch.topk(g1, 2, dim=1).values
        clear = ((top2[:, 0] - top2[:, 1]).nan_to_num(0.0, torch.inf)
                 > TOL * (1 + top2[:, 0].abs().nan_to_num(0.0, 0.0, 0.0)))
        assert torch.equal(kbi[clear], pbi[clear])


def test_block_move_kernel_selection_only_matches_with_gains(cuda):
    N, mu, _ = _states(3, B=1001, k=3, l=3, n=30)
    sizes = 2.0 ** np.arange(5, -1, -1, dtype=np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (N, mu, sizes)]
    full = G.block_move_gains_cuda(*args)
    sel = G.block_move_gains_cuda(*args, return_gains=False)
    assert sel[0] is None
    for a, b in zip(full[1:], sel[1:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous float32"):
        G.block_move_gains_cuda(args[0].double(), *args[1:])


def _grid(seed, B, k=4, l=6, n=600, shared=True):
    rng = np.random.default_rng(seed)
    mus = rng.uniform(1.0, 30.0, size=(1 if shared else B, k, l))
    mixes = np.array([rng.multinomial(n, p)
                      for p in rng.dirichlet([0.3] * k, size=B)])
    return (mus[0] if shared else mus), mixes


@pytest.mark.parametrize("objective", ["max-x", "max-x-e", "min-e",
                                       "min-edp"])
@pytest.mark.parametrize("shared", [True, False])
def test_fused_solve_matches_per_step_loop(cuda, objective, shared):
    """One launch of the fused solve gives the per-step loop's targets,
    moves and converged flags: both score with the same device functions
    and draw the same threshold."""
    from repro_torch.core.grin import (grin_solve_batch_steps_torch,
                                       grin_solve_batch_torch)
    mu, mixes = _grid(21 + shared, B=300, shared=shared)
    before = dict(G.launches)
    N, xs, conv, moves = grin_solve_batch_torch(mu, mixes,
                                                objective=objective,
                                                device=cuda)
    assert G.launches["grin_solve"] == before["grin_solve"] + 1
    assert G.launches["block_move_gains"] == before["block_move_gains"]
    Ns, xss, convs, movess = grin_solve_batch_steps_torch(
        mu, mixes, objective=objective, device=cuda)
    assert G.launches["block_move_gains"] > before["block_move_gains"]
    assert conv.all() and convs.all()
    assert torch.equal(N, Ns) and torch.equal(moves, movess)
    assert torch.equal(xs, xss)
    assert torch.equal(N.sum(dim=2).cpu(),
                       torch.as_tensor(mixes, dtype=torch.float32))


@pytest.mark.parametrize("objective", ["max-x", "max-x-e"])
def test_fused_solve_reports_the_cap(cuda, objective):
    """An instance that needs more than `max_moves` steps stops there and
    reports converged False, as the per-step loop does."""
    from repro_torch.core.grin import (grin_solve_batch_steps_torch,
                                       grin_solve_batch_torch)
    mu, mixes = _grid(5, B=64)
    full = grin_solve_batch_torch(mu, mixes, objective=objective,
                                  device=cuda)
    cap = 2
    N, _, conv, moves = grin_solve_batch_torch(
        mu, mixes, objective=objective, max_moves=cap, device=cuda)
    Ns, _, convs, movess = grin_solve_batch_steps_torch(
        mu, mixes, objective=objective, max_moves=cap, device=cuda)
    long = full[3] > cap
    assert long.any() and not conv[long].any()
    assert torch.equal(conv, convs) and torch.equal(moves, movess)
    assert torch.equal(N, Ns)
    phases = 2 if objective == "max-x-e" else 1
    assert (moves <= phases * cap).all()


def test_fused_solve_wrapper_checks_its_inputs(cuda):
    mu, mixes = _grid(3, B=8)
    N0 = torch.zeros((8, 4, 6), device=cuda)
    mus = torch.as_tensor(np.broadcast_to(mu, (8, 4, 6)).copy(),
                          dtype=torch.float32, device=cuda)
    sizes = 2.0 ** torch.arange(3, -1, -1, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="power matrix"):
        G.grin_block_solve_cuda(N0, mus, sizes, 10, objective=G.OBJ_E)
    with pytest.raises(ValueError, match="OBJ_X, OBJ_XE"):
        G.grin_block_solve_cuda(N0, mus, sizes, 10, P=mus,
                                objective=G.OBJ_E_GUARD)
    with pytest.raises(ValueError, match="mu must be"):
        G.grin_block_solve_cuda(N0, mus[:, :3].contiguous(), sizes, 10)


def _class_grid(seed, B, C, k=4, l=6):
    """(k, l) affinities and (B, C, k) class mixes: a small latency class
    (600 tasks) and batch classes (5400), each split Dirichlet(0.3)."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1.0, 30.0, size=(k, l))
    sizes = [600] + [5400] * (C - 1)
    mixes = np.stack([np.stack([rng.multinomial(n, rng.dirichlet([0.3] * k))
                                for n in sizes]) for _ in range(B)])
    return mu, mixes


@pytest.mark.parametrize("objective", ["max-x", "max-x-e"])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_fused_solve_at_class_weighted_shapes_matches_plain_loop(cuda, C,
                                                                 objective):
    """GrIn-P hands the fused solve (B, C*k, l) instances with w_c * mu rows
    (formed in float64, then cast) and the physical tiled P; one launch
    gives the per-step loop's targets, moves and flags at every point
    (`grin_solve_batch_steps_torch`), both with the plain PyTorch scorer
    (the fused solve's plain version) and with the scorer kernel. The
    plain energy bodies sum X_sys and W_sys in the kernel's order, so
    max-x-e's X-plateau band edge falls where the kernel's does."""
    from repro_torch.core.affinity import PROPORTIONAL_POWER
    from repro_torch.core.grin import grin_solve_batch_steps_torch
    from repro_torch.core.priority import (flatten_mixes,
                                           grin_solve_priority_batch_torch,
                                           priority_mu)
    mu, mixes = _class_grid(40 + C, B=256, C=C)
    w = np.array([4.0, 1.0, 0.5][:C])
    before = dict(G.launches)
    N, xw, conv, moves = grin_solve_priority_batch_torch(
        mu, mixes, w, objective=objective, device=cuda)
    assert G.launches["grin_solve"] == before["grin_solve"] + 1
    P = (None if objective == "max-x"
         else np.tile(PROPORTIONAL_POWER.power_matrix(mu), (C, 1)))
    for scorer in (G.block_move_scores_reference, None):
        Ns, xs, convs, movess = grin_solve_batch_steps_torch(
            priority_mu(mu, w), flatten_mixes(mixes), objective=objective,
            P=P, device=cuda, scorer=scorer)
        assert conv.all() and convs.all()
        differing = ((N.reshape(len(mixes), -1)
                      != Ns.reshape(len(mixes), -1)).any(dim=1)
                     | (moves != movess))
        assert int(differing.sum()) == 0, scorer
        assert torch.equal(xw, xs)
    assert torch.equal(N.sum(dim=3).cpu(),
                       torch.as_tensor(mixes, dtype=torch.float32))


def test_fused_solve_refuses_shapes_over_its_shared_memory(cuda):
    """64 classes of 4 types on 6 pools need 18.5 KB of shared memory an
    instance, 74 KB for a block of four, over the 48 KB a launch may ask
    for: the solve raises with the shape and does not drop to the per-step
    loop."""
    from repro_torch.core.priority import grin_solve_priority_batch_torch
    mu, mixes = _class_grid(9, B=4, C=64)
    before = dict(G.launches)
    with pytest.raises(ValueError, match="shared memory"):
        grin_solve_priority_batch_torch(mu, mixes, np.ones(64), device=cuda)
    assert G.launches == before


def test_prio_engine_batch_has_finite_per_class_metrics(cuda):
    """A PRIO batch on the card: finite per-class metrics wherever a class
    completes work, the class split summing to the total, and each run's
    total X within the conformance gate (0.15) of the host event core's on
    the same config and seed. Strict priority may starve the batch class;
    then both must agree it is dead. (At these 3,000 completions a single
    run of the batch class scatters too widely for a per-class gate; the
    smoke holds every run's per-class rates to the host core at 0.2, with
    PRIO runs of 48,000 completions.)"""
    from repro_torch.sched import get_policy
    from repro_torch.sched.priority import priority_sim_config
    from repro_torch.sim import (ClosedNetworkSimulator, compare_policies,
                                 make_distribution)
    rng = np.random.default_rng(21)
    pol = get_policy("grin-p", weights=[3.0, 1.0])
    cfg = priority_sim_config(
        rng.uniform(1, 30, (2, 3)), np.array([[3, 2], [7, 8]]),
        distribution=make_distribution("exponential"), order="PRIO",
        n_completions=3000, warmup_completions=600, seed=0)
    rows = compare_policies(cfg, [pol, "lb"], seeds=[0, 1], device=cuda)
    alive = 0
    for name, spec in (("GrIn-P", pol), ("LB", "lb")):
        for seed, m in zip([0, 1], rows[name]):
            assert m.meta["device"].startswith("cuda")
            assert m.class_throughput.sum() == pytest.approx(m.throughput,
                                                             rel=1e-5)
            cfg.seed = seed
            host = ClosedNetworkSimulator(cfg, device="cpu").run(spec)
            for c in range(2):
                dx, hx = m.class_throughput[c], host.class_throughput[c]
                if hx == 0 or dx == 0:
                    assert hx < 0.02 * host.throughput
                    assert dx < 0.02 * m.throughput
                    continue
                alive += 1
                assert np.isfinite(m.class_response_time[c])
                assert np.isfinite(m.class_energy[c])
            assert abs(m.throughput - host.throughput) / host.throughput \
                < 0.15, (name, seed, m.throughput, host.throughput)
    assert alive >= 6          # LB keeps both classes running


# ------------------------------------------------------------ model kernels
#
# Tolerances (the reference sweep's, tests/test_kernels.py): attention
# 2e-2 in bfloat16 (the kernel takes bfloat16 only); SSD y 2e-4 in float32 and 5e-2 in
# bfloat16, the final state 1e-4 (float32 state from the same inputs on both sides);
# RMSNorm 1e-5 in float32 and 2e-2 in bfloat16.

def _rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(dtype)


@pytest.mark.parametrize("b,s,h,kv,dh", [
    (1, 128, 4, 4, 128), (2, 200, 8, 2, 96), (2, 300, 6, 1, 64),
    (1, 64, 4, 2, 112), (1, 333, 2, 2, 32),
    # the Hopper design's edges: S not a multiple of its 128-row / 128-key
    # tiles, the padded-box head dims 112 and 96, GQA ratios 1, 4 and 8
    (1, 1000, 4, 4, 112), (2, 333, 8, 2, 112), (1, 200, 8, 1, 96),
    (1, 1000, 8, 1, 128)])
@pytest.mark.parametrize("window", [0, 50, 130])
def test_flash_attention_kernel_matches_plain_version(cuda, b, s, h, kv, dh,
                                                      window):
    """Windows smaller than a key tile (50) and not a multiple of it
    (130)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref
    dt = torch.bfloat16
    rng = np.random.default_rng(s + dh)
    q = _rand(rng, (b, s, h, dh), dt, cuda)
    k = _rand(rng, (b, s, kv, dh), dt, cuda)
    v = _rand(rng, (b, s, kv, dh), dt, cuda)
    before = FA.launches["flash_attention"]
    out = FA.flash_attention_cuda(q, k, v, causal=True, window=window)
    assert FA.launches["flash_attention"] == before + 1
    plain = FA.flash_attention_plain(q, k, v, causal=True, window=window,
                                     chunk_q=64, chunk_k=64)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    for other in (plain, ref):
        torch.testing.assert_close(out.float(), other.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("b,h,sq", [(1, 1, 1), (2, 3, 300), (1, 4, 1024),
                                    (3, 2, 129), (129, 512, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_blocks_cover_every_tile_once(cuda, b, h, sq,
                                                      causal):
    """The built kernel's block order: every (batch, head, q tile) once,
    one head's q tiles together (they share its K and V in L2), the
    longest causal tile first; its tiles are the wrapper's TMA boxes."""
    from repro_torch.kernels import flash_attention as FA
    tiles = FA.kernel_tiles()
    assert (tiles["block_q"], tiles["block_k"]) == (FA.BLOCK_Q, FA.BLOCK_K)
    assert tiles["stages"] >= 2
    nq = -(-sq // FA.BLOCK_Q)
    order = [FA.block_tile(i, nq, h, causal) for i in range(b * h * nq)]
    assert sorted(order) == sorted((i, j, t) for i in range(b)
                                   for j in range(h) for t in range(nq))
    for start in range(0, len(order), nq):
        assert len({o[:2] for o in order[start:start + nq]}) == 1
        qt = [o[2] for o in order[start:start + nq]]
        assert qt == (sorted(qt, reverse=True) if causal else sorted(qt))


def test_flash_attention_kernel_takes_more_than_65535_heads(cuda):
    """B*H = 66,048 blocks' worth of heads, which the earlier grid (B*H on
    blockIdx.y) refused; small S, dh 32."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import flash_attention_ref
    rng = np.random.default_rng(7)
    b, s, h, kv, dh = 129, 40, 512, 128, 32
    q = _rand(rng, (b, s, h, dh), torch.bfloat16, cuda)
    k = _rand(rng, (b, s, kv, dh), torch.bfloat16, cuda)
    v = _rand(rng, (b, s, kv, dh), torch.bfloat16, cuda)
    out = FA.flash_attention_cuda(q, k, v, causal=True, window=0)
    ref = flash_attention_ref(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_kernel_reads_strided_views(cuda):
    """k and v split out of one projection, as the model passes them."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    b, s, h, kv, dh = 2, 130, 4, 2, 112
    qkv = _rand(rng, (b, s, (h + 2 * kv) * dh), torch.bfloat16, cuda)
    q, k, v = torch.split(qkv, [h * dh, kv * dh, kv * dh], dim=-1)
    q, k, v = (t.reshape(b, s, -1, dh) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, window=64)
    plain = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), window=64)
    torch.testing.assert_close(out.float().cpu(), plain.float(), atol=2e-2,
                               rtol=2e-2)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q.float(), k.float(), v.float())


@pytest.mark.parametrize("b,s,h,kv,dh", [
    (2, 1000, 24, 8, 64),        # granite-moe-3b-a800m: GQA 24 / 8, dh 64
    (1, 1500, 24, 24, 64),       # musicgen-medium: 1500 frames
    (1, 1100, 32, 32, 96)])      # phi-3-vision-4.2b: dh 96
def test_flash_attention_kernel_at_the_moe_audio_vlm_shapes(cuda, b, s, h,
                                                            kv, dh):
    """Causal, at the head layouts of the moe, audio and vlm families, S
    not a multiple of the 128-row tiles; k and v strided out of one
    projection, as the model passes them."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    rng = np.random.default_rng(s + h)
    qkv = _rand(rng, (b, s, (h + 2 * kv) * dh), torch.bfloat16, cuda)
    q, k, v = (t.reshape(b, s, -1, dh) for t in torch.split(
        qkv, [h * dh, kv * dh, kv * dh], dim=-1))
    before = FA.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True)
    assert FA.launches["flash_attention"] == before + 1
    plain = FA.flash_attention_plain(q, k, v, causal=True, chunk_q=64,
                                     chunk_k=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)


def _moe_layer(dev, **kw):
    """One MoE layer at granite-moe-3b-a800m's widths (d 1536, 40 experts,
    top 8, expert width 512), bf16, random weights from a seed."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    cfg = get_arch("granite-moe-3b-a800m").with_(**kw)
    p = L.init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return cfg, p.to(torch.bfloat16)


def test_apply_moe_on_the_card_matches_the_cpu(cuda):
    """`apply_moe` on the card against the same layer on the CPU, at
    dropless capacity (every token's choices kept, so a routing difference
    stays with its token). The router's bf16 products round differently
    on the two devices, so a token may choose another expert where its
    k-th and (k+1)-th probabilities lie within bf16 resolution (2^-8 of
    the k-th): such tokens are counted and left out of y's comparison;
    every other token's y agrees at the bf16 tolerance (2e-2)."""
    from repro_torch.models import layers as L
    cfg, p = _moe_layer(cuda, capacity_factor=40 / 8)
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 512, cfg.d_model), torch.bfloat16, cuda)
    pc = _moe_layer(torch.device("cpu"), capacity_factor=40 / 8)[1]
    pc.load_state_dict({k: v.cpu() for k, v in p.state_dict().items()})
    rc, rg = L.moe_route(p, x, cfg), L.moe_route(pc, x.cpu(), cfg)
    yc, auxc = L.apply_moe(p, x, cfg)
    yg, auxg = L.apply_moe(pc, x.cpu(), cfg)
    assert int(rc["dropped"]) == 0 == int(rg["dropped"])
    same = (rc["gate_idx"].sort(-1).values.cpu()
            == rg["gate_idx"].sort(-1).values).all(-1)
    probs = rg["probs"].sort(-1, descending=True).values
    edge = (probs[:, 7] - probs[:, 8]) / probs[:, 7]
    assert bool((edge[~same] < 2.0 ** -8).all()), edge[~same]
    assert int(same.sum()) >= 0.9 * same.numel()
    torch.testing.assert_close(yc.cpu().reshape(-1, cfg.d_model)[same].float(),
                               yg.reshape(-1, cfg.d_model)[same].float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(auxc.cpu(), auxg, atol=1e-3, rtol=1e-2)


def test_moe_prefill_and_generate_are_bit_equal_run_to_run(cuda):
    """The MoE combine sums each token's expert rows in a fixed order
    (no atomics), so two prefills on the card give bit-equal logits and
    caches, and two greedy runs the same tokens, at a capacity that drops
    tokens (1.0: each expert takes its mean load)."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    cfg = smoke_config(get_arch("granite-moe-3b-a800m")).with_(
        capacity_factor=1.0)
    engine = ServeEngine(Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0)), max_len=1100)
    toks = torch.randint(0, cfg.vocab_size, (4, 1024), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    (l1, c1), (l2, c2) = (engine.prefill({"tokens": toks}) for _ in range(2))
    assert torch.equal(l1, l2)
    for a, b in zip(c1["attn"], c2["attn"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    from repro_torch.models import layers as L
    x = torch.randn((4, 1024, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    assert int(L.moe_route(engine.model.layers[0].moe, x.to(torch.bfloat16),
                           cfg)["dropped"]) > 0
    g1, g2 = (engine.generate({"tokens": toks}, steps=16) for _ in range(2))
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 130, 3, 16, 32, 32), (1, 64, 2, 64, 64, 16), (2, 96, 4, 8, 128, 32),
    (1, 700, 3, 64, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain_version(cuda, b, s, h, dk, dv, chunk,
                                               dtype):
    from repro_torch.kernels import ssd_scan as SSD
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s + dk)
    q = _rand(rng, (b, s, h, dk), dt, cuda)
    k = _rand(rng, (b, s, h, dk), dt, cuda)
    v = _rand(rng, (b, s, h, dv), dt, cuda)
    log_a = -torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32,
                                                cuda))
    beta = torch.sigmoid(_rand(rng, (b, s, h), torch.float32, cuda))
    before = SSD.launches["ssd_scan"]
    y, state = SSD.ssd_scan_cuda(q, k, v, log_a, beta, chunk=chunk)
    assert SSD.launches["ssd_scan"] == before + 1
    yp, sp = SSD.ssd_scan_plain(q, k, v, log_a, beta, chunk=chunk)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, sp, atol=1e-4, rtol=1e-4)


def test_ssd_scan_kernel_reads_head_broadcast_views(cuda):
    """Mamba2 passes B and C expanded over heads (head stride 0)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(9)
    b, s, h, ds, hd = 2, 300, 6, 16, 32
    Bc = _rand(rng, (b, s, ds), torch.bfloat16, cuda)
    Cc = _rand(rng, (b, s, ds), torch.bfloat16, cuda)
    x = _rand(rng, (b, s, h * hd), torch.bfloat16, cuda).reshape(b, s, h, hd)
    log_a = -torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32,
                                                cuda))
    beta = torch.sigmoid(_rand(rng, (b, s, h), torch.float32, cuda))
    Bh = Bc[:, :, None, :].expand(b, s, h, ds)
    Ch = Cc[:, :, None, :].expand(b, s, h, ds)
    y, state = ops.ssd_scan(Ch, Bh, x, log_a, beta, chunk=32)
    yp, sp = ops.ssd_scan(*(t.cpu() for t in (Ch, Bh, x, log_a, beta)),
                          chunk=32)
    torch.testing.assert_close(y.float().cpu(), yp.float(), atol=5e-2,
                               rtol=5e-2)
    torch.testing.assert_close(state.cpu(), sp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 77, 3, 24, 40, 64), (1, 200, 2, 64, 72, 256), (3, 45, 2, 16, 24, 16),
    (1, 130, 1, 128, 128, 128), (2, 90, 2, 32, 100, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_ragged_slices_and_tails(cuda, b, s, h, dk, dv, chunk,
                                                 dtype):
    """dv not a multiple of the 64-column slice (one or two slices, the
    last ragged), S not a multiple of the sub-tile, dk not a multiple of
    16."""
    from repro_torch.kernels import ssd_scan as SSD
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s + dv)
    q = _rand(rng, (b, s, h, dk), dt, cuda)
    k = _rand(rng, (b, s, h, dk), dt, cuda)
    v = _rand(rng, (b, s, h, dv), dt, cuda)
    log_a = -torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32,
                                                cuda))
    beta = torch.sigmoid(_rand(rng, (b, s, h), torch.float32, cuda))
    y, state = SSD.ssd_scan_cuda(q, k, v, log_a, beta, chunk=chunk)
    yp, sp = SSD.ssd_scan_plain(q, k, v, log_a, beta, chunk=chunk)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, sp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_head_broadcast_views_both_dtypes(cuda, dtype):
    """Head stride 0 q and k (Mamba2's B and C) in both dtypes, with the
    serving path's dk = dv = 64 and a ragged tail."""
    from repro_torch.kernels import ssd_scan as SSD
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(17)
    b, s, h, d = 2, 333, 5, 64
    Bc = _rand(rng, (b, s, d), dt, cuda)
    Cc = _rand(rng, (b, s, d), dt, cuda)
    x = _rand(rng, (b, s, h * d), dt, cuda).reshape(b, s, h, d)
    dtv = torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32,
                                             cuda) - 2.0)
    log_a = dtv * -torch.linspace(1.0, 16.0, h, device=cuda)
    Bh = Bc[:, :, None].expand(b, s, h, d)
    Ch = Cc[:, :, None].expand(b, s, h, d)
    y, state = SSD.ssd_scan_cuda(Ch, Bh, x, log_a, dtv, chunk=256)
    yp, sp = SSD.ssd_scan_plain(Ch, Bh, x, log_a, dtv, chunk=256)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, sp, atol=1e-4, rtol=1e-4)


# mLSTM forget-gate biases: log_a = log_sigmoid(randn + bias). At 0 (about
# -0.8 a token) a chunk passes on e^-13 (16 tokens) to e^-200 (256 tokens)
# of the state entering it, so y and the final state barely see the carry
# over chunks; at 6 (about -0.004 a token, forget gates near 1) it passes
# on a third or more, so a dropped or misplaced carry shows.
FORGET_BIASES = [0.0, 6.0]


def _mlstm_scan_inputs(rng, b, s, h, dk, dv, dt, dev, forget_bias=0.0):
    """SSD inputs as an mLSTM layer forms them: q scaled by 1/sqrt(dk),
    log_a = log_sigmoid(. + forget_bias), beta = sigmoid; v = ones for
    dv = 1 (the normaliser)."""
    q = (_rand(rng, (b, s, h, dk), torch.float32, dev) / dk ** 0.5).to(dt)
    k = _rand(rng, (b, s, h, dk), dt, dev)
    v = (torch.ones((b, s, h, 1), dtype=dt, device=dev) if dv == 1
         else _rand(rng, (b, s, h, dv), dt, dev))
    log_a = torch.nn.functional.logsigmoid(
        _rand(rng, (b, s, h), torch.float32, dev) + forget_bias)
    beta = torch.sigmoid(_rand(rng, (b, s, h), torch.float32, dev))
    return q, k, v, log_a, beta


@pytest.mark.parametrize("forget_bias", FORGET_BIASES)
@pytest.mark.parametrize("dv", [512, 1])
def test_ssd_scan_wide_kernel_matches_plain_version_at_mlstm_shapes(
        cuda, dv, forget_bias):
    """xlstm-1.3b's prefill calls, bf16: (4, 8192, 4, 512, 512) and
    (4, 8192, 4, 512, 1), chunk 256, at fast and slow decay; y within
    5e-2, the state 1e-4."""
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW
    rng = np.random.default_rng(dv)
    args = _mlstm_scan_inputs(rng, 4, 8192, 4, 512, dv, torch.bfloat16, cuda,
                              forget_bias)
    before = SSDW.launches["ssd_scan_wide"]
    y, state = SSDW.ssd_scan_wide_cuda(*args, chunk=256)
    assert SSDW.launches["ssd_scan_wide"] == before + 1
    yp, sp = SSD.ssd_scan_plain(*args, chunk=256)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), yp.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(state, sp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 300, 3, 512, 512, 256), (1, 77, 2, 512, 1, 32),
    (2, 130, 3, 200, 136, 64), (3, 45, 2, 24, 40, 16), (1, 1, 2, 512, 7, 256),
    (2, 513, 1, 129, 17, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("forget_bias", FORGET_BIASES)
def test_ssd_scan_wide_kernel_ragged_shapes(cuda, b, s, h, dk, dv, chunk,
                                            dtype, forget_bias):
    """S not a multiple of the chunk or of the 64-token tiles, dk and dv
    not multiples of the tiles (64, or 16 for dv <= 16), one token, both
    dtypes, fast and slow decay."""
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s + dk + dv)
    args = _mlstm_scan_inputs(rng, b, s, h, dk, dv, dt, cuda, forget_bias)
    y, state = SSDW.ssd_scan_wide_cuda(*args, chunk=chunk)
    yp, sp = SSD.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, sp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("forget_bias", FORGET_BIASES)
def test_ssd_scan_wide_kernel_reads_strided_and_head_broadcast_views(
        cuda, dtype, forget_bias):
    """q, k, v split from one projection (strided views, as mLSTM's qkv),
    and q, k expanded over heads (head stride 0, as Mamba2's B and C), at
    fast and slow decay."""
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(23)
    b, s, h, d = 2, 300, 3, 512
    qkv = _rand(rng, (b, s, 3 * h * d), dt, cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in torch.split(qkv, h * d, -1))
    log_a = torch.nn.functional.logsigmoid(
        _rand(rng, (b, s, h), torch.float32, cuda) + forget_bias)
    beta = torch.sigmoid(_rand(rng, (b, s, h), torch.float32, cuda))
    qb = _rand(rng, (b, s, d), dt, cuda)[:, :, None].expand(b, s, h, d)
    kb = _rand(rng, (b, s, d), dt, cuda)[:, :, None].expand(b, s, h, d)
    tol = 2e-4 if dtype == "float32" else 5e-2
    for args in ((q / d ** 0.5, k, v), (qb / d ** 0.5, kb, v)):
        y, state = SSDW.ssd_scan_wide_cuda(*args, log_a, beta, chunk=64)
        yp, sp = SSD.ssd_scan_plain(*args, log_a, beta, chunk=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(state, sp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_scale", [1.0, 0.01])
def test_ssd_scan_wide_kernel_matches_the_mamba2_kernel(cuda, dtype,
                                                        decay_scale):
    """At dk = dv = 64 (Mamba2's heads, head-broadcast q and k) the wide
    kernel agrees with ssd_scan.cu and with the plain version; log_a =
    dt * A scaled by `decay_scale` (0.01: about -0.0013 to -0.02 a token,
    so the carry over chunks shows in y and the state). The wide kernel
    and both states are held as at fast decay."""
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(31)
    b, s, h, d = 2, 700, 5, 64
    Bc = _rand(rng, (b, s, d), dt, cuda)
    Cc = _rand(rng, (b, s, d), dt, cuda)
    x = _rand(rng, (b, s, h * d), dt, cuda).reshape(b, s, h, d)
    dtv = torch.nn.functional.softplus(_rand(rng, (b, s, h), torch.float32,
                                             cuda) - 2.0)
    args = (Cc[:, :, None].expand(b, s, h, d), Bc[:, :, None].expand(
        b, s, h, d), x, decay_scale * dtv * -torch.linspace(
            1.0, 16.0, h, device=cuda), dtv)
    yw, sw = SSDW.ssd_scan_wide_cuda(*args, chunk=256)
    yk, sk = SSD.ssd_scan_cuda(*args, chunk=256)
    yp, sp = SSD.ssd_scan_plain(*args, chunk=256)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(yw.float(), yp.float(), atol=tol, rtol=tol)
    for st in (sw, sk):
        torch.testing.assert_close(st, sp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sw, sk, atol=1e-4, rtol=1e-4)
    if dtype == "float32" and decay_scale != 1.0:
        # ssd_scan.cu takes float32 operands as hi + lo bf16 pairs, ~16
        # significant bits. At slow decay y sums terms of up to ~180 that
        # cancel to near 0 in places, so its y is held to 2^-14 of the sum
        # of the terms' magnitudes (the plain scan of |q|, |k|, |v|).
        mag = SSD.ssd_scan_plain(*(t.abs() for t in args[:3]), *args[3:],
                                 chunk=256)[0]
        for a, ref in ((yk, yp), (yw, yk)):
            assert bool(((a - ref).abs() <= tol + 2 ** -14 * mag).all())
    else:
        torch.testing.assert_close(yk.float(), yp.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(yw.float(), yk.float(), atol=tol,
                                   rtol=tol)


def _assert_pair_close(out, ref, tol):
    """The pair's (y, C, nm, n) against two plain calls: y and nm within
    `tol`, the states within 1e-4; nm in v's dtype."""
    assert [(t.shape, t.dtype) for t in out] == [(t.shape, t.dtype)
                                                 for t in ref]
    for x, xp, t in zip(out, ref, (tol, 1e-4, tol, 1e-4)):
        torch.testing.assert_close(x.float(), xp.float(), atol=t, rtol=t)


@pytest.mark.parametrize("forget_bias", FORGET_BIASES)
def test_mlstm_scan_pair_matches_two_plain_calls_at_the_serving_shape(
        cuda, forget_bias):
    """xlstm-1.3b's prefill call of the pair, bf16: (4, 8192, 4, 512, 512)
    and its normaliser in one launch, chunk 256, at fast and slow decay,
    against the plain memory and normaliser scans: y and nm within 5e-2,
    C and n within 1e-4."""
    from repro_torch.kernels import ssd_scan_wide as SSDW
    rng = np.random.default_rng(512)
    args = _mlstm_scan_inputs(rng, 4, 8192, 4, 512, 512, torch.bfloat16,
                              cuda, forget_bias)
    before = dict(SSDW.launches)
    out = SSDW.mlstm_scan_cuda(*args, chunk=256)
    assert SSDW.launches == {**before,
                             "mlstm_scan": before["mlstm_scan"] + 1}
    ref = SSDW.mlstm_scan_plain(*args, chunk=256)
    torch.cuda.synchronize()
    _assert_pair_close(out, ref, 5e-2)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", [
    (2, 300, 3, 512, 512, 256), (1, 77, 2, 512, 1, 32),
    (2, 130, 3, 200, 136, 64), (3, 45, 2, 24, 40, 16), (1, 1, 2, 512, 7, 256),
    (2, 513, 1, 129, 17, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("forget_bias", FORGET_BIASES)
def test_mlstm_scan_pair_ragged_shapes(cuda, b, s, h, dk, dv, chunk, dtype,
                                       forget_bias):
    """The pair at the wide kernel's ragged shapes, both dtypes, fast and
    slow decay: y and nm within 2e-4 (float32) or 5e-2 (bf16), C and n
    within 1e-4."""
    from repro_torch.kernels import ssd_scan_wide as SSDW
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7 * s + dk + dv)
    args = _mlstm_scan_inputs(rng, b, s, h, dk, dv, dt, cuda, forget_bias)
    out = SSDW.mlstm_scan_cuda(*args, chunk=chunk)
    ref = SSDW.mlstm_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    _assert_pair_close(out, ref, 2e-4 if dtype == "float32" else 5e-2)


def test_ops_mlstm_scan_on_the_card_is_one_launch_of_the_pair(cuda,
                                                              monkeypatch):
    """`ops.mlstm_scan` on CUDA tensors is one launch of the pair and no
    other kernel, never the plain version; a failed launch or build
    raises instead of falling back; a state wider than 512 is refused."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW

    def plain(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(SSDW, "linear_scan_chunked", plain)
    monkeypatch.setattr(ops, "linear_scan_chunked", plain)
    rng = np.random.default_rng(43)
    args = _mlstm_scan_inputs(rng, 2, 100, 2, 512, 512, torch.bfloat16,
                              cuda)
    before = {**SSD.launches, **SSDW.launches}
    y, C, nm, n = ops.mlstm_scan(*args, chunk=32)
    assert {**SSD.launches, **SSDW.launches} == {
        **before, "mlstm_scan": before["mlstm_scan"] + 1}
    assert nm.shape == (2, 100, 2, 1) and n.shape == (2, 2, 512, 1)
    monkeypatch.setattr(SSDW, "_kernel_lib", lambda: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="ssd_scan_wide_fwd launch failed"):
        ops.mlstm_scan(*args)

    def no_build():
        raise RuntimeError("nvcc failed for ssd_scan_wide")
    monkeypatch.setattr(SSDW, "_kernel_lib", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops.mlstm_scan(*args)
    assert SSDW.launches["mlstm_scan"] == before["mlstm_scan"] + 1
    with pytest.raises(ValueError, match="<= 512"):
        ops.mlstm_scan(*_mlstm_scan_inputs(rng, 1, 10, 1, 513, 513,
                                           torch.bfloat16, cuda))


def test_ops_ssd_scan_on_the_card_never_takes_the_plain_version(cuda,
                                                                monkeypatch):
    """`ops.ssd_scan` on CUDA tensors launches ssd_scan.cu up to 128 x 128
    and ssd_scan_wide.cu above, and never calls the plain version; a failed
    launch or build of the wide kernel raises instead of falling back."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssd_scan_wide as SSDW

    def plain(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(ops, "linear_scan_chunked", plain)
    rng = np.random.default_rng(41)
    for dk, dv, name in ((64, 64, "ssd_scan"), (512, 512, "ssd_scan_wide"),
                         (512, 1, "ssd_scan_wide")):
        args = _mlstm_scan_inputs(rng, 2, 100, 2, dk, dv, torch.bfloat16,
                                  cuda)
        before = {**SSD.launches, **SSDW.launches}
        y, state = ops.ssd_scan(*args, chunk=32)
        after = {**SSD.launches, **SSDW.launches}
        assert after[name] == before[name] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        assert y.shape == (2, 100, 2, dv) and state.shape == (2, 2, dk, dv)
    args = _mlstm_scan_inputs(rng, 1, 10, 1, 512, 512, torch.bfloat16, cuda)
    monkeypatch.setattr(SSDW, "_kernel_lib", lambda: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="ssd_scan_wide_fwd launch failed"):
        ops.ssd_scan(*args)

    def no_build():
        raise RuntimeError("nvcc failed for ssd_scan_wide")
    monkeypatch.setattr(SSDW, "_kernel_lib", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops.ssd_scan(*args)
    with pytest.raises(ValueError, match="<= 512"):
        ops.ssd_scan(*_mlstm_scan_inputs(rng, 1, 10, 1, 513, 1,
                                         torch.bfloat16, cuda))


@pytest.mark.parametrize("shape", [(64, 256), (2, 37, 256), (5, 128),
                                   (3, 3584), (7, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_version(cuda, shape, dtype):
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as RN
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(shape[-1])
    x = _rand(rng, shape, dt, cuda)
    w = _rand(rng, (shape[-1],), torch.float32, cuda) * 0.1
    before = RN.launches["rmsnorm"]
    out = ops.rmsnorm(x, w)
    assert RN.launches["rmsnorm"] == before + 1
    plain = RN.rmsnorm_plain(x, w)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)


def _open_fault_inputs(order, dev):
    """Six points of fig_faults.py's 2x4 system under a two-burst storm:
    class hedges with checkpointing, and the speculative hedge, over the
    five route modes."""
    from repro_torch.faults import FaultScenario, build_fault_batch, make_storm
    from repro_torch.sched import get_policy
    from repro_torch.sim import make_distribution
    from repro_torch.traffic import PoissonArrivals, TrafficSpec
    mu = np.array([[12.0, 2.0, 2.0, 1.5], [1.5, 9.0, 2.0, 8.0]])
    spec = TrafficSpec((PoissonArrivals(3.3), PoissonArrivals(9.9)),
                       np.eye(2))
    seeds = list(range(6))
    arr = [spec.sample(s, 2000) for s in seeds]
    pol = get_policy("grin-p", weights=[2.0, 1.0])
    tgt = np.broadcast_to(np.asarray(pol.solve_target(mu, [2, 6])),
                          (6, 2, 4))
    storm = make_storm(4, n_bursts=2, window=(40.0, 100.0), downtime=10.0,
                       seed=11)
    scs = [FaultScenario(events=storm, fail_prob=0.05, hedge_classes=(0,),
                         refresh_targets=True, ckpt_period=0.05),
           FaultScenario(events=storm, fail_prob=0.02, hedge_quantile=0.9,
                         hedge_min_obs=16)] * 3
    fb = build_fault_batch(scs, mu, tgt, seeds=seeds, mode="open",
                           policies=pol, mixes=[2, 6], n_arrivals=2000,
                           n_classes=2, device=dev)
    return dict(mu=mu, targets=tgt, arr_times=np.stack([a[0] for a in arr]),
                arr_types=np.stack([a[1] for a in arr]), seeds=seeds,
                distribution=make_distribution("exponential"),
                queue_capacity=8, order=order, warmup_arrivals=200,
                modes=np.array([0, 1, 2, 3, 4, 0]), class_of_type=[0, 1],
                faults=fb, telemetry_bins=16)


@pytest.mark.parametrize("order", ["PS", "FCFS", "PRIO"])
def test_open_engine_with_faults_on_the_card(cuda, order):
    """The open engine with faults, hedges and telemetry on the card: the
    captured-graph loop gives the eager loop's results exactly, and both
    agree with the CPU run (other random streams) on the seed means."""
    from repro_torch.kernels import grin_moves as GM
    from repro_torch.traffic import simulate_open_batch
    before = GM.launches["grin_solve"]
    kw = _open_fault_inputs(order, cuda)
    assert GM.launches["grin_solve"] == before + 3   # one per refresh point
    eager = simulate_open_batch(device=cuda, cuda_graph=False, **kw)
    graph = simulate_open_batch(device=cuda, cuda_graph=True, **kw)
    for key, val in eager.items():
        if key == "telemetry":
            for k2, v2 in val.items():
                np.testing.assert_array_equal(v2, graph[key][k2])
        elif key != "device":
            np.testing.assert_array_equal(np.asarray(val),
                                          np.asarray(graph[key]))
    cpu = simulate_open_batch(device="cpu", **_open_fault_inputs(order,
                                                                 "cpu"))
    assert (eager["topology_events"] == cpu["topology_events"]).all()
    for key in ("goodput", "completed"):
        assert abs(eager[key].mean() / cpu[key].mean() - 1) < 0.05, key


@pytest.mark.parametrize("order", ["PS", "FCFS", "PRIO"])
def test_closed_engine_with_faults_on_the_card(cuda, order):
    """The closed engine's fault stanza on the card: a scenario that never
    fires and telemetry leave the fault-free run bit for bit as it was; a
    storm with failures, checkpoints and refreshed targets makes one fused
    launch per refreshing policy and agrees with the CPU run (other
    random streams) on topology events and, on the seed mean, goodput."""
    from repro_torch.faults import FaultScenario, crash, make_storm
    from repro_torch.kernels import grin_moves as GM
    from repro_torch.sim import SimConfig, compare_policies, make_distribution
    mu = np.random.default_rng(31).uniform(1, 30, size=(3, 3))

    def cfg(faults):
        return SimConfig(mu=mu, n_programs_per_type=np.array([6, 6, 6]),
                         distribution=make_distribution("exponential"),
                         order=order, n_completions=1500,
                         warmup_completions=300, seed=0, faults=faults,
                         class_of_type=[0, 1, 1] if order == "PRIO" else None)
    pols, seeds = ["grin", "lb", "rd"], [0, 1, 2]
    base = compare_policies(cfg(None), pols, seeds=seeds, device=cuda)
    never = compare_policies(cfg(FaultScenario(events=crash(1, 1e9, 2e9))),
                             pols, seeds=seeds, device=cuda)
    for name in base:
        for a, b in zip(base[name], never[name]):
            for f in ("throughput", "mean_response_time", "mean_energy",
                      "elapsed", "state_occupancy", "class_throughput"):
                assert np.array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f))), (name, f)
    storm = FaultScenario(events=make_storm(
        3, n_bursts=2, group_size=1, window=(5.0, 15.0), downtime=3.0,
        seed=2), fail_prob=0.05, ckpt_period=0.02, refresh_targets=True)
    before = GM.launches["grin_solve"]
    card = compare_policies(cfg(storm), pols, seeds=seeds, device=cuda)
    assert GM.launches["grin_solve"] == before + 1   # grin refreshes
    cpu = compare_policies(cfg(storm), pols, seeds=seeds, device="cpu")
    for name in card:
        assert [m.topology_events for m in card[name]] == \
            [m.topology_events for m in cpu[name]]
        g, h = (np.mean([m.goodput for m in r[name]]) for r in (card, cpu))
        assert abs(g / h - 1) < 0.1, name


def test_profile_span_waits_on_the_card(cuda):
    """With profiling on, `span.ready` synchronizes: the span of a 64 x 64
    grid solve lasts at least its fused kernel's device time."""
    from repro_torch.core.grin import _batch_inputs, grin_solve_batch_torch
    from repro_torch.obs import get_profiler, profile_block
    rng = np.random.default_rng(0)
    mus = rng.uniform(1.0, 30.0, size=(4096, 4, 6))
    mixes = np.stack([rng.multinomial(6000, rng.dirichlet([0.3] * 4))
                      for _ in range(4096)])
    grin_solve_batch_torch(mus, mixes, device=cuda)
    torch.cuda.synchronize()
    get_profiler().clear()
    with profile_block("t") as prof:
        grin_solve_batch_torch(mus, mixes, device=cuda)
    span = [s for s in prof.spans if s.name == "grin_solve_batch_torch"][0]
    # the kernel alone, between CUDA events (its inputs prepared before)
    N0, mu_t, _, sizes, cap, _ = _batch_inputs(mus, mixes, None, None,
                                               "max-x", None, None, cuda)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    G.grin_block_solve_cuda(N0, mu_t, sizes, cap)
    end.record()
    end.synchronize()
    assert span.dur * 1e3 >= 0.9 * start.elapsed_time(end) > 1.0
