"""The MoE experts' fixed-order backward (`models.layers.dispatch_rows`,
`combine_rows`) against autograd's index backward of the plain gathers
(`x2[idx]`, `rows[row[:, j]]`, the route before the Functions), on the CPU.

At float64 the two sum the same terms in other orders, so they agree to
float64 resolution (rtol 1e-12): with drops (capacity_factor 0.5), at the
registry's capacity, and at ties (a zero router, repeated tokens), as
`tests/test_torch_moe.py` covers the forward. The Functions' backward is
gathers and adds only (no index_put_, scatter-add or index_add), so a card
runs it in the same order every time; the card test holds two runs bit
for bit and against the index backward at bf16 (2e-2 of each gradient's
largest entry).
"""
import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.train_step import (compute_copy,  # noqa: E402
                                          loss_and_grads)

F64 = dict(rtol=1e-12, atol=1e-12)
SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
ACCUMULATING = ("index_put", "scatter_add", "index_add", "put_",
                "scatter_reduce")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# the experts' gather and combine as plain indexing, which autograd
# differentiates with index_put_(accumulate=True): the smoke's reference
index_backward = _smoke().index_backward


def _layer(arch, dtype="float64", device="cpu", **kw):
    cfg = smoke_config(get_arch(arch)).with_(dtype=dtype, param_dtype=dtype,
                                             **kw)
    p = L.init_moe(cfg, torch.Generator(device=device).manual_seed(1), device)
    return cfg, p.to(getattr(torch, dtype)).requires_grad_()


def _x(seed, shape, dtype=torch.float64, device="cpu"):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(a, dtype=dtype, device=device, requires_grad=True)


def _grads(p, x, cfg, ctx=None):
    """d/d(x, router, w_in, w_out) of a fixed projection of y plus aux."""
    with ctx or contextlib.nullcontext():
        y, aux = L.apply_moe(p, x, cfg)
        w = torch.linspace(-1.0, 1.0, y.numel(), dtype=y.dtype,
                           device=y.device).reshape(y.shape)
        return torch.autograd.grad((y * w).sum() + aux,
                                   [x, *p.parameters()])


def _assert_same(got, want, **tol):
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.detach().cpu().double().numpy(),
                                   r.detach().cpu().double().numpy(), **tol)


@pytest.mark.parametrize("arch,capacity_factor", [
    ("granite-moe-1b-a400m", 0.5), ("granite-moe-3b-a800m", 0.5),
    ("granite-moe-3b-a800m", 1.0), ("granite-moe-1b-a400m", 1.25)])
def test_expert_functions_match_index_backward_float64(arch,
                                                       capacity_factor):
    """A prefill of 2 x 100 tokens at capacities that drop choices (0.5
    about half, 1.0 a few) and at the registry's 1.25."""
    cfg, p = _layer(arch, capacity_factor=capacity_factor)
    x = _x(2, (2, 100, cfg.d_model))
    route = L.moe_route(p, x, cfg)
    if capacity_factor < 1.25:
        assert int(route["dropped"]) > 0
    _assert_same(_grads(p, x, cfg), _grads(p, x, cfg, index_backward()),
                 **F64)


@pytest.mark.parametrize("case", ["equal_router_scores", "repeated_tokens"])
def test_expert_functions_match_index_backward_at_ties(case):
    """Ties: a zero router gives every token equal scores for every
    expert; repeated token rows give equal gates at the capacity's edge
    (which tokens are kept there follows the stable top-k either way)."""
    cfg, p = _layer("granite-moe-1b-a400m", capacity_factor=0.5)
    a = np.random.default_rng(6).standard_normal((2, 40, cfg.d_model))
    if case == "equal_router_scores":
        with torch.no_grad():
            p.router.zero_()
    else:
        a[:, 1::2] = a[:, ::2]
    x = torch.tensor(a, requires_grad=True)
    _assert_same(_grads(p, x, cfg), _grads(p, x, cfg, index_backward()),
                 **F64)


def test_decode_sized_call_matches_index_backward():
    """S = 1: dropless, every token's k choices kept."""
    cfg, p = _layer("granite-moe-3b-a800m")
    x = _x(4, (5, 1, cfg.d_model))
    assert int(L.moe_route(p, x, cfg)["dropped"]) == 0
    _assert_same(_grads(p, x, cfg), _grads(p, x, cfg, index_backward()),
                 **F64)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _backward_ops(ctx=None):
    cfg, p = _layer("granite-moe-3b-a800m", dtype="float32",
                    capacity_factor=0.5)
    x = _x(3, (2, 30, cfg.d_model), torch.float32)
    with ctx or contextlib.nullcontext():
        y, aux = L.apply_moe(p, x, cfg)
    ops = _Ops()
    with ops:
        y.float().square().sum().backward()
    return ops.names


def test_expert_backward_accumulates_nowhere():
    """The Functions' backward is gathers and adds: no op that accumulates
    into indexed rows (whose order of adds a card does not fix). Autograd's
    index backward of the plain gathers does use index_put_, which shows
    the check can see such an op."""
    assert not [n for n in _backward_ops() if any(a in n
                                                  for a in ACCUMULATING)]
    assert [n for n in _backward_ops(index_backward()) if "index_put" in n]


def test_moe_model_gradients_match_index_backward_and_repeat():
    """The moe family's smoke model at float32: `loss_and_grads` through
    the Functions against the index backward (float32: summation order
    only), and two runs bit-equal (on one thread: on several, the CPU's
    index backward of the embedding gather adds in another order in every
    run)."""
    cfg = smoke_config(get_arch("granite-moe-3b-a800m")).with_(
        dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    pc = compute_copy(dict(model.named_parameters()), torch.float32)
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 48)))
    batch = {"tokens": tok, "targets": tok.roll(-1, 1)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        l1, _, g1 = loss_and_grads(model, pc, batch)
        l2, _, g2 = loss_and_grads(model, pc, batch)
        with index_backward():
            l3, _, g3 = loss_and_grads(model, pc, batch)
    finally:
        torch.set_num_threads(threads)
    assert float(l1) == float(l2) == float(l3)
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n
        scale = float(g3[n].abs().max()) or 1.0
        np.testing.assert_allclose(g1[n].numpy(), g3[n].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's index backward is what "
                    "the Functions replace")
    return torch.device("cuda")


def test_expert_functions_on_the_card_repeat_bit_for_bit(cuda):
    """One MoE layer at granite-moe-3b-a800m's widths (d 1536, 40 experts,
    top 8, width 512), bf16, 4096 tokens at the registry's capacity: the
    Functions' gradients twice, bit-equal, and within 2e-2 of each
    gradient's largest entry of autograd's index backward (which sums in
    bf16 in another order)."""
    cfg = get_arch("granite-moe-3b-a800m")
    p = L.init_moe(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    p = p.to(torch.bfloat16).requires_grad_()
    x = _x(1, (1, 4096, cfg.d_model), torch.bfloat16, cuda)
    a, b = _grads(p, x, cfg), _grads(p, x, cfg)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    for g, r in zip(a, _grads(p, x, cfg, index_backward())):
        scale = float(r.float().abs().max())
        assert float((g.float() - r.float()).abs().max()) <= 2e-2 * scale
