"""`Model.loss` and its gradients in the port against the reference's
`jax.value_and_grad` of `Model.loss`, on the CPU, for all six families.

Each case builds the reference's smoke config at float32 compute
(`dtype="float32"`: the point is the algorithm, not bf16 rounding),
carries its parameters across (`convert.model_params_from_reference`),
and feeds both the same seeded numpy batch: unchunked and chunked cross-
entropy (`loss_chunk`, the last chunk ragged), vlm's patches before the
tokens (the `npad` slice), a `loss_mask`, the moe family's load-balancing
loss. The port's gradients are taken at a compute copy of its parameters
(`train.train_step.loss_and_grads`, the train step's own route).
Tolerances: the loss to 2e-6 relative; each parameter's gradient to
GRAD_TOL of its largest entry (the two differ in summation order only;
the hybrid and ssm families' scans reach ~1e-4, the rest ~2e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import smoke_config as ref_smoke  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 reference_arrays)
from repro_torch.train.train_step import (compute_copy,  # noqa: E402
                                          loss_and_grads)

GRAD_TOL = 5e-4
B, S = 2, 24


def _batch(cfg, seed, masked):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.family == "audio" else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, shape).astype(
                 np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if masked:
        batch["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,loss_chunk,masked", [
    ("qwen2.5-3b", 0, True),            # dense, unchunked, masked
    ("qwen2.5-3b", 10, True),           # chunks of 10, 10, 4
    ("phi-3-vision-4.2b", 0, True),     # vlm: the npad slice
    ("phi-3-vision-4.2b", 16, False),   # vlm, chunked after the slice
    ("granite-moe-1b-a400m", 16, False),    # moe: + aux
    ("musicgen-medium", 16, False),     # audio: (B, S, K, V), never chunked
    ("zamba2-7b", 16, False),           # hybrid
    ("xlstm-1.3b", 16, False),          # ssm
])
def test_loss_and_grads_match_reference(arch, loss_chunk, masked):
    rcfg = ref_smoke(REF_ARCHS[arch]).with_(dtype="float32",
                                           loss_chunk=loss_chunk)
    pcfg = smoke_config(get_arch(arch)).with_(dtype="float32",
                                             loss_chunk=loss_chunk)
    rm = build_model(rcfg)
    params = jax.jit(rm.init)(jax.random.PRNGKey(3))
    batch = _batch(rcfg, 11, masked)
    (rl, rmet), rg = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = model_params_from_reference(pcfg, jax.tree.map(np.asarray,
                                                           params),
                                        device="cpu")
    pc = compute_copy(dict(model.named_parameters()), torch.float32)
    total, met, grads = loss_and_grads(
        model, pc, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(rl), rtol=2e-6)
    np.testing.assert_allclose(float(met["ce"]), float(rmet["ce"]),
                               rtol=2e-6)
    np.testing.assert_allclose(float(met["aux"]), float(rmet["aux"]),
                               rtol=2e-6, atol=1e-9)
    if arch.startswith("granite-moe"):
        assert float(met["aux"]) > 0
    want = reference_arrays(model, jax.tree.map(np.asarray, rg))
    assert sorted(want) == sorted(grads)
    for name, w in want.items():
        g = grads[name].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(
            np.abs(w).max(), 1e-30), err_msg=name)


def test_loss_keeps_the_model_parameters_and_serving_paths():
    """The parameters are created without requires_grad and stay so: the
    gradients go to the compute copy, and a no-grad forward (serving)
    builds no graph."""
    cfg = smoke_config(get_arch("qwen2.5-3b"))
    from repro_torch.models.model import Model
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1,
                                                       False).items()}
    pc = compute_copy(dict(model.named_parameters()), torch.bfloat16)
    total, _, grads = loss_and_grads(model, pc, batch)
    assert torch.isfinite(total)
    assert all(float(g.abs().sum()) > 0 for g in grads.values())
    assert not any(p.requires_grad or p.grad is not None
                   for p in model.parameters())
    with torch.no_grad():
        assert model.forward(batch).grad_fn is None
