"""The audio, vlm, hybrid and ssm families trained sharded over a mesh of
ranks on the CPU: gloo ranks started by `tests/torch_sharded_ranks.py` in
a child process (one launch, "families,recovery_hybrid" on 4 ranks as a
(data 2, model 2) mesh), each family's smoke config at float32, held to
the reference and to the port's one-device step, computed here:

  * one sharded step from the reference's initial parameters (carried
    across by `repro_torch.convert`): its loss and gradients against
    `jax.value_and_grad` of the reference's loss, its masters after the
    step against the port's one-device step at the reference mesh test's
    tolerances (loss rel 1e-4, max parameter difference 5e-4,
    `tests/test_sharding.py:113-114`);
  * each sharded block against the reference's layer function on the
    same inputs and parameters: Mamba2 on 4 of 8 SSD heads (B and C
    whole), mLSTM on 2 of 4 heads, sLSTM on 64 of 128 channels gathered;
    the audio and vlm embedding (vocabulary-parallel codebooks,
    column-parallel `patch_proj`) and head (vocabulary-parallel logits);
  * Mamba2's control: its gated norm's sum of squares left as this rank's
    part gives a result beyond the tolerance;
  * zamba2's gathered checkpoint restores on one device; its
    `launch.train.train` run recovers from an injected failure bit-equal;
    each family's masters' and moments' bytes a rank are `lower_cell`'s;
  * what stays unported raises on a mesh, naming it: `zero_stage=3`,
    int8 gradient compression, `prefill` and `decode_step`, heads that
    do not divide the model axis.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as rget_arch  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch.configs import ShapeConfig, get_arch, smoke_config  # noqa
from repro_torch.convert import (_load, model_params_from_reference,  # noqa
                                 reference_arrays)
from repro_torch.launch.dryrun import lower_cell  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, check_mesh  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.train_step import (TrainState,  # noqa: E402
                                          init_train_state, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_sharded_ranks as R  # noqa: E402
from test_torch_sharded import (LOSS_REL, PARAM_DIFF, _launch,  # noqa: E402
                                _max_diff, _one_thread)

ARCHS = R.FAMILY_ARCHS
BLOCK_TOL = dict(atol=2e-5, rtol=2e-4)    # float32, sums in another order
GRAD_TOL = 5e-4                # tests/test_torch_loss.py's, of the largest
ROWS = 4
INIT = {"mamba": RL.init_mamba, "mlstm": RL.init_mlstm,
        "slstm": RL.init_slstm}
MODULES = {"mamba": L.Mamba, "mlstm": L.MLSTM, "slstm": L.SLSTM}


def _ref_cfg(arch):
    return rsmoke(rget_arch(arch)).with_(dtype="float32")


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    inp, ref = {}, {}
    rng = np.random.default_rng(7)
    for i, arch in enumerate(ARCHS):
        rc, cfg = _ref_cfg(arch), R.config(arch)
        rm = build_model(rc)
        params = jax.jit(rm.init)(jax.random.PRNGKey(11 + i))
        host = jax.tree.map(np.asarray, params)
        batch = R.batch(cfg, ROWS)
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        (rl, _), rg = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
            params, jb)
        model = model_params_from_reference(cfg, host, device="cpu")
        whole = {n: p.detach().clone() for n, p in model.named_parameters()}
        case = {"params": whole, "batch": batch}
        r = {"loss": float(rl),
             "grads": reference_arrays(model, jax.tree.map(np.asarray, rg))}
        for blk in R.FAMILY_BLOCKS.get(arch, ()):
            rp = INIT[blk](jax.random.PRNGKey(31 + i), rc)
            pp = MODULES[blk](cfg, "cpu")
            assert _load(pp, jax.tree.map(np.asarray, rp)) == len(
                list(pp.parameters()))
            x = rng.standard_normal((ROWS, R.SEQ, cfg.d_model)).astype(
                np.float32)
            case[blk] = {"x": torch.from_numpy(x),
                         "weights": {n: p.detach().clone()
                                     for n, p in pp.named_parameters()}}
            y, _ = getattr(RL, f"apply_{blk}")(rp, jnp.asarray(x), rc)
            r[blk] = np.asarray(y)
        if cfg.family in ("audio", "vlm"):
            hx = rng.standard_normal((ROWS, R.SEQ, cfg.d_model)).astype(
                np.float32)
            case["head_x"] = torch.from_numpy(hx)
            r["embed"] = np.asarray(rm._embed(params, {
                k: v for k, v in jb.items() if k != "targets"}))
            r["head"] = np.asarray(rm._head(params, jnp.asarray(hx)))
        # the port's one-device step from the same parameters and batch
        params1 = {n: t.clone() for n, t in whole.items()}
        state = TrainState(params1, init_opt_state(params1, R.OPT), 0)
        st, met = _one_thread(lambda: make_train_step(
            model, R.OPT, microbatches=R.FAMILY_MICRO)(state, batch))
        r["one_device"] = (met["loss"], {n: t.clone() for n, t in
                                         st.params.items()},
                           {n: t.clone() for n, t in st.opt["m"].items()})
        inp[arch], ref[arch] = case, r
    torch.save(inp, out / "families_in.pt")
    _launch("families,recovery_hybrid", out, 4)
    return {"out": out, "ref": ref, "inp": inp,
            "got": torch.load(out / "families.pt")}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(fam, arch):
    """Loss rel 1e-4 and the masters after the step within 5e-4 of the
    port's one-device step from the same parameters and batch."""
    got = fam["got"][arch]
    loss, params, _ = fam["ref"][arch]["one_device"]
    assert got["loss"] == pytest.approx(loss, rel=LOSS_REL)
    assert _max_diff(got["params"], params) < PARAM_DIFF


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_reference(fam, arch):
    """The sharded step's loss and its masters' gradients (gathered)
    against `jax.value_and_grad` of the reference's loss, each leaf
    within GRAD_TOL of its largest entry."""
    got, ref = fam["got"][arch], fam["ref"][arch]
    assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_REL)
    assert sorted(got["grads"]) == sorted(ref["grads"])
    for name, w in ref["grads"].items():
        np.testing.assert_allclose(
            got["grads"][name].numpy(), w, rtol=0,
            atol=GRAD_TOL * max(np.abs(w).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("arch,block", [("zamba2-7b", "mamba"),
                                        ("xlstm-1.3b", "mlstm"),
                                        ("xlstm-1.3b", "slstm")])
def test_sharded_block_matches_reference(fam, arch, block):
    np.testing.assert_allclose(fam["got"][arch][block].numpy(),
                               fam["ref"][arch][block], **BLOCK_TOL)


def test_mamba_norm_without_its_model_sum_fails(fam):
    """The control: the gated norm's sum of squares left as this rank's
    half of d_inner moves the block's output beyond the tolerance."""
    want = fam["ref"]["zamba2-7b"]["mamba"]
    got = fam["got"]["zamba2-7b"]["mamba_control"].numpy()
    assert not np.allclose(got, want, **BLOCK_TOL)
    assert np.abs(got - want).max() > 100 * BLOCK_TOL["atol"]


@pytest.mark.parametrize("arch,part", [
    ("musicgen-medium", "embed"), ("musicgen-medium", "head"),
    ("phi-3-vision-4.2b", "embed"), ("phi-3-vision-4.2b", "head")])
def test_sharded_embed_and_head_match_reference(fam, arch, part):
    """audio: 4 codebooks' vocabulary-parallel lookups summed over "model",
    the codebook heads' split logits gathered; vlm: `patch_proj`
    column-parallel and gathered before the tokens' rows, the vocabulary
    split logits gathered."""
    np.testing.assert_allclose(fam["got"][arch][part].numpy(),
                               fam["ref"][arch][part], **BLOCK_TOL)


def test_hybrid_checkpoint_restores_on_one_device(fam):
    """zamba2's sharded save (gathered to rank 0) restored into a
    one-device state: bit-equal to the run's gathered masters and first
    moments."""
    cfg, got = R.config("zamba2-7b"), fam["got"]["zamba2-7b"]
    model = Model(cfg, device="cpu")
    tmpl = init_train_state(model, torch.Generator().manual_seed(5), R.OPT)
    state, step = ckpt.restore(str(fam["out"] / "ckpt_hybrid"), tmpl)
    assert step == 1 and state.opt["step"] == 1
    for n, p in state.params.items():
        assert torch.equal(p, got["params"][n]), n
        assert torch.equal(state.opt["m"][n], got["m"][n]), n


def test_hybrid_recovery_under_the_mesh_is_bit_equal(fam):
    clean, healed = torch.load(fam["out"] / "recovery_hybrid.pt")
    assert clean["mesh"] == {"data": 2, "model": 2}
    assert (clean["restarts"], healed["restarts"]) == (0, 1)
    assert clean["steps"] == healed["steps"] == 3
    for n, p in clean["params"].items():
        assert torch.equal(p, healed["params"][n]), n


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_bytes_match_the_ranks_masters_and_moments(fam, arch):
    cfg = R.config(arch)
    mesh = S.Mesh(("data", "model"), (2, 2))
    shape = ShapeConfig("sharded", R.SEQ, ROWS, "train",
                        microbatches=R.FAMILY_MICRO)
    _, info = lower_cell(cfg.name, shape.name, mesh, cfg=cfg, shape=shape,
                         sharding_mode="2d", zero_stage=2, trace=False)
    mem = info["per_device_bytes"]
    for got in fam["got"][arch]["bytes_by_rank"]:
        assert got == {"params": mem["params"],
                       "opt_moments": mem["opt_moments"]}


def _two_ranks():
    return S.Mesh(("data", "model"), (1, 2), ranks=(0, 1), rank=0)


@pytest.mark.parametrize("what", ["zero_stage=3", "compress_grads",
                                  "prefill", "decode_step"])
def test_what_is_not_ported_raises_on_a_mesh(what):
    """On a 2-rank mesh, before any collective, naming what is not
    ported."""
    cfg = smoke_config(get_arch("zamba2-7b"))
    mesh = _two_ranks()
    if what == "zero_stage=3":
        with S.use_mesh(mesh), pytest.raises(ValueError,
                                             match="zero_stage=3 is not"):
            make_train_step(Model(cfg, device="meta"), R.OPT, zero_stage=3)
    elif what == "compress_grads":
        with pytest.raises(NotImplementedError, match="compress"):
            init_train_state(Model(cfg, device="meta"),
                             torch.Generator().manual_seed(0),
                             OptimizerConfig(compress_grads=True),
                             mesh=mesh)
    else:
        model = Model(cfg, device="cpu")
        tok = torch.zeros(1, 4).long()
        with S.use_mesh(mesh), pytest.raises(NotImplementedError,
                                             match="serving on a mesh"):
            if what == "prefill":
                model.prefill({"tokens": tok})
            else:
                model.decode_step(tok[:, :1], {}, 4)


@pytest.mark.parametrize("arch,change,heads", [
    ("zamba2-7b", dict(d_model=48), "3 SSD heads"),
    ("xlstm-1.3b", dict(n_heads=3, n_kv_heads=3), "3 mLSTM heads"),
    ("musicgen-medium", dict(n_heads=3, n_kv_heads=3),
     "3 attention heads")])
def test_heads_that_do_not_divide_raise_naming_them(arch, change, heads):
    cfg = smoke_config(get_arch(arch)).with_(**change)
    with pytest.raises(NotImplementedError,
                       match=f"the {cfg.family} family.*{heads}"):
        check_mesh(cfg, _two_ranks())


def test_the_columns_a_model_rank_computes_with():
    """Mamba2's, mLSTM's and sLSTM's columns on each of two model ranks:
    the rank's heads' (or channels') of each part, B and C on both."""
    cfg = smoke_config(get_arch("zamba2-7b"))       # d_inner 256, 8 heads
    din, ds = cfg.d_inner, cfg.ssm_state
    for m in range(2):
        c = L.mamba_columns(cfg, 2, m)
        inner = list(range(m * 128, m * 128 + 128))
        assert c["inner"].tolist() == inner
        assert c["in_proj"].tolist() == (
            inner + [din + i for i in inner]
            + list(range(2 * din, 2 * din + 2 * ds))
            + list(range(2 * din + 2 * ds + 4 * m,
                         2 * din + 2 * ds + 4 * m + 4)))
        assert c["conv"].tolist() == inner + list(range(din, din + 2 * ds))
    cfg = smoke_config(get_arch("xlstm-1.3b"))      # 4 heads of 32
    c = L.mlstm_columns(cfg, 2, 1)
    assert c["wif"].tolist() == [2, 3, 6, 7]
    assert c["ln_inner"].tolist() == [2, 3]
    assert c["wqkv"].tolist() == [j + i for j in (0, 128, 256)
                                  for i in range(64, 128)]
    assert L.slstm_columns(cfg, 2, 0).tolist() == [
        g * 128 + i for g in range(4) for i in range(64)]
