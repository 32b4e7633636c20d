"""The port's training path against the JAX reference, on the CPU.

qwen3-4b at its SMOKE size in f32: the reference initialises the
parameters and ``params_from_jax`` carries them across.  The loss and
every gradient leaf are held against ``jax.grad`` of the reference's
``train_loss`` (``attn_impl="chunked"``, the same function as its flash
path); AdamW, the synthetic data and checkpoints against their reference
counterparts on the same numpy inputs; and the trainer against the
properties ``tests/test_trainer.py`` asserts of the reference's.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import SMOKE as J_SMOKE
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.models.build import build_model as j_build
from repro.optim import adamw as jadamw
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.checkpoint import ckpt
from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs.registry import SMOKE
from repro_torch.data.synthetic import Loader, SyntheticLM
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.optim import adamw
from repro_torch.parallel.ctx import RunCtx
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = SMOKE["qwen3-4b"]
# f32 on both sides; the differences are summation order through 4 layers
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest |g|
OPT = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)


@pytest.fixture(scope="module")
def ref_model():
    jm = j_build(J_SMOKE["qwen3-4b"])
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    return jm, jctx, jparams


def _batch(batch=4, seq=64, seed=5, step=0):
    return JSyntheticLM(J_SMOKE["qwen3-4b"], batch=batch, seq_len=seq,
                        seed=seed).batch_at(step)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_loss_and_grads_match_reference(ref_model, remat):
    jm, jctx, jparams = ref_model
    hb = _batch()
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.train_loss(p, jctx, {k: jnp.asarray(v) for k, v in hb.items()})
    )(jparams)
    tm = build_model(CFG)
    tparams = tree_map(lambda t: t.requires_grad_(),
                       params_from_jax(jax.tree.map(np.asarray, jparams)))
    tbatch = {k: torch.from_numpy(v) for k, v in hb.items()}
    loss = tm.train_loss(tparams, RunCtx(remat=remat), tbatch)
    grads = torch.autograd.grad(loss, tree_leaves(tparams))
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for a, b in zip(grads, jleaves):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * float(np.abs(b).max()), err
    logits = tm.train_logits(tparams, RunCtx(remat=remat), tbatch)
    jlogits = jm.train_logits(jparams, jctx, {"inputs": jnp.asarray(hb["inputs"])})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_remat_is_validated():
    with pytest.raises(ValueError, match="remat"):
        RunCtx(remat="dots")


def _opt_tree(rng):
    return {
        "dec": [{"w": rng.normal(size=(3, 8, 16)), "s": rng.normal(size=(3, 8))}],
        "io": {"tok": rng.normal(size=(32, 8))},
    }


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_reference(clip):
    """Three steps on the same numpy params and grads: params and moments
    within 1e-6 (f32 arithmetic in the reference's order)."""
    rng = np.random.default_rng(0)
    p_np = jax.tree.map(lambda x: x.astype(np.float32), _opt_tree(rng))
    grads_np = [jax.tree.map(lambda x: (x * 3).astype(np.float32),
                             _opt_tree(rng)) for _ in range(3)]
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    jcfg = jadamw.AdamWConfig(schedule=jadamw.warmup_cosine(1e-2, 2, 10), **kw)
    tcfg = adamw.AdamWConfig(schedule=adamw.warmup_cosine(1e-2, 2, 10), **kw)
    jp = jax.tree.map(jnp.asarray, p_np)
    jst = jadamw.init_state(jp, jcfg)
    tp = tree_map(torch.from_numpy, jax.tree.map(np.copy, p_np))
    tst = adamw.init_state(tp, tcfg)
    for g in grads_np:
        jp, jst, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                           jst, jcfg)
        tp, tst, tm = adamw.apply_updates(
            tp, tree_map(torch.from_numpy, jax.tree.map(np.copy, g)), tst, tcfg)
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-6 * abs(float(jm[key]))
    assert int(tst["step"]) == int(jst["step"]) == 3
    for name, a, b in (("params", tp, jp), ("m", tst["m"], jst["m"]),
                       ("v", tst["v"], jst["v"])):
        for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                       rtol=1e-6, err_msg=name)


def test_adamw_slices_are_bit_identical(monkeypatch):
    """The update over slices of the leading axis gives the bits of the
    whole-leaf update, bf16 parameters included."""

    def run():
        p = {"a": torch.from_numpy(rng_p.normal(size=(6, 5, 7)).astype(np.float32)),
             "b": torch.from_numpy(rng_p.normal(size=(9, 4))).to(torch.bfloat16)}
        st = adamw.init_state(p, OPT)
        for _ in range(2):
            g = tree_map(lambda t: torch.from_numpy(
                rng_g.normal(size=t.shape).astype(np.float32)).to(t.dtype), p)
            p, st, _ = adamw.apply_updates(p, g, st, OPT)
        return tree_leaves(p) + tree_leaves(st)

    rng_p, rng_g = np.random.default_rng(2), np.random.default_rng(3)
    whole = run()
    monkeypatch.setattr(adamw, "CHUNK_ELEMS", 8)
    rng_p, rng_g = np.random.default_rng(2), np.random.default_rng(3)
    sliced = run()
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)


def test_synthetic_batches_bit_identical():
    for seed, step in ((0, 0), (1, 7), (3, 123)):
        a = JSyntheticLM(J_SMOKE["qwen3-4b"], 5, 33, seed=seed).batch_at(step)
        b = SyntheticLM(CFG, 5, 33, seed=seed).batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    src = SyntheticLM(CFG, 2, 8, seed=4)
    loader = Loader(src, start_step=3)
    try:
        first = next(loader)
        assert loader.step == 4
        np.testing.assert_array_equal(first["inputs"].numpy(),
                                      src.batch_at(3)["inputs"])
    finally:
        loader.close()


# --------------------------------------------------------------------------- #
# the trainer: the port's mirrors of tests/test_trainer.py
# --------------------------------------------------------------------------- #
def _run(steps, ckpt_dir=None, ckpt_every=0, resume=False, seed=0):
    tr = Trainer(build_model(CFG), RunCtx(remat="none"), OPT, TrainerConfig(
        steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, log_every=5))
    gen = torch.Generator().manual_seed(seed)
    start, data_start = 0, 0
    if resume:
        params, st, start, extra = tr.recover(gen)
        data_start = int(extra.get("data_step", start))
    else:
        params, st = tr.init(gen)
    loader = Loader(SyntheticLM(CFG, batch=16, seq_len=64, seed=1),
                    start_step=data_start)
    try:
        params, st, hist = tr.run(params, st, loader, start_step=start)
    finally:
        loader.close()
    return params, hist


def test_loss_decreases():
    _, hist = _run(steps=60)
    assert hist[-1]["loss"] < hist[0]["loss"] - 1.0
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)


def test_restart_bitwise_equivalence():
    """interrupted-and-restarted == uninterrupted (same data stream)."""
    with tempfile.TemporaryDirectory() as td:
        pA, _ = _run(steps=20, ckpt_dir=td, ckpt_every=10)
        for d in os.listdir(td):
            if d.startswith("step_") and int(d.split("_")[1]) > 10:
                shutil.rmtree(os.path.join(td, d))
        assert ckpt.latest_step(td) == 10
        pB, _ = _run(steps=20, ckpt_dir=td, resume=True, seed=123)
        for a, b in zip(tree_leaves(pA), tree_leaves(pB)):
            assert torch.equal(a, b)


def test_grad_accumulation_matches_large_batch():
    """ga=2 over batch 16 == one step over batch 16 (same tokens)."""
    hb = SyntheticLM(CFG, batch=16, seq_len=32, seed=3).batch_at(0)

    def one(ga):
        tr = Trainer(build_model(CFG), RunCtx(remat="none"), OPT,
                     TrainerConfig(steps=1, ga_steps=ga, ckpt_every=0))
        params, st = tr.init(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v) for k, v in hb.items()}
        p2, _, m = tr.make_train_step()(params, st, batch)
        return p2, m

    pa, ma = one(1)
    pb, mb = one(2)
    assert abs(float(ma["loss"]) - float(mb["loss"])) < 1e-4
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        # f32 reduction-order noise through AdamW's rsqrt: loose atol
        torch.testing.assert_close(a.detach(), b.detach(), atol=2e-4, rtol=0)


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #
def test_ckpt_round_trip_with_bf16_leaf():
    g = torch.Generator().manual_seed(0)
    tree = {
        "params": {"w": torch.randn((3, 4), generator=g),
                   "e": torch.randn((5, 2), generator=g).to(torch.bfloat16)},
        "opt": {"m": [torch.randn((2,), generator=g)],
                "step": torch.tensor(7, dtype=torch.int32)},
    }
    with tempfile.TemporaryDirectory() as td:
        for step in (1, 2, 3):
            ckpt.save(td, step, tree, extra={"data_step": step + 10}).wait()
        ckpt.cleanup(td, keep_last=2)
        assert sorted(os.listdir(td)) == ["step_0000000002", "step_0000000003"]
        assert ckpt.latest_step(td) == 3
        target = tree_map(torch.zeros_like, tree)
        got, extra = ckpt.restore(td, 3, target)
        assert extra == {"data_step": 13}
        for a, b in zip(tree_leaves(got), tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        with open(os.path.join(td, "step_0000000003", "manifest.json")) as f:
            assert '"bfloat16"' in f.read()
        with pytest.raises(ValueError, match="fit"):
            ckpt.restore(td, 3, {**target, "params": {
                "w": torch.zeros((4, 3)), "e": target["params"]["e"]}})


def test_restores_a_checkpoint_the_reference_wrote():
    rng = np.random.default_rng(9)
    tree = {"params": {"dec": [{"w": rng.normal(size=(2, 3)).astype(np.float32)}],
                       "tok": rng.normal(size=(4, 2)).astype(np.float32)},
            "opt": {"step": np.asarray(5, np.int32)}}
    with tempfile.TemporaryDirectory() as td:
        jckpt.save(td, 4, jax.tree.map(jnp.asarray, tree),
                   extra={"data_step": 4}, async_=False)
        assert ckpt.latest_step(td) == 4
        target = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
            np.asarray(a)).dtype), tree)
        got, extra = ckpt.restore(td, 4, target)
        assert extra["data_step"] == 4
        for a, b in zip(tree_leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a.numpy(), b)


def test_train_entry_point_runs_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-4b",
         "--smoke", "--steps", "3", "--device", "cpu", "--remat", "full"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "final loss:" in proc.stdout
