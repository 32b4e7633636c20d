"""Distributed substrate suite on one device: the compressed gradient
ring, GPipe forward and backward, expert-parallel MoE against the local
MoE, the remat=names policy, and the elastic restart of data-parallel
training.

Twin of ``repro.testing.dist_suite`` (which needs 8 XLA devices) on the
port's rank-stacked layout: every "device" is a rank of ``Context.spmd``
(the EP check's (data, model) mesh is ``RunCtx.ep_grid``).  Its
``fsdp_gather`` half has no meaning without a mesh; the elastic restart
runs through ``examples/train_lm.py``'s functions (8 -> 6 ranks) where
the reference restarts its mesh trainer.

Run:  PYTHONPATH=src python -m repro_torch.testing.dist_suite [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import List, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_device, tree_leaves, tree_map
from repro_torch.configs.registry import SMOKE
from repro_torch.core import gasnet
from repro_torch.core.gasnet import P
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.examples import train_lm
from repro_torch.models import layers
from repro_torch.models.build import build_model
from repro_torch.optim import compression
from repro_torch.parallel.ctx import RunCtx
from repro_torch.parallel.pipeline import gpipe

N = 8
M, MB, D = 8, 4, 16  # GPipe: microbatches, microbatch rows, width


def compressed_all_reduce(device: torch.device) -> float:
    """int8 EF ring over 8 ranks against the exact sum; its rel error."""
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(N, 1024)).astype(np.float32)
    ).to(device)
    ctx = gasnet.Context(N, backend="xla", device=device)

    def prog(node, xl):
        err = torch.zeros((1024,), dtype=torch.float32, device=device)
        red, _ = compression.compressed_ring_all_reduce(node.engine, xl, err)
        return red

    red = ctx.spmd(prog, x.reshape(-1), out_specs=P("node")).reshape(N, -1)
    want = x.sum(0)
    rel = float((red[0] - want).abs().max() / want.abs().max())
    assert rel < 0.05, rel
    return rel


def stage(wl: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    return torch.tanh(xx @ wl[0])


def sequential(w: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    o = xs
    for i in range(w.shape[0]):
        o = torch.tanh(o @ w[i])
    return o


def gpipe_parity(device: torch.device, backend: str = "xla",
                 boundary_segments: Optional[int] = None):
    """8-stage GPipe forward against the sequential chain (atol 1e-5) and
    the gradients of sum(out ** 2) against the chain's (2e-4)."""
    xm = torch.from_numpy(np.random.default_rng(1).normal(
        size=(M, MB, D)).astype(np.float32)).to(device)
    w0 = torch.from_numpy((np.random.default_rng(2).normal(
        size=(N, D, D)) * 0.1).astype(np.float32)).to(device)
    ctx = gasnet.Context(N, backend=backend, device=device)

    def pipe(w):
        return ctx.spmd(
            lambda node, wl, xs: gpipe(stage, wl, xs, engine=node.engine,
                                       n_stages=N,
                                       boundary_segments=boundary_segments),
            w, xm, in_specs=(P("node"), P()), out_specs=P())

    w = w0.clone().requires_grad_()
    out = pipe(w)
    ws = w0.clone().requires_grad_()
    ref = sequential(ws, xm)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    (out ** 2).sum().backward()
    (ref ** 2).sum().backward()
    torch.testing.assert_close(w.grad, ws.grad, atol=2e-4, rtol=2e-4)
    return out.detach(), w.grad


EP_GRID = (2, 4)  # the reference's (data, model) mesh


def ep_moe_parity(device: torch.device, backend: str = "xla") -> float:
    """arctic-480b SMOKE with capacity factor 4.0: the MoE FFN
    expert-parallel on a (2, 4) grid against the local path on 8 x 16
    tokens.  EP routes each token shard with its own capacity, so drop
    boundaries may differ at the margin: more than 97% of the token rows
    within 1e-4 (the reference's gate).  Returns that share."""
    cfg = dataclasses.replace(SMOKE["arctic-480b"], capacity_factor=4.0)
    gen = torch.Generator(device=device).manual_seed(1)
    p = layers.moe_init(cfg, RunCtx(), gen)
    x = torch.from_numpy((np.random.default_rng(3).normal(
        size=(8, 16, cfg.d_model)) * 0.1).astype(np.float32)).to(device)
    ctx_ep = RunCtx(moe_mode="ep_shardmap", moe_backend=backend,
                    ep_grid=EP_GRID, remat="none")
    with torch.no_grad():
        y_ep = layers.apply_moe(p, cfg, ctx_ep, x)
        y_lo = layers.apply_moe(p, cfg, RunCtx(moe_mode="local",
                                               remat="none"), x)
    diff = (y_ep - y_lo).abs().amax(-1).reshape(-1)
    frac_same = float((diff < 1e-4).float().mean())
    assert frac_same > 0.97, frac_same
    return frac_same


def remat_names_parity(device: torch.device):
    """qwen3-4b SMOKE: loss and gradients under remat "names" against
    "full" (loss within 1e-4, gradients atol 2e-4, rtol 2e-3)."""
    cfg = SMOKE["qwen3-4b"]
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(2)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(RunCtx(), gen, device=device))
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
        cfg, batch=8, seq_len=32, seed=5).batch_at(0).items()}
    out = {}
    for remat in ("full", "names"):
        loss = model.train_loss(params, RunCtx(remat=remat), batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[remat] = (float(loss.detach()), grads)
    assert abs(out["full"][0] - out["names"][0]) < 1e-4, (
        out["full"][0], out["names"][0])
    for a, b in zip(out["full"][1], out["names"][1]):
        torch.testing.assert_close(b.float(), a.float(), atol=2e-4, rtol=2e-3)
    return out["full"][0], out["names"][0]


def elastic_restart(device: torch.device, ckpt_dir: str) -> dict:
    """Data-parallel training on 8 ranks through ``train_lm``, a failure at
    step 4, the restart from step 3's snapshot on 6 ranks (parameters and
    AdamW state bitwise the snapshot's), and training on to step 6."""
    out = train_lm.train(
        SMOKE["qwen3-4b"], steps=6, reduce_mode="gas_ring_int8",
        batch=24, seq=16, n_nodes=N, n_lost=2, fail_at=4, ckpt_every=3,
        ckpt_dir=ckpt_dir, device=device, say=lambda *a, **k: None)
    r = out["restart"]
    assert r["restored_step"] == 3 and r["n_nodes"] == 6, r
    assert r["bitwise"], r
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["history"][-1]["step"] == 5 and out["history"][-1][
        "n_nodes"] == 6
    return r


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rel = compressed_all_reduce(device)
    print(f"compressed all-reduce OK (rel {rel:.4f})")
    gpipe_parity(device)
    print("gpipe fwd+bwd parity OK")
    frac_same = ep_moe_parity(device)
    print(f"EP MoE vs local OK ({frac_same:.2%} token rows identical)")
    full, names = remat_names_parity(device)
    print(f"remat=names parity OK (loss {names:.6f} vs full {full:.6f})")
    with tempfile.TemporaryDirectory() as td:
        elastic_restart(device, td)
    print("elastic restart OK (8 -> 6 ranks, bitwise the snapshot's)")
    print("DIST_SUITE_PASS")


if __name__ == "__main__":
    main()
