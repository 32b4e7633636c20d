"""Data-parallel LM training ON the GAS layer, with int8 error-feedback
gradient rings, async checkpoints, an injected node failure and an
elastic restart on the surviving nodes.

Port of the reference's ``examples/train_lm.py``.  n GASNet nodes share
one device, their data stacked on a leading rank axis.  Every node
computes the gradients of its shard of the global batch, and the
gradient reduction is the paper's communication substrate: a ring of
one-sided puts (``--reduce gas_ring``), int8-compressed with error
feedback (``--reduce gas_ring_int8``), or the engine's all-reduce, the
reference's ``lax.pmean`` (``--reduce psum``); then AdamW.  At
``--fail-at`` the job loses ``--n-lost`` nodes; ``elastic_plan``
proposes the smaller ring, the latest snapshot restores onto it (held
bit for bit against the snapshot), and the deterministic data stream
resumes where it left off.

How a step runs.  The reference runs the whole step as one node program
under ``shard_map``.  On one device the port computes each node's loss
and gradients with plain autograd on its shard, node by node (local
compute, no communication: ``FlashAttention`` has no vmap rule, and
``torch.func.grad`` does not run the layers' checkpoints under vmap),
stacks them (one ``(n, L)`` f32 row a node for the rings, one ``(n,
*shape)`` tensor a leaf in its dtype for psum), and runs only the
reduction as a node program under ``Context.spmd`` on the chosen engine.
The reduced gradients are the same on every node, so AdamW updates the
one replicated copy of the parameters.  This computes the reference's
function (``examples/train_lm.py:44-75``).  The int8 ring's error state
is one row a node, as each device keeps its own in the reference.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
      PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
          --steps 12 --fail-at 7 --ckpt-every 4
"""

from __future__ import annotations

import argparse
import math
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.compat import resolve_device, tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.registry import SMOKE
from repro_torch.core import gasnet, sched
from repro_torch.core.gasnet import P
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.build import build_model
from repro_torch.optim import adamw, compression
from repro_torch.parallel.ctx import RunCtx
from repro_torch.runtime.ft import elastic_plan

__all__ = ["REDUCE_MODES", "NodeFailure", "local_grads", "reduce_grads",
           "make_step", "init_error", "train"]

REDUCE_MODES = ("psum", "gas_ring", "gas_ring_int8")
LOCAL_CTX = RunCtx(remat="none")  # the reference's local step


class NodeFailure(RuntimeError):
    """The injected loss of nodes."""


def _shards(batch: Dict[str, torch.Tensor], n: int) -> List[Dict]:
    B = batch["inputs"].shape[0]
    if B % n:
        raise ValueError(f"global batch {B} not divisible by {n} nodes")
    per = B // n
    return [{k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            for r in range(n)]


def local_grads(model, params, batch: Dict[str, torch.Tensor], n_nodes: int,
                *, flat: bool) -> Tuple[torch.Tensor, Any]:
    """Each node's loss and gradients on its shard of ``batch``, node by
    node.  Returns ``(losses (n,), stacked)``: with ``flat`` one ``(n,
    L)`` f32 buffer, each row a node's leaves flattened, concatenated and
    zero-padded to a multiple of n (the reference's flat ring payload);
    otherwise one ``(n, *shape)`` tensor a leaf, in the leaf's dtype."""
    leaves = tree_leaves(params)
    dev = leaves[0].device
    if flat:
        total = sum(p.numel() for p in leaves)
        stacked = torch.empty((n_nodes, total + (-total) % n_nodes),
                              dtype=torch.float32, device=dev)
        stacked[:, total:] = 0
    else:
        stacked = [torch.empty((n_nodes,) + tuple(p.shape), dtype=p.dtype,
                               device=dev) for p in leaves]
    losses = torch.empty((n_nodes,), dtype=torch.float32, device=dev)
    for r, shard in enumerate(_shards(batch, n_nodes)):
        loss = model.train_loss(params, LOCAL_CTX, shard)
        grads = torch.autograd.grad(loss, leaves)
        losses[r] = loss.detach()
        if flat:
            off = 0
            for g in grads:
                stacked[r, off:off + g.numel()].copy_(g.reshape(-1))
                off += g.numel()
        else:
            for s, g in zip(stacked, grads):
                s[r].copy_(g)
        del grads, loss
    return losses, stacked


def reduce_grads(
    stacked: Any,
    err: Optional[torch.Tensor],
    *,
    n_nodes: int,
    reduce_mode: str,
    engine: str = "xla",
) -> Tuple[Any, Optional[torch.Tensor]]:
    """The gradient reduction, a node program on ``engine``'s ranks: the
    mean over nodes of ``stacked`` (as :func:`local_grads` made it).
    Returns ``(reduced, err)``: for psum a list of leaves, else the flat
    f32 mean; ``err`` the int8 ring's new error state, one row a node
    (``(n, L)``), and passed through for the other modes."""
    n = n_nodes
    if reduce_mode not in REDUCE_MODES:
        raise ValueError(f"reduce mode {reduce_mode!r}: one of {REDUCE_MODES}")
    dev = (stacked[0] if reduce_mode == "psum" else stacked).device
    ctx = gasnet.Context(n, backend=engine, device=dev)
    if reduce_mode == "psum":
        shapes = [tuple(s.shape[1:]) for s in stacked]

        def pmean(node, *gs):
            return tuple(node.engine.all_reduce(g.reshape(shape)) / n
                         for g, shape in zip(gs, shapes))

        out = ctx.spmd(pmean, *[s.reshape(-1) for s in stacked],
                       out_specs=P())
        return list(out), err
    flat = stacked.reshape(-1)
    if reduce_mode == "gas_ring":
        # plan-driven: size-aware algorithm selection and segmentation
        red = ctx.spmd(lambda node, x: sched.all_reduce(node.engine, x) / n,
                       flat, out_specs=P())
        return red, err

    def ring_int8(node, x, e):
        red, new_err = compression.compressed_ring_all_reduce(
            node.engine, x, e)
        return red / n, new_err

    red, new_err = ctx.spmd(ring_int8, flat, err.reshape(-1),
                            out_specs=(P(), P("node")))
    return red, new_err.reshape(n, -1)


def _unflat(params: Any, red: torch.Tensor) -> Any:
    outs, off = [], 0
    for p in tree_leaves(params):
        outs.append(red[off:off + p.numel()].reshape(p.shape).to(p.dtype))
        off += p.numel()
    return tree_unflatten(params, outs)


def init_error(params: Any, n_nodes: int) -> torch.Tensor:
    """The int8 ring's zero error state, one row a node."""
    e = compression.init_error_state(params, n_nodes)
    return e.expand(n_nodes, -1).contiguous()


def make_step(model, opt_cfg: adamw.AdamWConfig, n_nodes: int,
              reduce_mode: str, *, engine: str = "xla") -> Callable:
    """Explicit-DP train step: local grads -> GAS reduction -> AdamW.

    ``step(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics)``; parameters and moments update in place, ``err`` is the
    int8 ring's error state (:func:`init_error`; None for the other
    modes), ``batch`` the global batch, split evenly over the nodes."""
    if reduce_mode not in REDUCE_MODES:
        raise ValueError(f"reduce mode {reduce_mode!r}: one of {REDUCE_MODES}")

    def step(params, opt_state, err, batch):
        losses, stacked = local_grads(model, params, batch, n_nodes,
                                      flat=reduce_mode != "psum")
        red, err = reduce_grads(stacked, err, n_nodes=n_nodes,
                                reduce_mode=reduce_mode, engine=engine)
        del stacked
        grads = (tree_unflatten(params, red) if reduce_mode == "psum"
                 else _unflat(params, red))
        del red
        params, opt_state, metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics["loss"] = losses.mean()  # lax.pmean of the nodes' losses
        return params, opt_state, err, metrics

    return step


def _snapshot(tree: Any) -> Any:
    """A copy of ``tree`` beside it on its device: what a save wrote."""
    return tree_map(lambda t: t.detach().clone(), tree)


def _bitwise(a: Any, b: Any) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train(
    cfg,
    *,
    steps: int,
    reduce_mode: str = "gas_ring_int8",
    engine: str = "xla",
    batch: int = 24,
    seq: int = 64,
    n_nodes: int = 8,
    n_lost: int = 2,
    fail_at: Optional[int] = 120,
    ckpt_every: int = 40,
    ckpt_dir: str,
    device: Any = None,
    lr: float = 3e-3,
    seed: int = 0,
    data_seed: int = 1,
    log_every: int = 20,
    say: Callable = print,
    on_step: Optional[Callable[[int, int, Dict], None]] = None,
) -> Dict[str, Any]:
    """The reference's main loop.  ``on_step(step, n_nodes, record)``
    runs after every step.  Returns the history (one record a step, its
    wall ``step_ms`` ending in the host's read of the loss), the
    restart (where it failed, the restored step and data cursor, the new
    node count and whether the restored parameters and AdamW state equal
    the snapshot bit for bit), the final parameters, optimizer and error
    state."""
    dev = resolve_device(device)
    model = build_model(cfg)
    opt_cfg = adamw.AdamWConfig(
        lr=lr, weight_decay=0.0,
        schedule=adamw.warmup_cosine(lr, 10, steps),
    )
    src = SyntheticLM(cfg, batch=batch, seq_len=seq, seed=data_seed)

    def to_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    n = n_nodes
    step_fn = make_step(model, opt_cfg, n, reduce_mode, engine=engine)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(RunCtx(), gen, device=dev))
    opt_state = adamw.init_state(params, opt_cfg)
    err = init_error(params, n) if reduce_mode == "gas_ring_int8" else None

    say(f"training {cfg.name} on {n} GASNet nodes ({engine}), "
        f"reduce={reduce_mode}")
    t0 = time.time()
    history: List[Dict[str, Any]] = []
    restart: Dict[str, Any] = {}
    snapshots: Dict[int, Any] = {}
    handle = None
    data_step, step, m = 0, 0, None
    while step < steps:
        try:
            if step == fail_at and n == n_nodes:
                lost = list(range(n - n_lost, n))
                raise NodeFailure(f"NODE FAILURE: nodes {lost} lost")
            t_step = time.perf_counter()
            b = to_dev(src.batch_at(data_step))
            params, opt_state, err, m = step_fn(params, opt_state, err, b)
            data_step += 1
            rec = {"step": step, "n_nodes": n, "loss": float(m["loss"]),
                   "lr": float(m["lr"]), "grad_norm": float(m["grad_norm"])}
            rec["step_ms"] = 1e3 * (time.perf_counter() - t_step)
            history.append(rec)
            if on_step is not None:
                on_step(step, n, rec)
            if step % log_every == 0 or step == steps - 1:
                say(f"  step {step:4d} loss {rec['loss']:.4f} "
                    f"lr {rec['lr']:.2e}")
            if (step + 1) % ckpt_every == 0:
                if handle:
                    handle.wait()
                snap = {"params": _snapshot(params),
                        "opt": _snapshot(opt_state)}
                snapshots = {step + 1: snap}  # the latest one only
                handle = ckpt.save(ckpt_dir, step + 1, snap,
                                   extra={"data_step": data_step})
            step += 1
        except NodeFailure as e:
            say(f"  !! {e}")
            plan = elastic_plan(n - n_lost, 1)
            n = math.prod(plan)
            while batch % n:  # keep the global batch divisible
                n -= 1
            say(f"  elastic plan -> continue on {n} nodes")
            if handle:
                handle.wait()
            last = ckpt.latest_step(ckpt_dir)
            with torch.no_grad():
                tree, extra = ckpt.restore(
                    ckpt_dir, last, {"params": params, "opt": opt_state})
            params = tree_map(lambda t: t.requires_grad_(), tree["params"])
            opt_state = tree["opt"]
            step_fn = make_step(model, opt_cfg, n, reduce_mode, engine=engine)
            err = (init_error(params, n) if reduce_mode == "gas_ring_int8"
                   else None)
            restart = {
                "failed_at": step, "restored_step": last,
                "data_step": int(extra["data_step"]), "n_nodes": n,
                "bitwise": _bitwise(snapshots[last]["params"], params)
                and _bitwise(snapshots[last]["opt"], opt_state),
            }
            if not restart["bitwise"]:
                raise AssertionError(
                    f"restored step {last} differs from its snapshot")
            step, data_step = last, restart["data_step"]
            say(f"  restored step {last} (data cursor {data_step}), "
                f"bitwise the snapshot's: {restart['bitwise']}; resuming")
    if handle:
        handle.wait()
    final = float(m["loss"]) if m is not None else float("nan")
    say(f"done in {time.time() - t0:.1f}s; final loss {final:.4f} "
        f"(started ~{np.log(cfg.vocab):.2f})")
    return {"history": history, "restart": restart, "params": params,
            "opt_state": opt_state, "err": err}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reduce", default="gas_ring_int8", choices=REDUCE_MODES)
    ap.add_argument("--engine", default="xla",
                    help="xla | gascore | a per-rank pattern (xla,gascore)")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-nodes", type=int, default=8)
    ap.add_argument("--n-lost", type=int, default=2)
    ap.add_argument("--fail-at", type=int, default=120)
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
        out = train(
            SMOKE["qwen3-4b"], steps=args.steps, reduce_mode=args.reduce,
            engine=args.engine, batch=args.batch, seq=args.seq,
            n_nodes=args.n_nodes, n_lost=args.n_lost, fail_at=args.fail_at,
            ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir or tmp,
            device=args.device,
        )
    if args.fail_at is not None and args.fail_at < args.steps:
        r = out["restart"]
        print(f"restart: failed at step {r['failed_at']}, restored step "
              f"{r['restored_step']} on {r['n_nodes']} nodes, params and "
              f"AdamW state bitwise the snapshot's: {r['bitwise']}")


if __name__ == "__main__":
    main()
