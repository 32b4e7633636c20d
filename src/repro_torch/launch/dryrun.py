"""Dry run of every (arch × shape × mesh) cell: the port's
``repro.launch.dryrun``.

For each cell this builds the full-scale model on ``meta`` (no parameter
storage, no generator: ``Model.abstract_init``), makes the cell's step
(``train``: loss, backward and AdamW through ``Trainer``'s step;
``prefill``; ``decode`` at a cache of the shape's length) and runs it on
``meta`` under the op-stream counter (``launch/hlostats.py``).  What the
reference reads from XLA, the port reads from that run:

    memory.argument_size_in_bytes   parameters, optimizer state, batch and
                                    cache one device holds, from the
                                    sanitized specs (``parallel/sharding``)
    cost.flops / bytes_accessed     the counted op stream
    collectives                     operand bytes per collective type

A ``meta`` run takes every branch the card would take, so its counts are
those of the real step (``chip_smoke.py``'s ``dryrun`` phase checks that
on the card).  Without an SPMD partitioner, a step is counted whole on
one device: on a mesh of more than one chip the counts are GLOBAL (the
record's ``"counts": "global"``) and ``roofline.derive`` divides them by
the chips; no collective of the partitioned program is modelled.  The
specs and per-device bytes are the reference's, bit for bit.

Meshes: the reference's ``single`` (16 × 16) and ``multi`` (2 × 16 × 16),
and ``h100``, the 1 × 1 mesh of the one card the port runs on.  Records go
to ``results/dryrun_torch/<arch>__<shape>__<mesh>__<tag>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh h100
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh h100
    PYTHONPATH=src python -m repro_torch.launch.roofline --mesh h100
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.compat import TensorSpec, tree_leaves, tree_map
from repro_torch.configs.registry import ARCHS, SHAPES, ShapeConfig, cell_runnable
from repro_torch.core.addrspace import PartitionSpec as P
from repro_torch.launch import hlostats
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh, mesh_axes
from repro_torch.models.build import Model, build_model, meta_tensors, structs_of
from repro_torch.optim import adamw
from repro_torch.parallel.ctx import RunCtx
from repro_torch.parallel.sharding import named_shardings
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["MESHES", "argument_bytes", "build_ctx", "make_step", "mesh_of",
           "opt_config", "run_cell", "step_structs"]

MESHES = ("single", "multi", "h100")
OUT_DIR = "results/dryrun_torch"


def mesh_of(kind: str) -> Mesh:
    """``single`` / ``multi``: the production meshes; ``h100``: one card."""
    if kind == "h100":
        return make_mesh((1, 1), ("data", "model"))
    if kind in ("single", "multi"):
        return make_production_mesh(multi_pod=kind == "multi")
    raise ValueError(f"mesh {kind!r}: one of {MESHES}")


def build_ctx(mesh: Mesh, *, attn_chunk: int = 512, remat: str = "full",
              moe_mode: str = "auto", fsdp_gather: bool = False,
              seq_shard_acts: bool = False, scan_impl: str = "ref") -> RunCtx:
    dp, tp = mesh_axes(mesh)
    return RunCtx(
        mesh=mesh, dp=dp, tp=tp, remat=remat, moe_mode=moe_mode,
        attn_chunk=attn_chunk, scan_impl=scan_impl, fsdp_gather=fsdp_gather,
        seq_shard_acts=seq_shard_acts,
    )


def opt_config(model: Model) -> adamw.AdamWConfig:
    """The reference dry run's AdamW: bf16 moments from d_model 8192."""
    return adamw.AdamWConfig(
        schedule=adamw.warmup_cosine(3e-4, 2000, 100000),
        state_dtype=(torch.float32 if model.cfg.d_model < 8192
                     else torch.bfloat16),
    )


def step_structs(model: Model, ctx: RunCtx, shape: ShapeConfig,
                 opt_cfg: adamw.AdamWConfig) -> Tuple[Tuple, Tuple]:
    """The step's arguments as ``TensorSpec`` trees and their specs, in
    call order: train (params, opt_state, batch), prefill (params, batch),
    decode (params, token, positions, caches)."""
    params, specs = model.abstract_init(ctx)
    p_struct = structs_of(params)
    batch = model.input_structs(shape)
    b_specs = model.input_specs(shape, ctx)
    if shape.kind == "train":
        zeros = lambda st: TensorSpec(st.shape, opt_cfg.state_dtype)  # noqa: E731
        opt = {"m": tree_map(zeros, p_struct), "v": tree_map(zeros, p_struct),
               "step": TensorSpec((), torch.int32)}
        return ((p_struct, opt, batch),
                (specs, adamw.state_specs(specs), b_specs))
    if shape.kind == "prefill":
        return (p_struct, batch), (specs, b_specs)
    caches = model.cache_structs(shape, ctx)
    return ((p_struct, batch["token"], batch["positions"], caches),
            (specs, b_specs["token"], b_specs["positions"],
             model.cache_specs(caches, ctx)))


def make_step(model: Model, ctx: RunCtx, shape: ShapeConfig,
              opt_cfg: adamw.AdamWConfig):
    """The cell's step, called with :func:`step_structs`' arguments."""
    if shape.kind == "train":
        return Trainer(model, ctx, opt_cfg, TrainerConfig()).make_train_step()
    if shape.kind == "prefill":
        return lambda params, batch: model.prefill(params, ctx, batch,
                                                   cache_len=shape.seq_len)
    return lambda params, token, positions, caches: model.decode_step(
        params, ctx, token, positions, caches)


def _is_spec(x: Any) -> bool:
    return isinstance(x, P)


def argument_bytes(structs: Any, specs: Any, mesh: Mesh) -> int:
    """Bytes one device holds of the step's arguments, each leaf laid
    out by its sanitized spec."""
    total = 0
    for st, (_, shard) in zip(
            tree_leaves(structs),
            tree_leaves(named_shardings(specs, structs, mesh), is_leaf=_is_pair)):
        n = 1
        for d in shard:
            n *= d
        total += n * torch.tensor([], dtype=st.dtype).element_size()
    return total


def _is_pair(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and _is_spec(x[0])


def meta_args(structs: Tuple, kind: str) -> Tuple:
    """The arguments on ``meta``; training's parameters require grad."""
    args = [meta_tensors(s) for s in structs]
    if kind == "train":
        args[0] = tree_map(lambda t: t.requires_grad_(), args[0])
    return tuple(args)


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    *,
    out_dir: Optional[str] = OUT_DIR,
    overrides: Optional[Dict[str, Any]] = None,
    tag: str = "baseline",
    cfg=None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Dry-run one cell; writes its record under ``out_dir`` (unless
    None) and returns it.  ``cfg`` replaces the registry's config (a
    SMOKE one in tests); ``mesh`` names a mesh other than ``mesh_kind``'s
    (``make_mesh``), recorded under ``mesh_kind``."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = mesh if mesh is not None else mesh_of(mesh_kind)
    overrides = overrides or {}
    ctx = build_ctx(mesh, **overrides.get("ctx", {}))
    cfg = cfg if cfg is not None else ARCHS[arch]
    if overrides.get("cfg"):
        cfg = dataclasses.replace(cfg, **overrides["cfg"])
    model = build_model(cfg)
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape.name,
        "shape_dims": {"kind": shape.kind, "seq_len": shape.seq_len,
                       "global_batch": shape.global_batch},
        "mesh": mesh_kind,
        "mesh_shape": dict(mesh.shape),
        "tag": tag,
        "n_devices": mesh.size,
        "counts": "global",
        "scan_impl": ctx.scan_impl,
        "status": "ok",
    }
    t0 = time.time()
    try:
        opt_cfg = opt_config(model)
        structs, specs = step_structs(model, ctx, shape, opt_cfg)
        rec["memory"] = {"argument_size_in_bytes":
                         argument_bytes(structs, specs, mesh)}
        step = make_step(model, ctx, shape, opt_cfg)
        args = meta_args(structs, shape.kind)
        rec["build_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        st = hlostats.analyze(step, *args)
        rec["trace_s"] = round(time.time() - t1, 1)
        rec["cost"] = {"flops": st.flops, "bytes_accessed": st.bytes}
        rec["collectives"] = {
            "per_type": st.collective_per_type,
            "counts": st.collective_counts,
            "total": st.collective_bytes,
        }
        rec["while_trips"] = st.while_trips
        rec["unresolved_whiles"] = st.unresolved_whiles
        rec["kernels"] = st.kernels
        rec["ops"] = st.ops
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape.name}__{mesh_kind}__{tag}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=list(MESHES) + ["both", "all"],
                    help="single | multi | h100; both = single and multi; "
                         "all = the three")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--moe-mode", default="auto")
    ap.add_argument("--fsdp-gather", action="store_true")
    ap.add_argument("--seq-shard-acts", action="store_true")
    ap.add_argument("--scan-impl", default="ref")
    args = ap.parse_args()

    cells = []
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"both": ["single", "multi"], "all": list(MESHES)}.get(
        args.mesh, [args.mesh])
    for a in archs:
        for s in shapes:
            ok, why = cell_runnable(a, s)
            if not ok:
                print(f"SKIP {a} × {s}: {why}")
                continue
            for m in meshes:
                cells.append((a, s, m))

    overrides = {
        "ctx": {
            "remat": args.remat,
            "attn_chunk": args.attn_chunk,
            "moe_mode": args.moe_mode,
            "fsdp_gather": args.fsdp_gather,
            "seq_shard_acts": args.seq_shard_acts,
            "scan_impl": args.scan_impl,
        }
    }
    for a, s, m in cells:
        rec = run_cell(a, s, m, out_dir=args.out, overrides=overrides,
                       tag=args.tag)
        status = rec["status"]
        extra = (
            f"flops={rec['cost']['flops']:.3e} "
            f"coll={rec['collectives']['total']:.3e}B "
            f"args/dev={rec['memory']['argument_size_in_bytes'] / 1e9:.2f}GB "
            f"trace={rec.get('trace_s')}s"
            if status == "ok"
            else rec.get("error", "")
        )
        print(f"[{status}] {a} × {s} × {m}: {extra}", flush=True)


if __name__ == "__main__":
    main()
