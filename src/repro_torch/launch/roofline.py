"""Roofline derivation from dry-run records, on the H100's peaks.

The port of ``repro.launch.roofline``.  Three terms per (arch × shape ×
mesh) cell, in seconds per step:

    compute    = flops_dev             / 989e12 bf16 FLOP/s
    memory     = analytic_bytes_dev    / 3.35e12 B/s of HBM
    collective = 2 × collective_bytes_dev / 3.35e12 B/s

with the card's constants from ``kernels.cost`` (the ones ``PERF.md``'s
kernel bounds use).  A collective is priced as the port's transport
moves it on one card: its operand read once and written once at the HBM
rate (how the GAScore rows of ``PERF.md`` get their bounds).

The port's dry run counts the ops a step dispatches on one device
(``launch/hlostats.py``), so a record's counts are GLOBAL
(``"counts": "global"``): the port has no SPMD partitioner to split a
step over a mesh.  :func:`derive` divides them by the record's chips,
the reference's even-sharding formula; a record without that key holds
per-device counts, as the reference's do.

The dominant term is the bottleneck; MODEL_FLOPS / counted flops
measures how much dispatched compute is "useful" (remat recompute and
element-wise work show up here).  MODEL_FLOPS = 6·N_active·tokens for
training, 2·N_active·tokens for inference steps.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.registry import ARCHS, SHAPES, ShapeConfig
from repro_torch.kernels.cost import HBM_BYTES_PER_S, PEAK_FLOPS

__all__ = ["HBM_CAPACITY_BYTES", "analytic_memory_bytes", "derive",
           "load_records", "model_flops", "table"]

PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]
HBM_CAPACITY_BYTES = 80e9  # one H100 80GB (the data sheet's 80 GB)
OUT_DIR = "results/dryrun_torch"


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def analytic_memory_bytes(arch: str, shape_name, chips: int,
                          state_bytes: int = 4) -> float:
    """Per-device HBM traffic per step under a fused schedule (the
    reference's formula, by value).

    train:   weights read fwd + bwd (bf16), grad write+read (f32),
             m/v read+write (state_bytes), param read+write;
             activations: one residual stream per layer saved + reread +
             recomputed under full remat (3 moves of B·S·D·2B per layer).
    prefill: weights once + KV cache write + activations write/read once.
    decode:  weights once (all experts resident for MoE: every expert is
             hit at batch>=128·topk) + full KV cache read + one slot write.

    ``shape_name`` names a cell of ``SHAPES``, or is a ``ShapeConfig``.
    """
    cfg = ARCHS[arch]
    shape = _shape(shape_name)
    total, active = cfg.param_counts()
    B, S = shape.global_batch, shape.seq_len
    D, L = cfg.d_model, cfg.n_layers + cfg.n_enc_layers
    KH, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    w_b = 2  # bf16 weights
    if shape.kind == "train":
        weight_traffic = total * (2 * w_b + 2 * 4 + 2 * state_bytes * 2
                                  + 2 * w_b)
        act_traffic = L * B * S * D * w_b * 3  # save + reread + recompute
        return (weight_traffic + act_traffic) / chips
    if shape.kind == "prefill":
        kv = L * B * S * KH * Dh * 2 * w_b if not cfg.attention_free else (
            L * B * (cfg.resolved_d_inner * cfg.ssm_state) * 4)
        act = L * B * S * D * w_b * 2
        return (total * w_b + kv + act) / chips
    # decode: per generated token
    if cfg.attention_free:
        state = L * B * cfg.resolved_d_inner * (cfg.ssm_state + 3) * 4 * 2
        return (total * w_b + state) / chips
    window = cfg.local_window if "local" in cfg.pattern else S
    kinds = cfg.layer_kinds()
    kv_read = B * KH * Dh * 2 * w_b * sum(
        min(S, window) if k == "local" else
        (0 if k in ("mamba",) else S) for k in kinds
    )
    return (total * w_b + kv_read) / chips


def model_flops(arch: str, shape_name) -> float:
    cfg = ARCHS[arch]
    shape = _shape(shape_name)
    _, n_active = cfg.param_counts()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def derive(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if rec.get("status") != "ok":
        return None
    chips = rec["n_devices"]
    split = chips if rec.get("counts") == "global" else 1
    # a cell cut from the registry's shape carries its own dims
    shape = (ShapeConfig(rec["shape"], **rec["shape_dims"])
             if "shape_dims" in rec else rec["shape"])
    flops_dev = rec["cost"].get("flops", 0.0) / split
    sched_bytes_dev = rec["cost"].get("bytes_accessed", 0.0) / split
    mem_dev = analytic_memory_bytes(rec["arch"], shape, chips)
    coll_dev = rec["collectives"]["total"] / split
    t_compute = flops_dev / PEAK_BF16
    t_memory = mem_dev / HBM_BYTES_PER_S
    t_coll = 2 * coll_dev / HBM_BYTES_PER_S
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], shape)
    hlo_global = flops_dev * chips
    useful = mf / hlo_global if hlo_global else 0.0
    # roofline fraction: useful-compute time over the bound set by the
    # dominant term
    t_useful = (mf / chips) / PEAK_BF16
    bound = max(terms.values())
    arg_dev = rec.get("memory", {}).get("argument_size_in_bytes")
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "tag", "n_devices")},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "sched_bytes_dev": sched_bytes_dev,
        "mem_bytes_dev": mem_dev,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": useful,
        "roofline_fraction": (t_useful / bound) if bound else 0.0,
        "collectives": rec["collectives"]["per_type"],
        "memory": rec.get("memory", {}),
        "arg_bytes_dev": arg_dev,
        "fits_one_card": (None if arg_dev is None
                          else arg_dev <= HBM_CAPACITY_BYTES),
    }


def load_records(out_dir: str = OUT_DIR) -> List[Dict[str, Any]]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def _fmt_t(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}µs"


def table(out_dir: str = OUT_DIR, tag: Optional[str] = None,
          mesh: Optional[str] = None) -> str:
    rows = []
    for rec in load_records(out_dir):
        if (tag and rec.get("tag") != tag) or (mesh and rec.get("mesh") != mesh):
            continue
        d = derive(rec)
        if d is None:
            rows.append(
                f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
                f"ERROR: {rec.get('error', '?')[:60]} | | | | | | | |"
            )
            continue
        arg = d["arg_bytes_dev"]
        rows.append(
            "| {arch} | {shape} | {mesh} | {tc} | {tm} | {tl} | **{dom}** | "
            "{ur:.2f} | {rf:.2f} | {gb} | {fits} |".format(
                arch=d["arch"], shape=d["shape"], mesh=d["mesh"],
                tc=_fmt_t(d["t_compute_s"]), tm=_fmt_t(d["t_memory_s"]),
                tl=_fmt_t(d["t_collective_s"]), dom=d["dominant"],
                ur=d["useful_ratio"], rf=d["roofline_fraction"],
                gb="?" if arg is None else f"{arg / 1e9:.2f}",
                fits={None: "?", True: "yes", False: "no"}[d["fits_one_card"]],
            )
        )
    header = (
        "| arch | shape | mesh | compute | memory | collective | dominant | "
        "useful | roofline frac | arg GB/dev | fits 80 GB |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|"
    )
    return header + "\n" + "\n".join(rows)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    print(table(args.dir, args.tag, args.mesh))
