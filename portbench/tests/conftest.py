"""Fixtures of the benchmark's own tests: small configurations of the
cells' models and mixes that a CPU runs in seconds, and the card check
for the tests marked ``cuda``."""

import copy
import sys
import time
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT), str(CHECKOUT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness, manifest as mf  # noqa: E402

TINY = {
    "dense": dict(layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
                  d_ff=128, vocab=256, dtype="float32"),
    "mamba": dict(layers=2, d_model=64, d_inner=128, ssm_state=4, dt_rank=8,
                  vocab=256, dtype="float32"),
}


# The serving driver's mix and limits for its CPU tests.  No cell of
# BENCHMARK.json serves yet; a serving cell adds its own mix and limits.
SERVE_MIX = {
    "kind": "serve_closed", "clients": 8, "batch": 8, "cache_len": 8192,
    "page_tokens": 16,
    "prompt": {"median": 2048, "sigma": 0.8, "min": 512, "max": 7936},
    "output": {"min": 16, "max": 64},
    "pool": 1024, "strata": 16, "pairing_seed": 0, "eos_id": -1,
    "warmup_prompts": [7936, 512, 2048, 4096], "warmup_new": 4,
    "ramp_requests": 16, "sample_requests": 8, "drain_seconds": 60,
    "trace_seconds": 15,
}
SERVE_CELL = {"name": "granite-34b.serve.test", "config": "granite-34b",
              "traffic": None, "chips": 1, "why": "the serving driver's tests"}
SERVE_LIMITS = {"max_gap": {"limit": 0.12, "unit": "logit"}}
# A cell whose files are here but which BENCHMARK.json does not list
# (PERF.md, section 7); its tests run it from those files.
FALCON_CELL = {"name": "falcon-mamba-7b.train.2x4k", "config": "falcon-mamba-7b",
               "traffic": "train.2x4k", "chips": 1,
               "why": "the mamba family's tests"}


def tiny_config(name):
    cfg = copy.deepcopy(mf.config(name))
    cfg["model"].update(TINY[cfg["model"]["family"]])
    return cfg


def tiny_mix(name):
    mix = copy.deepcopy(SERVE_MIX) if name is None else mf.mix(name)
    if mix["kind"] == "train":
        mix.update(batch=2, seq_len=32, window_batches=2)
    else:
        mix.update(cache_len=256, pool=64, strata=8, ramp_requests=4,
                   sample_requests=3, warmup_prompts=[120, 16],
                   prompt={"median": 40, "sigma": 0.8, "min": 16, "max": 120},
                   output={"min": 4, "max": 8})
    return mix


@pytest.fixture
def tiny_run():
    """``make(workload, fault="", seconds=1.0)``: a Run of the cell (or of
    ``SERVE_CELL`` or ``FALCON_CELL``) on the CPU at a small size, with its
    own limits."""
    import torch

    man = mf.load_manifest()

    def make(workload, fault="", seconds=1.0, seed=2**31 + 12345):
        from portbench import check

        if workload == SERVE_CELL["name"]:
            w, lim = SERVE_CELL, SERVE_LIMITS
        elif workload == FALCON_CELL["name"]:
            w, lim = FALCON_CELL, check.limits(workload)
        else:
            w, lim = mf.cell(man, workload), check.limits(workload)
        return harness.Run(
            workload=w, cfg=tiny_config(w["config"]), mix=tiny_mix(w["traffic"]),
            seed=seed, seconds=seconds, trace=False,
            device=torch.device("cpu"), t_start=time.monotonic(),
            limits=lim, fault=fault)

    return make, man


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
