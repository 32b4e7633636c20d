"""One run of one cell: the driver of its traffic's kind, the check of its
outputs, and the result line.

:func:`execute` is what ``run.py`` calls once it has found a card; the
tests call it on the CPU with small configurations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

from portbench import check, manifest as mf
from portbench.trace import Categories


@dataclasses.dataclass
class Run:
    workload: Dict[str, Any]  # the cell's entry in BENCHMARK.json
    cfg: Dict[str, Any]  # configs/<config>.json
    mix: Dict[str, Any]  # traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float  # time.monotonic() at the process's start
    limits: Dict[str, Dict]
    categories: Categories = dataclasses.field(default_factory=Categories)
    fault: str = ""  # tests only: break the timed path underneath

    @property
    def cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"


def make_run(manifest: Dict[str, Any], workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> Run:
    w = mf.cell(manifest, workload)
    return Run(workload=w, cfg=mf.config(w["config"]), mix=mf.mix(w["traffic"]),
               seed=seed, seconds=seconds, trace=trace, device=device,
               t_start=t_start, limits=check.limits(workload))


def execute(r: Run, manifest: Dict[str, Any]) -> Dict[str, Any]:
    """Drive the cell; returns the result (its keys in the order printed)
    and the lines that go last to standard error."""
    res = mf.driver(r.mix["kind"]).run(r)
    ok, shown, lines = check.judge(res["numbers"], r.limits)
    name = r.workload["name"]
    metrics: Dict[str, Dict[str, Any]] = {}
    for m in mf.metrics_of(manifest, name, r.trace):
        if r.trace:
            v = mf.reader(m["name"])(res["obs"])
        else:
            v = res["e2e"].get(m["name"])
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = device_info(r, res)
    out: Dict[str, Any] = {"correct": bool(ok), "attempted": res["attempted"],
                           "failed": res["failed"], "metrics": metrics,
                           "device": device}
    if r.trace and res["obs"] and res["obs"]["trace"].get("seen"):
        t = res["obs"]["trace"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = shown
    return {"result": out, "lines": lines, "info": res.get("info", {})}


def device_info(r: Run, res: Dict[str, Any]) -> Dict[str, Any]:
    if r.cuda:
        import torch

        kind = torch.cuda.get_device_name(r.device)
    else:
        kind = "cpu"
    d = {"platform": "gpu" if r.cuda else "cpu", "kind": kind,
         "count": r.workload["chips"],
         "memory_peak_bytes": res["memory_peak_bytes"]}
    obs: Optional[Dict] = res.get("obs")
    if r.trace and obs:
        t = obs["trace"]
        d["busy_s"] = t["busy_s"] if t.get("seen") else 0.0
        d["window_s"] = obs["window_s"]
    return d


def forbidden_modules(names: List[str]) -> List[str]:
    """Loaded modules whose top-level name is, whole, one of ``names``."""
    import sys

    return sorted({m for m in sys.modules if m.split(".")[0] in names})
