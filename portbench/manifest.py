"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<mix>.json``, whose ``kind`` names the generator
``traffic/<kind>.py`` and the driver ``drivers/<kind>.py``); a per-layer
metric is read by ``metrics/<metric>.py``; kernel names are mapped by
every ``kernels/*.json``.  Nothing here lists them: a later change adds
a cell, a mix, a metric or a kernel name as new files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest_path(root: Path = ROOT) -> Path:
    return root.parent / "BENCHMARK.json"


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads(manifest_path(root).read_text())


def cell(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def mix(name: str, root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = ROOT):
    return _module(root / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def reader(metric: str, root: Path = ROOT) -> Callable[[Dict], Optional[float]]:
    mod = _module(root / "metrics" / f"{metric}.py",
                  "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))
    return mod.read


def metrics_of(manifest: Dict[str, Any], workload: str, trace: bool
               ) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer
    metrics (``trace`` True): those that list it, or list no cells."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if "workloads" not in m or workload in m["workloads"]]


def problems(manifest: Dict[str, Any], root: Path = ROOT) -> List[str]:
    """Names, units and files that break the benchmark's rules; empty when
    the manifest is sound."""
    errs = []
    names = ([c["name"] for c in manifest["configs"]]
             + [w["name"] for w in manifest["workloads"]]
             + [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]])
    for n in names:
        if not NAME.match(n):
            errs.append(f"name {n!r}")
    if len(set(names)) != len(names):
        errs.append("a name is used twice")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(m["unit"]):
            errs.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"better of {m['name']}")
    cfgs = {c["name"] for c in manifest["configs"]}
    for c in manifest["configs"]:
        if not (root.parent / c["file"]).is_file():
            errs.append(f"file of {c['name']}")
        for k in c["reduced"]:
            if not NAME.match(k):
                errs.append(f"reduced key {k!r}")
    for w in manifest["workloads"]:
        if w["config"] not in cfgs:
            errs.append(f"config of {w['name']}")
        if not (root / "traffic" / f"{w['traffic']}.json").is_file():
            errs.append(f"traffic of {w['name']}")
        else:
            kind = mix(w["traffic"], root)["kind"]
            for sub in ("traffic", "drivers"):
                if not (root / sub / f"{kind}.py").is_file():
                    errs.append(f"{sub}/{kind}.py of {w['name']}")
        if not (root / "limits" / f"{w['name']}.json").is_file():
            errs.append(f"limits of {w['name']}")
    for m in manifest["per_layer"]:
        if not (root / "metrics" / f"{m['name']}.py").is_file():
            errs.append(f"reader of {m['name']}")
    return errs
