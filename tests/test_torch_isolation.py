"""The port stands alone: no module of ``repro_torch``, nor ``chip_smoke.py``,
imports JAX or the reference package.  Checked in a fresh interpreter
where importing ``jax``, ``jaxlib`` or ``repro`` raises."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None  # any import of it now raises ImportError
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c",
         _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    # every module of slices 1-5 was imported (the GAS substrate, its
    # kernels, the simulator, the node map and the examples among them; the
    # training path: flash-attention kernels, AdamW, data, checkpoints,
    # trainer and its entry point; the scan kernels' wrappers and the
    # falcon-mamba and recurrentgemma configs; the router kernel's wrapper
    # and the kimi-k2 and arctic configs)
    assert int(proc.stdout.split()[-1]) >= 61
