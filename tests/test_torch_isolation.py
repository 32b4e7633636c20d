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
print(" ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c",
         _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    # every module of slices 1-12 was imported (the GAS substrate, its
    # kernels, the simulator, the node map and the examples among them; the
    # training path: flash-attention kernels, AdamW, data, checkpoints,
    # trainer and its entry point; the scan kernels' wrappers and the
    # falcon-mamba and recurrentgemma configs; the router kernel's wrapper
    # and the kimi-k2 and arctic configs; slice 11's cluster, tier, health
    # and heartbeat; slice 12's tensor-parallel groups, parallel/tp.py and
    # testing/tp_suite.py; the device-time profiler, the int8 compression,
    # GPipe, the data-parallel example and the distributed suite; slice
    # 16's suite twins and stencil example; slice 17's analysis tools:
    # the kernels' cost formulas, sharding specs, the op-stream counter,
    # the roofline, the dry run and the counter's collective suite)
    names = proc.stdout.split()
    assert len(names) >= 85
    assert {"repro_torch.obs.profile", "repro_torch.optim.compression",
            "repro_torch.parallel.pipeline", "repro_torch.examples.train_lm",
            "repro_torch.testing.dist_suite", "repro_torch.testing.gas_suite",
            "repro_torch.testing.gascore_suite",
            "repro_torch.examples.stencil_halo",
            "repro_torch.kernels.cost", "repro_torch.parallel.sharding",
            "repro_torch.launch.hlostats", "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun",
            "repro_torch.testing.hlostats_coll_suite"} <= set(names)


def test_ab_reduce_scatter_tool_imports_without_jax_and_needs_a_card():
    """``tools/ab_reduce_scatter.py`` imports nothing of JAX or the
    reference and, without a card, exits with its usage and no result."""
    probe = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['ab_reduce_scatter.py', 'before.cu']\n"
        f"runpy.run_path({os.path.join(ROOT, 'tools', 'ab_reduce_scatter.py')!r},"
        " run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 1, proc.stderr[-4000:]
    assert "usage" in proc.stderr and not proc.stdout


def test_ab_attention_tool_imports_without_jax_and_needs_a_card():
    """``tools/ab_attention.py`` imports nothing of JAX or the reference
    and, without a card, exits before it builds or prints anything."""
    probe = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['ab_attention.py', 'before=build/ab/before', 'after=.']\n"
        f"runpy.run_path({os.path.join(ROOT, 'tools', 'ab_attention.py')!r},"
        " run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 1, proc.stderr[-4000:]
    assert "needs a GPU" in proc.stderr and not proc.stdout


def test_ab_router_tool_imports_without_jax_and_needs_a_card():
    """``tools/ab_router.py`` imports nothing of JAX or the reference and,
    without a card, exits with its usage before it builds or prints
    anything, for the turns and for the plan sweep alike."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for argv in (["before=build/ab/before", "after=."], ["--plans"]):
        probe = (
            "import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = ['ab_router.py', *{argv!r}]\n"
            f"runpy.run_path({os.path.join(ROOT, 'tools', 'ab_router.py')!r},"
            " run_name='__main__')\n")
        proc = subprocess.run([sys.executable, "-c", probe],
                              capture_output=True, text=True, timeout=120,
                              env=env, cwd=ROOT)
        assert proc.returncode == 1, proc.stderr[-4000:]
        assert "usage" in proc.stderr and not proc.stdout
