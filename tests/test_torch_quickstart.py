"""The reference's example programs on the port's three CPU backends.

The reference's ``examples/quickstart.py`` (8 forced host devices) and its
pipeline program (act 1, on 4 of them) run once, on the reference's
``"xla"`` backend, in one subprocess that saves their outputs to npz.  The
port's ``repro_torch.examples`` must give the same results on ``"xla"``,
``"gascore"`` and ``"xla,gascore"``: bit for bit, and to rtol 1e-6 on the
tanh path.  The reference's interpret-mode GAScore is left out: its parity
with ``"xla"`` is the reference suites' job.

The launches that ``chip_smoke.py`` expects on the card are checked here
against the transport calls each program makes on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.examples import heterogeneous_pipeline, quickstart
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ["xla", "gascore", "xla,gascore"]

_REFERENCE = r"""
import os, runpy, sys
import numpy as np
out_path = sys.argv[1]
g = runpy.run_path(os.path.join({root!r}, "examples", "quickstart.py"))
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import gasnet
res = {{k: np.asarray(g[k]) for k in
        ("seg", "got", "fetched", "acc", "ar", "bc", "ex", "seg_ar")}}

N = 4  # the pipeline example's mesh: 4 of the 8 host devices
mesh = jax.make_mesh((N,), ("node",), devices=jax.devices()[:N])

def pipeline_program(node, inbox, x):
    work = node.local(x)
    for _hop in range(N - 1):
        work = jnp.tanh(work) * 1.1
        inbox = node.put(inbox, work, to=gasnet.Shift(1), index=0)
        node.barrier()
        work = node.local(inbox).reshape(-1)[: work.shape[0]]
    return work[None]

ctx = gasnet.Context(mesh, node_axis="node", backend="xla")
aspace = ctx.address_space()
aspace.register("inbox", (128,), jnp.float32)
inbox = aspace.alloc("inbox")
ramp = np.linspace(-1, 1, 128, dtype=np.float32)
x = jnp.tile(jnp.asarray(ramp)[None], (N, 1))
res["pipeline"] = np.asarray(ctx.spmd(pipeline_program, inbox, x,
                                      out_specs=P("node")))
np.savez(out_path, **res)
print("REFERENCE_DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "examples.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(root=ROOT), str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0 and "REFERENCE_DONE" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    return dict(np.load(out))


def _same(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart_matches_reference(reference, backend):
    res = quickstart.run(backend, 8, "cpu", verbose=False)
    _same(res["overlap_seg"], reference["seg"])
    for key in ("got", "fetched", "acc", "ar", "bc", "ex", "seg_ar"):
        _same(res[key], reference[key])


@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_matches_reference(reference, backend):
    got = heterogeneous_pipeline.run_pipeline(backend, 4, "cpu")
    np.testing.assert_allclose(got.numpy(), reference["pipeline"], rtol=1e-6,
                               atol=0)


def test_pipeline_example_runs_all_acts():
    res = heterogeneous_pipeline.run("gascore", 4, "cpu", verbose=False)
    assert torch.equal(res["sw"], res["mixed"])
    seg, kv = res["kv_seg"], res["kv"]
    half = kv.shape[1]
    for d in range(4):
        assert torch.equal(seg[d, half:], kv[(d - 1) % 4])
        assert not seg[d, :half].any()


@pytest.fixture
def calls(monkeypatch):
    """Count the GAScore transport calls that reach ``kernels.ops`` (one
    kernel launch each on the card)."""
    seen = dict.fromkeys(chip_smoke.GAS_KERNELS, 0)
    for name in seen:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return seen


def _expect(*parts):
    want = dict.fromkeys(chip_smoke.GAS_KERNELS, 0)
    for part in parts:
        for k, v in part.items():
            want[k] += v
    return want


@pytest.mark.parametrize("backend", BACKENDS)
def test_chip_smoke_example_schedules(calls, backend):
    quickstart.run(backend, 8, "cpu", verbose=False)
    heterogeneous_pipeline.run_pipeline(backend, 4, "cpu")
    assert calls == _expect(chip_smoke.quickstart_launches(backend, 8),
                            chip_smoke.pipeline_launches(backend, 4))


@pytest.mark.parametrize("backend", BACKENDS)
def test_chip_smoke_full_program_schedule(calls, backend):
    """The full-size program at a tiny size: its results check out and its
    transport calls match the schedule ``chip_smoke.py`` asserts."""
    sizes = dict(rows=16, cols=4, am=4)
    out, seg, big = chip_smoke.run_full(backend, "cpu", seg_elems=64, put=8,
                                        **sizes)
    chip_smoke.check_full(out, seg, big, put=8, **sizes)
    assert calls == _expect(chip_smoke.full_launches(backend, **sizes))
