"""The GAS layer's last pieces against the JAX reference, on the CPU.

The one-device twins of the reference's GAS and GAScore suites reach
their PASS lines; ``hierarchical_all_reduce`` on the port's group engines
is held bit for bit to the reference's own rings composed pod by pod
through its lockstep simulator; the Jacobi rod of the reference's
``examples/stencil_halo.py`` agrees with the dense rod, across the
port's backends byte for byte, and with the reference script's printed
figures.  The launches ``chip_smoke.py`` expects on the card are checked
against the transport calls each program makes here.
"""

import functools
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import collectives as jcoll
from repro.testing.sim import run_spmd as jrun_spmd
from repro_torch.core import collectives, gasnet
from repro_torch.core.engine import GroupEngine, make_engine, pod_engines
from repro_torch.examples import stencil_halo
from repro_torch.kernels import ops
from repro_torch.testing import gas_suite, gascore_suite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ["xla", "gascore", "xla,gascore"]
GRIDS = [(2, 4), (2, 2), (4, 2)]  # (pods, ranks per pod)
ROWS, COLS = 8, 16  # a rank's block


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


@pytest.mark.parametrize("suite,token", [(gas_suite, "GAS_SUITE_PASS"),
                                         (gascore_suite, "GASCORE_SUITE_PASS")],
                         ids=["gas", "gascore"])
def test_suite_twin_passes_on_the_cpu(capsys, suite, token):
    suite.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == token
    assert sum(line.endswith("OK") or " OK " in line for line in lines) >= 12


def _blocks(pods, inner):
    n = pods * inner
    return np.random.default_rng(n + pods).uniform(
        0.5, 1.5, (n, ROWS, COLS)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(pods, inner):
    """The reference's rings through its simulator: RS inside each pod,
    the ring all-reduce across the pods, AG inside each pod."""
    x = _blocks(pods, inner)

    def sim(fn, members, vals):
        outs = jrun_spmd(lambda e: fn(e, jnp.asarray(vals[e.rank])),
                         len(members))
        return dict(zip(members, (np.asarray(o) for o in outs)))

    n = pods * inner
    pod = [list(range(p * inner, (p + 1) * inner)) for p in range(pods)]
    ring = [list(range(i, n, inner)) for i in range(inner)]
    rs, ar, ag = {}, {}, {}
    for g in pod:
        rs.update(sim(jcoll.ring_reduce_scatter, g, [x[r] for r in g]))
    for g in ring:
        ar.update(sim(jcoll.ring_all_reduce, g, [rs[r] for r in g]))
    for g in pod:
        ag.update(sim(jcoll.ring_all_gather, g, [ar[r] for r in g]))
    return np.stack([ag[r] for r in range(n)])


@pytest.mark.parametrize("pods,inner", GRIDS, ids=[f"{p}x{i}" for p, i in GRIDS])
@pytest.mark.parametrize("backend", BACKENDS)
def test_hierarchical_all_reduce_matches_reference_rings(calls, backend, pods,
                                                         inner):
    x = _blocks(pods, inner)
    n = pods * inner

    def prog(node, v):
        i, o = pod_engines(node.engine, pods)
        return collectives.hierarchical_all_reduce(i, o, node.local(v))[None]

    got = gasnet.Context(n, backend=backend, device="cpu").spmd(
        prog, torch.from_numpy(x.copy())).numpy()
    want = _reference(pods, inner)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # the reference suite's own check
    np.testing.assert_allclose(got, np.tile(x.sum(0), (n, 1, 1)), rtol=1e-6)
    expect = dict.fromkeys(chip_smoke.GAS_KERNELS, 0)
    expect.update(chip_smoke.hier_launches(backend, n, pods, ROWS))
    assert calls == expect


def test_group_engines_partition_the_ranks():
    base = make_engine("gascore", "node", 8)
    inner, outer = pod_engines(base, 2)
    assert inner.groups == ((0, 1, 2, 3), (4, 5, 6, 7)) and inner.n_nodes == 4
    assert outer.groups == ((0, 4), (1, 5), (2, 6), (3, 7))
    assert outer.n_nodes == 2 and inner.name == outer.name == "gascore"
    # outer hops are one uniform shift of the ranks, inner ones are not
    assert outer._uniform(1)[1] == 4 and inner._uniform(1)[1] is None
    assert inner._lift([1, 2, 3, 0]) == [1, 2, 3, 0, 5, 6, 7, 4]
    with pytest.raises(ValueError, match="do not tile"):
        pod_engines(base, 3)
    with pytest.raises(ValueError, match="not a partition"):
        GroupEngine(base, [(0, 1, 2, 3), (4, 5, 6, 6)])


@pytest.fixture(scope="module")
def reference_rod():
    """The reference script's printed figures (8 forced host devices)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "stencil_halo.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    m = re.search(r"max=(\S+), total heat=(\S+)", proc.stdout)
    assert m, proc.stdout
    return m.group(1), m.group(2)


def test_stencil_matches_rod_reference_and_schedule(reference_rod, calls,
                                                    capsys):
    results = {}
    for backend in BACKENDS:
        before = dict(calls)
        results[backend] = stencil_halo.run(backend, "cpu")
        got = {k: calls[k] - before[k] for k in calls}
        expect = dict.fromkeys(chip_smoke.GAS_KERNELS, 0)
        expect.update(stencil_halo.launches(backend))
        assert got == expect
    for backend in BACKENDS[1:]:
        for key in ("seg", "heat"):
            assert (results[backend][key].numpy().tobytes()
                    == results["xla"][key].numpy().tobytes())
    assert results["xla"]["heat"].shape == (stencil_halo.N_NODES,
                                            stencil_halo.STEPS)
    printed = re.findall(r"max=(\S+), total heat=(\S+)",
                         capsys.readouterr().out)
    assert printed == [reference_rod] * len(BACKENDS)
