"""A run with its timed path broken underneath reads ``correct`` false;
a sound one reads true.  The harness's look for a card is skipped: the
rest of a run is driven on the CPU at a small size, under the cell's own
limits.  Falcon's cell (its own files) and the serving driver (the
test's mix and limits) run too, though BENCHMARK.json lists neither."""

import pytest

from portbench import harness, manifest as mf

from conftest import FALCON_CELL, SERVE_CELL

# the faults each kind of cell can have
FAULTS = {"train": ["stale", "half_batch"], "serve_closed": ["token"]}
CASES = [(w["name"], fault) for w in mf.load_manifest()["workloads"]
         for fault in [""] + FAULTS[mf.mix(w["traffic"])["kind"]]]
CASES += [(FALCON_CELL["name"], fault) for fault in [""] + FAULTS["train"]]
CASES += [(SERVE_CELL["name"], fault) for fault in ["", "token"]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_correct_reads_the_fault(workload, fault, tiny_run):
    make, man = tiny_run
    out = harness.execute(make(workload, fault=fault), man)
    res = out["result"]
    assert res["correct"] is (fault == ""), out["lines"]
    assert list(res)[-1] == "checks"
    assert all(c["limit"] is not None for c in res["checks"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
