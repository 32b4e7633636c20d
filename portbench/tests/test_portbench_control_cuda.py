"""The control (the reference in float8 in the program's place) comes
out not correct at each cell's own size, on the card.  Every cell
trains; a serving cell adds its own control test."""

import time

import pytest

from portbench import check, harness, manifest as mf
from portbench.reference import family

SEED = 2**31 + 424243


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         [w["name"] for w in mf.load_manifest()["workloads"]])
def test_control_is_not_correct(workload, card):
    from portbench import program

    program.import_path()
    man = mf.load_manifest()
    r = harness.make_run(man, workload, SEED, 3.0, False, card, time.monotonic())
    drv = mf.driver(r.mix["kind"])
    m = r.cfg["model"]
    specs = family(m["family"]).layout(m)
    from portbench.traffic import train as traffic

    host = traffic.batches(r.mix, m["vocab"], SEED)
    keep = drv.keeps_first(r)
    ref = drv.reference_readings(r, specs, host, keep_first=keep)
    ctl = drv.reference_readings(r, specs, host, quant=True, keep_first=keep)
    numbers = check.training_numbers(ctl, ref, card)
    compared = {k for k, v in r.limits.items() if v.get("compared") is not False}
    assert compared <= set(numbers)  # the control fails a number it read
    ok, shown, lines = check.judge(numbers, r.limits)
    assert not ok, lines
