"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds a,b,... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds 3] --out <file>

For each seed, in one process: the program's numbers against the plain
reference (a sound run at the cell's own size, over a short window), and
on the seeds asked for, the control's (the reference in float8 in the
program's place, against the float32 reference) and the faults' (the
timed path broken underneath: a training step's batch half left out; a
served token altered where it is produced).  One JSON line per reading.
Not run by the benchmark's own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    from portbench import run as _run

    _run._environment()
    from portbench import check, harness, manifest as mf, program, weights
    from portbench.reference import family

    program.import_path()
    import torch

    man = mf.load_manifest()
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    sound, ctrl, faulty = (seeds(args.seeds), seeds(args.control_seeds),
                           seeds(args.fault_seeds))
    out = open(args.out, "a")

    def emit(rec):
        out.write(json.dumps(rec) + "\n")
        out.flush()
        print(json.dumps(rec), flush=True)

    for seed in sorted(set(sound) | set(ctrl) | set(faulty)):
        r = harness.make_run(man, args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), time.monotonic())
        drv = mf.driver(r.mix["kind"])
        m = r.cfg["model"]
        specs = family(m["family"]).layout(m)
        t = time.monotonic()
        if r.mix["kind"] == "train":
            from portbench.traffic import train as traffic

            host = traffic.batches(r.mix, m["vocab"], seed)
            dev = r.device
            p = (drv.program_readings(r, specs, host, keep_first=True)
                 if seed in sound else None)
            ref = drv.reference_readings(r, specs, host, keep_first=True)
            base = {"seed": seed, "ref_losses": ref["losses"]}
            if p is not None:
                emit(dict(base, kind="program", losses=p["losses"],
                          **_values(check.training_numbers(p, ref, dev))))
                del p
            if seed in faulty:
                r.fault = "half_batch"
                p = drv.program_readings(r, specs, host, keep_first=True)
                r.fault = ""
                emit(dict(base, kind="fault_half_batch", losses=p["losses"],
                          **_values(check.training_numbers(p, ref, dev))))
                del p
            if seed in ctrl:
                c = drv.reference_readings(r, specs, host, quant=True,
                                           keep_first=True)
                emit(dict(base, kind="control_fp8", losses=c["losses"],
                          **_values(check.training_numbers(c, ref, dev))))
                del c
            del ref, base
        else:
            from portbench.traffic import serve_closed as traffic

            for fault in ([""] if seed in sound or seed in ctrl else []) + (
                    ["token"] if seed in faulty else []):
                r.fault = fault
                p = drv.program_run(r, specs, traffic.requests(
                    r.mix, m["vocab"], seed))
                chosen = drv.sample([s for s in p["sent"] if s["due"] >= p["t0"]],
                                    r.mix["sample_requests"], seed)
                n_tok = sum(len(s["req"].out) for s in chosen)
                if fault or seed in sound:
                    g = drv.gaps(r, specs, chosen)
                    emit({"seed": seed, "kind": "fault_token" if fault else "program",
                          "max_gap": max(g), "gaps": g, "tokens": n_tok})
                if not fault and seed in ctrl:
                    g = drv.gaps(r, specs, chosen, control=True)
                    emit({"seed": seed, "kind": "control_fp8", "max_gap": max(g),
                          "gaps": g, "tokens": n_tok})
        print(f"seed {seed}: {time.monotonic() - t:.1f}s", file=sys.stderr, flush=True)
        program.free()


def _values(numbers):
    return {k: v["value"] for k, v in numbers.items()} | {
        k + "_at": v.get("at") for k, v in numbers.items()}


if __name__ == "__main__":
    main()
