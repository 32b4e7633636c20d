"""The numbers that decide ``correct``, and their limits.

Training: the gap of the first step's loss; the gap between
the program's and the reference's norm of each leaf's first gradient as
AdamW gets it (after clipping), and of each leaf's change over the
first steps, both by the worst leaf and against the reference's norm of
that leaf or of the median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.  The largest gap of
the later steps' losses is read too, and not compared: the first AdamW
steps move each weight by about the learning rate whatever its
gradient's size, so the sign of a near-zero gradient, which rounding
decides, moves the later losses of sound runs as much as the control's
(``PERF.md``).

Where a cell's limits name ``grad_diff``, the first gradients are also
compared leaf by leaf: the worst leaf's norm of the difference, against
the same denominator.  Gaps of norms and of a mean loss move only with
the square of noise that is spread evenly over the elements, so they
can read a lower precision (the control) as close to the program as
the program is to the reference; the difference moves with the noise
itself (``PERF.md``).

Serving: the widest gap by which a served token's reference logit lies
below the reference's best logit at its position.

Each cell's limits are data, ``limits/<cell>.json``, each with the
readings it was set from.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict, List, Mapping, Tuple

ROOT = Path(__file__).resolve().parent
TINY_GRAD = 1e-3  # of the median leaf's reference gradient norm


def _worst(gaps: Mapping[str, float], ref: Mapping[str, float],
           names) -> Tuple[float, str]:
    """The largest of ``gaps`` over ``names``, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; and the leaf it is at."""
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = gaps[n] / max(ref[n], med, 1e-30)
        if gap >= worst:
            worst, at = gap, n
    return worst, at


def training_numbers(prog: Mapping, ref: Mapping, device="cpu"
                      ) -> Dict[str, Dict]:
    """``prog`` and ``ref`` hold ``losses``, ``grad_norms`` and
    ``change_norms`` (by leaf path name), and may hold ``first_grads``
    (host tensors by leaf path name, compared on ``device``)."""
    losses = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference ran different steps")
    gref = ref["grad_norms"]
    names = sorted(gref)
    med = statistics.median(gref.values())
    moving = [n for n in names if gref[n] >= TINY_GRAD * med]
    gap = lambda a, b: {n: abs(a[n] - b[n]) for n in b}
    grad, g_at = _worst(gap(prog["grad_norms"], gref), gref, names)
    cref = ref["change_norms"]
    change, c_at = _worst(gap(prog["change_norms"], cref), cref, moving)
    out = {
        "loss1_gap": {"value": losses[0], "at": "step 1"},
        "loss_gap": {"value": max(losses), "at": f"step {losses.index(max(losses)) + 1}"},
        "grad_gap": {"value": grad, "at": g_at},
        "change_gap": {"value": change, "at": c_at,
                       "left_out": sorted(set(names) - set(moving))},
    }
    if prog.get("first_grads") and ref.get("first_grads"):
        from portbench.reference.common import diff_norm

        a, b = prog["first_grads"], ref["first_grads"]
        diffs = {n: diff_norm(a[n].to(device), b[n].to(device)) for n in names}
        value, at = _worst(diffs, gref, names)
        out["grad_diff"] = {"value": value, "at": at}
    return out


def limits(cell: str, root: Path = ROOT) -> Dict[str, Dict]:
    return json.loads((root / "limits" / f"{cell}.json").read_text())


def judge(numbers: Mapping[str, Dict], lim: Mapping[str, Dict]
          ) -> Tuple[bool, Dict[str, Dict], List[str]]:
    """(correct, ``{name: {value, limit}}``, lines for standard error).
    A number that ``lim`` marks ``"compared": false`` is left out; any
    other number with no limit fails: it has not been calibrated; and
    so does a limit whose number was not read."""
    ok = True
    shown, lines = {}, []
    missing = {k: {"value": float("nan")} for k in lim if k not in numbers}
    for name, n in {**numbers, **missing}.items():
        if (lim.get(name) or {}).get("compared") is False:
            continue
        limit = (lim.get(name) or {}).get("limit")
        v = n["value"]
        good = limit is not None and v == v and v <= limit
        ok &= good
        shown[name] = {"value": v, "limit": limit}
        where = f" (at {n['at']})" if n.get("at") else ""
        lines.append(f"check {name} {v!r} limit {limit!r} "
                     f"{'ok' if good else 'FAILED'}{where}")
    return ok, shown, lines
