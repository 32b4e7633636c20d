#!/usr/bin/env python3
"""Time the selective scan and the RG-LRU scan of two or more source trees
on one GPU, in turns.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit, with each earlier tree unpacked first under ``build/`` (which git
ignores):

    mkdir -p build/ab/before
    git archive <commit> | tar -x -C build/ab/before
    python3 tools/ab_scan.py before=build/ab/before after=.

Each tree is driven through its own Python wrappers
(``repro_torch.kernels.ssm_scan.selective_scan`` with the final state, and
``repro_torch.kernels.rglru.gated_linear_scan``, whose signatures have not
changed since the port began), with its kernels built from its own sources
into its own ``build/``; all the trees' builds start at once.  The trees
are timed in turns, one process per turn, in the order given and then in
reverse (before, after, after, before), each turn at ``chip_smoke.py``'s
full-width cases (``SSM_FULL``: falcon-mamba's prefill, B 1 and 4 x 512 x
8192, N 16; ``LRU_FULL``: recurrentgemma's, B 1 and 4 x 2560 x 4096), in
bf16 and f32, on ``chip_smoke.py``'s inputs, held against the plain
versions at ``chip_smoke.SCAN_TOL`` and timed by ``chip_smoke.device_ms``
(CUDA events behind a sleep kernel, the L2 flushed between calls).

With ``--bwd`` the trees' backward kernels are timed instead, at
``chip_smoke.py``'s full-width training cases, bf16 and f32, by
``device_ms`` with the L2 flushed: the selective scan's
(``ssm_scan.selective_scan_bwd`` at ``SSM_BWD[0]``, falcon-mamba's B 1 x
4,096 x 8,192, N 16), each output held row by row to the f64 plain
backward as ``chip_smoke.scan_bwd_phase`` holds it (``rows_exact``,
``BWD_REL``), and the RG-LRU's (``rglru.gated_linear_scan_bwd`` at
``LRU_BWD[0]``, recurrentgemma's B 1 x 4,096 x 4,096, on the forward
kernel's h), held equal to ``ref.gated_linear_scan_bwd`` bit for bit.
``--only NAME`` (``ssm_scan_bwd`` or ``rglru_bwd``, repeatable) times
only those:

    python3 tools/ab_scan.py --bwd before=build/ab/before after=.
    python3 tools/ab_scan.py --bwd --only rglru_bwd before=build/ab/before after=.

A tree named with ``--unchecked`` is timed without the check: a probe
whose kernel was changed on purpose (a cut reduction, a faster
exponential); its ``max_abs_err`` and ``max_rel_err`` (the largest
|kernel - plain| / (1 + |plain|), the measure ``SCAN_TOL`` bounds) are
still reported.  Bounds and the selective scan's special-function floor
come from this checkout's ``chip_smoke.py``.  Prints one JSON line, with
the card's name, power limit and maximum SM clock.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("ssm_scan", "rglru")
BWD_KERNELS = ("ssm_scan_bwd", "rglru_bwd")


def _python(tree: Path, *args: str, timeout: int) -> str:
    env = {k: v for k, v in os.environ.items() if k != "REPRO_TORCH_BUILD_DIR"}
    p = subprocess.run([sys.executable, *args], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if p.returncode:
        raise SystemExit(f"{tree}: {' '.join(args)} failed:\n{p.stdout}"
                         f"{p.stderr}")
    return p.stdout


def build(tree: Path, kernels=KERNELS) -> None:
    _python(tree, "-c", "import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.kernels import build; "
            f"build.build_all({list(kernels)!r})", timeout=900)


def measure_turn(tree: Path, check: bool, bwd=None) -> dict:
    args = (["--measure", str(tree)] + ([] if check else ["--no-check"])
            + ([] if bwd is None else
               ["--bwd", *(f"--only={k}" for k in bwd)]))
    out = _python(tree, str(Path(__file__).resolve()), *args, timeout=900)
    return json.loads(out.strip().splitlines()[-1])


# ------------------------------------------------------------------ #
# one turn: runs inside a tree, with that tree's package imported
# ------------------------------------------------------------------ #


def _import_tree(tree: Path):
    """Import ``repro_torch`` from ``tree``, then this checkout's
    ``chip_smoke`` (whose imports of ``repro_torch`` then bind the tree's
    modules)."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401

    sys.path.insert(1, str(ROOT))
    import chip_smoke

    for mod in (chip_smoke.ssm_scan, chip_smoke.rglru):
        if not Path(mod.__file__).resolve().is_relative_to(tree):
            raise SystemExit(f"{mod.__name__} not from {tree}")
    return chip_smoke


def _errors(got, want):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return {"max_abs_err": diff.max().item(),
            "max_rel_err": (diff / (1 + want.abs())).max().item(),
            "finite": bool(got.isfinite().all())}


def figures(cs, flush, check):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    record = {"selective_scan": {}, "gated_linear_scan": {}}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case in cs.SSM_FULL:
            args = cs.ssm_inputs(case, dtype, gen)

            def call():
                return cs.ssm_scan.selective_scan(*args, final_state=True)

            y, h = call()
            want_y, want_h = cs.ref.selective_scan(*args), \
                cs.ref.mamba_final_state(*args[:4])
            if check:
                cs.within(f"selective_scan {case} {dname} y", y, want_y,
                          cs.SCAN_TOL[dtype])
                cs.within(f"selective_scan {case} {dname} h", h, want_h,
                          cs.SCAN_TOL[torch.float32])
            record["selective_scan"][f"{case} {dname}"] = {
                "y": _errors(y, want_y), "h": _errors(h, want_h),
                "device_ms": cs.device_ms(call, 20, flush)}
            del args, y, h, want_y, want_h
        for case in cs.LRU_FULL:
            a, b = cs.lru_inputs(case, dtype, gen)

            def call():
                return cs.rglru.gated_linear_scan(a, b)

            got, want = call(), cs.ref.gated_linear_scan(a, b)
            if check:
                cs.within(f"gated_linear_scan {case} {dname}", got, want,
                          cs.SCAN_TOL[dtype])
            record["gated_linear_scan"][f"{case} {dname}"] = {
                "y": _errors(got, want), "bit_equal": torch.equal(got, want),
                "device_ms": cs.device_ms(call, 20, flush)}
            del a, b, got, want
    return record


def figures_bwd(cs, flush, check, kernels=BWD_KERNELS):
    """The named backward kernels, bf16 and f32, with ``device_ms``: the
    selective scan's at ``SSM_BWD[0]`` with the largest row ratio of each
    output against the f64 plain backward (``chip_smoke.rows_exact``;
    raising past 1 when checked), the RG-LRU's at ``LRU_BWD[0]`` with its
    distance from the plain backward (raising unless equal bit for bit
    when checked)."""
    out = {}
    if "ssm_scan_bwd" in kernels:
        out["selective_scan_bwd"] = _ssm_bwd(cs, flush, check)
    if "rglru_bwd" in kernels:
        out["gated_linear_scan_bwd"] = _lru_bwd(cs, flush, check)
    return out


def _lru_bwd(cs, flush, check):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(30)
    case = cs.LRU_BWD[0]
    record = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        a, b = cs.lru_inputs(case, dtype, gen)
        h = cs.rglru.gated_linear_scan(a, b)
        dh = torch.randn(case, generator=gen, device="cuda").to(dtype)

        def call():
            return cs.rglru.gated_linear_scan_bwd(a, h, dh)

        got, want = call(), cs.ref.gated_linear_scan_bwd(a, h, dh)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        if check and not equal:
            raise SystemExit(f"gated_linear_scan_bwd {case} {dname}: not "
                             "equal to the plain version")
        record[f"{case} {dname}"] = {
            "da": _errors(got[0], want[0]), "db": _errors(got[1], want[1]),
            "bit_equal": equal, "device_ms": cs.device_ms(call, 20, flush)}
        del a, b, h, dh, got, want
    return record


def _ssm_bwd(cs, flush, check):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(18)
    case = cs.SSM_BWD[0]
    B, S, Di, N = case[:4]
    record = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        args = cs.ssm_inputs(case, dtype, gen)
        dy = torch.randn((B, S, Di), generator=gen, device="cuda").to(dtype)

        def call():
            return cs.ssm_scan.selective_scan_bwd(*args, dy)

        got = call()
        plain = cs.ref.selective_scan_bwd(*args, dy)
        exact = cs.ref.selective_scan_bwd(*args, dy, acc=torch.float64)
        terms = (dy.double().abs() * args[0].double().abs()).sum((0, 1))
        ratios = {}
        for name, g, p, e, width in zip(("dx", "ddt", "dA", "dB", "dC", "dD"),
                                        got, plain, exact,
                                        (Di, Di, N, N, N, 1)):
            _, ratios[name] = cs.rows_exact(
                f"selective_scan_bwd {name}", g, p, e, cs.BWD_REL[g.dtype],
                width, terms if name == "dD" else None)
        del got, plain, exact
        if check:
            cs.rows_failed({dname: {"row_ratio": ratios}})
        record[f"{case} {dname}"] = {"row_ratio": ratios,
                                     "device_ms": cs.device_ms(call, 10,
                                                               flush)}
        del args, dy
    return record


def measure(tree: Path, check: bool, bwd=None) -> None:
    cs = _import_tree(tree)
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    print(json.dumps(figures(cs, flush, check) if bwd is None else
                     figures_bwd(cs, flush, check, bwd)))


# ------------------------------------------------------------------ #


def bounds(clock_mhz: float, bwd=None) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    out = {}
    if bwd is None:
        kernels = (("selective_scan", cs.SSM_FULL),
                   ("gated_linear_scan", cs.LRU_FULL))
    else:
        kernels = tuple(k for name, k in (
            ("ssm_scan_bwd", ("selective_scan_bwd", cs.SSM_BWD[:1])),
            ("rglru_bwd", ("gated_linear_scan_bwd", cs.LRU_BWD[:1])))
            if name in bwd)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, cases in kernels:
            for case in cases:
                b = cs.scan_bounds(name, case, dtype)
                out[f"{name} {case} {dname}"] = {
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                    **cs.scan_sfu_floor(name, case, clock_mhz)}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", metavar="NAME=PATH",
                    help="the trees to time, in turn order")
    ap.add_argument("--unchecked", nargs="*", default=[], metavar="NAME",
                    help="trees timed without the check against the plain "
                    "versions (probes changed on purpose)")
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward kernels instead")
    ap.add_argument("--only", action="append", choices=BWD_KERNELS,
                    help="with --bwd, time only these backward kernels")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--no-check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.only and not args.bwd:
        ap.error("--only needs --bwd")
    args.bwd = (args.only or list(BWD_KERNELS)) if args.bwd else None
    if args.measure:
        return measure(args.measure, check=not args.no_check, bwd=args.bwd)
    trees = dict(t.split("=", 1) for t in args.trees)
    trees = {name: Path(path).resolve() for name, path in trees.items()}
    if not trees or not set(args.unchecked) <= set(trees):
        ap.error("give at least one tree, NAME=PATH, and --unchecked "
                 "names among them")
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_scan.py needs a GPU")
    kernels = KERNELS if args.bwd is None else (
        ("rglru", *args.bwd) if "rglru_bwd" in args.bwd else args.bwd)
    with concurrent.futures.ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(lambda t: build(t, kernels), trees.values()))
    order = list(trees) + list(reversed(trees))
    turns = {name: [] for name in trees}
    for name in order:
        turns[name].append(measure_turn(trees[name],
                                        name not in args.unchecked,
                                        args.bwd))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card, clock = cs.card(), cs.sm_clock_mhz()
    print(json.dumps({"card": card, "sm_clock_max_mhz": clock,
                      "order": order, "unchecked": args.unchecked,
                      "bounds": bounds(clock, args.bwd), "turns": turns}))


if __name__ == "__main__":
    main()
