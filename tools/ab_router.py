#!/usr/bin/env python3
"""Time the MoE router kernel of two or more source trees on one GPU, in
turns; or sweep this checkout's launch plans.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit, with each earlier tree unpacked first under ``build/`` (which git
ignores):

    mkdir -p build/ab/before
    git archive <commit> | tar -x -C build/ab/before
    python3 tools/ab_router.py before=build/ab/before after=.

Each tree is driven through its own wrapper
(``repro_torch.kernels.moe_router.moe_router``, whose arguments have not
changed since the port began; its outputs are the four of
``ref.route_topk`` in older trees, ``(words, keep)`` in newer ones), with its kernel built from its own source
into its own ``build/``; all the trees' builds start at once.  The trees
are timed in turns, one process per turn, in the order given and then in
reverse (before, after, after, before), each turn at ``chip_smoke.py``'s
``ROUTER_T`` (a decode batch of 8, a prefill of 128, a long prefill of
8,192) for both ``ROUTER_ARCHS`` (kimi-k2: E 384, K 8; arctic: E 128,
K 2), on ``chip_smoke.py``'s logits and capacities.  Each case is held
against ``ref.route_topk`` (``chip_smoke.router_check``: indices, slots
and keep equal, weights within ``ROUTER_W_TOL``) and reports:

- ``device_ms`` with the logits in L2 (as the model leaves them) and with
  the L2 flushed (``chip_smoke.device_ms``: CUDA events behind a sleep
  kernel, the median of 50);
- ``host_us``, the host's enqueue of one call (``chip_smoke.host_us``),
  and its parts, each timed alone the same way: the outputs'
  allocation, the device query, the stream, the ctypes call with its
  launch (the rest is the wrapper's checks and the Python call); and
  three ways to allocate the outputs, the same in every tree;
- the device kernels of one call, and of them those named
  ``moe_router_*``, from ``torch.profiler``.

Each turn also times an empty kernel (``torch.cuda._sleep(0)``) the same
way: the floor of a ``device_ms`` span and of an enqueue.

A tree named with ``--unchecked`` (a probe whose kernel was changed on
purpose) is timed without the check; the places where its outputs differ
are reported instead.

``--plans`` instead times, in this checkout only, every launch plan that
``candidates`` lists (one CTA, one cluster, one cooperative grid, at
several CTA and warp shapes) at the ``SWEEP_T`` token counts for both
widths, each held against the plain version: the measurement the
thresholds of ``moe_router.plan`` come from.

Prints one JSON line, with the card's name and power limit.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_T = (8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 2048,
           4096, 8192)


def _python(tree: Path, *args: str, timeout: int) -> str:
    env = {k: v for k, v in os.environ.items() if k != "REPRO_TORCH_BUILD_DIR"}
    p = subprocess.run([sys.executable, *args], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if p.returncode:
        raise SystemExit(f"{tree}: {' '.join(args)} failed:\n{p.stdout}"
                         f"{p.stderr}")
    return p.stdout


def build(tree: Path) -> None:
    _python(tree, "-c", "import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.kernels import build; "
            "build.build_all(['moe_router'])", timeout=900)


def measure_turn(tree: Path, check: bool) -> dict:
    args = ["--measure", str(tree)] + ([] if check else ["--no-check"])
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

    if not Path(chip_smoke.mr.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"{chip_smoke.mr.__name__} not from {tree}")
    return chip_smoke


def host_parts(cs, x, K, cap):
    """The enqueue's parts, each timed alone by ``host_us``: the tree's
    allocation of the outputs, its device query and stream, and its
    ctypes call with the launch on prepared outputs."""
    import torch

    mr = cs.mr
    T, E = x.shape
    dev, n = x.device, T * K
    if hasattr(mr, "plan"):  # one launch by a plan
        how = mr.plan(T, *mr.card(dev.index))
        extra = -(-how.ctas * E // n) if how.mode == mr.GRID else 0
        words = torch.empty((3 + extra, T, K), dtype=torch.int32, device=dev)
        keep = torch.empty((T, K), dtype=torch.bool, device=dev)

        def alloc():
            e, s, w = torch.empty((3 + extra, T, K), dtype=torch.int32,
                                  device=dev).unbind(0)[:3]
            return e, s, w.view(torch.float32), torch.empty(
                (T, K), dtype=torch.bool, device=dev)

        def query():
            return mr.plan(T, *mr.card(dev.index))

        def stream():
            return torch._C._cuda_getCurrentRawStream(dev.index)

        s = stream()

        def call():
            return mr._kernel()[0](x.data_ptr(), T, E, K, cap, 1, how.mode,
                                   how.ctas, how.warps, how.tpw,
                                   words.data_ptr(), keep.data_ptr(), s)
    else:  # the earlier wrapper: four outputs, block counts, 3 launches
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tpw = mr.tokens_per_warp(T, sms)
        launch, blocks = mr._kernel()
        nb = blocks(T, tpw)
        outs = [torch.empty((T, K), dtype=dt, device=dev) for dt in (
            torch.int32, torch.int32, torch.float32, torch.bool)]
        counts = torch.empty((nb, E), dtype=torch.int32, device=dev)

        def alloc():
            return ([torch.empty((T, K), dtype=dt, device=dev) for dt in (
                torch.int32, torch.int32, torch.float32, torch.bool)]
                + ([torch.empty((nb, E), dtype=torch.int32, device=dev)]
                   if nb > 1 else []))

        def query():
            return mr.tokens_per_warp(T, torch.cuda.get_device_properties(
                dev).multi_processor_count)

        def stream():
            return torch.cuda.current_stream(dev).cuda_stream

        s = stream()

        def call():
            return launch(x.data_ptr(), T, E, K, cap, 1, tpw,
                          *(o.data_ptr() for o in outs),
                          counts.data_ptr() if nb > 1 else None, s)

    return {name: cs.host_us(fn) for name, fn in (
        ("alloc_us", alloc), ("query_us", query), ("stream_us", stream),
        ("ctypes_launch_us", call))}


def alloc_variants(cs, T, K):
    """Host time of three ways to make the four (T, K) outputs: four
    allocations; one buffer carved into four views; one int32 buffer of
    three planes unbound, the weight plane viewed as f32, and a bool
    tensor (the wrapper's way)."""
    import torch

    n = T * K

    def four():
        return [torch.empty((T, K), dtype=dt, device="cuda") for dt in (
            torch.int32, torch.int32, torch.float32, torch.bool)]

    def carved():
        b = torch.empty(3 * n + -(-n // 4), dtype=torch.int32, device="cuda")
        return (b[:n].view(T, K), b[n:2 * n].view(T, K),
                b[2 * n:3 * n].view(torch.float32).view(T, K),
                b[3 * n:].view(torch.bool)[:n].view(T, K))

    def planes():
        e, s, w = torch.empty((3, T, K), dtype=torch.int32,
                              device="cuda").unbind(0)
        return e, s, w.view(torch.float32), torch.empty(
            (T, K), dtype=torch.bool, device="cuda")

    return {name: cs.host_us(fn) for name, fn in (
        ("four_allocations_us", four), ("one_buffer_carved_us", carved),
        ("int32_planes_and_bool_us", planes))}


def kernels_per_call(cs, fn):
    own, every = cs.router_kernels_per_call(fn)
    return {"router_kernels_per_call": own, "device_kernels_per_call": every}


def mismatches(cs, x, K, cap):
    """A probe's outputs against the plain version's, without raising:
    the places where indices, slots or keep differ, and the max |weight
    difference|."""
    import torch

    got = cs.mr.moe_router(x, k=K, capacity=cap)
    if len(got) == 2:  # (words, keep): a wrapper of one packed form
        got = cs.mr.unpack(*got)
    want = cs.ref.route_topk(x, k=K, capacity=cap)
    torch.cuda.synchronize()
    return {"differ": sum(int((got[i] != want[i]).sum()) for i in (0, 1, 3)),
            "weight_err": float((got[2] - want[2]).abs().max())}


def figures(cs, check):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    record = {"floor": {"device_ms": cs.device_ms(empty, 50),
                        "device_ms_l2_flushed": cs.device_ms(empty, 50, flush),
                        "host_us": cs.host_us(empty)}}
    for arch in cs.ROUTER_ARCHS:
        cfg = cs.ARCHS[arch]
        E, K = cfg.n_experts, cfg.top_k
        for T in cs.ROUTER_T:
            x = cs.router_logits(T, E, gen)
            cap = cs.moe_layers.moe_capacity(cfg, T)
            name = f"E{E} K{K} T{T}"
            err = (cs.router_check(name, x, K, cap) if check
                   else mismatches(cs, x, K, cap))
            call = lambda: cs.mr.moe_router(x, k=K, capacity=cap)  # noqa: E731
            record[name] = {
                "max_abs_err": err,
                "device_ms": cs.device_ms(call, 50),
                "device_ms_l2_flushed": cs.device_ms(call, 50, flush),
                "host_us": cs.host_us(call),
                "host_parts": host_parts(cs, x, K, cap),
                "alloc_variants": alloc_variants(cs, T, K),
                **kernels_per_call(cs, call),
                **cs.router_bounds(T, E, K)}
    return record


def measure(tree: Path, check: bool) -> None:
    cs = _import_tree(tree)
    print(json.dumps(figures(cs, check)))


# ------------------------------------------------------------------ #
# the plan sweep, in this checkout
# ------------------------------------------------------------------ #


def _cdiv(a, b):
    return -(-a // b)


def candidates(mr, T, sms, max_cluster):
    """Launch plans for T tokens: one CTA or a cluster of 2-16 CTAs, a
    token a warp; grids of 4-32 warps a CTA and at most one CTA a SM (one
    wave) at the fewest tokens a warp that fits and at two and four times
    that."""
    out = []
    if T <= mr.MAX_WARPS:
        out.append(mr.Plan(mr.CTA, 1, T, 1))
    c = 2
    while c <= max_cluster:
        warps = _cdiv(T, c)
        if warps <= mr.MAX_WARPS:
            out.append(mr.Plan(mr.CLUSTER, _cdiv(T, warps), warps, 1))
        c *= 2
    for warps in (4, 8, 16, 32):
        tpw = max(1, _cdiv(T, sms * warps))
        for t in (tpw, 2 * tpw, 4 * tpw):
            ctas = _cdiv(T, warps * t)
            if ctas >= 2:
                out.append(mr.Plan(mr.GRID, ctas, warps, t))
    return [p for i, p in enumerate(out) if p not in out[:i] and (
        p.mode != mr.CLUSTER or p.ctas >= 2)]


def sweep():
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch

    mr = cs.mr
    sms, max_cluster = mr.card(0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {"sms": sms, "max_cluster": max_cluster, "chosen_by": {}, "times": {}}
    for arch in cs.ROUTER_ARCHS:
        cfg = cs.ARCHS[arch]
        E, K = cfg.n_experts, cfg.top_k
        for T in SWEEP_T:
            x = cs.router_logits(T, E, gen, ties=True)
            cap = cs.moe_layers.moe_capacity(cfg, T)
            want = cs.ref.route_topk(x, k=K, capacity=cap)
            rows = {}
            for how in candidates(mr, T, sms, max_cluster):
                got = mr.unpack(*mr.launch(x, K, cap, 1, how))
                torch.cuda.synchronize()
                for i in (0, 1, 3):
                    if not torch.equal(got[i], want[i]):
                        raise AssertionError(f"E{E} T{T} {how}: output {i}")
                call = lambda: mr.launch(x, K, cap, 1, how)  # noqa: E731
                rows[" ".join(map(str, how))] = [
                    cs.device_ms(call, 20), cs.device_ms(call, 20, flush)]
            key = f"E{E} K{K} T{T}"
            out["times"][key] = rows
            out["chosen_by"][key] = " ".join(map(str, mr.plan(
                T, sms, max_cluster)))
    out["columns"] = "plan 'mode ctas warps tpw': [device_ms, L2 flushed]"
    out["card"] = cs.card()
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", metavar="NAME=PATH",
                    help="the trees to time, in turn order")
    ap.add_argument("--plans", action="store_true",
                    help="sweep this checkout's launch plans instead")
    ap.add_argument("--unchecked", nargs="*", default=[], metavar="NAME",
                    help="trees timed without the check against the plain "
                    "version (probes changed on purpose)")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--no-check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.measure, check=not args.no_check)
    trees = dict(t.split("=", 1) for t in args.trees)
    trees = {name: Path(path).resolve() for name, path in trees.items()}
    if (not trees and not args.plans) or not set(args.unchecked) <= set(trees):
        ap.error("give at least one tree, NAME=PATH, or --plans, and "
                 "--unchecked names among the trees")
    import torch

    if not torch.cuda.is_available():
        sys.exit("usage (on a GPU): ab_router.py NAME=PATH ... | --plans")
    if args.plans:
        return sweep()
    with concurrent.futures.ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(build, trees.values()))
    order = list(trees) + list(reversed(trees))
    turns = {name: [] for name in trees}
    for name in order:
        turns[name].append(measure_turn(trees[name],
                                        name not in args.unchecked))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(json.dumps({"card": cs.card(), "order": order,
                      "unchecked": args.unchecked, "turns": turns}))


if __name__ == "__main__":
    main()
