#!/usr/bin/env python3
"""Time the bf16 flash-attention forward and the paged-attention kernel of
two or more source trees on one GPU, in turns.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit, with each earlier tree unpacked first under ``build/`` (which git
ignores):

    mkdir -p build/ab/before
    git archive <commit> | tar -x -C build/ab/before
    python3 tools/ab_attention.py before=build/ab/before after=.

Each tree is driven through its own Python wrappers
(``repro_torch.kernels.flash_attention.flash_attention_fwd`` and
``repro_torch.kernels.paged_attention.paged_attention``, whose signatures
have not changed since the port began), with its kernels built from its
own sources into its own ``build/``; all the trees' builds start at once.
The trees are timed in turns, one process per turn, in the order given
and then in reverse (before, after, after, before), each turn held
against the plain versions and timed by ``chip_smoke.device_ms`` (CUDA
events behind a sleep kernel, the L2 flushed between calls):

- the forward at qwen3-4b's training shape (B 2, 32 q / 8 KV heads, S
  2048, D 128, causal) and non-causal at S 2048, beside SDPA's forward;
- paged attention, bf16 and f32, at ``chip_smoke.py``'s kernel-phase
  lengths and at the served steady step (8 requests of 148 tokens), also
  by events around one call; where the tree's wrapper has splits
  (``SPLIT_TOKENS``), with splits of 1, 2, 4 and 8 pages too.

A tree named with ``--unchecked`` is timed without the check: a probe
whose kernel was cut to do less work on purpose (``max_abs_err`` is still
reported).  Bounds come from this checkout's ``chip_smoke.py``.  Prints
one JSON line, with the card's name and power limit.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPLITS = (1, 2, 4, 8)  # pages per split, where the tree's kernel splits
KERNELS = ("flash_attention", "paged_attention")


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
            f"build.build_all({list(KERNELS)!r})", timeout=900)


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

    if not Path(chip_smoke.pa.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"paged wrapper not from {tree}")
    return chip_smoke


def flash_figures(cs, flush, gen, check):
    import torch

    record = {}
    for label, causal in (("train_causal", True), ("s2048_noncausal", False)):
        case = (2, 32, 8, 2048, 128, causal, None, torch.bfloat16)
        q, k, v, _, kw, _ = cs.flash_inputs(case, gen)
        want, want_lse = cs.ref.flash_attention_fwd(q, k, v, **kw)
        out, lse = cs.fa.flash_attention_fwd(q, k, v, **kw)
        err = (out.float() - want.float()).abs().max().item()
        if check:
            cs.within(f"flash {label}", out, want, 2e-2)
            cs.within(f"flash {label} lse", lse, want_lse, 2e-4)
        sdpa, _ = cs.sdpa_calls(q, k, v, q, causal)
        record[label] = {
            "device_ms": cs.device_ms(
                lambda: cs.fa.flash_attention_fwd(q, k, v, **kw), 10, flush),
            "sdpa_device_ms": cs.device_ms(sdpa, 10, flush),
            "max_abs_err": err}
        del q, k, v, want, want_lse, out, lse
    return record


def paged_figures(cs, flush, gen, check):
    import torch

    record = {}
    for label, lengths in (("kernel_phase", cs.kernel_phase_lengths()),
                           ("served_step", cs.SERVED_LENGTHS)):
        for dtype in (torch.bfloat16, torch.float32):
            args = cs.kernel_inputs(dtype, gen, lengths)

            def call():
                return cs.pa.paged_attention(*args)

            want = cs.ref.paged_attention(*args)
            err = (call().float() - want.float()).abs().max().item()
            if check and not err <= cs.KERNEL_ATOL[dtype]:
                raise AssertionError(f"paged {label} {dtype}: {err}")
            rec = {"max_abs_err": err,
                   "device_ms": cs.device_ms(call, 20, flush),
                   "events_ms": cs.cuda_time_ms(call, 20, flush)}
            if hasattr(cs.pa, "SPLIT_TOKENS"):
                default = cs.pa.SPLIT_TOKENS
                rec["by_pages_per_split"] = {}
                for pps in SPLITS:
                    cs.pa.SPLIT_TOKENS = pps * cs.T
                    rec["by_pages_per_split"][pps] = cs.device_ms(call, 20,
                                                                 flush)
                cs.pa.SPLIT_TOKENS = default
            record[f"{label} {str(dtype).split('.')[-1]}"] = rec
    return record


def measure(tree: Path, check: bool) -> None:
    cs = _import_tree(tree)
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    print(json.dumps({"flash_bf16": flash_figures(cs, flush, gen, check),
                      "paged": paged_figures(cs, flush, gen, check)}))


# ------------------------------------------------------------------ #


def bounds() -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    case = (2, 32, 8, 2048, 128, True, None, torch.bfloat16)
    out = {"flash train_causal": cs.flash_bounds(case)[
        "flash_attention_fwd"]["bound_ms"]}
    case = case[:5] + (False,) + case[6:]
    out["flash s2048_noncausal"] = cs.flash_bounds(case)[
        "flash_attention_fwd"]["bound_ms"]
    for label, lengths in (("kernel_phase", cs.kernel_phase_lengths()),
                           ("served_step", cs.SERVED_LENGTHS)):
        for dtype in (torch.bfloat16, torch.float32):
            out[f"paged {label} {str(dtype).split('.')[-1]}"] = (
                cs.kernel_bound_ms(dtype, lengths)[0])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", metavar="NAME=PATH",
                    help="the trees to time, in turn order")
    ap.add_argument("--unchecked", nargs="*", default=[], metavar="NAME",
                    help="trees timed without the check against the plain "
                    "versions (probes cut on purpose)")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--no-check", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.measure, check=not args.no_check)
    trees = dict(t.split("=", 1) for t in args.trees)
    trees = {name: Path(path).resolve() for name, path in trees.items()}
    if len(trees) < 2 or not set(args.unchecked) <= set(trees):
        ap.error("give at least two trees, NAME=PATH, and --unchecked "
                 "names among them")
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_attention.py needs a GPU")
    with concurrent.futures.ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(build, trees.values()))
    order = list(trees) + list(reversed(trees))
    turns = {name: [] for name in trees}
    for name in order:
        turns[name].append(measure_turn(trees[name],
                                        name not in args.unchecked))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "order": order, "bound_ms": bounds(),
                      "turns": turns}))


if __name__ == "__main__":
    main()
