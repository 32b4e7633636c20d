"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the outputs were correct, the requests or steps attempted and failed,
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), the device, and each number compared beside its limit.
Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), when the program under test (``src/`` beside
this folder) is missing, or when the process ends up holding JAX or the
JAX package.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ["jax", "jaxlib", "flax", "repro"]


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run there builds; and PyTorch's allocator
    growing its segments in place, as a training job that fills the card
    runs it (a step's gradient accumulator, held twice while it is
    summed, otherwise strands gigabytes between cached blocks)."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    build = CHECKOUT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    _environment()
    sys.path.insert(0, str(CHECKOUT))

    from portbench import harness, manifest as mf, program

    man = mf.load_manifest()
    bad = mf.problems(man)
    if bad:
        print("BENCHMARK.json: " + "; ".join(bad), file=sys.stderr)
        return 2
    chips = mf.cell(man, args.workload)["chips"]
    if not program.SRC.joinpath("repro_torch").is_dir():
        print(f"no program under test at {program.SRC}", file=sys.stderr)
        return 2
    program.import_path()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.make_run(man, args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START)
    out = harness.execute(run, man)
    held = harness.forbidden_modules(FORBIDDEN)
    if held:
        print("the run holds modules it must not: " + ", ".join(held),
              file=sys.stderr)
        return 4
    print(json.dumps({"info": out["info"]}), file=sys.stderr)
    for line in out["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        sys.exit(1)
