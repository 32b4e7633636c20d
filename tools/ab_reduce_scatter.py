#!/usr/bin/env python3
"""Time two builds of the GAScore reduce-scatter kernel on one GPU, in turns.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit, with an earlier version of ``csrc/gascore_ring.cu`` saved first:

    git show <commit>:src/repro_torch/kernels/csrc/gascore_ring.cu \\
        > build/ring_before.cu
    python3 tools/ab_reduce_scatter.py build/ring_before.cu

It builds that source ("before") beside the checkout's own ("after"),
checks that both give the bytes of the ring-order plain version on 8 ranks
of 16 MiB (f32 and bf16), and times before, after, after, before, then
``x.sum(0)`` twice, each by ``chip_smoke.device_ms`` (CUDA events behind a
sleep kernel, the L2 flushed between calls).  Prints one JSON line with
the card's name and power limit.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import gascore as gc  # noqa: E402


def load_before(source: Path):
    lib = build._build_dir() / "libring_before.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(source)], check=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).repro_gascore_reduce_scatter
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, i, ctypes.c_longlong, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        sys.exit("usage (on a GPU): ab_reduce_scatter.py BEFORE.cu")
    fn = load_before(Path(sys.argv[1]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def before(x):
        n = x.shape[0]
        out = torch.empty((n, x.shape[1] // n), dtype=x.dtype, device=x.device)
        err = fn({torch.float32: 0, torch.bfloat16: 1}[x.dtype], x.data_ptr(),
                 out.data_ptr(), n, out[0].numel(), 1, sms,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"before: CUDA error {err}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    record = {}
    for kind, elem in (("f32", 4), ("bf16", 2)):
        x = chip_smoke.gas_payload(kind, (1 << 24) // elem, gen)
        n, e = x.shape
        want = chip_smoke._bits(ref.reduce_scatter(x))
        calls = {"before": lambda: before(x),
                 "after": lambda: gc.ring_reduce_scatter(x),
                 "sum0": lambda: x.sum(0).view(n, e // n)}
        for name in ("before", "after"):
            if not torch.equal(chip_smoke._bits(calls[name]()), want):
                raise AssertionError(f"{name} {kind}: not the ring's bytes")
        times = {}
        for name in ("before", "after", "after", "before", "sum0", "sum0"):
            times.setdefault(name, []).append(
                chip_smoke.device_ms(calls[name], 20, flush))
        record[kind] = times
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "bound_ms_f32": 1e3 * 9 * (1 << 24)
                      / chip_smoke.HBM_BYTES_PER_S, "device_ms": record}))


if __name__ == "__main__":
    main()
