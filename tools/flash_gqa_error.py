#!/usr/bin/env python3
"""How far the bf16 flash dK/dV kernel and its plain version each lie from
the f64 sum of the same inputs, at GQA groups up to 48 (on a GPU).

For each case (B, Hq, Hkv, S, D, causal, window): bf16 q, k, v, dout from
a seeded generator, the plain forward's lse; dK and dV from the kernel,
from the plain version (f32) and in f64 (``ref.flash_attention_dkv_f64``).
Prints one JSON line a case: max |dV|, each side's distance from the f64
sum, the kernel against the plain version, the share of elements past
2e-2 x (1 + |plain|), and for dK and dV ``chip_smoke.exact_row_ratio``,
the largest key-row ratio of the check ``chip_smoke.within_exact``
applies (the kernel's row error over 2 x the plain version's plus 2**-8
of the row's max; at most 1 passes).

Run from the repository root:  python3 tools/flash_gqa_error.py
"""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import exact_row_ratio  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

CASES = [(2, 32, 8, 2048, 128, True, None), (2, 48, 1, 2048, 128, True, None),
         (1, 48, 1, 2048, 128, True, None), (2, 16, 16, 1024, 64, False, None),
         (1, 32, 16, 4096, 128, True, 1024)]


def run(case, seed=3):
    B, Hq, Hkv, S, D, causal, window = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, dout = (torch.randn((B, Hq, S, D), generator=g, device="cuda")
               .bfloat16() for _ in range(2))
    k, v = (torch.randn((B, Hkv, S, D), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    kw = dict(causal=causal, window=window)
    out, lse = ref.flash_attention_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, dout, lse, delta)
    dk, dv = fab.flash_attention_dkv(*args, **kw, block_q=128, block_k=128)
    pk, pv = ref.flash_attention_dkv(*args, **kw)
    edk, edv = ref.flash_attention_dkv_f64(*args, **kw)

    diff = (dv.float() - pv.float()).abs()
    return {
        "case": list(case), "max_abs_dv": float(edv.abs().max()),
        "kernel_vs_f64": float((dv.double() - edv).abs().max()),
        "plain_vs_f64": float((pv.double() - edv).abs().max()),
        "kernel_vs_plain": float(diff.max()),
        "share_past_2e-2_elementwise": float(
            (diff > 2e-2 * (1 + pv.float().abs())).float().mean()),
        "dv_row_ratio": exact_row_ratio(dv, pv, edv),
        "dk_row_ratio": exact_row_ratio(dk, pk, edk),
        "dk_kernel_vs_plain": float((dk.float() - pk.float()).abs().max()),
        "max_abs_dk": float(pk.float().abs().max())}


def main():
    if not torch.cuda.is_available():
        print("flash_gqa_error: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    for case in CASES:
        print(json.dumps(run(case)), flush=True)


if __name__ == "__main__":
    main()
