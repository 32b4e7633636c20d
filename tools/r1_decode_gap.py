#!/usr/bin/env python3
"""R1 on the CPU: how far the port's decode of a ``cross``/``xdec`` arch
lies from teacher forcing (``train_logits`` over the whole sequence).

``Model.decode_step`` gives the blocks no ``xkv``, as the reference's
does, so a cross sub-block decodes down the self path over its cached
encoder/image KV (ROADMAP.md section 3, R1; the port is held to the
reference's decode in tests/test_torch_zoo.py).  For seamless-m4t-medium
and llama-3.2-vision-11b (every ``xgate`` 0.5) at their SMOKE sizes in
f32, seeded: the max |logit difference| of a prefill of 8 tokens at its
last position, then of each of 4 decode steps, against ``train_logits``
of the same 12 tokens, and the logits' max |value|.  Prints one JSON line
an arch.

Run from the repository root:  python3 tools/r1_decode_gap.py
"""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import SMOKE  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.parallel.ctx import RunCtx  # noqa: E402

S, STEPS = 8, 4


@torch.no_grad()
def gap(arch):
    cfg = SMOKE[arch]
    model, ctx = build_model(cfg), RunCtx()
    gen = torch.Generator().manual_seed(0)
    params = model.init(ctx, gen, device="cpu")
    for seg in params["dec"]:
        for block in seg.values():
            if "xgate" in block:
                block["xgate"].fill_(0.5)
    toks = torch.randint(0, cfg.vocab, (2, S + STEPS), generator=gen,
                         dtype=torch.int32)
    extra = {}
    if cfg.n_enc_layers:
        extra["frames"] = torch.randn((2, 10, cfg.d_model), generator=gen)
    else:
        extra["xkv"] = torch.randn((2, cfg.cross_kv_len, cfg.d_model),
                                   generator=gen)
    full = model.train_logits(params, ctx, {"inputs": toks, **extra})
    logits, caches = model.prefill(params, ctx,
                                   {"inputs": toks[:, :S], **extra}, 32)
    out = {"arch": arch, "prefill": float((logits - full[:, S - 1]).abs().max()),
           "decode": [], "max_abs_logit": float(full.abs().max())}
    for j in range(STEPS):
        pos = torch.full((2,), S + j, dtype=torch.int32)
        logits, caches = model.decode_step(params, ctx,
                                           toks[:, S + j:S + j + 1], pos,
                                           caches)
        out["decode"].append(float((logits - full[:, S + j]).abs().max()))
    return out


def main():
    for arch in ("seamless-m4t-medium", "llama-3.2-vision-11b"):
        print(json.dumps(gap(arch)), flush=True)


if __name__ == "__main__":
    main()
