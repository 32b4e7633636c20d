#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check, serve, report.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, one JSON line each:

1. build   — compile every CUDA kernel of the serving path with nvcc for
             sm_90a (all sources at once).
2. kernel  — each kernel against its plain PyTorch version at the serving
             path's shapes (bf16 and f32, NaN pages behind the lengths),
             timed with CUDA events against its bound.
3. serve   — qwen3-4b at full width and depth (36 layers, bf16, random
             weights from a seeded generator) through ``PagedServer``:
             16 requests of 128 prompt tokens, 64 new tokens each, four
             sharing a 64-token prefix; held against the dense ``Server``.
4. profile — three steady decode steps of a separate paged run under
             ``torch.profiler``: kernels, device busy time and share.

Then the card's name and power limit, the ``kernels`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero before that line.  Without CUDA it exits non-zero
and prints nothing on stdout.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch.serve import PagedServer, Request, Server  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.parallel.ctx import RunCtx  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the serving path's paged-attention shape (qwen3-4b, batch 8, 512 cache)
B, HQ, HKV, D, T, NP = 8, 32, 8, 128, 16, 32
# kernel vs plain: both accumulate in f32 from the same inputs; bf16 output
# rounding (8 mantissa bits on values of order 1) sets the bf16 tolerance
KERNEL_ATOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# first decode step, paged (kernel) vs dense server, bf16 through 36
# layers: the dense path rounds softmax weights to bf16, the kernel keeps
# them f32, so logits differ by bf16 noise; bound it against their scale
LOGIT_REL_TOL = 5e-2

BATCH, CACHE_LEN, PAGE_TOKENS = 8, 512, 16
N_REQ, PROMPT_LEN, MAX_NEW, SHARED = 16, 128, 64, 64
PROFILE_STEPS = (20, 21, 22)  # steady decode steps, in a separate run


def emit(record):
    print(json.dumps(record), flush=True)


def cuda_time_ms(fn, iters, flush):
    """Mean device time of ``fn`` per call: CUDA events around each call,
    with the 50 MB L2 overwritten before every call (the serving step
    reaches each layer's pages cold)."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def kernel_inputs(dtype, gen, lengths):
    dev = torch.device("cuda")
    P = B * NP + 1  # the last page is NaN garbage
    q = torch.randn((B, HQ, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, T, HKV, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, T, HKV, D), generator=gen, device=dev).to(dtype)
    kp[-1] = float("nan")
    vp[-1] = float("nan")
    perm = torch.randperm(B * NP, generator=gen, device=dev)
    table = perm.reshape(B, NP).to(torch.int32)
    for b in range(B):  # padded slots past the length point at the NaN page
        table[b, -(-int(lengths[b]) // T):] = P - 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


def kernel_bound_ms(dtype, lengths):
    """Least time for the same work: each live K/V page read once, q,
    table and lengths read once, the output written once; 4 flops per
    (q head, live position, dim) for q.k and p.v."""
    elem = torch.tensor([], dtype=dtype).element_size()
    live_pages = sum(-(-int(n) // T) for n in lengths)
    nbytes = (live_pages * T * HKV * D * 2 * elem + 2 * B * HQ * D * elem
              + B * NP * 4 + B * 4)
    flops = 4 * HQ * D * sum(int(n) for n in lengths)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase():
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    lengths = [1, CACHE_LEN] + rng.integers(1, CACHE_LEN + 1, size=B - 2).tolist()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = kernel_inputs(dtype, gen, lengths)
        got = pa.paged_attention(*args)
        want = ref.paged_attention(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"paged_attention {dtype}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        if err > KERNEL_ATOL[dtype]:
            raise AssertionError(
                f"paged_attention {dtype}: max |kernel - plain| {err} "
                f"> {KERNEL_ATOL[dtype]}"
            )
        ms = cuda_time_ms(lambda: pa.paged_attention(*args), 50, flush)
        plain_ms = cuda_time_ms(lambda: ref.paged_attention(*args), 10, flush)
        bound_ms, bound_by = kernel_bound_ms(dtype, lengths)
        out[str(dtype).split(".")[-1]] = {
            "max_abs_err": err, "atol": KERNEL_ATOL[dtype], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit({"phase": "kernel", "name": pa.NAME, "shape": {
        "B": B, "Hq": HQ, "Hkv": HKV, "D": D, "T": T, "NP": NP,
        "lengths": lengths}, "results": out})
    return out


def requests():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 151936, size=SHARED).tolist()
    reqs = []
    for rid in range(N_REQ):
        prompt = rng.integers(0, 151936, size=PROMPT_LEN).tolist()
        if rid < 4:
            prompt = shared + prompt[SHARED:]
        reqs.append(Request(rid=rid, prompt=prompt, max_new=MAX_NEW))
    return reqs


class RecordingPagedServer(PagedServer):
    """Keeps the first paged decode step's host logits, whether every
    step's logits were finite, and each step's wall time (the step ends
    with the logits' copy to the host, so the clock covers the device
    work).  Steps listed in ``profile_steps`` run under ``torch.profiler``
    and add to ``profile``."""

    def __init__(self, *a, profile_steps=(), **kw):
        super().__init__(*a, **kw)
        self.first_logits, self.all_finite, self.step_s = None, True, []
        self.profile_steps, self.profile = profile_steps, None

    def _decode_via_tables(self, tables):
        prof = None
        if len(self.step_s) in self.profile_steps:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA,
            ])
            prof.__enter__()
        t0 = time.perf_counter()
        logits = super()._decode_via_tables(tables)
        self.step_s.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            self.profile = step_breakdown(prof, self.step_s[-1], self.profile)
        if self.first_logits is None:
            self.first_logits = logits
        self.all_finite &= bool(np.isfinite(logits).all())
        return logits


def step_breakdown(prof, wall_s, acc):
    """Device time of one profiled decode step: the sum of its GPU kernels'
    durations (one stream, so they do not overlap), the share of the
    step's wall clock the device was busy, and paged attention's part."""
    acc = acc or {"steps": 0, "wall_ms": 0.0, "kernels": 0, "busy_ms": 0.0,
                  "paged_attention_ms": 0.0}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        acc["kernels"] += 1
        acc["busy_ms"] += ms
        if "paged_attention" in evt.name:
            acc["paged_attention_ms"] += ms
    acc["steps"] += 1
    acc["wall_ms"] += 1e3 * wall_s
    return acc


def profile_phase(model, ctx, params):
    """Three steady decode steps of a fresh paged server (the first batch
    of the serve phase's requests) under ``torch.profiler``, kept apart
    from the measured run so profiling costs it nothing.  Device figures
    are null when the profiler saw no GPU kernel (it could not trace the
    card)."""
    server = RecordingPagedServer(
        model, ctx, params, BATCH, CACHE_LEN, device="cuda",
        page_tokens=PAGE_TOKENS, profile_steps=PROFILE_STEPS,
    )
    for r in requests()[:BATCH]:
        r.max_new = PROFILE_STEPS[-1] + 2
        server.submit(r)
    server.run_until_drained()
    p = server.profile
    n, seen = p["steps"], p["kernels"] > 0
    emit({
        "phase": "profile", "steps": list(PROFILE_STEPS),
        "positions": PROMPT_LEN + PROFILE_STEPS[0],
        "step_wall_ms": p["wall_ms"] / n,
        "kernels_per_step": p["kernels"] / n if seen else None,
        "device_busy_ms": p["busy_ms"] / n if seen else None,
        "device_busy_share": p["busy_ms"] / p["wall_ms"] if seen else None,
        "paged_attention_ms": p["paged_attention_ms"] / n if seen else None,
    })


def serve_phase():
    cfg = ARCHS["qwen3-4b"]
    model, ctx = build_model(cfg), RunCtx()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(ctx, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    dense = Server(model, ctx, params, BATCH, CACHE_LEN, device="cuda")
    dense_logits = []
    decode = dense._decode

    def recording_decode(*a):
        logits, caches = decode(*a)
        if not dense_logits:
            dense_logits.append(logits.float().cpu().numpy())
        return logits, caches

    dense._decode = recording_decode
    for r in requests():
        dense.submit(r)
    dense_stats = dense.run_until_drained()
    dense_out = {r.rid: r.out for r in dense.finished}
    del dense

    server = RecordingPagedServer(
        model, ctx, params, BATCH, CACHE_LEN, device="cuda",
        page_tokens=PAGE_TOKENS,
    )
    for r in requests():
        server.submit(r)
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0  # the main path starts here
    stats = server.run_until_drained()
    launches = pa.paged_attention.launches

    paged_out = {r.rid: r.out for r in server.finished}
    if sorted(paged_out) != list(range(N_REQ)):
        raise AssertionError(f"finished {sorted(paged_out)} of {N_REQ} requests")
    short = {rid: len(o) for rid, o in paged_out.items() if len(o) != MAX_NEW}
    if short:
        raise AssertionError(f"requests without {MAX_NEW} tokens: {short}")
    steps = server.paged_decode_steps
    if launches != cfg.n_layers * steps or steps == 0:
        raise AssertionError(
            f"paged_attention launched {launches} times in {steps} decode "
            f"steps; want {cfg.n_layers} per step"
        )
    if not server.all_finite:
        raise AssertionError("non-finite logits on the paged path")
    first_p, first_d = server.first_logits, dense_logits[0]
    if first_p.shape != (BATCH, cfg.vocab) or first_d.shape != first_p.shape:
        raise AssertionError(f"logits shapes {first_p.shape}, {first_d.shape}")
    diff = float(np.abs(first_p - first_d).max())
    scale = float(np.abs(first_d).max())
    if diff > LOGIT_REL_TOL * scale:
        raise AssertionError(
            f"first decode step: paged vs dense logits differ by {diff} "
            f"(> {LOGIT_REL_TOL} x max |logit| {scale})"
        )
    agree = [
        sum(a == b for a, b in zip(paged_out[r], dense_out[r])) for r in paged_out
    ]
    if stats["pool_prefix_hits"] < 3 * (SHARED // PAGE_TOKENS):
        raise AssertionError(f"prefix sharing did not run: {stats}")
    record = {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "dtype": "bfloat16", "batch": BATCH,
        "cache_len": CACHE_LEN, "page_tokens": PAGE_TOKENS,
        "requests": stats["requests"], "decoded_tokens": stats["decoded_tokens"],
        "tok_per_s": stats["tok_per_s"], "p50_latency_s": stats["p50_latency_s"],
        "p50_ttft_s": stats["p50_ttft_s"], "wall_s": stats["wall_s"],
        "decode_steps": steps, "paged_attention_launches": launches,
        "decode_step_ms_median": 1e3 * float(np.median(server.step_s)),
        "decode_step_ms_mean": 1e3 * float(np.mean(server.step_s)),
        "first_step_logit_max_abs_diff": diff, "first_step_logit_max_abs": scale,
        "greedy_token_agreement": sum(agree) / (N_REQ * MAX_NEW),
        "requests_token_identical": sum(a == MAX_NEW for a in agree),
        "prefix_hits": stats["pool_prefix_hits"],
        "pool_pages": stats["pool_n_pages"],
        "pool_free_after": stats["pool_n_free"],
        "preemptions": stats["sched_evictions"],
        "dense_tok_per_s": dense_stats["tok_per_s"],
        "dense_p50_latency_s": dense_stats["p50_latency_s"],
        "init_s": init_s,
        "peak_device_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(record)
    profile_phase(model, ctx, params)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    # f32 products in full f32 (a stated reference, not TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = build.build_all([pa.NAME])
    emit({"phase": "build", "kernels": [pa.NAME], "seconds": seconds,
          "arch": "sm_90a", "nvcc_flags": list(build.NVCC_FLAGS)})

    kernel = kernel_phase()
    launches = serve_phase()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    k = kernel["bfloat16"]
    emit({"kernels": [{
        "name": pa.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:184",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
    }]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
