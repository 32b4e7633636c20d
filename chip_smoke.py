#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check, run, report.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, one JSON line each:

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             (one nvcc per source, all started at once).
2. kernel  — paged attention against its plain PyTorch version at the
             serving path's shapes (bf16 and f32, NaN pages behind the
             lengths), timed with CUDA events against its bound.
3. gascore — each of the five GAScore kernels against its plain version on
             8 ranks of 1 KiB, 1 MiB and 16 MiB (f32, bf16, and int32 bit
             patterns with NaNs in an f32 carrier): copies byte-equal, the
             reduce-scatter byte-equal to the ring order and within its
             rounding bound of ``sum(0)``; timed against the bound and the
             one PyTorch call that computes the same function.
4. gas     — the GAS substrate's main path: the quickstart and pipeline
             programs on the "xla", "gascore" and "xla,gascore" backends at
             their own sizes (all agree bit for bit), then at full size (8
             ranks, 16 MiB segments, 1 MiB puts and gets, AM medium
             messages of 512 floats, collectives over 16 MiB per rank, and
             act 3's offset put of one qwen3-4b layer's KV for a
             2,048-token prompt); launches per kernel checked against each
             program's static schedule.
5. serve   — qwen3-4b at full width and depth (36 layers, bf16, random
             weights from a seeded generator) through ``PagedServer``:
             16 requests of 128 prompt tokens, 64 new tokens each, four
             sharing a 64-token prefix; held against the dense ``Server``.
6. profile — three steady decode steps of a separate paged run under
             ``torch.profiler``: kernels, device busy time and share.

Then the card's name and power limit, the ``kernels`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero before that line.  Without CUDA it exits non-zero
and prints nothing on stdout.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core import collectives, gasnet, sched  # noqa: E402
from repro_torch.core.engine import make_engine  # noqa: E402
from repro_torch.core.gasnet import P  # noqa: E402
from repro_torch.examples import heterogeneous_pipeline, quickstart  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import gascore as gc  # noqa: E402
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


def host_us(fn, iters=50):
    """Host time per call of ``fn`` (the enqueue: checks, dispatch and the
    launch), without waiting for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


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


# --------------------------------------------------------------------------- #
# GAScore kernels (csrc/gascore_put.cu, csrc/gascore_ring.cu)
# --------------------------------------------------------------------------- #
N_RANKS = 8
GAS_SIZES = {"1KiB": 1 << 10, "1MiB": 1 << 20, "16MiB": 1 << 24}  # per rank
PERM = (3, 0, 6, 1, 7, 2, 5, 4)  # a bijection of the 8 ranks
GAS_KERNELS = {  # wrapper, source, TPU kernel it replaces
    "ring_shift": (gc.ring_shift, "gascore_put.cu", "gascore.py:67"),
    "perm_put": (gc.perm_put, "gascore_put.cu", "gascore.py:100"),
    "offset_put": (gc.offset_put, "gascore_put.cu", "gascore.py:147"),
    "ring_all_gather": (gc.ring_all_gather, "gascore_ring.cu", "gascore.py:207"),
    "ring_reduce_scatter": (gc.ring_reduce_scatter, "gascore_ring.cu",
                            "gascore.py:265"),
}


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _byte_equal(name, got, want):
    if got.shape != want.shape or not torch.equal(_bits(got), _bits(want)):
        raise AssertionError(f"{name}: kernel and plain version differ")


def gas_payload(kind, elems, gen):
    """(8, elems): f32, bf16, or int32 words (NaN patterns among them)
    viewed as f32."""
    dev = torch.device("cuda")
    if kind == "i32nan":
        w = torch.randint(-(2**31), 2**31 - 1, (N_RANKS, elems), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
        w[:, :2] = torch.tensor([0x7FC00001, -1], dtype=torch.int32, device=dev)
        return w.view(torch.float32)
    x = torch.randn((N_RANKS, elems), generator=gen, device=dev)
    return x.to(torch.bfloat16) if kind == "bf16" else x


def gas_cases(x):
    """Per kernel: (kernel call, plain call, library call, bytes moved).
    Bytes: each input read once, each output written once."""
    n, e = x.shape
    row = e * x.element_size()
    k = 3
    dst = torch.tensor(PERM, device=x.device)
    seg = torch.zeros((n, 2 * e), dtype=x.dtype, device=x.device)
    off_rows = [(r * e // n) // 8 * 8 for r in range(n)]
    offs = torch.tensor(off_rows, dtype=torch.int32, device=x.device)
    same = torch.full((n,), off_rows[1], dtype=torch.int32, device=x.device)
    rows = torch.arange(n, device=x.device)[:, None]
    cols = off_rows[1] + torch.arange(e, device=x.device)[None, :]
    shifted_rows = (rows + 1) % n

    def lib_offset():
        seg[shifted_rows, cols] = x  # one indexed (slice) assignment

    def lib_perm():
        out = torch.empty_like(x)
        out[dst] = x
        return out

    cases = {
        "ring_shift": (lambda: gc.ring_shift(x, k), lambda: ref.ring_shift(x, k),
                       lambda: torch.roll(x, k, 0), 2 * n * row),
        "perm_put": (lambda: gc.perm_put(x, PERM), lambda: ref.perm_put(x, PERM),
                     lib_perm, 2 * n * row),
        "offset_put": (lambda: gc.offset_put(seg, x, same, 1),
                       lambda: ref.offset_put(seg, x, same, 1), lib_offset,
                       2 * n * row),
        "ring_all_gather": (lambda: gc.ring_all_gather(x),
                            lambda: ref.all_gather(x),
                            lambda: x.reshape(1, -1).expand(n, -1).contiguous(),
                            n * row + n * n * row),
    }
    if x.dtype in (torch.float32, torch.bfloat16) and e % n == 0:
        cases["ring_reduce_scatter"] = (
            lambda: gc.ring_reduce_scatter(x), lambda: ref.reduce_scatter(x),
            lambda: x.sum(0).view(n, e // n), n * row + row)
    return cases, (seg, offs)


def gascore_kernel_phase():
    """Every GAScore kernel against its plain version (byte-equal) at each
    size and dtype; times at every size in f32.  Returns the 16 MiB f32
    figures per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    figures, checked = {}, []
    for size, nbytes in GAS_SIZES.items():
        for kind in ("f32", "bf16", "i32nan"):
            elem = 2 if kind == "bf16" else 4
            x = gas_payload(kind, nbytes // elem, gen)
            cases, (seg, offs) = gas_cases(x)
            if kind == "i32nan":  # a sum of bit patterns means nothing
                cases.pop("ring_reduce_scatter", None)
            for name, (kern, plain, _, _) in cases.items():
                want = plain()  # first: offset_put's kernel writes in place
                _byte_equal(f"{name} {size} {kind}", kern(), want)
                checked.append(f"{name}/{size}/{kind}")
            # per-rank offsets, written in place into a copy
            got = gc.offset_put(seg.clone(), x, offs, 5)
            _byte_equal(f"offset_put per-rank {size} {kind}", got,
                        ref.offset_put(seg, x, offs, 5))
            if "ring_reduce_scatter" in cases:
                # (n-1) roundings, each within half an ulp of a partial
                # sum bounded by sum |x| (2^-24 relative in f32, 2^-8 bf16)
                got = gc.ring_reduce_scatter(x).float()
                want = x.float().sum(0).view(N_RANKS, -1)
                half_ulp = 2.0**-24 if kind == "f32" else 2.0**-8
                tol = (N_RANKS - 1) * half_ulp * float(x.float().abs().sum(0).max())
                err = float((got - want).abs().max())
                if err > tol:
                    raise AssertionError(
                        f"reduce_scatter {size} {kind}: |ring - sum(0)| {err} "
                        f"> {tol}")
                if size == "16MiB":
                    figures.setdefault("_rs_vs_sum", {})[kind] = {
                        "max_abs_err": err, "tol": tol}
            if kind != "f32":
                continue
            for name, (kern, plain, lib, moved) in cases.items():
                iters = 20 if nbytes >= (1 << 20) else 100
                ms = cuda_time_ms(kern, iters, flush)
                plain_ms = cuda_time_ms(plain, max(iters // 2, 5), flush)
                library_ms = cuda_time_ms(lib, max(iters // 2, 5), flush)
                rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
                       "bound_by": "bytes", "bytes": moved, "max_abs_err": 0.0,
                       "host_us": host_us(kern), "plain_host_us": host_us(plain),
                       "library_host_us": host_us(lib)}
                figures.setdefault(name, {})[size] = rec
            del cases, seg, offs, x
    torch.cuda.synchronize()
    emit({"phase": "gascore", "ranks": N_RANKS, "sizes_per_rank": GAS_SIZES,
          "checked": len(checked), "byte_equal": True,
          "reduce_scatter_vs_sum0": figures.pop("_rs_vs_sum"),
          "f32": figures})
    return figures


# --------------------------------------------------------------------------- #
# the GAS substrate's main path: programs on three backends
# --------------------------------------------------------------------------- #
GAS_BACKENDS = ("xla", "gascore", "xla,gascore")
FULL_SEG = (1 << 24) // 4  # 16 MiB of f32 per rank
FULL_PUT = (1 << 20) // 4  # 1 MiB puts and gets
FULL_AM = 512  # AM medium payload, floats
FULL_ROWS, FULL_COLS = 512, 8192  # 16 MiB of f32 per rank for collectives
KV_S, KV_HEADS, KV_DIM = 2048, 8, 128  # qwen3-4b: 8 KV heads of dim 128


def counts():
    return {name: w.launches for name, (w, _, _) in GAS_KERNELS.items()}


def reset_counts():
    for w, _, _ in GAS_KERNELS.values():
        w.launches = 0


def quickstart_launches(backend, n):
    """Kernel launches of ``examples.quickstart`` (sections 2-7) on a
    backend: one per transfer of a gascore member, none on "xla"."""
    if "gascore" not in backend:
        return {}
    g = min(4, 16 // n)  # section 7's segments: 4 over (16 / n) rows
    # put 3 + get 2 + put_nb/get_nb 5 + AM exchange of 5 fields (n-1 each)
    # + all-reduce 2(n-1) + broadcast (n-1) + exchange (n-1) + segmented
    # all-reduce 2g(n-1)
    return {"ring_shift": 10 + (9 + 2 * g) * (n - 1)}


def pipeline_launches(backend, n):
    """``pipeline_program``: n-1 blocking puts of 3 transfers each."""
    return {"ring_shift": 3 * (n - 1)} if "gascore" in backend else {}


def make_full_program(put=FULL_PUT, am=FULL_AM):
    """The full-size node program: puts and gets of ``put`` floats (1 MiB)
    along a shift and a permutation, an AM medium of ``am`` floats, and the
    engine's and the scheduler's collectives over 16 MiB per rank."""

    def program(node, seg, big):
        n, me = node.n_nodes, node.my_id
        local = node.local(seg)
        payload = local[:put] + 1.0
        seg = node.put(seg, payload, to=gasnet.Shift(1), index=put)
        g1 = node.get(seg, frm=gasnet.Shift(3), index=put, size=put)
        seg = node.put(seg, payload, to=gasnet.Perm(PERM), index=2 * put)
        g2 = node.get(seg, frm=gasnet.Perm(PERM), index=2 * put, size=put)
        node.am_medium(((me + 1) % n).to(torch.int32), "sum",
                       payload=local[:am], args=(1,))
        state = node.am_flush({"acc": torch.zeros((am,), device=seg.device)})
        x = big  # this rank's (rows, cols) block
        e = node.engine
        ar = e.all_reduce(x)
        ag = e.all_gather(x)
        rs = e.reduce_scatter(x)
        sar = sched.all_reduce(e, x)
        return (seg, g1[None], g2[None], state["acc"][None], ar[None],
                ag[None], rs[None], sar[None])

    return program


def full_launches(backend, n=N_RANKS, rows=FULL_ROWS, cols=FULL_COLS,
                  am=FULL_AM, am_capacity=4):
    """Kernel launches of the full-size program, from its static schedule
    and the plans the scheduler makes for its payloads."""
    if "gascore" not in backend:
        return {}
    eng = make_engine(backend, "node", n)
    shift, perm = 3 + 2, 3 + 2  # a blocking put is 3 transfers, a get 2
    out = {}
    a2a = sched.plan_collective("all_to_all", nbytes=n * am_capacity * am * 4,
                                n_nodes=n, engine=eng)
    if a2a.algorithm == "direct":
        shift += 5 * (n - 1)  # five AM fields, n-1 puts each
    if eng.name == "map":  # the map's collectives: rings over its shifts
        shift += 2 * (n - 1) + (n - 1) + (n - 1)
    else:  # the fused kernels: all_reduce = RS + AG, then AG, then RS
        out["ring_all_gather"] = 2
        out["ring_reduce_scatter"] = 2
    p = sched.plan_collective("all_reduce", nbytes=rows * cols * 4, n_nodes=n,
                              engine=eng)
    if p.algorithm == "recursive_doubling":
        perm += int(math.log2(n))
    else:
        m = rows // n
        g = (1 if p.n_segments <= 1 or m < 2
             else len(collectives.segment_bounds(m, p.n_segments)))
        shift += 2 * g * (n - 1)
    out.update({"ring_shift": shift, "perm_put": perm})
    return out


def run_full(backend, device, n=N_RANKS, seg_elems=FULL_SEG, rows=FULL_ROWS,
             cols=FULL_COLS, put=FULL_PUT, am=FULL_AM, seed=0):
    ctx = gasnet.Context(n, backend=backend, device=device,
                         am_payload_width=am, am_capacity=4)
    ctx.handlers.register(
        "sum", lambda st, p, a: dict(st, acc=st["acc"] + p * a[0].float()))
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    seg = torch.randn((n, seg_elems), generator=gen, device=ctx.device)
    # small integers: every summation order gives the same f32 bits
    big = torch.randint(-8, 8, (n * rows, cols), generator=gen,
                        device=ctx.device).float()
    out = ctx.spmd(make_full_program(put, am), seg, big,
                   out_specs=(P("node"),) * 8)
    return out, seg, big


def check_full(out, seg, big, n=N_RANKS, rows=FULL_ROWS, cols=FULL_COLS,
               put=FULL_PUT, am=FULL_AM):
    """Full-size results against plain PyTorch on the same inputs."""
    new, g1, g2, acc, ar, ag, rs, sar = out
    for r in range(n):
        want = seg[(r - 1) % n, :put] + 1.0
        if not torch.equal(new[r, put:2 * put], want):
            raise AssertionError(f"shift put landed wrong on rank {r}")
    for s, d in enumerate(PERM):
        if not torch.equal(new[d, 2 * put:3 * put], seg[s, :put] + 1.0):
            raise AssertionError(f"perm put landed wrong on rank {d}")
    for r in range(n):
        if not torch.equal(g1[r], new[(r + 3) % n, put:2 * put]):
            raise AssertionError(f"shift get wrong on rank {r}")
        if not torch.equal(g2[r], new[PERM[r], 2 * put:3 * put]):
            raise AssertionError(f"perm get wrong on rank {r}")
        if not torch.equal(acc[r], seg[(r - 1) % n, :am]):
            raise AssertionError(f"AM handler result wrong on rank {r}")
    blocks = big.view(n, rows, cols)
    total = blocks.sum(0)
    for name, t in (("all_reduce", ar), ("sched.all_reduce", sar)):
        if not torch.equal(t, total.expand(n, -1, -1)):
            raise AssertionError(f"{name} wrong")
    if not torch.equal(ag, big.view(1, -1, cols).expand(n, -1, -1)):
        raise AssertionError("all_gather wrong")
    if not torch.equal(rs, total.view(n, rows // n, cols)):
        raise AssertionError("reduce_scatter wrong")


def gas_phase():
    """The GAS main path on three backends; returns the launches per
    kernel over the whole phase (counts set to 0 just before)."""
    reset_counts()
    walls, launches, first = {}, {}, {}
    for backend in GAS_BACKENDS:
        rec = {}
        before = counts()
        t0 = time.perf_counter()
        qs = quickstart.run(backend, 8, "cuda", verbose=False)
        torch.cuda.synchronize()
        rec["quickstart_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipe = heterogeneous_pipeline.run_pipeline(backend, 4, "cuda")
        torch.cuda.synchronize()
        rec["pipeline_s"] = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in counts().items()}
        want = dict.fromkeys(GAS_KERNELS, 0)
        for part in (quickstart_launches(backend, 8),
                     pipeline_launches(backend, 4)):
            for k, v in part.items():
                want[k] += v
        if got != want:
            raise AssertionError(f"{backend} examples: launches {got}, "
                                 f"schedule says {want}")
        if not first:
            first = {"qs": qs, "pipe": pipe}
        else:
            for k, v in qs.items():
                if not torch.equal(v, first["qs"][k]):
                    raise AssertionError(f"quickstart {k}: {backend} differs "
                                         "from xla")
            torch.testing.assert_close(pipe, first["pipe"], rtol=1e-6,
                                       atol=0.0)
        # full size: warm once, then time and check the second run
        before = counts()
        run_full(backend, "cuda")
        torch.cuda.synchronize()
        got1 = {k: v - before[k] for k, v in counts().items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, seg, big = run_full(backend, "cuda")
        torch.cuda.synchronize()
        rec["full_s"] = time.perf_counter() - t0
        rec["full_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        check_full(out, seg, big)
        want = dict.fromkeys(GAS_KERNELS, 0)
        want.update(full_launches(backend))
        if got1 != want:
            raise AssertionError(f"{backend} full size: launches {got1}, "
                                 f"schedule says {want}")
        rec["full_launches"] = got1
        del out, seg, big
        walls[backend] = rec
    # act 3 at full size: one qwen3-4b layer's K and V for a 2,048-token
    # prompt (16 MiB f32 per rank) into a 32 MiB segment
    before = counts()
    t0 = time.perf_counter()
    seg, kv = heterogeneous_pipeline.kv_handoff(
        N_RANKS, "cuda", S=KV_S, KH=KV_HEADS, Dh=2 * KV_DIM)
    torch.cuda.synchronize()
    act3_s = time.perf_counter() - t0
    half = kv.shape[1]
    for d in range(N_RANKS):
        if not torch.equal(seg[d, half:], kv[(d - 1) % N_RANKS]):
            raise AssertionError(f"act 3: KV landed wrong on rank {d}")
    if counts()["offset_put"] - before["offset_put"] != 1:
        raise AssertionError("act 3 did not run one offset_put launch")
    launches = counts()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"gas path never launched {missing}")
    emit({"phase": "gas", "ranks": N_RANKS, "backends": walls,
          "act3_s": act3_s, "act3_bytes": kv.numel() * 4, "launches": launches,
          "examples_agree": True})
    return launches


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

    sources = [pa.NAME, gc.PUT, gc.RING]
    seconds = build.build_all(sources)
    emit({"phase": "build", "kernels": sources, "seconds": seconds,
          "arch": "sm_90a", "nvcc_flags": list(build.NVCC_FLAGS)})

    kernel = kernel_phase()
    gas_figures = gascore_kernel_phase()
    gas_launches = gas_phase()
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
    }] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{where}",
        "launches": gas_launches[name],
        **{key: gas_figures[name]["16MiB"][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, (_, src, where) in GAS_KERNELS.items()]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
