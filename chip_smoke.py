#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check, run, report.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, one JSON line each:

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             (one nvcc per source, all started at once).
2. kernel  — paged attention against its plain PyTorch version at the
             serving path's shapes (bf16 and f32, NaN pages behind the
             lengths; the three archs' head shapes; lengths on and past
             the kernel's split boundaries; the served step's lengths),
             timed by ``device_ms`` at the phase's lengths and at the
             served step (8 x 148 tokens) against its bound; the zoo's
             groups (granite-34b's 48 q heads on one KV head, llama3-405b's
             128 / 8) checked the same way and timed beside their bounds.
3. gascore — each of the five GAScore kernels against its plain version on
             8 ranks of 1 KiB, 1 MiB and 16 MiB (f32, bf16, and int32 bit
             patterns with NaNs in an f32 carrier): copies byte-equal, the
             reduce-scatter byte-equal to the ring order and within its
             rounding bound of ``sum(0)``; timed against the bound and the
             one PyTorch call that computes the same function, by events
             around one call (``ms``, the host's enqueue included) and
             behind a sleep kernel (``device_ms``: the device alone).
4. gas     — the GAS substrate's main path: the quickstart and pipeline
             programs on the "xla", "gascore" and "xla,gascore" backends at
             their own sizes (all agree bit for bit), then at full size (8
             ranks, 16 MiB segments, 1 MiB puts and gets, AM medium
             messages of 512 floats, collectives over 16 MiB per rank, and
             act 3's offset put of one qwen3-4b layer's KV for a
             2,048-token prompt); launches per kernel checked against each
             program's static schedule.
4a. overlap — split phase on the side stream against blocking transfers,
             by ``device_ms``: (a) the reference's blocking and split-phase
             rings (8 ranks, 4 MiB a hop, transform tanh(c @ w)) on "xla"
             and "gascore"; (b) 8 vectored gets of 4 qwen3-4b pages (4.72
             MB each, 2 ranks of 64) beside paged attention at the serve
             step's shape, against the gets completed one by one first;
             (c) the segmented against the monolithic ring all-reduce on
             "gascore" at 8 x 16 MiB.  T, C, the bound (T+C)/max(T,C) and
             the measured gap printed; outputs byte-equal, no host sync
             after warm-up, and (a)'s transfer kernels on a stream of
             their own overlapping a compute kernel (``torch.profiler``).
5. serve   — qwen3-4b at full width and depth (36 layers, bf16, random
             weights from a seeded generator) through ``PagedServer``:
             16 requests of 128 prompt tokens, 64 new tokens each, four
             sharing a 64-token prefix; held against the dense ``Server``
             (the first step's logits). Then the same in f32 (~16 GB of
             weights, freed after): greedy tokens paged and dense must be
             identical but at near ties (dense top-2 margin below the
             step's max |logit difference|), each printed and counted.
5a. gas_suites — the GAS layer's last pieces (after phase 5, whose
             weights (d) serves): (a) the one-device twins of the
             reference's GAS suite (8 ranks) and GAScore suite (4 ranks,
             the five kernels at the reference's shapes held to their
             oracles) on the card, each to its PASS line; (b) the Jacobi
             rod of ``examples/stencil_halo.py`` (8 nodes, 400 steps of two
             one-sided halo puts) on the three backends: within 1e-4 of
             the dense rod, byte-equal to each other, launches per kernel
             against its schedule; (c) ``hierarchical_all_reduce`` on
             "gascore", 2 pods x 4 ranks, 16 MiB f32 per rank (inner rings
             on ``perm_put``, the outer ring on ``ring_shift``) beside the
             flat ring all-reduce of the 8 on the same data, both within
             the rounding bound of the f64 sum, by ``device_ms``, with the
             bytes each puts between the pods (from the schedule; on one
             card every put is an on-chip copy); (d) ``PagedServer(
             paged_decode=False)`` on phase 5's traffic: tokens held to the
             dense ``Server``'s by F3's rule, every live row equal to its
             gather through the page table at two steps, the pool full
             after the drain, no paged-attention launch; step ms, tok/s
             and peak GiB beside ``PagedServer``'s.
6. profile — three steady decode steps of a separate paged run under
             ``torch.profiler``: kernels, device busy time and share.
6a. serve_disagg — the disaggregated cluster on phase 5's weights, all
             ranks on the card, segments one rank-stacked tensor written
             in place (its storage checked every tick): act 1, 2 prefill
             ("xla") + 2 decode ("gascore") ranks, dense staging, phase
             5's traffic, tokens equal to ``Server``'s; act 2, the same
             paged, equal to ``PagedServer``'s, prefix pages mapped; act
             3, 1 prefill + 1 decode + 1 memory ("gascore") rank, a pool
             of one request's cache, the reference's pressure burst 8x
             longer, swaps and bit-identical resumes, tokens equal to an
             unpressured ``PagedServer``'s; swaps priced with transport
             constants measured in phase 3. AM books, drained pool and
             tier, launches per kernel equal to the transfers' schedule;
             a push tick of acts 1 and 2 under ``torch.profiler``.
6b. serve_tp — tensor-parallel decode groups of 2 ranks on qwen3-4b at
             full width: ``TPPagedServer`` on "gascore" and "xla,gascore",
             f32 on 12 layers (reduced: n_layers 36 -> 12) with tokens
             identical to an f32 ``PagedServer``'s of that depth but at
             near ties (F3's rule, counted), bf16 at full depth; a
             cluster of 1 prefill rank and a tp=2 decode group held the
             same way to a tp=1 cluster (f32); bf16 tok/s beside
             ``PagedServer``'s; one paged-attention launch a layer a step
             (the vmap rule folds the ranks into the kernel's batch).
6c. serve_ft — fault-tolerant elastic serving of qwen3-4b at full width
             on 12 layers (reduced: n_layers 36 -> 12) in f32 (its own
             seeded weights): the fault suite's
             kill-decode mid-handoff (1 prefill "xla", 2 decode and 2
             memory "gascore" ranks, 2 tier replicas, 1 spare), quorum
             restore, elastic join, heartbeat delay and chaos(0), each
             against its no-failure twin (identical tokens but at counted
             near ties); kills under sync debug mode, one flight dump a
             death, a valid exported trace, launches per kernel equal to
             the clusters' schedule; ticks from kill to detection, the
             death tick's wall beside a normal tick's, recovered counts.
6d. profiler — the device-time profiler (``obs/profile.py``): the paged
             kernel and its plain version at ``profiling_targets``' shapes
             (``measured="device"``, beside ``device_ms``), then
             ``PagedServer.profile_decode`` twice mid-serving of phase 5's
             traffic at full width and depth: tokens equal phase 5's.
7. flash   — the flash-attention forward, dK/dV and dQ kernels against
             their plain versions at qwen3-4b's training shape (batch 2 x
             seq 2048, 32 q / 8 KV heads of dim 128, causal) in bf16 and
             f32, at the reference's small cases (GQA, windows,
             non-causal, bf16) and at the edges of the bf16 kernels'
             tiles (ragged S, ragged q blocks and kv tiles, Sq != Sk, D 16
             and 32, narrow and causal windows, a GQA group of 7); timed
             with CUDA events beside their bound (``ms``: events around
             one call, the host's enqueue included; ``device_ms``, and
             the µs, TFLOP/s and share of the bound: the device's time
             alone) and
             ``scaled_dot_product_attention`` (forward, and its autograd
             backward) as the library yardstick; ``cuobjdump`` shows
             HGMMA in the bf16 forward, dK/dV and dQ kernels and none in
             the SIMT (f32) ones.  The zoo's training shapes (seamless'
             encoder: B 2, 16 / 16 heads, S 1,024, D 64, non-causal;
             granite's B 2, 48 / 1, S 2,048, causal; gemma3's B 1, 32 / 16,
             S 4,096, a causal window of 1,024) held to the plain versions
             and timed by ``device_ms`` beside their bounds.
8. train   — qwen3-4b at full width and depth (36 layers, bf16, random
             weights from a seeded generator) through ``Trainer``: batch 2 x
             seq 2048, full remat, AdamW with f32 moments, 6 steps (the
             first 2 warm-up); losses and grad norms finite, the step-0
             loss near ln(vocab), each kernel's launches per step checked;
             then one more step under ``torch.profiler``.
8a. train_dp — data-parallel training on the GAS layer
             (``examples/train_lm.py``): qwen3-4b at full width on 2
             layers (bf16), global batch 12 x 512 over 4 ranks, 10 steps,
             a checkpoint every 4, 1 rank lost at step 6, the restore of
             step 4 on 3 ranks (bitwise); once each with the engine's
             all-reduce ("xla"), the f32 GAS ring and the int8
             error-feedback ring ("gascore").  Gates: the f32 ring bitwise
             on "xla" and "gascore" and within 1e-5 of the plain mean; the
             int8 ring within 5%, 4 (n - 1) ``ring_shift`` launches, each
             rank's error state exactly comp - dequant; finite losses; the
             flash kernels once a layer a rank a step.  Step ms, peak GiB
             and a profiled step's busy share.
8b. pipeline — GPipe (``parallel/pipeline.py``) over 4 ranks, stage
             tanh(x @ w_s), w (4, 2560, 2560) f32, 8 microbatches of (512,
             2560): forward within 1e-5 and gradients within 2e-4 of the
             sequential chain on "xla" under sync debug mode "error"; the
             "gascore" forward bitwise equal, its gradient refused.
8c. scan_chunked — the chunked scans (``scan_impl="chunked"``) against
             the kernels at the scan phase's full-width cases (its
             tolerances) and in the f32 prefill of falcon-mamba-7b and
             recurrentgemma-9b at full width; both times printed.
9. scan    — the selective-scan (mamba-1) and gated-linear-scan (RG-LRU)
             kernels against their plain versions, bf16 and f32, at the
             serving prefill's full widths (falcon-mamba: B 1 and 4 x S
             512 x Di 8192 x N 16, with the final state; recurrentgemma:
             B 1 and 4 x S 2560 x W 4096), at an odd S and at the
             reference tests' small shapes, with the model's value ranges;
             timed by ``device_ms`` (L2 flushed) beside their bound and
             the selective scan's special-function floor (its
             exponentials at 16 a clock per SM at the maximum SM clock).
10. serve_falcon — falcon-mamba-7b at full width and depth (64 layers,
             bf16, random weights from a seeded generator) through the
             dense ``Server``: 16 requests of 512 prompt tokens, 64 new
             tokens each, batch 8; one scan launch per layer per prefill.
             Then prefill of S + 4 tokens against prefill of S and 4
             decode steps: held to a tolerance in f32 at full width on 2
             layers, printed for bf16 at full depth.
11. serve_recurrentgemma — recurrentgemma-9b at full width and depth (38
             layers, bf16, seeded random weights) through ``Server``: 8
             requests of 2,560 prompt tokens (past the 2,048 window, so
             the window mask and the decode ring both bite), 64 new tokens
             each, batch 4, cache 4096; one scan launch per ``rec`` layer
             per prefill; the same consistency check (f32 on 3 layers).
12. router — the MoE router kernel against its plain version: at
             kimi-k2's (E 384, K 8) and arctic's (E 128, K 2) widths at T 8
             (a decode batch), 128 (a prefill) and 8,192, at T 1 and 77,
             without renormalisation, on rows with repeated logits (the tie
             rule), at the edges of its launch plans (the largest T of one
             CTA and of one cluster, and one token past each) and at the
             reference tests' four cases; indices, slots and keep equal,
             weights within 1e-6, and one ``moe_router_*`` kernel a call
             by ``torch.profiler``; its device time by CUDA events behind a
             sleep kernel (the logits in L2 as the model leaves them, and
             with L2 flushed) beside its bound and an empty kernel's time
             (the launch floor), the host's enqueue apart.
13. serve_kimi — kimi-k2-1t-a32b at full width on 2 layers (the dense
             first layer and one ``moe`` layer of 384 experts, bf16, seeded
             random weights) through ``PagedServer`` with slice 1's
             traffic (phase 5); one router launch per ``moe`` layer per
             forward call; the first decode step held against the dense
             ``Server``'s on the rows (at least half) whose expert choices
             agree in every ``moe`` layer; the router kernel against its
             plain version on logits captured from the served model's MoE
             layer; a prefill and a decode step under ``torch.profiler``.
14. serve_arctic — arctic-480b the same way, 2 ``moe`` layers of 128
             experts with the dense residual FFN.
15. serve_zoo — the rest of the model zoo in bf16, seeded random weights:
             granite-34b at full width and depth (88 layers, 63.3 GiB)
             and llama3-405b at full width on 4 layers (reduced: n_layers
             126 -> 4) through ``PagedServer`` (slice 1's traffic; 8
             requests of 32 new tokens for llama3), the first step held
             against the dense ``Server``, then granite's f32 TieGate pass
             (paged vs dense) on 2 layers; gemma3-27b at full depth
             through ``Server`` (8 requests of 1,536 tokens, past the
             1,024 window; batch 4, cache 2,048) and its f32 consistency
             on 6 layers; llama-3.2-vision-11b at full depth, prefill with
             a 4 x 1,601 x 4,096 image and every ``xgate`` 0.5, 32 greedy
             steps, text-only ``Server``, f32 consistency on 5 layers;
             seamless-m4t-medium at full depth, prefill with 4 x 1,024
             frames (the encoder on the flash forward), 32 greedy steps,
             and in f32 its prefill against ``train_logits``.  tok/s, step
             ms, peak GiB and each kernel's launches against its layers.
16. train_zoo — ``Trainer`` at full width, full remat, AdamW, 3 steps:
             gemma3 on 6 layers (1 x 4,096), granite on 2 (2 x 2,048),
             seamless at full depth (2 x 1,024), llama-vision on 5 (2 x
             2,048 with image embeddings); finite losses and grad norms,
             step 0 near ln(vocab), 2 forwards, 1 dK/dV and 1 dQ a flash-
             attended layer a step.
17. moe_ep — one arctic ``moe`` layer at full width (E 128, K 2, D
             7,168, F 4,864; 26.8 GB of experts), T 1,024, expert-parallel
             on a (1, 4) grid on "xla" and "gascore": bitwise equal, the
             per-shard plain composition within bf16 rounding, > 97% of
             rows within it of the local path at capacity factor 4.0, 2 x
             3 ``ring_shift`` and 4 router launches a call; ``device_ms``
             beside local.  Then arctic on 2 layers through
             ``PagedServer`` with EP on "gascore" (4 requests), launches
             gated per forward call.

18. dryrun — the analysis tools (``launch/dryrun.py``, ``hlostats.py``,
             ``roofline.py``) against real steps: qwen3-4b at full width
             and depth (36 layers, bf16, weights random from seed 0) on the
             ``h100`` mesh, one step of each kind: train 2 x 4,096 (full
             remat, AdamW; reduced: global_batch 256 -> 2), prefill 1 x
             16,384 (reduced: global_batch 32 -> 1, seq_len 32,768 ->
             16,384: 36 s a run at 32,768), decode batch 8 at a 32,768
             cache (reduced: global_batch 128 -> 8).  Each is
             dry-run on ``meta`` and run on the card under the op-stream
             counter: flops, bytes, collective bytes, ops and kernel calls
             equal; the dry run's argument bytes equal to the bytes the
             step holds (parameters, AdamW state, batch, cache); each
             kernel launched as often as counted (the flash forward, dK/dV
             and dQ in training; qwen3-4b's prefill and decode run plain
             attention, as the reference's do).  Step ms (events around one
             call), the profiled busy ms (train and decode), peak
             allocated bytes beside the
             argument bytes, the roofline terms, the dominant one and
             ``roofline_fraction``, and the useful-flops time over the
             measured step, beside the card's name and power limit.

Phases 10-18 run after the training phase has freed its memory, each
after the one before it has freed its own.  Every ``reduced`` cut is
printed in its phase's line.
Then a ``timing`` line (seconds by phase), the card's name and power
limit, the ``kernels`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero before that line.  Without CUDA it exits non-zero
and prints nothing on stdout.
"""

import contextlib
import dataclasses
import gc as pygc  # "gc" names the GAScore kernels below
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.compat import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs.registry import ARCHS, ShapeConfig  # noqa: E402
from repro_torch.core import collectives, gasnet, sched  # noqa: E402
from repro_torch.core.engine import make_engine, pod_engines  # noqa: E402
from repro_torch.core.gasnet import P  # noqa: E402
from repro_torch.examples import heterogeneous_pipeline, quickstart  # noqa: E402
from repro_torch.examples import stencil_halo  # noqa: E402
from repro_torch.examples import serve_requests as ex  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.data.synthetic import Loader, SyntheticLM  # noqa: E402
from repro_torch.kernels import build, cost, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import gascore as gc  # noqa: E402
from repro_torch.kernels import moe_router as mr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rglru  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402
from repro_torch.launch import dryrun, hlostats, roofline  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    PagedServer, Request, Server, TPPagedServer, serve_with_context)
from repro_torch.obs import export as obs_export  # noqa: E402
from repro_torch.obs import profile as obs_profile  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving import pool as pool_lib  # noqa: E402
from repro_torch.serving.disagg import DisaggCluster  # noqa: E402
from repro_torch.models import layers as moe_layers  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402
from repro_torch.parallel.ctx import RunCtx  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.testing import fault_suite  # noqa: E402
from repro_torch.testing import gas_suite, gascore_suite  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W), and the
# kernels' work formulas: kernels/cost.py, which the dry run reads too
HBM_BYTES_PER_S = cost.HBM_BYTES_PER_S
PEAK_FLOPS = cost.PEAK_FLOPS

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


def card():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def emit(record):
    print(json.dumps(record), flush=True)


def device_ms(fn, iters, flush=None):
    """Median device time of one call of ``fn``: CUDA events around the
    call, with a sleep kernel queued ahead of them, so the device reaches
    the start event only once the host has enqueued the call and the stop
    event; the events then time the device's work and not the host's
    enqueue (tens of microseconds against the router's few).  Where the
    device reached the start event first, the sleep is doubled and the
    call timed again.  With ``flush``, the 50 MB L2 is overwritten between
    the sleep and the start event."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 1 << 21, []
    while len(times) < iters:
        torch.cuda._sleep(cycles)
        if flush is not None:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        late = e0.query()
        e1.synchronize()
        if not late:
            times.append(e0.elapsed_time(e1))
        elif cycles >= 1 << 30:
            raise AssertionError("the host never enqueued a call ahead of "
                                 "the device")
        else:
            cycles *= 2
    return float(np.median(times))


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


def kernel_inputs(dtype, gen, lengths, hq=HQ, hkv=HKV):
    dev = torch.device("cuda")
    P = B * NP + 1  # the last page is NaN garbage
    q = torch.randn((B, hq, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, T, hkv, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, T, hkv, D), generator=gen, device=dev).to(dtype)
    kp[-1] = float("nan")
    vp[-1] = float("nan")
    perm = torch.randperm(B * NP, generator=gen, device=dev)
    table = perm.reshape(B, NP).to(torch.int32)
    for b in range(B):  # padded slots past the length point at the NaN page
        table[b, -(-int(lengths[b]) // T):] = P - 1
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


def kernel_bound_ms(dtype, lengths, hq=HQ, hkv=HKV):
    """Least time for the same work (``cost.paged_attention_work``: the
    live positions' K and V rows, q, the lengths and the live table
    entries read once, the output written once; 4 flops per (q head,
    live position, dim))."""
    live = [min(int(n), NP * T) for n in lengths]
    b = cost.bound(*cost.paged_attention_work(live, hq, hkv, D, T, dtype),
                   dtype)
    return b["bound_ms"], b["bound_by"]


def paged_check(name, q, kp, vp, table, lens, scale=None, relative=False):
    """The kernel against the plain version on the same inputs: finite,
    and within ``KERNEL_ATOL`` (with ``relative``, times the output's
    scale where that exceeds 1: bf16 rounds relative to the value).
    Returns the max |difference|."""
    got = pa.paged_attention(q, kp, vp, table, lens, scale=scale)
    want = ref.paged_attention(q, kp, vp, table, lens, scale=scale)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    tol = KERNEL_ATOL[q.dtype]
    if relative:
        tol *= max(1.0, want.float().abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{name}: max |kernel - plain| {err} > {tol}")
    return err


# the MoE archs' head shapes: kimi-k2 64 q / 8 KV heads (a group of 8),
# arctic 56 / 8 (a group of 7, not a power of two)
MOE_HEADS = ((64, 8), (56, 8))
# the zoo's: granite-34b's MQA, 48 q heads on one KV head (a group of
# 48), and llama3-405b's 128 / 8 (a group of 16)
ZOO_HEADS = ((48, 1), (128, 8))


# the served steady step: BATCH requests at the first profiled position
SERVED_LENGTHS = [PROMPT_LEN + PROFILE_STEPS[0]] * BATCH


def kernel_phase_lengths():
    """One request of 1 token, one of the full cache, the rest random."""
    rng = np.random.default_rng(1)
    return [1, CACHE_LEN] + rng.integers(1, CACHE_LEN + 1, size=B - 2).tolist()


def split_edge_lengths():
    """Lengths that end on a boundary of the kernel's splits and one token
    past it (the first, second and last boundaries of the table), one
    token short of the full cache, and 0."""
    edge = pa.default_pages_per_split(T) * T
    last = (NP * T // edge - 1) * edge
    return [edge, edge + 1, 2 * edge, 2 * edge + 1, last, last + 1,
            CACHE_LEN - 1, 0]


def kernel_phase():
    """The kernel against its plain version at the three head shapes, bf16
    and f32, on the phase's lengths, at split edges and at the served
    step; timed by ``device_ms`` (and by events around one call,
    ``events_ms``) with L2 flushed, at the phase's lengths and at the
    served step."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = kernel_phase_lengths()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out, heads = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        args = kernel_inputs(dtype, gen, lengths)
        err = paged_check(f"paged_attention {dtype}", *args)
        for hq, hkv in MOE_HEADS:
            tag = f"Hq{hq} Hkv{hkv} {dname}"
            heads[tag] = paged_check(f"paged_attention {tag}", *kernel_inputs(
                dtype, gen, lengths, hq, hkv))
        for hq, hkv in ((HQ, HKV),) + MOE_HEADS + ZOO_HEADS:
            for what, lens in (("split edges", split_edge_lengths()),
                               ("served step", SERVED_LENGTHS)):
                tag = f"Hq{hq} Hkv{hkv} {dname} {what}"
                heads[tag] = paged_check(f"paged_attention {tag}",
                                         *kernel_inputs(dtype, gen, lens, hq,
                                                        hkv))
        zoo = {}
        for hq, hkv in ZOO_HEADS:  # checked, then timed beside the bound
            zargs = kernel_inputs(dtype, gen, lengths, hq, hkv)
            zerr = paged_check(f"paged_attention Hq{hq} Hkv{hkv} {dname}",
                               *zargs)
            zb, zby = kernel_bound_ms(dtype, lengths, hq, hkv)
            zms = device_ms(lambda: pa.paged_attention(*zargs), 50, flush)
            zoo[f"Hq{hq} Hkv{hkv}"] = {
                "max_abs_err": zerr, "ms": zms, "bound_ms": zb,
                "bound_by": zby, "bound_share": zb / zms}
            del zargs
        served = kernel_inputs(dtype, gen, SERVED_LENGTHS)
        served_err = paged_check(f"paged_attention {dtype} served", *served)
        bound_ms, bound_by = kernel_bound_ms(dtype, lengths)
        out[dname] = {
            "max_abs_err": err, "atol": KERNEL_ATOL[dtype],
            "ms": device_ms(lambda: pa.paged_attention(*args), 50, flush),
            "events_ms": cuda_time_ms(lambda: pa.paged_attention(*args), 50,
                                      flush),
            "plain_ms": cuda_time_ms(lambda: ref.paged_attention(*args), 10,
                                     flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "served_step": {
                "lengths": SERVED_LENGTHS, "max_abs_err": served_err,
                "ms": device_ms(lambda: pa.paged_attention(*served), 50,
                                flush),
                "events_ms": cuda_time_ms(
                    lambda: pa.paged_attention(*served), 50, flush),
                "bound_ms": kernel_bound_ms(dtype, SERVED_LENGTHS)[0]},
            "zoo_heads": zoo,
        }
    emit({"phase": "kernel", "name": pa.NAME, "shape": {
        "B": B, "Hq": HQ, "Hkv": HKV, "D": D, "T": T, "NP": NP,
        "lengths": lengths, "split_edge_lengths": split_edge_lengths(),
        "pages_per_split": pa.default_pages_per_split(T)},
        "results": out, "other_max_abs_err": heads})
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
    """Per kernel: (kernel call, plain call, library call, bytes moved),
    bytes counting each input read once and each output written once;
    the segment and per-rank offsets; and offset_put with its offset held
    on the host (the other entry of its kernel, offsets passed by value),
    timed beside the device-offset call the table reports."""
    n, e = x.shape
    row = e * x.element_size()
    k = 3
    dst = torch.tensor(PERM, device=x.device)
    seg = torch.zeros((n, 2 * e), dtype=x.dtype, device=x.device)
    off_rows = [(r * e // n) // 8 * 8 for r in range(n)]
    offs = torch.tensor(off_rows, dtype=torch.int32, device=x.device)
    same = torch.full((n,), off_rows[1], dtype=torch.int32, device=x.device)
    same_host = same.cpu()
    rows = torch.arange(n, device=x.device)[:, None]
    cols = off_rows[1] + torch.arange(e, device=x.device)[None, :]
    shifted_rows = (rows + 1) % n

    def lib_offset():
        seg[shifted_rows, cols] = x  # one indexed (slice) assignment

    def lib_perm():
        out = torch.empty_like(x)
        out[dst] = x
        return out

    moved = lambda name: cost.gascore_bytes(name, n, row)  # noqa: E731
    cases = {
        "ring_shift": (lambda: gc.ring_shift(x, k), lambda: ref.ring_shift(x, k),
                       lambda: torch.roll(x, k, 0), moved("ring_shift")),
        "perm_put": (lambda: gc.perm_put(x, PERM), lambda: ref.perm_put(x, PERM),
                     lib_perm, moved("perm_put")),
        "offset_put": (lambda: gc.offset_put(seg, x, same, 1),
                       lambda: ref.offset_put(seg, x, same, 1), lib_offset,
                       moved("offset_put")),
        "ring_all_gather": (lambda: gc.ring_all_gather(x),
                            lambda: ref.all_gather(x),
                            lambda: x.reshape(1, -1).expand(n, -1).contiguous(),
                            moved("ring_all_gather")),
    }
    if x.dtype in (torch.float32, torch.bfloat16) and e % n == 0:
        cases["ring_reduce_scatter"] = (
            lambda: gc.ring_reduce_scatter(x), lambda: ref.reduce_scatter(x),
            lambda: x.sum(0).view(n, e // n), moved("ring_reduce_scatter"))
    host_offsets = lambda: gc.offset_put(seg, x, same_host, 1)  # noqa: E731
    return cases, (seg, offs), host_offsets


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
            cases, (seg, offs), host_offsets = gas_cases(x)
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
            _byte_equal(f"offset_put host offsets {size} {kind}",
                        host_offsets(), cases["offset_put"][1]())
            # out-of-range offsets clamp as the plain version clamps
            wild = offs * 3 - 7 * x.shape[1] // N_RANKS
            _byte_equal(f"offset_put clamped {size} {kind}",
                        gc.offset_put(seg.clone(), x, wild, 2),
                        ref.offset_put(seg, x, wild, 2))
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
                       # the device's time alone, the host's enqueue kept out
                       "device_ms": device_ms(kern, iters, flush),
                       "library_device_ms": device_ms(lib, iters, flush),
                       "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
                       "bound_by": "bytes", "bytes": moved, "max_abs_err": 0.0,
                       "host_us": host_us(kern), "plain_host_us": host_us(plain),
                       "library_host_us": host_us(lib)}
                if name == "offset_put":
                    rec["host_offsets_device_ms"] = device_ms(
                        host_offsets, iters, flush)
                figures.setdefault(name, {})[size] = rec
            del cases, seg, offs, host_offsets, x
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


def counts(table=GAS_KERNELS):
    return {name: w.launches for name, (w, _, _) in table.items()}


def reset_counts(table=GAS_KERNELS):
    for w, _, _ in table.values():
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


# --------------------------------------------------------------------------- #
# the GAS layer's last pieces: the suite twins, the stencil, the
# hierarchical all-reduce; PagedServer's dense-row path
# --------------------------------------------------------------------------- #
SUITES = ((gas_suite, "GAS_SUITE_PASS"), (gascore_suite, "GASCORE_SUITE_PASS"))
HIER_PODS = 2  # the 8 ranks as 2 pods of 4
HIER_ITERS = 10
F32_EPS = 2.0**-24  # f32's unit roundoff
ROW_CANON_STEPS = (1, MAX_NEW - 1)  # decode steps whose pool is gathered


def hier_launches(backend, n=N_RANKS, pods=HIER_PODS, rows=FULL_ROWS):
    """Kernel launches of one ``hierarchical_all_reduce`` of ``rows`` rows
    per rank: a backend with a "gascore" member moves the inner rings
    (RS, AG: n/pods - 1 hops each) along a permutation inside the pods
    (``perm_put``) and the outer ring (RS + AG over the pods, or the
    shift-accumulate ring when the shard does not tile) as a uniform
    shift of the ranks by a pod's size (``ring_shift``)."""
    if "gascore" not in backend:
        return {}
    m = n // pods
    shard = rows // m
    outer = 2 * (pods - 1) if shard and shard % pods == 0 else pods - 1
    out = {"perm_put": 0, "ring_shift": outer}
    out["perm_put" if pods > 1 else "ring_shift"] += 2 * (m - 1)
    return out


def hier_outer_bytes(nbytes, n=N_RANKS, pods=HIER_PODS):
    """Bytes that cross between pods: the hierarchical outer ring (2 (p-1)
    hops of 1/(m p) of a rank's bytes, every rank), and the flat ring of n
    ranks laid pod by pod (2 (n-1) hops of 1/n, on the p edges between
    pods)."""
    m = n // pods
    return {"hierarchical": n * 2 * (pods - 1) * nbytes // (m * pods),
            "flat_ring": pods * 2 * (n - 1) * nbytes // n}


def hier_check(backend="gascore", device="cuda", n=N_RANKS, pods=HIER_PODS,
               rows=FULL_ROWS, cols=FULL_COLS, iters=HIER_ITERS):
    """The hierarchical all-reduce of (rows, cols) f32 per rank beside the
    flat ring all-reduce on the same data: each within the rounding bound
    of n - 1 additions of the f64 sum, equal on every rank, launches per
    kernel against the schedule; their ``device_ms``."""
    ctx = gasnet.Context(n, backend=backend, device=device)
    gen = torch.Generator(device=ctx.device).manual_seed(3)
    x = torch.randn((n, rows, cols), generator=gen, device=ctx.device)

    def hier(node, v):
        inner, outer = pod_engines(node.engine, pods)
        return collectives.hierarchical_all_reduce(inner, outer,
                                                   node.local(v))[None]

    def flat(node, v):
        return collectives.ring_all_reduce(node.engine, node.local(v))[None]

    exact = x.double().sum(0)
    # recursive summation of n terms: within (n - 1) u sum |x| of the sum
    bound = 1.01 * (n - 1) * F32_EPS * x.double().abs().sum(0)
    rec = {}
    for name, prog, want in (
            ("hierarchical", hier, hier_launches(backend, n, pods, rows)),
            ("flat_ring", flat, {"ring_shift": 2 * (n - 1)}
             if "gascore" in backend else {})):
        before = counts()
        out = ctx.spmd(prog, x)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in counts().items() if v > before[k]}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{name} all-reduce: launches {got}, schedule "
                                 f"says {want}")
        err = (out.double() - exact).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"{name} all-reduce: beyond the rounding "
                                 f"bound by {float((err - bound).max())}")
        for r in range(1, n):
            _byte_equal(f"{name} all-reduce rank {r}", out[r], out[0])
        del out
        checked = counts()  # the timing loop's launches are not the path's
        rec[name] = {"launches": got, "max_abs_err": float(err.max()),
                     "max_bound": float(bound.max()),
                     "device_ms": device_ms(lambda: ctx.spmd(prog, x), iters)}
        for kernel, (w, _, _) in GAS_KERNELS.items():
            w.launches = checked[kernel]
    nbytes = rows * cols * 4
    return {"backend": backend, "pods": pods, "ranks_per_pod": n // pods,
            "bytes_per_rank": nbytes,
            "outer_bytes": hier_outer_bytes(nbytes, n, pods), **rec}


def row_canonical(server, live):
    """Each live row's cache equals, byte for byte, its gather through
    the page table."""
    for i in live:
        rid = server.active[i].rid
        row = tree_map(lambda x: x[:, i:i + 1], server.caches)
        for a, b in zip(tree_leaves(row), tree_leaves(server.store.gather(rid))):
            if a.dtype != b.dtype:
                raise AssertionError(f"row {i}: gather gives {b.dtype}, the "
                                     f"cache holds {a.dtype}")
            _byte_equal(f"pool gather of rid {rid}", a, b.to(a.device))
    return len(live)


def dense_row_run(served):
    """``PagedServer(paged_decode=False)`` on the serve phase's weights and
    traffic: tokens held to the dense ``Server``'s rows by F3's rule, the
    pool gathered against the rows at ``ROW_CANON_STEPS`` and full after
    the drain, no paged-attention launch; the decode and the page
    write-back timed apart (each ends in a device sync)."""
    server = PagedServer(served["model"], served["ctx"], served["params"],
                         BATCH, CACHE_LEN, device="cuda",
                         page_tokens=PAGE_TOKENS, paged_decode=False)
    gate = served["dense_gate"].fork()
    decode, post = server._decode, server._post_decode
    decode_s, post_s, canon = [], [], []

    def timed_decode(*a):
        t0 = time.perf_counter()
        out = decode(*a)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        return out

    def timed_post(live, written):
        t0 = time.perf_counter()
        post(live, written)
        post_s.append(time.perf_counter() - t0)

    def on_step(srv, live, logits):
        gate.compare(srv, live, logits)
        if len(decode_s) in ROW_CANON_STEPS:
            canon.append(row_canonical(srv, live))

    server._decode, server._post_decode = timed_decode, timed_post
    server.on_step = on_step
    paged_before = pa.paged_attention.launches
    torch.cuda.reset_peak_memory_stats()
    for r in requests(served["model"].cfg.vocab):
        server.submit(r)
    stats = server.run_until_drained()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if pa.paged_attention.launches != paged_before:
        raise AssertionError("the row path launched paged attention")
    out = {r.rid: r.out for r in server.finished}
    verdict = gate.verdict("row path vs dense", served["dense"], out)
    if len(canon) != len(ROW_CANON_STEPS):
        raise AssertionError(f"pool gathered at {len(canon)} steps")
    if stats["pool_n_free"] != stats["pool_n_pages"] or server.store.tables:
        raise AssertionError(f"pool not drained: {stats}")
    pool_lib.check_pool(server.store.state, tables=[])
    paged = served["record"]
    step_ms = 1e3 * (float(np.median(decode_s)) + float(np.median(post_s)))
    cfg = served["model"].cfg
    return {"layers": cfg.n_layers, "dtype": str(cfg.dtype).split(".")[-1],
            "decode_steps": len(decode_s),
            "step_ms_median": step_ms,
            "decode_ms_median": 1e3 * float(np.median(decode_s)),
            "writeback_ms_median": 1e3 * float(np.median(post_s)),
            "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
            "peak_device_mem_gib": peak,
            "rows_gathered_equal": sum(canon), "pool_free_after":
            stats["pool_n_free"], "pool_pages": stats["pool_n_pages"],
            **verdict,
            "paged_server": {"step_ms_median": paged["decode_step_ms_median"],
                             "tok_per_s": paged["tok_per_s"],
                             "peak_device_mem_gib":
                             paged["peak_device_mem_gib"]}}


def gas_suites_phase(served):
    """(a) the two suite twins on the card, (b) the stencil on three
    backends, (c) the hierarchical all-reduce at full size, (d) the
    dense-row path; returns the launches per GAScore kernel over (a)-(c)
    (counts set to 0 just before)."""
    reset_counts()
    rec = {"phase": "gas_suites"}
    for suite, token in SUITES:  # (a)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            suite.main(device="cuda")
        torch.cuda.synchronize()
        lines = buf.getvalue().splitlines()
        if not lines or lines[-1] != token:
            raise AssertionError(f"{suite.__name__} ended {lines[-1:]}")
        rec[suite.__name__.rsplit(".", 1)[-1]] = {
            "s": time.perf_counter() - t0,
            "sections_ok": sum(" OK" in line for line in lines)}
    rec["suite_launches"] = counts()
    stencil, first = {}, None
    for backend in GAS_BACKENDS:  # (b)
        before = counts()
        t0 = time.perf_counter()
        res = stencil_halo.run(backend, "cuda", verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in counts().items()}
        want = dict.fromkeys(GAS_KERNELS, 0)
        want.update(stencil_halo.launches(backend))
        if got != want:
            raise AssertionError(f"stencil on {backend}: launches {got}, "
                                 f"schedule says {want}")
        if first is None:
            first = res
        for key in ("seg", "heat"):
            _byte_equal(f"stencil {key} on {backend}", res[key], first[key])
        stencil[backend] = {"s": wall, "launches": got}
    rod = first["seg"][:, 1:-1].reshape(-1).cpu().numpy()
    rec["stencil"] = {"steps": stencil_halo.STEPS, "max": float(rod.max()),
                      "total_heat": float(rod.sum()), "backends": stencil,
                      "byte_equal": True}
    rec["hierarchical"] = hier_check()  # (c)
    launches = counts()
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"gas_suites never launched {missing}")
    rec["dense_row"] = dense_row_run(served)  # (d)
    if counts() != launches:
        raise AssertionError("the row path launched a GAScore kernel")
    rec["launches"] = launches
    emit(rec)
    return launches


def requests(vocab=151936):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, size=SHARED).tolist()
    reqs = []
    for rid in range(N_REQ):
        prompt = rng.integers(0, vocab, size=PROMPT_LEN).tolist()
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
    dense_gate = TieGate()  # the oracle rows the row path is held to
    dense.on_step = dense_gate.keep
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
    profile_phase(model, ctx, params)
    record["f32"], _ = f32_pass(cfg)
    emit(record)
    return {"launches": launches, "model": model, "ctx": ctx,
            "params": params, "dense": dense_out, "paged": paged_out,
            "dense_gate": dense_gate, "record": record}


def top2_margin(row):
    a, b = np.partition(row, -2)[-2:]
    return float(b - a)


class TieGate:
    """F3's rule for two greedy decodes of the same requests: tokens must be
    identical, except where they part at a near tie — a step where the
    oracle's top-2 logit margin is below that step's max |logit
    difference| over the rows whose inputs still agree.  ``keep`` records
    the oracle's rows by (request, tokens so far), ``compare`` holds the
    other run's rows to them (each a server's ``on_step`` hook), and
    ``verdict`` fails at any other divergence and returns the figures.
    Each near tie is printed."""

    def __init__(self, rows=None):
        self.rows = {} if rows is None else rows
        self.parted, self.ties, self.clear = set(), [], []
        self.stats = {"steps": 0, "max_abs_diff": 0.0, "min_margin": math.inf}

    def fork(self):
        """A gate on the same oracle rows, with no comparisons yet."""
        return TieGate(self.rows)

    def keep(self, server, live, logits):
        for i in live:
            req = server.active[i]
            self.rows[(req.rid, len(req.out))] = logits[i].copy()

    def compare(self, server, live, logits):
        rows = []
        for i in live:
            req = server.active[i]
            if req.rid in self.parted:
                continue
            want = self.rows[(req.rid, len(req.out))]
            rows.append((req.rid, len(req.out), logits[i], want))
        if not rows:
            return
        step_diff = max(float(np.abs(got - want).max()) for *_, got, want in rows)
        self.stats["steps"] += 1
        self.stats["max_abs_diff"] = max(self.stats["max_abs_diff"], step_diff)
        for rid, k, got, want in rows:
            margin = top2_margin(want)
            self.stats["min_margin"] = min(self.stats["min_margin"], margin)
            if int(np.argmax(got)) == int(np.argmax(want)):
                continue
            self.parted.add(rid)
            case = {"rid": rid, "step": k, "margin": margin,
                    "max_abs_diff": step_diff}
            (self.ties if margin < step_diff else self.clear).append(case)
            if margin < step_diff:
                print(f"near tie: request {rid} step {k} margin {margin} "
                      f"difference {step_diff}", file=sys.stderr, flush=True)

    def verdict(self, name, want, got):
        if self.clear:
            raise AssertionError(f"{name}: greedy tokens part at clear "
                                 f"margins: {self.clear}")
        if sorted(got) != sorted(want):
            raise AssertionError(f"{name}: finished {sorted(got)} of "
                                 f"{sorted(want)}")
        same = [r for r in got if got[r] == want[r]]
        if len(same) != len(want) - len(self.ties):
            raise AssertionError(f"{name}: {len(want) - len(same)} requests "
                                 f"differ, {len(self.ties)} near ties")
        return {"requests_token_identical": len(same),
                "near_ties": len(self.ties), "ties": self.ties,
                "steps_compared": self.stats["steps"],
                "max_abs_logit_diff": self.stats["max_abs_diff"],
                "min_top2_margin": self.stats["min_margin"]}


def f32_pass(cfg):
    """Paged vs dense decode of the serve phase's requests at ``cfg``'s
    width and depth in f32: greedy tokens must be identical but at near
    ties (``TieGate``).  The f32 weights are freed before returning.
    Returns the figures, and the paged run's tokens and logit rows (a
    ``TieGate`` the tensor-parallel servers are held to)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model, ctx = build_model(cfg32), RunCtx()
    params = model.init(ctx, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    dense_gate, paged_gate = TieGate(), TieGate()
    dense = Server(model, ctx, params, BATCH, CACHE_LEN, device="cuda")
    dense.on_step = dense_gate.keep
    dense_out = ex.serve(dense, requests(cfg.vocab))
    del dense

    def both(server, live, logits):
        dense_gate.compare(server, live, logits)
        paged_gate.keep(server, live, logits)

    paged = PagedServer(model, ctx, params, BATCH, CACHE_LEN, device="cuda",
                        page_tokens=PAGE_TOKENS)
    paged.on_step = both
    paged_out = ex.serve(paged, requests(cfg.vocab))
    del paged, params, model
    pygc.collect()
    torch.cuda.empty_cache()
    figures = {"layers": cfg32.n_layers, "dtype": "float32",
               **dense_gate.verdict("f32 paged vs dense", dense_out,
                                    paged_out)}
    return figures, {"gate": paged_gate, "tokens": paged_out}


# --------------------------------------------------------------------------- #
# the disaggregated cluster (serving/disagg.py) at full width and depth
# --------------------------------------------------------------------------- #
DISAGG_KERNELS = ("paged_attention", "ring_shift", "perm_put")
PRESSURE_SCALE = 8  # act 3: the reference's pressure burst, 8x longer
# acts 1 and 2: tick 6 has two prefills, a push and two decode steps
PROFILE_TICK = 6


def all_counts():
    return {**counts(), "paged_attention": pa.paged_attention.launches}


def drive_act(cluster, reqs, *, pressured=False, counter=all_counts):
    """Serve ``reqs`` through ``cluster`` as its entry points do (act 3's
    arrival pattern when ``pressured``), with the host tracer on for the
    cluster's tick and tick-phase spans: no profiler and no sync of its
    own.  Checks on the way that the segment tensor keeps its storage at
    every tick (the cluster's ``fault_hook``, run as each tick starts), and
    that the launches per kernel equal the transfer programs' schedule
    (``DisaggCluster.transfer_kernels``, summed in the stats) plus one
    paged attention a layer a paged decode step.  Returns the stats, the
    launches, each tick's and each decode's wall (ms), the progress
    (pushes, tokens) as each tick started, and the tokens."""
    seg = cluster.kvseg
    lo, hi = seg.data_ptr(), seg.data_ptr() + seg.numel() * seg.element_size()
    progress = {}

    def in_place(c, phase, tick):
        if phase == "tick":
            progress[tick] = (c.kv_transfers, c.decoded_tokens)
        if c.kvseg.data_ptr() != lo or any(
                not lo <= s.mem.data_ptr() < hi for s in c.stores):
            raise AssertionError("the cluster's segments left their storage")

    cluster.fault_hook = in_place
    tracer = obs_trace.enable(obs_trace.Tracer(capacity=1 << 20))
    before = counter()
    try:
        if pressured:
            stats = ex.run_pressured(cluster, reqs)
        else:
            for r in reqs:
                cluster.submit(r)
            stats = cluster.run_until_drained()
    finally:
        obs_trace.disable()
        cluster.fault_hook = None
    in_place(cluster, "end", None)
    got = {k: v - before[k] for k, v in counter().items()}
    want = {**dict.fromkeys(got, 0), **stats["transfer_launches"],
            "paged_attention": cluster.model.cfg.n_layers
            * stats.get("decode_paged_steps", 0)}
    if got != want:
        raise AssertionError(f"launches {got}, schedule says {want}")
    return {"stats": stats, "launches": got, "progress": progress,
            "tick_ms": {s.tick0: s.dur_us / 1e3
                        for s in tracer.spans(cat="tick", name="tick")},
            "decode_ms": [s.dur_us / 1e3 for s in
                          tracer.spans(cat="tick_phase", name="decode")],
            "tokens": {r.rid: r.out for r in cluster.finished}}


def profile_tick(cluster, reqs, tick):
    """Tick ``tick`` of ``reqs`` on a fresh ``cluster`` under
    ``torch.profiler``, with a tracer that annotates the cluster's tick
    phases (which do not nest), so that each kernel is attributed to the
    phase it starts in (a range appears on the device's timeline spanning
    its kernels).  The ticks
    before run untraced.  Returns the device's busy time (the union of its
    kernels' and copies' intervals: the transfers run on the side stream,
    beside the current stream's work) and their summed durations, the
    split by phase, the kernels by name, the profiled wall, and the
    progress (pushes, tokens) after the tick, by which the measured run's
    same tick is found."""
    for r in reqs:
        cluster.submit(r)
    for _ in range(tick - 1):
        cluster.tick()
    torch.cuda.synchronize()
    tracer = obs_trace.enable(obs_trace.Tracer(annotate=("tick_phase",)))
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cluster.tick()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        obs_trace.disable()
    ranges = {f"{s.cat}::{s.name}" for s in tracer.events
              if s.cat in tracer.annotate}
    phases, kernels = {}, []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = evt.time_range.start, evt.time_range.end
        if evt.name.startswith("tick_phase::"):
            phases.setdefault(evt.name.split("::")[1], []).append((t0, t1))
        elif evt.name not in ranges:
            kernels.append((evt.name, t0, (t1 - t0) / 1e3))
    busy, by_name, split = 0.0, {}, {}
    for name, t0, ms in kernels:
        rec = by_name.setdefault(name[:90], [0, 0.0])
        rec[0] += 1
        rec[1] += ms
        part = next((k for k, iv in phases.items()
                     if any(a <= t0 < b for a, b in iv)), "other")
        rec = split.setdefault(part, [0, 0.0])
        rec[0] += 1
        rec[1] += ms
    if not kernels:
        raise AssertionError(f"the profiler saw no device work in tick {tick}")
    end = -math.inf
    for _, t0, ms in sorted(kernels, key=lambda k: k[1]):
        t1 = t0 + 1e3 * ms
        busy += max(0.0, t1 - max(t0, end)) / 1e3
        end = max(end, t1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"tick": tick, "profiled_wall_ms": wall_ms, "kernels": len(kernels),
            "device_busy_ms": busy,
            "kernel_ms": sum(ms for *_, ms in kernels),
            **{f"{d}_copies": sum(n for k, (n, _) in by_name.items()
                                  if f"Memcpy {d}" in k)
               for d in ("DtoH", "HtoD")},
            "phases": {k: {"kernels": n, "device_ms": ms}
                       for k, (n, ms) in split.items()},
            "top_kernels": [[k, n, ms] for k, (n, ms) in top],
            "progress": (cluster.kv_transfers, cluster.decoded_tokens)}


def serve_disagg_phase(served):
    """The disaggregated cluster on qwen3-4b at full width and depth (the
    serve phase's bf16 weights), every rank on this card, in three acts,
    each held to the colocated server that runs its decode path on the
    same requests: act 1 (2 prefill + 2 decode ranks, dense staging,
    prefill on "xla", decode on "gascore") to ``Server``; act 2 (the
    same, paged) to ``PagedServer``; act 3 (1 prefill, 1 decode, 1 memory
    rank on "gascore", a pool of one request's full cache, the
    reference's pressure burst 8x longer) to an unpressured
    ``PagedServer``.  The clusters are built as the entry points build
    them: transfers planned and swaps priced by the cluster's own
    measurement of this card (``sched.measure_costs``).  The checks' own
    runs (act 3's oracle, the profiled ticks) come before the counts are
    set to 0.  Returns the launches per kernel over the acts."""
    model, ctx, params = served["model"], served["ctx"], served["params"]
    cfg = model.cfg
    pool_pages = CACHE_LEN // PAGE_TOKENS  # act 3: one request's full cache
    paged = dict(paged=True, page_tokens=PAGE_TOKENS)
    burst = lambda: ex.pressure_burst(cfg.vocab, PRESSURE_SCALE)  # noqa: E731
    acts = {  # cluster arguments, requests, pressured
        "act1": (dict(n_prefill=2, n_decode=2), requests, False),
        "act2": (dict(n_prefill=2, n_decode=2, **paged), requests, False),
        "act3": (dict(n_prefill=1, n_decode=1, n_memory=1,
                      memory_backend="gascore", pages_per_rank=pool_pages,
                      **paged), burst, True),
    }

    def cluster(name):
        return DisaggCluster(model, ctx, params, decode_batch=BATCH,
                             cache_len=CACHE_LEN, prefill_backend="xla",
                             decode_backend="gascore", device="cuda",
                             **acts[name][0])

    oracles = {"act1": served["dense"], "act2": served["paged"],
               "act3": ex.serve(PagedServer(model, ctx, params, BATCH,
                                            CACHE_LEN, device="cuda",
                                            page_tokens=PAGE_TOKENS), burst())}
    demand = sum(-(-(len(r.prompt) + r.max_new) // PAGE_TOKENS) for r in burst())
    if demand < 1.5 * pool_pages:
        raise AssertionError(f"act 3 demand {demand} pages < 1.5 x {pool_pages}")
    profiles = {}
    for name in ("act1", "act2"):
        c = cluster(name)
        profiles[name] = profile_tick(c, requests(), PROFILE_TICK)
        del c
        torch.cuda.empty_cache()

    reset_counts()
    pa.paged_attention.launches = 0  # the phase's main path starts here
    figures, per_act, costs = {}, {}, None
    for name, (_, reqs, pressured) in acts.items():
        c, rs = cluster(name), reqs()
        rec = drive_act(c, rs, pressured=pressured)
        st = rec["stats"]
        ex.check_handoff(st, len(rs))
        ex.check_tokens(name, oracles[name], rec["tokens"])
        if c.paged:
            ex.check_drained(c, st)
        if name == "act2" and st["kv_pages_shared"] < SHARED // PAGE_TOKENS:
            raise AssertionError(f"act 2: prefix pages were moved: {st}")
        if name == "act3" and (st["sched_swaps"] < 1
                               or st["sched_resumes"] != st["sched_evictions"]):
            raise AssertionError(f"act 3: swaps {st['sched_swaps']}, resumes "
                                 f"{st['sched_resumes']} of "
                                 f"{st['sched_evictions']}")
        per_act[name] = rec["launches"]
        fig = {
            "ranks": c.roles, "backends": c._backends,
            "segment_gib": c.kvseg.numel() * 4 / 2**30,
            "tok_per_s": st["tok_per_s"], "p50_latency_s": st["p50_latency_s"],
            "p50_ttft_s": st["p50_ttft_s"], "wall_s": st["wall_s"],
            "ticks": st["ticks"], "transfers": st["transfer_programs"],
            "tick_ms_median": float(np.median(list(rec["tick_ms"].values()))),
            "decode_tick_ms_median": float(np.median(rec["decode_ms"])),
            "kv_bytes": st["kv_bytes"], "kv_bytes_per_s": st["kv_bytes_per_s"],
            "kv_plan": st["kv_plan"], "launches": rec["launches"],
            "requests_token_identical": len(rec["tokens"]),
        }
        for key in ("kv_pages_sent", "kv_pages_shared", "prefix_hit_rate",
                    "pool_free_pages", "sched_evictions", "sched_swaps",
                    "sched_recomputes", "sched_resumes", "swap_out_bytes",
                    "swap_in_bytes", "tier_free_slots", "tier_slots",
                    "swap_plan"):
            if key in st:
                fig[key] = st[key]
        if name in profiles:
            # the busy share against the same tick's wall in this run,
            # which ran without the profiler's overhead
            prof = profiles[name]
            if rec["progress"].get(PROFILE_TICK + 1) != tuple(prof["progress"]):
                raise AssertionError(
                    f"{name}: the profiled tick {prof['progress']} is not "
                    f"the measured one {rec['progress'].get(PROFILE_TICK + 1)}")
            wall = rec["tick_ms"][PROFILE_TICK]
            fig["profiled_tick"] = {**prof, "wall_ms": wall,
                                    "device_busy_share": prof["device_busy_ms"] / wall}
        if name == "act3":
            fig["demand_pages"] = demand
            costs = {k: dataclasses.asdict(v) for k, v in c.costs.items()}
        figures[name] = fig
        del c
        torch.cuda.empty_cache()
    launches = {k: v for k, v in all_counts().items() if k in DISAGG_KERNELS}
    if launches != {k: sum(a[k] for a in per_act.values()) for k in launches}:
        raise AssertionError(f"serve_disagg launched {launches}, its acts "
                             f"{per_act}")
    if min(launches.values()) == 0:
        raise AssertionError(f"serve_disagg never launched: {launches}")
    emit({"phase": "serve_disagg", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": "bfloat16", "card": card(),
          "batch": BATCH, "cache_len": CACHE_LEN, "page_tokens": PAGE_TOKENS,
          "costs": costs, "acts": figures, "launches": launches})
    return launches


# --------------------------------------------------------------------------- #
# tensor-parallel decode groups (parallel/tp.py, TPPagedServer, TP clusters)
# --------------------------------------------------------------------------- #
TP = 2
TP_BACKENDS = ("gascore", "xla,gascore")
# the f32 runs' depth, reduced: n_layers 36 -> 12, so that the whole
# script stays well inside its time limit on a slow host (the bf16 runs
# keep the serve phase's full depth)
TP_F32_LAYERS = 12
TP_CLUSTER_REQUESTS = N_REQ  # the serve phase's traffic, not cut
TP_TRANSFERS = ("ring_shift", "perm_put")  # a group all-reduce's kernels


def counted(fn):
    """``fn()`` and the launches per kernel (``all_counts``) it made."""
    before = all_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in all_counts().items()}


def per_step(name, launches, steps, n_layers):
    """Launches a TP decode step, from the launches of a run of ``steps``
    paged decode steps that launched nothing else: one paged attention a
    layer for the whole group (the vmap rule's fold), and each transfer
    kernel the same number of times every step (the step's planned
    all-reduces)."""
    if steps == 0 or launches["paged_attention"] != n_layers * steps:
        raise AssertionError(f"{name}: paged attention launched "
                             f"{launches['paged_attention']} times in {steps} "
                             f"TP steps; want {n_layers} a step")
    uneven = {k: v for k, v in launches.items() if v % steps}
    if uneven:
        raise AssertionError(f"{name}: {uneven} launches in {steps} TP steps")
    return {k: launches[k] // steps for k in DISAGG_KERNELS}


def tp_cluster(model, ctx, params, tp):
    """Act 2's paged setting with one decode group: 1 prefill rank
    ("xla") and ``tp`` decode ranks ("gascore") forming one group."""
    return DisaggCluster(model, ctx, params, n_prefill=1, n_decode=tp, tp=tp,
                         decode_batch=BATCH, cache_len=CACHE_LEN,
                         prefill_backend="xla", decode_backend="gascore",
                         paged=True, page_tokens=PAGE_TOKENS, device="cuda")


def run_tp_cluster(make, reqs, on_step, n_layers):
    """Build a cluster with ``make()`` and serve ``reqs`` through it,
    ``on_step`` hooked on its decode servers.  Returns the stats, the
    tokens, the launches per kernel (building included), and the launches
    of the decode group's all-reduces a step: what is left over the
    transfer programs' schedule and one paged attention a layer a paged
    decode step, the same every step."""
    def run():
        cluster = make()
        for srv in cluster.decode_servers:
            srv.on_step = on_step
        for r in reqs:
            cluster.submit(r)
        stats = cluster.run_until_drained()
        ex.check_handoff(stats, len(reqs))
        ex.check_drained(cluster, stats)
        return stats, {r.rid: r.out for r in cluster.finished}

    (stats, tokens), launches = counted(run)
    extra = {k: v - stats["transfer_launches"].get(k, 0)
             for k, v in launches.items()}
    steps = stats["decode_paged_steps"]
    extra["paged_attention"] -= n_layers * steps
    if (steps == 0 or extra["paged_attention"] or min(extra.values()) < 0
            or any(v % steps for v in extra.values())):
        raise AssertionError(f"TP cluster launches {launches}, schedule "
                             f"{stats['transfer_launches']}, {steps} paged "
                             "decode steps")
    return stats, tokens, launches, {k: extra[k] // steps
                                     for k in TP_TRANSFERS}


def serve_tp_phase(served):
    """Tensor-parallel decode groups of 2 ranks on qwen3-4b at full width,
    every rank on this card.  f32 on ``TP_F32_LAYERS`` layers (a second
    seeded model plus its rank-stacked shards): ``TPPagedServer`` on
    "gascore" and "xla,gascore" on the serve phase's traffic, tokens
    identical to an f32 ``PagedServer``'s of the same depth (``f32_pass``,
    run first) but at near ties under F3's rule (each printed and
    counted); then a cluster of 1 prefill rank and a tp=2 decode group,
    held the same way to a tp=1 cluster (the oracle, run before the
    counts are set to 0).  bf16 (the serve phase's
    weights): ``TPPagedServer`` on both backends, tok/s beside
    ``PagedServer``'s of the same run, agreement, launches a step.  One
    paged-attention launch a layer a TP step; the group all-reduces
    planned with this card's measured constants, the cluster group's the
    same a step as the server's on "gascore".  The phase's launches are
    the sum of its gated runs'."""
    cfg = served["model"].cfg
    cut = dataclasses.replace(cfg, n_layers=TP_F32_LAYERS)
    rec = {"phase": "serve_tp", "arch": cfg.name, "layers": cfg.n_layers,
           "f32_layers": cut.n_layers,
           "reduced": {"f32 n_layers": [cfg.n_layers, cut.n_layers]},
           "d_model": cfg.d_model, "tp": TP, "card": card(), "batch": BATCH,
           "cache_len": CACHE_LEN, "page_tokens": PAGE_TOKENS}
    rec["f32_oracle"], f32 = f32_pass(cut)
    cfg32 = dataclasses.replace(cut, dtype=torch.float32)
    model, ctx = build_model(cfg32), RunCtx()
    params = model.init(ctx, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    reqs = lambda: requests()[:TP_CLUSTER_REQUESTS]  # noqa: E731
    oracle = TieGate()
    base, base_tokens, _, base_group = run_tp_cluster(
        lambda: tp_cluster(model, ctx, params, 1), reqs(), oracle.keep,
        cfg32.n_layers)
    if any(base_group.values()):
        raise AssertionError(f"the tp=1 cluster's decode all-reduced: "
                             f"{base_group} a step")
    pygc.collect()
    torch.cuda.empty_cache()

    reset_counts()
    pa.paged_attention.launches = 0  # the phase's path starts here
    runs = []

    def tp_server(backend, model, params, on_step=None):
        srv, built = counted(lambda: TPPagedServer(
            model, ctx, params, BATCH, CACHE_LEN, tp=TP, tp_backend=backend,
            device="cuda", page_tokens=PAGE_TOKENS))
        srv.on_step = on_step
        def serve():
            for r in requests():
                srv.submit(r)
            st = srv.run_until_drained()
            return {r.rid: r.out for r in srv.finished}, st

        t0 = time.perf_counter()
        (out, st), launches = counted(serve)
        wall = time.perf_counter() - t0
        runs.extend([built, launches])
        fig = {"wall_s": wall, "decode_steps": srv.paged_decode_steps,
               "launches_per_step": per_step(
                   backend, launches, srv.paged_decode_steps,
                   model.cfg.n_layers),
               "costs": {k: dataclasses.asdict(v)
                         for k, v in srv.costs.items()}}
        del srv
        pygc.collect()
        torch.cuda.empty_cache()
        return out, st, fig

    rec["f32"] = {}
    for backend in TP_BACKENDS:
        gate = f32["gate"].fork()
        out, _, fig = tp_server(backend, model, params, gate.compare)
        rec["f32"][backend] = {
            **gate.verdict(f"f32 TP {backend}", f32["tokens"], out), **fig}

    # the cluster: a tp=2 decode group against the tp=1 oracle, f32
    stats, tokens, launches, group = run_tp_cluster(
        lambda: tp_cluster(model, ctx, params, TP), reqs(), oracle.compare,
        cfg32.n_layers)
    runs.append(launches)
    if stats["tp"] != TP or stats["n_decode_groups"] != 1:
        raise AssertionError(f"not one tp={TP} decode group: {stats}")
    server_step = rec["f32"]["gascore"]["launches_per_step"]
    if group != {k: server_step[k] for k in TP_TRANSFERS}:
        raise AssertionError(f"the cluster's TP group launched {group} a "
                             f"step, TPPagedServer {server_step}")
    rec["cluster"] = {
        "requests": TP_CLUSTER_REQUESTS, "dtype": "float32",
        **oracle.verdict("f32 TP cluster", base_tokens, tokens),
        "tok_per_s": stats["tok_per_s"], "tp1_tok_per_s": base["tok_per_s"],
        "ticks": stats["ticks"], "tp1_ticks": base["ticks"],
        "decode_steps": stats["decode_paged_steps"], "launches": launches,
        "launches_per_step": {**group, "paged_attention": cfg32.n_layers}}
    del model, params, oracle
    pygc.collect()
    torch.cuda.empty_cache()

    # bf16 on the serve phase's weights, reported
    rec["bf16"] = {"paged_tok_per_s": served["record"]["tok_per_s"]}
    for backend in TP_BACKENDS:
        out, st, fig = tp_server(backend, served["model"], served["params"])
        if sorted(out) != list(range(N_REQ)):
            raise AssertionError(f"bf16 TP {backend}: finished {sorted(out)}")
        agree = sum(a == b for r in out
                    for a, b in zip(out[r], served["paged"][r]))
        rec["bf16"][backend] = {
            "tok_per_s": st["tok_per_s"], "p50_latency_s": st["p50_latency_s"],
            **fig, "greedy_token_agreement": agree / (N_REQ * MAX_NEW),
            "requests_token_identical": sum(out[r] == served["paged"][r]
                                            for r in out)}
    total = all_counts()
    if total != {k: sum(r[k] for r in runs) for k in total}:
        raise AssertionError(f"serve_tp launched {total}, its runs {runs}")
    launches = {k: v for k, v in total.items() if k in DISAGG_KERNELS}
    rec["launches"] = launches
    emit(rec)
    return launches


# --------------------------------------------------------------------------- #
# fault-tolerant elastic serving (serving/disagg.py, testing/fault_suite.py)
# --------------------------------------------------------------------------- #
# the suite's mix at the serve cell's pages and cache: even rids share a
# 64-token prefix, prompts of 48-128 tokens, 16-32 new tokens; the quorum
# scenario's burst on act 3's pool (one request's full cache) with act
# 3's decode batch
FT_SIZE = fault_suite.Size(
    page_tokens=PAGE_TOKENS, cache_len=CACHE_LEN, decode_batch=2,
    n_requests=6, shared_pages=SHARED // PAGE_TOKENS,
    even_tail=(1, PROMPT_LEN - SHARED + 1), private_len=(48, PROMPT_LEN + 1),
    max_new=(16, 33), burst_scale=4, quorum_pages=CACHE_LEN // PAGE_TOKENS,
    quorum_batch=BATCH)
FT_BACKENDS = dict(prefill_backend="xla", decode_backend="gascore",
                   memory_backend="gascore")
FT_SEED = 0  # chaos(0)
# reduced: n_layers 36 -> 12, so that the whole script stays well inside
# its time limit on a slow host
FT_LAYERS = 12


def sync_free(fn):
    """``fn`` wrapped to run under sync debug mode "error" on the card (a
    host wait inside raises), with no synchronisation around it: a
    transfer may still be in flight on the side stream."""
    def call(*a, **kw):
        if not torch.cuda.is_available():
            return fn(*a, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return call


class FTWatch:
    """How the ``serve_ft`` phase runs a scenario's two clusters (the
    suite's ``run``) and holds the faulted tokens to the twin's (its
    ``parity``).  Both runs: the host tracer on (its registry the
    cluster's, so ``export.validate`` checks RMA bytes against the
    counters), launches per kernel equal to the cluster's schedule (its
    transfer programs' kernels, one paged attention a layer a paged decode
    step).  The twin's decode servers keep their logit rows, the faulted
    run's are compared to them (``TieGate``: F3's rule; replayed rows of a
    recompute-resume are checked by the server itself, token for token).
    The faulted run: every kill under sync debug mode, a dead group's
    server stepping no more after its kill, one flight dump per death, a
    valid exported trace; its figures are kept in ``record``."""

    def __init__(self, name, counter=all_counts):
        self.name, self.counter = name, counter
        self.gate, self.record, self.launches = None, {}, []

    def run(self, label, model, ctx, params, reqs, hook=None, **kw):
        if label == "twin":
            self.gate = TieGate()
        look = self.gate.keep if label == "twin" else self.gate.compare

        def on_step(server, live, logits):
            look(server, [i for i in live if not server.replaying.get(i)],
                 logits)

        def setup(cluster):
            for srv in cluster.decode_servers:
                srv.on_step = on_step

        frozen = {}

        def watched(cluster, phase, tick):
            down = {g for g in range(cluster.n_groups)
                    if cluster._group_down(g)}
            sync_free(hook)(cluster, phase, tick)
            for g in range(cluster.n_groups):
                if cluster._group_down(g) and g not in down:
                    frozen[g] = cluster.decode_servers[g].paged_decode_steps

        tracer = obs_trace.enable(obs_trace.Tracer(capacity=1 << 20))
        before = self.counter()
        try:
            cl, stats, toks = fault_suite.run_cluster(
                model, ctx, params, reqs, hook=watched if hook else None,
                setup=setup, metrics=tracer.registry, **kw)
        finally:
            obs_trace.disable()
        got = {k: v - before[k] for k, v in self.counter().items()}
        want = {**dict.fromkeys(got, 0), **stats["transfer_launches"],
                "paged_attention": model.cfg.n_layers
                * stats["decode_paged_steps"]}
        if got != want:
            raise AssertionError(f"{self.name} {label}: launches {got}, "
                                 f"schedule says {want}")
        self.launches.append(got)
        still = {g: cl.decode_servers[g].paged_decode_steps for g in frozen}
        if still != frozen:
            raise AssertionError(f"{self.name}: a dead group stepped on: "
                                 f"{frozen} at its kill, {still} at the end")
        ticks = {e.tick0: e.dur_us / 1e3
                 for e in tracer.spans(cat="tick", name="tick")}
        if label == "twin":
            self.twin_ticks = ticks
            self.record["twin_ticks"] = len(ticks)
            return cl, stats, toks
        phases = {}
        for e in tracer.spans(cat="tick_phase"):
            phases.setdefault(e.tick0, {})[e.name] = e.dur_us / 1e3
        problems = obs_export.validate(obs_export.chrome_trace(tracer),
                                       tracer.registry)
        if problems:
            raise AssertionError(f"{self.name}: the exported trace is "
                                 f"invalid: {problems[:5]}")
        deaths = [e.tick0 for e in tracer.events
                  if e.cat == "ft" and e.name == "rank_death"]
        if len(cl.flight_dumps) != stats["rank_failures"] or len(deaths) != (
                stats["rank_failures"]):
            raise AssertionError(
                f"{self.name}: {stats['rank_failures']} deaths, "
                f"{len(deaths)} traced, {len(cl.flight_dumps)} flight dumps")
        kills = hook.log if hook else []
        normal = [ms for t, ms in ticks.items() if t not in deaths]
        self.record.update({
            "ticks": len(ticks), "kills": [list(k) for k in kills],
            "detected_at": deaths,
            "ticks_to_detection": [d - k[0] for d, k in zip(deaths, kills)],
            "kill_tick_ms": [ticks[k[0]] for k in kills],
            "death_tick_ms": [ticks[d] for d in deaths],
            "death_tick_phases_ms": [phases[d] for d in deaths],
            "twin_tick_ms_at_death": [self.twin_ticks.get(d) for d in deaths],
            "normal_tick_ms_median": float(np.median(normal)),
            "flight_dump_events": [len(d["events"]) for d in cl.flight_dumps],
            "trace_events": len(tracer.events),
            "launches": got,
            **{k: stats[k] for k in (
                "rank_failures", "recovered_reroutes", "recovered_recompute",
                "elastic_joins", "migrated_prefix_pages", "decode_paged_steps",
                "sched_swaps", "tier_quorum_restores", "tok_per_s", "wall_s")
               if k in stats},
        })
        return cl, stats, toks

    def parity(self, base, got, what):
        self.record.update(self.gate.verdict(what, base, got))


def ft_scenarios(model, ctx, params, size, device, counter=all_counts):
    """The fault suite's scenarios 1-4 and ``chaos(FT_SEED)`` on ``model``
    at ``size`` on ``device``, each run through an ``FTWatch``.  Returns
    each scenario's record and every run's launches per kernel."""
    kw = dict(size=size, device=device, **FT_BACKENDS)
    plan = {
        "kill_decode": lambda w: fault_suite.scenario_kill_decode(
            model, ctx, params, run=w.run, parity=w.parity, **kw),
        "quorum_restore": lambda w: fault_suite.scenario_quorum_restore(
            model, ctx, params, run=w.run, parity=w.parity, **kw),
        "elastic_join": lambda w: fault_suite.scenario_elastic_join(
            model, ctx, params, run=w.run, parity=w.parity, **kw),
        "heartbeat_delay": lambda w: fault_suite.scenario_heartbeat_delay(
            model, ctx, params, run=w.run, parity=w.parity, **kw),
        "chaos": lambda w: fault_suite.scenario_chaos(
            model, ctx, params, FT_SEED, run=w.run, parity=w.parity, **kw),
    }
    records, launches = {}, []
    for name, go in plan.items():
        watch = FTWatch(name, counter)
        out = go(watch)
        rec = watch.record
        if name == "kill_decode" and rec["kills"][0][1] != "pre_consume":
            raise AssertionError(f"kill_decode: not mid-handoff: {rec}")
        if name == "elastic_join":
            rec["served_on_joined"] = out["served_on_joined"]
        records[name] = rec
        launches.extend(watch.launches)
        del out
        pygc.collect()
    return records, launches


def serve_ft_phase(served=None):
    """Fault-tolerant elastic serving of qwen3-4b at full width on
    ``FT_LAYERS`` layers in f32 (a seeded model of its own, freed after),
    every rank on
    this card: the fault suite's kill-decode mid-handoff (1 prefill "xla",
    2 decode "gascore", 2 memory "gascore" with 2 replicas, 1 spare),
    quorum restore, elastic join, heartbeat delay and ``chaos(0)``, each
    against its no-failure twin (``FTWatch``).  Clusters plan with this
    card's measured transport constants.  The counts are set to 0 at the
    phase's start; its launches are the sum of its runs'."""
    cfg = (served["model"].cfg if served is not None
           else ARCHS["qwen3-4b"])
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=FT_LAYERS)
    model, ctx = build_model(cfg32), RunCtx()
    params = model.init(ctx, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    # the transport constants the clusters plan with, measured once a
    # process (timed puts): before the counts are set to 0
    sched.measure_costs("cuda", ("xla", "gascore"))
    reset_counts()
    pa.paged_attention.launches = 0  # the phase's path starts here
    t0 = time.perf_counter()
    records, runs = ft_scenarios(model, ctx, params, FT_SIZE, "cuda")
    wall = time.perf_counter() - t0
    del model, params
    pygc.collect()
    torch.cuda.empty_cache()
    total = all_counts()
    if total != {k: sum(r[k] for r in runs) for k in total}:
        raise AssertionError(f"serve_ft launched {total}, its runs {runs}")
    launches = {k: v for k, v in total.items() if k in DISAGG_KERNELS}
    if min(launches.values()) == 0:
        raise AssertionError(f"serve_ft never launched: {launches}")
    emit({"phase": "serve_ft", "arch": cfg.name, "layers": cfg32.n_layers,
          "reduced": {"n_layers": [cfg.n_layers, cfg32.n_layers]},
          "d_model": cfg.d_model, "dtype": "float32", "card": card(),
          "size": dataclasses.asdict(FT_SIZE), "backends": FT_BACKENDS,
          "wall_s": wall, "scenarios": records, "launches": launches})
    return launches


# --------------------------------------------------------------------------- #
# split phase on the side stream (core/engine.py)
# --------------------------------------------------------------------------- #
OV_RANKS, OV_ROWS, OV_COLS = 8, 8192, 128  # (a): 4 MiB of f32 a rank a hop
OV_BACKENDS = ("xla", "gascore")
# (b): qwen3-4b pages of 16 tokens fetched by 8 vectored gets of 4 pages
FETCH_RANKS, FETCH_PAGES, FETCH_BATCHES, FETCH_PER_BATCH = 2, 64, 8, 4
AR_ROWS, AR_COLS, AR_SEGMENTS = 16384, 256, 4  # (c): 16 MiB of f32 a rank


def ov_transform(c, w):
    return torch.tanh(c @ w)


def blocking_ring(engine, x, w):
    """The reference's blocking ring (``gas_microbench.py``): each hop's
    shift completes on the current stream before its transform runs."""
    cur, acc = x, torch.zeros_like(x)
    for _ in range(1, engine.n_nodes):
        cur = engine.shift(cur, 1)
        acc = acc + ov_transform(cur, w)
    return acc


def overlap_ring(engine, x, w):
    """The reference's split-phase ring: hop h+1 is initiated (on the side
    stream) before hop h's transform (on the current stream)."""
    n = engine.n_nodes
    cur, acc = x, torch.zeros_like(x)
    pending = engine.shift_nb(cur, 1)
    for h in range(1, n):
        cur = pending.wait()
        if h < n - 1:
            pending = engine.shift_nb(cur, 1)
        acc = acc + ov_transform(cur, w)
    return acc


def no_sync(fn):
    """One call of ``fn`` under sync debug mode "error": any host wait
    inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


def path_call(fn):
    """One untimed call of ``fn``, a program of the phase's path, with no
    host sync (``no_sync``): the counts are set to 0 just before it and
    read just after.  Returns its output and its launches per kernel."""
    reset_counts()
    pa.paged_attention.launches = 0
    out = no_sync(fn)
    return out, all_counts()


def path_pair(name, run, runs, times=1):
    """``run``'s two programs, blocking and overlapped: each called once to
    warm up, then once on the path (``path_call``, its launches kept in
    ``runs``).  The second must launch each kernel ``times`` times as
    often as the first; returns the warm and the path call's outputs of
    each."""
    outs = {}
    for k, f in run.items():
        warm = f()
        outs[k] = (warm, *path_call(f))
    got = {k: o[2] for k, o in outs.items()}
    first, second = got.values()
    if second != {k: times * v for k, v in first.items()}:
        raise AssertionError(f"{name}: the programs launched {got}")
    runs.update({f"{name} {k}": v for k, v in got.items()})
    return {k: o[:2] for k, o in outs.items()}


def stream_overlap(fn):
    """One call of ``fn`` under ``torch.profiler``, enqueued whole behind a
    sleep kernel (as ``device_ms`` times it: the host's enqueue is slower
    than these kernels, and without the sleep each kernel would run
    alone as it arrives), its kernels read from the Chrome trace with
    their streams.  The compute stream is the one the matrix products
    run on; every kernel on another stream is a transfer.  Returns the
    kernel names by stream and how many (transfer, compute) pairs of
    kernels ran at the same time."""
    import os
    import tempfile

    cycles = 1 << 27
    while True:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
            fn()
            late = slept.query()
            torch.cuda.synchronize()
        if not late:
            break
        if cycles >= 1 << 31:
            raise AssertionError("the host never enqueued the call ahead "
                                 "of the device")
        cycles *= 2
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = [(e["name"], e["args"]["stream"], e["ts"], e["ts"] + e["dur"])
               for e in events
               if e.get("cat") == "kernel" and "stream" in e.get("args", {})
               and "sleep" not in e["name"]]
    compute = {k[1] for k in kernels
               if any(t in k[0].lower() for t in GEMM_NAMES)}
    xfer = [k for k in kernels if k[1] not in compute]
    comp = [k for k in kernels if k[1] in compute]
    pairs = sum(1 for _, _, a0, a1 in xfer for _, _, b0, b1 in comp
                if a0 < b1 and b0 < a1)
    names = {}
    for name, stream, *_ in kernels:
        names.setdefault(str(stream), set()).add(name[:60])
    return {"kernels": len(kernels), "compute_streams": sorted(compute),
            "transfer_streams": sorted({k[1] for k in xfer}),
            "transfer_kernels": len(xfer), "overlapping_pairs": pairs,
            "names": {k: sorted(v) for k, v in names.items()}}


def check_streams(name, trace, transfers):
    """The transfers (``transfers`` of them) ran off the compute stream,
    and at least one of them beside a compute kernel."""
    if len(trace["compute_streams"]) != 1 or trace["transfer_kernels"] < (
            transfers):
        raise AssertionError(f"{name}: want {transfers} transfer kernels off "
                             f"the one compute stream: {trace}")
    if trace["overlapping_pairs"] == 0:
        raise AssertionError(f"{name}: no transfer kernel overlapped a "
                             f"compute kernel: {trace}")


def gap_record(T, C, blocking, overlapped):
    return {"T_ms": T, "C_ms": C, "bound": (T + C) / max(T, C),
            "blocking_ms": blocking, "overlap_ms": overlapped,
            "gap": blocking / overlapped}


def overlap_phase():
    """Split-phase transfers on the side stream against blocking ones, by
    ``device_ms`` (the device's time alone; both streams' work lies
    between its events, the last wait ordering the current stream after
    the last transfer): (a) the reference's rings (``gas_microbench.py``)
    at 8 ranks x 4 MiB a hop with the transform tanh(c @ w), on "xla" and
    "gascore"; (b) the reference's paged-fetch overlap
    (``train_serve_bench.py``) at qwen3-4b's page, 2 ranks, 8 vectored
    gets of 4 pages beside paged attention at the serve phase's decode
    shape; (c) the segmented against the monolithic ring all-reduce on
    "gascore" at 8 x 16 MiB.  Each prints T (one transfer), C (one
    compute), the bound (T+C)/max(T,C) and the measured gap
    (blocking / overlapped).  Gated: overlapped bytes equal to blocking
    bytes, no host sync after warm-up, and (a)'s profiled overlapped ring
    runs its transfer kernels on a stream of their own, at least one of
    them at the same time as a compute kernel.  The gaps are printed.
    The phase's launches are those of one untimed call of each program
    (``path_pair``), not of the timing loops or the profiled call."""
    dev = torch.device("cuda")
    runs = {}
    g = torch.Generator(device=dev).manual_seed(0)
    rec = {"phase": "overlap", "card": card()}

    # (a) rings
    n = OV_RANKS
    x = torch.randn((n * OV_ROWS, OV_COLS), generator=g, device=dev) * 0.01
    w = torch.eye(OV_COLS, device=dev) * 0.5
    stacked = x.reshape(n, OV_ROWS, OV_COLS)
    C = device_ms(lambda: ov_transform(stacked, w), 20)
    rec["rings"] = {}
    for backend in OV_BACKENDS:
        ctx = gasnet.Context(n, backend=backend, device=dev)
        spec = (P("node"), P())
        run = {name: (lambda ring=ring: ctx.spmd(
            lambda node, v, w: ring(node.engine, v, w), x, w, in_specs=spec))
            for name, ring in (("blocking", blocking_ring),
                               ("overlap", overlap_ring))}
        hop = lambda: ctx.spmd(lambda node, v: node.engine.shift(v, 1), x)  # noqa: E731
        outs = path_pair(f"ring {backend}", run, runs)  # warm, path
        _byte_equal(f"overlap ring {backend}", outs["overlap"][1],
                    outs["blocking"][1])
        _byte_equal(f"overlap ring {backend} (again)", outs["overlap"][0],
                    outs["blocking"][0])
        trace = stream_overlap(run["overlap"])
        check_streams(f"ring on {backend}", trace, n - 1)
        rec["rings"][backend] = {
            **gap_record(device_ms(hop, 20), C, device_ms(run["blocking"], 10),
                         device_ms(run["overlap"], 10)),
            "trace": trace}

    # (b) paged fetch beside paged attention
    cfg = ARCHS["qwen3-4b"]
    layout = pool_lib.PagedLayout.from_struct(
        build_model(cfg).kv_block_struct(RunCtx(), prompt_len=4,
                                         cache_len=CACHE_LEN),
        cache_len=CACHE_LEN, page_tokens=PAGE_TOKENS)
    pe = layout.page_elems
    seg = torch.randn((FETCH_RANKS, FETCH_PAGES * pe), generator=g, device=dev)
    rng = np.random.default_rng(0)
    batches = [[int(p) * pe for p in rng.integers(0, FETCH_PAGES,
                                                  FETCH_PER_BATCH)]
               for _ in range(FETCH_BATCHES)]
    attn = kernel_inputs(torch.bfloat16, g, SERVED_LENGTHS)

    def fetch(overlapped, with_attn=True):
        def prog(node, s):
            if overlapped:
                hs = [node.get_nbv(s, frm=gasnet.Shift(1), indices=b, size=pe)
                      for b in batches]
            else:
                got = [node.get_v(s, frm=gasnet.Shift(1), indices=b, size=pe)
                       for b in batches]
            out = ops.paged_attention(*attn) if with_attn else attn[0]
            if overlapped:
                got = [node.sync(h) for h in hs]
            return torch.cat(got)[None], out

        return prog

    rec["fetch"] = {"page_bytes": pe * 4, "ranks": FETCH_RANKS,
                    "pages_per_rank": FETCH_PAGES, "gets": FETCH_BATCHES,
                    "pages_per_get": FETCH_PER_BATCH}
    spec = (P("node"), P())
    C = device_ms(lambda: ops.paged_attention(*attn), 20)
    for backend in OV_BACKENDS:
        ctx = gasnet.Context(FETCH_RANKS, backend=backend, device=dev)
        run = {k: (lambda o=o, a=True: ctx.spmd(fetch(o, a), seg,
                                                 out_specs=spec))
               for k, o in (("blocking", False), ("overlap", True))}
        gets = lambda: ctx.spmd(fetch(False, False), seg, out_specs=spec)  # noqa: E731
        outs = path_pair(f"fetch {backend}", run, runs)
        for i in range(2):
            for j in range(2):
                _byte_equal(f"fetch {backend}", outs["overlap"][i][j],
                            outs["blocking"][i][j])
        want = seg.view(FETCH_RANKS, FETCH_PAGES, pe).roll(-1, 0)
        flat = [p // pe for b in batches for p in b]
        _byte_equal(f"fetch {backend} pages", outs["overlap"][1][0].reshape(
            FETCH_RANKS, -1, pe), want[:, flat])
        rec["fetch"][backend] = gap_record(
            device_ms(gets, 10), C, device_ms(run["blocking"], 10),
            device_ms(run["overlap"], 10))

    # (c) segmented against monolithic ring all-reduce
    ctx = gasnet.Context(n, backend="gascore", device=dev)
    x = torch.randn((n * AR_ROWS, AR_COLS), generator=g, device=dev)
    run = {
        "monolithic": lambda: ctx.spmd(
            lambda node, v: collectives.ring_all_reduce(node.engine, v), x),
        "segmented": lambda: ctx.spmd(
            lambda node, v: collectives.segmented_ring_all_reduce(
                node.engine, v, n_segments=AR_SEGMENTS, depth=2), x),
    }
    outs = path_pair("all-reduce", run, runs, times=AR_SEGMENTS)
    _byte_equal("segmented all-reduce", outs["segmented"][1],
                outs["monolithic"][1])
    _byte_equal("segmented all-reduce (again)", outs["segmented"][0],
                outs["monolithic"][0])
    chunk = x[: n * (AR_ROWS // n)]  # one hop's S/n rows a rank
    hop = lambda: ctx.spmd(lambda node, v: node.engine.shift(v, 1), chunk)  # noqa: E731
    chunk = chunk.reshape(n, AR_ROWS // n, AR_COLS)
    costs = sched.measure_costs(dev, {"xla", "gascore"})
    plan = sched.plan_collective(
        "all_reduce", nbytes=AR_ROWS * AR_COLS * 4, n_nodes=n,
        engine=make_engine("gascore", "node", n), costs=costs)
    rec["all_reduce"] = {
        "ranks": n, "mib_per_rank": AR_ROWS * AR_COLS * 4 / 2**20,
        "segments": AR_SEGMENTS, "depth": 2, "planned": plan.describe(),
        **gap_record(device_ms(hop, 20), device_ms(lambda: chunk + chunk, 20),
                     device_ms(run["monolithic"], 10),
                     device_ms(run["segmented"], 10))}
    launches = {k: sum(r[k] for r in runs.values()) for k in all_counts()}
    rec["path_launches"], rec["launches"] = runs, launches
    emit(rec)
    return launches


# --------------------------------------------------------------------------- #
# flash attention (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu)
# --------------------------------------------------------------------------- #
# the training path's attention: qwen3-4b, batch 2 x seq 2048, causal
TRAIN_SHAPE = (2, 32, 8, 2048, 128, True, None)  # B, Hq, Hkv, S, D, causal, window
# the reference's FA_CASES (tests/test_kernels.py:21-28), then bf16 cases at
# the edges of the tensor-core kernels' tiles (128 q x 128 kv rows forward,
# 64 q x 128 kv dK/dV, 128 q x 64 kv dQ); S is (Sq, Sk) where they differ
FLASH_SMALL = [
    (2, 4, 2, 256, 64, True, None, torch.float32),
    (1, 4, 4, 128, 128, True, None, torch.float32),
    (2, 8, 2, 256, 64, True, 64, torch.float32),
    (1, 2, 1, 128, 64, False, None, torch.float32),
    (1, 4, 1, 256, 128, True, None, torch.bfloat16),
    (1, 2, 2, 128, 64, True, 32, torch.bfloat16),
    (2, 4, 2, 96, 64, True, None, torch.bfloat16),  # S not a tile multiple
    (1, 4, 2, 192, 128, True, None, torch.bfloat16),  # blocks of 64
    (1, 4, 2, (128, 384), 64, True, None, torch.bfloat16),
    (1, 4, 2, (128, 384), 128, False, None, torch.bfloat16),
    (1, 4, 2, (384, 128), 64, False, 32, torch.bfloat16),  # rows see no key
    (2, 4, 2, 256, 16, True, None, torch.bfloat16),
    (2, 4, 2, 256, 32, False, None, torch.bfloat16),
    (1, 4, 2, 256, 64, True, 20, torch.bfloat16),  # window < one tile
    (1, 4, 2, 256, 128, False, 20, torch.bfloat16),
    (1, 56, 8, 256, 128, True, None, torch.bfloat16),  # a group of 7
    (1, 4, 2, (192, 320), 64, False, None, torch.bfloat16),  # ragged q block
    (2, 4, 2, (256, 96), 128, False, None, torch.bfloat16),  # ragged kv tile
    (1, 4, 2, 320, 128, True, 100, torch.bfloat16),  # a causal window
    # the persistent forward: 320 work tiles of uneven length on 132 SMs
    (4, 16, 4, 640, 128, True, 100, torch.bfloat16),
]
# the zoo's attention shapes in training (bf16): seamless' encoder
# (non-causal, head dim 64), granite's MQA (a group of 48), gemma3's
# local layers (a causal window of 1,024 at S 4,096).  At granite's group
# dK and dV sum 48 Sq terms an element, each with the bf16 kernel's P or
# dS rounded to 8 bits on the tensor cores: an element small beside its
# key row's largest may lie a few bf16 ulps of that row from the plain
# version (0.125 at |dV| < 5.3 in a row reaching 29.8 on an NVIDIA H100
# 80GB HBM3 at 700 W, tools/flash_gqa_error.py).  So dK and dV at
# ``FLASH_EXACT`` are held, key row by key row, to the f64 sum of the same
# inputs (``within_exact``); the other cases elementwise, as the rest.
FLASH_ZOO = [
    (2, 16, 16, 1024, 64, False, None, torch.bfloat16),
    (2, 48, 1, 2048, 128, True, None, torch.bfloat16),
    (1, 32, 16, 4096, 128, True, 1024, torch.bfloat16),
]
FLASH_EXACT = {FLASH_ZOO[1]}
# |kernel - plain| <= tol * (1 + |plain|) elementwise.  Both sides take f32
# products from the same inputs: f32 differs by summation order (the
# forward at the reference's 2e-5, the gradients at its 5e-4); bf16 by the
# outputs' rounding to 8 mantissa bits.  lse is f32 on both dtypes.
FLASH_TOL = {torch.float32: {"fwd": 2e-5, "bwd": 5e-4},
             torch.bfloat16: {"fwd": 2e-2, "bwd": 2e-2}}
LSE_TOL = 2e-4
FLASH_KERNELS = {  # wrapper, source, TPU kernel it replaces
    "flash_attention_fwd": (fa.flash_attention_fwd, "flash_attention.cu",
                            "flash_attention.py:117"),
    "flash_attention_dkv": (fab.flash_attention_dkv, "flash_attention_bwd.cu",
                            "flash_attention_bwd.py:58"),
    "flash_attention_dq": (fab.flash_attention_dq, "flash_attention_bwd.cu",
                           "flash_attention_bwd.py:129"),
}


def within(name, got, want, tol):
    """Max |got - want|, raising past ``tol * (1 + |want|)`` anywhere."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    if bool((diff > tol * (1 + want.abs())).any()):
        raise AssertionError(f"{name}: max |kernel - plain| {diff.max().item()}"
                             f" past {tol} x (1 + |plain|)")
    return diff.max().item()


def exact_row_ratio(got, plain, exact):
    """The largest over key rows of the row's max |got - exact| over its
    bound, 2 x the row's max |plain - exact| + 2**-8 x its max |exact|."""
    err = (got.double() - exact).abs().amax(-1)
    bound = (2 * (plain.double() - exact).abs().amax(-1)
             + 2.0**-8 * exact.abs().amax(-1))
    return float((err / bound).max())


def within_exact(name, got, plain, exact):
    """Each key row (the last axis) of the kernel's output against the f64
    sum ``exact``: its largest error at most twice the plain version's
    largest in that row, plus one bf16 ulp of the row's largest |value|
    (2**-8 of it).  A row of zeros or garbage fails; a kernel whose
    rounding is the plain version's passes.  Returns (max |got - plain|,
    the largest row error over its bound)."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    ratio = exact_row_ratio(got, plain, exact)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: a key row lies {ratio} x its bound "
                             f"from the f64 sum (2 x plain's error + 2**-8 "
                             f"x the row's max)")
    return float((got.float() - plain.float()).abs().max()), ratio


def flash_inputs(case, gen):
    B, Hq, Hkv, S, D, causal, window, dtype = case
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    dev = torch.device("cuda")
    q, dout = (torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
               for _ in range(2))
    k, v = (torch.randn((B, Hkv, Sk, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    # the reference's largest blocks (128, then 64) that tile both sequences
    block = 128 if all(n % min(128, n) == 0 for n in (Sq, Sk)) else 64
    return q, k, v, dout, dict(causal=causal, window=window), dict(
        block_q=block, block_k=block)


def flash_check(case, gen):
    """Each kernel against its plain version on the same inputs; returns
    the max |kernel - plain| of out, lse, dk and dv, dq, and the inputs.
    dK and dV of a ``FLASH_EXACT`` case are held to their f64 sums
    (``within_exact``; the row ratios are returned too)."""
    q, k, v, dout, kw, blocks = flash_inputs(case, gen)
    tol = FLASH_TOL[case[-1]]
    name = f"flash {case}"
    out, lse = fa.flash_attention_fwd(q, k, v, **kw, **blocks)
    want_out, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    errs = {"out": within(f"{name} out", out, want_out, tol["fwd"]),
            "lse": within(f"{name} lse", lse, want_lse, LSE_TOL)}
    delta = (dout.float() * want_out.float()).sum(-1)
    args = (q, k, v, dout, want_lse, delta)
    dk, dv = fab.flash_attention_dkv(*args, **kw, **blocks)
    want_dk, want_dv = ref.flash_attention_dkv(*args, **kw)
    if case in FLASH_EXACT:
        exact = ref.flash_attention_dkv_f64(*args, **kw)
        for key, got, plain, f64 in zip(("dk", "dv"), (dk, dv),
                                        (want_dk, want_dv), exact):
            errs[key], errs[f"{key}_f64_row_ratio"] = within_exact(
                f"{name} {key}", got, plain, f64)
        del exact
    else:
        errs["dk"] = within(f"{name} dk", dk, want_dk, tol["bwd"])
        errs["dv"] = within(f"{name} dv", dv, want_dv, tol["bwd"])
    del want_dk, want_dv
    dq = fab.flash_attention_dq(*args, **kw, **blocks)
    errs["dq"] = within(f"{name} dq", dq, ref.flash_attention_dq(*args, **kw),
                        tol["bwd"])
    torch.cuda.synchronize()
    return errs, (args, kw)


def flash_bounds(case):
    """Least time per kernel: the larger of its bytes (each input read
    once, each output written once) over 3.35 TB/s and its flops over the
    dtype's peak (``cost.flash_work``: the (q, k) pairs the mask leaves
    visible, 2 * D flops per pair per product; 2 products in the forward,
    4 in dK/dV, 3 in dQ)."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    work = cost.flash_work(B, Hq, Hkv, S, S, D, causal, window, dtype)
    return {name: {**cost.bound(nbytes, flops, dtype), "flops": flops,
                   "bytes": nbytes}
            for name, (nbytes, flops) in work.items()}


def sdpa_calls(q, k, v, dout, causal):
    """The library yardstick (never on the port's path): PyTorch's
    ``scaled_dot_product_attention`` with GQA, and its autograd backward."""
    F = torch.nn.functional
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    try:
        F.scaled_dot_product_attention(q[:, :, :8], k[:, :, :8], v[:, :, :8],
                                       enable_gqa=True)
        gqa = {"enable_gqa": True}
    except TypeError:  # a PyTorch without enable_gqa: repeat the KV heads
        group = q.shape[1] // k.shape[1]
        leaves[1:] = [t.detach().repeat_interleave(group, 1).requires_grad_()
                      for t in (k, v)]
        gqa = {}

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal, **gqa)

    out = fwd()

    def bwd():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    return fwd, bwd


# each flash kernel's name in the libraries' SASS: (library, count of
# instantiations, whether its products run on the tensor cores)
FLASH_SASS = {
    "fwd_bf16_kernel": (fa.NAME, 4, True),  # D 16, 32, 64, 128
    "dkv_bf16_kernel": (fab.NAME, 4, True),
    "dq_bf16_kernel": (fab.NAME, 4, True),
    "dq_kernel": (fab.NAME, 4, False),  # f32
    "fwd_kernel": (fa.NAME, 4, False),  # f32
    "dkv_kernel": (fab.NAME, 4, False),  # f32
}
SASS_OPS = ("HGMMA", "HMMA", "FFMA")


def flash_sass():
    """``cuobjdump --dump-sass`` of the two flash libraries: every
    instantiation of the bf16 forward, dK/dV and dQ kernels issues HGMMA
    (wgmma); the f32 kernels stay SIMT (FFMA, no HGMMA or HMMA).  Returns
    the opcode counts per kernel and instantiation."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    found = {}
    for lib in sorted({lib for lib, _, _ in FLASH_SASS.values()}):
        text = subprocess.run(
            [str(tool), "--dump-sass", str(build.library_path(lib))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        for body in text.split("Function : ")[1:]:
            mangled = body.split()[0]
            m = re.search(r"\d(fwd_bf16|dkv_bf16|dq_bf16|dq|fwd|dkv)"
                          r"_kernelI(.*?)Li(\d+)E", mangled)
            if m is None:
                continue
            dtype = "float32" if m.group(2) == "f" else "bfloat16"
            found[f"{m.group(1)}_kernel<{dtype},{m.group(3)}>"] = {
                op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPS}
    for kernel, (lib, n, tensor_cores) in FLASH_SASS.items():
        mine = {k: v for k, v in found.items() if k.startswith(kernel + "<")}
        if len(mine) != n:
            raise AssertionError(f"SASS of lib{lib}: {sorted(mine)}, want {n} "
                                 f"instantiations of {kernel}")
        for name, ops in mine.items():
            on_tc = ops["HGMMA"] + ops["HMMA"] > 0
            if on_tc != tensor_cores or (not tensor_cores and not ops["FFMA"]):
                raise AssertionError(f"SASS of {name}: {ops}")
    return found


def flash_zoo(gen, flush):
    """Each ``FLASH_ZOO`` case against the plain versions, then each
    kernel's ``device_ms`` beside its bound."""
    out = {}
    for case in FLASH_ZOO:
        errs, (args, kw) = flash_check(case, gen)
        q, k, v = args[:3]
        bounds = flash_bounds(case)
        calls = {"flash_attention_fwd": lambda: fa.flash_attention_fwd(
                     q, k, v, **kw),
                 "flash_attention_dkv": lambda: fab.flash_attention_dkv(
                     *args, **kw),
                 "flash_attention_dq": lambda: fab.flash_attention_dq(
                     *args, **kw)}
        library = {}
        if kw["window"] is None:  # SDPA has no window: no same function
            sdpa_fwd, sdpa_bwd = sdpa_calls(q, k, v, args[3], kw["causal"])
            library = {"flash_attention_fwd": device_ms(sdpa_fwd, 10, flush),
                       "sdpa_backward": device_ms(sdpa_bwd, 10, flush)}
            del sdpa_fwd, sdpa_bwd
        figs = {"library_device_ms": library}
        for name, fn in calls.items():
            dev = device_ms(fn, 10, flush)
            figs[name] = {"device_ms": dev, "bound_ms": bounds[name]["bound_ms"],
                          "bound_by": bounds[name]["bound_by"],
                          "bound_share": bounds[name]["bound_ms"] / dev,
                          "tflops": bounds[name]["flops"] / dev / 1e9}
        out[str(case[:-1])] = {"max_abs_err": errs, "kernels": figs}
        del args, q, k, v, calls
        torch.cuda.empty_cache()
    return out


def flash_phase():
    """Returns the training-shape bf16 figures per kernel."""
    sass = flash_sass()
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    small = {}
    for case in FLASH_SMALL:
        errs, _ = flash_check(case, gen)
        small[str(case[:-1] + (str(case[-1]).split(".")[-1],))] = errs
    zoo = flash_zoo(gen, flush)
    figures = {}
    for dtype in (torch.bfloat16, torch.float32):
        case = TRAIN_SHAPE + (dtype,)
        errs, (args, kw) = flash_check(case, gen)
        q, k, v, dout, lse, delta = args
        bounds = flash_bounds(case)
        calls = {
            "flash_attention_fwd": (
                lambda: fa.flash_attention_fwd(q, k, v, **kw),
                lambda: ref.flash_attention_fwd(q, k, v, **kw), ("out", "lse")),
            "flash_attention_dkv": (
                lambda: fab.flash_attention_dkv(*args, **kw),
                lambda: ref.flash_attention_dkv(*args, **kw), ("dk", "dv")),
            "flash_attention_dq": (
                lambda: fab.flash_attention_dq(*args, **kw),
                lambda: ref.flash_attention_dq(*args, **kw), ("dq",)),
        }
        sdpa_fwd, sdpa_bwd = sdpa_calls(q, k, v, dout, kw["causal"])
        library = {"flash_attention_fwd": cuda_time_ms(sdpa_fwd, 10, flush)}
        library["flash_attention_dkv"] = library["flash_attention_dq"] = (
            cuda_time_ms(sdpa_bwd, 10, flush))
        # the same calls with the host's enqueue kept out (device_ms)
        library_dev = {"flash_attention_fwd": device_ms(sdpa_fwd, 10, flush)}
        library_dev["flash_attention_dkv"] = library_dev[
            "flash_attention_dq"] = device_ms(sdpa_bwd, 10, flush)
        for name, (kern, plain, keys) in calls.items():
            dev = device_ms(kern, 10, flush)
            figures.setdefault(str(dtype).split(".")[-1], {})[name] = {
                "max_abs_err": max(errs[key] for key in keys),
                "ms": cuda_time_ms(kern, 10, flush), "device_ms": dev,
                "plain_ms": cuda_time_ms(plain, 3, flush),
                "library_ms": library[name],
                "library_device_ms": library_dev[name], **bounds[name],
                "us": 1e3 * dev, "tflops": bounds[name]["flops"] / dev / 1e9,
                "bound_share": bounds[name]["bound_ms"] / dev,
            }
        del args, q, k, v, dout, lse, delta, calls, sdpa_fwd, sdpa_bwd
        torch.cuda.empty_cache()
    B, Hq, Hkv, S, D, causal, _ = TRAIN_SHAPE
    bf16 = figures["bfloat16"]
    backward = {  # the two backward kernels against SDPA's whole backward
        "dkv_plus_dq_device_ms": bf16["flash_attention_dkv"]["device_ms"]
        + bf16["flash_attention_dq"]["device_ms"],
        "sdpa_backward_device_ms": bf16["flash_attention_dq"][
            "library_device_ms"]}
    emit({"phase": "flash", "shape": {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S,
                                      "D": D, "causal": causal},
          "tol": {str(d).split(".")[-1]: t for d, t in FLASH_TOL.items()},
          "lse_tol": LSE_TOL, "small_cases": small, "train_shape": figures,
          "zoo_cases": zoo,
          "bf16_backward": backward, "sass": sass,
          "library": "scaled_dot_product_attention(enable_gqa=True): forward; "
                     "its autograd backward (dq, dk, dv in one call) for the "
                     "dK/dV and dQ rows"})
    return bf16


# --------------------------------------------------------------------------- #
# training: qwen3-4b at full width and depth through Trainer
# --------------------------------------------------------------------------- #
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP = 2, 2048, 6, 2
TRAIN_LR = 1e-3
STEP0_LOSS = (11.0, 14.0)  # ln(151936) = 11.93, plus the logits' spread


def train_launches(n_layers):
    """Launches per step under full remat: the forward kernel runs in each
    layer's forward and again in its recompute; dK/dV and dQ once each."""
    return {"flash_attention_fwd": 2 * n_layers,
            "flash_attention_dkv": n_layers, "flash_attention_dq": n_layers}


GEMM_NAMES = ("nvjet", "gemm", "xmma", "cutlass")  # cuBLAS kernel names


def profile_call(fn, own_key="flash_ms", own_tag="flash::"):
    """One call of ``fn`` under ``torch.profiler``: device busy time (the
    sum of its GPU kernels' durations, one stream), the wall clock, the
    device time of the port's own kernels (names holding ``own_tag``), of
    cuBLAS matrix products and of the rest, and the kernels that took the
    most device time.  Device figures are null when the profiler saw no
    GPU kernel."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ])
    torch.cuda.synchronize()
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, n = {}, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n += 1
        by_name[evt.name] = by_name.get(evt.name, 0.0) + (
            evt.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    split = {own_key: 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    for name, ms in by_name.items():
        key = (own_key if own_tag in name else "gemm_ms"
               if any(g in name.lower() for g in GEMM_NAMES) else "other_ms")
        split[key] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": 1e3 * wall, "kernels": n if n else None,
            "device_busy_ms": busy if n else None,
            "device_busy_share": busy / (1e3 * wall) if n else None,
            **{k: (v if n else None) for k, v in split.items()},
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def profile_train_step(step_fn, params, opt_state, batch):
    """One training step under ``torch.profiler`` (``profile_call``)."""

    def step():
        _, _, m = step_fn(params, opt_state, batch)
        float(m["loss"])

    return profile_call(step)


def train_phase():
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS["qwen3-4b"]
    model, ctx = build_model(cfg), RunCtx(remat="full")
    opt = adamw.AdamWConfig(
        lr=TRAIN_LR, weight_decay=0.0,
        schedule=adamw.warmup_cosine(TRAIN_LR, max(TRAIN_STEPS // 20, 1),
                                     TRAIN_STEPS))
    trainer = Trainer(model, ctx, opt, TrainerConfig(
        steps=TRAIN_STEPS, ga_steps=1, log_every=1, ckpt_every=0))
    t0 = time.perf_counter()
    params, opt_state = trainer.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    loader = Loader(SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0),
                    device="cuda")
    step_fn = trainer.make_train_step()  # the step run() drives
    try:
        reset_counts(FLASH_KERNELS)  # the main path starts here
        params, opt_state, history = trainer.run(params, opt_state, loader)
        launches = counts(FLASH_KERNELS)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        profile = profile_train_step(step_fn, params, opt_state, next(loader))
    finally:
        loader.close()
    want = {k: v * TRAIN_STEPS for k, v in train_launches(cfg.n_layers).items()}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(history) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train: losses {losses}, grad norms {norms}")
    if not STEP0_LOSS[0] <= losses[0] <= STEP0_LOSS[1]:
        raise AssertionError(f"train: step-0 loss {losses[0]} outside "
                             f"{STEP0_LOSS}")
    step_ms = [1e3 * h["step_time_s"] for h in history]
    median_ms = float(np.median(step_ms[TRAIN_WARMUP:]))
    emit({
        "phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "params": n_params, "dtype": "bfloat16",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": ctx.remat,
        "steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP, "losses": losses,
        "grad_norms": norms, "lrs": [h["lr"] for h in history],
        "step0_loss": losses[0], "step_ms": step_ms,
        "step_ms_median": median_ms,
        "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
        "peak_gib": peak_gib, "init_s": init_s, "launches": launches,
        "launches_per_step": train_launches(cfg.n_layers),
        "profile_step": profile,
    })
    return launches


# --------------------------------------------------------------------------- #
# the scans (csrc/ssm_scan.cu, csrc/rglru.cu)
# --------------------------------------------------------------------------- #
# (B, S, Di, N): falcon-mamba's prefill at full width (B 1 is the serving
# path's: one request per prefill), an odd S, the reference's small shapes
SSM_FULL = [(1, 512, 8192, 16), (4, 512, 8192, 16)]
SSM_OTHER = [(2, 77, 8192, 16), (2, 128, 256, 16), (1, 64, 512, 16),
             (2, 96, 128, 8)]
# (B, S, W): recurrentgemma's prefill at full width, odd S, small shapes
LRU_FULL = [(1, 2560, 4096), (4, 2560, 4096)]
LRU_OTHER = [(2, 77, 4096), (2, 128, 256), (1, 64, 512)]
# |kernel - plain| <= tol * (1 + |plain|).  f32: the selective scan's
# exponential is ex2.approx (~2^-22 relative) and its state update one
# fused multiply-add, its sum of C.h over N in another order (the RG-LRU
# scan rounds as the plain version does and equals it); bf16: the outputs'
# rounding to 8 mantissa bits.  The final state is f32 on both dtypes.
SCAN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SCAN_KERNELS = {  # wrapper, source, TPU kernel it replaces
    "selective_scan": (ssm_scan.selective_scan, "ssm_scan.cu",
                       "ssm_scan.py:73"),
    "gated_linear_scan": (rglru.gated_linear_scan, "rglru.cu", "rglru.py:49"),
}


def ssm_inputs(case, dtype, gen):
    """The model's value ranges: dt = softplus(.) log-uniform in [1e-3,
    1e-1], A = -(1..N) per channel; B and C strided views of one
    (B, S, R + 2N) projection, as the layer slices them."""
    B, S, Di, N = case
    dev = torch.device("cuda")
    x = torch.randn((B, S, Di), generator=gen, device=dev).to(dtype)
    u = torch.rand((B, S, Di), generator=gen, device=dev)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(Di, 1)
    dbc = torch.randn((B, S, 256 + 2 * N), generator=gen, device=dev).to(dtype)
    d = torch.ones((Di,), device=dev)
    return x, dt, a, dbc[..., 256:256 + N], dbc[..., 256 + N:], d


def lru_inputs(case, dtype, gen):
    """a in [0.1, 0.99] (the RG-LRU's decay range), b of order one."""
    dev = torch.device("cuda")
    a = 0.1 + 0.89 * torch.rand(case, generator=gen, device=dev)
    b = torch.randn(case, generator=gen, device=dev)
    return a.to(dtype), b.to(dtype)


def scan_bounds(name, case, dtype):
    """Least time: bytes (each input read once, each output written once)
    over 3.35 TB/s, or f32 operations over 67 TFLOP/s (the arithmetic is
    f32 on both dtypes; ``cost.scan_work``)."""
    nbytes, flops = cost.scan_work(name, case, dtype)
    return {**cost.bound(nbytes, flops, torch.float32), "bytes": nbytes,
            "flops": flops}


def sm_clock_mhz():
    """The card's maximum SM clock, MHz, as ``nvidia-smi`` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.split()[0])


# Hopper's special-function units return 16 exponentials a clock per SM
SFU_PER_CLOCK = 16


def scan_sfu_floor(name, case, clock_mhz):
    """Least time for the scan's exponentials on the special-function
    units: one per (b, t, channel, state) for the selective scan, none for
    the RG-LRU scan; over the SMs x 16 a clock x the maximum SM clock."""
    exps = math.prod(case) if name == "selective_scan" else 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sfu_floor_ms": 1e3 * exps / (sms * SFU_PER_CLOCK
                                         * clock_mhz * 1e6),
            "exponentials": exps, "sm_clock_mhz": clock_mhz}


def scan_phase():
    """Each scan against its plain version on every case and dtype; times
    at the full-width cases, by ``device_ms`` (``ms``) and by events
    around one call (``events_ms``), L2 flushed, beside the bound and the
    special-function floor.  Returns the serving path's figures per kernel
    (falcon B 1 bf16; recurrentgemma B 1 f32, the model's a and b)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    clock = sm_clock_mhz()
    checked, figures = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case in SSM_FULL + SSM_OTHER:
            args = ssm_inputs(case, dtype, gen)
            y, h = ssm_scan.selective_scan(*args, final_state=True)
            want_y = ref.selective_scan(*args)
            want_h = ref.mamba_final_state(*args[:4])
            torch.cuda.synchronize()
            errs = {"y": within(f"selective_scan {case} {dname} y", y, want_y,
                                SCAN_TOL[dtype]),
                    "h": within(f"selective_scan {case} {dname} h", h, want_h,
                                SCAN_TOL[torch.float32])}
            checked[f"selective_scan {case} {dname}"] = errs
            if case in SSM_FULL:
                def call():
                    return ssm_scan.selective_scan(*args, final_state=True)

                figures.setdefault("selective_scan", {})[f"{case} {dname}"] = {
                    "max_abs_err": max(errs.values()),
                    "ms": device_ms(call, 20, flush),
                    "events_ms": cuda_time_ms(call, 20, flush),
                    "plain_ms": cuda_time_ms(lambda: (
                        ref.selective_scan(*args),
                        ref.mamba_final_state(*args[:4])), 2, flush),
                    "library_ms": None,
                    **scan_bounds("selective_scan", case, dtype),
                    **scan_sfu_floor("selective_scan", case, clock)}
            del args, y, h, want_y, want_h
        for case in LRU_FULL + LRU_OTHER:
            a, b = lru_inputs(case, dtype, gen)
            err = within(f"gated_linear_scan {case} {dname}",
                         rglru.gated_linear_scan(a, b),
                         ref.gated_linear_scan(a, b), SCAN_TOL[dtype])
            checked[f"gated_linear_scan {case} {dname}"] = {"y": err}
            if case in LRU_FULL:
                figures.setdefault("gated_linear_scan", {})[
                    f"{case} {dname}"] = {
                    "max_abs_err": err,
                    "ms": device_ms(lambda: rglru.gated_linear_scan(a, b), 20,
                                    flush),
                    "events_ms": cuda_time_ms(
                        lambda: rglru.gated_linear_scan(a, b), 20, flush),
                    "plain_ms": cuda_time_ms(
                        lambda: ref.gated_linear_scan(a, b), 2, flush),
                    "library_ms": None,
                    **scan_bounds("gated_linear_scan", case, dtype),
                    **scan_sfu_floor("gated_linear_scan", case, clock)}
            del a, b
    torch.cuda.empty_cache()
    emit({"phase": "scan", "tol": {str(d).split(".")[-1]: t
                                   for d, t in SCAN_TOL.items()},
          "checked": checked, "full_width": figures,
          "library": "none: no single PyTorch call computes either scan"})
    return {"selective_scan": figures["selective_scan"][
                f"{SSM_FULL[0]} bfloat16"],
            "gated_linear_scan": figures["gated_linear_scan"][
                f"{LRU_FULL[0]} float32"]}


# --------------------------------------------------------------------------- #
# serving falcon-mamba-7b and recurrentgemma-9b at full width and depth
# --------------------------------------------------------------------------- #
# f32 at full width on a few layers: prefill of S + j tokens against prefill
# of S and j decode steps.  The two paths run the same f32 arithmetic in
# another order (the scan kernel against the closed-form step, cuBLAS
# products of other shapes); summation-order noise of ~1e-6 relative per
# layer leaves 100x headroom under 1e-3 of the largest |logit|.
CONSIST_REL_TOL = 1e-3
CONSIST_STEPS = 4
RECURRENT_SERVING = {
    # arch: (scan kind, requests, prompt, new tokens, batch, cache_len,
    #        (f32 consistency layers, its prompt))
    "falcon-mamba-7b": ("mamba", 16, 512, 64, 8, 1024, (2, 512)),
    "recurrentgemma-9b": ("rec", 8, 2560, 64, 4, 4096, (3, 2060)),
}


class RecordingServer(Server):
    """The dense ``Server``, keeping each decode step's wall time (the step
    ends in a synchronize) and whether every step's logits were finite."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.step_s, self.all_finite = [], True
        decode = self._decode

        def timed(*args):
            t0 = time.perf_counter()
            out = decode(*args)
            torch.cuda.synchronize()
            self.step_s.append(time.perf_counter() - t0)
            return out

        self._decode = timed

    def _advance(self, live, logits):
        self.all_finite &= bool(np.isfinite(logits[live]).all())
        super()._advance(live, logits)


def consistency(model, ctx, params, S, steps, cache_len, gen):
    """Two rows of S + steps tokens: the logits of prefill(S + j) against
    those of prefill(S) followed by j decode steps, j = 1..steps.  Returns
    the max |difference|, the max |logit| and the share of (row, step)
    whose top token agrees."""
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab, (2, S + steps), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    logits, caches = model.prefill(params, ctx, {"inputs": toks[:, :S]},
                                   cache_len)
    diff, scale, agree = 0.0, 0.0, 0
    for j in range(steps):
        logits, caches = model.decode_step(
            params, ctx, toks[:, S + j:S + j + 1],
            torch.full((2,), S + j, dtype=torch.int32, device="cuda"), caches)
        want, _ = model.prefill(params, ctx, {"inputs": toks[:, :S + j + 1]},
                                cache_len)
        got, want = logits.float(), want.float()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{cfg.name}: non-finite logits")
        diff = max(diff, float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    return diff, scale, agree / (2 * steps)


def profile_serving(model, ctx, params, batch, prompt_len, cache_len, gen,
                    kind):
    """Apart from the measured run: one prefill of one prompt (the
    served shape) and one decode step of a full batch at that depth,
    each warmed once, under ``torch.profiler``."""
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len + 2), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    tag = "ssm_scan_kernel" if kind == "mamba" else "rglru_kernel"

    def prefill():
        model.prefill(params, ctx, {"inputs": toks[:1, :prompt_len]},
                      cache_len)

    _, caches = model.prefill(params, ctx, {"inputs": toks[:, :prompt_len]},
                              cache_len)
    pos = torch.full((batch,), prompt_len, dtype=torch.int32, device="cuda")

    def decode():
        model.decode_step(params, ctx, toks[:, prompt_len:prompt_len + 1],
                          pos, caches)

    out = {}
    for name, fn in (("prefill", prefill), ("decode_step", decode)):
        fn()  # warm (decode rewrites the same position: same work)
        out[name] = profile_call(fn, "scan_ms", tag)
    del caches
    return out


def serve_recurrent_phase(arch):
    """One recurrent arch at full width and depth through ``Server``, then
    the prefill/decode consistency checks.  Returns the scan kernel's
    launches in the served run."""
    kind, n_req, prompt_len, max_new, batch, cache_len, (f32_layers, f32_S) = (
        RECURRENT_SERVING[arch])
    wrapper = (ssm_scan.selective_scan if kind == "mamba"
               else rglru.gated_linear_scan)
    cfg = ARCHS[arch]
    model, ctx = build_model(cfg), RunCtx()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(ctx, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    server = RecordingServer(model, ctx, params, batch, cache_len,
                             device="cuda")
    for rid in range(n_req):
        server.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, size=prompt_len).tolist(), max_new=max_new))
    torch.cuda.reset_peak_memory_stats()
    wrapper.launches = 0  # the main path starts here
    stats = server.run_until_drained()
    launches = wrapper.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    want = cfg.layer_kinds().count(kind) * n_req
    if launches != want:
        raise AssertionError(f"{arch}: {wrapper.__name__} launched {launches} "
                             f"times, want {want} (one per {kind} layer per "
                             "prefill)")
    outs = {r.rid: r.out for r in server.finished}
    if sorted(outs) != list(range(n_req)) or any(
            len(o) != max_new for o in outs.values()):
        raise AssertionError(f"{arch}: finished {sorted(outs)}, lengths "
                             f"{sorted({len(o) for o in outs.values()})}")
    if not server.all_finite or any(
            not 0 <= t < cfg.vocab for o in outs.values() for t in o):
        raise AssertionError(f"{arch}: non-finite logits or tokens out of range")
    step_s = server.step_s
    gen = torch.Generator(device="cuda").manual_seed(1)
    profile = profile_serving(model, ctx, params, batch, prompt_len,
                              cache_len, gen, kind)
    bf16 = consistency(model, ctx, params, prompt_len, CONSIST_STEPS,
                       cache_len, gen)
    del server, params  # the server's decode closure holds it in a cycle
    pygc.collect()
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=f32_layers, dtype=torch.float32)
    smodel = build_model(small)
    sparams = smodel.init(ctx, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    f32 = consistency(smodel, ctx, sparams, f32_S, CONSIST_STEPS, cache_len,
                      gen)
    del sparams
    torch.cuda.empty_cache()
    if f32[0] > CONSIST_REL_TOL * f32[1]:
        raise AssertionError(
            f"{arch} f32 x {f32_layers} layers: prefill and prefill + decode "
            f"differ by {f32[0]} (> {CONSIST_REL_TOL} x max |logit| {f32[1]})")
    emit({
        "phase": "serve_" + arch.split("-")[0], "arch": arch,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "params": n_params,
        "dtype": "bfloat16", "batch": batch, "cache_len": cache_len,
        "prompt_len": prompt_len, "max_new": max_new,
        "requests": stats["requests"], "decoded_tokens": stats["decoded_tokens"],
        "tok_per_s": stats["tok_per_s"], "p50_latency_s": stats["p50_latency_s"],
        "p50_ttft_s": stats["p50_ttft_s"], "wall_s": stats["wall_s"],
        "decode_steps": len(step_s),
        "decode_step_ms_median": 1e3 * float(np.median(step_s)),
        "decode_step_ms_mean": 1e3 * float(np.mean(step_s)),
        "peak_device_mem_gib": peak_gib, "init_s": init_s,
        "scan_launches": launches, "scan_launches_expected": want,
        "profile": profile,
        "consistency_bf16_full_depth": {
            "prompt": prompt_len, "steps": CONSIST_STEPS,
            "max_abs_logit_diff": bf16[0], "max_abs_logit": bf16[1],
            "top1_agreement": bf16[2]},
        "consistency_f32": {
            "layers": f32_layers, "prompt": f32_S, "steps": CONSIST_STEPS,
            "max_abs_logit_diff": f32[0], "max_abs_logit": f32[1],
            "rel_tol": CONSIST_REL_TOL, "top1_agreement": f32[2]},
    })
    return launches


# --------------------------------------------------------------------------- #
# the MoE router (csrc/moe_router.cu)
# --------------------------------------------------------------------------- #
ROUTER_ARCHS = ("kimi-k2-1t-a32b", "arctic-480b")  # E 384, K 8; E 128, K 2
ROUTER_T = (8, 128, 8192)  # a decode batch, a prefill, a long prefill
ROUTER_OTHER_T = (1, 77)
# (T, E, K, capacity): the reference's four cases (tests/test_kernels.py)
ROUTER_REF_CASES = [(512, 16, 2, 80), (256, 8, 1, 64), (512, 64, 8, 72),
                    (256, 128, 2, 8)]
# (T, E, K): E 256 and E 1024, the kernel's 8 and 32 experts per lane,
# which no served arch reaches; K 32 is the kernel's largest
ROUTER_WIDE_CASES = [(77, 256, 8), (8192, 256, 8), (128, 1024, 8),
                     (77, 1024, 32), (8192, 1024, 8)]
# weights: the probabilities are bit-equal (the kernel sums as torch's warp
# softmax does); the renormalising sum over K may round apart
ROUTER_W_TOL = 1e-6
ROUTER_KERNELS = {"moe_router": (mr.moe_router, "moe_router.cu",
                                 "moe_dispatch.py:103")}


def router_check(name, logits, k, capacity, renormalize=True):
    """The kernel against the plain version on the same logits: indices,
    slots and keep equal, weights within ``ROUTER_W_TOL``.  Returns the
    max |weight difference|."""
    got = mr.unpack(*mr.moe_router(logits, k=k, capacity=capacity,
                                   renormalize=renormalize))
    want = ref.route_topk(logits, k=k, capacity=capacity,
                          renormalize=renormalize)
    torch.cuda.synchronize()
    for part, i in (("expert_idx", 0), ("slot", 1), ("keep", 3)):
        g, w = got[i], want[i]
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{name}: {part} differs at {bad} places")
    err = float((got[2] - want[2]).abs().max())
    if not err <= ROUTER_W_TOL:
        raise AssertionError(f"{name}: weights differ by {err}")
    return err


def router_kernels_per_call(fn, calls=3, tries=5):
    """Device kernels per call of ``fn`` under ``torch.profiler`` over
    ``calls`` calls: (those named ``moe_router_*``, all).  The profiler
    drops kernel records now and then (a whole session's once, one of
    three another time), so each session first runs 64 empty kernels and
    a session that saw fewer ``moe_router_*`` kernels than calls is tried
    again, up to ``tries`` sessions; the first that saw at least one a
    call counts."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [evt.name for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA]
        own = sum("moe_router_" in name for name in names)
        every = len(names) - sum("spin_kernel" in name for name in names)
        if own >= calls:
            return own / calls, every / calls
        seen.append((own, len(names)))
    raise AssertionError(f"the profiler saw fewer moe_router_* kernels than "
                         f"calls in {tries} sessions: (moe_router_*, all "
                         f"device records) {seen} for {calls} calls")


def router_one_launch(name, logits, k, capacity, renormalize=True):
    """The kernel against the plain version (``router_check``), then
    exactly one device kernel named ``moe_router_*`` per call."""
    err = router_check(name, logits, k, capacity, renormalize)
    own, _ = router_kernels_per_call(lambda: mr.moe_router(
        logits, k=k, capacity=capacity, renormalize=renormalize))
    if own != 1:
        raise AssertionError(f"{name}: {own} moe_router_* kernels a call")
    return err


def router_logits(T, E, gen, ties=False):
    """Normal logits (the model's router logits are of order one); with
    ``ties``, rounded to halves and every fourth row constant."""
    x = torch.randn((T, E), generator=gen, device="cuda")
    if ties:
        x = torch.round(x * 2) / 2
        x[::4] = 0.5
    return x


def router_bounds(T, E, K):
    """Least time: the logits read once and 13 bytes written per choice
    over 3.35 TB/s, or the f32 operations over 67 TFLOP/s
    (``cost.router_work``)."""
    nbytes, flops = cost.router_work(T, E, K)
    return {**cost.bound(nbytes, flops, torch.float32), "bytes": nbytes,
            "flops": flops}


def router_phase():
    """The kernel against its plain version on every case, each call one
    ``moe_router_*`` kernel by the profiler; times at the served widths:
    device time (CUDA events, ``device_ms``), and the host's enqueue per
    call.  ``ms`` leaves the logits in L2, as the model's router finds
    them straight after the product that wrote them; ``ms_l2_flushed``
    reads them from HBM, as the bound assumes; ``launch_floor_ms`` is an
    empty kernel timed the same way.  Returns kimi-k2's prefill figures
    (T 128)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    empty = lambda: torch.cuda._sleep(0)  # noqa: E731
    floor_ms = device_ms(empty, 50)
    floor_flushed_ms = device_ms(empty, 50, flush)
    sms, max_cluster = mr.card(torch.cuda.current_device())
    one_cta, cluster = mr.regime_edges(max_cluster)
    plans = {}
    checked, figures = {}, {}
    for arch in ROUTER_ARCHS:
        cfg = ARCHS[arch]
        E, K = cfg.n_experts, cfg.top_k
        for T in ROUTER_T:
            x = router_logits(T, E, gen)
            cap = moe_layers.moe_capacity(cfg, T)
            name = f"E{E} K{K} T{T}"
            err = router_one_launch(name, x, K, cap)
            checked[name] = err
            kernel = lambda: mr.moe_router(x, k=K, capacity=cap)  # noqa: E731
            plain = lambda: ref.route_topk(x, k=K, capacity=cap)  # noqa: E731
            figures[name] = {
                "arch": arch, "capacity": cap, "max_abs_err": err,
                "plan": mr.plan(T, sms, max_cluster)._asdict(),
                "ms": device_ms(kernel, 50),
                "ms_l2_flushed": device_ms(kernel, 50, flush),
                "launch_floor_ms": floor_ms,
                "launch_floor_ms_l2_flushed": floor_flushed_ms,
                "plain_ms": device_ms(plain, 10),
                "host_us": host_us(kernel), "plain_host_us": host_us(plain, 10),
                "library_ms": None, **router_bounds(T, E, K)}
        # (T, ties, renormalize): a lone token, a ragged block, no
        # renormalisation, repeated logits across one and many blocks, and
        # the plans' edges: the largest T of one CTA and of one cluster on
        # this card, one token past each, and the grid's step from 16-warp
        # to 32-warp CTAs
        extra = [(t, False, rn) for t in ROUTER_OTHER_T for rn in (True, False)]
        extra += [(t, True, True) for t in (77, 128, 8192)]
        extra += [(t, ties, True) for t in (one_cta, one_cta + 1, cluster,
                                            cluster + 1, mr.GRID_WARPS * sms,
                                            mr.GRID_WARPS * sms + 1)
                  for ties in (False, True)]
        for T, ties, renormalize in extra:
            tag = f"E{E} K{K} T{T} ties={ties} renormalize={renormalize}"
            plans[T] = mr.plan(T, sms, max_cluster)._asdict()
            checked[tag] = router_one_launch(
                tag, router_logits(T, E, gen, ties), K,
                moe_layers.moe_capacity(cfg, T), renormalize)
    for T, E, K, C in ROUTER_REF_CASES:
        for ties in (False, True):
            tag = f"E{E} K{K} T{T} C{C} ties={ties}"
            checked[tag] = router_one_launch(
                tag, router_logits(T, E, gen, ties), K, C)
    for T, E, K in ROUTER_WIDE_CASES:
        C = max(4, -(-T * K * 5 // (4 * E)))  # ceil(T K 1.25 / E)
        for ties in (False, True):
            tag = f"E{E} K{K} T{T} C{C} ties={ties}"
            checked[tag] = router_one_launch(
                tag, router_logits(T, E, gen, ties), K, C)
    emit({"phase": "router", "name": mr.NAME, "weight_tol": ROUTER_W_TOL,
          "sms": sms, "max_cluster": max_cluster,
          "plan_edges": {"one_cta": one_cta, "cluster": cluster},
          "edge_plans": plans, "checked": checked,
          "kernels_per_call": "1 moe_router_* kernel in every checked call",
          "served": figures,
          "library": "none: no single PyTorch call computes the router"})
    return figures["E384 K8 T128"]


# --------------------------------------------------------------------------- #
# serving kimi-k2-1t-a32b and arctic-480b at full width, two layers
# --------------------------------------------------------------------------- #
# 2 layers at full width: kimi-k2's dense layer and one moe layer hold
# 19.92 B parameters (39.8 GB in bf16), arctic's two moe layers 27.68 B
# (55.4 GB); a third kimi layer would need ~74 GB of the card's 80
MOE_LAYERS = 2


class OpLog:
    """While installed, ``ops.<name>`` passes through and, while ``on``,
    keeps ``record(out, *args, **kwargs)`` of each call (no launch of its
    own)."""

    def __init__(self, name, record, on=False):
        self.name, self.record, self.on, self.calls = name, record, on, []
        self.real = getattr(ops, name)

    def __enter__(self):
        def logged(*a, **kw):
            out = self.real(*a, **kw)
            if self.on:
                self.calls.append(self.record(out, *a, **kw))
            return out

        setattr(ops, self.name, logged)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.real)


def route_record(out, logits, *, k, capacity, renormalize=True):
    """A router call's inputs and expert choices: (logits, k, capacity,
    renormalize, expert_idx)."""
    return logits.clone(), k, capacity, renormalize, out[0].clone()


def attn_record(out, q, k_pages, v_pages, page_table, lengths, *, scale=None):
    """A paged-attention call's inputs, copied (later steps write the
    pool): ((q, k_pages, v_pages, page_table, lengths), scale)."""
    args = (q, k_pages, v_pages, page_table, lengths)
    return tuple(t.clone() for t in args), scale


def log_first_call(fn, *logs):
    """``fn``, with ``logs`` on during its first call only."""
    first_call = [True]

    def first(*a):
        for log in logs:
            log.on = first_call[0]
        first_call[0] = False
        try:
            return fn(*a)
        finally:
            for log in logs:
                log.on = False
    return first


def routing_agreement(dense_calls, paged_calls, k):
    """The first decode step's ``moe`` layers, dense server against paged.
    Returns per row whether every layer chose the same set of experts in
    both; at each row that chose apart, the dense path's gap between its
    k-th and (k+1)-th router probability in the first layer that did (a
    near tie that bf16-level differences of the attention flip); and per
    layer the max |router logit difference| on the rows that routed alike
    in every earlier layer (all rows in the first ``moe`` layer: its
    logits are continuous in the attention's outputs), with their count
    and the max |router logit|."""
    same, gaps, logit_diffs = None, [], []
    for dense, paged in zip(dense_calls, paged_calls):
        dl, pl = dense[0].float().cpu(), paged[0].float().cpu()
        rows = torch.ones(dl.shape[0], dtype=torch.bool) if same is None \
            else same
        logit_diffs.append({
            "rows": int(rows.sum()),
            "max_abs_diff": float((dl - pl)[rows].abs().max())
            if rows.any() else 0.0,
            "max_abs": float(dl.abs().max())})
        de, pe = dense[-1].cpu(), paged[-1].cpu()
        agree = (de.sort(-1).values == pe.sort(-1).values).all(-1)
        p = torch.softmax(dl, -1).sort(-1, descending=True).values
        gap = p[:, k - 1] - p[:, k]
        for r in torch.nonzero(~agree).flatten().tolist():
            if same is None or same[r]:
                gaps.append(float(gap[r]))
        same = agree if same is None else same & agree
    return same.numpy(), gaps, logit_diffs


def capture_router_calls(model, ctx, params, toks):
    """The router's calls on the served model while one prompt prefills
    (T = its length), a batch prefills (T = batch x length) and that batch
    decodes one step (T = batch)."""
    S = toks.shape[1] - 1
    with OpLog("moe_router", route_record, on=True) as log:
        model.prefill(params, ctx, {"inputs": toks[:1, :S]}, CACHE_LEN)
        _, caches = model.prefill(params, ctx, {"inputs": toks[:, :S]},
                                  CACHE_LEN)
        model.decode_step(params, ctx, toks[:, S:], torch.full(
            (toks.shape[0],), S, dtype=torch.int32, device="cuda"), caches)
    return log.calls


def serve_moe_phase(arch):
    """One MoE arch at full width on ``MOE_LAYERS`` layers through
    ``PagedServer`` (slice 1's traffic), the dense ``Server`` beside it.
    Returns the router's launches in the served run."""
    cfg = dataclasses.replace(ARCHS[arch], n_layers=MOE_LAYERS)
    n_moe = cfg.layer_kinds().count("moe")
    model, ctx = build_model(cfg), RunCtx()
    pygc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(ctx, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))

    dense = Server(model, ctx, params, BATCH, CACHE_LEN, device="cuda")
    dense_logits, decode = [], dense._decode

    def recording_decode(*a):
        logits, caches = decode(*a)
        if not dense_logits:
            dense_logits.append(logits.float().cpu().numpy())
        return logits, caches

    dense_log = OpLog("moe_router", route_record)
    paged_log = OpLog("moe_router", route_record)
    attn_log = OpLog("paged_attention", attn_record)
    dense._decode = log_first_call(recording_decode, dense_log)
    for r in requests(cfg.vocab):
        dense.submit(r)
    with dense_log:
        dense_stats = dense.run_until_drained()
    dense_out = {r.rid: r.out for r in dense.finished}
    del dense, decode, recording_decode

    server = RecordingPagedServer(model, ctx, params, BATCH, CACHE_LEN,
                                  device="cuda", page_tokens=PAGE_TOKENS)
    prefills, prefill_one = [0], server._prefill_one

    def counted_prefill(*a):
        prefills[0] += 1
        return prefill_one(*a)

    server._prefill_one = counted_prefill
    server._decode_paged = log_first_call(server._decode_paged, paged_log,
                                          attn_log)
    for r in requests(cfg.vocab):
        server.submit(r)
    torch.cuda.reset_peak_memory_stats()
    with paged_log, attn_log:
        mr.moe_router.launches = 0  # the main path starts here
        stats = server.run_until_drained()
        launches = mr.moe_router.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    outs = {r.rid: r.out for r in server.finished}
    if sorted(outs) != list(range(N_REQ)) or any(
            len(o) != MAX_NEW for o in outs.values()):
        raise AssertionError(f"{arch}: finished {sorted(outs)}, lengths "
                             f"{sorted({len(o) for o in outs.values()})}")
    if not server.all_finite or any(
            not 0 <= t < cfg.vocab for o in outs.values() for t in o):
        raise AssertionError(f"{arch}: non-finite logits or tokens out of range")
    steps = server.paged_decode_steps
    calls = prefills[0] + steps
    if launches != n_moe * calls or steps == 0:
        raise AssertionError(
            f"{arch}: moe_router launched {launches} times in {prefills[0]} "
            f"prefills + {steps} decode steps; want {n_moe} per call")
    first_p, first_d = server.first_logits, dense_logits[0]
    if first_p.shape != (BATCH, cfg.vocab) or first_d.shape != first_p.shape:
        raise AssertionError(f"{arch}: logits shapes {first_p.shape}, "
                             f"{first_d.shape}")
    if len(dense_log.calls) != n_moe or len(paged_log.calls) != n_moe:
        raise AssertionError(f"{arch}: {len(dense_log.calls)} and "
                             f"{len(paged_log.calls)} router calls logged in "
                             f"the first decode step, want {n_moe}")
    # the paged-attention kernel at this arch's head shape, on every row
    # of the served step's own inputs (shared prefix pages included)
    if len(attn_log.calls) != cfg.n_layers:
        raise AssertionError(f"{arch}: {len(attn_log.calls)} paged attention "
                             f"calls logged in the first decode step, want "
                             f"{cfg.n_layers}")
    served_attn = [paged_check(f"{arch} served paged_attention layer {i}",
                               *args, scale=scale, relative=True)
                   for i, (args, scale) in enumerate(attn_log.calls)]
    attn_shape = {"Hq": int(attn_log.calls[0][0][0].shape[1]),
                  "Hkv": int(attn_log.calls[0][0][1].shape[2]),
                  "lengths": attn_log.calls[0][0][4].tolist()}
    del attn_log
    # top-k is discontinuous: where the paged kernel's f32 attention
    # weights and the dense path's bf16 ones flip a near-tied expert
    # choice, that row's logits differ by the expert's share.  The router
    # logits are held to slice 1's tolerance on every row that routed
    # alike upstream (every row in the first moe layer); the model's
    # logits on the rows that chose alike in every layer, most rows
    same, flip_gaps, router_diffs = routing_agreement(
        dense_log.calls, paged_log.calls, cfg.top_k)
    for i, d in enumerate(router_diffs):
        if d["max_abs_diff"] > LOGIT_REL_TOL * d["max_abs"]:
            raise AssertionError(
                f"{arch} first decode step, moe layer {i}: paged vs dense "
                f"router logits differ by {d['max_abs_diff']} on {d['rows']} "
                f"rows (> {LOGIT_REL_TOL} x max |logit| {d['max_abs']})")
    diff_all = float(np.abs(first_p - first_d).max())
    diff = float(np.abs(first_p[same] - first_d[same]).max()) if same.any() \
        else float("inf")
    scale = float(np.abs(first_d).max())
    if 2 * int(same.sum()) < BATCH or diff > LOGIT_REL_TOL * scale:
        raise AssertionError(
            f"{arch} first decode step: {int(same.sum())} of {BATCH} rows "
            f"routed alike; their paged vs dense logits differ by {diff} "
            f"(> {LOGIT_REL_TOL} x max |logit| {scale}?); router gaps at "
            f"the rows that flipped: {flip_gaps}")
    if stats["pool_prefix_hits"] < 3 * (SHARED // PAGE_TOKENS):
        raise AssertionError(f"{arch}: prefix sharing did not run: {stats}")
    agree = [sum(a == b for a, b in zip(outs[r], dense_out[r])) for r in outs]
    step_s = server.step_s
    del server, prefill_one, counted_prefill

    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT_LEN + 1), generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)
    served_router = {}
    for logits, k, cap, renormalize, _ in capture_router_calls(
            model, ctx, params, toks):
        tag = f"T{logits.shape[0]} C{cap}"
        served_router[tag] = router_check(f"{arch} served router {tag}",
                                          logits, k, cap, renormalize)
    caches = model.prefill(params, ctx, {"inputs": toks[:, :PROMPT_LEN]},
                           CACHE_LEN)[1]
    pos = torch.full((BATCH,), PROMPT_LEN, dtype=torch.int32, device="cuda")
    profile = {}
    for name, fn in (
            ("prefill", lambda: model.prefill(
                params, ctx, {"inputs": toks[:1, :PROMPT_LEN]}, CACHE_LEN)),
            ("decode_step", lambda: model.decode_step(
                params, ctx, toks[:, PROMPT_LEN:], pos, caches))):
        fn()  # warm (decode rewrites the same position: same work)
        profile[name] = profile_call(fn, "router_ms", "moe_router_")
    del caches, params
    pygc.collect()
    torch.cuda.empty_cache()
    emit({
        "phase": "serve_" + arch.split("-")[0], "arch": arch,
        "layers": cfg.n_layers, "layer_kinds": cfg.layer_kinds(),
        "layers_published": ARCHS[arch].n_layers, "d_model": cfg.d_model,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k, "params": n_params,
        "dtype": "bfloat16", "batch": BATCH, "cache_len": CACHE_LEN,
        "page_tokens": PAGE_TOKENS, "prompt_len": PROMPT_LEN,
        "max_new": MAX_NEW, "requests": stats["requests"],
        "decoded_tokens": stats["decoded_tokens"],
        "tok_per_s": stats["tok_per_s"], "p50_latency_s": stats["p50_latency_s"],
        "p50_ttft_s": stats["p50_ttft_s"], "wall_s": stats["wall_s"],
        "prefills": prefills[0], "decode_steps": steps,
        "decode_step_ms_median": 1e3 * float(np.median(step_s)),
        "decode_step_ms_mean": 1e3 * float(np.mean(step_s)),
        "peak_device_mem_gib": peak_gib, "init_s": init_s,
        "router_launches": launches,
        "router_launches_expected": f"{n_moe} x ({prefills[0]} + {steps})",
        "first_step_rows_routed_alike": int(same.sum()),
        "first_step_logit_max_abs_diff": diff,
        "first_step_logit_max_abs_diff_all_rows": diff_all,
        "first_step_logit_max_abs": scale,
        "first_step_router_gaps_at_flips": flip_gaps,
        "first_step_router_logits": router_diffs,
        "served_paged_attention": {**attn_shape, "max_abs_err": served_attn},
        "greedy_token_agreement_with_dense": sum(agree) / (N_REQ * MAX_NEW),
        "prefix_hits": stats["pool_prefix_hits"],
        "preemptions": stats["sched_evictions"],
        "dense_tok_per_s": dense_stats["tok_per_s"],
        "dense_p50_latency_s": dense_stats["p50_latency_s"],
        "served_router_max_abs_err": served_router, "profile": profile,
    })
    return launches


# --------------------------------------------------------------------------- #
# data-parallel training on the GAS ring (examples/train_lm.py), GPipe
# (parallel/pipeline.py), the profiler (obs/profile.py), the chunked scans
# --------------------------------------------------------------------------- #
DP_LAYERS = 2  # reduced: n_layers 36 -> 2 (the int8 ring's state, below)
DP_RANKS, DP_AFTER = 4, 3  # reduced: ranks 8 -> 4 -> 3
DP_BATCH, DP_SEQ = 12, 512  # global batch; 3 then 4 sequences a rank
DP_STEPS, DP_CKPT_EVERY, DP_FAIL_AT = 10, 4, 6
DP_RUNS = (("psum", "xla"), ("gas_ring", "gascore"),
           ("gas_ring_int8", "gascore"))
DP_RING_REL = 1e-5  # the f32 ring against the plain mean: summation order
DP_INT8_REL = 0.05  # the reference's gate (testing/dist_suite.py:44)


def all_launches():
    """Launches so far of every kernel on this slice's path."""
    return {**counts(), **counts(FLASH_KERNELS),
            "paged_attention": pa.paged_attention.launches}


def reset_all_launches():
    reset_counts()
    reset_counts(FLASH_KERNELS)
    pa.paged_attention.launches = 0


def rel_err(got, want):
    """Max |got - want| over max |want|."""
    den = want.abs().max().clamp_min(torch.finfo(torch.float32).tiny)
    return float((got - want).abs().max() / den)


def synced_ms(fn):
    """Host wall of ``fn()`` ending in a synchronise, and its output."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def dp_reduction_checks(cfg):
    """One step's gradients at full width on DP_RANKS ranks, reduced off
    the main path: the f32 ring bitwise equal on "xla" and "gascore" and
    within DP_RING_REL of the plain mean; the int8 ring on "gascore"
    within DP_INT8_REL, 4 (n - 1) ``ring_shift`` launches, and each
    rank's new error state exactly its compensated gradient minus the
    dequantized payload."""
    model = build_model(cfg)
    params = tree_map(lambda t: t.requires_grad_(), model.init(
        RunCtx(), torch.Generator(device="cuda").manual_seed(0),
        device="cuda"))
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg, DP_BATCH, DP_SEQ, seed=1).batch_at(0).items()}
    n = DP_RANKS
    _, stacked = train_lm.local_grads(model, params, batch, n, flat=True)
    del params, model, batch
    mean = stacked.sum(0) / n
    rec, ring = {"elements": stacked.shape[1]}, {}
    for engine in ("xla", "gascore"):
        ms, (red, _) = synced_ms(lambda: train_lm.reduce_grads(
            stacked, None, n_nodes=n, reduce_mode="gas_ring", engine=engine))
        ring[engine] = red.clone()
        del red
        rec[f"gas_ring_{engine}_ms"] = ms
    if not torch.equal(ring["xla"], ring["gascore"]):
        raise AssertionError("train_dp: the f32 ring differs on xla and "
                             "gascore")
    rec["gas_ring_rel"] = rel_err(ring["xla"], mean)
    del ring
    if rec["gas_ring_rel"] > DP_RING_REL:
        raise AssertionError(f"train_dp: f32 ring rel {rec['gas_ring_rel']}")
    err = torch.zeros_like(stacked)
    before = gc.ring_shift.launches
    ms, (red8, new_err) = synced_ms(lambda: train_lm.reduce_grads(
        stacked, err, n_nodes=n, reduce_mode="gas_ring_int8",
        engine="gascore"))
    rec["gas_ring_int8_gascore_ms"] = ms
    rec["int8_ring_shift_launches"] = gc.ring_shift.launches - before
    if rec["int8_ring_shift_launches"] != 4 * (n - 1):
        raise AssertionError(f"train_dp: {rec['int8_ring_shift_launches']} "
                             f"ring_shift launches, want {4 * (n - 1)}")
    rec["gas_ring_int8_rel"] = rel_err(red8, mean)
    del red8
    if rec["gas_ring_int8_rel"] > DP_INT8_REL:
        raise AssertionError(f"train_dp: int8 rel {rec['gas_ring_int8_rel']}")
    for r in range(n):
        comp = stacked[r] + err[r]
        q, sc = compression.quantize_int8(comp)
        if not torch.equal(new_err[r],
                           comp - compression.dequantize_int8(q, sc)):
            raise AssertionError(f"train_dp: rank {r}'s error state is not "
                                 "comp - dequant")
        del comp, q
    # bytes a rank puts on the wire in one all-reduce: 2 (n - 1) hops of
    # L / n elements, f32, or int8 plus one f32 scale a hop
    L = stacked.shape[1]
    rec["wire_bytes_per_rank"] = {"f32": 2 * (n - 1) * (L // n) * 4,
                                  "int8": 2 * (n - 1) * (L // n + 4)}
    del stacked, err, new_err, mean
    pygc.collect()
    torch.cuda.empty_cache()
    return rec


def train_dp_run(cfg, mode, engine):
    """One run of ``train_lm.train`` on the card: DP_RANKS ranks, the
    failure at DP_FAIL_AT, the restart on DP_AFTER.  Gates each step's
    launches (``DP_LAYERS`` of each flash kernel a rank; 4 (n - 1)
    ``ring_shift`` a compressed all-reduce), finite losses and the bitwise
    restore; then one more step under ``torch.profiler``."""
    torch.cuda.reset_peak_memory_stats()
    marks = []
    tmp = tempfile.mkdtemp(prefix="train_dp_")
    try:
        reset_all_launches()  # the main path starts here
        wall, out = synced_ms(lambda: train_lm.train(
            cfg, steps=DP_STEPS, reduce_mode=mode, engine=engine,
            batch=DP_BATCH, seq=DP_SEQ, n_nodes=DP_RANKS,
            n_lost=DP_RANKS - DP_AFTER, fail_at=DP_FAIL_AT,
            ckpt_every=DP_CKPT_EVERY, ckpt_dir=tmp, device="cuda",
            say=lambda *a, **k: None,
            on_step=lambda step, n, rec: marks.append((n, all_launches()))))
        launches = all_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prev = {k: 0 for k in launches}
    for n, now in marks:
        step = {k: now[k] - prev[k] for k in now}
        prev = now
        want = {name: DP_LAYERS * n for name in FLASH_KERNELS}
        if mode == "gas_ring_int8":
            want["ring_shift"] = 4 * (n - 1)
        got = {k: step[k] for k in want}
        if got != want:
            raise AssertionError(f"train_dp {mode}: launches {got} a step on "
                                 f"{n} ranks, want {want}")
    hist, restart = out["history"], out["restart"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_dp {mode}: losses {losses}")
    if not (restart.get("bitwise") and restart["n_nodes"] == DP_AFTER
            and restart["restored_step"] == DP_CKPT_EVERY):
        raise AssertionError(f"train_dp {mode}: restart {restart}")
    n = out["restart"]["n_nodes"]
    model = build_model(cfg)
    opt = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    step_fn = train_lm.make_step(model, opt, n, mode, engine=engine)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        cfg, DP_BATCH, DP_SEQ, seed=1).batch_at(DP_STEPS).items()}
    prof = profile_call(lambda: float(step_fn(
        out["params"], out["opt_state"], out["err"], batch)[3]["loss"]))
    del out, step_fn, model, batch
    pygc.collect()
    torch.cuda.empty_cache()
    ms = [h["step_ms"] for h in hist]
    return {
        "engine": engine, "wall_s": wall / 1e3, "losses": losses,
        "ranks_by_step": [h["n_nodes"] for h in hist],
        "step_ms": ms,
        "step_ms_median_4_ranks": float(np.median(
            [m for m, h in zip(ms[1:], hist[1:]) if h["n_nodes"] == DP_RANKS])),
        "step_ms_median_3_ranks": float(np.median(
            [m for m, h in zip(ms, hist) if h["n_nodes"] == DP_AFTER][1:])),
        "peak_gib": peak, "restart": restart, "launches": launches,
        "profile_step": prof,
    }


def train_dp_phase():
    """qwen3-4b at full width, 2 layers, data-parallel on the GAS layer
    (``train_lm``): the reductions' gates, then one run per reduce mode.
    Returns the launches of the three runs."""
    cfg = dataclasses.replace(ARCHS["qwen3-4b"], n_layers=DP_LAYERS)
    t0 = time.perf_counter()
    checks = dp_reduction_checks(cfg)
    runs, total = {}, {k: 0 for k in all_launches()}
    for mode, engine in DP_RUNS:
        runs[mode] = train_dp_run(cfg, mode, engine)
        for k, v in runs[mode]["launches"].items():
            total[k] += v
    emit({"phase": "train_dp", "arch": cfg.name, "layers": cfg.n_layers,
          "reduced": {"n_layers": [36, DP_LAYERS],
                      "ranks": [8, DP_RANKS, DP_AFTER]},
          "d_model": cfg.d_model, "dtype": "bfloat16",
          "params": checks["elements"], "batch": DP_BATCH, "seq": DP_SEQ,
          "steps": DP_STEPS, "ckpt_every": DP_CKPT_EVERY,
          "fail_at": DP_FAIL_AT, "remat": train_lm.LOCAL_CTX.remat,
          "checks": checks, "runs": runs, "launches": total,
          "phase_s": time.perf_counter() - t0})
    return total


PIPE_S, PIPE_M, PIPE_MB, PIPE_D = 4, 8, 512, 2560
PIPE_FWD_TOL, PIPE_GRAD_TOL = 1e-5, 2e-4  # the reference's


def pipe_stage(wl, xx):
    return torch.tanh(xx @ wl[0])


def pipeline_phase():
    """GPipe over 4 ranks at qwen3-4b's width: forward and gradients on
    "xla" against the sequential chain, after a warm-up under sync debug
    mode "error"; the "gascore" forward bitwise the "xla" one, its
    gradient refused.  Returns the launches of the gated runs."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    xm = torch.randn((PIPE_M, PIPE_MB, PIPE_D), generator=gen, device="cuda")
    w0 = torch.randn((PIPE_S, PIPE_D, PIPE_D), generator=gen,
                     device="cuda") / math.sqrt(PIPE_D)

    def pipe(backend, w):
        ctx = gasnet.Context(PIPE_S, backend=backend, device="cuda")
        return ctx.spmd(
            lambda node, wl, xs: pipeline.gpipe(
                pipe_stage, wl, xs, engine=node.engine, n_stages=PIPE_S),
            w, xm, in_specs=(P("node"), P()), out_specs=P())

    def xla_step():
        w = w0.clone().requires_grad_()
        out = pipe("xla", w)
        (out ** 2).sum().backward()
        return out.detach(), w.grad

    def chain_step(per_microbatch=True):
        """The sequential chain, microbatch by microbatch as GPipe runs
        it (each weight gradient summed over 512-row products in
        microbatch order), or over the whole batch at once (4,096-row
        products: another summation order, printed, not gated)."""
        w = w0.clone().requires_grad_()
        out = (torch.stack([pipeline_chain(w, x) for x in xm])
               if per_microbatch else pipeline_chain(w, xm))
        (out ** 2).sum().backward()
        return out.detach(), w.grad

    xla_step()  # warm-up: index constants cached, plan made
    torch.cuda.synchronize()
    reset_all_launches()  # the main path starts here
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, grad = xla_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with torch.no_grad():
        gout = pipe("gascore", w0)
    launches = all_launches()
    refused = False
    try:
        pipe("gascore", w0.clone().requires_grad_()).sum().backward()
    except RuntimeError as e:
        refused = "forward-only" in str(e)
    want_out, want_grad = chain_step()
    fwd_err = float((out - want_out).abs().max())
    grad_err = float((grad - want_grad).abs().max())
    grad_scale = float(want_grad.abs().max())
    whole_out, whole_grad = chain_step(per_microbatch=False)
    whole = {"fwd_max_abs_err": float((out - whole_out).abs().max()),
             "grad_max_abs_err": float((grad - whole_grad).abs().max()),
             "grad_max_abs": float(whole_grad.abs().max())}
    del whole_out, whole_grad
    torch.testing.assert_close(out, want_out, atol=PIPE_FWD_TOL, rtol=0)
    # the reference's gradients are O(1) at its shapes; here each weight
    # gradient sums 4,096 products and is far larger, so its 2e-4 holds
    # relative to the largest |gradient| (f32 rounding of the sums)
    torch.testing.assert_close(grad / grad_scale, want_grad / grad_scale,
                               atol=PIPE_GRAD_TOL, rtol=PIPE_GRAD_TOL)
    if not torch.equal(gout, out):
        raise AssertionError("pipeline: gascore forward differs from xla")
    if not refused:
        raise AssertionError("pipeline: the gascore gradient was not refused")
    timing = {
        "xla_fwd_bwd_ms": [synced_ms(xla_step)[0] for _ in range(3)],
        "xla_fwd_ms": [synced_ms(lambda: pipe("xla", w0))[0]
                       for _ in range(3)],
        "gascore_fwd_ms": [synced_ms(lambda: pipe("gascore", w0))[0]
                           for _ in range(3)],
        "chain_fwd_bwd_ms": [synced_ms(chain_step)[0] for _ in range(3)],
    }
    emit({"phase": "pipeline", "stages": PIPE_S, "microbatches": PIPE_M,
          "microbatch": [PIPE_MB, PIPE_D], "dtype": "float32",
          "fwd_max_abs_err": fwd_err, "grad_max_abs_err": grad_err,
          "grad_max_abs": grad_scale,
          "tol": {"fwd": PIPE_FWD_TOL, "grad_of_max": PIPE_GRAD_TOL},
          "whole_batch_chain": whole,
          "sync_debug": "error", "gascore_bitwise": True,
          "gascore_grad_refused": refused, "launches": launches, **timing})
    return launches


def pipeline_chain(w, xs):
    o = xs
    for i in range(w.shape[0]):
        o = torch.tanh(o @ w[i])
    return o


PROFILE_DECODE_AT = (8, 40)  # decode steps after which the step is timed
PROFILE_ITERS, PROFILE_WARMUP = 6, 2


def profile_obs_phase(served):
    """``DeviceProfiler.profile_many`` over ``profiling_targets`` at the
    reference's shapes (device-timed, beside ``device_ms`` of the same
    kernel call), then ``PagedServer.profile_decode`` mid-serving of the
    serve cell's traffic at qwen3-4b's full width and depth: the tokens
    equal the serve phase's run without it.  Returns the launches of the
    served run."""
    prof = obs_profile.DeviceProfiler(device="cuda")
    targets = ops.profiling_targets(device="cuda")
    best = prof.profile_many(targets, rounds=6, warmup=2)
    recs = {r["name"]: r for r in prof.records}
    if set(recs) != {"paged_attention_kernel", "paged_attention_ref"} or any(
            r["measured"] != "device" for r in recs.values()):
        raise AssertionError(f"profile: records {prof.records}")
    kernel = dict(targets[0][2], device_ms=device_ms(targets[0][1], 20),
                  profile_us=best["paged_attention_kernel"],
                  ref_profile_us=best["paged_attention_ref"])
    err = float((targets[0][1]() - targets[1][1]()).abs().max())
    if err > KERNEL_ATOL[torch.float32]:
        raise AssertionError(f"profile: kernel vs plain {err}")

    server = PagedServer(served["model"], served["ctx"], served["params"],
                         BATCH, CACHE_LEN, device="cuda",
                         page_tokens=PAGE_TOKENS)
    for r in requests():
        server.submit(r)
    reset_all_launches()  # the main path starts here
    timed, at = [], list(PROFILE_DECODE_AT)
    while server.queue or any(r is not None for r in server.active):
        server.step()
        if at and server.paged_decode_steps >= at[0]:
            at.pop(0)
            before = pa.paged_attention.launches
            us = server.profile_decode(prof, iters=PROFILE_ITERS,
                                       warmup=PROFILE_WARMUP)
            timed.append((server.paged_decode_steps, us,
                          pa.paged_attention.launches - before))
    launches = all_launches()
    tokens = {r.rid: r.out for r in server.finished}
    if tokens != served["paged"]:
        diff = [rid for rid in tokens if tokens[rid] != served["paged"][rid]]
        raise AssertionError(f"profile_decode changed the tokens of {diff}")
    # one launch a layer in every step served and every re-execution the
    # profiler ran (warm-up, timed calls, and the calls its clock retried)
    n_layers = served["model"].cfg.n_layers
    reruns = [t[2] for t in timed]
    if (launches["paged_attention"] - sum(reruns)
            != n_layers * server.paged_decode_steps or any(
                r % n_layers or r < n_layers * (PROFILE_ITERS + PROFILE_WARMUP)
                for r in reruns)):
        raise AssertionError(f"profile: {launches['paged_attention']} paged "
                             f"attention launches, {reruns} of them "
                             f"re-executions, in {server.paged_decode_steps} "
                             "decode steps")
    decode = prof.spans("paged_decode_step")
    if len(decode) != len(PROFILE_DECODE_AT) or any(
            r["measured"] != "device" for r in decode):
        raise AssertionError(f"profile: decode records {decode}")
    emit({"phase": "profiler", "targets": recs, "kernel": kernel,
          "kernel_vs_plain_max_abs_err": err,
          "decode": [dict(r, after_step=t[0], reexecutions=t[2] // n_layers)
                     for r, t in zip(decode, timed)],
          "decode_steps": server.paged_decode_steps,
          "tokens_identical": True, "launches": launches})
    del server
    return launches


def scan_chunked_phase():
    """The chunked scans (``scan_impl="chunked"``) against the kernel path:
    at the scan phase's full-width cases (bf16 and f32, both held to
    ``SCAN_TOL``, timed by ``device_ms`` beside the kernel), then the
    prefill of each arch at full width (f32 on the consistency check's
    layers) held to ``CONSIST_REL_TOL``, both prefills timed."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    scans = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        args = ssm_inputs(SSM_FULL[0], dtype, gen)
        y, h = ops.selective_scan(*args, final_state=True, impl="chunked")
        ky, kh = ops.selective_scan(*args, final_state=True)
        scans[f"selective_scan {SSM_FULL[0]} {dname}"] = {
            "y_err": within("chunked selective_scan y", y, ky,
                            SCAN_TOL[dtype]),
            "h_err": within("chunked selective_scan h", h, kh,
                            SCAN_TOL[torch.float32]),
            "chunked_ms": device_ms(lambda: ops.selective_scan(
                *args, final_state=True, impl="chunked"), 5, flush),
            "kernel_ms": device_ms(lambda: ops.selective_scan(
                *args, final_state=True), 20, flush)}
        del args, y, h, ky, kh
        a, b = lru_inputs(LRU_FULL[0], dtype, gen)
        scans[f"gated_linear_scan {LRU_FULL[0]} {dname}"] = {
            "y_err": within("chunked gated_linear_scan",
                            ops.gated_linear_scan(a, b, impl="chunked"),
                            ops.gated_linear_scan(a, b), SCAN_TOL[dtype]),
            "chunked_ms": device_ms(lambda: ops.gated_linear_scan(
                a, b, impl="chunked"), 5, flush),
            "kernel_ms": device_ms(lambda: ops.gated_linear_scan(a, b), 20,
                                   flush)}
        del a, b
    prefill = {}
    for arch, serving in RECURRENT_SERVING.items():
        S, layers = serving[2], serving[6][0]  # the served prompt
        cfg = dataclasses.replace(ARCHS[arch], n_layers=layers,
                                  dtype=torch.float32)
        model = build_model(cfg)
        params = model.init(RunCtx(), torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                             device="cuda", dtype=torch.int32)
        out = {}
        for impl in ("ref", "chunked"):
            ctx = RunCtx(scan_impl=impl)
            run = lambda: model.prefill(params, ctx, {"inputs": toks},
                                        cache_len=S)
            run()
            out[impl] = (run(), [synced_ms(run)[0] for _ in range(3)])
        (kl, kc), kms = out["ref"]
        (cl, cc), cms = out["chunked"]
        rel = rel_err(cl.float(), kl.float())
        state = max(rel_err(c.float(), k.float())
                    for c, k in zip(tree_leaves(cc), tree_leaves(kc)))
        if rel > CONSIST_REL_TOL or state > CONSIST_REL_TOL:
            raise AssertionError(f"scan_chunked {arch}: logits rel {rel}, "
                                 f"caches rel {state}")
        prefill[arch] = {"layers": layers, "dtype": "float32", "prompt": S,
                         "logits_rel": rel, "caches_rel": state,
                         "kernel_ms": kms, "chunked_ms": cms}
        del model, params, out, kl, kc, cl, cc
        pygc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "scan_chunked", "tol": {"scan": {
        str(d).split(".")[-1]: t for d, t in SCAN_TOL.items()},
        "prefill_rel": CONSIST_REL_TOL}, "scans": scans, "prefill": prefill})


# --------------------------------------------------------------------------- #
# the rest of the model zoo (slice 15): gemma3-27b, granite-34b,
# llama3-405b, llama-3.2-vision-11b, seamless-m4t-medium; then expert
# parallelism over the GAS all-to-all
# --------------------------------------------------------------------------- #
ALL_KERNELS = {**{"paged_attention": (pa.paged_attention, None, None)},
               **GAS_KERNELS, **FLASH_KERNELS,
               "selective_scan": (ssm_scan.selective_scan, None, None),
               "gated_linear_scan": (rglru.gated_linear_scan, None, None),
               "moe_router": (mr.moe_router, None, None)}
ZOO_PAGED = {  # arch: (layers served, f32 layers of the TieGate pass)
    "granite-34b": (None, 2),  # full depth: 88 layers, 63.3 GiB of bf16
    "llama3-405b": (4, None),  # reduced: n_layers 126 -> 4 (810 GB at 126)
}
LLAMA3_REQ, LLAMA3_NEW = 8, 32
GEMMA = dict(requests=8, prompt=1536, new=32, batch=4, cache=2048,
             f32_layers=6)  # prompts past the 1,024 window; one 5:1 unit
VISION = dict(batch=4, prompt=128, new=32, cache=512, xgate=0.5,
              f32_layers=5)
SEAMLESS = dict(batch=4, frames=1024, prompt=128, new=32, cache=256)


def ln_vocab_range(vocab):
    """A step-0 loss near ln(vocab): random logits spread it up a little."""
    return math.log(vocab) - 1.0, math.log(vocab) + 2.5


def zoo_model(cfg, seed=0):
    """``cfg``'s model and seeded random parameters on the card, after
    freeing what the phase before left; with the init's seconds."""
    pygc.collect()
    torch.cuda.empty_cache()
    model, ctx = build_model(cfg), RunCtx()
    t0 = time.perf_counter()
    params = model.init(ctx, torch.Generator(device="cuda").manual_seed(seed),
                        device="cuda")
    torch.cuda.synchronize()
    return model, ctx, params, time.perf_counter() - t0


def free():
    pygc.collect()
    torch.cuda.empty_cache()


def first_dense_logits(model, ctx, params, reqs, batch, cache_len):
    """The dense ``Server``'s first decode step over the first ``batch``
    requests (the oracle of a paged run's first step), host f32."""
    dense = Server(model, ctx, params, batch, cache_len, device="cuda")
    got, decode = [], dense._decode

    def recording(*a):
        logits, caches = decode(*a)
        if not got:
            got.append(logits.float().cpu().numpy())
        return logits, caches

    dense._decode = recording
    for r in reqs[:batch]:
        r.max_new = 2
        dense.submit(r)
    dense.run_until_drained()
    del dense, decode, recording
    return got[0]


def serve_paged_zoo(arch):
    """One arch of ``global`` blocks through ``PagedServer`` with slice 1's
    traffic, its first decode step held against the dense ``Server``'s;
    then (granite) the f32 TieGate pass of paged against dense at full
    width on a cut depth.  Returns (record, paged-attention launches)."""
    layers, f32_layers = ZOO_PAGED[arch]
    cfg = ARCHS[arch] if layers is None else dataclasses.replace(
        ARCHS[arch], n_layers=layers)
    n_req, max_new = ((N_REQ, MAX_NEW) if arch == "granite-34b"
                      else (LLAMA3_REQ, LLAMA3_NEW))

    def reqs():
        out = requests(cfg.vocab)[:n_req]
        for r in out:
            r.max_new = max_new
        return out

    model, ctx, params, init_s = zoo_model(cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    first_d = first_dense_logits(model, ctx, params, reqs(), BATCH, CACHE_LEN)
    server = RecordingPagedServer(model, ctx, params, BATCH, CACHE_LEN,
                                  device="cuda", page_tokens=PAGE_TOKENS)
    for r in reqs():
        server.submit(r)
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0  # the main path starts here
    stats = server.run_until_drained()
    launches = pa.paged_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    outs = {r.rid: r.out for r in server.finished}
    if sorted(outs) != list(range(n_req)) or any(
            len(o) != max_new for o in outs.values()):
        raise AssertionError(f"{arch}: finished {sorted(outs)}")
    steps = server.paged_decode_steps
    if launches != cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"{arch}: paged_attention launched {launches} "
                             f"times in {steps} steps; want {cfg.n_layers} a "
                             "step")
    if not server.all_finite:
        raise AssertionError(f"{arch}: non-finite logits on the paged path")
    first_p = server.first_logits
    if first_p.shape != (BATCH, cfg.vocab) or first_d.shape != first_p.shape:
        raise AssertionError(f"{arch}: logits {first_p.shape}, {first_d.shape}")
    diff = float(np.abs(first_p - first_d).max())
    scale = float(np.abs(first_d).max())
    if diff > LOGIT_REL_TOL * scale:
        raise AssertionError(f"{arch} first decode step: paged vs dense "
                             f"logits differ by {diff} (> {LOGIT_REL_TOL} x "
                             f"{scale})")
    step_s = server.step_s
    record = {
        "arch": arch, "layers": cfg.n_layers,
        "layers_published": ARCHS[arch].n_layers, "params": n_params,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "dtype": "bfloat16",
        "server": "PagedServer", "batch": BATCH, "cache_len": CACHE_LEN,
        "page_tokens": PAGE_TOKENS, "requests": stats["requests"],
        "prompt_len": PROMPT_LEN, "max_new": max_new,
        "decoded_tokens": stats["decoded_tokens"],
        "tok_per_s": stats["tok_per_s"], "p50_latency_s": stats["p50_latency_s"],
        "p50_ttft_s": stats["p50_ttft_s"], "wall_s": stats["wall_s"],
        "decode_steps": steps,
        "decode_step_ms_median": 1e3 * float(np.median(step_s)),
        "peak_device_mem_gib": peak_gib, "init_s": init_s,
        "launches": {"paged_attention": launches},
        "launches_expected": {"paged_attention":
                              f"{cfg.n_layers} attention layers x {steps}"},
        "first_step_logit_max_abs_diff": diff,
        "first_step_logit_max_abs": scale,
        "prefix_hits": stats["pool_prefix_hits"],
    }
    if layers is not None:
        record["reduced"] = {"n_layers": [ARCHS[arch].n_layers, layers]}
    del server, params, model
    free()
    if f32_layers:
        record["f32"], _ = f32_pass(dataclasses.replace(
            ARCHS[arch], n_layers=f32_layers))
    return record, launches


def serve_dense_zoo(model, params, reqs, batch, cache_len):
    """``reqs`` through the dense ``Server`` at ``batch`` rows; the run's
    figures.  Tokens must be finite and in the vocabulary."""
    cfg = model.cfg
    server = RecordingServer(model, RunCtx(), params, batch, cache_len,
                             device="cuda")
    for r in reqs:
        server.submit(r)
    torch.cuda.reset_peak_memory_stats()
    stats = server.run_until_drained()
    outs = {r.rid: r.out for r in server.finished}
    if len(outs) != len(reqs) or any(
            len(o) != r.max_new for o, r in zip(
                (outs[r.rid] for r in reqs), reqs)):
        raise AssertionError(f"{cfg.name}: finished {sorted(outs)}")
    if not server.all_finite or any(
            not 0 <= t < cfg.vocab for o in outs.values() for t in o):
        raise AssertionError(f"{cfg.name}: non-finite logits or tokens out "
                             "of range")
    step_s = server.step_s
    del server
    return {"server": "Server", "batch": batch, "cache_len": cache_len,
            "requests": stats["requests"], "prompt_len": len(reqs[0].prompt),
            "max_new": reqs[0].max_new,
            "decoded_tokens": stats["decoded_tokens"],
            "tok_per_s": stats["tok_per_s"],
            "p50_latency_s": stats["p50_latency_s"],
            "p50_ttft_s": stats["p50_ttft_s"], "wall_s": stats["wall_s"],
            "decode_steps": len(step_s),
            "decode_step_ms_median": 1e3 * float(np.median(step_s)),
            "peak_device_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def consistency_f32(cfg, n_layers, S):
    """``consistency`` in f32 at full width on ``n_layers`` layers, held
    to ``CONSIST_REL_TOL``; the figures."""
    small = dataclasses.replace(cfg, n_layers=n_layers, dtype=torch.float32)
    model, ctx, params, _ = zoo_model(small)
    gen = torch.Generator(device="cuda").manual_seed(1)
    diff, scale, agree = consistency(model, ctx, params, S, CONSIST_STEPS,
                                     S + CONSIST_STEPS + 4, gen)
    del params, model
    free()
    if diff > CONSIST_REL_TOL * scale:
        raise AssertionError(
            f"{cfg.name} f32 x {n_layers} layers: prefill and prefill + "
            f"decode differ by {diff} (> {CONSIST_REL_TOL} x {scale})")
    return {"layers": n_layers, "prompt": S, "steps": CONSIST_STEPS,
            "max_abs_logit_diff": diff, "max_abs_logit": scale,
            "rel_tol": CONSIST_REL_TOL, "top1_agreement": agree}


def greedy(model, ctx, params, toks, steps, cache_len, context):
    """The prompts ``toks`` (B, S) through ``serve_with_context`` (the
    port's loop for prefills that take frames or an image), one batch,
    ``steps`` greedy decode steps; the record: tokens in the vocabulary,
    prefill seconds, the median step ms and tok/s of the decode steps."""
    cfg = model.cfg
    reqs = [Request(rid=i, prompt=row, max_new=steps + 1)
            for i, row in enumerate(toks.tolist())]
    stats = serve_with_context(model, ctx, params, reqs, len(reqs),
                               cache_len, lambda B, S: context)
    out = [t for r in reqs for t in r.out]
    if (len(out) != len(reqs) * (steps + 1) or stats["decode_steps"] != steps
            or not all(0 <= t < cfg.vocab for t in out)):
        raise AssertionError(f"{cfg.name}: {stats['decode_steps']} steps, "
                             f"tokens {out[:8]}...")
    step_s = stats["step_s"]
    return {"batch": len(reqs), "new_tokens": steps + 1,
            "prefill_s": stats["prefill_s"][0], "decode_steps": steps,
            "decode_step_ms_median": 1e3 * float(np.median(step_s)),
            "tok_per_s": len(reqs) * steps / sum(step_s)}


def serve_gemma():
    cfg = ARCHS["gemma3-27b"]
    g = GEMMA
    model, ctx, params, init_s = zoo_model(cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=g["prompt"]).tolist(),
                    max_new=g["new"]) for i in range(g["requests"])]
    record = {"arch": cfg.name, "layers": cfg.n_layers,
              "params": sum(t.numel() for t in tree_leaves(params)),
              "local_window": cfg.local_window, "dtype": "bfloat16",
              "init_s": init_s, **serve_dense_zoo(
                  model, params, reqs, g["batch"], g["cache"]),
              "launches": {}, "launches_expected": {
                  "paged_attention": "0: Server (paged decode has no "
                                     "windows)"}}
    del params, model
    free()
    record["consistency_f32"] = consistency_f32(cfg, g["f32_layers"],
                                                g["prompt"])
    return record


@torch.no_grad()
def open_gates(params, value):
    """Every ``xgate`` leaf of ``params`` set to ``value`` (in place): the
    init's 0 closes the image path."""
    for seg in params["dec"]:
        for block in seg.values():
            if "xgate" in block:
                block["xgate"].fill_(value)


def serve_vision():
    cfg = ARCHS["llama-3.2-vision-11b"]
    v = VISION
    model, ctx, params, init_s = zoo_model(cfg)
    open_gates(params, v["xgate"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (v["batch"], v["prompt"]),
                         generator=gen, device="cuda").to(torch.int32)
    xkv = torch.randn((v["batch"], cfg.cross_kv_len, cfg.d_model),
                      generator=gen, device="cuda").to(cfg.dtype)
    torch.cuda.reset_peak_memory_stats()
    with_image = greedy(model, ctx, params, toks, v["new"], v["cache"],
                        {"xkv": xkv})
    record = {"arch": cfg.name, "layers": cfg.n_layers,
              "params": sum(t.numel() for t in tree_leaves(params)),
              "dtype": "bfloat16", "init_s": init_s, "xgate": v["xgate"],
              "image": list(xkv.shape), "prompt_len": v["prompt"],
              "cache_len": v["cache"],
              "with_image": {**with_image,
                             "peak_device_mem_gib":
                             torch.cuda.max_memory_allocated() / 2**30},
              "launches": {}, "launches_expected": {
                  "paged_attention": "0: Server and Model.decode_step"}}
    del xkv
    record["text_only"] = serve_dense_zoo(model, params,
                                          requests(cfg.vocab)[:BATCH], BATCH,
                                          CACHE_LEN)
    del params, model
    free()
    record["consistency_f32"] = consistency_f32(cfg, v["f32_layers"],
                                                PROMPT_LEN)
    return record


def serve_seamless():
    """Prefill with frames (the encoder on the flash forward, non-causal at
    head dim 64), 32 greedy decode steps; then in f32 the prefill's
    logits against ``train_logits`` at the last position."""
    cfg = ARCHS["seamless-m4t-medium"]
    s = SEAMLESS
    model, ctx, params, init_s = zoo_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (s["batch"], s["prompt"]),
                         generator=gen, device="cuda").to(torch.int32)
    frames = torch.randn((s["batch"], s["frames"], cfg.d_model),
                         generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(FLASH_KERNELS)
    served = greedy(model, ctx, params, toks, s["new"], s["cache"],
                    {"frames": frames})
    launches = counts(FLASH_KERNELS)
    want = {"flash_attention_fwd": cfg.n_enc_layers,
            "flash_attention_dkv": 0, "flash_attention_dq": 0}
    if launches != want:
        raise AssertionError(f"seamless prefill: flash launches {launches}, "
                             f"want {want} (one forward an encoder layer)")
    record = {"arch": cfg.name, "layers": cfg.n_layers,
              "enc_layers": cfg.n_enc_layers,
              "params": sum(t.numel() for t in tree_leaves(params)),
              "dtype": "bfloat16", "init_s": init_s,
              "frames": list(frames.shape), "prompt_len": s["prompt"],
              "cache_len": s["cache"],
              **served,
              "peak_device_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "launches": dict(launches), "launches_expected": {
                  "flash_attention_fwd": f"{cfg.n_enc_layers} encoder layers "
                                         "x 1 prefill"}}
    del params, model
    free()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model, ctx, params, _ = zoo_model(cfg32)
    batch = {"inputs": toks, "frames": frames}
    reset_counts(FLASH_KERNELS)
    pre, _ = model.prefill(params, ctx, batch, s["cache"])
    with torch.no_grad():
        full = model.train_logits(params, ctx, batch)[:, -1]
    launches32 = counts(FLASH_KERNELS)
    diff = float((pre.float() - full.float()).abs().max())
    scale = float(full.float().abs().max())
    if not (torch.isfinite(pre).all() and diff <= CONSIST_REL_TOL * scale):
        raise AssertionError(f"seamless f32: prefill vs train_logits at the "
                             f"last position {diff} (> {CONSIST_REL_TOL} x "
                             f"{scale})")
    record["f32_prefill_vs_train_logits"] = {
        "max_abs_logit_diff": diff, "max_abs_logit": scale,
        "rel_tol": CONSIST_REL_TOL, "flash_launches": launches32}
    for k, n in launches32.items():
        launches[k] += n
    del params, model, pre, full
    free()
    return record, launches


def serve_zoo_phase():
    """The five archs' serving paths.  Returns the launches per kernel."""
    t0 = time.perf_counter()
    total = {name: 0 for name in ALL_KERNELS}
    out = {}
    for arch in ZOO_PAGED:
        out[arch], n = serve_paged_zoo(arch)
        total["paged_attention"] += n
    out["gemma3-27b"] = serve_gemma()
    out["llama-3.2-vision-11b"] = serve_vision()
    out["seamless-m4t-medium"], flash = serve_seamless()
    for k, n in flash.items():
        total[k] += n
    emit({"phase": "serve_zoo", "archs": out, "launches": total,
          "seconds": time.perf_counter() - t0})
    return total


TRAIN_ZOO = [  # arch, layers (None: full depth), batch, seq, with xkv
    ("gemma3-27b", 6, 1, 4096),
    ("granite-34b", 2, 2, 2048),
    ("seamless-m4t-medium", None, 2, 1024),
    ("llama-3.2-vision-11b", 5, 2, 2048),
]
TRAIN_ZOO_STEPS = 3


def flash_layers(cfg):
    """Self-attentions on the flash kernels in training: every decoder
    block (a ``cross``/``xdec`` block's self sub-block; its cross
    sub-block is plain torch, as the reference's jnp) and every encoder
    layer."""
    return cfg.n_layers + cfg.n_enc_layers


def train_zoo_phase():
    """``Trainer`` at full width, full remat, AdamW, 3 steps an arch.
    Returns the flash kernels' launches."""
    t0 = time.perf_counter()
    total = {name: 0 for name in FLASH_KERNELS}
    out = {}
    for arch, layers, B, S in TRAIN_ZOO:
        free()
        torch.cuda.reset_peak_memory_stats()
        cfg = ARCHS[arch] if layers is None else dataclasses.replace(
            ARCHS[arch], n_layers=layers)
        model, ctx = build_model(cfg), RunCtx(remat="full")
        opt = adamw.AdamWConfig(lr=TRAIN_LR, weight_decay=0.0)
        trainer = Trainer(model, ctx, opt, TrainerConfig(
            steps=TRAIN_ZOO_STEPS, ga_steps=1, log_every=1, ckpt_every=0))
        params, opt_state = trainer.init(
            torch.Generator(device="cuda").manual_seed(0))
        if cfg.cross_kv_len:
            open_gates(params, VISION["xgate"])
        loader = Loader(SyntheticLM(cfg, B, S, seed=0), device="cuda")
        try:
            reset_counts(FLASH_KERNELS)  # the main path starts here
            params, opt_state, history = trainer.run(params, opt_state, loader)
            launches = counts(FLASH_KERNELS)
        finally:
            loader.close()
        n = flash_layers(cfg)
        want = {k: v * TRAIN_ZOO_STEPS for k, v in train_launches(n).items()}
        if launches != want:
            raise AssertionError(f"train {arch}: launches {launches}, want "
                                 f"{want}")
        losses = [h["loss"] for h in history]
        norms = [h["grad_norm"] for h in history]
        lo, hi = ln_vocab_range(cfg.vocab)
        if len(history) != TRAIN_ZOO_STEPS or not all(
                math.isfinite(x) for x in losses + norms) or not (
                lo <= losses[0] <= hi):
            raise AssertionError(f"train {arch}: losses {losses}, grad norms "
                                 f"{norms}, step 0 outside {(lo, hi)}")
        step_ms = [1e3 * h["step_time_s"] for h in history]
        out[arch] = {
            "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
            "layers_published": ARCHS[arch].n_layers, "batch": B, "seq": S,
            "xkv": [B, cfg.cross_kv_len, cfg.d_model] if cfg.cross_kv_len
            else None,
            "params": sum(t.numel() for t in tree_leaves(params)),
            "losses": losses, "grad_norms": norms, "step0_range": [lo, hi],
            "step_ms": step_ms, "step_ms_last": step_ms[-1],
            "tok_per_s": B * S / (step_ms[-1] / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches,
            "launches_per_step": train_launches(n),
            "flash_attended_layers": n}
        if layers is not None:
            out[arch]["reduced"] = {"n_layers": [ARCHS[arch].n_layers, layers]}
        for k, v in launches.items():
            total[k] += v
        del params, opt_state, trainer, model
    free()
    emit({"phase": "train_zoo", "archs": out, "remat": "full",
          "steps": TRAIN_ZOO_STEPS, "launches": total,
          "seconds": time.perf_counter() - t0})
    return total


EP_GRID = (1, 4)
EP_T = 1024
EP_CF = 4.0
EP_ROW_TOL = 2e-2  # bf16: |a - b| <= tol * (1 + |b|) over a row


def ep_composition(p, cfg, x2d, grid):
    """The reference's ``_moe_ep`` body token shard by token shard with
    the plain router, dispatch and combine (``kernels/ref.py``) and every
    expert's products on the shard's buffer: what EP computes, its
    all-to-all only moving rows."""
    dp, tp = grid
    T, _ = x2d.shape
    shards = dp * tp if T % (dp * tp) == 0 else dp
    T_l = T // shards
    C_l = max(4, int(math.ceil(T_l * cfg.top_k * cfg.capacity_factor
                               / cfg.n_experts)))
    outs = []
    for i in range(shards):
        x_l = x2d[i * T_l:(i + 1) * T_l]
        e, s, w, keep = ref.route_topk(x_l.float() @ p["router"],
                                       k=cfg.top_k, capacity=C_l)
        buf = ref.moe_dispatch(x_l, e, s, keep, n_experts=cfg.n_experts,
                               capacity=C_l)
        hid = torch.nn.functional.silu(torch.bmm(buf, p["wg"])) * torch.bmm(
            buf, p["wi"])
        outs.append(ref.moe_combine(torch.bmm(hid, p["wo"]), e, s, w, keep))
    return torch.cat(outs)


def rows_within(got, want, tol):
    """Share of rows with every |got - want| <= tol (1 + |want|)."""
    ok = ((got.float() - want.float()).abs()
          <= tol * (1 + want.float().abs())).all(-1)
    return float(ok.float().mean())


def moe_ep_phase():
    """One arctic ``moe`` layer at full width on a (1, 4) grid, EP on
    "xla" and "gascore" against each other, the per-shard plain
    composition and the local path; then arctic on 2 layers through
    ``PagedServer`` with EP on "gascore".  Returns the launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["arctic-480b"], n_layers=MOE_LAYERS)
    model, _, params, init_s = zoo_model(cfg)
    p = params["dec"][0]["b0_moe"]["moe"]
    layer = {k: p[k][0] for k in ("router", "wi", "wg", "wo")}  # views
    cf = dataclasses.replace(cfg, capacity_factor=EP_CF)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn((EP_T, cfg.d_model), generator=gen, device="cuda")
         * 0.5).to(cfg.dtype)
    runs, total = {}, {name: 0 for name in ALL_KERNELS}
    for backend in ("xla", "gascore"):
        ctx = RunCtx(moe_mode="ep_shardmap", ep_grid=EP_GRID,
                     moe_backend=backend)
        reset_counts(ALL_KERNELS)  # the main path starts here
        y = moe_layers._moe_ep(layer, cf, ctx, x)
        torch.cuda.synchronize()
        launches = counts(ALL_KERNELS)
        want = {"moe_router": EP_GRID[0] * EP_GRID[1],
                "ring_shift": 2 * (EP_GRID[1] - 1) if backend == "gascore"
                else 0}
        got = {k: launches[k] for k in want}
        if got != want or sum(launches.values()) != sum(want.values()):
            raise AssertionError(f"moe_ep {backend}: launches {launches}, "
                                 f"want {want}")
        for k, n in launches.items():
            total[k] += n
        runs[backend] = {"y": y, "launches": got,
                         "device_ms": device_ms(lambda: moe_layers._moe_ep(
                             layer, cf, ctx, x), 5)}
    if not torch.equal(runs["xla"]["y"], runs["gascore"]["y"]):
        raise AssertionError("moe_ep: the engines differ")
    y = runs["gascore"]["y"]
    if not torch.isfinite(y.float()).all():
        raise AssertionError("moe_ep: non-finite output")
    comp = ep_composition(layer, cf, x, EP_GRID)
    comp_err = within("moe_ep vs per-shard composition", y, comp, EP_ROW_TOL)
    cap = moe_layers.moe_capacity(cf, EP_T)
    local = moe_layers._moe_local(layer, cf, RunCtx(), x, cap)
    share = rows_within(y, local, EP_ROW_TOL)
    if share <= 0.97:
        raise AssertionError(f"moe_ep: {share:.2%} of rows within tolerance "
                             "of local")
    local_ms = device_ms(lambda: moe_layers._moe_local(
        layer, cf, RunCtx(), x, cap), 5)
    record = {"layer": {"E": cfg.n_experts, "K": cfg.top_k, "D": cfg.d_model,
                        "F": cfg.d_ff, "T": EP_T, "capacity_factor": EP_CF,
                        "expert_gb": 3 * cfg.n_experts * cfg.d_model
                        * cfg.d_ff * 2 / 1e9},
              "grid": list(EP_GRID), "engines_bitwise_equal": True,
              "composition_max_abs_err": comp_err,
              "rows_within_tol_of_local": share, "row_tol": EP_ROW_TOL,
              "device_ms": {b: r["device_ms"] for b, r in runs.items()},
              "local_device_ms": local_ms,
              "launches": {b: r["launches"] for b, r in runs.items()},
              "init_s": init_s}
    del runs, y, comp, local, layer, p
    # the served path: 2 layers, PagedServer, EP on "gascore"
    ctx = RunCtx(ep_grid=EP_GRID, moe_backend="gascore")
    server = RecordingPagedServer(model, ctx, params, 4, CACHE_LEN,
                                  device="cuda", page_tokens=PAGE_TOKENS)
    prefills, prefill_one = [0], server._prefill_one

    def counted_prefill(*a):
        prefills[0] += 1
        return prefill_one(*a)

    server._prefill_one = counted_prefill
    for r in requests(cfg.vocab)[:4]:
        r.max_new = 16
        server.submit(r)
    reset_counts(ALL_KERNELS)  # the main path starts here
    stats = server.run_until_drained()
    launches = counts(ALL_KERNELS)
    outs = {r.rid: r.out for r in server.finished}
    steps = server.paged_decode_steps
    calls = prefills[0] + steps
    n_moe = cfg.layer_kinds().count("moe")
    want = {"moe_router": n_moe * EP_GRID[1] * calls,
            "ring_shift": n_moe * 2 * (EP_GRID[1] - 1) * calls,
            "paged_attention": cfg.n_layers * steps}
    if ({k: launches[k] for k in want} != want or len(outs) != 4
            or not server.all_finite or any(
                not 0 <= t < cfg.vocab for o in outs.values() for t in o)):
        raise AssertionError(f"moe_ep served: launches {launches}, want "
                             f"{want}; finished {sorted(outs)}")
    for k, n in launches.items():
        total[k] += n
    record["served"] = {
        "arch": cfg.name, "layers": cfg.n_layers,
        "reduced": {"n_layers": [ARCHS["arctic-480b"].n_layers, MOE_LAYERS]},
        "server": "PagedServer", "engine": "gascore", "batch": 4,
        "requests": stats["requests"], "decoded_tokens": stats["decoded_tokens"],
        "tok_per_s": stats["tok_per_s"], "prefills": prefills[0],
        "decode_steps": steps,
        "decode_step_ms_median": 1e3 * float(np.median(server.step_s)),
        "launches": {k: launches[k] for k in want}}
    del server, prefill_one, counted_prefill, params, model
    free()
    emit({"phase": "moe_ep", **record, "launches_total": total,
          "seconds": time.perf_counter() - t0})
    return total


# --------------------------------------------------------------------------- #
# the analysis tools against real qwen3-4b steps (launch/dryrun.py)
# --------------------------------------------------------------------------- #
DRYRUN_ARCH = "qwen3-4b"
# the registry's cell, the shape run here, what was cut, and whether a
# third run is profiled.  The prefill's attention is plain f32 torch over
# the whole score matrix: 36.0 s a run at 32,768 on an NVIDIA H100 80GB
# HBM3 at 700 W, so it runs at 16,384, timed by events only (its device
# is busy through the call)
DRYRUN_STEPS = [
    ("train_4k", ShapeConfig("train_4k", "train", 4096, 2),
     "global_batch 256->2", True),
    ("prefill_32k", ShapeConfig("prefill_32k", "prefill", 16384, 1),
     "global_batch 32->1, seq_len 32768->16384", False),
    ("decode_32k", ShapeConfig("decode_32k", "decode", 32768, 8),
     "global_batch 128->8", True),
]


def dryrun_args(model, ctx, shape, opt_cfg, params, gen):
    """The step's arguments on the card, laid out as
    ``dryrun.step_structs`` lays them out: the training batch from the
    synthetic stream, a prefill's random tokens, and a decode step at the
    last slot of a cache whose every slot holds a position (the step
    reads the whole cache)."""
    B, S, dev = shape.global_batch, shape.seq_len, torch.device("cuda")
    V = model.cfg.vocab
    if shape.kind == "train":
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
            model.cfg, B, S, seed=0).batch_at(0).items()}
        return params, adamw.init_state(params, opt_cfg), batch
    if shape.kind == "prefill":
        return params, {"inputs": torch.randint(
            0, V, (B, S), generator=gen, device=dev, dtype=torch.int32)}
    caches = tree_map(
        lambda st: torch.zeros(st.shape, dtype=st.dtype, device=dev),
        model.cache_structs(shape, ctx))
    for seg in caches:
        for block in seg.values():
            pos = block["attn"]["pos"]  # (L, B, W)
            pos.copy_(torch.arange(pos.shape[-1], dtype=pos.dtype,
                                   device=dev).expand(pos.shape))
    token = torch.randint(0, V, (B, 1), generator=gen, device=dev,
                          dtype=torch.int32)
    positions = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    return params, token, positions, caches


def dryrun_step(model, ctx, shape, opt_cfg, args, profiled):
    """One step kind: the dry run on ``meta``, the same step on the card
    under the op-stream counter (the counts must be equal, the predicted
    argument bytes the held ones, each kernel launched as often as
    counted), then timed (CUDA events around one call) and, if
    ``profiled``, profiled (the device's busy time); the roofline terms
    from the dry run's record."""
    t0 = time.perf_counter()
    rec = dryrun.run_cell(DRYRUN_ARCH, shape, "h100", out_dir=None)
    if rec["status"] != "ok":
        raise AssertionError(f"dryrun {shape.name}: {rec['error']}")
    meta_s = time.perf_counter() - t0
    step = dryrun.make_step(model, ctx, shape, opt_cfg)
    held = sum(t.numel() * t.element_size() for t in tree_leaves(args))
    if rec["memory"]["argument_size_in_bytes"] != held:
        raise AssertionError(
            f"dryrun {shape.name}: predicted argument bytes "
            f"{rec['memory']['argument_size_in_bytes']}, held {held}")
    reset_counts(ALL_KERNELS)  # the main path starts here
    with hlostats.OpCounter() as counter:
        step(*args)
    torch.cuda.synchronize()
    real = counter.stats()
    got = {"flops": real.flops, "bytes": real.bytes,
           "collective_bytes": real.collective_bytes, "ops": real.ops,
           "kernels": real.kernels}
    want = {"flops": rec["cost"]["flops"],
            "bytes": rec["cost"]["bytes_accessed"],
            "collective_bytes": rec["collectives"]["total"],
            "ops": rec["ops"], "kernels": rec["kernels"]}
    if got != want:
        raise AssertionError(f"dryrun {shape.name}: counted on the card "
                             f"{got}, on meta {want}")
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    step(*args)
    e1.record()
    e1.synchronize()
    step_ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_call(lambda: step(*args)) if profiled else {}
    runs = 3 if profiled else 2
    launches = {k: v for k, v in counts(ALL_KERNELS).items() if v}
    want_launches = {k: runs * n for k, n in real.kernels.items()
                     if k in ALL_KERNELS}
    if launches != want_launches:
        raise AssertionError(f"dryrun {shape.name}: launches {launches} in "
                             f"{runs} runs, counted {real.kernels}")
    d = roofline.derive(rec)
    t_useful = d["model_flops"] / rec["n_devices"] / roofline.PEAK_BF16
    bound_s = max(d["t_compute_s"], d["t_memory_s"], d["t_collective_s"])
    return launches, {
        "shape": dataclasses.asdict(shape), "reduced": None,
        "meta_s": meta_s, "step_ms": step_ms,
        "busy_ms": prof.get("device_busy_ms"), "flash_ms": prof.get("flash_ms"),
        "gemm_ms": prof.get("gemm_ms"), "other_ms": prof.get("other_ms"),
        "kernels_profiled": prof.get("kernels"),
        "argument_bytes": held, "peak_allocated_bytes": peak,
        "temp_bytes": peak - held, "counted": got,
        "counted_equal_on_meta": True, "launches": launches,
        "t_compute_s": d["t_compute_s"], "t_memory_s": d["t_memory_s"],
        "t_collective_s": d["t_collective_s"], "dominant": d["dominant"],
        "roofline_fraction": d["roofline_fraction"],
        "useful_ratio": d["useful_ratio"], "model_flops": d["model_flops"],
        # the measured step against the same terms
        "measured_fraction": t_useful / (step_ms / 1e3),
        "bound_over_measured": bound_s / (step_ms / 1e3),
    }


def dryrun_phase():
    """qwen3-4b at full width and depth (36 layers, bf16, weights random
    from seed 0): one train, prefill and decode step on the ``h100``
    mesh, each dry-run on ``meta`` and run on the card (``dryrun_step``).
    Returns the kernels' launches."""
    free()
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[DRYRUN_ARCH]
    model = build_model(cfg)
    ctx = dryrun.build_ctx(dryrun.mesh_of("h100"))
    opt_cfg = dryrun.opt_config(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tree_map(lambda t: t.requires_grad_(),
                      model.init(ctx, gen, device="cuda"))
    steps, total = {}, {}
    for cell, shape, reduced, profiled in DRYRUN_STEPS:
        t0 = time.perf_counter()
        args = dryrun_args(model, ctx, shape, opt_cfg, params, gen)
        launches, steps[cell] = dryrun_step(model, ctx, shape, opt_cfg, args,
                                            profiled)
        steps[cell]["reduced"] = reduced
        steps[cell]["seconds"] = time.perf_counter() - t0
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del args
        free()
    if not all(total.get(k) for k in FLASH_KERNELS):
        raise AssertionError(f"dryrun: flash kernels not all launched {total}")
    emit({"phase": "dryrun", "arch": cfg.name, "layers": cfg.n_layers,
          "dtype": "bfloat16", "mesh": "h100", "card": card(),
          "steps": steps, "launches": total})
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    # f32 products in full f32 (a stated reference, not TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sources = build.sources()  # every csrc/*.cu: eight libraries
    seconds = build.build_all(sources)
    emit({"phase": "build", "kernels": sources, "seconds": seconds,
          "arch": "sm_90a", "nvcc_flags": list(build.NVCC_FLAGS)})

    seconds_by_phase = []

    def timed(fn, *args):
        """``fn(*args)``, its wall seconds kept for the ``timing`` line."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds_by_phase.append(
            [" ".join([fn.__name__] + [a for a in args if isinstance(a, str)]),
             time.perf_counter() - t0])
        return out

    kernel = timed(kernel_phase)
    gas_figures = timed(gascore_kernel_phase)
    gas_launches = timed(gas_phase)
    overlap_launches = timed(overlap_phase)
    served = timed(serve_phase)
    launches = served["launches"]
    suites_launches = timed(gas_suites_phase, served)
    disagg_launches = timed(serve_disagg_phase, served)
    tp_launches = timed(serve_tp_phase, served)
    ft_launches = timed(serve_ft_phase, served)
    profile_launches = timed(profile_obs_phase, served)
    del served
    pygc.collect()
    torch.cuda.empty_cache()
    flash_figures = timed(flash_phase)
    scan_figures = timed(scan_phase)
    flash_launches = timed(train_phase)
    pygc.collect()  # the training phase's ~48 GiB
    torch.cuda.empty_cache()
    dp_launches = timed(train_dp_phase)
    pipe_launches = timed(pipeline_phase)
    timed(scan_chunked_phase)
    slice14 = {k: dp_launches[k] + pipe_launches[k] + profile_launches[k]
               for k in dp_launches}
    scan_launches = {
        "selective_scan": timed(serve_recurrent_phase, "falcon-mamba-7b"),
        "gated_linear_scan": timed(serve_recurrent_phase,
                                   "recurrentgemma-9b"),
    }
    router_figures = timed(router_phase)
    router_launches = (timed(serve_moe_phase, "kimi-k2-1t-a32b")
                       + timed(serve_moe_phase, "arctic-480b"))
    zoo_serve = timed(serve_zoo_phase)
    zoo_train = timed(train_zoo_phase)
    zoo_ep = timed(moe_ep_phase)
    slice15 = {k: zoo_serve[k] + zoo_train.get(k, 0) + zoo_ep[k]
               for k in zoo_serve}
    dryrun_launches = timed(dryrun_phase)
    router_launches += slice15["moe_router"]
    emit({"phase": "timing", "build_s": seconds,
          "seconds_by_phase": seconds_by_phase})

    print(card(), flush=True)
    k = kernel["bfloat16"]
    emit({"kernels": [{
        "name": pa.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:184",
        "launches": launches + disagg_launches["paged_attention"]
        + overlap_launches["paged_attention"] + tp_launches["paged_attention"]
        + ft_launches["paged_attention"] + slice14["paged_attention"]
        + slice15["paged_attention"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
    }] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{where}",
        "launches": gas_launches[name] + disagg_launches.get(name, 0)
        + overlap_launches.get(name, 0) + tp_launches.get(name, 0)
        + ft_launches.get(name, 0) + slice14[name] + slice15[name]
        + suites_launches[name],
        **{key: gas_figures[name]["16MiB"][key] for key in (
            "max_abs_err", "plain_ms", "bound_ms", "bound_by")},
        # the device's time alone, the kernel's and the library call's
        "ms": gas_figures[name]["16MiB"]["device_ms"],
        "library_ms": gas_figures[name]["16MiB"]["library_device_ms"],
    } for name, (_, src, where) in GAS_KERNELS.items()] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{where}",
        "launches": flash_launches[name] + slice14[name] + slice15[name]
        + dryrun_launches.get(name, 0),
        **{key: flash_figures[name][key] for key in (
            "max_abs_err", "plain_ms", "bound_ms", "bound_by")},
        # the device's time alone, the kernel's and the library call's
        "ms": flash_figures[name]["device_ms"],
        "library_ms": flash_figures[name]["library_device_ms"],
    } for name, (_, src, where) in FLASH_KERNELS.items()] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{where}",
        "launches": scan_launches[name] + slice15[name],
        **{key: scan_figures[name][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, (_, src, where) in SCAN_KERNELS.items()] + [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{where}",
        "launches": router_launches,
        **{key: router_figures[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, (_, src, where) in ROUTER_KERNELS.items()]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
