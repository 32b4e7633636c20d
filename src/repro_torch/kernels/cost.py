"""The card's peaks and the work of each hand kernel, in one place.

Two readers:

- ``chip_smoke.py`` prices each kernel's least time (its bound) from
  these constants and work formulas;
- the op-stream counter (``launch/hlostats.py``) counts each kernel call
  as ONE op with the work of what it computes, whatever implements it:
  the CUDA kernel, its plain version on the CPU, or a shape-only
  stand-in on ``meta``.  A step therefore counts the same on ``meta``,
  the CPU and the card.

The peaks are the H100 SXM's published ones (NVIDIA data sheet, dense,
at 700 W).  Work counts each input read once and each output written
once; flops count what the kernel's arithmetic needs.  Where a kernel's
work depends on data (paged attention stops at each row's length), the
bound takes the data (``paged_attention_work(lengths=...)``) and the
counter, which reads no device value, counts the table's capacity.

Counting protocol: a kernel entry point wraps its call in
:func:`kernel`; when a counter is active (:func:`counting`), the call is
reported once and every op dispatched inside it is left out, nested
reports included (a GAS all-reduce made of GAScore rings counts as one
all-reduce).  :func:`per_rank` marks an SPMD node program over ``n``
ranks: the counter divides what it sees there by ``n``, so a rank's
share is counted, as the reference's per-device HLO counts it.  The
state is process-wide (not per thread): the autograd engine runs a
CUDA backward on a thread of its own.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "HBM_BYTES_PER_S",
    "PEAK_FLOPS",
    "COLLECTIVES",
    "bound",
    "attention_pairs",
    "flash_work",
    "paged_attention_work",
    "gascore_bytes",
    "scan_work",
    "router_work",
    "kernel",
    "counting",
    "per_rank",
    "ranks",
    "suppressed",
]

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# the reference's collective types (hlostats.COLLECTIVES)
COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> Dict:
    """Least time for the work: the larger of its bytes over the HBM
    rate and its flops over ``dtype``'s peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _elem(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


# --------------------------------------------------------------------------- #
# flash attention (forward, dK/dV, dQ)
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=256)
def attention_pairs(Sq: int, Sk: int, causal: bool,
                    window: Optional[int]) -> int:
    """The (q, k) pairs ``ref.attention_mask`` leaves visible, counted
    row by row in closed form (no (Sq, Sk) mask)."""
    i = np.arange(Sq, dtype=np.int64)
    lo = np.zeros(Sq, dtype=np.int64)
    hi = np.full(Sq, Sk - 1, dtype=np.int64)
    if causal:
        hi = np.minimum(hi, i)
    if window is not None:
        lo = np.maximum(lo, i - window + 1)
        if not causal:
            hi = np.minimum(hi, i + window - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int,
               causal: bool, window: Optional[int],
               dtype: torch.dtype) -> Dict[str, Tuple[int, int]]:
    """Per kernel, ``(bytes, flops)``: q, k, v, dO, O in ``dtype``, the
    log-sum-exp and delta rows in f32, each read or written once; 2 D
    flops per visible pair per product, 2 products in the forward (q.k,
    p.v), 4 in dK/dV (q.k, dO.v, p^T.dO, dS^T.q), 3 in dQ (q.k, dO.v,
    dS.k)."""
    elem = _elem(dtype)
    pairs = attention_pairs(Sq, Sk, causal, window)
    qb, kb, rows = B * Hq * Sq * D * elem, B * Hkv * Sk * D * elem, B * Hq * Sq * 4
    work = {  # name: (bytes, products)
        "flash_attention_fwd": (2 * qb + 2 * kb + rows, 2),
        "flash_attention_dkv": (2 * qb + 4 * kb + 2 * rows, 4),
        "flash_attention_dq": (3 * qb + 2 * kb + 2 * rows, 3),
    }
    return {name: (nbytes, products * 2 * D * pairs * B * Hq)
            for name, (nbytes, products) in work.items()}


# --------------------------------------------------------------------------- #
# paged attention
# --------------------------------------------------------------------------- #
def paged_attention_work(lengths: Sequence[int], hq: int, hkv: int, D: int,
                         page_tokens: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(bytes, flops)``: the K and V rows of each live position read
    once (the kernel loads none past the length), q, the lengths and the
    live entries of the table read once, the output written once; 4
    flops per (q head, live position, dim) for q.k and p.v.  ``lengths``
    are the live positions of each row (at most the table's capacity)."""
    elem = _elem(dtype)
    live = [int(n) for n in lengths]
    nbytes = (sum(live) * hkv * D * 2 * elem + 2 * len(live) * hq * D * elem
              + sum(-(-n // page_tokens) for n in live) * 4 + len(live) * 4)
    return nbytes, 4 * hq * D * sum(live)


# --------------------------------------------------------------------------- #
# GAScore transport
# --------------------------------------------------------------------------- #
def gascore_bytes(name: str, n: int, row_bytes: int) -> int:
    """Bytes a GAScore kernel moves over ``n`` ranks of ``row_bytes``
    each: a put reads every row once and writes it once; the all-gather
    reads the n rows and writes n copies of all of them; the
    reduce-scatter reads the n rows and writes one row's worth."""
    if name in ("ring_shift", "perm_put", "offset_put"):
        return 2 * n * row_bytes
    if name == "ring_all_gather":
        return n * row_bytes + n * n * row_bytes
    if name == "ring_reduce_scatter":
        return n * row_bytes + row_bytes
    raise ValueError(f"no GAScore kernel {name!r}")


# --------------------------------------------------------------------------- #
# the scans and the router (f32 arithmetic on either dtype)
# --------------------------------------------------------------------------- #
def scan_work(name: str, case: Tuple[int, ...],
              dtype: torch.dtype) -> Tuple[int, int]:
    """``(bytes, flops)`` of a scan: ``selective_scan`` on ``(B, S, Di,
    N)`` (x in and y out in ``dtype``, dt in f32, the B and C rows in
    ``dtype``, A, D and the final state in f32), ``gated_linear_scan`` on
    ``(B, S, W)`` (a, b in and h out in ``dtype``).  Per (b, t, channel, state) of the selective scan: dt*A, exp,
    decay*h, dx*B, +, C*h, + (an exponential counts as one operation);
    per (b, t, channel): dt*x, D*x, +.  The RG-LRU: a*h + b."""
    elem = _elem(dtype)
    if name == "selective_scan":
        B, S, Di, N = case
        nbytes = (B * S * Di * (2 * elem + 4) + 2 * B * S * N * elem
                  + Di * N * 4 + Di * 4 + B * Di * N * 4)
        return nbytes, B * S * Di * (7 * N + 3)
    if name == "gated_linear_scan":
        B, S, W = case
        return 3 * B * S * W * elem, 2 * B * S * W
    raise ValueError(f"no scan {name!r}")


def router_work(T: int, E: int, K: int) -> Tuple[int, int]:
    """``(bytes, flops)`` of the MoE router: the (T, E) f32 logits read
    once and 13 bytes written per choice; per logit a subtract, an exp,
    an add, a divide, and a compare in each of K rounds."""
    return 4 * T * E + 13 * T * K, T * E * (4 + K)


# --------------------------------------------------------------------------- #
# the counting protocol
# --------------------------------------------------------------------------- #
class _State:
    sinks: list = []  # active counters, innermost last
    depth = 0  # > 0 inside a reported call: nested work is not counted
    ranks = 1  # the ranks of the SPMD program being run


_STATE = _State()


@contextlib.contextmanager
def counting(sink) -> Iterator[None]:
    """Make ``sink`` (an object with ``record(name, flops, nbytes,
    collective, coll_bytes)``) the active counter."""
    _STATE.sinks.append(sink)
    try:
        yield
    finally:
        _STATE.sinks.remove(sink)


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float,
           collective: Optional[str] = None,
           coll_bytes: float = 0.0) -> Iterator[None]:
    """One call of a hand kernel (or one collective, ``collective`` its
    type and ``coll_bytes`` its operand bytes), its work as dispatched
    (all ranks of a rank-stacked tensor): reported to the active counter
    unless it runs inside another report; nothing dispatched inside it
    is counted."""
    if _STATE.sinks and _STATE.depth == 0:
        _STATE.sinks[-1].record(name, flops, nbytes, collective, coll_bytes)
    _STATE.depth += 1
    try:
        yield
    finally:
        _STATE.depth -= 1


@contextlib.contextmanager
def per_rank(n: int) -> Iterator[None]:
    """Counts inside are one rank's of ``n`` (an SPMD node program)."""
    prev, _STATE.ranks = _STATE.ranks, _STATE.ranks * max(int(n), 1)
    try:
        yield
    finally:
        _STATE.ranks = prev


def ranks() -> int:
    return _STATE.ranks


def suppressed() -> bool:
    """True inside a reported call."""
    return _STATE.depth > 0
