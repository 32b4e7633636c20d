"""The benchmark's yardstick of work: the card's peaks, each kernel's
bytes and flops, and the model flops of a step.

The peaks and the three kernel formulas are frozen copies of
``src/repro_torch/kernels/cost.py`` at commit
71347f761a99dddfc5eefd7e024427e99c643bd7 (``PEAK_FLOPS``,
``HBM_BYTES_PER_S``, ``attention_pairs``, ``flash_work``, ``scan_work``,
``paged_attention_work``), with dtypes named by strings so that nothing
here imports the program.  A later change to ``cost.py`` does not move
the benchmark.

The model flops are the benchmark's own, written from the layer
equations (``PERF.md`` works granite's and falcon's figures by hand):
every matrix product with a weight, the LM head included, at 2 flops a
multiply-add; attention's score and value products over the causal
pairs; nothing for the embedding lookup, the norms, the convolution,
the scan's element-wise recurrence or its A and D.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """Least seconds for the work: the larger of its bytes over the HBM
    rate and its flops over ``dtype``'s peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# --------------------------------------------------------------------------- #
# kernels (frozen copies)
# --------------------------------------------------------------------------- #
def attention_pairs(Sq: int, Sk: int, causal: bool, window=None) -> int:
    """The (q, k) pairs a causal / windowed mask leaves visible, row by
    row in closed form."""
    total = 0
    for i in range(Sq):
        lo, hi = 0, Sk - 1
        if causal:
            hi = min(hi, i)
        if window is not None:
            lo = max(lo, i - window + 1)
            if not causal:
                hi = min(hi, i + window - 1)
        total += max(hi - lo + 1, 0)
    return total


def causal_pairs(S: int) -> int:
    """``attention_pairs(S, S, True)`` without the loop."""
    return S * (S + 1) // 2


def flash_work(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int,
               causal: bool, window, dtype: str) -> Dict[str, Tuple[int, int]]:
    """Per kernel, ``(bytes, flops)``: q, k, v, dO, O in ``dtype``, the
    log-sum-exp and delta rows in f32, each read or written once; 2 D
    flops per visible pair per product, 2 products in the forward, 4 in
    dK/dV, 3 in dQ."""
    elem = ELEM[dtype]
    pairs = (causal_pairs(Sq) if causal and window is None and Sq == Sk
             else attention_pairs(Sq, Sk, causal, window))
    qb, kb, rows = B * Hq * Sq * D * elem, B * Hkv * Sk * D * elem, B * Hq * Sq * 4
    work = {
        "fwd": (2 * qb + 2 * kb + rows, 2),
        "dkv": (2 * qb + 4 * kb + 2 * rows, 4),
        "dq": (3 * qb + 2 * kb + 2 * rows, 3),
    }
    return {name: (nbytes, products * 2 * D * pairs * B * Hq)
            for name, (nbytes, products) in work.items()}


def paged_attention_work(lengths: Sequence[int], hq: int, hkv: int, D: int,
                         page_tokens: int, dtype: str) -> Tuple[int, int]:
    """``(bytes, flops)``: the K and V rows of each live position read
    once, q, the lengths and the live table entries read once, the output
    written once; 4 flops per (q head, live position, dim)."""
    elem = ELEM[dtype]
    live = [int(n) for n in lengths]
    nbytes = (sum(live) * hkv * D * 2 * elem + 2 * len(live) * hq * D * elem
              + sum(-(-n // page_tokens) for n in live) * 4 + len(live) * 4)
    return nbytes, 4 * hq * D * sum(live)


def scan_work(name: str, case: Tuple[int, ...], dtype: str) -> Tuple[int, int]:
    """``(bytes, flops)`` of the selective scan (``fwd``) or its backward
    (``bwd``) on ``(B, S, Di, N)``."""
    elem = ELEM[dtype]
    B, S, Di, N = case
    if name == "fwd":
        nbytes = (B * S * Di * (2 * elem + 4) + 2 * B * S * N * elem
                  + Di * N * 4 + Di * 4 + B * Di * N * 4)
        return nbytes, B * S * Di * (7 * N + 3)
    if name == "bwd":
        nbytes = (B * S * Di * (3 * elem + 8) + 4 * B * S * N * elem
                  + 2 * Di * N * 4 + 2 * Di * 4)
        return nbytes, B * S * Di * (19 * N + 9)
    raise ValueError(f"no scan {name!r}")


# --------------------------------------------------------------------------- #
# model flops (the benchmark's own)
# --------------------------------------------------------------------------- #
def matmul_params(m: Mapping) -> Dict[str, int]:
    """Weights that enter a matrix product, per layer and in the LM head,
    from a configuration's ``model`` block."""
    D, V = m["d_model"], m["vocab"]
    if m["family"] == "dense":
        H, KH, Dh, F = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
        attn = D * H * Dh + 2 * D * KH * Dh + H * Dh * D
        mlp = (3 if m.get("mlp_gated") else 2) * D * F
        layer = attn + mlp
    elif m["family"] == "mamba":
        Di, N, R = m["d_inner"], m["ssm_state"], m["dt_rank"]
        # in_x, in_gate; x_proj; dt_proj; out_proj (not A, D or the conv)
        layer = 2 * D * Di + Di * (R + 2 * N) + R * Di + Di * D
    else:
        raise ValueError(f"no flop formula for family {m['family']!r}")
    return {"layer": layer, "layers": layer * m["layers"], "head": D * V}


def attention_flops(m: Mapping, pairs: int) -> int:
    """Forward flops of the score and value products over ``pairs``
    visible (query, key) pairs in every layer."""
    if m["family"] != "dense":
        return 0
    return 4 * m["n_heads"] * m["head_dim"] * pairs * m["layers"]


def train_step_flops(m: Mapping, B: int, S: int) -> int:
    """A training step over ``B`` sequences of ``S`` tokens: 3x the
    forward (forward, then the two backward products), recomputation not
    counted."""
    mm = matmul_params(m)
    fwd = 2 * (mm["layers"] + mm["head"]) * B * S
    fwd += attention_flops(m, B * causal_pairs(S))
    return 3 * fwd


def prefill_flops(m: Mapping, S: int) -> int:
    """A prefill of ``S`` prompt tokens that yields one token's logits."""
    mm = matmul_params(m)
    return 2 * mm["layers"] * S + 2 * mm["head"] + attention_flops(
        m, causal_pairs(S))


def decode_flops(m: Mapping, position: int) -> int:
    """One decoded token at ``position`` (it attends ``position + 1``
    keys)."""
    mm = matmul_params(m)
    return 2 * (mm["layers"] + mm["head"]) + attention_flops(m, position + 1)
