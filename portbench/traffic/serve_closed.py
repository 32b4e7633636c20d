"""Serving traffic for a closed loop of clients.

Every seed gets the same set of request sizes: ``pool`` prompt lengths
at evenly spaced quantiles of a clipped log-normal and as many output
lengths at evenly spaced quantiles of a uniform range, paired once by a
fixed permutation.  The seed only orders them and draws the prompt
token ids.  The order is stratified: the prompts are cut by length into
``strata`` groups, and each run of ``strata`` consecutive requests takes
one prompt from every group, so any prefix of the stream that a window
consumes holds the same mix of lengths.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Iterator, List, Mapping, Tuple

import numpy as np


def sizes(mix: Mapping) -> List[Tuple[int, int]]:
    """``(prompt_len, max_new)`` of the pool, sorted by prompt length."""
    n = mix["pool"]
    p = mix["prompt"]
    o = mix["output"]
    nd = NormalDist()
    prompts = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        length = round(p["median"] * math.exp(p["sigma"] * z))
        prompts.append(min(max(length, p["min"]), p["max"]))
    span = o["max"] - o["min"] + 1
    outs = [o["min"] + int((i + 0.5) / n * span) for i in range(n)]
    pairing = np.random.default_rng(mix["pairing_seed"]).permutation(n)
    return [(prompts[i], outs[pairing[i]]) for i in range(n)]


def requests(mix: Mapping, vocab: int, seed: int) -> Iterator[Tuple[np.ndarray, int]]:
    """The endless stream of ``(prompt token ids, max_new)`` for ``seed``:
    pass after pass over the pool, each in a stratified order of its own."""
    pool = sizes(mix)
    k = mix["strata"]
    n = len(pool)
    if n % k:
        raise ValueError(f"pool {n} is not a multiple of strata {k}")
    rng = np.random.default_rng(seed)
    per = n // k
    while True:
        groups = [rng.permutation(per) + g * per for g in range(k)]
        for j in range(per):
            block = [int(groups[g][j]) for g in range(k)]
            for i in rng.permutation(k):
                plen, max_new = pool[block[i]]
                ids = rng.integers(0, vocab, size=plen, dtype=np.int64)
                yield ids.astype(np.int32), max_new
