"""Training traffic: batches of a seeded synthetic token stream.

``SyntheticStream.batch_at`` is a frozen copy of
``src/repro_torch/data/synthetic.py``'s ``SyntheticLM.batch_at`` at
commit 71347f761a99dddfc5eefd7e024427e99c643bd7 (the text path only):
every batch is a pure function of ``(seed, step)``, Zipf-free uniform
first tokens with a planted bigram ``next = (5 tok + 7) % vocab`` kept
with probability ``structure``.  The work of a dense step does not
depend on the token values, so the window cycles a fixed set of
distinct batches made in set-up.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


class SyntheticStream:
    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int,
                 structure: float = 0.7):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed, self.structure = seed, structure

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq_len, self.vocab
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        noise = rng.random((B, S))
        rand_next = rng.integers(0, V, size=(B, S))
        for t in range(S):
            planted = (5 * toks[:, t] + 7) % V
            toks[:, t + 1] = np.where(
                noise[:, t] < self.structure, planted, rand_next[:, t]
            )
        return {
            "inputs": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32),
        }


def batches(mix: Mapping, vocab: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """The run's batches, one an optimizer step: ``ga_steps`` micro-batches
    of ``batch`` rows each, stacked row-wise.  The first ``check_steps``
    are the steps the reference follows, the rest the ``window_batches``
    the window cycles; all differ."""
    stream = SyntheticStream(vocab, mix["ga_steps"] * mix["batch"],
                             mix["seq_len"], seed, mix.get("structure", 0.7))
    n = mix["check_steps"] + mix["window_batches"]
    return [stream.batch_at(i) for i in range(n)]
