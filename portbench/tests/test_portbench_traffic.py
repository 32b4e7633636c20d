"""The traffic generators: the same seed gives the same inputs, seeds
differ, and every seed gets the same set of sizes."""

import itertools
from collections import Counter

import numpy as np
import pytest

from portbench import manifest as mf
from portbench.traffic import serve_closed, train

from conftest import SERVE_MIX

SEEDS = [2**31 + 11, 2**31 + 12]


def _take(mix, seed, n):
    return list(itertools.islice(serve_closed.requests(mix, 49152, seed), n))


def test_serving_stream_repeats_for_a_seed_and_differs_across_seeds():
    mix = SERVE_MIX
    a, b = _take(mix, SEEDS[0], 64), _take(mix, SEEDS[0], 64)
    c = _take(mix, SEEDS[1], 64)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
    assert any(len(x[0]) != len(y[0]) or not np.array_equal(x[0], y[0])
               for x, y in zip(a, c))


def test_serving_sizes_are_the_same_set_for_every_seed():
    mix = SERVE_MIX
    n = mix["pool"]
    sets = [Counter((len(p), m) for p, m in _take(mix, s, n)) for s in SEEDS]
    assert sets[0] == sets[1] == Counter(serve_closed.sizes(mix))


def test_serving_sizes_keep_to_the_mix():
    mix = SERVE_MIX
    sizes = serve_closed.sizes(mix)
    prompts = sorted(p for p, _ in sizes)
    outs = [o for _, o in sizes]
    assert prompts[0] >= mix["prompt"]["min"] and prompts[-1] <= mix["prompt"]["max"]
    assert abs(prompts[len(prompts) // 2] - mix["prompt"]["median"]) <= 8
    assert min(outs) == mix["output"]["min"] and max(outs) == mix["output"]["max"]
    assert prompts[-1] + max(outs) < mix["cache_len"] - 1


def test_every_block_of_the_stream_holds_each_length_stratum():
    mix = SERVE_MIX
    k, n = mix["strata"], mix["pool"]
    edges = sorted(p for p, _ in serve_closed.sizes(mix))
    stream = _take(mix, SEEDS[0], 4 * k)
    for b in range(4):
        lens = sorted(len(p) for p, _ in stream[b * k:(b + 1) * k])
        for g in range(k):
            lo, hi = edges[g * n // k], edges[(g + 1) * n // k - 1]
            assert lo <= lens[g] <= hi


@pytest.mark.parametrize("name", ["train.8k", "train.2x4k"])
def test_training_batches_repeat_for_a_seed_and_differ_across_steps(name):
    mix = dict(mf.mix(name), seq_len=64, window_batches=2)
    a = train.batches(mix, 512, SEEDS[0])
    b = train.batches(mix, 512, SEEDS[0])
    c = train.batches(mix, 512, SEEDS[1])
    assert len(a) == mix["check_steps"] + mix["window_batches"]
    assert all(np.array_equal(x["inputs"], y["inputs"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["inputs"], c[0]["inputs"])
    rows = {x["inputs"].tobytes() for x in a}
    assert len(rows) == len(a)
    assert a[0]["inputs"].shape == (mix["ga_steps"] * mix["batch"], 64)
    assert np.array_equal(a[0]["targets"][:, :-1], a[0]["inputs"][:, 1:])
