"""Paged attention of the port against the JAX reference.

The port's plain version (``repro_torch.kernels.ref.paged_attention``,
what ``ops.paged_attention`` runs on CPU tensors) is held against the
JAX oracle and against the Pallas kernel in interpret mode on the cases
of ``tests/test_kernels.py``: ragged tails, length 0, NaN pages.  The
CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa

# f32 CPU parity: the two frameworks sum in different orders
ATOL = 1e-5


def _case(seed, B, Hq, Hkv, D, T, NP, P=None, lengths=None):
    rng = np.random.default_rng(seed)
    P = P or B * NP + 2
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    table = rng.permutation(P)[: B * NP].reshape(B, NP).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(0, NP * T + 1, size=(B,))
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _port(q, kp, vp, table, lengths):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (q, kp, vp, table, lengths)]
    return ops.paged_attention(*t).numpy()


def _jax(q, kp, vp, table, lengths, impl):
    out = jops.paged_attention(
        *(jnp.asarray(x) for x in (q, kp, vp, table, lengths)), impl=impl
    )
    return np.asarray(out)


PA_CASES = [
    # (B, Hq, Hkv, D, page_tokens, n_pages): tests/test_kernels.py PA_CASES
    (2, 4, 2, 16, 4, 3),
    (1, 2, 2, 8, 8, 2),
    (3, 8, 2, 32, 16, 4),
    (2, 4, 1, 64, 8, 4),
    # the served shape of qwen3-4b SMOKE: GQA 4, head dim 16, 8-token pages
    (2, 8, 2, 16, 8, 4),
]


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("case", PA_CASES, ids=[str(c) for c in PA_CASES])
def test_plain_paged_attention_matches_jax(case, impl):
    args = _case(7, *case)
    np.testing.assert_allclose(
        _port(*args), _jax(*args, impl), atol=ATOL, rtol=ATOL
    )


ADV_CASES = [
    # (B, Hq, Hkv, NP): tests/test_kernels.py PA_ADV_CASES
    (1, 1, 1, 1),
    (2, 4, 1, 5),
    (3, 8, 1, 3),
    (5, 8, 2, 7),
    (2, 8, 8, 2),
]


@pytest.mark.parametrize("case", ADV_CASES, ids=[str(c) for c in ADV_CASES])
def test_boundary_lengths_and_zero_rows(case):
    B, Hq, Hkv, NP = case
    D, T = 16, 4
    edge = [0, 1, T, min(2 * T, NP * T), NP * T]
    lengths = (edge * ((B + 4) // 5))[:B]
    args = _case(11, B, Hq, Hkv, D, T, NP, lengths=lengths)
    got = _port(*args)
    np.testing.assert_allclose(got, _jax(*args, "ref"), atol=ATOL, rtol=ATOL)
    zero_rows = args[4] == 0
    assert (got[zero_rows] == 0).all()


def test_nan_pages_and_tails_never_reach_the_output():
    B, Hq, Hkv, D, T = 2, 4, 2, 16, 4
    q, kp, vp, _, _ = _case(3, B, Hq, Hkv, D, T, 3, P=8)
    table = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    lengths = np.asarray([5, 9], np.int32)
    kp[2], vp[2] = np.nan, np.inf  # dead page of row 0
    kp[1, 1:], vp[1, 1:] = np.inf, np.nan  # masked tail of row 0's page 1
    kp[5, 1:], vp[5, 1:] = np.nan, np.nan  # masked tail of row 1's page 5
    got = _port(q, kp, vp, table, lengths)
    assert np.isfinite(got).all()
    for impl in ("ref", "pallas"):
        np.testing.assert_allclose(
            got, _jax(q, kp, vp, table, lengths, impl), atol=ATOL, rtol=ATOL
        )


def test_padded_slots_alias_any_page():
    q, kp, vp, _, _ = _case(5, 1, 2, 1, 8, 4, 3, P=4)
    lengths = np.asarray([5], np.int32)
    a = _port(q, kp, vp, np.asarray([[0, 1, 2]], np.int32), lengths)
    b = _port(q, kp, vp, np.asarray([[0, 1, 0]], np.int32), lengths)
    np.testing.assert_array_equal(a, b)


def test_plain_attention_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 4, 16, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, 16, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, 16, 8)).astype(np.float32)
    for causal, window in ((True, None), (True, 4), (False, None), (False, 3)):
        got = ref.attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, window=window,
        ).numpy()
        want = np.asarray(jref.attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            causal=causal, window=window,
        ))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches only on CUDA tensors: a CPU tensor is
    refused, never silently computed by the plain version."""
    t = [torch.from_numpy(x) for x in _case(1, 1, 2, 1, 8, 4, 2)]
    launches = pa.paged_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(*t)
    assert pa.paged_attention.launches == launches
