"""The plain versions of the port's five GAScore kernels against the JAX
reference.

``repro_torch.kernels.ref`` holds what the CUDA kernels of
``kernels/csrc/gascore_*.cu`` compute (the card tests hold the kernels
against them).  Here they meet the reference's numpy oracles
(``repro.kernels.ref``), act 3 of the reference's pipeline example, and the
reference's ring reduce-scatter run through its lockstep simulator.  Copies
must be byte-equal, int32 bit patterns in an f32 carrier included.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import collectives as jcoll
from repro.kernels import ref as jref
from repro.testing.sim import run_spmd as jrun_spmd
from repro_torch.kernels import ops, ref

DTYPES = ["float32", "bfloat16", "int32"]
NS = [2, 4, 8]


def _np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" else np.dtype(name)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _data(seed, shape, name):
    rng = np.random.default_rng(seed)
    if name == "int32":
        return rng.integers(-1000, 1000, size=shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32).astype(_np_dtype(name))


def _perm(n, seed):
    return tuple(int(d) for d in np.random.default_rng(seed).permutation(n))


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_copies_match_numpy_oracles(n, name):
    x = _data(n, (n, 3, 16), name)
    t = _to_torch(x)
    for k in (1, n - 1, n + 2):
        assert _bits(ops.ring_shift(t, k)) == _bits(jref.ring_shift(x, k % n))
    dst = _perm(n, n)
    assert _bits(ops.perm_put(t, dst)) == _bits(jref.perm_put(x, dst))
    assert _bits(ops.ring_all_gather(t)) == _bits(jref.all_gather(x))
    blocks = _data(n + 1, (n, n * 2, 8), name)
    assert _bits(ref.all_to_all(_to_torch(blocks))) == _bits(
        jref.all_to_all(blocks))


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_reduce_scatter_against_numpy_oracle(n, name):
    x = _data(7 * n, (n, n * 2, 8), name)
    got = ops.ring_reduce_scatter(_to_torch(x))
    want = jref.reduce_scatter(x.astype(np.float32) if name != "int32" else x)
    if name == "int32":
        np.testing.assert_array_equal(got.numpy(), want)  # numpy sums in int64
    else:
        # ring order vs numpy's order: reassociation over n terms, rounded
        # to the dtype after every add (bf16 keeps 8 mantissa bits)
        tol = 1e-5 if name == "float32" else 6e-2
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
    tot = ref.all_reduce(_to_torch(x))
    np.testing.assert_allclose(
        tot.float().numpy(), jref.all_reduce(x.astype(np.float32)),
        rtol=1e-5 if name != "bfloat16" else 6e-2, atol=1e-4)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", NS)
def test_ring_order_reduce_scatter_equals_reference_ring(n, name):
    """Byte-equal to the reference's ``collectives.ring_reduce_scatter``
    run through its lockstep simulator on one JAX device."""
    x = _data(11 * n, (n, n * 3, 5), name)
    outs = jrun_spmd(
        lambda e: jcoll.ring_reduce_scatter(e, jnp.asarray(x[e.rank])), n
    )
    want = np.stack([np.asarray(o) for o in outs])
    got = ops.ring_reduce_scatter(_to_torch(x))
    assert _bits(got) == _bits(want)


@settings(max_examples=25, deadline=None, database=None)
@given(
    n=st.sampled_from(NS),
    k=st.integers(-9, 9),
    rows=st.integers(1, 5),
    seed=st.integers(0, 2**31 - 1),
)
def test_int32_patterns_survive_the_f32_carrier(n, k, rows, seed):
    """Random 32-bit words (NaN and infinity patterns among them) viewed as
    f32 arrive bit for bit through every copy."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-(2**31), 2**31 - 1, size=(n, rows, 4),
                         dtype=np.int64).astype(np.int32)
    words[0, 0, :3] = [0x7FC00001, 0x7F800000, -1]  # NaN, inf, NaN
    carrier = words.view(np.float32)
    t = _to_torch(carrier)
    assert _bits(ops.ring_shift(t, k)) == _bits(jref.ring_shift(carrier, k % n))
    dst = _perm(n, seed)
    assert _bits(ops.perm_put(t, dst)) == _bits(jref.perm_put(carrier, dst))
    assert _bits(ops.ring_all_gather(t)) == _bits(jref.all_gather(carrier))
    seg = np.zeros((n, rows + 3, 4), np.float32)
    off = torch.tensor(3, dtype=torch.int32)
    got = ops.offset_put(_to_torch(seg), t, off, k).numpy()
    for d in range(n):
        assert got[d, 3:].tobytes() == carrier[(d - k) % n].tobytes()
        assert not got[d, :3].any()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_offset_put_matches_pipeline_act3(n):
    """Act 3 of the reference's pipeline example: each node's KV block lands
    at offset S*KH*Dh of its right neighbour's cache segment
    (``examples/heterogeneous_pipeline.py:107-111``)."""
    S, KH, Dh = 32, 2, 16
    kv = np.random.default_rng(0).normal(size=(n, S * KH * Dh)).astype(
        np.float32)
    empty = np.zeros((n, 2 * S * KH * Dh), np.float32)
    off = torch.tensor(S * KH * Dh, dtype=torch.int32)
    got = ops.offset_put(_to_torch(empty), _to_torch(kv), off, 1).numpy()
    for d in range(n):
        np.testing.assert_array_equal(got[d, S * KH * Dh:], kv[(d - 1) % n])
        np.testing.assert_array_equal(got[d, : S * KH * Dh], 0.0)


def test_offset_put_per_rank_offsets_clamp_like_jax():
    seg = torch.zeros((3, 10, 2))
    data = torch.arange(3 * 4 * 2, dtype=torch.float32).reshape(3, 4, 2) + 1
    offs = torch.tensor([0, 6, 99], dtype=torch.int32)  # 99 clamps to 6
    got = ref.offset_put(seg, data, offs, 2)
    for r, o in enumerate([0, 6, 6]):
        d = (r + 2) % 3
        assert torch.equal(got[d, o:o + 4], data[r])
    assert torch.equal(seg, torch.zeros((3, 10, 2)))  # a new segment


def test_perm_put_rejects_a_non_bijection():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="bijection"):
        ops.perm_put(x, (0, 0, 1, 2))
    with pytest.raises(ValueError, match="bijection"):
        ops.perm_put(x, (0, 1, 2))
    # the software engine's partial permute: non-destinations get zeros
    got = ref.perm_put(torch.ones((4, 2)), (1, None, 3, None))
    assert got[[1, 3]].eq(1).all() and got[[0, 2]].eq(0).all()
