"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device.  This file imports no
JAX, so it runs on a machine with PyTorch and the CUDA toolkit alone:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]
)
def test_cuda_kernel_matches_plain(cuda, dtype, atol):
    """On the card: the hand kernel against the plain version, NaN pages
    in padded table slots, ragged lengths 0..NP*T (bf16 output rounding
    sets its tolerance)."""
    B, Hq, Hkv, D, T, NP = 5, 32, 8, 128, 16, 6
    rng = np.random.default_rng(2)
    P = B * NP + 1
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    lengths = np.asarray([0, 1, 17, 64, 96], np.int32)
    kp[-1], vp[-1] = np.nan, np.nan
    perm = rng.permutation(B * NP)
    table = perm.reshape(B, NP).astype(np.int32)
    for b in range(B):
        table[b, -(-int(lengths[b]) // T):] = B * NP  # the NaN page
    args = [torch.from_numpy(x).to(cuda) for x in (q, kp, vp, table, lengths)]
    args[:3] = [x.to(dtype) for x in args[:3]]
    before = pa.paged_attention.launches
    got = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = ref.paged_attention(*args)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
def test_cuda_kernel_reads_a_layer_slice_by_strides(cuda):
    """One layer of an (L, P, T, Hkv, D) pool, as the decode step passes
    it; a wrong dtype or a CPU tensor is refused without a launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    pools = torch.randn((3, 9, 16, 2, 64), generator=g, device=cuda)
    q = torch.randn((2, 8, 64), generator=g, device=cuda)
    table = torch.tensor([[3, 1, 8], [0, 2, 5]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([40, 7], dtype=torch.int32, device=cuda)
    got = ops.paged_attention(q, pools[1], pools[2], table, lengths)
    want = ref.paged_attention(q, pools[1], pools[2], table, lengths)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    before = pa.paged_attention.launches
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), pools[1].half(), pools[2].half(),
                           table, lengths)
    with pytest.raises(TypeError):
        pa.paged_attention(q, pools[1], pools[2], table.long(), lengths)
    assert pa.paged_attention.launches == before


# --------------------------------------------------------------------------- #
# GAScore kernels (csrc/gascore_put.cu, csrc/gascore_ring.cu)
# --------------------------------------------------------------------------- #
def _bits(t):
    """The raw bytes of a tensor: the copies must be byte-equal."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _payload(cuda, n, shape, dtype, seed):
    """(n, *shape) of ``dtype``; float32 payloads carry int32 bit patterns,
    NaNs and infinities among them, so only a raw copy survives."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if dtype == torch.float32:
        bits = torch.randint(-(2**31), 2**31 - 1, (n,) + shape, generator=g,
                             device=cuda, dtype=torch.int64).to(torch.int32)
        bits.view(-1)[:4] = torch.tensor([0x7FC00001, 0x7F800000, -1, 0xFF8],
                                         device=cuda, dtype=torch.int32)
        return bits.view(torch.float32)
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, (n,) + shape, generator=g,
                             device=cuda, dtype=torch.int32)
    return torch.randn((n,) + shape, generator=g, device=cuda).to(dtype)


GASCORE_CASES = [
    (2, (8, 128), torch.float32),
    (8, (3, 5), torch.float32),  # 60-byte rows: 4-byte words
    (8, (16, 64), torch.bfloat16),
    (4, (7,), torch.bfloat16),  # 14-byte rows: 2-byte words
    (8, (256,), torch.int32),
    (3, (5,), torch.bool),  # 1-byte words
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,shape,dtype", GASCORE_CASES)
def test_cuda_gascore_puts_are_byte_exact(cuda, n, shape, dtype):
    from repro_torch.kernels import gascore as gc

    x = (_payload(cuda, n, shape, torch.int32, 3) > 0 if dtype == torch.bool
         else _payload(cuda, n, shape, dtype, 3))
    before = gc.ring_shift.launches, gc.perm_put.launches
    for k in (1, n - 1, 2 * n + 1):
        got = ops.ring_shift(x, k)
        assert torch.equal(_bits(got), _bits(ref.ring_shift(x, k)))
    dst = [(3 * i + 1) % n if n % 3 else (n - 1 - i) for i in range(n)]
    got = ops.perm_put(x, dst)
    assert torch.equal(_bits(got), _bits(ref.perm_put(x, dst)))
    torch.cuda.synchronize()
    assert gc.ring_shift.launches == before[0] + 3
    assert gc.perm_put.launches == before[1] + 1
    with pytest.raises(ValueError, match="bijection"):
        gc.perm_put(x, [0] * n)
    assert gc.perm_put.launches == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_offset_put_in_place_and_range_checked(cuda, dtype):
    from repro_torch.kernels import gascore as gc

    n, S, L, W = 4, 40, 9, 6
    seg = _payload(cuda, n, (S, W), dtype, 4)
    data = _payload(cuda, n, (L, W), dtype, 5)
    offs = torch.tensor([0, 31, 7, 13], dtype=torch.int32, device=cuda)
    want = ref.offset_put(seg, data, offs, 1)
    before = gc.offset_put.launches
    got = gc.offset_put(seg.clone(), data, offs, 1)
    assert torch.equal(_bits(got), _bits(want))
    keep = seg.clone()
    out = gc.offset_put(keep, data, offs[:1], 3)
    assert out.data_ptr() == keep.data_ptr()  # written in place
    assert torch.equal(_bits(out), _bits(ref.offset_put(seg, data, offs[:1], 3)))
    with pytest.raises(ValueError, match="outside"):
        gc.offset_put(seg.clone(), data, offs + 1, 1)  # 32 > S - L
    flat = torch.zeros(n, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="rows"):
        gc.offset_put(flat, flat.clone(), offs[:1], 1)
    torch.cuda.synchronize()
    assert gc.offset_put.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("n,shape,dtype", GASCORE_CASES[:5])
def test_cuda_ring_all_gather_byte_exact(cuda, n, shape, dtype):
    from repro_torch.kernels import gascore as gc

    x = _payload(cuda, n, shape, dtype, 6)
    before = gc.ring_all_gather.launches
    got = ops.ring_all_gather(x)
    torch.cuda.synchronize()
    assert gc.ring_all_gather.launches == before + 1
    assert got.shape == (n, n * shape[0]) + shape[1:]
    assert torch.equal(_bits(got), _bits(ref.all_gather(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,dtype", [
    (2, (4, 32), torch.float32), (8, (3, 5), torch.float32),
    (8, (2, 64), torch.bfloat16), (4, (3,), torch.bfloat16),
    (8, (16,), torch.int32),
])
def test_cuda_ring_reduce_scatter_ring_order(cuda, n, m, dtype):
    """Byte-equal to the ring-order plain version; within the dtype's
    rounding of the plain sum (reassociation over n terms)."""
    from repro_torch.kernels import gascore as gc

    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (n, n * m[0]) + m[1:]
    x = (torch.randint(-50, 50, shape, generator=g, device=cuda,
                       dtype=torch.int32) if dtype == torch.int32
         else torch.randn(shape, generator=g, device=cuda).to(dtype))
    before = gc.ring_reduce_scatter.launches
    got = ops.ring_reduce_scatter(x)
    torch.cuda.synchronize()
    assert gc.ring_reduce_scatter.launches == before + 1
    want = ref.reduce_scatter(x)
    assert torch.equal(_bits(got), _bits(want))
    plain = x.float().sum(0).reshape((n,) + m)
    tol = {torch.float32: 1e-5, torch.bfloat16: 6e-2, torch.int32: 0}[dtype]
    torch.testing.assert_close(got.float(), plain, atol=tol, rtol=tol)
