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
