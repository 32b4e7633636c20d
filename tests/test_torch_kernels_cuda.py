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


def _paged_inputs(cuda, dtype, Hq, Hkv, lengths, D=128, T=16, NP=32, seed=3):
    """Inputs in the serving layout with NaN behind every length: padded
    table slots point at a NaN page, and the positions past the length in
    a request's last live page hold NaN."""
    B = len(lengths)
    rng = np.random.default_rng(seed)
    P = B * NP + 1
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, T, Hkv, D)).astype(np.float32)
    kp[-1], vp[-1] = np.nan, np.nan
    table = rng.permutation(B * NP).reshape(B, NP).astype(np.int32)
    for b, n in enumerate(lengths):
        live = -(-n // T)
        table[b, live:] = P - 1
        if n % T:
            kp[table[b, live - 1], n % T:] = np.nan
            vp[table[b, live - 1], n % T:] = np.nan
    args = [torch.from_numpy(x).to(cuda)
            for x in (q, kp, vp, table, np.asarray(lengths, np.int32))]
    args[:3] = [x.to(dtype) for x in args[:3]]
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("pps", [None, 1, 3])
@pytest.mark.parametrize("heads", [(56, 8), (64, 8)], ids=["G7", "G8"])
@pytest.mark.parametrize(
    "dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]
)
def test_cuda_split_kernel_across_split_boundaries(cuda, heads, pps, dtype,
                                                   atol, monkeypatch):
    """The split-KV kernel at arctic's and kimi-k2's GQA groups of 7 and 8,
    with the default split (4 pages) and splits of 1 and 3 pages: lengths
    on and one token either side of split boundaries, the served step's
    148, one request of 512 tokens; against the plain version."""
    lengths = [1, 31, 32, 33, 47, 48, 49, 148, 512]
    args = _paged_inputs(cuda, dtype, *heads, lengths)
    if pps is not None:
        monkeypatch.setattr(pa, "SPLIT_TOKENS", 16 * pps)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = ref.paged_attention(*args)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("pps", [None, 8])
@pytest.mark.parametrize(
    "dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]
)
def test_cuda_split_kernel_large_group_and_passes(cuda, pps, dtype, atol,
                                                  monkeypatch):
    """A GQA group of 16 (two rounds of 8 query heads over the staged
    K/V) with the default split and with splits of 8 pages (two staging
    passes each), lengths across both boundaries; against the plain
    version."""
    lengths = [1, 63, 64, 65, 127, 128, 129, 300, 512]
    args = _paged_inputs(cuda, dtype, 32, 2, lengths)
    if pps is not None:
        monkeypatch.setattr(pa, "SPLIT_TOKENS", 16 * pps)
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention(*args)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
def test_cuda_paged_attention_on_two_streams(cuda):
    """The merge's arrival counters are per stream: a paged call on a side
    stream, overlapping the same on the default one, each give the plain
    version's result."""
    paged = _paged_inputs(cuda, torch.bfloat16, 32, 8, [148, 300, 512, 7])
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        got_side = pa.paged_attention(*paged)
    got_main = pa.paged_attention(*paged)
    torch.cuda.synchronize()
    want = ref.paged_attention(*paged)
    for got in (got_side, got_main):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


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
    # out of range (32 > S - L, and below 0): clamped as ref.offset_put
    # clamps, on device and host offsets alike
    for bad in (offs + 1, offs - 8):
        want = ref.offset_put(seg, data, bad, 1)
        for o in (bad, bad.cpu()):
            got = gc.offset_put(seg.clone(), data, o, 1)
            assert torch.equal(_bits(got), _bits(want))
    flat = torch.zeros(n, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="rows"):
        gc.offset_put(flat, flat.clone(), offs[:1], 1)
    torch.cuda.synchronize()
    assert gc.offset_put.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_cuda_offset_put_device_offsets_make_no_host_sync(cuda, dtype):
    """A device offset stays on the card: the launch enqueues without the
    host reading it (sync debug mode "error" raises on any sync), and the
    bytes in range are exact, per-rank and broadcast offsets, every k."""
    from repro_torch.kernels import gascore as gc

    n, S, L, W = 8, 96, 17, 5
    seg = _payload(cuda, n, (S, W), dtype, 6)
    data = _payload(cuda, n, (L, W), dtype, 7)
    offs = torch.tensor([0, 79, 3, 40, -5, 200, 61, 12], dtype=torch.int32,
                        device=cuda)
    cases = [(offs, k) for k in (0, 1, n - 1, 2 * n + 3)] + [(offs[5:6], 2)]
    wants = [ref.offset_put(seg, data, o, k) for o, k in cases]
    segs = [seg.clone() for _ in cases]
    torch.cuda.synchronize()
    before = gc.offset_put.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        gots = [gc.offset_put(s, data, o, k) for s, (o, k) in zip(segs, cases)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert gc.offset_put.launches == before + len(cases)
    for got, s, want in zip(gots, segs, wants):
        assert got.data_ptr() == s.data_ptr()
        assert torch.equal(_bits(got), _bits(want))


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
    (3, (5, 40), torch.float32), (3, (7,), torch.bfloat16),
    (16, (8, 64), torch.int32), (17, (4, 16), torch.int32),
    (16, (1 << 19,), torch.int32),
])
def test_cuda_ring_reduce_scatter_ring_order(cuda, n, m, dtype):
    """Byte-equal to the ring-order plain version; within the dtype's
    rounding of the plain sum (reassociation over n terms).  n 3 and 16
    are templates of the kernel (2-16), n 17 its loop over any n; chunks
    of 5 x 40 or 8 x 64 elements take the 16-byte path, 7 or 3 x 5 the
    element-wise one; 2^19 int32 a chunk over 16 ranks outgrows the
    kernel's grid (8 waves of at most 3 CTAs an SM at its registers), so
    each thread loops."""
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


# --------------------------------------------------------------------------- #
# flash attention (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu)
# --------------------------------------------------------------------------- #
# (B, Hq, Hkv, S, D, causal, window, dtype): the reference's FA_CASES and
# one bf16 case at qwen3-4b's head layout (32 q / 8 KV heads of dim 128);
# then bf16 cases at the edges of the tensor-core kernels' tiles (128 q x
# 128 kv rows forward, 64 q x 128 kv dK/dV, 128 q x 64 kv dQ), S being
# (Sq, Sk) where they differ
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, None, torch.float32),
    (1, 4, 4, 128, 128, True, None, torch.float32),
    (2, 8, 2, 256, 64, True, 64, torch.float32),
    (1, 2, 1, 128, 64, False, None, torch.float32),
    (1, 4, 1, 256, 128, True, None, torch.bfloat16),
    (1, 2, 2, 128, 64, True, 32, torch.bfloat16),
    (1, 32, 8, 512, 128, True, None, torch.bfloat16),
    (2, 4, 2, 96, 64, True, None, torch.bfloat16),  # S not a tile multiple
    (1, 4, 2, 192, 128, True, None, torch.bfloat16),  # blocks of 64
    (1, 4, 2, (128, 384), 64, True, None, torch.bfloat16),
    (1, 4, 2, (128, 384), 128, False, None, torch.bfloat16),
    (1, 4, 2, (384, 128), 64, False, 32, torch.bfloat16),  # rows see no key
    (2, 4, 2, 256, 16, True, None, torch.bfloat16),
    (2, 4, 2, 256, 32, False, None, torch.bfloat16),
    (1, 4, 2, 256, 64, True, 20, torch.bfloat16),  # window < one tile
    (1, 4, 2, 256, 128, False, 20, torch.bfloat16),
    (1, 56, 8, 256, 128, True, None, torch.bfloat16),  # a GQA group of 7
    (1, 4, 2, (192, 320), 64, False, None, torch.bfloat16),  # ragged q block
    (2, 4, 2, (256, 96), 128, False, None, torch.bfloat16),  # ragged kv tile
    (1, 4, 2, 320, 128, True, 100, torch.bfloat16),  # a causal window
    # the persistent bf16 forward: 320 work tiles of uneven length (causal,
    # a window) on 132 SMs, and a single tile on one CTA
    (4, 16, 4, 640, 128, True, 100, torch.bfloat16),
    (1, 1, 1, 128, 64, False, None, torch.bfloat16),
]
# f32: summation order only; bf16: the outputs' rounding (8 mantissa bits)
FLASH_TOL = {torch.float32: (2e-5, 5e-4), torch.bfloat16: (2e-2, 2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_cuda_flash_kernels_match_plain(cuda, case):
    """Forward (out, lse), dK/dV and dQ kernels against their plain
    versions on the same inputs, one launch each; then ops.attention's
    gradients against autograd through the plain attention.  The blocks
    passed are the reference's largest (128, then 64) that tile both
    sequences."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    B, Hq, Hkv, S, D, causal, window, dtype = case
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(Sq + Hq)
    q = torch.randn((B, Hq, Sq, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, Hkv, Sk, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, Hkv, Sk, D), generator=g, device=cuda).to(dtype)
    dout = torch.randn((B, Hq, Sq, D), generator=g, device=cuda).to(dtype)
    kw = dict(causal=causal, window=window)
    block = 128 if all(n % min(128, n) == 0 for n in (Sq, Sk)) else 64
    blocks = dict(block_q=block, block_k=block)
    before = (fa.flash_attention_fwd.launches, fab.flash_attention_dkv.launches,
              fab.flash_attention_dq.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw, **blocks)
    want_out, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=2e-4)
    delta = (dout.float() * want_out.float()).sum(-1)
    args = (q, k, v, dout, want_lse, delta)
    dk, dv = fab.flash_attention_dkv(*args, **kw, **blocks)
    dq = fab.flash_attention_dq(*args, **kw, **blocks)
    want_dk, want_dv = ref.flash_attention_dkv(*args, **kw)
    want_dq = ref.flash_attention_dq(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fab.flash_attention_dkv.launches,
            fab.flash_attention_dq.launches) == tuple(b + 1 for b in before)
    for got, want in ((dk, want_dk), (dv, want_dv), (dq, want_dq)):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=bwd_tol,
                                   rtol=bwd_tol)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.attention(*leaves, **kw, **blocks), leaves,
                              dout)
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*plain, **kw), plain, dout.float())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b, atol=bwd_tol, rtol=bwd_tol)


@pytest.mark.cuda
def test_cuda_flash_fully_masked_rows_and_refusals(cuda):
    """Rows that see no key give out 0, lse -1e30 and no gradient; the
    wrappers refuse what the kernels do not take, without a launch."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, 2, 256, 64), generator=g, device=cuda)
    k = torch.randn((1, 1, 128, 64), generator=g, device=cuda)
    v = torch.randn((1, 1, 128, 64), generator=g, device=cuda)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=False, window=32)
    assert float(out[:, :, 159:].abs().max()) == 0.0
    assert bool((lse[:, :, 159:] == -1e30).all())
    leaves = [t.requires_grad_() for t in (q, k, v)]
    y = ops.attention(*leaves, causal=False, window=32)
    dq = torch.autograd.grad((y**2).sum(), leaves)[0]
    assert float(dq[:, :, 159:].abs().max()) == 0.0
    before = fa.flash_attention_fwd.launches
    strided = q.detach().transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(strided, k.detach(), v.detach())
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention_fwd(q[:, :, :96], k[:, :, :96], v[:, :, :96],
                               block_q=64, block_k=64)
    assert fa.flash_attention_fwd.launches == before


@pytest.mark.cuda
def test_cuda_train_loss_and_grads_match_cpu(cuda):
    """qwen3-4b at its SMOKE size (head dim 16, f32) through
    ``Model.train_loss`` under full remat: on the card each layer launches
    the forward kernel twice (its forward and the recompute) and the dK/dV
    and dQ kernels once, and the loss and every gradient agree with the CPU
    run of the plain versions (f32: 1e-5 of the loss, 1e-4 of each leaf's
    largest |g|)."""
    from repro_torch.compat import tree_leaves, tree_map
    from repro_torch.configs.registry import SMOKE
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    cfg = SMOKE["qwen3-4b"]
    model, ctx = build_model(cfg), RunCtx(remat="full")
    params = model.init(ctx, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticLM(cfg, 4, 64, seed=2).batch_at(0).items()}

    def loss_and_grads(dev):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
        loss = model.train_loss(p, ctx, {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return loss.detach().cpu(), [g.cpu() for g in grads]

    def launches():
        return (fa.flash_attention_fwd.launches,
                fab.flash_attention_dkv.launches, fab.flash_attention_dq.launches)

    want_loss, want = loss_and_grads("cpu")
    before = launches()
    got_loss, got = loss_and_grads(cuda)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert tuple(a - b for a, b in zip(launches(), before)) == (2 * n, n, n)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# --------------------------------------------------------------------------- #
# the scans (csrc/ssm_scan.cu, csrc/rglru.cu)
# --------------------------------------------------------------------------- #
# (B, S, Di, N): the reference's selective-scan shapes, B > 1 at an odd S,
# and the smallest and largest state sizes the kernel takes
SSM_CASES = [(2, 128, 256, 16), (1, 64, 512, 16), (2, 96, 128, 8),
             (3, 77, 192, 16), (2, 33, 96, 4), (1, 45, 64, 32)]
# |kernel - plain| <= tol * (1 + |plain|): f32 differs by the order of the
# C.h sum over N (the state update rounds as the plain version does); bf16
# by the outputs' rounding to 8 mantissa bits
SCAN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


# Cases that reach the kernels' edge paths, (B, S, Di, N, R): R columns of
# the projection before B and C (R 16 or 256: their rows start on 16
# bytes; R 7: they do not). S 1, S past a multiple of the tile (64 steps),
# Di whose rows are not whole 16 bytes in bf16 (100 at N 8), N 4 (B and C
# rows of 8 bytes in bf16), and falcon-mamba's width at B 4.
SSM_EDGE_CASES = [(1, 1, 256, 16, 16), (2, 77, 100, 8, 16),
                  (1, 2561, 64, 16, 16), (2, 50, 96, 4, 8),
                  (2, 40, 416, 32, 7), (4, 512, 8192, 16, 256)]


def _ssm_inputs(cuda, B, S, Di, N, dtype, seed, R=5):
    """The model's value ranges (dt in [1e-3, 1e-1], A = -(1..N)); B and
    C sliced out of one (B, S, R + 2N) projection, as the layer does."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((B, S, Di), generator=g, device=cuda).to(dtype)
    dt = 1e-3 + (1e-1 - 1e-3) * torch.rand((B, S, Di), generator=g, device=cuda)
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=cuda).repeat(Di, 1)
    dbc = torch.randn((B, S, R + 2 * N), generator=g, device=cuda).to(dtype)
    d = torch.randn((Di,), generator=g, device=cuda)
    return x, dt, a, dbc[..., R:R + N], dbc[..., R + N:], d


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= tol * (1 + want.abs())).all()), float(
        (got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N", SSM_CASES)
def test_cuda_selective_scan_matches_plain(cuda, B, S, Di, N, dtype):
    """y and the final state against the plain scans, one launch, B and C
    read through their strides."""
    _check_selective_scan(cuda, B, S, Di, N, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Di,N,R", SSM_EDGE_CASES)
def test_cuda_selective_scan_edges(cuda, B, S, Di, N, R, dtype):
    """The same checks where the kernel stages rows element by element,
    where a tile or a group of steps is ragged, and at full width."""
    _check_selective_scan(cuda, B, S, Di, N, dtype, R)


def _check_selective_scan(cuda, B, S, Di, N, dtype, R=5):
    from repro_torch.kernels import ssm_scan

    x, dt, a, b, c, d = _ssm_inputs(cuda, B, S, Di, N, dtype, S + Di, R)
    assert B * S == 1 or not b.is_contiguous()  # one row is contiguous
    before = ssm_scan.selective_scan.launches
    y, h = ops.selective_scan(x, dt, a, b, c, d, final_state=True)
    torch.cuda.synchronize()
    assert ssm_scan.selective_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    _close(y, ref.selective_scan(x, dt, a, b, c, d), SCAN_TOL[dtype])
    _close(h, ref.mamba_final_state(x, dt, a, b), SCAN_TOL[torch.float32])
    assert torch.equal(ops.selective_scan(x, dt, a, b, c, d), y)


@pytest.mark.cuda
def test_cuda_selective_scan_refusals(cuda):
    """No backward kernel: a call that needs a gradient raises; wrong
    dtypes and state sizes are refused; none of them launches."""
    from repro_torch.kernels import ssm_scan

    x, dt, a, b, c, d = _ssm_inputs(cuda, 1, 8, 32, 16, torch.float32, 0)
    before = ssm_scan.selective_scan.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ssm_scan.selective_scan(x.requires_grad_(), dt, a, b, c, d)
    x = x.detach()
    with pytest.raises(TypeError):
        ssm_scan.selective_scan(x, dt.bfloat16(), a, b, c, d)
    with pytest.raises(TypeError):
        ssm_scan.selective_scan(x.bfloat16(), dt, a, b, c, d)
    with pytest.raises(ValueError, match="state size"):
        ssm_scan.selective_scan(x, dt, a[:, :12].contiguous(), b[..., :12],
                                c[..., :12], d)
    assert ssm_scan.selective_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(2, 128, 256), (1, 64, 512), (3, 77, 200),
                                   (1, 1, 32)])
def test_cuda_gated_linear_scan_matches_plain(cuda, B, S, W, dtype):
    """Against the plain scan: the kernel rounds its multiply and add as
    the plain version does, so f32 agrees to the last bit; bf16 within the
    outputs' rounding."""
    from repro_torch.kernels import rglru

    a, b = _lru_inputs(cuda, B, S, W, dtype)
    before = rglru.gated_linear_scan.launches
    got = ops.gated_linear_scan(a, b)
    torch.cuda.synchronize()
    assert rglru.gated_linear_scan.launches == before + 1
    assert got.dtype == dtype
    want = ref.gated_linear_scan(a, b)
    _close(got, want, SCAN_TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="no backward"):
        rglru.gated_linear_scan(a.float().clone().requires_grad_(), b.float())
    with pytest.raises(TypeError):
        rglru.gated_linear_scan(a.float(), b.bfloat16())
    assert rglru.gated_linear_scan.launches == before + 1


def _lru_inputs(cuda, B, S, W, dtype, offset=0):
    """a in the RG-LRU's decay range, b of order one; with ``offset``,
    contiguous views that start ``offset`` elements into their storage."""
    g = torch.Generator(device=cuda).manual_seed(S + W)
    n = B * S * W
    a = 0.1 + 0.89 * torch.rand((offset + n,), generator=g, device=cuda)
    b = torch.randn((offset + n,), generator=g, device=cuda)
    return tuple(t.to(dtype)[offset:].view(B, S, W) for t in (a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W,offset", [
    (2, 2561, 256, 0), (3, 77, 99, 0), (2, 1, 99, 0), (2, 130, 64, 1),
    (4, 2560, 4096, 0)])
def test_cuda_gated_linear_scan_edges(cuda, B, S, W, offset, dtype):
    """S past a multiple of the ring's stage (64 steps of f32, 128 of
    bf16), S 1, W whose rows are not whole 16 bytes (99), inputs that do
    not start on 16 bytes, and recurrentgemma's width at B 4: f32 equal to
    the plain scan bit for bit, bf16 within its rounding."""
    from repro_torch.kernels import rglru

    a, b = _lru_inputs(cuda, B, S, W, dtype, offset)
    assert a.is_contiguous() and b.is_contiguous()
    before = rglru.gated_linear_scan.launches
    got = ops.gated_linear_scan(a, b)
    torch.cuda.synchronize()
    assert rglru.gated_linear_scan.launches == before + 1
    want = ref.gated_linear_scan(a, b)
    _close(got, want, SCAN_TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("falcon-mamba-7b", "mamba"),
                                       ("recurrentgemma-9b", "rec")])
def test_cuda_prefill_and_decode_match_cpu(cuda, arch, kind):
    """The SMOKE model (f32) on the card against the CPU run of the plain
    versions: a prefill launches the scan kernel once per ``kind`` layer,
    and the logits and every cache leaf agree (summation order: 1e-4),
    then over three decode steps."""
    from repro_torch.compat import tree_leaves, tree_map
    from repro_torch.configs.registry import SMOKE
    from repro_torch.kernels import rglru, ssm_scan
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    cfg = SMOKE[arch]
    model, ctx = build_model(cfg), RunCtx()
    params = model.init(ctx, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    wrapper = (ssm_scan.selective_scan if kind == "mamba"
               else rglru.gated_linear_scan)
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        before = wrapper.launches
        t_dev = toks.to(dev)
        logits, caches = model.prefill(p, ctx, {"inputs": t_dev[:, :21]}, 32)
        n = wrapper.launches - before
        steps = [logits]
        for t in range(21, 24):  # teacher-forced: the same tokens on both
            logits, caches = model.decode_step(
                p, ctx, t_dev[:, t:t + 1], torch.full((2,), t, dtype=torch.int32,
                                                      device=dev), caches)
            steps.append(logits)
        runs[str(dev)] = (n, [s.cpu() for s in steps],
                          [c.cpu() for c in tree_leaves(caches)])
    assert runs["cpu"][0] == 0
    assert runs["cuda"][0] == cfg.layer_kinds().count(kind)
    for got, want in zip(runs["cuda"][1] + runs["cuda"][2],
                         runs["cpu"][1] + runs["cpu"][2]):
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=1e-4)


# --------------------------------------------------------------------------- #
# MoE router (csrc/moe_router.cu)
# --------------------------------------------------------------------------- #
# (T, E, K): kimi-k2's and arctic's widths at a lone token, a decode batch,
# a ragged T, a prefill and a long prefill (many blocks); the edges of the
# kernel's plans on a card that holds clusters of 16 (the largest T of one
# CTA and of one cluster, and one token past each); the reference tests'
# four cases; E 256 and E 1024 (the kernel's 8 and 32 experts per lane),
# with K 32 at the largest E
ROUTER_EDGE_T = (16, 17, 192, 193)
ROUTER_CASES = ([(T, 384, 8) for T in (1, 8, 77, 128, 8192) + ROUTER_EDGE_T]
                + [(T, 128, 2) for T in (1, 8, 77, 128, 8192) + ROUTER_EDGE_T]
                + [(512, 16, 2), (256, 8, 1), (512, 64, 8), (256, 128, 2)]
                + [(77, 256, 8), (8192, 256, 8), (128, 1024, 8),
                   (77, 1024, 32), (8192, 1024, 8)])


def _router_logits(T, E, ties, seed):
    x = np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32)
    if ties:  # repeated logits in every row, every fourth row constant
        x = np.round(x * 2) / 2
        x[::4] = 0.5
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("T,E,K", ROUTER_CASES)
def test_cuda_moe_router_matches_plain(cuda, T, E, K, ties):
    """Indices, slots and keep equal to the plain version's on the card,
    weights within 1e-6, with and without renormalisation, at the model's
    capacity for T tokens."""
    from repro_torch.kernels import moe_router as mr

    logits = torch.from_numpy(_router_logits(T, E, ties, T + E)).to(cuda)
    cap = max(4, -(-T * K * 5 // (4 * E)))  # ceil(T K 1.25 / E)
    for renormalize in (True, False):
        before = mr.moe_router.launches
        got = ops.moe_router(logits, k=K, capacity=cap,
                             renormalize=renormalize)
        torch.cuda.synchronize()
        assert mr.moe_router.launches == before + 1
        want = ref.route_topk(logits, k=K, capacity=cap,
                              renormalize=renormalize)
        assert [t.dtype for t in got] == [t.dtype for t in want]
        for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert torch.equal(g, w)
        torch.testing.assert_close(got[2], want[2], atol=1e-6, rtol=0)


def _router_matches(got, logits, K, cap, renormalize=True):
    want = ref.route_topk(logits, k=K, capacity=cap, renormalize=renormalize)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[2], want[2], atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("E,K", [(384, 8), (128, 2)])
def test_cuda_moe_router_at_this_cards_plan_edges(cuda, E, K):
    """The largest T of one CTA and of one cluster on this card (its SM
    count and largest cluster), one token past each, and the grid plan's
    edge between its 16-warp and 32-warp CTAs and at several tokens a
    warp: each a single launch by the plan that ``plan`` picks, equal to
    the plain version."""
    from repro_torch.kernels import moe_router as mr

    sms, max_cluster = mr.card(cuda.index or 0)
    one_cta, cluster = mr.regime_edges(max_cluster)
    Ts = [one_cta, one_cta + 1, cluster, cluster + 1, mr.GRID_WARPS * sms,
          mr.GRID_WARPS * sms + 1, 64 * sms + 7]
    modes = {mr.plan(T, sms, max_cluster).mode for T in Ts}
    assert modes == ({mr.CTA, mr.CLUSTER, mr.GRID} if max_cluster > 1
                     else {mr.CTA, mr.GRID})
    for T in Ts:
        logits = torch.from_numpy(_router_logits(T, E, True, T)).to(cuda)
        cap = max(4, -(-T * K * 5 // (4 * E)))
        before = mr.moe_router.launches
        got = mr.moe_router(logits, k=K, capacity=cap)
        torch.cuda.synchronize()
        assert mr.moe_router.launches == before + 1
        _router_matches(mr.unpack(*got), logits, K, cap)


@pytest.mark.cuda
def test_cuda_moe_router_on_two_streams_at_once(cuda):
    """Two calls in flight at once on two streams, each plan once (one
    CTA, a cluster, a grid), each behind a sleep so that they overlap:
    every output equals the plain version's (no shared scratch)."""
    from repro_torch.kernels import moe_router as mr

    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for T in (8, 128, 8192):
        xs = [torch.from_numpy(_router_logits(T, 384, False, T + i)).to(cuda)
              for i in range(2)]
        cap = max(4, -(-T * 8 * 5 // (4 * 384)))
        torch.cuda.synchronize()
        outs = []
        for s, x in zip(streams, xs):
            with torch.cuda.stream(s):
                torch.cuda._sleep(1 << 20)
                outs.append(mr.moe_router(x, k=8, capacity=cap))
        torch.cuda.synchronize()
        for got, x in zip(outs, xs):
            _router_matches(mr.unpack(*got), x, 8, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 128, 8192])
def test_cuda_moe_router_keeps_no_state_between_calls(cuda, T):
    """The same logits twice give the same outputs bit for bit, and other
    logits next give their own plain result: nothing one call leaves in
    the kernel's memory is read by the next."""
    from repro_torch.kernels import moe_router as mr

    a = torch.from_numpy(_router_logits(T, 384, False, 1)).to(cuda)
    b = torch.from_numpy(_router_logits(T, 384, True, 2)).to(cuda)
    cap = max(4, -(-T * 8 * 5 // (4 * 384)))
    first = mr.moe_router(a, k=8, capacity=cap)
    second = mr.moe_router(a, k=8, capacity=cap)
    third = mr.moe_router(b, k=8, capacity=cap)
    torch.cuda.synchronize()
    for g, w in zip(first, second):
        assert torch.equal(g, w)
    _router_matches(mr.unpack(*first), a, 8, cap)
    _router_matches(mr.unpack(*third), b, 8, cap)


@pytest.mark.cuda
def test_cuda_moe_router_refusals(cuda):
    from repro_torch.kernels import moe_router as mr

    x = torch.randn((16, 384), device=cuda)
    before = mr.moe_router.launches
    with pytest.raises(TypeError):
        mr.moe_router(x.bfloat16(), k=8, capacity=4)
    with pytest.raises(ValueError, match="contiguous"):
        mr.moe_router(x.t(), k=8, capacity=4)
    with pytest.raises(ValueError, match="experts"):
        mr.moe_router(torch.randn((4, 1025), device=cuda), k=2, capacity=4)
    with pytest.raises(ValueError, match="k="):
        mr.moe_router(x[:, :4].contiguous(), k=5, capacity=4)
    with pytest.raises(RuntimeError, match="no backward"):
        mr.moe_router(x.clone().requires_grad_(), k=8, capacity=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mr.moe_router(x.cpu(), k=8, capacity=4)
    assert mr.moe_router.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_cuda_moe_prefill_and_decode_match_cpu(cuda, arch):
    """The SMOKE model (f32) on the card against the CPU run of the plain
    versions: every forward launches the router once per ``moe`` layer,
    and the logits and every cache leaf agree (summation order: 1e-4),
    then over three decode steps."""
    from repro_torch.compat import tree_leaves, tree_map
    from repro_torch.configs.registry import SMOKE
    from repro_torch.kernels import moe_router as mr
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    cfg = SMOKE[arch]
    model, ctx = build_model(cfg), RunCtx()
    params = model.init(ctx, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        before = mr.moe_router.launches
        t_dev = toks.to(dev)
        logits, caches = model.prefill(p, ctx, {"inputs": t_dev[:, :21]}, 48)
        steps = [logits]
        for t in range(21, 24):  # teacher-forced: the same tokens on both
            logits, caches = model.decode_step(
                p, ctx, t_dev[:, t:t + 1], torch.full((2,), t, dtype=torch.int32,
                                                      device=dev), caches)
            steps.append(logits)
        runs[str(dev)] = (mr.moe_router.launches - before,
                          [s.cpu() for s in steps],
                          [c.cpu() for c in tree_leaves(caches)])
    assert runs["cpu"][0] == 0
    assert runs["cuda"][0] == 4 * cfg.layer_kinds().count("moe")
    for got, want in zip(runs["cuda"][1] + runs["cuda"][2],
                         runs["cpu"][1] + runs["cpu"][2]):
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=1e-4)


def _smoke_cluster(cuda, **kw):
    """qwen3-4b SMOKE in f32 on the card, and a disaggregated cluster over
    it with its decode (and memory) ranks on "gascore"."""
    from repro_torch.configs.registry import SMOKE
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx
    from repro_torch.serving.disagg import DisaggCluster

    cfg = SMOKE["qwen3-4b"]
    model, ctx = build_model(cfg), RunCtx()
    params = model.init(ctx, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    shape = dict(n_prefill=1, n_decode=1, decode_batch=2, cache_len=48,
                 paged=True, page_tokens=8, decode_backend="gascore",
                 memory_backend="gascore", device=cuda)
    return DisaggCluster(model, ctx, params, **{**shape, **kw})


def _colocated_tokens(cluster, reqs):
    from repro_torch.launch.serve import PagedServer

    server = PagedServer(cluster.model, cluster.ctx, cluster.params, 2, 48,
                         device=cluster.device, page_tokens=8)
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    return {r.rid: r.out for r in server.finished}


@pytest.mark.cuda
def test_cuda_cluster_decode_write_and_page_put_in_one_tick(cuda):
    """On the card: a tick whose transfer lands a request's pages while
    the rank's decode writes a page of another; both land, the pages the
    prefill's bit for bit, and the tokens the colocated server's."""
    from repro_torch.launch.serve import Request
    from repro_torch.testing import disagg_suite

    cluster = _smoke_cluster(cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (11, 13)]
    mk = lambda: [Request(rid=i, prompt=p, max_new=9)  # noqa: E731
                  for i, p in enumerate(prompts)]
    ptr = cluster.kvseg.data_ptr()
    got = disagg_suite.put_and_decode_in_one_tick(cluster, *mk())
    assert cluster.kvseg.data_ptr() == ptr
    assert got == _colocated_tokens(cluster, mk())


@pytest.mark.cuda
def test_cuda_cluster_swaps_out_a_page_written_that_tick(cuda):
    """On the card: a page the decode wrote in a tick, swapped out by a
    preemption staged in that tick, reaches the memory rank as written;
    the resumed request's tokens are the colocated server's."""
    from repro_torch.launch.serve import Request
    from repro_torch.testing import disagg_suite

    cluster = _smoke_cluster(cuda, n_memory=1)
    prompt = np.random.default_rng(6).integers(0, 512, size=14).tolist()
    got = disagg_suite.swap_out_of_a_fresh_write(
        cluster, Request(rid=0, prompt=prompt, max_new=12))
    assert cluster.metrics.counter("sched_swaps").value == 1
    assert got == _colocated_tokens(
        cluster, [Request(rid=0, prompt=prompt, max_new=12)])


@pytest.mark.cuda
def test_cuda_cluster_plans_with_this_cards_measured_costs(cuda):
    """On the card a cluster built without ``costs`` (as the entry points
    build it) plans and prices with ``sched.measure_costs`` of the card:
    finite constants for both engines, fitted, not the reference's."""
    from repro_torch.core import sched

    cluster = _smoke_cluster(cuda)
    costs = cluster.costs
    assert costs == sched.measure_costs(cuda, {"xla", "gascore"})
    for name in ("xla", "gascore"):
        c = costs[name]
        assert c != sched.DEFAULT_COSTS[name]
        for v in (c.alpha_us, c.beta_us_per_kib, c.gamma_us_per_kib):
            assert np.isfinite(v) and v >= 0.0
        assert c.alpha_us > 0.0 and c.beta_us_per_kib + c.gamma_us_per_kib > 0.0
    assert cluster.scheduler.cost == costs["xla"]


# --------------------------------------------------------------------------- #
# split phase on the side stream; no host sync on the GAS programs' path
# --------------------------------------------------------------------------- #
GAS_BACKENDS = ["xla", "gascore", "xla,gascore"]


def _gas_programs(cuda, backend):
    """A ring program (segmented ring all-reduce, the planned all-reduce,
    the all-n-1-puts exchange), a vectored get of host-listed offsets and
    a put at a host int offset with a host bool flag, on 8 ranks; each
    returns its rank-stacked result."""
    from repro_torch.core import collectives, gasnet, sched

    n = 8
    ctx = gasnet.Context(n, backend=backend, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n * n * 4, 64), generator=g, device=cuda)
    seg = torch.randn((n, 4096), generator=g, device=cuda)
    data = torch.randn((n, 96), generator=g, device=cuda)

    def ring(node, v):
        e = node.engine
        return torch.cat([
            collectives.segmented_ring_all_reduce(e, v, n_segments=2, depth=2),
            sched.all_reduce(e, v), collectives.exchange(e, v)])

    def vget(node, s):
        return node.get_v(s, frm=gasnet.Shift(3), indices=[0, 512, 1030],
                          size=256)[None]

    def put(node, s, d):
        return node.put(s, d[0], to=gasnet.Shift(1), index=8, pred=True)

    return [lambda: ctx.spmd(ring, x), lambda: ctx.spmd(vget, seg),
            lambda: ctx.spmd(put, seg, data)]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", GAS_BACKENDS)
def test_cuda_gas_programs_make_no_host_sync_after_warmup(cuda, backend):
    """After one warm-up call (kernels built, index constants cached), a
    ring program, a vectored get and a put run under sync debug mode
    "error", which raises on any host wait: index lists, offsets and
    flags no longer cross from pageable host memory.  The same
    bytes as the warm-up.  The results are compared (a host read) after
    the guarded region; nothing inside it reads the device."""
    programs = _gas_programs(cuda, backend)
    warm = [p() for p in programs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [p() for p in programs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for a, b in zip(got, warm):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", GAS_BACKENDS)
def test_cuda_distinct_index_lists_make_no_host_sync(cuda, backend):
    """Vectored gets at index lists never seen before, under sync debug
    mode "error": each list is staged in pinned memory and copied without
    the host waiting, and none is kept in the constant cache.  The
    results are read after the guarded region."""
    from repro_torch import compat
    from repro_torch.core import gasnet

    n, S = 4, 2048
    ctx = gasnet.Context(n, backend=backend, device=cuda)
    seg = torch.randn((n, S), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    lists = [[(37 * i + 101 * j) % (S - 16) for j in range(3)]
             for i in range(12)]

    def vget(idx):
        return ctx.spmd(lambda node, s: node.get_v(
            s, frm=gasnet.Shift(1), indices=idx, size=16).reshape(1, -1), seg)

    vget([0, 1, 2])  # warm-up: kernels built, constants cached
    cached = len(compat._CONSTS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [vget(idx) for idx in lists]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(compat._CONSTS) == cached
    for idx, out in zip(lists, got):
        want = torch.stack([torch.cat([seg[(r + 1) % n, k:k + 16]
                                       for k in idx]) for r in range(n)])
        assert torch.equal(_bits(out), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", GAS_BACKENDS)
def test_cuda_split_phase_transfer_runs_beside_the_current_stream(cuda,
                                                                   backend):
    """A ``shift_nb`` completes on the side stream while the current
    stream is still busy (a sleep kernel queued after the initiation),
    without a host sync; ``wait()`` then orders the current stream after
    it, and the bytes are the blocking shift's."""
    import time

    from repro_torch.core import gasnet

    n = 4
    x = torch.randn((n, 1 << 20), device=cuda)
    ctx = gasnet.Context(n, backend=backend, device=cuda)
    want = ctx.spmd(lambda node, v: node.engine.shift(v, 1), x)
    seen = {}

    def prog(node, v):
        p = node.engine.shift_nb(v, 1)
        torch.cuda._sleep(1 << 28)  # the current stream: ~0.1 s busy
        busy = torch.cuda.Event()
        busy.record()
        t0 = time.monotonic()
        while not all(ev.query() for ev in p.events):
            assert time.monotonic() - t0 < 30, "the transfer never ran"
        seen["beside"] = not busy.query()
        seen["events"] = len(p.events)
        return p.wait()

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ctx.spmd(prog, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert seen["events"] == (2 if "," in backend else 1)
    assert seen["beside"], "the transfer waited for the current stream"
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", GAS_BACKENDS)
def test_cuda_split_phase_input_freed_after_initiation(cuda, backend):
    """Allocator stress: the payload is freed right after initiation, while
    the side stream has not read it yet (it sleeps first), and the current
    stream at once fills a tensor of the same size (the freed block, were
    it handed out again).  The transfer must deliver the payload's bytes:
    the input is recorded on the side stream."""
    from repro_torch.core import gasnet
    from repro_torch.core.engine import side_stream

    n, elems = 4, 1 << 22
    x = torch.randn((n, elems), device=cuda)
    ctx = gasnet.Context(n, backend=backend, device=cuda)
    side = side_stream(cuda)

    def prog(node, v):
        src = v * 3.0  # made on the current stream, owned by the program
        with torch.cuda.stream(side):
            torch.cuda._sleep(1 << 27)  # the side stream's read comes late
        p = node.engine.shift_nb(src, 1)
        del src
        junk = torch.full_like(v, 7.0)
        return p.wait(), junk

    for _ in range(3):
        got, junk = ctx.spmd(prog, x, out_specs=(gasnet.P("node"),) * 2)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ref.ring_shift(x * 3.0, 1)))
        assert bool((junk == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_vmap_rule_one_launch_per_group(cuda, dtype):
    """Paged attention under vmap over 2 ranks (a TP group's rank-stacked
    pools, one layer of each): ONE launch, each rank's output equal to
    the plain version on its own pool."""
    g = torch.Generator(device=cuda).manual_seed(4)
    tp, L, P, T, KH, D, B, H, NP = 2, 3, 41, 16, 4, 128, 8, 16, 10
    k = torch.randn((tp, L, P, T, KH, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((tp, L, P, T, KH, D), generator=g, device=cuda).to(dtype)
    q = torch.randn((tp, B, H, D), generator=g, device=cuda).to(dtype)
    table = torch.randint(0, P, (B, NP), generator=g, device=cuda,
                          dtype=torch.int32)
    lens = torch.randint(0, NP * T + 1, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    before = pa.paged_attention.launches
    got = torch.func.vmap(lambda q, k, v: ops.paged_attention(
        q, k[2], v[2], table, lens))(q, k, v)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    for r in range(tp):
        want = ref.paged_attention(q[r], k[r, 2], v[r, 2], table, lens)
        torch.testing.assert_close(got[r].float(), want.float(), atol=atol,
                                   rtol=atol)


@pytest.mark.cuda
def test_cuda_tp_suite(cuda):
    """The TP suite on the card at the SMOKE width: the group all-reduce
    bitwise on the three backends, ``TPPagedServer`` (tp=2) and a cluster
    with a tp=2 decode group token-identical to tp=1; one paged-attention
    launch per layer per TP decode step."""
    from repro_torch.configs.registry import SMOKE
    from repro_torch.launch.serve import TPPagedServer
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx
    from repro_torch.testing import tp_suite

    tp_suite.all_reduce_parity(cuda)
    model, ctx = build_model(SMOKE["qwen3-4b"]), RunCtx()
    params = model.init(ctx, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    tp_suite.server_parity(model, ctx, params, cuda,
                           backends=("xla", "gascore", "xla,gascore"))
    srv = TPPagedServer(model, ctx, params, 3, 32, tp=2, tp_backend="gascore",
                        device=cuda, page_tokens=8)
    before = pa.paged_attention.launches
    tp_suite._serve(srv, tp_suite.smoke_requests(model.cfg.vocab))
    assert (pa.paged_attention.launches - before
            == model.cfg.n_layers * srv.paged_decode_steps)
    tp_suite.cluster_parity(model, ctx, params, cuda)


@pytest.mark.cuda
def test_cuda_prefill_and_dense_decode_make_no_host_sync(cuda):
    """A qwen3-4b (SMOKE) prefill and a dense decode step enqueue without a
    host wait once warm (sync debug mode "error"); the tokens the server
    reads from the logits (a host read, as in the reference) are read
    after the guarded region."""
    from repro_torch.configs.registry import SMOKE
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    model, ctx = build_model(SMOKE["qwen3-4b"]), RunCtx()
    params = model.init(ctx, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    toks = torch.randint(0, 512, (1, 13), device=cuda, dtype=torch.int32)

    def run():
        logits, caches = model.prefill(params, ctx, {"inputs": toks},
                                       cache_len=32)
        nxt = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
        pos = torch.full((1,), 13, dtype=torch.int32, device=cuda)
        step, _ = model.decode_step(params, ctx, nxt, pos, caches)
        return logits, step

    warm = run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for a, b in zip(got, warm):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kill_mid_handoff_poisons_without_a_host_sync(cuda):
    """On the card: a decode rank killed between a tick's transfer launch
    and its consume (the mid-handoff window, the transfer possibly still
    on the side stream) is poisoned with no host wait (sync debug mode
    "error"); after every later consume its whole row holds the poison
    word, the segment keeps its storage and every store stays a view of
    its row; every request still finishes."""
    from repro_torch.launch.serve import Request
    from repro_torch.serving.disagg import POISON_BITS

    cluster = _smoke_cluster(cuda, n_decode=2)
    ptr = cluster.kvseg.data_ptr()
    rows = [s.mem.data_ptr() for s in cluster.stores]
    killed = []

    def hook(c, phase, tick):
        push = next((p for p in c.pending_push if p is not None), None)
        if phase != "pre_consume" or killed or push is None:
            return
        torch.cuda.set_sync_debug_mode("error")
        try:
            c.kill_rank(c.decode_rank(push[1]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        killed.append(c.decode_rank(push[1]))

    cluster.fault_hook = hook
    rng = np.random.default_rng(3)
    for rid in range(4):
        cluster.submit(Request(rid=rid, max_new=6, prompt=rng.integers(
            0, 512, size=int(rng.integers(6, 20))).tolist()))
    stats = cluster.run_until_drained()
    assert killed and stats["rank_failures"] == 1
    assert sorted(r.rid for r in cluster.finished) == [0, 1, 2, 3]
    row = cluster.kvseg[killed[0]]
    assert bool((row.view(torch.int32) == POISON_BITS).all())
    assert bool(torch.isnan(row).all())
    assert cluster.kvseg.data_ptr() == ptr
    assert [s.mem.data_ptr() for s in cluster.stores] == rows


# the transport ops' VJPs and GPipe on the card: the programs
# of tests/test_torch_dist.py, on the software transport
def _transport_programs():
    return {
        "shift": lambda e, x: e.shift(x, 3),
        "permute": lambda e, x: e.permute(x, [2, None, 0, 1]),
        "all_reduce": lambda e, x: e.all_reduce(x),
        "all_gather": lambda e, x: e.all_gather(x),
        "reduce_scatter": lambda e, x: e.reduce_scatter(x),
        "all_to_all": lambda e, x: e.all_to_all(x),
        "split_phase": lambda e, x: e.shift_nb(x * x, 1).wait()
        + e.permute_nb(x, [1, 2, 3, 0]).wait(),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(_transport_programs()))
def test_cuda_transport_vjps_match_cpu(cuda, op):
    """On the card: a transport op's forward and gradient on "xla" equal
    the CPU's, the second call under sync debug mode "error" (the VJPs,
    the split-phase ones on the side stream, wait on no host); on
    "gascore" the backward is refused."""
    from repro_torch.core import gasnet

    n, prog = 4, _transport_programs()[op]
    x0 = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n * 4, 3)).astype(np.float32))

    def run(x, backend="xla"):
        ctx = gasnet.Context(n, backend=backend, device=x.device)
        x = x.clone().requires_grad_()
        y = ctx.spmd(lambda node, xl: prog(node.engine, xl), x)
        wts = torch.arange(y.numel(), dtype=y.dtype,
                           device=y.device).reshape(y.shape)
        (y * wts).sum().backward()
        return y.detach(), x.grad

    want = run(x0)
    xc = x0.to(cuda)
    run(xc)  # warm-up: constants cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run(xc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-6)
    if op == "permute":
        prog = lambda e, xl: e.permute(xl, [2, 3, 0, 1])  # noqa: E731
    with pytest.raises(RuntimeError, match="forward-only"):
        run(xc, "gascore")


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 3])
def test_cuda_gpipe_backward_through_split_phase_puts(cuda, segments):
    """GPipe over 4 ranks on "xla": forward and gradients of the second
    call under sync debug mode "error" (the boundary puts and their VJPs
    on the side stream), within the reference's tolerances of the
    sequential chain, three times over with allocations in between (the
    caching allocator's reuse across streams); the "gascore" forward
    bitwise the "xla" one, its backward refused."""
    from repro_torch.core import gasnet
    from repro_torch.core.gasnet import P
    from repro_torch.parallel.pipeline import gpipe

    S, M, MB, D = 4, 6, 64, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    xm = torch.randn((M, MB, D), generator=g, device=cuda)
    w0 = torch.randn((S, D, D), generator=g, device=cuda) / D ** 0.5

    def stage(wl, xx):
        return torch.tanh(xx @ wl[0])

    def pipe(backend, w):
        ctx = gasnet.Context(S, backend=backend, device=cuda)
        return ctx.spmd(
            lambda node, wl, xs: gpipe(stage, wl, xs, engine=node.engine,
                                       n_stages=S,
                                       boundary_segments=segments),
            w, xm, in_specs=(P("node"), P()), out_specs=P())

    def step(backend="xla"):
        w = w0.clone().requires_grad_()
        out = pipe(backend, w)
        (out ** 2).sum().backward()
        return out.detach(), w.grad

    ws = w0.clone().requires_grad_()
    ref_out = xm
    for i in range(S):
        ref_out = torch.tanh(ref_out @ ws[i])
    (ref_out ** 2).sum().backward()
    step()  # warm-up
    torch.cuda.synchronize()
    for _ in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, grad = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        junk = torch.randn((8 << 20,), generator=g, device=cuda)  # reuse
        torch.testing.assert_close(out, ref_out.detach(), atol=1e-5, rtol=0)
        torch.testing.assert_close(grad, ws.grad, atol=2e-4, rtol=2e-4)
        del junk
    with torch.no_grad():
        assert torch.equal(pipe("gascore", w0), out)
    with pytest.raises(RuntimeError, match="forward-only"):
        step("gascore")


@pytest.mark.cuda
def test_cuda_profiler_clocks(cuda):
    """``DeviceProfiler`` on the card: a call of a few launches is timed by
    events behind a sleep kernel; a call of more launches than the launch
    queue holds cannot wait behind one and is timed by its kernels'
    durations; both samples say ``measured="device"``."""
    from repro_torch.obs.profile import DeviceProfiler

    x = torch.zeros((1 << 10,), device=cuda)

    def many():
        for _ in range(16384):
            x.add_(1.0)

    prof = DeviceProfiler(device=cuda)
    small = prof.profile("small", lambda: x.add_(1.0), iters=3, warmup=1)
    big = prof.profile("big", many, iters=2, warmup=1)
    recs = {r["name"]: r for r in prof.records}
    assert recs["small"]["measured"] == recs["big"]["measured"] == "device"
    assert recs["small"]["clock"] == "events"
    assert recs["big"]["clock"] == "kernels"
    assert 0 < small < 1e3 and small * 100 < big


# --------------------------------------------------------------------------- #
# the rest of the model zoo's shapes; expert parallelism
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(48, 1), (128, 8)], ids=["G48", "G16"])
@pytest.mark.parametrize(
    "dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]
)
def test_cuda_paged_attention_at_the_zoos_groups(cuda, heads, dtype, atol):
    """granite-34b's MQA (48 q heads on one KV head) and llama3-405b's 128
    / 8 heads: lengths on and either side of the split boundaries and a
    full table, one launch, against the plain version."""
    lengths = [1, 63, 64, 65, 128, 148, 511, 512]
    args = _paged_inputs(cuda, dtype, *heads, lengths)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = ref.paged_attention(*args)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=atol)


# seamless' encoder (non-causal, head dim 64), granite's group of 48,
# gemma3's causal window of 1,024 at S 4,096
FLASH_ZOO_CASES = [
    (2, 16, 16, 1024, 64, False, None, torch.bfloat16),
    (1, 48, 1, 2048, 128, True, None, torch.bfloat16),
    (1, 32, 16, 4096, 128, True, 1024, torch.bfloat16),
    (1, 16, 16, 512, 64, False, None, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_ZOO_CASES,
                         ids=[str(c) for c in FLASH_ZOO_CASES])
def test_cuda_flash_kernels_at_the_zoos_shapes(cuda, case):
    """The forward, dK/dV and dQ kernels against their plain versions at
    the zoo's training shapes, one launch each.  At granite's group of 48
    dK and dV sum 48 S terms an element, each with the bf16 kernel's P or
    dS rounded to 8 bits, so an element small beside its key row's largest
    may lie a few of that row's bf16 ulps from the plain version: there
    each key row is held to the f64 sum of the same inputs, its largest
    error at most twice the plain version's plus 2**-8 of the row's
    largest |value| (tools/flash_gqa_error.py).  The rest as in
    ``test_cuda_flash_kernels_match_plain``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    B, Hq, Hkv, S, D, causal, window, dtype = case
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    q, dout = (torch.randn((B, Hq, S, D), generator=g, device=cuda).to(dtype)
               for _ in range(2))
    k, v = (torch.randn((B, Hkv, S, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window)
    before = (fa.flash_attention_fwd.launches, fab.flash_attention_dkv.launches,
              fab.flash_attention_dq.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = ref.flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=fwd_tol,
                               rtol=fwd_tol)
    torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=2e-4)
    delta = (dout.float() * want_out.float()).sum(-1)
    args = (q, k, v, dout, want_lse, delta)
    dk, dv = fab.flash_attention_dkv(*args, **kw)
    dq = fab.flash_attention_dq(*args, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fab.flash_attention_dkv.launches,
            fab.flash_attention_dq.launches) == tuple(b + 1 for b in before)
    plain = ref.flash_attention_dkv(*args, **kw)
    exact = (ref.flash_attention_dkv_f64(*args, **kw) if Hq // Hkv == 48
             else None)
    for i, (got, want) in enumerate(zip((dk, dv), plain)):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        if exact is None:
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=bwd_tol, rtol=bwd_tol)
            continue
        err = (got.double() - exact[i]).abs().amax(-1)
        bound = (2 * (want.double() - exact[i]).abs().amax(-1)
                 + 2.0**-8 * exact[i].abs().amax(-1))
        assert bool((err <= bound).all()), float((err / bound).max())
    torch.testing.assert_close(dq.float(),
                               ref.flash_attention_dq(*args, **kw).float(),
                               atol=bwd_tol, rtol=bwd_tol)


@pytest.mark.cuda
def test_cuda_moe_router_under_the_rank_vmap(cuda):
    """``ops.moe_router`` under ``torch.func.vmap`` over 4 ranks: one
    launch a rank, each rank's routes those of the plain router on its
    own tokens with the same capacity."""
    from repro_torch.kernels import moe_router as mr

    x = torch.from_numpy(_router_logits(4 * 96, 128, False, 5)).to(cuda)
    x = x.reshape(4, 96, 128)
    before = mr.moe_router.launches
    got = torch.func.vmap(lambda lg: ops.moe_router(lg, k=2, capacity=4))(x)
    torch.cuda.synchronize()
    assert mr.moe_router.launches == before + 4
    for r in range(4):
        _router_matches(tuple(t[r] for t in got), x[r], 2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,T", [((1, 4), 64), ((2, 4), 128), ((2, 4), 66)])
def test_cuda_moe_ep_engines_agree_and_match_plain(cuda, grid, T):
    """Expert-parallel MoE (arctic SMOKE, capacity factor 4.0) on the card:
    "gascore" bitwise equal to "xla", 2 all-to-alls of n - 1
    ``ring_shift`` launches each, the router once a rank and token shard
    (once a data shard where the model ranks share their tokens: the
    op is not batched then); and within f32 rounding of the same on the
    CPU (the plain versions)."""
    import dataclasses

    from repro_torch.configs.registry import SMOKE
    from repro_torch.kernels import gascore as gc
    from repro_torch.kernels import moe_router as mr
    from repro_torch.models import layers
    from repro_torch.parallel.ctx import RunCtx

    cfg = dataclasses.replace(SMOKE["arctic-480b"], capacity_factor=4.0)
    p = layers.moe_init(cfg, RunCtx(), torch.Generator().manual_seed(1))
    keys = ("router", "wi", "wg", "wo")
    x = torch.randn((T, cfg.d_model), generator=torch.Generator().manual_seed(2))
    outs = {}
    for backend in ("xla", "gascore"):
        ctx = RunCtx(moe_mode="ep_shardmap", ep_grid=grid, moe_backend=backend)
        shifts, routes = gc.ring_shift.launches, mr.moe_router.launches
        outs[backend] = layers._moe_ep({k: p[k].to(cuda) for k in keys}, cfg,
                                       ctx, x.to(cuda))
        torch.cuda.synchronize()
        want_shifts = 2 * (grid[1] - 1) if backend == "gascore" else 0
        assert gc.ring_shift.launches - shifts == want_shifts
        shards = grid[0] * (grid[1] if T % (grid[0] * grid[1]) == 0 else 1)
        assert mr.moe_router.launches - routes == shards
    assert torch.equal(outs["xla"], outs["gascore"])
    cpu = layers._moe_ep({k: p[k] for k in keys}, cfg,
                         RunCtx(moe_mode="ep_shardmap", ep_grid=grid), x)
    torch.testing.assert_close(outs["xla"].cpu(), cpu, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_gascore_suite(cuda, capsys):
    """The GAScore suite twin on the card: the five kernels at the
    reference's shapes held to their oracles (copies byte for byte), then
    the engine parity over "xla", "gascore" and "xla,gascore"; every
    kernel launched."""
    from repro_torch.kernels import gascore as gc
    from repro_torch.testing import gascore_suite

    kernels = (gc.ring_shift, gc.perm_put, gc.offset_put, gc.ring_all_gather,
               gc.ring_reduce_scatter)
    before = [k.launches for k in kernels]
    gascore_suite.main(device=cuda)
    assert capsys.readouterr().out.splitlines()[-1] == "GASCORE_SUITE_PASS"
    assert all(k.launches > b for k, b in zip(kernels, before))


def _entry_calls(dev):
    """Every kernel entry point once, on ``dev``, at small shapes (the
    inputs made here, outside the calls)."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    q = t(1, 4, 128, 64, dtype=torch.bfloat16).requires_grad_()
    k = t(1, 2, 128, 64, dtype=torch.bfloat16).requires_grad_()
    v = t(1, 2, 128, 64, dtype=torch.bfloat16).requires_grad_()
    pq, pk, pv = t(2, 8, 64), t(9, 8, 2, 64), t(9, 8, 2, 64)
    table = torch.arange(8, dtype=torch.int32).reshape(2, 4).to(dev)
    lens = torch.full((2,), 30, dtype=torch.int32).to(dev)
    logits = t(16, 32)
    sx, sdt, sb, sc = t(1, 64, 32), t(1, 64, 32), t(1, 64, 4), t(1, 64, 4)
    sa, sd = -torch.ones((32, 4)).to(dev), torch.ones((32,)).to(dev)
    la, lb = torch.rand((1, 64, 32), generator=g).to(dev), t(1, 64, 32)
    x8 = t(8, 256)
    seg, offs = torch.zeros((8, 512)).to(dev), torch.zeros(
        (8,), dtype=torch.int32).to(dev)

    def attention_fwd_bwd():
        out = ops.attention(q, k, v)
        return (out,) + torch.autograd.grad(out.float().sum(), (q, k, v))

    return {
        "attention": attention_fwd_bwd,
        "paged_attention": lambda: ops.paged_attention(pq, pk, pv, table,
                                                       lens),
        "moe_router": lambda: ops.moe_router(logits, k=2, capacity=4),
        "selective_scan": lambda: ops.selective_scan(
            sx, sdt, sa, sb, sc, sd, final_state=True),
        "gated_linear_scan": lambda: ops.gated_linear_scan(la, lb),
        "ring_shift": lambda: ops.ring_shift(x8, 3),
        "perm_put": lambda: ops.perm_put(x8, (3, 0, 6, 1, 7, 2, 5, 4)),
        "offset_put": lambda: ops.offset_put(seg, x8, offs, 1),
        "ring_all_gather": lambda: ops.ring_all_gather(x8),
        "ring_reduce_scatter": lambda: ops.ring_reduce_scatter(x8),
    }


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


@pytest.mark.cuda
def test_cuda_meta_stand_ins_match_the_kernels(cuda):
    """On ``meta`` each entry point returns what its kernel returns on the
    card, shape and dtype, and counts as the same one op."""
    from repro_torch.launch import hlostats

    calls = {dev: _entry_calls(dev) for dev in (cuda, torch.device("meta"))}
    for name, fn in calls[cuda].items():
        with hlostats.OpCounter() as on_card:
            got = _flat(fn())
        torch.cuda.synchronize()
        with hlostats.OpCounter() as on_meta:
            want = _flat(calls[torch.device("meta")][name]())
        assert [(tuple(a.shape), a.dtype) for a in got] == [
            (tuple(b.shape), b.dtype) for b in want], name
        assert all(b.device.type == "meta" for b in want), name
        assert on_card.stats().as_dict() == on_meta.stats().as_dict(), name
