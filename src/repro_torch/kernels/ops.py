"""Kernel entry points of the port, dispatched on the tensor's device.

The reference picks ``impl="ref"|"pallas"`` by flag.  The port picks by
where the data lies: a CUDA tensor goes to the hand-written kernel (which
raises on what it cannot take — there is no fallback), a CPU tensor to
the plain PyTorch version in ``repro_torch.kernels.ref``, a ``meta``
tensor (the dry run) to a shape-only stand-in: the plain version where
its autograd graph matters (the router, and a scan whose inputs need a
gradient, train through it on the CPU, so a ``meta`` step keeps the same
backward), else empty results.

Every entry point reports its call to an active op-stream counter as ONE
op with the work of what it computes (``kernels.cost``), and nothing it
dispatches inside is counted again.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.compat import resolve_device
from repro_torch.kernels import cost
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import gascore as _gc
from repro_torch.kernels import moe_router as _moe
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import ssm_scan as _ssm

__all__ = [
    "attention",
    "paged_attention",
    "moe_router",
    "moe_dispatch",
    "moe_combine",
    "ring_shift",
    "perm_put",
    "offset_put",
    "ring_all_gather",
    "ring_reduce_scatter",
    "selective_scan",
    "gated_linear_scan",
    "profiling_targets",
]


def _on(x: torch.Tensor, kernel, plain, name: str):
    """CUDA -> the hand kernel, CPU and ``meta`` -> the plain version,
    else raise."""
    if x.device.type == "cuda":
        return kernel
    if x.device.type in ("cpu", "meta"):
        return plain
    raise ValueError(f"no {name} for device {x.device}")


def _paged_work(q, k_pages, page_table):
    """Paged attention's work with every table slot live (the counter
    reads no lengths off the device)."""
    B, Hq, D = q.shape
    T, Hkv = k_pages.shape[1], k_pages.shape[2]
    nbytes, flops = cost.paged_attention_work(
        [page_table.shape[1] * T] * B, Hq, Hkv, D, T, q.dtype)
    return cost.kernel("paged_attention", flops, nbytes)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Differentiable blockwise attention: q (B, Hq, Sq, D) against k, v
    (B, Hkv, Sk, D), contiguous.  ``FlashAttention`` dispatches on the
    device in its forward and backward: on CUDA the forward, dK/dV and dQ
    kernels, on the CPU their plain versions, on ``meta`` shape-only
    stand-ins, elsewhere it raises."""
    return _fab.FlashAttention.apply(q, k, v, causal, window, scale,
                                     block_q, block_k)


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=())
def _paged_attention_op(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    scale: Optional[float],
) -> torch.Tensor:
    with _paged_work(q, k_pages, page_table):
        if q.device.type == "cuda":
            return _pa.paged_attention(
                q, k_pages, v_pages, page_table, lengths, scale=scale
            )
        if q.device.type == "cpu":
            return ref.paged_attention(
                q, k_pages, v_pages, page_table, lengths, scale=scale
            )
    raise ValueError(f"no paged_attention for device {q.device}")


@_paged_attention_op.register_fake
def _paged_attention_fake(q, k_pages, v_pages, page_table, lengths, scale):
    """The shape-only stand-in (``meta``)."""
    with _paged_work(q, k_pages, page_table):
        return torch.empty_like(q)


def _rank_major(x: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    if dim is None:
        return x.unsqueeze(0).expand((n,) + tuple(x.shape))
    return x.movedim(dim, 0)


def _fold_pools(k: torch.Tensor, v: torch.Tensor):
    """Rank-stacked pools ``(n, P, T, KH, D)`` as ONE pool of pages and the
    page offset of each rank in it.  When a rank's pool begins a whole
    number of pages after the one before (the stacked layouts do: ranks
    major, each rank's pool a page-strided block), the folded pool is a
    view over all ranks' storage, so no page is copied; otherwise both
    pools are copied rank-major."""
    n, P = k.shape[:2]
    s0, s1 = k.stride(0), k.stride(1)
    if (k.stride() == v.stride() and s1 > 0 and s0 % s1 == 0
            and s0 // s1 >= P):
        per = s0 // s1
        size = ((n - 1) * per + P,) + tuple(k.shape[2:])
        stride = (s1,) + tuple(k.stride()[2:])
        return (k.as_strided(size, stride, k.storage_offset()),
                v.as_strided(size, stride, v.storage_offset()), per)
    k = k.contiguous()
    v = v.contiguous()
    return (k.reshape((n * P,) + tuple(k.shape[2:])),
            v.reshape((n * P,) + tuple(v.shape[2:])), P)


@_paged_attention_op.register_vmap
def _paged_attention_vmap(info, in_dims, q, k_pages, v_pages, page_table,
                          lengths, scale):
    """Paged attention over a vmapped rank axis (a tensor-parallel group
    on one device) as ONE call of the kernel: the ranks fold into the
    kernel's batch — q ``(n, B, H, D)`` to ``(n·B, H, D)``, the ranks'
    pools to one pool (:func:`_fold_pools`), rank r's page table offset
    by r's first page, the lengths repeated — and the output unfolds."""
    n = info.batch_size
    qd, kd, vd, td, ld = in_dims[:5]
    qs = _rank_major(q, qd, n)
    B = qs.shape[1]
    if kd is None and vd is None:
        kp, vp, per = k_pages, v_pages, 0
    else:
        kp, vp, per = _fold_pools(_rank_major(k_pages, kd, n),
                                  _rank_major(v_pages, vd, n))
    shift = (torch.arange(n, dtype=torch.int32, device=q.device) * per)
    table = (_rank_major(page_table, td, n).to(torch.int32)
             + shift[:, None, None]).reshape(n * B, -1)
    lens = _rank_major(lengths, ld, n).reshape(n * B).contiguous()
    out = _paged_attention_op(
        qs.reshape((n * B,) + tuple(qs.shape[2:])).contiguous(), kp, vp,
        table.contiguous(), lens.to(torch.int32), scale)
    return out.reshape((n, B) + tuple(out.shape[1:])), 0


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention through a page table: q (B, Hq, D) against
    (P, T, Hkv, D) physical pages addressed by page_table (B, NP), masked
    at lengths (B,).  A custom op: under ``torch.func.vmap`` over the ranks
    of a tensor-parallel group its vmap rule folds the ranks into the
    batch, so the group's attention is still one launch of the kernel."""
    return _paged_attention_op(q, k_pages, v_pages, page_table, lengths,
                               scale)


@torch.library.custom_op("repro_torch::moe_router", mutates_args=())
def _moe_router_op(
    logits: torch.Tensor, k: int, capacity: int, renormalize: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's ``(words, keep)``, words (3, T, K) int32 the planes
    expert_idx, slot and weight's f32 bits (a custom op's outputs may not
    alias one another, so the kernel's one buffer stays whole)."""
    with _router_work(logits, k):
        return _moe.moe_router(logits, k=k, capacity=capacity,
                               renormalize=renormalize)


def _router_work(logits, k):
    nbytes, flops = cost.router_work(logits.shape[0], logits.shape[1], k)
    return cost.kernel("moe_router", flops, nbytes)


@_moe_router_op.register_vmap
def _moe_router_vmap(info, in_dims, logits, k, capacity, renormalize):
    """The router over a vmapped rank axis (expert parallelism): ONE
    launch a rank.  Each rank routes its own tokens with its own
    ``capacity``: folded into one call, the ranks' tokens would share
    every expert's slots."""
    xs = _rank_major(logits, in_dims[0], info.batch_size)
    outs = [_moe_router_op(x.contiguous(), k, capacity, renormalize)
            for x in xs.unbind(0)]
    return ((torch.stack([w for w, _ in outs]),
             torch.stack([keep for _, keep in outs])), (0, 0))


@torch.library.custom_op("repro_torch::f32_from_bits", mutates_args=())
def _f32_from_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 words as the f32 they hold (a copy): ``Tensor.view(dtype)``
    has no vmap batching rule in every PyTorch release."""
    return x.view(torch.float32).clone()


@_f32_from_bits.register_vmap
def _f32_from_bits_vmap(info, in_dims, x):
    return x.view(torch.float32).clone(), in_dims[0]


def moe_router(
    logits: torch.Tensor, *, k: int, capacity: int, renormalize: bool = True
):
    """Top-k routing with capacity slots in token order: expert_idx,
    slot, weight and keep, each (T, K), from (T, E) f32 logits.  On the
    CPU the plain version (differentiable in the weights, as the
    reference's); on CUDA the kernel, through a custom op whose vmap rule
    launches it once a rank of an expert-parallel group.  ``meta`` takes
    the plain version too: its weights keep the CPU's autograd graph."""
    if logits.device.type in ("cpu", "meta"):
        with _router_work(logits, k):
            return ref.route_topk(logits, k=k, capacity=capacity,
                                  renormalize=renormalize)
    if logits.device.type != "cuda":
        raise ValueError(f"no moe_router for device {logits.device}")
    words, keep = _moe_router_op(logits, k, capacity, renormalize)
    if torch._C._functorch.is_batchedtensor(words):
        return words[0], words[1], _f32_from_bits(words[2]), keep
    return _moe.unpack(words, keep)


# dispatch/combine are the plain scatter and gather on both devices, as
# in the reference (where XLA handles them)
moe_dispatch = ref.moe_dispatch
moe_combine = ref.moe_combine


def _scan_impl(impl: str) -> str:
    if impl not in ("ref", "pallas", "chunked"):
        raise ValueError(f"unknown scan impl {impl!r}")
    return impl


def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    *,
    final_state: bool = False,
    impl: str = "ref",
    block_s: int = 128,
):
    """The mamba-1 scan: y (B, S, Di) in x's dtype, and with
    ``final_state`` also h_S (B, Di, N) f32.  ``impl`` "ref" and "pallas"
    dispatch by device: on CUDA one kernel launch computes both, on the
    CPU the plain scan and, for the state, the reference's second scan
    (``ref.mamba_final_state``).  "chunked" runs
    ``ref.selective_scan_chunked`` with chunks of ``block_s`` steps (its
    carried state is the final one) on either device."""
    if _scan_impl(impl) == "chunked":
        return ref.selective_scan_chunked(x, dt, a, b, c, d, chunk=block_s,
                                          final_state=final_state)
    nbytes, flops = cost.scan_work("selective_scan", tuple(x.shape)
                                   + (a.shape[-1],), x.dtype)
    with cost.kernel("selective_scan", flops, nbytes):
        if x.device.type == "cuda":
            return _ssm.selective_scan(x, dt, a, b, c, d,
                                       final_state=final_state)
        if x.device.type == "meta" and not _needs_grad(x, dt, a, b, c, d):
            y = torch.empty_like(x)
            if final_state:
                return y, x.new_empty((x.shape[0], x.shape[2], a.shape[-1]),
                                      dtype=torch.float32)
            return y
        if x.device.type in ("cpu", "meta"):
            y = ref.selective_scan(x, dt, a, b, c, d)
            if final_state:
                return y, ref.mamba_final_state(x, dt, a, b)
            return y
    raise ValueError(f"no selective_scan for device {x.device}")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def gated_linear_scan(a: torch.Tensor, b: torch.Tensor, *, impl: str = "ref",
                      block_s: int = 128) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, every h_t in b's dtype: the
    hand kernel on CUDA, the plain scan on the CPU, or with
    ``impl="chunked"`` ``ref.gated_linear_scan_chunked`` in chunks of
    ``2 * block_s`` steps."""
    if _scan_impl(impl) == "chunked":
        return ref.gated_linear_scan_chunked(a, b, chunk=2 * block_s)
    nbytes, flops = cost.scan_work("gated_linear_scan", tuple(b.shape),
                                   b.dtype)
    with cost.kernel("gated_linear_scan", flops, nbytes):
        if b.device.type == "meta" and not _needs_grad(a, b):
            return torch.empty_like(b)
        return _on(b, _rglru.gated_linear_scan, ref.gated_linear_scan,
                   "gated_linear_scan")(a, b)


def profiling_targets(
    *,
    batch: int = 4,
    heads: int = 4,
    kv_heads: int = 2,
    head_dim: int = 64,
    n_pages: int = 16,
    page_tokens: int = 8,
    device=None,
    seed: int = 0,
):
    """Named paged-attention closures over one synthetic decode shape: the
    targets ``repro_torch.obs.profile.DeviceProfiler.profile_many``
    interleaves to time the serving hot kernel against its plain version.

    The inputs (from a generator seeded with ``seed``, on ``device``:
    CUDA unless the caller names another) are made once, so each closure
    times only the call: q ``(B, Hq, D)`` against ``(P, T, Hkv, D)`` pages
    through a ``(B, NP)`` table.  Returns ``(name, fn, tags)`` tuples:
    ``paged_attention_kernel`` (the CUDA kernel, on a CUDA device only)
    and ``paged_attention_ref`` (the plain version)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((batch, heads, head_dim), generator=gen, device=dev)
    kv_shape = (n_pages, page_tokens, kv_heads, head_dim)
    k_pages = torch.randn(kv_shape, generator=gen, device=dev)
    v_pages = torch.randn(kv_shape, generator=gen, device=dev)
    per_req = n_pages // batch
    table = (torch.arange(batch * per_req, dtype=torch.int32, device=dev)
             .reshape(batch, per_req) % n_pages)
    lengths = torch.randint(page_tokens, per_req * page_tokens + 1, (batch,),
                            generator=gen, device=dev, dtype=torch.int32)
    tags = {
        "batch": batch, "heads": heads, "kv_heads": kv_heads,
        "head_dim": head_dim, "n_pages": n_pages,
        "page_tokens": page_tokens,
    }
    targets = []
    if dev.type == "cuda":
        targets.append(("paged_attention_kernel", lambda: _pa.paged_attention(
            q, k_pages, v_pages, table, lengths), {**tags, "impl": "cuda"}))
    targets.append(("paged_attention_ref", lambda: ref.paged_attention(
        q, k_pages, v_pages, table, lengths), {**tags, "impl": "ref"}))
    return targets


# --------------------------------------------------------------------------- #
# GAScore transport (global rank-stacked tensors, see kernels/gascore.py)
# --------------------------------------------------------------------------- #
def _transfer(name: str, x: torch.Tensor, collective: str):
    """A GAScore kernel's report: a collective of ``x``'s bytes (every
    rank's operand), moving ``cost.gascore_bytes``."""
    n = x.shape[0]
    nbytes = cost.gascore_bytes(name, n, x.numel() * x.element_size() // n)
    return cost.kernel(name, 0, nbytes, collective=collective,
                       coll_bytes=x.numel() * x.element_size())


def ring_shift(x: torch.Tensor, k: int) -> torch.Tensor:
    with _transfer("ring_shift", x, "collective-permute"):
        return _on(x, _gc.ring_shift, ref.ring_shift, "ring_shift")(x, k)


def perm_put(x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
    """Bijections only, on either device (the GAScore contract)."""
    if sorted(int(d) for d in dst) != list(range(x.shape[0])):
        raise ValueError(f"perm_put requires a bijection, got {tuple(dst)}")
    with _transfer("perm_put", x, "collective-permute"):
        return _on(x, _gc.perm_put, ref.perm_put, "perm_put")(x, dst)


def offset_put(
    seg: torch.Tensor, data: torch.Tensor, offset: torch.Tensor, k: int
) -> torch.Tensor:
    """On CUDA the kernel writes into ``seg`` in place and returns it; the
    plain version returns a new segment.  Callers use the return value."""
    with _transfer("offset_put", data, "collective-permute"):
        return _on(seg, _gc.offset_put, ref.offset_put, "offset_put")(
            seg, data, offset, k
        )


def ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    with _transfer("ring_all_gather", x, "all-gather"):
        return _on(x, _gc.ring_all_gather, ref.all_gather,
                   "ring_all_gather")(x)


def ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    with _transfer("ring_reduce_scatter", x, "reduce-scatter"):
        return _on(x, _gc.ring_reduce_scatter, ref.reduce_scatter,
                   "ring_reduce_scatter")(x)
