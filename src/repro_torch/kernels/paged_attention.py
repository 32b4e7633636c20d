"""Paged decode attention on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.paged_attention.paged_attention``
(``_pa_kernel``): decode attention of q ``(B, Hq, D)`` against K/V pages
``(P, T, Hkv, D)`` read in place through ``page_table (B, NP)``, masked at
``lengths (B,)``.  The kernel is ``csrc/paged_attention.cu`` (its header
gives the bound and the design): each request's live positions are split
into runs of whole pages, one CTA per (KV head, request, split), and the
splits' partial softmaxes are merged inside the same launch.  This module
checks the inputs, allocates the merge's workspace and counters, launches
the kernel on PyTorch's current stream and counts the launches.

The wrapper takes CUDA tensors only.  CPU tensors go to the plain version
``repro_torch.kernels.ref.paged_attention`` through
``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["paged_attention", "default_pages_per_split", "NAME", "HEAD_DIMS"]

NAME = "paged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16  # the kernel's vector load width
HEAD_DIMS = (8, 16, 32, 64, 128)  # the head dims the kernel is built for
# positions per CTA: four pages of 16, staged in one pass (see the csrc
# header; tools/ab_attention.py times splits of 1, 2, 4 and 8 pages)
SPLIT_TOKENS = 64

_fn = None
# the merge's arrival counters, one buffer per (device, stream)
_arrival_bufs: Dict[Tuple[int, int], torch.Tensor] = {}


def _kernel():
    global _fn
    if _fn is None:
        f = build.load(NAME).repro_paged_attention
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll,
                      ll, ctypes.c_float, p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _arrivals(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters on ``device``'s current
    stream, zeroed when first made.  The kernel leaves them at 0 (the last
    CTA of each (request, KV head) puts its counter back), so one buffer
    serves every launch on a stream with no memset before it; launches on
    other streams, which may overlap, get buffers of their own, kept for
    the life of the process.  Streams are taken to be long-lived: a caller
    that makes a new stream for each call adds a small buffer each time."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _arrival_bufs.get(key)
    if buf is None or buf.numel() < n:
        buf = _arrival_bufs[key] = torch.zeros(n, dtype=torch.int32,
                                               device=device)
    return buf


def default_pages_per_split(page_tokens: int) -> int:
    """The kernel's default split: whole pages, about ``SPLIT_TOKENS``
    positions."""
    return max(1, SPLIT_TOKENS // page_tokens)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel; returns ``(B, Hq, D)`` in ``q.dtype``.

    ``k_pages``/``v_pages`` may be strided views (one layer of a
    ``(L, P, T, Hkv, D)`` pool): they are read through their page, token
    and head strides, with D contiguous.  No page that an entry of
    ``page_table`` past ``ceil(lengths[b] / T)`` names is read (the
    kernel reads such entries ahead of the length, as numbers only).
    Each CTA takes :func:`default_pages_per_split` pages of a request."""
    B, Hq, D = q.shape
    P, T, Hkv, Dk = k_pages.shape
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)} do not match"
        )
    if Hq % Hkv or Hq // Hkv > 128:
        raise ValueError(f"Hq={Hq} must be Hkv={Hkv} x a group of <= 128")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    NP = page_table.shape[1]
    if page_table.shape != (B, NP) or lengths.shape != (B,):
        raise ValueError("page_table/lengths batch mismatch")
    if not (q.is_contiguous() and page_table.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("q, page_table and lengths must be contiguous")
    if k_pages.stride() != v_pages.stride() or k_pages.stride(3) != 1:
        raise ValueError("k_pages and v_pages need equal strides, D contiguous")
    vec = _VEC_BYTES // q.element_size()
    if D not in HEAD_DIMS or D // vec > 32:
        raise ValueError(f"head dim {D}: the kernel takes {HEAD_DIMS}, at most "
                         f"{32 * vec} for {q.dtype}")
    sp, st, sh, _ = k_pages.stride()
    if D % vec or sp % vec or st % vec or sh % vec or any(
        t.data_ptr() % _VEC_BYTES for t in (q, k_pages, v_pages)
    ):
        raise ValueError("q and K/V rows must be 16-byte aligned for vector "
                         "loads")
    pps = default_pages_per_split(T)
    if scale is None:
        scale = 1.0 / (D**0.5)
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_splits = -(-NP // pps)
    ws = torch.empty(B * Hkv * n_splits * (Hq // Hkv) * (D + 2)
                     if n_splits > 1 else 0, dtype=torch.float32,
                     device=q.device)
    arrivals = _arrivals(q.device, B * Hkv)
    err = _kernel()(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr(), arrivals.data_ptr(), B, Hq, Hkv, D, T, NP, pps * T, sp,
        st, sh, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
