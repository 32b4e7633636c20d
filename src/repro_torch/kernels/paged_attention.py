"""Paged decode attention on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.paged_attention.paged_attention``
(``_pa_kernel``): decode attention of q ``(B, Hq, D)`` against K/V pages
``(P, T, Hkv, D)`` read in place through ``page_table (B, NP)``, masked at
``lengths (B,)``.  The kernel is ``csrc/paged_attention.cu`` (its header
gives the bound and the design); this module checks the inputs, launches
it on PyTorch's current stream and counts the launches.

The wrapper takes CUDA tensors only.  CPU tensors go to the plain version
``repro_torch.kernels.ref.paged_attention`` through
``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["paged_attention", "NAME"]

NAME = "paged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16  # the kernel's vector load width

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = build.load(NAME).repro_paged_attention
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, ll, ll, ll,
                      ctypes.c_float, p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


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
    and head strides, with D contiguous.  Entries of ``page_table`` past
    ``ceil(lengths[b] / T)`` are never read."""
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
    sp, st, sh, _ = k_pages.stride()
    if D % vec or sp % vec or st % vec or sh % vec or any(
        t.data_ptr() % _VEC_BYTES for t in (k_pages, v_pages)
    ):
        raise ValueError("K/V rows must be 16-byte aligned for vector loads")
    if scale is None:
        scale = 1.0 / (D**0.5)
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = _kernel()(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, T, NP, sp, st, sh, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
