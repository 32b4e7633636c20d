"""GAScore on the GPU: the wrappers of the five hand-written CUDA kernels.

Replaces the TPU kernels of ``repro.kernels.gascore``.  Every function acts
on the GLOBAL rank-stacked tensor ``(n_nodes, *local)``: on one H100 all
ranks' partitions lie in the same HBM, so one launch carries the puts of
all n ranks.

- :func:`ring_shift`          rank i's row lands on rank (i+k) % n.
- :func:`perm_put`            rank i's row lands on rank dst[i] (bijection).
- :func:`offset_put`          AMLong: rank i's data lands in rank (i+k) % n's
                              segment at a sender-chosen row, in place.
- :func:`ring_all_gather`     (n, m, ...) -> (n, n*m, ...).
- :func:`ring_reduce_scatter` (n, n*m, ...) -> (n, m, ...), ring order.

The three puts are one kernel (``csrc/gascore_put.cu``), the two
collectives another (``csrc/gascore_ring.cu``); their headers give the
bound and the design.  Each wrapper checks its inputs, launches on
PyTorch's current stream, raises on a CUDA error and counts ``launches``.
The wrappers take CUDA tensors only; CPU tensors go to the plain versions
in ``repro_torch.kernels.ref`` through ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

__all__ = [
    "PUT",
    "RING",
    "ring_shift",
    "perm_put",
    "offset_put",
    "ring_all_gather",
    "ring_reduce_scatter",
]

PUT = "gascore_put"  # csrc/gascore_put.cu
RING = "gascore_ring"  # csrc/gascore_ring.cu
MAX_RANKS = 256  # the put kernel's by-value rank map
_RS_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_fns: dict = {}
_sm_counts: dict = {}  # device index -> multiprocessor count


def _fn(lib: str, symbol: str, argtypes):
    key = (lib, symbol)
    f = _fns.get(key)
    if f is None:
        f = getattr(build.load(lib), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[key] = f
    return f


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _put_fn():
    return _fn(PUT, "repro_gascore_put",
               [_p, _p, _i, _ll, _ll, _ll, _p, _p, _i, _i, _p])


def _offset_put_fn():
    return _fn(PUT, "repro_gascore_offset_put",
               [_p, _p, _i, _ll, _ll, _ll, _i, _p, _i, _ll, _ll, _i, _i, _p])


def _gather_fn():
    return _fn(RING, "repro_gascore_all_gather", [_p, _p, _i, _ll, _i, _i, _p])


def _rs_fn():
    return _fn(RING, "repro_gascore_reduce_scatter",
               [_i, _p, _p, _i, _ll, _i, _i, _p])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sms(t: torch.Tensor) -> int:
    idx = t.device.index
    n = _sm_counts.get(idx)
    if n is None:
        n = torch.cuda.get_device_properties(t.device).multi_processor_count
        _sm_counts[idx] = n
    return n


def _word_bytes(*sizes: int) -> int:
    """The widest word (16, 4, 2 or 1 bytes) dividing every size, offset
    and pointer: the kernels never move a float, only raw words."""
    for w in (16, 4, 2):
        if all(s % w == 0 for s in sizes):
            return w
    return 1


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {name} on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.dim() < 1 or x.shape[0] < 1:
        raise ValueError(f"{name} needs a leading rank axis, got "
                         f"{tuple(x.shape)}")
    if x.shape[0] > MAX_RANKS:
        raise ValueError(f"at most {MAX_RANKS} ranks, got {x.shape[0]}")


def _row_bytes(x: torch.Tensor) -> int:
    return x.numel() // x.shape[0] * x.element_size()


def _put(src, dst, src_row, dst_row, copy, dst_rank, dst_off) -> bool:
    """Launch the put kernel; False when there is nothing to copy."""
    if copy == 0:
        return False
    n = src.shape[0]
    w = _word_bytes(src_row, dst_row, copy, src.data_ptr(), dst.data_ptr(),
                    *dst_off)
    ranks = (ctypes.c_int * n)(*dst_rank)
    offs = (ctypes.c_longlong * n)(*dst_off)
    err = _put_fn()(src.data_ptr(), dst.data_ptr(), n, src_row, dst_row, copy,
                    ctypes.cast(ranks, _p), ctypes.cast(offs, _p), w,
                    _sms(src), _stream(src))
    if err != 0:
        raise RuntimeError(f"gascore put launch failed: CUDA error {err}")
    return True


def ring_shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rank i's ``x[i]`` lands on rank (i+k) % n: one launch for all n
    puts.  ``k % n == 0`` is the identity and launches nothing."""
    _check(x, "x")
    n = x.shape[0]
    if k % n == 0:
        return x
    out = torch.empty_like(x)
    row = _row_bytes(x)
    if _put(x, out, row, row, row, [(r + k) % n for r in range(n)], [0] * n):
        ring_shift.launches += 1
    return out


def perm_put(x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
    """Rank i's ``x[i]`` lands on rank ``dst[i]``.  ``dst`` must be a
    bijection of 0..n-1, as the TPU kernel demands (every recv semaphore
    fires exactly once)."""
    _check(x, "x")
    n = x.shape[0]
    dst = [int(d) for d in dst]
    if sorted(dst) != list(range(n)):
        raise ValueError(f"perm_put requires a bijection, got {tuple(dst)}")
    out = torch.empty_like(x)
    row = _row_bytes(x)
    if _put(x, out, row, row, row, dst, [0] * n):
        perm_put.launches += 1
    return out


def offset_put(
    seg: torch.Tensor, data: torch.Tensor, offset: torch.Tensor, k: int
) -> torch.Tensor:
    """AMLong: rank i's ``data[i]`` (L, ...) lands in rank (i+k) % n's
    partition of ``seg`` (n, S, ...) at leading row ``offset[i]``, written
    IN PLACE into ``seg`` (the TPU kernel's ``input_output_aliases``);
    returns ``seg``.

    ``offset`` is an int32 tensor of one offset or one per rank, clamped to
    [0, S - L] as JAX clamps (and as ``ref.offset_put`` does), so no offset
    value raises and no write leaves its row.  On the card the kernel reads
    the offsets from device memory inside the launch: the host never waits
    on them.  Offsets held on the host are clamped there and passed by
    value, as the other puts pass theirs."""
    _check(seg, "seg")
    _check(data, "data")
    if data.device != seg.device or data.dtype != seg.dtype:
        raise TypeError("seg and data must share one device and dtype")
    if seg.dim() < 2:
        raise ValueError(f"seg {tuple(seg.shape)} needs (n, S, ...) rows")
    n, S = seg.shape[0], seg.shape[1]
    if data.dim() != seg.dim() or data.shape[0] != n or (
            tuple(data.shape[2:]) != tuple(seg.shape[2:])) or (
            data.shape[1] > S):
        raise ValueError(f"data {tuple(data.shape)} does not fit seg "
                         f"{tuple(seg.shape)}")
    L = data.shape[1]
    if offset.dtype != torch.int32 or offset.numel() not in (1, n):
        raise TypeError("offset must be int32, one value or one per rank")
    if offset.device.type not in ("cpu", seg.device.type) or (
            offset.device.type == "cuda" and offset.device != seg.device):
        raise ValueError(f"offset on {offset.device}, seg on {seg.device}")
    seg_row, data_row = _row_bytes(seg), _row_bytes(data)
    elem_row = seg_row // S if S else 0
    if offset.device.type == "cpu":
        offs = [min(max(o, 0), S - L) for o in offset.reshape(-1).expand(n).tolist()]
        dst_rank = [(r + k) % n for r in range(n)]
        dst_off = [o * elem_row for o in offs]  # byte offset of sender r
        if _put(data, seg, data_row, seg_row, data_row, dst_rank, dst_off):
            offset_put.launches += 1
        return seg
    if data_row == 0:
        return seg
    off = offset.reshape(-1).contiguous()
    w = _word_bytes(data_row, seg_row, elem_row, data.data_ptr(),
                    seg.data_ptr())
    err = _offset_put_fn()(data.data_ptr(), seg.data_ptr(), n, data_row,
                           seg_row, data_row, k, off.data_ptr(),
                           int(off.numel() == n), elem_row, S - L, w,
                           _sms(seg), _stream(seg))
    if err != 0:
        raise RuntimeError(f"gascore offset_put launch failed: CUDA error {err}")
    offset_put.launches += 1
    return seg


def ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    """(n, m, ...) -> (n, n*m, ...): every rank's slot c holds rank c's
    chunk.  One launch writes all n x n slots."""
    _check(x, "x")
    n = x.shape[0]
    out = torch.empty((n, n * x.shape[1]) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device) if x.dim() > 1 else (
        torch.empty((n, n), dtype=x.dtype, device=x.device))
    row = _row_bytes(x)
    if row:
        w = _word_bytes(row, x.data_ptr(), out.data_ptr())
        err = _gather_fn()(x.data_ptr(), out.data_ptr(), n, row, w, _sms(x),
                           _stream(x))
        if err != 0:
            raise RuntimeError(
                f"ring_all_gather launch failed: CUDA error {err}")
        ring_all_gather.launches += 1
    return out


def ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """(n, n*m, ...) -> (n, m, ...): rank c holds the sum over ranks of
    chunk c, added in ring order (bit-exact against the software ring)."""
    _check(x, "x")
    if x.dtype not in _RS_DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}: float32, bfloat16 or "
                        "int32")
    n = x.shape[0]
    if x.dim() < 2 or x.shape[1] % n:
        raise ValueError(f"dim 1 of {tuple(x.shape)} not divisible by {n}")
    m_rows = x.shape[1] // n
    out = torch.empty((n, m_rows) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    m = out[0].numel()  # elements of one chunk
    if m:
        vector = int((m * x.element_size()) % 16 == 0
                     and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        err = _rs_fn()(_RS_DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), n,
                       m, vector, _sms(x), _stream(x))
        if err != 0:
            raise RuntimeError(
                f"ring_reduce_scatter launch failed: CUDA error {err}")
        ring_reduce_scatter.launches += 1
    return out


for _f in (ring_shift, perm_put, offset_put, ring_all_gather,
           ring_reduce_scatter):
    _f.launches = 0
