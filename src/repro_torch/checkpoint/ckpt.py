"""Async, atomic checkpoints: the port of ``repro.checkpoint.ckpt``.

The same on-disk layout as the reference: one directory ``step_XXXXXXXXXX``
per step with one ``.npy`` per tree leaf, named by the leaf's
``/``-joined key path (``/`` written as ``__``), plus ``manifest.json``
(the leaves' keys, shapes and dtypes, the step, and ``extra`` such as the
data-stream cursor).  A checkpoint the reference wrote restores here.

``save`` snapshots every leaf to host memory synchronously (a consistent
cut), then writes on a background thread into ``<dir>.tmp`` and renames it
into place, so a reader never sees a half-written step;
``AsyncHandle.wait`` joins before the next save or at shutdown.

numpy has no bfloat16 (without ``ml_dtypes``): a bf16 leaf is written as
its raw 16-bit words under the header the reference's ``np.save`` writes
for ``ml_dtypes.bfloat16`` (``'descr': '<V2'``), so the two packages'
files are byte-identical; the manifest records ``"bfloat16"`` and the
leaf restores bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import tree_flatten_with_path, tree_unflatten

__all__ = ["save", "restore", "latest_step", "AsyncHandle", "cleanup"]

_MANIFEST = "manifest.json"


def _leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    return [("/".join(str(p) for p in path), leaf)
            for path, leaf in tree_flatten_with_path(tree)]


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A private host copy of ``t`` and the dtype name the manifest
    records (bf16 as its raw 16-bit words, a ``V2`` view)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _save_npy(path: str, a: np.ndarray, dtype_name: str) -> None:
    """``np.save``, but a bf16 leaf gets the reference's ``'<V2'`` header
    (``ml_dtypes.bfloat16``'s descr; numpy's own void dtype would write
    ``'|V2'``) in front of the same raw little-endian words."""
    if dtype_name != "bfloat16":
        np.save(path, a)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(np.ascontiguousarray(a).tobytes())


class AsyncHandle:
    def __init__(self, thread: threading.Thread, path: str):
        self._thread = thread
        self.path = path

    def wait(self):
        self._thread.join()


def save(
    root: str,
    step: int,
    tree: Any,
    *,
    extra: Optional[Dict[str, Any]] = None,
) -> AsyncHandle:
    """Snapshot ``tree`` at ``step``: synchronous host copy, async write."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:010d}")
    tmp = final + ".tmp"
    host = [(k, *_to_host(v)) for k, v in _leaf_paths(tree)]
    manifest = {
        "step": step,
        "leaves": [
            {"key": k, "shape": list(a.shape), "dtype": dt}
            for k, a, dt in host
        ],
        "extra": extra or {},
    }

    def write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, a, dt in host:
            _save_npy(os.path.join(tmp, k.replace("/", "__") + ".npy"), a, dt)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    return AsyncHandle(t, final)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, _MANIFEST)):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _from_host(a: np.ndarray, dtype_name: str, like: torch.Tensor) -> torch.Tensor:
    if dtype_name == "bfloat16" or a.dtype.kind == "V":  # raw 16-bit words
        t = torch.from_numpy(np.array(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy, 0-d kept
    if t.dtype != like.dtype or tuple(t.shape) != tuple(like.shape):
        raise ValueError(
            f"checkpoint leaf {tuple(t.shape)} {t.dtype} does not fit "
            f"{tuple(like.shape)} {like.dtype}"
        )
    return t.to(like.device)


def restore(root: str, step: int, target: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``target`` (a tree of tensors): each
    leaf gets the target leaf's shape, dtype and device, or raises."""
    d = os.path.join(root, f"step_{step:010d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    dtypes = {leaf["key"]: leaf["dtype"] for leaf in manifest["leaves"]}
    leaves = []
    for k, like in _leaf_paths(target):
        a = np.load(os.path.join(d, k.replace("/", "__") + ".npy"))
        leaves.append(_from_host(a, dtypes.get(k, str(a.dtype)), like))
    return tree_unflatten(target, leaves), manifest.get("extra", {})


def cleanup(root: str, keep_last: int = 2) -> None:
    if not os.path.isdir(root):
        return
    steps = sorted(
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep_last] if keep_last else steps:
        shutil.rmtree(os.path.join(root, f"step_{s:010d}"), ignore_errors=True)
