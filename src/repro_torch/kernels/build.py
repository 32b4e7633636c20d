"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
for ``sm_90a`` into a shared library under ``build/repro_torch_kernels/``
at the repository root (or ``$REPRO_TORCH_BUILD_DIR``).  The library's
name carries a hash of its source and of the shared ``csrc/*.cuh``
headers, so an edited source or header is rebuilt and a built one is
reused.  Nothing is compiled when a module is imported:
:func:`load` builds at first use, and :func:`build_all` starts one
``nvcc`` per source at once so that several kernels build in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

__all__ = ["CSRC", "build_all", "library_path", "load", "sources"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build")
    return str(path)


def sources() -> List[str]:
    """The name of every kernel source, ``csrc/<name>.cu``, sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return _build_dir() / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when its library is built."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Sequence[str]) -> float:
    """Build every named kernel library, all ``nvcc`` runs at once;
    returns the wall seconds spent."""
    t0 = time.perf_counter()
    started: List = [(n, _start(n)) for n in names]
    errors = []
    for n, s in started:
        if s is None:
            continue
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
