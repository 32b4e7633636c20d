"""Synthetic LM data: deterministic, seekable, restart-safe.

The port's copy of ``repro.data.synthetic``.  Every batch is a pure
function of (seed, step), drawn with numpy exactly as the reference draws
it, so the two packages see bit-identical batches, and a job restarted
from a checkpoint at step k consumes the same stream it would have seen
uninterrupted.

The token stream is Zipf-ish with a planted bigram structure
(``next = (5 * tok + 7) % vocab`` with noise), so a real model shows a
falling loss.

:class:`Loader` prefetches one batch ahead on a background thread and
places each batch on one device.  :class:`ShardedLoader` is the
reference's loader with its mesh: on the one card it places the global
batch whole, after checking that the batch divides its data-parallel
axes (where the reference's ``sanitize`` would drop them, it raises).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["SyntheticLM", "Loader", "ShardedLoader"]


class SyntheticLM:
    """Deterministic synthetic batches for an ArchConfig."""

    def __init__(
        self,
        cfg: Any,
        batch: int,
        seq_len: int,
        seed: int = 0,
        structure: float = 0.7,
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.structure = structure

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq_len, self.cfg.vocab
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        noise = rng.random((B, S))
        rand_next = rng.integers(0, V, size=(B, S))
        for t in range(S):
            planted = (5 * toks[:, t] + 7) % V
            toks[:, t + 1] = np.where(
                noise[:, t] < self.structure, planted, rand_next[:, t]
            )
        out: Dict[str, np.ndarray] = {
            "inputs": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32),
        }
        if getattr(self.cfg, "n_enc_layers", 0):
            out["frames"] = rng.standard_normal(
                (B, S, self.cfg.d_model), np.float32
            ).astype(np.float32)
        elif getattr(self.cfg, "cross_kv_len", 0):
            out["xkv"] = rng.standard_normal(
                (B, self.cfg.cross_kv_len, self.cfg.d_model), np.float32
            ).astype(np.float32)
        return out


class Loader:
    """Prefetching loader that places batches on ``device``.

    ``step`` is the cursor of the next batch the caller receives (saved in
    checkpoints as ``data_step``).  :meth:`close` stops the thread."""

    def __init__(self, source: SyntheticLM, device: Any = "cpu",
                 start_step: int = 0, prefetch: int = 1):
        self.source = source
        self.device = torch.device(device)
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host_batch.items()}

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        step, batch = self._q.get()
        self.step = step + 1
        return self._place(batch)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class ShardedLoader(Loader):
    """The reference's ``ShardedLoader(source, mesh, dp_axes, start_step,
    prefetch)``: batches with the mesh's batch sharding, ``P(dp_axes)`` on
    the leading dim.  The port holds a global batch whole on ``device``;
    a batch whose leading dim the ``dp_axes`` do not divide (which the
    reference's sanitation would replicate) raises here."""

    def __init__(self, source: SyntheticLM, mesh: Optional[Any] = None,
                 dp_axes=("data",), start_step: int = 0, prefetch: int = 1,
                 device: Any = "cpu"):
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        if mesh is not None:
            from repro_torch.core.addrspace import PartitionSpec as P
            from repro_torch.parallel.sharding import sanitize

            spec = P(self.dp_axes)
            if sanitize(spec, (source.batch,), mesh) != spec:
                raise ValueError(
                    f"batch {source.batch} does not divide the mesh's "
                    f"{self.dp_axes} axes ({dict(mesh.shape)})")
        super().__init__(source, device=device, start_step=start_step,
                         prefetch=prefetch)
