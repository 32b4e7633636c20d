"""Lockstep SPMD simulator: run collective schedules rank by rank.

Port of ``repro.testing.sim``.  The ring/tree/recursive-doubling
algorithms in ``repro_torch.core.collectives``
are pure functions of ``(engine, local_value)`` whose communication
pattern is *static* — every rank makes the identical sequence of
``shift``/``permute`` calls (SPMD).  That makes them property-testable
without a multi-device mesh: :func:`run_spmd` executes the program once
per rank with a :class:`SimEngine` whose transport reads the values the
*other* ranks sent at the same call index.

Receives at call index c depend only on sends at index c, which depend
only on receives at indices < c, so iterating the whole program to
fixpoint resolves one more call index per sweep; convergence is reached
in at most (#comm calls + 1) sweeps and is verified, not assumed.

It runs a program on plain (unbatched) tensors, one call per rank, so the
port's property tests can hold a collective against its schedule without
``Context.spmd``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.engine import CommEngine

__all__ = ["SimEngine", "run_spmd"]


class SimEngine(CommEngine):
    """One rank's engine inside :func:`run_spmd` (see module docstring).

    ``my_id`` is the concrete rank; ``shift``/``permute`` record this
    rank's send into the current sweep's mailbox and return what the
    counterpart rank sent at the same call index in the *previous* sweep
    (zeros on the first sweep).
    """

    name = "sim"
    can_permute_partial = True

    def __init__(self, n_nodes: int, rank: int, prev: dict, sends: dict):
        super().__init__(axis="sim", n_nodes=n_nodes)
        self.rank = rank
        self._prev = prev
        self._sends = sends
        self._calls = 0

    def my_id(self) -> torch.Tensor:
        return torch.tensor(self.rank, dtype=torch.int32)

    def barrier(self, token=None) -> torch.Tensor:
        t = torch.ones((), dtype=torch.int32) if token is None else token
        return t * self.n_nodes

    def _record(self, tag, value) -> int:
        c = self._calls
        self._calls += 1
        slot = self._sends.setdefault(c, {})
        slot[self.rank] = (tag, value.detach().cpu().clone())
        return c

    def _recv(self, c: int, src: Optional[int],
              like: torch.Tensor) -> torch.Tensor:
        prev = self._prev.get(c)
        if src is None or prev is None or src not in prev:
            return torch.zeros_like(like)
        _, val = prev[src]
        return val.clone()

    def shift(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        n = self.n_nodes
        if k % n == 0:
            return x
        c = self._record(("shift", k % n), x)
        return self._recv(c, (self.rank - k) % n, x)

    def permute(self, x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
        c = self._record(("permute", tuple(dst)), x)
        src = None
        for s, d in enumerate(dst):
            if d is not None and int(d) == self.rank:
                src = s
                break
        return self._recv(c, src, x)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import collectives

        return collectives.ring_all_reduce(self, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import collectives

        return collectives.ring_all_gather(self, x)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import collectives

        return collectives.ring_reduce_scatter(self, x)


def _bytes(t: torch.Tensor) -> bytes:
    u8 = t.contiguous().reshape(-1).view(torch.uint8) if t.dim() else (
        t.reshape(1).view(torch.uint8))
    return u8.numpy().tobytes()


def _mailbox_equal(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for c in a:
        if a[c].keys() != b[c].keys():
            return False
        for r in a[c]:
            (tag_a, va), (tag_b, vb) = a[c][r], b[c][r]
            if tag_a != tag_b or va.shape != vb.shape or va.dtype != vb.dtype:
                return False
            # bitwise, not numeric: NaN payloads (e.g. int bit patterns
            # riding a float carrier) must still reach fixpoint
            if _bytes(va) != _bytes(vb):
                return False
    return True


def run_spmd(
    program: Callable[[CommEngine], object], n_nodes: int, max_sweeps: int = 0
) -> List[object]:
    """Run ``program(engine)`` for every rank, lockstep to fixpoint.

    Returns the per-rank outputs.  Raises if the mailbox has not
    converged after the sweep bound (a data-dependent communication
    pattern, which is not SPMD-static and not supported here).
    """
    prev: dict = {}
    outs: List[object] = []
    sends: dict = {}
    for sweep in range(2):  # bootstrap: discover the call count
        sends = {}
        outs = [
            program(SimEngine(n_nodes, r, prev, sends)) for r in range(n_nodes)
        ]
        if _mailbox_equal(sends, prev):
            return outs
        prev = sends
    bound = max_sweeps or (len(sends) + 2)
    for sweep in range(bound):
        sends = {}
        outs = [
            program(SimEngine(n_nodes, r, prev, sends)) for r in range(n_nodes)
        ]
        if _mailbox_equal(sends, prev):
            return outs
        prev = sends
    raise RuntimeError(
        f"SPMD simulation did not converge in {bound + 2} sweeps; "
        "is the communication pattern data-dependent?"
    )
