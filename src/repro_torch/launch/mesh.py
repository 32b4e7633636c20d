"""Per-rank engine maps (port of ``repro.launch.mesh.node_backends``).

Only the node map is ported: the port runs every rank on one device, so
it builds no device mesh.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

__all__ = ["node_backends"]


def node_backends(
    n_nodes: int,
    *,
    hw_ranks: Optional[Iterable[int]] = None,
    pattern: Optional[str] = None,
    software: str = "xla",
    hardware: str = "gascore",
) -> Tuple[str, ...]:
    """Per-rank engine backends for a heterogeneous node map.

    Either name the hardware ranks explicitly (``hw_ranks={1, 3}``) or
    pick a ``pattern``:

    - ``"alternating"`` — odd ranks are hardware nodes (the paper's mixed
      racks: every CPU node paired with an FPGA node),
    - ``"split"``       — the upper half of the ring is hardware,
    - ``None``          — all software.

    Feed the result to ``make_engine(...)`` / ``gasnet.Context(backend=...)``.
    """
    if hw_ranks is not None and pattern is not None:
        raise ValueError("pass hw_ranks or pattern, not both")
    if hw_ranks is not None:
        hw = {int(r) % n_nodes for r in hw_ranks}
    elif pattern == "alternating":
        hw = {r for r in range(n_nodes) if r % 2 == 1}
    elif pattern == "split":
        hw = set(range(n_nodes // 2, n_nodes))
    elif pattern is None:
        hw = set()
    else:
        raise ValueError(f"unknown node-map pattern {pattern!r}")
    return tuple(hardware if r in hw else software for r in range(n_nodes))
