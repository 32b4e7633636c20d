"""Per-rank engine maps and serving roles (port of ``repro.launch.mesh``).

The node map and the serving-role functions are ported; the port runs
every rank on one device, so it builds no device mesh.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

__all__ = [
    "node_backends",
    "serve_roles",
    "decode_groups",
    "role_backends",
    "promote_spare",
]


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


def serve_roles(
    n_prefill: int,
    n_decode: int,
    n_memory: int = 0,
    tp: int = 1,
    n_spare: int = 0,
) -> Tuple[str, ...]:
    """Per-rank roles of a disaggregated serving ring: the first
    ``n_prefill`` ranks are the prefill pool, then the decode pool, then
    ``n_memory`` *memory* ranks — the paper's memory-node archetype:
    ranks that export segment capacity into the global address space but
    run no model compute (the second tier of the KV hierarchy; see
    ``repro_torch.serving.tier``).

    The convention is load-bearing: `repro_torch.serving.disagg` derives
    dispatch targets, the KV handoff permutation, swap destinations, and
    segment slot ownership from rank order alone, so every node agrees on
    it without any exchange (the SPMD analogue of a static cluster map).

    ``tp`` carves the decode pool into tensor-parallel groups of ``tp``
    consecutive ranks (see :func:`decode_groups`): it must divide
    ``n_decode``, and every member of a group keeps the ``"decode"``
    role — group structure is a decode-pool refinement, not a new role.

    ``n_spare`` trailing *spare* ranks join the ring idle (segment
    capacity reserved, no assigned work) and are promoted into a pool by
    :func:`promote_spare` at elastic scale-out: membership changes
    without re-launching the job, since the ring size — which every
    permutation and segment shape depends on — never changes.
    """
    if n_prefill < 1 or n_decode < 1 or n_memory < 0 or n_spare < 0:
        raise ValueError(
            f"need at least 1 prefill and 1 decode rank (memory/spare "
            f">= 0), got {n_prefill}/{n_decode}/{n_memory}/{n_spare}"
        )
    if tp < 1 or n_decode % tp:
        raise ValueError(
            f"tp={tp} must divide the decode pool (n_decode={n_decode})"
        )
    return (
        ("prefill",) * n_prefill
        + ("decode",) * n_decode
        + ("memory",) * n_memory
        + ("spare",) * n_spare
    )


def decode_groups(
    n_prefill: int, n_decode: int, tp: int = 1
) -> Tuple[Tuple[int, ...], ...]:
    """The decode pool carved into TP groups of ``tp`` consecutive ranks.

    Group ``g`` is ranks ``[n_prefill + g*tp, n_prefill + (g+1)*tp)``;
    its first member is the *group leader* — the rank whose pool shard
    backs the group's page allocator and which receives the control-plane
    AMs (KV-ready, acks).  Consecutive placement keeps the per-step
    all-reduce on ring-adjacent edges.
    """
    serve_roles(n_prefill, n_decode, tp=tp)  # validate
    return tuple(
        tuple(range(n_prefill + g * tp, n_prefill + (g + 1) * tp))
        for g in range(n_decode // tp)
    )


def role_backends(
    roles: Tuple[str, ...],
    *,
    prefill: str = "xla",
    decode: str = "xla",
    memory: str = "xla",
    spare: Optional[str] = None,
) -> Tuple[str, ...]:
    """Per-rank engine backends keyed by serving role.

    The paper's split maps naturally onto disaggregation: prefill nodes
    can stay software GASNet nodes (``"xla"``) while the decode pool —
    whose KV installs are pure remote-DMA traffic — runs on hardware
    nodes (``"gascore"``), or any other mix; memory ranks (pure segment
    exporters, the FPGA memory-node archetype) take their own engine too.
    Feed the result to ``make_engine`` / ``gasnet.Context(backend=...)``
    to get an ``EngineMap`` when the pools differ.  Spare ranks default
    to the decode engine (they are promoted into the decode pool).
    """
    table = {
        "prefill": prefill,
        "decode": decode,
        "memory": memory,
        "spare": decode if spare is None else spare,
    }
    try:
        return tuple(table[r] for r in roles)
    except KeyError as e:
        raise ValueError(f"unknown serving role {e.args[0]!r}") from None


def promote_spare(
    roles: Tuple[str, ...], rank: int, to: str = "decode"
) -> Tuple[str, ...]:
    """Elastic scale-out: promote spare ``rank`` into pool ``to`` and
    return the regenerated role map.  Only ``"spare"`` ranks promote (a
    live pool member never changes role mid-job), and the ring size is
    unchanged — every derived permutation stays valid."""
    if not (0 <= rank < len(roles)):
        raise ValueError(f"rank {rank} outside the {len(roles)}-rank ring")
    if roles[rank] != "spare":
        raise ValueError(
            f"rank {rank} has role {roles[rank]!r}, only spares promote"
        )
    if to not in ("prefill", "decode", "memory"):
        raise ValueError(f"cannot promote a spare to {to!r}")
    return roles[:rank] + (to,) + roles[rank + 1 :]
