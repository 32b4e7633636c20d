"""The paper's primary contribution, ported: a GASNet-style PGAS substrate.

- ``addrspace``   — partitioned global address space segments (all ranks
                    stacked on one device).
- ``am``          — Active Messages (short/medium/long + handler dispatch).
- ``engine``      — interchangeable transports: the software node (PyTorch
                    indexing) vs the GAScore hardware node (hand-written
                    CUDA kernels), blocking + split-phase, plus
                    heterogeneous per-rank ``EngineMap`` node maps.
- ``transport``   — the rank-stacked transport ops (custom ops with vmap
                    rules) the engines call.
- ``extended``    — GASNet Extended API: non-blocking put/get handles.
- ``collectives`` — ring/segmented collectives over one-sided puts, plus
                    latency-optimal tree/recursive-doubling.
- ``sched``       — the collective scheduler: size-aware algorithm
                    selection + segmentation plans over the engine map.
- ``gasnet``      — the GASNet-like user API (Context / Node / put / get /
                    put_nb / get_nb / sync).
"""
from repro_torch.core.addrspace import AddressSpace, GlobalAddress, SegmentSpec
from repro_torch.core.engine import (
    AlreadyWaitedError,
    CommEngine,
    EngineMap,
    GascoreEngine,
    Pending,
    XlaEngine,
    make_engine,
    parse_backend_spec,
    wait_all,
)
from repro_torch.core.extended import GetHandle, Handle, PutHandle
from repro_torch.core.gasnet import Context, Node, Perm, Shift
from repro_torch.core.sched import CollectivePlan, EngineCost, plan_collective

__all__ = [
    "AddressSpace",
    "GlobalAddress",
    "SegmentSpec",
    "AlreadyWaitedError",
    "CommEngine",
    "Pending",
    "XlaEngine",
    "GascoreEngine",
    "EngineMap",
    "make_engine",
    "parse_backend_spec",
    "wait_all",
    "Handle",
    "PutHandle",
    "GetHandle",
    "Context",
    "Node",
    "Shift",
    "Perm",
    "CollectivePlan",
    "EngineCost",
    "plan_collective",
]
