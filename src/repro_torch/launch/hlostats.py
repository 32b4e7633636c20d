"""The op-stream counter: the port's ``repro.launch.hlostats``.

The reference re-derives flops, bytes and collective bytes from compiled
HLO text, multiplying each ``while`` body by its trip count, because
XLA's ``cost_analysis`` counts a loop body once.  Eager PyTorch has no
compiled module and no loops to recover: every Python loop (over layers,
attention chunks, optimizer chunks) is unrolled as it dispatches.  So the
port counts the ops a step DISPATCHES, under a ``TorchDispatchMode``,
with the reference's per-op model:

  flops      — matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``):
               2 × result numel × contracted size (plus the added term);
               arithmetic element-wise ops and reductions: 1 flop per
               output element.
  bytes      — operands + results of every op that materialises (every
               non-view op of an eager step writes its result to memory:
               the counterpart of the reference's instruction boundaries).
               Views and allocations without a write count nothing.
  collective — operand bytes per collective type, reported by the GAS
               transport (``core/transport.py``) and the GAScore kernels:
               one collective of the reference's type however it moves.

Each hand kernel (``kernels/ops.py``, ``FlashAttention``) counts as ONE
op with the work of what it computes (``kernels.cost``), whatever
implements it, and what it dispatches inside is not counted, so a step
counts the same on ``meta`` (the dry run), on the CPU and on the card.
Inside a ``Context.spmd`` node program over n ranks the counts are one
rank's (divided by n), as the reference's per-device HLO counts them.

``while_trips`` stays ``{}`` and ``unresolved_whiles`` ``[]``: eager
dispatch unrolls every loop, so there is no trip count to recover.  The
record keeps both keys so that a dry-run record has the reference's
schema.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost

__all__ = ["COLLECTIVES", "HloStats", "OpCounter", "analyze"]

COLLECTIVES = cost.COLLECTIVES

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}

# arithmetic element-wise ops and reductions (aten names; an in-place
# variant's trailing "_" is dropped first): 1 flop per output element
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "exp",
    "exp2", "log", "log2", "tanh", "rsqrt", "sqrt", "neg", "abs", "eq",
    "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "expm1", "log1p", "sin", "cos", "atan2",
    "clamp", "clamp_min", "clamp_max", "round", "sign", "floor", "ceil",
    "sigmoid", "erf", "silu", "gelu", "softplus", "reciprocal", "square",
    "remainder", "fmod", "floor_divide", "relu", "lerp", "addcmul",
    "addcdiv", "masked_fill", "sum", "mean", "amax", "amin", "max", "min",
    "prod", "logsumexp", "any", "all", "var", "std", "var_mean",
    "linalg_vector_norm", "norm", "argmax", "argmin", "cumsum", "softmax",
    "_softmax", "log_softmax", "_log_softmax", "tanh_backward",
    "sigmoid_backward", "silu_backward", "gelu_backward",
    "softplus_backward", "threshold_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
}

# ops that move no bytes: allocations without a write, aliases
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "_unsafe_view", "lift_fresh", "alias", "set", "resize",
}


@dataclasses.dataclass
class HloStats:
    flops: float
    bytes: float
    collective_bytes: float
    collective_per_type: Dict[str, float]
    collective_counts: Dict[str, float]
    while_trips: Dict[str, int]
    unresolved_whiles: List[str]
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0  # ops counted: dispatched ops and kernel calls

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (``with OpCounter() as
    c: ...``; then ``c.stats()``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {c: 0.0 for c in COLLECTIVES}
        self.coll_n = {c: 0.0 for c in COLLECTIVES}
        self.kernels: Dict[str, int] = collections.Counter()
        self.ops = 0
        self._records = 0
        self._sink = None

    def __enter__(self):
        out = super().__enter__()
        self._sink = cost.counting(self)
        self._sink.__enter__()
        return out

    def __exit__(self, *exc):
        self._sink.__exit__(*exc)
        return super().__exit__(*exc)

    # a hand kernel's or a collective's report (``cost.kernel``)
    def record(self, name: str, flops: float, nbytes: float,
               collective, coll_bytes: float) -> None:
        share = 1.0 / cost.ranks()
        self.flops += flops * share
        self.bytes += nbytes * share
        if collective is not None:
            self.coll[collective] += coll_bytes * share
            self.coll_n[collective] += 1
        self.kernels[name] += 1
        self.ops += 1
        self._records += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if cost.suppressed():
            return func(*args, **kwargs)
        if func.namespace == "repro_torch":
            # a custom op of the port: a kernel reports itself from its
            # implementation; any other (a tag, a bitcast) is a copy
            before = self._records
            out = func(*args, **kwargs)
            if self._records == before:
                self._count(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        base = name[:-1] if name.endswith("_") and not name.startswith("_") \
            else name
        if func.is_view or base in _FREE:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        share = 1.0 / cost.ranks()
        self.bytes += sum(_nbytes(t) for t in ins + outs) * share
        if base in _DOTS:
            a = args[1] if base in ("addmm", "baddbmm") else args[0]
            res = outs[0].numel()
            self.flops += (2.0 * res * a.shape[-1]
                           + (res if base in ("addmm", "baddbmm") else 0)
                           ) * share
        elif base in _ELEMENTWISE:
            self.flops += sum(t.numel() for t in outs) * share
        self.ops += 1

    def stats(self) -> HloStats:
        return HloStats(
            flops=self.flops,
            bytes=self.bytes,
            collective_bytes=sum(self.coll.values()),
            collective_per_type=dict(self.coll),
            collective_counts=dict(self.coll_n),
            while_trips={},
            unresolved_whiles=[],
            kernels=dict(self.kernels),
            ops=self.ops,
        )


def analyze(fn: Callable, *args: Any, **kw: Any) -> HloStats:
    """Run ``fn(*args, **kw)`` under an :class:`OpCounter`; its counts."""
    with OpCounter() as counter:
        fn(*args, **kw)
    return counter.stats()
