"""Seeded weights, made on the device by the benchmark and handed to both
the program and the reference.

Each leaf is drawn by one call of its own generator, seeded from the
run's seed and the leaf's path, in the dtype the configuration serves
it in: so any leaf can be made again alone (the change of a leaf after
the first training steps is measured against it without a second copy
of the model).  The rules follow the program's own initialisation:
``normal:<std>``, ``fan_in:<axis>`` (std 1/sqrt(shape[axis])), ``ones``,
``zeros``, ``a_log`` (log 1..N along the last axis), ``dt_bias:<lo>:<hi>``
(the inverse softplus of dt log-uniform in [lo, hi]).
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from portbench.reference import common as C

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

Spec = Tuple[Tuple, Tuple[int, ...], str, str]


def leaf_seed(seed: int, name: str) -> int:
    return (int(seed) * 0x9E3779B1 + zlib.crc32(name.encode())) % (1 << 63)


def make_leaf(spec: Spec, seed: int, device) -> torch.Tensor:
    path, shape, dtype, rule = spec
    dt = DTYPES[dtype]
    kind, _, arg = rule.partition(":")
    if kind == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if kind == "a_log":
        n = shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        return row.expand(shape).to(dt).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, C.path_name(path)))
    if kind == "dt_bias":
        lo, hi = (math.log(float(v)) for v in arg.split(":"))
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        dtv = torch.exp(lo + u * (hi - lo))
        return torch.log(torch.expm1(dtv)).to(dt)
    if kind == "normal":
        std = float(arg)
    elif kind == "fan_in":
        std = 1.0 / math.sqrt(shape[int(arg)])
    else:
        raise ValueError(f"unknown init rule {rule!r}")
    x = torch.randn(shape, generator=gen, dtype=dt, device=device)
    return x.mul_(std)


def make_tree(specs: Sequence[Spec], seed: int, device) -> Any:
    return C.build_tree([(s[0], make_leaf(s, seed, device)) for s in specs])


def remaker(specs: Sequence[Spec], seed: int, device
            ) -> Callable[[str], torch.Tensor]:
    """``fn(path name)``: that leaf as it was made."""
    by_name: Dict[str, Spec] = {C.path_name(s[0]): s for s in specs}
    return lambda name: make_leaf(by_name[name], seed, device)


def check_layout(specs: Sequence[Spec], program_tree: Any) -> List[str]:
    """Where the program's parameter tree (``meta`` tensors) differs from
    the layout the benchmark makes: an empty list when they agree."""
    want = {C.path_name(s[0]): (tuple(s[1]), DTYPES[s[2]]) for s in specs}
    have = {C.path_name(p): (tuple(t.shape), t.dtype)
            for p, t in C.leaves_with_path(program_tree)}
    errs = []
    for k in sorted(set(want) | set(have)):
        if want.get(k) != have.get(k):
            errs.append(f"{k}: benchmark {want.get(k)}, program {have.get(k)}")
    return errs
