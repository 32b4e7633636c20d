"""PGAS scientific kernel: 1-D Jacobi heat diffusion with halo exchange.

The paper closes by planning "higher-level communication abstractions
... for parallel scientific computations"; the canonical PGAS citizen is a
stencil whose halo exchange is a pair of one-sided puts per step.  Each
node owns an interior strip of the rod plus two ghost cells; every
iteration puts its boundary values into the neighbors' ghost cells through
the GAS API and relaxes locally.  Verified against a dense numpy rod.
The port's twin of the reference's ``examples/stencil_halo.py``: its
``lax.scan`` over the steps is a Python loop inside the node program.

Run:  PYTHONPATH=src python -m repro_torch.examples.stencil_halo
      [--backend xla|gascore|xla,gascore] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gasnet
from repro_torch.core.gasnet import P

N_NODES = 8
LOCAL = 64  # interior cells per node
STEPS = 400
ALPHA = 0.25


def launches(backend: str, steps: int = STEPS) -> Dict[str, int]:
    """GAScore launches of one run: two blocking puts a step, each three
    transfers (payload, offset, arrival flag), one ``ring_shift`` each on
    a backend with a "gascore" member; none on "xla"."""
    return {"ring_shift": 6 * steps} if "gascore" in backend else {}


def dense_rod(steps: int = STEPS) -> np.ndarray:
    """The single-device reference: the whole rod, zero ends."""
    rod = np.zeros(N_NODES * LOCAL, np.float32)
    rod[LOCAL // 2] = 100.0
    for _ in range(steps):
        padded = np.pad(rod, 1)  # zero ends
        rod = rod + ALPHA * (padded[:-2] - 2 * rod + padded[2:])
    return rod


def jacobi(node, seg, steps: int = STEPS):
    """The node program: ``steps`` halo exchanges and relaxations; returns
    the final segment and the interior's heat after every step."""
    first = node.my_id == 0
    last = node.my_id == node.n_nodes - 1
    heat = []
    for _ in range(steps):
        u = node.local(seg)
        # halo exchange: one-sided puts of boundary cells into neighbors
        seg = node.put(seg, u[1:2], to=gasnet.Shift(-1), index=LOCAL + 1)
        seg = node.put(seg, u[LOCAL:LOCAL + 1], to=gasnet.Shift(1), index=0)
        u = node.local(seg)
        # physical boundary: the rod ends see zero ghosts (the ring wraps,
        # so the end nodes must overwrite the wrapped-around halo)
        lo = torch.where(first, torch.zeros_like(u[:1]), u[:1])
        hi = torch.where(last, torch.zeros_like(u[-1:]), u[-1:])
        interior = u[1:-1]
        new = interior + ALPHA * (torch.cat([lo, u[1:-2]]) - 2 * interior
                                  + torch.cat([u[2:-1], hi]))
        seg = gasnet.Node._restore(seg, torch.cat([lo, new, hi]))
        heat.append(new.sum())
    return seg, torch.stack(heat)[None]


def run(backend: str = "xla", device=None, verbose: bool = True,
        steps: int = STEPS) -> Dict[str, torch.Tensor]:
    """Run the rod on ``backend``; check it against :func:`dense_rod`
    (atol 1e-4).  Returns the final segment ``(N_NODES, LOCAL + 2)`` and
    each node's heat per step ``(N_NODES, steps)``."""
    ctx = gasnet.Context(N_NODES, node_axis="node", backend=backend,
                         device=device)
    # segment layout per node: [ghost_left | interior(LOCAL) | ghost_right]
    aspace = ctx.address_space()
    aspace.register("rod", (LOCAL + 2,), torch.float32)
    # initial condition: a hot spike in node 0's strip, fixed 0 boundaries
    init = torch.zeros((N_NODES, LOCAL + 2), dtype=torch.float32)
    init[0, 1 + LOCAL // 2] = 100.0
    seg = aspace.alloc_from("rod", init.to(ctx.device))
    seg, heat = ctx.spmd(lambda node, s: jacobi(node, s, steps), seg,
                         out_specs=(P("node"), P("node")))
    got = seg[:, 1:-1].reshape(-1).cpu().numpy()
    np.testing.assert_allclose(got, dense_rod(steps), atol=1e-4)
    if verbose:
        print(f"Jacobi rod after {steps} steps: max={got.max():.4f}, "
              f"total heat={got.sum():.4f}")
        print("distributed PGAS result matches the dense reference — OK")
    return {"seg": seg, "heat": heat}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    run(args.backend, args.device)


if __name__ == "__main__":
    main()
