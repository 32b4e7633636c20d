"""AdamW with a warmup-cosine schedule: the port of ``repro.optim.adamw``.

The same f32 arithmetic in the same order as the reference's
``apply_updates``: bias correction, ``eps`` outside the square root,
decoupled weight decay on the f32 parameter, and the cast back to the
parameter's and the state's dtypes.  Where JAX donates the old buffers,
the port updates parameters and moments IN PLACE under ``torch.no_grad()``
(and clips the gradients in place), and runs the element-wise update over
chunks of a leaf's leading axis, so that a leaf's f32 temporaries stay near
``CHUNK_ELEMS`` elements instead of the whole stacked leaf; element-wise
arithmetic gives the same bits either way.  No ``state_specs``: the port
runs on one device, without a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from repro_torch.compat import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_state", "apply_updates", "warmup_cosine",
           "global_norm", "clip_by_global_norm"]

CHUNK_ELEMS = 1 << 26  # elements per slice of the in-place update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32  # bf16 halves optimizer memory
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def warmup_cosine(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup, warm, cos)

    return fn


def init_state(params: Any, cfg: AdamWConfig) -> Any:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=dev)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _chunks(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of same-shaped tensors over slices of their leading
    axis, each about ``CHUNK_ELEMS`` elements (a whole small leaf is one)."""
    t0 = ts[0]
    if t0.dim() == 0 or t0.numel() <= CHUNK_ELEMS:
        yield ts
        return
    rows = max(1, CHUNK_ELEMS // max(t0[0].numel(), 1))
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in ts)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    parts = [c.float().square().sum() for (c,) in _chunks(x)]
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum()


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(torch.stack([_sq_sum(x) for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` IN PLACE so their global norm is at most
    ``max_norm``; returns them and the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        for (c,) in _chunks(g):
            c.copy_(c.float() * scale)
    return grads, norm


@torch.no_grad()
def apply_updates(
    params: Any, grads: Any, state: Any, cfg: AdamWConfig
) -> Tuple[Any, Any, dict]:
    """One AdamW step.  ``params``, the moments in ``state`` and ``grads``
    (when clipped) are updated in place; returns ``(params, state,
    metrics)`` with the metrics as 0-dim f32 tensors."""
    step = state["step"] + 1
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    lr = cfg.schedule(step) if cfg.schedule else cfg.lr
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        for pc, gc, mc, vc in _chunks(p, g, m, v):
            gf = gc.float()
            mf = b1 * mc.float() + (1 - b1) * gf
            vf = b2 * vc.float() + (1 - b2) * gf * gf
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if cfg.weight_decay:
                delta = delta + cfg.weight_decay * pc.float()
            newp = pc.float() - lr * delta
            pc.copy_(newp)  # copy_ casts back to each dtype
            mc.copy_(mf)
            vc.copy_(vf)
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32, device=step.device)}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
