"""Plain PyTorch pieces the reference models share, in float32.

Nothing here imports the program.  TF32 is switched off by
:func:`strict_f32` before the reference runs on the card, so a float32
product is a float32 product.

The control (``quant=True``) is the same reference computed in float8
e4m3 where the program computes in bfloat16, the precision below the
configurations' that a later change would be tempted to take: both
operands of every weight product, and the residual stream each layer
hands on (:func:`stream`), rounded with a per-tensor scale.  The
rounding passes the gradient straight through, so the backward's
products read the rounded operands.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32, with a straight-through gradient."""
    with torch.no_grad():
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(F32) / scale
    return x + (q - x).detach()


def stream(x: torch.Tensor, quant: bool) -> torch.Tensor:
    """The residual stream as a layer hands it on (float8 in the
    control)."""
    return fp8_round(x) if quant else x


def mm(x: torch.Tensor, w: torch.Tensor, quant: bool) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` and the first of ``w``."""
    if quant:
        x, w = fp8_round(x), fp8_round(w)
    return torch.tensordot(x, w, dims=([x.dim() - 1], [0]))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on the two halves of the head dim: x (B, S, H,
    Dh), positions (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[:, None] * freqs  # (S, half)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


# --------------------------------------------------------------------------- #
# parameter trees: nested dicts and lists addressed by path tuples
# --------------------------------------------------------------------------- #
def get(tree: Any, path: Sequence) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def build_tree(items: Sequence[Tuple[Tuple, Any]]) -> Any:
    """A nested dict / list tree from ``(path, leaf)`` pairs; an int key
    makes a list."""
    root: Dict = {}
    for path, leaf in items:
        node = root
        for k, nxt in zip(path[:-1], path[1:]):
            if k not in node:
                node[k] = {}
            node = node[k]
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def leaves_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` with dict keys sorted and lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def unbind_layers(seg: Any) -> List[Any]:
    """A tree of leaves stacked on a leading layer axis as one tree of
    views a layer, by one ``unbind`` a leaf (whose backward stacks the
    layers' gradients once)."""
    named = list(leaves_with_path(seg))
    parts = [t.unbind(0) for _, t in named]
    return [build_tree([(p, part[i]) for (p, _), part in zip(named, parts)])
            for i in range(len(parts[0]))]


def path_name(path: Sequence) -> str:
    return "/".join(str(k) for k in path)


# --------------------------------------------------------------------------- #
# loss and optimizer
# --------------------------------------------------------------------------- #
def ce_loss(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor, quant: bool, chunk: int = 1024) -> torch.Tensor:
    """Mask-weighted mean cross-entropy of ``h @ head`` (h already
    normed), ``chunk`` positions at a time, each chunk recomputed in the
    backward so that its logits are never all kept."""
    from torch.utils.checkpoint import checkpoint

    B, S, _ = h.shape

    def part(hc, tc, mc):
        logits = mm(hc, head, quant)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tc[..., None].long())[..., 0]
        return ((lse - tgt) * mc).sum()

    tot = torch.zeros((), dtype=F32, device=h.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        tot = tot + checkpoint(part, h[:, sl], targets[:, sl], mask[:, sl],
                               use_reentrant=False)
    return tot / torch.clamp(mask.sum(), min=1.0)


class AdamW:
    """AdamW in float32 over a list of leaves: bias correction, ``eps``
    outside the square root, decoupled weight decay, clipping by the
    global norm, a constant learning rate.  The moments wait on the
    host, a block of rows at a time on the leaves' device while it is
    updated, so that the card holds only the leaves, their summed
    gradients and one micro-batch's activations."""

    def __init__(self, leaves: List[torch.Tensor], opt: Dict):
        self.opt = opt
        self.step_no = 0
        self.m = [torch.zeros(p.shape, dtype=F32) for p in leaves]
        self.v = [torch.zeros(p.shape, dtype=F32) for p in leaves]

    @torch.no_grad()
    def apply(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]
              ) -> List[float]:
        """Update ``leaves`` in place; returns each leaf's gradient norm
        as the optimizer gets it (after clipping)."""
        o = self.opt
        self.step_no += 1
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = o.get("grad_clip") or 0.0
        scale = (torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
                 if clip else torch.ones((), device=norm.device))
        b1, b2, lr = o["b1"], o["b2"], o["lr"]
        bc1, bc2 = 1 - b1 ** self.step_no, 1 - b2 ** self.step_no
        got = []
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            g.mul_(scale)
            got.append(float(torch.linalg.vector_norm(g)))
            for pc, gc, mh, vh in zip(_rows(p), _rows(g), _rows(m), _rows(v)):
                mc, vc = mh.to(pc.device), vh.to(pc.device)
                mc.mul_(b1).add_(gc, alpha=1 - b1)
                vc.mul_(b2).add_(gc * gc, alpha=1 - b2)
                delta = (mc / bc1) / (torch.sqrt(vc / bc2) + o["eps"])
                if o.get("weight_decay"):
                    delta = delta + o["weight_decay"] * pc
                pc.sub_(lr * delta)
                mh.copy_(mc)
                vh.copy_(vc)
        return got


@torch.no_grad()
def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """``||a - b||`` in float32, a slice of the leading axis at a time."""
    total = torch.zeros((), dtype=F32, device=a.device)
    for x, y in zip(_rows(a, 1 << 24), _rows(b, 1 << 24)):
        total += torch.sum(torch.square(x.float() - y.float()))
    return float(torch.sqrt(total))


def _rows(t: torch.Tensor, elems: int = 1 << 26) -> List[torch.Tensor]:
    """Views of ``t`` over slices of its leading axis of about ``elems``
    elements each, so that an update's temporaries stay small."""
    if t.dim() == 0 or t.numel() <= elems:
        return [t]
    rows = max(1, elems // max(t[0].numel(), 1))
    return [t[i:i + rows] for i in range(0, t.shape[0], rows)]
