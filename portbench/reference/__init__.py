"""The benchmark's plain reference: float32 PyTorch written from the layer
equations, one module per model family (``reference/<family>.py``, found
by the ``family`` of a configuration's ``model`` block).  It imports
nothing of the program and reads no tensor the program made: the
harness hands it the seeded weights and inputs it made itself.

Two readings:

- :func:`train_readings`: the first steps of training from the seed
  (losses, each leaf's first gradient norm as AdamW gets it, each leaf's
  change after the steps);
- :func:`logits_at`: the logits at chosen positions of one sequence,
  for the served tokens' gaps.

``quant=True`` gives the control (``common.fp8_round``).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Mapping, Sequence

import torch

from portbench.reference import common as C


def family(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def train_readings(m: Mapping, params, batches: Sequence[Dict[str, torch.Tensor]],
                   opt: Mapping, initial: Callable[[str], torch.Tensor],
                   ga: int = 1, quant: bool = False, keep_first: bool = False
                   ) -> Dict:
    """Run ``len(batches)`` AdamW steps from ``params`` (float32 leaves,
    updated in place), each on the mean gradient of its batch's ``ga``
    micro-batches (equal blocks of rows, each loss a mean over its own
    mask).  Returns the losses (each step's mean of its micro-batches'),
    each leaf's gradient norm at the first step after clipping, and each
    leaf's change norm after the last step against ``initial(path
    name)``, the leaf as it started (made again in its own dtype, so that
    no second copy of the model is kept), keyed by path name; with
    ``keep_first``, also that first clipped gradient, leaf by leaf on the
    host (``first_grads``)."""
    fam = family(m["family"])
    named = list(C.leaves_with_path(params))
    leaves = [t for _, t in named]
    names = [C.path_name(p) for p, _ in named]
    for t in leaves:
        t.requires_grad_(True)
    adam = C.AdamW([t.detach() for t in leaves], dict(opt))
    losses: List[float] = []
    first: List[float] = []
    for i, batch in enumerate(batches):
        loss = 0.0
        for mb in _micro_batches(batch, ga):
            h = fam.final_hidden(params, mb["inputs"], m, quant)
            part = C.ce_loss(h, fam.head(params, m), mb["targets"],
                             mb["mask"], quant)
            (part / ga).backward()  # summed into each leaf's .grad
            loss += float(part.detach()) / ga
            del h, part
        losses.append(loss)
        grads = [t.grad for t in leaves]
        got = adam.apply([t.detach() for t in leaves], grads)
        if i == 0:
            first = got
            if keep_first:
                kept = {n: g.to("cpu") for n, g in zip(names, grads)}
        for t in leaves:
            t.grad = None
        del grads
    change = {}
    with torch.no_grad():
        for n, t in zip(names, leaves):
            change[n] = C.diff_norm(t.detach(), initial(n))
    out = {"losses": losses, "grad_norms": dict(zip(names, first)),
           "change_norms": change}
    if keep_first:
        out["first_grads"] = kept
    return out


def _micro_batches(batch: Dict[str, torch.Tensor], ga: int
                   ) -> List[Dict[str, torch.Tensor]]:
    """``ga`` equal blocks of the batch's rows, in order."""
    return [{k: v.reshape((ga, v.shape[0] // ga) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(ga)]


@torch.no_grad()
def logits_at(m: Mapping, params, tokens: torch.Tensor, positions: Sequence[int],
              quant: bool = False) -> torch.Tensor:
    """Float32 logits (len(positions), V) of the causal forward over
    ``tokens`` (S,), read at ``positions``."""
    fam = family(m["family"])
    h = fam.final_hidden(params, tokens[None], m, quant)[0]
    idx = torch.as_tensor(list(positions), device=h.device)
    return C.mm(h[idx], fam.head(params, m), quant)
