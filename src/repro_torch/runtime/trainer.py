"""Training loop of the port: step, async checkpoints, restart.

The port of ``repro.runtime.trainer`` on one device:

  make_train_step  — the loss, ``torch.autograd.grad`` over the parameter
                     leaves and AdamW, with optional microbatch gradient
                     accumulation (``ga_steps``) summing ``g / ga`` into
                     f32 zeros as the reference does.  Parameters and
                     optimizer state are updated in place where the
                     reference donates them.
  Trainer.run      — step loop with async snapshots every ``ckpt_every``.
  recover          — rebuild from the latest checkpoint; the deterministic
                     data stream resumes from the saved cursor, so the
                     token stream is that of an uninterrupted run.

PyTorch runs eagerly, so there is no jit and no mesh: the step is a plain
function, and the device is the one the generator given to :meth:`init`
lives on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.compat import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.build import Model
from repro_torch.optim import adamw
from repro_torch.parallel.ctx import RunCtx

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ga_steps: int = 1  # gradient-accumulation microbatches
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_last: int = 2


class Trainer:
    def __init__(
        self,
        model: Model,
        ctx: RunCtx,
        opt_cfg: adamw.AdamWConfig,
        tcfg: TrainerConfig,
    ):
        self.model = model
        self.ctx = ctx
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self._step_fn = None
        self._ckpt_handle: Optional[ckpt.AsyncHandle] = None

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> Tuple[Any, Any]:
        """Parameters drawn from ``generator`` on its device, as leaves
        that require grad, and zeroed AdamW state beside them."""
        params = self.model.init(self.ctx, generator, device=generator.device)
        params = tree_map(lambda t: t.requires_grad_(), params)
        return params, adamw.init_state(params, self.opt_cfg)

    # ------------------------------------------------------------------ #
    def make_train_step(self) -> Callable:
        model, ctx, opt_cfg = self.model, self.ctx, self.opt_cfg
        ga = self.tcfg.ga_steps

        def loss_and_grads(params, batch):
            leaves = tree_leaves(params)
            loss = model.train_loss(params, ctx, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), grads

        def step(params, opt_state, batch):
            if ga > 1:
                leaves = tree_leaves(params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in leaves]
                mbs = {k: v.reshape((ga, v.shape[0] // ga) + v.shape[1:])
                       for k, v in batch.items()}
                for i in range(ga):
                    l, g = loss_and_grads(params, {k: v[i] for k, v in mbs.items()})
                    loss = loss + l / ga
                    acc = [a + b / ga for a, b in zip(acc, g)]
                grads = acc
            else:
                loss, grads = loss_and_grads(params, batch)
            grads = tree_unflatten(params, list(grads))
            params, opt_state, metrics = adamw.apply_updates(
                params, grads, opt_state, opt_cfg
            )
            metrics["loss"] = loss
            return params, opt_state, metrics

        self._step_fn = step
        return step

    # ------------------------------------------------------------------ #
    def save(self, step: int, params, opt_state, extra: Dict) -> None:
        if not self.tcfg.ckpt_dir:
            return
        if self._ckpt_handle is not None:
            self._ckpt_handle.wait()  # one write in flight at a time
        self._ckpt_handle = ckpt.save(
            self.tcfg.ckpt_dir, step,
            {"params": params, "opt": opt_state},
            extra={"data_step": extra.get("data_step", step), **extra},
        )
        ckpt.cleanup(self.tcfg.ckpt_dir, self.tcfg.keep_last)

    def recover(self, generator: torch.Generator) -> Tuple[Any, Any, int, Dict]:
        """Rebuild from the latest checkpoint (or fresh when there is
        none); returns ``(params, opt_state, step, extra)``."""
        if not self.tcfg.ckpt_dir:
            raise ValueError("recover needs TrainerConfig.ckpt_dir")
        params, opt_state = self.init(generator)  # structure, dtypes, device
        step = ckpt.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0, {}
        with torch.no_grad():
            tree, extra = ckpt.restore(
                self.tcfg.ckpt_dir, step, {"params": params, "opt": opt_state}
            )
        params = tree_map(lambda t: t.requires_grad_(), tree["params"])
        return params, tree["opt"], step, extra

    # ------------------------------------------------------------------ #
    def run(
        self,
        params,
        opt_state,
        loader,
        start_step: int = 0,
        on_step: Optional[Callable[[int, Dict], None]] = None,
    ) -> Tuple[Any, Any, list]:
        step_fn = self._step_fn or self.make_train_step()
        history = []
        t_prev = time.monotonic()
        for step in range(start_step, self.tcfg.steps):
            batch = next(loader)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["step_time_s"] = time.monotonic() - t_prev
                history.append(m)
                if on_step:
                    on_step(step, m)
            t_prev = time.monotonic()
            if self.tcfg.ckpt_every and (step + 1) % self.tcfg.ckpt_every == 0:
                self.save(step + 1, params, opt_state, {"data_step": loader.step})
        if self._ckpt_handle is not None:
            self._ckpt_handle.wait()
        return params, opt_state, history
