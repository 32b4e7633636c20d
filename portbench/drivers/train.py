"""Driver of a training cell: the program's ``Trainer`` step (the mix's
``ga_steps`` micro-batches, then AdamW) on a seeded token stream, steps
back to back through the window.

Set-up builds one trainer (model, step and optimizer state) from the
seed, drives it through the mix's ``check_steps`` first steps on
batches that all differ (which also warms every shape the window
uses), reads what the check needs from its state, and hands the same
objects to the window.  Once the window has closed and the program's
state is freed, the plain reference follows the same first steps from
the same weights and batches.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List

from portbench import check, program, weights, work
from portbench.reference import common as C
from portbench.trace import DeviceTrace, Spans, reduce
from portbench.traffic import train as traffic


def _device_batches(host: List[Dict], device) -> List[Dict]:
    import torch

    return [{k: torch.from_numpy(v.copy()).to(device) for k, v in b.items()}
            for b in host]


def _half(batch: Dict, ga: int) -> Dict:
    """The fault ``half_batch``: half of each micro-batch's rows (of its
    positions, for one row) left out of the mean."""
    mask = batch["mask"].clone()
    mb = mask.view(ga, -1, mask.shape[-1])
    if mb.shape[1] > 1:
        mb[:, mb.shape[1] // 2:] = 0
    else:
        mb[:, :, mb.shape[2] // 2:] = 0
    return dict(batch, mask=mask)


def keeps_first(r) -> bool:
    """Whether the cell compares the first gradients leaf by leaf
    (``grad_diff``), so that both sides keep them on the host."""
    return "grad_diff" in r.limits


def program_readings(r, specs, host_batches, keep_first: bool = False
                     ) -> Dict[str, Any]:
    """Set-up, the check steps and the window.  Returns what the check,
    the metrics and the result line need (with ``keep_first``, the first
    gradient as AdamW got it, on the host); the program's state is freed
    before it returns."""
    import torch
    from repro_torch.models.build import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel.ctx import RunCtx
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    mix, m = r.mix, r.cfg["model"]
    model = build_model(program.arch_config(r.cfg))
    ctx = RunCtx(remat=mix["remat"])
    errs = weights.check_layout(specs, model.abstract_init(ctx)[0])
    if errs:
        raise RuntimeError("the program's parameters differ from the "
                           "benchmark's layout: " + "; ".join(errs))
    o = mix["optimizer"]
    opt = adamw.AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                            weight_decay=o["weight_decay"],
                            grad_clip=o["grad_clip"])
    if r.fault == "stale":
        adamw_apply = lambda p, g, s, c: (p, s, {"grad_norm": torch.zeros(()),
                                                 "lr": torch.zeros(())})
        adamw.apply_updates, saved = adamw_apply, adamw.apply_updates
    trainer = Trainer(model, ctx, opt, TrainerConfig(
        steps=1 << 30, ga_steps=mix["ga_steps"], ckpt_every=0))
    params = weights.make_tree(specs, r.seed, r.device)
    for _, t in C.leaves_with_path(params):
        t.requires_grad_(True)
    opt_state = adamw.init_state(params, opt)
    step = trainer.make_train_step()
    batches = _device_batches(host_batches, r.device)
    feed = ([_half(b, mix["ga_steps"]) for b in batches]
            if r.fault == "half_batch" else batches)
    n_check = mix["check_steps"]

    check_s = 0.0
    losses, grads, kept = [], {}, {}
    for i in range(n_check):
        params, opt_state, met = step(params, opt_state, feed[i])
        losses.append(float(met["loss"]))
        if i == 0:  # m = (1 - b1) g after one step
            t = time.monotonic()
            for p, v in C.leaves_with_path(opt_state["m"]):
                grads[C.path_name(p)] = float(torch.linalg.vector_norm(v)) / (1 - o["b1"])
                if keep_first:
                    kept[C.path_name(p)] = (v.float() / (1 - o["b1"])).to("cpu")
            check_s += time.monotonic() - t
    t = time.monotonic()
    first = weights.remaker(specs, r.seed, r.device)
    change = {C.path_name(p): C.diff_norm(v.detach(), first(C.path_name(p)))
              for p, v in C.leaves_with_path(params)}
    check_s += time.monotonic() - t

    window = feed[n_check:]
    spans = Spans()
    tr = DeviceTrace(r.device) if r.trace else None
    setup_peak = torch.cuda.max_memory_allocated() if r.cuda else None
    if r.cuda:
        torch.cuda.reset_peak_memory_stats()
    if tr:
        tr.start()
    t0 = time.monotonic()
    steps = failed = 0
    while True:
        with spans.span("train_step"):
            params, opt_state, met = step(params, opt_state,
                                          window[steps % len(window)])
            loss = float(met["loss"])  # the host reads each step's loss
        steps += 1
        failed += not math.isfinite(loss)
        if time.monotonic() - t0 >= r.seconds:
            break
    if tr:
        tr.stop()
    t_end = time.monotonic()
    peak = torch.cuda.max_memory_allocated() if r.cuda else None
    if r.fault == "stale":
        adamw.apply_updates = saved
    del params, opt_state, step, trainer, model, batches, feed, window
    program.free()
    return {"losses": losses, "grad_norms": grads, "change_norms": change,
            "first_grads": kept,
            "t0": t0, "t_end": t_end, "steps": steps, "failed": failed,
            "check_s": check_s, "spans": spans, "trace": tr,
            "peak_bytes": peak, "setup_peak_bytes": setup_peak}


def reference_readings(r, specs, host_batches, quant: bool = False,
                       keep_first: bool = False) -> Dict:
    """The plain reference's first steps, float32 (``quant``: the control
    in float8), from the same weights and batches."""
    import torch
    from portbench import reference

    C.strict_f32()
    params = C.build_tree([(s[0], weights.make_leaf(s, r.seed, r.device).float())
                           for s in specs])
    batches = _device_batches(host_batches[:r.mix["check_steps"]], r.device)
    out = reference.train_readings(
        r.cfg["model"], params, batches, r.mix["optimizer"],
        weights.remaker(specs, r.seed, r.device), ga=r.mix["ga_steps"],
        quant=quant, keep_first=keep_first)
    del params, batches
    program.free()
    return out


def run(r) -> Dict[str, Any]:
    from portbench import reference

    mix, m = r.mix, r.cfg["model"]
    specs = reference.family(m["family"]).layout(m)
    host = traffic.batches(mix, m["vocab"], r.seed)
    p = program_readings(r, specs, host, keeps_first(r))
    t = time.monotonic()
    ref = reference_readings(r, specs, host, keep_first=keeps_first(r))
    numbers = check.training_numbers(p, ref, r.device)
    ref_s = time.monotonic() - t

    window_s = p["t_end"] - p["t0"]
    rows = mix["ga_steps"] * mix["batch"]  # sequences an optimizer step
    tokens = rows * mix["seq_len"]
    e2e = {"train_tok_s": p["steps"] * tokens / window_s,
           "setup_s": p["t0"] - r.t_start - p["check_s"]}
    obs = None
    if p["trace"] is not None:
        tr = p["trace"]
        red = reduce(tr.events, r.categories, tr.host_t0, p["spans"],
                     "between steps (harness)")
        obs = {"model": m, "mix": mix, "trace": red, "window_s": tr.window_s,
               "steps": p["steps"],
               "flops": p["steps"] * work.train_step_flops(m, rows,
                                                           mix["seq_len"]),
               "peak_bytes": p["peak_bytes"]}
    peaks = [x for x in (p["peak_bytes"], p["setup_peak_bytes"]) if x is not None]
    return {"numbers": numbers, "attempted": p["steps"], "failed": p["failed"],
            "e2e": e2e, "obs": obs, "memory_peak_bytes": max(peaks) if peaks else None,
            "info": {"losses": p["losses"], "ref_losses": ref["losses"],
                     "not_compared": {k: v["value"] for k, v in numbers.items()
                                      if (r.limits.get(k) or {}).get("compared") is False},
                     "check_s": p["check_s"], "reference_s": ref_s,
                     "window_s": window_s, "steps": p["steps"]}}
