"""Driver of a serving cell: a closed loop of clients against the
program's ``PagedServer``.

Each client sends its next request when its last one completes, with no
think time; a request is timed from that moment, its due time.  The
loop starts in set-up, and the window opens once ``ramp_requests`` have
completed; it lasts ``--seconds``, then the server runs on, taking no new
request, until every request sent has finished (or ``drain_seconds``
pass: those that did not finish count as failed).  The window's requests
are those due in it; its rate counts the prompt and generated tokens of
the requests completed in it.
Once the program is freed, the plain reference runs over a sample of
the finished requests, drawn from the seed with the longest among them:
each prompt with its served tokens, and the widest gap by which a served
token's logit lies below the reference's best at its position.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from portbench import check, program, weights, work
from portbench.reference import common as C
from portbench.stats import percentile
from portbench.trace import DeviceTrace, Spans, reduce
from portbench.traffic import serve_closed as traffic


class _Seen:
    """The server's per-step hook: the live rows' positions of each decode
    step while recording, and the ``token`` fault's altered argmax."""

    def __init__(self, fault: str = ""):
        self.recording = False
        self.steps: List[List[int]] = []
        self.fault = fault
        self.n = 0

    def __call__(self, server, live, logits) -> None:
        if self.recording:
            self.steps.append([int(server.positions[i]) for i in live])
        self.n += 1
        if self.fault == "token" and self.n % 7 == 0:
            for i in live:
                logits[i] = np.roll(logits[i], 1)  # its argmax moves one id up


def program_run(r, specs, stream) -> Dict[str, Any]:
    import torch
    from repro_torch.launch.serve import PagedServer, Request
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    mix, m = r.mix, r.cfg["model"]
    model = build_model(program.arch_config(r.cfg))
    ctx = RunCtx()
    errs = weights.check_layout(specs, model.abstract_init(ctx)[0])
    if errs:
        raise RuntimeError("the program's parameters differ from the "
                           "benchmark's layout: " + "; ".join(errs))
    params = weights.make_tree(specs, r.seed, r.device)
    server = PagedServer(model, ctx, params, batch_size=mix["batch"],
                         cache_len=mix["cache_len"], eos_id=mix["eos_id"],
                         device=r.device, page_tokens=mix["page_tokens"])
    seen = _Seen(r.fault)
    server.on_step = seen

    # warm-up: the longest prompt and a few others, a few tokens each
    rng = np.random.default_rng((r.seed, 1))
    for i, plen in enumerate(mix["warmup_prompts"]):
        ids = rng.integers(0, m["vocab"], size=plen).tolist()
        server.submit(Request(rid=-1 - i, prompt=ids, max_new=mix["warmup_new"]))
    server.run_until_drained()

    # the loop runs from set-up on: the window opens once ``ramp``
    # requests have completed, so that it measures the loop's steady state
    spans = Spans()
    tr = DeviceTrace(r.device) if r.trace else None
    trace_s = mix.get("trace_seconds") or r.seconds
    sent: List[Dict[str, Any]] = []
    nxt = stream
    done_seen = len(server.finished)

    def send(due: float) -> None:
        ids, max_new = next(nxt)
        req = Request(rid=len(sent), prompt=ids.tolist(), max_new=max_new)
        sent.append({"req": req, "due": due, "plen": len(ids)})
        server.submit(req)

    start = time.monotonic()
    for _ in range(mix["clients"]):
        send(start)
    ticks: List[Dict[str, Any]] = []
    traced: Dict[str, Any] = {"prefill_flops": 0, "ticks": 0}
    waiting = list(sent)
    t0 = t_end = setup_peak = None
    completed = 0
    while True:
        ts = time.monotonic()
        with spans.span("server tick"):
            live = server.step()
        te = time.monotonic()
        admitted = [s for s in waiting if s["req"].t_first]
        waiting = [s for s in waiting if not s["req"].t_first]
        if t0 is not None:
            ticks.append({"s": te - ts, "admitted": len(admitted), "live": live})
        if seen.recording:
            traced["prefill_flops"] += sum(work.prefill_flops(m, s["plen"])
                                           for s in admitted)
            traced["ticks"] += 1
        for req in server.finished[done_seen:]:
            completed += 1
            if t_end is None:
                send(req.t_done)
                waiting.append(sent[-1])
        done_seen = len(server.finished)
        if tr and seen.recording and te - t0 >= trace_s:
            tr.stop()
            seen.recording = False
        if t0 is None:
            if completed >= mix["ramp_requests"]:
                setup_peak = torch.cuda.max_memory_allocated() if r.cuda else None
                if tr:
                    tr.start()
                    seen.recording = True
                t0 = time.monotonic()
            continue
        if t_end is None and te - t0 >= r.seconds:
            t_end = te
        if t_end is not None and (
                all(s["req"].t_done for s in sent)
                or te - t_end >= mix["drain_seconds"]):
            break
    if tr and seen.recording:
        tr.stop()
        seen.recording = False
    peak = torch.cuda.max_memory_allocated() if r.cuda else None
    del server, params, model
    program.free()
    return {"sent": sent, "t0": t0, "t_end": t_end, "ticks": ticks,
            "spans": spans, "trace": tr, "traced": traced,
            "decode_positions": seen.steps, "peak_bytes": peak,
            "setup_peak_bytes": setup_peak}


def sample(sent: List[Dict], k: int, seed: int) -> List[Dict]:
    """``k`` finished requests drawn from the seed, the longest among
    them."""
    done = [s for s in sent if s["req"].t_done and s["req"].out]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: done[i]["plen"] + len(done[i]["req"].out))
    rest = [i for i in range(len(done)) if i != longest]
    pick = np.random.default_rng((seed, 2)).permutation(len(rest))[:k - 1]
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def gaps(r, specs, chosen: List[Dict], control: bool = False) -> List[float]:
    """Per request, the widest gap below the reference's best logit of the
    served tokens (``control``: of the tokens the float8 reference puts
    first at the same positions)."""
    import torch
    from portbench import reference

    C.strict_f32()
    m = r.cfg["model"]
    params = C.build_tree([(s[0], weights.make_leaf(s, r.seed, r.device).float())
                           for s in specs])
    out = []
    for s in chosen:
        req = s["req"]
        toks = torch.as_tensor(req.prompt + req.out[:-1], device=r.device)
        pos = range(s["plen"] - 1, s["plen"] - 1 + len(req.out))
        ref = reference.logits_at(m, params, toks, pos)
        if control:
            served = reference.logits_at(m, params, toks, pos, quant=True).argmax(-1)
        else:
            served = torch.as_tensor(req.out, device=r.device)
        got = ref.gather(-1, served[:, None].long())[:, 0]
        out.append(float((ref.max(-1).values - got).max()))
    del params
    program.free()
    return out


def run(r) -> Dict[str, Any]:
    from portbench import reference

    mix, m = r.mix, r.cfg["model"]
    specs = reference.family(m["family"]).layout(m)
    stream = traffic.requests(mix, m["vocab"], r.seed)
    p = program_run(r, specs, stream)
    t = time.monotonic()
    chosen = sample([s for s in p["sent"] if s["due"] >= p["t0"]],
                    mix["sample_requests"], r.seed)
    g = gaps(r, specs, chosen)
    ref_s = time.monotonic() - t
    numbers = {"max_gap": {"value": max(g) if g else float("nan"),
                           "at": f"{len(chosen)} requests, "
                                 f"{sum(len(s['req'].out) for s in chosen)} tokens"}}

    t0, t_end = p["t0"], p["t_end"]
    sent = [s for s in p["sent"] if t0 <= s["due"] < t_end]
    ttft, failed = [], 0
    for s in sent:
        req = s["req"]
        if req.t_first and req.t_done:
            ttft.append(req.t_first - s["due"])
        else:
            failed += 1
            ttft.append(float("inf"))
    done = [s for s in p["sent"] if s["req"].t_done and t0 <= s["req"].t_done <= t_end]
    tokens = sum(s["plen"] + len(s["req"].out) for s in done)
    e2e = {"serve_tok_s": tokens / (t_end - t0),
           "ttft_p95_s": percentile(ttft, 95),
           "setup_s": t0 - r.t_start}
    obs = None
    if p["trace"] is not None:
        tr = p["trace"]
        red = reduce(tr.events, r.categories, tr.host_t0, p["spans"],
                     "between ticks (harness)")
        dec = sum(work.decode_flops(m, q) for step in p["decode_positions"]
                  for q in step)
        obs = {"model": m, "mix": mix, "trace": red, "window_s": tr.window_s,
               "ticks": p["ticks"], "page_tokens": mix["page_tokens"],
               "paged_lengths": [[q + 1 for q in step]
                                 for step in p["decode_positions"]],
               "flops": p["traced"]["prefill_flops"] + dec}
    peaks = [x for x in (p["peak_bytes"], p["setup_peak_bytes"]) if x is not None]
    return {"numbers": numbers, "attempted": len(sent), "failed": failed,
            "e2e": e2e, "obs": obs, "memory_peak_bytes": max(peaks) if peaks else None,
            "info": {"requests_done_in_window": len(done),
                     "sent": len(sent), "ticks": len(p["ticks"]),
                     "gaps": g, "reference_s": ref_s,
                     "ttft_p50_s": percentile(ttft, 50),
                     "window_s": t_end - t0}}
