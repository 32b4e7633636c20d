"""The port's device-time profiler against the JAX reference's, on the CPU.

``obs/profile.py``'s records (``measured="wall"`` on the CPU), their tags,
the tracer mirror and the round-robin order against the reference's
``DeviceProfiler`` on the same calls; ``profile_epilogue`` records as fit
points of ``sched.EngineCost``; ``kernels.ops.profiling_targets`` against
the reference's (names, tags, shapes); and ``PagedServer.profile_decode``:
the served tokens are the reference's ``PagedServer``'s with and without
profiling between steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models.build import build_model as j_build
from repro.obs import profile as jprofile
from repro.obs import trace as jtrace
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.configs.registry import SMOKE
from repro_torch.core import sched
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.obs import DeviceProfiler, device_events_available, measure
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.ctx import RunCtx


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small ops; with one intra-op thread they do
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both():
    return jprofile.DeviceProfiler(), DeviceProfiler(device="cpu")


def test_cpu_samples_are_wall_clocked_like_the_reference():
    assert not device_events_available("cpu")
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    jp, tp = _both()
    jus = jp.profile("matmul", lambda: jnp.asarray(x) @ jnp.asarray(x),
                     iters=3, warmup=1, bytes=x.nbytes, impl="ref")
    tus = tp.profile("matmul", lambda: torch.from_numpy(x) @ torch.from_numpy(x),
                     iters=3, warmup=1, bytes=x.nbytes, impl="ref")
    assert jus > 0 and tus > 0
    (jr,), (tr,) = jp.records, tp.records
    assert jr.keys() == tr.keys()
    assert tr["measured"] == jr["measured"] == "wall"
    assert tr["name"] == "matmul" and tr["bytes"] == x.nbytes
    assert tr["dur_us"] == round(tus, 3)
    best, clock = measure(lambda: None, iters=2, warmup=0, device="cpu")
    assert clock == "wall" and best >= 0
    assert tp.spans("matmul") == [tr] and tp.spans("other") == []


def test_records_mirror_onto_the_active_tracer():
    jtr, ttr = jtrace.enable(jtrace.Tracer()), obs_trace.enable()
    try:
        jp, tp = _both()
        jp.profile("k", lambda: jnp.zeros(4), iters=1, warmup=0, bytes=16)
        tp.profile("k", lambda: torch.zeros(4), iters=1, warmup=0, bytes=16)
    finally:
        jtrace.disable()
        obs_trace.disable()
    (jev,), (tev,) = list(jtr.spans(cat="profile")), list(ttr.spans(
        cat="profile"))
    assert tev.kind == jev.kind == "instant" and tev.name == jev.name == "k"
    assert set(tev.args) == set(jev.args) == {"dur_us", "measured", "bytes"}
    # an explicit tracer takes the records when none is active
    own = obs_trace.Tracer()
    DeviceProfiler(tracer=own, device="cpu").profile("m", lambda: None,
                                                     iters=1, warmup=0)
    assert [e.name for e in own.spans(cat="profile")] == ["m"]


def test_profile_many_interleaves_round_robin_like_the_reference():
    def order(prof, mk):
        calls = []
        targets = [(name, mk(calls, name), {"tag": name}) for name in "abc"]
        best = prof.profile_many(targets, rounds=3, warmup=2)
        return calls, best, prof.records

    jcalls, jbest, jrecs = order(
        jprofile.DeviceProfiler(),
        lambda calls, n: (lambda: calls.append(n) or jnp.zeros(1)))
    tcalls, tbest, trecs = order(
        DeviceProfiler(device="cpu"),
        lambda calls, n: (lambda: calls.append(n) or torch.zeros(1)))
    assert tcalls == jcalls == list("aabbcc") + list("abc") * 3
    assert set(tbest) == set(jbest) == set("abc")
    assert [(r["name"], r["tag"], r["measured"]) for r in trecs] == [
        (r["name"], r["tag"], r["measured"]) for r in jrecs]


def test_epilogue_records_are_fit_points():
    """profile_epilogue's records carry ``bytes``: they feed
    ``fit_gamma_from_trace`` and ``fit_from_trace(epilogue_spans=...)``."""
    tp = DeviceProfiler(device="cpu")
    sizes = [1 << 12, 1 << 16, 1 << 20]

    def make(nbytes):
        buf = torch.zeros(nbytes // 4)
        return lambda: buf.add_(1.0)

    epi = tp.profile_epilogue(make, sizes, name="epilogue_install", iters=3,
                              warmup=1)
    assert [r["bytes"] for r in epi] == sizes
    assert all(r["measured"] == "wall" and r["dur_us"] > 0 for r in epi)
    assert tp.spans("epilogue_install") == epi
    gamma = sched.EngineCost.fit_gamma_from_trace(epi)
    assert gamma >= 0
    transfers = [{"bytes": b, "dur_us": 10.0 + b / 1024.0} for b in sizes]
    fit = sched.EngineCost.fit_from_trace(transfers, epilogue_spans=epi)
    # the epilogue's share of the measured 1 us/KiB slope becomes gamma
    assert fit.gamma_us_per_kib == pytest.approx(min(gamma, 1.0))
    assert fit.beta_us_per_kib + fit.gamma_us_per_kib == pytest.approx(1.0)
    assert fit.alpha_us == pytest.approx(10.0, rel=1e-6)


def test_profiling_targets_match_the_reference():
    jt = jops.profiling_targets(interpret=True)
    tt = ops.profiling_targets(device="cpu")
    # the kernel target exists only on a CUDA device; the plain one is the
    # reference's oracle target under its own name and tags
    assert [t[0] for t in jt] == ["paged_attention_pallas",
                                  "paged_attention_ref"]
    assert [t[0] for t in tt] == ["paged_attention_ref"]
    assert tt[0][2] == jt[1][2]
    want = jax.eval_shape(jt[1][1])
    got = tt[0][1]()
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    # inputs are made once and seeded: the same call gives the same bits
    assert torch.equal(got, tt[0][1]()) and torch.equal(
        got, ops.profiling_targets(device="cpu")[0][1]())
    wide = ops.profiling_targets(device="cpu", batch=2, heads=8, head_dim=32)
    assert tuple(wide[0][1]().shape) == (2, 8, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.profiling_targets()
    names = DeviceProfiler(device="cpu").profile_many(tt, rounds=2, warmup=1)
    assert set(names) == {"paged_attention_ref"}


@pytest.fixture(scope="module")
def models():
    cfg = J_SMOKE["qwen3-4b"]
    jm = j_build(cfg)
    jctx = JCtx(mesh=None, remat="none")
    jparams = jax.jit(lambda k: jm.init(jctx, k)[0])(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jm, jctx, jparams), (build_model(SMOKE["qwen3-4b"]), RunCtx(),
                                 tparams)


def _burst(mod, n=4):
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, size=16).tolist()
    reqs = [mod.Request(rid=0, prompt=shared + [5], max_new=6),
            mod.Request(rid=1, prompt=shared + [9, 11], max_new=5)]
    for rid in range(2, n):
        reqs.append(mod.Request(
            rid=rid,
            prompt=rng.integers(0, 512, size=int(rng.integers(6, 18))).tolist(),
            max_new=int(rng.integers(6, 10))))
    return reqs


def _serve(server, reqs, prof=None, every=2):
    for r in reqs:
        server.submit(r)
    ticks, timed = 0, []
    while server.queue or any(r is not None for r in server.active):
        server.step()
        ticks += 1
        if prof is not None and ticks % every == 0:
            timed.append(server.profile_decode(prof, iters=2, warmup=1))
    return {r.rid: r.out for r in server.finished}, timed


def test_profile_decode_leaves_tokens_unchanged(models):
    (jm, jctx, jparams), (tm, ctx, tparams) = models
    want, _ = _serve(jserve.PagedServer(jm, jctx, jparams, 3, 32,
                                        page_tokens=8), _burst(jserve))
    plain, _ = _serve(serve.PagedServer(tm, ctx, tparams, 3, 32,
                                        device="cpu", page_tokens=8),
                      _burst(serve))
    prof = DeviceProfiler(device="cpu")
    server = serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                               page_tokens=8)
    got, timed = _serve(server, _burst(serve), prof=prof)
    assert plain == want
    assert got == want
    assert timed and all(t is not None and t > 0 for t in timed)
    recs = prof.spans("paged_decode_step")
    assert len(recs) == len(timed)
    assert all(r["measured"] == "wall" and r["live"] >= 1
               and r["table_width"] % 4 == 0 for r in recs)
    # re-executions are not decode steps
    steps = serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                              page_tokens=8)
    _serve(steps, _burst(serve))
    assert server.paged_decode_steps == steps.paged_decode_steps
    # no live row: nothing to time
    assert server.profile_decode(prof) is None
