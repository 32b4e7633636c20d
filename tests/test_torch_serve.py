"""The port's servers against the JAX reference's, same parameters.

qwen3-4b SMOKE in f32 on the CPU.  The port's ``PagedServer`` must give
token for token what the reference's ``PagedServer`` gives on the same
prompts, and what the port's dense ``Server`` gives; an oversubscribed
pool that preempts (swap and recompute) must not change a token.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.launch import serve as jserve
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.configs.registry import SMOKE
from repro_torch.launch import serve
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel.ctx import RunCtx
from repro_torch.serving import pool, tier


@pytest.fixture(scope="module")
def models():
    cfg = J_SMOKE["qwen3-4b"]
    jm = j_build(cfg)
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jm, jctx, jparams), (build_model(SMOKE["qwen3-4b"]), RunCtx(), tparams)


def _burst(mod, n=5):
    """Requests of mixed lengths, two sharing a 16-token prompt prefix."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, size=16).tolist()
    reqs = [
        mod.Request(rid=0, prompt=shared + [5], max_new=6),
        mod.Request(rid=1, prompt=shared + [9, 11], max_new=5),
    ]
    for rid in range(2, n):
        reqs.append(mod.Request(
            rid=rid,
            prompt=rng.integers(0, 512, size=int(rng.integers(6, 18))).tolist(),
            max_new=int(rng.integers(6, 12)),
        ))
    return reqs


def _serve(server, reqs, **kw):
    for r in reqs:
        server.submit(r)
    stats = server.run_until_drained(**kw)
    return {r.rid: r.out for r in server.finished}, stats


def test_paged_server_tokens_match_reference_and_dense(models):
    (jm, jctx, jparams), (tm, ctx, tparams) = models
    want, _ = _serve(
        jserve.PagedServer(jm, jctx, jparams, 3, 32, page_tokens=8),
        _burst(jserve),
    )
    got, stats = _serve(
        serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu", page_tokens=8),
        _burst(serve),
    )
    dense, _ = _serve(
        serve.Server(tm, ctx, tparams, 3, 32, device="cpu"), _burst(serve)
    )
    assert got == want
    assert got == dense
    assert stats["pool_prefix_hits"] >= 2  # rid 0/1 share two full pages
    assert stats["pool_n_free"] == stats["pool_n_pages"]


def test_oversubscribed_pool_preempts_without_changing_tokens(models):
    """Aggregate KV demand well above a 7-page pool: the scheduler
    preempts, pages swap to the host tier (or, priced for recompute, are
    dropped and replayed), every request resumes, and the tokens are the
    unpressured run's; pool and tier drain."""
    _, (tm, ctx, tparams) = models
    base, _ = _serve(
        serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu", page_tokens=8),
        _burst(serve, 6),
    )
    for kwargs, expect in (
        ({}, "sched_swaps"),
        ({"decode_step_us": 1e-3, "prefill_us": 1e-3}, "sched_recomputes"),
    ):
        srv = serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                                page_tokens=8, n_pool_pages=7, **kwargs)
        got, stats = _serve(srv, _burst(serve, 6), max_ticks=500)
        assert got == base
        assert stats["sched_evictions"] >= 1
        assert stats[expect] >= 1
        assert stats["pool_n_free"] == stats["pool_n_pages"]
        assert stats["tier_free_slots"] == stats["tier_slots"]
        pool.check_pool(srv.store.state, tables=list(srv.store.tables.values()))
        tier.check_tier(srv.tier, resident_rids=list(srv.store.tables))


def test_entry_points_need_cuda_unless_told_otherwise(models):
    _, (tm, ctx, tparams) = models
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.Server(tm, ctx, tparams, 2, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init(ctx, torch.Generator())
    with pytest.raises(ValueError, match="parameters on"):
        serve.PagedServer(tm, ctx, tparams, 2, 32, device="meta")


def test_serve_main_runs_on_cpu(capsys):
    serve.main(["--role", "decode", "--paged", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "requests: 3" in out and "pool_n_free: " in out


@pytest.mark.parametrize("arch,layers", [("kimi-k2-1t-a32b", 61),
                                         ("arctic-480b", 35)])
def test_serve_full_refuses_moe_depth_before_allocating(arch, layers,
                                                        monkeypatch, capsys):
    """``--full`` at a depth whose weights outgrow one card refuses before
    the model is built: no parameter is allocated.  The weights it names
    come from ``param_counts``, the reference's count."""
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import build

    def refuse(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(build, "build_model", refuse)
    monkeypatch.setattr(build.Model, "init", refuse)
    with pytest.raises(SystemExit):
        serve.main(["--full", "--arch", arch, "--device", "cpu"])
    err = capsys.readouterr().err
    need = ARCHS[arch].param_counts()[0] * 2 / 1e9
    assert f"{layers} layers" in err and f"{need:,.0f} GB" in err
    assert "80 GB card" in err and need > serve.CARD_BYTES / 1e9
    assert ARCHS[arch].param_counts() == J_ARCHS[arch].param_counts()


def test_scheduler_and_cost_model_match_reference():
    """Host arithmetic copied from the reference decides like it: the
    same admission order, victims, swap-vs-recompute choices and
    transfer plans."""
    from repro.core import sched as jsched
    from repro.serving import scheduler as jsch
    from repro_torch.core import sched
    from repro_torch.serving import scheduler as sch

    assert {k: vars(v) for k, v in sched.DEFAULT_COSTS.items()} == {
        k: vars(v) for k, v in jsched.DEFAULT_COSTS.items()
    }
    for nbytes in (1, 4096, 300_000, 4_718_592, 1 << 28):
        assert (sched.plan_p2p(nbytes=nbytes).describe()
                == jsched.plan_p2p(nbytes=nbytes).describe())
    both = [m.AdmissionScheduler(page_bytes=4_718_592) for m in (jsch, sch)]
    for s, m in zip(both, (jsch, sch)):
        s.submit(1, m.SLO(priority=0, ttft_deadline_s=5.0), now=0.0)
        s.submit(2, m.SLO(priority=1), now=1.0)
        s.submit(3, m.SLO(priority=0, ttft_deadline_s=1.0), now=0.0)
        s.on_admitted(2)
        s.on_preempted(2, "swap")
        s.submit(4, m.SLO(priority=1), now=2.0)
    assert both[0].admission_order() == both[1].admission_order()
    for s in both:
        for rid in (2, 4, 1):
            s.on_admitted(rid)
        for _ in range(7):
            s.on_step(1)
    free = {1: 3, 2: 2, 4: 2}
    for args in (([1, 2, 4], 3, 2, False), ([1, 4], 2, 3, False),
                 ([4], 2, 3, True), ([1], 9, 2, False)):
        running, need, ben, strict = args
        assert (both[0].pick_victims(running, need, free.get, ben, strict)
                == both[1].pick_victims(running, need, free.get, ben, strict))
    for n_pages in (1, 8, 64, 512):
        assert both[0].choose_mode(1, n_pages) == both[1].choose_mode(1, n_pages)
    assert both[0].stats() == both[1].stats()
