"""Tensor-parallel decode groups of the port against the JAX reference, on
the CPU.

The shard rules (``parallel.tp``) are held against the reference's on the
same numpy tree, bit for bit.  The port's group all-reduce and its
head-sharded paged decode step (``launch.serve._tp_paged_decode_fn``),
the ranks under ``Context.spmd``, run against the reference's
single-device stand-in — ``jax.vmap`` over a ``"tp"`` axis with
``lax.psum``, as ``tests/test_properties.py`` runs it — on the same
inputs: the all-reduce bit for bit on the three backends in f32 and
bf16; the decode step on the same weights with logits replicated bit
for bit across the ranks, tokens equal, ``pos`` pages bit-equal and k/v
pages within 2e-5 (the plain paged attention of the two packages rounds
differently in the last bits).  ``TPPagedServer`` and a cluster's tp=2 decode group must give the
tokens of tp=1 at the SMOKE width.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs.registry import SMOKE as J_SMOKE
from repro.models.build import build_model as j_build
from repro.parallel import tp as jtp
from repro.parallel.ctx import RunCtx as JCtx
from repro.serving import pool as jpool
from repro_torch.compat import tree_flatten_with_path
from repro_torch.configs.registry import SMOKE
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel import tp
from repro_torch.parallel.ctx import RunCtx
from repro_torch.serving import pool
from repro_torch.testing import tp_suite

BACKENDS = ["xla", "gascore", "xla,gascore"]
TP = 2


@pytest.fixture(scope="module")
def models():
    cfg = J_SMOKE["qwen3-4b"]
    jm = j_build(cfg)
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jm, jctx, jparams), (build_model(SMOKE["qwen3-4b"]), RunCtx(),
                                 tparams)


def _path_key(path):
    return tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path)


def _np(t):
    return t.contiguous().view(torch.int32).numpy()


# --------------------------------------------------------------------------- #
# shard rules
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rank", [0, 1])
def test_shard_decode_params_match_reference(models, rank):
    (_, _, jparams), (_, _, tparams) = models
    want = dict(jax.tree_util.tree_flatten_with_path(
        jtp.shard_decode_params(jparams, TP, rank))[0])
    want = {_path_key(k): v for k, v in want.items()}
    got = dict(tree_flatten_with_path(
        tp.shard_decode_params(tparams, TP, rank)))
    assert set(got) == set(want)
    sharded = 0
    for path, leaf in got.items():
        w = np.asarray(want[path])
        assert tuple(leaf.shape) == w.shape, path
        assert np.array_equal(_np(leaf.float()), w.astype(np.float32).view(
            np.int32)), path
        sharded += tp.shard_axis_for(path) is not None
    # one stacked segment: wq wk wv wo of attention, wi wg wo of the MLP
    assert sharded == 7


def test_stack_shards_match_reference(models):
    (_, _, jparams), (_, _, tparams) = models
    want = {_path_key(k): v for k, v in jax.tree_util.tree_flatten_with_path(
        jtp.stack_shards(jparams, TP))[0]}
    got = dict(tree_flatten_with_path(tp.stack_shards(tparams, TP)))
    assert set(got) == set(want)
    for path, leaf in got.items():
        w = np.asarray(want[path])
        assert tuple(leaf.shape) == w.shape and leaf.shape[0] == TP, path
        assert np.array_equal(leaf.numpy(), w), path


@pytest.mark.parametrize("path,axis", [
    (("dec", 0, "b0_global", "attn", "wq"), -2),
    (("dec", 0, "b0_global", "attn", "wo"), -2),
    (("dec", 0, "b0_global", "mlp", "wi"), -1),
    (("dec", 0, "b0_global", "mlp", "wg"), -1),
    (("dec", 0, "b0_moe", "moe", "shared", "wi"), None),
    (("dec", 0, "b0_global", "attn", "q_norm", "scale"), None),
    (("io", "tok"), None),
])
def test_shard_axis_for_matches_reference(path, axis):
    jpath = tuple(jax.tree_util.DictKey(p) if isinstance(p, str)
                  else jax.tree_util.SequenceKey(p) for p in path)
    assert tp.shard_axis_for(path) == jtp.shard_axis_for(jpath) == axis


def test_validate_tp_refuses_what_the_reference_refuses(models):
    cfg = models[1][0].cfg
    tp.validate_tp(cfg, 2)
    for bad in (3, 4):  # SMOKE qwen3-4b: 8 q heads, 2 KV heads
        with pytest.raises(ValueError, match="must divide"):
            jtp.validate_tp(models[0][0].cfg, bad)
        with pytest.raises(ValueError, match="must divide"):
            tp.validate_tp(cfg, bad)


# --------------------------------------------------------------------------- #
# the group's all-reduce (the reference suite's first block)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tp_all_reduce_bitwise(backend, dtype):
    """The port's planned group all-reduce (``Context.spmd`` over "tp")
    against the reference's single-device stand-in, ``jax.vmap`` over a
    "tp" axis with ``lax.psum``, on the same inputs in ``dtype``."""
    x = (np.arange(2.0 * 4 * 1 * 128).reshape(2, 4, 1, 128) / 37.0 - 5.0
         ).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.vmap(lambda v: lax.psum(v.astype(jd), "tp"), axis_name="tp")(
        jnp.asarray(x))
    got = tp_suite.group_all_reduce(torch.from_numpy(x), backend, td)
    assert got.dtype == td and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# --------------------------------------------------------------------------- #
# the head-sharded paged decode step against the reference's stand-in
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_tp_decode_step_matches_reference_stand_in(models, backend):
    (jm, jctx, jparams), (tm, ctx, tparams) = models
    cache_len, pt, steps, prompt_len = 24, 4, 3, 9
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jm.cfg.vocab, prompt_len).tolist()
    logits0, caches = jm.prefill(jparams, jctx,
                                 {"inputs": jnp.asarray(prompt, jnp.int32)[None]},
                                 cache_len=cache_len)
    t0 = int(np.argmax(np.asarray(logits0)[0]))
    jl = jpool.PagedLayout.from_struct(
        jm.kv_block_struct(jctx, prompt_len=prompt_len, cache_len=cache_len),
        cache_len=cache_len, page_tokens=pt)
    pages = np.asarray(jl.flatten(caches))
    n_pool = jl.n_pages + 2
    order = rng.permutation(n_pool)[: jl.n_pages]
    mem = np.zeros((n_pool, jl.page_elems), np.float32)
    mem[order] = pages
    table = np.asarray(order[None], np.int32)
    KH = jm.cfg.n_kv_heads

    # ---- the reference: jax.vmap over "tp" + lax.psum --------------------
    jshard, jcols = jl.shard_heads(TP, KH)
    sparams = jax.tree.map(jnp.asarray, jtp.stack_shards(jparams, TP))
    group = jtp.TPGroup(TP, lambda x: lax.psum(x, "tp"))

    def one_shard(p_shard, mem_shard, token, position):
        vs = jshard.decode_views(mem_shard)
        lg, vs = jm.decode_step_paged(p_shard, jctx, token, position, vs,
                                      jnp.asarray(table), tp=group)
        return lg, jshard.views_to_pool(vs)

    vstep = jax.jit(jax.vmap(one_shard, in_axes=(0, 0, None, None),
                             axis_name="tp"))
    jmem = jnp.asarray(np.stack([mem[:, c] for c in jcols]))
    want_toks, last, pos = [t0], t0, prompt_len
    for _ in range(steps):
        lg, jmem = vstep(sparams, jmem, jnp.asarray([[last]], jnp.int32),
                         jnp.asarray([pos], jnp.int32))
        last = int(np.argmax(np.asarray(lg)[0, 0]))
        want_toks.append(last)
        pos += 1
    jmem = np.asarray(jmem)

    # ---- the port: the ranks under Context.spmd -------------------------
    layout = pool.PagedLayout.from_struct(
        tm.kv_block_struct(ctx, prompt_len=4, cache_len=cache_len),
        cache_len=cache_len, page_tokens=pt)
    shard, cols = layout.shard_heads(TP, KH)
    np.testing.assert_array_equal(cols, jcols)
    tcols = torch.from_numpy(cols)
    rows = torch.from_numpy(np.concatenate(
        [mem, layout.empty_page_row()[None]]))  # + the scratch page
    views = serve._tp_views(shard, tcols, rows)
    step = serve._tp_paged_decode_fn(tm, ctx, shard, TP, backend, "cpu")
    stacked = tp.stack_shards(tparams, TP)
    got_toks, last, pos = [t0], t0, prompt_len
    for _ in range(steps):
        lg = step(stacked, torch.tensor([[last]], dtype=torch.int32),
                  torch.tensor([pos], dtype=torch.int32), views,
                  torch.from_numpy(table))
        assert lg.shape == (TP, 1, tm.cfg.vocab)
        assert torch.equal(lg[0].view(torch.int32), lg[1].view(torch.int32))
        last = int(torch.argmax(lg[0, 0]))
        got_toks.append(last)
        pos += 1
    assert got_toks == want_toks
    got = serve._tp_rows(shard, views, torch.arange(n_pool)).numpy()
    for s in range(TP):
        for (path, _), leaf in zip(tree_flatten_with_path(shard.treedef),
                                   shard.leaves):
            sl = slice(leaf.offset, leaf.offset + leaf.size)
            g, w = got[s][:, sl], jmem[s][:, sl]
            if path[-1] in ("k", "v"):
                np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6,
                                           err_msg=f"shard {s} {path}")
            else:
                assert g.tobytes() == w.tobytes(), (s, path)


def test_paged_attention_vmap_rule_is_one_call_per_group(monkeypatch):
    """The rank fold: one call of the kernel's entry for the whole group,
    each rank's output equal to the plain version on its own pool."""
    calls = []
    real = ops.ref.paged_attention
    monkeypatch.setattr(ops.ref, "paged_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    g = torch.Generator().manual_seed(3)
    L, P, T, KH, D, B, H, NP = 3, 7, 4, 2, 16, 3, 4, 5
    k = torch.randn((TP, L, P, T, KH, D), generator=g)
    v = torch.randn((TP, L, P, T, KH, D), generator=g)
    q = torch.randn((TP, B, H, D), generator=g)
    table = torch.randint(0, P, (B, NP), generator=g, dtype=torch.int32)
    lens = torch.tensor([5, 17, 20], dtype=torch.int32)
    got = torch.func.vmap(lambda q, k, v: ops.paged_attention(
        q, k[1], v[1], table, lens, scale=0.3))(q, k, v)
    assert calls == [(TP * B, H, D)]
    for r in range(TP):
        want = real(q[r], k[r, 1], v[r, 1], table, lens, scale=0.3)
        assert torch.equal(got[r], want)


# --------------------------------------------------------------------------- #
# servers and the cluster: tp=2 tokens == tp=1 tokens
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_tp_paged_server_tokens_match_tp1(models, backend):
    _, (tm, ctx, tparams) = models
    out = tp_suite.server_parity(tm, ctx, tparams, "cpu", backends=(backend,))
    assert len(out[backend]) == 5


@pytest.mark.parametrize("backend", BACKENDS)
def test_tp2_decode_group_in_cluster_matches_tp1(models, backend):
    """The positive counterpart of the tp > 1 raise the cluster had before
    its TP groups were ported."""
    _, (tm, ctx, tparams) = models
    stats = tp_suite.cluster_parity(tm, ctx, tparams, "cpu",
                                    tp_backend=backend)
    assert stats["decode_paged_steps"] > 0


def test_tp_cluster_refuses_what_the_reference_refuses(models):
    from repro_torch.serving.disagg import DisaggCluster

    _, (tm, ctx, tparams) = models
    kw = dict(n_prefill=1, n_decode=2, tp=2, decode_batch=2, cache_len=32,
              device="cpu")
    with pytest.raises(ValueError, match="paged"):
        DisaggCluster(tm, ctx, tparams, **kw)
    with pytest.raises(ValueError, match="memory tiering"):
        DisaggCluster(tm, ctx, tparams, paged=True, n_memory=1, **kw)
    with pytest.raises(ValueError, match="must divide"):
        DisaggCluster(tm, ctx, tparams, paged=True,
                      **{**kw, "n_decode": 3})


def test_serve_entry_point_runs_a_tp2_decode_group():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--role", "decode", "--paged", "--tp", "2",
                    "--device", "cpu", "--requests", "4", "--max-new", "4",
                    "--tp-backend", "xla,gascore"])
    lines = dict(l.split(": ", 1) for l in buf.getvalue().splitlines())
    assert lines["requests"] == "4" and int(lines["decoded_tokens"]) > 0
    with pytest.raises(SystemExit):
        serve.main(["--role", "decode", "--tp", "2", "--device", "cpu"])


# --------------------------------------------------------------------------- #
# chip_smoke's serve_tp gates, at the SMOKE size
# --------------------------------------------------------------------------- #
@pytest.fixture
def smoke_counts(monkeypatch):
    """chip_smoke's counters read as the kernel calls that reach
    ``kernels.ops`` (one launch each on the card)."""
    import chip_smoke

    seen = dict.fromkeys(list(chip_smoke.GAS_KERNELS) + ["paged_attention"], 0)
    for name in seen:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    monkeypatch.setattr(chip_smoke, "all_counts", lambda: dict(seen))
    return chip_smoke


def test_chip_smoke_tp_launch_schedule(models, smoke_counts):
    """``run_tp_cluster`` and ``per_step`` as the card's ``serve_tp`` phase
    runs them: the decode servers' public ``on_step`` hook feeds the
    tp=1 oracle's ``TieGate`` and holds the tp=2 group to it; the tp=1
    group all-reduces nothing; the tp=2 group's all-reduce launches a
    step equal ``TPPagedServer``'s on the same backend."""
    from repro_torch.launch.serve import Request, TPPagedServer
    from repro_torch.serving.disagg import DisaggCluster

    cs = smoke_counts
    _, (tm, ctx, tparams) = models
    n_layers = tm.cfg.n_layers

    def reqs():
        return [Request(rid=rid, prompt=list(p), max_new=mx)
                for rid, p, mx in tp_suite.smoke_requests(tm.cfg.vocab)]

    def cluster(n):
        return lambda: DisaggCluster(
            tm, ctx, tparams, n_prefill=1, n_decode=n, tp=n, decode_batch=2,
            cache_len=32, page_tokens=8, paged=True, decode_backend="gascore",
            device="cpu")

    oracle = cs.TieGate()
    _, base, _, g1 = cs.run_tp_cluster(cluster(1), reqs(), oracle.keep,
                                       n_layers)
    assert oracle.rows and not any(g1.values())
    stats, got, _, g2 = cs.run_tp_cluster(cluster(TP), reqs(),
                                          oracle.compare, n_layers)
    assert stats["tp"] == TP
    verdict = oracle.verdict("tp=2 cluster", base, got)
    assert verdict["requests_token_identical"] == len(base)
    assert verdict["steps_compared"] > 0

    srv = TPPagedServer(tm, ctx, tparams, 2, 32, tp=TP, tp_backend="gascore",
                        device="cpu", page_tokens=8)
    steps = []
    srv.on_step = lambda s, live, logits: steps.append(len(live))

    def serve_all():
        for r in reqs():
            srv.submit(r)
        return srv.run_until_drained()

    _, launches = cs.counted(serve_all)
    assert len(steps) == srv.paged_decode_steps > 0
    step = cs.per_step("gascore", launches, srv.paged_decode_steps, n_layers)
    assert step["paged_attention"] == n_layers
    assert g2 == {k: step[k] for k in cs.TP_TRANSFERS}
    assert sum(g2.values()) > 0
