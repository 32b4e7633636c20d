"""The port's mesh, sharding specs and abstract model against the JAX
reference's, on the CPU.

For all ten archs at both production meshes (16 × 16 and 2 × 16 × 16):
the PartitionSpec tree of ``Model.abstract_init`` leaf for leaf, the
``meta`` parameter tree's shapes and dtypes, and after ``sanitize`` the
specs and the shape one device holds (the reference's
``NamedSharding(AbstractMesh, spec).shard_shape``).  The reference runs
its own ``abstract_init`` over an ``AbstractMesh`` (no devices).  Then
the step inputs' and the decode caches' structs and specs, the ``meta``
tree against a CPU ``init`` at SMOKE size, and the cases where
``sanitize`` drops an axis (from the reference's docstring).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.models.build import ShapeConfig as JShape
from repro.models.build import build_model as j_build
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsharding
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.compat import tree_flatten_with_path
from repro_torch.configs import registry
from repro_torch.core.addrspace import PartitionSpec as P
from repro_torch.launch import mesh
from repro_torch.models.build import build_model
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.parallel.ctx import RunCtx

ARCHS = list(registry.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _is_jp(x):
    return isinstance(x, JP)


def _is_p(x):
    return isinstance(x, P)


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


def _jflat(tree, is_leaf=None):
    """(path, leaf) pairs of a JAX tree, paths as tuples of keys."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(_key(k) for k in path), leaf) for path, leaf in leaves]


def _tflat(tree, is_leaf=None):
    return list(tree_flatten_with_path(tree, (), is_leaf))


def _dt(d):
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else str(np.dtype(d))


@pytest.fixture(scope="module")
def abstract():
    """Both packages' abstract inits for every arch at both meshes."""
    out = {}
    for mk, (shape, axes) in MESHES.items():
        jm = AbstractMesh(shape, axes)
        tm = mesh.make_mesh(shape, axes)
        dp, tp = mesh.mesh_axes(tm)
        assert (dp, tp) == jmesh.mesh_axes(jm)
        for arch in ARCHS:
            jp, js = j_build(jreg.ARCHS[arch]).abstract_init(
                JCtx(mesh=jm, dp=dp, tp=tp))
            tp_, ts = build_model(registry.ARCHS[arch]).abstract_init(
                RunCtx(mesh=tm, dp=dp, tp=tp))
            out[mk, arch] = (jm, tm, jp, js, tp_, ts)
    return out


def test_production_meshes_and_axis_roles():
    single = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert dict(single.shape) == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert mesh.mesh_axes(multi) == (("pod", "data"), "model")
    assert mesh.mesh_axes(mesh.make_mesh((4,), ("d",))) == ((), "d")
    assert RunCtx(mesh=multi, dp=("pod", "data")).tp_size == 16
    assert RunCtx().tp_size == 1 and RunCtx().mesh is None


def test_partition_spec_normalises_as_jax():
    for entries in [(("data",), None), (["pod", "data"], "model"), ((),),
                    ("data", ("pod", "data"))]:
        assert tuple(P(*entries)) == tuple(JP(*entries))


@pytest.mark.parametrize("mk", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_shapes_and_shards_equal_the_reference(abstract, arch, mk):
    jm, tm, jp, js, tp_, ts = abstract[mk, arch]
    jspecs, tspecs = _jflat(js, _is_jp), _tflat(ts, _is_p)
    assert [p for p, _ in jspecs] == [p for p, _ in tspecs]
    assert [tuple(s) for _, s in jspecs] == [tuple(s) for _, s in tspecs]
    jleaves, tleaves = _jflat(jp), _tflat(tp_)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(j.shape) == tuple(t.shape) and _dt(j.dtype) == _dt(t.dtype)
        assert t.device.type == "meta"
    jsan = _jflat(jsharding.sanitize_tree(js, jp, jm), _is_jp)
    tsan = _tflat(sharding.sanitize_tree(ts, tp_, tm), _is_p)
    assert [tuple(s) for _, s in jsan] == [tuple(s) for _, s in tsan]
    pairs = _tflat(sharding.named_shardings(ts, tp_, tm),
                   lambda x: isinstance(x, tuple) and len(x) == 2 and _is_p(x[0]))
    for (_, j), (_, s), (_, leaf), (_, (spec, shard)) in zip(
            jleaves, jsan, tleaves, pairs):
        assert tuple(spec) == tuple(s)
        assert shard == tuple(NamedSharding(jm, s).shard_shape(tuple(leaf.shape)))
    # the optimizer state's specs mirror the parameters'
    jst, tst = jadamw.state_specs(js), adamw.state_specs(ts)
    assert [tuple(s) for _, s in _jflat(jst, _is_jp)] == [
        tuple(s) for _, s in _tflat(tst, _is_p)]


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_and_caches_equal_the_reference(arch):
    """Input structs and specs of every step kind, and the decode cache's
    structs (a prefill on meta / eval_shape) and specs, at 16 × 16."""
    shape_, axes = MESHES["single"]
    jm, tm = AbstractMesh(shape_, axes), mesh.make_mesh(shape_, axes)
    jctx, tctx = JCtx(mesh=jm), RunCtx(mesh=tm)
    jmodel, tmodel = (j_build(jreg.ARCHS[arch]),
                      build_model(registry.ARCHS[arch]))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        js, ts = jreg.SHAPES[name], registry.SHAPES[name]
        ji, ti = jmodel.input_structs(js), tmodel.input_structs(ts)
        assert sorted(ji) == sorted(ti)
        for k in ji:
            assert tuple(ji[k].shape) == ti[k].shape
            assert _dt(ji[k].dtype) == _dt(ti[k].dtype)
        jsp, tsp = jmodel.input_specs(js, jctx), tmodel.input_specs(ts, tctx)
        assert {k: tuple(v) for k, v in jsp.items()} == {
            k: tuple(v) for k, v in tsp.items()}
    small = registry.ShapeConfig("decode_small", "decode", 64, 16)
    jstruct = jmodel.cache_structs(JShape("decode_small", "decode", 64, 16),
                                   jctx)
    jc = _jflat(jstruct)
    tstruct = tmodel.cache_structs(small, tctx)
    tc = _tflat(tstruct)
    assert [p for p, _ in jc] == [p for p, _ in tc]
    for (_, j), (_, t) in zip(jc, tc):
        assert tuple(j.shape) == t.shape and _dt(j.dtype) == _dt(t.dtype)
    jcs = _jflat(jmodel.cache_specs(jstruct, jctx), _is_jp)
    tcs = _tflat(tmodel.cache_specs(tstruct, tctx), _is_p)
    assert [tuple(s) for _, s in jcs] == [tuple(s) for _, s in tcs]


@pytest.mark.parametrize("arch", ["qwen3-4b", "falcon-mamba-7b",
                                  "kimi-k2-1t-a32b", "seamless-m4t-medium"])
def test_meta_tree_equals_the_cpu_init(arch):
    cfg = registry.SMOKE[arch]
    model = build_model(cfg)
    meta, specs = model.abstract_init(RunCtx())
    real = model.init(RunCtx(), torch.Generator().manual_seed(0), device="cpu")
    mflat, rflat = _tflat(meta), _tflat(real)
    assert [p for p, _ in mflat] == [p for p, _ in rflat]
    for (_, m), (_, r) in zip(mflat, rflat):
        assert m.device.type == "meta" and r.device.type == "cpu"
        assert m.shape == r.shape and m.dtype == r.dtype
    assert [p for p, _ in _tflat(specs, _is_p)] == [p for p, _ in rflat]


def test_sanitize_drops_what_does_not_divide():
    """The reference docstring's cases: vocab 256206, arctic's 56 heads
    over model=16, batch-1 long-context decode."""
    tm = mesh.make_production_mesh()
    jm = AbstractMesh((16, 16), ("data", "model"))
    cases = [
        (P("model", "data"), (256206, 1024)),  # seamless' vocab
        (P("data", "model", None), (7168, 56, 128)),  # arctic's wq
        (P(("data",), None), (1, 1)),  # batch-1 decode's token
        (P(("pod", "data"), None), (16, 4)),  # drop the trailing axis only
    ]
    multi = mesh.make_production_mesh(multi_pod=True)
    jmulti = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    want = [(None, "data"), ("data", None, None), (None, None), ("pod", None)]
    for (spec, shape), w, (m, jmm) in zip(
            cases, want, [(tm, jm)] * 3 + [(multi, jmulti)]):
        got = sharding.sanitize(spec, shape, m)
        assert tuple(got) == w
        assert tuple(jsharding.sanitize(JP(*spec), shape, jmm)) == w
        assert sharding.shard_shape(got, shape, m) == tuple(
            NamedSharding(jmm, JP(*got)).shard_shape(shape))
    # the registry's real cases
    seamless = build_model(registry.ARCHS["seamless-m4t-medium"])
    p, s = seamless.abstract_init(RunCtx(mesh=tm))
    assert tuple(sharding.sanitize(s["io"]["tok"], p["io"]["tok"].shape, tm)) \
        == (None, "data")
    arctic = build_model(registry.ARCHS["arctic-480b"])
    p, s = arctic.abstract_init(RunCtx(mesh=tm))
    wq, wq_spec = p["dec"][0]["b0_moe"]["attn"]["wq"], \
        s["dec"][0]["b0_moe"]["attn"]["wq"]
    assert wq.shape[2] == 56
    assert tuple(sharding.sanitize(wq_spec, wq.shape, tm)) == (
        None, "data", None, None)
    long = registry.SHAPES["long_500k"]
    spec = build_model(registry.ARCHS["falcon-mamba-7b"]).input_specs(
        long, RunCtx(mesh=tm))["token"]
    assert tuple(sharding.sanitize(spec, (1, 1), tm)) == (None, None)
