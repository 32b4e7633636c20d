"""The dry run (``launch/dryrun.py``) and the mesh's other readers, on the
CPU: records of SMOKE-size cells on the ``h100`` mesh and on a 2 × 2
mesh, their argument bytes against the CPU tensors' (and, on the mesh,
the reference's per-device shard shapes), the CLI and the roofline table
over its records, ``ShardedLoader`` against ``Loader``, ``launch/train.py
--mesh-shape`` against the run without a mesh, and the distributed
suite's ``fsdp_gather`` check.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.parallel.sharding import sanitize as jsanitize
from repro_torch.compat import tree_leaves
from repro_torch.configs.registry import SMOKE, ShapeConfig
from repro_torch.core.addrspace import PartitionSpec as P
from repro_torch.data.synthetic import Loader, ShardedLoader, SyntheticLM
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.launch import train as train_main
from repro_torch.models.build import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.ctx import RunCtx
from repro_torch.testing import dist_suite

ARCHS = ["qwen3-4b", "falcon-mamba-7b", "kimi-k2-1t-a32b"]
SHAPES = [ShapeConfig("train_smoke", "train", 32, 4),
          ShapeConfig("prefill_smoke", "prefill", 32, 4),
          ShapeConfig("decode_smoke", "decode", 32, 4)]
KEYS = {"arch", "shape", "shape_dims", "mesh", "mesh_shape", "tag",
        "n_devices", "counts", "scan_impl", "status", "memory", "cost",
        "collectives",
        "while_trips", "unresolved_whiles", "kernels", "ops", "build_s",
        "trace_s", "total_s"}


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _cpu_arg_bytes(model, shape):
    """The bytes the step's arguments hold as CPU tensors: parameters
    from ``init``, AdamW state from ``init_state``, the batch, and the
    cache a CPU prefill returns."""
    ctx = RunCtx()
    params = model.init(ctx, torch.Generator().manual_seed(0), device="cpu")
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
            model.cfg, B, S).batch_at(0).items()}
        state = adamw.init_state(params, dryrun.opt_config(model))
        return _nbytes(params) + _nbytes(state) + _nbytes(batch)
    inputs = torch.zeros((B, S), dtype=torch.int32)
    if shape.kind == "prefill":
        return _nbytes(params) + _nbytes(inputs)
    _, caches = model.prefill(params, ctx, {"inputs": inputs}, cache_len=S)
    return _nbytes(params) + _nbytes(caches) + B * 4 + B * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_records(arch, tmp_path):
    model = build_model(SMOKE[arch])
    m22 = mesh.make_mesh((2, 2), ("data", "model"))
    jm = AbstractMesh((2, 2), ("data", "model"))
    for shape in SHAPES:
        for mk, m in (("h100", None), ("2x2", m22)):
            rec = dryrun.run_cell(arch, shape, mk, cfg=SMOKE[arch], mesh=m,
                                  out_dir=str(tmp_path), tag="smoke")
            assert rec["status"] == "ok", rec.get("traceback")
            assert set(rec) == KEYS
            assert rec["counts"] == "global" and rec["while_trips"] == {}
            assert set(rec["collectives"]["per_type"]) == set(
                dryrun.hlostats.COLLECTIVES)
            assert rec["cost"]["flops"] > 0 and rec["ops"] > 0
            path = tmp_path / f"{arch}__{shape.name}__{mk}__smoke.json"
            assert json.loads(path.read_text()) == rec
            arg = rec["memory"]["argument_size_in_bytes"]
            if mk == "h100":
                assert rec["n_devices"] == 1
                assert arg == _cpu_arg_bytes(model, shape)
            else:  # the reference's shard shapes of the same specs
                assert rec["n_devices"] == 4
                ctx = dryrun.build_ctx(m22)
                structs, specs = dryrun.step_structs(
                    model, ctx, shape, dryrun.opt_config(model))
                want = 0
                for st, sp in zip(tree_leaves(structs), tree_leaves(
                        specs, lambda x: isinstance(x, P))):
                    shard = NamedSharding(jm, jsanitize(
                        JP(*sp), st.shape, jm)).shard_shape(st.shape)
                    want += int(np.prod(shard)) * torch.tensor(
                        [], dtype=st.dtype).element_size()
                assert arg == want < _cpu_arg_bytes(model, shape)
        if shape.kind == "train" and arch == "falcon-mamba-7b":
            # training scans through the scan kernel and its backward
            assert rec["scan_impl"] == "ref"
            assert rec["kernels"]["selective_scan_bwd"] == SMOKE[arch].n_layers
        elif shape.kind == "train":
            assert rec["scan_impl"] == "ref"
            assert rec["kernels"]["flash_attention_dkv"] == SMOKE[arch].n_layers


def test_cli_writes_records_the_roofline_reads(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--arch", "qwen3-4b", "--shape", "decode_32k",
        "--mesh", "h100", "--out", str(tmp_path)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main()
    assert "[ok] qwen3-4b × decode_32k × h100" in out.getvalue()
    (rec,) = roofline.load_records(str(tmp_path))
    # 8.05 GB of weights and a 32,768-slot cache of 128 rows: 627 GB
    assert rec["memory"]["argument_size_in_bytes"] == 627124599808
    d = roofline.derive(rec)
    assert d["dominant"] == "memory" and d["fits_one_card"] is False
    table = roofline.table(str(tmp_path), mesh="h100").splitlines()
    assert len(table) == 3 and "| qwen3-4b | decode_32k | h100 |" in table[2]


def test_sharded_loader_matches_loader():
    src = SyntheticLM(SMOKE["qwen3-4b"], batch=8, seq_len=16, seed=3)
    m = mesh.make_mesh((4, 2), ("data", "model"))
    plain, sharded = Loader(src, start_step=2), ShardedLoader(
        src, mesh=m, dp_axes=("data",), start_step=2, prefetch=2)
    try:
        for _ in range(3):
            a, b = next(plain), next(sharded)
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], b[k])
        assert sharded.step == plain.step == 5
    finally:
        plain.close()
        sharded.close()
    with pytest.raises(ValueError, match="does not divide"):
        ShardedLoader(SyntheticLM(SMOKE["qwen3-4b"], batch=6, seq_len=16),
                      mesh=m)
    multi = mesh.make_mesh((2, 2, 2), ("pod", "data", "model"))
    ok = ShardedLoader(src, mesh=multi, dp_axes=("pod", "data"))
    ok.close()


def _losses(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main.main()
    return [line.split("loss ")[1].split()[0] for line in
            out.getvalue().splitlines() if line.startswith("step")]


def test_train_mesh_shape_losses_equal_no_mesh(monkeypatch):
    base = ["--arch", "qwen3-4b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "8", "--device", "cpu"]
    plain = _losses(base, monkeypatch)
    meshed = _losses(base + ["--mesh-shape", "2,1"], monkeypatch)
    assert len(plain) == 3 and plain == meshed


def test_dist_suite_fsdp_gather_parity():
    base, opt = dist_suite.fsdp_gather_parity(torch.device("cpu"))
    assert abs(base - opt) < 1e-4
