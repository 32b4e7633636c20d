"""The op-stream counter (``launch/hlostats.py``): twins of the
reference's ``tests/test_hlostats.py`` at its tolerances, the twin of its
collective suite, and every SMOKE arch's train, prefill and decode step
counted the same on ``meta`` as on the CPU.

The reference re-derives loop trip counts from HLO text; eager PyTorch
unrolls every loop as it dispatches, so the twins hold the counter to the
same totals with no trip count to recover (``while_trips`` stays empty).
"""

import pytest
import torch

from repro_torch.compat import tree_map
from repro_torch.configs.registry import SMOKE, ShapeConfig
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun, hlostats
from repro_torch.models.build import build_model
from repro_torch.testing import hlostats_coll_suite

M = 128


def _scan(x, ws):
    c = x
    for i in range(ws.shape[0]):
        c = torch.tanh(c @ ws[i])
    return c


def _struct(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def test_eager_dispatch_counts_every_loop_iteration():
    """The twin of ``test_xla_cost_analysis_undercounts_loops``: the
    reference shows XLA counting a loop body once; the counter sees each
    of the 10 matrix products as it is dispatched, and has no loop to
    recover."""
    st = hlostats.analyze(_scan, _struct(M, M), _struct(10, M, M))
    assert st.flops >= 10 * 2 * M**3
    assert st.while_trips == {} and st.unresolved_whiles == []
    assert st.ops == 20  # 10 products and 10 tanh


def test_hlostats_scan_flops_exact():
    st = hlostats.analyze(_scan, _struct(M, M), _struct(10, M, M))
    expected = 10 * 2 * M**3
    assert abs(st.flops - expected) / expected < 0.02  # tanh adds ~0.4%
    assert not st.unresolved_whiles


def test_hlostats_grad_scan_flops():
    ws = _struct(10, M, M).requires_grad_()

    def grad():
        torch.autograd.grad((_scan(_struct(M, M), ws) ** 2).sum(), ws)

    st = hlostats.analyze(grad)
    expected = 3 * 10 * 2 * M**3  # fwd + 2 bwd matmuls per layer
    assert abs(st.flops - expected) / expected < 0.05
    assert not st.unresolved_whiles


def test_hlostats_nested_scan():
    def f(x, ws):
        c = x
        for i in range(ws.shape[0]):
            for _ in range(3):
                c = torch.tanh(c @ ws[i])
        return c

    st = hlostats.analyze(f, _struct(M, M), _struct(5, M, M))
    expected = 5 * 3 * 2 * M**3
    assert abs(st.flops - expected) / expected < 0.02


def test_hlostats_dot_bytes_counted():
    a, b = _struct(256, 256), _struct(256, 256)
    st = hlostats.analyze(lambda: a @ b)
    assert st.flops == 2 * 256**3
    assert st.bytes >= 3 * 256 * 256 * 4  # two reads + one write


def test_collective_suite_twin():
    """T all-reduces of (M, M) f32 over 4 ranks: T·M·M·4 within 5%, on
    the CPU and on ``meta``."""
    for dev in ("cpu", "meta"):
        st = hlostats_coll_suite.run(torch.device(dev))
        assert st.kernels == {"gas_all_reduce": hlostats_coll_suite.T}


def test_kernel_counts_as_one_op_with_its_formula():
    """The flash forward under the counter: one op of ``cost.flash_work``,
    its plain version's ops left out; the same on ``meta``."""
    B, H, S, D = 1, 4, 64, 16
    for dev in ("cpu", "meta"):
        q = torch.zeros((B, H, S, D), device=dev)
        st = hlostats.analyze(ops.attention, q, q, q)
        nbytes, flops = cost.flash_work(B, H, H, S, S, D, True, None,
                                        torch.float32)["flash_attention_fwd"]
        assert st.kernels == {"flash_attention_fwd": 1} and st.ops == 1
        assert (st.flops, st.bytes) == (flops, nbytes)


def _real(structs, kind):
    gen = torch.Generator().manual_seed(0)

    def one(st):
        if st.dtype.is_floating_point:
            return (torch.randn(st.shape, generator=gen) * 0.02).to(st.dtype)
        return torch.zeros(st.shape, dtype=st.dtype)

    args = [tree_map(one, s) for s in structs]
    if kind == "train":
        args[0] = tree_map(lambda t: t.requires_grad_(), args[0])
    return tuple(args)


@pytest.mark.parametrize("arch", list(SMOKE))
def test_smoke_steps_count_the_same_on_meta_and_cpu(arch):
    """Each step as the dry run makes it, and a scan arch's training step
    on the plain scans too (their backward through the plain version)."""
    cfg = SMOKE[arch]
    model = build_model(cfg)
    ctx = dryrun.build_ctx(dryrun.mesh_of("h100"))
    opt = dryrun.opt_config(model)
    steps = [(dryrun.step_ctx(ctx, cfg, shape), shape) for shape in (
        ShapeConfig("t", "train", 16, 2), ShapeConfig("p", "prefill", 16, 2),
        ShapeConfig("d", "decode", 16, 2))]
    if steps[0][0].scan_impl == "chunked":
        steps.append((ctx, steps[0][1]))
    for ctx, shape in steps:
        structs, _ = dryrun.step_structs(model, ctx, shape, opt)
        step = dryrun.make_step(model, ctx, shape, opt)
        cpu = hlostats.analyze(step, *_real(structs, shape.kind))
        meta = hlostats.analyze(step, *dryrun.meta_args(structs, shape.kind))
        assert cpu.as_dict() == meta.as_dict(), (arch, shape.kind)
        assert cpu.flops > 0 and cpu.bytes > 0 and cpu.collective_bytes == 0
