"""GAScore kernel suite + software/hardware engine parity on one device.

Twin of ``repro.testing.gascore_suite`` (4 XLA devices, Pallas in TPU
interpret mode) on the port's rank-stacked layout: each GAScore wrapper
(``kernels.ops``: the CUDA kernel on the card, its plain version on the
CPU) takes the ``(4, ...)`` stack of the ranks' blocks at the reference's
shapes and is held to the oracles of ``kernels.ref``, copies byte for
byte.  The engine parity then runs under ``Context.spmd`` on "xla",
"gascore" and the mixed "xla,gascore" map.

Run:  PYTHONPATH=src python -m repro_torch.testing.gascore_suite [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import am, collectives, gasnet, sched
from repro_torch.core.gasnet import P
from repro_torch.kernels import ops, ref
from repro_torch.testing.gas_suite import _full, _np

N = 4
BACKENDS = ("xla", "gascore", "xla,gascore")
PERM = (2, 0, 3, 1)


def _same_bytes(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if (got.dtype != want.dtype or got.shape != want.shape
            or _np(got.contiguous().view(torch.uint8)).tobytes()
            != _np(want.contiguous().view(torch.uint8)).tobytes()):
        raise AssertionError(f"{name}: kernel and oracle differ")


def kernels(dev: torch.device) -> None:
    """The five GAScore kernels against their oracles."""
    x = torch.arange(4.0 * 8 * 128, device=dev).reshape(N, 8, 128)
    for k in (1, 2, 3):
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            xx = x.to(dt)
            if dt == torch.int32:  # int32 words ride the f32 carrier
                y = ops.ring_shift(xx.view(torch.float32), k).view(torch.int32)
            else:
                y = ops.ring_shift(xx, k)
            _same_bytes(f"ring_shift k={k} {dt}", y, ref.ring_shift(xx, k))
    print("ring_shift OK")

    _same_bytes("perm_put", ops.perm_put(x, PERM), ref.perm_put(x, PERM))
    print("perm_put OK")

    # offset_put (AMLong semantics): rank r's 4 rows land at row 4 of
    # rank r+1's 16-row segment
    seg = torch.zeros((N, 16, 128), dtype=torch.float32, device=dev)
    data = torch.arange(4.0, device=dev)[None, :, None].expand(N, 4, 128)
    data = (data + torch.arange(4.0, device=dev)[:, None, None] * 100
            ).contiguous()
    offset = torch.full((1,), 4, dtype=torch.int32, device=dev)
    want = ref.offset_put(seg, data, offset, 1)
    y = ops.offset_put(seg.clone(), data, offset, 1)
    _same_bytes("offset_put", y, want)
    yn, dn = _np(y), _np(data)
    for node in range(N):
        np.testing.assert_allclose(yn[node, 4:8], dn[(node - 1) % N])
        np.testing.assert_allclose(yn[node, :4], 0)
    print("offset_put OK")

    xl = torch.arange(4.0 * 2 * 128, device=dev).reshape(N, 2, 128)
    _same_bytes("ring_all_gather", ops.ring_all_gather(xl), ref.all_gather(xl))
    print("ring_all_gather OK")

    xf = torch.arange(4.0 * 8 * 128, device=dev).reshape(N, 8, 128) / 100.0
    np.testing.assert_allclose(_np(ops.ring_reduce_scatter(xf)),
                               _np(ref.reduce_scatter(xf)), rtol=1e-6)
    print("ring_reduce_scatter OK")


def _run(backend: str, fn: Callable, *args, out_specs=P("node")):
    """``fn(node, *local args)`` on every rank of a ``backend`` context."""
    ctx = gasnet.Context(N, backend=backend, device=args[0].device)
    return ctx.spmd(fn, *args, out_specs=out_specs)


def engine_parity(xf: torch.Tensor) -> None:
    """Each engine collective, then the ring algorithms, on every engine."""
    for op in ("all_reduce", "all_to_all", "all_gather", "reduce_scatter"):
        def prog(node, a, op=op):
            arg = node.local(a) if op != "all_gather" else node.local(a)[:2]
            return getattr(node.engine, op)(arg)[None]

        outs = [_np(_run(b, prog, xf)) for b in BACKENDS]
        for b, o in zip(BACKENDS[1:], outs[1:]):
            np.testing.assert_allclose(outs[0], o, rtol=1e-6,
                                       err_msg=f"{op} parity vs {b}")
    print("engine parity OK (incl. heterogeneous map)")

    # the ring algorithms built on top run on EVERY engine identically,
    # monolithic and segmented/pipelined (the scheduler's bulk tier)
    def coll_prog(node, a):
        e, xl = node.engine, node.local(a)
        mono = collectives.ring_all_reduce(e, xl)
        seg = collectives.segmented_ring_all_reduce(e, xl, n_segments=3,
                                                    depth=2)
        planned = sched.all_reduce(e, xl)
        return mono[None], seg[None], planned[None]

    outs = {b: [_np(y) for y in _run(b, coll_prog, xf,
                                     out_specs=(P("node"),) * 3)]
            for b in BACKENDS}
    for b in BACKENDS:
        mono, seg, planned = outs[b]
        np.testing.assert_allclose(mono, seg, rtol=1e-6,
                                   err_msg=f"segmented != monolithic on {b}")
        np.testing.assert_allclose(mono, planned, rtol=1e-5,
                                   err_msg=f"planned != monolithic on {b}")
        np.testing.assert_allclose(mono, outs["xla"][0], rtol=1e-6,
                                   err_msg=f"ring parity vs {b}")
    print("collectives-on-engines parity OK (monolithic/segmented/planned)")

    # split-phase primitives + the collectives built on them
    def nb_prog(node, a):
        e, xl = node.engine, node.local(a)
        pending = e.shift_nb(xl, 1)   # initiate
        local = xl * 2.0              # overlapped compute
        shifted = pending.wait()      # sync point
        bc = collectives.broadcast(e, xl, root=1)
        ex = collectives.exchange(e, xl)
        return (shifted + 0.0 * local)[None], bc[None], ex[None]

    specs3 = (P("node"),) * 3
    sw = _run("xla", nb_prog, xf, out_specs=specs3)
    hw = _run("gascore", nb_prog, xf, out_specs=specs3)
    for name, a, b in zip(("shift_nb", "broadcast", "exchange"), sw, hw):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, err_msg=name)
    # broadcast oracle: every node holds node 1's contribution
    np.testing.assert_allclose(_np(sw[1]), np.tile(_np(xf)[1], (N, 1, 1)))
    print("split-phase primitives parity OK")


def vectored(dev: torch.device) -> None:
    """get_nbv / put_nbv with predicates on the three engine maps."""
    segv = torch.arange(4.0 * 16, device=dev).reshape(N, 16)

    def prog_get(node, seg):
        # plain vectored fetch from the left neighbour
        plain = node.sync(node.get_nbv(seg, frm=gasnet.Shift(1),
                                       indices=[4, 0, 12], size=3))
        # pred-gated: odd ranks run the fetch but keep zeros
        gated = node.get_v(seg, frm=gasnet.Shift(2), indices=[8, 2], size=2,
                           pred=(node.my_id % 2) == 0)
        return plain[None], gated[None]

    getv = {b: [_np(o) for o in _run(b, prog_get, segv,
                                     out_specs=(P("node"),) * 2)]
            for b in BACKENDS}
    sv = _np(segv)
    plain, gated = getv["xla"]
    for node in range(N):
        want = np.stack([sv[(node + 1) % N, i:i + 3] for i in (4, 0, 12)])
        np.testing.assert_allclose(plain[node], want)
        if node % 2 == 0:
            want2 = np.stack([sv[(node + 2) % N, i:i + 2] for i in (8, 2)])
            np.testing.assert_allclose(gated[node], want2)
        else:
            np.testing.assert_allclose(gated[node], 0.0)
    for b in BACKENDS[1:]:
        for name, a, o in zip(("plain", "pred-gated"), getv["xla"], getv[b]):
            np.testing.assert_allclose(
                a, o, err_msg=f"get_nbv parity vs {b}: {name}")
    print("vectored get parity OK (xla/gascore/mixed, incl. pred-gated)")

    def prog_put(node, seg):
        datas = torch.stack([_full(3, 1.0 + 10 * node.my_id + j, dev)
                             for j in range(2)])
        h = node.put_nbv(seg, datas, to=gasnet.Shift(1), indices=[1, 9],
                         pred=[True, (node.my_id % 2) == 0])
        seg = node.sync(h)
        return node.put_v(seg, torch.full((1, 2), 77.0, device=dev),
                          to=gasnet.Shift(2), indices=[13])

    zeros = torch.zeros((N, 16), dtype=torch.float32, device=dev)
    putv = {b: _np(_run(b, prog_put, zeros)) for b in BACKENDS}
    ref_pv = putv["xla"]
    for node in range(N):
        src = (node - 1) % N
        np.testing.assert_allclose(ref_pv[node, 1:4], 1.0 + 10 * src)
        if src % 2 == 0:
            np.testing.assert_allclose(ref_pv[node, 9:12], 2.0 + 10 * src)
        else:
            np.testing.assert_allclose(ref_pv[node, 9:12], 0.0)
        np.testing.assert_allclose(ref_pv[node, 13:15], 77.0)
    for b in BACKENDS[1:]:
        np.testing.assert_allclose(ref_pv, putv[b],
                                   err_msg=f"put_nbv parity vs {b}")
    print("vectored put parity OK (xla/gascore/mixed, incl. per-page pred)")


def request_reply(backend: str, dev: torch.device) -> List[np.ndarray]:
    ctx = gasnet.Context(N, backend=backend, device=dev, am_payload_width=4)
    table = ctx.handlers

    def pong(state, payload, args):
        out = dict(state)
        out["ack_payload"] = payload
        out["ack_arg"] = state["ack_arg"] + args[0]
        return out

    pong_id = table.register("pong", pong)

    def ping(state, payload, args):
        out = dict(state)
        out["got"] = state["got"] + args[0]
        return out, am.reply_medium(pong_id, payload * 2.0,
                                    args=(args[0] + 1,))

    table.register("ping", ping, replies=True)

    def prog_rr(node, seg):
        me = node.my_id
        state = {
            "got": torch.zeros((), dtype=torch.int32, device=dev),
            "ack_arg": torch.zeros((), dtype=torch.int32, device=dev),
            "ack_payload": torch.zeros((4,), dtype=torch.float32, device=dev),
        }
        h = node.am_call(((me + 1) % N).to(torch.int32), "ping",
                         payload=_full(4, 1.0 + me, dev), args=(me * 5,),
                         ack=lambda st: st["ack_payload"])
        state = node.am_flush(state)
        acked = node.sync(h)
        return state["got"][None], state["ack_arg"][None], acked[None]

    seg = torch.zeros((N, 8), dtype=torch.float32, device=dev)
    return [_np(o) for o in ctx.spmd(prog_rr, seg, out_specs=(P("node"),) * 3)]


def request_replies(dev: torch.device) -> None:
    rr = {b: request_reply(b, dev) for b in BACKENDS}
    got, ack_arg, acked = rr["xla"]
    for node in range(N):
        assert int(got[node]) == ((node - 1) % N) * 5
        assert int(ack_arg[node]) == node * 5 + 1
        np.testing.assert_allclose(acked[node], 2.0 * (1.0 + node))
    for b in BACKENDS[1:]:
        for name, a, o in zip(("got", "ack_arg", "ack_payload"), rr["xla"],
                              rr[b]):
            np.testing.assert_allclose(
                a, o, err_msg=f"request/reply parity vs {b}: {name}")
    print("AM request/reply parity OK (xla/gascore/mixed)")


def tp_all_reduce(dev: torch.device) -> None:
    """The TP decode group's partial sum at (B, 1, D) payloads, planned by
    the scheduler, f32 and bf16, on the three engine maps."""
    xd = torch.arange(4.0 * 4 * 1 * 128, device=dev).reshape(N, 4, 1, 128
                                                             ) / 29.0 - 9.0
    for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 0.05)):
        def prog(node, a, dt=dt):
            out = sched.all_reduce(node.engine, node.local(a).to(dt))
            return out.float()[None]

        want = np.tile(_np(xd.to(dt).float()).sum(0), (N, 1, 1, 1))
        outs = [_np(_run(b, prog, xd)) for b in BACKENDS]
        for b, o in zip(BACKENDS, outs):
            np.testing.assert_allclose(
                o, want, rtol=tol, err_msg=f"TP all-reduce vs numpy on {b} "
                                           f"({dt})")
            np.testing.assert_allclose(
                o, outs[0], rtol=tol,
                err_msg=f"TP all-reduce engine parity vs {b}")
    print("TP-group decode-payload all-reduce parity OK (f32+bf16)")


def main(device: Any = None) -> None:
    dev = resolve_device(device)
    kernels(dev)
    xf = torch.arange(4.0 * 8 * 128, device=dev).reshape(N, 8, 128) / 100.0
    engine_parity(xf)
    vectored(dev)
    request_replies(dev)
    tp_all_reduce(dev)
    print("GASCORE_SUITE_PASS")


def _cli(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    _cli()
