"""GAS layer suite on one device: segments, put/get, AMs, ring collectives.

Twin of ``repro.testing.gas_suite`` (8 XLA devices) on the port's
rank-stacked layout: the 8 "devices" are ranks of ``Context.spmd``, and
the reference's ``(pod, data)`` mesh of its hierarchical all-reduce is two
group engines over them (``engine.pod_engines``).  The sections run in the
reference's order with its inputs and tolerances, one "OK" line each.

Run:  PYTHONPATH=src python -m repro_torch.testing.gas_suite [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import am, collectives, gasnet, sched
from repro_torch.core.engine import pod_engines
from repro_torch.core.gasnet import P

N = 8
PERM = (3, 0, 7, 1, 2, 6, 5, 4)


def _np(t: torch.Tensor) -> np.ndarray:
    """A result on the host (bf16 widened to f32) for numpy's checks."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _full(shape, value, device) -> torch.Tensor:
    """``jnp.full(shape, value, float32)`` for a value that may be a
    batched rank id."""
    return torch.zeros(shape, dtype=torch.float32, device=device) + value


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def put_get(ctx, seg) -> Any:
    """One-sided put (Shift, sender-chosen offset), put along a Perm,
    get; returns the put program for the later sections."""
    dev = ctx.device

    def prog(node, seg):
        seg = node.put(seg, _full(4, node.my_id, dev), to=gasnet.Shift(1),
                       index=2)
        node.barrier()
        return seg

    got = _np(ctx.spmd(prog, seg))
    for n in range(N):
        np.testing.assert_allclose(got[n, 2:6], (n - 1) % N)
        np.testing.assert_allclose(got[n, :2], 0)
    print("put OK")

    def prog_perm(node, seg):
        return node.put(seg, _full(4, node.my_id, dev), to=gasnet.Perm(PERM),
                        index=0)

    got = _np(ctx.spmd(prog_perm, seg))
    for s, d in enumerate(PERM):
        np.testing.assert_allclose(got[d, :4], s)
    print("perm put OK")

    seg2 = ctx.spmd(prog, seg)

    def prog_get(node, seg):
        return node.get(seg, frm=gasnet.Shift(3), index=2, size=4)[None]

    out = _np(ctx.spmd(prog_get, seg2, out_specs=P("node")))
    for n in range(N):
        np.testing.assert_allclose(out[n], (n + 3 - 1) % N)
    print("get OK")
    return prog


def ring_collectives(ctx, x) -> None:
    def prog_coll(node, x):
        e = node.engine
        ag = collectives.ring_all_gather(e, node.local(x))
        rs = collectives.ring_reduce_scatter(e, ag)
        ar = collectives.ring_all_reduce(e, node.local(x) * 1.0)
        return ag[None], rs[None], ar[None]

    ag, rs, ar = map(_np, ctx.spmd(prog_coll, x, out_specs=(P("node"),) * 3))
    xg = _np(x)
    for n in range(N):
        np.testing.assert_allclose(ag[n], xg.reshape(-1))
        np.testing.assert_allclose(rs[n], N * xg.reshape(N, 16)[n])
    np.testing.assert_allclose(ar, np.tile(xg.sum(0), (N, 1)))
    print("ring collectives OK")


def hierarchical(ctx, n_pods: int = 2) -> None:
    """RS inside each pod of 4, AR across the 2 pods, AG inside the pod."""
    xx = torch.arange(N * 16.0, device=ctx.device).reshape(N, 16) / 7.0

    def prog_hier(node, x):
        inner, outer = pod_engines(node.engine, n_pods)
        return collectives.hierarchical_all_reduce(
            inner, outer, node.local(x))[None]

    hier = _np(ctx.spmd(prog_hier, xx))
    np.testing.assert_allclose(
        hier, np.tile(_np(xx).sum(0), (N, 1)), rtol=1e-6)
    print("hierarchical all-reduce OK")


def active_messages(ctx, seg) -> Any:
    """Counters and AMLong writes, then overflow accounting; returns the
    counting handler."""
    dev = ctx.device
    handlers = ctx.handlers

    @handlers.handler("count")
    def h_count(state, payload, args):
        out = dict(state)
        out["cnt"] = state["cnt"] + args[0]
        return out

    handlers.register("write", am.long_write_handler("buf"))

    def prog_am(node, seg):
        me = node.my_id
        state = {"cnt": torch.zeros((), dtype=torch.int32, device=dev),
                 "buf": node.local(seg)}
        d1 = _i32((me + 2) % N)
        node.am_short(d1, "count", args=(3,))
        node.am_short(d1, "count", args=(4,))
        node.am_long(_i32((me + 1) % N), "write",
                     payload=_full(4, 100 + me, dev), dst_index=8)
        state = node.am_flush(state)
        return state["cnt"][None], state["buf"][None]

    cnt, buf = map(_np, ctx.spmd(prog_am, seg, out_specs=(P("node"),) * 2))
    np.testing.assert_array_equal(cnt, 7)
    for n in range(N):
        np.testing.assert_allclose(buf[n, 8:12], 100 + (n - 1) % N)
    print("active messages OK")

    ctx2 = gasnet.Context(N, backend="xla", device=dev, am_payload_width=4,
                          am_capacity=4, am_per_peer_capacity=1)
    ctx2.handlers.register("count", h_count)

    def prog_over(node, seg):
        state = {"cnt": torch.zeros((), dtype=torch.int32, device=dev)}
        d = _i32((node.my_id + 1) % N)
        for _ in range(3):  # 3 messages to the same peer, capacity 1
            node.am_short(d, "count", args=(1,))
        state = node.am_flush(state)
        return state["cnt"][None], node.dropped[None]

    cnt, dropped = map(_np, ctx2.spmd(prog_over, seg,
                                      out_specs=(P("node"),) * 2))
    np.testing.assert_array_equal(cnt, 1)
    np.testing.assert_array_equal(dropped, 2)
    print("AM overflow accounting OK")


def request_reply(backend: str, seg) -> List[np.ndarray]:
    """A ping to rank me+3 whose handler replies to the sender."""
    dev = seg.device
    ctx_rr = gasnet.Context(N, backend=backend, device=dev,
                            am_payload_width=4)
    table = ctx_rr.handlers

    def pong(state, payload, args):
        out = dict(state)
        out["ack_payload"] = payload
        out["ack_arg"] = state["ack_arg"] + args[0]
        return out

    pong_id = table.register("pong", pong)

    def ping(state, payload, args):
        out = dict(state)
        out["got"] = state["got"] + args[0]
        return out, am.reply_medium(pong_id, payload + 1.0,
                                    args=(args[0] + 1,))

    table.register("ping", ping, replies=True)

    def prog_rr(node, seg):
        me = node.my_id
        state = {
            "got": torch.zeros((), dtype=torch.int32, device=dev),
            "ack_arg": torch.zeros((), dtype=torch.int32, device=dev),
            "ack_payload": torch.zeros((4,), dtype=torch.float32, device=dev),
        }
        h = node.am_call(_i32((me + 3) % N), "ping", payload=_full(4, me, dev),
                         args=(me * 10,), ack=lambda st: st["ack_payload"])
        state = node.am_flush(state)
        acked = node.sync(h)
        return state["got"][None], state["ack_arg"][None], acked[None]

    return [_np(o) for o in ctx_rr.spmd(prog_rr, seg,
                                        out_specs=(P("node"),) * 3)]


def request_replies(seg) -> None:
    rr_sw = request_reply("xla", seg)
    got, ack_arg, acked = rr_sw
    for n in range(N):
        assert int(got[n]) == ((n - 3) % N) * 10          # request landed
        assert int(ack_arg[n]) == n * 10 + 1              # reply came back
        np.testing.assert_allclose(acked[n], n + 1.0)     # ack handle value
    rr_mix = request_reply("xla,gascore", seg)
    for name, a, b in zip(("got", "ack_arg", "ack_payload"), rr_sw, rr_mix):
        np.testing.assert_allclose(a, b, err_msg=f"request/reply: {name}")
    print("AM request/reply round trip OK (xla + mixed map)")


def extended(ctx, aspace, seg, prog) -> None:
    """Split-phase put/get, vectored get and put with predicates, and
    ``sync_all``."""
    dev = ctx.device

    def prog_nb(node, seg):
        # initiate, overlap independent compute, then sync
        h = node.put_nb(seg, _full(4, node.my_id, dev), to=gasnet.Shift(1),
                        index=2)
        overlapped = torch.sum(node.local(seg) * 2.0)  # no dep on the transfer
        seg = node.sync(h)
        g = node.get_nb(seg, frm=gasnet.Shift(3), index=2, size=4)
        done, got = node.try_sync(g)
        assert done
        return seg, got[None] + 0.0 * overlapped

    seg_nb, got = ctx.spmd(prog_nb, seg, out_specs=(P("node"),) * 2)
    seg_blk = ctx.spmd(prog, seg)  # the blocking version of the same put
    np.testing.assert_allclose(_np(seg_nb), _np(seg_blk))
    got = _np(got)
    for n in range(N):
        np.testing.assert_allclose(got[n], (n + 3 - 1) % N)
    print("nb put/get OK")

    def prog_nbv(node, seg):
        # gated fetch: odd ranks run the same transfers but get zeros
        h = node.get_nbv(seg, frm=gasnet.Shift(1), indices=[2, 6, 0], size=2,
                         pred=(node.my_id % 2) == 0)
        gated = node.sync(h)
        # ungated fetch via the blocking wrapper
        allv = node.get_v(seg, frm=gasnet.Shift(3), indices=[4, 0], size=3)
        return gated[None], allv[None]

    seg_src = ctx.spmd(prog, seg)  # deterministic contents (put section)
    gated, allv = map(_np, ctx.spmd(prog_nbv, seg_src,
                                    out_specs=(P("node"),) * 2))
    src_seg = _np(seg_src)
    for n in range(N):
        want = np.stack([src_seg[(n + 1) % N, i:i + 2] for i in (2, 6, 0)])
        if n % 2 == 0:
            np.testing.assert_allclose(gated[n], want)
        else:
            np.testing.assert_allclose(gated[n], 0.0)
        want3 = np.stack([src_seg[(n + 3) % N, i:i + 3] for i in (4, 0)])
        np.testing.assert_allclose(allv[n], want3)
    print("vectored get (incl. pred-gated) OK")

    def prog_pnbv(node, seg):
        datas = torch.stack(
            [_full(3, 1.0 + node.my_id * 10 + j, dev) for j in range(2)])
        # per-payload flags: payload 1 ships gated-off from odd ranks
        h = node.put_nbv(seg, datas, to=gasnet.Shift(1), indices=[2, 20],
                         pred=[True, (node.my_id % 2) == 0])
        overlapped = torch.sum(node.local(seg))  # no dep on the transfer
        seg = node.sync(h)
        # blocking wrapper, Perm pattern
        seg = node.put_v(seg, _full((1, 4), 70.0 + node.my_id, dev),
                         to=gasnet.Perm(PERM), indices=[10])
        return seg + 0.0 * overlapped

    got = _np(ctx.spmd(prog_pnbv, aspace.alloc("buf")))
    for n in range(N):
        src = (n - 1) % N
        np.testing.assert_allclose(got[n, 2:5], 1.0 + src * 10)
        if src % 2 == 0:
            np.testing.assert_allclose(got[n, 20:23], 2.0 + src * 10)
        else:
            np.testing.assert_allclose(got[n, 20:23], 0.0)
        np.testing.assert_allclose(got[n, 10:14], 70.0 + PERM.index(n))
    print("vectored put (incl. per-page pred) OK")

    def prog_nb_all(node, seg):
        node.put_nb(seg, torch.ones((2,), device=dev), to=gasnet.Shift(1),
                    index=0)
        node.get_nb(seg, frm=gasnet.Shift(1), index=2, size=2)
        seg2, got = node.sync_all()  # FIFO completion
        return seg2, got[None]

    seg_all, _ = ctx.spmd(prog_nb_all, seg, out_specs=(P("node"),) * 2)
    np.testing.assert_allclose(_np(seg_all)[:, :2], 1.0)
    print("sync_all OK")


def broadcast_exchange(ctx, x) -> None:
    def prog_bcex(node, x):
        e = node.engine
        bc = collectives.broadcast(e, node.local(x), root=5)
        ex = collectives.exchange(e, node.local(x))
        return bc[None], ex[None]

    bc, ex = map(_np, ctx.spmd(prog_bcex, x, out_specs=(P("node"),) * 2))
    xg = _np(x)
    for n in range(N):
        np.testing.assert_allclose(bc[n], xg[5])
    np.testing.assert_allclose(
        ex.reshape(N, N, 2), xg.reshape(N, N, 2).transpose(1, 0, 2))
    print("broadcast/exchange OK")


def engine_parity(ctx, ctx_hw, ctx_mix) -> None:
    """Every Extended op on "xla", "gascore" and the mixed map."""
    dev = ctx.device
    xk = torch.arange(N * 8 * 128.0, device=dev).reshape(N, 8, 128)
    aspace_hw = ctx_hw.address_space()
    aspace_hw.register("kbuf", (8, 128), torch.float32)
    segk = aspace_hw.alloc("kbuf")

    def prog_ext(node, seg, x):
        me = node.my_id
        h = node.put_nb(seg, _full(128, 1.0 + me, dev), to=gasnet.Shift(1),
                        index=128)
        seg = node.sync(h)
        g = node.get_nb(seg, frm=gasnet.Shift(1), index=128, size=128)
        got = node.sync(g)
        # vectored multi-get, gated on even ranks: both engines must agree
        gv = node.get_nbv(seg, frm=gasnet.Shift(2), indices=[128, 0, 192],
                          size=64, pred=(me % 2) == 0)
        gotv = node.sync(gv)
        # vectored multi-put (per-payload flags): the write-side mirror
        pv = node.put_nbv(
            seg, [_full(32, 5.0 + me, dev),
                  torch.full((32,), 9.0, device=dev)],
            to=gasnet.Shift(3), indices=[256, 640],
            pred=[True, (me % 2) == 0])
        seg = node.sync(pv)
        e = node.engine
        bc = collectives.broadcast(e, node.local(x), root=2)
        ex = collectives.exchange(e, node.local(x))
        return seg, got[None], gotv[None], bc[None], ex[None]

    names = ("put_nb/put_nbv/sync", "get_nb", "get_nbv(pred)", "broadcast",
             "exchange")
    specs = (P("node"),) * 5
    sw = ctx.spmd(prog_ext, segk, xk, out_specs=specs)
    hw = ctx_hw.spmd(prog_ext, segk, xk, out_specs=specs)
    for name, a, b in zip(names, sw, hw):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                   err_msg=f"engine parity: {name}")
    print("extended engine parity OK (incl. vectored get + put)")

    # alternating software and hardware ranks in one job: the paper's
    # mixed cluster runs the identical program to identical results
    mix = ctx_mix.spmd(prog_ext, segk, xk, out_specs=specs)
    for name, a, b in zip(names, sw, mix):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                   err_msg=f"mixed-map parity: {name}")
    print("heterogeneous EngineMap parity OK")


def segmented_planned(ctx, ctx_mix) -> None:
    xi = torch.arange(N * 16, dtype=torch.int32,
                      device=ctx.device).reshape(N, 16) * 7 - 300

    def prog_seg(node, x):
        e = node.engine
        xl = node.local(x)
        mono = collectives.ring_all_reduce(e, xl)
        seg = collectives.segmented_ring_all_reduce(e, xl, n_segments=3,
                                                    depth=2)
        agm = collectives.ring_all_gather(e, xl)
        ags = collectives.segmented_ring_all_gather(e, xl, n_segments=4,
                                                    depth=3)
        planned = sched.all_reduce(e, xl)
        return mono[None], seg[None], agm[None], ags[None], planned[None]

    for c in (ctx, ctx_mix):
        mono, seg, agm, ags, planned = map(
            _np, c.spmd(prog_seg, xi, out_specs=(P("node"),) * 5))
        np.testing.assert_array_equal(mono, seg)
        np.testing.assert_array_equal(agm, ags)
        np.testing.assert_array_equal(planned, np.tile(_np(xi).sum(0), (N, 1)))
    print("segmented + planned collectives OK")


def tp_all_reduce(ctx, ctx_hw, ctx_mix) -> None:
    """The TP group's per-sub-block partial sum at (B, 1, D) decode
    payloads, f32 and bf16, on the three engine maps."""
    def prog_tp(node, x):
        return sched.all_reduce(node.engine, node.local(x))[None]

    for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 0.05)):
        xa = (torch.arange(N * 4 * 1 * 128.0, device=ctx.device)
              .reshape(N, 4, 1, 128) / 37.0 - 5.0).to(dt)
        want = np.tile(_np(xa).sum(0), (N, 1, 1, 1))
        outs = {name: _np(c.spmd(prog_tp, xa, out_specs=P("node")))
                for name, c in (("xla", ctx), ("gascore", ctx_hw),
                                ("mixed", ctx_mix))}
        for name, o in outs.items():
            np.testing.assert_allclose(
                o, want, rtol=tol,
                err_msg=f"TP all-reduce vs numpy on {name} ({dt})")
            np.testing.assert_allclose(
                o, outs["xla"], rtol=tol,
                err_msg=f"TP all-reduce engine parity: {name}")
    print("TP-group all-reduce parity OK (decode payloads, f32+bf16)")


def main(device: Any = None) -> None:
    dev = resolve_device(device)
    ctx = gasnet.Context(N, node_axis="node", backend="xla", device=dev,
                         am_payload_width=4)
    aspace = ctx.address_space()
    aspace.register("buf", (32,), torch.float32)
    seg = aspace.alloc("buf")
    assert tuple(seg.shape) == (N, 32)

    prog = put_get(ctx, seg)
    x = torch.arange(N * 16.0, device=dev).reshape(N, 16)
    ring_collectives(ctx, x)
    hierarchical(ctx)
    active_messages(ctx, seg)
    request_replies(seg)
    extended(ctx, aspace, seg, prog)
    broadcast_exchange(ctx, x)
    ctx_hw = gasnet.Context(N, node_axis="node", backend="gascore", device=dev)
    ctx_mix = gasnet.Context(N, node_axis="node", backend="xla,gascore",
                             device=dev)
    engine_parity(ctx, ctx_hw, ctx_mix)
    segmented_planned(ctx, ctx_mix)
    tp_all_reduce(ctx, ctx_hw, ctx_mix)
    print("GAS_SUITE_PASS")


def _cli(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    _cli()
