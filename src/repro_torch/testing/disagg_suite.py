"""Checks of the disaggregated cluster's two page writers meeting.

In the cluster a decode rank's pool lives twice: as float32 carrier pages
in its segment (what the wire reads and writes) and as the decode step's
resident views (``PooledDecodeServer``).  Two orderings must hold, on
any device:

- :func:`put_and_decode_in_one_tick` — one tick in which a transfer
  lands a new request's pages in a decode rank's segment while that
  rank's decode step writes a page of a running request: both land, the
  new pages bit-equal to the prefill's, the written page equal in the
  segment and the views.
- :func:`swap_out_of_a_fresh_write` — a page the decode wrote in a tick,
  swapped out by a preemption staged in that same tick (after the decode,
  before the transfer's consume): the memory rank receives the bytes the
  decode wrote, and the resumed request decodes on bit-identically.

Each raises ``AssertionError`` on a failure and returns the cluster's
finished tokens, for the caller to hold against a colocated server.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.compat import tree_map

__all__ = ["put_and_decode_in_one_tick", "swap_out_of_a_fresh_write"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.int32)


def _view_rows(server, pages: List[int]) -> torch.Tensor:
    """Carrier rows of ``pages`` as the decode views hold them."""
    idx = torch.tensor(pages, dtype=torch.int64, device=server.device)
    return server.layout.views_to_pool(
        tree_map(lambda v: v.index_select(1, idx), server._views))


def _tokens(cluster) -> Dict[int, List[int]]:
    return {r.rid: r.out for r in cluster.finished}


def put_and_decode_in_one_tick(cluster, first, second) -> Dict[int, List[int]]:
    """``first`` decodes on the one decode rank of a paged ``cluster``;
    ``second`` (sharing no prompt prefix with it) is submitted then, and
    the tick whose transfer lands ``second``'s pages is checked as it
    ends."""
    server, store = cluster.decode_servers[0], cluster.stores[0]
    cluster.submit(first)
    for _ in range(16):
        cluster.tick()
        if any(r is first for r in server.active):
            break
    else:
        raise AssertionError("the first request never reached a decode row")
    cluster.submit(second)
    written: set = set()
    decode = server._step

    def spy():
        n = decode()
        written.update(server._dirty)
        return n

    server._step = spy
    for _ in range(8):
        written.clear()
        cluster.tick()
        if second.rid in store.tables:
            break
    else:
        raise AssertionError("the second request's pages never landed")
    del server._step
    if not written or first not in server.active:
        raise AssertionError("the rank did not decode in the landing tick")
    dev = cluster.device
    n_prompt = cluster.playout.pages_for(len(second.prompt))
    pages = list(store.tables[second.rid][:n_prompt])
    # the landed pages are the prefill's carrier, bit for bit
    toks = torch.tensor([second.prompt], dtype=torch.int32, device=dev)
    _, caches = cluster.model.prefill(cluster.params, cluster.ctx,
                                      {"inputs": toks},
                                      cache_len=cluster.cache_len)
    want = cluster.playout.flatten(caches)[:n_prompt]
    if not torch.equal(_bits(store.mem[torch.tensor(pages, device=dev)]),
                       _bits(want)):
        raise AssertionError("landed pages differ from the prefill's")
    # the decode's page went back into the segment, and no page is both
    wp = sorted(written)
    if set(wp) & set(pages):
        raise AssertionError("a decode write hit a landing page")
    if not torch.equal(_bits(store.mem[torch.tensor(wp, device=dev)]),
                       _bits(_view_rows(server, wp))):
        raise AssertionError("the decode's page did not reach the segment")
    cluster.run_until_drained()
    return _tokens(cluster)


def swap_out_of_a_fresh_write(cluster, victim) -> Dict[int, List[int]]:
    """``victim`` decodes on a tiered ``cluster`` (one decode and one
    memory rank); after a few ticks it is preempted by swap right after a
    decode step wrote its page, before the tick's consume.  The memory
    rank must receive the written bytes, and the run must drain."""
    server = cluster.decode_servers[0]
    cluster.submit(victim)
    for _ in range(16):
        cluster.tick()
        if any(r is victim for r in server.active):
            break
    else:
        raise AssertionError("the victim never reached a decode row")
    cluster.tick()
    cluster.tick()
    want = {}

    def hook(c, phase, tick):
        if phase != "pre_consume" or want:
            return
        written = sorted(server._dirty)
        if not written:
            return
        table = c.stores[0].page_table(victim.rid)
        n_mat = c.playout.pages_for(int(server.positions[next(
            i for i, r in enumerate(server.active) if r is victim)]))
        phys = [table[lp] for lp in range(n_mat)]
        if not set(written) <= set(phys):
            raise AssertionError("the decode wrote outside the victim's pages")
        want["rows"] = _view_rows(server, phys)
        c._preempt(0, victim.rid, mode="swap")

    cluster.fault_hook = hook
    cluster.tick()  # decode writes, the hook stages the swap
    if not want:
        raise AssertionError("no decode write to swap out")
    cluster.fault_hook = None
    cluster.tick()  # the transfer ships the swap
    hold = cluster.tier.holdings.get(victim.rid)
    if hold is None:
        raise AssertionError("the swap-out did not land in the tier")
    seg = cluster.kvseg[cluster.memory_rank(hold.rank)]
    E = cluster.playout.page_elems
    got = torch.stack([seg[s * E:(s + 1) * E] for s in hold.slots])
    if not torch.equal(_bits(got), _bits(want["rows"])):
        raise AssertionError("the tier holds other bytes than the decode wrote")
    cluster.run_until_drained()
    return _tokens(cluster)
