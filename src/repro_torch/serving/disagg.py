"""Disaggregated prefill/decode serving over the GAS layer.

Counterpart of ``repro.serving.disagg``.  The cluster is one GASNet job of
``n`` ranks (``launch.mesh.serve_roles``): the first ``n_prefill`` ranks
form the prefill pool, then the decode pool, then the memory ranks, each
pool optionally on its own engine (``role_backends`` -> ``EngineMap`` —
the paper's mixed software/hardware cluster, serving-shaped).  All ranks
live on one device: their segments are the rows of ONE rank-stacked
``(n, seg_elems)`` float32 tensor, allocated once and written in place
for the cluster's life.

- **Data plane** — a finished request's KV cache is flattened into one
  carrier block (:class:`~repro_torch.serving.kv.KVLayout`) and pushed
  into a staging slot of the decode rank's segment with
  ``sched.plan_p2p``-planned segmented split-phase puts
  (:func:`~repro_torch.serving.kv.push_block`).  With ``paged=True`` the
  decode segments hold the **global paged KV pool**
  (:mod:`repro_torch.serving.pool`): the prefill rank puts each page
  straight into the slot the allocator assigned, pred-gated; pages whose
  prompt-prefix chain is already resident on the target rank ship
  nothing and are mapped into the new request's table.
- **Control plane** — Active Messages: a ``kv_ready`` *request* (request
  id, slot, origin) rides with the data; the decode rank's handler
  records the slot in its inbox and replies an AMShort ack that resolves
  the prefill rank's :class:`~repro_torch.core.extended.AckHandle`; a
  finished request's ``req_done`` AM notifies its origin prefill rank.
- **Tier plane** (``n_memory > 0``, paged only) — memory ranks export
  segment capacity and run no model compute.  Admission is lazy, so the
  pool oversubscribes; the SLO-aware scheduler preempts victims, whose
  pages swap OUT to a memory rank as one vectored put (payloads + tier
  slot offsets in one command block, ``tier.swap_out_pages``) and back IN
  at resume as one vectored get (``pool.fetch_pages``), or recompute.
  Preempted requests resume bit-exactly.

Every tick runs the SPMD transfer program (``Context.spmd``): the puts'
payloads, offsets and arrival flags cross the wire on the ranks' engines
(on ``"gascore"`` ranks the GAScore copy kernels) and the AM plane runs;
each put's landing is deferred (``Node.defer``) and written into the
stacked segment in place after the program (``extended.land``) — no
segment is ever copied.  A decode step on every decode server is queued
between the transfer's launch and its consume, as in the reference; the
transfer's moves run on the engines' side stream (``core.engine``), the
decode on the current one.

- **Tensor-parallel decode groups** (``tp > 1``, paged only) — the decode
  pool is carved into groups of ``tp`` consecutive ranks; a group is one
  logical decode server (``launch.serve.TPPooledDecodeServer``) whose
  pool is striped across its members' segments BY HEADS
  (``PagedLayout.shard_heads``).  A prefill rank pushes each page's head
  shard to the member that owns it (``perm`` is a tuple of per-shard
  permutations), the group leader receives the control plane, and the
  decode's written pages come back as ``(tp, shard_elems)`` rows, one
  per member.  Not composed with memory ranks (as in the reference).

Out of this slice (they raise ``NotImplementedError`` naming their
``ROADMAP.md`` queue 1 item): spare ranks, rank kills and recovery,
elastic join (item 7), and the flight recorder's dump at a rank's death
(item 8).  The heartbeat runs as in the reference.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core import am, extended, gasnet, sched
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import health as health_lib
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Registry, counter_property
from repro_torch.serving import kv as kv_lib
from repro_torch.serving import pool as pool_lib
from repro_torch.serving import tier as tier_lib

__all__ = ["DisaggCluster"]


def _todo(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1, item {item})"
    )


def _merge_landings(landings: List[Tuple[torch.Tensor, ...]]) -> List[Tuple]:
    """Concatenate consecutive landing commands of one payload length into
    one ``(m, L)`` stack each (order kept), so the caller lands a page
    plane in a few passes instead of one per put."""
    runs: List[List[Tuple[torch.Tensor, ...]]] = []
    for cmd in landings:
        if runs and runs[-1][0][0].shape[-1] == cmd[0].shape[-1]:
            runs[-1].append(cmd)
        else:
            runs.append([cmd])
    return [tuple(torch.cat(parts)[None] for parts in zip(*run)) for run in runs]


class DisaggCluster:
    """A role-based serving cluster: prefill pool + decode pool + AM
    control plane (+ memory ranks), all over one GAS context on one
    device.

    ``prefill_backend`` / ``decode_backend`` / ``memory_backend`` name each
    pool's engine (mixing them yields an ``EngineMap``).  ``n_slots`` is
    the number of KV staging slots per decode rank's segment (in paged
    mode: in-flight installs per rank — the data lands in pages);
    ``decode_batch`` the continuous-batching width of each decode server.
    ``paged=True`` replaces the staging slots with the paged pool
    (``pages_per_rank`` pages of ``page_tokens`` tokens per decode rank).

    ``costs`` (a :mod:`~repro_torch.core.sched` cost table) plans the
    puts and prices swap against recompute; without it the cluster takes
    the reference's constants on the CPU and the card's own, measured
    once by :func:`~repro_torch.core.sched.measure_costs`, on CUDA.

    Cluster statistics live on one typed
    :class:`~repro_torch.obs.metrics.Registry` (``self.metrics``, shared
    with the admission scheduler and the memory tier).
    """

    HEADER = 2  # carrier elems prepended to each block: first_token, pos

    kv_transfers = counter_property("kv_transfers")
    kv_acked = counter_property("kv_acked")
    kv_pages_sent = counter_property("kv_pages_sent")
    kv_pages_shared = counter_property("kv_pages_shared")
    decoded_tokens = counter_property("decoded_tokens")
    dropped_am = counter_property("am_dropped")
    swap_out_bytes = counter_property("swap_out_bytes")
    swap_in_bytes = counter_property("swap_in_bytes")
    transfer_programs = counter_property("transfer_programs")

    def __init__(
        self,
        model: Any,
        ctx: Any,
        params: Any,
        *,
        n_prefill: int = 1,
        n_decode: int = 1,
        n_memory: int = 0,
        decode_batch: int = 4,
        cache_len: int = 64,
        n_slots: int = 2,
        prefill_backend: str = "xla",
        decode_backend: str = "xla",
        memory_backend: str = "xla",
        node_axis: str = "node",
        eos_id: int = -1,
        costs: Optional[Dict[str, Any]] = None,
        paged: bool = False,
        page_tokens: int = 8,
        pages_per_rank: Optional[int] = None,
        mem_slots_per_rank: Optional[int] = None,
        decode_step_us: float = 2000.0,
        prefill_us: float = 4000.0,
        tp: int = 1,
        tp_backend: Optional[str] = None,
        heartbeat_timeout: int = 3,
        tier_replicas: int = 1,
        replicate_all_swaps: bool = False,
        n_spare: int = 0,
        metrics: Optional[Registry] = None,
        device: Any = None,
    ):
        from repro_torch.launch.serve import (
            PooledDecodeServer, Server, TPPooledDecodeServer)
        from repro_torch.runtime.ft import HeartbeatMonitor
        from repro_torch.serving import scheduler as sched_lib

        if n_memory and not paged:
            raise ValueError("memory ranks require paged=True (page swap)")
        if tp > 1:
            if not paged:
                raise ValueError(
                    "tp > 1 requires paged=True (the TP group shards the "
                    "page pool by heads)"
                )
            if n_memory:
                raise ValueError(
                    "TP decode groups not yet composed with memory tiering"
                )
        if n_spare:
            raise _todo("spare ranks and elastic join", 7)

        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else Registry()
        self.model, self.ctx, self.params = model, ctx, params
        self.n_prefill, self.n_decode = n_prefill, n_decode
        self.n_memory = n_memory
        self.n = n_prefill + n_decode + n_memory
        self._memory_base = n_prefill + n_decode
        self.cache_len = cache_len
        self.n_slots = n_slots
        self.max_done = decode_batch
        self.paged = paged
        self.tp = tp
        self.tp_backend = tp_backend or decode_backend
        self.n_groups = n_decode // tp

        self.roles = mesh_lib.serve_roles(n_prefill, n_decode, n_memory, tp=tp)
        # decode-group leader ranks: the rank whose segment backs the
        # group's store and which receives the group's control plane
        self.group_leaders = [n_prefill + g * tp for g in range(self.n_groups)]
        self._backends = mesh_lib.role_backends(
            self.roles, prefill=prefill_backend, decode=decode_backend,
            memory=memory_backend,
        )
        if costs is None and self.device.type == "cuda":
            # the reference's default constants are a TPU's: plan and
            # price this card's transfers with its own, measured once
            costs = sched.measure_costs(self.device, {"xla", *self._backends})
        self.costs = costs or sched.DEFAULT_COSTS
        self.gas = gasnet.Context(
            self.n,
            node_axis=node_axis,
            backend=self._backends,
            device=self.device,
            am_capacity=self.max_done + 4,
            am_payload_width=1,
        )
        engine = self.gas.make_engine()

        # ---- KV layout (static: shapes depend only on cache_len) --------
        struct = model.kv_block_struct(ctx, prompt_len=4, cache_len=cache_len)
        if paged:
            self.playout = pool_lib.PagedLayout.from_struct(
                struct, cache_len=cache_len, page_tokens=page_tokens,
            )
            self.pages_per_rank = pages_per_rank or (
                (decode_batch + n_slots) * self.playout.n_pages
            )
            self.block_elems = self.playout.n_pages * self.playout.page_elems
            self.block_bytes = self.block_elems * 4
            self.shard_layout, self.shard_cols = self.playout.shard_heads(
                tp, model.cfg.n_kv_heads
            )
            self._cols = torch.from_numpy(self.shard_cols).to(self.device)
            self.seg_elems = self.pages_per_rank * self.shard_layout.page_elems
            # per-PAGE put plan: each page is its own planned transfer
            self.plan = sched.plan_p2p(
                nbytes=self.shard_layout.page_bytes, engine=engine,
                costs=costs,
            )
            self.max_swap = self.playout.n_pages  # one request per tick
            self.swap_plan = sched.plan_p2p(
                nbytes=self.max_swap * self.playout.page_bytes,
                engine=engine, costs=costs,
            )
            if n_memory:
                self.mem_slots = mem_slots_per_rank or (
                    2 * decode_batch * self.playout.n_pages
                )
                self.tier = tier_lib.MemoryTier(
                    n_memory, self.mem_slots, self.playout.page_elems,
                    replicas=max(1, min(tier_replicas, n_memory)),
                    registry=self.metrics,
                )
                self.seg_elems = max(
                    self.seg_elems, self.mem_slots * self.playout.page_elems
                )
            else:
                self.tier = None
            self.scheduler = sched_lib.AdmissionScheduler(
                page_bytes=self.playout.page_bytes, costs=costs,
                decode_step_us=decode_step_us, prefill_us=prefill_us,
                registry=self.metrics,
            )
            # live SLO monitor on the tick clock (inert until a request
            # carries finite deadlines)
            self.health = health_lib.HealthMonitor(registry=self.metrics)
            self.scheduler.attach_health(self.health)
        else:
            self.layout = kv_lib.KVLayout.from_struct(struct)
            self.block_elems = self.layout.total + self.HEADER
            self.block_bytes = self.block_elems * 4
            self.seg_elems = self.n_slots * self.block_elems
            self.plan = sched.plan_p2p(
                nbytes=self.block_bytes, engine=engine, costs=costs,
            )
            self.tier = None
            self.swap_plan = None
            self.scheduler = None
            self.health = None
            self.max_swap = 1

        # ---- AM control plane ------------------------------------------
        handlers = self.gas.handlers

        def kv_ack(state, payload, args):
            del payload
            acks = state["acks"]
            hit = torch.arange(acks.shape[0], device=acks.device) == args[1]
            out = dict(state)
            out["acks"] = torch.where(hit, args[0] + 1, acks)
            return out

        ack_id = handlers.register("kv_ack", kv_ack)

        def kv_ready(state, payload, args):
            rid, slot, origin = args[0], args[1], args[2]
            inbox = state["inbox"]
            row = torch.stack([torch.ones_like(rid), rid, origin])
            hit = torch.arange(inbox.shape[0], device=inbox.device) == slot
            out = dict(state)
            out["inbox"] = torch.where(hit[:, None], row[None, :], inbox)
            return out, am.reply_short(ack_id, args=(rid, slot), like=payload)

        handlers.register("kv_ready", kv_ready, replies=True)

        def req_done(state, payload, args):
            del payload, args
            out = dict(state)
            out["done"] = state["done"] + 1
            return out

        handlers.register("req_done", req_done)

        # ---- cluster state ---------------------------------------------
        # the ranks' segments: one device tensor for the cluster's life,
        # written in place by every landing (data_ptr never changes)
        self.kvseg = torch.zeros((self.n, self.seg_elems), dtype=torch.float32,
                                 device=self.device)
        # the AM plane's per-rank state, small: it crosses to the host and
        # back once per transfer
        self.inbox = np.zeros((self.n, n_slots, 3), np.int32)
        self.acks = np.zeros((self.n, n_slots), np.int32)
        self.done = np.zeros((self.n, 1), np.int32)

        # ---- pools ------------------------------------------------------
        if paged:
            pool_elems = self.pages_per_rank * self.shard_layout.page_elems
            # every member's pool partition, a view of its segment row
            # (entry 0, the leader's, backs the group's store)
            self.shard_mems = [
                [self.kvseg[self.member_rank(g, s), :pool_elems].view(
                    self.pages_per_rank, self.shard_layout.page_elems)
                 for s in range(tp)]
                for g in range(self.n_groups)
            ]
            self.stores = [
                pool_lib.PagedKVStore(self.shard_layout, self.pages_per_rank,
                                      mem=self.shard_mems[g][0])
                for g in range(self.n_groups)
            ]

            def shortage(g):
                return lambda rid, need: self._decode_shortage(g, rid, need)

            if tp > 1:
                self.decode_servers = [
                    TPPooledDecodeServer(
                        model, ctx, params, decode_batch, cache_len,
                        store=self.stores[g], shard_mems=self.shard_mems[g],
                        tp=tp, tp_backend=self.tp_backend, costs=costs,
                        eos_id=eos_id, device=self.device,
                        on_page_shortage=shortage(g),
                    )
                    for g in range(self.n_groups)
                ]
            else:
                self.decode_servers = [
                    PooledDecodeServer(
                        model, ctx, params, decode_batch, cache_len,
                        store=self.stores[g], eos_id=eos_id,
                        device=self.device, on_page_shortage=shortage(g),
                    )
                    for g in range(self.n_groups)
                ]
        else:
            self.stores = []
            self.shard_mems = []
            self.decode_servers = [
                Server(model, ctx, params, decode_batch, cache_len,
                       eos_id=eos_id, device=self.device)
                for _ in range(n_decode)
            ]
        for d, srv in enumerate(self.decode_servers):
            srv.trace_rank = self.decode_rank(d)
        self._prefill_fn = lambda p, b: model.prefill(p, ctx, b, cache_len=cache_len)

        # ---- host scheduler state --------------------------------------
        self.queue: List[Any] = []
        self.by_rid: Dict[int, Any] = {}
        self.finished: List[Any] = []
        # one in-flight push per prefill worker: (request, pool, slot,
        # block, admit plan)
        self.pending_push: List[Optional[Tuple]] = [None] * n_prefill
        self.staged: List[Dict[int, int]] = [
            dict() for _ in range(self.n_groups)]
        self._done_queue: List[Tuple[int, int, int]] = []  # (d, rid+1, origin)
        self._finished_seen = [0] * self.n_groups
        self._rr_decode = 0
        self.kv_transfers = 0
        self.transfer_programs = 0
        self.kv_acked = 0
        self.kv_pages_sent = 0
        self.kv_pages_shared = 0
        self.decoded_tokens = 0
        self.dropped_am = 0
        # ---- tiered-memory scheduler state -----------------------------
        self._preempted: Dict[int, Dict[str, Any]] = {}
        # staged swap-outs: (rid, d, src_offsets, legs), legs a tuple of
        # (memory rank, dst_offsets), one vectored put per replica leg
        self._swap_jobs: List[Tuple] = []
        # staged swap-ins: (rid, d, remote_offsets, local_offsets, src_rank)
        self._fetch_jobs: List[Tuple] = []
        self._inflight_swap: Optional[Tuple] = None
        self._inflight_fetch: Optional[Tuple] = None
        # (decode pool, fresh physical pages) of the pushes in flight
        self._inflight_pages: List[Tuple[int, List[int]]] = []
        self._installable: Dict[int, int] = {}
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.replicate_all_swaps = replicate_all_swaps
        self.max_replicas = self.tier.replicas if self.tier is not None else 1
        # ---- liveness: every rank beats once per tick; the monitor
        # declares a rank dead after ``heartbeat_timeout`` missed ticks
        self._tick_no = 0
        self.monitor = HeartbeatMonitor(
            list(range(self.n)),
            timeout_s=float(heartbeat_timeout),
            clock=lambda: float(self._tick_no),
        )
        self.fault_hook = None  # callable(cluster, phase, tick)
        self.beat_filter = None  # callable(rank, tick) -> bool

    # ------------------------------------------------------------------ #
    # role views
    # ------------------------------------------------------------------ #
    def decode_rank(self, d: int) -> int:
        """Rank of decode GROUP ``d``'s leader (its only member at tp=1):
        the rank whose segment backs the group's store and which receives
        the group's control-plane AMs."""
        return self.group_leaders[d]

    def member_rank(self, g: int, s: int) -> int:
        """Rank of member ``s`` of decode group ``g`` (its head shard)."""
        return self.group_leaders[g] + s

    def memory_rank(self, m: int) -> int:
        return self._memory_base + m

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------ #
    # request intake
    # ------------------------------------------------------------------ #
    def submit(self, req: Any) -> None:
        from repro_torch.serving.scheduler import SLO

        req.t_enqueue = time.monotonic()
        tr = obs_trace.active()
        if tr.enabled:
            tr.instant("req_submit", cat="req", rid=req.rid,
                       prompt_len=len(req.prompt))
        self.queue.append(req)
        self.by_rid[req.rid] = req
        if self.scheduler is not None:
            slo = getattr(req, "slo", None) or SLO()
            self.scheduler.submit(req.rid, slo, prompt_len=len(req.prompt),
                                  now=req.t_enqueue)
            self.health.track(req.rid, slo, req.t_enqueue)

    # ------------------------------------------------------------------ #
    # SPMD transfer program (data plane + tier plane + control plane)
    # ------------------------------------------------------------------ #
    def _transfer_program(
        self,
        perm: Any,
        perm_swap: Optional[Tuple[Tuple[int, ...], ...]],
        perm_fetch: Optional[Tuple[int, ...]],
    ):
        block = self.block_elems
        P = gasnet.Perm

        def body(node, kvseg, inbox, acks, done, outflat, meta, page_meta,
                 done_meta, swap_meta, fetch_meta):
            has = meta[0, 0] > 0
            rid, slot, dst = meta[0, 1], meta[0, 2], meta[0, 3]
            # data plane: planned segmented split-phase puts
            handles = []
            if self.paged:
                # one pred-gated put per page PER HEAD SHARD, each shard
                # landing at the allocator's slot of its group member's
                # segment (the same offset on every member: the
                # partitions are congruent); ``perm`` holds one
                # permutation per shard; prefix-shared pages trace with
                # pred=False
                for s, pm in enumerate(perm):
                    for j in range(self.playout.n_pages):
                        hs, _ = kv_lib.push_block(
                            node, kvseg, outflat[0, s, j], to=P(pm),
                            base_index=page_meta[0, j, 0],
                            pred=has & (page_meta[0, j, 1] > 0),
                            plan=self.plan,
                        )
                        handles.extend(hs)
            else:
                handles, _ = kv_lib.push_block(
                    node, kvseg, outflat[0], to=P(perm),
                    base_index=slot * block, pred=has, plan=self.plan,
                )
            # tier plane: swap-out rides the vectored put (victim pages +
            # tier slot offsets in one command block, one put per replica
            # leg), swap-in the vectored get
            swap_handles = []
            fetch_handles = None
            if perm_swap is not None:
                for li, pm in enumerate(perm_swap):
                    hs, _ = tier_lib.swap_out_pages(
                        node, kvseg,
                        swap_meta[0, li, :, 0], swap_meta[0, li, :, 1],
                        to=P(pm), page_elems=self.playout.page_elems,
                        flags=swap_meta[0, li, :, 2], plan=self.swap_plan,
                    )
                    swap_handles.extend(hs)
            if perm_fetch is not None:
                fetch_handles, _ = pool_lib.fetch_pages(
                    node, kvseg, fetch_meta[0, :, 0], frm=P(perm_fetch),
                    page_elems=self.playout.page_elems, plan=self.swap_plan,
                    pred=fetch_meta[0, :, 2].max() > 0,
                )
            # control plane rides while the puts are in flight
            ackh = node.am_call(
                dst, "kv_ready", args=(rid, slot, node.my_id), pred=has,
                ack=lambda st: st["acks"],
            )
            for j in range(self.max_done):
                node.am_short(
                    done_meta[0, j, 1], "req_done",
                    args=(done_meta[0, j, 0],), pred=done_meta[0, j, 0] > 0,
                )
            landings = _merge_landings([node.defer(h) for h in handles])
            swaps = _merge_landings([node.defer(h) for h in swap_handles])
            fetched = ()
            if fetch_handles is not None:
                got = pool_lib.sync_fetch(node, fetch_handles)
                fetched = (got[None], fetch_meta[0, :, 1][None],
                           (fetch_meta[0, :, 2] > 0)[None])
            state = {"inbox": inbox[0], "acks": acks[0], "done": done[0]}
            state = node.am_flush(state)
            acked = node.sync(ackh)
            return (landings, swaps, fetched, state["inbox"][None],
                    acked[None], state["done"][None], node.dropped[None])

        return body

    def transfer_kernels(self, swap: bool, fetch: bool) -> Dict[str, int]:
        """The kernel launches of one run of :meth:`_transfer_program`
        (with a swap-out and a swap-in when ``swap`` / ``fetch``) on an
        engine map with a gascore member; none on an all-"xla" map, whose
        moves are torch indexing.  Each move of a put (payload, offset,
        flag), of a vectored put (payloads and command block as one) and
        of each leg of a vectored get is one ``perm_put`` of all ranks;
        each of the AM flush's two routes (request and reply) moves 5
        fields with n - 1 ``ring_shift`` each.  A paged push moves every
        page once per head shard (``tp`` times).  The TP groups' decode
        all-reduces are not transfer kernels: they run inside the decode
        step (``launch.serve._tp_paged_decode_fn``)."""
        if "gascore" not in self._backends:
            return {}
        seg = kv_lib.segment_bounds
        if self.paged:
            puts = self.tp * self.playout.n_pages * len(
                seg(self.shard_layout.page_elems, self.plan.n_segments))
            batches = len(seg(self.max_swap, self.swap_plan.n_segments))
        else:
            puts = len(seg(self.block_elems, self.plan.n_segments))
            batches = 0
        return {"perm_put": 3 * puts + swap * self.max_replicas * batches
                + 2 * fetch * batches,
                "ring_shift": 10 * (self.n - 1)}

    # ------------------------------------------------------------------ #
    # host scheduler
    # ------------------------------------------------------------------ #
    def _pick_target(
        self, taken: set, prompt: Optional[Any] = None
    ) -> Optional[Tuple[int, int]]:
        """(decode pool index, staging slot) with capacity, round-robin;
        paged mode also needs free pages for an unshared admission and
        prefers the rank holding the longest resident prompt prefix."""
        order = [(self._rr_decode + i) % self.n_groups
                 for i in range(self.n_groups)]
        if self.paged and prompt is not None:
            matches = {d: self.stores[d].prefix_match(prompt) for d in order}
            best = max(matches.values())
            if best > 0:
                # hard affinity: admitting elsewhere would re-ship pages
                # that already exist; a busy rank makes the request wait
                order = [d for d in order if matches[d] == best]
        for d in order:
            if d in taken:
                continue
            if self.paged:
                need = (self.playout.pages_for(len(prompt))
                        if prompt is not None else self.playout.n_pages)
                if self.stores[d].n_free < need:
                    continue
            for slot in range(self.n_slots):
                if slot not in self.staged[d]:
                    self._rr_decode = (d + 1) % self.n_groups
                    return d, slot
        return None

    def _admission_queue(self) -> List[Any]:
        """The submit queue in scheduler order (priority-major, EDF within
        a priority) when paged; FIFO otherwise."""
        if self.scheduler is None:
            return list(self.queue)
        pos = {rid: i for i, rid in enumerate(self.scheduler.admission_order())}
        return sorted(self.queue, key=lambda r: pos.get(r.rid, len(pos) + r.rid))

    def _run_prefills(self) -> None:
        """Assign queued requests to idle prefill workers (device compute)."""
        taken = {push[1] for push in self.pending_push if push is not None}
        order = self._admission_queue()
        for p in range(self.n_prefill):
            if self.pending_push[p] is not None or not order:
                continue
            req = order[0]
            target = self._pick_target(taken, prompt=req.prompt)
            if target is None:
                # oversubscribed: preempt for the head-of-order request
                if self.tier is not None:
                    self._try_preempt_for(req)
                return
            d, slot = target
            order.pop(0)
            self.queue.remove(req)
            tr = obs_trace.active()
            with tr.span("prefill", cat="req", rank=p, rid=req.rid,
                         prompt_len=len(req.prompt), group=d):
                toks = self._tensor(np.asarray(req.prompt, np.int32)[None])
                logits, caches_one = self._prefill_fn(
                    self.params, {"inputs": toks})
                tok = int(torch.argmax(logits[0].float()).item())
            if not req.out:  # a recompute-resume already holds its tokens
                req.out.append(tok)
                req.t_first = time.monotonic()
                if tr.enabled:
                    tr.instant("req_first_token", cat="req", rank=p,
                               rid=req.rid)
                if self.health is not None:
                    self.health.first_token(req.rid, req.t_first)
            if self.paged:
                # the allocator assigns the pages now (host control
                # plane); the payloads go one-sided into those slots,
                # each page pre-striped by heads for the group's members:
                # (tp, n_pages, shard_page_elems), the identity at tp=1
                pages = self.playout.flatten(caches_one)
                shards = (pages[:, self._cols].transpose(0, 1)
                          if self.tp > 1 else pages[None])
                plan = self.stores[d].plan_admit(req.prompt, lazy=True)
                self.stores[d].commit(req.rid, plan)
                self.pending_push[p] = (req, d, slot, shards, plan)
            else:
                header = torch.tensor([tok, len(req.prompt)], dtype=torch.int32)
                flat = torch.cat([header.view(torch.float32).to(self.device),
                                  self.layout.flatten(caches_one)])
                self.pending_push[p] = (req, d, slot, flat, None)
            self.staged[d][slot] = req.rid
            taken.add(d)

    # ------------------------------------------------------------------ #
    # tiered memory: preemption, swap staging, resume
    # ------------------------------------------------------------------ #
    def _try_preempt_for(self, req: Any) -> None:
        """Head-of-order request found no rank with pages: preempt victims
        on the rank that can reclaim enough.  Strictly-lower-priority
        victims always qualify; equal-priority victims only once the
        beneficiary's TTFT deadline has expired."""
        from repro_torch.serving.scheduler import SLO

        if self._swap_jobs or self._inflight_swap is not None:
            return  # one staged swap-out at a time
        need = self.playout.pages_for(len(req.prompt))
        slo = getattr(req, "slo", None) or SLO()
        expired = time.monotonic() > req.t_enqueue + slo.ttft_deadline_s
        for d in range(self.n_groups):
            shortage = need - self.stores[d].n_free
            if shortage <= 0:
                continue  # pages are not this rank's blocker (slots are)
            if all(s in self.staged[d] for s in range(self.n_slots)):
                continue  # no staging slot: freeing pages would not help
            running = [r.rid for r in self.decode_servers[d].active
                       if r is not None]
            victims = self.scheduler.pick_victims(
                running, shortage,
                lambda rid, d=d: self.stores[d].freeable(rid),
                beneficiary=req.rid, strict=not expired,
            )
            if victims:
                for rid in victims:
                    self._preempt(d, rid)
                return

    def _preempt(self, d: int, rid: int, mode: Optional[str] = None) -> None:
        """Evict one running request from decode rank ``d``: swap its
        pages to a memory rank (vectored-put job staged for the next
        transfer) or drop them for recompute-replay, per the β cost
        model unless ``mode`` names one."""
        server = self.decode_servers[d]
        store = self.stores[d]
        i = next(ix for ix, r in enumerate(server.active)
                 if r is not None and r.rid == rid)
        req = server.active[i]
        pos = int(server.positions[i])
        last = int(server.last_token[i, 0])
        n_mat = self.playout.pages_for(pos)
        self.scheduler.entry(rid).generated = max(0, len(req.out) - 1)
        chosen, swap_us, recompute_us = self.scheduler.choose_mode(rid, n_mat)
        mode = mode or chosen
        tr = obs_trace.active()
        if tr.enabled:
            tr.instant("req_preempt", cat="req", rank=self.decode_rank(d),
                       rid=rid, mode=mode, n_pages=n_mat,
                       swap_est_us=round(swap_us, 1),
                       recompute_est_us=round(recompute_us, 1))
        hold = None
        if mode == "swap":
            # hot (prefix-shared) pages get every tier replica
            want = 1
            if self.tier.replicas > 1 and (
                self.replicate_all_swaps or store.shared_page_count(rid) > 0
            ):
                want = self.tier.replicas
            try:
                store.materialize_through(rid, n_mat)
                hold = self.tier.plan_swap_out(rid, list(range(n_mat)),
                                               replicas=want)
            except (pool_lib.OutOfPagesError, tier_lib.OutOfSlotsError):
                mode = "recompute"  # no room to stage: drop and replay
        if mode == "swap":
            # the pool segment IS the victim's state: every page the
            # decode wrote went back to it at the end of its tick, so the
            # job ships the resident pages as they sit, once per leg
            table = store.page_table(rid)
            src = [table[lp] * self.playout.page_elems for lp in range(n_mat)]
            legs = tuple(
                (self.memory_rank(pl.rank),
                 [self.tier.slot_offset(pl.rank, s) for s in pl.slots])
                for pl in hold.placements
            )
            self._swap_jobs.append((rid, d, src, legs))
            self.swap_out_bytes += n_mat * self.playout.page_bytes * len(legs)
        else:
            store.evict_request(rid)
            self.queue.append(req)  # resume = re-prefill + replay
        replay = list(server.replaying.get(i, []))
        server.evict_row(i)
        self._preempted[rid] = {
            "mode": mode, "position": pos, "last_token": last,
            "n_mat": n_mat, "swapped": False,
            "replay": replay,  # a victim caught mid-replay keeps its tail
        }
        self.scheduler.on_preempted(rid, mode)

    def _decode_shortage(self, d: int, rid: int, need: int) -> bool:
        """A decode row's lazy page growth found rank ``d``'s pool dry:
        preempt victims for it.  False when no pages freed up *this tick*
        (a swap victim's pages free only once its put lands): the row
        stalls one tick and retries."""
        if self.scheduler is None:
            return False
        store = self.stores[d]
        if any(job[1] == d for job in self._swap_jobs) or (
            self._inflight_swap is not None and self._inflight_swap[1] == d
        ):
            return False  # pages are on their way: stall, don't ping-pong
        running = [r.rid for r in self.decode_servers[d].active
                   if r is not None and r.rid != rid]
        victims = self.scheduler.pick_victims(
            running, need - store.n_free,
            lambda v, d=d: store.freeable(v),
            beneficiary=rid, strict=False,
        )
        # no eligible victim: the growing row preempts itself
        for v in (victims or [rid]):
            self._preempt(d, v)
        return store.n_free >= need

    def _apply_decode_writes(self) -> None:
        """Write this tick's decode-written pages back into the pool
        segment (device to device), before any swap-out reads them —
        every member's head shard of them in a TP group.  Transfer
        targets are disjoint from decode write pages: admission puts and
        swap-in installs land only in freshly allocated pages, and
        swap-out destinations live on memory ranks."""
        for g, server in enumerate(self.decode_servers):
            rows = server.drain_dirty()
            if rows:
                idx = self._tensor(np.asarray(list(rows), np.int64))
                stacked = torch.stack(list(rows.values()))
                if self.tp > 1:  # (m, tp, shard_elems): one per member
                    for s, mem in enumerate(self.shard_mems[g]):
                        mem[idx] = stacked[:, s]
                else:
                    self.stores[g].mem[idx] = stacked

    def _run_resumes(self) -> None:
        """Stage swap-ins: a swapped-out request resumes onto the decode
        rank with room — one vectored-get job per tick."""
        if self.tier is None:
            return
        if self._fetch_jobs or self._inflight_fetch is not None:
            return
        for rid in self.scheduler.admission_order():
            snap = self._preempted.get(rid)
            if (snap is None or snap["mode"] != "swap" or not snap["swapped"]
                    or snap.get("staged") or rid in self._installable):
                continue
            hold = self.tier.holdings[rid]
            pl = self.tier.restore_placement(rid)
            # growth headroom: resuming on a page boundary needs a page
            # beyond the restored set for the first decode tick
            need = len(hold.logical)
            if snap["position"] % self.playout.page_tokens == 0:
                need += 1
            best = next((d for d in range(self.n_groups)
                         if self.stores[d].n_free >= need), None)
            if best is None:
                continue
            phys = self.stores[best].admit_resume(rid, hold.logical)
            remote = [self.tier.slot_offset(pl.rank, s) for s in pl.slots]
            local = [pp * self.playout.page_elems for pp in phys]
            self._fetch_jobs.append(
                (rid, best, remote, local, self.memory_rank(pl.rank)))
            snap["staged"] = True
            return

    def _install_resumed(self) -> None:
        """Bind restored requests to free decode rows: the swapped pages
        landed back in the pool at their new table slots, so the row
        resumes exactly at the preempted position."""
        for rid, d in list(self._installable.items()):
            server = self.decode_servers[d]
            snap = self._preempted[rid]
            req = self.by_rid[rid]
            if not server.admit_paged(req, first_token=snap["last_token"],
                                      position=snap["position"]):
                continue  # no free row yet; pages stay resident
            if snap.get("replay"):
                row = next(ix for ix, r in enumerate(server.active)
                           if r is not None and r.rid == rid)
                server.start_replay(row, snap["replay"])
            self.tier.release(rid)
            for s in self.stores:
                s.note_swap_in(rid)
            del self._installable[rid]
            del self._preempted[rid]
            self.scheduler.on_admitted(rid, time.monotonic())
            tr = obs_trace.active()
            if tr.enabled:
                tr.instant("req_resume", cat="req", rank=self.decode_rank(d),
                           rid=rid, position=snap["position"])

    def _launch_transfer(self) -> Optional[Tuple[Any, ...]]:
        """Build this tick's transfer inputs and run the SPMD program (the
        wire and the AM plane); the landing waits for the consume."""
        pushes = [(p, push) for p, push in enumerate(self.pending_push)
                  if push is not None]
        if (not pushes and not self._done_queue and not self._swap_jobs
                and not self._fetch_jobs):
            return None
        if self.paged:
            # one handoff permutation per head shard: prefill rank p's
            # shard-s slice goes to member s of its target group
            perm = tuple(
                kv_lib.handoff_permutation(
                    self.n, {p: self.member_rank(d, s)
                             for p, (_, d, _, _, _) in pushes})
                for s in range(self.tp))
        else:
            perm = kv_lib.handoff_permutation(
                self.n, {p: self.decode_rank(d) for p, (_, d, _, _, _) in pushes})
        # tier plane: at most one swap-out and one swap-in job per tick,
        # each its own completed bijection (decode rank -> memory rank)
        perm_swap = perm_fetch = None
        R = self.max_replicas
        swap_meta = np.zeros((self.n, R, self.max_swap, 3), np.int32)
        fetch_meta = np.zeros((self.n, self.max_swap, 3), np.int32)
        if self._swap_jobs:
            job = self._swap_jobs.pop(0)
            _, d, src, legs = job
            rank = self.decode_rank(d)
            perms = []
            for li, (mrank, dst) in enumerate(legs):
                for j, (s, t) in enumerate(zip(src, dst)):
                    swap_meta[rank, li, j] = (s, t, 1)
                perms.append(kv_lib.handoff_permutation(self.n, {rank: mrank}))
            # unused legs ship nothing (zero flags) along the identity
            while len(perms) < R:
                perms.append(kv_lib.handoff_permutation(self.n, {}))
            perm_swap = tuple(perms)
            self._inflight_swap = job
        if self._fetch_jobs:
            job = self._fetch_jobs.pop(0)
            _, d, remote, local, mrank = job
            rank = self.decode_rank(d)
            for j, (s, t) in enumerate(zip(remote, local)):
                fetch_meta[rank, j] = (s, t, 1)
            perm_fetch = kv_lib.handoff_permutation(self.n, {rank: mrank})
            self._inflight_fetch = job
        if self.paged:
            outflat = torch.zeros(
                (self.n, self.tp, self.playout.n_pages,
                 self.shard_layout.page_elems),
                dtype=torch.float32, device=self.device)
            page_meta = np.zeros((self.n, self.playout.n_pages, 2), np.int32)
        else:
            outflat = torch.zeros((self.n, self.block_elems),
                                  dtype=torch.float32, device=self.device)
            page_meta = np.zeros((self.n, 1, 2), np.int32)
        meta = np.zeros((self.n, 4), np.int32)
        self._inflight_pages = []
        for p, (req, d, slot, flat, aplan) in pushes:
            outflat[p] = flat
            meta[p] = (1, req.rid, slot, self.decode_rank(d))
            if self.paged:
                for j, (page_id, fresh) in enumerate(zip(aplan.table, aplan.fresh)):
                    # unmaterialised slots (lazy tail) park at offset 0,
                    # gated off like prefix-shared pages
                    page_meta[p, j] = (
                        max(page_id, 0) * self.shard_layout.page_elems,
                        1 if fresh else 0,
                    )
                self._inflight_pages.append(
                    (d, [pid for pid, f in zip(aplan.table, aplan.fresh) if f]))
            if not getattr(req, "_push_counted", False):
                req._push_counted = True
                self.kv_transfers += 1
                if self.paged:
                    self.kv_pages_sent += sum(aplan.fresh)
                    self.kv_pages_shared += sum(
                        1 for pid, f in zip(aplan.table, aplan.fresh)
                        if pid >= 0 and not f)
        done_meta = np.zeros((self.n, self.max_done, 2), np.int32)
        per_rank = [0] * self.n
        leftover: List[Tuple[int, int, int]] = []
        for d, rid_plus1, origin in self._done_queue:
            rank = self.decode_rank(d)
            j = per_rank[rank]
            if j < self.max_done:
                done_meta[rank, j] = (rid_plus1, origin)
                per_rank[rank] = j + 1
            else:
                leftover.append((d, rid_plus1, origin))
        self._done_queue = leftover
        tr = obs_trace.active()
        if tr.enabled:
            self._transfer_span = tr.begin_async(
                "kv_handoff", cat="transfer", pushes=len(pushes),
                done_reports=int(sum(per_rank)),
                swap=self._inflight_swap is not None,
                fetch=self._inflight_fetch is not None,
                est_us=round(self.plan.est_us, 1),
            )
        body = self._transfer_program(perm, perm_swap, perm_fetch)
        self.transfer_programs += 1
        for kernel, n in self.transfer_kernels(
                perm_swap is not None, perm_fetch is not None).items():
            self.metrics.counter(f"{kernel}_launches").inc(n)
        t = self._tensor
        return self.gas.spmd(
            body, self.kvseg, t(self.inbox), t(self.acks), t(self.done),
            outflat, t(meta), t(page_meta), t(done_meta), t(swap_meta),
            t(fetch_meta),
        )

    def _decode_step(self) -> None:
        """One continuous-batching tick on every decode server; collect
        newly finished requests as completion reports for the next
        transfer."""
        for d, server in enumerate(self.decode_servers):
            self.decoded_tokens += server.step()
            fresh = server.finished[self._finished_seen[d]:]
            self._finished_seen[d] = len(server.finished)
            for req in fresh:
                self.finished.append(req)
                if self.paged:
                    # drop the request's page references; prefix pages
                    # shared with live requests stay resident
                    self.stores[d].release(req.rid)
                    self.scheduler.on_done(req.rid)
                    self.health.retire(req.rid)
                origin = getattr(req, "origin_rank", 0)
                self._done_queue.append((d, req.rid + 1, origin))

    def _consume_transfer(self, results: Tuple[Any, ...]) -> None:
        landings, swaps, fetched, inbox, acks, done, dropped = results
        # the receivers land the payloads, in place, in issue order
        for cmd in landings:
            extended.land(self.kvseg, *cmd)
        for cmd in swaps:
            extended.land(self.kvseg, *cmd)
        if fetched:
            extended.land(self.kvseg, *fetched)
        sp = getattr(self, "_transfer_span", None)
        if sp is not None:
            self._transfer_span = None
            obs_trace.active().end_async(sp)
        # the AM rows cross to the host (writable copies: installs clear
        # inbox flags)
        self.inbox = inbox.cpu().numpy().copy()
        self.acks = acks.cpu().numpy().copy()
        self.done = done.cpu().numpy().copy()
        self.dropped_am += int(dropped.sum())
        for d, pages in self._inflight_pages:
            self.decode_servers[d].mark_stale(pages)
        self._inflight_pages = []
        # tier plane completions: a landed swap-out releases the victim's
        # pool pages (never before the bytes are safe in the memory rank);
        # a landed swap-in becomes installable into a decode row
        if self._inflight_swap is not None:
            rid, d, src, legs = self._inflight_swap
            self.stores[d].note_swap_out(rid, len(src), replicas=len(legs) - 1)
            self.stores[d].evict_request(rid)
            self._preempted[rid]["swapped"] = True
            self._inflight_swap = None
        if self._inflight_fetch is not None:
            rid, d, remote, local, _ = self._inflight_fetch
            self.decode_servers[d].mark_stale(
                [o // self.playout.page_elems for o in local])
            self._installable[rid] = d
            self.swap_in_bytes += len(remote) * self.playout.page_bytes
            self._inflight_fetch = None
        # prefill side: retire acknowledged pushes
        for p, push in enumerate(self.pending_push):
            if push is None:
                continue
            req, d, slot, _, _ = push
            if int(self.acks[p, slot]) == req.rid + 1:
                self.kv_acked += 1
                req.origin_rank = p
                self.pending_push[p] = None
        # decode side: install staged blocks into servers with free rows
        for d, server in enumerate(self.decode_servers):
            rank = self.decode_rank(d)
            for slot in range(self.n_slots):
                if not int(self.inbox[rank, slot, 0]):
                    continue
                rid = int(self.inbox[rank, slot, 1])
                req = self.by_rid.get(rid)
                if req is None or self.staged[d].get(slot) != rid:
                    continue
                if self._install(server, rank, slot, req):
                    self.inbox[rank, slot, 0] = 0
                    del self.staged[d][slot]

    def _install(self, server, rank: int, slot: int, req) -> bool:
        if self.paged:
            # bind the decode row straight to the page table: the pool is
            # the KV source of truth and every tick decodes through it
            ok = server.admit_paged(req, first_token=req.out[0],
                                    position=len(req.prompt))
            if ok:
                snap = self._preempted.get(req.rid)
                if snap is not None and snap["mode"] == "recompute":
                    # recompute-resume: replay the generated tokens to
                    # rebuild the KV bit-identically before continuing
                    row = next(ix for ix, r in enumerate(server.active)
                               if r is not None and r.rid == req.rid)
                    server.start_replay(row, req.out[1:])
                    del self._preempted[req.rid]
                self.scheduler.on_admitted(req.rid, time.monotonic())
            return ok
        block = self.kvseg[rank, slot * self.block_elems:
                           (slot + 1) * self.block_elems]
        tok, position = block[: self.HEADER].view(torch.int32).tolist()
        caches_one = self.layout.unflatten(block[self.HEADER:])
        return server.admit_prefilled(req, caches_one, first_token=tok,
                                      position=position)

    # ------------------------------------------------------------------ #
    # liveness
    # ------------------------------------------------------------------ #
    def _heartbeat(self) -> None:
        """Tick-clocked liveness: every rank beats once per tick (on a
        real cluster the beat is an AM to the coordinator); the monitor
        declares a silent rank dead after ``heartbeat_timeout`` ticks."""
        if not self.paged:
            return
        tr = obs_trace.active()
        for r in range(self.n):
            if self.beat_filter is not None and not self.beat_filter(
                    r, self._tick_no):
                if tr.enabled:
                    tr.instant("heartbeat_miss", cat="ft", rank=r)
                continue
            self.monitor.beat(r)
        for r in self.monitor.check():
            self._on_rank_failed(r)

    def _on_rank_failed(self, rank: int) -> None:
        raise _todo(
            f"recovery from the death of rank {rank} ({self.roles[rank]}) "
            "and its flight-recorder dump (item 8)", 7)

    def kill_rank(self, rank: int) -> None:
        raise _todo("fault injection (kill_rank)", 7)

    def join_decode_rank(self) -> int:
        raise _todo("elastic scale-out (join_decode_rank)", 7)

    # ------------------------------------------------------------------ #
    def tick(self) -> None:
        """One cluster tick: prefill (possibly preempting for the queue
        head), stage resumes, launch the transfer (admission puts + swap
        put + swap-in get + AM control plane), a decode step, consume the
        transfer (landings and AM rows), write the decode's pages back,
        install restored requests."""
        self._tick_no += 1
        tr = obs_trace.active()
        tr.set_tick(self._tick_no)
        if self.fault_hook is not None:
            self.fault_hook(self, "tick", self._tick_no)
        with tr.span("tick", cat="tick"):
            with tr.span("heartbeat", cat="tick_phase"):
                self._heartbeat()
            with tr.span("prefill", cat="tick_phase"):
                self._run_prefills()
            with tr.span("resume_stage", cat="tick_phase"):
                self._run_resumes()
            with tr.span("transfer_launch", cat="tick_phase"):
                results = self._launch_transfer()
            with tr.span("decode", cat="tick_phase"):
                self._decode_step()
            if self.fault_hook is not None:
                self.fault_hook(self, "pre_consume", self._tick_no)
            if results is not None:
                with tr.span("transfer_consume", cat="tick_phase"):
                    self._consume_transfer(results)
            with tr.span("install", cat="tick_phase"):
                if self.paged:
                    self._apply_decode_writes()
                if self.tier is not None:
                    self._install_resumed()
            if self.health is not None:
                with tr.span("health", cat="tick_phase"):
                    self.health.tick(
                        self._tick_no, time.monotonic(),
                        progress={r.rid: len(r.out)
                                  for s in self.decode_servers
                                  for r in s.active if r is not None},
                    )
                    if tr.enabled:
                        tr.instant("health_summary", cat="slo",
                                   line=self.health.render())

    def idle(self) -> bool:
        return (
            not self.queue
            and all(p is None for p in self.pending_push)
            and not any(self.staged)
            and not any(any(s.active) or s.queue for s in self.decode_servers)
            and not self._preempted
            and not self._swap_jobs
            and not self._fetch_jobs
            and not self._installable
            and self._inflight_swap is None
            and self._inflight_fetch is None
        )

    def _latencies(self) -> Tuple[List[float], List[float]]:
        """Per-request (latency, ttft): from the trace's lifecycle
        instants when tracing holds them all, else the request timers."""
        tr = obs_trace.active()
        if tr.enabled and self.finished:
            per = tr.request_stats()
            lat = [per[r.rid]["latency_s"] for r in self.finished
                   if r.rid in per and "latency_s" in per[r.rid]]
            ttft = [per[r.rid]["ttft_s"] for r in self.finished
                    if r.rid in per and "ttft_s" in per[r.rid]]
            if len(lat) == len(self.finished) == len(ttft):
                return lat, ttft
        lat = [r.t_done - r.t_enqueue for r in self.finished]
        ttft = [r.t_first - r.t_enqueue for r in self.finished]
        return lat, ttft

    def reset_metrics(self) -> None:
        """Zero the cluster's cumulative counters (scheduler and tier
        share the registry, so theirs clear too); gauges survive."""
        self.metrics.reset()

    def stats(self) -> Dict[str, Any]:
        """Cumulative counters and point-in-time gauges."""
        if self.paged:
            kv_bytes = self.kv_pages_sent * self.playout.page_bytes
        else:
            kv_bytes = self.kv_transfers * self.block_bytes
        stats = {
            "requests": len(self.finished),
            "decoded_tokens": self.decoded_tokens,
            "kv_transfers": self.kv_transfers,
            "kv_acked": self.kv_acked,
            "kv_bytes": kv_bytes,
            "kv_block_bytes": self.block_bytes,
            "kv_plan": self.plan.describe(),
            "completions_notified": int(self.done[: self.n_prefill].sum()),
            "am_dropped": self.dropped_am,
            "transfer_programs": self.transfer_programs,
            # the transfer programs' kernel launches, as scheduled by
            # transfer_kernels
            "transfer_launches": {
                k: int(self.metrics.counter(f"{k}_launches").value)
                for k in ("perm_put", "ring_shift")},
        }
        if self.paged:
            hits = sum(s.prefix_hits for s in self.stores)
            misses = sum(s.prefix_misses for s in self.stores)
            hit_rate = hits / (hits + misses) if hits + misses else 0.0
            free_pages = sum(s.n_free for s in self.stores)
            self.metrics.gauge("pool_free_pages").set(free_pages)
            self.metrics.gauge("prefix_hit_rate").set(hit_rate)
            stats.update({
                "paged": True,
                "tp": self.tp,
                "n_decode_groups": self.n_groups,
                "page_tokens": self.playout.page_tokens,
                "page_bytes": self.playout.page_bytes,
                "pages_per_rank": self.pages_per_rank,
                "kv_pages_sent": self.kv_pages_sent,
                "kv_pages_shared": self.kv_pages_shared,
                "prefix_hit_rate": hit_rate,
                "pool_free_pages": free_pages,
                "decode_paged_steps": sum(
                    s.paged_decode_steps for s in self.decode_servers),
                "heartbeat_failed": list(self.monitor.failed),
            })
            stats.update(self.scheduler.stats())
            stats["slo_violations"] = int(
                self.metrics.counter("slo_violations").value)
            stats["health"] = dict(self.health.last_summary)
            if self.tier is not None:
                stats.update(self.tier.stats())
                stats.update({
                    "n_memory_ranks": self.n_memory,
                    "swap_out_bytes": self.swap_out_bytes,
                    "swap_in_bytes": self.swap_in_bytes,
                    "swap_plan": self.swap_plan.describe(),
                })
        return stats

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[str, Any]:
        t0 = time.monotonic()
        ticks = 0
        while not self.idle() and ticks < max_ticks:
            self.tick()
            ticks += 1
        # final flushes so the last completions reach their origin ranks
        # (bounded: an unacknowledged push must not spin forever)
        for _ in range(2 * self.n + 2):
            results = self._launch_transfer()
            if results is None:
                break
            self._consume_transfer(results)
        dt = time.monotonic() - t0
        lat, ttft = self._latencies()
        stats = self.stats()
        stats.update({
            "wall_s": dt,
            "ticks": ticks,
            "tok_per_s": self.decoded_tokens / dt if dt else 0.0,
            "p50_latency_s": float(np.median(lat)) if lat else 0.0,
            "p99_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "p50_ttft_s": float(np.median(ttft)) if ttft else 0.0,
            "kv_bytes_per_s": stats["kv_bytes"] / dt if dt else 0.0,
        })
        return stats
