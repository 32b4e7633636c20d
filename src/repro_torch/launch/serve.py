"""Colocated serving of the port: dense and paged continuous batching.

Counterpart of ``repro.launch.serve`` for ``--role decode [--paged]``.
Request lifecycle: queued -> prefilled (KV cache assigned) -> decoding in
the fixed-width decode batch -> finished (EOS or max tokens) -> row
recycled for the next queued request.  The decode step runs the whole
batch; per-row positions let rows be at different generation depths.

- :class:`Server` keeps a dense cache row per request: attention KV
  rings and, for falcon-mamba-7b and recurrentgemma-9b, the recurrent
  states (conv windows, SSM and RG-LRU states).  Their prefill runs the
  hand-written scan kernels on the card.
- :class:`PagedServer` keeps the KV cache in the paged pool
  (``repro_torch.serving.pool``): pages allocated lazily per request,
  prompt prefixes shared by page table, SLO-aware preemption with swap
  to a host memory tier or recompute.  Its decode step runs THROUGH the
  page table, with attention on the hand-written CUDA kernel on the card.
  It serves the archs of ``global``, ``dense`` and ``moe`` blocks
  (qwen3-4b, kimi-k2-1t-a32b, arctic-480b); every ``moe`` layer of every
  forward, in either server, routes its tokens on the hand-written
  router kernel on the card.

- :class:`PooledDecodeServer` decodes from an external pool shard: the
  decode side of the disaggregated cluster
  (``repro_torch.serving.disagg``).
- :class:`TPPagedServer` and :class:`TPPooledDecodeServer` run the paged
  decode over a tensor-parallel group of ``tp`` GAS ranks
  (``repro_torch.parallel.tp``): heads and MLP columns sharded per rank,
  each rank's pool holding its heads' slice of every page, one planned
  all-reduce per sub-block (``core.sched``) on the group's engine.  All
  ranks live on the one device, their shards stacked.

Run: ``python -m repro_torch.launch.serve --role decode --paged``
(``--arch`` any of the ten archs: kimi-k2-1t-a32b, arctic-480b,
granite-34b and llama3-405b page too; falcon-mamba-7b,
recurrentgemma-9b, gemma3-27b and llama-3.2-vision-11b without
``--paged``, as their blocks cannot be paged and ``--paged`` raises;
seamless-m4t-medium, an encoder-decoder, runs ``Model.prefill`` with
seeded frames and greedy ``Model.decode_step``s instead of a server);
``--role both [--paged] [--n-memory 1]`` runs the disaggregated cluster;
``--tp 2`` serves the paged decode over a tensor-parallel group (with
``--role decode --paged``, or decode groups of the cluster)
(``--device cpu`` runs on the CPU, with the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_device, tree_leaves, tree_map
from repro_torch.obs import trace as obs_trace


# block kinds whose caches have no token axis to page (recurrent states),
# a ring the paged path cannot address (sliding windows) or a
# cross-attention sub-block (the reference's paged decode raises on it);
# ``global``, ``dense`` and ``moe`` blocks page their attention KV
UNPAGED_KINDS = frozenset({"local", "mamba", "rec", "cross", "xdec"})


def _paged_decode_views_fn(model, ctx, layout, device):
    """The colocated paged decode step: the pool stays resident on the
    device in *decode-views* form (the per-layer page-pool tree) across
    ticks, so a steady-state step runs zero carrier repacks.

    The reference donates the views buffers to its jitted step; the port
    updates them IN PLACE instead — the scratch-page wipe and the
    per-layer token scatter write the resident pools where they lie, and
    the returned views are the same tensors."""
    empty_views = layout.decode_views(
        torch.from_numpy(layout.empty_page_row()[None]).to(device)
    )

    def step(params, token, positions, views, tables):
        # wipe the scratch page (page axis 1 of every (L, P, T, ...) pool):
        # dead rows and unmaterialised slots scattered garbage into it
        for pool, init in zip(tree_leaves(views), tree_leaves(empty_views)):
            pool[:, -1] = init[:, 0]
        return model.decode_step_paged(
            params, ctx, token, positions, views, tables
        )

    return step


def _pool_patch_fn(layout):
    """Device-side pool patch for the views-resident pool: scatter ``rows``
    (fresh page payloads — admissions, lazy materialisations) at
    ``write_dst`` and duplicate ``copy_src -> copy_dst`` (COW splits), in
    place, without round-tripping the whole pool through the host.
    Writes land before copies: a copy source may be a page written this
    very tick."""

    def patch(views, write_dst, rows, copy_src, copy_dst):
        rowviews = layout.decode_views(rows)
        for pool, rv in zip(tree_leaves(views), tree_leaves(rowviews)):
            if write_dst.numel():
                pool[:, write_dst] = rv
            if copy_src.numel():
                pool[:, copy_dst] = pool[:, copy_src]
        return views

    return patch


def _pool_write_need(store, layout, rid: int, position: int) -> int:
    """Fresh pages the next decode write needs: one when the position
    lands on an unmaterialised slot (lazy growth) or a shared page
    (copy-on-write split), none otherwise."""
    table = store.tables[rid]
    p = table[position // layout.page_tokens]
    if p < 0:
        return 1
    return 1 if store.state.refcnt[p] > 1 else 0


def _to_host(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    t_enqueue: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    slo: Any = None  # Optional[repro_torch.serving.scheduler.SLO]


class Server:
    """Fixed-decode-batch continuous batching over Model prefill/decode.

    ``params`` must live on ``device`` (CUDA unless the caller passes
    another device)."""

    def __init__(self, model, ctx, params, batch_size: int, cache_len: int,
                 eos_id: int = -1, device: Any = None):
        if model.cfg.n_enc_layers:  # the reference fails at the first prefill
            raise ValueError(
                f"{model.cfg.name} is an encoder-decoder: a request needs its "
                "encoder frames, which the server's token-only prefill does "
                "not carry; run Model.prefill with batch['frames'] and "
                "Model.decode_step")
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(
                    f"parameters on {leaf.device}, server on {self.device}"
                )
        self.model = model
        self.ctx = ctx
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.eos_id = eos_id

        # rank attributed to this server's trace events
        self.trace_rank: Optional[int] = None
        # called as on_step(server, live rows, host logits) at every decode
        # step, before the live rows' tokens advance (None: no hook)
        self.on_step: Optional[Callable[[Any, List[int], np.ndarray],
                                        None]] = None
        self.active: List[Optional[Request]] = [None] * batch_size
        self.positions = np.zeros((batch_size,), np.int32)
        self.last_token = np.zeros((batch_size, 1), np.int32)
        self.caches = None  # lazily built from first prefill
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        # slot -> remaining tokens a recompute-resume must replay: the
        # decode path reproduces them bit-identically (same ops, same
        # inputs), rebuilding the KV cache without re-appending output
        self.replaying: Dict[int, List[int]] = {}

        self._decode = lambda p, t, pos, c: model.decode_step(p, ctx, t, pos, c)
        self._prefill_one = lambda p, b: model.prefill(
            p, ctx, b, cache_len=cache_len
        )

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        req.t_enqueue = time.monotonic()
        tr = obs_trace.active()
        if tr.enabled:
            tr.instant("req_submit", cat="req", rank=self.trace_rank,
                       rid=req.rid, prompt_len=len(req.prompt))
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _write_row(self, caches_one, slot: int) -> None:
        """Insert a single-request cache into batch row ``slot``."""
        if self.caches is None:
            # build an empty batched cache from the single-row structure
            self.caches = tree_map(
                lambda x: torch.zeros((x.shape[0], self.B) + tuple(x.shape[2:]),
                                      dtype=x.dtype, device=x.device),
                caches_one,
            )
        for full, one in zip(tree_leaves(self.caches), tree_leaves(caches_one)):
            full[:, slot] = one[:, 0]

    def admit_prefilled(
        self, req: Request, caches_one, first_token: int, position: int
    ) -> bool:
        """Install a prefilled request in a free decode row.  Returns False
        when no decode row is free."""
        slot = self._free_slot()
        if slot is None:
            return False
        self._bind(req, slot, first_token, position)
        self._write_row(caches_one, slot)
        return True

    def _bind(self, req: Request, slot: int, first_token: int,
              position: int) -> None:
        """Seat an admitted request in decode row ``slot``."""
        if not req.out:
            req.out.append(int(first_token))
        tr = obs_trace.active()
        if not req.t_first:
            req.t_first = time.monotonic()
            if tr.enabled:
                tr.instant("req_first_token", cat="req",
                           rank=self.trace_rank, rid=req.rid)
        if tr.enabled:
            tr.instant("req_admit", cat="req", rank=self.trace_rank,
                       rid=req.rid, slot=slot, position=position)
        self.active[slot] = req
        self.positions[slot] = position
        self.last_token[slot, 0] = int(first_token)

    def _prefill(self, req: Request):
        toks = self._tensor(np.asarray(req.prompt, np.int32)[None])
        logits, caches_one = self._prefill_one(self.params, {"inputs": toks})
        return int(np.argmax(_to_host(logits)[0])), caches_one

    def _admit(self) -> None:
        while self.queue:
            if self._free_slot() is None:
                return
            req = self.queue.pop(0)
            tok, caches_one = self._prefill(req)
            self.admit_prefilled(
                req, caches_one, first_token=tok, position=len(req.prompt)
            )

    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        if req is None:  # already retired this step (eos at the cache cap)
            return
        req.t_done = time.monotonic()
        tr = obs_trace.active()
        if tr.enabled:
            tr.instant("req_retire", cat="req", rank=self.trace_rank,
                       rid=req.rid, tokens=len(req.out))
        self.finished.append(req)
        self.active[slot] = None
        self._release(req)

    def evict_row(self, slot: int) -> Optional[Request]:
        """Remove a request from its decode row WITHOUT retiring it (the
        preemption path): the caller owns its KV state and re-admits it
        later.  No release hook runs."""
        req = self.active[slot]
        self.active[slot] = None
        self.replaying.pop(slot, None)
        return req

    def start_replay(self, slot: int, tokens: List[int]) -> None:
        """Arm a recompute-resume: the next ``len(tokens)`` decode steps
        on ``slot`` rebuild the KV cache by re-deriving exactly those
        tokens (asserted — the decode path is deterministic), without
        re-appending them to the request's output."""
        if tokens:
            self.replaying[slot] = list(tokens)

    def _release(self, req: Request) -> None:
        """Called when a request leaves its decode row."""

    def _advance(self, live: List[int], logits: np.ndarray) -> None:
        """Shared post-decode token handling: append/advance each live
        row, replaying preempted-and-recomputed rows without appending."""
        if self.on_step is not None:
            self.on_step(self, live, logits)
        for i in live:
            req = self.active[i]
            tok = int(np.argmax(logits[i]))
            replay = self.replaying.get(i)
            if replay:
                expect = replay.pop(0)
                if tok != expect:
                    raise AssertionError(
                        f"recompute replay diverged on rid {req.rid}: "
                        f"step produced {tok}, original was {expect}"
                    )
                if not replay:
                    del self.replaying[i]
                self.positions[i] += 1
                self.last_token[i, 0] = tok
                continue  # the token is already in req.out
            req.out.append(tok)
            self.positions[i] += 1
            self.last_token[i, 0] = tok
            if tok == self.eos_id or len(req.out) >= req.max_new:
                self._retire(i)
            if self.positions[i] >= self.cache_len - 1:
                self._retire(i)

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """One scheduler tick: admit, decode one token for all rows.
        Subclasses override :meth:`_step`; this wrapper is the single
        place every server's tick gets its ``decode_step`` span."""
        tr = obs_trace.active()
        if not tr.enabled:
            return self._step()
        with tr.span("decode_step", cat="decode", rank=self.trace_rank) as sp:
            n = self._step()
            sp.args["live"] = n
            return n

    def _step(self) -> int:
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live or self.caches is None:
            return 0
        logits, self.caches = self._decode(
            self.params,
            self._tensor(self.last_token),
            self._tensor(self.positions),
            self.caches,
        )
        self._advance(live, _to_host(logits))
        return len(live)

    def _pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[str, Any]:
        t0 = time.monotonic()
        decoded = 0
        ticks = 0
        while self._pending() and ticks < max_ticks:
            decoded += self.step()
            ticks += 1
        dt = time.monotonic() - t0
        lat = [r.t_done - r.t_enqueue for r in self.finished]
        ttft = [r.t_first - r.t_enqueue for r in self.finished]
        return {
            "requests": len(self.finished),
            "decoded_tokens": decoded,
            "wall_s": dt,
            "tok_per_s": decoded / dt if dt else 0.0,
            "p50_latency_s": float(np.median(lat)) if lat else 0.0,
            "p50_ttft_s": float(np.median(ttft)) if ttft else 0.0,
        }


class PagedServer(Server):
    """Continuous batching over the paged KV pool with SLO-aware
    preemptive scheduling over a tiered KV memory.

    Each admitted request gets fixed-size token *pages* from a refcounted
    pool, freed when it retires; requests sharing a prompt prefix resolve
    to the *same physical pages* (copy-on-write protected).  The decode
    step runs THROUGH the page table: the new token's K/V scatter straight
    into the pool and attention is the paged-attention kernel over the
    physical pages.  Admission is **lazy** (only prompt pages materialise;
    the generation tail allocates page by page), so the pool
    *oversubscribes*: when the free list runs dry the
    :class:`~repro_torch.serving.scheduler.AdmissionScheduler` preempts
    victims — swap (pages copied to the host
    :class:`~repro_torch.serving.tier.MemoryTier`, restored bit-exactly) or
    recompute (pages dropped; resume replays the generated tokens).

    Token parity with :class:`Server` — pressured or not — is the
    correctness bar.
    """

    def __init__(self, model, ctx, params, batch_size: int, cache_len: int,
                 eos_id: int = -1, device: Any = None, page_tokens: int = 8,
                 n_pool_pages: Optional[int] = None,
                 decode_step_us: float = 2000.0, prefill_us: float = 4000.0,
                 health: Optional[Any] = None):
        unpaged = sorted(set(model.cfg.layer_kinds()) & UNPAGED_KINDS)
        if unpaged:  # the reference fails here too (no token axis to page)
            raise ValueError(
                f"paged decode unsupported for {unpaged} blocks: serve "
                f"{model.cfg.name} through the dense Server"
            )
        super().__init__(model, ctx, params, batch_size, cache_len,
                         eos_id=eos_id, device=device)
        from repro_torch.serving.pool import PagedKVStore, PagedLayout
        from repro_torch.serving.scheduler import AdmissionScheduler
        from repro_torch.serving.tier import MemoryTier

        self.layout = PagedLayout.from_struct(
            model.kv_block_struct(ctx, prompt_len=4, cache_len=cache_len),
            cache_len=cache_len, page_tokens=page_tokens,
        )
        if n_pool_pages is None:
            n_pool_pages = (batch_size + 1) * self.layout.n_pages
        self.store = PagedKVStore(self.layout, n_pool_pages)
        tier_slots = max(n_pool_pages, batch_size * self.layout.n_pages)
        self.tier = MemoryTier(
            1, tier_slots, self.layout.page_elems, host_backed=True
        )
        self.scheduler = AdmissionScheduler(
            page_bytes=self.layout.page_bytes,
            decode_step_us=decode_step_us, prefill_us=prefill_us,
        )
        # live SLO monitor (``obs.health.HealthMonitor``): tracked per
        # submit, ticked per step; with its backpressure on, the scheduler
        # defers below-floor admissions while deadlines are at risk.
        # Inert (risk 0) for requests without finite deadlines.
        self.health = health
        self._tick_no = 0
        if health is not None and getattr(health, "backpressure", False):
            self.scheduler.attach_health(health)
        self._by_rid: Dict[int, Request] = {}
        self._preempted: Dict[int, Dict[str, Any]] = {}
        self._decode_paged = _paged_decode_views_fn(
            model, ctx, self.layout, self.device
        )
        # device-resident pool in decode-views form (each per-layer pool
        # has P+1 rows, scratch last), kept across ticks; None whenever
        # the host mirror is authoritative
        self._dev_views = None
        # live high-water mark of page-table width (monotonic)
        self._table_width = 1
        # host-side page mutations queued for the device-resident pool:
        # fresh payload rows and COW src->dst splits, applied before the
        # next decode step (or before any host sync)
        self._patch = _pool_patch_fn(self.layout)
        self._pending_rows: Dict[int, np.ndarray] = {}
        self._pending_copies: List[tuple] = []
        self.paged_decode_steps = 0

    def _apply_pending(self) -> None:
        """Flush queued page writes/copies into the device-resident pool."""
        rows = list(self._pending_rows.items())
        copies = list(self._pending_copies)
        self._pending_rows.clear()
        self._pending_copies.clear()
        idx = lambda xs: self._tensor(np.asarray(xs, np.int64))
        wd = idx([pg for pg, _ in rows])
        wr = self._tensor(
            np.stack([r for _, r in rows]) if rows
            else np.zeros((0, self.layout.page_elems), np.float32)
        )
        cs = idx([s for s, _ in copies])
        cd = idx([d for _, d in copies])
        self._dev_views = self._patch(self._dev_views, wd, wr, cs, cd)

    def _sync_host(self) -> None:
        """Land the device-resident pool back in the host mirror before
        any host-side read or write of page payloads (swap staging,
        resume restores).  Queued page patches flush to the device first
        so the download is complete.  The device copy is dropped; the
        next decode step re-uploads the mutated mirror."""
        if self._dev_views is not None:
            if self._pending_rows or self._pending_copies:
                self._apply_pending()
            P = self.store.state.n_pages
            mem = self.layout.views_to_pool(self._dev_views)
            self.store.mem[:] = mem[:P].cpu().numpy()
            self._dev_views = None

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        from repro_torch.serving.scheduler import SLO

        super().submit(req)
        self._by_rid[req.rid] = req
        self.scheduler.submit(
            req.rid, req.slo or SLO(), prompt_len=len(req.prompt),
            now=req.t_enqueue,
        )
        if self.health is not None:
            self.health.track(req.rid, req.slo or SLO(), req.t_enqueue)

    def _pending(self) -> bool:
        return super()._pending() or bool(self._preempted)

    # ------------------------------------------------------------------ #
    # capacity management: preemption + tiered swap
    # ------------------------------------------------------------------ #
    def _running_rids(self) -> List[int]:
        return [r.rid for r in self.active if r is not None]

    def _slot_of(self, rid: int) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is not None and r.rid == rid:
                return i
        return None

    def _freeable(self, rid: int) -> int:
        return self.store.freeable(rid)

    def _write_need(self, rid: int, position: int) -> int:
        return _pool_write_need(self.store, self.layout, rid, position)

    def _preempt(self, rid: int, mode: Optional[str] = None) -> None:
        from repro_torch.serving import tier as tier_lib

        self._sync_host()  # swap staging reads page payloads
        slot = self._slot_of(rid)
        req = self._by_rid[rid]
        table = self.store.page_table(rid)
        logical = [lp for lp, pp in enumerate(table) if pp >= 0]
        chosen, swap_us, rec_us = self.scheduler.choose_mode(rid, len(logical))
        if mode is None:
            mode = chosen
        tr = obs_trace.active()
        if tr.enabled:
            tr.instant(
                "req_preempt", cat="req", rank=self.trace_rank, rid=rid,
                mode=mode, n_pages=len(logical),
                swap_est_us=round(swap_us, 1),
                recompute_est_us=round(rec_us, 1),
            )
        if mode == "swap":
            try:
                self.tier.plan_swap_out(rid, logical)
            except tier_lib.OutOfSlotsError:
                mode = "recompute"  # tier full: drop and replay instead
        if mode == "swap":
            rows = np.stack([self.store.mem[table[lp]] for lp in logical])
            self.tier.host_store(rid, rows)
        snap = {
            "mode": mode,
            "logical": tuple(logical),
            "position": int(self.positions[slot]),
            "last_token": int(self.last_token[slot, 0]),
            # a victim caught mid-replay must finish its replay after a
            # swap-resume (evict_row drops the row's replay state)
            "replay": list(self.replaying.get(slot, [])),
        }
        self.store.evict_request(rid)
        self.evict_row(slot)
        self._preempted[rid] = snap
        # keep the β model honest: replayed tokens are not new generation
        self.scheduler.entry(rid).generated = max(0, len(req.out) - 1)
        self.scheduler.on_preempted(rid, mode)

    def _make_room(self, need: int, beneficiary: int, strict: bool) -> bool:
        """Free at least ``need`` pool pages by preempting victims chosen
        by the scheduler; False when no eligible victim set suffices."""
        while self.store.n_free < need:
            victims = self.scheduler.pick_victims(
                self._running_rids(), need - self.store.n_free,
                self._freeable, beneficiary=beneficiary, strict=strict,
            )
            if not victims:
                return False
            for rid in victims:
                self._preempt(rid)
        return True

    # ------------------------------------------------------------------ #
    # admission + resume (scheduler-ordered)
    # ------------------------------------------------------------------ #
    def _bind_row(
        self, req: Request, slot: int, position: int, last_token: int
    ) -> None:
        tr = obs_trace.active()
        if not req.t_first:
            req.t_first = time.monotonic()
            if tr.enabled:
                tr.instant("req_first_token", cat="req",
                           rank=self.trace_rank, rid=req.rid)
            if self.health is not None:
                self.health.first_token(req.rid, req.t_first)
        if tr.enabled:
            tr.instant("req_admit", cat="req", rank=self.trace_rank,
                       rid=req.rid, slot=slot, position=position)
        self.active[slot] = req
        self.positions[slot] = position
        self.last_token[slot, 0] = int(last_token)

    def _prefill_pages(self, req: Request):
        tok, caches_one = self._prefill(req)
        return tok, self.layout.flatten(caches_one).cpu().numpy()

    def _resume(self, rid: int, slot: int) -> bool:
        st = self._preempted[rid]
        req = self._by_rid[rid]
        self._sync_host()  # restores / re-prefills write page payloads
        if st["mode"] == "swap":
            if self.store.n_free < len(st["logical"]):
                return False
            phys = self.store.admit_resume(rid, st["logical"])
            rows = self.tier.host_load(rid)
            self.tier.release(rid)
            for row, pp in zip(rows, phys):
                self.store.mem[pp] = row
            self._bind_row(req, slot, st["position"], st["last_token"])
            self.start_replay(slot, st.get("replay", []))
        else:  # recompute: re-prefill the prompt, replay the generation
            if self.store.n_free < self.layout.pages_for(len(req.prompt)):
                return False
            _, pages = self._prefill_pages(req)
            plan = self.store.plan_admit(req.prompt, lazy=True)
            self.store.write_pages(plan, pages)
            self.store.commit(rid, plan)
            self._bind_row(req, slot, len(req.prompt), req.out[0])
            self.start_replay(slot, req.out[1:])
        del self._preempted[rid]
        tr = obs_trace.active()
        if tr.enabled:
            tr.instant("req_resume", cat="req", rank=self.trace_rank,
                       rid=rid, slot=slot, mode=st["mode"])
        self.scheduler.on_admitted(rid, time.monotonic())
        return True

    def _admit(self) -> None:
        for rid in self.scheduler.admission_order():
            slot = self._free_slot()
            if slot is None:
                return
            if rid in self._preempted:
                self._resume(rid, slot)
                continue
            req = self._by_rid.get(rid)
            if req is None or req not in self.queue:
                continue
            need = self.layout.pages_for(len(req.prompt))
            if self.store.n_free < need and not self._make_room(
                need, rid, strict=True
            ):
                continue
            self.queue.remove(req)
            tok, pages = self._prefill_pages(req)
            plan = self.store.plan_admit(req.prompt, lazy=True)
            self.store.write_pages(plan, pages)
            self.store.commit(req.rid, plan)
            if self._dev_views is not None:
                # the pool stays device-resident across admissions: queue
                # only the fresh prompt pages as patches
                for page_id, is_fresh in zip(plan.table, plan.fresh):
                    if is_fresh:
                        self._pending_rows[page_id] = self.store.mem[
                            page_id
                        ].copy()
            if not req.out:
                req.out.append(tok)
            self._bind_row(req, slot, len(req.prompt), req.out[0])
            self.scheduler.on_admitted(rid, time.monotonic())

    # ------------------------------------------------------------------ #
    # the end-to-end paged decode step
    # ------------------------------------------------------------------ #
    def _step(self) -> int:
        self._admit()
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        # write capacity row by row: lazy materialisation / COW splits may
        # need fresh pages — the oversubscription pressure point.  A row
        # that cannot get one (even after preempting eligible victims)
        # self-preempts and resumes once pages free up.
        from repro_torch.serving.pool import UNMATERIALIZED

        for i in list(live):
            req = self.active[i]
            if req is None:
                continue  # already evicted by an earlier row's make_room
            need = self._write_need(req.rid, int(self.positions[i]))
            if need and self.store.n_free < need:
                if not self._make_room(need, req.rid, strict=False):
                    self._preempt(req.rid)
                    continue
            pos = int(self.positions[i])
            if need and self._dev_views is not None:
                # materialisation / COW split mutates page payloads: mirror
                # the host-side write as a device patch
                before = self.store.tables[req.rid][pos // self.layout.page_tokens]
                dst = self.store.prepare_write(req.rid, pos)
                if before == UNMATERIALIZED:
                    self._pending_rows[dst] = np.asarray(
                        self.layout.empty_page_row()
                    )
                elif dst != before:  # COW split: clone the shared payload
                    self._pending_copies.append((int(before), int(dst)))
            else:
                self.store.prepare_write(req.rid, pos)
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        # device tables: unmaterialised slots (and dead rows) target the
        # scratch page past the pool — always masked by lengths.  The
        # width is the batch's live high-water mark in 4-page buckets, so
        # paged attention reads only pages a request can occupy.
        P = self.store.state.n_pages
        T = self.layout.page_tokens
        need = max(int(self.positions[i]) // T + 1 for i in live)
        need = min(self.layout.n_pages, -(-need // 4) * 4)  # 4-page buckets
        self._table_width = max(self._table_width, need)
        tables = np.full((self.B, self._table_width), P, np.int32)
        for i in live:
            row = self.store.device_table(self.active[i].rid, absent=P)
            tables[i] = row[: self._table_width]
        logits = self._decode_via_tables(tables)
        for i in live:
            if i not in self.replaying:  # replays are not new generation
                self.scheduler.on_step(self.active[i].rid)
        self._advance(live, logits)
        return len(live)

    def profile_decode(self, profiler, iters: int = 6,
                       warmup: int = 2) -> Optional[float]:
        """Offline timing of the paged decode step over the server's
        *current* page tables (width rounded up to 4-page buckets, as a
        step's), by ``profiler.profile`` (a ``repro_torch.obs.profile.
        DeviceProfiler``).  The step's inputs are staged on the device
        once, so a timed call is the step's device work alone (on the
        card no host copy waits inside it).  Re-execution is idempotent:
        the step rewrites the same K/V slots from the same tokens and
        positions, and its logits are discarded.  Never called on the
        serving path.  Returns the best microseconds, or None when no row
        is live."""
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return None
        P = self.store.state.n_pages
        T = self.layout.page_tokens
        need = max(int(self.positions[i]) // T + 1 for i in live)
        need = min(self.layout.n_pages, -(-need // 4) * 4)
        width = max(self._table_width, need)
        tables = np.full((self.B, width), P, np.int32)
        for i in live:
            tables[i] = self.store.device_table(
                self.active[i].rid, absent=P)[:width]
        inputs = self._decode_inputs(tables)
        return profiler.profile(
            "paged_decode_step", lambda: self._decode_device(*inputs),
            iters=iters, warmup=warmup, live=len(live), table_width=width,
        )

    def _decode_inputs(self, tables: np.ndarray):
        """The decode step's per-step inputs on the device: the last
        tokens, the positions and the page tables."""
        return (self._tensor(self.last_token), self._tensor(self.positions),
                self._tensor(tables))

    def _decode_device(self, token, positions, tables) -> torch.Tensor:
        """Upload the pool when host-resident, flush queued page patches,
        run the paged decode; returns the device logits."""
        if self._dev_views is None:  # (re-)upload the mutated host mirror
            mem = np.concatenate(
                [self.store.mem, self.layout.empty_page_row()[None]], axis=0
            )
            self._dev_views = self.layout.decode_views(self._tensor(mem))
        if self._pending_rows or self._pending_copies:
            self._apply_pending()
        logits, self._dev_views = self._decode_paged(
            self.params, token, positions, self._dev_views, tables)
        return logits

    def _decode_via_tables(self, tables: np.ndarray) -> np.ndarray:
        """One paged decode step through ``tables``; returns host logits."""
        logits = self._decode_device(*self._decode_inputs(tables))
        self.paged_decode_steps += 1
        return _to_host(logits)

    # ------------------------------------------------------------------ #
    def step(self) -> int:
        n = super().step()
        if self.health is not None:
            self._tick_no += 1
            self.health.tick(
                self._tick_no, time.monotonic(),
                progress={r.rid: len(r.out)
                          for r in self.active if r is not None},
            )
        return n

    def _release(self, req: Request) -> None:
        self.store.release(req.rid)
        if req.rid in self._by_rid:
            self.scheduler.on_done(req.rid)
        if self.health is not None:
            self.health.retire(req.rid)

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[str, Any]:
        stats = super().run_until_drained(max_ticks)
        self._sync_host()  # callers may inspect the pool post-drain
        stats.update({f"pool_{k}": v for k, v in self.store.stats().items()})
        stats.update(self.tier.stats())
        stats.update(self.scheduler.stats())
        return stats


class PooledDecodeServer(Server):
    """Decode server whose KV lives in an EXTERNAL paged store — the
    disaggregated cluster's per-rank pool shard.

    Rows are bound to page tables by rid (:meth:`admit_paged`); no dense
    cache row is ever built, and every tick decodes through
    ``Model.decode_step_paged`` — the same single decode path the
    colocated :class:`PagedServer` runs.

    Division of labour with the cluster:

    - the cluster owns prefill, admission (page puts over the GAS layer),
      preemption policy, release, and resume;
    - the server owns the per-tick write-page claim
      (``store.prepare_write``) and the batched paged decode.

    ``store.mem`` is the rank's pool segment on the device, the form the
    wire reads and writes (float32 carrier pages).  The decode step reads
    and writes the pool in *decode-views* form instead (per-layer pages
    in the model dtype), kept resident here across ticks.  Two sets keep
    the forms in step without converting the whole shard: pages whose
    segment bytes changed (landed by a transfer — :meth:`mark_stale` —
    or materialised and copy-on-write split here) are re-read into the
    views before the next decode, and pages the decode wrote are handed
    back by :meth:`drain_dirty` for the cluster to write into the segment
    before any swap-out reads them.

    When the pool shard runs dry mid-growth (tiered clusters
    oversubscribe), ``on_page_shortage(rid, need)`` asks the cluster to
    preempt; if pages still aren't free the row *stalls* one tick: its
    write slot is remapped to the scratch page (so a pending
    copy-on-write split can't corrupt sharers) and its logits are
    discarded — it retries once the swap-out lands.
    """

    def __init__(self, model, ctx, params, batch_size: int, cache_len: int,
                 store, eos_id: int = -1, device: Any = None,
                 on_page_shortage=None):
        super().__init__(model, ctx, params, batch_size, cache_len,
                         eos_id=eos_id, device=device)
        self.store = store
        self.layout = store.layout
        self.on_page_shortage = on_page_shortage
        self.paged_decode_steps = 0
        self._decode_paged = _paged_decode_views_fn(
            model, ctx, self.layout, self.device
        )
        self._views = None  # decode-views pool, P+1 rows (scratch last)
        self._stale: set = set()
        self._dirty: set = set()

    def _admit(self) -> None:
        """Admission belongs to the cluster (prefill nodes + GAS puts)."""

    def admit_paged(
        self, req: Request, first_token: int, position: int
    ) -> bool:
        """Bind an installed request's decode row to its page table: the
        pool shard — not any dense copy — is the KV source of truth.
        Returns False when no decode row is free."""
        slot = self._free_slot()
        if slot is None:
            return False
        self._bind(req, slot, first_token, position)
        return True

    def mark_stale(self, pages) -> None:
        """Physical pages whose segment bytes changed outside the decode
        step (landed by a transfer): re-read before the next decode."""
        self._stale.update(int(p) for p in pages)

    def drain_dirty(self) -> Dict[int, torch.Tensor]:
        """Physical page -> carrier row the decode wrote since the last
        drain (device tensors, read from the views)."""
        pages = sorted(self._dirty)
        self._dirty = set()
        if not pages or self._views is None:
            return {}
        idx = self._tensor(np.asarray(pages, np.int64))
        rows = self.layout.views_to_pool(
            tree_map(lambda v: v.index_select(1, idx), self._views)
        )
        return dict(zip(pages, rows))

    def _refresh_views(self) -> None:
        """Bring the decode views up to the segment: whole on first use,
        then only the stale pages."""
        mem = self.store.mem
        if self._views is None:
            empty = torch.from_numpy(self.layout.empty_page_row()).to(
                mem.device)
            self._views = self.layout.decode_views(
                torch.cat([mem, empty[None]], dim=0))
            self._stale.clear()
            return
        if not self._stale:
            return
        idx = self._tensor(np.asarray(sorted(self._stale), np.int64))
        self._stale.clear()
        rows = self.layout.decode_views(mem.index_select(0, idx))
        for pool, rv in zip(tree_leaves(self._views), tree_leaves(rows)):
            pool[:, idx] = rv

    def _paged_step(self, token, positions, tables) -> torch.Tensor:
        """One paged decode over the resident views (written in place);
        returns the logits."""
        logits, self._views = self._decode_paged(
            self.params, token, positions, self._views, tables)
        return logits

    def _step(self) -> int:
        from repro_torch.serving.pool import UNMATERIALIZED

        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        # row -> the physical page this tick's write lands in; rows absent
        # here at decode time are stalled (no write page) and discarded
        written: Dict[int, int] = {}
        T = self.layout.page_tokens
        for i in list(live):
            req = self.active[i]
            if req is None:
                continue  # evicted by an earlier row's shortage handling
            pos = int(self.positions[i])
            need = _pool_write_need(self.store, self.layout, req.rid, pos)
            if need and self.store.n_free < need:
                ok = bool(self.on_page_shortage) and self.on_page_shortage(
                    req.rid, need
                )
                if self.active[i] is None:
                    continue  # the shortage handler preempted this row
                if not ok:
                    continue  # stall: retry once freed pages land
            before = self.store.tables[req.rid][pos // T]
            dst = self.store.prepare_write(req.rid, pos)
            if before == UNMATERIALIZED or dst != before:
                self._stale.add(dst)  # materialised or COW-split in mem
            written[i] = dst
        live = [i for i, r in enumerate(self.active) if r is not None]
        if not live:
            return 0
        P = self.store.state.n_pages
        tables = np.full((self.B, self.layout.n_pages), P, np.int32)
        for i in live:
            tables[i] = self.store.device_table(self.active[i].rid, absent=P)
            if i not in written:
                # stalled: scatter into scratch, never a shared page
                tables[i, int(self.positions[i]) // T] = P
        self._refresh_views()
        logits = self._paged_step(self._tensor(self.last_token),
                                  self._tensor(self.positions),
                                  self._tensor(tables))
        self.paged_decode_steps += 1
        self._dirty.update(written.values())
        advanced = [i for i in live if i in written]
        self._advance(advanced, _to_host(logits))
        return len(advanced)


def _tp_paged_decode_fn(model, ctx, shard_layout, tp: int, backend,
                        device, costs=None):
    """The tensor-parallel paged decode step: ``Context.spmd`` over a
    ``("tp",)`` axis of ``tp`` ranks, each holding one head shard of the
    weights (``stack_shards``) and of the pool's decode views, and each
    sub-block's partial sum crossing the group through
    ``sched.all_reduce`` on the group's engine (``backend`` may be a
    mixed spec like ``"xla,gascore"``; plans take ``costs``).

    Called as ``step(stacked_params, token, positions, views, tables)``
    with ``views`` the rank-stacked decode views (every leaf ``(tp, L,
    P+1, T, ...)``), written in place (the scratch-page wipe and the K/V
    scatter run under the rank vmap on the batched views); returns every
    rank's logits, ``(tp, B, vocab)`` — replicated bit for bit (at tp 2
    every all-reduce schedule adds the same two partial sums).  Paged
    attention runs as one kernel launch per layer for the whole group
    (``kernels.ops.paged_attention``'s vmap rule)."""
    from repro_torch.core import gasnet, sched
    from repro_torch.core.addrspace import P
    from repro_torch.parallel.tp import TPGroup

    gas = gasnet.Context(tp, node_axis="tp", backend=backend, device=device)
    empty_views = shard_layout.decode_views(
        torch.from_numpy(shard_layout.empty_page_row()[None]).to(device)
    )

    def body(node, params, token, positions, views, tables):
        params = tree_map(lambda x: x[0], params)
        views = tree_map(lambda x: x[0], views)
        for pool, init in zip(tree_leaves(views), tree_leaves(empty_views)):
            pool[:, -1] = init[:, 0]
        engine = node.engine
        group = TPGroup(
            tp, lambda x: sched.all_reduce(engine, x, costs=costs))
        logits, _ = model.decode_step_paged(
            params, ctx, token, positions, views, tables, tp=group)
        return logits[None]

    def step(stacked_params, token, positions, views, tables):
        return gas.spmd(
            body, stacked_params, token, positions, views, tables,
            in_specs=(P("tp"), P(), P(), P("tp"), P()), out_specs=P("tp"),
        )

    return step


def _rank_views(shard_layout, rows: List[torch.Tensor]) -> Any:
    """Each rank's shard rows ``(m, shard_elems)`` as the rank-stacked
    decode views: every leaf ``(tp, L, m, T, ...)``."""
    per_rank = [shard_layout.decode_views(r) for r in rows]
    return tree_map(lambda *xs: torch.stack(xs), *per_rank)


def _tp_views(shard_layout, cols: torch.Tensor, rows: torch.Tensor) -> Any:
    """Full carrier rows ``(m, page_elems)`` as the rank-stacked decode
    views of their head shards (``cols``: ``(tp, shard_elems)``)."""
    return _rank_views(shard_layout, [rows.index_select(1, c) for c in cols])


def _tp_pool_patch_fn(shard_layout, cols: torch.Tensor):
    """Stacked-views variant of :func:`_pool_patch_fn`: ``rows`` are FULL
    carrier rows, split into head shards through ``cols`` (``(tp,
    shard_elems)`` carrier columns, ``PagedLayout.shard_heads``) and
    scattered into every rank's pool in place; copies run on every
    rank."""

    def patch(views, write_dst, rows, copy_src, copy_dst):
        rowviews = _tp_views(shard_layout, cols, rows)
        for pool, rv in zip(tree_leaves(views), tree_leaves(rowviews)):
            if write_dst.numel():
                pool[:, :, write_dst] = rv
            if copy_src.numel():
                pool[:, :, copy_dst] = pool[:, :, copy_src]
        return views

    return patch


def _tp_rows(shard_layout, views, idx: torch.Tensor) -> torch.Tensor:
    """The carrier rows of pages ``idx`` of every rank's shard, as the
    rank-stacked views hold them: ``(tp, m, shard_elems)``."""
    tp = tree_leaves(views)[0].shape[0]
    return torch.stack([
        shard_layout.views_to_pool(
            tree_map(lambda v: v[s].index_select(1, idx), views))
        for s in range(tp)
    ])


class TPPagedServer(PagedServer):
    """:class:`PagedServer` whose decode runs over a tensor-parallel group
    of ``tp`` GAS ranks: attention heads and MLP columns sharded per rank
    (``repro_torch.parallel.tp``), each rank's pool holding only its heads'
    slice of every page (``PagedLayout.shard_heads``), one planned
    all-reduce per sub-block inside the step (:func:`_tp_paged_decode_fn`,
    on ``tp_backend``: ``"xla"``, ``"gascore"`` or ``"xla,gascore"``,
    planned with ``sched_cost_table``; on CUDA without one, with this
    card's constants, ``sched.measure_costs``, as the cluster plans).

    Everything host-side is unchanged from the base class: the allocator,
    page tables, prefix index, scheduler, tier and the host ``mem``
    mirror all stay in the FULL layout (pages are sharded by bytes, not
    by id — every rank holds the same table).  Only the device residency
    differs: the views are rank-stacked (every leaf ``(tp, L, P+1, T,
    ...)``), patches pre-shard queued rows through ``shard_cols``, and
    ``_sync_host`` reassembles the shards bit-exactly.  Prefill runs
    unsharded on ``params``.

    All ranks live on the one device, so the reference's check that the
    job has ``tp`` devices has no counterpart here: any ``tp`` dividing
    both head counts runs.
    """

    def __init__(self, model, ctx, params, batch_size: int, cache_len: int,
                 tp: int = 2, tp_backend: str = "xla",
                 sched_cost_table: Optional[Dict[str, Any]] = None, **kw):
        super().__init__(model, ctx, params, batch_size, cache_len, **kw)
        from repro_torch.parallel import tp as tp_lib

        tp_lib.validate_tp(model.cfg, tp)
        self.tp = tp
        self.shard_layout, self.shard_cols = self.layout.shard_heads(
            tp, model.cfg.n_kv_heads
        )
        self._cols = torch.from_numpy(self.shard_cols).to(self.device)
        self._stacked_params = tp_lib.stack_shards(params, tp)
        if sched_cost_table is None and self.device.type == "cuda":
            # the reference's default constants are a TPU's: plan the
            # group's all-reduces with this card's own, measured once
            from repro_torch.core import sched
            from repro_torch.core.engine import parse_backend_spec

            sched_cost_table = sched.measure_costs(
                self.device, {"xla", *parse_backend_spec(tp_backend, tp)})
        self.costs = sched_cost_table
        self._decode_tp = _tp_paged_decode_fn(
            model, ctx, self.shard_layout, tp, tp_backend, self.device,
            costs=sched_cost_table,
        )
        self._patch = _tp_pool_patch_fn(self.shard_layout, self._cols)

    def _sync_host(self) -> None:
        if self._dev_views is None:
            return
        if self._pending_rows or self._pending_copies:
            self._apply_pending()
        P = self.store.state.n_pages
        idx = torch.arange(P, device=self.device)
        shards = _tp_rows(self.shard_layout, self._dev_views, idx)
        full = torch.empty((P, self.layout.page_elems), dtype=torch.float32,
                           device=self.device)
        for s in range(self.tp):
            full[:, self._cols[s]] = shards[s]
        self.store.mem[:] = full.cpu().numpy()
        self._dev_views = None

    def _decode_device(self, token, positions, tables) -> torch.Tensor:
        if self._dev_views is None:  # (re-)upload, pre-sharded per rank
            mem = np.concatenate(
                [self.store.mem, self.layout.empty_page_row()[None]], axis=0
            )
            self._dev_views = _tp_views(self.shard_layout, self._cols,
                                        self._tensor(mem))
        if self._pending_rows or self._pending_copies:
            self._apply_pending()
        logits = self._decode_tp(self._stacked_params, token, positions,
                                 self._dev_views, tables)
        return logits[0]


class TPPooledDecodeServer(PooledDecodeServer):
    """One logical decode server for a tensor-parallel GROUP of cluster
    ranks: the group's pool is striped across the members' segments BY
    HEADS (member ``s`` holds every page's slice for its heads —
    ``PagedLayout.shard_heads``), and each tick's decode runs over the
    group's ranks with one planned all-reduce per sub-block
    (:func:`_tp_paged_decode_fn`).

    The allocator, page tables and request rows are group-level (one
    logical server, one store, whose ``mem`` is the leader's partition);
    only page payloads are sharded.  ``shard_mems`` are the members' pool
    partitions in the cluster's segment tensor (entry 0 is ``store.mem``);
    the decode views are rank-stacked, stale pages are re-read from every
    member, and :meth:`drain_dirty` hands back ``(tp, shard_elems)`` rows
    for the cluster to write into every member's partition."""

    def __init__(self, model, ctx, params, batch_size: int, cache_len: int,
                 store, shard_mems: List[torch.Tensor], tp: int,
                 tp_backend: str = "xla",
                 costs: Optional[Dict[str, Any]] = None, eos_id: int = -1,
                 device: Any = None, on_page_shortage=None):
        super().__init__(model, ctx, params, batch_size, cache_len,
                         store=store, eos_id=eos_id, device=device,
                         on_page_shortage=on_page_shortage)
        from repro_torch.parallel import tp as tp_lib

        tp_lib.validate_tp(model.cfg, tp)
        self.tp = tp
        self.shard_mems = shard_mems
        self._stacked_params = tp_lib.stack_shards(params, tp)
        # self.layout is the SHARD layout (the store is built with it)
        self._decode_tp = _tp_paged_decode_fn(
            model, ctx, self.layout, tp, tp_backend, self.device, costs=costs
        )

    def drain_dirty(self) -> Dict[int, torch.Tensor]:
        """Physical page -> ``(tp, shard_elems)`` rows the decode wrote
        since the last drain (device tensors, read from the views)."""
        pages = sorted(self._dirty)
        self._dirty = set()
        if not pages or self._views is None:
            return {}
        idx = self._tensor(np.asarray(pages, np.int64))
        rows = _tp_rows(self.layout, self._views, idx)
        return {pp: rows[:, j] for j, pp in enumerate(pages)}

    def _refresh_views(self) -> None:
        if self._views is None:
            empty = torch.from_numpy(self.layout.empty_page_row()).to(
                self.device)
            self._views = _rank_views(
                self.layout,
                [torch.cat([m, empty[None]], dim=0) for m in self.shard_mems])
            self._stale.clear()
            return
        if not self._stale:
            return
        idx = self._tensor(np.asarray(sorted(self._stale), np.int64))
        self._stale.clear()
        rows = _rank_views(self.layout,
                           [m.index_select(0, idx) for m in self.shard_mems])
        for pool, rv in zip(tree_leaves(self._views), tree_leaves(rows)):
            pool[:, :, idx] = rv

    def _paged_step(self, token, positions, tables):
        return self._decode_tp(self._stacked_params, token, positions,
                               self._views, tables)[0]


CARD_BYTES = 80e9  # device memory of the one H100 the port serves on


def serve_with_context(model, ctx, params, reqs: List[Request], batch: int,
                       cache_len: int,
                       context: Callable[[int, int], Dict[str, torch.Tensor]]
                       ) -> Dict[str, Any]:
    """Requests whose prefill takes more than tokens, ``batch`` at a time
    (equal prompt lengths): ``Model.prefill`` with ``context(B, S)``'s
    entries beside the tokens (``frames`` for an encoder-decoder, ``xkv``
    for cross-attention to an image), then greedy ``Model.decode_step``s
    until each row has ``max_new`` tokens.  Fills each request's ``out``
    and raises on non-finite logits.  Returns the counts and the seconds
    of each prefill and each decode step, each ending with its tokens
    read to the host."""
    device = next(iter(tree_leaves(params))).device
    prefill_s, step_s = [], []
    t0 = time.perf_counter()
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        toks = torch.tensor([r.prompt for r in group], dtype=torch.int32,
                            device=device)
        B, S = toks.shape
        extra = context(B, S)
        pos = torch.full((B,), S, dtype=torch.int32, device=device)
        n_new = max(r.max_new for r in group)
        t = time.perf_counter()
        logits, caches = model.prefill(params, ctx, {"inputs": toks, **extra},
                                       cache_len=cache_len)
        for step in range(n_new):
            if not bool(torch.isfinite(logits).all()):
                raise FloatingPointError(
                    f"{model.cfg.name}: non-finite logits at step {step}")
            tok = torch.argmax(logits, -1).to(torch.int32)
            for r, v in zip(group, _to_host(tok).tolist()):
                if len(r.out) < r.max_new:
                    r.out.append(int(v))
            (step_s if step else prefill_s).append(time.perf_counter() - t)
            if step + 1 < n_new:
                t = time.perf_counter()
                logits, caches = model.decode_step(params, ctx, tok[:, None],
                                                   pos, caches)
                pos = pos + 1
        del caches, extra
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in reqs)
    return {"requests": len(reqs), "tokens": n_tok,
            "decode_steps": len(step_s), "wall_s": wall,
            "tok_per_s": n_tok / wall if wall else 0.0,
            "prefill_s": prefill_s, "step_s": step_s}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b",
                    help="any arch of configs/registry.py (qwen3-4b, "
                         "llama3-405b, granite-34b, gemma3-27b, "
                         "arctic-480b, kimi-k2-1t-a32b, falcon-mamba-7b, "
                         "recurrentgemma-9b, llama-3.2-vision-11b, "
                         "seamless-m4t-medium)")
    ap.add_argument("--role", choices=("prefill", "decode", "memory", "both"),
                    default="decode",
                    help="both = disaggregated cluster (prefill pool + "
                         "decode pool + optional memory ranks over the GAS "
                         "layer, all ranks on one device); decode = "
                         "colocated continuous batching; prefill = the "
                         "prefill pool alone; memory = a memory-only GAS "
                         "rank (segment capacity, no model compute: "
                         "reports its tier geometry)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-prefill", type=int, default=1)
    ap.add_argument("--n-decode", type=int, default=1)
    ap.add_argument("--n-memory", type=int, default=0,
                    help="memory-only ranks joining the paged cluster: their "
                         "segments hold the swap tier (serving.tier)")
    ap.add_argument("--prefill-backend", default="xla",
                    help="engine of the prefill pool (xla|gascore)")
    ap.add_argument("--decode-backend", default="xla",
                    help="engine of the decode pool (xla|gascore)")
    ap.add_argument("--memory-backend", default="xla",
                    help="engine of the memory ranks (xla|gascore)")
    ap.add_argument("--mem-slots", type=int, default=None,
                    help="tier page slots per memory rank")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths and depth (bf16) "
                         "instead of the SMOKE cut")
    ap.add_argument("--paged", action="store_true",
                    help="KV lives in the paged pool: pages allocated/freed "
                         "per request, prompt prefixes shared by page table")
    ap.add_argument("--page-tokens", type=int, default=8,
                    help="tokens per KV page (must divide --cache-len)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel decode group size: heads and MLP "
                         "columns sharded over tp GAS ranks (all on the "
                         "one device), one planned all-reduce per "
                         "sub-block; needs --paged")
    ap.add_argument("--tp-backend", default=None,
                    help="engine of the TP group's all-reduces "
                         "(xla|gascore|xla,gascore; default: "
                         "--decode-backend)")
    args = ap.parse_args(argv)
    if args.tp > 1 and not args.paged:
        ap.error("--tp > 1 shards the paged pool by heads: add --paged")
    tp_backend = args.tp_backend or args.decode_backend

    from repro_torch.configs.registry import ARCHS, SMOKE
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    # the reference serves the SMOKE cut; --full the published config
    cfg = (ARCHS if args.full else SMOKE)[args.arch]
    if args.full:
        need = cfg.param_counts()[0] * cfg.dtype.itemsize
        if need > CARD_BYTES:
            ap.error(
                f"--full {args.arch}: its published depth of {cfg.n_layers} "
                f"layers needs {need / 1e9:,.0f} GB of "
                f"{str(cfg.dtype).split('.')[-1]} weights, more than one "
                f"{CARD_BYTES / 1e9:.0f} GB card holds")
    device = resolve_device(args.device)
    model = build_model(cfg)
    ctx = RunCtx()
    if args.role == "memory":
        # a memory-only GAS rank exports segment capacity and runs no
        # model compute: report the tier geometry it would contribute
        from repro_torch.serving.pool import PagedLayout
        from repro_torch.serving.tier import MemoryTier

        layout = PagedLayout.from_struct(
            model.kv_block_struct(ctx, prompt_len=4, cache_len=args.cache_len),
            cache_len=args.cache_len, page_tokens=args.page_tokens,
        )
        slots = args.mem_slots or 2 * args.batch * layout.n_pages
        stats = dict(MemoryTier(1, slots, layout.page_elems).stats())
        stats.update({"role": "memory", "page_bytes": layout.page_bytes,
                      "segment_bytes": slots * layout.page_bytes})
        for k, v in stats.items():
            print(f"{k}: {v}")
        return
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(ctx, gen, device=device)

    rng = np.random.default_rng(0)
    reqs = [
        Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).tolist(),
            max_new=args.max_new,
        )
        for rid in range(args.requests)
    ]
    if args.role == "decode" and cfg.n_enc_layers:
        if args.paged or args.tp > 1:
            ap.error(f"{args.arch} is an encoder-decoder: no paged or TP "
                     "server takes its frames")
        frames = torch.Generator(device=device).manual_seed(0)
        stats = serve_with_context(
            model, ctx, params, reqs, args.batch, args.cache_len,
            lambda B, S: {"frames": torch.randn(  # a frame a prompt token
                (B, S, cfg.d_model), generator=frames, device=device)})
    elif args.role == "decode":
        if args.tp > 1:
            server = TPPagedServer(model, ctx, params, args.batch,
                                   args.cache_len, tp=args.tp,
                                   tp_backend=tp_backend, device=device,
                                   page_tokens=args.page_tokens)
        elif args.paged:
            server = PagedServer(model, ctx, params, args.batch,
                                 args.cache_len, device=device,
                                 page_tokens=args.page_tokens)
        else:
            server = Server(model, ctx, params, args.batch, args.cache_len,
                            device=device)
        for req in reqs:
            server.submit(req)
        stats = server.run_until_drained()
    elif args.role == "prefill":
        t0 = time.monotonic()
        for req in reqs:
            toks = torch.tensor([req.prompt], dtype=torch.int32, device=device)
            logits, _ = model.prefill(params, ctx, {"inputs": toks},
                                      cache_len=args.cache_len)
            logits.sum().item()  # wait for the device
        dt = time.monotonic() - t0
        stats = {"requests": len(reqs), "wall_s": dt,
                 "kv_blocks_per_s": len(reqs) / dt if dt else 0.0}
    else:
        from repro_torch.serving.disagg import DisaggCluster

        cluster = DisaggCluster(
            model, ctx, params,
            n_prefill=args.n_prefill, n_decode=args.n_decode,
            n_memory=args.n_memory,
            decode_batch=args.batch, cache_len=args.cache_len,
            prefill_backend=args.prefill_backend,
            decode_backend=args.decode_backend,
            memory_backend=args.memory_backend,
            paged=args.paged or args.n_memory > 0,
            page_tokens=args.page_tokens,
            mem_slots_per_rank=args.mem_slots,
            tp=args.tp, tp_backend=tp_backend,
            device=device,
        )
        for req in reqs:
            cluster.submit(req)
        stats = cluster.run_until_drained()
    for k, v in stats.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
