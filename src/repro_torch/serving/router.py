"""Router: N EngineCore replicas behind one request stream.

The middle layer of the port's serving API (counterpart of the JAX
package's ``serving/router.py``).  The router owns the replicas, decides
WHERE a request runs, and keeps the fleet balanced::

      submit(req) ── routing policy ──► EngineCore[k].add_request
      step()      ── every replica  ──► merged list[RequestOutput]
      page-starved replica? ──► snapshot_slot ──► inject_slot on a donor

Routing policies (``policy=``):

* ``round_robin`` — cycle through replicas; the stateless baseline.
* ``least_loaded`` — send to the replica with the smallest
  (queue depth + active slots), discounted by the fraction of the prompt
  the replica's prefix cache could serve without prefilling
  (``EngineCore.prefix_hit_estimate``, 0 when prefix caching is off) and
  breaking ties toward the most free pages; the sensible default under
  heterogeneous request sizes.
* ``session_affinity`` — the replica whose prefix cache already holds the
  most of this request's prompt wins outright (that is where the session's
  pages physically live); with no cached pages anywhere — or prefix
  caching off — it falls back to hashing ``Request.session`` so a
  conversation keeps landing on one replica (``session=None`` falls back
  to round robin).

Request ids must be GLOBALLY unique across the fleet — the router
enforces it at submit, and
:class:`repro_torch.serving.client.ServingClient`
is the single place that allocates them (and derives sampling seeds from
them, so no two replicas ever reuse a sample stream).  Replicas may share
one params dict (``Router.build`` does) and one card.

Slot migration: after each step, if a replica is page-starved (a
suspended slot waiting on pages, or a backlogged queue it cannot admit)
and another replica has headroom (free slot + the snapshot's pages + one
page of growth room), the router drains the starved replica's candidate
slot via ``snapshot_slot`` and resumes it on the donor via
``inject_slot``.  The snapshot rides the tiered-KV swap seam
(``swap_out_pages`` / ``swap_in_pages`` / ``checkpoint_slot_state``), so
a migrated request's decode logits are bit-identical to the unmigrated
run (tests/test_torch_migrate.py).  At most one migration per router step
keeps the balancing pressure bounded.
"""

from __future__ import annotations

import copy
import zlib
from typing import Iterable, Optional

from repro_torch.serving.core import EngineCore, EngineStats, Request, \
    RequestOutput

ROUTE_POLICIES = ("round_robin", "least_loaded", "session_affinity")


class Router:
    """Owns N homogeneous :class:`EngineCore` replicas.

    Replicas must share family, page size, max_seq, and eos id — a
    migrated snapshot must mean the same thing everywhere (enforced at
    construction).  Params may differ in principle (the router never
    looks at them) but identical params are what makes migration
    bit-identical; ``Router.build`` constructs replicas from one
    (cfg, params) pair, which is the intended use.
    """

    def __init__(self, cores: Iterable[EngineCore],
                 policy: str = "round_robin", migrate: bool = True):
        self.cores: list[EngineCore] = list(cores)
        if not self.cores:
            raise ValueError("router needs at least one replica")
        if policy not in ROUTE_POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}; pick from "
                f"{ROUTE_POLICIES}")
        head = self.cores[0]
        for c in self.cores[1:]:
            same = (c.cfg.family == head.cfg.family
                    and c.max_seq == head.max_seq
                    and c.eos_id == head.eos_id
                    and c.mode == head.mode
                    and getattr(c, "page_size", None)
                    == getattr(head, "page_size", None)
                    and getattr(c, "kv_dtype", None)
                    == getattr(head, "kv_dtype", None)
                    and c.device == head.device)
            if not same:
                raise ValueError(
                    "replicas must be homogeneous (family/max_seq/eos_id/"
                    "mode/page_size/kv_dtype/device)")
        self.policy = policy
        self.migrate = migrate and head.mode == "continuous"
        self.migrations = 0
        self._rr = 0
        self._home: dict[int, EngineCore] = {}   # rid -> owning replica
        # duplicate-id guard with bounded memory: live rids are in _home,
        # finished ones are covered by the high-water mark (ServingClient
        # allocates strictly increasing ids; direct submitters must too)
        self._rid_hwm = -1

    @classmethod
    def build(cls, cfg, params, replicas: int = 1,
              policy: str = "round_robin", migrate: bool = True,
              **engine_kw) -> "Router":
        """N identical replicas over one (cfg, params) pair: the weights
        are shared, each replica has its own KV pool and decode graph."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        cores = []
        for _ in range(replicas):
            kw = dict(engine_kw)
            # stateful schedulers (DRR's deficit ring, EDF/priority are
            # stateless but uniform treatment is free) must not be shared:
            # interleaved admit() calls from different replicas would
            # corrupt their per-queue bookkeeping
            if kw.get("scheduler") is not None:
                kw["scheduler"] = copy.deepcopy(kw["scheduler"])
            cores.append(EngineCore(cfg, params, **kw))
        return cls(cores, policy=policy, migrate=migrate)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _pick(self, req: Request) -> EngineCore:
        if self.policy == "session_affinity" and req.session is not None:
            # "the session's replica" is wherever its KV pages actually
            # live: the largest cached-prefix estimate wins (max is stable,
            # so equal estimates keep the lowest replica — deterministic)
            hits = [c.prefix_hit_estimate(req) for c in self.cores]
            if max(hits) > 0:
                return self.cores[hits.index(max(hits))]
            # no replica holds anything (cold session / prefix off):
            # deterministic across processes (python's str hash is salted)
            h = zlib.crc32(str(req.session).encode())
            return self.cores[h % len(self.cores)]
        if self.policy == "least_loaded":
            # discount load by the prompt fraction already cached: a busier
            # replica that can skip the whole prefill is often the cheaper
            # place to land (hit fraction is in [0, 1], so it acts as a
            # tie-shader between integer load levels, not an override)
            len0 = max(1, len(req.prompt))
            return min(self.cores,
                       key=lambda c: (c.queue_depth + c.n_active
                                      - c.prefix_hit_estimate(req) / len0,
                                      -c.free_pages))
        core = self.cores[self._rr % len(self.cores)]
        self._rr += 1
        return core

    def submit(self, req: Request) -> EngineCore:
        """Route one request; returns the replica it landed on."""
        if req.rid in self._home or req.rid <= self._rid_hwm:
            raise ValueError(
                f"request id {req.rid} already submitted — ids must be "
                f"globally unique and strictly increasing across replicas "
                f"(use ServingClient, which allocates them)")
        core = self._pick(req)
        core.add_request(req)
        self._rid_hwm = max(self._rid_hwm, req.rid)
        self._home[req.rid] = core
        return core

    def abort(self, rid: int) -> bool:
        core = self._home.get(rid)
        return core is not None and core.abort_request(rid)

    def replica_of(self, rid: int) -> Optional[int]:
        """Index of the replica currently holding ``rid`` (None once it
        finished or was never submitted)."""
        core = self._home.get(rid)
        return None if core is None else self.cores.index(core)

    # ------------------------------------------------------------------
    # fleet stepping + migration
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return any(c.has_work for c in self.cores)

    def step(self) -> list[RequestOutput]:
        """One round across the fleet: every replica with work advances,
        then at most one starved→donor slot migration rebalances pages."""
        outs: list[RequestOutput] = []
        for core in self.cores:
            if core.has_work:
                # _advance + drain rather than core.step(): identical for
                # an EngineCore, but also correct for the ServingEngine
                # shim (whose step() keeps the legacy bool return), so any
                # EngineCore subclass can serve as a replica
                core._advance()
            # an idle replica can still hold pending events: an abort of
            # its last request leaves the terminal event queued
            outs.extend(core.drain_outputs())
        if self.migrate and len(self.cores) > 1:
            self._maybe_migrate()
        for e in outs:
            if e.finished:
                self._home.pop(e.rid, None)
        return outs

    def _maybe_migrate(self) -> None:
        for src in self.cores:
            if not src.page_starved:
                continue
            cand = src.migration_candidate()
            if cand is None:
                continue
            rid, n_pages = cand
            donors = [c for c in self.cores
                      if c is not src and c.can_accept(n_pages)]
            if not donors:
                continue
            donor = max(donors, key=lambda c: (c.free_pages,
                                               c.n_free_slots))
            snap = src.snapshot_slot(rid)
            try:
                donor.inject_slot(snap)
                self._home[rid] = donor
            except Exception:
                # donor raced out of room between the check and the inject:
                # the source just freed the snapshot's pages, so it can
                # always take its own slot back — the request is never lost
                src.inject_slot(snap)
                raise
            self.migrations += 1
            return  # at most one move per step

    # ------------------------------------------------------------------
    # drive helpers (mirror the EngineCore surface)
    # ------------------------------------------------------------------
    def stream(self, max_steps: int = 10_000):
        steps = 0
        while self.has_work and steps < max_steps:
            yield from self.step()
            steps += 1

    def run(self, max_steps: int = 10_000) -> list[EngineStats]:
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.stats

    @property
    def stats(self) -> list[EngineStats]:
        """Per-replica stats, index-aligned with ``cores``."""
        return [c.stats for c in self.cores]

    def summary(self) -> str:
        lines = [f"router: {len(self.cores)} replica(s) "
                 f"policy={self.policy} migrations={self.migrations}"]
        for k, c in enumerate(self.cores):
            lines.append(f"  [replica {k}] {c.stats.summary()}")
        return "\n".join(lines)
