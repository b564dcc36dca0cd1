"""Router: N EngineCore replicas behind one request stream.

The middle layer of the port's serving API (counterpart of
``repro.serving.router``): it owns the replicas and decides WHERE a request
runs.  Routing policies:

* ``round_robin`` — cycle through replicas; the stateless baseline.
* ``least_loaded`` — the replica with the smallest (queue depth + active
  slots), ties toward the most free pages.

``session_affinity`` ranks replicas by their prefix caches, and slot
migration moves snapshots between replicas; both wait for their slices, so
``migrate`` defaults to False here and ``migrate=True`` raises.

Request ids must be globally unique and increasing across the fleet; the
:class:`repro_torch.serving.client.ServingClient` allocates them.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.serving.core import EngineCore, EngineStats, Request, \
    RequestOutput

ROUTE_POLICIES = ("round_robin", "least_loaded")


class Router:
    """Owns N homogeneous :class:`EngineCore` replicas."""

    def __init__(self, cores: Iterable[EngineCore],
                 policy: str = "round_robin", migrate: bool = False):
        self.cores: list[EngineCore] = list(cores)
        if not self.cores:
            raise ValueError("router needs at least one replica")
        if policy not in ROUTE_POLICIES:
            raise ValueError(
                f"unknown or unported routing policy {policy!r}; pick from "
                f"{ROUTE_POLICIES}")
        if migrate:
            raise NotImplementedError(
                "slot migration needs snapshot_slot / inject_slot, not "
                "ported to the PyTorch engine yet")
        head = self.cores[0]
        for c in self.cores[1:]:
            same = (c.cfg.family == head.cfg.family
                    and c.max_seq == head.max_seq
                    and c.eos_id == head.eos_id
                    and c.page_size == head.page_size
                    and c.device == head.device)
            if not same:
                raise ValueError(
                    "replicas must be homogeneous "
                    "(family/max_seq/eos_id/page_size/device)")
        self.policy = policy
        self._rr = 0
        self._home: dict[int, EngineCore] = {}   # rid -> owning replica
        self._rid_hwm = -1

    @classmethod
    def build(cls, cfg, params, replicas: int = 1,
              policy: str = "round_robin", migrate: bool = False,
              **engine_kw) -> "Router":
        """N identical replicas over one (cfg, params) pair; the weights
        are shared, each replica has its own KV pool."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        cores = [EngineCore(cfg, params, **engine_kw)
                 for _ in range(replicas)]
        return cls(cores, policy=policy, migrate=migrate)

    def _pick(self, req: Request) -> EngineCore:
        if self.policy == "least_loaded":
            return min(self.cores,
                       key=lambda c: (c.queue_depth + c.n_active,
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

    @property
    def has_work(self) -> bool:
        return any(c.has_work for c in self.cores)

    def step(self) -> list[RequestOutput]:
        """One round across the fleet: every replica with work advances."""
        outs: list[RequestOutput] = []
        for core in self.cores:
            if core.has_work:
                core._advance()
            outs.extend(core.drain_outputs())
        for e in outs:
            if e.finished:
                self._home.pop(e.rid, None)
        return outs

    @property
    def stats(self) -> list[EngineStats]:
        """Per-replica stats, index-aligned with ``cores``."""
        return [c.stats for c in self.cores]

    def summary(self) -> str:
        lines = [f"router: {len(self.cores)} replica(s) "
                 f"policy={self.policy}"]
        for k, c in enumerate(self.cores):
            lines.append(f"  [replica {k}] {c.stats.summary()}")
        return "\n".join(lines)
