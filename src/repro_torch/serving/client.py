"""ServingClient: the user-facing handle over a Router of EngineCores.

Counterpart of ``repro.serving.client``::

    client = ServingClient(cfg, params, replicas=2, route="least_loaded",
                           max_batch=4, max_seq=128)   # device="cuda"
    h = client.submit([1, 2, 3], max_new_tokens=16)
    for tok in h.tokens():          # per-request incremental stream
        ...
    for out in client.stream():     # or: merged fleet-wide event stream
        ...
    client.abort(h.rid)             # or h.abort()

The client is the single place global request ids are allocated, and so
the single place a stochastic request's seed is derived (``seed_base +
rid``), exactly as in the JAX package.  Replicas migrate slots off a
page-starved replica (``migrate=True``, the default).  ``workers=N``
builds a loopback ``FleetRouter`` instead (``serving/fleet/router.py``):
N in-process workers behind the fleet wire codec, ``spares=K`` hot
spares, checkpoints and failover; for subprocess workers build
``FleetRouter.build_socket(...)`` and pass it as ``router=``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator, Optional

from repro_torch.serving.core import Request, RequestOutput
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import SamplingParams


class RequestHandle:
    """One submitted request's live view: buffered events and incremental
    token iteration."""

    def __init__(self, client: "ServingClient", req: Request):
        self._client = client
        self.request = req
        self.rid = req.rid
        self.events: deque[RequestOutput] = deque()
        self.finished = False
        self.finish_reason: Optional[str] = None

    def _push(self, ev: RequestOutput) -> None:
        self.events.append(ev)
        if ev.finished:
            self.finished = True
            self.finish_reason = ev.finish_reason

    def tokens(self) -> Iterator[int]:
        """Yield this request's token ids as they are generated, pumping
        the fleet while other requests make progress too."""
        while True:
            while self.events:
                ev = self.events.popleft()
                if ev.token is not None:
                    yield ev.token
            if self.finished:
                return
            if not self._client.pump() and not self._client.has_work:
                return

    def result(self) -> Request:
        """Drive the fleet until this request finishes; returns it."""
        for _ in self.tokens():
            pass
        return self.request

    def abort(self) -> bool:
        return self._client.abort(self.rid)


class ServingClient:
    """User-facing serving surface over N engine replicas: wrap a router
    (``router=``) or let the client build one from ``(cfg, params)`` with
    ``replicas`` / ``route`` and any EngineCore keyword (``max_batch``,
    ``max_seq``, ``scheduler``, ``overlap``, ``kv_tier``, ``prefix_cache``,
    ``device``, ...); a request's ``SamplingParams`` may be stochastic.
    ``workers`` / ``spares`` / ``transport``: a loopback fleet (see the
    module docstring)."""

    def __init__(self, cfg=None, params=None, *, router: Router = None,
                 replicas: int = 1, route: str = "round_robin",
                 migrate: bool = True, seed_base: int = 0,
                 workers: int = 0, transport: str = "loopback",
                 spares: int = 0, **engine_kw):
        if router is None:
            if cfg is None or params is None:
                raise ValueError("pass (cfg, params) or a prebuilt router=")
            if workers:
                if transport != "loopback":
                    raise ValueError(
                        "ServingClient builds loopback fleets only; for "
                        "socket workers use FleetRouter.build_socket(...) "
                        "and pass router=")
                from repro_torch.serving.fleet.router import FleetRouter
                router = FleetRouter.build_loopback(
                    cfg, params, workers=workers, spares=spares,
                    policy=route, migrate=migrate, **engine_kw)
            else:
                router = Router.build(cfg, params, replicas=replicas,
                                      policy=route, migrate=migrate,
                                      **engine_kw)
        self.router = router
        self.seed_base = seed_base
        self._next_rid = 0
        self._handles: dict[int, RequestHandle] = {}

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               priority: int = 0, deadline_s: Optional[float] = None,
               session: Optional[str] = None,
               sampling: Optional[SamplingParams] = None,
               arrival_s: Optional[float] = None) -> RequestHandle:
        """Route one request; returns its handle (non-blocking)."""
        rid = self._next_rid
        self._next_rid += 1
        if (sampling is not None and sampling.temperature > 0.0
                and sampling.seed is None):
            sampling = dataclasses.replace(sampling,
                                           seed=self.seed_base + rid)
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, priority=priority,
                      deadline_s=deadline_s, session=session,
                      sampling=sampling, arrival_s=arrival_s)
        self.router.submit(req)
        handle = RequestHandle(self, req)
        self._handles[rid] = handle
        return handle

    def abort(self, rid: int) -> bool:
        return self.router.abort(rid)

    @property
    def has_work(self) -> bool:
        return self.router.has_work

    def pump(self) -> list[RequestOutput]:
        """One fleet step; fans events out to their handles."""
        outs = self.router.step()
        for ev in outs:
            h = self._handles.get(ev.rid)
            if h is not None:
                h._push(ev)
                if ev.finished:
                    del self._handles[ev.rid]
        return outs

    def stream(self, max_steps: int = 10_000) -> Iterator[RequestOutput]:
        """Merged fleet-wide event stream, until the fleet drains."""
        steps = 0
        while steps < max_steps:
            outs = self.pump()
            yield from outs
            if not outs and not self.router.has_work:
                return
            steps += 1

    def run(self, max_steps: int = 10_000) -> None:
        for _ in self.stream(max_steps):
            pass

    def summary(self) -> str:
        return self.router.summary()
