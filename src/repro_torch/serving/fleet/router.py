"""FleetRouter: the Router surface over remote workers, with failover.

The port's own copy of ``repro.serving.fleet.router``, contract for
contract.  Same duck-typed surface the in-process
:class:`repro_torch.serving.router.Router` offers (``submit`` / ``step`` /
``abort`` / ``has_work`` / ``stats`` / ``summary``), so a
:class:`repro_torch.serving.client.ServingClient` plugs in unchanged — but
the replicas are :class:`WorkerHandle`\\ s behind a
:mod:`transport <repro_torch.serving.fleet.transport>`, each hosting one
EngineCore in (potentially) another process.

Health state machine (per worker, driven by every reply)::

    ALIVE ──reply deadline blown──► SUSPECT ──misses > limit──► DEAD
      ▲                               │                           ▲
      └────────late reply arrives─────┘      EOF / reset / kill ──┘

ALIVE workers get one ``step`` command per router step; a SUSPECT
worker is only polled for its outstanding late reply (never sent new
work) until it recovers or crosses the miss limit.  Every reply
piggybacks the worker's load vector — the heartbeat that routing and
migration read.

Failover re-dispatches every request owned by a DEAD worker:

* requests still queued on it replay **from the client's request
  record** — a fresh clone with the ORIGINAL prompt (the mirror is
  never folded or mutated by worker-side restarts);
* in-flight slots restore from the last periodic checkpoint — every
  ``checkpoint_every`` steps each worker returns non-destructive
  ``SlotSnapshot.to_bytes()`` blobs of its active slots, persisted
  through ``distributed/checkpoint.py``'s atomic-write machinery (and
  re-read through it at failover) — injected into a surviving worker or
  a promoted hot spare, which then re-decodes the few tokens generated
  since the checkpoint.

The replay invariant: re-decoded tokens the client already saw are
suppressed, but each one is **verified byte-equal** against the
delivered stream before being dropped (counted in ``tokens_replayed``)
— per-request streams are batch-composition-invariant and sampling is
seed-pinned per request, so the recovered stream is bit-identical to an
undisturbed run, and any divergence is a loud RuntimeError instead of a
silent wrong answer.
"""

from __future__ import annotations

import copy
import shutil
import tempfile
import time
import zlib
from collections import deque
from typing import Iterable, Optional

import numpy as np

from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from repro_torch.serving.core import (EngineCore, EngineStats, Request,
                                      RequestOutput, SlotSnapshot)
from repro_torch.serving.fleet.transport import (LoopbackTransport,
                                                 RemoteError, Transport,
                                                 TransportError,
                                                 TransportTimeout,
                                                 spawn_worker, unwrap)
from repro_torch.serving.router import ROUTE_POLICIES

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"


class WorkerHandle:
    """One remote EngineCore: transport + the router's view of its health."""

    def __init__(self, name: str, transport: Transport, spare: bool = False):
        self.name = name
        self.transport = transport
        self.spare = spare
        self.state = ALIVE
        self.load: dict = {}
        self.misses = 0          # consecutive blown reply deadlines
        self.pending: Optional[str] = None   # method awaiting its reply
        self.last_stats = EngineStats()

    @property
    def alive(self) -> bool:
        return self.state != DEAD

    def __repr__(self):
        return f"<worker {self.name} {self.state}>"


class FleetRouter:
    """Routes requests over transport-attached workers; detects death and
    straggle by heartbeat/reply deadlines; fails over with bit-identical
    recovered streams.  See the module docstring for the contract."""

    def __init__(self, workers: Iterable[Transport | WorkerHandle],
                 spares: Iterable[Transport | WorkerHandle] = (),
                 policy: str = "least_loaded", migrate: bool = True,
                 checkpoint_every: int = 8, ckpt_dir: Optional[str] = None,
                 reply_timeout_s: float = 60.0,
                 suspect_poll_s: float = 0.05, miss_limit: int = 3):
        if policy not in ROUTE_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; pick "
                             f"from {ROUTE_POLICIES}")
        self._active = [w if isinstance(w, WorkerHandle)
                        else WorkerHandle(f"w{i}", w)
                        for i, w in enumerate(workers)]
        if not self._active:
            raise ValueError("fleet needs at least one worker")
        self._spares = [w if isinstance(w, WorkerHandle)
                        else WorkerHandle(f"s{i}", w, spare=True)
                        for i, w in enumerate(spares)]
        self.policy = policy
        self.migrate = migrate
        self.migrations = 0
        self.checkpoint_every = checkpoint_every
        self.reply_timeout_s = reply_timeout_s
        self.suspect_poll_s = suspect_poll_s
        self.miss_limit = miss_limit
        self._own_ckpt_dir = ckpt_dir is None
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="fleet_ckpt_")
        # fleet-level counters (the satellite fields of EngineStats)
        self.fleet = EngineStats(mode="fleet", policy=policy)
        self._reqs: dict[int, Request] = {}      # live client-side mirrors
        self._owner: dict[int, WorkerHandle] = {}
        self._backlog: deque[Request] = deque()  # clones awaiting dispatch
        self._ckpt: dict[int, bytes] = {}        # freshest snapshot blobs
        self._saved: dict[int, bytes] = {}       # what the last save wrote
        self._replay_until: dict[int, int] = {}  # rid -> delivered hwm
        self._out_buffer: list[RequestOutput] = []
        self.recovery_s: list[float] = []        # per-failover wall seconds
        self._rid_hwm = -1
        self._rr = 0
        self._step_n = 0

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def build_loopback(cls, cfg, params, workers: int = 2, spares: int = 0,
                       policy: str = "least_loaded", migrate: bool = True,
                       **kw) -> "FleetRouter":
        """N in-process EngineCores behind byte-faithful loopback
        transports.  ``kw`` splits into EngineCore kwargs and FleetRouter
        kwargs (``checkpoint_every`` etc.)."""
        from repro_torch.serving.fleet.worker import WorkerHost

        router_kw = {k: kw.pop(k) for k in
                     ("checkpoint_every", "ckpt_dir", "reply_timeout_s",
                      "suspect_poll_s", "miss_limit") if k in kw}

        def mk(name, spare):
            ekw = dict(kw)
            if ekw.get("scheduler") is not None:   # stateful: never shared
                ekw["scheduler"] = copy.deepcopy(ekw["scheduler"])
            core = EngineCore(cfg, params, **ekw)
            return WorkerHandle(name, LoopbackTransport(
                WorkerHost(core, name=name)), spare=spare)

        return cls([mk(f"w{i}", False) for i in range(workers)],
                   spares=[mk(f"s{i}", True) for i in range(spares)],
                   policy=policy, migrate=migrate, **router_kw)

    @classmethod
    def build_socket(cls, arch: str, workers: int = 2, spares: int = 0,
                     policy: str = "least_loaded", migrate: bool = True,
                     checkpoint_every: int = 8,
                     ckpt_dir: Optional[str] = None,
                     reply_timeout_s: float = 120.0, miss_limit: int = 3,
                     sched_policy: str = "fcfs", **spawn_kw) -> "FleetRouter":
        """Spawn ``workers + spares`` subprocess workers (concurrently —
        param init dominates startup) and wire them up.  ``policy`` is
        the fleet ROUTING policy; the per-worker SCHEDULER policy rides
        as ``sched_policy`` (the names collide on the worker CLI).  On a
        card (``device``, "cuda" by default) the kernel library is built
        here first, so the workers load it instead of each compiling it."""
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.device import resolve_device

        if resolve_device(spawn_kw.get("device", "cuda")).type == "cuda":
            from repro_torch.kernels import build as kernel_build
            kernel_build.build()
        n = workers + spares
        with ThreadPoolExecutor(max_workers=n) as ex:
            transports = list(ex.map(
                lambda _: spawn_worker(arch, policy=sched_policy,
                                       **spawn_kw), range(n)))
        return cls([WorkerHandle(f"w{i}", t)
                    for i, t in enumerate(transports[:workers])],
                   spares=[WorkerHandle(f"s{i}", t, spare=True)
                           for i, t in enumerate(transports[workers:])],
                   policy=policy, migrate=migrate,
                   checkpoint_every=checkpoint_every, ckpt_dir=ckpt_dir,
                   reply_timeout_s=reply_timeout_s, miss_limit=miss_limit)

    # ------------------------------------------------------------------
    # reply plumbing + health bookkeeping
    # ------------------------------------------------------------------
    def _process_reply(self, w: WorkerHandle, rep: dict):
        """Book a received reply: heartbeat, health recovery, and the
        method-specific payload (step events / checkpoint blobs)."""
        if isinstance(rep.get("load"), dict):
            w.load = rep["load"]
        w.misses = 0
        if w.state == SUSPECT:
            w.state = ALIVE
        method, w.pending = w.pending, None
        result = unwrap(rep)
        if method == "step":
            self._deliver(result["events"])
        elif method == "checkpoint":
            self._note_checkpoint(result["snaps"])
        return result

    def _call(self, w: WorkerHandle, method: str, args: dict | None = None):
        """Synchronous auxiliary call (submit / inject / migration /
        stats).  A timeout here is treated as death, not straggle: unlike
        ``step``, these calls have side effects we cannot leave in limbo
        (did the add_request land?) — closing the worker makes the answer
        irrelevant."""
        try:
            w.transport.send(method, args or {})
            w.pending = method
            rep = w.transport.recv(self.reply_timeout_s)
        except TransportTimeout:
            self.fleet.heartbeat_misses += 1
            self._failover(w)
            raise
        except TransportError:
            self._failover(w)
            raise
        return self._process_reply(w, rep)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _routable(self) -> list[WorkerHandle]:
        return [w for w in self._active
                if w.state == ALIVE and w.pending is None]

    def _pick(self, req: Request) -> Optional[WorkerHandle]:
        ws = self._routable()
        if not ws:
            return None
        if self.policy == "session_affinity" and req.session is not None:
            # remote prefix estimates would cost one RPC per worker per
            # submit; the stable-hash fallback keeps a conversation pinned
            # to one worker, which is the property the policy sells
            h = zlib.crc32(str(req.session).encode())
            return ws[h % len(ws)]
        if self.policy == "least_loaded":
            return min(ws, key=lambda w: (
                w.load.get("queue_depth", 0) + w.load.get("n_active", 0),
                -w.load.get("free_pages", 0)))
        w = ws[self._rr % len(ws)]
        self._rr += 1
        return w

    @staticmethod
    def _clone(req: Request) -> Request:
        """A fresh submission-grade copy from the client's record: the
        ORIGINAL prompt, no generated tokens — what a worker receives at
        first dispatch and what from-scratch failover replays."""
        return Request(rid=req.rid, prompt=list(req.prompt),
                       max_new_tokens=req.max_new_tokens,
                       priority=req.priority, arrival_s=req.arrival_s,
                       deadline_s=req.deadline_s, session=req.session,
                       sampling=req.sampling)

    def submit(self, req: Request) -> Optional[str]:
        """Route one request; returns the worker name it landed on (None
        while it waits in the local backlog).  The caller's Request object
        becomes the client-side mirror — the failover record and the
        stream the replay verifier checks against."""
        if req.rid in self._reqs or req.rid <= self._rid_hwm:
            raise ValueError(
                f"request id {req.rid} already submitted — ids must be "
                f"globally unique and strictly increasing across the fleet "
                f"(use ServingClient, which allocates them)")
        self._rid_hwm = max(self._rid_hwm, req.rid)
        self._reqs[req.rid] = req
        self._backlog.append(self._clone(req))
        self._flush_backlog()
        w = self._owner.get(req.rid)
        return w.name if w is not None else None

    def _flush_backlog(self) -> None:
        while self._backlog:
            req = self._backlog[0]
            mirror = self._reqs.get(req.rid)
            if mirror is None or mirror.done:   # aborted while queued
                self._backlog.popleft()
                continue
            w = self._pick(req)
            if w is None:
                if not any(x.alive for x in self._active) \
                        and not self._spares:
                    raise RuntimeError(
                        "fleet has no live workers and no spares left")
                return   # try again next step
            try:
                self._call(w, "add_request", {"req": req})
            except RemoteError as e:
                # the worker executed and REJECTED it (e.g. prompt does not
                # fit max_seq) — a terminal verdict, not a routing failure
                mirror.done = True
                mirror.rejected = True
                mirror.finish_reason = "rejected"
                self.fleet.rejected += 1
                self._emit_local(mirror, "rejected", str(e))
                self._backlog.popleft()
                continue
            except TransportError:
                continue   # worker failed over; try the next candidate
            self._owner[req.rid] = w
            self._backlog.popleft()

    def abort(self, rid: int) -> bool:
        for req in self._backlog:
            if req.rid == rid:
                self._backlog.remove(req)
                mirror = self._reqs.get(rid, req)
                mirror.done = True
                mirror.finish_reason = "aborted"
                self.fleet.aborted += 1
                self._emit_local(mirror, "aborted")
                return True
        w = self._owner.get(rid)
        if w is None or not w.alive or w.pending is not None:
            return False
        try:
            return bool(self._call(w, "abort", {"rid": rid}))
        except TransportError:
            return False

    def _emit_local(self, req: Request, reason: str,
                    detail: str | None = None) -> None:
        self._out_buffer.append(RequestOutput(
            rid=req.rid, token=None, n_out=len(req.out_tokens),
            finished=True, finish_reason=reason,
            sched={"chunks": 0, "preemptions": 0, "wait_s": None}))
        self._finish_bookkeeping(req.rid)

    def _finish_bookkeeping(self, rid: int) -> None:
        self._reqs.pop(rid, None)
        self._owner.pop(rid, None)
        self._ckpt.pop(rid, None)
        self._replay_until.pop(rid, None)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._backlog) or bool(self._reqs) \
            or bool(self._out_buffer)

    def step(self) -> list[RequestOutput]:
        """One fleet round: flush the backlog, step every ALIVE worker
        (polling SUSPECT ones for their late reply), collect periodic
        checkpoints, maybe migrate one slot."""
        self._step_n += 1
        self._flush_backlog()
        for w in list(self._active):
            if not w.alive:
                continue
            try:
                if w.pending is None:
                    w.transport.send("step", {})
                    w.pending = "step"
                    rep = w.transport.recv(self.reply_timeout_s)
                else:   # SUSPECT: only poll for the outstanding reply
                    rep = w.transport.recv(self.suspect_poll_s)
            except TransportTimeout:
                w.misses += 1
                self.fleet.heartbeat_misses += 1
                w.state = SUSPECT
                if w.misses > self.miss_limit:
                    self._failover(w)
                continue
            except TransportError:
                self._failover(w)
                continue
            self._process_reply(w, rep)
        if self.checkpoint_every \
                and self._step_n % self.checkpoint_every == 0:
            self._checkpoint()
        if self.migrate:
            self._maybe_migrate()
        outs, self._out_buffer = self._out_buffer, []
        return outs

    def _deliver(self, events: list[RequestOutput]) -> None:
        for ev in events:
            req = self._reqs.get(ev.rid)
            if req is None:
                continue   # finished/aborted mirror: stale event
            until = self._replay_until.get(ev.rid, 0)
            if ev.token is not None:
                if ev.n_out <= until:
                    # failover replay: the re-decoded token must equal the
                    # one already delivered — THE bit-identity oracle
                    if req.out_tokens[ev.n_out - 1] != ev.token:
                        raise RuntimeError(
                            f"failover replay diverged for rid {ev.rid} at "
                            f"token {ev.n_out}: delivered "
                            f"{req.out_tokens[ev.n_out - 1]}, replayed "
                            f"{ev.token}")
                    self.fleet.tokens_replayed += 1
                    if not ev.finished:
                        continue   # duplicate: suppress, client saw it
                elif ev.n_out != len(req.out_tokens) + 1:
                    raise RuntimeError(
                        f"rid {ev.rid}: token event n_out={ev.n_out} does "
                        f"not extend the delivered stream of "
                        f"{len(req.out_tokens)}")
                else:
                    req.out_tokens.append(ev.token)
            if ev.finished:
                req.done = True
                req.finish_reason = ev.finish_reason
                self.fleet.completed += 1
                self._finish_bookkeeping(ev.rid)
            self._out_buffer.append(ev)

    # ------------------------------------------------------------------
    # periodic checkpoints (the failover source)
    # ------------------------------------------------------------------
    def _checkpoint(self) -> None:
        for w in self._active:
            if w.state != ALIVE or w.pending is not None:
                continue
            if not w.load.get("n_active"):
                continue   # nothing in slots — nothing to snapshot
            try:
                w.transport.send("checkpoint", {})
                w.pending = "checkpoint"
                rep = w.transport.recv(self.reply_timeout_s)
            except TransportTimeout:
                w.misses += 1
                self.fleet.heartbeat_misses += 1
                w.state = SUSPECT
                continue    # the late blob is booked when it arrives
            except TransportError:
                self._failover(w)
                continue
            try:
                self._process_reply(w, rep)
            except RemoteError:
                pass   # a failed snapshot is a missed checkpoint, not death
        self._persist()

    def _note_checkpoint(self, snaps: dict) -> None:
        for rid, blob in snaps.items():
            if rid in self._reqs:
                self._ckpt[rid] = blob

    def _persist(self) -> None:
        """Write the blob set through the atomic-write checkpoint
        machinery (tmp dir + rename, keep-last-K) — snapshot bytes ride as
        uint8 leaves keyed by rid."""
        if not self._ckpt:
            return
        tree = {str(rid): np.frombuffer(blob, dtype=np.uint8)
                for rid, blob in self._ckpt.items()}
        try:
            save_checkpoint(self.ckpt_dir, self._step_n, tree, keep=2)
        except OSError:
            return   # disk trouble: in-memory blobs still cover failover
        self._saved = dict(self._ckpt)

    def _restore_saved(self) -> dict[int, bytes]:
        """Re-read the last persisted blob set from disk — failover
        restores through the same machinery an operator would after a
        full router restart.  Falls back to the in-memory copy."""
        if not self._saved:
            return {}
        like = {str(rid): np.zeros(len(blob), np.uint8)
                for rid, blob in self._saved.items()}
        try:
            tree, _ = restore_checkpoint(self.ckpt_dir, like)
        except Exception:
            return dict(self._saved)
        return {int(rid): arr.tobytes() for rid, arr in tree.items()}

    # ------------------------------------------------------------------
    # failover
    # ------------------------------------------------------------------
    def _failover(self, w: WorkerHandle) -> None:
        """Declare ``w`` dead and re-dispatch everything it owned."""
        if w.state == DEAD:
            return
        t0 = time.monotonic()
        w.state = DEAD
        w.pending = None
        w.transport.close()
        self.fleet.workers_lost += 1
        self.fleet.failovers += 1
        self._promote_spare()
        victims = [rid for rid, own in self._owner.items() if own is w]
        disk = self._restore_saved() if victims else {}
        for rid in victims:
            self._owner.pop(rid, None)
            req = self._reqs.get(rid)
            if req is None or req.done:
                continue
            self.fleet.requests_replayed += 1
            blob = disk.get(rid, self._ckpt.get(rid))
            if blob is None or not self._recover_from_snapshot(rid, blob):
                # queued (never checkpointed) or nowhere to inject:
                # replay from the client's request record, from scratch
                self._replay_until[rid] = len(req.out_tokens)
                self._backlog.append(self._clone(req))
        self.recovery_s.append(time.monotonic() - t0)

    def _promote_spare(self) -> None:
        while self._spares:
            s = self._spares.pop(0)
            try:
                unwrap(s.transport.call("ping", {}, self.reply_timeout_s))
            except TransportError:
                s.state = DEAD
                s.transport.close()
                continue
            s.spare = False
            s.state = ALIVE
            self._active.append(s)
            return

    def _recover_from_snapshot(self, rid: int, blob: bytes) -> bool:
        """Inject a checkpointed slot into a surviving worker; reconcile
        the mirror with tokens the checkpoint holds but the client never
        saw (decoded between the last delivery and the snapshot)."""
        req = self._reqs[rid]
        try:
            snap = SlotSnapshot.from_bytes(blob)
        except Exception:
            return False
        snap_toks = list(snap.req.out_tokens)
        common = min(len(snap_toks), len(req.out_tokens))
        if snap_toks[:common] != req.out_tokens[:common]:
            raise RuntimeError(
                f"checkpoint for rid {rid} diverges from the delivered "
                f"stream within the first {common} tokens")
        # order candidates: most free pages first (same spirit as the
        # in-process Router's donor choice)
        cands = sorted(self._routable(),
                       key=lambda w: -w.load.get("free_pages", 0))
        for w in cands:
            try:
                self._call(w, "inject_slot", {"snap": snap})
            except RemoteError:
                continue          # no slot / OutOfPages there: next
            except TransportError:
                continue          # that worker just failed over too
            self._owner[rid] = w
            # checkpoint tokens the client never saw are first deliveries,
            # not replays: emit them now so the stream stays gapless
            for n in range(len(req.out_tokens) + 1, len(snap_toks) + 1):
                req.out_tokens.append(snap_toks[n - 1])
                self._out_buffer.append(RequestOutput(
                    rid=rid, token=snap_toks[n - 1], n_out=n))
            self._replay_until[rid] = len(req.out_tokens)
            return True
        return False

    # ------------------------------------------------------------------
    # migration (the in-process Router's rebalance, over the wire)
    # ------------------------------------------------------------------
    def _maybe_migrate(self) -> None:
        ws = self._routable()
        if len(ws) < 2:
            return
        for src in ws:
            if not src.load.get("page_starved"):
                continue
            try:
                cand = self._call(src, "migration_candidate")
            except TransportError:
                return
            if cand is None:
                continue
            rid, n_pages = cand
            donor = None
            for d in sorted((x for x in ws if x is not src),
                            key=lambda x: -x.load.get("free_pages", 0)):
                try:
                    if self._call(d, "can_accept", {"n_pages": n_pages}):
                        donor = d
                        break
                except TransportError:
                    continue
            if donor is None:
                continue
            try:
                snap = self._call(src, "snapshot_slot", {"rid": rid})
            except (RemoteError, TransportError):
                return
            try:
                self._call(donor, "inject_slot", {"snap": snap})
                self._owner[rid] = donor
            except (RemoteError, TransportError):
                # donor raced out of room or died holding nothing: the
                # source just freed these pages, so it takes the slot back
                try:
                    self._call(src, "inject_slot", {"snap": snap})
                except (RemoteError, TransportError):
                    # source gone too — the snapshot in hand IS a fresh
                    # checkpoint: stash it and let failover place it
                    self._ckpt[rid] = snap.to_bytes()
                    if self._owner.get(rid) is not None:
                        self._owner.pop(rid, None)
                    req = self._reqs.get(rid)
                    if req is not None and not req.done:
                        self.fleet.requests_replayed += 1
                        if not self._recover_from_snapshot(
                                rid, self._ckpt[rid]):
                            self._replay_until[rid] = len(req.out_tokens)
                            self._backlog.append(self._clone(req))
                return
            self.migrations += 1
            return   # at most one move per step

    # ------------------------------------------------------------------
    # drive helpers + stats (the Router surface)
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
    def workers(self) -> list[WorkerHandle]:
        return list(self._active)

    @property
    def spares_left(self) -> int:
        return len(self._spares)

    @property
    def stats(self) -> list[EngineStats]:
        """Per-worker EngineStats (last known for DEAD/SUSPECT workers),
        index-aligned with ``workers``."""
        out = []
        for w in self._active:
            if w.state == ALIVE and w.pending is None:
                try:
                    d = self._call(w, "stats")
                    known = {f.name for f in
                             EngineStats.__dataclass_fields__.values()}
                    w.last_stats = EngineStats(
                        **{k: v for k, v in d.items() if k in known})
                except (TransportError, RemoteError):
                    pass
            out.append(w.last_stats)
        return out

    def summary(self) -> str:
        stats = self.stats
        lines = [f"fleet: {len(self._active)} worker(s) "
                 f"policy={self.policy} spares_left={self.spares_left} "
                 f"migrations={self.migrations} "
                 f"workers_lost={self.fleet.workers_lost} "
                 f"failovers={self.fleet.failovers} replayed req/tok="
                 f"{self.fleet.requests_replayed}"
                 f"/{self.fleet.tokens_replayed} "
                 f"heartbeat_misses={self.fleet.heartbeat_misses}"]
        if self.recovery_s:
            lines[0] += (f" recovery p50="
                         f"{float(np.median(self.recovery_s)):.3f}s")
        for w, s in zip(self._active, stats):
            lines.append(f"  [{w.name} {w.state}] {s.summary()}")
        return "\n".join(lines)

    def close(self) -> None:
        """Shut every worker down (best effort) and drop the checkpoint
        dir if this router created it."""
        for w in self._active + self._spares:
            if w.alive:
                try:
                    w.transport.call("shutdown", {}, 5.0)
                except TransportError:
                    pass
            w.transport.close()
            if hasattr(w.transport, "terminate"):
                w.transport.terminate()
        if self._own_ckpt_dir:
            shutil.rmtree(self.ckpt_dir, ignore_errors=True)
