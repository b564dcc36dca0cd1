"""EngineCore: the per-replica serving loop (continuous mode).

The bottom layer of the port's serving API, as in ``repro.serving.core``::

    ServingClient (serving/client.py)   user-facing handles + global ids
        │ submit / stream / abort
    Router        (serving/router.py)   N replicas, routing policy
        │
    EngineCore    (this module)         ONE replica: slots, paged KV,
                                        scheduler calls

The core owns a fixed-size slot table (the batch).  Requests enter a
queue, claim free slots and prefill together in ONE batched pass
(``models.model.prefill_into_slots``: right-padded to a power-of-two bucket,
the group padded to ``max_batch`` rows by repeating its first row), then
decode step by step (``decode_step_paged`` over every active slot, then
per-request sampling); finished slots free their pages at once.  With a
chunk budget (``scheduler.chunk_tokens``) a prompt longer than the budget
claims its slot and all its pages at admission and prefills one
budget-sized chunk per engine step (``models.model.prefill_chunk_into_slot``,
eagerly, between decode steps), its slot an inactive lane of the decode
step until its last chunk samples its first token: decoding slots keep
emitting a token every step instead of stalling behind one long prefill.
The chunks give the bits of a one-chunk prefill, whatever the budget.
The scheduler (``serving.scheduler``) decides admission order and
preemption victims; when the page pool runs dry the ``exhaust_policy``
either requeues the starved request (``"requeue"``: a mid-decode slot
restarts later with its generated prefix folded into its prompt) or fails
it (``"reject"``).

What the port serves is the JAX engine's continuous path for the dense and
hybrid families with bf16 or int8 page pools (``kv_dtype="int8"``: rows
quantized at their write, one float32 scale per row and head), chunked
prefill for the dense family (a hybrid engine given a budget prefills in
one shot, as the JAX engine's ``_chunk_ok`` makes it), synchronous or
overlapped, with the per-request sampler (greedy, or temperature / top-k /
top-p under jax's threefry keys, ``serving/sampler.py``).  A hybrid slot's
Mamba conv window and SSM state live in the cache's slot-indexed state
pools: a prefill overwrites the slot's rows and decode masks inactive
lanes, and preemption here is requeue-and-re-prefill, so no state
checkpoint is taken (the JAX engine takes one only on its tiered and
migration paths).  The other options of the JAX engine raise until their
slices land: ``mode="wave"``, ``kv_tier="flash"``, ``prefix_cache`` and
slot migration (``snapshot_slot`` / ``inject_slot``).

The device state is the cache dict of ``init_paged_cache`` on ``device``,
whose tensors keep their storage for the engine's life (prefill's new
lengths are copied into ``cache["lens"]``); the block table, last tokens
and active mask live host-side in numpy.  A decode step is one
``serving.graphs.DecodeGraph`` step: the inputs staged into static
buffers, then on CUDA one replayed CUDA graph (the counterpart of the JAX
engine's one jitted dispatch).  The synchronous loop replays the decode
step and samples its logits in a second dispatch (2 dispatches a step,
``EngineStats.decode_dispatches``).

Overlapped decode (``overlap=True``), as in the JAX engine: one fused
decode + sample step a round, whose sampled tokens stay on the device and
chain into the next step (``where(use_dev, tok_dev, tok_host)``), read
back one step late: step N+1 is dispatched before step N's tokens are
read, so the readback overlaps the compute (1 dispatch a step).  Step N's
copy to the host is queued right after its replay, before step N+1's, so
the drain waits for step N only.  Finishes are found at the lagged drain:
length and capacity are predicted on the host one step ahead and masked
out of the next step; a slot that sampled eos runs one speculative step
whose writes stay behind its ``lens`` and whose token a slot-epoch check
discards.  Token streams are bit-identical to the synchronous loop's,
greedy and seed-pinned stochastic (tests/test_torch_overlap.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serving import graphs, sampler
from repro_torch.serving.kv_cache import (OutOfPages, PageAllocator,
                                          pages_needed, prefill_bucket)
from repro_torch.serving.scheduler import (SamplingParams, Scheduler,
                                           SlotView, make_scheduler)


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    priority: int = 0          # higher wins under priority/DRR policies
    # trace arrival time (any monotone clock); None -> stamped at submit
    arrival_s: Optional[float] = None
    deadline_s: Optional[float] = None   # SLO budget in seconds (EDF)
    session: Optional[str] = None        # router affinity key
    sampling: Optional[SamplingParams] = None  # None -> greedy
    temperature: float = 0.0   # legacy alias, folded into ``sampling``
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False  # failed admission under exhaust_policy="reject"
    # eos | length | capacity | rejected | aborted
    finish_reason: Optional[str] = None
    n_folded: int = 0  # out_tokens already folded into prompt by restarts
    n_chunks: int = 0      # chunked-prefill passes run for this request
    n_preempted: int = 0   # restarts suffered
    n_migrated: int = 0    # cross-replica moves (always 0 in this port)
    # lifecycle timestamps (time.monotonic), filled by the engine
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    def __post_init__(self):
        if self.sampling is None:
            self.sampling = SamplingParams(temperature=self.temperature)

    @property
    def admission_wait_s(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> float:
        return self.t_first_token - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """One streamed event of a request's lifetime: a token event, or the
    final event (``finished=True``) with the finish reason and stats."""

    rid: int
    token: Optional[int]
    n_out: int
    finished: bool = False
    finish_reason: Optional[str] = None
    # populated on the final event only
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    sched: Optional[dict] = None   # {"chunks", "preemptions", "wait_s"}


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    prefill_chunks: int = 0    # chunked-prefill passes (chunk granularity)
    decode_steps: int = 0
    # dispatches attributable to decoding: a replayed decode step and a
    # separate sample in the synchronous loop (2 a step), the fused step
    # in the overlapped one (1); on CUDA a dispatch is one graph replay
    decode_dispatches: int = 0
    tokens_out: int = 0
    # synchronous loop: decode + sample; overlapped loop: dispatch time
    # only (the compute is deliberately not awaited)
    wall_decode_s: float = 0.0
    wall_prefill_s: float = 0.0
    admitted: int = 0
    completed: int = 0
    mode: str = ""
    policy: str = ""
    pool_exhausted: int = 0    # OutOfPages events absorbed (requeue/reject)
    rejected: int = 0
    aborted: int = 0
    preemptions: int = 0       # requeue restarts
    admission_wait_s: list = dataclasses.field(default_factory=list)
    ttft_s: list = dataclasses.field(default_factory=list)
    latency_s: list = dataclasses.field(default_factory=list)

    def percentiles(self, series: str = "latency_s",
                    qs: tuple = (50, 90, 99)) -> dict:
        xs = getattr(self, series)
        return {f"p{q}": float(np.percentile(xs, q)) if xs else 0.0
                for q in qs}

    def summary(self) -> str:
        lat = self.percentiles("latency_s")
        adm = self.percentiles("admission_wait_s")
        s = (f"[{self.mode}] policy={self.policy or 'fcfs'} "
             f"requests={self.completed} "
             f"tokens={self.tokens_out} steps={self.decode_steps} "
             f"latency p50/p90/p99="
             f"{lat['p50']:.3f}/{lat['p90']:.3f}/{lat['p99']:.3f}s "
             f"admission p50/p99={adm['p50']:.3f}/{adm['p99']:.3f}s")
        if self.prefill_chunks:
            s += f" prefill_chunks={self.prefill_chunks}"
        if self.pool_exhausted or self.rejected:
            s += (f" pool_exhausted={self.pool_exhausted} "
                  f"rejected={self.rejected} preempt={self.preemptions}")
        return s


def _not_ported(flag: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is not ported to the PyTorch engine yet ({slice_})")


class EngineCore:
    """Single-replica engine over the port's functional model API, on one
    device (``"cuda"`` by default; ``"cpu"`` runs the plain versions)."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_seq: int = 512, eos_id: int = 2,
                 mode: str = "auto",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_tier: str = "none", exhaust_policy: str = "requeue",
                 scheduler: "Scheduler | str | None" = None,
                 overlap: bool = False, prefix_cache: bool = False,
                 kv_dtype: str = "bf16", device: str | torch.device = "cuda"):
        if mode == "auto":
            mode = "continuous"
        if mode == "wave":
            raise _not_ported("mode='wave'", "the shared-cursor cache")
        if mode != "continuous":
            raise ValueError(f"unknown mode {mode!r}")
        if not model_lib.supports_paged(cfg):
            raise _not_ported(f"serving family {cfg.family!r}",
                              "dense and hybrid only; ssm needs wave mode")
        if kv_tier != "none":
            raise _not_ported(f"kv_tier={kv_tier!r}", "the tiered KV slice")
        if prefix_cache:
            raise _not_ported("prefix_cache=True", "the prefix-cache slice")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} not in ('bf16', 'int8')")
        if exhaust_policy not in ("requeue", "reject"):
            raise ValueError(f"exhaust_policy {exhaust_policy!r}")
        self.scheduler = make_scheduler(scheduler)
        # chunk budgets apply where the model can prefill a chunk; other
        # families prefill every prompt in one shot
        self._chunk_ok = model_lib.supports_chunked_prefill(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.mode = mode
        self.overlap = overlap
        # overlapped-loop state: at most one dispatched but undrained fused
        # step; per-slot in-flight token counts (0 or 1) and release epochs
        # that invalidate pending rows whose slot was reassigned since
        self._pending: Optional[dict] = None
        self._inflight: list[int] = [0] * max_batch
        self._slot_epoch: list[int] = [0] * max_batch
        self.exhaust_policy = exhaust_policy
        self.stats = EngineStats(mode=mode, policy=self.scheduler.name)
        self.queue: list[Request] = []
        self.slots: list[Optional[Request]] = [None] * max_batch
        self._events: list[RequestOutput] = []
        self.page_size = page_size
        self.pages_per_slot = pages_needed(max_seq, page_size)
        full_pool = max_batch * self.pages_per_slot + 1
        self.num_pages = full_pool if num_pages is None else num_pages
        self.kv_dtype = kv_dtype
        self.cache = model_lib.init_paged_cache(
            cfg, max_batch, max_seq, page_size=page_size,
            num_pages=self.num_pages, device=self.device, kv_dtype=kv_dtype)
        self.kv_page_bytes = model_lib.kv_page_bytes(
            cfg, page_size, model_lib.paged_pool_dtype(self.cache))
        # host-side bookkeeping: block table, last tokens, per-slot pages
        self.block = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self.last_np = np.zeros((max_batch,), np.int32)
        self.allocator = PageAllocator(self.num_pages)
        self.slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
        self.slot_len: list[int] = [0] * max_batch  # host mirror of lens
        # chunked-prefill state: a prefilling slot holds a request whose
        # prompt is prefilled up to prefill_pos
        self.prefilling: list[bool] = [False] * max_batch
        self.prefill_pos: list[int] = [0] * max_batch
        self.graph = graphs.DecodeGraph(cfg, params, max_batch,
                                        self.pages_per_slot, self.device)

    # ------------------------------------------------------------------
    # command surface: add / abort
    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        if len(req.prompt) >= self.max_seq:
            raise ValueError(f"prompt ({len(req.prompt)}) does not fit "
                             f"max_seq ({self.max_seq})")
        worst = min(self.max_seq, len(req.prompt) + req.max_new_tokens)
        if pages_needed(worst, self.page_size) > self.num_pages - 1:
            raise ValueError(
                f"request needs up to {pages_needed(worst, self.page_size)}"
                f" pages, pool has {self.num_pages - 1}")
        req.t_submit = time.monotonic()
        if req.arrival_s is None:
            req.arrival_s = req.t_submit
        self.queue.append(req)

    def abort_request(self, rid: int) -> bool:
        """Cancel a queued or running request: frees its slot/pages and
        emits exactly one terminal event with ``finish_reason="aborted"``."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._abort(req)
                return True
        for i, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                self._release_slot(i)
                self._abort(req)
                return True
        return False

    def _abort(self, req: Request) -> None:
        req.done = True
        req.finish_reason = "aborted"
        req.t_done = time.monotonic()
        self.stats.aborted += 1
        self._emit(req, None, finished=True)

    def snapshot_slot(self, rid: int, release: bool = True):
        raise _not_ported("snapshot_slot", "the migration slice")

    def inject_slot(self, snap) -> int:
        raise _not_ported("inject_slot", "the migration slice")

    # ------------------------------------------------------------------
    # load introspection (what the router routes on)
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def free_pages(self) -> int:
        return self.allocator.available

    # ------------------------------------------------------------------
    # streaming events
    # ------------------------------------------------------------------
    MAX_PENDING_EVENTS = 1 << 16

    def _emit(self, req: Request, token: Optional[int],
              finished: bool = False) -> None:
        if len(self._events) >= self.MAX_PENDING_EVENTS:
            # shed the oldest half but keep its terminal events
            half = self.MAX_PENDING_EVENTS // 2
            finals = [e for e in self._events[:half] if e.finished]
            self._events = finals + self._events[half:]
        sched = None
        ttft = lat = None
        if finished:
            sched = {"chunks": req.n_chunks, "preemptions": req.n_preempted,
                     "wait_s": (req.admission_wait_s if req.t_admit
                                else None)}
            ttft = req.ttft_s if req.t_first_token else None
            lat = req.latency_s
        self._events.append(RequestOutput(
            rid=req.rid, token=token, n_out=len(req.out_tokens),
            finished=finished,
            finish_reason=req.finish_reason if finished else None,
            ttft_s=ttft, latency_s=lat, sched=sched))

    def drain_outputs(self) -> list[RequestOutput]:
        ev, self._events = self._events, []
        return ev

    def step(self) -> list[RequestOutput]:
        """One admit + decode round; returns the events it produced."""
        self._advance()
        return self.drain_outputs()

    def stream(self, max_steps: int = 10_000):
        steps = 0
        while self.has_work and steps < max_steps:
            if not self._advance():
                break
            steps += 1
            yield from self.drain_outputs()
        yield from self.drain_outputs()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _sample_rows(self, logits: torch.Tensor,
                     items: list[tuple[int, Request]]) -> np.ndarray:
        """One token per (row, request) pair of logits [B, V] (one host
        sync).  Rows not named in ``items`` are garbage.  An all-greedy
        batch takes the argmax; any stochastic row sends the whole batch
        through ``sampler.sample_batch`` (greedy rows still argmax in it).
        """
        if all(req.sampling.temperature <= 0.0 for _, req in items):
            return sampler.greedy(logits).cpu().numpy()
        rows = self._rows_of(logits.shape[0], [
            (row, req, len(req.out_tokens)) for row, req in items])
        seeds, counts, temps, top_k, top_p = (
            torch.from_numpy(a).to(logits.device) for a in rows)
        return sampler.sample_batch(logits, seeds, counts, temps, top_k,
                                    top_p).cpu().numpy()

    @staticmethod
    def _rows_of(b: int, items: list[tuple[int, Request, int]]
                 ) -> tuple[np.ndarray, ...]:
        """Sampling rows (seeds, counts, temperature, top_k, top_p) for
        (row, request, sampler cursor) triples; the other rows greedy."""
        seeds = np.zeros((b,), np.int32)
        counts = np.zeros((b,), np.int32)
        temps = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        top_p = np.ones((b,), np.float32)
        for row, req, count in items:
            sp = req.sampling
            seeds[row] = sp.seed if sp.seed is not None else req.rid
            counts[row] = count
            temps[row] = sp.temperature
            top_k[row] = sp.top_k
            top_p[row] = sp.top_p
        return seeds, counts, temps, top_k, top_p

    def _slot_view(self, i: int) -> SlotView:
        r = self.slots[i]
        # a mid-prefill slot already holds its whole prompt's pages, so
        # victim choices keyed on seq_len see that footprint
        seq = len(r.prompt) if self.prefilling[i] else self.slot_len[i]
        return SlotView(index=i, rid=r.rid, priority=r.priority,
                        arrival_s=r.arrival_s, seq_len=seq,
                        n_out=len(r.out_tokens),
                        remaining=r.max_new_tokens - len(r.out_tokens),
                        prefilling=self.prefilling[i], suspended=False,
                        deadline_s=(r.arrival_s + r.deadline_s
                                    if r.deadline_s is not None else None))

    def _views(self) -> list[Optional[SlotView]]:
        return [self._slot_view(i) if r is not None else None
                for i, r in enumerate(self.slots)]

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        # a fresh copy on the device: the host arrays keep changing
        return torch.tensor(arr, device=self.device)

    def _release_slot(self, i: int) -> None:
        # a pending fused-step row of this slot is stale now: the epoch
        # bump makes the lagged drain skip it
        self._slot_epoch[i] += 1
        self._inflight[i] = 0
        self.slots[i] = None
        self.allocator.free([p for p in self.slot_pages[i] if p != 0])
        self.slot_pages[i] = []
        self.slot_len[i] = 0
        self.prefilling[i] = False
        self.prefill_pos[i] = 0
        self.block[i] = 0
        self.cache["lens"][i] = 0

    def _finish(self, i: int, req: Request, reason: str,
                token: Optional[int] = None) -> None:
        req.done = True
        req.finish_reason = reason
        req.t_done = time.monotonic()
        self.stats.completed += 1
        self.stats.admission_wait_s.append(req.admission_wait_s)
        self.stats.ttft_s.append(req.ttft_s)
        self.stats.latency_s.append(req.latency_s)
        self._release_slot(i)
        self._emit(req, token, finished=True)

    def _reject(self, req: Request) -> None:
        req.done = True
        req.rejected = True
        req.finish_reason = "rejected"
        req.t_done = time.monotonic()
        self.stats.rejected += 1
        self._emit(req, None, finished=True)

    def _preempt_restart(self, i: int, req: Request) -> None:
        """Fold the generated prefix into the prompt and requeue: greedy
        decode, and a seed-pinned draw keyed by (seed, output index),
        regenerate the same continuation."""
        self.stats.preemptions += 1
        req.n_preempted += 1
        req.prompt = req.prompt + req.out_tokens[req.n_folded:]
        req.n_folded = len(req.out_tokens)
        self._release_slot(i)
        self.queue.insert(0, req)

    def _finish_reason_for(self, req: Request, tok: int,
                           seq_len: int) -> Optional[str]:
        if tok == self.eos_id:
            return "eos"
        if len(req.out_tokens) >= req.max_new_tokens:
            return "length"
        if seq_len >= self.max_seq - 1:
            return "capacity"
        return None

    # ------------------------------------------------------------------
    # admission: one batched prefill per step, or a chunked admission
    # ------------------------------------------------------------------
    def _admit_continuous(self) -> None:
        """Claim free slots for the plan's head requests.  Prompts within
        the policy's chunk budget prefill together in one batched pass;
        longer ones claim their slot and pages now and prefill chunk by
        chunk over the following steps (``_prefill_chunks``)."""
        plan = self.scheduler.admit(list(self.queue), self._views(),
                                    self.allocator.available)
        head = next((r for r in plan.order if r in self.queue), None)
        for vi in plan.preempt:
            if not 0 <= vi < self.max_batch or self.slots[vi] is None:
                continue
            if head is not None:
                # restart a victim only if its pages cover the arrival
                victim_pages = sum(1 for p in self.slot_pages[vi] if p != 0)
                need = pages_needed(len(head.prompt), self.page_size)
                if self.allocator.available + victim_pages < need:
                    continue
            self._preempt_restart(vi, self.slots[vi])
        free = [i for i in range(self.max_batch) if self.slots[i] is None]
        group = []
        now = time.monotonic()
        for req in plan.order:
            if not free:
                break
            if req not in self.queue:  # defensive: stale plan entry
                continue
            i = free[0]
            len0 = len(req.prompt)
            try:
                pids = self.allocator.alloc(pages_needed(len0, self.page_size))
            except OutOfPages:
                self.stats.pool_exhausted += 1
                if self.exhaust_policy == "reject":
                    self.queue.remove(req)
                    self._reject(req)
                    continue
                break  # starved request keeps its queue spot for next step
            free.pop(0)
            self.queue.remove(req)
            self.slot_pages[i] = pids
            self.block[i, :len(pids)] = pids
            budget = self.scheduler.prefill_budget(SlotView(
                index=i, rid=req.rid, priority=req.priority,
                arrival_s=req.arrival_s, seq_len=0, n_out=0,
                remaining=req.max_new_tokens, prefilling=True,
                suspended=False,
                deadline_s=(req.arrival_s + req.deadline_s
                            if req.deadline_s is not None else None)))
            if self._chunk_ok and budget < len0:
                self.slots[i] = req
                self.prefilling[i] = True
                self.prefill_pos[i] = 0
                self.slot_len[i] = 0
                if req.t_admit == 0.0:
                    req.t_admit = now
                self.stats.admitted += 1
            else:
                group.append((i, req, len0))
        if not group:
            return
        cap = self.pages_per_slot * self.page_size
        bucket = min(max(prefill_bucket(len(req.prompt))
                         for i, req, len0 in group), cap)
        # pad the group to max_batch rows by REPEATING row 0 (duplicate
        # scatters write identical values), so prefill sees fixed shapes
        rows = group + [group[0]] * (self.max_batch - len(group))
        toks = np.asarray(
            [req.prompt + [0] * (bucket - len(req.prompt))
             for i, req, len0 in rows], np.int32)
        slot_ids = np.asarray([i for i, req, len0 in rows], np.int32)
        true_lens = np.asarray([len0 for i, req, len0 in rows], np.int32)
        t0 = time.monotonic()
        logits, out_cache = model_lib.prefill_into_slots(
            self.params, self.cfg, self._tensor(toks),
            self._tensor(true_lens),
            {**self.cache, "block": self._tensor(self.block)},
            self._tensor(slot_ids))
        # the pools were written in place; the lengths keep their storage,
        # which a captured decode step reads and writes
        self.cache["lens"].copy_(out_cache["lens"])
        self.stats.prefills += 1
        self.stats.admitted += len(group)
        toks_out = self._sample_rows(
            logits, [(row, req) for row, (i, req, len0) in enumerate(group)])
        t1 = time.monotonic()
        self.stats.wall_prefill_s += t1 - t0
        for row, (i, req, len0) in enumerate(group):
            tok = int(toks_out[row])
            if req.t_admit == 0.0:  # restarts keep their first-admit times
                req.t_admit = now
                req.t_first_token = t1
            req.out_tokens.append(tok)
            self.stats.tokens_out += 1
            self.last_np[i] = tok
            self.slot_len[i] = len0
            self.slots[i] = req
            reason = self._finish_reason_for(req, tok, len0)
            if reason is not None:
                self._finish(i, req, reason, token=tok)
            else:
                self._emit(req, tok)

    def _prefill_chunks(self) -> None:
        """Run one prefill chunk (the policy's per-step token budget) for
        every mid-prefill slot.  A slot whose prompt completes samples its
        first token and joins decode from the next lane mask on."""
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None or not self.prefilling[i]:
                continue
            len0 = len(req.prompt)
            pos = self.prefill_pos[i]
            budget = max(1, int(self.scheduler.prefill_budget(
                self._slot_view(i))))
            clen = min(budget, len0 - pos)
            cap = self.pages_per_slot * self.page_size
            # a power-of-two bucket from the page size up: a chunk's
            # compute scales with the budget, not the slot's capacity
            cb = min(prefill_bucket(clen, floor=self.page_size), cap)
            toks = np.zeros((cb,), np.int32)
            toks[:clen] = req.prompt[pos:pos + clen]
            logits, _ = model_lib.prefill_chunk_into_slot(
                self.params, self.cfg, self._tensor(toks), pos, clen,
                {**self.cache, "block": self._tensor(self.block)}, i)
            req.n_chunks += 1
            self.stats.prefill_chunks += 1
            pos += clen
            self.prefill_pos[i] = pos
            self.slot_len[i] = pos
            if pos < len0:
                continue
            self.prefilling[i] = False
            tok = int(self._sample_rows(logits[None], [(0, req)])[0])
            if req.t_first_token == 0.0:
                req.t_first_token = time.monotonic()
            req.out_tokens.append(tok)
            self.stats.tokens_out += 1
            self.last_np[i] = tok
            reason = self._finish_reason_for(req, tok, pos)
            if reason is not None:
                self._finish(i, req, reason, token=tok)
            else:
                self._emit(req, tok)

    def _ensure_pages(self) -> None:
        """Allocate the page each decoding slot's next write lands in; on a
        dry pool, requeue or reject the slot's request."""
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None or self.prefilling[i]:
                continue
            # the next write position counts the in-flight token the host
            # has not drained yet (slot_len is the drained length)
            pj = (self.slot_len[i] + self._inflight[i]) // self.page_size
            if pj < len(self.slot_pages[i]):
                continue
            try:
                pid = self.allocator.alloc(1)[0]
            except OutOfPages:
                self.stats.pool_exhausted += 1
                if self.exhaust_policy == "reject":
                    self._reject(req)
                    self._release_slot(i)
                else:
                    self._preempt_restart(i, req)
                continue
            self.slot_pages[i].append(pid)
            self.block[i, pj] = pid

    # ------------------------------------------------------------------
    # overlapped decode: dispatch step N+1 before reading step N's tokens
    # ------------------------------------------------------------------
    def _sampling_rows(self, items: list[tuple[int, Request]]
                       ) -> tuple[bool, Optional[tuple[np.ndarray, ...]]]:
        """(greedy_only, sampling rows) of a fused step.  The sampler
        cursor (``counts``) indexes the token about to be sampled, which
        trails ``len(out_tokens)`` by the slot's undrained token."""
        if all(req.sampling.temperature <= 0.0 for _, req in items):
            return True, None
        return False, self._rows_of(self.max_batch, [
            (i, req, len(req.out_tokens) + self._inflight[i])
            for i, req in items])

    def _drain_pending(self) -> None:
        """Read back and account the in-flight fused step (no-op without).

        The lagged finish point: eos shows here one engine call after the
        token was computed, and the speculative step a finished slot ran
        in between is discarded by the slot-epoch check."""
        pend, self._pending = self._pending, None
        if pend is not None:
            self._drain_rows(pend)

    def _drain_rows(self, pend: dict) -> None:
        tok_np = self.graph.tokens(pend["tok"])  # waits for THIS step only
        for i, req, seq_after, epoch in pend["rows"]:
            if (req.done or self.slots[i] is not req
                    or self._slot_epoch[i] != epoch):
                continue  # slot released or reassigned since dispatch
            self._inflight[i] -= 1
            t = int(tok_np[i])
            self.last_np[i] = t
            req.out_tokens.append(t)
            self.stats.tokens_out += 1
            self.slot_len[i] = seq_after
            reason = self._finish_reason_for(req, t, seq_after)
            if reason is not None:
                self._finish(i, req, reason, token=t)
            else:
                self._emit(req, t)

    def _overlap_round_continuous(self, active_list: list[bool]) -> None:
        """One overlapped round: dispatch the next fused step, queue its
        tokens' copy to the host, THEN drain the previous step, whose
        readback overlaps the step just queued."""
        items = [(i, self.slots[i]) for i in range(self.max_batch)
                 if active_list[i]]
        greedy_only, rows = self._sampling_rows(items)
        use_dev = np.asarray([n > 0 for n in self._inflight])
        old, self._pending = self._pending, None
        t0 = time.monotonic()
        self.graph.stage(self.last_np, np.asarray(active_list), self.block,
                         use_dev=use_dev, rows=rows)
        self.graph.run("fused_greedy" if greedy_only else "fused",
                       self.cache)
        tok = self.graph.readback()
        # dispatch time only: the compute is deliberately not awaited
        self.stats.wall_decode_s += time.monotonic() - t0
        self.stats.decode_steps += 1
        self.stats.decode_dispatches += 1
        pend_rows = []
        for i, req in items:
            seq_after = self.slot_len[i] + self._inflight[i] + 1
            pend_rows.append((i, req, seq_after, self._slot_epoch[i]))
            self._inflight[i] += 1
        self._pending = {"tok": tok, "rows": pend_rows}
        if old is not None:
            self._drain_rows(old)

    def _mask_predicted_finishes(self, active_list: list[bool]) -> None:
        """Leave out slots whose undrained token already finishes them.

        Length and capacity are predictable on the host one step ahead,
        so those slots run no wasted step; eos shows only at the drain, so
        a slot that sampled it runs one speculative step whose writes land
        beyond its ``lens`` (or are re-prefilled by the next occupant) and
        whose token the epoch check discards."""
        for i in range(self.max_batch):
            if not active_list[i] or not self._inflight[i]:
                continue
            req = self.slots[i]
            if (len(req.out_tokens) + self._inflight[i]
                    >= req.max_new_tokens
                    or self.slot_len[i] + self._inflight[i]
                    >= self.max_seq - 1):
                active_list[i] = False

    def _step_continuous(self) -> bool:
        self._admit_continuous()
        # the chunks run before the lane mask is built: a slot whose last
        # chunk ran decodes in this step (as in the JAX engine)
        self._prefill_chunks()
        if all(s is None for s in self.slots):
            self._drain_pending()  # discard a stale speculative step
            return bool(self.queue)
        self._ensure_pages()
        active_list = [self.slots[i] is not None and not self.prefilling[i]
                       for i in range(self.max_batch)]
        if self.overlap:
            self._mask_predicted_finishes(active_list)
        if not any(active_list):
            self._drain_pending()  # lagged finishes still need to land
            return True
        if self.overlap:
            self._overlap_round_continuous(active_list)
            return True
        t0 = time.monotonic()
        self.graph.stage(self.last_np, np.asarray(active_list), self.block)
        logits = self.graph.run("sync", self.cache)
        self.stats.decode_steps += 1
        self.stats.decode_dispatches += 2  # the decode step + the sample
        tok_np = self._sample_rows(  # one sync per step
            logits, [(i, r) for i, r in enumerate(self.slots)
                     if r is not None and active_list[i]])
        self.stats.wall_decode_s += time.monotonic() - t0
        for i, req in enumerate(self.slots):
            if req is None or not active_list[i]:
                continue
            t = int(tok_np[i])
            self.last_np[i] = t
            req.out_tokens.append(t)
            self.stats.tokens_out += 1
            self.slot_len[i] += 1
            reason = self._finish_reason_for(req, t, self.slot_len[i])
            if reason is not None:
                self._finish(i, req, reason, token=t)
            else:
                self._emit(req, t)
        return True

    # ------------------------------------------------------------------
    def _advance(self) -> bool:
        """Admit + one decode step over the active batch; True if any work."""
        return self._step_continuous()

    def run(self, max_steps: int = 10_000) -> EngineStats:
        steps = 0
        while self.has_work and steps < max_steps:
            if not self._advance():
                break
            steps += 1
        return self.stats
