"""Pluggable request-scheduling policies for the serving engine.

(The port's own copy of ``repro.serving.scheduler``, which is framework-
free: the same policies, the same ``SamplingParams`` fields.)

The paper's single-batch, bandwidth-starved regime makes *which* request
gets the NPU's scarce pages and FLOPs the first-order serving decision: the
hot KV pool is sized below demand (the flash tier absorbs the overflow, see
``serving/kv_cache.py``), so admission order, preemption choice, and
prefill pacing decide every request's TTFT.  This module is the policy
layer the engine consults at each of those three seams — the on-device
serving surveys (On-Device Language Models, arXiv 2409.00088; Network Edge
Inference for LLMs) both single out request scheduling and latency-SLO
policy as the lever that turns a fast kernel stack into a usable
multi-user edge service.

The :class:`Scheduler` protocol has three decision points:

* ``admit(queue, slots, free_pages) -> AdmitPlan`` — which queued requests
  enter free slots this step, in what order, and whether a running slot
  should be preempted to make room (the plan's ``preempt`` list).
* ``victim(slots) -> int`` — which active slot gives up its pages when the
  hot pool runs dry (the engine suspends it and spills its pages to the
  flash tier).  This is deliberately the same seam a multi-host page
  migration will use to pick which slot moves to a hot spare.
* ``prefill_budget(slot) -> int`` — how many prompt tokens a slot may
  prefill per engine step (chunked prefill): long prompts are split into
  fixed token-budget chunks interleaved with decode steps, so they never
  stall active decode slots.  Logit math is bit-identical to one-shot
  prefill (``models.model.prefill_chunk_into_slot``).

Shipped policies, each mapped to its motivation in the edge-serving
setting:

* :class:`FCFSScheduler` — arrival order; the baseline the paper's
  single-user scenario implies, and the fairest under homogeneous load.
* :class:`PriorityScheduler` — strict priorities with preemption: an
  interactive (high-priority) request arriving at a full batch evicts the
  lowest-priority slot via ``victim()`` instead of queueing behind it —
  the latency-SLO policy of the edge surveys.  Priority inversion is
  pinned by tests/test_scheduler.py.
* :class:`SJFScheduler` — shortest estimated service (prompt + remaining
  decode tokens) first: minimizes mean latency when the NPU is the
  bottleneck, at the cost of long-job starvation under sustained load.
* :class:`DRRScheduler` — deficit round robin across priority classes
  (the flow id is ``Request.priority``): each class earns a token quantum
  per serviced round and admits its FCFS head while the deficit covers the
  head's estimated cost, so no class is starved and bandwidth splits
  proportionally — the classic fair-queueing answer to SJF's starvation.
* :class:`EDFScheduler` — earliest deadline first over ``Request.deadline_s``
  (the SLO budget from arrival): admission by absolute deadline, and the
  pool-pressure ``victim()`` suspends the SLACKEST slot, so urgent requests
  keep both their slot and their pages.  ``bench_serving --trace policy``
  reports each policy's deadline-miss rate.

Policies are host-side control flow only — they never touch device state,
so swapping one in changes *which* jitted calls run, never their traces.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling contract (``serving.sampler.sample_batch``).

    ``temperature <= 0`` is greedy (the default); ``seed`` pins the
    request's sample stream — the key for output index i is
    ``fold_in(PRNGKey(seed), i)``, so a preempt-restart regenerates
    exactly the same continuation.  ``seed=None`` falls back to the
    request id.
    """

    temperature: float = 0.0
    top_k: int = 0        # 0 = disabled
    top_p: float = 1.0    # 1.0 = disabled
    seed: int | None = None


@dataclasses.dataclass(frozen=True)
class SlotView:
    """Immutable snapshot of one engine slot, handed to policy decisions."""

    index: int
    rid: int
    priority: int
    arrival_s: float
    seq_len: int        # current cache length (pages ~ seq_len / page_size)
    n_out: int          # tokens emitted so far
    remaining: int      # max_new_tokens - n_out
    prefilling: bool    # still mid chunked-prefill
    suspended: bool     # pages (partially) spilled to the flash tier
    # ABSOLUTE deadline (arrival_s + Request.deadline_s, same clock as
    # arrival_s); None = no SLO — EDF treats it as infinitely slack
    deadline_s: float | None = None


@dataclasses.dataclass
class AdmitPlan:
    """One admission round's decisions.

    ``order``: queued requests to admit now, in priority order — the engine
    admits a prefix of it (as many as free slots and pages allow; the rest
    keep their queue spot).  ``preempt``: slot indices to preempt-restart
    FIRST (their requests fold generated tokens into the prompt and
    requeue), freeing slots for the head of ``order``.
    """

    order: list = dataclasses.field(default_factory=list)
    preempt: list = dataclasses.field(default_factory=list)


def _service_cost(req) -> int:
    """Estimated whole-lifetime service demand, in tokens."""
    return len(req.prompt) + req.max_new_tokens


_NO_BUDGET = 1 << 30  # "no chunking": any prompt prefills in one shot


class Scheduler:
    """Policy protocol + FCFS defaults.

    ``chunk_tokens`` (all policies): per-step chunked-prefill token budget;
    ``None`` disables chunking (prompts prefill in one shot).
    """

    name = "fcfs"

    def __init__(self, chunk_tokens: int | None = None):
        self.chunk_tokens = chunk_tokens

    # -- admission ---------------------------------------------------------
    def admit(self, queue: list, slots: list, free_pages: int) -> AdmitPlan:
        """queue: waiting Requests (engine order); slots: SlotView | None
        per engine slot; free_pages: hot pages currently allocatable."""
        return AdmitPlan(order=list(queue))

    # -- preemption --------------------------------------------------------
    def victim(self, slots: list) -> int:
        """Pick the slot that gives up its pages under pool pressure.
        Default: the longest sequence — it frees the most pages at once."""
        return max(slots, key=lambda s: s.seq_len).index

    # -- prefill pacing ----------------------------------------------------
    def prefill_budget(self, slot) -> int:
        """Prompt tokens this slot may prefill this engine step."""
        # reprolint: ok boolean-select-trap — 0 and None both mean "no chunking" (chunk_spans rejects budget <= 0)
        return self.chunk_tokens or _NO_BUDGET


class FCFSScheduler(Scheduler):
    """First come, first served — the engine's historical inline policy."""

    name = "fcfs"


class PriorityScheduler(Scheduler):
    """Strict priorities (higher ``Request.priority`` wins), preemptive.

    Admission sorts by (priority desc, arrival, rid).  When the batch is
    full and the queue head outranks the lowest-priority running slot, the
    plan preempt-restarts that slot (at most one per step, so preemption
    pressure stays bounded); under ``kv_tier="flash"`` pool pressure the
    ``victim()`` seam also evicts lowest-priority first, so a high-priority
    arrival is never stalled behind a low-priority slot's pages.
    """

    name = "priority"

    def __init__(self, chunk_tokens: int | None = None,
                 preemptive: bool = True):
        super().__init__(chunk_tokens)
        self.preemptive = preemptive

    @staticmethod
    def _key(req):
        return (-req.priority, req.arrival_s, req.rid)

    def admit(self, queue, slots, free_pages):
        order = sorted(queue, key=self._key)
        preempt: list[int] = []
        if (self.preemptive and order
                and not any(s is None for s in slots)):
            cands = [s for s in slots if s is not None and not s.suspended]
            if cands:
                worst = min(cands, key=lambda s: (s.priority, -s.seq_len))
                if order[0].priority > worst.priority:
                    preempt = [worst.index]
        return AdmitPlan(order=order, preempt=preempt)

    def victim(self, slots):
        return min(slots, key=lambda s: (s.priority, -s.seq_len)).index


class SJFScheduler(Scheduler):
    """Shortest estimated job first (prompt + max_new tokens).

    Minimizes mean latency/TTFT under backlog; long jobs can starve — pair
    with DRR when that matters.  Pool-pressure victims stay the default
    (longest sequence): evicting the biggest footprint frees the most
    pages per suspended request.
    """

    name = "sjf"

    def admit(self, queue, slots, free_pages):
        return AdmitPlan(order=sorted(
            queue, key=lambda r: (_service_cost(r), r.arrival_s, r.rid)))


class DRRScheduler(Scheduler):
    """Deficit round robin across priority classes (flow id =
    ``Request.priority``).

    Every admission round with at least one free slot, the class under the
    round-robin pointer earns ``quantum`` deficit tokens and admits its
    FCFS head while the deficit covers the head's estimated service cost
    (prompt + max_new tokens); unspent deficit carries while the class is
    backlogged and resets when it empties (standard DRR).  Classes with
    cheap requests therefore admit more of them per round — token
    bandwidth, not request count, is what's shared fairly.
    """

    name = "drr"

    def __init__(self, quantum: int = 64, chunk_tokens: int | None = None):
        super().__init__(chunk_tokens)
        self.quantum = quantum
        self._deficit: dict[int, int] = {}
        self._ring: list[int] = []  # round-robin order of backlogged flows
        self._ptr = 0
        # (flow, cost, req) charged last round — refunded if the engine
        # could not actually admit the request (it is still in the queue).
        # Holding the request itself (not just its id) makes the identity
        # check safe against id reuse after garbage collection.
        self._charged: list[tuple[int, int, object]] = []

    def admit(self, queue, slots, free_pages):
        # a plan entry the engine failed to admit (OutOfPages) reappears in
        # the queue: refund its cost so the flow is not charged twice for
        # service it never received.  Settled on the VERY NEXT call — even
        # one that early-returns — so an admitted request that re-enters
        # the queue much later via preempt-restart is never mistaken for a
        # failed admission.
        qids = {id(r) for r in queue}
        for f, cost, req in self._charged:
            if id(req) in qids:
                self._deficit[f] = self._deficit.get(f, 0) + cost
        self._charged = []
        n_free = sum(1 for s in slots if s is None)
        if not queue or n_free == 0:
            return AdmitPlan()
        flows: dict[int, list] = {}
        for r in queue:
            flows.setdefault(r.priority, []).append(r)
        for fl in flows.values():
            fl.sort(key=lambda r: (r.arrival_s, r.rid))
        for f in sorted(flows):
            if f not in self._ring:
                self._ring.append(f)
        self._ring = [f for f in self._ring if f in flows]
        for f in [f for f in self._deficit if f not in flows]:
            del self._deficit[f]  # emptied flow: deficit resets
        want = min(len(queue), n_free)
        order: list = []
        while len(order) < want and self._ring:
            self._ptr %= len(self._ring)
            f = self._ring[self._ptr]
            self._deficit[f] = self._deficit.get(f, 0) + self.quantum
            fl = flows[f]
            while (fl and len(order) < want
                   and self._deficit[f] >= _service_cost(fl[0])):
                r = fl.pop(0)
                self._deficit[f] -= _service_cost(r)
                self._charged.append((f, _service_cost(r), r))
                order.append(r)
            if not fl:
                del flows[f]
                self._deficit.pop(f, None)
                self._ring.remove(f)  # ptr now points at the next flow
            else:
                self._ptr += 1
        return AdmitPlan(order=order)


_NO_DEADLINE = float("inf")


def _abs_deadline(req) -> float:
    """Absolute deadline on the arrival clock (inf = no SLO)."""
    if req.deadline_s is None:
        return _NO_DEADLINE
    arrival = 0.0 if req.arrival_s is None else req.arrival_s
    return arrival + req.deadline_s


class EDFScheduler(Scheduler):
    """Earliest deadline first — the SLO policy (``Request.deadline_s`` is
    the latency budget in seconds from arrival).

    Admission orders by absolute deadline (``arrival_s + deadline_s``;
    requests without one sort last, FCFS among themselves), the classic
    optimal single-resource deadline schedule.  The ``victim()`` seam is
    deadline-aware in the opposite direction: under pool pressure the
    SLACKEST slot (latest absolute deadline; no-deadline slots first,
    longest sequence as tie-break) gives up its pages, so an urgent
    request is never the one suspended to make room.
    """

    name = "edf"

    def admit(self, queue, slots, free_pages):
        return AdmitPlan(order=sorted(
            queue, key=lambda r: (_abs_deadline(r), r.arrival_s, r.rid)))

    def victim(self, slots):
        return max(slots, key=lambda s: (
            s.deadline_s if s.deadline_s is not None else _NO_DEADLINE,
            s.seq_len)).index


POLICIES = {c.name: c for c in
            (FCFSScheduler, PriorityScheduler, SJFScheduler, DRRScheduler,
             EDFScheduler)}


def make_scheduler(policy, **kw) -> Scheduler:
    """Build a scheduler from a policy name (or pass an instance through)."""
    if isinstance(policy, Scheduler):
        return policy
    if policy is None:
        return FCFSScheduler(**kw)
    try:
        return POLICIES[policy](**kw)
    except KeyError:
        raise ValueError(
            f"unknown policy {policy!r}; pick from {sorted(POLICIES)}")
