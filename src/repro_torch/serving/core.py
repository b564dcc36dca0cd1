"""EngineCore: the per-replica serving loop (continuous and wave mode).

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

What the port serves is the JAX engine's continuous path for the dense, moe
and hybrid families with bf16 or int8 page pools (``kv_dtype="int8"``: rows
quantized at their write, one float32 scale per row and head), chunked
prefill for the dense and moe families (a hybrid engine given a budget
prefills in one shot, as the JAX engine's ``_chunk_ok`` makes it),
synchronous or overlapped, with the per-request sampler (greedy, or
temperature / top-k / top-p under jax's threefry keys,
``serving/sampler.py``).  A hybrid slot's Mamba conv window and SSM state
live in the cache's slot-indexed state pools: a prefill overwrites the
slot's rows and decode masks inactive lanes; a suspension, a migration
and a prefix resume point checkpoint them host-side
(``checkpoint_slot_state``) and write them back on resume.

Wave mode (``mode="wave"``; ``mode="auto"`` picks it for the families the
JAX package cannot page, ssm and audio), as in the JAX engine: the legacy
cache keeps one length cursor for every row (``models.model.init_cache``),
so a wave of up to ``max_batch`` requests is admitted only when the whole
batch has drained.  Its prompts are left-padded with token 0 to the wave's
longest and prefilled in one pass (``models.model.prefill``; the audio
family's frames and the vlm family's vision embeddings are zeros, as the
JAX engine feeds them, the cursor counting the vision rows), the pads
attended as the JAX engine attends them; then every row decodes at the
shared cursor (``decode_step``), finished rows riding along, until every
row has finished or the cursor reaches ``max_seq - 1``.  The cursor is
mirrored on the host, so no step reads a device value for it.  The wave
cache is allocated once and overwritten in place by each wave's prefill,
so a captured decode graph keeps its addresses.  A wave engine refuses
int8 pools, the flash tier and the prefix cache with the JAX engine's
``ValueError``; it has no slot to snapshot or inject.  A wave of ssm or
hybrid prompts shorter than the conv window (``ssm_conv - 1`` tokens)
raises ``ValueError`` at its admission (the JAX reference crashes there).

The straggler watchdog (``watchdog(step, dt) -> bool``, the synchronous
loop only, as in the JAX engine): when it flags a decode step, the step
runs again from the state it started from.  The step writes ``lens`` (wave
mode: the cursor ``len``), the K/V row at each active slot's position and,
for the hybrid and ssm families, the Mamba state pools in place under its
graph, so before the first replay the engine keeps a device copy of the
lengths and of the state pools, and on a re-dispatch copies them back on
the compute stream and replays again; a K/V row rewritten at the same
position from the same inputs has the same bits, so the K/V tensors need
no copy.  The copies are taken only with a
watchdog set.  With ``REPRO_SANITIZE=1`` the engine arms the sanitizer
rails (``repro_torch/_sanitize.py``): shadow models of the allocators, the
overlapped loop's dispatch guard over the arrays it stages, and a budget
on the decode graph's captures.

Tiered KV (``kv_tier="flash"``), as in the JAX engine: the hot page pool
may be sized below the demand (``num_pages``); when it runs dry the engine
suspends a victim slot (``scheduler.victim``), spills its pages to the
cold tier and prefetches them back, onto whatever hot pids are free,
before the slot's next decode step; the block table is remapped, so decode
gives the all-resident run's bits.  On a card the cold tier is pinned host
memory: a spill gathers the pages into one device bucket on the compute
stream (``models.model.swap_out_pages``), queues its copy into a pinned
buffer and records an event; the device bucket stays referenced until that
event, and a payload is read (prefetch, snapshot) only after it.  A
prefetch stacks the payloads into a fresh pinned buffer, copies it to the
card without blocking (the pinned allocator reuses the buffer only after
the copy's event) and writes the pages into the pools in place
(``swap_in_pages``: ``index_copy_`` on the page axis), so the pools keep
the storage a captured decode graph reads.  ``flash_pages`` bounds the
tier; a pinned allocation or a copy that fails raises.

Prefix caching (``prefix_cache=True``): finished requests leave their
prefill-written pages in a content-addressed ``kv_cache.PrefixIndex``,
refcounted at the allocator.  An exact-prompt hit maps the shared full
pages, scatters a private copy of the tail page, restores a hybrid slot's
state and samples the first token from the stored prefill logits: zero
prefill dispatches, the cold run's bits.  A partial hit (dense and moe
families, bf16 pools only, as in the JAX engine) maps the cached leading
pages and prefills the suffix through the chunk path from the cached
length.  On a card the chunk kernel gives each query B3's one-shot bits,
so a partial hit equals a cold run bit for bit whether the cold run and
the cached pages came from the one-shot prefill or from chunks.  Idle
cached pages are reclaimed LRU under pressure or, under the flash tier,
spilled under ``("px", key)`` and prefetched on their next hit.

Migration: ``snapshot_slot`` drains a slot (after draining a pending
overlapped step) into a ``SlotSnapshot`` of host tensors (pages,
lengths, sampler cursor, hybrid state, shared pages' chain keys), and
``inject_slot`` resumes it on another engine with the same bits;
``serving/fleet/wire.py`` gives it the JAX package's byte format.

The device state is the cache dict of ``init_paged_cache`` (wave mode:
``init_cache``) on ``device``, whose tensors keep their storage for the
engine's life (prefill's new lengths are copied into ``cache["lens"]`` or
``cache["len"]``); the block table, last tokens and active mask live
host-side in numpy.  A decode step is one
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
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import _sanitize
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models import model as model_lib
from repro_torch.serving import graphs, sampler
from repro_torch.serving.kv_cache import (OutOfPages, PageAllocator,
                                          PrefixIndex, ResumeEntry,
                                          TieredPageAllocator, pages_needed,
                                          prefill_bucket)
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
    n_preempted: int = 0   # restarts + tiered suspensions suffered
    n_migrated: int = 0    # cross-replica slot moves suffered
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

    @property
    def deadline_missed(self) -> bool:
        """True when the request finished more than ``deadline_s`` seconds
        after submission (False without a deadline or before completion)."""
        return (self.deadline_s is not None and self.t_done > 0.0
                and self.latency_s > self.deadline_s)


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
class SlotSnapshot:
    """One slot's entire serving state as host data: the migration wire
    format, field for field the JAX package's ``SlotSnapshot``.

    ``pages[j]`` is the payload tuple of the slot's j-th page, one CPU
    tensor per ``blocks.paged_pool_keys`` component, [L, page, ...]:
    ``(k, v)`` for bf16 pools (mla_moe: the compressed ``(ckv, krope)``
    rows), ``(k, v, k_scale, v_scale)`` for int8 ones;
    ``ssm`` is the ``checkpoint_slot_state`` snapshot of a hybrid slot
    (None otherwise); ``prefix_keys`` maps the slot's shared pages to their
    chain keys (None when the source engine has no prefix cache).  No
    device tensor leaks into it."""

    req: Request
    slot_len: int          # valid cache length (prefill_pos mid-prefill)
    last_token: int        # next decode step's input token
    prefilling: bool       # still mid chunked-prefill
    prefill_pos: int
    pages: list            # [tuple of tensors] per page, in pool-key order
    ssm: object            # checkpoint_slot_state payload (None if none)
    page_size: int
    family: str
    prefix_keys: Optional[dict] = None

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def to_bytes(self) -> bytes:
        """The JAX package's standalone snapshot bytes (``fleet/wire.py``)."""
        from repro_torch.serving.fleet import wire
        return wire.snapshot_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes, expect_family: str = None,
                   expect_page_size: int = None,
                   expect_dtype: str = None) -> "SlotSnapshot":
        """Inverse of :meth:`to_bytes`, with its geometry guard."""
        from repro_torch.serving.fleet import wire
        return wire.snapshot_from_bytes(
            data, expect_family=expect_family,
            expect_page_size=expect_page_size, expect_dtype=expect_dtype)


class _SpillBatch:
    """One spill's gathered pages on their way to the cold tier.

    On a card the copy into pinned host memory is queued on the compute
    stream behind the gather and an event recorded; the device bucket is
    held until that event (so the caching allocator cannot hand its memory
    out while the copy reads it), and the host buffer is read only after
    it.  On the CPU the gathered tensors are the host copy."""

    __slots__ = ("dev", "host", "event")

    def __init__(self, arrays: tuple[torch.Tensor, ...]):
        if arrays[0].device.type == "cuda":
            self.host = tuple(torch.empty(a.shape, dtype=a.dtype,
                                          pin_memory=True) for a in arrays)
            for h, a in zip(self.host, arrays):
                h.copy_(a, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self.dev = arrays
        else:
            self.host, self.event, self.dev = arrays, None, None

    def wait(self) -> tuple[torch.Tensor, ...]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
            self.dev = None
        return self.host


class _LazyPagePayload:
    """A spilled page's payload still on its way to the host: column ``j``
    of a :class:`_SpillBatch`, materialized when a prefetch or a snapshot
    reads it, so a spill never blocks the engine loop."""

    __slots__ = ("batch", "j")

    def __init__(self, batch: _SpillBatch, j: int):
        self.batch, self.j = batch, j

    def materialize(self) -> tuple[torch.Tensor, ...]:
        return tuple(h[:, self.j] for h in self.batch.wait())


def _payload_host(payload) -> tuple[torch.Tensor, ...]:
    if isinstance(payload, _LazyPagePayload):
        return payload.materialize()
    return payload


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
    straggler_events: int = 0  # decode steps the watchdog re-dispatched
    # synchronous loop: decode + sample; overlapped loop: dispatch time
    # only (the compute is deliberately not awaited)
    wall_decode_s: float = 0.0
    wall_prefill_s: float = 0.0
    admitted: int = 0
    completed: int = 0
    mode: str = ""
    policy: str = ""
    # pool pressure / tiered KV accounting
    pool_exhausted: int = 0    # OutOfPages events absorbed (requeue/reject)
    rejected: int = 0
    aborted: int = 0
    preemptions: int = 0       # slots suspended (tiered) or restarted
    resumes: int = 0           # suspended slots brought back hot
    migrated_out: int = 0      # slots drained via snapshot_slot
    migrated_in: int = 0       # slots resumed via inject_slot
    kv_spill_pages: int = 0
    kv_prefetch_pages: int = 0
    kv_spill_bytes: float = 0.0
    kv_prefetch_bytes: float = 0.0
    # prefix-cache accounting
    prefix_lookups: int = 0    # admissions that consulted the index
    prefix_hits: int = 0       # admissions served any cached prefix
    prefix_hit_pages: int = 0  # shared pages mapped instead of re-prefilled
    prefix_tokens_reused: int = 0  # prompt tokens whose prefill was skipped
    cow_copies: int = 0        # private copies made of (tail) shared pages
    # fleet health / failover accounting (the FleetRouter's fleet-level
    # stats object; always 0 on a single in-process engine)
    workers_lost: int = 0      # workers declared dead (SIGKILL, hang, EOF)
    failovers: int = 0         # failover passes run (one per lost worker)
    requests_replayed: int = 0  # requests re-dispatched by failover
    tokens_replayed: int = 0   # re-decoded tokens suppressed as duplicates
    heartbeat_misses: int = 0  # reply deadlines blown (straggle signal)
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
        if self.kv_spill_pages or self.pool_exhausted or self.rejected:
            s += (f" pool_exhausted={self.pool_exhausted} "
                  f"rejected={self.rejected} preempt={self.preemptions} "
                  f"spill/prefetch pages={self.kv_spill_pages}"
                  f"/{self.kv_prefetch_pages}")
        if self.migrated_out or self.migrated_in:
            s += (f" migrated out/in={self.migrated_out}"
                  f"/{self.migrated_in}")
        if self.prefix_lookups:
            s += (f" prefix hits={self.prefix_hits}/{self.prefix_lookups}"
                  f" pages={self.prefix_hit_pages}"
                  f" tokens={self.prefix_tokens_reused}"
                  f" cow={self.cow_copies}")
        if self.workers_lost or self.failovers or self.heartbeat_misses:
            s += (f" workers_lost={self.workers_lost} "
                  f"failovers={self.failovers} replayed "
                  f"req/tok={self.requests_replayed}/{self.tokens_replayed} "
                  f"heartbeat_misses={self.heartbeat_misses}")
        return s


def _not_ported(flag: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is not ported to the PyTorch engine yet ({slice_})")


def _batch_extras(cfg: ModelConfig, batch: int,
                  device: torch.device) -> dict:
    """The prefill's extra inputs, as the JAX engine makes them: the audio
    family's frame embeddings, zeros [batch, encoder_seq, d_model] bf16;
    the vlm family's vision embeddings, zeros [batch, n_vision, d_model]
    bf16 (the stub frontend's, constant per config)."""
    if cfg.family == "audio":
        return {"frames": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)}
    if cfg.family == "vlm":
        return {"vision_embeds": torch.zeros(
            (batch, cfg.n_vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=device)}
    return {}


class EngineCore:
    """Single-replica engine over the port's functional model API, on one
    device (``"cuda"`` by default; ``"cpu"`` runs the plain versions)."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_seq: int = 512, eos_id: int = 2,
                 watchdog: Optional[Callable[[int, float], bool]] = None,
                 straggler_timeout_s: float = 5.0, mode: str = "auto",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_tier: str = "none", exhaust_policy: str = "requeue",
                 flash_pages: Optional[int] = None,
                 scheduler: "Scheduler | str | None" = None,
                 overlap: bool = False, prefix_cache: bool = False,
                 kv_dtype: str = "bf16", device: str | torch.device = "cuda"):
        if overlap and watchdog is not None:
            raise ValueError(
                "overlap=True keeps one decode step in flight past the host "
                "readback, so the watchdog's replay-from-pre-step-state "
                "re-dispatch contract cannot hold; use the synchronous loop "
                "with a watchdog")
        if mode == "auto":
            mode = "wave" if model_lib.wave_only(cfg) else "continuous"
        if mode not in ("continuous", "wave"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "continuous" and model_lib.wave_only(cfg):
            raise ValueError(
                f"continuous mode needs a paged KV cache; family "
                f"{cfg.family!r} has recurrent state tied to the shared "
                f"cursor — use mode='wave'")
        if mode == "continuous" and not model_lib.supports_paged(cfg):
            raise _not_ported(f"serving family {cfg.family!r}",
                              "dense, vlm, moe, mla_moe, hybrid, ssm and "
                              "audio only")
        if kv_tier not in ("none", "flash"):
            raise ValueError(f"kv_tier {kv_tier!r} not in ('none', 'flash')")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} not in ('bf16', 'int8')")
        if kv_dtype == "int8" and mode != "continuous":
            raise ValueError("kv_dtype='int8' needs mode='continuous' (only "
                             "the paged pools quantize per page row)")
        if exhaust_policy not in ("requeue", "reject"):
            raise ValueError(f"exhaust_policy {exhaust_policy!r}")
        if kv_tier == "flash" and mode != "continuous":
            raise ValueError("kv_tier='flash' needs mode='continuous'")
        if prefix_cache and mode != "continuous":
            raise ValueError(
                "prefix_cache=True needs mode='continuous' (the wave cache "
                "has no page pool to share)")
        self.scheduler = make_scheduler(scheduler)
        # chunk budgets apply where the model can prefill a chunk; other
        # families prefill every prompt in one shot
        self._chunk_ok = (mode == "continuous"
                          and model_lib.supports_chunked_prefill(cfg))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.watchdog = watchdog
        self.straggler_timeout_s = straggler_timeout_s
        self.mode = mode
        self.overlap = overlap
        self._san = _sanitize.load()  # None unless REPRO_SANITIZE=1
        # overlapped-loop state: at most one dispatched but undrained fused
        # step; per-slot in-flight token counts (0 or 1) and release epochs
        # that invalidate pending rows whose slot was reassigned since
        self._pending: Optional[dict] = None
        self._inflight: list[int] = [0] * max_batch
        self._slot_epoch: list[int] = [0] * max_batch
        self.kv_tier = kv_tier
        self.exhaust_policy = exhaust_policy
        self.stats = EngineStats(mode=mode, policy=self.scheduler.name)
        self.queue: list[Request] = []
        self.slots: list[Optional[Request]] = [None] * max_batch
        self._events: list[RequestOutput] = []
        self.kv_dtype = kv_dtype
        self._px: Optional[PrefixIndex] = None  # set in continuous mode
        if mode == "wave":
            self._init_wave()
            return
        self.page_size = page_size
        self.pages_per_slot = pages_needed(max_seq, page_size)
        full_pool = max_batch * self.pages_per_slot + 1
        self.num_pages = full_pool if num_pages is None else num_pages
        self.cache = model_lib.init_paged_cache(
            cfg, max_batch, max_seq, page_size=page_size,
            num_pages=self.num_pages, device=self.device, kv_dtype=kv_dtype)
        self.kv_page_bytes = model_lib.kv_page_bytes(
            cfg, page_size, model_lib.paged_pool_dtype(self.cache))
        # hybrid: per-slot Mamba state checkpoints, taken on suspend
        self._has_state = model_lib.has_slot_state(cfg)
        self._ssm_ckpt: dict[int, object] = {}
        # host-side bookkeeping: block table, last tokens, per-slot pages
        self.block = np.zeros((max_batch, self.pages_per_slot), np.int32)
        self.last_np = np.zeros((max_batch,), np.int32)
        if kv_tier == "flash":
            self.allocator = TieredPageAllocator(self.num_pages, flash_pages)
        else:
            self.allocator = PageAllocator(self.num_pages)
        # prefix cache: the content-addressed page index and, per slot,
        # {page_idx: chain key} of the pages it maps from the index
        self._px = PrefixIndex(page_size) if prefix_cache else None
        self.slot_shared: list[dict[int, bytes]] = [
            {} for _ in range(max_batch)]
        self._px_pin: set[bytes] = set()  # keys mid-acquire (shed shield)
        # per-slot page lists mirror the block table; a 0 entry marks a
        # page currently cold (spilled to the flash tier)
        self.slot_pages: list[list[int]] = [[] for _ in range(max_batch)]
        self.slot_len: list[int] = [0] * max_batch  # host mirror of lens
        self.suspended: list[bool] = [False] * max_batch
        self.resume_order: list[int] = []  # FIFO of suspended slots
        self._resumed_now: set[int] = set()
        self._idle_steps = 0  # consecutive steps with nothing decodable
        # chunked-prefill state: a prefilling slot holds a request whose
        # prompt is prefilled up to prefill_pos
        self.prefilling: list[bool] = [False] * max_batch
        self.prefill_pos: list[int] = [0] * max_batch
        self.graph = graphs.DecodeGraph(cfg, params, max_batch,
                                        self.pages_per_slot, self.device)

    def _init_wave(self) -> None:
        """Wave mode's state: the shared-cursor cache (allocated once, each
        wave's prefill overwrites it in place), the last tokens and the
        cursor mirrored on the host, the prefill's extra inputs."""
        b = self.max_batch
        self.cache = model_lib.init_cache(self.cfg, b, self.max_seq,
                                          device=self.device)
        self._wave_last_np = np.zeros((b,), np.int32)
        self._wave_len = 0  # host mirror of cache["len"]
        self._extras = _batch_extras(self.cfg, b, self.device)
        self.graph = graphs.DecodeGraph(self.cfg, self.params, b, 0,
                                        self.device, wave=True)

    # ------------------------------------------------------------------
    # command surface: add / abort
    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        if self._cache_len0(req) >= self.max_seq:
            raise ValueError(f"prompt ({len(req.prompt)}) does not fit "
                             f"max_seq ({self.max_seq})")
        if self.mode == "continuous":
            # the whole-lifetime page demand of one request must fit the
            # hot pool, or requeue / suspend-and-resume could never finish
            worst = min(self.max_seq,
                        self._cache_len0(req) + req.max_new_tokens)
            if pages_needed(worst, self.page_size) > self.num_pages - 1:
                raise ValueError(
                    f"request needs up to "
                    f"{pages_needed(worst, self.page_size)} pages, hot pool "
                    f"has {self.num_pages - 1}")
        req.t_submit = time.monotonic()
        if req.arrival_s is None:
            req.arrival_s = req.t_submit
        self.queue.append(req)

    # the historical name (``serving.engine.ServingEngine``'s surface);
    # Router and new code use add_request
    submit = add_request

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
                if self.mode == "continuous":
                    self._release_slot(i)
                else:
                    self.slots[i] = None
                self._abort(req)
                return True
        return False

    def _cache_len0(self, req: Request) -> int:
        """Valid cache length right after prefill (vision tokens
        included)."""
        extra = self.cfg.n_vision_tokens if self.cfg.family == "vlm" else 0
        return len(req.prompt) + extra

    def _abort(self, req: Request) -> None:
        req.done = True
        req.finish_reason = "aborted"
        req.t_done = time.monotonic()
        self.stats.aborted += 1
        self._emit(req, None, finished=True)

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
    def n_free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    @property
    def free_pages(self) -> int:
        """Hot pages currently allocatable (the free slots in wave mode,
        which has no page pool)."""
        if self.mode != "continuous":
            return self.n_free_slots
        return self.allocator.available

    @property
    def page_starved(self) -> bool:
        """True when this replica cannot make progress on all it holds: a
        suspended slot waits for pages, or nothing in the queue can claim a
        slot and its prefill pages.  The router's migration trigger."""
        if self.mode != "continuous":
            return False
        if any(self.suspended):
            return True
        if not self.queue:
            return False
        if self.n_free_slots == 0:
            return True
        need = min(pages_needed(self._cache_len0(r), self.page_size)
                   for r in self.queue)
        return need > self.allocator.available + self._px_reclaimable

    def migration_candidate(self) -> Optional[tuple[int, int]]:
        """``(rid, n_pages)`` of the slot this replica would rather hand to
        a peer, or None: suspended slots first, then, with a backlogged
        queue and no free slot, the scheduler's victim."""
        if self.mode != "continuous":
            return None
        if self.resume_order:
            i = self.resume_order[0]
        elif self.queue and self.n_free_slots == 0:
            views = [self._slot_view(j) for j, r in enumerate(self.slots)
                     if r is not None and not self.suspended[j]]
            if not views:
                return None
            i = self.scheduler.victim(views)
            if self.slots[i] is None:  # defensive: policy returned junk
                return None
        else:
            return None
        return self.slots[i].rid, len(self.slot_pages[i])

    def can_accept(self, n_pages: int) -> bool:
        """Whether ``inject_slot`` of an ``n_pages`` snapshot would succeed
        without evicting anyone: a free slot plus the pages, with one page
        of growth headroom."""
        return (self.mode == "continuous" and not self.page_starved
                and self.n_free_slots > 0
                and n_pages <= self.pages_per_slot
                and (self.allocator.available + self._px_reclaimable
                     >= n_pages + 1))

    @property
    def _px_reclaimable(self) -> int:
        """Idle (refcount-0) hot prefix-cache pages: freeable on demand."""
        return self._px.n_idle_hot if self._px is not None else 0

    # ------------------------------------------------------------------
    # snapshot / inject (cross-replica slot migration)
    # ------------------------------------------------------------------
    def snapshot_slot(self, rid: int, release: bool = True) -> SlotSnapshot:
        """Drain request ``rid``'s slot into a :class:`SlotSnapshot` and
        release it here (the request is not finished: it continues where
        the snapshot is injected).  Hot pages come out through one gather,
        cold ones from the tier's store, so a suspended slot snapshots
        without a prefetch.  ``release=False`` leaves the slot running and
        the tier intact (a checkpoint; serialize it before the next step)."""
        if self.mode != "continuous":
            raise ValueError("snapshot_slot needs mode='continuous'")
        # an in-flight fused step's token must land in out_tokens /
        # slot_len / last_np before they are copied out
        self._drain_pending()
        for i, req in enumerate(self.slots):
            if req is not None and req.rid == rid:
                break
        else:
            raise KeyError(f"request {rid} is not active in any slot")
        n_pages = len(self.slot_pages[i])
        pages: list = [None] * n_pages
        hot = [(j, pid) for j, pid in enumerate(self.slot_pages[i])
               if pid != 0]
        if hot:
            payloads = self._gather_pages([pid for _, pid in hot])
            for (j, _pid), payload in zip(hot, payloads):
                pages[j] = payload
        for j, pid in enumerate(self.slot_pages[i]):
            if pid == 0:  # cold: the payload is host-side (or on its way)
                pages[j] = _payload_host(
                    self.allocator.fetch((i, j)) if release
                    else self.allocator.peek((i, j)))
        snap = SlotSnapshot(
            req=req, slot_len=self.slot_len[i],
            last_token=int(self.last_np[i]),
            prefilling=self.prefilling[i], prefill_pos=self.prefill_pos[i],
            pages=pages,
            ssm=(model_lib.checkpoint_slot_state(self.cache, i)
                 if self._has_state else None),
            page_size=self.page_size, family=self.cfg.family,
            prefix_keys=(dict(self.slot_shared[i]) if self._px is not None
                         else None))
        if release:
            self._release_slot(i)
            req.n_migrated += 1
            self.stats.migrated_out += 1
        return snap

    def inject_slot(self, snap: SlotSnapshot) -> int:
        """Resume a snapshotted request in a free slot here; returns the
        slot index.  The pages scatter onto fresh pids (the prefetch path,
        a block-table remap), ``lens`` and the sampler cursor come from the
        snapshot and a hybrid slot's state through ``restore_slot_state``,
        all in place, so decode continues with the unmigrated run's bits."""
        if self.mode != "continuous":
            raise ValueError("inject_slot needs mode='continuous'")
        if snap.family != self.cfg.family or snap.page_size != self.page_size:
            raise ValueError(
                f"snapshot ({snap.family}, page_size={snap.page_size}) does "
                f"not match replica ({self.cfg.family}, {self.page_size})")
        if snap.n_pages > self.pages_per_slot:
            raise ValueError(f"snapshot holds {snap.n_pages} pages, slots "
                             f"here cap at {self.pages_per_slot}")
        free = [i for i in range(self.max_batch) if self.slots[i] is None]
        if not free:
            raise OutOfPages("no free slot to inject into")
        i = free[0]
        # re-share against the local index where it holds a carried chain
        # key (equal keys: the same tokens prefilled with the same params),
        # copy the rest; carried keys the index lacks register the copy
        shared_map = (dict(snap.prefix_keys or {})
                      if self._px is not None else {})
        reuse_idx = sorted(j for j, k in shared_map.items()
                           if j < snap.n_pages
                           and self._px.get(k) is not None)
        acquired = self._px_acquire([shared_map[j] for j in reuse_idx])
        fresh_idx = [j for j in range(snap.n_pages) if j not in set(reuse_idx)]
        try:
            fresh = self._alloc_pages(len(fresh_idx))
        except OutOfPages:
            for j in reuse_idx:
                self._px_release_key(shared_map[j])
            raise
        if fresh_idx:
            self._scatter_pages(fresh, [snap.pages[j] for j in fresh_idx])
        pids = [0] * snap.n_pages
        for j, pid in zip(reuse_idx, acquired):
            pids[j] = pid
        for j, pid in zip(fresh_idx, fresh):
            pids[j] = pid
        self.slot_shared[i] = {j: shared_map[j] for j in reuse_idx}
        if self._px is not None:
            for j, key in shared_map.items():
                if (j not in self.slot_shared[i] and j < snap.n_pages
                        and self._px.get(key) is None):
                    self._px.insert(key, pids[j])
                    self.slot_shared[i][j] = key
        self.slot_pages[i] = pids
        self.block[i, :snap.n_pages] = pids
        self.slot_len[i] = snap.slot_len
        self.cache["lens"][i] = snap.slot_len
        self.last_np[i] = snap.last_token
        self.prefilling[i] = snap.prefilling
        self.prefill_pos[i] = snap.prefill_pos
        if self._has_state and snap.ssm is not None:
            model_lib.restore_slot_state(self.cache, i, snap.ssm)
        self.slots[i] = snap.req
        self.stats.migrated_in += 1
        return i

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
        if self.mode == "continuous":
            # a mid-prefill slot already holds its whole prompt's pages, so
            # victim choices keyed on seq_len see that footprint
            prefilling = self.prefilling[i]
            seq = self._cache_len0(r) if prefilling else self.slot_len[i]
            suspended = self.suspended[i]
        else:
            seq = len(r.prompt) + len(r.out_tokens)
            prefilling = suspended = False
        return SlotView(index=i, rid=r.rid, priority=r.priority,
                        arrival_s=r.arrival_s, seq_len=seq,
                        n_out=len(r.out_tokens),
                        remaining=r.max_new_tokens - len(r.out_tokens),
                        prefilling=prefilling,
                        suspended=suspended,
                        deadline_s=(r.arrival_s + r.deadline_s
                                    if r.deadline_s is not None else None))

    def _views(self) -> list[Optional[SlotView]]:
        return [self._slot_view(i) if r is not None else None
                for i, r in enumerate(self.slots)]

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        # a fresh copy on the device: the host arrays keep changing
        return torch.tensor(arr, device=self.device)

    # ------------------------------------------------------------------
    # tiered KV: spill / prefetch / suspend / resume
    # ------------------------------------------------------------------
    def _page_ids(self, pids: list[int]) -> torch.Tensor:
        # the exact page list: the port has no trace to pad a bucket for
        return torch.tensor(pids, dtype=torch.long, device=self.device)

    def _gather_pages(self, pids: list[int]) -> list[tuple[torch.Tensor, ...]]:
        """Hot pages as per-page host payload tuples (one CPU tensor per
        pool component), through one ``swap_out_pages`` gather and one
        synchronous copy to the host; each column is copied out so a
        payload does not pin the whole gathered bucket.  The payload format
        of the tier's cold store and of a snapshot."""
        host = [a.cpu() for a in model_lib.swap_out_pages(
            self.cache, self._page_ids(pids))]
        return [tuple(a[:, j].clone() for a in host)
                for j in range(len(pids))]

    def _scatter_pages(self, pids: list[int], payloads: list) -> None:
        """Write per-page payload tuples onto freshly allocated hot pids:
        one stacked host buffer per component (pinned on a card, so its
        copy to the card does not block the host; the pinned allocator
        hands the buffer out again only after that copy's event), then one
        ``swap_in_pages`` in place.  The caller remaps the owning
        block-table row.  Shared by the tier's prefetch and inject."""
        payloads = [_payload_host(p) for p in payloads]
        pools = [self.cache[k] for k in blocks.paged_pool_keys(self.cache)]
        comps = []
        for c, pool in enumerate(pools):
            parts = [p[c] for p in payloads]
            shape = (parts[0].shape[0], len(parts), *parts[0].shape[1:])
            buf = torch.empty(shape, dtype=pool.dtype,
                              pin_memory=self.device.type == "cuda")
            torch.stack([x.to(pool.dtype) for x in parts], dim=1, out=buf)
            comps.append(buf.to(self.device, non_blocking=True))
        model_lib.swap_in_pages(self.cache, self._page_ids(pids), *comps)

    def _spill(self, items: list[tuple[tuple, int]]) -> int:
        """Swap ``(key=(slot, page_idx), pid)`` hot pages out to the cold
        tier; returns how many moved.  With a bounded tier, items past its
        capacity go back on the eviction queue instead of half-spilling
        (which would leak their hot pids)."""
        room = self.allocator.flash_available
        if room is not None and len(items) > room and self._px is not None:
            # cold cached-prefix payloads are droppable (nobody maps them;
            # a re-miss re-prefills): shed LRU ones for room
            for key in self._px.cold_idle_keys(len(items) - room):
                if key in self._px_pin:
                    continue  # mid-acquire, about to prefetch
                self.allocator.drop_slot(
                    lambda k, key=key: k == ("px", key))
                self._px.drop(key)
            room = self.allocator.flash_available
        if room is not None and len(items) > room:
            for key, pid in items[room:]:
                self.allocator.mark_evictable(key, pid)
            items = items[:room]
        if not items:
            return 0
        pids = [pid for _, pid in items]
        # one gather, its copy to pinned host memory queued behind it;
        # the payloads are read only after the copy's event
        batch = _SpillBatch(model_lib.swap_out_pages(
            self.cache, self._page_ids(pids)))
        for j, (key, _pid) in enumerate(items):
            self.allocator.store(key, _LazyPagePayload(batch, j))
            if key[0] == "px":
                # an idle cached-prefix page going cold: no block-table row
                # to clear, just the index residency flip
                self._px.mark_cold(key[1])
            else:
                slot, page_idx = key
                self.block[slot, page_idx] = 0
                self.slot_pages[slot][page_idx] = 0
        self.allocator.free(pids)
        self.stats.kv_spill_pages += len(pids)
        self.stats.kv_spill_bytes += len(pids) * self.kv_page_bytes
        return len(items)

    def _prefetch_slot(self, i: int) -> bool:
        """Bring all of slot ``i``'s cold pages back hot (before its next
        decode step); False when the hot pool cannot take them yet."""
        keys = self.allocator.cold_keys(lambda k: k[0] == i)
        if not keys:
            return True
        need = len(keys)
        if self.allocator.available < need:
            short = need - self.allocator.available
            self._spill(self.allocator.pop_evictable(
                short, exclude=lambda k: k[0] == i))
        if self.allocator.available < need:
            return False
        keys.sort(key=lambda k: k[1])
        pids = self.allocator.alloc(need)
        self._scatter_pages(pids, [self.allocator.fetch(k) for k in keys])
        # residency-aware block-table remap: the pages came back on new pids
        for key, pid in zip(keys, pids):
            self.block[i, key[1]] = pid
            self.slot_pages[i][key[1]] = pid
        self.stats.kv_prefetch_pages += need
        self.stats.kv_prefetch_bytes += need * self.kv_page_bytes
        return True

    def _suspend(self, i: int) -> None:
        """Preempt slot ``i``: it stops decoding and its pages become LRU
        eviction candidates, oldest (lowest page index) first.  A hybrid
        slot's Mamba state is checkpointed host-side and written back on
        resume."""
        self.suspended[i] = True
        self.resume_order.append(i)
        self.stats.preemptions += 1
        self.slots[i].n_preempted += 1
        if self._has_state:
            self._ssm_ckpt[i] = model_lib.checkpoint_slot_state(self.cache, i)
        for page_idx, pid in enumerate(self.slot_pages[i]):
            # shared prefix pages stay hot while mapped (other slots may
            # read them); they become spill candidates once idle
            if pid != 0 and page_idx not in self.slot_shared[i]:
                self.allocator.mark_evictable((i, page_idx), pid)

    def _resume_suspended(self) -> None:
        """Head-of-line resume: the oldest suspended slot gets first claim
        on freed pages (evicting other suspended slots' pages if need be),
        so every preempted request comes back."""
        while self.resume_order:
            i = self.resume_order[0]
            if not self._prefetch_slot(i):
                break
            self.resume_order.pop(0)
            self.suspended[i] = False
            self.allocator.unmark_slot(lambda k, i=i: k[0] == i)
            if self._has_state and i in self._ssm_ckpt:
                model_lib.restore_slot_state(self.cache, i,
                                             self._ssm_ckpt.pop(i))
            self._resumed_now.add(i)
            self.stats.resumes += 1

    def _make_room(self, n: int, avoid: frozenset = frozenset()) -> None:
        """Free hot pages until ``n`` are available: spill LRU eviction
        candidates first, then suspend the policy's victim slot and retry.
        ``avoid`` shields slots (e.g. ones resumed this very step)."""
        while self.allocator.available < n:
            short = n - self.allocator.available
            items = self.allocator.pop_evictable(short)
            if items:
                if self._spill(items) == 0:
                    return  # tier full: eviction cannot free anything
                continue
            victims = [i for i, r in enumerate(self.slots)
                       if r is not None and not self.suspended[i]
                       and i not in avoid]
            if not victims:
                return
            choice = self.scheduler.victim(
                [self._slot_view(i) for i in victims])
            if choice not in victims:  # defensive: policy returned junk
                choice = max(victims, key=lambda i: self.slot_len[i])
            self._suspend(choice)

    def _alloc_pages(self, n: int, avoid: frozenset = frozenset()
                     ) -> list[int]:
        if self.kv_tier == "flash" and self.allocator.available < n:
            self._make_room(n, avoid)
        if self._px is not None and self.allocator.available < n:
            # LRU-reclaim idle cached-prefix pages: live slots beat the
            # cache (a reclaimed prefix re-prefills on its next miss)
            self._px_reclaim(n - self.allocator.available)
        return self.allocator.alloc(n)

    def _px_reclaim(self, n: int) -> None:
        ents = self._px.pop_idle_hot(n)
        if not ents:
            return
        if self.kv_tier == "flash":
            keys = {("px", key) for key, _pid in ents}
            self.allocator.unmark_slot(lambda k: k in keys)
        self.allocator.free([pid for _key, pid in ents])

    # ------------------------------------------------------------------
    # prefix cache: lookup / acquire / release / register / COW
    # ------------------------------------------------------------------
    def _key_tokens(self, req: Request) -> list[int]:
        """The token sequence the prefix hash chains over, one entry per
        cache position (``_cache_len0`` long).  vlm prepends a ``-1``
        sentinel per vision token: the vision embeds are config-constant
        here, so equal sentinels imply equal page contents, as real tokens
        do for the text families."""
        if self.cfg.family == "vlm":
            return [-1] * self.cfg.n_vision_tokens + list(req.prompt)
        return list(req.prompt)

    def _px_lookup(self, req: Request, len0: int):
        """``("resume", entry)`` for an exact-prompt resume point,
        ``("partial", keys)`` for a leading run of cached full pages (the
        chunk-capable family, bf16 pools), or None.  A resume entry citing
        a reclaimed page entry dies here."""
        if self._px is None:
            return None
        self.stats.prefix_lookups += 1
        kt = self._key_tokens(req)
        rkey = self._px.resume_key(kt)
        rent = self._px.get_resume(rkey)
        if rent is not None:
            if all(self._px.get(k) is not None for k in rent.page_keys):
                return ("resume", rent)
            self._px.drop_resume(rkey)
        if not self._chunk_ok:
            return None
        if self.kv_dtype == "int8":
            # the one-shot prefill and a chunked suffix replay agree only to
            # quantization precision under int8 pools, which would break
            # "a prompt's pages are a function of its tokens"; resume hits
            # replay stored bits and stay
            return None
        keys = self._px.page_keys(kt)
        # at least one token remains to prefill: the suffix chunk gives the
        # first token's logits
        n = min(self._px.match(keys), (len0 - 1) // self.page_size)
        if n >= 1:
            return ("partial", keys[:n])
        return None

    def _px_acquire(self, keys: list[bytes],
                    avoid: frozenset = frozenset()) -> list[int]:
        """Map cached page entries into a slot: incref hot ones (an idle
        entry leaves the idle LRU and its spill candidacy), prefetch cold
        ones onto fresh pids.  Returns pids in ``keys`` order; OutOfPages
        rolls the acquisition back."""
        done: list[bytes] = []
        cold: list[bytes] = []
        for k in keys:
            ent = self._px.get(k)
            if ent.cold:
                cold.append(k)
                continue
            if self.allocator.incref(ent.pid) == 1:
                self._px.unpark(k)
                if self.kv_tier == "flash":
                    self.allocator.unmark_slot(
                        lambda kk, k=k: kk == ("px", k))
            done.append(k)
        if cold:
            # pop the payloads before allocating: _make_room may shed cold
            # prefix payloads for room, and _px_pin shields these
            payloads = [self.allocator.fetch(("px", k)) for k in cold]
            self._px_pin.update(cold)
            try:
                npids = self._alloc_pages(len(cold), avoid=avoid)
            except OutOfPages:
                for k, p in zip(cold, payloads):
                    self.allocator.store(("px", k), p)
                for k in done:
                    self._px_release_key(k)
                raise
            finally:
                self._px_pin.difference_update(cold)
            self._scatter_pages(npids, payloads)
            for k, pid in zip(cold, npids):
                self._px.mark_hot(k, pid)
            self.stats.kv_prefetch_pages += len(cold)
            self.stats.kv_prefetch_bytes += len(cold) * self.kv_page_bytes
        return [self._px.get(k).pid for k in keys]

    def _px_release_key(self, key: bytes) -> None:
        """Drop one slot's reference; at 0 the page parks on the idle LRU
        (cached for the next hit) and becomes a spill candidate."""
        ent = self._px.get(key)
        if self.allocator.decref(ent.pid) == 0:
            self._px.park(key)
            if self.kv_tier == "flash":
                self.allocator.mark_evictable(("px", key), ent.pid)

    def _px_register_prompt(self, i: int, req: Request, len0: int,
                            logits_row: torch.Tensor) -> None:
        """Register slot ``i``'s freshly prefill-written prompt pages and
        an exact-prompt resume point, right after a one-shot prefill or a
        chunked prefill's last chunk; never decode-written pages."""
        kt = self._key_tokens(req)
        keys = self._px.page_keys(kt)
        shared = self.slot_shared[i]
        for j, key in enumerate(keys):
            if j in shared:
                continue  # a partial hit already maps the index's page
            if self._px.get(key) is None:
                self._px.insert(key, self.slot_pages[i][j])
                shared[j] = key
            # else: a twin prompt of the same group registered its page
        rkey = self._px.resume_key(kt)
        if self._px.peek_resume(rkey) is None:
            tail_len = len0 - len(keys) * self.page_size
            tail = (self._gather_pages([self.slot_pages[i][len(keys)]])[0]
                    if tail_len else None)
            self._px.put_resume(rkey, ResumeEntry(
                page_keys=keys, tail=tail, tail_len=tail_len,
                logits=logits_row.clone(), length=len0,
                ssm=(model_lib.checkpoint_slot_state(self.cache, i)
                     if self._has_state else None)))

    def _px_cow(self, i: int, pj: int) -> None:
        """Copy-on-write: give slot ``i`` a private copy of its shared page
        ``pj`` before a write dirties it (a safety net: registered pages
        lie behind every write frontier)."""
        key = self.slot_shared[i][pj]
        payload = self._gather_pages([self.slot_pages[i][pj]])[0]
        pid = self._alloc_pages(
            1, avoid=frozenset({i}) | self._resumed_now)[0]
        self._scatter_pages([pid], [payload])
        del self.slot_shared[i][pj]
        self._px_release_key(key)
        self.slot_pages[i][pj] = pid
        self.block[i, pj] = pid
        self.stats.cow_copies += 1

    def _admit_resume_hit(self, i: int, req: Request, len0: int,
                          rent: ResumeEntry, now: float) -> None:
        """Admit an exact-prompt hit with zero prefill dispatches: map the
        shared full pages, scatter the stored tail page onto a private
        page, restore a hybrid slot's state and sample the first token
        from the stored prefill logits: every bit consumed is the cold
        run's."""
        avoid = frozenset(self._resumed_now)
        shared = self._px_acquire(rent.page_keys, avoid=avoid)
        tail: list[int] = []
        if rent.tail_len:
            try:
                tail = self._alloc_pages(1, avoid=avoid)
            except OutOfPages:
                for k in rent.page_keys:
                    self._px_release_key(k)
                raise
            self._scatter_pages(tail, [rent.tail])
            self.stats.cow_copies += 1
        pids = shared + tail
        self.slot_pages[i] = pids
        self.block[i, :len(pids)] = pids
        self.slot_shared[i] = dict(enumerate(rent.page_keys))
        self.slot_len[i] = rent.length
        self.cache["lens"][i] = rent.length
        self.prefilling[i] = False
        self.prefill_pos[i] = 0
        if self._has_state and rent.ssm is not None:
            model_lib.restore_slot_state(self.cache, i, rent.ssm)
        self.slots[i] = req
        self.stats.admitted += 1
        self.stats.prefix_hits += 1
        self.stats.prefix_hit_pages += len(shared)
        self.stats.prefix_tokens_reused += rent.length
        tok = int(self._sample_rows(rent.logits[None], [(0, req)])[0])
        t1 = time.monotonic()
        if req.t_admit == 0.0:  # restarts keep their first-admit times
            req.t_admit = now
            req.t_first_token = t1
        req.out_tokens.append(tok)
        self.stats.tokens_out += 1
        self.last_np[i] = tok
        reason = self._finish_reason_for(req, tok, rent.length)
        if reason is not None:
            self._finish(i, req, reason, token=tok)
        else:
            self._emit(req, tok)

    def _admit_partial_hit(self, i: int, req: Request, len0: int,
                           keys: list[bytes], now: float) -> None:
        """Admit a partial hit: map the cached leading pages, allocate the
        rest and enter the chunk path at the cached length."""
        avoid = frozenset(self._resumed_now)
        cached = len(keys) * self.page_size
        shared = self._px_acquire(keys, avoid=avoid)
        try:
            fresh = self._alloc_pages(
                pages_needed(len0, self.page_size) - len(keys), avoid=avoid)
        except OutOfPages:
            for k in keys:
                self._px_release_key(k)
            raise
        pids = shared + fresh
        self.slot_pages[i] = pids
        self.block[i, :len(pids)] = pids
        self.slot_shared[i] = dict(enumerate(keys))
        self.slots[i] = req
        self.prefilling[i] = True
        self.prefill_pos[i] = cached
        self.slot_len[i] = cached
        self.cache["lens"][i] = cached
        if req.t_admit == 0.0:
            req.t_admit = now
        self.stats.admitted += 1
        self.stats.prefix_hits += 1
        self.stats.prefix_hit_pages += len(keys)
        self.stats.prefix_tokens_reused += cached

    def prefix_hit_estimate(self, req: Request) -> int:
        """Prompt tokens this replica's prefix cache could serve ``req``
        without prefilling (the router's ``least_loaded`` discount and
        ``session_affinity`` placement); LRU-neutral."""
        if self._px is None:
            return 0
        kt = self._key_tokens(req)
        rent = self._px.peek_resume(self._px.resume_key(kt))
        if rent is not None and all(
                self._px.get(k) is not None for k in rent.page_keys):
            return rent.length
        if not self._chunk_ok:
            return 0
        n = min(self._px.match(self._px.page_keys(kt)),
                (self._cache_len0(req) - 1) // self.page_size)
        return n * self.page_size

    def clear_prefix_cache(self) -> int:
        """Drop every idle cached prefix page (hot and cold) and every
        resume entry; pages mapped by live slots stay shared.  Returns the
        number of page entries dropped."""
        if self._px is None:
            return 0
        ents = self._px.pop_idle_hot(1 << 30)
        if ents:
            if self.kv_tier == "flash":
                keys = {("px", k) for k, _pid in ents}
                self.allocator.unmark_slot(lambda kk: kk in keys)
            self.allocator.free([pid for _k, pid in ents])
        cold = self._px.cold_idle_keys(1 << 30)
        for key in cold:
            self.allocator.drop_slot(lambda k, key=key: k == ("px", key))
            self._px.drop(key)
        self._px.clear_resume()
        return len(ents) + len(cold)

    # ------------------------------------------------------------------
    # release / finish / restart
    # ------------------------------------------------------------------
    def _release_slot(self, i: int) -> None:
        # a pending fused-step row of this slot is stale now: the epoch
        # bump makes the lagged drain skip it
        self._slot_epoch[i] += 1
        self._inflight[i] = 0
        self.slots[i] = None
        # shared pages decref (at 0 they park on the index's idle LRU);
        # exclusively owned pages free outright, and the allocator's
        # refcount guard raises for a misclassified shared page
        own = [p for j, p in enumerate(self.slot_pages[i])
               if p != 0 and j not in self.slot_shared[i]]
        self.allocator.free(own)
        for j in self.slot_shared[i]:
            self._px_release_key(self.slot_shared[i][j])
        self.slot_shared[i] = {}
        if self.kv_tier == "flash":
            self.allocator.drop_slot(lambda k, i=i: k[0] == i)
            if self.suspended[i]:
                self.suspended[i] = False
                self.resume_order.remove(i)
        self.slot_pages[i] = []
        self.slot_len[i] = 0
        self.prefilling[i] = False
        self.prefill_pos[i] = 0
        self.block[i] = 0
        self._ssm_ckpt.pop(i, None)
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
        if self.mode == "continuous":
            self._release_slot(i)
        else:
            self.slots[i] = None
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
    # admission: prefix hits, one batched prefill per step, or a chunked
    # admission
    # ------------------------------------------------------------------
    def _admit_continuous(self) -> None:
        """Claim free slots for the plan's head requests.  Prefix hits
        admit without a group prefill; prompts within the policy's chunk
        budget prefill together in one batched pass; longer ones claim
        their slot and pages now and prefill chunk by chunk over the
        following steps (``_prefill_chunks``)."""
        plan = self.scheduler.admit(list(self.queue), self._views(),
                                    self.allocator.available)
        head = next((r for r in plan.order if r in self.queue), None)
        for vi in plan.preempt:
            if (not 0 <= vi < self.max_batch or self.slots[vi] is None
                    or self.suspended[vi]):
                continue
            if head is not None and self.kv_tier != "flash":
                # futility gate: without a flash tier, restarting a victim
                # whose pages still do not cover the arrival's prefill only
                # throws its progress away; the tier can always spill
                victim_hot = sum(1 for p in self.slot_pages[vi] if p != 0)
                need = pages_needed(self._cache_len0(head), self.page_size)
                if self.allocator.available + victim_hot < need:
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
            len0 = self._cache_len0(req)
            hit = self._px_lookup(req, len0)
            try:
                if hit is not None and hit[0] == "resume":
                    self._admit_resume_hit(i, req, len0, hit[1], now)
                    free.pop(0)
                    self.queue.remove(req)
                    continue
                if hit is not None and hit[0] == "partial":
                    self._admit_partial_hit(i, req, len0, hit[1], now)
                    free.pop(0)
                    self.queue.remove(req)
                    continue
                pids = self._alloc_pages(
                    pages_needed(len0, self.page_size),
                    avoid=frozenset(self._resumed_now))
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
        # the group's bucket, capped so bucket + vision tokens still fits a
        # slot's block-table row
        extra = max(len0 - len(req.prompt) for i, req, len0 in group)
        cap = self.pages_per_slot * self.page_size - extra
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
            self._tensor(slot_ids),
            _batch_extras(self.cfg, len(rows), self.device))
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
            if self._px is not None:
                # register before any finish below: the pages outlive the
                # slot as cached entries even for one-token requests
                self._px_register_prompt(i, req, len0, logits[row])
            reason = self._finish_reason_for(req, tok, len0)
            if reason is not None:
                self._finish(i, req, reason, token=tok)
            else:
                self._emit(req, tok)

    def _prefill_chunks(self) -> int:
        """Run one prefill chunk (the policy's per-step token budget) for
        every mid-prefill slot; returns how many ran.  A slot whose prompt
        completes samples its first token and joins decode from the next
        lane mask on."""
        ran = 0
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None or not self.prefilling[i] or self.suspended[i]:
                continue
            len0 = self._cache_len0(req)
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
            ran += 1
            pos += clen
            self.prefill_pos[i] = pos
            self.slot_len[i] = pos
            if pos < len0:
                continue
            self.prefilling[i] = False
            if self._px is not None:
                self._px_register_prompt(i, req, len0, logits)
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
        return ran

    def _ensure_pages(self) -> None:
        """Allocate the page each decoding slot's next write lands in; on a
        dry pool, preempt (tiered: suspend and spill; untiered: requeue or
        reject)."""
        for i in range(self.max_batch):
            req = self.slots[i]
            if req is None or self.suspended[i] or self.prefilling[i]:
                continue
            # the next write position counts the in-flight token the host
            # has not drained yet (slot_len is the drained length)
            pj = (self.slot_len[i] + self._inflight[i]) // self.page_size
            try:
                if pj < len(self.slot_pages[i]):
                    if self._px is not None and pj in self.slot_shared[i]:
                        # the next write lands in a shared page: copy it
                        # before it can dirty the other readers
                        self._px_cow(i, pj)
                    continue
                pid = self._alloc_pages(
                    1, avoid=frozenset({i}) | self._resumed_now)[0]
            except OutOfPages:
                self.stats.pool_exhausted += 1
                if self.kv_tier == "flash":
                    self._suspend(i)
                elif self.exhaust_policy == "reject":
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
    def _sampling_rows(self, items: list[tuple[int, Request]],
                       lag: Optional[Callable[[int], int]] = None
                       ) -> tuple[bool, Optional[tuple[np.ndarray, ...]]]:
        """(greedy_only, sampling rows) of a fused step.  The sampler
        cursor (``counts``) indexes the token about to be sampled, which
        trails ``len(out_tokens)`` by the slot's undrained tokens,
        ``lag(i)`` (default: the slot's in-flight count)."""
        if all(req.sampling.temperature <= 0.0 for _, req in items):
            return True, None
        lag = lag or (lambda i: self._inflight[i])
        return False, self._rows_of(self.max_batch, [
            (i, req, len(req.out_tokens) + lag(i)) for i, req in items])

    def _drain_pending(self) -> None:
        """Read back and account the in-flight fused step (no-op without).

        The lagged finish point: eos shows here one engine call after the
        token was computed, and the speculative step a finished slot ran
        in between is discarded by the slot-epoch check."""
        pend, self._pending = self._pending, None
        if pend is not None:
            self._drain_rows(pend)

    def _drain_rows(self, pend: dict) -> None:
        if self._san is not None and pend.get("san") is not None:
            # the step is about to be read back: the host arrays it was
            # staged from must hold what was dispatched (aliasing guard)
            self._san.check_drain(pend["san"])
        tok_np = self.graph.tokens(pend["tok"])  # waits for THIS step only
        if self.mode != "continuous":
            for i, req, seq_after in pend["rows"]:
                if req.done or self.slots[i] is not req:
                    continue
                t = int(tok_np[i])
                self._wave_last_np[i] = t
                req.out_tokens.append(t)
                self.stats.tokens_out += 1
                reason = self._finish_reason_for(req, t, seq_after)
                if reason is not None:
                    self._finish(i, req, reason, token=t)
                else:
                    self._emit(req, t)
            return
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
        # snapshots, as the JAX engine stages them: the drain below
        # rewrites ``last_np`` (a spill ``block``) while this step is in
        # flight, and the sanitizer's guard hashes what was staged
        last_np = self.last_np.copy()
        block = self.block.copy()
        active = np.asarray(active_list)
        self.graph.stage(last_np, active, block, use_dev=use_dev, rows=rows)
        self.graph.run("fused_greedy" if greedy_only else "fused",
                       self.cache)
        tok = self.graph.readback()
        # dispatch time only: the compute is deliberately not awaited
        self.stats.wall_decode_s += time.monotonic() - t0
        san = None
        if self._san is not None:
            sp = rows if rows is not None else (None,) * 5
            san = self._san.guard_dispatch(
                self.stats.decode_steps, last_np=last_np, block=block,
                use_dev=use_dev, active=active, seeds=sp[0], counts=sp[1],
                temps=sp[2], topk=sp[3], topp=sp[4])
            self._san.check_retrace(self.graph, "decode_sample")
        self.stats.decode_steps += 1
        self.stats.decode_dispatches += 1
        pend_rows = []
        for i, req in items:
            seq_after = self.slot_len[i] + self._inflight[i] + 1
            pend_rows.append((i, req, seq_after, self._slot_epoch[i]))
            self._inflight[i] += 1
        self._pending = {"tok": tok, "rows": pend_rows, "san": san}
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
        self._resumed_now = set()
        if self.kv_tier == "flash":
            self._resume_suspended()
        self._admit_continuous()
        # the chunks run before the lane mask is built: a slot whose last
        # chunk ran decodes in this step (as in the JAX engine)
        chunks_ran = self._prefill_chunks()
        if all(s is None for s in self.slots):
            self._drain_pending()  # discard a stale speculative step
            return bool(self.queue)
        self._ensure_pages()
        active_list = [self.slots[i] is not None and not self.suspended[i]
                       and not self.prefilling[i]
                       for i in range(self.max_batch)]
        if self.overlap:
            self._mask_predicted_finishes(active_list)
        if not any(active_list):
            had_pending = self._pending is not None
            self._drain_pending()  # lagged finishes still need to land
            if chunks_ran or had_pending:
                self._idle_steps = 0  # chunk or drain progress is progress
                return True
            # everything suspended and nothing resumed: a full bounded tier
            # can wedge (no spill room, no free hot pages); after a second
            # step without progress, restart the head slot, which frees its
            # pages outright
            self._idle_steps += 1
            if self.resume_order and self._idle_steps >= 2:
                i = self.resume_order[0]
                self.stats.pool_exhausted += 1
                self._preempt_restart(i, self.slots[i])
                self._idle_steps = 0
            return True
        self._idle_steps = 0
        if self.overlap:
            self._overlap_round_continuous(active_list)
            return True
        t0 = time.monotonic()
        active = np.asarray(active_list)
        kept = self._keep_step_state() if self.watchdog is not None else None
        self.graph.stage(self.last_np, active, self.block)
        logits = self.graph.run("sync", self.cache)
        dt = time.monotonic() - t0
        if self.watchdog is not None and self.watchdog(
                self.stats.decode_steps, dt):
            # re-dispatch from the state the step started from
            self.stats.straggler_events += 1
            self._restore_step_state(kept)
            self.graph.stage(self.last_np, active, self.block)
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

    def _keep_step_state(self) -> dict:
        """Device copies of what a decode step overwrites with new values
        in place: the lengths and the Mamba state pools (the watchdog's
        re-dispatch source)."""
        return graphs.keep_step_state(self.cache)

    def _restore_step_state(self, kept: dict) -> None:
        """Copy :meth:`_keep_step_state`'s tensors back in place (the
        storage a captured graph reads stays put)."""
        graphs.restore_step_state(self.cache, kept)

    # ------------------------------------------------------------------
    # wave admission and decode over the shared-cursor cache
    # ------------------------------------------------------------------
    def _admit_wave(self) -> None:
        """The shared cursor forces lockstep decode, so new requests start
        only when the whole batch has drained.  The scheduler still orders
        the wave (nothing is preempted: no slot has a cache of its own)."""
        if any(s is not None for s in self.slots):
            return
        # with overlap, the call that drained a wave's last tokens has
        # already dispatched one speculative step, all of whose rows are
        # stale now: retire it before the next wave
        self._drain_pending()
        if not self.queue:
            return
        plan = self.scheduler.admit(list(self.queue), self._views(), 1 << 30)
        wave = [r for r in plan.order if r in self.queue][:self.max_batch]
        if not wave:
            return
        plen = max(len(r.prompt) for r in wave)
        if self.cfg.family in ("ssm", "hybrid") \
                and plen < self.cfg.ssm_conv - 1:
            raise ValueError(
                f"a wave whose longest prompt has {plen} tokens is shorter "
                f"than the conv window (ssm_conv - 1 = "
                f"{self.cfg.ssm_conv - 1} tokens); the JAX reference crashes "
                f"on such a wave")
        for r in wave:
            self.queue.remove(r)
        now = time.monotonic()
        # every prompt right-aligned to the wave's longest, padded in front
        # with token 0 (which the prefill attends, as in JAX)
        toks = np.zeros((self.max_batch, plen), np.int32)
        for row, r in enumerate(wave):
            toks[row, plen - len(r.prompt):] = r.prompt
        t0 = time.monotonic()
        logits, out = model_lib.prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device),
            self.cache, self._extras)
        self.cache["len"].copy_(out["len"])
        self.stats.prefills += 1
        self.stats.admitted += len(wave)
        tok_np = self._sample_rows(logits, list(enumerate(wave)))
        self._wave_last_np = np.asarray(tok_np, np.int32).copy()
        # the cursor counts the vlm family's vision rows (the JAX engine's
        # host mirror leaves them out, and so lets a write pass max_seq)
        self._wave_len = plen + self._cache_len0(wave[0]) - len(wave[0].prompt)
        t1 = time.monotonic()
        self.stats.wall_prefill_s += t1 - t0
        for i, r in enumerate(wave):
            self.slots[i] = r
            r.t_admit = now
            r.t_first_token = t1
            tok = int(tok_np[i])
            r.out_tokens.append(tok)
            self.stats.tokens_out += 1
            reason = self._finish_reason_for(r, tok, len(r.prompt))
            if reason == "capacity":
                reason = None  # the shared cursor is checked at decode
            if reason is not None:
                self._finish(i, r, reason, token=tok)
            else:
                self._emit(r, tok)

    def _overlap_round_wave(self) -> None:
        """Wave mode's overlapped round: dispatch the next fused step, then
        drain the previous one, as in continuous mode, minus slot churn (no
        admission mid-wave, no epochs: a row is live while ``slots[i] is
        req``)."""
        items = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        old, self._pending = self._pending, None
        live = set()
        if old is not None:
            for i, req, _cursor in old["rows"]:
                if self.slots[i] is req and not req.done:
                    live.add(i)
        if self._wave_len >= self.max_seq - 1:
            # the shared cursor at capacity: nothing more may be dispatched
            # (a write at max_seq would leave the cache); the drain below
            # finishes every surviving row on capacity
            if old is not None:
                self._drain_rows(old)
            return
        greedy_only, rows = self._sampling_rows(
            items, lag=lambda i: 1 if i in live else 0)
        use_dev = np.asarray([i in live for i in range(self.max_batch)])
        t0 = time.monotonic()
        # a snapshot: the drain below rewrites ``_wave_last_np`` while this
        # step is in flight, and the sanitizer's guard hashes what was staged
        wave_last = self._wave_last_np.copy()
        self.graph.stage(wave_last, None, None, use_dev=use_dev, rows=rows)
        self.graph.run("wave_fused_greedy" if greedy_only else "wave_fused",
                       self.cache)
        tok = self.graph.readback()
        # dispatch time only: the compute is deliberately not awaited
        self.stats.wall_decode_s += time.monotonic() - t0
        san = None
        if self._san is not None:
            sp = rows if rows is not None else (None,) * 5
            san = self._san.guard_dispatch(
                self.stats.decode_steps, wave_last=wave_last,
                use_dev=use_dev, seeds=sp[0], counts=sp[1], temps=sp[2],
                topk=sp[3], topp=sp[4])
            self._san.check_retrace(self.graph, "decode_sample")
        self.stats.decode_steps += 1
        self.stats.decode_dispatches += 1
        self._wave_len += 1
        self._pending = {"tok": tok, "san": san,
                         "rows": [(i, r, self._wave_len) for i, r in items]}
        if old is not None:
            self._drain_rows(old)

    def _step_wave(self) -> bool:
        self._admit_wave()
        if all(s is None for s in self.slots):
            return bool(self.queue)
        if self.overlap:
            self._overlap_round_wave()
            return True
        t0 = time.monotonic()
        kept = self._keep_step_state() if self.watchdog is not None else None
        self.graph.stage(self._wave_last_np, None, None)
        logits = self.graph.run("wave", self.cache)
        dt = time.monotonic() - t0
        if self.watchdog is not None and self.watchdog(
                self.stats.decode_steps, dt):
            # re-dispatch from the state the step started from
            self.stats.straggler_events += 1
            self._restore_step_state(kept)
            self.graph.stage(self._wave_last_np, None, None)
            logits = self.graph.run("wave", self.cache)
        self.stats.decode_steps += 1
        self.stats.decode_dispatches += 2  # the decode step + the sample
        tok_np = self._sample_rows(  # one sync per step
            logits, [(i, r) for i, r in enumerate(self.slots)
                     if r is not None])
        self.stats.wall_decode_s += time.monotonic() - t0
        # every row's token feeds the next step, finished rows' included
        self._wave_last_np = np.asarray(tok_np, np.int32).copy()
        self._wave_len += 1
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            t = int(tok_np[i])
            r.out_tokens.append(t)
            self.stats.tokens_out += 1
            reason = self._finish_reason_for(r, t, self._wave_len)
            if reason is not None:
                self._finish(i, r, reason, token=t)
            else:
                self._emit(r, t)
        return True

    # ------------------------------------------------------------------
    def _advance(self) -> bool:
        """Admit + one decode step over the active batch; True if any work."""
        if self.mode == "continuous":
            return self._step_continuous()
        return self._step_wave()

    def run(self, max_steps: int = 10_000) -> EngineStats:
        steps = 0
        while self.has_work and steps < max_steps:
            if not self._advance():
                break
            steps += 1
        return self.stats
