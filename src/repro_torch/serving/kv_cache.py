"""Host-side page management for the paged / tiered per-slot KV cache.

The port's own copy of ``repro.serving.kv_cache`` (it imports nothing of
the JAX package).  The device tensors (page pools, lengths) live in the
cache dict of ``models.model.init_paged_cache``; admission and free
decisions are control flow, so the free lists stay host-side in the
engine.  Page 0 is the reserved null page (inactive slots park their
writes there) and is never handed out.

* :class:`PageAllocator` -- the free list over the hot page pool, with a
  slot refcount per page for prefix sharing.
* :class:`TieredPageAllocator` -- the hot pool plus the cold "flash" tier:
  per-(slot, page) residency, an LRU queue of eviction candidates and the
  spilled page payloads (on a card, pinned host memory), which the engine
  prefetches back before the slot's next decode step.
* :class:`PrefixIndex` -- the content-addressed index of prefill-written
  prefix pages (a sha256 chain over page-aligned token spans) and the
  exact-prompt resume points.

Payloads are opaque to the allocators; all device data movement goes
through ``models.model.swap_out_pages`` / ``swap_in_pages``.  Beside them,
the page / bucket arithmetic and the chunked-prefill schedule helper.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Hashable

import numpy as np

from repro_torch import _sanitize


class OutOfPages(RuntimeError):
    pass


@dataclasses.dataclass
class PageAllocator:
    """Free-list allocator over ``num_pages`` pages; page 0 is reserved.

    Pages carry a *slot* refcount for prefix sharing: ``alloc`` hands a page
    out with refcount 1 (sole owner — the legacy contract), ``incref`` adds a
    sharer, ``decref`` drops one.  A refcount of 0 means "allocated but
    unreferenced" — a cached prefix page parked in the index, reclaimable via
    ``free`` — NOT free-list membership; ``decref`` never auto-frees.  The
    double-free guard extends to the decref path: ``free`` accepts refcounts
    of 0 (idle cached page) or 1 (sole owner) but raises if any sharer
    remains, so releasing a slot can never free a page another slot still
    reads.
    """

    num_pages: int

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs: dict[int, int] = {}
        san = _sanitize.load()
        if san is not None:
            san.attach_page_shadow(self)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for p in out:
            self._refs[p] = 1
        return out

    def free(self, pids: list[int]) -> None:
        seen: set[int] = set()
        for p in pids:  # validate the whole batch before applying any of it
            if p == 0:
                raise ValueError("page 0 is the reserved null page")
            if p in self._free_set or p in seen or not 0 < p < self.num_pages:
                # a double-freed id would be handed out to two slots and
                # silently corrupt both KV streams
                raise ValueError(f"page {p} freed twice (or never allocated)")
            if self._refs.get(p, 0) > 1:
                # the refcount extension of the same guard: a shared page
                # freed out from under its other readers corrupts them all
                raise ValueError(
                    f"page {p} freed with refcount {self._refs[p]} > 1")
            seen.add(p)
        self._free.extend(pids)
        self._free_set.update(pids)
        for p in pids:
            self._refs.pop(p, None)

    # ------------------------------------------------------- refcounts
    def refcount(self, pid: int) -> int:
        if pid in self._free_set or pid not in self._refs:
            raise ValueError(f"page {pid} is not allocated")
        return self._refs[pid]

    def incref(self, pid: int) -> int:
        """Add a sharer to an allocated page; returns the new refcount."""
        self._refs[pid] = self.refcount(pid) + 1
        return self._refs[pid]

    def decref(self, pid: int) -> int:
        """Drop one sharer; returns the new refcount.  At 0 the page stays
        allocated (an idle cached prefix page) until explicitly freed."""
        n = self.refcount(pid)
        if n <= 0:
            raise ValueError(f"page {pid} decref below zero")
        self._refs[pid] = n - 1
        return self._refs[pid]


PageKey = Hashable  # engine uses (slot, page_idx)


class TieredPageAllocator:
    """Two-tier page store: hot device pool + cold flash tier.

    Residency bookkeeping only — the engine performs the device gather /
    scatter and hands page payloads (opaque host blobs) in and out:

    * ``mark_evictable(key, pid)`` — a hot page becomes an eviction candidate
      (call in LRU order: oldest page of the least-recently-suspended slot
      first, tail pages last).
    * ``pop_evictable(n, exclude)`` — up to ``n`` LRU candidates to spill.
    * ``store(key, payload)`` / ``fetch(key)`` — the cold store proper.
    * ``cold_keys(match)`` — cold pages of one slot, for prefetch before its
      next decode step.

    ``flash_pages`` bounds the cold tier (None = the NAND dies dwarf the KV
    working set, the paper's regime).
    """

    def __init__(self, num_pages: int, flash_pages: int | None = None):
        self.hot = PageAllocator(num_pages)
        self.flash_pages = flash_pages
        self._cold: dict[PageKey, object] = {}
        self._evictable: OrderedDict[PageKey, int] = OrderedDict()
        san = _sanitize.load()
        if san is not None:
            san.attach_tier_shadow(self)

    # -------------------------------------------------------- hot pool
    @property
    def available(self) -> int:
        return self.hot.available

    def alloc(self, n: int = 1) -> list[int]:
        return self.hot.alloc(n)

    def free(self, pids: list[int]) -> None:
        self.hot.free(pids)

    def refcount(self, pid: int) -> int:
        return self.hot.refcount(pid)

    def incref(self, pid: int) -> int:
        return self.hot.incref(pid)

    def decref(self, pid: int) -> int:
        return self.hot.decref(pid)

    # -------------------------------------------------------- residency
    @property
    def cold_count(self) -> int:
        return len(self._cold)

    @property
    def flash_available(self) -> int | None:
        """Free cold-tier pages (None = unbounded)."""
        if self.flash_pages is None:
            return None
        return self.flash_pages - len(self._cold)

    @property
    def evictable_count(self) -> int:
        return len(self._evictable)

    def mark_evictable(self, key: PageKey, pid: int) -> None:
        if key in self._evictable or key in self._cold:
            raise ValueError(f"page {key!r} already evictable/cold")
        self._evictable[key] = pid

    def pop_evictable(self, n: int,
                      exclude=None) -> list[tuple[PageKey, int]]:
        """Up to ``n`` oldest candidates ``(key, hot pid)``, removed from the
        queue; the caller must spill each one (``store``) and free its pid.
        ``exclude(key) -> bool`` shields a slot's own pages (used when making
        room to prefetch that very slot)."""
        out = []
        for key in list(self._evictable):
            if len(out) >= n:
                break
            if exclude is not None and exclude(key):
                continue
            out.append((key, self._evictable.pop(key)))
        return out

    # -------------------------------------------------------- cold store
    def store(self, key: PageKey, payload) -> None:
        if key in self._cold:
            raise ValueError(f"page {key!r} already cold")
        if (self.flash_pages is not None
                and len(self._cold) >= self.flash_pages):
            raise OutOfPages(f"flash tier full ({self.flash_pages} pages)")
        self._cold[key] = payload

    def fetch(self, key: PageKey):
        """Pop one cold page's payload (the engine scatters it back into a
        freshly allocated hot page and remaps the block table)."""
        return self._cold.pop(key)

    def peek(self, key: PageKey):
        """Read one cold page's payload WITHOUT removing it — the
        non-destructive snapshot path (periodic fleet checkpoints must
        leave the tier intact while the slot keeps running)."""
        return self._cold[key]

    def cold_keys(self, match) -> list[PageKey]:
        """Cold pages with ``match(key)`` true, in insertion (spill) order."""
        return [k for k in self._cold if match(k)]

    def unmark_slot(self, match) -> None:
        """Withdraw a resumed slot's remaining eviction candidates (every
        page of a decoding slot must stay hot until its next suspension)."""
        for k in [k for k in self._evictable if match(k)]:
            del self._evictable[k]

    def drop_slot(self, match) -> None:
        """Forget every page of a finished slot (cold payloads and eviction
        candidates; the engine frees the hot pids itself)."""
        for k in [k for k in self._cold if match(k)]:
            del self._cold[k]
        for k in [k for k in self._evictable if match(k)]:
            del self._evictable[k]


_CHAIN_SEED = b"\x00" * 32


def _chain(prev: bytes, span: np.ndarray) -> bytes:
    h = hashlib.sha256(prev)
    h.update(span.tobytes())
    return h.digest()


@dataclasses.dataclass
class PageEntry:
    """One cached full page of prefix KV: chain key -> physical residency.

    ``pid`` is the hot page id (meaningless while ``cold``); the pid's
    allocator refcount counts the *slots* currently mapping this entry, so
    refcount 0 == idle (reclaimable / spillable) and the entry itself holds
    no reference.
    """

    key: bytes
    pid: int
    cold: bool = False


@dataclasses.dataclass
class ResumeEntry:
    """Exact-prompt resume point: everything needed to admit an identical
    prompt with ZERO prefill dispatches — the shared full pages (by chain
    key, lazily validated at hit time), a private copy of the partial tail
    page, the prefill's final-position logits (sampling replays from these
    bits, so the first token is bit-identical for any sampling params), and
    the post-prefill recurrent state for stateful (hybrid) families."""

    page_keys: list[bytes]
    tail: object          # gathered tail-page payload, or None if aligned
    tail_len: int         # prompt tokens in the tail page (0 = page-aligned)
    logits: object        # [vocab] last-row prefill logits (a tensor)
    length: int           # cache length after prefill (prompt + extras)
    ssm: object = None    # checkpoint_slot_state payload (hybrid), or None


class PrefixIndex:
    """Content-addressed index over prefix KV pages of ONE engine's pool.

    Keys are a sha256 rolling hash over page-aligned token spans:
    ``key_j = sha256(key_{j-1} || tokens[j*P:(j+1)*P])`` — so a page's key
    commits to the whole prefix behind it and equal keys imply bit-identical
    page contents (prefill is deterministic and position-wise independent of
    bucketing/chunking, the contract ``tests/test_chunked_prefill.py`` pins).

    Only PREFILL-written pages are ever registered.  Decode-written KV may
    differ bitwise from a prefill of the same tokens (prefill/decode numerics
    are only guaranteed to agree on the flash tier — see the requeue caveat
    in ``serving/core.py``), so registering decode output would silently
    break the warm-vs-cold bit-identity oracle on reuse.

    The index holds NO page references itself: an entry whose pid refcount
    is 0 sits on the idle LRU, reclaimable (engine frees the pid, drops the
    entry) or — under a tiered allocator — spillable to flash under the
    ``("px", key)`` cold key and prefetched back on the next hit.  Resume
    entries are capped by ``resume_cap`` (LRU) and die lazily when any page
    entry they cite disappears.
    """

    def __init__(self, page_size: int, resume_cap: int = 512):
        self.page_size = page_size
        self.resume_cap = resume_cap
        self._pages: dict[bytes, PageEntry] = {}
        self._idle: OrderedDict[bytes, None] = OrderedDict()
        self._resume: OrderedDict[bytes, ResumeEntry] = OrderedDict()

    # ------------------------------------------------------------ hashing
    def page_keys(self, tokens) -> list[bytes]:
        """Chain keys of every FULL page span of ``tokens``."""
        arr = np.asarray(tokens, np.int64)
        ps = self.page_size
        keys, prev = [], _CHAIN_SEED
        for j in range(len(arr) // ps):
            prev = _chain(prev, arr[j * ps:(j + 1) * ps])
            keys.append(prev)
        return keys

    def resume_key(self, tokens) -> bytes:
        """Whole-prompt key: the page chain extended over the tail span plus
        a domain marker (so an aligned prompt's resume key never collides
        with a page key)."""
        arr = np.asarray(tokens, np.int64)
        ps = self.page_size
        keys = self.page_keys(arr)
        prev = keys[-1] if keys else _CHAIN_SEED
        h = hashlib.sha256(prev)
        h.update(arr[(len(arr) // ps) * ps:].tobytes())
        h.update(b"resume")
        return h.digest()

    # ------------------------------------------------------- page entries
    def __len__(self) -> int:
        return len(self._pages)

    @property
    def n_idle(self) -> int:
        return len(self._idle)

    @property
    def n_idle_hot(self) -> int:
        return sum(1 for k in self._idle if not self._pages[k].cold)

    def get(self, key: bytes) -> PageEntry | None:
        return self._pages.get(key)

    def match(self, keys: list[bytes]) -> int:
        """Longest cached prefix: count of LEADING keys present."""
        n = 0
        for k in keys:
            if k not in self._pages:
                break
            n += 1
        return n

    def insert(self, key: bytes, pid: int) -> None:
        """Register a prefill-written hot page (the registering slot already
        holds the pid's single reference)."""
        if key in self._pages:
            raise ValueError("prefix page already registered")
        self._pages[key] = PageEntry(key, pid)

    def park(self, key: bytes) -> None:
        """Entry's refcount hit 0: append to the idle LRU."""
        self._idle[key] = None

    def unpark(self, key: bytes) -> None:
        """Entry acquired again (refcount 0 -> 1)."""
        self._idle.pop(key, None)

    def pop_idle_hot(self, n: int) -> list[tuple[bytes, int]]:
        """Remove up to ``n`` LRU idle HOT entries from the index entirely,
        returning ``(key, pid)`` for the engine to free."""
        out = []
        for key in list(self._idle):
            if len(out) >= n:
                break
            ent = self._pages[key]
            if ent.cold:
                continue
            del self._idle[key]
            del self._pages[key]
            out.append((key, ent.pid))
        return out

    def cold_idle_keys(self, n: int) -> list[bytes]:
        """Up to ``n`` cold entries' keys, LRU order.  Cold prefix pages are
        always idle (a slot acquiring one prefetches it hot first)."""
        out = []
        for key in self._idle:
            if len(out) >= n:
                break
            if self._pages[key].cold:
                out.append(key)
        return out

    def mark_cold(self, key: bytes) -> None:
        ent = self._pages[key]
        ent.cold, ent.pid = True, 0

    def mark_hot(self, key: bytes, pid: int) -> None:
        ent = self._pages[key]
        ent.cold, ent.pid = False, pid
        self._idle.pop(key, None)

    def drop(self, key: bytes) -> None:
        self._idle.pop(key, None)
        del self._pages[key]

    # ------------------------------------------------------ resume entries
    @property
    def n_resume(self) -> int:
        return len(self._resume)

    def put_resume(self, rkey: bytes, entry: ResumeEntry) -> None:
        self._resume[rkey] = entry
        self._resume.move_to_end(rkey)
        while len(self._resume) > self.resume_cap:
            self._resume.popitem(last=False)

    def get_resume(self, rkey: bytes) -> ResumeEntry | None:
        ent = self._resume.get(rkey)
        if ent is not None:
            self._resume.move_to_end(rkey)
        return ent

    def peek_resume(self, rkey: bytes) -> ResumeEntry | None:
        """LRU-neutral lookup (router scoring must not perturb eviction)."""
        return self._resume.get(rkey)

    def drop_resume(self, rkey: bytes) -> None:
        self._resume.pop(rkey, None)

    def clear_resume(self) -> None:
        self._resume.clear()


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def kv_page_elems(cfg, page_size: int) -> int:
    """Elements one KV page holds across all its layer-stacked pools: K and
    V rows of every layer (dense, moe), the compressed ``[R + Dr]`` rows
    (ckv + krope) of every layer (mla_moe), or K and V of every
    shared-attention application (hybrid; the Mamba state never pages).
    ``models.model.kv_page_bytes`` prices a page from it."""
    f = cfg.family
    if f == "mla_moe":
        return cfg.n_layers * page_size * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    if f == "hybrid":
        n_groups = cfg.n_layers // cfg.shared_attn_every
        return 2 * n_groups * page_size * cfg.n_kv_heads * cfg.d_head
    if f in ("dense", "vlm", "moe"):
        return 2 * cfg.n_layers * page_size * cfg.n_kv_heads * cfg.d_head
    raise ValueError(f"family {f!r} has no paged KV cache in this port")


def kv_page_scale_elems(cfg, page_size: int) -> int:
    """float32 scales one int8 KV page carries beside its payload: one per
    page row per kv head (GQA pools) or per compressed row of the ckv and
    krope pools (mla_moe), the pool shapes less their last axis."""
    if cfg.family == "mla_moe":
        return 2 * cfg.n_layers * page_size
    return kv_page_elems(cfg, page_size) // cfg.d_head


def chunk_spans(n_tokens: int, budget: int) -> list[tuple[int, int]]:
    """Reference chunked-prefill schedule for a FIXED budget: ``(start,
    length)`` spans of at most ``budget`` tokens tiling the prompt.  The
    engine derives each span live (the budget is a per-step policy
    decision); ``models.model.prefill_chunk_into_slot`` gives the same
    bits for every split, so a schedule is a pacing choice only."""
    if budget <= 0:
        raise ValueError(f"chunk budget must be positive, got {budget}")
    return [(s, min(budget, n_tokens - s))
            for s in range(0, n_tokens, budget)]


def prefill_bucket(n_tokens: int, floor: int = 8) -> int:
    """Pad prefill lengths to power-of-two buckets from ``floor`` up (the
    JAX engine's jit shape buckets; the port keeps them so both engines
    run the same shapes and the same padding).  Chunks use the page size
    as the floor."""
    b = floor
    while b < n_tokens:
        b *= 2
    return b
