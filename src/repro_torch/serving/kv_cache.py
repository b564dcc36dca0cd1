"""Host-side page management for the paged per-slot KV cache.

The port's own copy of the parts of ``repro.serving.kv_cache`` the
untiered serving path uses: the flat free-list ``PageAllocator`` over the
page pool (page 0 is the reserved null page and is never handed out), the
page / bucket arithmetic and the chunked-prefill schedule helper.  The
tiered allocator and the prefix index come with their slices.
"""

from __future__ import annotations

import dataclasses


class OutOfPages(RuntimeError):
    pass


@dataclasses.dataclass
class PageAllocator:
    """Free-list allocator over ``num_pages`` pages; page 0 is reserved.

    ``free`` validates the whole batch first and rejects a double free or
    the null page, so a page can never be handed to two slots at once.
    """

    num_pages: int

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._free_set = set(self._free)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, pids: list[int]) -> None:
        seen: set[int] = set()
        for p in pids:  # validate the whole batch before applying any of it
            if p == 0:
                raise ValueError("page 0 is the reserved null page")
            if p in self._free_set or p in seen or not 0 < p < self.num_pages:
                raise ValueError(f"page {p} freed twice (or never allocated)")
            seen.add(p)
        self._free.extend(pids)
        self._free_set.update(pids)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


def kv_page_elems(cfg, page_size: int) -> int:
    """Elements one KV page holds across all its layer-stacked pools: K and
    V rows of every layer (dense) or of every shared-attention application
    (hybrid; the Mamba state never pages).  ``models.model.kv_page_bytes``
    prices a page from it."""
    f = cfg.family
    if f == "hybrid":
        n_groups = cfg.n_layers // cfg.shared_attn_every
        return 2 * n_groups * page_size * cfg.n_kv_heads * cfg.d_head
    if f in ("dense", "vlm", "moe"):
        return 2 * cfg.n_layers * page_size * cfg.n_kv_heads * cfg.d_head
    raise ValueError(f"family {f!r} has no paged KV cache in this port")


def kv_page_scale_elems(cfg, page_size: int) -> int:
    """float32 scales one int8 KV page carries beside its payload: one per
    page row per kv head, the pool shapes less their last axis."""
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
