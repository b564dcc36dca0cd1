"""Host-side page management for the paged per-slot KV cache.

The port's own copy of the parts of ``repro.serving.kv_cache`` the
untiered serving path uses: the flat free-list ``PageAllocator`` over the
page pool (page 0 is the reserved null page and is never handed out), and
the page / bucket arithmetic.  The tiered allocator and the prefix index
come with their slices.
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


def prefill_bucket(n_tokens: int) -> int:
    """Pad prefill lengths to power-of-two buckets (the JAX engine's jit
    shape buckets; the port keeps them so both engines run the same
    shapes and the same padding)."""
    b = 8
    while b < n_tokens:
        b *= 2
    return b
