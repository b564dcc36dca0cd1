"""Event-driven flash-channel simulator (SSDsim-style, per paper §VII-A).

Channels are symmetric: we simulate one channel's bus + die pool exactly and
read the matrix completion time off it.  The model captures the paper's
pipeline (Fig. 6): read-compute input transfers, ~tR in-die windows, result
uploads, and plain reads/writes either whole-page (blocking) or sliced into
the bubbles.

Resources on a channel:
  * the bus — serializes every transfer (rc inputs, rc results, read/write
    slices);
  * the die pool — a tile's array-read+compute occupies all dies for tR
    (all compute cores cooperate on one tile; the two-plane data/cache
    register pipeline lets the next tile's array read overlap the bus phase,
    which is captured by allowing the next tile's input transfer during the
    current tile's tR window);
  * NPU-bound reads use any idle plane, so they do not contend for dies in
    this model (the idle plane serves them, per §IV-C "the idle plane serves
    normal read requests"), only for the bus.  Plain WRITES (KV pages
    spilled by the tiered cache) are the symmetric case — the page programs
    an idle plane after its bus transfer, so they too contend only for the
    bus.

The port's copy of ``repro.sim.engine`` (pure Python; the port imports
nothing of the JAX package).  Its figures describe the paper's edge hardware
and models; none of them times the H100.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.schedule import (DEFAULT_SLICE_BYTES, ChannelWorkload, Policy)


@dataclasses.dataclass
class BusSegment:
    start: float
    end: float
    kind: str  # "rc_in" | "rc_out" | "read" | "write"


@dataclasses.dataclass
class SimResult:
    time: float                  # matrix completion time (rc + reads + writes)
    rc_done: float               # last read-compute completion
    reads_done: float            # last NPU-bound byte delivered
    bus_busy: float              # total bus-occupied seconds
    util: float                  # bus_busy / time
    segments: list[BusSegment]   # trace (for Fig-6 style plots)
    writes_done: float = 0.0     # last flash-bound (KV spill) byte delivered


def simulate_channel(w: ChannelWorkload, policy: Policy = Policy.RC_SLICED,
                     slice_bytes: int = DEFAULT_SLICE_BYTES,
                     keep_trace: bool = False) -> SimResult:
    """Simulate one channel processing ``w``; returns completion stats.

    Event structure per read-compute request i:
      input transfer  [s_i, s_i + t_in]   (bus)
      die window      [s_i + t_in, s_i + t_in + tR]   (dies, all of them)
      result transfer [die_end, die_end + t_out]      (bus, priority)
    Plain traffic (NPU-bound reads, then flash-bound KV writes) fills bus
    gaps: whole pages (RC_UNSLICED) or slices (RC_SLICED).  Read data is
    produced by idle planes and writes program idle planes, so we assume a
    page is ready whenever the bus can take it (array reads/programs overlap
    earlier traffic), which matches the paper's steady-state pipeline.
    """
    t_in = w.rc_input_bytes / w.bw
    t_out = w.rc_result_bytes / w.bw
    t_slice = slice_bytes / w.bw
    t_page = w.page_bytes / w.bw

    segments: list[BusSegment] = []
    bus_busy = 0.0

    def occupy(start: float, dur: float, kind: str) -> float:
        nonlocal bus_busy
        bus_busy += dur
        if keep_trace:
            segments.append(BusSegment(start, start + dur, kind))
        return start + dur

    # Pending plain-traffic bytes: reads drain before writes.
    if policy != Policy.RC_ONLY:
        plain = {"read": float(w.n_reads * w.page_bytes),
                 "write": float(w.n_writes * w.page_bytes)}
    else:
        plain = {"read": 0.0, "write": 0.0}
    done_at = {"read": 0.0, "write": 0.0}

    bus_free = 0.0      # earliest time the bus is available
    dies_free = 0.0     # earliest time the die pool can start a new tile
    rc_done = 0.0

    def plain_pending() -> bool:
        return plain["read"] > 0 or plain["write"] > 0

    def next_kind() -> str:
        return "read" if plain["read"] > 0 else "write"

    def fill_bubble(limit: float) -> None:
        """Fill the bus gap [bus_free, limit] with plain-traffic slices."""
        nonlocal bus_free
        while plain_pending():
            kind = next_kind()
            n_fit = int((limit - bus_free) / t_slice)
            n_have = int(-(-plain[kind] // slice_bytes))
            n = min(n_fit, n_have)
            if n <= 0:
                return
            t = bus_free
            for _s in range(n):
                t = occupy(t, t_slice, kind)
            plain[kind] = max(0.0, plain[kind] - n * slice_bytes)
            done_at[kind] = t
            bus_free = t

    for _ in range(w.n_tiles):
        # Input transfer: needs the bus; the die pool must be free by the time
        # the transfer completes (two-plane pipelining lets transfer overlap
        # the previous tile's die window).
        start_in = max(bus_free, dies_free - t_in)
        # RC_UNSLICED: a whole-page read/write may be occupying the bus
        # (head-of-line blocking).  Interleave: before each rc input, if
        # plain traffic remains, one full page transfer goes out first
        # (paper Fig. 6b's interleaving).
        if policy == Policy.RC_UNSLICED and plain_pending():
            kind = next_kind()
            bus_free = occupy(bus_free, t_page, kind)
            plain[kind] = max(0.0, plain[kind] - w.page_bytes)
            done_at[kind] = bus_free
            start_in = max(bus_free, dies_free - t_in)
        if policy == Policy.RC_SLICED and plain_pending():
            fill_bubble(start_in)
            start_in = max(bus_free, dies_free - t_in)
        end_in = occupy(start_in, t_in, "rc_in")
        bus_free = end_in
        die_start = max(end_in, dies_free)
        die_end = die_start + w.t_r
        dies_free = die_end
        # Result upload has priority at die_end, but slices may use the bubble
        # [end_in, die_end] first.
        if policy == Policy.RC_SLICED and plain_pending():
            fill_bubble(die_end)
        start_out = max(bus_free, die_end)
        bus_free = occupy(start_out, t_out, "rc_out")
        rc_done = bus_free

    # Drain remaining plain traffic after the last rc request.
    while plain_pending():
        kind = next_kind()
        step = min(slice_bytes if policy == Policy.RC_SLICED else w.page_bytes,
                   plain[kind])
        bus_free = occupy(bus_free, step / w.bw, kind)
        plain[kind] -= step
        done_at[kind] = bus_free

    total = max(rc_done, done_at["read"], done_at["write"])
    if total <= 0.0:
        total = 0.0
        util = 0.0
    else:
        util = bus_busy / total
    return SimResult(time=total, rc_done=rc_done, reads_done=done_at["read"],
                     bus_busy=bus_busy, util=util, segments=segments,
                     writes_done=done_at["write"])


# ---------------------------------------------------------------------------
# Whole-model stream simulation
# ---------------------------------------------------------------------------
#
# A decode step is a *sequence* of GeMV matrices (layer order) interleaved
# with NPU-only phases (attention + KV-cache traffic).  Read-compute requests
# are activation-dependent (matrix k+1's input is matrix k's output) and so
# serialize at matrix barriers; plain weight READS are activation-independent
# and may prefetch ahead into any channel bubble, bounded by the NPU's weight
# buffer (``prefetch_bytes``).  This is the paper's Slice Control applied to
# the full request stream.
#
# Tiered-KV traffic (``kv_write_bytes`` spilled pages NPU->flash,
# ``kv_read_bytes`` prefetched pages flash->NPU) is a third request class:
# activation-independent like weight reads, but lowest priority — it rides
# whatever bubble space weight reads leave behind, and only gates the token's
# completion (the spill must land before the hot page is reused next token),
# never a matrix barrier.


@dataclasses.dataclass(frozen=True)
class RCBlock:
    """One matrix's per-channel workload inside the stream."""

    n_tiles: int
    rc_input_bytes: float
    rc_result_bytes: float
    read_bytes: float  # NPU-bound weight bytes on this channel, this matrix
    t_r: float
    bw: float
    page_bytes: float = 16384.0


@dataclasses.dataclass(frozen=True)
class NpuPhase:
    """Channel-idle phase (attention / KV traffic); reads may still flow."""

    duration: float


@dataclasses.dataclass
class StreamResult:
    time: float
    bus_busy: float
    util: float
    stalled_on_reads: float  # time the barrier waited on undelivered reads
    kv_done: float = 0.0     # when the last KV-tier byte crossed the bus
    kv_bus_s: float = 0.0    # bus seconds spent on KV spill/prefetch traffic


def simulate_stream(items: list, policy: Policy = Policy.RC_SLICED,
                    slice_bytes: int = DEFAULT_SLICE_BYTES,
                    prefetch_bytes: float = 32e6,
                    kv_write_bytes: float = 0.0,
                    kv_read_bytes: float = 0.0,
                    kv_bw: float = 1.0e9,
                    kv_page_bytes: float = 16384.0) -> StreamResult:
    """Simulate one channel executing the full decode stream.

    Matrix barriers: RCBlock ``i+1`` cannot start until block ``i``'s rc tiles
    are done AND its NPU-bound read bytes are delivered.  Reads are delivered
    FIFO; reads belonging to blocks at-or-before the executing block are
    always allowed, reads of future blocks prefetch into bubbles while the
    NPU-side weight buffer (``prefetch_bytes``) has room.

    KV-tier traffic (``kv_write_bytes`` + ``kv_read_bytes``, this channel's
    share of the token's spill/prefetch bytes) fills bubbles AFTER weight
    reads each time the bus idles, and drains at the end of the stream if
    bubbles didn't absorb it — the token is only complete once the tier
    traffic has crossed the bus.  Like plain reads it follows the policy:
    RC_ONLY drops it, RC_UNSLICED moves whole ``kv_page_bytes`` pages,
    RC_SLICED moves ``slice_bytes`` slices.
    """
    n = len(items)
    reads = [it.read_bytes if isinstance(it, RCBlock) else 0.0 for it in items]
    left = list(reads)
    finish = [0.0] * n  # when item i's reads were fully delivered

    bus_free = 0.0
    dies_free = 0.0
    bus_busy = 0.0
    stalled = 0.0
    q_head = 0
    while q_head < n and left[q_head] <= 0:
        q_head += 1
    delivered_total = 0.0
    consumed_total = 0.0  # reads of all blocks at-or-before the current barrier
    current = 0
    kv_left = (0.0 if policy == Policy.RC_ONLY
               else float(kv_write_bytes) + float(kv_read_bytes))
    kv_step = slice_bytes if policy == Policy.RC_SLICED else kv_page_bytes
    kv_unit = kv_step / kv_bw
    kv_done_at = 0.0
    kv_bus = 0.0

    def fill_reads(until: float) -> None:
        """Deliver read data into the bus gap [bus_free, until]."""
        nonlocal bus_free, bus_busy, q_head, delivered_total
        if policy == Policy.RC_ONLY:
            return
        while q_head < n:
            it = items[q_head]
            if policy == Policy.RC_UNSLICED and q_head > current:
                return  # unsliced reads can't opportunistically prefetch
            step = slice_bytes if policy == Policy.RC_SLICED else it.page_bytes
            t_unit = step / it.bw
            gap = min(until, 1e30) - bus_free
            if gap < t_unit - 1e-15:
                return
            # prefetch cap for future blocks' reads
            if q_head > current:
                room = prefetch_bytes - (delivered_total - consumed_total)
                if room < step:
                    return
                budget_units = int(room / step)
            else:
                budget_units = 1 << 60
            units_left = int(-(-left[q_head] // step))
            k = min(int(gap / t_unit), units_left, budget_units)
            if k <= 0:
                return
            amt = min(k * step, left[q_head])
            bus_free += k * t_unit
            bus_busy += k * t_unit
            delivered_total += amt
            left[q_head] -= amt
            if left[q_head] <= 1e-9:
                finish[q_head] = bus_free
                q_head += 1
                while q_head < n and left[q_head] <= 0:
                    q_head += 1

    def fill_kv(until: float) -> None:
        """Lowest priority: KV tier slices ride leftover bubble space."""
        nonlocal bus_free, bus_busy, kv_left, kv_done_at, kv_bus
        if kv_left <= 0:
            return
        gap = min(until, 1e30) - bus_free
        k = min(int(gap / kv_unit), int(-(-kv_left // kv_step)))
        if k <= 0:
            return
        dur = k * kv_unit
        bus_free += dur
        bus_busy += dur
        kv_bus += dur
        kv_left = max(0.0, kv_left - k * kv_step)
        kv_done_at = bus_free

    barrier = 0.0
    for i, it in enumerate(items):
        current = i
        if isinstance(it, NpuPhase):
            end = barrier + it.duration
            fill_reads(end)
            fill_kv(end)
            barrier = end
            consumed_total += 0.0
            continue
        t_in = it.rc_input_bytes / it.bw
        t_out = it.rc_result_bytes / it.bw
        rc_done = barrier
        for _t in range(it.n_tiles):
            earliest = max(barrier, dies_free - t_in)
            # RC_UNSLICED head-of-line blocking: a pending whole-page read for
            # the current (or earlier) block transmits before the rc input.
            if (policy == Policy.RC_UNSLICED and q_head <= i and q_head < n
                    and left[q_head] > 0):
                fill_reads(max(bus_free, earliest) + it.page_bytes / it.bw)
            else:
                fill_reads(max(bus_free, earliest))
            fill_kv(max(bus_free, earliest))
            start_in = max(bus_free, earliest)
            end_in = start_in + t_in
            bus_busy += t_in
            bus_free = end_in
            die_end = max(end_in, dies_free) + it.t_r
            dies_free = die_end
            fill_reads(die_end)
            fill_kv(die_end)
            start_out = max(bus_free, die_end)
            bus_free = start_out + t_out
            bus_busy += t_out
            rc_done = bus_free
        # Drain this block's own remaining reads (they gate the barrier).
        if q_head <= i and q_head < n and left[i] > 0:
            t0 = max(bus_free, rc_done)
            fill_reads(float("inf"))
            stalled += max(0.0, bus_free - t0)
        my_reads = finish[i] if reads[i] > 0 else 0.0
        barrier = max(rc_done, my_reads)
        consumed_total += reads[i]

    # Tail-drain the KV tier traffic the bubbles didn't absorb.
    if kv_left > 0:
        fill_kv(float("inf"))
    total = max(barrier, kv_done_at)
    util = bus_busy / total if total > 0 else 0.0
    return StreamResult(time=total, bus_busy=bus_busy, util=util,
                        stalled_on_reads=stalled, kv_done=kv_done_at,
                        kv_bus_s=kv_bus)
