"""Slice Control (paper §IV-C): request types and channel scheduling policies.

A matrix plan expands into, per flash channel:

* ``n_tiles`` READ-COMPUTE requests — input-vector broadcast down the channel,
  ~tR of in-die work on every compute core, result partials back up;
* ``reads_per_channel`` plain READ requests (pages bound for the NPU), each
  optionally segmented into ``slice_bytes`` slices that are interposed into
  the channel-occupancy bubbles between read-compute transfers;
* ``n_writes`` plain WRITE requests (pages bound for the flash dies) — the
  Fig. 6 model extended for the tiered KV cache: when the serving engine
  spills cold KV pages to the flash tier (``serving/kv_cache.py``,
  ``TieredPageAllocator``), the spilled page rides the channel bus NPU→die
  and the later prefetch rides it die→NPU.  Both directions are sliced and
  interposed into the same bubbles as plain reads (writes program an idle
  plane, so like NPU-bound reads they contend only for the bus in this
  model).  See the "Flash-resident KV pages" design note in ROADMAP.md for
  the tier diagram and eviction policy.

Three policies reproduce paper Fig. 6:
  RC_ONLY      (a) only read-compute requests (channel mostly idle),
  RC_UNSLICED  (b) whole-page reads/writes block subsequent read-compute
                   requests,
  RC_SLICED    (c) sliced reads/writes fill the bubbles (ours/paper's).

The port's copy of ``repro.core.schedule`` (pure Python; the port imports
nothing of the JAX package).  Its figures describe the paper's edge hardware
and models; none of them times the H100.
"""

from __future__ import annotations

import dataclasses
import enum


class Policy(enum.Enum):
    RC_ONLY = "rc_only"
    RC_UNSLICED = "rc_unsliced"
    RC_SLICED = "rc_sliced"


DEFAULT_SLICE_BYTES = 2048  # read/write-request slice granularity


@dataclasses.dataclass(frozen=True)
class ChannelWorkload:
    """Per-channel request load for one weight matrix (symmetric channels)."""

    n_tiles: int              # read-compute requests (global tile count)
    rc_input_bytes: float     # per tile, per channel: W_req/channels * act_bytes
    rc_result_bytes: float    # per tile, per channel: H_req * result_bytes
    n_reads: int              # plain page reads bound for the NPU, this channel
    page_bytes: int
    t_r: float                # NAND array read time
    bw: float                 # channel bus bandwidth, bytes/s
    n_writes: int = 0         # plain page writes (KV spill), this channel

    @property
    def rc_bus_bytes(self) -> float:
        return self.n_tiles * (self.rc_input_bytes + self.rc_result_bytes)

    @property
    def read_bus_bytes(self) -> float:
        return self.n_reads * self.page_bytes

    @property
    def write_bus_bytes(self) -> float:
        return self.n_writes * self.page_bytes


def channel_workload(plan, flash, act_bytes: float = 1.0,
                     result_bytes: float = 1.0,
                     kv_write_pages: int = 0) -> ChannelWorkload:
    """Build the per-channel workload from a core.tiling.MatrixPlan."""
    import math

    reads = math.ceil(plan.n_read_pages / flash.channels)
    return ChannelWorkload(
        n_tiles=plan.n_tiles,
        rc_input_bytes=plan.tile.w / flash.channels * act_bytes,
        rc_result_bytes=plan.tile.h * result_bytes,
        n_reads=reads,
        page_bytes=flash.page_bytes,
        t_r=flash.t_r,
        bw=flash.bw_channel,
        n_writes=kv_write_pages,
    )
