"""Hardware-aware tiling (paper §V).

Pure closed-form math, copied from ``repro.core.tiling`` (the port imports
nothing of the JAX package); ``tests/test_torch_ecc.py`` holds its plans
equal to the JAX module's on the llama2-7b shapes.

Definitions (paper notation):

* A weight matrix ``(H_weight, W_weight)`` is cut into tiles ``(H_req, W_req)``.
  One tile = one read-compute request, computed cooperatively by every compute
  core in the flash; each core owns an *atomic tile* of exactly one page.
* Channel traffic per tile with input broadcast on a channel (scheme (b)):
      Trans = W_req + channel_num * H_req
  subject to   H_req * W_req = channel_num * ccore_num * pagesize_elems
  AM-GM minimum at
      H_req* = sqrt(ccore_num * pagesize_elems)
      W_req* = channel_num * sqrt(ccore_num * pagesize_elems)
* Workload split α (fraction of the matrix processed in-flash) balances the
  time of read-compute requests against plain (sliced) read requests that feed
  the NPU through leftover channel bandwidth.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hw import FlashSpec, NPUSpec


@dataclasses.dataclass(frozen=True)
class TileShape:
    h: int  # H_req: rows of the weight tile (output elements of the GeMV)
    w: int  # W_req: cols of the weight tile (input elements of the GeMV)

    @property
    def elems(self) -> int:
        return self.h * self.w


def channel_traffic_broadcast(h_req: int, w_req: int, channel_num: int) -> int:
    """Trans for splitting scheme (b): input vectors broadcast per channel.

    Each channel ships the full ``w_req`` input once (broadcast to its ccores)
    and returns its ``h_req``-long partial result slice per channel.
    """
    return w_req + channel_num * h_req


def channel_traffic_no_reuse(h_req: int, w_req: int, channel_num: int, ccore_num: int) -> int:
    """Trans for the inferior scheme (c): no input reuse across a channel."""
    return ccore_num * w_req + channel_num * h_req


def optimal_tile(flash: FlashSpec, bytes_per_elem: float = 1.0) -> TileShape:
    """Paper §V-A closed form, rounded to integers that preserve the invariant.

    ``pagesize`` in the paper is in weight *elements* (INT8 → bytes == elems).
    For W4A16 mode ``bytes_per_elem=0.5`` doubles the elements per page.
    """
    pagesize_elems = int(flash.page_bytes / bytes_per_elem)
    ccore = flash.ccores_per_channel
    root = math.isqrt(ccore * pagesize_elems)
    # Snap H to a power of two so the page invariant holds exactly (all flash
    # geometry params are powers of two) and tiles stay MXU/128-aligned in the
    # TPU adaptation.  For exact squares (e.g. -S: ccore=4, page=16K -> 256)
    # this is the paper's closed form verbatim; otherwise pick the power-of-2
    # neighbour minimizing Trans (ties -> smaller H: smaller result vectors).
    lo = 1 << (root.bit_length() - 1)
    hi = lo * 2
    total = flash.channels * ccore * pagesize_elems

    def trans(h: int) -> int:
        return total // (flash.channels * h) * flash.channels + flash.channels * h

    h = lo if trans(lo) <= trans(hi) else hi
    w = total // (flash.channels * h) * flash.channels  # divisible by channels
    return TileShape(h=h, w=w)


def min_channel_traffic(flash: FlashSpec, bytes_per_elem: float = 1.0) -> float:
    """min Trans = 2 * channel_num * sqrt(ccore_num * pagesize_elems)."""
    pagesize_elems = flash.page_bytes / bytes_per_elem
    return 2.0 * flash.channels * math.sqrt(flash.ccores_per_channel * pagesize_elems)


def read_compute_time(flash: FlashSpec, tile: TileShape, bytes_per_elem: float = 1.0) -> float:
    """t_rc = tR + W_req / (channel_num * bw_channel)   (paper §V-B).

    Input vector elements are activations; the paper's formulation counts the
    INT8 input stream, we scale by activation byte width (INT8=1, bf16=2 for
    W4A16 mode's 16-bit activations).
    """
    act_bytes = 1.0 if bytes_per_elem >= 1.0 else 2.0
    return (flash.t_r + flash.t_cmd
            + (tile.w * act_bytes) / (flash.channels * flash.bw_channel))


def rc_channel_utilization(flash: FlashSpec, tile: TileShape, bytes_per_elem: float = 1.0) -> float:
    """rate_rc = (H_req + W_req/channel_num) / (tR * bw_channel)."""
    act_bytes = 1.0 if bytes_per_elem >= 1.0 else 2.0
    per_channel_bytes = tile.h * act_bytes + (tile.w * act_bytes) / flash.channels
    return per_channel_bytes / (flash.t_r * flash.bw_channel)


def read_time(flash: FlashSpec, tile: TileShape, bytes_per_elem: float = 1.0) -> float:
    """t_r = pagesize / ((1 - rate_rc) * bw_channel): a plain page read through
    the bandwidth left over by read-compute traffic."""
    rate = min(rc_channel_utilization(flash, tile, bytes_per_elem), 0.999)
    return flash.page_bytes / ((1.0 - rate) * flash.bw_channel)


def alpha_requests(flash: FlashSpec, tile: TileShape | None = None,
                   bytes_per_elem: float = 1.0) -> float:
    """The paper's literal §V-B expression  α = t_r / (t_r + t_rc).

    This is the balanced fraction of *requests* that are read-compute requests
    (one read-compute request per whole tile vs one read request per page).
    It is NOT the byte fraction — see :func:`alpha_split` for the byte-level
    split the planner actually uses (derived from the same balance condition).
    """
    if tile is None:
        tile = optimal_tile(flash, bytes_per_elem)
    t_rc = read_compute_time(flash, tile, bytes_per_elem)
    t_r = read_time(flash, tile, bytes_per_elem)
    return t_r / (t_r + t_rc)


def alpha_split(flash: FlashSpec, tile: TileShape | None = None,
                bytes_per_elem: float = 1.0) -> float:
    """Byte fraction of the weight matrix processed in-flash.

    Derived from the paper's balance condition ("execution times for read and
    read-compute requests are equal"):  the flash serializes tiles at ``t_rc``
    each (every tile occupies all compute cores; ``ccore_num`` pages per
    channel per tile), while each channel independently delivers NPU-bound
    pages at ``t_r`` each through leftover bandwidth.  Equal-time balance with
    ``N_r = channels * N_rc * t_rc / t_r`` reads gives byte fraction

        α_bytes = ccore_num * t_r / (ccore_num * t_r + t_rc).

    Sanity: for Cambricon-LLM-S this is ≈0.69, which reproduces the paper's
    Fig. 14 ablation (hybrid tiling 1.3–1.4× faster than flash-only); the
    literal request-ratio 0.35 would make the hybrid *slower* than flash-only.
    """
    if tile is None:
        tile = optimal_tile(flash, bytes_per_elem)
    t_rc = read_compute_time(flash, tile, bytes_per_elem)
    t_r = read_time(flash, tile, bytes_per_elem)
    cc = flash.ccores_per_channel
    return (cc * t_r) / (cc * t_r + t_rc)


@dataclasses.dataclass(frozen=True)
class MatrixPlan:
    """Execution plan for one weight matrix's GeMV (paper Fig. 7a).

    ``flash_rows`` rows are handled by read-compute requests in ``n_tiles``
    tiles of ``tile``; the remaining ``npu_rows`` stream to the NPU as sliced
    read requests.
    """

    h_weight: int
    w_weight: int
    tile: TileShape
    alpha: float
    flash_rows: int
    npu_rows: int
    n_tiles: int
    n_read_pages: int
    bytes_per_elem: float = 1.0

    @property
    def flash_bytes(self) -> float:
        return self.flash_rows * self.w_weight * self.bytes_per_elem

    @property
    def npu_bytes(self) -> float:
        return self.npu_rows * self.w_weight * self.bytes_per_elem


def fit_tile(tile: TileShape, h_weight: int, w_weight: int, flash: FlashSpec,
             bytes_per_elem: float = 1.0) -> TileShape:
    """Tailor the optimal tile to a concrete matrix (paper: "we tailor each
    weight matrix into this specific shape").

    * Matrix narrower than W_req*: split the width into equal columns
      (avoiding a nearly-empty ragged last column that would waste a full tR
      on idle cores), round W up to a channel multiple, and grow H so each
      compute core still holds ≤ one full page (H rounded down to a
      ccores-per-channel multiple — atomic tiles may underfill a page
      slightly, never overflow it).
    * Matrix smaller than one full tile: the tile degenerates to the whole
      matrix and some cores idle — the Fig. 15 saturation effect.
    """
    pagesize_elems = int(flash.page_bytes / bytes_per_elem)
    ch, cc = flash.channels, flash.ccores_per_channel
    total = ch * cc * pagesize_elems
    ncols = max(1, -(-w_weight // tile.w))
    w = -(-w_weight // (ncols * ch)) * ch  # even columns, channel-aligned
    h = total // max(w, 1) // cc * cc      # atomic tile fits in a page
    if h <= 0:
        h = min(cc, h_weight)
    if h > h_weight:
        h = max(h_weight, 1)
        w = min(total // h, w_weight)
    return TileShape(h=h, w=w)


def plan_matrix(h_weight: int, w_weight: int, flash: FlashSpec,
                bytes_per_elem: float = 1.0,
                alpha_override: float | None = None,
                tile_override: TileShape | None = None) -> MatrixPlan:
    """Build the §V plan for an ``(h_weight, w_weight)`` GeMV."""
    tile = tile_override or optimal_tile(flash, bytes_per_elem)
    tile = fit_tile(tile, h_weight, w_weight, flash, bytes_per_elem)
    alpha = alpha_split(flash, tile, bytes_per_elem) if alpha_override is None else alpha_override
    # Tile rows assigned to flash; the final tile may be partial (same tR,
    # fewer rows) so small matrices aren't forced to all-or-nothing splits.
    flash_rows = int(round(alpha * h_weight))
    flash_rows = max(0, min(flash_rows, h_weight))
    npu_rows = h_weight - flash_rows
    tiles_h = math.ceil(flash_rows / tile.h) if tile.h else 0
    tiles_w = math.ceil(w_weight / tile.w) if tile.w else 0
    n_tiles = tiles_h * tiles_w
    n_read_pages = math.ceil(npu_rows * w_weight * bytes_per_elem / flash.page_bytes)
    return MatrixPlan(
        h_weight=h_weight, w_weight=w_weight, tile=tile, alpha=alpha,
        flash_rows=flash_rows, npu_rows=npu_rows, n_tiles=n_tiles,
        n_read_pages=n_read_pages, bytes_per_elem=bytes_per_elem,
    )


def matrix_time_analytic(plan: MatrixPlan, flash: FlashSpec,
                         npu: NPUSpec | None = None) -> float:
    """Analytic steady-state execution time of one matrix (used by the planner;
    the event simulator in sim/ validates this within a few percent).

    Flash path: n_tiles read-compute requests, each t_rc, but all ccores work
    in parallel — a tile occupies every ccore for max(tR, input stream time).
    NPU path: npu_bytes through leftover channel bandwidth.
    Total = max(flash_path, npu_path) since they overlap by construction.
    """
    npu = npu or NPUSpec()
    t_rc = read_compute_time(flash, plan.tile, plan.bytes_per_elem)
    flash_time = plan.n_tiles * t_rc
    rate = min(rc_channel_utilization(flash, plan.tile, plan.bytes_per_elem), 0.999)
    leftover_bw = (1.0 - rate) * flash.total_channel_bw
    npu_stream_time = plan.npu_bytes / leftover_bw if plan.npu_bytes else 0.0
    npu_compute_time = 2.0 * plan.npu_rows * plan.w_weight / npu.ops_per_s
    return max(flash_time, npu_stream_time, npu_compute_time)
