"""End-to-end decode performance of Cambricon-LLM (paper Figs 9/11/12/13/14/15).

The decode step is simulated as a whole-channel request stream: read-compute
requests serialize at matrix barriers (activation dependencies); NPU-bound
weight reads are activation-independent and prefetch into channel bubbles
(bounded by the NPU weight buffer).  NPU attention and KV-cache DRAM traffic
appear as channel-idle phases that reads also fill.

The port's copy of ``repro.sim.llm_perf`` (pure Python; the port imports
nothing of the JAX package).  Its figures describe the paper's edge hardware
and models; none of them times the H100.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner, tiling
from repro_torch.core.hw import DEFAULT_NPU, FlashSpec, NPUSpec
from repro_torch.core.schedule import DEFAULT_SLICE_BYTES, Policy
from repro_torch.sim.engine import NpuPhase, RCBlock, simulate_stream


@dataclasses.dataclass(frozen=True)
class TokenTime:
    total: float
    npu_phase_time: float     # attention + KV/state DRAM traffic
    channel_util: float       # bus-busy fraction over the token
    channel_bytes: float      # bytes that crossed the flash channels (all ch.)
    flash_array_bytes: float  # bytes read out of NAND arrays (energy model)
    stalled_on_reads: float
    kv_tier_bytes: float = 0.0  # KV spill+prefetch bytes this token (all ch.)
    kv_bus_s: float = 0.0       # per-channel bus seconds the KV tier used
    host_gap_s: float = 0.0     # host dispatch gap added on top of compute

    @property
    def tokens_per_s(self) -> float:
        return 1.0 / self.total


def _attn_phase_time(cfg: ModelConfig, seq_len: int, npu: NPUSpec,
                     kv_bytes_per_elem: int, cross: bool = False) -> float:
    """One attention instance on the NPU: QK^T + PV + softmax + KV traffic."""
    n_heads, d_head = cfg.n_heads, cfg.d_head
    kv_heads = cfg.n_kv_heads
    kv_len = cfg.encoder_seq if cross else seq_len
    if cfg.family == "mla_moe" and not cross:
        # absorbed-MLA decode: per-head dot against the compressed cache
        d_head = cfg.kv_lora_rank + cfg.qk_rope_dim
        kv_heads = 1
    macs = 2 * 2 * n_heads * d_head * kv_len
    sfu = n_heads * kv_len
    kv_bytes = 2 * kv_heads * d_head * kv_len * kv_bytes_per_elem
    return macs / npu.ops_per_s + sfu / npu.sfu_ops_per_s + kv_bytes / npu.dram_bw


def _ssm_phase_time(cfg: ModelConfig, npu: NPUSpec, kv_bytes_per_elem: int) -> float:
    """One SSD state update: read+update+write the recurrent state."""
    state_elems = cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
    conv_elems = cfg.ssm_conv * (cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state)
    macs = 6 * state_elems
    bytes_ = 2 * (state_elems + conv_elems) * kv_bytes_per_elem
    return macs / npu.ops_per_s + bytes_ / npu.dram_bw


def decode_token_time(cfg: ModelConfig, flash: FlashSpec,
                      bytes_per_elem: float = 1.0,
                      policy: Policy = Policy.RC_SLICED,
                      slice_bytes: int = DEFAULT_SLICE_BYTES,
                      seq_len: int = 1024,
                      npu: NPUSpec | None = None,
                      alpha_override: float | None = None,
                      tile_override: tiling.TileShape | None = None,
                      prefetch_bytes: float = 32e6,
                      kv_spill_bytes: float = 0.0,
                      kv_prefetch_bytes: float = 0.0,
                      host_dispatch_s: float = 0.0,
                      n_dispatches: int = 2,
                      overlap_dispatch: bool = False) -> TokenTime:
    """Simulate one decode token; ``kv_spill_bytes``/``kv_prefetch_bytes``
    are the token's tiered-KV page traffic (total across channels, e.g. from
    ``EngineStats.kv_spill_bytes / tokens_out``), accounted as sliced plain
    write/read requests riding the Slice Control bubbles.

    ``host_dispatch_s`` prices the serving loop's host-side overhead per
    jitted dispatch (default 0 = ideal host).  A synchronous loop pays
    ``n_dispatches`` gaps per token serially (decode + sample = 2); the
    overlapped loop (``overlap_dispatch=True``, one fused dispatch enqueued
    while the previous step still computes) hides the gap behind compute —
    only ``max(0, gap - compute)`` of it can ever surface as latency."""
    npu = npu or DEFAULT_NPU  # reprolint: ok boolean-select-trap — npu is an NPUSpec or None, never numeric
    act_bytes = 1.0 if bytes_per_elem >= 1.0 else 2.0  # W4A16 -> 16-bit acts
    kv_b = int(act_bytes)

    plan_cache: dict[tuple[int, int], tiling.MatrixPlan] = {}

    def get_plan(h: int, w: int) -> tiling.MatrixPlan:
        key = (h, w)
        if key not in plan_cache:
            plan_cache[key] = tiling.plan_matrix(
                h, w, flash, bytes_per_elem,
                alpha_override=alpha_override, tile_override=tile_override)
        return plan_cache[key]

    items = []
    npu_phase_time = 0.0
    channel_bytes = 0.0
    array_bytes = 0.0
    stream = planner.decode_execution_stream(cfg)
    n_attn_seen = 0
    for it in stream:
        if it[0] == "gemv":
            _, h, w = it
            plan = get_plan(h, w)
            reads_per_ch = plan.npu_bytes / flash.channels
            rc_in = (plan.tile.w / flash.channels * act_bytes
                     + flash.t_cmd * flash.bw_channel)  # command overhead
            rc_out = plan.tile.h * act_bytes
            items.append(RCBlock(
                n_tiles=plan.n_tiles, rc_input_bytes=rc_in,
                rc_result_bytes=rc_out, read_bytes=reads_per_ch,
                t_r=flash.t_r, bw=flash.bw_channel,
                page_bytes=flash.page_bytes))
            channel_bytes += (plan.n_tiles * (rc_in + rc_out) * flash.channels
                              + plan.npu_bytes)
            array_bytes += h * w * bytes_per_elem
        elif it[0] == "attn":
            cross = cfg.family == "audio" and n_attn_seen % 2 == 1
            dur = _attn_phase_time(cfg, seq_len, npu, kv_b, cross)
            n_attn_seen += 1
            npu_phase_time += dur
            items.append(NpuPhase(dur))
        elif it[0] == "ssm":
            dur = _ssm_phase_time(cfg, npu, kv_b)
            npu_phase_time += dur
            items.append(NpuPhase(dur))
    res = simulate_stream(items, policy, slice_bytes, prefetch_bytes,
                          kv_write_bytes=kv_spill_bytes / flash.channels,
                          kv_read_bytes=kv_prefetch_bytes / flash.channels,
                          kv_bw=flash.bw_channel,
                          kv_page_bytes=flash.page_bytes)
    gap = n_dispatches * host_dispatch_s
    if overlap_dispatch:
        gap = max(0.0, gap - res.time)
    return TokenTime(
        total=res.time + gap,
        npu_phase_time=npu_phase_time,
        channel_util=res.util,
        channel_bytes=channel_bytes,
        flash_array_bytes=array_bytes,
        stalled_on_reads=res.stalled_on_reads,
        kv_tier_bytes=kv_spill_bytes + kv_prefetch_bytes,
        kv_bus_s=res.kv_bus_s,
        host_gap_s=gap,
    )


def kv_swap_overhead_s(cfg: ModelConfig, flash: FlashSpec,
                       kv_spill_bytes: float, kv_prefetch_bytes: float,
                       **kw) -> float:
    """Token-latency cost of riding the given per-token KV tier traffic
    through the channel bubbles: decode time with the traffic minus the
    all-resident baseline.  Near zero while the bubbles absorb it (the
    paper's Slice Control headroom), rising once the bus saturates."""
    base = decode_token_time(cfg, flash, **kw)
    kv = decode_token_time(cfg, flash, kv_spill_bytes=kv_spill_bytes,
                           kv_prefetch_bytes=kv_prefetch_bytes, **kw)
    return kv.total - base.total


def prefill_ttft_s(cfg: ModelConfig, flash: FlashSpec,
                   prompt_len: int, cached_tokens: int = 0,
                   **kw) -> float:
    """Time-to-first-token of a prefill with ``cached_tokens`` of the prompt
    already served by the KV prefix cache.

    The weight stream is token-parallel (one pass over the layers covers
    every new position's GEMVs — the whole suffix batches into it), while
    the per-position NPU attention/SSM phases serialize; cached positions
    participate only as attention context, which the ``seq_len``-sized
    phases already price.  So a prefix hit removes ``cached_tokens`` of the
    serialized NPU phases — TTFT decreases monotonically in the cached
    length and collapses to a single decode-step time on a full hit, which
    is exactly what the serving engine's zero-dispatch resume admission
    does.  ``**kw`` forwards to :func:`decode_token_time`."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    cached = max(0, min(int(cached_tokens), prompt_len - 1))
    n_new = prompt_len - cached
    t = decode_token_time(cfg, flash, seq_len=prompt_len, **kw)
    return t.total + (n_new - 1) * t.npu_phase_time


def family_kv_page_bytes(cfg: ModelConfig, page_size: int,
                         bytes_per_elem: float = 2.0,
                         kv_dtype: str = "bf16") -> float:
    """Bytes one evicted KV page moves, per family — the MLA family spills
    compressed [page, d_ckv + d_krope] rows and the hybrid family only its
    shared-attention groups, so their tier traffic is a fraction of a
    same-sized dense model's.  Derives from the same element count the
    engine's ``kv_page_bytes`` uses (``serving.kv_cache.kv_page_elems``),
    keeping the sim pricing honest with the live byte counters.

    ``kv_dtype="int8"`` prices the quantized pools: one byte per element
    plus the f32 per-row scale payloads (``kv_page_scale_elems``) that
    spill alongside them — a ~2·Dh/(Dh+4) traffic reduction vs bf16."""
    from repro_torch.serving.kv_cache import kv_page_elems, kv_page_scale_elems
    if kv_dtype == "int8":
        return (kv_page_elems(cfg, page_size)
                + 4.0 * kv_page_scale_elems(cfg, page_size))
    return kv_page_elems(cfg, page_size) * bytes_per_elem


def kv_page_cost_s(cfg: ModelConfig, flash: FlashSpec,
                   kv_page_bytes: float | None = None,
                   page_size: int = 16, **kw) -> float:
    """Token-latency cost of ONE evicted KV page (spilled now, prefetched
    back later) — what the serving engine charges an eviction decision.
    ``kv_page_bytes`` defaults to the family-accurate page size
    (``family_kv_page_bytes``), so MLA's compressed pages price cheaper
    than a dense model's full-K/V pages."""
    if kv_page_bytes is None:
        kv_page_bytes = family_kv_page_bytes(cfg, page_size)
    return kv_swap_overhead_s(cfg, flash, kv_page_bytes, kv_page_bytes, **kw)


def flash_only_token_time(cfg: ModelConfig, flash: FlashSpec,
                          bytes_per_elem: float = 1.0,
                          seq_len: int = 1024,
                          npu: NPUSpec | None = None) -> TokenTime:
    """Fig-14 ablation: no hardware-aware tiling, everything on flash (α=1)."""
    return decode_token_time(cfg, flash, bytes_per_elem, Policy.RC_ONLY,
                             seq_len=seq_len, npu=npu, alpha_override=1.0)
