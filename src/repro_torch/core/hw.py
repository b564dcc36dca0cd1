"""Hardware descriptions of the paper's Cambricon-LLM chiplet.

Copied from ``repro.core.hw``: :class:`FlashSpec` (NAND flash with on-die
compute cores behind shared channels) and :class:`NPUSpec` (a small
systolic NPU with LPDDR5X), the paper's Table II configurations
``CAMBRICON_LLM_S/M/L`` and ``DEFAULT_NPU``.  These figures describe the
paper's edge hardware and drive the section V tiling formulas
(``core/tiling.py``); they are neither a TPU's nor the H100's, and nothing
here times the card.  The JAX module's TPU description is not carried
over.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FlashSpec:
    """NAND flash organisation (paper Table II).

    ``bw_channel`` is bytes/s on one channel bus (1000 MT/s × 8-bit = 1 GB/s).
    ``t_r`` is the page read time (NAND array -> data register), seconds.
    """

    channels: int = 8
    chips_per_channel: int = 2
    dies_per_chip: int = 2
    planes_per_die: int = 2
    ccores_per_die: int = 1
    page_bytes: int = 16 * 1024
    t_r: float = 30e-6
    t_cmd: float = 1e-6  # per-request command/address + FTL overhead (ONFI)
    bw_channel: float = 1.0e9  # 1000 MT/s, 8-bit bus
    # On-die compute core rating: must match array read speed (paper §IV-B).
    ccore_ops_per_s: float = 1.6e9

    @property
    def ccores_per_channel(self) -> int:
        return self.chips_per_channel * self.dies_per_chip * self.ccores_per_die

    @property
    def total_ccores(self) -> int:
        return self.channels * self.ccores_per_channel

    @property
    def total_channel_bw(self) -> float:
        return self.channels * self.bw_channel

    @property
    def page_read_bw_per_ccore(self) -> float:
        """Sustained array->register bandwidth one pipelined compute core sees."""
        return self.page_bytes / self.t_r

    @property
    def in_flash_bw(self) -> float:
        """Aggregate in-flash weight-processing bandwidth (all ccores)."""
        return self.total_ccores * self.page_read_bw_per_ccore


# Paper Table II configurations. S/M/L differ only in channel & chip counts.
CAMBRICON_LLM_S = FlashSpec(channels=8, chips_per_channel=2)
CAMBRICON_LLM_M = FlashSpec(channels=16, chips_per_channel=4)
CAMBRICON_LLM_L = FlashSpec(channels=32, chips_per_channel=8)

FLASH_CONFIGS = {
    "S": CAMBRICON_LLM_S,
    "M": CAMBRICON_LLM_M,
    "L": CAMBRICON_LLM_L,
}


@dataclasses.dataclass(frozen=True)
class NPUSpec:
    """The paper's edge NPU: 16x16 systolic @1GHz = 2 TOPS INT8, LPDDR5X DRAM."""

    ops_per_s: float = 2.0e12
    dram_bw: float = 40.0e9  # LPDDR5X ~40 GB/s, holds only the KV cache
    sfu_ops_per_s: float = 32.0e9  # special functions (softmax, sin/cos, ...)


DEFAULT_NPU = NPUSpec()
