"""Analytic baseline models (paper Table III): Flexgen-SSD / Flexgen-DRAM /
MLC-LLM.  Single-batch decode is bandwidth-bound end to end, so each baseline
is modelled as weights-over-the-bottleneck-link plus framework efficiency.

Constants (documented calibration, public specs):
  * Flexgen-SSD : Intel PCIe-4 NVMe sequential read ~7 GB/s, efficiency 0.8
  * Flexgen-DRAM: PCIe 4.0 x16 host->GPU ~25 GB/s, efficiency 0.9
  * MLC-LLM     : Snapdragon 8 Gen 2 LPDDR5X ~50 GB/s effective, eff. 0.55,
                  4-bit weights (the paper's Table III: MLC-LLM runs W4)
Validation vs paper: OPT-6.7B Flexgen-SSD 0.81 tok/s (model: 0.84),
Flexgen-DRAM 3.52 tok/s (model: 3.47); Llama2-7B MLC-LLM 7.58 (model: 7.7).

The port's copy of ``repro.sim.baselines`` (pure Python; the port imports
nothing of the JAX package).  Its figures describe the paper's edge hardware
and models; none of them times the H100.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core import planner

NVME_BW = 7.0e9
NVME_EFF = 0.8
PCIE_BW = 25.0e9
PCIE_EFF = 0.9
PHONE_DRAM_BW = 50.0e9
PHONE_EFF = 0.55


def _weight_bytes(cfg: ModelConfig, bytes_per_elem: float) -> float:
    return sum(m.active_params for m in planner.model_matrices(cfg)) * bytes_per_elem


def flexgen_ssd_tokens_per_s(cfg: ModelConfig, bytes_per_elem: float = 1.0) -> float:
    return NVME_BW * NVME_EFF / _weight_bytes(cfg, bytes_per_elem)


def flexgen_dram_tokens_per_s(cfg: ModelConfig, bytes_per_elem: float = 1.0) -> float:
    return PCIE_BW * PCIE_EFF / _weight_bytes(cfg, bytes_per_elem)


def mlc_llm_tokens_per_s(cfg: ModelConfig, bytes_per_elem: float = 0.5) -> float:
    """4-bit round-to-nearest quantization on a Snapdragon 8 Gen 2."""
    return PHONE_DRAM_BW * PHONE_EFF / _weight_bytes(cfg, bytes_per_elem)


def mlc_llm_fits_dram(cfg: ModelConfig, dram_bytes: float = 12e9,
                      bytes_per_elem: float = 0.5) -> bool:
    """MLC-LLM OOMs beyond ~7B on a 12-16GB phone (paper: 13B/70B OOM)."""
    return _weight_bytes(cfg, bytes_per_elem) + 2e9 < dram_bytes
