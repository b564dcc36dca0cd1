"""test_torch_tiered.py's engine cases for the moe family
(qwen2-moe-a2.7b, reduced): the flash tier's streams equal the
all-resident engine's, synchronous and overlapped, and a tier bounded
below the demand finishes every request.  The cases are the dense and
hybrid ones, run here over the moe weights; they sit in a file of their
own so that a test run handing each file to one worker keeps its files
near the same length."""

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_tiered import (  # noqa: F401  (collected here)
    test_tiered_engine_bounded_flash_tier,
    test_tiered_engine_matches_all_resident)

ARCHS = {"moe": "qwen2-moe-a2.7b"}


@pytest.fixture(scope="module", params=sorted(ARCHS),
                ids=lambda f: f"fam_{f}")
def fam(request):
    """The port's own float32 weights (the bit-identity oracles)."""
    cfg = get_arch(ARCHS[request.param]).reduced()
    return request.param, cfg, TM.init_params(
        cfg, seed=0, max_seq=64, device="cpu", dtype=torch.float32)
