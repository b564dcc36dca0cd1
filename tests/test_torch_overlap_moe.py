"""test_torch_overlap.py's family cases for the moe family
(qwen2-moe-a2.7b, reduced): the overlapped loop gives the synchronous
loop's streams, greedy and sampled, through an eos found at the lagged
drain, a requeue, a slot at capacity and an abort mid-stream.  The cases
are the dense and hybrid ones, run here over the moe weights; they sit in
a file of their own so that a test run handing each file to one worker
keeps its files near the same length."""

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_overlap import (  # noqa: F401  (collected here)
    test_overlap_abort_mid_stream, test_overlap_bit_identical,
    test_overlap_capacity_identity, test_overlap_eos_lag_identity,
    test_overlap_requeue_identity)

ARCHS = {"moe": "qwen2-moe-a2.7b"}


@pytest.fixture(scope="module", params=sorted(ARCHS), ids=lambda f: f"fam_{f}")
def fam(request):
    cfg = get_arch(ARCHS[request.param]).reduced()
    params = TM.init_params(cfg, seed=0, max_seq=64, device="cpu",
                            dtype=torch.float32)
    return request.param, cfg, params
