"""The port's CUDA kernels and engine on a card.

Every test here carries the ``gpu`` marker and takes the ``cuda_device``
fixture, which skips where ``torch.cuda.is_available()`` is false; the
file imports no JAX, so it runs on a machine with a card and PyTorch only:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the int8 product is integer arithmetic, bit-exact; the
attention kernels and their plain versions both accumulate in float32 and
round once to bf16, so they round to the same or adjacent bf16 values: each
output must lie within two bf16 steps of the reference value, plus 1e-5 for
float32 summation noise on outputs near 0.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.int8_pagegemv.ops import int8_gemm
from repro_torch.kernels.int8_pagegemv.ref import int8_gemm_ref

BF16_STEPS = 2
F32_NOISE = 1e-5


def assert_bf16_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    got, ref = got.float(), ref.float()
    step = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(2.0 ** -126))) - 7)
    err = (got - ref).abs()
    bad = err > BF16_STEPS * step + F32_NOISE
    assert not bool(bad.any()), (
        f"{int(bad.sum())} outputs beyond {BF16_STEPS} bf16 steps; max |err| "
        f"{err.max().item():.3e}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 references
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (4, 4096, 4096),    # llama2-7b decode, vector path
    (300, 960, 2560),   # smollm prefill, tiled path
    (5, 1000, 300),     # ragged K and N, byte-wise path
    (37, 1000, 130),
])
def test_int8_gemm_bit_exact_on_card(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x, w = (torch.randint(-127, 128, shape, generator=gen, device=cuda_device,
                          dtype=torch.int8) for shape in ((m, k), (n, k)))
    assert torch.equal(int8_gemm(x, w), int8_gemm_ref(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,d,lens", [
    (4, 32, 32, 128, [1024, 545, 17, 0]),   # llama2-7b
    (4, 15, 5, 64, [700, 64, 1, 0]),        # smollm-360m GQA
    (3, 4, 2, 16, [90, 0, 3]),              # reduced
])
def test_paged_decode_attention_on_card(cuda_device, b, h, hkv, d, lens):
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    page, pps = 16, 64
    n_pages = b * pps + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device
                           ).to(torch.bfloat16)

    q, kp, vp = randn(b, h, d), randn(n_pages, page, hkv, d), \
        randn(n_pages, page, hkv, d)
    perm = torch.randperm(n_pages - 1, generator=gen, device=cuda_device)
    block = (perm[:b * pps] + 1).reshape(b, pps).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = paged_decode_attention(q, kp, vp, block, lengths).float()
    ref = paged_decode_attention_ref(q, kp, vp, block, lengths).float()
    live = lengths > 0
    assert_bf16_close(got[live], ref[live])
    assert bool(torch.isfinite(got).all())   # length-0 lanes too


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (4, 512, 32, 32, 128),   # llama2-7b prefill bucket
    (2, 200, 15, 5, 64),     # smollm heads, S not a multiple of 64
    (4, 32, 4, 2, 16),       # reduced
])
def test_flash_attention_on_card(cuda_device, b, s, h, hkv, d):
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    assert_bf16_close(flash_attention(q, k, v), flash_attention_ref(q, k, v))


@pytest.mark.gpu
def test_engine_on_card_launches_every_kernel(cuda_device):
    """The reduced llama2-7b W8A8 engine on the card: requests complete,
    tokens are in range, and the path went through all three kernels."""
    from repro_torch.launch.serve import build_client

    cfg, client = build_client("llama2-7b", reduced=True, max_seq=128,
                               device="cuda")
    handles = [client.submit([3 + i, 17, 99, 5] * (i + 1), max_new_tokens=6)
               for i in range(6)]
    kernels.reset_launch_counts()
    client.run()
    torch.cuda.synchronize()
    for h in handles:
        toks = h.request.out_tokens
        assert h.finish_reason == "length" and len(toks) == 6
        assert all(0 <= t < cfg.vocab_size for t in toks)
    assert all(n > 0 for n in kernels.launch_counts().values()), \
        kernels.launch_counts()
