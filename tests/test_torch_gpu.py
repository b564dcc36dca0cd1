"""The port's CUDA kernels and engine on a card.

Every test here carries the ``gpu`` marker and takes the ``cuda_device``
fixture, which skips where ``torch.cuda.is_available()`` is false; the
file imports no JAX, so it runs on a machine with a card and PyTorch only:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: the int8 product and the ECC decode are integer arithmetic,
bit-exact; the W4A16 product sums float32 products in another order than
its plain version: |got - ref| <= 1e-5 (|x| @ |W|^T) + 1e-6; the
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
from repro_torch.kernels.w4a16_gemv.ops import w4a16_gemm
from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref

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
    tokens are in range, and the path went through B1, B2 (both variants)
    and B3."""
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
    counts = kernels.launch_counts()
    serving = ("int8_gemv", "int8_gemm", "paged_decode_attention",
               "flash_attention")   # B4 and B5 are off the W8A8 path
    assert all(counts[k] > 0 for k in serving), counts


@pytest.mark.gpu
@pytest.mark.parametrize("ber", [0.0, 1e-4, 2e-3])
def test_ecc_decode_bit_exact_on_card(cuda_device, ber):
    """B5 against its plain version on 512 random int8 pages corrupted
    (pages and sidecars) at ``ber``: equal on every position, collisions
    included (both apply the entries in order, the last one winning)."""
    from repro_torch.core import ecc
    from repro_torch.kernels.ecc_decode.ops import ecc_decode

    gen = torch.Generator(device=cuda_device).manual_seed(int(ber * 1e5))
    pages = torch.randint(0, 256, (512, ecc.PAGE_ELEMS), generator=gen,
                          device=cuda_device, dtype=torch.uint8)
    code = ecc.encode_pages(pages)
    noisy = ecc.inject_bitflips(pages, ber, gen)
    code = ecc.inject_ecc_bitflips(code, ber, gen)
    got = ecc_decode(noisy, code)
    ref = ecc.decode_pages(noisy, code)
    assert torch.equal(got, ref), int((got != ref).sum())
    if ber == 0.0:
        assert torch.equal(got, pages)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (4, 4096, 32000),   # llama2-7b lm_head at decode, vector path
    (4, 960, 2048),     # smollm width: 7.5 groups
    (3, 100, 70),       # ragged K (g = 100): byte-wise path
    (20, 4096, 300),    # M > 8: tiled variant
])
def test_w4a16_gemm_on_card(cuda_device, m, k, n):
    from repro_torch.quant.int4 import dequantize4, quantize_weight4

    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((n, k), generator=gen, device=cuda_device) * 0.05
    q = quantize_weight4(w)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    got = w4a16_gemm(x, q.w_packed, q.scale)
    ref = w4a16_gemm_ref(x, q.w_packed, q.scale)
    bound = 1e-5 * (x.abs() @ dequantize4(q).abs().T) + 1e-6
    err = (got - ref).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.gpu
def test_w4a16_engine_launches_its_kernel(cuda_device):
    """The reduced llama2-7b engine with ``quant="w4a16"`` (W8A8 layers, a
    W4A16 lm_head) serves on the card through the B4 kernel."""
    from repro_torch.launch.serve import build_client

    cfg, client = build_client("llama2-7b", reduced=True, quant="w4a16",
                               max_seq=128, device="cuda")
    assert "w_p4" in client.router.cores[0].params["lm_head"]
    handles = [client.submit([5 + i, 11, 42] * (i + 1), max_new_tokens=5)
               for i in range(4)]
    kernels.reset_launch_counts()
    client.run()
    torch.cuda.synchronize()
    for h in handles:
        assert h.finish_reason == "length" and len(h.request.out_tokens) == 5
    counts = kernels.launch_counts()
    assert counts["w4a16_gemv"] > 0 and counts["int8_gemv"] > 0, counts
