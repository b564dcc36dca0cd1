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
float32 summation noise on outputs near 0.  The SSD intra-chunk kernel (B6)
against its plain version computed in float64 on the same inputs: rtol =
atol = 1e-4, the JAX package's own B6 tolerance (tests/test_kernels.py).
The float64 yardstick: at the model's decays a chunk's cumulative sum
reaches |cs| ~ 2e3, where two float32 summation orders differ by ~1e-4
and so move L = exp(cs_i - cs_j) by as much as the tolerance; the kernel
sums in double, so it is held to the exact function.
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


def _ssd_inputs(dev, b, s, h, g, p, n, dtype, seed):
    """Model-like inputs: x and B / C of unit scale in the working dtype,
    a = -A_h dt with A_h = 1..16 over the heads (the model's a_log) and
    dt = softplus(normal)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.linspace(1.0, 16.0, h, device=dev) * dt
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev)
              .mul(0.5).to(dtype) for _ in range(2))
    return x, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,g,p,n,chunk,dtype", [
    (2, 256, 16, 1, 64, 64, 128, torch.bfloat16),   # zamba2-7b widths
    (1, 256, 24, 1, 64, 128, 128, torch.bfloat16),  # mamba2-130m
    (2, 8, 8, 1, 16, 16, 8, torch.bfloat16),        # reduced, Q = 8
    (2, 96, 8, 2, 32, 32, 32, torch.float32),       # G > 1, float32 inputs
])
def test_ssd_intra_chunk_on_card(cuda_device, b, s, h, g, p, n, chunk,
                                 dtype):
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_model_ref

    x, a, bm, cm = _ssd_inputs(cuda_device, b, s, h, g, p, n, dtype,
                               seed=s + h)
    got = ssd_intra_chunk(x, a, bm, cm, chunk)
    ref = ssd_intra_chunk_model_ref(x, a, bm, cm, chunk, torch.float64)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, p)
    torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ssd_intra_chunk_reads_strided_views(cuda_device):
    """B and C as the model passes them: views into the conv output."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_model_ref

    x, a, _, _ = _ssd_inputs(cuda_device, 2, 64, 8, 1, 16, 16,
                             torch.bfloat16, seed=3)
    xbc = torch.randn((2, 64, 128 + 32), device=cuda_device).to(
        torch.bfloat16)
    bm = xbc[..., 128:144].reshape(2, 64, 1, 16)
    cm = xbc[..., 144:].reshape(2, 64, 1, 16)
    got = ssd_intra_chunk(x, a, bm, cm, 32)
    ref = ssd_intra_chunk_model_ref(x, a, bm, cm, 32, torch.float64)
    torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_attention_kernels_at_head_dim_112(cuda_device):
    """zamba2-7b's shared block: 32 heads of 112 (B1 at decode, B3 at
    prefill)."""
    gen = torch.Generator(device=cuda_device).manual_seed(112)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device
                           ).to(torch.bfloat16)

    q, k, v = randn(2, 200, 32, 112), randn(2, 200, 32, 112), \
        randn(2, 200, 32, 112)
    assert_bf16_close(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    page, pps, b = 16, 32, 4
    kp, vp = randn(b * pps + 1, page, 32, 112), randn(b * pps + 1, page, 32,
                                                      112)
    block = (torch.randperm(b * pps, generator=gen, device=cuda_device) + 1
             ).reshape(b, pps).to(torch.int32)
    lengths = torch.tensor([512, 300, 17, 0], dtype=torch.int32,
                           device=cuda_device)
    qd = randn(b, 32, 112)
    got = paged_decode_attention(qd, kp, vp, block, lengths)
    ref = paged_decode_attention_ref(qd, kp, vp, block, lengths)
    live = lengths > 0
    assert_bf16_close(got[live], ref[live])


@pytest.mark.gpu
def test_hybrid_engine_on_card_launches_its_kernels(cuda_device):
    """The reduced zamba2-7b W8A8 engine on the card: requests complete,
    tokens are in range, and the path went through B6, B1, B2 and B3."""
    from repro_torch.launch.serve import build_client

    cfg, client = build_client("zamba2-7b", reduced=True, max_seq=128,
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
    assert all(counts[k] > 0 for k in (
        "ssd_intra_chunk", "int8_gemv", "int8_gemm", "paged_decode_attention",
        "flash_attention")), counts
