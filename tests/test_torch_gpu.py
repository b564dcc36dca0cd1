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
from repro_torch.kernels.decode_attention.ref import (
    SPLIT, paged_decode_attention_ref)
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
    (4, 4096, 4096),      # llama2-7b decode, tensor-core GeMV
    (300, 960, 2560),     # smollm prefill, tensor-core variant
    (5, 1000, 300),       # K % 16 != 0, ragged N: the __dp4a GeMV
    (37, 1000, 130),      # K % 16 != 0: the __dp4a tiled variant
    (2048, 3584, 14576),  # zamba2-7b in_proj: N not a multiple of 128
    (2048, 7168, 3584),   # zamba2-7b out_proj
    (9, 4096, 11008),     # ragged M tiles
    (130, 3584, 14576),
])
def test_int8_gemm_bit_exact_on_card(cuda_device, m, k, n):
    from repro_torch.kernels.int8_pagegemv import ops

    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x, w = (torch.randint(-127, 128, shape, generator=gen, device=cuda_device,
                          dtype=torch.int8) for shape in ((m, k), (n, k)))
    variant = ops.gemm_variant(m, k, x.data_ptr(), w.data_ptr())
    before = dict(ops.LAUNCHES)
    assert torch.equal(int8_gemm(x, w), int8_gemm_ref(x, w))
    assert {name: ops.LAUNCHES[name] - before[name] for name in before} == {
        name: int(name == variant) for name in before}


@pytest.mark.gpu
def test_int8_gemm_misaligned_base_takes_the_dp4a_tile(cuda_device):
    from repro_torch.kernels.int8_pagegemv import ops

    gen = torch.Generator(device=cuda_device).manual_seed(130)
    buf, w = (torch.randint(-127, 128, shape, generator=gen,
                            device=cuda_device, dtype=torch.int8)
              for shape in ((130 * 4096 + 1,), (4096, 4096)))
    x = buf[1:].view(130, 4096)
    before = ops.LAUNCHES["int8_gemm"]
    assert torch.equal(int8_gemm(x, w), int8_gemm_ref(x, w))
    assert ops.LAUNCHES["int8_gemm"] == before + 1


# (K, N) of every W8A8 linear at decode: llama2-7b, zamba2-7b (shared
# block, Mamba in_proj / out_proj), smollm-360m; then ragged N and K
GEMV_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096),
               (3584, 3584), (3584, 14336), (14336, 3584), (3584, 14576),
               (7168, 3584),
               (960, 960), (960, 320), (960, 2560), (2560, 960),
               (960, 300), (1000, 300), (4104, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", GEMV_SHAPES)
def test_int8_gemv_bit_exact_at_every_decode_batch(cuda_device, k, n):
    """M = 1..8 at each shape: the tensor-core GeMV where K % 16 == 0, the
    __dp4a GeMV at K % 16 == 8; bit-exact, and only the chosen variant's
    counter moves."""
    from repro_torch.kernels.int8_pagegemv import ops

    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    for m in range(1, ops.GEMV_MAX_M + 1):
        x = torch.randint(-127, 128, (m, k), generator=gen,
                          device=cuda_device, dtype=torch.int8)
        variant = ops.gemm_variant(m, k, x.data_ptr(), w.data_ptr())
        assert variant == ("int8_gemv" if k % 16 == 0 else "int8_gemv_dp4a")
        before = dict(ops.LAUNCHES)
        got = int8_gemm(x, w)
        assert torch.equal(got, int8_gemm_ref(x, w)), (m, k, n)
        assert {name: ops.LAUNCHES[name] - before[name] for name in before} \
            == {name: int(name == variant) for name in before}


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["x", "w"])
def test_int8_gemv_misaligned_base_takes_the_dp4a_gemv(cuda_device, operand):
    from repro_torch.kernels.int8_pagegemv import ops

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x, w = (torch.randint(-127, 128, (size + 1,), generator=gen,
                          device=cuda_device, dtype=torch.int8)
            for size in (4 * 4096, 4096 * 4096))
    x = x[1:].view(4, 4096) if operand == "x" else x[:-1].view(4, 4096)
    w = w[1:].view(4096, 4096) if operand == "w" else w[:-1].view(4096, 4096)
    before = ops.LAUNCHES["int8_gemv_dp4a"]
    assert torch.equal(int8_gemm(x, w), int8_gemm_ref(x, w))
    assert ops.LAUNCHES["int8_gemv_dp4a"] == before + 1


def _paged_inputs(dev, seed, b, h, hkv, d, pps, page=16):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev
                           ).to(torch.bfloat16)

    n_pages = b * pps + 1
    q, kp, vp = randn(b, h, d), randn(n_pages, page, hkv, d), \
        randn(n_pages, page, hkv, d)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    block = (perm[:b * pps] + 1).reshape(b, pps).to(torch.int32)
    return q, kp, vp, block


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,d", [(32, 32, 128), (32, 32, 112),
                                     (15, 5, 64), (8, 1, 16)])
def test_paged_decode_attention_at_split_edges_on_card(cuda_device, h, hkv,
                                                       d):
    """Lengths 0, 1, SPLIT - 1, SPLIT, SPLIT + 1 and the full capacity of
    the block table (4 splits): within two bf16 steps of the plain version;
    a length-0 slot comes out 0."""
    lens = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 4 * SPLIT]
    pps = 4 * SPLIT // 16
    q, kp, vp, block = _paged_inputs(cuda_device, d + h, len(lens), h, hkv,
                                     d, pps)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = paged_decode_attention(q, kp, vp, block, lengths)
    ref = paged_decode_attention_ref(q, kp, vp, block, lengths)
    assert_bf16_close(got[1:], ref[1:])
    assert bool(torch.isfinite(got.float()).all())
    assert not bool(got[0].float().any())


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1, SPLIT, 545, 1024])
def test_paged_decode_attention_slot_bits_do_not_depend_on_the_batch(
        cuda_device, length):
    """Slot 0 alone, inside a batch of 4 with other lengths, and under a
    block table twice as wide: the same output bits."""
    h, hkv, d, pps = 32, 32, 128, 64
    q, kp, vp, block = _paged_inputs(cuda_device, length, 4, h, hkv, d, pps)
    lens = torch.tensor([length, 17, 1024, 0], dtype=torch.int32,
                        device=cuda_device)
    batched = paged_decode_attention(q, kp, vp, block, lens)
    alone = paged_decode_attention(q[:1].contiguous(), kp, vp,
                                   block[:1].contiguous(), lens[:1].clone())
    wide = torch.cat([block[:1], block[1:2]], dim=1).contiguous()
    wider = paged_decode_attention(q[:1].contiguous(), kp, vp, wide,
                                   lens[:1].clone())
    assert torch.equal(batched[0], alone[0])
    assert torch.equal(wider[0], alone[0])


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
    (4, 512, 32, 32, 112),   # zamba2-7b's shared block
    (2, 200, 8, 2, 128),     # ragged S at D 128, GQA
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
    tokens are in range, and the path went through B1, B2 (the GeMV at
    decode, the tensor-core GEMM at prefill) and B3."""
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
    serving = ("int8_gemv", "int8_gemm_tc", "paged_decode_attention",
               "flash_attention")   # B4 and B5 are off the W8A8 path
    assert all(counts[k] > 0 for k in serving), counts


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["w8a8", "tied", "w4a16"])
def test_lm_head_row_bits_do_not_depend_on_the_batch(cuda_device, head):
    """llama2-7b's lm_head (the float32 product of the W8A8 head and of a
    tied embedding, and B4's GeMV for a W4A16 head) gives each row the same
    bits at M = 1, 2, 3, 4 and 8 rows as alone."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.layers import init_linear
    from repro_torch.models.model import lm_head
    from repro_torch.quant.convert import quantize_params

    cfg = get_arch("llama2-7b")
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    if head == "tied":
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
        params = {"embed": (torch.randn((cfg.vocab_size, cfg.d_model),
                                        generator=gen, device=cuda_device)
                            * 0.02).to(torch.bfloat16)}
    else:
        params = quantize_params({"lm_head": init_linear(
            gen, cfg.d_model, cfg.vocab_size, False, torch.bfloat16,
            cuda_device)}, mode=head)
        assert {"w8a8": "w_q", "w4a16": "w_p4"}[head] in params["lm_head"]
    x = torch.randn((8, cfg.d_model), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    alone = torch.cat([lm_head(params, cfg, x[r:r + 1]) for r in range(8)])
    for m in (1, 2, 3, 4, 8):
        got = lm_head(params, cfg, x[:m])
        diff = (got != alone[:m]).any(dim=1)
        assert not bool(diff.any()), (
            f"M={m}: rows {diff.nonzero().flatten().tolist()} differ from "
            f"the same rows alone")


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
@pytest.mark.parametrize("b", [1, 4096])
def test_ecc_decode_batch_sizes_on_card(cuda_device, b):
    """B5 on one page (one CTA) and on 4,096 pages (the timed batch, many
    CTAs an SM) at BER 2e-3: bit-exact against the plain version."""
    from repro_torch.core import ecc
    from repro_torch.kernels.ecc_decode.ops import ecc_decode

    gen = torch.Generator(device=cuda_device).manual_seed(b)
    pages = torch.randint(0, 256, (b, ecc.PAGE_ELEMS), generator=gen,
                          device=cuda_device, dtype=torch.uint8)
    code = ecc.inject_ecc_bitflips(ecc.encode_pages(pages), 2e-3, gen)
    noisy = ecc.inject_bitflips(pages, 2e-3, gen)
    got = ecc_decode(noisy, code)
    assert torch.equal(got, ecc.decode_pages(noisy, code))


def planted_collisions(ecc, pages):
    """Sidecars of 4 clean ``pages`` with colliding entries; the n-th entry
    placed on a page's address gets value copies 0x11 (n + 1), so each
    restore is told apart.  Returns (sidecars, the address of each page,
    the byte the last entry leaves there).  Page 0: entry 0 valid, then
    entry K-1 invalid, on a value below the threshold (the in-page value
    stays); page 1: entry 0 invalid, then K-1 valid (0x22); page 2:
    entries 0, K/2 and K-1 valid on one address (0x33); page 3: entry 0
    valid, then K-1 invalid, on an outlier above the threshold (clamped to
    0).  An entry is made invalid by inverting its 5 parity bits, which
    puts its syndrome at 31."""
    code = ecc.encode_pages(pages)
    addr, parity, copies = (code.addr.clone(), code.addr_parity.clone(),
                            code.copies.clone())
    k = addr.shape[1]
    mag = pages.view(torch.int8).to(torch.int32).abs()
    thr = code.threshold[:, 0].to(torch.int32)
    low = int(torch.nonzero(mag[0] <= thr[0])[0, 0])
    plan = [(low, {0: True, k - 1: False}),
            (int(addr[1, 0]), {0: False, k - 1: True}),
            (int(addr[2, 0]), {0: True, k // 2: True, k - 1: True}),
            (int(addr[3, 0]), {0: True, k - 1: False})]
    assert int(mag[3, plan[3][0]]) > int(thr[3])
    for page, (target, entries) in enumerate(plan):
        for n, (e, valid) in enumerate(entries.items()):
            addr[page, e] = target
            parity[page, e] = int(ecc.hamming_encode(addr[page, e:e + 1])[0]) \
                ^ (0 if valid else 0x1F)
            copies[page, e] = 0x11 * (n + 1)
    want = [int(pages[0, low]), 0x22, 0x33, 0]
    return (ecc.PageECC(code.threshold, addr.contiguous(),
                        parity.contiguous(), copies.contiguous()),
            [t for t, _ in plan], want)


@pytest.mark.gpu
def test_ecc_decode_planted_collisions_on_card(cuda_device):
    """B5 where entries collide, valid then invalid, invalid then valid,
    and three on one address: bit-exact against the plain version, and the
    byte at each collision is the one "the last entry wins" gives."""
    from repro_torch.core import ecc
    from repro_torch.kernels.ecc_decode.ops import ecc_decode

    gen = torch.Generator(device=cuda_device).manual_seed(16)
    pages = torch.randint(0, 256, (4, ecc.PAGE_ELEMS), generator=gen,
                          device=cuda_device, dtype=torch.uint8)
    code, at, want = planted_collisions(ecc, pages)
    ref = ecc.decode_pages(pages, code)
    got = ecc_decode(pages, code)
    assert torch.equal(got, ref), int((got != ref).sum())
    assert [int(ref[p, a]) for p, a in enumerate(at)] == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (4, 4096, 32000),   # llama2-7b lm_head at decode, vector path
    (4, 960, 2048),     # smollm width: 7.5 groups
    (3, 100, 70),       # ragged K (g = 100): byte-wise path
    (20, 4096, 300),    # M > 8: tiled variant
    (130, 3584, 14336),  # zamba2-7b gate/up, ragged M tiles: tiled variant
])
def test_w4a16_gemm_on_card(cuda_device, m, k, n, dtype):
    from repro_torch.kernels.w4a16_gemv import ops
    from repro_torch.quant.int4 import dequantize4, quantize_weight4

    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    w = torch.randn((n, k), generator=gen, device=cuda_device) * 0.05
    q = quantize_weight4(w)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    before = dict(ops.LAUNCHES)
    got = w4a16_gemm(x, q.w_packed, q.scale)
    assert {name: ops.LAUNCHES[name] - before[name] for name in before} == {
        name: int(name == ops.variant(m)) for name in before}
    ref = w4a16_gemm_ref(x, q.w_packed, q.scale)
    bound = 1e-5 * (x.float().abs() @ dequantize4(q).abs().T) + 1e-6
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


@pytest.mark.gpu
def test_hybrid_w4a16_engine_launches_both_b4_variants(cuda_device):
    """The reduced zamba2-7b engine with ``quant="w4a16"`` (the shared
    block's linears and the lm_head W4A16, the Mamba layers W8A8): requests
    complete, and the path went through B4's tiled GEMM (prefill) and its
    GeMV (decode), B6, and B2's GeMV and GEMM."""
    from repro_torch.launch.serve import build_client

    cfg, client = build_client("zamba2-7b", reduced=True, quant="w4a16",
                               max_seq=128, device="cuda")
    params = client.router.cores[0].params
    assert "w_p4" in params["shared"]["attn"]["q"]
    assert "w_p4" in params["lm_head"]
    handles = [client.submit([3 + i, 17, 99, 5] * (i + 2), max_new_tokens=5)
               for i in range(4)]
    kernels.reset_launch_counts()
    client.run()
    torch.cuda.synchronize()
    for h in handles:
        toks = h.request.out_tokens
        assert h.finish_reason == "length" and len(toks) == 5
        assert all(0 <= t < cfg.vocab_size for t in toks)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in (
        "w4a16_gemv", "w4a16_gemm", "ssd_intra_chunk", "int8_gemv",
        "int8_gemm_tc")), counts


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
    (2, 256, 16, 2, 64, 64, 128, torch.bfloat16),   # G 2: each group's C B^T
    (4, 1024, 22, 1, 64, 64, 64, torch.bfloat16),   # Q 64; 22 heads, blocks of 6
    (1, 80, 8, 1, 32, 24, 40, torch.bfloat16),      # Q, N not multiples of 16
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
def test_ssd_intra_chunk_head_blocks_are_ragged_where_tested(cuda_device):
    """The 22-head case above splits its heads into blocks with a shorter
    last one on this card, and zamba2-7b's 112 heads fill about one wave of
    two CTAs an SM."""
    from repro_torch.kernels.ssd_scan.ops import ctas_per_sm, head_block

    slots = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count * ctas_per_sm(64)
    assert 22 % head_block(4, 16, 22, 1, slots) != 0
    hpc = head_block(4, 4, 112, 1, slots)
    assert 4 * 4 * -(-112 // hpc) <= slots


@pytest.mark.gpu
def test_ssd_intra_chunk_refuses_misaligned_views(cuda_device):
    """The bf16 kernel copies 16-byte rows: a view whose rows start off the
    16-byte grid raises; it is not sent elsewhere."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk

    x, a, bm, _ = _ssd_inputs(cuda_device, 1, 32, 8, 1, 16, 16,
                              torch.bfloat16, seed=5)
    xbc = torch.randn((1, 32, 33), device=cuda_device).to(torch.bfloat16)
    cm = xbc[..., 1:17].reshape(1, 32, 1, 16)
    with pytest.raises(ValueError, match="16-byte"):
        ssd_intra_chunk(x, a, bm, cm, 32)


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
        "ssd_intra_chunk", "int8_gemv", "int8_gemm_tc",
        "paged_decode_attention", "flash_attention")), counts
