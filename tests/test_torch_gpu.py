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
sums in double, so it is held to the exact function.  The grouped GEMM
(the moe family's ragged_dot) and its plain version both accumulate in
float32 and round once to bf16: two bf16 steps of |ref| plus
1e-5 (|x| @ |W|) for float32 summation noise.  The MLA decode kernel and
its plain version are float32 throughout (a float32 context, no bf16
rounding), summed in other orders: |got - ref| <= 1e-5 max|ckv|, the
context's own scale.
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
@pytest.mark.parametrize("h,hkv,d,kv", [
    (32, 32, 128, "bf16"), (32, 32, 112, "bf16"), (15, 5, 64, "bf16"),
    (8, 1, 16, "bf16"),
    (32, 2, 128, "bf16"), (96, 8, 128, "bf16"),   # groups of 16 and 12
    (32, 2, 128, "int8"), (96, 8, 128, "int8")])
def test_paged_decode_attention_at_split_edges_on_card(cuda_device, h, hkv,
                                                       d, kv):
    """Lengths 0, 1, SPLIT - 1, SPLIT, SPLIT + 1 and the full capacity of
    the block table (4 splits): within two bf16 steps of the plain version;
    a length-0 slot comes out 0."""
    lens = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 4 * SPLIT]
    pps = 4 * SPLIT // 16
    q, kp, vp, block = _paged_inputs(cuda_device, d + h, len(lens), h, hkv,
                                     d, pps)
    if kv == "int8":
        kp, vp = _int8_pools(kp, vp)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = paged_decode_attention(q, kp, vp, block, lengths)
    ref = paged_decode_attention_ref(q, kp, vp, block, lengths)
    assert_bf16_close(got[1:], ref[1:])
    assert bool(torch.isfinite(got.float()).all())
    assert not bool(got[0].float().any())


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,kv", [(32, 32, "bf16"), (32, 2, "bf16"),
                                      (96, 8, "bf16"), (32, 2, "int8"),
                                      (96, 8, "int8")])
@pytest.mark.parametrize("length", [1, SPLIT, 545, 1024])
def test_paged_decode_attention_slot_bits_do_not_depend_on_the_batch(
        cuda_device, length, h, hkv, kv):
    """Slot 0 alone, inside a batch of 4 with other lengths, and under a
    block table twice as wide: the same output bits (MHA, and query groups
    of 16 and 12 over bf16 and int8 pools)."""
    d, pps = 128, 64
    q, kp, vp, block = _paged_inputs(cuda_device, length, 4, h, hkv, d, pps)
    if kv == "int8":
        kp, vp = _int8_pools(kp, vp)
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
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("h,cut", [(16, 8), (12, 8), (12, 6)])
def test_paged_decode_attention_head_bits_do_not_depend_on_the_group(
        cuda_device, h, cut, kv):
    """A group of ``h`` heads over one kv head (two passes of up to 8 in
    the kernel) equals, bit for bit, the same queries in two calls of
    ``cut`` and ``h - cut`` heads over the same pools."""
    lens = [1024, 545, 17, 0, 1, SPLIT - 1, SPLIT, SPLIT + 1]
    q, kp, vp, block = _paged_inputs(cuda_device, h + cut, len(lens), h, 1,
                                     128, 64)
    if kv == "int8":
        kp, vp = _int8_pools(kp, vp)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    whole = paged_decode_attention(q, kp, vp, block, lengths)
    parts = torch.cat([
        paged_decode_attention(q[:, :cut].contiguous(), kp, vp, block,
                               lengths),
        paged_decode_attention(q[:, cut:].contiguous(), kp, vp, block,
                               lengths)], dim=1)
    assert torch.equal(whole, parts)


@pytest.mark.gpu
def test_paged_decode_attention_keeps_its_bits_at_groups_up_to_8(
        cuda_device):
    """Groups 1-8 (the ported configurations' head layouts and each group
    over 2 kv heads, bf16 and int8 pools) against B1 as it was while it
    took groups of up to 8 only (``csrc/diag/decode_attention_groups8.cu``,
    built by ``kernels/diag_b1_bits.py``): every output bit for bit."""
    from repro_torch.kernels import diag_b1_bits

    assert diag_b1_bits.compare(torch, diag_b1_bits.load()) == 0


@pytest.mark.gpu
def test_paged_decode_attention_refuses_a_group_above_16(cuda_device):
    q, kp, vp, block = _paged_inputs(cuda_device, 17, 1, 17, 1, 128, 4)
    lengths = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="B1 takes at most 16"):
        paged_decode_attention(q, kp, vp, block, lengths)


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
    (4, 512, 16, 16, 192),   # deepseek-v2-lite-16b's MLA prefill
    (2, 200, 4, 4, 24),      # its reduced qk head
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
def test_blocked_lm_head_at_qwen2_vl_72b_vocab(cuda_device):
    """qwen2-vl-72b's W8A8 head (152,064 x 8192: 1.25e9 int8 weights) in
    LM_HEAD_BLOCK-row float32 blocks: within 1e-5 (|x| @ |W|) + 1e-6 of the
    float64 product of the dequantized weights, a row's bits the same at
    M = 1, 4 and 8, and no more memory taken than two float32 blocks and
    the logits (the whole float32 head would be 4.98 GB)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as TM

    cfg = get_arch("qwen2-vl-72b")
    v, d = cfg.vocab_size, cfg.d_model
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    w_q = torch.randint(-127, 128, (v, d), generator=gen, device=cuda_device,
                        dtype=torch.int8)
    scale = torch.rand(v, generator=gen, device=cuda_device) * 1e-3 + 1e-4
    params = {"lm_head": {"w_q": w_q, "scale": scale}}
    x = torch.randn((8, d), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = TM.lm_head(params, cfg, x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert got.shape == (8, v)
    assert extra <= 2 * TM.LM_HEAD_BLOCK * d * 4 + 2 * got.numel() * 4 \
        + (64 << 20), extra
    xd = x.double()
    for v0 in range(0, v, 32768):
        w = w_q[v0:v0 + 32768].double() * scale[v0:v0 + 32768, None].double()
        ref = xd @ w.T
        limit = 1e-5 * (xd.abs() @ w.abs().T) + 1e-6
        assert bool(((got[:, v0:v0 + 32768].double() - ref).abs()
                     <= limit).all()), v0
    for m in (1, 4):
        assert torch.equal(TM.lm_head(params, cfg, x[:m]), got[:m]), m


@pytest.mark.gpu
def test_tied_lm_head_past_2_31_elements(cuda_device):
    """command-r-plus-104b's tied head: the bf16 embedding of 256,000 x
    12,288 = 3.15e9 elements, more than 2^31, read LM_HEAD_BLOCK rows at a
    time.  Rows at both ends of the vocabulary (where an offset of the
    whole matrix passes 2^31) within 1e-5 (|x| @ |W|) + 1e-6 of the
    float64 product, the logits finite, a row's bits the same at M = 1."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as TM

    cfg = get_arch("command-r-plus-104b")
    v, d = cfg.vocab_size, cfg.d_model
    assert cfg.tie_embeddings and v * d > 2 ** 31
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    embed = torch.empty((v, d), dtype=torch.bfloat16, device=cuda_device)
    for v0 in range(0, v, 32768):   # drawn in blocks: no float32 copy
        embed[v0:v0 + 32768] = torch.randn(
            (min(32768, v - v0), d), generator=gen,
            device=cuda_device).mul_(0.02)
    params = {"embed": embed}
    x = torch.randn((4, d), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    got = TM.lm_head(params, cfg, x)
    torch.cuda.synchronize()
    assert got.shape == (4, v) and bool(torch.isfinite(got).all())
    xd = x.double()
    for v0, v1 in ((0, 4096), (2 ** 31 // d - 2048, 2 ** 31 // d + 2048),
                   (v - 4096, v)):
        w = embed[v0:v1].double()
        ref = xd @ w.T
        limit = 1e-5 * (xd.abs() @ w.abs().T) + 1e-6
        assert bool(((got[:, v0:v1].double() - ref).abs() <= limit).all()), \
            (v0, v1)
    assert torch.equal(TM.lm_head(params, cfg, x[:1]), got[:1])


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


# ------------------------------------------------ decode as a CUDA graph
def _graph_engines(arch, quant, overlap=(False, False), **engine_kw):
    """Two engines on one reduced model's weights (card, 4 slots);
    ``engine_kw`` goes to both (``kv_dtype``, ``kv_tier``, ...)."""
    from repro_torch.launch.serve import build_client
    from repro_torch.serving.core import EngineCore

    cfg, client = build_client(arch, reduced=True, quant=quant, max_seq=128,
                               device="cuda")
    params = client.router.cores[0].params
    return cfg, [EngineCore(cfg, params, max_batch=4, max_seq=128,
                            eos_id=-1, overlap=o, device="cuda", **engine_kw)
                 for o in overlap]


def _serve(engine, stochastic=False, n=6, max_new=6):
    from repro_torch.serving.core import Request
    from repro_torch.serving.scheduler import SamplingParams

    reqs = [Request(rid=i, prompt=[3 + i, 17, 99, 5] * (i + 1),
                    max_new_tokens=max_new,
                    sampling=SamplingParams(temperature=0.8, top_k=20,
                                            top_p=0.9, seed=7 + i)
                    if stochastic and i % 2 else None)
            for i in range(n)]
    for r in reqs:
        engine.add_request(r)
    engine.run()
    torch.cuda.synchronize()
    return [(r.out_tokens, r.finish_reason) for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-7b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("quant", ["w8a8", "w4a16"])
def test_decode_graph_matches_eager_bit_for_bit(cuda_device, arch, quant):
    """The replayed decode step runs the eager step's kernels in its order:
    the same logits, bit for bit, at each of three steps, and the same
    token streams over a whole trace."""
    import numpy as np

    from repro_torch.serving import graphs
    from repro_torch.serving.core import Request

    cfg, (a, b) = _graph_engines(arch, quant)
    for e in (a, b):
        for i in range(3):
            e.add_request(Request(rid=i, prompt=[5 + i, 11, 42, 9] * (i + 2),
                                  max_new_tokens=8))
        e._admit_continuous()
    active = np.array([True, True, True, False])
    for _ in range(3):
        logits = []
        for e, eager in ((a, True), (b, False)):
            e._ensure_pages()   # a slot crossing a page boundary gets one
            e.graph.stage(e.last_np, active, e.block)
            if eager:
                with graphs.disabled():
                    logits.append(e.graph.run("sync", e.cache).clone())
            else:
                logits.append(e.graph.run("sync", e.cache).clone())
            e.last_np[:] = logits[-1].argmax(-1).cpu().numpy()
        assert torch.equal(logits[0][:3], logits[1][:3])
        assert torch.equal(a.cache["lens"], b.cache["lens"])
    assert a.graph.replays == 0 and b.graph.replays == 3
    _, (c, d) = _graph_engines(arch, quant)
    with graphs.disabled():
        eager = _serve(c)
    assert _serve(d) == eager
    assert c.graph.replays == 0 and d.graph.replays == d.stats.decode_steps


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-7b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_overlap_matches_sync_on_card(cuda_device, arch, stochastic):
    _, (sync, olap) = _graph_engines(arch, "w8a8", overlap=(False, True))
    assert _serve(olap, stochastic) == _serve(sync, stochastic)
    assert sync.stats.decode_dispatches == 2 * sync.stats.decode_steps
    assert olap.stats.decode_dispatches == olap.stats.decode_steps
    assert olap.graph.replays == olap.stats.decode_steps
    assert ("fused" in olap.graph._graphs) == stochastic


@pytest.mark.gpu
def test_moved_cache_tensor_raises_before_replay(cuda_device):
    """A cache tensor rebound after capture (here the K pool) makes the
    next step raise instead of replaying over memory the cache no longer
    owns; nothing is recaptured."""
    _, (e, _unused) = _graph_engines("llama2-7b", "w8a8")
    _serve(e, max_new=3)
    replays = e.graph.replays
    e.cache["k"] = e.cache["k"].clone()
    from repro_torch.serving.core import Request

    e.add_request(Request(rid=99, prompt=[4, 5, 6, 7], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="moved since capture"):
        e.run()
    assert e.graph.replays == replays and set(e.graph._graphs) == {"sync"}


@pytest.mark.gpu
def test_launch_counters_count_replays(cuda_device):
    """After capture, n replays add n times the captured launches of each
    kernel, and nothing else."""
    _, (e, _unused) = _graph_engines("llama2-7b", "w8a8")
    _serve(e, n=4, max_new=3)    # captures the sync step
    delta = e.graph._deltas["sync"]
    assert delta["int8_gemv"] > 0 and delta["paged_decode_attention"] > 0
    from repro_torch.serving.core import Request

    for i in range(4):
        e.add_request(Request(rid=10 + i, prompt=[4 + i, 5, 6, 7],
                              max_new_tokens=5))
    e._admit_continuous()
    kernels.reset_launch_counts()
    steps, replays = e.stats.decode_steps, e.graph.replays
    for _ in range(3):
        e.step()
    torch.cuda.synchronize()
    n = e.graph.replays - replays
    assert n == e.stats.decode_steps - steps == 3
    counts = kernels.launch_counts()
    assert counts == {k: n * delta.get(k, 0) for k in counts}, counts


# ------------------------------------- chunked prefill and int8 KV pools
def _int8_pools(kp, vp):
    """bf16 pools quantized per row and head as the port's int8 cache holds
    them: (data, scale) pairs."""
    from repro_torch.models.attention import quantize_rows

    return quantize_rows(kp), quantize_rows(vp)


def _chunk_inputs(dev, seed, c, h, hkv, d, pps, page=16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = pps + 3
    q, kp, vp = (torch.randn(shape, generator=gen, device=dev
                             ).to(torch.bfloat16)
                 for shape in ((c, h, d), (n_pages, page, hkv, d),
                               (n_pages, page, hkv, d)))
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev)
    return q, kp, vp, (perm[:pps] + 1).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("h,hkv,d", [(32, 32, 128), (32, 32, 112),
                                     (15, 5, 64), (4, 2, 16),
                                     (32, 2, 128)])   # chatglm3-6b, group 16
@pytest.mark.parametrize("c,start", [(1, 0), (7, 5), (16, 300), (128, 0),
                                     (128, 300)])
def test_paged_chunk_attention_is_b3_bit_for_bit(cuda_device, c, start, h,
                                                 hkv, d, kv):
    """Over bf16 pools each valid query i of a chunk equals, bit for bit,
    B3's output for the query at position start + i in a one-shot run over
    the same keys laid out contiguously; over both kinds of pool the chunk
    is within two bf16 steps of its plain version, padding rows (a chunk of
    7 valid rows in a bucket of 16) come out 0, and a query gives the same
    bits in a chunk from ``start`` and in one chunk from 0."""
    from repro_torch.kernels.decode_attention.ops import paged_chunk_attention
    from repro_torch.kernels.decode_attention.ref import (
        paged_chunk_attention_ref)
    from repro_torch.models.attention import gather_paged_rows

    pps = 32   # 512 keys
    rows = max(c, 16) if c == 7 else c
    q, kp, vp, row = _chunk_inputs(cuda_device, c + start + d, rows, h, hkv,
                                   d, pps)
    n = start + c
    if kv == "int8":
        kp, vp = _int8_pools(kp, vp)
    else:
        q_all = torch.zeros((1, n, h, d), dtype=torch.bfloat16,
                            device=cuda_device)
        q_all[0, start:] = q[:c]
        k_all, v_all = (gather_paged_rows(x, row[None])[:, :n].contiguous()
                        for x in (kp, vp))
        b3 = flash_attention(q_all, k_all, v_all)[0, start:]
    got = paged_chunk_attention(q, kp, vp, row, start, c)
    if kv == "bf16":
        assert torch.equal(got[:c], b3)
    pos = start + torch.arange(rows, device=cuda_device)
    ref = paged_chunk_attention_ref(q[None], kp, vp, row[None], pos[None])[0]
    assert_bf16_close(got[:c], ref[:c])
    assert not bool(got[c:].float().any())
    q_from_0 = torch.zeros((n, h, d), dtype=torch.bfloat16,
                           device=cuda_device)
    q_from_0[start:] = q[:c]
    from_0 = paged_chunk_attention(q_from_0, kp, vp, row, 0, n)
    assert torch.equal(from_0[start:], got[:c])


@pytest.mark.gpu
@pytest.mark.parametrize("page", [3, 48])
def test_paged_chunk_attention_refuses_a_page_that_does_not_divide_64(
        cuda_device, page):
    from repro_torch.kernels.decode_attention.ops import paged_chunk_attention

    q, kp, vp, row = _chunk_inputs(cuda_device, page, 16, 4, 4, 64, 8,
                                   page=page)
    with pytest.raises(ValueError, match="does not divide"):
        paged_chunk_attention(q, kp, vp, row, 0, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,d", [(32, 32, 128), (32, 32, 112),
                                     (15, 5, 64)])
def test_int8_paged_decode_attention_on_card(cuda_device, h, hkv, d):
    """B1 over int8 (data, scale) pools: within two bf16 steps of the plain
    version (which dequantizes as the kernel does), length-0 lanes 0, and a
    slot's bits the same alone and in its batch."""
    lens = [0, 1, SPLIT, SPLIT + 1, 545, 1024]
    q, kp, vp, block = _paged_inputs(cuda_device, d + 7, len(lens), h, hkv,
                                     d, 64)
    kq, vq = _int8_pools(kp, vp)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = kernels.launch_counts()["paged_decode_attention_int8"]
    got = paged_decode_attention(q, kq, vq, block, lengths)
    assert kernels.launch_counts()["paged_decode_attention_int8"] == before + 1
    ref = paged_decode_attention_ref(q, kq, vq, block, lengths)
    assert_bf16_close(got[1:], ref[1:])
    assert not bool(got[0].float().any())
    alone = paged_decode_attention(q[4:5].contiguous(), kq, vq,
                                   block[4:5].contiguous(), lengths[4:5].clone())
    assert torch.equal(alone[0], got[4])


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_chunked_prefill_bit_identical_to_one_shot_on_card(cuda_device, kv):
    """llama2-7b at full width, 2 layers, W8A8: a 150-token prompt chunked
    with budgets {1, 7, 16, 128} leaves the slot's valid K/V rows, the
    first token's logits and 3 decode logits equal, bit for bit, to the
    one-chunk run."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.quant.convert import quantize_params
    from repro_torch.serving.kv_cache import chunk_spans, prefill_bucket

    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=2)
    params = quantize_params(M.init_params(cfg, seed=3, max_seq=256,
                                           device="cuda"), consume=True)
    prompt = torch.randint(0, cfg.vocab_size, (150,),
                           generator=torch.Generator().manual_seed(4)).tolist()

    def run(budget):
        cache = M.init_paged_cache(cfg, 2, 256, page_size=16, device="cuda",
                                   kv_dtype=kv)
        cache["block"] = torch.zeros((2, 16), dtype=torch.int32,
                                     device="cuda")
        cache["block"][0] = torch.arange(17, 1, -1, device="cuda")
        for start, n in chunk_spans(len(prompt), budget):
            toks = torch.zeros(min(prefill_bucket(n, floor=16), 256),
                               dtype=torch.int32)
            toks[:n] = torch.tensor(prompt[start:start + n])
            lg, cache = M.prefill_chunk_into_slot(
                params, cfg, toks.to("cuda"), start, n, cache, 0)
        pages = cache["block"][0].long()
        rows = {key: cache[key][:, pages].flatten(1, 2)[:, :len(prompt)]
                .clone() for key in blocks.paged_pool_keys(cache)}
        out = [lg.clone()]
        tok = torch.zeros(2, dtype=torch.int32, device="cuda")
        active = torch.tensor([True, False], device="cuda")
        for _ in range(3):
            tok[0] = torch.argmax(out[-1])
            step, cache = M.decode_step_paged(params, cfg, tok, cache,
                                              active)
            out.append(step[0].clone())
        torch.cuda.synchronize()
        return out, rows

    kernels.reset_launch_counts()
    one, one_rows = run(len(prompt))
    name = "paged_chunk_attention" + ("_int8" if kv == "int8" else "")
    assert kernels.launch_counts()[name] == cfg.n_layers
    for budget in (1, 7, 16, 128):
        got, rows = run(budget)
        for key in one_rows:
            assert torch.equal(rows[key], one_rows[key]), (budget, key)
        for step, (a, b) in enumerate(zip(one, got)):
            assert torch.equal(a, b), (budget, step)


@pytest.mark.gpu
def test_one_shot_prefill_equals_chunked_prefill_on_card(cuda_device):
    """llama2-7b at full width, 2 layers, W8A8, bf16 pools: a 150-token
    prompt through ``prefill_into_slots`` (B3) and through
    ``prefill_chunk_into_slot`` at budgets {1, 7, 16, 128} (the chunk
    kernel) leaves the same valid K/V rows, first-token logits and 3 decode
    logits, bit for bit."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.quant.convert import quantize_params
    from repro_torch.serving.kv_cache import chunk_spans, prefill_bucket

    cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=2)
    params = quantize_params(M.init_params(cfg, seed=3, max_seq=256,
                                           device="cuda"), consume=True)
    prompt = torch.randint(0, cfg.vocab_size, (150,),
                           generator=torch.Generator().manual_seed(4)).tolist()

    def run(budget):
        cache = M.init_paged_cache(cfg, 2, 256, page_size=16, device="cuda")
        cache["block"] = torch.zeros((2, 16), dtype=torch.int32,
                                     device="cuda")
        cache["block"][0] = torch.arange(17, 1, -1, device="cuda")
        if budget is None:
            bucket = prefill_bucket(len(prompt))
            toks = torch.tensor([prompt + [0] * (bucket - len(prompt))],
                                device="cuda")
            lg, cache = M.prefill_into_slots(
                params, cfg, toks, torch.tensor([len(prompt)], device="cuda"),
                cache, torch.tensor([0], device="cuda"))
            lg = lg[0]
        else:
            for start, n in chunk_spans(len(prompt), budget):
                toks = torch.zeros(min(prefill_bucket(n, floor=16), 256),
                                   dtype=torch.int32)
                toks[:n] = torch.tensor(prompt[start:start + n])
                lg, cache = M.prefill_chunk_into_slot(
                    params, cfg, toks.to("cuda"), start, n, cache, 0)
        pages = cache["block"][0].long()
        rows = {key: cache[key][:, pages].flatten(1, 2)[:, :len(prompt)]
                .clone() for key in blocks.paged_pool_keys(cache)}
        out = [lg.clone()]
        tok = torch.zeros(2, dtype=torch.int32, device="cuda")
        active = torch.tensor([True, False], device="cuda")
        for _ in range(3):
            tok[0] = torch.argmax(out[-1])
            step, cache = M.decode_step_paged(params, cfg, tok, cache,
                                              active)
            out.append(step[0].clone())
        torch.cuda.synchronize()
        return out, rows

    kernels.reset_launch_counts()
    one, one_rows = run(None)
    assert kernels.launch_counts()["flash_attention"] == cfg.n_layers
    for budget in (1, 7, 16, 128):
        got, rows = run(budget)
        for key in one_rows:
            assert torch.equal(rows[key], one_rows[key]), (budget, key)
        for step, (a, b) in enumerate(zip(one, got)):
            assert torch.equal(a, b), (budget, step)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_chunked_engine_on_card(cuda_device, kv):
    """The reduced llama2-7b W8A8 engine with a chunk budget of 5:
    synchronous and overlapped streams equal, the chunk kernel (and under
    int8 pools B1's int8 variant) launched, the decode graph replayed."""
    from repro_torch.launch.serve import build_client
    from repro_torch.serving.core import EngineCore
    from repro_torch.serving.scheduler import FCFSScheduler

    cfg, client = build_client("llama2-7b", reduced=True, max_seq=128,
                               device="cuda")
    params = client.router.cores[0].params
    engines = [EngineCore(cfg, params, max_batch=4, max_seq=128, eos_id=-1,
                          overlap=o, kv_dtype=kv, device="cuda",
                          scheduler=FCFSScheduler(chunk_tokens=5))
               for o in (False, True)]
    kernels.reset_launch_counts()
    sync = _serve(engines[0], stochastic=True)
    assert _serve(engines[1], stochastic=True) == sync
    counts = kernels.launch_counts()
    suffix = "_int8" if kv == "int8" else ""
    assert counts["paged_chunk_attention" + suffix] > 0, counts
    assert counts["paged_decode_attention" + suffix] > 0, counts
    assert engines[0].stats.prefill_chunks > 0
    assert engines[0].graph.replays == engines[0].stats.decode_steps


# ------------------------------ the flash KV tier, prefix cache, migration
def _relocate(engine, slot):
    """Move every page of ``slot`` to other pids through the host (the
    tier's gather and scatter) and remap its block-table row."""
    old = list(engine.slot_pages[slot])
    payloads = engine._gather_pages(old)
    new = engine.allocator.alloc(len(old))
    engine._scatter_pages(new, payloads)
    engine.allocator.free(old)
    engine.slot_pages[slot] = new
    engine.block[slot, :len(new)] = new
    return old, new


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_swap_in_keeps_captured_pools_and_replays_after_remap(cuda_device,
                                                              kv):
    """Pages moved to other pids between decode steps: the pools keep the
    storage the captured graph holds (no recapture, no raise), and each
    replayed step after the remap gives the eager step's logits on a twin
    engine moved the same way, bit for bit."""
    import numpy as np

    from repro_torch.serving import graphs
    from repro_torch.serving.core import Request

    _, (a, b) = _graph_engines("llama2-7b", "w8a8", kv_dtype=kv)
    for e in (a, b):
        for i in range(3):
            e.add_request(Request(rid=i, prompt=[5 + i, 11, 42, 9] * (i + 3),
                                  max_new_tokens=12))
        e._admit_continuous()
    active = np.array([True, True, True, False])

    def step(e, eager):
        e._ensure_pages()
        e.graph.stage(e.last_np, active, e.block)
        if eager:
            with graphs.disabled():
                out = e.graph.run("sync", e.cache).clone()
        else:
            out = e.graph.run("sync", e.cache).clone()
        e.last_np[:] = out.argmax(-1).cpu().numpy()
        e.slot_len[:3] = [n + 1 for n in e.slot_len[:3]]
        return out

    for k in range(5):
        if k in (1, 3):
            for e in (a, b):
                old, new = _relocate(e, k % 3)
                assert set(old).isdisjoint(new)
        got, want = step(b, False), step(a, True)
        assert torch.equal(got[:3], want[:3]), k
        ptrs = [t.data_ptr() for t in graphs._cache_tensors(b.cache)]
        assert ptrs == b.graph._pointers["sync"]
    assert b.graph.replays == 5 and a.graph.replays == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_spill_payload_equals_pool_pages_after_its_event(cuda_device, kv):
    """A spill's copy lands in pinned host memory behind an event; once the
    event has passed, each lazy payload holds the pool's page bits."""
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.serving.core import Request, _LazyPagePayload, \
        _SpillBatch

    _, (e, _unused) = _graph_engines("llama2-7b", "w8a8", kv_dtype=kv,
                                     kv_tier="flash")
    e.add_request(Request(rid=0, prompt=list(range(3, 60)),
                          max_new_tokens=4))
    e.step()
    pids = list(e.slot_pages[0])
    keys = blocks.paged_pool_keys(e.cache)
    want = [e.cache[k][:, pids].cpu() for k in keys]
    batch = _SpillBatch(M.swap_out_pages(e.cache, e._page_ids(pids)))
    assert batch.event is not None and batch.dev is not None
    assert all(h.is_pinned() for h in batch.host)
    for j in range(len(pids)):
        page = _LazyPagePayload(batch, j).materialize()
        assert batch.event is None and batch.dev is None
        for got, w in zip(page, want):
            assert torch.equal(got, w[:, j])


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True])
def test_tiered_engine_matches_resident_on_card(cuda_device, overlap):
    """A hot pool below the demand: the tiered engine spills, prefetches
    and emits the all-resident engine's streams, bit for bit."""
    from repro_torch.serving.core import EngineCore

    _, (resident, _unused) = _graph_engines("llama2-7b", "w8a8",
                                            overlap=(overlap, overlap))
    tiered = EngineCore(resident.cfg, resident.params, max_batch=4,
                        max_seq=128, eos_id=-1, overlap=overlap,
                        num_pages=9, kv_tier="flash", device="cuda")
    want = _serve(resident, n=6, max_new=24)
    assert _serve(tiered, n=6, max_new=24) == want
    s = tiered.stats
    assert s.kv_spill_pages > 0 and s.kv_prefetch_pages == s.kv_spill_pages
    assert s.preemptions > 0 and s.resumes > 0
    assert tiered.allocator.available == 8


@pytest.mark.gpu
def test_resume_hit_and_migration_on_card(cuda_device):
    """A resume hit replays the cold run's stream with no prefill; a slot
    snapshotted mid-decode, through its bytes, finishes on another engine
    with the unmigrated stream."""
    from repro_torch.serving.core import EngineCore, Request, SlotSnapshot

    _, (cold, _unused) = _graph_engines("llama2-7b", "w8a8")
    kw = dict(max_batch=4, max_seq=128, eos_id=-1, device="cuda")
    warm = EngineCore(cold.cfg, cold.params, prefix_cache=True, **kw)
    prompt = list(range(7, 47))
    ref = Request(rid=0, prompt=list(prompt), max_new_tokens=10)
    cold.add_request(ref)
    cold.run()
    for rid in (1, 2):
        r = Request(rid=rid, prompt=list(prompt), max_new_tokens=10)
        warm.add_request(r)
        warm.run()
        assert r.out_tokens == ref.out_tokens
    assert warm.stats.prefix_hits == 1 and warm.stats.prefills == 1
    a = EngineCore(cold.cfg, cold.params, **kw)
    b = EngineCore(cold.cfg, cold.params, **kw)
    a.add_request(Request(rid=5, prompt=list(prompt), max_new_tokens=10))
    for _ in range(4):
        a.step()
    snap = SlotSnapshot.from_bytes(a.snapshot_slot(5).to_bytes())
    b.inject_slot(snap)
    b.run()
    assert snap.req.out_tokens == ref.out_tokens


@pytest.mark.gpu
def test_partial_hit_page_paths_on_card(cuda_device):
    """C-open-2, repaired (ROADMAP section C): a partial hit's suffix runs
    the chunk kernel, which gives each query B3's one-shot bits.  Over
    pages the chunk path wrote, a partial hit's first-token logits equal a
    cold chunked run's; over pages B3 wrote, they equal the cold one-shot
    run's, bit for bit; and the partial-hit engine's greedy stream equals
    the one-shot cold engine's on every prompt."""
    from repro_torch.models import model as M
    from repro_torch.serving.core import EngineCore, Request
    from repro_torch.serving.kv_cache import prefill_bucket

    cfg, (cold, _unused) = _graph_engines("llama2-7b", "w8a8")
    params = cold.params
    warm = EngineCore(cfg, params, max_batch=4, max_seq=128, eos_id=-1,
                      prefix_cache=True, device="cuda")
    gen = torch.Generator().manual_seed(3)

    def first_logits(prompt, cached, chunk_prefix):
        cache = M.init_paged_cache(cfg, 1, 128, device="cuda")
        cache["block"] = torch.arange(8, 0, -1, dtype=torch.int32,
                                      device="cuda")[None]
        head = prompt[:cached] + [0]
        if chunk_prefix:
            toks = torch.zeros(prefill_bucket(len(head), floor=16),
                               dtype=torch.int32)
            toks[:len(head)] = torch.tensor(head)
            M.prefill_chunk_into_slot(params, cfg, toks.cuda(), 0,
                                      len(head), cache, 0)
        else:
            b = prefill_bucket(len(head))
            M.prefill_into_slots(
                params, cfg, torch.tensor([head + [0] * (b - len(head))],
                                          device="cuda"),
                torch.tensor([len(head)], device="cuda"), cache,
                torch.tensor([0], device="cuda"))
        n = len(prompt) - cached
        toks = torch.zeros(prefill_bucket(n, floor=16), dtype=torch.int32)
        toks[:n] = torch.tensor(prompt[cached:])
        logits, _ = M.prefill_chunk_into_slot(params, cfg, toks.cuda(),
                                              cached, n, cache, 0)
        return logits

    def chunked_cold(prompt):
        cache = M.init_paged_cache(cfg, 1, 128, device="cuda")
        cache["block"] = torch.arange(8, 0, -1, dtype=torch.int32,
                                      device="cuda")[None]
        toks = torch.zeros(prefill_bucket(len(prompt), floor=16),
                           dtype=torch.int32)
        toks[:len(prompt)] = torch.tensor(prompt)
        logits, _ = M.prefill_chunk_into_slot(params, cfg, toks.cuda(), 0,
                                              len(prompt), cache, 0)
        return logits

    for i in range(6):
        prompt = torch.randint(0, cfg.vocab_size, (40 + 5 * i,),
                               generator=gen).tolist()
        assert torch.equal(first_logits(prompt, 32, True),
                           chunked_cold(prompt))
        a = Request(rid=10 * i, prompt=list(prompt), max_new_tokens=4)
        cold.add_request(a)
        cold.run()
        warm.add_request(Request(rid=10 * i + 1, prompt=prompt[:32] + [0],
                                 max_new_tokens=1))
        warm.run()
        b = Request(rid=10 * i + 2, prompt=list(prompt), max_new_tokens=4)
        warm.add_request(b)
        warm.run()
        one_shot = M.prefill_into_slots(
            params, cfg, torch.tensor([prompt + [0] * (
                prefill_bucket(len(prompt)) - len(prompt))], device="cuda"),
            torch.tensor([len(prompt)], device="cuda"),
            {**M.init_paged_cache(cfg, 1, 128, device="cuda"),
             "block": torch.arange(8, 0, -1, dtype=torch.int32,
                                   device="cuda")[None]},
            torch.tensor([0], device="cuda"))[0][0]
        assert torch.equal(first_logits(prompt, 32, False), one_shot), i
        assert a.out_tokens == b.out_tokens, i
    assert warm.stats.prefix_hits == 6


# ------------------------------------------------- watchdog and fleet
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-7b"])
def test_watchdog_redispatch_replays_the_unwatched_bits(cuda_device, arch):
    """A watchdog flagging decode steps 1 and 3: the kept ``lens`` (and
    Mamba state) are copied back on the compute stream and the graph is
    replayed again; the streams equal the unwatched engine's bit for bit
    and every step, re-dispatched or not, is a replay."""
    from repro_torch.serving.core import EngineCore

    cfg, (plain, _) = _graph_engines(arch, "w8a8")
    fired = set()

    def watchdog(step, dt):
        if step in (1, 3) and step not in fired:
            fired.add(step)
            return True
        return False
    watched = EngineCore(cfg, plain.params, max_batch=4, max_seq=128,
                         eos_id=-1, device="cuda", watchdog=watchdog)
    assert _serve(watched, stochastic=True) == _serve(plain, stochastic=True)
    assert watched.stats.straggler_events == 2
    assert watched.graph.replays == watched.stats.decode_steps + 2


def _params_digest(params) -> str:
    """sha256 over every tensor of a param tree (dtype and bytes), in
    sorted-key order."""
    import hashlib

    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif isinstance(t, torch.Tensor):
            h.update(str(t.dtype).encode())
            h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
    walk(params)
    return h.hexdigest()


_DIGEST = """\
from repro_torch.serving.fleet.worker import build_params
from test_torch_gpu import _params_digest
print(_params_digest(build_params("llama2-7b", reduced=True, max_seq=128,
                                  quant="w8a8", device="cuda")[1]))
"""


@pytest.mark.gpu
def test_socket_workers_on_card_hold_the_parents_bits(cuda_device):
    """Two worker processes build llama2-7b (reduced, W8A8) from (arch,
    seed) on the card with the parent's bits; a socket fleet of two card
    workers, one SIGKILLed mid-decode, gives the parent's single engine's
    streams."""
    import os
    import signal
    import subprocess
    import sys

    from repro_torch.launch.serve import build_client
    from repro_torch.serving.fleet.router import FleetRouter

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here])}
    procs = [subprocess.Popen([sys.executable, "-c", _DIGEST], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for _ in range(2)]
    digests = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        digests.append(out.strip())
    _, client = build_client("llama2-7b", reduced=True, quant="w8a8",
                             max_seq=128, max_batch=4, device="cuda")
    parent = _params_digest(client.router.cores[0].params)
    assert digests[0] == digests[1] == parent
    ref = _serve(client.router.cores[0], stochastic=True)
    fl = FleetRouter.build_socket("llama2-7b", workers=2, spares=0,
                                  checkpoint_every=3, migrate=False,
                                  quant="w8a8", max_batch=4, max_seq=128,
                                  eos_id=-1, device="cuda",
                                  startup_timeout_s=300.0,
                                  reply_timeout_s=120.0)
    try:
        from repro_torch.serving.core import Request
        from repro_torch.serving.scheduler import SamplingParams

        reqs = [Request(rid=i, prompt=[3 + i, 17, 99, 5] * (i + 1),
                        max_new_tokens=6,
                        sampling=SamplingParams(temperature=0.8, top_k=20,
                                                top_p=0.9, seed=7 + i)
                        if i % 2 else None)
                for i in range(6)]
        for r in reqs:
            fl.submit(r)
        steps = 0
        while fl.has_work and steps < 500:
            fl.step()
            steps += 1
            if steps == 3:
                os.kill(fl.workers[0].transport.pid, signal.SIGKILL)
        assert [(r.out_tokens, r.finish_reason) for r in reqs] == ref
        assert fl.fleet.workers_lost == 1
    finally:
        fl.close()


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,h,hkv,d", [
    (4, 1500, 1500, 12, 12, 64),   # whisper-small's encoder
    (4, 128, 1500, 12, 12, 64),    # its cross-attention
    (4, 9, 16, 4, 2, 16),          # the reduced config, Skv 16
    (2, 200, 77, 8, 2, 128),       # ragged GQA cross-attention
    (2, 130, 300, 8, 8, 112),      # D 112
])
def test_bidirectional_flash_attention_on_card(cuda_device, b, sq, skv, h,
                                               hkv, d):
    """B3's bidirectional mode against its plain version; its launches
    count apart from the causal mode's."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + skv)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device
                           ).to(torch.bfloat16)
               for shape in ((b, sq, h, d), (b, skv, hkv, d),
                             (b, skv, hkv, d)))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    counts = kernels.launch_counts()
    assert counts["flash_attention_bidir"] == 1
    assert counts["flash_attention"] == 0
    assert_bf16_close(got, flash_attention_ref(q, k, v, causal=False))
    if sq != skv:   # the causal mode needs Skv == Sq
        with pytest.raises(ValueError):
            flash_attention(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,d,smax,lens", [
    (4, 12, 12, 64, 448, [448, 300, 129, 1]),   # whisper self-attention
    (4, 12, 12, 64, 1500, [1500] * 4),          # its cross-attention
    (3, 4, 2, 16, 32, [9, 9, 9]),               # a reduced wave
])
def test_contiguous_decode_attention_on_card(cuda_device, b, h, hkv, d, smax,
                                             lens):
    """B1 over a contiguous cache (one page a row) against the plain
    ``models.attention.decode_attention``; a row's bits are the same
    alone and in its batch."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device=cuda_device).manual_seed(smax)
    q = torch.randn((b, h, d), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    kc, vc = (torch.randn((b, smax, hkv, d), generator=gen,
                          device=cuda_device).to(torch.bfloat16)
              for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = decode_attention(q, kc, vc, lengths)
    assert_bf16_close(got, decode_attention_ref(q, kc, vc, lengths))
    alone = decode_attention(q[1:2].contiguous(), kc[1:2].contiguous(),
                             vc[1:2].contiguous(), lengths[1:2].contiguous())
    assert torch.equal(alone[0], got[1])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-small", "mamba2-130m",
                                  "llama2-7b", "zamba2-7b",
                                  "qwen2-moe-a2.7b"])
def test_wave_engine_on_card(cuda_device, arch):
    """The reduced model's wave engine, W8A8 on the card: a replayed decode
    step gives the eager step's streams, overlapped gives the synchronous
    streams (greedy and sampled rows), every decode step is one replay,
    and whisper-small's path launches B3's bidirectional mode."""
    from repro_torch.launch.serve import build_client
    from repro_torch.serving import graphs
    from repro_torch.serving.client import ServingClient
    from repro_torch.serving.scheduler import SamplingParams

    cfg, client = build_client(arch, reduced=True, max_seq=64, mode="wave",
                               device="cuda")
    params = client.router.cores[0].params

    def serve(cl, eager=False, sampled=False):
        hs = [cl.submit([3 + i, 17, 99, 5] * (1 + i % 3), max_new_tokens=7,
                        sampling=(SamplingParams(temperature=0.8, top_k=20,
                                                 seed=50 + i)
                                  if sampled and i % 2 else None))
              for i in range(6)]
        if eager:
            with graphs.disabled():
                cl.run()
        else:
            cl.run()
        torch.cuda.synchronize()
        assert all(h.finish_reason == "length" for h in hs)
        return [h.request.out_tokens for h in hs]

    kernels.reset_launch_counts()
    want = serve(client)
    counts = kernels.launch_counts()
    core = client.router.cores[0]
    assert core.mode == "wave" and core.graph.replays == \
        core.stats.decode_steps
    if arch == "whisper-small":
        assert counts["flash_attention_bidir"] > 0
    assert counts["int8_gemv"] > 0 and counts["int8_gemm_tc"] > 0
    assert serve(client, eager=True) == want
    over = ServingClient(cfg, params, max_batch=4, max_seq=64, eos_id=-1,
                         mode="wave", overlap=True, device="cuda")
    assert serve(over) == want
    assert serve(over, sampled=True) == serve(client, sampled=True)


# ------------------------------------------------ the grouped GEMM (moe)
def _grouped_inputs(dev, sizes, k, n, seed):
    """bf16 x [sum(sizes) + extra, K], W [E, K, N] (normal / sqrt(K)) and
    int32 group sizes on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = int(sum(sizes))
    x = torch.randn((r, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((len(sizes), k, n), generator=gen, device=dev)
         * k ** -0.5).to(torch.bfloat16)
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=dev)


def assert_grouped_close(got, ref, x, w, sizes):
    """Within 2 bf16 steps of |ref| + 1e-5 (|x| @ |W_e(r)|)."""
    e_of = torch.repeat_interleave(
        torch.arange(len(sizes), device=x.device), sizes.long())
    n = len(e_of)
    mag = torch.stack([x[r].float().abs() @ w[e_of[r]].float().abs()
                       for r in range(n)])
    step = torch.exp2(torch.floor(torch.log2(
        ref[:n].float().abs().clamp_min(2.0 ** -126))) - 7)
    err = (got[:n].float() - ref[:n].float()).abs()
    limit = BF16_STEPS * step + 1e-5 * mag
    assert bool((err <= limit).all()), float((err - limit).max())


GROUPED_CASES = {
    "decode, 16 rows over 16 experts": ([1] * 16 + [0] * 48, 2048, 1408),
    "decode, 16 rows on one expert": ([0] * 5 + [16] + [0] * 58, 1408, 2048),
    "reduced, empty groups": ([3, 0, 0, 5, 1, 0, 7, 2] + [0] * 8, 64, 32),
    "skew, 300 rows on one expert": ([0] * 63 + [300], 2048, 1408),
    "ragged, 130 rows": ([0, 61, 1, 0, 64, 65, 0, 0] + [0] * 8, 256, 72),
    "tile edges, an empty expert between two full ones":
        ([63, 64, 65, 127, 128, 0, 128, 129] + [0] * 56, 2048, 1408),
    "tile edges, down shape, R not a multiple of the row tile":
        ([0, 129, 0, 63, 200] + [0] * 59, 1408, 2048),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GROUPED_CASES))
def test_grouped_gemm_on_card(cuda_device, case):
    """The kernel against its plain version (one launch, counted), rows
    past the groups' sum written 0."""
    from repro_torch.kernels.grouped_gemm import ops
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

    sizes, k, n = GROUPED_CASES[case]
    x, w, gs = _grouped_inputs(cuda_device, sizes, k, n, len(case))
    x = torch.cat([x, torch.ones((3, k), dtype=x.dtype, device=x.device)])
    before = ops.LAUNCHES["grouped_gemm"]
    got = ops.grouped_gemm(x, w, gs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["grouped_gemm"] == before + 1
    ref = grouped_gemm_ref(x, w, gs)
    assert_grouped_close(got, ref, x, w, gs)
    assert not bool(got[int(gs.sum()):].any())


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)],
                         ids=["up", "down"])
def test_grouped_gemm_row_bits_do_not_depend_on_the_group_on_card(
        cuda_device, k, n):
    """Expert 7's row v at qwen2-moe-a2.7b's up and down shapes: alone and
    inside groups of 2, 7, 16, the tile edges (63, 64, 65, 127, 128, 129),
    136 and 8,192 rows, first, in the middle and last, other experts
    loaded before and after: the same bits."""
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm

    e = 64
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = (torch.randn((e, k, n), generator=gen, device=cuda_device)
         * k ** -0.5).to(torch.bfloat16)
    v = torch.randn((k,), generator=gen, device=cuda_device).to(
        torch.bfloat16)

    def row_of(size, place):
        sizes = torch.zeros(e, dtype=torch.int32)
        sizes[2], sizes[7], sizes[40] = 37, size, 5
        x = torch.randn((int(sizes.sum()), k), generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        at = 37 + {"first": 0, "middle": size // 2, "last": size - 1}[place]
        x[at] = v
        return grouped_gemm(x, w, sizes.to(cuda_device))[at]

    alone = row_of(1, "first")
    for size in (2, 7, 16, 63, 64, 65, 127, 128, 129, 136, 8192):
        for place in ("first", "middle", "last"):
            assert torch.equal(row_of(size, place), alone), (size, place)


@pytest.mark.gpu
def test_grouped_gemm_refuses_what_it_does_not_take(cuda_device):
    """float32 operands raise on the card (no fallback to the plain
    version), as do int64 group sizes and a K that is not a multiple of
    8."""
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm

    x, w, gs = _grouped_inputs(cuda_device, [2, 3], 64, 32, 1)
    with pytest.raises(TypeError):
        grouped_gemm(x.float(), w.float(), gs)
    with pytest.raises(TypeError):
        grouped_gemm(x, w, gs.long())
    with pytest.raises(ValueError):
        grouped_gemm(x[:, :60].contiguous(), w[:, :60].contiguous(), gs)


@pytest.mark.gpu
def test_moe_decode_graph_holds_the_grouped_gemm(cuda_device):
    """qwen2-moe-a2.7b.reduced() W8A8: the captured decode step holds
    three grouped GEMM launches a layer (the group sizes read on the
    device), and every decode step is one replay."""
    _, (e, _unused) = _graph_engines("qwen2-moe-a2.7b", "w8a8")
    _serve(e, n=5, max_new=5)
    assert e.graph._deltas["sync"]["grouped_gemm"] == 3 * e.cfg.n_layers
    assert e.graph.replays == e.stats.decode_steps > 0


# ------------------------------------------- the MLA decode kernel (mla_moe)
MLA_RTOL = 1e-5


def _mla_inputs(dev, lens, h, r, dr, kv, page=16, pps=64, seed=0):
    """float32 queries (scores to ~+-10), bf16 or int8 pools of seeded
    rows, a shuffled block table, int32 lengths, on the card."""
    from repro_torch.models.attention import quantize_rows

    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lens)
    n = b * pps + 1
    ckv = torch.randn((n, page, r), generator=gen, device=dev)
    kr = torch.randn((n, page, dr), generator=gen, device=dev)
    pools = ((quantize_rows(ckv), quantize_rows(kr)) if kv == "int8"
             else (ckv.to(torch.bfloat16), kr.to(torch.bfloat16)))
    perm = torch.randperm(n - 1, generator=torch.Generator().manual_seed(
        seed))[:b * pps] + 1
    block = perm.reshape(b, pps).to(torch.int32).to(dev)
    q_c = torch.randn((b, h, r), generator=gen, device=dev) * (0.6 / r ** .5)
    q_r = torch.randn((b, h, dr), generator=gen, device=dev) * (0.6 / dr ** .5)
    return (q_c, q_r, *pools, block,
            torch.tensor(lens, dtype=torch.int32, device=dev))


MLA_CASES = {
    "deepseek-v2-lite-16b, 1024/545/17/0": ([1024, 545, 17, 0], 16, 512, 64),
    "deepseek-v2-lite-16b, split edges": ([1, 63, 64, 65], 16, 512, 64),
    "reduced, split edges": ([1, 63, 64, 65, 0], 4, 32, 8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_mla_decode_attention_on_card(cuda_device, case, kv):
    """The kernel against its plain version (JAX's formula) within
    MLA_RTOL of max|ckv|, one launch counted; a length-0 lane comes out
    0; a slot's bits alone, in its batch and under a wider table."""
    from repro_torch.kernels.mla_decode_attention.ops import (
        mla_decode_attention)
    from repro_torch.kernels.mla_decode_attention.ref import (
        mla_decode_attention_ref)
    from repro_torch.models.attention import gather_paged_rows

    lens, h, r, dr = MLA_CASES[case]
    q_c, q_r, ckv, kr, block, lengths = _mla_inputs(cuda_device, lens, h, r,
                                                    dr, kv)
    scale = 192 ** -0.5
    kernels.reset_launch_counts()
    got = mla_decode_attention(q_c, q_r, ckv, kr, block, lengths, scale)
    torch.cuda.synchronize()
    name = "mla_decode_attention" + ("_int8" if kv == "int8" else "")
    assert kernels.launch_counts()[name] == 1
    ref = mla_decode_attention_ref(q_c, q_r, ckv, kr, block, lengths, scale)
    live = lengths > 0
    mag = gather_paged_rows(ckv, block).float().abs().max()
    err = (got - ref).abs()[live]
    assert bool((err <= MLA_RTOL * mag).all()), float(err.max())
    assert not bool(got[~live].any())
    wide = torch.cat([block, block[:, :8]], 1).contiguous()
    assert torch.equal(mla_decode_attention(q_c, q_r, ckv, kr, wide, lengths,
                                            scale), got)
    for i in range(len(lens)):
        alone = mla_decode_attention(
            q_c[i:i + 1].contiguous(), q_r[i:i + 1].contiguous(), ckv, kr,
            block[i:i + 1].contiguous(), lengths[i:i + 1].contiguous(),
            scale)
        assert torch.equal(alone[0], got[i]), i


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_decode_attention_length_past_the_table(cuda_device, kv):
    """A length past the block table's capacity (1,024 keys) reads the
    table's keys only, as the plain version's mask does: within MLA_RTOL
    of it, and the bits of the same slot at the capacity."""
    from repro_torch.kernels.mla_decode_attention.ops import (
        mla_decode_attention)
    from repro_torch.kernels.mla_decode_attention.ref import (
        mla_decode_attention_ref)
    from repro_torch.models.attention import gather_paged_rows

    q_c, q_r, ckv, kr, block, lengths = _mla_inputs(
        cuda_device, [1090, 1025, 17], 16, 512, 64, kv, seed=3)
    scale = 192 ** -0.5
    got = mla_decode_attention(q_c, q_r, ckv, kr, block, lengths, scale)
    ref = mla_decode_attention_ref(q_c, q_r, ckv, kr, block, lengths, scale)
    mag = gather_paged_rows(ckv, block).float().abs().max()
    assert bool(((got - ref).abs() <= MLA_RTOL * mag).all())
    at_cap = mla_decode_attention(q_c, q_r, ckv, kr, block,
                                  lengths.clamp(max=1024), scale)
    assert torch.equal(got, at_cap)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_decode_attention_tickets_reset_between_launches(cuda_device,
                                                             kv):
    """Ten launches in a row on one stream share a ticket buffer and give
    the first launch's bits: the CTA that merges a slot sets its ticket
    back to 0, and every ticket buffer is zero after them."""
    from repro_torch.kernels.mla_decode_attention import ops

    q_c, q_r, ckv, kr, block, lengths = _mla_inputs(
        cuda_device, [1024, 545, 17, 0, 200], 16, 512, 64, kv, seed=4)
    scale = 192 ** -0.5
    first = ops.mla_decode_attention(q_c, q_r, ckv, kr, block, lengths,
                                     scale)
    for _ in range(10):
        again = ops.mla_decode_attention(q_c, q_r, ckv, kr, block, lengths,
                                         scale)
        assert torch.equal(again, first)
    torch.cuda.synchronize()
    assert all(not bool(t.any()) for t in ops._TICKETS.values())


@pytest.mark.gpu
def test_mla_decode_attention_graph_replays_hold_the_bits(cuda_device):
    """The kernel captured into a CUDA graph (after one eager launch, which
    allocates the tickets outside capture) and replayed three times gives
    the eager bits each time; lengths changed in place between replays
    are read at the replay; every ticket buffer is zero after them."""
    from repro_torch.kernels.mla_decode_attention import ops
    from repro_torch.kernels.mla_decode_attention.ops import (
        mla_decode_attention)

    q_c, q_r, ckv, kr, block, lengths = _mla_inputs(
        cuda_device, [1024, 545, 17, 0], 16, 512, 64, "bf16", seed=5)
    scale = 192 ** -0.5
    eager = mla_decode_attention(q_c, q_r, ckv, kr, block, lengths, scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mla_decode_attention(q_c, q_r, ckv, kr, block, lengths, scale)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    lengths.copy_(torch.tensor([65, 64, 1000, 3], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, mla_decode_attention(q_c, q_r, ckv, kr, block,
                                                 lengths, scale))
    torch.cuda.synchronize()
    assert all(not bool(t.any()) for t in ops._TICKETS.values())


@pytest.mark.gpu
def test_mla_decode_attention_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.mla_decode_attention.ops import (
        mla_decode_attention)

    q_c, q_r, ckv, kr, block, lengths = _mla_inputs(
        cuda_device, [5, 9], 4, 32, 8, "bf16")
    with pytest.raises(ValueError):      # no (R, Dr) instance
        mla_decode_attention(q_c[..., :16].contiguous(), q_r, ckv[..., :16],
                             kr, block, lengths, 1.0)
    with pytest.raises(TypeError):       # a float32 pool
        mla_decode_attention(q_c, q_r, ckv.float(), kr, block, lengths, 1.0)
    with pytest.raises(TypeError):       # int64 lengths
        mla_decode_attention(q_c, q_r, ckv, kr, block, lengths.long(), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_engine_on_card(cuda_device, kv):
    """deepseek-v2-lite-16b.reduced() W8A8 on the card: the decode graph
    holds one MLA kernel launch a layer and no B1 launch, the replayed
    step gives the eager step's streams and the overlapped loop the
    synchronous one's, prefill runs B3 at the qk head of 24."""
    from repro_torch.serving import graphs

    cfg, (e, o) = _graph_engines("deepseek-v2-lite-16b", "w8a8",
                                 overlap=(False, True), kv_dtype=kv)
    kernels.reset_launch_counts()
    want = _serve(e, stochastic=True)
    counts = kernels.launch_counts()
    name = "mla_decode_attention" + ("_int8" if kv == "int8" else "")
    assert e.graph._deltas["sync"][name] == cfg.n_layers
    assert e.graph.replays == e.stats.decode_steps > 0
    assert counts["flash_attention"] > 0 and counts[name] > 0
    assert counts["paged_decode_attention"] == 0
    assert counts["paged_decode_attention_int8"] == 0
    with graphs.disabled():
        assert _serve(e, stochastic=True) == want
    assert _serve(o, stochastic=True) == want
