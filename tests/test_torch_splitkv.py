"""CPU rehearsals of the decode kernels that only a card runs.

* B1 (``csrc/decode_attention.cu``): split-KV with a fixed-order combine.
  Its plain rehearsal ``ref.paged_decode_attention_splitkv`` (splits of
  ``ref.SPLIT`` keys from key 0, a float32 partial per split, merged in
  split-index order) is held against the JAX package's
  ``paged_decode_attention`` on numpy-seeded bf16 inputs carried across by
  ``bridge.py``, at the split-edge lengths, MHA and GQA.  Gate: each
  output within two bf16 steps of the JAX output plus 1e-5, the gate the
  card's check uses (chip_smoke.py, tests/test_torch_gpu.py).  A slot's
  bits must not depend on the batch around it or on the block table's
  width.  Query groups above 8 (the kernel's two passes of up to 8 heads)
  are held at 12 and 16; a head's bits must not depend on how many heads
  share its kv head, and the wrappers' group limits (B1 up to 16, the
  chunk kernel any) are pinned.
* B2's decode GeMV (``int8_gemv_mma_kernel``): its operand layout (each
  lane's 16 contiguous bytes of two weight rows and one activation row fed
  to ``mma.sync m16n8k32`` with the k order permuted alike in A and B)
  emulated lane by lane from the PTX fragment tables, bit-exact against
  the plain product; and ``gemm_variant``'s rule for it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.decode_attention.ops import MAX_GROUP, _check_pools
from repro_torch.kernels.decode_attention.ref import (
    SPLIT, paged_decode_attention_ref, paged_decode_attention_splitkv)
from repro_torch.kernels.int8_pagegemv.ops import GEMV_MAX_M, gemm_variant
from repro_torch.kernels.int8_pagegemv.ref import int8_gemm_ref

BF16_STEPS = 2
F32_NOISE = 1e-5
PAGE = 16


def _gate_ratio(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst |err| / (two bf16 steps of |ref| + 1e-5)."""
    got, ref = got.float(), ref.float()
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
                      - 7)
    return float(((got - ref).abs() / (BF16_STEPS * step + F32_NOISE)).max())


def _paged(seed, lens, h, hkv, d, pps, n_pages=None):
    """numpy inputs: bf16-representable q and pools, a shuffled block
    table of ``pps`` pages per slot."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    n_pages = n_pages or b * pps + 1
    as_bf16 = lambda a: np.asarray(  # noqa: E731
        jnp.asarray(a, dtype=jnp.bfloat16))
    arrs = {"q": as_bf16(rng.randn(b, h, d)),
            "k": as_bf16(rng.randn(n_pages, PAGE, hkv, d)),
            "v": as_bf16(rng.randn(n_pages, PAGE, hkv, d)),
            "block": (rng.permutation(n_pages - 1)[:b * pps] + 1).reshape(
                b, pps).astype(np.int32),
            "lens": np.asarray(lens, np.int32)}
    return arrs, params_from_numpy(arrs)


@pytest.mark.parametrize("h,hkv,d", [
    (4, 4, 64),    # MHA
    (6, 2, 16),    # GQA 3:1 (smollm-shaped)
    (2, 2, 112),   # zamba2-7b's head dim
    (8, 1, 32),    # GQA 8:1, the widest group of one pass
    (16, 1, 32),   # a group of 16: two passes of 8
    (32, 2, 128),  # chatglm3-6b's heads (group 16)
    (12, 1, 64),   # command-r-plus-104b's group of 12: passes of 8 and 4
])
def test_b1_splitkv_rehearsal_vs_jax(h, hkv, d):
    pps = 3 * SPLIT // PAGE   # capacity: three splits
    lens = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 5, 3 * SPLIT]
    a, t = _paged(h * d, lens, h, hkv, d, pps)
    ref = torch.from_numpy(np.asarray(jattn.paged_decode_attention(
        *(jnp.asarray(a[k]) for k in ("q", "k", "v", "block", "lens")))
        .astype(jnp.float32)))
    got = paged_decode_attention_splitkv(t["q"], t["k"], t["v"], t["block"],
                                         t["lens"])
    assert got.dtype == torch.bfloat16 and got.shape == (len(lens), h, d)
    ratio = _gate_ratio(got[1:], ref[1:])
    print(f"B1 split-KV rehearsal H={h} Hkv={hkv} D={d}: worst |err|/limit "
          f"{ratio:.3f} against the JAX paged_decode_attention")
    assert ratio <= 1.0
    assert bool(torch.isfinite(got).all())
    assert not bool(got[0].any())   # a length-0 slot comes out 0


@pytest.mark.parametrize("split", [SPLIT, None], ids=["splitkv", "plain"])
@pytest.mark.parametrize("h,halves", [(16, (8, 8)), (12, (8, 4)),
                                      (12, (6, 6))])
def test_b1_head_bits_do_not_depend_on_the_group(h, halves, split):
    """A group of H heads over one kv head, and the same queries cut into
    two calls of smaller groups over the same pools: each head's output
    bits are the same, for the split schedule and for the plain version
    (the card's oracle)."""
    d, pps = 32, 3 * SPLIT // PAGE
    lens = [1, SPLIT, 2 * SPLIT + 37, 0]
    _, t = _paged(h + sum(halves), lens, h, 1, d, pps)

    def run(q):
        if split is None:
            return paged_decode_attention_ref(q, t["k"], t["v"], t["block"],
                                              t["lens"])
        return paged_decode_attention_splitkv(q, t["k"], t["v"], t["block"],
                                              t["lens"])

    whole = run(t["q"])
    a = halves[0]
    parts = torch.cat([run(t["q"][:, :a].contiguous()),
                       run(t["q"][:, a:].contiguous())], dim=1)
    assert torch.equal(whole[:3], parts[:3])


def test_group_limits_of_the_wrappers():
    """``_check_pools``: B1 (``paged_decode_attention``) takes a group of up
    to MAX_GROUP = 16 heads and refuses 17 with a message naming B1; the
    chunk kernel's wrapper takes any group that H % Hkv == 0 allows; a
    ragged group is refused by both."""
    assert MAX_GROUP == 16
    q16 = torch.zeros((2, 32, 128), dtype=torch.bfloat16)
    q17 = torch.zeros((2, 17, 128), dtype=torch.bfloat16)
    kp2 = torch.zeros((3, PAGE, 2, 128), dtype=torch.bfloat16)
    kp1 = torch.zeros((3, PAGE, 1, 128), dtype=torch.bfloat16)
    int8 = (torch.zeros((3, PAGE, 2, 128), dtype=torch.int8),
            torch.ones((3, PAGE, 2), dtype=torch.float32))
    for name, limit in (("paged_decode_attention", MAX_GROUP),
                        ("paged_chunk_attention", None)):
        k, _, _, _, is8 = _check_pools(q16, kp2, kp2, name, limit)
        assert k is kp2 and not is8
        assert _check_pools(q16, int8, int8, name, limit)[4]
    with pytest.raises(ValueError, match="B1 takes at most 16"):
        _check_pools(q17, kp1, kp1, "paged_decode_attention", MAX_GROUP)
    assert _check_pools(q17, kp1, kp1, "paged_chunk_attention")[0] is kp1
    for limit in (MAX_GROUP, None):
        with pytest.raises(ValueError, match="unsupported head layout"):
            _check_pools(q17, kp2, kp2, "either", limit)


@pytest.mark.parametrize("length", [1, SPLIT, 2 * SPLIT + 37])
def test_b1_splitkv_slot_bits_do_not_depend_on_the_batch(length):
    """Slot 0's output alone, inside a batch of 4 with other lengths, and
    under a block table twice as wide (its pages elsewhere in a larger
    pool): the same bits."""
    h, hkv, d, pps = 6, 2, 16, 3 * SPLIT // PAGE
    a, t = _paged(length, [length], h, hkv, d, pps)
    alone = paged_decode_attention_splitkv(t["q"], t["k"], t["v"],
                                           t["block"], t["lens"])
    _, other = _paged(length + 1, [0, 5, 3 * SPLIT, 200], h, hkv, d, pps)
    q = torch.cat([t["q"], other["q"][1:]])
    kp = torch.cat([t["k"], other["k"]])
    vp = torch.cat([t["v"], other["v"]])
    block = torch.cat([t["block"], other["block"][1:] + t["k"].shape[0]])
    lens = torch.cat([t["lens"], other["lens"][1:]])
    batched = paged_decode_attention_splitkv(q, kp, vp, block, lens)
    assert torch.equal(batched[0], alone[0])
    # a wider block table: slot 0's pages moved to the end of a larger pool
    n = t["k"].shape[0]
    wide = torch.zeros((1, 2 * pps), dtype=torch.int32)
    wide[0, :pps] = t["block"][0] + n
    kp2, vp2 = torch.cat([t["k"], t["k"]]), torch.cat([t["v"], t["v"]])
    moved = paged_decode_attention_splitkv(t["q"], kp2, vp2, wide, t["lens"])
    assert torch.equal(moved[0], alone[0])


def test_b1_splitkv_rehearsal_vs_plain_version_float32():
    """In float32 the split schedule and the one-shot softmax agree to
    float32 rounding: rtol = atol = 2e-5 (the JAX package's own kernel-test
    tolerance)."""
    rng = np.random.RandomState(7)
    b, h, hkv, d, pps = 4, 4, 2, 32, 40
    q = torch.from_numpy(rng.randn(b, h, d).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.randn(b * pps + 1, PAGE, hkv, d)
                               .astype(np.float32)) for _ in range(2))
    block = torch.from_numpy((rng.permutation(b * pps)[:b * pps] + 1)
                             .reshape(b, pps).astype(np.int32))
    lens = torch.tensor([640, 129, 128, 3], dtype=torch.int32)
    got = paged_decode_attention_splitkv(q, kp, vp, block, lens)
    ref = paged_decode_attention_ref(q, kp, vp, block, lens)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


def _mma_m16n8k32(a_regs, b_regs):
    """D = A . B of one ``mma.sync.m16n8k32.row.col.s32.s8.s8.s32`` from the
    32 lanes' fragments, placed by the PTX ISA's fragment tables: A reg r of
    lane (g, q) holds row g + 8 (r % 2), k 4q + 16 (r // 2) + 0..3; B reg r
    holds column g, k 4q + 16 r + 0..3; D reg i holds row g + 8 (i // 2),
    column 2q + i % 2.  Returns the 32 lanes' four int32 outputs."""
    a = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for r in range(4):
            a[g + 8 * (r % 2), 4 * q + 16 * (r // 2):][:4] = a_regs[lane][r]
        for r in range(2):
            bm[4 * q + 16 * r:][:4, g] = b_regs[lane][r]
    d = a @ bm
    return [[d[g + 8 * (i // 2), 2 * q + i % 2] for i in range(4)]
            for g, q in (divmod(lane, 4) for lane in range(32))]


def _gemv_mma_rehearsal(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The kernel's schedule for one CTA's 16 rows at a time: 64-byte slabs,
    lane (g, q) loading bytes 16q..16q+15 of the slab from weight rows g and
    g + 8 and activation row g (zeros past K, N or M), two mmas a slab on
    words (0, 1) and (2, 3) of each load."""
    m, k = x.shape
    n = w.shape[0]
    out = np.zeros((m, n), np.int64)
    for n0 in range(0, n, 16):
        acc = [[0] * 4 for _ in range(32)]
        for s in range(-(-k // 64)):
            a_lo, a_hi, b_lo, b_hi = [], [], [], []
            for lane in range(32):
                g, q = divmod(lane, 4)
                c0 = 64 * s + 16 * q

                def chunk(mat, row):
                    buf = np.zeros(16, np.int64)
                    if row < mat.shape[0] and c0 < k:
                        buf[:] = mat[row, c0:c0 + 16]
                    return buf.reshape(4, 4)   # four 4-byte words

                wa, wb, xv = chunk(w, n0 + g), chunk(w, n0 + g + 8), \
                    chunk(x, g)
                a_lo.append([wa[0], wb[0], wa[1], wb[1]])
                a_hi.append([wa[2], wb[2], wa[3], wb[3]])
                b_lo.append([xv[0], xv[1]])
                b_hi.append([xv[2], xv[3]])
            for a_regs, b_regs in ((a_lo, b_lo), (a_hi, b_hi)):
                d = _mma_m16n8k32(a_regs, b_regs)
                acc = [[acc[ln][i] + d[ln][i] for i in range(4)]
                       for ln in range(32)]
        for lane in range(32):
            g, q = divmod(lane, 4)
            for i in range(4):
                row, col = n0 + g + 8 * (i // 2), 2 * q + i % 2
                if row < n and col < m:
                    out[col, row] = acc[lane][i]
    return out


@pytest.mark.parametrize("m,k,n", [
    (4, 256, 32),   # whole slabs
    (8, 208, 20),   # K = 3 slabs + one 16-byte chunk; ragged N; M = 8
    (1, 96, 16),    # M = 1
])
def test_b2_gemv_mma_operand_layout_is_exact(m, k, n):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-127, 128, size=(m, k)).astype(np.int8)
    w = rng.randint(-127, 128, size=(n, k)).astype(np.int8)
    ref = int8_gemm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(_gemv_mma_rehearsal(x, w), ref)


@pytest.mark.parametrize("m", range(1, GEMV_MAX_M + 1))
@pytest.mark.parametrize("k,x_ptr,w_ptr,variant", [
    (4096, 0, 256, "int8_gemv"),       # llama2-7b q/k/v/o, gate/up
    (11008, 512, 0, "int8_gemv"),      # llama2-7b down_proj
    (3584, 16, 32, "int8_gemv"),       # zamba2-7b in_proj
    (7168, 0, 0, "int8_gemv"),         # zamba2-7b out_proj
    (960, 0, 16, "int8_gemv"),         # smollm-360m
    (4104, 0, 0, "int8_gemv_dp4a"),    # K % 16 == 8
    (1000, 0, 0, "int8_gemv_dp4a"),    # K % 16 == 8
    (4096, 8, 0, "int8_gemv_dp4a"),    # x base off the 16-byte grid
    (4096, 0, 1, "int8_gemv_dp4a"),    # w base off the 16-byte grid
])
def test_b2_gemv_dispatch_rule(m, k, x_ptr, w_ptr, variant):
    assert gemm_variant(m, k, x_ptr, w_ptr) == variant
    # one row more leaves the GeMVs
    assert gemm_variant(m + GEMV_MAX_M, k, x_ptr, w_ptr) in (
        "int8_gemm_tc", "int8_gemm")
