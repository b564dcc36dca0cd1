"""CPU rehearsal of B4's tensor-core kernels (``csrc/w4a16_gemv.cu``:
``w4a16_gemv_mma_kernel`` for M <= 8, ``w4a16_gemm_mma_kernel`` above),
which only a card runs.

* The nibble -> bf16 conversion (``dequant8``: prmt, lop3 with 0x4300, one
  bf16x2 subtraction of 136), emulated bit for bit on all 256 byte values.
* The float32 -> three bf16 terms split (``split3``), which must give x
  back exactly.
* The kernels' summation orders written out: each group's partial sums
  exact bf16 x int4 products in float32, one rounding per mma (the model
  of an mma used here), and is folded into a float32 total with
  fmaf(partial, scale, total); the GeMV's groups are split across 16 warps
  whose totals are summed in warp order; the GEMM's partial spans two K
  tiles of 64 columns, 16 columns an mma step (mma.sync m16n8k16 and wgmma
  m64n128k16 alike).  Held against the JAX package's Pallas kernel in
  interpret mode under chip_smoke.py's W4_TOL, 1e-5 (|x| @ |W|^T) + 1e-6,
  at K 3584 and 14336 with narrow N, for bf16 and float32 x.
* The fragment layouts, lane by lane from the PTX tables of ``mma.sync
  m16n8k16`` and ``ldmatrix``: the GeMV's (packed bytes and x chunks
  straight from device memory into registers) and the mma.sync GEMM's
  (shared-memory tiles, 16-byte chunks XOR-swizzled by row, the layout the
  wgmma GEMM's descriptors also read, through ldmatrix), each against the
  exact product of small integers, with one planted layout mutation each
  that must fail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.w4a16_gemv.ops import w4a16_gemv as jw4_pallas
from repro.quant import int4 as jint4
from repro_torch.kernels.w4a16_gemv.ops import GEMV_MAX_M, variant
from repro_torch.quant.int4 import dequantize4, quantize_weight4, unpack_nibbles

W4_REL, W4_ABS = 1e-5, 1e-6
GV_WARPS = 16     # warps of a GeMV CTA, taking the groups in turn
BK = 64           # the GEMM's K tile


# ---------------------------------------------------------------- bit tools


def _bf16_bits(a) -> np.ndarray:
    """float values -> uint32 bf16 bits (round to nearest even)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF


def _halves(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """bf16x2 words -> (low half, high half) as float64."""
    w = np.asarray(w, np.uint32)
    lo = ((w & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (w & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo.astype(np.float64), hi.astype(np.float64)


def _pack(lo_bits, hi_bits) -> np.ndarray:
    return (np.asarray(lo_bits, np.uint32) | (np.asarray(hi_bits, np.uint32) << 16)
            ).astype(np.uint32)


def _byte_perm(x, y, s: int) -> np.ndarray:
    """PTX prmt (default mode): result byte i is byte ((s >> 4i) & 7) of
    the eight bytes x0..x3, y0..y3."""
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
          [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 7] << (8 * i)
    return out


def dequant8(w) -> list[np.ndarray]:
    """The kernel's dequant8: a packed word -> four bf16x2 words,
    (lo(byte j) - 8, hi(byte j) - 8)."""
    w = np.asarray(w, np.uint32)
    sh = w >> 4
    out = []
    for j in range(4):
        t = _byte_perm(w, sh, j * 0x0011 + (4 + j) * 0x1100)
        v = (t & 0x000F000F) | 0x43004300
        lo, hi = _halves(v)                 # bf16 128 + n, exactly
        out.append(_pack(_bf16_bits(lo - 136.0), _bf16_bits(hi - 136.0)))
    return out


def split3(f) -> list[np.ndarray]:
    """The kernel's split3: float32 -> three float32 values of bf16 width
    (each the high half of what the earlier terms leave)."""
    r = np.asarray(f, np.float32).copy()
    terms = []
    for _ in range(3):
        hi = (r.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        terms.append(hi.copy())
        r = (r - hi).astype(np.float32)
    return terms


# ---------------------------------------------------- conversion and split


def test_dequant8_is_exact_on_every_byte():
    """Every byte value in every position of a packed word: word j of the
    output holds (lo - 8, hi - 8) of byte j as bf16, the columns the
    reference's ``unpack_nibbles`` gives."""
    b = np.arange(256, dtype=np.uint32)
    words = sum(np.roll(b, -i) << (8 * i) for i in range(4)).astype(np.uint32)
    out = dequant8(words)
    packed = words.view(np.uint8).reshape(256, 4)        # little-endian bytes
    cols = unpack_nibbles(torch.from_numpy(packed.copy())).numpy()  # [256, 8]
    for j in range(4):
        lo, hi = _halves(out[j])
        np.testing.assert_array_equal(lo, cols[:, 2 * j])
        np.testing.assert_array_equal(hi, cols[:, 2 * j + 1])
        byte = (words >> (8 * j)) & 0xFF
        np.testing.assert_array_equal(
            out[j], _pack(_bf16_bits((byte & 0xF).astype(np.float32) - 8),
                          _bf16_bits((byte >> 4).astype(np.float32) - 8)))


def test_split3_gives_float32_back_exactly():
    """Three bf16 terms hold any float32 of magnitude 2^-110 or more (or
    zero) exactly, where the remainders stay normal: their sum (in float64)
    is x, and each term has no bits below bf16's.  (Below that a remainder
    is subnormal and loses bits: no activation is that small.)"""
    rng = np.random.RandomState(0)
    x = (rng.randn(200_000) * 10.0 ** rng.uniform(-30, 30, 200_000)
         ).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, -0.0, 1.0, -3.0e38, 3.4e38,
                                       2.0 ** -110, np.pi, 1 / 3])])
    t = split3(x)
    for term in t:
        assert not (term.view(np.uint32) & 0xFFFF).any()
    np.testing.assert_array_equal(
        t[0].astype(np.float64) + t[1].astype(np.float64)
        + t[2].astype(np.float64), x.astype(np.float64))
    # two terms leave up to 2^-16 of x: the third is needed
    assert (t[2] != 0).mean() > 0.9


# ----------------------------------------------------- summation orders


def _one_mma(c, xs, ws):
    """c [M, N] float32 + the exact products of one mma's 16 columns
    (xs [M, 16], ws [N, 16]), rounded once to float32."""
    return (c.astype(np.float64) + xs @ ws.T).astype(np.float32)


def _fma(p, s, t):
    return (p.astype(np.float64) * s.astype(np.float64)
            + t.astype(np.float64)).astype(np.float32)


def _terms(x32: np.ndarray, f32: bool) -> list[np.ndarray]:
    return [t.astype(np.float64) for t in split3(x32)] if f32 \
        else [x32.astype(np.float64)]


def gemv_order(x32, wq, scale, f32):
    """The GeMV's sums: per group, 8 mma steps over the columns that its
    lanes q = 0..3 put in the k slots (4 consecutive columns of each lane's
    32); float32 x's three terms one mma each; groups split over 16 warps
    (group i to warp i % 16), totals summed in warp order."""
    m, k = x32.shape
    g = min(128, k)
    ng = -(-k // g)
    terms = _terms(x32, f32)
    n = wq.shape[0]
    warp_tot = np.zeros((GV_WARPS, m, n), np.float32)
    for gi in range(ng):
        c = np.zeros((m, n), np.float32)
        for step in range(8):
            t, half = divmod(step, 2)
            cols = np.array([gi * g + 32 * q + 8 * t + 4 * half + e
                             for q in range(4) for e in range(4)])
            ok = cols < k
            cols = np.where(ok, cols, 0)
            ws = wq[:, cols] * ok
            for term in terms:
                c = _one_mma(c, term[:, cols] * ok, ws)
        w = gi % GV_WARPS
        warp_tot[w] = _fma(c, scale[None, :, gi], warp_tot[w])
    out = np.zeros((m, n), np.float32)
    for w in range(GV_WARPS):
        out = (out + warp_tot[w]).astype(np.float32)
    return out


def gemm_order(x32, wq, scale, f32):
    """The GEMM's sums: K tiles of 64 columns, 4 mma steps of 16 each,
    term-major for float32 x; the partial folded after a group's last
    tile."""
    m, k = x32.shape
    g = min(128, k)
    terms = _terms(x32, f32)
    n = wq.shape[0]
    part = np.zeros((m, n), np.float32)
    total = np.zeros((m, n), np.float32)
    n_tiles = -(-k // BK)
    for t in range(n_tiles):
        for ks in range(BK // 16):
            cols = t * BK + 16 * ks + np.arange(16)
            ok = cols < k
            cols = np.where(ok, cols, 0)
            for term in terms:
                part = _one_mma(part, term[:, cols] * ok, wq[:, cols] * ok)
        if t + 1 == n_tiles or ((t + 1) * BK) % g == 0:
            total = _fma(part, scale[None, :, t * BK // g], total)
            part = np.zeros_like(part)
    return total


@pytest.mark.parametrize("k,n", [(3584, 24), (14336, 16), (960, 8)])
@pytest.mark.parametrize("f32", [False, True])
def test_kernel_summation_orders_vs_pallas(k, n, f32):
    """Both kernels' orders against the JAX Pallas kernel (interpret mode)
    and the exact float64 product, within W4_TOL; K 960 has a ragged last
    group."""
    rng = np.random.RandomState(k + n + f32)
    wf = (rng.randn(n, k) * k ** -0.5).astype(np.float32)
    x = rng.randn(4, k).astype(np.float32)
    if not f32:
        x = _halves(_bf16_bits(x))[0].astype(np.float32)  # bf16 values
    jq = jint4.quantize_weight4(jnp.asarray(wf))
    tq = quantize_weight4(torch.from_numpy(wf))
    wq = unpack_nibbles(tq.w_packed).numpy().astype(np.float64)
    scale = tq.scale.numpy()
    w_deq = dequantize4(tq).numpy().astype(np.float64)
    pallas = np.asarray(jw4_pallas(jq, jnp.asarray(x.T), interpret=True)).T
    exact = x.astype(np.float64) @ w_deq.T
    limit = W4_REL * (np.abs(x).astype(np.float64) @ np.abs(w_deq).T) + W4_ABS
    for order in (gemv_order, gemm_order):
        got = order(x, wq, scale, f32)
        for what, ref in (("Pallas", pallas), ("exact", exact)):
            used = (np.abs(got - ref) / limit).max()
            assert used <= 1.0, f"{order.__name__} vs {what}: {used:.3f}"
    # bf16 terms alone would not do for float32 x
    if f32:
        one = gemm_order(_halves(_bf16_bits(x))[0].astype(np.float32), wq,
                         scale, False)
        assert (np.abs(one - exact) / limit).max() > 1.0


# ------------------------------------------------------- fragment layouts


def mma_emulate(a, b, c):
    """mma.sync m16n8k16 bf16 for one warp, from the PTX fragment tables:
    a [32, 4], b [32, 2] bf16x2 words, c [32, 4] float64 -> d [32, 4]
    (g = lane / 4, q = lane % 4: a0 row g, a1 row g + 8, k 2q + {0, 1};
    a2 / a3 the same rows, k 8 + 2q + {0, 1}; b0 k 2q + {0, 1}, b1 k 8 +
    2q + {0, 1}, column g; c0 / c1 row g, c2 / c3 row g + 8, columns
    2q + {0, 1})."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, q = divmod(lane, 4)
        for r, (row, kk) in enumerate(((g, 2 * q), (g + 8, 2 * q),
                                       (g, 8 + 2 * q), (g + 8, 8 + 2 * q))):
            A[row, kk], A[row, kk + 1] = _halves(a[lane, r])
        B[2 * q, g], B[2 * q + 1, g] = _halves(b[lane, 0])
        B[8 + 2 * q, g], B[9 + 2 * q, g] = _halves(b[lane, 1])
    D = A @ B
    d = np.array(c, np.float64)
    for lane in range(32):
        g, q = divmod(lane, 4)
        d[lane] += [D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q],
                    D[g + 8, 2 * q + 1]]
    return d


def _small_case(rng, m, k, n):
    """Small integers (every sum exact in float64) and power-of-two scales:
    x [m, k] bf16-exact, packed bytes [n, k / 2], scales [n, ng]."""
    x = rng.randint(-4, 5, (m, k)).astype(np.float32)
    wp = rng.randint(0, 256, (n, k // 2)).astype(np.uint8)
    ng = -(-k // min(128, k))
    scale = (2.0 ** rng.randint(-3, 4, (n, ng))).astype(np.float32)
    w = unpack_nibbles(torch.from_numpy(wp)).numpy().astype(np.float64)
    sc = np.repeat(scale, min(128, k), axis=1)[:, :k]
    return x, wp, scale, x.astype(np.float64) @ (w * sc).T


def gemv_tile(x, wp, scale, n0, mutate=False):
    """One GeMV CTA (16 weight rows from n0), lane by lane as the kernel
    loads and issues: out [M, 16]; ``mutate`` swaps the a1 / a2 registers
    (row g + 8 and the high k slots)."""
    m, k = x.shape
    n = wp.shape[0]
    g_sz = min(128, k)
    xb = _bf16_bits(x)
    tot = np.zeros((GV_WARPS, 32, 4))
    for gi in range(-(-k // g_sz)):
        c = np.zeros((32, 4))
        ra = np.zeros((32, 4, 4), np.uint32)     # lane, word t, dequant8 j
        rb = np.zeros((32, 4, 4), np.uint32)
        xw = np.zeros((32, 16), np.uint32)
        sa, sb = np.zeros(32), np.zeros(32)
        for lane in range(32):
            g, q = divmod(lane, 4)
            k0 = gi * g_sz + 32 * q
            for dst, row, s in ((ra, n0 + g, sa), (rb, n0 + g + 8, sb)):
                byt = np.zeros(16, np.uint8)
                if row < n:       # a lane's scales serve its output columns
                    s[lane] = scale[row, gi]
                if row < n and k0 < k:
                    seg = wp[row, k0 // 2:k0 // 2 + 16]
                    byt[:len(seg)] = seg
                dst[lane] = np.stack(dequant8(byt.view(np.uint32)), 1)
            if g < m and k0 < k:
                cols = xb[g, k0:k0 + 32]
                cols = np.pad(cols, (0, 32 - len(cols)))
                xw[lane] = _pack(cols[0::2], cols[1::2])
        for t in range(4):
            for half in range(2):
                j = 2 * half
                a = np.stack([ra[:, t, j], rb[:, t, j], ra[:, t, j + 1],
                              rb[:, t, j + 1]], 1)
                if mutate:
                    a = a[:, [0, 2, 1, 3]]
                b = xw[:, [4 * t + 2 * half, 4 * t + 2 * half + 1]]
                c = mma_emulate(a, b, c)
        tot[gi % GV_WARPS] += c * np.stack([sa, sa, sb, sb], 1)
    out = np.zeros((m, 16))
    s = tot.sum(0)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for i in range(4):
            mm, nn = 2 * q + (i & 1), g + 8 * (i >> 1)
            if mm < m:
                out[mm, nn] = s[lane, i]
    return out


@pytest.mark.parametrize("m,k,n", [(5, 256, 16), (8, 96, 16), (3, 100, 12)])
def test_gemv_fragment_layout_lane_by_lane(m, k, n):
    """The GeMV's registers through the mma tables give the exact product
    (two groups; one group of 96 with lanes past it; a ragged K of 100 with
    rows past N); the a1 / a2 swap must not."""
    x, wp, scale, exact = _small_case(np.random.RandomState(m + k), m, k, n)
    np.testing.assert_array_equal(gemv_tile(x, wp, scale, 0)[:, :n], exact)
    assert not np.array_equal(gemv_tile(x, wp, scale, 0, mutate=True)[:, :n],
                              exact)


def _swz(r, c):
    """Element offset of (row r, 16-byte chunk c) in a [rows][64] bf16 tile,
    chunks XOR-swizzled by row (the kernel's swz)."""
    return r * BK + ((c ^ (r & 7)) << 3)


def _ldmatrix_x4(smem, addr):
    """ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8;
    register m of lane (g, q) holds row g, columns 2q, 2q + 1 of matrix m."""
    regs = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for mat in range(4):
            row = smem[addr[8 * mat + g]:addr[8 * mat + g] + 8]
            regs[lane, mat] = _pack(row[2 * q], row[2 * q + 1])
    return regs


def gemm_tile(x, wp, swizzle_reads=True):
    """One GEMM CTA over one K tile of 64 columns (x [128, 64] bf16-exact,
    wp [128, 32] bytes): the stores into shared memory as the kernel's
    threads make them (x chunks as they are, weights through dequant8), then
    each warp's ldmatrix reads and mma.sync; out [128, 128]."""
    xs = np.zeros(128 * BK, np.uint32)
    ws = np.zeros(128 * BK, np.uint32)
    xb = _bf16_bits(x)
    for tid in range(256):
        for i in range(4):
            r, c = tid // 8 + 32 * i, tid % 8
            xs[_swz(r, c):_swz(r, c) + 8] = xb[r, 8 * c:8 * c + 8]
        wr, wh = divmod(tid, 2)
        d = np.stack(dequant8(wp[wr, 16 * wh:16 * wh + 16].view(np.uint32)), 1)
        for j in range(4):
            half = np.stack([d[j] & 0xFFFF, d[j] >> 16], 1).ravel()
            ws[_swz(wr, 4 * wh + j):_swz(wr, 4 * wh + j) + 8] = half
    rd = _swz if swizzle_reads else (lambda r, c: r * BK + c * 8)
    out = np.zeros((128, 128))
    for warp in range(8):
        wm, wn = divmod(warp, 4)
        part = np.zeros((4, 4, 32, 4))
        lanes = np.arange(32)
        mi, li = lanes // 8, lanes % 8
        for ks in range(BK // 16):
            bf = [_ldmatrix_x4(ws, rd(32 * wn + 16 * p + 8 * (mi >> 1) + li,
                                      2 * ks + (mi & 1))) for p in range(2)]
            for mt in range(4):
                af = _ldmatrix_x4(xs, rd(64 * wm + 16 * mt + 8 * (mi & 1) + li,
                                         2 * ks + (mi >> 1)))
                for nt in range(4):
                    b = bf[nt // 2][:, [2 * (nt % 2), 2 * (nt % 2) + 1]]
                    part[mt, nt] = mma_emulate(af, b, part[mt, nt])
        for mt in range(4):
            for nt in range(4):
                for lane in range(32):
                    g, q = divmod(lane, 4)
                    for i in range(4):
                        r = 64 * wm + 16 * mt + g + 8 * (i >> 1)
                        col = 32 * wn + 8 * nt + 2 * q + (i & 1)
                        out[r, col] = part[mt, nt, lane, i]
    return out


def test_gemm_fragment_layout_lane_by_lane():
    """One CTA's K tile through the swizzled shared-memory tiles, ldmatrix
    and the mma tables gives the exact product; reading the tiles without
    the swizzle the stores used must not."""
    rng = np.random.RandomState(7)
    x, wp, _scale, _ = _small_case(rng, 128, BK, 128)
    w = unpack_nibbles(torch.from_numpy(wp)).numpy().astype(np.float64)
    exact = x.astype(np.float64) @ w.T
    np.testing.assert_array_equal(gemm_tile(x, wp), exact)
    assert not np.array_equal(gemm_tile(x, wp, swizzle_reads=False), exact)


def test_variant_rule():
    """M <= 8 rows take the GeMV, more the tiled GEMM: the rule that keeps
    a decode batch's rows batch-invariant."""
    assert GEMV_MAX_M == 8
    assert [variant(m) for m in (1, 4, 8)] == ["w4a16_gemv"] * 3
    assert [variant(m) for m in (9, 130, 2048)] == ["w4a16_gemm"] * 3
