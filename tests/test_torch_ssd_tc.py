"""CPU rehearsal of the bf16 tensor-core B6 kernel (``csrc/ssd_scan.cu``,
``ssd_intra_chunk_tc_kernel``), which only a card runs.

* Its roundings, emulated by ``ref.ssd_intra_chunk_split_ref`` (C B^T of
  bf16 inputs with float32 sums, cs in double (kept as a float pair for
  L = exp2 of float adds), S = (C B^T) o L in float32
  split into bf16 terms, S x summed in float32), held within the card's
  gate, rtol = atol = 1e-4 of the float64 plain version (chip_smoke.py's
  SSD_TOL), at Q 128 on the model's decays; the worst |err| / limit is
  printed for one, two and three terms of 8 significant bits each.  The
  kernel uses three, which hold S exactly; two leave ~2^-16 |S|, which the
  card's gate, on 14.7M outputs at zamba2-7b's shape (225x as many as
  here), would see in the tail.
* The same function against the JAX package's Pallas kernel in interpret
  mode, on bf16-representable inputs: rtol = atol = 1e-4 (the three bf16
  terms hold S exactly, and the Pallas kernel sums in float32).
* Its fragment layout: one CTA's schedule emulated lane by lane from the PTX
  fragment tables of ``ldmatrix`` (plain and ``.trans``) and ``mma.sync
  m16n8k16`` bf16, against the rounding rehearsal: rtol = atol = 1e-5 (the
  same roundings, float32 sums in another order), where a misplaced
  fragment is off by O(1).
* The rule that picks the heads per CTA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_intra_chunk_op
from repro_torch.kernels.ssd_scan.ops import (MAX_HEAD_BLOCK, ctas_per_sm,
                                              head_block)
from repro_torch.kernels.ssd_scan.ref import (ssd_intra_chunk_model_ref,
                                              ssd_intra_chunk_split_ref)

SSD_TOL = 1e-4
H100_SMS = 132


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _model_inputs(rng, b, s, h, g, p, n):
    """As chip_smoke.py makes them: x and B / C bf16, a = -A_h dt with A_h =
    1..16 over the heads and dt = softplus(normal)."""
    x = torch.from_numpy(rng.randn(b, s, h, p).astype(np.float32)).to(
        torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.randn(b, s, h).astype(np.float32)))
    a = -torch.linspace(1.0, 16.0, h) * dt
    bm, cm = (torch.from_numpy(rng.randn(b, s, g, n).astype(np.float32) * 0.5)
              .to(torch.bfloat16) for _ in range(2))
    return x, a, bm, cm


@pytest.mark.parametrize("h,p,n", [
    (4, 64, 64),    # zamba2-7b's head and state widths
    (4, 64, 128),   # mamba2-130m's
])
def test_b6_split_rehearsal_within_gate(h, p, n):
    x, a, bm, cm = _model_inputs(np.random.RandomState(h + n), 1, 256, h, 1,
                                 p, n)
    ref = ssd_intra_chunk_model_ref(x, a, bm, cm, 128, torch.float64)
    limit = SSD_TOL + SSD_TOL * ref.abs()
    ratios = {}
    for terms in (1, 2, 3):
        got = ssd_intra_chunk_split_ref(x, a, bm, cm, 128, terms)
        assert got.dtype == torch.float32
        ratios[terms] = float(((got.double() - ref).abs() / limit).max())
    print(f"B6 rehearsal Q=128 P={p} N={n}: worst |err|/limit "
          + ", ".join(f"{t} bf16 term{'s' * (t > 1)} {r:.4f}"
                      for t, r in ratios.items()))
    assert ratios[3] <= 1.0


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (1, 64, 4, 1, 32, 16, 32),    # two chunks
    (2, 32, 4, 2, 16, 32, 16),    # G > 1
])
def test_b6_split_rehearsal_matches_pallas(b, s, h, g, p, n, chunk):
    rng = np.random.RandomState(s * h)
    x = _bf16(rng.randn(b, s, h, p))
    a = (-np.abs(rng.randn(b, s, h)) * 0.1).astype(np.float32)
    bm, cm = (_bf16(rng.randn(b, s, g, n) * 0.3) for _ in range(2))
    want = np.asarray(ssd_intra_chunk_op(jnp.asarray(x), jnp.asarray(a),
                                         jnp.asarray(bm), jnp.asarray(cm),
                                         chunk=chunk, interpret=True))
    got = ssd_intra_chunk_split_ref(
        *(torch.from_numpy(t) for t in (x, a, bm, cm)), chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=SSD_TOL, atol=SSD_TOL)


# ---------------------------------------------------------------------------
# lane-by-lane emulation of one CTA of ssd_intra_chunk_tc_kernel
# ---------------------------------------------------------------------------

LANES = np.arange(32)
LG, LQ = LANES // 4, LANES % 4


def _ldmatrix_x4(smem: np.ndarray, row_col, trans: bool) -> np.ndarray:
    """``ldmatrix.x4`` (``.trans``): lane l addresses row l % 8 of matrix
    l / 8 at ``row_col(l)``; lane (g, q) receives matrix m's (row g,
    columns 2q, 2q + 1), or with .trans its (rows 2q, 2q + 1, column g).
    Returns [4 registers, 32 lanes, 2 values]."""
    out = np.zeros((4, 32, 2), np.float32)
    for m in range(4):
        mat = np.stack([smem[r, c:c + 8]
                        for r, c in (row_col(8 * m + i) for i in range(8))])
        if trans:
            mat = mat.T
        out[m] = np.stack([mat[LG, 2 * LQ], mat[LG, 2 * LQ + 1]], axis=-1)
    return out


def _mma_m16n8k16(a: np.ndarray, b0: np.ndarray, b1: np.ndarray,
                  c: np.ndarray) -> np.ndarray:
    """``mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`` from the lanes'
    fragments: A reg 0 of lane (g, q) holds row g, k 2q + {0, 1}; reg 1 row
    g + 8; regs 2 and 3 the same rows at k 8 + 2q + {0, 1}; B reg 0 holds k
    2q + {0, 1}, reg 1 k 8 + 2q + {0, 1}, column g; C / D c0, c1 row g, c2,
    c3 row g + 8, columns 2q + {0, 1}.  c: [32, 4] float32."""
    am = np.zeros((16, 16))
    bm = np.zeros((16, 8))
    for r, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in range(2):
            am[LG + dr, 2 * LQ + dk + e] = a[r, :, e]
    for r, b in enumerate((b0, b1)):
        for e in range(2):
            bm[2 * LQ + 8 * r + e, LG] = b[:, e]
    d = am @ bm
    dl = np.stack([d[LG, 2 * LQ], d[LG, 2 * LQ + 1], d[LG + 8, 2 * LQ],
                   d[LG + 8, 2 * LQ + 1]], axis=-1)
    return (c.astype(np.float64) + dl).astype(np.float32)


def _cta_rehearsal(x, a, bm, cm):
    """One CTA: x [E, Q, P], a [E, Q] of its E heads, B / C [Q, N] of their
    group, bf16-representable float32 arrays.  Returns y [E, Q, P] as the
    kernel's lanes compute and store it."""
    e_heads, q, p = x.shape
    n = bm.shape[1]
    n_rt = -(-q // 16)
    qp, npad = 16 * n_rt, 16 * -(-n // 16)
    cst, bst = np.zeros((qp, npad), np.float32), np.zeros((qp, npad),
                                                          np.float32)
    cst[:q, :n], bst[:q, :n] = cm, bm
    # C B^T, tile blocks at or below the diagonal, kept in fragment order
    gs = {}
    for rt in range(n_rt):
        for kt in range(rt + 1):
            acc = [np.zeros((32, 4), np.float32) for _ in range(2)]
            for ks in range(npad // 16):
                af = _ldmatrix_x4(cst, lambda ln: (
                    16 * rt + ln % 8 + 8 * ((ln // 8) & 1),
                    16 * ks + 8 * ((ln // 8) >> 1)), trans=False)
                bf = _ldmatrix_x4(bst, lambda ln: (
                    16 * kt + ln % 8 + 8 * ((ln // 8) >> 1),
                    16 * ks + 8 * ((ln // 8) & 1)), trans=False)
                acc[0] = _mma_m16n8k16(af, bf[0], bf[1], acc[0])
                acc[1] = _mma_m16n8k16(af, bf[2], bf[3], acc[1])
            gs[rt, kt] = np.concatenate(acc, axis=1)    # [32 lanes, 8]
    y = np.zeros((e_heads, q, p), np.float32)
    ri = np.array([0, 0, 8, 8, 0, 0, 8, 8])
    kj = np.array([0, 1, 0, 1, 8, 9, 8, 9])
    for e in range(e_heads):
        cs2 = np.cumsum(np.concatenate([a[e].astype(np.float64),
                                        np.zeros(128 - q)])) * np.log2(np.e)
        hi = cs2.astype(np.float32)
        lo = (cs2 - hi).astype(np.float32)
        xh = np.zeros((qp, p), np.float32)
        xh[:q] = x[e]
        for rt in range(n_rt):
            acc = [np.zeros((32, 4), np.float32) for _ in range(p // 8)]
            rows = 16 * rt + LG[:, None] + ri[None, :]           # [32, 8]
            for kt in range(rt + 1):
                keys = 16 * kt + 2 * LQ[:, None] + kj[None, :]
                with np.errstate(over="ignore", invalid="ignore"):
                    ell = np.exp2((hi[rows] - hi[keys])
                                  + (lo[rows] - lo[keys]))
                    s = np.where(keys <= rows, gs[rt, kt] * ell,
                                 0.0).astype(np.float32)
                terms = []
                for _ in range(3):   # the kernel's kTerms bf16 terms of S
                    t = (s.view(np.uint32) & np.uint32(0xFFFF0000)).view(
                        np.float32)
                    terms.append(np.stack([t[:, 2 * r:2 * r + 2]
                                           for r in range(4)]))
                    s = s - t
                for nq in range(p // 16):
                    xf = _ldmatrix_x4(xh, lambda ln: (
                        16 * kt + ln % 8 + 8 * ((ln // 8) & 1),
                        16 * nq + 8 * ((ln // 8) >> 1)), trans=True)
                    for t, (b0, b1) in enumerate(((xf[0], xf[1]),
                                                  (xf[2], xf[3]))):
                        for af in terms:
                            acc[2 * nq + t] = _mma_m16n8k16(
                                af, b0, b1, acc[2 * nq + t])
            for half in range(2):
                for nt in range(p // 8):
                    for lane in range(32):
                        t = 16 * rt + LG[lane] + 8 * half
                        if t < q:
                            col = 8 * nt + 2 * LQ[lane]
                            y[e, t, col:col + 2] = \
                                acc[nt][lane, 2 * half:2 * half + 2]
    return y


@pytest.mark.parametrize("q,p,n", [
    (32, 32, 32),   # whole tiles: two row tiles, three blocks
    (24, 16, 24),   # Q and N not multiples of 16: zero-filled rows and dims
])
def test_b6_fragment_layout_matches_rehearsal(q, p, n):
    rng = np.random.RandomState(q + p + n)
    e_heads = 2
    x = _bf16(rng.randn(e_heads, q, p))
    a = (-np.abs(rng.randn(e_heads, q)) * 0.5).astype(np.float32)
    bm, cm = _bf16(rng.randn(q, n) * 0.5), _bf16(rng.randn(q, n) * 0.5)
    got = _cta_rehearsal(x, a, bm, cm)
    # the same chunk in the model's layout: batch 1, heads of one group
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    want = ssd_intra_chunk_split_ref(
        t(x.transpose(1, 0, 2)[None]), t(a.T[None]), t(bm[None, :, None]),
        t(cm[None, :, None]), q)[0].numpy().transpose(1, 0, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,nc,h,g,p,want", [
    (4, 4, 112, 1, 64, 7),    # zamba2-7b bucket 512: 16 x 16 = 256 CTAs
    (4, 4, 24, 1, 64, 2),     # mamba2-130m: 192 CTAs
    (4, 16, 22, 1, 64, 6),    # 22 heads in blocks of 6: a ragged last block
    (2, 4, 16, 2, 32, 1),     # G 2: 128 CTAs, inside each group of 8 heads
    (2, 4, 64, 2, 32, 2),     # G 2, blocks of 2 of each group's 32 heads
    (1, 1, 8, 8, 16, 1),      # one head per group
    (4, 4, 112, 1, 128, 8),   # P 128: one CTA an SM, 1.6 waves
    (64, 16, 112, 1, 64, MAX_HEAD_BLOCK),
])
def test_b6_head_block_rule(b, nc, h, g, p, want):
    hpc = head_block(b, nc, h, g, H100_SMS * ctas_per_sm(p))
    assert hpc == want
    assert hpc <= h // g and hpc <= MAX_HEAD_BLOCK
