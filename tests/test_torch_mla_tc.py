"""CPU rehearsal of the paged MLA decode kernel's fragment layout
(``csrc/mla_decode_attention.cu``, ``mla_decode_attention_kernel``), which
only a card runs.

Every CTA of one slot is emulated lane by lane from the PTX fragment tables
of ``ldmatrix`` (``.x4``, ``.x4.trans``) and ``mma.sync m16n8k16`` bf16,
with the kernel's own shared-memory layout (rows padded by 8 elements, the
rope dims padded to 16), its warp roles (warp w: a slice of the dims for
every key, the query's A fragments of it in registers as three bf16
terms; the slices' sums added in warp order, latent and rope apart; the
context's column pairs by warp), its element-to-(head, key) and
element-to-(head, column) maps, the split's softmax, the one-split path
and the split-order merge of each column block.  It is held against the
kernel's rounding rehearsal (``ref.mla_decode_attention_splitkv``) within
1e-5 of max|ckv| (the same roundings, float32 sums in another order),
where a misplaced fragment is off by O(1); planted index mutations must
fail that check.  Both instances: deepseek-v2-lite-16b's (R 512, Dr 64,
H 16; four column blocks) and the reduced config's (R 32, Dr 8 padded to
16, H 4), over bf16 and int8 pools, at lengths crossing the split edges.  The int8 codes' widening to
bf16 is checked bit for bit on every code.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.mla_decode_attention.ref import (
    bf16_terms, mla_decode_attention_splitkv)
from repro_torch.models.attention import gather_paged_rows, quantize_rows

LANES = np.arange(32)
LG, LQ = LANES // 4, LANES % 4
MI, MR = LANES // 8, LANES % 8
SPLIT, TILE, PPITCH = 64, 16, 72


def _ldmatrix(smem: np.ndarray, addr, n: int, trans: bool = False):
    """``ldmatrix.x{n}`` (``.trans``): lane l addresses row l % 8 of matrix
    l / 8 at ``addr`` [32, 2] (row, column) of ``smem``; lane (g, q)
    receives matrix m's (row g, columns 2q, 2q + 1), or with .trans its
    (rows 2q, 2q + 1, column g).  Returns [n, 32 lanes, 2]."""
    out = np.zeros((n, 32, 2), np.float32)
    for m in range(n):
        mat = np.stack([smem[r, c:c + 8] for r, c in addr[8 * m:8 * m + 8]])
        if trans:
            mat = mat.T
        out[m] = np.stack([mat[LG, 2 * LQ], mat[LG, 2 * LQ + 1]], axis=-1)
    return out


def _mma(a, b0, b1, c):
    """``mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32``: a [4, 32, 2], b0 /
    b1 [32, 2], c [32, 4]; A reg 0 of lane (g, q) row g, k 2q + {0, 1},
    reg 1 row g + 8, regs 2 / 3 the same rows at k 8 + 2q; B reg 0 k 2q +
    {0, 1}, reg 1 k 8 + 2q, column g; C c0, c1 row g, c2, c3 row g + 8,
    columns 2q + {0, 1}."""
    am, bm = np.zeros((16, 16)), np.zeros((16, 8))
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


def _split3(x: np.ndarray) -> list[np.ndarray]:
    return [t.numpy() for t in bf16_terms(torch.from_numpy(
        np.ascontiguousarray(x, np.float32)))]


def _query_frag(q: np.ndarray, d0: int) -> list[np.ndarray]:
    """The kernel's ``load_query`` + ``split_query``: the A fragment of dims
    [d0, d0 + 16) of q [16 heads, dims] (lane (g, q): reg 0 head g, dims
    2q + {0, 1}; reg 1 head g + 8; regs 2, 3 dims 8 + 2q), as three bf16
    terms.  Returns [3 terms][4, 32, 2]."""
    frag = np.zeros((4, 32, 2), np.float32)
    for rr in range(4):
        hrow = LG + 8 * (rr % 2)
        d = d0 + 8 * (rr // 2) + 2 * LQ
        frag[rr] = np.stack([q[hrow, d], q[hrow, d + 1]], axis=-1)
    return _split3(frag)


def _addr(rows, cols):
    return list(zip(np.broadcast_to(rows, 32), np.broadcast_to(cols, 32)))


def _emulate_slot(q_c, q_r, ckv, kr, cs, ks, n, scale, col_split=1,
                  mutate=None):
    """One slot's output [H, R] as the kernel's CTAs compute it: q_c [H, R],
    q_r [H, Dr]; ckv [S, R], kr [S, Dr] the slot's rows as staged (bf16
    values, or int8 codes with row scales cs / ks [S], else None); n its
    length."""
    h, r = q_c.shape
    dr = q_r.shape[1]
    drp = max(dr, 16)
    lat_steps, rope_steps = r // 16, drp // 16
    lpw = lat_steps // 8 if lat_steps >= 8 else 1
    lat_warps = lat_steps // lpw
    cols = r // col_split
    col_pairs = cols // 16
    npw = col_pairs // 8 if col_pairs >= 8 else 1
    # the query (heads padded to 16, rope dims to drp), q_c | q_r
    q_sm = np.zeros((16, r + drp), np.float32)
    q_sm[:h, :r], q_sm[:h, r:r + dr] = q_c, q_r
    out = np.zeros((h, r), np.float32)
    if n <= 0:
        return out
    ns = -(-n // SPLIT)
    parts = []   # per split: (acc [16, R] over all column blocks, m, l)
    for split in range(ns):
        t0 = split * SPLIT
        n_tok = min(SPLIT, n - t0)
        n_kt = -(-n_tok // TILE)
        rows = np.zeros((SPLIT, r + 8), np.float32)
        rope = np.zeros((SPLIT, drp + 8), np.float32)
        rows[:n_tok, :r] = ckv[t0:t0 + n_tok]
        rope[:n_tok, :dr] = kr[t0:t0 + n_tok]
        # scores: warp w's slice of the dims (latent k-steps [w lpw, (w +
        # 1) lpw), the last warps one rope k-step each) for every key
        red = {}
        for warp in range(8):
            lat_warp = warp < lat_warps
            lat0 = warp * lpw
            rope_ks = warp - (8 - rope_steps)
            lat = [np.zeros((32, 4), np.float32) for _ in range(8)]
            rp = [np.zeros((32, 4), np.float32) for _ in range(8)]
            qa = [_query_frag(q_sm, 16 * (lat0 + st))
                  for st in range(lpw if lat_warp else 0)]
            qr_frag = _query_frag(q_sm, r + 16 * rope_ks) if rope_ks >= 0 \
                else None
            for kt in range(n_kt):
                brow = kt * TILE + MR + 8 * (MI >> 1)
                if mutate == "b rows":
                    brow = kt * TILE + MR + 8 * (MI & 1)
                if lat_warp:
                    for st in range(lpw):
                        bf = _ldmatrix(rows, _addr(brow, 16 * (lat0 + st)
                                                   + 8 * (MI & 1)), 4)
                        for t in range(3):
                            lat[2 * kt] = _mma(qa[st][t], bf[0], bf[1],
                                               lat[2 * kt])
                            lat[2 * kt + 1] = _mma(qa[st][t], bf[2], bf[3],
                                                   lat[2 * kt + 1])
                if qr_frag is not None:
                    bf = _ldmatrix(rope, _addr(brow, 16 * rope_ks
                                               + 8 * (MI & 1)), 4)
                    for t in range(3):
                        rp[2 * kt] = _mma(qr_frag[t], bf[0], bf[1],
                                          rp[2 * kt])
                        rp[2 * kt + 1] = _mma(qr_frag[t], bf[2], bf[3],
                                              rp[2 * kt + 1])
            for name, accs, on in (("lat", lat, lat_warp),
                                   ("rope", rp, rope_ks >= 0)):
                if not on:
                    continue
                part = np.zeros((16, SPLIT), np.float32)
                for nt in range(2 * n_kt):
                    for e in range(4):
                        part[LG + 8 * (e // 2), 8 * nt + 2 * LQ + e % 2] = \
                            accs[nt][:, e]
                red[name, warp] = part
        s_p = np.zeros((16, PPITCH), np.float32)
        sl = np.zeros((16, SPLIT), np.float32)
        sr = np.zeros((16, SPLIT), np.float32)
        for warp in range(8):   # warp order, latent and rope apart
            if ("lat", warp) in red:
                sl = (sl + red["lat", warp]).astype(np.float32)
            if ("rope", warp) in red:
                sr = (sr + red["rope", warp]).astype(np.float32)
        keys = np.arange(SPLIT)
        ok = keys < n_tok
        if cs is not None:
            kk = np.minimum(t0 + keys, len(cs) - 1)
            sl = np.where(ok, sl * cs[kk], sl).astype(np.float32)
            sr = np.where(ok, sr * ks[kk], sr).astype(np.float32)
        s_p[:, :SPLIT] = np.where(ok, (sl + sr) * np.float32(scale), -1e30)
        m = np.zeros(16, np.float32)
        ell = np.zeros(16, np.float32)
        keys = np.arange(SPLIT)
        for hh in range(16):
            if hh >= h:
                s_p[hh, :SPLIT] = 0.0
                continue
            v = np.where(keys < n_tok, s_p[hh, :SPLIT], -1e30)
            m[hh] = v.max()
            e = np.where(keys < n_tok, np.exp(v - m[hh]), 0.0).astype(
                np.float32)
            ell[hh] = e.sum(dtype=np.float32)
            if cs is not None:
                e = np.where(keys < n_tok, e * cs[np.minimum(
                    t0 + keys, len(cs) - 1)], 0.0).astype(np.float32)
            s_p[hh, :SPLIT] = e
        acc_all = np.zeros((16, r), np.float32)
        for cb in range(col_split):
            for warp in range(8):
                if warp * npw >= col_pairs:
                    continue
                wc0 = cb * cols + warp * npw * 16
                acc = [np.zeros((32, 4), np.float32) for _ in range(2 * npw)]
                for kstep in range(n_kt):
                    af = np.zeros((3, 4, 32, 2), np.float32)
                    for rr in range(4):
                        hrow = LG + 8 * (rr % 2)
                        kcol = 16 * kstep + 8 * (rr // 2) + 2 * LQ
                        pair = np.stack([s_p[hrow, kcol], s_p[hrow, kcol + 1]],
                                        axis=-1)
                        for t, term in enumerate(_split3(pair)):
                            af[t, rr] = term
                    for np_ in range(npw):
                        c_off = 8 * (MI >> 1)
                        if mutate == "trans cols":
                            c_off = 8 * (MI & 1)
                        xf = _ldmatrix(rows, _addr(
                            16 * kstep + MR + 8 * (MI & 1),
                            wc0 + 16 * np_ + c_off), 4, trans=True)
                        for t in range(3):
                            acc[2 * np_] = _mma(af[t], xf[0], xf[1],
                                                acc[2 * np_])
                            acc[2 * np_ + 1] = _mma(af[t], xf[2], xf[3],
                                                    acc[2 * np_ + 1])
                for nt in range(2 * npw):
                    for e in range(4):
                        hh = LG + 8 * (e // 2)
                        col = wc0 + 8 * nt + 2 * LQ + e % 2
                        acc_all[hh, col] = acc[nt][:, e]
        parts.append((acc_all, m, ell))
    if ns == 1:
        acc_all, m, ell = parts[0]
        return (acc_all[:h] / np.maximum(ell[:h], 1e-20)[:, None]).astype(
            np.float32)
    mx = np.max([p[1] for p in parts], axis=0)
    tot = np.zeros(16, np.float32)
    acc = np.zeros((16, r), np.float32)
    for acc_s, m_s, l_s in parts:   # split-index order
        w = np.exp(m_s - mx).astype(np.float32)
        tot = (l_s * w + tot).astype(np.float32)
        acc = (acc_s * w[:, None] + acc).astype(np.float32)
    return (acc[:h] / np.maximum(tot[:h], 1e-20)[:, None]).astype(np.float32)


def _inputs(seed, kv, lens, h, r, dr, page=16, pps=6):
    """Seeded queries (scores to a few units), pools and a shuffled table."""
    rng = np.random.RandomState(seed)
    b, n_pages = len(lens), len(lens) * pps + 1
    ckv = torch.from_numpy(rng.randn(n_pages, page, r).astype(np.float32))
    kr = torch.from_numpy(rng.randn(n_pages, page, dr).astype(np.float32))
    if kv == "int8":
        ckv_p, kr_p = quantize_rows(ckv), quantize_rows(kr)
    else:
        ckv_p, kr_p = ckv.to(torch.bfloat16), kr.to(torch.bfloat16)
    block = torch.from_numpy((rng.permutation(n_pages - 1)[:b * pps] + 1)
                             .reshape(b, pps).astype(np.int32))
    q_c = torch.from_numpy(rng.randn(b, h, r).astype(np.float32)
                           * (2.0 / r ** .5))
    q_r = torch.from_numpy(rng.randn(b, h, dr).astype(np.float32)
                           * (2.0 / dr ** .5))
    return q_c, q_r, ckv_p, kr_p, block, torch.tensor(lens, dtype=torch.int32)


def _staged(pool, block):
    """A slot's rows as the kernel stages them, and its row scales."""
    if isinstance(pool, tuple):
        return (gather_paged_rows(pool[0], block).float()[0].numpy(),
                gather_paged_rows(pool[1], block).float()[0].numpy())
    return gather_paged_rows(pool, block).float()[0].numpy(), None


def _emulate(q_c, q_r, ckv, kr, block, lens, scale, **kw):
    outs = []
    for i in range(len(lens)):
        rows, cs = _staged(ckv, block[i:i + 1])
        rope, ks = _staged(kr, block[i:i + 1])
        n = min(int(lens[i]), rows.shape[0])
        outs.append(_emulate_slot(q_c[i].numpy(), q_r[i].numpy(), rows,
                                  rope, cs, ks, n, scale, **kw))
    return np.stack(outs)


CASES = {   # (lens, H, R, Dr)
    "deepseek-v2-lite-16b": ([65, 17, 0], 16, 512, 64),
    "deepseek-v2-lite-16b, split edges": ([64, 1], 16, 512, 64),
    "reduced": ([1, 63, 64, 65, 96, 0], 4, 32, 8),
}


def _col_split(r: int) -> int:
    """The kernel's column blocks a split (``col_split``)."""
    return 4 if r >= 128 else 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mla_fragment_layout_matches_rehearsal(case, kv):
    lens, h, r, dr = CASES[case]
    q_c, q_r, ckv, kr, block, lengths = _inputs(len(case), kv, lens, h, r, dr)
    scale = 192 ** -0.5
    got = _emulate(q_c, q_r, ckv, kr, block, lengths, scale,
                   col_split=_col_split(r))
    want = mla_decode_attention_splitkv(q_c, q_r, ckv, kr, block, lengths,
                                        scale).numpy()
    mag = float(gather_paged_rows(ckv, block).float().abs().max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * mag)
    assert not got[np.asarray(lens) == 0].any()


@pytest.mark.parametrize("mutate", ["b rows", "trans cols"])
def test_mla_fragment_mutations_fail(mutate):
    """The score's row operand read with its key halves and dim halves
    crossed, or the context's rows read 8 columns off: the emulation
    leaves the gate."""
    lens, h, r, dr = CASES["reduced"]
    q_c, q_r, ckv, kr, block, lengths = _inputs(1, "bf16", lens, h, r, dr)
    scale = 192 ** -0.5
    got = _emulate(q_c, q_r, ckv, kr, block, lengths, scale, mutate=mutate)
    want = mla_decode_attention_splitkv(q_c, q_r, ckv, kr, block, lengths,
                                        scale).numpy()
    mag = float(gather_paged_rows(ckv, block).float().abs().max())
    assert np.abs(got - want).max() > 1e-3 * mag


def _widen(codes: np.ndarray, bias: int = 0x80) -> np.ndarray:
    """The kernel's ``widen2`` on int8 codes: the float 2^23 + (c + 128)
    from its bits (``__byte_perm`` of the byte-flipped code under
    0x4B0000__), less 2^23 + 128 in float32, its high half taken as the
    bf16 bits.  Returns the bf16 bit patterns."""
    biased = (codes.astype(np.int16) + bias).astype(np.uint8).astype(np.uint32)
    f = (np.uint32(0x4B000000) | biased).view(np.float32) \
        - np.float32(8388736.0)
    assert f.dtype == np.float32
    return (f.view(np.uint32) >> 16).astype(np.uint16)


def test_int8_widening_is_exact_for_every_code():
    """Every int8 code comes out as its own bf16 value, and its float32's
    low 16 bits are 0, so the high half is the whole value; a wrong bias
    does not."""
    codes = np.arange(-128, 128, dtype=np.int8)
    want = torch.from_numpy(codes.astype(np.float32)).to(torch.bfloat16) \
        .view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(_widen(codes), want)
    biased = (codes.astype(np.int16) + 0x80).astype(np.uint32)
    f = (np.uint32(0x4B000000) | biased).view(np.float32) \
        - np.float32(8388736.0)
    assert not (f.view(np.uint32) & 0xFFFF).any()
    assert (_widen(codes, bias=0x7F) != want).any()
