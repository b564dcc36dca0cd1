"""CPU rehearsal of the paged chunk kernel, which only a card runs.

``csrc/paged_chunk_attention.cu`` runs B3's per-block arithmetic
(``csrc/attention_tile.cuh``) over a slot's pages: 64-row query tiles at
absolute multiples of 64, intersected with the chunk; K/V blocks of 64
keys from key 0, read through the block row, keys after the tile's last
live position zero-filled; int8 pools with each key's scale on its score
and each value row's scale on P before P is split into bf16 hi + lo.
Written out here in plain PyTorch, with the same per-tile function for the
one-shot schedule (B3's tiles over a contiguous sequence):

* a chunk query's output equals, bit for bit, the one-shot schedule's
  output for the same query, for every chunk start, size, bucket padding,
  page size that divides 64, block-row order, GQA ratio and head dim
  (16, 64, 112, 128), and padding rows come out 0;
* the chunk schedule is within the card's gate of the JAX package's
  ``paged_chunk_attention`` (bf16 and int8 pools): two bf16 steps of the
  reference plus 1e-5.

The products are taken in float64 and rounded to float32, so the rehearsal
is exact whatever the CPU's matrix code does; the card's own bits are held
by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import attention as JA

BLOCK = 64       # query rows per tile and keys per K/V block
BF16_STEPS = 2
F32_NOISE = 1e-5


def _tile(q, key_block, n_blocks, q0, scale):
    """One 64-row query tile q [H, 64, DP] (rows at positions q0..q0+63)
    over K/V blocks 0..n_blocks-1; ``key_block(kb)`` -> (k, v) [H, 64, DP]
    and, for int8 pools, (ks, vs) [H, 64].  Returns bf16-rounded rows
    [H, 64, DP]."""
    h, _, dp = q.shape
    m = torch.full((h, BLOCK), -1e30)
    l = torch.zeros((h, BLOCK))
    o = torch.zeros((h, BLOCK, dp))
    pos = q0 + torch.arange(BLOCK)
    for kb in range(n_blocks):
        k, v, ks, vs = key_block(kb)
        sc = (q.double() @ k.double().transpose(-1, -2)).float()
        if ks is not None:
            sc = sc * ks[:, None, :]
        sc = sc * scale
        if kb == n_blocks - 1:
            keys = kb * BLOCK + torch.arange(BLOCK)
            sc = torch.where(keys[None, None, :] > pos[None, :, None],
                             torch.tensor(-1e30), sc)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = p * vs[:, None, :] if vs is not None else p
        hi = pv.to(torch.bfloat16).float()
        lo = (pv - hi).to(torch.bfloat16).float()
        o = o * corr[..., None]
        o = o + (hi.double() @ v.double()).float()
        o = o + (lo.double() @ v.double()).float()
        m = m_new
    return (o / torch.clamp_min(l, 1e-20)[..., None]).to(torch.bfloat16)


def _pad(t, dp):
    return F.pad(t.float(), (0, dp - t.shape[-1]))


def one_shot(q, k, v):
    """B3's schedule: q [S, H, D], k/v [S, Hkv, D] bf16 -> [S, H, D]."""
    s, h, d = q.shape
    dp = 64 if d <= 64 else 128
    rep = h // k.shape[1]
    n_tiles = -(-s // BLOCK)
    rows = n_tiles * BLOCK
    qf = F.pad(_pad(q, dp), (0, 0, 0, 0, 0, rows - s)).transpose(0, 1)
    kf, vf = (F.pad(_pad(t, dp), (0, 0, 0, 0, 0, rows - s))
              .repeat_interleave(rep, dim=1).transpose(0, 1) for t in (k, v))

    def blocks(kb):
        sl = slice(kb * BLOCK, kb * BLOCK + BLOCK)
        return kf[:, sl], vf[:, sl], None, None

    out = torch.cat([_tile(qf[:, a * BLOCK:a * BLOCK + BLOCK], blocks, a + 1,
                           a * BLOCK, float(np.float32(d ** -0.5)))
                     for a in range(n_tiles)], dim=1)
    return out[:, :s, :d].transpose(0, 1)


def chunk(q, k_pages, v_pages, block_row, start, n_valid):
    """The chunk kernel's schedule: q [C, H, D] at positions start..;
    k/v_pages bf16 [P, page, Hkv, D] or int8 (data, scale) pairs ->
    [C, H, D], rows from n_valid on 0."""
    c, h, d = q.shape
    int8 = isinstance(k_pages, tuple)
    kd, vd = (p[0] if int8 else p for p in (k_pages, v_pages))
    _, page, hkv, _ = kd.shape
    assert BLOCK % page == 0
    dp = 64 if d <= 64 else 128
    rep = h // hkv
    scale = float(np.float32(d ** -0.5))
    out = torch.zeros((c, h, d), dtype=torch.bfloat16)
    for a in range(start // BLOCK, (start + c - 1) // BLOCK + 1):
        q0 = a * BLOCK
        lo, hi = max(q0, start), min(q0 + BLOCK, start + n_valid)
        if lo >= hi:
            continue
        qt = torch.zeros((h, BLOCK, dp))
        qt[:, lo - q0:hi - q0] = _pad(q[lo - start:hi - start], dp).transpose(
            0, 1)

        def blocks(kb, last=hi - 1):
            t = kb * BLOCK + torch.arange(BLOCK)
            ok = t <= last
            row = block_row[torch.clamp(t // page, max=len(block_row) - 1)]
            pid, off = row.long(), t % page

            def rows(pool):   # [64, Hkv(, D)], zeros past the last key
                x = pool[pid, off].float()
                x = torch.where(ok.reshape(-1, *[1] * (x.dim() - 1)), x, 0.0)
                return x.repeat_interleave(rep, dim=1).transpose(0, 1)

            kb_, vb_ = (_pad(rows(x), dp) for x in (kd, vd))
            if not int8:
                return kb_, vb_, None, None
            return kb_, vb_, rows(k_pages[1]), rows(v_pages[1])

        tile = _tile(qt, blocks, a + 1, q0, scale)
        out[lo - start:hi - start] = tile[:, lo - q0:hi - q0, :d].transpose(
            0, 1)
    return out


def _inputs(seed, n_q, h, hkv, d, page, n_pages):
    rng = np.random.RandomState(seed)
    q, kp, vp = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .to(torch.bfloat16)
                 for shape in ((n_q, h, d), (n_pages, page, hkv, d),
                               (n_pages, page, hkv, d)))
    return q, kp, vp, rng


def _gate_ratio(got, ref):
    """Worst |err| / (two bf16 steps of |ref| + 1e-5)."""
    got, ref = got.float(), ref.float()
    step = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got - ref).abs() / (BF16_STEPS * step + F32_NOISE)).max())


CASES = [(1, 0, 16), (7, 5, 16), (16, 300, 16), (128, 0, 16),
         (128, 300, 16), (16, 992, 64), (5, 63, 1), (70, 60, 8), (64, 64, 32)]
HEADS = [(4, 4, 128), (4, 4, 112), (6, 2, 64), (4, 2, 16)]


@pytest.mark.parametrize("h,hkv,d", HEADS)
@pytest.mark.parametrize("c,start,page", CASES)
def test_chunk_schedule_is_the_one_shot_schedule(c, start, page, h, hkv, d):
    """Every valid chunk query equals the one-shot schedule's row at its
    position over the same keys, bit for bit; bucket padding (a chunk of c
    valid rows in a bucket of max(c, 16)) comes out 0."""
    n_keys = start + c
    pps = -(-n_keys // page) + 1
    n_pages = pps + 2
    rows = max(c, 16)
    q, kp, vp, rng = _inputs(c + start + d, rows, h, hkv, d, page, n_pages)
    block_row = torch.from_numpy(
        rng.permutation(n_pages - 1)[:pps] + 1).to(torch.int32)
    got = chunk(q, kp, vp, block_row, start, c)
    t = torch.arange(n_keys)
    pid, off = block_row[t // page].long(), t % page
    qs = torch.zeros((n_keys, h, d), dtype=torch.bfloat16)
    qs[start:] = q[:c]
    want = one_shot(qs, kp[pid, off], vp[pid, off])[start:]
    assert torch.equal(got[:c], want)
    assert not bool(got[c:].float().any())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("c,start,page", [(7, 5, 16), (128, 300, 16),
                                          (16, 100, 4)])
def test_chunk_schedule_within_the_gate_of_jax(c, start, page, kv):
    """The chunk schedule against the JAX package's paged_chunk_attention
    (float32 softmax over the dequantized rows) within two bf16 steps of
    the reference plus 1e-5, 8 heads on 2 kv heads at D 128."""
    h, hkv, d = 8, 2, 128
    pps = -(-(start + c) // page) + 1
    n_pages = pps + 2
    q, kp, vp, rng = _inputs(start + c, c, h, hkv, d, page, n_pages)
    block_row = torch.from_numpy(
        rng.permutation(n_pages - 1)[:pps] + 1).to(torch.int32)
    if kv == "int8":
        pools = []
        for x in (kp, vp):
            data = torch.from_numpy(rng.randint(-127, 128, x.shape)
                                    .astype(np.int8))
            scl = torch.from_numpy((rng.rand(*x.shape[:-1]) * 0.05 + 1e-3)
                                   .astype(np.float32))
            pools.append((data, scl))
        kp, vp = pools
        jk, jv = ((jnp.asarray(p[0].numpy()), jnp.asarray(p[1].numpy()))
                  for p in (kp, vp))
    else:
        jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (kp, vp))
    got = chunk(q, kp, vp, block_row, start, c)
    pos = start + np.arange(c, dtype=np.int32)[None]
    want = JA.paged_chunk_attention(
        jnp.asarray(q.float().numpy(), jnp.bfloat16)[None], jk, jv,
        jnp.asarray(block_row.numpy())[None], jnp.asarray(pos))[0]
    ref = torch.from_numpy(np.array(want.astype(jnp.float32)))
    ratio = _gate_ratio(got, ref)
    print(f"chunk schedule {kv} C {c} start {start} page {page}: worst "
          f"|err|/limit {ratio:.3f}")
    assert ratio <= 1.0
