"""CPU rehearsal of the grouped GEMM's Hopper kernel
(``csrc/grouped_gemm.cu``, the moe family's ``jax.lax.ragged_dot``), which
only a card runs.

* The tile scheduler, written out as the kernel walks it: the group sizes
  32 at a time through two warp scans (rows saturating at R, row tiles of
  128), a ballot for the tile's expert, the zero tiles past the groups'
  sum.  Every row below the sum is computed exactly once per column tile
  and stored by a warpgroup of its own expert, no tile crosses an expert,
  the zero tiles cover the rows past the sum, the tiles fit the static
  grid bound, and the clamped sizes match the plain version's.
* The summation order: one float32 accumulator per output over K in
  ascending k16 steps (each step's 16 bf16 products exact, one rounding a
  step: the model of a wgmma step used here), through the tile schedule
  with other experts' and zero rows beside each row, bit-equal to the same
  order row by row, and within chip_smoke.py's GG_TOL of
  ``jax.lax.ragged_dot`` on the CPU.
* The rings' protocol, as the producers and the consumer warpgroups run
  it (W: 8 stages waited on by every consumer warpgroup; x: 11 boxes, one
  per warpgroup with rows and slice, waited on by that warpgroup only;
  mbarrier parity waits; the consumers meeting after each slice's waits),
  with TMA landings in random order: no wait passes on a stale phase and
  nothing deadlocks; without the meeting a wait passes on a stale phase,
  and with a ring of fewer than two slices' boxes the pipeline deadlocks.
* The shared-memory layout and the accumulator mapping, lane by lane: x
  and W written as TMA writes 128-byte swizzled boxes, read back through
  the kernel's wgmma descriptors (x K-major, W MN-major: transposed B),
  the accumulators stored by the epilogue's formula, each against the
  exact product of small integers, with one planted mutation each that
  must fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

BM, CONSUMERS, BN, BK = 64, 3, 128, 64   # grouped_gemm.cu's tile constants
ROW_TILE = BM * CONSUMERS
BOX = 64 * 128                            # bytes of one TMA box
X_BOXES, W_STAGES = 11, 8                 # the x and W rings
GG_ULPS, GG_REL = 2, 1e-5                 # chip_smoke.py's GG_TOL


# --------------------------------------------------------------- scheduler


def _scan(v, op):
    """Hillis-Steele inclusive scan over 32 lanes, as the shuffles do."""
    v = list(v)
    d = 1
    while d < 32:
        v = [op(v[i], v[i - d]) if i >= d else v[i] for i in range(32)]
        d *= 2
    return v


def scan_chunk(gs, R, e0, start, t):
    """The kernel's ``scan_chunk``: per lane (begin, end, first tile,
    tiles) of experts e0..e0+31, and the rows / tiles after the chunk."""
    E = len(gs)
    a = [min(max(int(gs[e0 + i]), 0), R) if e0 + i < E else 0
         for i in range(32)]
    p = _scan(a, lambda x, y: min(x + y, R))
    q = [0] + p[:31]
    begin = [min(start + v, R) for v in q]
    end = [min(start + v, R) for v in p]
    tiles = [-(-(e - b) // ROW_TILE) for b, e in zip(begin, end)]
    s = _scan(tiles, lambda x, y: x + y)
    first = [t + si - ti for si, ti in zip(s, tiles)]
    return begin, end, first, tiles, end[31], t + s[31]


def count_row_tiles(gs, R):
    start = t = 0
    for e0 in range(0, len(gs), 32):
        *_, start, t = scan_chunk(gs, R, e0, start, t)
    return t + -(-(R - start) // ROW_TILE)


def find_row_tile(gs, R, y):
    """(expert or -1, first row, the expert's end row) of row tile y."""
    start = t = 0
    for e0 in range(0, len(gs), 32):
        begin, end, first, tiles, nstart, nt = scan_chunk(gs, R, e0, start, t)
        hit = [i for i in range(32) if first[i] <= y < first[i] + tiles[i]]
        if hit:
            i = hit[0]                     # __ffs of the ballot
            return e0 + i, begin[i] + (y - first[i]) * ROW_TILE, end[i]
        start, t = nstart, nt
    return -1, start + (y - t) * ROW_TILE, R


def grid_bound(R, E, N):
    """The launch's static tile bound (``row_tiles`` x column tiles)."""
    return -(-N // BN) * (-(-R // ROW_TILE) + min(E, R) + 1)


def schedule(gs, R, N):
    """Every output tile, in the kernel's numbering (columns fastest):
    (expert, row0, end, n0, live warpgroups)."""
    col_tiles = -(-N // BN)
    out = []
    for tile in range(count_row_tiles(gs, R) * col_tiles):
        e, row0, end = find_row_tile(gs, R, tile // col_tiles)
        live = 0 if e < 0 else min(CONSUMERS, -(-(end - row0) // BM))
        out.append((e, row0, end, (tile % col_tiles) * BN, live))
    return out


def _clamped_ranges(gs, R):
    """Each expert's rows as the plain version (ref.py) clamps them."""
    ranges, start = [], 0
    for g in gs:
        g = min(max(int(g), 0), R - start)
        ranges.append((start, start + g))
        start += g
    return ranges, start


SCHEDULES = {
    "edges": ([0, 1, 63, 64, 65, 136, 0, 127, 128, 129] + [0] * 54, 40),
    "real routing": (None, 0),
    "one expert": ([0] * 17 + [300] + [0] * 46, 0),
    "decode": ([1] * 16 + [0] * 48, 3),
    "clamped": ([5, -3, 70, 10 ** 6, 9] + [0] * 59, 0),
    "E 100": ([3, 0, 129] * 33 + [64], 17),
    "E 8": ([0, 200, 0, 0, 1, 64, 0, 63], 128),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_tile_schedule_covers_every_row_once(case):
    sizes, tail = SCHEDULES[case]
    if sizes is None:                       # ~136 rows an expert, 60 of 64
        rng = np.random.RandomState(5)
        sizes = list(rng.multinomial(8192, [1 / 60] * 60)) + [0] * 4
    gs = np.array(sizes, np.int64)
    R = int(np.clip(gs, 0, None).sum()) + tail
    if case == "clamped":
        R = 200                             # the huge group takes the rest
    N = 1408 if case != "E 8" else 72
    ranges, total = _clamped_ranges(gs, R)
    sched = schedule(gs, R, N)
    assert len(sched) <= grid_bound(R, len(gs), N)
    stored = np.zeros((R, -(-N // BN)), np.int64)     # rows written
    zeros = np.zeros_like(stored)
    for e, row0, end, n0, live in sched:
        c = n0 // BN
        if e < 0:                           # zero tile: both warpgroups
            assert row0 >= total and end == R
            zeros[row0:min(row0 + ROW_TILE, R), c] += 1
            continue
        b, en = ranges[e]
        assert b <= row0 < en and end == en
        assert (row0 - b) % ROW_TILE == 0   # tiles from the expert's start
        for w in range(live):
            lo = row0 + w * BM
            assert lo < end                 # a live warpgroup has rows
            stored[lo:min(lo + BM, end), c] += 1
        if live < CONSUMERS:                # an idle warpgroup has no rows
            assert row0 + live * BM >= end
    assert (stored[:total] == 1).all() and not stored[total:].any()
    assert (zeros[total:] == 1).all() and not zeros[:total].any()


def test_tile_schedule_numbers_an_experts_tiles_together():
    """An expert's tiles are consecutive in the numbering, columns
    fastest, so CTAs in flight share its weights."""
    gs = [0, 136, 0, 300, 1] + [0] * 59
    sched = schedule(np.array(gs), 437, 1408)
    experts = [s[0] for s in sched]
    seen = []
    for e in experts:
        if not seen or seen[-1] != e:
            assert e not in seen
            seen.append(e)
    assert seen == [1, 3, 4]
    assert [s[3] for s in sched[:11]] == [BN * i for i in range(11)]


# ---------------------------------------------------- the summation order


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def k16_order(xr, w):
    """One float32 accumulator per output over K in ascending k16 steps,
    each step's 16 products summed exactly and added with one rounding:
    xr [M, K], w [K, N] (bf16 values) -> float32 [M, N]."""
    m, k = xr.shape
    acc = np.zeros((m, w.shape[1]), np.float32)
    for k0 in range(0, k, 16):
        step = xr[:, k0:k0 + 16].astype(np.float64) @ \
            w[k0:k0 + 16].astype(np.float64)
        acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def kernel_emulate(x, w, gs):
    """The kernel through its schedule: each live warpgroup's 64 rows from
    its tile's first row (zero past R, other experts' rows included),
    K padded with zeros to a multiple of 64, rows stored below the
    expert's end, zero tiles past the sum; bf16 [R, N] as float32."""
    R, K = x.shape
    N = w.shape[2]
    kp = -(-K // BK) * BK
    xp = np.zeros((R + ROW_TILE, kp), np.float32)
    xp[:R, :K] = x
    wp = np.zeros((w.shape[0], kp, -(-N // BN) * BN), np.float32)
    wp[:, :K, :N] = w
    out = np.full((R, N), np.nan, np.float32)
    for e, row0, end, n0, live in schedule(gs, R, N):
        for wg in range(CONSUMERS):
            lo = row0 + wg * BM
            if e < 0:
                out[lo:min(lo + BM, R), n0:n0 + BN] = 0
                continue
            if wg >= live:
                continue
            acc = k16_order(xp[lo:lo + BM], wp[e, :, n0:n0 + BN])
            hi = min(lo + BM, end)
            cols = min(BN, N - n0)
            out[lo:hi, n0:n0 + cols] = _bf16(acc[:hi - lo, :cols])
    return out


@pytest.mark.parametrize("k,n", [(2048, 24), (1408, 40), (96, 136)])
def test_summation_order_vs_ragged_dot(k, n):
    """The kernel's order, through the schedule, equals the order row by
    row bit for bit (a row's bits do not depend on its tile), rows past
    the sum come out 0, and it lies within GG_TOL of JAX's ragged_dot."""
    rng = np.random.RandomState(k + n)
    sizes = [0, 1, 63, 64, 65, 0, 136, 2] + [0] * 8
    R = sum(sizes) + 9
    x = _bf16(rng.randn(R, k))
    w = _bf16(rng.randn(len(sizes), k, n) / np.sqrt(k))
    gs = np.array(sizes, np.int32)
    got = kernel_emulate(x, w, gs)
    e_of = np.repeat(np.arange(len(sizes)), sizes)
    total = len(e_of)
    for r in range(total):
        alone = _bf16(k16_order(x[r:r + 1], w[e_of[r]]))[0]
        np.testing.assert_array_equal(got[r], alone)
    assert not got[total:].any()
    want = np.asarray(jax.lax.ragged_dot(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(gs)).astype(jnp.float32))
    mag = np.stack([np.abs(x[r]) @ np.abs(w[e_of[r]]) for r in range(total)])
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want[:total]),
                                               2.0 ** -126))) - 7)
    err = np.abs(got[:total] - want[:total])
    assert (err <= GG_ULPS * step + GG_REL * mag).all()
    assert not want[total:].any()


# ------------------------------------------------------- the rings' protocol


class _Bar:
    """An mbarrier: phases completed; ``count`` arrivals complete one."""

    def __init__(self, count=1):
        self.count, self.done, self.arrived = count, 0, 0

    def arrive(self, n=1):
        self.arrived += n
        if self.arrived == self.count:
            self.arrived, self.done = 0, self.done + 1

    def passes(self, parity):
        """try_wait.parity: passes unless the current phase has ``parity``."""
        return self.done % 2 != parity


def run_rings(tiles, nk, rng, x_boxes=X_BOXES, meet=True):
    """The kernel's ring protocol for one CTA over ``tiles`` (the live
    warpgroups of each tile, 0 for a zero tile) of ``nk`` slices, agents
    stepped in random order and TMA landings delayed at random.  Returns
    "ok", "stale" (a consumer wait passed on an earlier phase than its
    use) or "deadlock"."""
    xfull = [_Bar() for _ in range(x_boxes)]
    xempty = [_Bar(1) for _ in range(x_boxes)]       # the reading warpgroup
    wfull = [_Bar() for _ in range(W_STAGES)]
    wempty = [_Bar(CONSUMERS) for _ in range(W_STAGES)]  # every warpgroup
    ops = {"pw": [], "px": []}
    for wg in range(CONSUMERS):
        ops[wg] = []
    it = xb = 0
    for live in tiles:
        if not live:
            continue
        for kt in range(nk):
            j = it + kt
            ops["pw"].append(("wait", wempty[j % W_STAGES],
                              (j // W_STAGES) % 2 ^ 1, None))
            ops["pw"].append(("load", wfull[j % W_STAGES]))
            for w in range(live):
                g = xb + kt * live + w
                ops["px"].append(("wait", xempty[g % x_boxes],
                                  (g // x_boxes) % 2 ^ 1, None))
                ops["px"].append(("load", xfull[g % x_boxes]))
            for wg in range(CONSUMERS):
                q = ops[wg]
                q.append(("wait", wfull[j % W_STAGES], (j // W_STAGES) % 2,
                          j // W_STAGES + 1))
                g = xb + kt * live + wg
                if wg < live:
                    q.append(("wait", xfull[g % x_boxes], (g // x_boxes) % 2,
                              g // x_boxes + 1))
                if meet:
                    q.append(("meet", (it, kt)))
                if wg >= live:
                    q.append(("arrive", wempty[j % W_STAGES]))
                elif kt > 0:
                    q += [("arrive", wempty[(j - 1) % W_STAGES]),
                          ("arrive", xempty[(g - live) % x_boxes])]
        for wg in range(live):
            g = xb + (nk - 1) * live + wg
            ops[wg] += [("arrive", wempty[(it + nk - 1) % W_STAGES]),
                        ("arrive", xempty[g % x_boxes])]
        it += nk
        xb += nk * live
    pos = {a: 0 for a in ops}
    flights, met = [], {}      # [rounds left, barrier] of the loads in flight
    while True:
        moved = bool(flights)
        for f in flights:
            f[0] -= 1
        for f in [f for f in flights if f[0] <= 0]:
            flights.remove(f)
            f[1].arrive()
        agents = list(ops)
        rng.shuffle(agents)
        for a in agents:
            if pos[a] == len(ops[a]):
                continue
            op = ops[a][pos[a]]
            if op[0] == "wait":
                if not op[1].passes(op[2]):
                    continue
                if op[3] is not None and op[1].done != op[3]:
                    return "stale"
            elif op[0] == "load":     # now and then a straggler
                flights.append([rng.randint(1, 4) if rng.rand() < 0.9
                                else rng.randint(20, 60), op[1]])
            elif op[0] == "arrive":
                op[1].arrive()
            elif op[0] == "meet":
                met.setdefault(op[1], set()).add(a)
                if len(met[op[1]]) < CONSUMERS:
                    continue
            pos[a] += 1
            moved = True
        if all(pos[a] == len(ops[a]) for a in ops):
            return "ok"
        if not moved and not flights:
            return "deadlock"


TILE_MIXES = [[1] * 6, [3, 3, 3], [3, 1, 0, 2, 3, 1, 1], [2, 0, 3, 1]]


@pytest.mark.parametrize("mix", range(len(TILE_MIXES)))
def test_rings_protocol_holds(mix):
    """Decode (one live warpgroup), prefill (three), mixes with zero tiles
    and short slices: every run ends, no wait passes on a stale phase."""
    for seed in range(6):
        rng = np.random.RandomState(100 * mix + seed)
        assert run_rings(TILE_MIXES[mix], 5, rng) == "ok"


def test_rings_protocol_mutations_fail():
    """Without the consumers' meeting a warpgroup waits on a box two phases
    on; with an x ring of fewer than two slices' boxes it deadlocks."""
    results = {run_rings([3, 1, 1, 3, 1, 3], 6, np.random.RandomState(s),
                         meet=False) for s in range(40)}
    assert "stale" in results
    assert run_rings([3, 3], 4, np.random.RandomState(0),
                     x_boxes=2 * CONSUMERS - 1) == "deadlock"


# ------------------------------------- shared-memory layout, accumulators


def swizzle(addr):
    """The 128-byte swizzle: 16-byte chunk bits [4:6] XOR row bits [7:9]."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_write(smem, base, box):
    """TMA's write of a box [rows, 64] of bf16 values at ``base`` (1,024-
    byte aligned), element (r, c) at byte r * 128 + 2 c, swizzled."""
    rows = box.shape[0]
    r, c = np.meshgrid(np.arange(rows), np.arange(64), indexing="ij")
    smem[swizzle(base + r * 128 + 2 * c) // 2] = box


def desc_sw128(saddr, lbo, sbo):
    """hopper.cuh's desc_sw128, bit for bit."""
    d = (saddr >> 4) & 0x3FFF
    d |= ((lbo >> 4) & 0x3FFF) << 16
    d |= ((sbo >> 4) & 0x3FFF) << 32
    return d | (1 << 62)


def _fields(desc):
    assert desc >> 62 == 1                   # 128-byte swizzle
    return ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4,
            ((desc >> 32) & 0x3FFF) << 4)


def read_a_kmajor(smem, desc):
    """A [64, 16] as wgmma reads a K-major 128-byte swizzled operand:
    (m, k) at start + (m / 8) SBO + (m % 8) 128 + 2 k, swizzled."""
    start, _lbo, sbo = _fields(desc)
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    return smem[swizzle(start + (m // 8) * sbo + (m % 8) * 128 + 2 * k) // 2]


def read_b_mnmajor(smem, desc, n=128):
    """B [16, n] as wgmma reads an MN-major (transposed) 128-byte swizzled
    operand: (k, c) at start + (c / 64) LBO + (k / 8) SBO + (k % 8) 128
    + 2 (c % 64), swizzled."""
    start, lbo, sbo = _fields(desc)
    k, c = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    addr = start + (c // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 + \
        2 * (c % 64)
    return smem[swizzle(addr) // 2]


def acc_to_tile(acc, mutate=False):
    """The epilogue: thread t (warp t / 32, lane l) stores acc[4j + 2h]
    and acc[4j + 2h + 1] at row 16 warp + l / 4 + 8 h, columns 8j +
    2 (l % 4) + {0, 1}.  ``mutate`` swaps the two halves' rows."""
    out = np.full((64, acc.shape[1] * 2), np.nan)
    for t in range(128):
        warp, lane = divmod(t, 32)
        for j in range(acc.shape[1] // 4):
            for h in range(2):
                hh = 1 - h if mutate else h
                row = 16 * warp + lane // 4 + 8 * hh
                col = 8 * j + 2 * (lane % 4)
                out[row, col:col + 2] = acc[t, 4 * j + 2 * h:4 * j + 2 * h + 2]
    return out


def wgmma_emulate(a, b, acc):
    """m64n128k16 for a warpgroup: D = A B added to the accumulators in the
    hopper.cuh layout (thread t, warp w, lane l: d[4j + {0, 1}] at row
    16w + l/4, columns 8j + 2(l%4) + {0, 1}; d[4j + {2, 3}] 8 rows on)."""
    d = a.astype(np.float64) @ b.astype(np.float64)
    for t in range(128):
        warp, lane = divmod(t, 32)
        r = 16 * warp + lane // 4
        for j in range(d.shape[1] // 8):
            c = 8 * j + 2 * (lane % 4)
            acc[t, 4 * j:4 * j + 4] += [d[r, c], d[r, c + 1], d[r + 8, c],
                                        d[r + 8, c + 1]]


def warpgroup_tile(x, w, wg, row0, n0, lbo_sbo=(BOX, 1024), mutate_acc=False):
    """One consumer warpgroup's 64 x 128 outputs, slice by slice as the
    kernel loads and issues: per 64-element K slice the producer's boxes
    (x rows from row0 + 64 wg, W's two 64-column boxes) written into a
    stage, four wgmma steps through the kernel's descriptors, then the
    epilogue's mapping."""
    R, K = x.shape
    N = w.shape[1]
    smem = np.zeros((CONSUMERS + 2) * BOX // 2, np.float64)
    acc = np.zeros((128, BN // 2))
    base = 0
    for k0 in range(0, K, BK):
        boxes = []
        for c in range(CONSUMERS):
            box = np.zeros((64, 64))
            rows = x[row0 + c * BM:row0 + (c + 1) * BM, k0:k0 + BK]
            box[:rows.shape[0], :rows.shape[1]] = rows
            boxes.append(box)
        for c in range(2):
            box = np.zeros((64, 64))
            blk = w[k0:k0 + BK, n0 + 64 * c:n0 + 64 * (c + 1)]
            box[:blk.shape[0], :blk.shape[1]] = blk
            boxes.append(box)
        for i, box in enumerate(boxes):
            tma_write(smem, base + i * BOX, box)
        xa, wa = base + wg * BOX, base + CONSUMERS * BOX
        for kk in range(BK // 16):
            a = read_a_kmajor(smem, desc_sw128(xa + kk * 32, 16, 1024))
            b = read_b_mnmajor(smem, desc_sw128(wa + kk * 16 * 128, *lbo_sbo))
            wgmma_emulate(a, b, acc)
    return acc_to_tile(acc, mutate_acc)


def _int_case(rng, r, k, n):
    return (rng.randint(-3, 4, (r, k)).astype(np.float64),
            rng.randint(-3, 4, (k, n)).astype(np.float64))


@pytest.mark.parametrize("wg", range(CONSUMERS))
def test_layout_and_accumulators_give_the_exact_product(wg):
    """Every warpgroup of a tile at row 37 (not 64-aligned) and column 128,
    K 192 (three slices): every output equals the exact product."""
    rng = np.random.RandomState(wg)
    x, w = _int_case(rng, 37 + ROW_TILE, 192, 256)
    row0, n0 = 37, 128
    got = warpgroup_tile(x, w, wg, row0, n0)
    lo = row0 + wg * BM
    want = x[lo:lo + BM] @ w[:, n0:n0 + BN]
    np.testing.assert_array_equal(got, want)


def test_layout_mutation_fails():
    """W's descriptor with the leading and stride offsets swapped (the
    column-block and 8-row strides exchanged) must not give the product."""
    rng = np.random.RandomState(7)
    x, w = _int_case(rng, 64, 64, 128)
    got = warpgroup_tile(x, w, 0, 0, 0, lbo_sbo=(1024, BOX))
    assert not np.array_equal(got, x @ w)


def test_accumulator_mutation_fails():
    """The epilogue with a thread's two rows exchanged must not give the
    product."""
    rng = np.random.RandomState(8)
    x, w = _int_case(rng, 64, 64, 128)
    got = warpgroup_tile(x, w, 0, 0, 0, mutate_acc=True)
    assert not np.array_equal(got, x @ w)


def test_the_edges_of_x_and_w_are_zero_filled():
    """A tile that runs past R and past N (N 72, one partial W box): the
    rows past R and the columns past N read zeros, the rest is exact."""
    rng = np.random.RandomState(9)
    x, w = _int_case(rng, 50, 64, 72)
    got = warpgroup_tile(x, w, 0, 10, 0)
    want = np.zeros((64, BN))
    want[:40, :72] = x[10:50] @ w
    np.testing.assert_array_equal(got, want)
