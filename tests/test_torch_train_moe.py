"""The gradient of the moe family's grouped product on the CPU: the port's
plain dX and dW (``kernels/grouped_gemm/ref.py``) and ``GroupedGemmF32``
against ``jax.vjp`` of ``jax.lax.ragged_dot`` in float32, and a rehearsal
of ``csrc/grouped_gemm_f32.cu``'s schedules, which only a card runs.

Tolerance: the port and JAX sum the same float32 products in other orders,
so each output is held within 1e-5 (|a| @ |b|) of JAX's, the sum of the
magnitudes of its products (an output whose products are all 0 is 0 in
both).

The rehearsal writes out, in numpy, how the kernels find their work: the
forward's and dX's 64-row tiles of one expert (the group sizes scanned 32
at a time, saturating at R; the zero tiles past the groups' sum; the
static grid bound), and dW's grid of (N tile, K tile, expert) CTAs, each
walking its expert's rows in steps of 32, ascending.  Every output is
produced once, in the stated order, an expert without rows is written
(zeros), and planted mutations of the walk must fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401  (autouse)
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.grouped_gemm.ops import GroupedGemmF32
from repro_torch.kernels.grouped_gemm.ref import (grouped_gemm_dw_ref,
                                                  grouped_gemm_dx_ref,
                                                  grouped_gemm_ref)
from repro_torch.training.train_loop import NO_BACKWARD, check_trainable

REL = 1e-5
K, N = 24, 40

# group sizes [E] and rows past their sum
CASES = {
    "normal routing": ([9, 14, 7, 12, 8, 11, 10, 9], 0),
    "empty experts": ([0, 17, 0, 0, 30, 1, 0, 12], 0),
    "rows past the sum": ([6, 0, 11, 4, 0, 9, 3, 0], 23),
    "one expert takes every row": ([0, 0, 0, 0, 0, 64, 0, 0], 0),
}


def _inputs(sizes, tail, seed):
    rng = np.random.RandomState(seed)
    r = sum(sizes) + tail
    x = rng.standard_normal((r, K)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), K, N)) / np.sqrt(K)).astype(
        np.float32)
    dy = rng.standard_normal((r, N)).astype(np.float32)
    return x, w, dy, np.array(sizes, np.int32)


def _jax_vjp(x, w, dy, gs):
    out, vjp = jax.vjp(
        lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(gs)),
        jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dy))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX run per case: inputs and (out, dx, dw) of ragged_dot's
    vjp."""
    runs = {}
    for i, (name, (sizes, tail)) in enumerate(sorted(CASES.items())):
        x, w, dy, gs = _inputs(sizes, tail, 11 + i)
        runs[name] = ((x, w, dy, gs), _jax_vjp(x, w, dy, gs))
    return runs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, mag):
    got, want, mag = (np.asarray(a, np.float64) for a in (got, want, mag))
    err = np.abs(got - want)
    assert (err <= REL * mag).all(), float((err - REL * mag).max())


def _mags(x, w, dy, gs):
    """|x| @ |W|, |dy| @ |W|^T and |x|^T @ |dy| of each output (float64)."""
    xa, wa, dya = (_t(np.abs(a)).double() for a in (x, w, dy))
    g = _t(gs)
    return (grouped_gemm_ref(xa, wa, g), grouped_gemm_dx_ref(dya, wa, g),
            grouped_gemm_dw_ref(xa, dya, g))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gradient_matches_jax_vjp(jax_runs, case):
    (x, w, dy, gs), (_, jdx, jdw) = jax_runs[case]
    _, mdx, mdw = _mags(x, w, dy, gs)
    dx = grouped_gemm_dx_ref(_t(dy), _t(w), _t(gs))
    dw = grouped_gemm_dw_ref(_t(x), _t(dy), _t(gs))
    assert dx.dtype == dw.dtype == torch.float32
    _close(dx, jdx, mdx)
    _close(dw, jdw, mdw)
    covered = int(gs.sum())
    assert not dx[covered:].any()
    for e in np.flatnonzero(gs == 0):
        assert not dw[e].any()


@pytest.mark.parametrize("case", sorted(CASES) + ["clamped sizes"])
def test_plain_gradient_matches_autograd_of_the_plain_forward(case):
    if case == "clamped sizes":      # -3 is 0; 50 takes the 20 rows left
        x, w, dy, _ = _inputs([5, 0, 11, 20, 0], 0, 3)
        gs = np.array([5, -3, 11, 50, 9], np.int32)
    else:
        x, w, dy, gs = _inputs(*CASES[case], 5)
    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    want_dx, want_dw = torch.autograd.grad(
        grouped_gemm_ref(xt, wt, _t(gs)), (xt, wt), _t(dy))
    _, mdx, mdw = _mags(x, w, dy, gs)
    _close(grouped_gemm_dx_ref(_t(dy), _t(w), _t(gs)), want_dx, mdx)
    _close(grouped_gemm_dw_ref(_t(x), _t(dy), _t(gs)), want_dw, mdw)


def test_dw_ref_experts_past_the_group_sizes_are_zero():
    x, w, dy, gs = _inputs([4, 0, 6], 2, 8)
    dw = grouped_gemm_dw_ref(_t(x), _t(dy), _t(gs), e=5)
    assert dw.shape == (5, K, N)
    assert torch.equal(dw[:3], grouped_gemm_dw_ref(_t(x), _t(dy), _t(gs)))
    assert not dw[3:].any()


@pytest.mark.parametrize("grads", ["x and w", "w only", "x only"])
def test_grouped_gemm_f32_function_on_cpu_matches_jax(jax_runs, grads):
    """GroupedGemmF32 on CPU tensors (the plain versions) against JAX's
    vjp; an input that needs no gradient gets None and runs no kernel."""
    (x, w, dy, gs), (jout, jdx, jdw) = jax_runs["rows past the sum"]
    mout, mdx, mdw = _mags(x, w, dy, gs)
    xt = _t(x).requires_grad_(grads != "w only")
    wt = _t(w).requires_grad_(grads != "x only")
    out = GroupedGemmF32.apply(xt, wt, _t(gs))
    _close(out.detach(), jout, mout)
    want = [t for t in (xt, wt) if t.requires_grad]
    got = torch.autograd.grad(out, want, _t(dy))
    for g, t in zip(got, want):
        if t is xt:
            _close(g, jdx, mdx)
        else:
            _close(g, jdw, mdw)


# --------------------------------------------------------------- rehearsal

BM = BN = 64     # grouped_gemm_f32.cu's kBM, kBN
BK = 32          # its kBK: reduction steps of a stage


def scan_rows(gs, R):
    """Every expert's rows [begin, end) as the kernels' warp scans find
    them: sizes clamped to [0, R], prefix sums saturating at R."""
    ends = np.minimum(np.cumsum(np.clip(np.asarray(gs, np.int64), 0, R)), R)
    begins = np.concatenate([[0], ends[:-1]])
    return begins, ends


def row_tiles(R, E):
    """The forward's and dX's grid bound (``row_tiles``)."""
    return -(-R // BM) + min(E, R) + 1


def find_row_tile(gs, R, y):
    """(expert or -1, first row, end row) of row tile y."""
    begins, ends = scan_rows(gs, R)
    t = 0
    for e, (b, en) in enumerate(zip(begins, ends)):
        tiles = -(-(en - b) // BM)
        if t <= y < t + tiles:
            return e, b + (y - t) * BM, en
        t += tiles
    return -1, int(ends[-1]) + (y - t) * BM, R


def dw_walk(gs, R, K_, N_, mutation=None):
    """dW's grid as the kernel runs it: CTA (N tile, K tile, expert) ->
    the rows it reads, in order ([] for an expert without rows)."""
    begins, ends = scan_rows(gs, R)
    if mutation == "inclusive prefix":    # the expert's end taken as begin
        begins = ends.copy()
    walks = {}
    for e in range(len(gs)):
        if mutation == "empty experts skipped" and ends[e] == begins[e]:
            continue
        for kt in range(-(-K_ // BM)):
            for nt in range(-(-N_ // BN)):
                rows = []
                stop = ends[e] - (1 if mutation == "last row dropped" else 0)
                for k0 in range(begins[e], stop, BK):
                    step = list(range(k0, min(k0 + BK, stop)))
                    if mutation == "steps reversed":
                        step = step[::-1]
                    rows += step
                walks[(nt, kt, e)] = rows
    return walks


def dw_from_walk(walks, x, dy, E):
    """dw as the CTAs would store it: one float32 accumulator an output,
    one product added a row in the walk's order; unwritten outputs NaN."""
    K_, N_ = x.shape[1], dy.shape[1]
    dw = np.full((E, K_, N_), np.nan, np.float32)
    for (nt, kt, e), rows in walks.items():
        ks = slice(kt * BM, min((kt + 1) * BM, K_))
        ns = slice(nt * BN, min((nt + 1) * BN, N_))
        acc = np.zeros((ks.stop - ks.start, ns.stop - ns.start), np.float32)
        for r in rows:
            acc = acc + np.outer(x[r, ks], dy[r, ns]).astype(np.float32)
        dw[e, ks, ns] = acc
    return dw


WALK_CASES = {
    "real routing": (None, 0),
    "empty experts and rows past the sum":
        ([0, 70, 0, 0, 33, 1, 0, 129], 17),
    "one expert": ([0] * 5 + [200] + [0] * 2, 0),
    "clamped": ([5, -3, 70, 10 ** 6, 9, 0, 0, 0], 0),
}


def _walk_case(case):
    sizes, tail = WALK_CASES[case]
    if sizes is None:
        rng = np.random.RandomState(2)
        sizes = list(rng.multinomial(300, [1 / 6] * 6)) + [0, 0]
    R = int(np.clip(sizes, 0, None).sum()) + tail
    if case == "clamped":
        R = 150
    return np.array(sizes, np.int64), R


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_dw_grid_walks_each_experts_rows_once_in_order(case):
    gs, R = _walk_case(case)
    K_, N_ = 136, 72                       # ragged K and N tiles
    begins, ends = scan_rows(gs, R)
    walks = dw_walk(gs, R, K_, N_)
    grid = [(nt, kt, e) for e in range(len(gs))
            for kt in range(-(-K_ // BM)) for nt in range(-(-N_ // BN))]
    assert sorted(walks) == sorted(grid)   # every CTA once, empties too
    for (_, _, e), rows in walks.items():
        assert rows == list(range(begins[e], ends[e]))
    # every row of the sum belongs to exactly one expert's walk
    owner = np.concatenate([np.full(ends[e] - begins[e], e)
                            for e in range(len(gs))])
    assert len(owner) == min(int(np.clip(gs, 0, None).sum()), R)
    rng = np.random.RandomState(4)
    x = rng.standard_normal((R, K_)).astype(np.float32)
    dy = rng.standard_normal((R, N_)).astype(np.float32)
    got = dw_from_walk(walks, x, dy, len(gs))
    want = grouped_gemm_dw_ref(_t(x), _t(dy), _t(gs.astype(np.int32)))
    mag = grouped_gemm_dw_ref(_t(np.abs(x)).double(), _t(np.abs(dy)).double(),
                              _t(gs.astype(np.int32)))
    _close(got, want, mag)
    for e in range(len(gs)):
        if ends[e] == begins[e]:
            assert (got[e] == 0).all()


@pytest.mark.parametrize("mutation", ["inclusive prefix", "last row dropped",
                                      "empty experts skipped",
                                      "steps reversed"])
def test_dw_rehearsal_catches_a_planted_mutation(mutation):
    """Each mutation of the walk fails the rehearsal's checks: coverage,
    the rows in ascending order, the empty experts written, or dW."""
    gs, R = _walk_case("empty experts and rows past the sum")
    K_, N_ = 136, 72
    begins, ends = scan_rows(gs, R)
    walks = dw_walk(gs, R, K_, N_, mutation)
    rng = np.random.RandomState(4)
    x = rng.standard_normal((R, K_)).astype(np.float32)
    dy = rng.standard_normal((R, N_)).astype(np.float32)
    got = dw_from_walk(walks, x, dy, len(gs))
    want = grouped_gemm_dw_ref(_t(x), _t(dy),
                               _t(gs.astype(np.int32))).numpy()
    caught = (len(walks) != len(gs) * 3 * 2
              or any(rows != list(range(begins[e], ends[e]))
                     for (_, _, e), rows in walks.items())
              or not np.allclose(got, want, rtol=0, atol=1e-4))
    assert caught, mutation


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_forward_tiles_cover_every_row_once(case):
    """The forward's and dX's row tiles: each row below the sum in one
    tile of its own expert (64 rows from the expert's first), the zero
    tiles covering the rest, all inside the static grid bound."""
    gs, R = _walk_case(case)
    begins, ends = scan_rows(gs, R)
    covered = np.zeros(R, np.int64)
    zeros = np.zeros(R, np.int64)
    for y in range(row_tiles(R, len(gs))):
        e, row0, end = find_row_tile(gs, R, y)
        if row0 >= R:
            continue                       # a CTA past the schedule exits
        rows = slice(row0, min(row0 + BM, end))
        if e < 0:
            zeros[rows] += 1
        else:
            assert begins[e] <= row0 < ends[e] == end
            assert (row0 - begins[e]) % BM == 0
            covered[rows] += 1
    total = int(ends[-1])
    assert (covered[:total] == 1).all() and not covered[total:].any()
    assert (zeros[total:] == 1).all() and not zeros[:total].any()


# ------------------------------------------------------------ the trainer


def test_moe_trains_on_the_card_and_the_rest_still_refuse():
    """check_trainable lets the moe family through on CUDA (the float32
    grouped GEMM has its dX and dW); mla_moe, hybrid, ssm and audio still
    raise, naming what they lack."""
    cuda = torch.device("cuda")
    check_trainable(get_arch("qwen2-moe-a2.7b"), cuda)
    assert "moe" not in NO_BACKWARD
    for arch, lacks in (("deepseek-v2-lite-16b", "head dim 192"),
                        ("zamba2-7b", "B6"), ("mamba2-130m", "B6"),
                        ("whisper-small", "bidirectional")):
        with pytest.raises(NotImplementedError, match=lacks):
            check_trainable(get_arch(arch), cuda)
    assert "grouped GEMM" not in NO_BACKWARD["mla_moe"]
