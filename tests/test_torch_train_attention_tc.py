"""CPU rehearsal of the float32 attention backward on the tensor cores
(``csrc/flash_attention_f32.cu``: dK/dV and dQ in 3xTF32 on mma.sync
m16n8k8), which only a card runs.

* The arithmetic: each operand split as big = TF32(x) (round to nearest,
  ties away, 10 mantissa bits, through the int32 view, as the kernel does
  it on the integer pipe: ``cvt.rna.tf32``'s bits) and small = x - big,
  whose low 13 bits the tensor cores drop; a product a_small b_big + a_big
  b_small + a_big b_big summed in float32.  Every matrix product of the
  backward's schedule (``kernels/flash_attention/ref.py``) runs through
  that emulation while the forward stays float32, and dq / dk / dv hold
  the 1e-5 x max|ref| gate against float64 autograd at the CASES of
  ``test_torch_train_attention.py``; one-term TF32 (big . big) misses it.
  (The mma's own accumulator, which truncates, is not emulated: the kernel
  sums each 3xTF32 product into zeroed registers and adds it with a
  rounded float32 add.)
* The schedule: the group's heads dealt to the cluster's ranks and summed
  in rank order, against one CTA walking every head, within 1e-5 (1e-12
  in float64); the cluster's partition of the partial tiles.
* The fragments: the m16n8k8 index maps rebuild a 16 x 8 product from the
  32 lanes' pieces; a C fragment taken as the next product's A fragment
  (k slots q, q + 4 at columns 2q, 2q + 1) against a B fragment loaded
  from rows 2q, 2q + 1 gives P^T dO; planted mutations fail; the loads of
  each fragment fall in 32 distinct banks at the kernel's row stride.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from _torch_threads import one_thread  # noqa: F401  (autouse)
from repro_torch.kernels.flash_attention.ref import (MAX_CTAS,
                                                     attention_f32_bwd_ref,
                                                     attention_f32_dkdv_ref,
                                                     attention_f32_fwd_ref,
                                                     group_ctas)
from test_torch_train_attention import CASES, _exact, _inputs, _rel

REL = 1e-5


# --------------------------------------------------------------- arithmetic


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's big term, cvt.rna.tf32.f32's bits on the integer pipe:
    round float32 to 10 mantissa bits, ties away from zero (add half of the
    dropped 13 bits to the magnitude, clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tensor_core(x: torch.Tensor) -> torch.Tensor:
    """What an mma.sync .tf32 operand is read as: its top 19 bits (the low
    13 truncated)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = TF32 of x, small = x - big (exact), as the
    kernel's split_tf32 hands them to the tensor cores."""
    big = tf32(x)
    return big, x - big


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ab, as_), (bb, bs) = split(a), split(b)
    return tensor_core(as_) @ bb + ab @ tensor_core(bs) + ab @ bb


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


class _Products(TorchFunctionMode):
    """Every ``@`` / ``torch.matmul`` inside runs as ``product``."""

    def __init__(self, product):
        super().__init__()
        self.product = product

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
            return self.product(*args)
        return func(*args, **(kwargs or {}))


def test_tf32_rounding_on_the_int32_view():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      -(1 + 2 ** -11), 1 + 2 ** -12, 3.0e-39, -2.5],
                     dtype=torch.float32)
    want = [1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0, None, -2.5]
    got = tf32(x)
    for g, w in zip(got.tolist(), want):
        if w is not None:
            assert g == w
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    big, small = split(v)
    assert ((big - v).abs() <= 2.0 ** -11 * v.abs()).all()
    # the remainder is exact, and big + small as the tensor cores read it
    # holds v within 2^-21 |v|
    assert torch.equal(small.double(), v.double() - big.double())
    assert ((big.double() + tensor_core(small).double() - v.double()).abs()
            <= 2.0 ** -21 * v.double().abs()).all()
    assert torch.equal(tensor_core(big), big)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-S{}-H{}-Hkv{}-D{}"
                         .format(*c))
def test_3xtf32_backward_holds_the_float32_gate(case):
    q, k, v, do = _inputs(*case, seed=3)
    _o, *want = _exact(q, k, v, do)
    t = [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v, do)]
    o, lse = attention_f32_fwd_ref(*t[:3])
    with _Products(matmul_3xtf32):
        got3 = attention_f32_bwd_ref(*t[:3], o, lse, t[3])
    with _Products(matmul_tf32):
        got1 = attention_f32_bwd_ref(*t[:3], o, lse, t[3])
    errs3 = [_rel(g, w) for g, w in zip(got3, want)]
    errs1 = [_rel(g, w) for g, w in zip(got1, want)]
    assert max(errs3) <= REL, errs3
    assert max(errs1) > 10 * REL, errs1   # one-term TF32 misses the gate


# ----------------------------------------------------------------- schedule


@pytest.mark.parametrize("group,want", [(1, 1), (2, 2), (3, 3), (5, 5),
                                        (8, 8), (11, 1), (12, 6), (16, 8),
                                        (24, 8), (96 // 8, 6)])
def test_group_ctas_is_the_largest_divisor_up_to_the_cluster_limit(group,
                                                                   want):
    assert group_ctas(group) == want
    assert group % want == 0 and want <= MAX_CTAS


@pytest.mark.parametrize("dtype,tol", [(torch.float32, REL),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", [c for c in CASES if c[2] != c[3]],
                         ids=lambda c: "S{1}-H{2}-Hkv{3}-D{4}".format(*c))
def test_group_sum_in_rank_order_matches_one_cta(case, dtype, tol):
    """The cluster's ranks summed in order against one CTA walking every
    head of the group."""
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(*case, seed=4))
    o, lse = attention_f32_fwd_ref(q, k, v)
    c = group_ctas(case[2] // case[3])
    assert c > 1
    dk_c, dv_c, delta = attention_f32_dkdv_ref(q, k, v, o, lse, do)
    dk_1, dv_1, delta_1 = attention_f32_dkdv_ref(q, k, v, o, lse, do,
                                                 ctas=1)
    assert torch.equal(delta, delta_1)
    assert _rel(dk_c, dk_1) <= tol and _rel(dv_c, dv_1) <= tol


@pytest.mark.parametrize("ctas", range(1, MAX_CTAS + 1))
@pytest.mark.parametrize("d", [64, 128])
def test_cluster_partition_sums_every_element_once(ctas, d):
    """The epilogue's loop: rank r, thread t take float4s r * 128 + t +
    i * 128 * ctas of the [2][64][D] partial tiles: each exactly once."""
    threads, n4 = 128, 2 * 64 * d // 4
    seen = np.zeros(n4, dtype=np.int64)
    for rank in range(ctas):
        for t in range(threads):
            seen[np.arange(rank * threads + t, n4, threads * ctas)] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------- fragments


def _lane(lane):
    return lane // 4, lane % 4   # g, q


def a_map(lane):
    """(row, k) of a0..a3 of mma.m16n8k8 tf32."""
    g, q = _lane(lane)
    return [(g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)]


def b_map(lane):
    """(k, column) of b0, b1."""
    g, q = _lane(lane)
    return [(q, g), (q + 4, g)]


def c_map(lane):
    """(row, column) of c0..c3."""
    g, q = _lane(lane)
    return [(g, 2 * q), (g, 2 * q + 1), (g + 8, 2 * q), (g + 8, 2 * q + 1)]


def mma(a_frag, b_frag, c_frag):
    """mma.sync.m16n8k8 from the 32 lanes' fragments: a [32][4], b [32][2],
    c [32][4] -> d [32][4]."""
    a, b, c = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        for (r, kk), x in zip(a_map(lane), a_frag[lane]):
            a[r, kk] = x
        for (kk, n), x in zip(b_map(lane), b_frag[lane]):
            b[kk, n] = x
        for (r, n), x in zip(c_map(lane), c_frag[lane]):
            c[r, n] = x
    d = a @ b + c
    return [[d[r, n] for r, n in c_map(lane)] for lane in range(32)]


def _gather(c_frag):
    out = np.zeros((16, 8))
    for lane in range(32):
        for (r, n), x in zip(c_map(lane), c_frag[lane]):
            out[r, n] = x
    return out


@pytest.mark.parametrize("fn", [a_map, b_map, c_map])
def test_fragment_maps_cover_each_element_once(fn):
    shape = {a_map: (16, 8), b_map: (8, 8), c_map: (16, 8)}[fn]
    seen = np.zeros(shape, dtype=np.int64)
    for lane in range(32):
        for r, n in fn(lane):
            seen[r, n] += 1
    assert (seen == 1).all()


def test_fragments_rebuild_a_16x8_product():
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal(s) for s in ((16, 8), (8, 8), (16, 8)))
    d = mma([[a[r, kk] for r, kk in a_map(ln)] for ln in range(32)],
            [[b[kk, n] for kk, n in b_map(ln)] for ln in range(32)],
            [[c[r, n] for r, n in c_map(ln)] for ln in range(32)])
    np.testing.assert_allclose(_gather(d), a @ b + c, rtol=1e-13)


def _load_a(t, r0, c0, lane):
    """load_a: rows r0 + g, r0 + g + 8, columns c0 + q, c0 + q + 4."""
    g, q = _lane(lane)
    return [t[r0 + g, c0 + q], t[r0 + g + 8, c0 + q], t[r0 + g, c0 + q + 4],
            t[r0 + g + 8, c0 + q + 4]]


def _load_b_t(t, n0, c0, lane):
    """load_b_t: b0 = t[n0 + g][c0 + q], b1 = t[n0 + g][c0 + q + 4]."""
    g, q = _lane(lane)
    return [t[n0 + g, c0 + q], t[n0 + g, c0 + q + 4]]


def _load_b_rows(t, r0, c0, lane):
    """load_b_rows: b0 = t[r0 + 2q][c0 + g], b1 = t[r0 + 2q + 1][c0 + g]."""
    g, q = _lane(lane)
    return [t[r0 + 2 * q, c0 + g], t[r0 + 2 * q + 1, c0 + g]]


def _c_as_a(c):
    """c_as_a: a C fragment as an A fragment, k slots q, q + 4 at columns
    2q, 2q + 1: (c0, c2, c1, c3)."""
    return [c[0], c[2], c[1], c[3]]


def _zero():
    return [[0.0] * 4 for _ in range(32)]


@pytest.mark.parametrize("mutation", [None, "c1 <-> c2", "b rows q, q+4"])
def test_c_fragment_feeds_the_next_product(mutation):
    """S^T = K Q^T as C fragments (load_a, load_b_t over the k steps),
    then dV = P^T dO with P^T = S^T taken as A (c_as_a) and dO's B
    fragment from rows 2q, 2q + 1 (load_b_rows): the 16 x 8 x 16 product
    matches; a mutation of either map does not."""
    rng = np.random.default_rng(2)
    kt, qt, dot = (rng.standard_normal(s) for s in ((16, 16), (8, 16),
                                                    (8, 8)))
    st = _zero()
    for kk in range(0, 16, 8):
        st = mma([_load_a(kt, 0, kk, ln) for ln in range(32)],
                 [_load_b_t(qt, 0, kk, ln) for ln in range(32)], st)
    np.testing.assert_allclose(_gather(st), kt @ qt.T, rtol=1e-12)
    if mutation == "c1 <-> c2":
        a = [[c[0], c[1], c[2], c[3]] for c in st]
    else:
        a = [_c_as_a(c) for c in st]
    if mutation == "b rows q, q+4":
        b = [[dot[_lane(ln)[1], _lane(ln)[0]],
              dot[_lane(ln)[1] + 4, _lane(ln)[0]]] for ln in range(32)]
    else:
        b = [_load_b_rows(dot, 0, 0, ln) for ln in range(32)]
    dv = _gather(mma(a, b, _zero()))
    want = (kt @ qt.T) @ dot
    if mutation is None:
        np.testing.assert_allclose(dv, want, rtol=1e-12)
    else:
        assert not np.allclose(dv, want)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("load", ["a", "b_t", "b_rows"])
def test_fragment_loads_hit_32_banks(load, d):
    """Word addresses of the 32 lanes' loads of one fragment register at
    the kernel's row stride D + 4: 32 distinct banks."""
    ld = d + 4
    for reg in range(4 if load == "a" else 2):
        banks = set()
        for lane in range(32):
            g, q = _lane(lane)
            if load == "a":
                r, c = [(g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)][reg]
            elif load == "b_t":
                r, c = (g, q + 4 * reg)
            else:
                r, c = (2 * q + reg, g)
            banks.add((r * ld + c) % 32)
        assert len(banks) == 32, (load, reg)
