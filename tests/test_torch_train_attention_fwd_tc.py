"""CPU rehearsal of the float32 attention forward on the tensor cores
(``csrc/flash_attention_f32.cu``: ``attention_f32_fwd_kernel``, 3xTF32 on
mma.sync m16n8k8), which only a card runs.

* The arithmetic: the forward's schedule (``attention_f32_fwd_ref``, keys
  in the kernel's steps) with its two products, S = Q K^T and P V, in the
  3xTF32 emulation of ``test_torch_train_attention_tc.py``, holds O and lse
  within 1e-5 x max|ref| of float64 at the CASES of
  ``test_torch_train_attention.py``; one-term TF32 misses by more than 10x.
* The schedule: the plain version's key step (16, 32, 64) moves O and lse
  only by rounding; ``FWD_STEP`` is the kernel's ``kFwdStep``, and the
  kernel's shared memory leaves at least two CTAs an SM at D 128.
* The fragments: one warp's walk lane by lane (S as C fragments from
  load_a / load_b_t, each row's max and sum over its quad by xor shuffles,
  the rescale, P as the A operand by c_as_a against V's B fragments from
  load_b_rows) rebuilds a 16 x D block of causal attention and its lse;
  planted mutations fail; every fragment load of a step falls in 32
  distinct banks at the kernel's row stride.
"""

import os
import re

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401  (autouse)
from repro_torch.kernels.flash_attention.ref import (FWD_STEP, NEG_INF,
                                                     attention_f32_fwd_ref)
from test_torch_train_attention import CASES, _exact, _inputs, _rel
from test_torch_train_attention_tc import (_Products, _c_as_a, _lane,
                                           _load_a, _load_b_rows, _load_b_t,
                                           _zero, matmul_3xtf32, matmul_tf32,
                                           mma)

REL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src", "repro_torch",
                   "kernels", "csrc", "flash_attention_f32.cu")


def _exact_lse(q, k):
    """lse [B, H, S] of causal attention in float64."""
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    g = q.shape[2] // k.shape[2]
    kr = k.repeat_interleave(g, dim=2).transpose(1, 2)
    sc = (q.transpose(1, 2) @ kr.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    return torch.logsumexp(sc.masked_fill(~mask, float("-inf")), dim=-1)


# --------------------------------------------------------------- arithmetic


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-S{}-H{}-Hkv{}-D{}"
                         .format(*c))
def test_3xtf32_forward_holds_the_float32_gate(case):
    q, k, v, do = _inputs(*case, seed=5)
    want = (_exact(q, k, v, do)[0], _exact_lse(q, k))
    t = [torch.from_numpy(x.astype(np.float32)) for x in (q, k, v)]
    with _Products(matmul_3xtf32):
        got3 = attention_f32_fwd_ref(*t)
    with _Products(matmul_tf32):
        got1 = attention_f32_fwd_ref(*t)
    errs3 = [_rel(g, w) for g, w in zip(got3, want)]
    errs1 = [_rel(g, w) for g, w in zip(got1, want)]
    assert max(errs3) <= REL, errs3
    assert max(errs1) > 10 * REL, errs1   # one-term TF32 misses the gate


# ----------------------------------------------------------------- schedule


@pytest.mark.parametrize("dtype,tol", [(torch.float32, REL),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("step", [16, 32, 64])
@pytest.mark.parametrize("case", CASES[:2], ids=lambda c: "S{1}-D{4}"
                         .format(*c))
def test_key_step_moves_the_forward_only_by_rounding(case, step, dtype, tol):
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _inputs(*case, seed=6)[:3])
    o, lse = attention_f32_fwd_ref(q, k, v, step=step)
    o64, lse64 = attention_f32_fwd_ref(q.double(), k.double(), v.double(),
                                       step=64)
    assert _rel(o, o64) <= tol and _rel(lse, lse64) <= tol


def _source_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         open(SRC).read()).group(1))


def _source_return(fn: str) -> str:
    """The expression a one-line constexpr function of the source returns."""
    return re.search(rf"constexpr int {fn}\(\) \{{[^{{}}]*?return ([^;]+);",
                     open(SRC).read()).group(1)


def test_plain_key_step_is_the_kernels():
    assert _source_int("kFwdStep") == FWD_STEP


@pytest.mark.parametrize("d", [64, 128])
def test_forward_shared_memory_leaves_two_ctas_an_sm(d):
    """The source's own fwd_smem expression, evaluated with its constants
    (kRows, kFwdStep, bwd_ld), and fwd_ctas's rule: at least two CTAs an
    SM (228 KB, 1 KB reserved a CTA) and within a CTA's 227 KB.  The
    source asserts the same at compile time."""
    ld = eval(_source_return("bwd_ld").replace("D", str(d)))
    expr = (_source_return("fwd_smem").replace("bwd_ld<D>()", str(ld))
            .replace("kRows", str(_source_int("kRows")))
            .replace("kFwdStep", str(_source_int("kFwdStep"))))
    assert re.fullmatch(r"[\d\s()+*]+", expr), expr
    smem = eval(expr)
    ctas = min(228 * 1024 // (smem + 1024), _source_int("kFwdMaxCtas"))
    assert smem <= 232448 and ctas >= 2, (smem, ctas)
    assert f"fwd_ctas<{d}>() >= 2" in open(SRC).read()


# ---------------------------------------------------------------- fragments


def warp_forward(q, k, v, row0, s_len, ks, mutation=None):
    """One warp of the forward kernel, lane by lane in float64: q [16, D]
    are queries row0 .. row0 + 15 (rows from s_len on padded), k / v
    [s_len, D]; the walk over steps of ks keys from key 0, each step that
    starts at or before the warp's last query.  Returns (O [16, D], lse
    [16]) as the lanes hold them at the end."""
    d = q.shape[1]
    nt, nu, scale = ks // 8, d // 8, d ** -0.5
    quad = (1, 4) if mutation == "quad lanes" else (1, 2)
    m = np.full((32, 2), NEG_INF)
    l = np.zeros((32, 2))
    acc = [_zero() for _ in range(nu)]
    for kb0 in range(0, s_len, ks):
        if kb0 > row0 + 15:
            break
        kt, vt = (np.zeros((ks, d)) for _ in range(2))
        n = min(ks, s_len - kb0)
        kt[:n], vt[:n] = k[kb0:kb0 + n], v[kb0:kb0 + n]
        s = [_zero() for _ in range(nt)]
        for kk in range(0, d, 8):
            a = [_load_a(q, 0, kk, ln) for ln in range(32)]
            for t in range(nt):
                s[t] = mma(a, [_load_b_t(kt, 8 * t, kk, ln)
                               for ln in range(32)], s[t])
        mt = np.full((32, 2), NEG_INF)
        for ln in range(32):
            g, qd = _lane(ln)
            for t in range(nt):
                for e in range(4):
                    j, i = kb0 + 8 * t + 2 * qd + (e & 1), row0 + g + 8 * (e >> 1)
                    x = s[t][ln][e] * scale
                    if j > i + (1 if mutation == "mask one key off" else 0):
                        x = NEG_INF
                    s[t][ln][e] = x
                    mt[ln, e >> 1] = max(mt[ln, e >> 1], x)
        for off in quad:
            mt = np.maximum(mt, mt[np.arange(32) ^ off])
        m_new = np.maximum(m, mt)
        corr = np.exp(m - m_new)
        m = m_new
        ps = np.zeros((32, 2))
        for ln in range(32):
            for t in range(nt):
                for e in range(4):
                    s[t][ln][e] = np.exp(s[t][ln][e] - m[ln, e >> 1])
                    ps[ln, e >> 1] += s[t][ln][e]
        for off in quad:
            ps = ps + ps[np.arange(32) ^ off]
        l = l * corr + ps
        if mutation != "no rescale":
            acc = [[[c[e] * corr[ln, e >> 1] for e in range(4)]
                    for ln, c in enumerate(a_u)] for a_u in acc]
        for t in range(0, nt, 2):
            a0 = [_c_as_a(s[t][ln]) for ln in range(32)]
            a1 = [_c_as_a(s[t + 1][ln]) for ln in range(32)]
            for u in range(nu):
                two = mma(a0, [_load_b_rows(vt, 8 * t, 8 * u, ln)
                               for ln in range(32)], _zero())
                two = mma(a1, [_load_b_rows(vt, 8 * t + 8, 8 * u, ln)
                               for ln in range(32)], two)
                acc[u] = [[c[e] + w[e] for e in range(4)]
                          for c, w in zip(acc[u], two)]
    o, lse = np.zeros((16, d)), np.zeros(16)
    for ln in range(32):
        g, qd = _lane(ln)
        for half in range(2):
            r = g + 8 * half
            lse[r] = m[ln, half] + np.log(l[ln, half])
            for u in range(nu):
                for c in range(2):
                    o[r, 8 * u + 2 * qd + c] = (acc[u][ln][2 * half + c]
                                                / max(l[ln, half], 1e-20))
    return o, lse


@pytest.mark.parametrize("mutation", [None, "quad lanes", "no rescale",
                                      "mask one key off"])
@pytest.mark.parametrize("d,ks,row0,s_len", [(64, 32, 48, 64),
                                             (128, 32, 32, 43),
                                             (128, 16, 16, 61)],
                         ids=["D64-step32", "D128-step32-ragged",
                              "D128-step16-ragged"])
def test_warp_walk_rebuilds_a_16_row_block(d, ks, row0, s_len, mutation):
    """The warp's 16 rows of causal attention (rows past s_len are not
    written, so not compared) against softmax in float64; each mutation
    moves them."""
    rng = np.random.default_rng(7)
    k, v = (rng.standard_normal((s_len, d)) for _ in range(2))
    q = rng.standard_normal((16, d))
    q[max(s_len - row0, 0):] = 0.0   # rows past S load as zeros
    o, lse = warp_forward(q, k, v, row0, s_len, ks, mutation)
    rows = np.arange(row0, min(row0 + 16, s_len))
    sc = q[:len(rows)] @ k.T * d ** -0.5
    sc = np.where(np.arange(s_len)[None, :] <= rows[:, None], sc, -np.inf)
    want_lse = np.log(np.exp(sc - sc.max(1, keepdims=True)).sum(1)) \
        + sc.max(1)
    want_o = np.exp(sc - want_lse[:, None]) @ v
    ok = (np.allclose(o[:len(rows)], want_o, rtol=1e-12, atol=1e-12)
          and np.allclose(lse[:len(rows)], want_lse, rtol=1e-12, atol=1e-12))
    assert ok == (mutation is None)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("operand", ["Q (load_a)", "K (load_b_t)",
                                     "V (load_b_rows)"])
def test_forward_fragment_loads_hit_32_banks(operand, d):
    """Every fragment register the forward loads in a step, at its tile
    offsets and row stride D + 4: the 32 lanes' words in 32 distinct
    banks."""
    ld, ks = d + 4, FWD_STEP
    loads = []
    if operand.startswith("Q"):
        for i0 in range(0, 64, 16):
            for kk in range(0, d, 8):
                loads += [[(i0 + r, kk + c) for r, c in
                           [(g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)]]
                          for g, q in map(_lane, range(32))]
    elif operand.startswith("K"):
        for t in range(ks // 8):
            for kk in range(0, d, 8):
                loads += [[(8 * t + g, kk + q), (8 * t + g, kk + q + 4)]
                          for g, q in map(_lane, range(32))]
    else:
        for t in range(ks // 8):
            for u in range(d // 8):
                loads += [[(8 * t + 2 * q, 8 * u + g),
                           (8 * t + 2 * q + 1, 8 * u + g)]
                          for g, q in map(_lane, range(32))]
    lanes = np.array(loads).reshape(-1, 32, *np.array(loads).shape[1:])
    for inst in lanes:                      # [32 lanes, regs, (row, col)]
        for reg in range(inst.shape[1]):
            banks = {(r * ld + c) % 32 for r, c in inst[:, reg]}
            assert len(banks) == 32, (operand, reg)
