"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every kernel wrapper of ``repro_torch`` takes its plain PyTorch
version; here those run on the same numpy inputs as the JAX Pallas kernels
(interpret mode) and the JAX model's jnp twins.  Tolerances:

* the int8 product is integer arithmetic: bit-exact;
* the attention kernels run in float32 on both sides, with sums taken in
  another order: rtol = atol = 2e-5, the JAX package's own kernel-test
  tolerance (tests/test_kernels.py).

The CUDA kernels themselves are held against these plain versions on a
card by tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import paged_decode_attention_op
from repro.kernels.flash_attention.ops import flash_attention_op
from repro.kernels.int8_pagegemv.int8_pagegemv import paged_int8_gemm
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.int8_pagegemv.ops import int8_gemm
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = dict(rtol=2e-5, atol=2e-5)


def _i8(rng, *shape):
    return rng.randint(-127, 128, size=shape).astype(np.int8)


# --------------------------------------------------------------- B2 int8
@pytest.mark.parametrize("m,k,n", [
    (4, 64, 128),      # reduced decode
    (5, 100, 30),      # ragged K and N
    (40, 960, 72),     # smollm width, prefill-sized M
])
def test_int8_gemm_bit_exact_vs_pallas(m, k, n):
    rng = np.random.RandomState(m * k + n)
    x, w = _i8(rng, m, k), _i8(rng, n, k)
    got = int8_gemm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    # the Pallas kernel computes int32[h, b] = w[h, w] @ x[w, b]
    ref = np.asarray(paged_int8_gemm(jnp.asarray(w), jnp.asarray(x.T),
                                     tile_h=n, tile_w=k, interpret=True)).T
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def _scale_splitting_absmax(dtype, n):
    """``n`` absmax values a (representable in ``dtype``) whose eager scale
    ``a / 127.0`` and jitted scale ``a * float32(1/127)`` differ, and
    differ enough that a/2 (a rounding tie, 63.5) takes another code."""
    rng = np.random.RandomState(5)
    cand = (rng.rand(20000) * 6.0 + 0.5).astype(np.float32)
    if dtype == "bfloat16":
        cand = np.asarray(jnp.asarray(cand).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    eager = cand / np.float32(127.0)
    jitted = cand * np.float32(1.0 / 127.0)
    half = cand / np.float32(2.0)
    split = cand[np.round(half / eager) != np.round(half / jitted)]
    return split[:n]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_w8a8_matmul_matches_jax(dtype):
    """The port's ``_w8a8_matmul`` against the JAX one as the JAX engine
    runs it, under ``jax.jit``: activation codes, the int32 accumulator and
    the output bit-exact.  The first rows' absmax values a are chosen so
    that the eager ``absmax / 127.0`` and the jitted reciprocal multiply
    give different scales, and each such row also holds a/2, whose code
    then differs between the two; the test checks that they do."""
    rng = np.random.RandomState(0)
    xf = (rng.randn(3, 5, 96) * 2.0).astype(np.float32)
    wf = (rng.randn(96, 80) * 0.1).astype(np.float32)
    split = _scale_splitting_absmax(dtype, 5)
    assert len(split) == 5
    xf[0] = np.clip(xf[0], -0.4, 0.4)
    xf[0, np.arange(5), np.arange(5) * 7] = split * np.array([1, -1, 1, -1, 1])
    xf[0, np.arange(5), np.arange(5) * 7 + 3] = split / 2
    jx = jnp.asarray(xf).astype(jnp.bfloat16 if dtype == "bfloat16"
                                else jnp.float32)
    from repro.quant.convert import _quantize_w as jquant
    from repro_torch.quant.convert import _quantize_w as tquant

    jq = jquant(jnp.asarray(wf))
    tq = tquant(torch.from_numpy(wf))
    np.testing.assert_array_equal(tq["w_q"].numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    tx = _to_torch(np.asarray(jx))

    def codes(x):   # the JAX formula of _w8a8_matmul, to be run jitted
        xf32 = x.astype(jnp.float32)
        absmax = jnp.maximum(jnp.max(jnp.abs(xf32), -1, keepdims=True), 1e-8)
        scale = absmax / 127.0
        xq = jnp.clip(jnp.round(xf32 / scale), -127, 127).astype(jnp.int8)
        return xq, scale

    jxq, jscale = jax.jit(codes)(jx)
    eager_xq, eager_scale = codes(jx)
    assert (np.asarray(eager_scale)[0, :5] != np.asarray(jscale)[0, :5]).all()
    assert (np.asarray(eager_xq)[0, :5] != np.asarray(jxq)[0, :5]).any(-1).all()
    jacc = jax.jit(lambda xq, wq: jax.lax.dot_general(
        xq, wq, (((2,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))(jxq, jq["w_q"])
    txf = tx.float()
    tscale = torch.clamp_min(txf.abs().amax(-1, keepdim=True), 1e-8) \
        * tlayers.INV127
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    txq = torch.clamp(torch.round(txf / tscale), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    tacc = int8_gemm(txq.reshape(-1, 96), tq["w_q"]).reshape(3, 5, 80)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    got = tlayers._w8a8_matmul(tq["w_q"], tq["scale"], tx)
    ref = jax.jit(jlayers._w8a8_matmul)(jq["w_q"], jq["scale"], jx)
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


# --------------------------------------------------- B1 paged decode attn
def _paged_case(seed, b, h, hkv, d, page, pps):
    """A random paged cache with a shuffled block table; lane 0 empty."""
    rng = np.random.RandomState(seed)
    n_pages = b * pps + 1
    q = rng.randn(b, h, d).astype(np.float32)
    kp = rng.randn(n_pages, page, hkv, d).astype(np.float32)
    vp = rng.randn(n_pages, page, hkv, d).astype(np.float32)
    block = (rng.permutation(n_pages - 1)[:b * pps] + 1).reshape(b, pps)
    lens = rng.randint(1, pps * page + 1, size=b)
    lens[0] = 0  # an inactive lane
    return q, kp, vp, block.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("b,h,hkv,d,page,pps", [
    (3, 4, 4, 16, 4, 6),     # MHA (llama-shaped, reduced)
    (4, 6, 2, 16, 8, 3),     # GQA 3:1 (smollm-shaped, reduced)
    (2, 15, 5, 64, 16, 4),   # smollm heads at full head dim
])
def test_paged_decode_attention_vs_pallas_and_jnp(b, h, hkv, d, page, pps):
    q, kp, vp, block, lens = _paged_case(b * h + d, b, h, hkv, d, page, pps)
    got = paged_decode_attention(*map(torch.from_numpy,
                                      (q, kp, vp, block, lens))).numpy()
    pallas = np.asarray(paged_decode_attention_op(
        *map(jnp.asarray, (q, kp, vp, block, lens)), block_k=page * 2,
        interpret=True))
    twin = np.asarray(jattn.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, block, lens))))
    np.testing.assert_allclose(got[1:], pallas[1:], **TOL)
    np.testing.assert_allclose(got[1:], twin[1:], **TOL)
    assert np.isfinite(got).all()  # the length-0 lane is finite


def test_write_and_gather_paged_rows_match_jax():
    """The decode write (inactive lanes to the null page, a lane at
    capacity clamped) and the block-table gather."""
    rng = np.random.RandomState(3)
    b, page, pps, hkv, d = 4, 4, 3, 2, 8
    pool = rng.randn(b * pps + 1, page, hkv, d).astype(np.float32)
    block = np.arange(1, b * pps + 1, dtype=np.int32).reshape(b, pps)
    rows = rng.randn(b, hkv, d).astype(np.float32)
    lens = np.array([0, 5, 11, 12], np.int32)   # last lane at capacity
    active = np.array([True, True, True, False])
    ref = np.asarray(jattn.write_paged_rows(
        jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(block),
        jnp.asarray(lens), jnp.asarray(active)))
    got = torch.from_numpy(pool.copy())
    tattn.write_paged_rows(got, torch.from_numpy(rows),
                           torch.from_numpy(block), torch.from_numpy(lens),
                           torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tattn.gather_paged_rows(got, torch.from_numpy(block)).numpy(),
        np.asarray(jattn.gather_paged_rows(jnp.asarray(ref),
                                           jnp.asarray(block))))


# --------------------------------------------------- B3 flash attention
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 32, 4, 4, 16),    # reduced llama shape
    (2, 40, 6, 2, 16),    # GQA, S not a multiple of the block
    (1, 64, 15, 5, 64),   # smollm heads
])
def test_flash_attention_vs_pallas_and_jnp(b, s, h, hkv, d):
    rng = np.random.RandomState(s * h)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    pallas = np.asarray(flash_attention_op(tr(q), tr(k), tr(v), causal=True,
                                           block_q=16, block_k=16,
                                           interpret=True)).transpose(0, 2, 1, 3)
    twin = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, twin, **TOL)


def test_chunked_attention_multi_chunk_matches_jax():
    """The plain version's online softmax across several q/kv chunks."""
    rng = np.random.RandomState(7)
    q = rng.randn(1, 48, 4, 16).astype(np.float32)
    k = rng.randn(1, 48, 2, 16).astype(np.float32)
    v = rng.randn(1, 48, 2, 16).astype(np.float32)
    for causal in (True, False):
        got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal, q_chunk=16, kv_chunk=16)
        ref = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, q_chunk=16, kv_chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---------------------------------------------------------------- helpers
def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()
