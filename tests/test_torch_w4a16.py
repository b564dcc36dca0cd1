"""The port's W4A16 path against the JAX package's, on the CPU.

Compared bit-exact: nibble packing, ``quantize_weight4`` (ragged last
groups included) and ``quantize_params(mode="w4a16")`` on llama2-7b
reduced.  Compared with a tolerance: the B4 plain version (what the CUDA
kernel is held to on the card) against the JAX Pallas kernel in interpret
mode and against its jnp reference, and W4A16 model logits.

Tolerance of the W4A16 product: both sides dequantize to the same float32
weights and sum float32 products in different orders, so each output may
differ by a few float32 roundings of the sum of |products|:
``|got - ref| <= 1e-5 * (|x| @ |W_deq|^T) + 1e-6``.  Model logits: the
layers stay W8A8 (as the JAX convert leaves them), so the tolerance is
``tests/test_torch_model.py``'s W8A8 one, atol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.kernels.w4a16_gemv.ops import w4a16_gemv as jw4_pallas
from repro.kernels.w4a16_gemv.ref import w4a16_gemv_ref as jw4_ref
from repro.models import model as JM
from repro.quant import int4 as jint4
from repro.quant.convert import quantize_params as jquantize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.w4a16_gemv.ops import w4a16_gemm, w4a16_gemv
from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref
from repro_torch.models import model as TM
from repro_torch.quant import int4 as tint4
from repro_torch.quant.convert import quantize_params as tquantize

REL, ABS = 1e-5, 1e-6


def assert_w4_close(got, ref, x, w_deq):
    """|got - ref| <= REL * (|x| @ |W|) + ABS, with x [w, b], W [h, w]."""
    bound = REL * (np.abs(w_deq) @ np.abs(x)) + ABS
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert (err <= bound).all(), f"max err/bound {(err / bound).max():.3f}"


def _w(seed, h, w):
    return (np.random.RandomState(seed).randn(h, w) * 0.1).astype(np.float32)


@pytest.mark.parametrize("h,w", [(16, 256), (10, 200), (8, 96), (6, 960)])
def test_pack_and_quantize_weight4_bit_exact_vs_jax(h, w):
    """Group 128 with a ragged last group (200: 1.56 groups, 960: 7.5),
    and a width below one group (96 -> g = 96)."""
    wf = _w(h * w, h, w)
    jq = jint4.quantize_weight4(jnp.asarray(wf))
    tq = tint4.quantize_weight4(torch.from_numpy(wf))
    np.testing.assert_array_equal(tq.w_packed.numpy(), np.asarray(jq.w_packed))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert (tq.h, tq.w) == (jq.h, jq.w)
    np.testing.assert_array_equal(
        tint4.unpack_nibbles(tq.w_packed).numpy(),
        np.asarray(jint4.unpack_nibbles(jq.w_packed)))
    np.testing.assert_array_equal(tint4.dequantize4(tq).numpy(),
                                  np.asarray(jint4.dequantize4(jq)))
    vals = np.random.RandomState(1).randint(-8, 8, (h, w)).astype(np.int8)
    np.testing.assert_array_equal(
        tint4.pack_nibbles(torch.from_numpy(vals)).numpy(),
        np.asarray(jint4.pack_nibbles(jnp.asarray(vals))))


@pytest.mark.parametrize("h,w,b", [
    (256, 512, 1),     # GeMV
    (300, 384, 4),     # ragged h, decode-sized batch
    (64, 960, 3),      # smollm width: 7.5 groups
    (40, 96, 9),       # w < group; b > 8 (the kernel's tiled variant)
])
def test_w4a16_plain_version_vs_pallas_and_ref(h, w, b):
    wf = _w(h + w + b, h, w)
    x = np.random.RandomState(b).randn(w, b).astype(np.float32)
    jq = jint4.quantize_weight4(jnp.asarray(wf))
    tq = tint4.quantize_weight4(torch.from_numpy(wf))
    got = w4a16_gemv(tq, torch.from_numpy(x)).numpy()
    w_deq = np.asarray(jint4.dequantize4(jq))
    pallas = np.asarray(jw4_pallas(jq, jnp.asarray(x), interpret=True))
    assert_w4_close(got, pallas, x, w_deq)
    assert_w4_close(got, np.asarray(jw4_ref(jq, jnp.asarray(x))), x, w_deq)
    # the kernel-level layout: x [M, K] row-major, out [M, N]
    direct = w4a16_gemm(torch.from_numpy(np.ascontiguousarray(x.T)),
                        tq.w_packed, tq.scale).numpy()
    assert_w4_close(direct.T, pallas, x, w_deq)
    np.testing.assert_array_equal(
        direct, w4a16_gemm_ref(torch.from_numpy(np.ascontiguousarray(x.T)),
                               tq.w_packed, tq.scale).numpy())
    got1 = w4a16_gemv(tq, torch.from_numpy(x[:, 0])).numpy()
    assert_w4_close(got1[:, None], pallas[:, :1], x[:, :1], w_deq)


def test_w4a16_linear_and_int4_matvec_match_jax():
    """The W4A16 branch of ``linear`` (B4 on CUDA), ``dense_weight`` of a
    W4A16 linear and ``int4_matvec`` against the JAX functions."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    wf = _w(9, 48, 384)                      # [out, in]
    x = np.random.RandomState(9).randn(2, 3, 384).astype(np.float32)
    jq = jint4.quantize_weight4(jnp.asarray(wf))
    tq = tint4.quantize_weight4(torch.from_numpy(wf))
    jp = {"w_p4": jq.w_packed, "scale4": jq.scale}
    tp = {"w_p4": tq.w_packed, "scale4": tq.scale}
    w_deq = np.asarray(jint4.dequantize4(jq))
    np.testing.assert_array_equal(tlayers.dense_weight(tp).numpy(),
                                  np.asarray(jlayers.dense_weight(jp)))
    got = tlayers.linear(tp, torch.from_numpy(x)).numpy().reshape(6, 48)
    ref = np.asarray(jlayers.linear(jp, jnp.asarray(x))).reshape(6, 48)
    assert_w4_close(got.T, ref.T, x.reshape(6, 384).T, w_deq)
    xv = x[0, 0]
    assert_w4_close(tint4.int4_matvec(tq, torch.from_numpy(xv)).numpy()[:, None],
                    np.asarray(jint4.int4_matvec(jq, jnp.asarray(xv)))[:, None],
                    xv[:, None], w_deq)


def test_w4a16_tolerance_rejects_swapped_nibbles():
    """The stated tolerance is tight enough to catch lo/hi swapped."""
    wf = _w(3, 64, 256)
    x = np.random.RandomState(3).randn(256, 2).astype(np.float32)
    tq = tint4.quantize_weight4(torch.from_numpy(wf))
    swapped = (tq.w_packed >> 4) | (tq.w_packed << 4)
    got = w4a16_gemv(tq._replace(w_packed=swapped), torch.from_numpy(x))
    ref = w4a16_gemv(tq, torch.from_numpy(x))
    with pytest.raises(AssertionError):
        assert_w4_close(got.numpy(), ref.numpy(), x,
                        tint4.dequantize4(tq).numpy())


@pytest.fixture(scope="module")
def w4_case():
    jcfg = jget_arch("llama2-7b").reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32,
                            max_seq=64)
    jq = jquantize(params, mode="w4a16")
    return jcfg, params, jq


def test_quantize_params_w4a16_matches_jax(w4_case):
    """The same outcome as JAX: the layer linears W8A8 (the reference's
    stacked fallback), ``lm_head`` W4A16, embeddings and norms untouched."""
    jcfg, params, jq = w4_case
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    tq = tquantize(tparams, mode="w4a16")
    assert set(tq["lm_head"]) == {"w_p4", "scale4"}
    for key in ("w_p4", "scale4"):
        np.testing.assert_array_equal(tq["lm_head"][key].numpy(),
                                      np.asarray(jq["lm_head"][key]))
    for i, layer in enumerate(tq["layers"]):
        for blk, names in (("attn", "qkvo"), ("ffn", ("gate", "up", "down"))):
            for name in names:
                got = layer[blk][name]
                want = jq["layers"][blk][name]
                assert set(got) == {"w_q", "scale"} == set(want)
                for key in ("w_q", "scale"):
                    np.testing.assert_array_equal(got[key].numpy(),
                                                  np.asarray(want[key][i]))
        np.testing.assert_array_equal(
            layer["attn_norm"]["g"].numpy(),
            np.asarray(jq["layers"]["attn_norm"]["g"][i]))
    np.testing.assert_array_equal(tq["embed"].numpy(),
                                  np.asarray(jq["embed"]))


def test_w4a16_prefill_and_decode_logits_match_jax(w4_case):
    """The W4A16 model (W8A8 layers, W4A16 head) against the JAX model on
    the same weights, as ``tests/test_torch_model.py`` does for W8A8."""
    jcfg, _params, jq = w4_case
    tcfg = get_arch("llama2-7b").reduced()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jq))
    slots, max_seq, page = 2, 32, 4
    rng = np.random.RandomState(5)
    lens = np.array([7, 12], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, jcfg.vocab_size, n)
    slot_ids = np.array([1, 0], np.int32)
    block = np.arange(1, 2 * (max_seq // page) + 1, dtype=np.int32
                      ).reshape(2, -1)
    jcache = JM.init_paged_cache(jcfg, slots, max_seq, dtype=jnp.float32,
                                 page_size=page)
    jcache["block"] = jnp.asarray(block)
    tcache = TM.init_paged_cache(tcfg, slots, max_seq, dtype=torch.float32,
                                 page_size=page, device="cpu")
    tcache["block"] = torch.from_numpy(block)
    jl, jcache = jax.jit(lambda p, t, tl, c, s: JM.prefill_into_slots(
        p, jcfg, t, tl, c, s))(jq, toks, lens, jcache, slot_ids)
    tl, tcache = TM.prefill_into_slots(
        tparams, tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
        tcache, torch.from_numpy(slot_ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=5e-3)
    jdecode = jax.jit(lambda p, t, c, a: JM.decode_step_paged(
        p, jcfg, t, c, a))
    active = np.array([True, True])
    nxt = np.zeros((slots,), np.int32)
    nxt[slot_ids] = np.argmax(np.asarray(jl), -1)
    for step in range(2):
        jl, jcache = jdecode(jq, nxt, jcache, active)
        tl, tcache = TM.decode_step_paged(tparams, tcfg,
                                          torch.from_numpy(nxt), tcache,
                                          torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=5e-3, err_msg=f"decode step {step}")
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)


def test_w4a16_forward_matches_jax(w4_case):
    """Teacher-forced ``forward`` logits of the W4A16 model."""
    jcfg, _params, jq = w4_case
    tparams = params_from_numpy(jax.tree.map(np.asarray, jq))
    toks = np.random.RandomState(8).randint(0, jcfg.vocab_size, (2, 12)
                                            ).astype(np.int32)
    jl = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jq, toks)
    tl = TM.forward(tparams, get_arch("llama2-7b").reduced(),
                    torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=5e-3)
