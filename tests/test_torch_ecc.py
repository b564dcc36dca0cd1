"""The port's ECC and hybrid NPU+flash GeMV (``repro_torch.core``) against
the JAX package's ``repro.core``, on the CPU.

Inputs are made with numpy from a seed (or by ``jax.random`` where the JAX
package draws them, as its bit flips) and handed to both packages.  Every
comparison is bit-exact: the ECC is integer bit twiddling and the hybrid
GeMV's int8 sums are exact.  The one exception is named by the JAX module
itself: where two sidecar entries name the same address after the Hamming
correction, the order of JAX's scatter is implementation-defined, so those
positions are masked (as ``tests/test_kernels.py`` masks them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ecc as jecc
from repro.core import hybrid_gemv as jhg
from repro.core import tiling as jtiling
from repro.core.hw import FLASH_CONFIGS as JFLASH
from repro.kernels.int8_pagegemv.ref import paged_int8_gemm_ref as jgemm_ref
from repro.quant.int8 import quantize_activation as jquant_act
from repro_torch.bridge import ecc_from_numpy, hybrid_from_numpy
from repro_torch.core import ecc as tecc
from repro_torch.core import hybrid_gemv as thg
from repro_torch.core import tiling as ttiling
from repro_torch.core.hw import FLASH_CONFIGS as TFLASH
from repro_torch.kernels.ecc_decode.ops import ecc_decode
from repro_torch.kernels.int8_pagegemv.ops import paged_int8_gemv
from repro_torch.kernels.int8_pagegemv.ref import paged_int8_gemm_ref
from repro_torch.quant.int8 import quantize_activation, quantize_weight

P = tecc.PAGE_ELEMS


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _colliding(addr: np.ndarray) -> np.ndarray:
    """Per page, the positions named by two or more entries."""
    mask = np.zeros((addr.shape[0], P), bool)
    for b in range(addr.shape[0]):
        vals, counts = np.unique(addr[b], return_counts=True)
        mask[b, vals[counts > 1]] = True
    return mask


def _pages(seed: int, n: int, spread: int) -> np.ndarray:
    """Pages of int8 bit patterns; a small ``spread`` makes magnitudes tie
    often (many equal values at the top-1% threshold)."""
    rng = np.random.RandomState(seed)
    vals = np.clip(np.round(rng.randn(n, P) * spread), -127, 127)
    vals[:, rng.randint(0, P, 40)] = 115   # a few planted outliers
    return vals.astype(np.int8).view(np.uint8)


# ------------------------------------------------------------------ Hamming
def test_hamming_encode_and_every_single_bit_error_match_jax():
    rng = np.random.RandomState(0)
    addr = np.concatenate([[0, 1, P - 1, 0x2AAA, 0x1555],
                           rng.randint(0, P, 59)]).astype(np.uint16)
    jpar = np.asarray(jecc.hamming_encode(jnp.asarray(addr)))
    tpar = tecc.hamming_encode(_t(addr.astype(np.int32)))
    np.testing.assert_array_equal(tpar.numpy(), jpar)
    for bit in range(19):   # 14 address bits, then 5 parity bits
        a, p = addr.copy(), jpar.copy()
        if bit < 14:
            a ^= np.uint16(1 << bit)
        else:
            p ^= np.uint8(1 << (bit - 14))
        ja, jv = jecc.hamming_correct(jnp.asarray(a), jnp.asarray(p))
        ta, tv = tecc.hamming_correct(_t(a.astype(np.int32)), _t(p))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ta.numpy(), addr)   # corrected
        assert tv.all()


def test_hamming_double_bit_errors_match_jax():
    rng = np.random.RandomState(1)
    addr = rng.randint(0, P, 400).astype(np.uint16)
    par = np.asarray(jecc.hamming_encode(jnp.asarray(addr)))
    code = addr.astype(np.int64) | (par.astype(np.int64) << 14)
    for i in range(len(code)):
        b1, b2 = rng.choice(19, 2, replace=False)
        code[i] ^= (1 << b1) | (1 << b2)
    a = (code & 0x3FFF).astype(np.uint16)
    p = (code >> 14).astype(np.uint8)
    ja, jv = jecc.hamming_correct(jnp.asarray(a), jnp.asarray(p))
    ta, tv = tecc.hamming_correct(_t(a.astype(np.int32)), _t(p))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tv.all()   # some double errors are detected


# --------------------------------------------------------------- majorities
@pytest.mark.parametrize("n", [3, 9])
def test_majority_bits_match_jax(n):
    rng = np.random.RandomState(n)
    copies = rng.randint(0, 256, (50, n)).astype(np.uint8)
    np.testing.assert_array_equal(
        tecc._majority_bits(_t(copies), axis=-1).numpy(),
        np.asarray(jecc._majority_bits(jnp.asarray(copies), axis=-1)))
    a, b, c = (rng.randint(0, 256, 64).astype(np.uint8) for _ in range(3))
    np.testing.assert_array_equal(
        tecc._majority3_u8(_t(a), _t(b), _t(c)).numpy(),
        np.asarray(jecc._majority3_u8(*map(jnp.asarray, (a, b, c)))))
    v = rng.randint(0, 256, 256).astype(np.uint8)
    np.testing.assert_array_equal(tecc._abs_i8(_t(v)).numpy(),
                                  np.asarray(jecc._abs_i8(jnp.asarray(v))))


# ------------------------------------------------------------------- encode
@pytest.mark.parametrize("spread", [2, 10, 60])
def test_encode_pages_matches_jax_on_tie_heavy_pages(spread):
    pages = _pages(spread, 3, spread)
    mags = np.abs(pages.view(np.int8).astype(np.int32))
    thr = np.sort(mags, axis=1)[:, -tecc.n_outliers()]
    if spread < 60:   # many values tie at the threshold
        assert ((mags == thr[:, None]).sum(1) > 20).all()
    je = jecc.encode_pages(jnp.asarray(pages))
    te = tecc.encode_pages(_t(pages), batch=2)
    for name in tecc.PageECC._fields:
        got = getattr(te, name).numpy()
        want = np.asarray(getattr(je, name))
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)
    assert tecc.ecc_size_bits() == jecc.ecc_size_bits()
    assert tecc.n_outliers() == jecc.n_outliers()
    # the single-page forms
    one = tecc.encode_page(_t(pages[1]))
    for name in tecc.PageECC._fields:
        np.testing.assert_array_equal(getattr(one, name).numpy(),
                                      getattr(te, name)[1].numpy())
    np.testing.assert_array_equal(
        tecc.decode_page(_t(pages[1]), one).numpy(),
        np.asarray(jecc.decode_page(jnp.asarray(pages[1]),
                                    jecc.encode_page(jnp.asarray(pages[1])))))


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("ber", [0.0, 1e-4, 2e-3])
def test_decode_pages_matches_jax_on_jax_corrupted_pages(ber):
    pages = _pages(7, 6, 10)
    je = jecc.encode_pages(jnp.asarray(pages))
    key = jax.random.fold_in(jax.random.PRNGKey(3), int(ber * 1e6))
    jpages = jnp.asarray(pages)
    if ber > 0:
        jpages = jecc.inject_bitflips(jpages, ber, jax.random.fold_in(key, 1))
        je = jecc.inject_ecc_bitflips(je, ber, jax.random.fold_in(key, 2))
    want = np.asarray(jecc.decode_pages(jpages, je))
    te = ecc_from_numpy(jax.tree.map(np.asarray, je))
    tpages = _t(np.asarray(jpages))
    got = tecc.decode_pages(tpages, te).numpy()
    # the wrapper takes the plain version on CPU tensors
    np.testing.assert_array_equal(ecc_decode(tpages, te).numpy(), got)
    addr, _ = jax.vmap(jecc.hamming_correct)(je.addr, je.addr_parity)
    keep = ~_colliding(np.minimum(np.asarray(addr).astype(np.int64), P - 1))
    np.testing.assert_array_equal(got[keep], want[keep])
    if ber > 0:
        assert (np.asarray(jpages) != pages).any()
        assert (got != np.asarray(jpages)).any()   # the decode corrected


def test_decode_pages_last_entry_wins_at_collisions():
    """Where two entries name one address, the later one decides, for the
    protected mask as for the written value (JAX leaves this order to the
    implementation; the port and its B5 kernel fix it)."""
    k = tecc.n_outliers()
    page = np.zeros((1, P), np.uint8)
    page[0, 100] = 90                        # above the threshold of 50
    addr = np.arange(1000, 1000 + k, dtype=np.int32)[None].copy()
    addr[0, :2] = 100                        # entries 0 and 1 collide
    copies = np.zeros((1, k, 2), np.uint8)
    copies[0, 0], copies[0, 1] = 7, 9
    thr = np.full((1, tecc.THRESHOLD_COPIES), 50, np.uint8)
    parity = tecc.hamming_encode(_t(addr))
    code = tecc.PageECC(_t(thr), _t(addr), parity, _t(copies))
    out = tecc.decode_pages(_t(page), code)
    assert int(out[0, 100]) == 9             # majority of {90, 9, 9}
    bad = parity.clone()
    bad[0, 1] ^= 20                          # syndrome 20: entry 1 invalid
    assert not bool(tecc.hamming_correct(_t(addr), bad)[1][0, 1])
    out = tecc.decode_pages(_t(page), code._replace(addr_parity=bad))
    assert int(out[0, 100]) == 0             # unprotected, clamped
    bad0 = parity.clone()
    bad0[0, 0] ^= 20                         # entry 0 invalid, 1 valid
    out = tecc.decode_pages(_t(page), code._replace(addr_parity=bad0))
    assert int(out[0, 100]) == 9


# ----------------------------------------------------------------- tiling
def test_plan_matrix_matches_jax_on_llama2_7b_shapes():
    shapes = [(4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096)]
    for cfg in ("S", "M", "L"):
        for h, w in shapes:
            for bpe in (1.0, 0.5):
                j = jtiling.plan_matrix(h, w, JFLASH[cfg], bytes_per_elem=bpe)
                t = ttiling.plan_matrix(h, w, TFLASH[cfg], bytes_per_elem=bpe)
                assert dataclasses.asdict(t) == dataclasses.asdict(j), \
                    (cfg, h, w, bpe)
        assert dataclasses.asdict(TFLASH[cfg]) == \
            dataclasses.asdict(JFLASH[cfg])


def test_protected_flip_rate_matches_jax():
    for ber in (1e-5, 2e-4, 1e-3, 2e-3):
        for n in (2, 4):
            assert tecc.protected_flip_rate(ber, n) == \
                jecc.protected_flip_rate(ber, n)


# ------------------------------------------------------------ hybrid GeMV
@pytest.mark.parametrize("b", [1, 3])
def test_hybrid_gemv_accumulators_bit_exact_vs_jax(b):
    """A reduced matrix planned on Cambricon-LLM-S, quantized, ECC-encoded
    and corrupted at BER 2e-4 in JAX: the port's decoded flash region, its
    int32 accumulators over both regions and its output equal JAX's
    ``hybrid_gemv(use_kernel=False)``."""
    rng = np.random.RandomState(b)
    h, w = 384, 256
    wf = (rng.randn(h, w) * 0.05).astype(np.float32)
    x = rng.randn(w, b).astype(np.float32)
    flash = JFLASH["S"]
    jhw = jhg.plan_and_quantize(jnp.asarray(wf), flash, with_ecc=True)
    jnoisy = jhg.corrupt_flash_region(jhw, 2e-4, jax.random.PRNGKey(b))
    assert (np.asarray(jnoisy.flash_wq) != np.asarray(jhw.flash_wq)).any()
    jy = np.asarray(jhg.hybrid_gemv(jnoisy, jnp.asarray(x), use_kernel=False))

    # the port's own plan and quantization of the same matrix
    thw = thg.plan_and_quantize(_t(wf), TFLASH["S"], with_ecc=True)
    for name in ("flash_wq", "flash_scale", "npu_wq", "npu_scale"):
        np.testing.assert_array_equal(getattr(thw, name).numpy(),
                                      np.asarray(getattr(jhw, name)))
    assert (thw.tile_h, thw.tile_w) == (jhw.tile_h, jhw.tile_w)
    for name in tecc.PageECC._fields:
        np.testing.assert_array_equal(
            getattr(thw.ecc, name).numpy(),
            np.asarray(getattr(jhw.ecc, name)).astype(
                getattr(thw.ecc, name).numpy().dtype))

    tnoisy = hybrid_from_numpy(jax.tree.map(np.asarray, jnoisy))
    jdec = jhg._from_pages(jecc.decode_pages(
        jhg._to_pages(jnoisy.flash_wq), jnoisy.ecc), jnoisy.flash_wq.shape)
    tdec = thg.decoded_flash(tnoisy, use_kernel=True)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(
        thg.decoded_flash(tnoisy, use_kernel=False).numpy(), tdec.numpy())

    jxq, _ = jquant_act(jnp.asarray(x))
    txq, _ = quantize_activation(_t(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    jacc = np.asarray(jgemm_ref(jnp.concatenate([jdec, jnoisy.npu_wq]), jxq))
    tacc = paged_int8_gemm_ref(torch.cat([tdec, tnoisy.npu_wq]), txq)
    np.testing.assert_array_equal(tacc.numpy(), jacc)

    ty = thg.hybrid_gemv(tnoisy, _t(x))
    np.testing.assert_array_equal(ty.numpy(), jy)
    np.testing.assert_array_equal(
        thg.hybrid_gemv(tnoisy, _t(x), use_kernel=False).numpy(), jy)
    # the unprotected path, and a 1-D input
    jraw = np.asarray(jhg.hybrid_gemv(jnoisy._replace(ecc=None),
                                      jnp.asarray(x[:, 0]), use_kernel=False))
    np.testing.assert_array_equal(
        thg.hybrid_gemv(tnoisy._replace(ecc=None), _t(x[:, 0])).numpy(), jraw)


def test_paged_int8_gemv_matches_jax_ref():
    from repro.kernels.int8_pagegemv.ref import paged_int8_gemv_ref as jref
    from repro.quant import int8 as jint8
    from repro.quant.int8 import quantize_weight as jqw
    from repro_torch.quant import int8 as tint8

    rng = np.random.RandomState(4)
    wf = rng.randn(70, 96).astype(np.float32)
    jq = jqw(jnp.asarray(wf))
    tq = quantize_weight(_t(wf))
    np.testing.assert_array_equal(tq.w_q.numpy(), np.asarray(jq.w_q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    for x in (rng.randn(96).astype(np.float32),
              rng.randn(96, 5).astype(np.float32)):
        np.testing.assert_array_equal(
            paged_int8_gemv(tq.w_q, tq.scale, _t(x)).numpy(),
            np.asarray(jref(jq.w_q, jq.scale, jnp.asarray(x))))
        np.testing.assert_array_equal(
            tint8.int8_matvec(tq, _t(x)).numpy(),
            np.asarray(jint8.int8_matvec(jq, jnp.asarray(x))))
    np.testing.assert_array_equal(
        tint8.dequantize(tq.w_q, tq.scale).numpy(),
        np.asarray(jint8.dequantize(jq.w_q, jq.scale)))


def test_inject_bitflips_rate_and_chunking(monkeypatch):
    """The port's generator: each bit flips at about the BER, the sidecar's
    parity stays 5-bit and its addresses 14-bit, and drawing in chunks
    changes nothing but the memory used."""
    arr = torch.zeros(200_000, dtype=torch.uint8)
    gen = torch.Generator().manual_seed(0)
    flipped = tecc.inject_bitflips(arr, 1e-2, gen)
    bits = np.unpackbits(flipped.numpy()).mean()
    assert abs(bits - 1e-2) < 1e-3
    monkeypatch.setattr(tecc, "FLIP_CHUNK", 4096)
    again = tecc.inject_bitflips(arr, 1e-2, torch.Generator().manual_seed(0))
    assert (again.numpy() != 0).mean() == pytest.approx(
        (flipped.numpy() != 0).mean(), abs=2e-3)
    e = tecc.encode_pages(_t(_pages(1, 2, 10)))
    noisy = tecc.inject_ecc_bitflips(e, 0.3, gen)
    assert int(noisy.addr_parity.max()) < 32
    assert int(noisy.addr.max()) < P and int(noisy.addr.min()) >= 0
    assert (noisy.copies != e.copies).any()
