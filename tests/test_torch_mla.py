"""The port's mla_moe family (deepseek-v2-lite-16b, reduced: 2 layers, the
first dense, d_model 64, 4 heads, R 32, Dn 16, Dr 8, Dv 16, 8 routed
experts top-2 and one shared) against the JAX package, on the same
weights.

JAX initialises the params (float32, or W8A8 by JAX's ``quantize_params``);
the bridge carries them over bit for bit; both sides run the same inputs,
JAX's functions under ``jit`` as its engine runs them (C1).  Compared:

- the config, the param tree and its ``dense_layers`` subtree, the bridge
  (every leaf bit for bit) and ``quantize_params`` (``kv_a_norm`` stays
  float, as in JAX);
- ``kv_page_elems`` / ``kv_page_scale_elems`` / ``kv_page_bytes`` and the
  paged cache's layout;
- the MLA kernel's plain version against the attention part of JAX's
  ``_mla_absorbed_attend`` (rtol 1e-5 of the context's magnitude), and the
  kernel's split schedule rehearsed against it, a slot's bits alone, in
  its batch and under a wider table;
- ``mla_full``, ``mla_decode_paged`` (bf16-shaped float32 and int8 pools)
  and ``mla_decode`` against the JAX block functions: 1e-5 float32 (the
  outputs' own scale is ~1), 1e-5 W8A8 (the int8 products are exact; the
  float32 glue around them differs in rounding order only);
- ``forward`` (1e-4, as tests/test_torch_model.py), the paged prefill and
  decode over bf16-layout float32 and int8 pools (1e-4 float32, 5e-3
  W8A8, as tests/test_torch_moe.py), the wave prefill and decode;
- the loopback fleet losing a worker, and snapshot bytes across the two
  codecs.

``forward`` is compared in float32 only: on the W8A8 model an
activation code that lies within float32 noise of its rounding boundary
(one of ~24,000 codes a 2 x 10-token forward quantizes) can round the
other way on the two sides and move a logit by ~3e-2; the W8A8 model is
held on the engine's own paths (paged, wave, the block functions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import blocks as JB
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro.serving import kv_cache as JKV
from repro.serving.fleet import wire as jwire
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.mla_decode_attention import ops as mla_ops
from repro_torch.kernels.mla_decode_attention.ref import (
    bf16_terms, mla_decode_attention_ref, mla_decode_attention_splitkv)
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models.attention import gather_paged_rows, quantize_rows
from repro_torch.quant.convert import quantize_params as tquantize
from repro_torch.serving import kv_cache as TKV
from repro_torch.serving.core import EngineCore, Request
from repro_torch.serving.fleet import wire
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_fleet import (  # noqa: F401  (collected here)
    _models, test_loopback_kill_mid_decode_bit_identical)
from test_torch_hybrid import _assert_same_tree, _bridge, _jax_params
from test_torch_migrate import _same_fields

ARCH = "deepseek-v2-lite-16b"
ATOL = {"float": 1e-4, "w8a8": 5e-3}
BLOCK_ATOL = 1e-5
SLOTS, MAX_SEQ, PAGE = 3, 32, 4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture(scope="module", params=["float", "w8a8"])
def case(request):
    jcfg, jparams = _jax_params(ARCH, request.param)
    return request.param, jcfg, jparams, _bridge(jparams)


@pytest.fixture(scope="module")
def fam():
    """test_torch_fleet.py's form: (JAX cfg, JAX float32 params, port cfg,
    bridged params)."""
    return _models(ARCH)


# ---------------------------------------------------------------------------
# config, params, bridge, quantization, page accounting
# ---------------------------------------------------------------------------


def test_config_and_paths_match_jax():
    for full in (True, False):
        j = jget_arch(ARCH) if full else jget_arch(ARCH).reduced()
        t = get_arch(ARCH) if full else get_arch(ARCH).reduced()
        assert j.__dict__ == t.__dict__
        assert TM.supports_paged(t) == JM.supports_paged(j) is True
        assert TM.supports_chunked_prefill(t) \
            == JM.supports_chunked_prefill(j) is False
        assert not TM.wave_only(t) and not TM.has_slot_state(t)
    cfg = get_arch(ARCH).reduced()
    cache = TM.init_paged_cache(cfg, 1, 16, page_size=4, device="cpu")
    cache["block"] = torch.arange(1, 5, dtype=torch.int32)[None]
    with pytest.raises(ValueError):
        TM.prefill_chunk_into_slot({}, cfg, torch.zeros(4, dtype=torch.int32),
                                   0, 4, cache, 0)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_init_params_tree_matches_jax(dtype):
    """The port's own init: the bridged JAX tree's keys, shapes and dtypes,
    one dense layer in ``dense_layers`` and one MoE layer in ``layers``."""
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jparams = JM.init_params(jget_arch(ARCH).reduced(),
                             jax.random.PRNGKey(0), dtype=jd, max_seq=64)
    want = _shapes(_bridge(jparams))
    got = _shapes(TM.init_params(get_arch(ARCH).reduced(), device="cpu",
                                 dtype=dtype, max_seq=64))
    assert got == want
    assert len(got["dense_layers"]) == 1 and len(got["layers"]) == 1
    assert "ffn" in got["dense_layers"][0] and "moe" in got["layers"][0]


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_bridge_round_trips_every_leaf(quant):
    """Every leaf of the JAX tree, layer i of a stacked leaf (``layers``
    and ``dense_layers``) against the port's list entry i, bit for bit."""
    jparams = JM.init_params(jget_arch(ARCH).reduced(),
                             jax.random.PRNGKey(2), dtype=jnp.bfloat16,
                             max_seq=64)
    if quant != "float":
        jparams = jquantize(jparams, mode=quant)
    tparams = _bridge(jparams)
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    stacked = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        arr = np.asarray(leaf)
        if keys[0] in ("layers", "dense_layers"):
            stacked += 1
            items = [(arr[i], tparams[keys[0]][i]) for i in range(len(arr))]
            keys = keys[1:]
        else:
            items = [(arr, tparams)]
        for want, node in items:
            for k in keys:
                node = node[k]
            if want.dtype.name == "bfloat16":
                assert node.dtype == torch.bfloat16, keys
                np.testing.assert_array_equal(
                    node.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(node.numpy(), want,
                                              err_msg=str(keys))
    assert stacked > 20


@pytest.mark.parametrize("mode", ["w8a8", "w4a16"])
def test_quantize_matches_jax(mode):
    """``quantize_params`` on the bridged float32 tree equals JAX's on its
    own, bit for bit: ``kv_a_norm`` stays a float vector, the stacked
    ``dense_layers`` fall back to W8A8 under ``w4a16`` as JAX's do, the
    routed stacks stay float, the router float32."""
    _, jparams = _jax_params(ARCH, "float")
    got = tquantize(_bridge(jparams), mode=mode)
    _assert_same_tree(got, _bridge(jquantize(jparams, mode=mode)))
    attn = got["dense_layers"][0]["attn"]
    assert attn["kv_a_norm"].dtype == torch.float32 \
        and attn["kv_a_norm"].dim() == 1
    assert set(attn["kv_b"]) == {"w_q", "scale"}
    assert set(got["dense_layers"][0]["ffn"]["up"]) == {"w_q", "scale"}
    assert ("w_p4" in got["lm_head"]) == (mode == "w4a16")


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_kv_page_accounting_matches_jax(full):
    """Elements, scale elements and bytes of one page (compressed [R + Dr]
    rows of every layer) for bf16, float32 and int8 pools."""
    j = jget_arch(ARCH) if full else jget_arch(ARCH).reduced()
    t = get_arch(ARCH) if full else get_arch(ARCH).reduced()
    for page in (4, 8, 16):
        assert TKV.kv_page_elems(t, page) == JKV.kv_page_elems(j, page) \
            == t.n_layers * page * (t.kv_lora_rank + t.qk_rope_dim)
        assert TKV.kv_page_scale_elems(t, page) \
            == JKV.kv_page_scale_elems(j, page) == 2 * t.n_layers * page
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32),
                         (torch.int8, jnp.int8)):
            assert TM.kv_page_bytes(t, page, tdt) \
                == JM.kv_page_bytes(j, page, jdt)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_cache_layout_matches_jax(kv):
    jcfg, cfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    j = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, page_size=PAGE, kv_dtype=kv)
    t = TM.init_paged_cache(cfg, SLOTS, MAX_SEQ, page_size=PAGE, device="cpu",
                            kv_dtype=kv)
    for key in set(j) - {"block"}:
        assert tuple(t[key].shape) == j[key].shape, key
        assert str(t[key].dtype).split(".")[-1] == j[key].dtype.name, key
    assert set(t) == set(j) - {"block"}
    want = ("ckv", "krope") + (("ckv_scale", "krope_scale")
                               if kv == "int8" else ())
    assert TB.paged_pool_keys(t) == JB.paged_pool_keys(j) == want
    t["block"] = torch.zeros((SLOTS, MAX_SEQ // PAGE), dtype=torch.int32)
    assert TM.paged_slot_capacity(t) == JM.paged_slot_capacity(j) == MAX_SEQ
    assert TM.paged_kv_dtype(t) == JM.paged_kv_dtype(j) == kv


# ---------------------------------------------------------------------------
# the MLA decode kernel's plain version
# ---------------------------------------------------------------------------


def _jax_attend(q_c, q_rope, ckv, krope, valid_len, scale):
    """The attention lines of JAX's ``_mla_absorbed_attend``
    (src/repro/models/blocks.py:340-352), on gathered float32 rows."""
    scores = (jnp.einsum("bhr,bsr->bhs", q_c, ckv)
              + jnp.einsum("bhd,bsd->bhs", q_rope, krope))
    scores = scores * scale
    smax = ckv.shape[1]
    valid = jnp.arange(smax)[None, :] < jnp.asarray(valid_len).reshape(-1, 1)
    scores = jnp.where(valid[:, None, :], scores, -1e30)
    p = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhs,bsr->bhr", p, ckv)


def _mla_inputs(seed, kv, lens, h=4, r=32, dr=8, page=4, pps=24):
    """Queries, bf16 or int8 pools with rows from a seed, and a shuffled
    block table; the queries scaled so that scores reach ~+-10."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    n_pages = b * pps + 1
    ckv = rng.randn(n_pages, page, r).astype(np.float32)
    kr = rng.randn(n_pages, page, dr).astype(np.float32)
    if kv == "int8":
        ckv_p, kr_p = (quantize_rows(torch.from_numpy(ckv)),
                       quantize_rows(torch.from_numpy(kr)))
    else:
        ckv_p = torch.from_numpy(ckv).to(torch.bfloat16)
        kr_p = torch.from_numpy(kr).to(torch.bfloat16)
    block = (rng.permutation(n_pages - 1)[:b * pps] + 1).reshape(b, pps)
    q_c = torch.from_numpy(rng.randn(b, h, r).astype(np.float32) * 0.6)
    q_r = torch.from_numpy(rng.randn(b, h, dr).astype(np.float32) * 0.6)
    return (q_c, q_r, ckv_p, kr_p, torch.from_numpy(block.astype(np.int32)),
            torch.tensor(lens, dtype=torch.int32))


def _gathered(pool, block):
    return gather_paged_rows(pool, block).float().numpy()


LENS = [96, 37, 1, 0, 63, 64, 65]   # lengths 0 and 1, the split edges


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_attention_ref_matches_jax(kv):
    """The plain version against JAX's attention lines on the same
    gathered rows (length 0: JAX's uniform mean on both sides): within
    1e-5 of the context's magnitude max|ckv|, rtol 1e-5."""
    q_c, q_r, ckv, kr, block, lens = _mla_inputs(3, kv, LENS)
    scale = 24 ** -0.5
    got = mla_decode_attention_ref(q_c, q_r, ckv, kr, block, lens, scale)
    ckv_g, kr_g = _gathered(ckv, block), _gathered(kr, block)
    want = np.asarray(_jax_attend(q_c.numpy(), q_r.numpy(), ckv_g, kr_g,
                                  lens.numpy(), scale))
    mag = np.abs(ckv_g).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * mag)
    # a CPU tensor takes the plain version through the wrapper
    before = dict(mla_ops.LAUNCHES)
    out = mla_ops.mla_decode_attention(q_c, q_r, ckv, kr, block, lens, scale)
    assert mla_ops.LAUNCHES == before and torch.equal(out, got)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_split_schedule_matches_ref_and_is_batch_invariant(kv):
    """The kernel's schedule (splits of 64 keys at absolute positions,
    merged in split order) against the one-shot softmax, within the same
    1e-5 of max|ckv|; a length-0 slot gives 0, as the kernel does.  A
    slot's bits: alone, in its batch and under a table 8 pages wider."""
    q_c, q_r, ckv, kr, block, lens = _mla_inputs(4, kv, LENS)
    scale = 24 ** -0.5
    got = mla_decode_attention_splitkv(q_c, q_r, ckv, kr, block, lens, scale)
    ref = mla_decode_attention_ref(q_c, q_r, ckv, kr, block, lens, scale)
    live = lens > 0
    mag = float(_gathered(ckv, block).__abs__().max())
    np.testing.assert_allclose(got[live].numpy(), ref[live].numpy(),
                               rtol=1e-5, atol=1e-5 * mag)
    assert not got[~live].any()
    wide = torch.cat([block, block[:, :8]], 1)
    wider = mla_decode_attention_splitkv(q_c, q_r, ckv, kr, wide, lens,
                                         scale)
    assert torch.equal(wider, got)
    for i in range(len(LENS)):
        alone = mla_decode_attention_splitkv(
            q_c[i:i + 1], q_r[i:i + 1], ckv, kr, block[i:i + 1],
            lens[i:i + 1], scale)
        assert torch.equal(alone[0], got[i]), i


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_split_schedule_matches_jax(kv):
    """The kernel's schedule and arithmetic (the three bf16 terms of the
    query and of P', the latent and rope sums apart, the split-order merge)
    against JAX's attention lines on the same gathered rows, at lengths 0,
    1 and the split edges 63 / 64 / 65: within 1e-5 of max|ckv| on the
    live lanes."""
    q_c, q_r, ckv, kr, block, lens = _mla_inputs(5, kv, LENS)
    scale = 24 ** -0.5
    got = mla_decode_attention_splitkv(q_c, q_r, ckv, kr, block, lens, scale)
    ckv_g, kr_g = _gathered(ckv, block), _gathered(kr, block)
    want = np.asarray(_jax_attend(q_c.numpy(), q_r.numpy(), ckv_g, kr_g,
                                  lens.numpy(), scale))
    live = (lens > 0).numpy()
    mag = np.abs(ckv_g).max()
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=1e-5,
                               atol=1e-5 * mag)


def test_bf16_terms_sum_back_to_the_float32_exactly():
    """Three terms of 8 significant bits each, every one a bf16 value, sum
    back to the float32 bit for bit wherever |x| >= 2^-110 (each remainder
    stays a normal float32), over 60 decades and float32's extremes; two
    terms do not.  Below 2^-110 a term that falls among the subnormals
    keeps only the bits of their top half: the sum is then within 2^-133
    of x (a softmax weight that small adds nothing the gate can see)."""
    rng = np.random.RandomState(6)
    x = np.concatenate([
        rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096),
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 2.0 ** -110, 1.2e-38,
         1e-40, 1e-45]]).astype(np.float32)
    xt = torch.from_numpy(x)
    terms = bf16_terms(xt)
    for t in terms:
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    total = (terms[0] + terms[1]) + terms[2]
    big = (xt.abs() >= 2.0 ** -110) | (xt == 0)
    assert int(big.sum()) == len(x) - 3
    assert torch.equal(total[big], xt[big])
    np.testing.assert_array_equal(
        sum(t.double() for t in terms).numpy()[big.numpy()],
        x.astype(np.float64)[big.numpy()])
    assert float((total - xt).abs().max()) < 2.0 ** -133
    two = bf16_terms(xt, 2)
    assert not torch.equal(two[0] + two[1], xt)


def test_mla_wrapper_refuses_other_devices():
    q = torch.empty((2, 4, 32), device="meta")
    pool = torch.empty((5, 4, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        mla_ops.mla_decode_attention(q, q[..., :8], pool, pool[..., :8],
                                     torch.zeros((2, 1), dtype=torch.int32),
                                     torch.zeros(2, dtype=torch.int32), 1.0)


# ---------------------------------------------------------------------------
# the block functions
# ---------------------------------------------------------------------------


def test_mla_full_matches_jax(case):
    """The dense layer's MLA over 2 x 9 rows: out, c_kv and k_rope (B3's
    plain version at the padded qk head of 24)."""
    quant, jcfg, jparams, tparams = case
    cfg = get_arch(ARCH).reduced()
    jp = jax.tree.map(lambda a: a[0], jparams["dense_layers"]["attn"])
    tp = tparams["dense_layers"][0]["attn"]
    x = np.random.RandomState(5).randn(2, 9, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    got = TB.mla_full(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    want = jax.jit(lambda p, x, pos: JB.mla_full(p, x, jcfg, pos))(jp, x, pos)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                   atol=BLOCK_ATOL)


def _block_pools(cfg, kv, rng):
    """One layer's float32 (bf16 layout) or int8 pools, seeded rows."""
    n = SLOTS * MAX_SEQ // PAGE + 1
    ckv = rng.randn(n, PAGE, cfg.kv_lora_rank).astype(np.float32)
    kr = rng.randn(n, PAGE, cfg.qk_rope_dim).astype(np.float32)
    if kv == "int8":
        tq = [quantize_rows(torch.from_numpy(a)) for a in (ckv, kr)]
        return tq, [(jnp.asarray(d.numpy()), jnp.asarray(s.numpy()))
                    for d, s in tq]
    return ([torch.from_numpy(ckv), torch.from_numpy(kr)],
            [jnp.asarray(ckv), jnp.asarray(kr)])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_decode_paged_matches_jax(case, kv):
    """The MoE layer's MLA decode for 3 lanes (one inactive, one at a page
    boundary) against JAX's ``mla_decode_paged``: the output of the live
    lanes and the pools after the write."""
    quant, jcfg, jparams, tparams = case
    cfg = get_arch(ARCH).reduced()
    rng = np.random.RandomState(6)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = tparams["layers"][0]["attn"]
    (tck, tkr), (jck, jkr) = _block_pools(cfg, kv, rng)
    block = (rng.permutation(SLOTS * MAX_SEQ // PAGE) + 1).reshape(
        SLOTS, -1).astype(np.int32)
    lens = np.array([13, 5, 8], np.int32)
    active = np.array([True, False, True])
    x = rng.randn(SLOTS, cfg.d_model).astype(np.float32)
    got = TB.mla_decode_paged(tp, torch.from_numpy(x), cfg, tck, tkr,
                              torch.from_numpy(block), torch.from_numpy(lens),
                              torch.from_numpy(active))
    want, jck, jkr = jax.jit(
        lambda p, x, c, k, b, l, a: JB.mla_decode_paged(p, x, jcfg, c, k, b,
                                                        l, a))(
        jp, x, jck, jkr, block, lens, active)
    np.testing.assert_allclose(_np(got)[active], np.asarray(want)[active],
                               rtol=0, atol=BLOCK_ATOL)
    for tpool, jpool in ((tck, jck), (tkr, jkr)):
        tl = list(tpool) if kv == "int8" else [tpool]
        jl = list(jpool) if kv == "int8" else [jpool]
        for a, b in zip(tl, jl):
            if a.dtype == torch.int8:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                           atol=BLOCK_ATOL)


def test_mla_decode_wave_matches_jax(case):
    """The wave form: 2 rows at the shared cursor 6 of an 11-row cache."""
    quant, jcfg, jparams, tparams = case
    cfg = get_arch(ARCH).reduced()
    rng = np.random.RandomState(7)
    jp = jax.tree.map(lambda a: a[0], jparams["dense_layers"]["attn"])
    tp = tparams["dense_layers"][0]["attn"]
    ckv = rng.randn(2, 11, cfg.kv_lora_rank).astype(np.float32)
    kr = rng.randn(2, 11, cfg.qk_rope_dim).astype(np.float32)
    x = rng.randn(2, cfg.d_model).astype(np.float32)
    tck, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got = TB.mla_decode(tp, torch.from_numpy(x), cfg, tck, tkr,
                        torch.tensor(6, dtype=torch.int32))
    want, jck, jkr = jax.jit(
        lambda p, x, c, k: JB.mla_decode(p, x, jcfg, c, k, 6))(jp, x, ckv, kr)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=BLOCK_ATOL)
    np.testing.assert_allclose(tck.numpy(), np.asarray(jck), rtol=0,
                               atol=BLOCK_ATOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), rtol=0,
                               atol=BLOCK_ATOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_matches_jax():
    """Teacher-forced float32 logits on 2 x 10 tokens."""
    jcfg, jparams = _jax_params(ARCH, "float")
    tparams, cfg = _bridge(jparams), get_arch(ARCH).reduced()
    toks = np.random.RandomState(13).randint(0, cfg.vocab_size, (2, 10)
                                             ).astype(np.int32)
    tl = TM.forward(tparams, cfg, torch.from_numpy(toks))
    jl = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jparams, toks)
    assert tl.shape == (2, 10, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL["float"])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_prefill_and_decode_match_jax(case, kv):
    """Two right-padded prompts into slots 2 and 0 of pages out of order,
    then 3 decode steps with slot 1 idle: logits, lengths and the pools."""
    quant, jcfg, jparams, tparams = case
    cfg = get_arch(ARCH).reduced()
    rng = np.random.RandomState(1)
    lens = np.array([5, 13], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, cfg.vocab_size, n)
    slot_ids = np.array([2, 0], np.int32)
    block = np.zeros((SLOTS, MAX_SEQ // PAGE), np.int32)
    block[2, :4] = [7, 3, 9, 1]
    block[0, :5] = [2, 11, 4, 5, 6]
    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, dtype=jnp.float32,
                                 page_size=PAGE, kv_dtype=kv)
    jcache["block"] = jnp.asarray(block)
    tcache = TM.init_paged_cache(cfg, SLOTS, MAX_SEQ, dtype=torch.float32,
                                 page_size=PAGE, device="cpu", kv_dtype=kv)
    tcache["block"] = torch.from_numpy(block)
    tl, tcache = TM.prefill_into_slots(
        tparams, cfg, torch.from_numpy(toks), torch.from_numpy(lens), tcache,
        torch.from_numpy(slot_ids))
    jl, jcache = jax.jit(lambda p, t, tl, c, s: JM.prefill_into_slots(
        p, jcfg, t, tl, c, s))(jparams, toks, lens, jcache, slot_ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    jdecode = jax.jit(lambda p, t, c, a: JM.decode_step_paged(
        p, jcfg, t, c, a))
    active = np.array([True, False, True])
    nxt = np.zeros((SLOTS,), np.int32)
    nxt[slot_ids] = np.argmax(np.asarray(jl), -1)
    for step in range(3):
        jl, jcache = jdecode(jparams, nxt, jcache, active)
        tl, tcache = TM.decode_step_paged(
            tparams, cfg, torch.from_numpy(nxt), tcache,
            torch.from_numpy(active))
        live = active.nonzero()[0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=0, atol=ATOL[quant],
                                   err_msg=f"decode step {step}")
        nxt = np.where(active, np.argmax(np.asarray(jl), -1), 0
                       ).astype(np.int32)
    np.testing.assert_array_equal(tcache["lens"].numpy(),
                                  np.asarray(jcache["lens"]))
    # int8 pools: a code within one step (a row's float32 values differ by
    # rounding, so a value at a code's rounding boundary may round apart)
    np.testing.assert_allclose(tcache["ckv"].float().numpy(),
                               np.asarray(jcache["ckv"]).astype(np.float32),
                               rtol=0, atol=ATOL[quant] if kv == "bf16"
                               else 1)


def test_wave_prefill_and_decode_match_jax(case):
    """The wave cache: a prefill of 2 x 10 tokens, 3 decode steps at the
    shared cursor; logits and the compressed rows."""
    quant, jcfg, jparams, tparams = case
    cfg = get_arch(ARCH).reduced()
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 10)
                                            ).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 24, dtype=jnp.float32)
    tc = TM.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} \
        == {k: v.shape for k, v in jc.items()}
    jl, jc = jax.jit(lambda p, t, c: JM.prefill(p, jcfg, t, c))(jparams, toks,
                                                                  jc)
    tl, tc = TM.prefill(tparams, cfg, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    jstep = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    for step in range(3):
        nt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jc = jstep(jparams, nt, jc)
        tl, tc = TM.decode_step(tparams, cfg, torch.from_numpy(nt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL[quant],
                                   err_msg=f"decode step {step}")
    assert int(tc["len"]) == int(jc["len"]) == 13
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=0, atol=ATOL[quant])


# ---------------------------------------------------------------------------
# snapshots across the two codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_snapshot_bytes_cross_decode(fam, kv):
    """A port snapshot of an mla_moe slot (the compressed ``(ckv, krope[,
    scales])`` pages) decodes in the JAX codec to its own fields and
    pages, and resumes on a port engine to the unmigrated stream."""
    _, _, cfg, params = fam
    eng_kw = dict(max_batch=2, max_seq=48, eos_id=-1, page_size=8,
                  kv_dtype=kv, device="cpu")
    sp = SamplingParams(temperature=0.8, top_k=20, seed=3)

    def req():
        return Request(rid=4, prompt=list(range(1, 12)), max_new_tokens=8,
                       sampling=sp)

    solo = EngineCore(cfg, params, **eng_kw)
    r0 = req()
    solo.add_request(r0)
    solo.run()
    a = EngineCore(cfg, params, **eng_kw)
    a.add_request(req())
    for _ in range(3):
        a.step()
    snap = a.snapshot_slot(4)
    assert len(snap.pages[0]) == (4 if kv == "int8" else 2)
    assert snap.pages[0][0].shape == (cfg.n_layers, 8, cfg.kv_lora_rank)
    data = snap.to_bytes()
    dtype = "int8" if kv == "int8" else "bfloat16"
    in_jax = jwire.snapshot_from_bytes(data, expect_family="mla_moe",
                                       expect_dtype=dtype)
    _same_fields(in_jax, snap)
    back = wire.snapshot_from_bytes(data, expect_family="mla_moe",
                                    expect_page_size=8)
    b = EngineCore(cfg, params, **eng_kw)
    b.inject_slot(back)
    b.run()
    assert back.req.out_tokens == r0.out_tokens
