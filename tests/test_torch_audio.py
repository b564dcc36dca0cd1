"""The port's audio family (whisper-small) and B3's bidirectional mode
against the JAX package.

Kernels and modules, on the CPU (the wrappers' plain versions), on the
same numpy inputs as the JAX functions, float32, rtol = atol = 2e-5 (the
JAX package's kernel-test tolerance, tests/test_kernels.py):

* ``flash_attention(causal=False)`` against the Pallas kernel
  (``flash_attention_op(causal=False, interpret=True)``) where Skv divides
  its key block, Sq == Skv and Sq != Skv, GQA; where it does not (a ragged
  Skv, whisper's 1,500-like and the reduced config's 16 beside a ragged
  Sq), against JAX ``chunked_attention(causal=False)``, since the JAX op
  raises there (``flash_attention/ops.py:34-35``); the port's chunked
  attention slices the last key chunk where JAX pads and masks it;
* ``decode_attention`` over a contiguous cache against JAX
  ``attention.decode_attention``, per-row and shared lengths;
* ``attn_full`` with ``kv_override`` (cross-attention, no RoPE),
  ``cross_attn_decode`` and ``_encode_audio`` on the bridged reduced
  whisper-small weights (float32 and W8A8 at the model tolerances of
  tests/test_torch_wave.py).

Then the model (``init_params`` layout, the bridge and quantization of
``enc_layers``, ``forward``, the wave ``prefill`` / ``decode_step``, bf16
within the rounding gate, ``decode_and_sample``) and the engine (wave mode
against the JAX engine on margin-checked waves, synchronous and
overlapped, greedy and sampled; ``mode="auto"``; the refusals; the
watchdog), through tests/test_torch_wave.py's harness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.kernels.flash_attention.ops import flash_attention_op
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro.serving.core import EngineCore as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as TM
from repro_torch.quant.convert import quantize_params as tquantize
from repro_torch.serving.core import EngineCore
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_wave import (ATOL, check_bf16_gate, check_decode_and_sample,
                             check_engine_against_jax,
                             check_model_against_jax, check_watchdog,
                             jax_params, np32, port_params)

ARCH = "whisper-small"
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, sq, skv, h, hkv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32),
            rng.randn(b, skv, hkv, d).astype(np.float32))


# ---------------------------------------------------------------------------
# B3 bidirectional and B1 over a contiguous cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,block", [
    (2, 32, 32, 4, 2, 16, 16),    # the reduced encoder's heads, Sq == Skv
    (1, 24, 48, 6, 2, 16, 16),    # cross-attention: Sq != Skv, GQA
    (1, 64, 64, 12, 12, 64, 32),  # whisper-small's heads
])
def test_bidirectional_attention_matches_pallas(b, sq, skv, h, hkv, d, block):
    q, k, v = _qkv(sq * h + skv, b, sq, skv, h, hkv, d)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          causal=False).numpy()
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    pallas = np.asarray(flash_attention_op(
        tr(q), tr(k), tr(v), causal=False, block_q=block, block_k=block,
        interpret=True)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,chunk", [
    (1, 9, 16, 4, 2, 16, 1024),     # reduced cross-attention (Senc 16)
    (2, 75, 75, 4, 2, 16, 1024),    # a ragged Skv, one chunk
    (1, 40, 40, 4, 4, 16, 16),      # JAX pads the last key chunk of 8
    (1, 8, 1500, 2, 2, 16, 1024),   # whisper's 1,500 keys in two chunks
])
def test_bidirectional_attention_ragged_matches_chunked(b, sq, skv, h, hkv, d,
                                                        chunk):
    q, k, v = _qkv(sq + skv, b, sq, skv, h, hkv, d)
    want = np.asarray(jattn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=False, q_chunk=chunk,
        kv_chunk=chunk))
    if chunk == 1024:
        got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False).numpy()
    else:
        from repro_torch.models.attention import chunked_attention
        got = chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False, q_chunk=chunk,
                                kv_chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):   # where the JAX op cannot go
        tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
        flash_attention_op(tr(q), tr(k), tr(v), causal=False, block_q=64,
                           block_k=min(64, skv - 1), interpret=True)


@pytest.mark.parametrize("length", [[16, 9, 1], 11], ids=["per-row", "shared"])
def test_decode_attention_matches_jax(length):
    """One query per row over a contiguous cache [B, Smax, Hkv, D] (the
    wave cache; with every row at Smax, the encoder's cross-attention)."""
    rng = np.random.RandomState(3)
    q = rng.randn(3, 4, 16).astype(np.float32)
    kc = rng.randn(3, 16, 2, 16).astype(np.float32)
    vc = rng.randn(3, 16, 2, 16).astype(np.float32)
    lens = np.asarray(length, np.int32)
    got = decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                           torch.from_numpy(np.broadcast_to(lens, (3,))
                                            .copy())).numpy()
    want = np.asarray(jattn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                             jnp.asarray(lens)))
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# whisper's blocks on the bridged weights
# ---------------------------------------------------------------------------


def _layer(params, i, framework):
    if framework == "jax":
        return jax.tree.map(lambda a: a[i], params["layers"])
    return params["layers"][i]


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_cross_attention_blocks_match_jax(quant):
    """``attn_full`` with ``kv_override`` (and bidirectional self-attention
    with ``causal=False``) and ``cross_attn_decode`` over its K/V."""
    jcfg, jparams = jax_params(ARCH, quant)
    cfg, tparams = get_arch(ARCH).reduced(), port_params(ARCH, quant)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    enc = rng.randn(2, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    jl, tl = _layer(jparams, 1, "jax"), _layer(tparams, 1, "port")
    cross = jax.jit(lambda p, x, pos, enc: jblocks.attn_full(
        p, x, jcfg, pos, kv_override=enc))
    bidir = jax.jit(lambda p, x, pos: jblocks.attn_full(
        p, x, jcfg, pos, causal=False))
    for fn, src in ((cross, enc), (bidir, None)):
        args = (jl["xattn"], jnp.asarray(x), jnp.asarray(pos))
        want = fn(*args, jnp.asarray(src)) if src is not None else fn(*args)
        kw = (dict(kv_override=torch.from_numpy(src)) if src is not None
              else dict(causal=False))
        got = tblocks.attn_full(tl["xattn"], torch.from_numpy(x), cfg,
                                torch.from_numpy(pos), **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np32(g), np32(w), rtol=0,
                                       atol=ATOL[quant])
    _, xk, xv = cross(jl["xattn"], jnp.asarray(x), jnp.asarray(pos),
                      jnp.asarray(enc))
    h = rng.randn(2, cfg.d_model).astype(np.float32)
    want = jax.jit(lambda p, h, xk, xv: jblocks.cross_attn_decode(
        p, h, jcfg, xk, xv, jcfg.encoder_seq))(jl["xattn"], jnp.asarray(h),
                                                xk, xv)
    got = tblocks.cross_attn_decode(tl["xattn"], torch.from_numpy(h), cfg,
                                    torch.from_numpy(np32(xk)),
                                    torch.from_numpy(np32(xv)),
                                    cfg.encoder_seq)
    np.testing.assert_allclose(np32(got), np32(want), rtol=0,
                               atol=ATOL[quant])


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_encode_audio_matches_jax(quant):
    """The encoder over zero frames (what the engine feeds) and random
    ones: learned positions, bidirectional layers, the final norm."""
    jcfg, jparams = jax_params(ARCH, quant)
    cfg, tparams = get_arch(ARCH).reduced(), port_params(ARCH, quant)
    rng = np.random.RandomState(6)
    encode = jax.jit(lambda p, f: JM._encode_audio(p, jcfg, f))
    for frames in (np.zeros((2, cfg.encoder_seq, cfg.d_model), np.float32),
                   rng.randn(2, cfg.encoder_seq, cfg.d_model)
                   .astype(np.float32)):
        want = encode(jparams, jnp.asarray(frames))
        got = TM._encode_audio(tparams, cfg, torch.from_numpy(frames))
        np.testing.assert_allclose(np32(got), np32(want), rtol=0,
                                   atol=ATOL[quant])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_whisper_config_and_params_match_jax():
    """The config field for field (full and reduced); the port's own
    ``init_params`` has the JAX tree's keys and shapes (encoder layers,
    ``enc_pos``, ``enc_final_norm``, ``pos_embed``, an untied odd-width
    ``lm_head``); the bridge splits ``enc_layers`` like ``layers``; the
    quantized trees equal JAX's leaf for leaf, W4A16 falling back to
    W8A8 for every stacked linear, the encoder's included."""
    for full in (True, False):
        j = jget_arch(ARCH) if full else jget_arch(ARCH).reduced()
        t = get_arch(ARCH) if full else get_arch(ARCH).reduced()
        assert j.__dict__ == t.__dict__
    assert get_arch(ARCH).vocab_size == 51865
    jcfg, jparams = jax_params(ARCH)
    cfg = get_arch(ARCH).reduced()
    mine = TM.init_params(cfg, device="cpu", dtype=torch.float32, max_seq=64)
    bridged = port_params(ARCH)
    assert len(bridged["enc_layers"]) == cfg.n_encoder_layers == 2

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(mine) == shapes(bridged)
    np.testing.assert_array_equal(
        bridged["enc_layers"][1]["attn"]["q"]["w"].numpy(),
        np.asarray(jparams["enc_layers"]["attn"]["q"]["w"][1]))
    for mode in ("w8a8", "w4a16"):
        want = params_from_numpy(jax.tree.map(
            np.asarray, jquantize(jparams, mode=mode)))
        got = tquantize(port_params(ARCH), mode=mode)
        assert shapes(got) == shapes(want)
        for path in (("enc_layers", 0, "ffn", "up"), ("layers", 1, "xattn",
                                                      "o"), ("lm_head",)):
            g, w = got, want
            for p in path:
                g, w = g[p], w[p]
            assert set(g) == set(w), path
            for key in w:
                assert torch.equal(g[key], w[key]), (mode, path, key)
        assert "w_q" in got["enc_layers"][0]["attn"]["k"]
    assert set(tquantize(port_params(ARCH), mode="w4a16")["lm_head"]) == {
        "w_p4", "scale4"}


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_forward_matches_jax(quant):
    jcfg, jparams = jax_params(ARCH, quant)
    cfg, tparams = get_arch(ARCH).reduced(), port_params(ARCH, quant)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    frames = rng.randn(2, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    want = jax.jit(lambda p, t, f: JM.forward(p, jcfg, t, {"frames": f}))(
        jparams, jnp.asarray(toks), jnp.asarray(frames))
    got = TM.forward(tparams, cfg, torch.from_numpy(toks),
                     {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(np32(got), np32(want), rtol=0,
                               atol=ATOL[quant])


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_audio_prefill_and_decode_match_jax(quant):
    check_model_against_jax(ARCH, quant)


def test_audio_bf16_within_the_rounding_gate():
    check_bf16_gate(ARCH)


def test_audio_decode_and_sample_equals_decode_then_sample():
    check_decode_and_sample(ARCH)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_audio_engine_matches_jax():
    check_engine_against_jax(ARCH)


def test_audio_auto_mode_and_refusals_match_jax():
    """``mode="auto"`` serves whisper in wave mode in both engines;
    continuous mode and a paged cache raise the JAX engine's ValueError;
    so do wave mode with int8 KV, the flash tier or the prefix cache."""
    jcfg, jparams = jax_params(ARCH)
    cfg, tparams = get_arch(ARCH).reduced(), port_params(ARCH)
    j = JEngine(jcfg, jparams, max_batch=2, max_seq=16)
    t = EngineCore(cfg, tparams, max_batch=2, max_seq=16, device="cpu")
    assert t.mode == j.mode == "wave"
    assert not TM.supports_paged(cfg) and TM.wave_only(cfg)
    for kw in (dict(mode="continuous"), dict(kv_dtype="int8"),
               dict(kv_tier="flash"), dict(prefix_cache=True)):
        with pytest.raises(ValueError):
            JEngine(jcfg, jparams, **kw)
        with pytest.raises(ValueError):
            EngineCore(cfg, tparams, device="cpu", **kw)
    with pytest.raises(ValueError):
        JM.init_paged_cache(jcfg, 2, 16)
    with pytest.raises(ValueError):
        TM.init_paged_cache(cfg, 2, 16, device="cpu")


def test_audio_watchdog_redispatch_gives_the_unwatched_bits():
    check_watchdog(ARCH)
