"""The vlm family (qwen2-vl-72b) in the port against the JAX package.

JAX initialises qwen2-vl-72b.reduced() in float32 (8 vision tokens, 4
query heads over 2 kv heads of 16 dims, M-RoPE, a bias on q/k/v and on
the FFN's linears (the config's ``use_bias``), drawn at random here since
JAX's init leaves them 0) and quantizes it W8A8;
``repro_torch.bridge`` carries both across bit for bit; one JAX reference
is built for the module.  The vision embeddings are seeded normals.

Held against JAX:

- the config copies field for field;
- ``mrope_grid_side``, ``mrope_positions`` and ``blocks._mrope_decode_pos``
  exactly (integers);
- ``apply_mrope`` at D 16 and D 128 (sections 4/4/8 and 42/42/44) within
  4 float32 steps at max(|y|, 1) (float32 cos / sin of the same float32
  angles differ in the last bit between the libraries: 2.0 steps
  measured);
- ``forward`` in float32, logits within 1e-4 (float32 sums in another
  order), vision rows included;
- paged ``prefill_into_slots`` of two prompts into a shuffled cache and
  three ``decode_step_paged`` steps, float32 (1e-4) and W8A8 (5e-3: an
  int8 activation code at a rounding tie moves a logit by ~1e-3,
  tests/test_torch_model.py), the lengths counting the vision rows;
- the wave cache's ``prefill`` and ``decode_step`` (float32, 1e-4);
- every W8A8 linear of a layer bit-exact on float32 activations, the
  biased ones as ROADMAP C10 states (the product bit-exact against jitted
  JAX, plus the bias in one float32 add as the source writes it).

And the port's twin of the JAX ``test_vlm_mrope_decode_matches_forward``
(tests/test_serving.py:310): decode continues the M-RoPE text stream
(``idx - n_vision + side``), so one decode step on the legacy and on the
paged path gives ``forward``'s logits at that position (1e-4, float32),
and the raw cache index would not.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_dense_configs import _random_biases

ARCH = "qwen2-vl-72b"
ATOL = {"float": 1e-4, "w8a8": 5e-3}
SLOTS, MAX_SEQ, PAGE = 3, 48, 4


@pytest.fixture(scope="module")
def model():
    """jcfg / tcfg; jf / jq, JAX's float32 and W8A8 params; tf / tq, the
    bridged ones; vis(b), seeded vision embeddings [b, n_vision, D]."""
    jcfg, tcfg = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jf = JM.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32,
                        max_seq=64)
    jf = _random_biases(jax.tree.map(np.asarray, jf),
                        np.random.RandomState(2))
    jq = jquantize(jax.tree.map(jnp.asarray, jf), mode="w8a8")
    jf = jax.tree.map(jnp.asarray, jf)

    def vis(b, seed=7):
        return np.random.RandomState(seed).randn(
            b, tcfg.n_vision_tokens, tcfg.d_model).astype(np.float32)
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jf=jf, jq=jq, vis=vis,
        tf=params_from_numpy(jax.tree.map(np.asarray, jf)),
        tq=params_from_numpy(jax.tree.map(np.asarray, jq)))


def _params(model, quant):
    return (model.jf, model.tf) if quant == "float" else (model.jq, model.tq)


def test_config_copy_matches_jax():
    assert get_arch(ARCH).__dict__ == jget_arch(ARCH).__dict__
    assert get_arch(ARCH).reduced().__dict__ == \
        jget_arch(ARCH).reduced().__dict__
    cfg = get_arch(ARCH)
    assert (cfg.family, cfg.rope_mode, cfg.n_vision_tokens, cfg.use_bias) \
        == ("vlm", "mrope", 256, True)


def test_mrope_positions_match_jax():
    for n in (0, 1, 3, 8, 15, 16, 17, 255, 256, 1000):
        assert TL.mrope_grid_side(n) == JL.mrope_grid_side(n), n
    for batch, seq, n in ((2, 17, 8), (1, 300, 256), (3, 5, 8), (1, 9, 0)):
        want = np.asarray(JL.mrope_positions(batch, seq, n))
        got = TL.mrope_positions(batch, seq, n).numpy()
        assert got.shape == want.shape == (3, batch, seq)
        np.testing.assert_array_equal(got, want)
    lens = np.arange(0, 600, 7, dtype=np.int32).reshape(-1, 1)
    for cfg in (get_arch(ARCH), get_arch(ARCH).reduced()):
        want = np.asarray(JB._mrope_decode_pos(cfg, jnp.asarray(lens)))
        got = TB._mrope_decode_pos(cfg, torch.from_numpy(lens)).numpy()
        np.testing.assert_array_equal(got, want)
    # the first text row after the vision grid continues at ``side``
    assert int(TB._mrope_decode_pos(get_arch(ARCH), torch.tensor(256))) == 16


@pytest.mark.parametrize("d", [16, 128])
def test_apply_mrope_matches_jax(d):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 4, d).astype(np.float32)
    pos = rng.randint(0, 2000, (3, 2, 7)).astype(np.int32)
    jy = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1.0e6))
    ty = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                        1.0e6).numpy()
    limit = 4 * 2.0 ** -23 * np.maximum(np.abs(jy), 1.0)
    assert (np.abs(ty - jy) <= limit).all()
    # three sections with their own frequencies: not plain RoPE on t
    flat = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                         1.0e6).numpy()
    assert not np.allclose(ty, flat, atol=1e-3)


def test_forward_matches_jax(model):
    rng = np.random.RandomState(13)
    toks = rng.randint(0, model.jcfg.vocab_size, (2, 10)).astype(np.int32)
    vis = model.vis(2)
    jl = jax.jit(lambda p, t, v: JM.forward(p, model.jcfg, t, {
        "vision_embeds": v}))(model.jf, toks, vis)
    tl = TM.forward(model.tf, model.tcfg, torch.from_numpy(toks),
                    {"vision_embeds": torch.from_numpy(vis)})
    assert tl.shape == (2, model.tcfg.n_vision_tokens + 10,
                        model.tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL["float"])


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_paged_prefill_and_decode_match_jax(model, quant):
    """Two prompts (5 and 13 tokens after 8 vision rows) into slots 2 and 0
    of a shuffled block table, then three decode steps with slot 1 idle:
    logits, lengths and the K pool within ATOL."""
    jcfg, tcfg = model.jcfg, model.tcfg
    jp, tp = _params(model, quant)
    nv = tcfg.n_vision_tokens
    rng = np.random.RandomState(11)
    lens = np.array([5, 13], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, jcfg.vocab_size, n)
    true_lens = lens + nv
    slot_ids = np.array([2, 0], np.int32)
    block = np.zeros((SLOTS, MAX_SEQ // PAGE), np.int32)
    block[2, :6] = [7, 3, 9, 1, 12, 13]
    block[0, :8] = [2, 11, 4, 5, 6, 8, 10, 14]
    vis = model.vis(2)
    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, dtype=jnp.float32,
                                 page_size=PAGE)
    jcache["block"] = jnp.asarray(block)
    tcache = TM.init_paged_cache(tcfg, SLOTS, MAX_SEQ, dtype=torch.float32,
                                 page_size=PAGE, device="cpu")
    tcache["block"] = torch.from_numpy(block)
    jl, jcache = jax.jit(lambda p, t, tl, c, s, v: JM.prefill_into_slots(
        p, jcfg, t, tl, c, s, {"vision_embeds": v}))(
        jp, toks, true_lens, jcache, slot_ids, vis)
    tl, tcache = TM.prefill_into_slots(
        tp, tcfg, torch.from_numpy(toks), torch.from_numpy(true_lens),
        tcache, torch.from_numpy(slot_ids),
        {"vision_embeds": torch.from_numpy(vis)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    assert tcache["lens"].tolist() == [13 + nv, 0, 5 + nv]
    jdecode = jax.jit(lambda p, t, c, a: JM.decode_step_paged(
        p, jcfg, t, c, a))
    active = np.array([True, False, True])
    nxt = np.zeros((SLOTS,), np.int32)
    nxt[slot_ids] = np.argmax(np.asarray(jl), -1)
    for step in range(3):
        jl, jcache = jdecode(jp, nxt, jcache, active)
        tl, tcache = TM.decode_step_paged(tp, tcfg, torch.from_numpy(nxt),
                                          tcache, torch.from_numpy(active))
        live = active.nonzero()[0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=0, atol=ATOL[quant],
                                   err_msg=f"decode step {step}")
        np.testing.assert_array_equal(tcache["lens"].numpy(),
                                      np.asarray(jcache["lens"]))
        nxt = np.where(active, np.argmax(np.asarray(jl), -1), 0
                       ).astype(np.int32)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=ATOL[quant])


def test_wave_prefill_and_decode_match_jax(model):
    """The wave cache: a left-padded batch of 2 after the vision rows, then
    three decode steps at the shared cursor (float32)."""
    jcfg, tcfg = model.jcfg, model.tcfg
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 9)
                                            ).astype(np.int32)
    vis = model.vis(2, seed=8)
    jcache = JM.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    jl, jcache = JM.prefill(model.jf, jcfg, jnp.asarray(toks), jcache,
                            {"vision_embeds": jnp.asarray(vis)})
    tl, tcache = TM.prefill(model.tf, tcfg, torch.from_numpy(toks), tcache,
                            {"vision_embeds": torch.from_numpy(vis)})
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL["float"], err_msg=f"step {step}")
        assert int(tcache["len"]) == int(jcache["len"]) == \
            tcfg.n_vision_tokens + 9 + step
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jcache = JM.decode_step(model.jf, jcfg, jnp.asarray(nxt), jcache)
        tl, tcache = TM.decode_step(model.tf, tcfg, torch.from_numpy(nxt),
                                    tcache)


def test_w8a8_linears_with_bias_are_bit_exact(model):
    """q/k/v, o and the gated FFN of layer 0 (all but o biased) on the
    same float32 activations: the product bit-exact against JAX's jitted
    ``_w8a8_matmul``; the port's ``linear`` is that product plus the bias
    in one float32 add, bit for bit; JAX's jitted ``linear`` within the
    product's and the sum's rounding (C10)."""
    rng = np.random.RandomState(3)
    jlin, jmm = jax.jit(JL.linear), jax.jit(JL._w8a8_matmul)
    biased = set()
    for blk, names in (("attn", "qkvo"), ("ffn", ("gate", "up", "down"))):
        for name in names:
            jp = jax.tree.map(lambda a: a[0], model.jq["layers"][blk][name])
            tp = model.tq["layers"][0][blk][name]
            x = (rng.randn(5, jp["w_q"].shape[1]) * 2).astype(np.float32)
            prod = np.asarray(jmm(jp["w_q"], jp["scale"], jnp.asarray(x)))
            ty = TL.linear(tp, torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(
                TL._w8a8_matmul(tp["w_q"], tp["scale"],
                                torch.from_numpy(x)).numpy(), prod,
                err_msg=name)
            if "b" not in jp:
                np.testing.assert_array_equal(ty, prod, err_msg=name)
                continue
            biased.add(name)
            np.testing.assert_array_equal(ty, prod + np.asarray(jp["b"]),
                                          err_msg=name)
            jy = np.asarray(jlin(jp, jnp.asarray(x)))
            ulp = np.spacing(np.abs(prod)) + np.spacing(np.abs(jy))
            assert (np.abs(ty - jy) <= ulp).all(), name
    # use_bias puts a bias on q/k/v and on the FFN's linears, as in JAX
    assert biased == {"q", "k", "v", "gate", "up", "down"}


def test_mrope_decode_matches_forward(model):
    """The twin of tests/test_serving.py:310 on the port: prefill 8 tokens
    after the vision rows, decode the 9th, on the wave (legacy) cache and
    on the paged one; both give ``forward``'s logits at that position,
    which a decode rotated at the raw cache index does not."""
    cfg, params = model.tcfg, model.tf
    nvt = cfg.n_vision_tokens
    ex = {"vision_embeds": torch.from_numpy(model.vis(1, seed=9))}
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (1, 9)).astype(np.int32))
    full = TM.forward(params, cfg, toks, ex)
    atol = ATOL["float"]

    cache = TM.init_cache(cfg, 1, 48, dtype=torch.float32, device="cpu")
    last, cache = TM.prefill(params, cfg, toks[:, :8], cache, ex)
    torch.testing.assert_close(last, full[:, nvt + 7], rtol=0, atol=atol)
    lg, cache = TM.decode_step(params, cfg, toks[:, 8], cache)
    torch.testing.assert_close(lg, full[:, nvt + 8], rtol=0, atol=atol)

    pc = TM.init_paged_cache(cfg, 2, 48, dtype=torch.float32, page_size=8,
                             device="cpu")
    pps = 48 // 8
    pc["block"] = torch.zeros((2, pps), dtype=torch.int32)
    pc["block"][0] = torch.arange(1, pps + 1, dtype=torch.int32)
    padded = torch.nn.functional.pad(toks[:, :8], (0, 8))
    lg0, pc = TM.prefill_into_slots(params, cfg, padded,
                                    torch.tensor([8 + nvt]), pc,
                                    torch.tensor([0]), ex)
    torch.testing.assert_close(lg0[0], full[0, nvt + 7], rtol=0, atol=atol)
    tokb = torch.tensor([int(toks[0, 8]), 0], dtype=torch.int32)
    lgp, _ = TM.decode_step_paged(params, cfg, tokb, pc,
                                  torch.tensor([True, False]))
    torch.testing.assert_close(lgp[0], full[0, nvt + 8], rtol=0, atol=atol)
    # the raw cache index in every stream is another model
    raw = dataclasses.replace(cfg, rope_mode="standard")
    wrong = TM.forward(params, raw, toks, ex)
    assert (wrong[0, nvt + 8] - full[0, nvt + 8]).abs().max() > 100 * atol
