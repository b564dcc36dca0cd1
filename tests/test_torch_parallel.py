"""The parallel-block dense model (command-r-plus-104b) in the port against
the JAX package.

A parallel block gives its attention and its FFN the same normed input,
``x + attn(hn) + ffn(hn)``; the JAX package writes it at four sites
(``_dense_layer_full``, ``prefill_chunk_into_slot``, ``decode_step_paged``,
``decode_step``), which no JAX test runs.  Two configurations: the
config's ``reduced()`` (4 query heads over 2 kv heads of 16 dims, a tied
embedding) and a variant of it at command-r's query group of 12 (12 heads
over 1).  JAX initialises float32 params and quantizes them W8A8;
``repro_torch.bridge`` carries both across bit for bit; one JAX reference
per configuration is built for the module.

Held against JAX, float32 within 1e-4 (float32 sums in another order)
and W8A8 within 5e-3 (an int8 activation code at a rounding tie moves a
logit by ~1e-3, tests/test_torch_model.py): ``forward``; the wave
cache's ``prefill`` and ``decode_step``; paged ``prefill_into_slots``
into a shuffled block table and ``decode_step_paged`` with a slot idle;
``prefill_into_slot``; ``prefill_chunk_into_slot`` over three chunks.
Every W8A8 linear of a layer bit-exact on float32 activations, and the
activation codes the two quantizations of ``hn`` (q/k/v, gate/up) take
bit-exact against JAX's jitted quantizer.

The reference's own float32 oracles, held inside the port bit for bit:
chunked prefill of any schedule == one chunk (tests/test_chunked_prefill.py),
and ``prefill_into_slot`` == its row of ``prefill_into_slots``.  And the
block really is parallel: the same weights as a sequential block give
other logits, while ``ffn_norm``, drawn and kept as JAX keeps it, is not
read.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro.serving.kv_cache import prefill_bucket
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.quant.convert import quantize_params as tquantize
from _torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "command-r-plus-104b"
# the reduced config, and its group of 12 (command-r's 96 over 8)
VARIANTS = {"reduced": {}, "group12": dict(n_heads=12, n_kv_heads=1)}
ATOL = {"float": 1e-4, "w8a8": 5e-3}
SLOTS, MAX_SEQ, PAGE = 3, 48, 4


def _cfgs(variant):
    return (dataclasses.replace(jget_arch(ARCH).reduced(),
                                **VARIANTS[variant]),
            dataclasses.replace(get_arch(ARCH).reduced(),
                                **VARIANTS[variant]))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    """jcfg / tcfg; jf / jq, JAX's float32 and W8A8 params; tf / tq, the
    bridged ones."""
    jcfg, tcfg = _cfgs(request.param)
    jf = JM.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32,
                        max_seq=64)
    jq = jquantize(jf, mode="w8a8")
    return types.SimpleNamespace(
        variant=request.param, jcfg=jcfg, tcfg=tcfg, jf=jf, jq=jq,
        tf=params_from_numpy(jax.tree.map(np.asarray, jf)),
        tq=params_from_numpy(jax.tree.map(np.asarray, jq)))


def _params(model, quant):
    return (model.jf, model.tf) if quant == "float" else (model.jq, model.tq)


def _tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_config_copy_matches_jax():
    assert get_arch(ARCH).__dict__ == jget_arch(ARCH).__dict__
    assert get_arch(ARCH).reduced().__dict__ == \
        jget_arch(ARCH).reduced().__dict__
    cfg = get_arch(ARCH)
    assert (cfg.parallel_block, cfg.tie_embeddings, cfg.n_layers,
            cfg.n_heads // cfg.n_kv_heads) == (True, True, 64, 12)
    assert TM.supports_paged(cfg) and TM.supports_chunked_prefill(cfg)
    for variant in VARIANTS:
        j, t = _cfgs(variant)
        assert j.__dict__ == t.__dict__


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_forward_matches_jax(model, quant):
    jp, tp = _params(model, quant)
    toks = _tokens(model.jcfg, (2, 11), 13)
    jl = jax.jit(lambda p, t: JM.forward(p, model.jcfg, t))(jp, toks)
    tl = TM.forward(tp, model.tcfg, torch.from_numpy(toks))
    assert tl.shape == (2, 11, model.tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_wave_prefill_and_decode_match_jax(model, quant):
    """The wave cache: a batch of 2 prompts of 9 tokens, then three decode
    steps at the shared cursor."""
    jcfg, tcfg = model.jcfg, model.tcfg
    jp, tp = _params(model, quant)
    toks = _tokens(jcfg, (2, 9), 4)
    jcache = JM.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    jl, jcache = JM.prefill(jp, jcfg, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tcfg, torch.from_numpy(toks), tcache)
    for step in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL[quant], err_msg=f"step {step}")
        assert int(tcache["len"]) == int(jcache["len"]) == 9 + step
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jcache = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
        tl, tcache = TM.decode_step(tp, tcfg, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=ATOL[quant])


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_paged_prefill_and_decode_match_jax(model, quant):
    """Two prompts (5 and 13 tokens) into slots 2 and 0 of a shuffled block
    table, then three decode steps with slot 1 idle: logits, lengths and
    the K pool."""
    jcfg, tcfg = model.jcfg, model.tcfg
    jp, tp = _params(model, quant)
    lens = np.array([5, 13], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = _tokens(jcfg, n, 11 + i)
    slot_ids = np.array([2, 0], np.int32)
    block = np.zeros((SLOTS, MAX_SEQ // PAGE), np.int32)
    block[2, :4] = [7, 3, 9, 1]
    block[0, :5] = [2, 11, 4, 5, 6]
    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, dtype=jnp.float32,
                                 page_size=PAGE)
    jcache["block"] = jnp.asarray(block)
    tcache = TM.init_paged_cache(tcfg, SLOTS, MAX_SEQ, dtype=torch.float32,
                                 page_size=PAGE, device="cpu")
    tcache["block"] = torch.from_numpy(block)
    jl, jcache = jax.jit(lambda p, t, tl, c, s: JM.prefill_into_slots(
        p, jcfg, t, tl, c, s))(jp, toks, lens, jcache, slot_ids)
    tl, tcache = TM.prefill_into_slots(
        tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens), tcache,
        torch.from_numpy(slot_ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    assert tcache["lens"].tolist() == [13, 0, 5]
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


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_prefill_into_slot_matches_jax(model, quant):
    """The one-request wrapper: a 10-token prompt (bucket 16) into slot 1;
    JAX's logits [V], and the port's == its row of ``prefill_into_slots``
    bit for bit (float32)."""
    jcfg, tcfg = model.jcfg, model.tcfg
    jp, tp = _params(model, quant)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :10] = _tokens(jcfg, 10, 21)
    block = np.arange(1, SLOTS * (MAX_SEQ // PAGE) + 1, dtype=np.int32
                      ).reshape(SLOTS, -1)
    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, dtype=jnp.float32,
                                 page_size=PAGE)
    jcache["block"] = jnp.asarray(block)
    jl, jcache = JM.prefill_into_slot(jp, jcfg, jnp.asarray(toks), 10, jcache,
                                      1)

    def port_cache():
        c = TM.init_paged_cache(tcfg, SLOTS, MAX_SEQ, dtype=torch.float32,
                                page_size=PAGE, device="cpu")
        c["block"] = torch.from_numpy(block)
        return c
    tl, tcache = TM.prefill_into_slot(tp, tcfg, torch.from_numpy(toks), 10,
                                      port_cache(), 1)
    assert tl.shape == (tcfg.vocab_size,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    assert tcache["lens"].tolist() == [0, 10, 0] \
        == np.asarray(jcache["lens"]).tolist()
    rows, _ = TM.prefill_into_slots(tp, tcfg, torch.from_numpy(toks),
                                    torch.tensor([10]), port_cache(),
                                    torch.tensor([1]))
    assert torch.equal(tl, rows[0])


@pytest.mark.parametrize("quant", ["float", "w8a8"])
def test_prefill_chunk_into_slot_matches_jax(model, quant):
    """Chunks of 5, 9 and 3 tokens (buckets 8, 16 and 4) into a slot whose
    pages are out of order: each chunk's logits and the slot's pages."""
    jcfg, tcfg = model.jcfg, model.tcfg
    jp, tp = _params(model, quant)
    rng = np.random.RandomState(7)
    block = np.array([[3, 1, 4, 2, 6, 5], [0] * 6], np.int32)
    jc = JM.init_paged_cache(jcfg, 2, 24, dtype=jnp.float32, page_size=PAGE)
    jc["block"] = jnp.asarray(block)
    tc = TM.init_paged_cache(tcfg, 2, 24, dtype=torch.float32,
                             page_size=PAGE, device="cpu")
    tc["block"] = torch.from_numpy(block)
    jfn = jax.jit(lambda p, t, s, n, c, sl: JM.prefill_chunk_into_slot(
        p, jcfg, t, s, n, c, sl))
    start = 0
    for clen in (5, 9, 3):
        toks = rng.randint(0, jcfg.vocab_size,
                           prefill_bucket(clen, floor=PAGE)).astype(np.int32)
        jl, jc = jfn(jp, toks, np.int32(start), np.int32(clen), jc,
                     np.int32(0))
        tl, tc = TM.prefill_chunk_into_slot(tp, tcfg, torch.from_numpy(toks),
                                            start, clen, tc, 0)
        start += clen
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL[quant])
        assert int(tc["lens"][0]) == int(jc["lens"][0]) == start
    pages = block[0]
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key][:, pages].numpy(),
                                   np.asarray(jc[key][:, pages]), rtol=0,
                                   atol=ATOL[quant])


def _chunked(cfg, params, prompt, budget):
    """``prompt`` prefilled in chunks of ``budget`` (buckets of the chunk
    length, floor PAGE), then 3 greedy decode steps -> (logits, k pages)."""
    cache = TM.init_paged_cache(cfg, 1, 32, dtype=torch.float32,
                                page_size=PAGE, device="cpu")
    cache["block"] = torch.arange(1, 9, dtype=torch.int32)[None]
    out = []
    for start in range(0, len(prompt), budget):
        piece = prompt[start:start + budget]
        toks = piece + [0] * (prefill_bucket(len(piece), floor=PAGE)
                              - len(piece))
        lg, cache = TM.prefill_chunk_into_slot(
            params, cfg, torch.tensor(toks), start, len(piece), cache, 0)
    out.append(lg)
    for _ in range(3):
        tok = torch.argmax(out[-1]).reshape(1).to(torch.int32)
        lg, cache = TM.decode_step_paged(params, cfg, tok, cache,
                                         torch.tensor([True]))
        out.append(lg[0])
    return out, cache["k"][:, 1:4].clone()


@pytest.mark.parametrize("budget", [1, 5, PAGE])
def test_chunked_prefill_bit_identical_to_one_shot(model, budget):
    """The reference's float32 oracle (tests/test_chunked_prefill.py) on
    the parallel block: any chunk schedule gives the one-chunk run's
    logits, decode logits and pages bit for bit."""
    prompt = _tokens(model.tcfg, 11, 5).tolist()
    one, one_k = _chunked(model.tcfg, model.tf, prompt, len(prompt))
    got, got_k = _chunked(model.tcfg, model.tf, prompt, budget)
    assert torch.equal(one_k, got_k)
    for a, b in zip(one, got):
        assert torch.equal(a, b)


def test_block_is_parallel_and_ffn_norm_unread(model):
    """The same weights as a sequential block give other logits (the
    parallel branch is taken); ``ffn_norm`` is drawn and kept, as JAX keeps
    it, and changing it moves neither JAX's logits nor the port's."""
    jcfg, tcfg = model.jcfg, model.tcfg
    toks = _tokens(jcfg, (1, 7), 2)
    tl = TM.forward(model.tf, tcfg, torch.from_numpy(toks))
    seq = TM.forward(model.tf, dataclasses.replace(tcfg, parallel_block=False),
                     torch.from_numpy(toks))
    assert (seq - tl).abs().max() > 1e-2
    assert all("ffn_norm" in lp for lp in model.tf["layers"])
    bent = {**model.tf, "layers": [{**lp, "ffn_norm": {
        k: v * 3 + 1 for k, v in lp["ffn_norm"].items()}}
        for lp in model.tf["layers"]]}
    assert torch.equal(TM.forward(bent, tcfg, torch.from_numpy(toks)), tl)
    jbent = {**model.jf, "layers": {**model.jf["layers"], "ffn_norm": {
        k: v * 3 + 1 for k, v in model.jf["layers"]["ffn_norm"].items()}}}
    jfwd = jax.jit(lambda p: JM.forward(p, jcfg, toks))
    np.testing.assert_array_equal(np.asarray(jfwd(jbent)),
                                  np.asarray(jfwd(model.jf)))


def _jax_codes(x):
    """The JAX ``_w8a8_matmul``'s activation codes and scale (its lines
    as written), run under ``jit`` as the JAX engine runs them."""
    xf = x.astype(jnp.float32)
    absmax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8)
    x_scale = absmax / 127.0
    return (jnp.clip(jnp.round(xf / x_scale), -127, 127).astype(jnp.int8),
            x_scale)


def test_w8a8_codes_and_linears_are_bit_exact(model, monkeypatch):
    """Layer 0 of the W8A8 model on a prompt's normed embeddings ``hn``:
    the port quantizes ``hn`` once for q/k/v and once for gate/up, as JAX
    does, and every one of those activation code tensors equals JAX's
    jitted codes of the same ``hn`` bit for bit; every W8A8 linear (q, k,
    v, o, gate, up, down) on float32 activations equals JAX's jitted
    ``_w8a8_matmul`` bit for bit; the port's conversion of the float
    weights equals JAX's."""
    from repro_torch.models import blocks as TB

    tcfg, lp = model.tcfg, model.tq["layers"][0]
    toks = torch.from_numpy(_tokens(tcfg, (1, 6), 8))
    hn = TB.norm(tcfg, lp["attn_norm"], model.tq["embed"][toks.long()])
    seen = []
    real = TL.int8_gemm

    def spy(x_q, w_q):
        seen.append(x_q.clone())
        return real(x_q, w_q)
    monkeypatch.setattr(TL, "int8_gemm", spy)
    TM.forward({**model.tq, "layers": model.tq["layers"][:1]},
               dataclasses.replace(tcfg, n_layers=1), toks)
    monkeypatch.undo()
    # q, k, v, o, gate, up, down: hn's codes feed q/k/v and gate/up
    assert len(seen) == 7
    jq, _ = jax.jit(_jax_codes)(jnp.asarray(hn.float().numpy()))
    for i in (0, 1, 2, 4, 5):
        np.testing.assert_array_equal(seen[i].numpy(),
                                      np.asarray(jq).reshape(-1, tcfg.d_model),
                                      err_msg=f"linear {i}")
    rng = np.random.RandomState(3)
    jmm = jax.jit(JL._w8a8_matmul)
    for blk, names in (("attn", "qkvo"), ("ffn", ("gate", "up", "down"))):
        for name in names:
            jp = jax.tree.map(lambda a: a[0], model.jq["layers"][blk][name])
            tp = model.tq["layers"][0][blk][name]
            x = (rng.randn(5, jp["w_q"].shape[1]) * 2).astype(np.float32)
            np.testing.assert_array_equal(
                TL.linear(tp, torch.from_numpy(x)).numpy(),
                np.asarray(jmm(jp["w_q"], jp["scale"], jnp.asarray(x))),
                err_msg=name)
    mine = tquantize(model.tf, mode="w8a8")
    for key in ("w_q", "scale"):
        assert torch.equal(mine["layers"][1]["ffn"]["up"][key],
                           model.tq["layers"][1]["ffn"]["up"][key])
