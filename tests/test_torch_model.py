"""The port's dense model against the JAX model, on the same weights.

JAX initialises float32 params; ``repro_torch.bridge`` carries them over
bit for bit; both sides prefill the same right-padded prompts into the
same slots of a paged cache and then decode the same tokens.  Compared:
the prefill logits and every decode step's logits.

Tolerance: float32 weights, float32 page pools, logits of unit scale.
Float params: atol 1e-4 (float32 sums run in another order; measured
differences are ~2e-6).  W8A8 params: atol 5e-3.  The activation scale is
the same on both sides (the port multiplies by the float32 reciprocal, as
XLA compiles the JAX layers under ``lax.scan``), but the attention and
norm sums upstream of each linear run in another order, so an activation
at a rounding tie can take the neighbouring int8 code (1/127 of a row's
absmax) and move a logit by ~1e-3.

Also: the float32 ``lm_head`` gives a row the same bits whatever rows are
batched with it (the port's own invariant; the CPU's GEMM, like cuBLAS,
picks its blocking by the row count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM

SLOTS, MAX_SEQ, PAGE = 3, 32, 4
ATOL = {"float": 1e-4, "w8a8": 5e-3}


def _jax_params(arch, quant):
    cfg = jget_arch(arch).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32,
                            max_seq=64)
    if quant == "w8a8":
        params = jquantize(params, mode="w8a8")
    return cfg, params


@pytest.fixture(scope="module", params=[
    ("smollm-360m", "float"), ("smollm-360m", "w8a8"),
    ("llama2-7b", "float"), ("llama2-7b", "w8a8"),
    ("opt-6.7b", "w8a8")],   # LayerNorm, biases, GELU MLP, learned positions
    ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    arch, quant = request.param
    jcfg, jparams = _jax_params(arch, quant)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return arch, quant, jcfg, jparams, tparams


def test_port_config_matches_jax():
    for arch in ("smollm-360m", "llama2-7b", "opt-6.7b"):
        for full in (True, False):
            j = jget_arch(arch) if full else jget_arch(arch).reduced()
            t = get_arch(arch) if full else get_arch(arch).reduced()
            assert j.__dict__ == t.__dict__


def test_bridge_is_bit_exact(case):
    arch, quant, jcfg, jparams, tparams = case
    lp = tparams["layers"][1]["attn"]["q"]
    jq = jparams["layers"]["attn"]["q"]
    for key in jq:
        np.testing.assert_array_equal(lp[key].numpy(), np.asarray(jq[key][1]))
    assert len(tparams["layers"]) == jcfg.n_layers


def test_prefill_and_decode_logits_match_jax(case):
    arch, quant, jcfg, jparams, tparams = case
    tcfg = get_arch(arch).reduced()
    rng = np.random.RandomState(11)
    lens = np.array([5, 13], np.int32)
    bucket = 16
    toks = np.zeros((2, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, jcfg.vocab_size, n)
    slot_ids = np.array([2, 0], np.int32)
    pps = MAX_SEQ // PAGE
    block = np.zeros((SLOTS, pps), np.int32)
    block[2, :4] = [7, 3, 9, 1]
    block[0, :5] = [2, 11, 4, 5, 6]

    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, dtype=jnp.float32,
                                 page_size=PAGE)
    jcache["block"] = jnp.asarray(block)
    tcache = TM.init_paged_cache(tcfg, SLOTS, MAX_SEQ, dtype=torch.float32,
                                 page_size=PAGE, device="cpu")
    tcache["block"] = torch.from_numpy(block)
    jl, jcache = jax.jit(lambda p, t, tl, c, s: JM.prefill_into_slots(
        p, jcfg, t, tl, c, s))(jparams, toks, lens, jcache, slot_ids)
    tl, tcache = TM.prefill_into_slots(
        tparams, tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
        tcache, torch.from_numpy(slot_ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    np.testing.assert_array_equal(tcache["lens"].numpy(),
                                  np.asarray(jcache["lens"]))

    jdecode = jax.jit(lambda p, t, c, a: JM.decode_step_paged(
        p, jcfg, t, c, a))
    active = np.array([True, False, True])
    nxt = np.zeros((SLOTS,), np.int32)
    nxt[slot_ids] = np.argmax(np.asarray(jl), -1)
    for step in range(3):
        jl, jcache = jdecode(jparams, nxt, jcache, active)
        tl, tcache = TM.decode_step_paged(
            tparams, tcfg, torch.from_numpy(nxt), tcache,
            torch.from_numpy(active))
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


def test_forward_logits_match_jax(case):
    """Teacher-forced full-sequence logits (``forward``)."""
    arch, quant, jcfg, jparams, tparams = case
    toks = np.random.RandomState(13).randint(0, jcfg.vocab_size, (2, 10)
                                             ).astype(np.int32)
    jl = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jparams, toks)
    tl = TM.forward(tparams, get_arch(arch).reduced(), torch.from_numpy(toks))
    assert tl.shape == (2, 10, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])


@pytest.mark.parametrize("tied", [False, True])
def test_lm_head_row_bits_do_not_depend_on_the_batch(tied):
    """llama2-7b.reduced()'s W8A8 head (or a tied embedding): each row's
    logits at M = 1, 2, 3, 4, 8 and 11 rows equal the row's alone, bit for
    bit."""
    import dataclasses

    from repro_torch.models.layers import init_linear
    from repro_torch.quant.convert import quantize_params

    cfg = get_arch("llama2-7b").reduced()
    gen = torch.Generator().manual_seed(11)
    if tied:
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
        params = {"embed": torch.randn((cfg.vocab_size, cfg.d_model),
                                       generator=gen) * 0.02}
    else:
        params = quantize_params({"lm_head": init_linear(
            gen, cfg.d_model, cfg.vocab_size, False, torch.float32,
            torch.device("cpu"))})
    x = torch.randn((11, cfg.d_model), generator=gen)
    alone = torch.cat([TM.lm_head(params, cfg, x[r:r + 1])
                       for r in range(11)])
    for m in (1, 2, 3, 4, 8, 11):
        assert torch.equal(TM.lm_head(params, cfg, x[:m]), alone[:m]), m


def test_w4a16_lm_head_row_bits_do_not_depend_on_the_batch():
    """A W4A16 head runs in 8-row blocks (ROADMAP C11: B4's tiled GEMM
    above 8 rows gave a row other bits on the card than its GeMV): each
    row's logits at M = 1, 4, 8, 9, 12 and 20 rows equal the row's alone,
    and the blocked product equals the plain one to float32 rounding."""
    from repro_torch.kernels.w4a16_gemv.ref import w4a16_gemm_ref
    from repro_torch.models.layers import init_linear
    from repro_torch.quant.convert import quantize_params

    cfg = get_arch("llama2-7b").reduced()
    gen = torch.Generator().manual_seed(12)
    params = quantize_params({"lm_head": init_linear(
        gen, cfg.d_model, cfg.vocab_size, False, torch.float32,
        torch.device("cpu"))}, mode="w4a16")
    head = params["lm_head"]
    assert "w_p4" in head
    x = torch.randn((20, cfg.d_model), generator=gen)
    alone = torch.cat([TM.lm_head(params, cfg, x[r:r + 1])
                       for r in range(20)])
    for m in (1, 4, 8, 9, 12, 20):
        assert torch.equal(TM.lm_head(params, cfg, x[:m]), alone[:m]), m
    plain = w4a16_gemm_ref(x, head["w_p4"], head["scale4"]).float()
    np.testing.assert_allclose(alone.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
