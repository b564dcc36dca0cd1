"""The port's dense model against the JAX model, on the same weights.

JAX initialises float32 params; ``repro_torch.bridge`` carries them over
bit for bit; both sides prefill the same right-padded prompts into the
same slots of a paged cache and then decode the same tokens.  Compared:
the prefill logits and every decode step's logits.

Tolerance: float32 weights, float32 page pools, logits of unit scale.
Float params: atol 1e-4 (float32 sums run in another order; measured
differences are ~2e-6).  W8A8 params: atol 5e-3.  The JAX model
runs its layers under ``lax.scan``, where XLA rewrites the activation
scale ``absmax / 127.0`` as a multiply by the float32 reciprocal; the
port divides, as ``_w8a8_matmul`` is written, so a code at a rounding tie
can differ by one (1/127 of a row's absmax) and move a logit by ~1e-3.
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
