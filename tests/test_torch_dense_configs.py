"""chatglm3-6b and internlm2-20b in the port against the JAX package.

Each configuration's ``reduced()`` with its published head layout and
features put back: chatglm3-6b 32 query heads over 2 kv heads (a group of
16, the decode kernel's two passes) of 16 dims, the rotary on half of each
head (``rope_fraction`` 0.5) and a bias on every q/k/v and FFN linear;
internlm2-20b 12 query heads over 2 (a group of 6).  JAX initialises
float32 params (biases drawn at random here, as JAX's init leaves them 0)
and quantizes them W8A8; ``repro_torch.bridge`` carries them across bit
for bit; one JAX reference per configuration is built for the module.

Held against JAX: the config copies field for field; ``apply_rope`` at
fraction 0.5; every W8A8 linear of a layer, bias included, bit-exact on
float32 activations (the int8 product is exact and the port reproduces
the jitted activation scale, test_torch_kernels.py); paged prefill into
slots and three decode steps, logits within 5e-3 (the W8A8 tolerance of
test_torch_model.py: an int8 activation code at a rounding tie moves a
logit by ~1e-3); and the engines' greedy streams on margin-checked
prompts (the method of test_torch_serving.py).
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.quant.convert import quantize_params as tquantize
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_serving import _both, _prompts

# the published head layout and features put back into reduced()
RESTORED = {"chatglm3-6b": dict(n_heads=32, n_kv_heads=2, d_head=16,
                                rope_fraction=0.5, use_bias=True),
            "internlm2-20b": dict(n_heads=12, n_kv_heads=2)}
SLOTS, MAX_SEQ, PAGE = 3, 32, 4
W8A8_ATOL = 5e-3


def _cfgs(arch):
    return (dataclasses.replace(jget_arch(arch).reduced(), **RESTORED[arch]),
            dataclasses.replace(get_arch(arch).reduced(), **RESTORED[arch]))


def _random_biases(tree, rng):
    """Every bias leaf of a linear dict drawn from N(0, 0.1^2)."""
    if isinstance(tree, dict):
        return {k: (rng.randn(*np.shape(v)).astype(np.float32) * 0.1
                    if k == "b" and "w" in tree else _random_biases(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=sorted(RESTORED))
def model(request):
    """arch; jcfg / tcfg, the JAX and port configs; jq, JAX's W8A8 params;
    tf / tq, the bridged float and W8A8 params."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jf = JM.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32,
                        max_seq=64)
    jf = _random_biases(jax.tree.map(np.asarray, jf),
                        np.random.RandomState(2))
    jq = jquantize(jax.tree.map(jnp.asarray, jf), mode="w8a8")
    return types.SimpleNamespace(
        arch=arch, jcfg=jcfg, jq=jq, tcfg=tcfg, tf=params_from_numpy(jf),
        tq=params_from_numpy(jax.tree.map(np.asarray, jq)))


@pytest.mark.parametrize("arch", sorted(RESTORED))
def test_config_copies_match_jax(arch):
    assert get_arch(arch).__dict__ == jget_arch(arch).__dict__
    assert get_arch(arch).reduced().__dict__ == \
        jget_arch(arch).reduced().__dict__
    j, t = _cfgs(arch)
    assert j.__dict__ == t.__dict__
    assert t.n_heads // t.n_kv_heads == {"chatglm3-6b": 16,
                                         "internlm2-20b": 6}[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_at_fraction_half_matches_jax(dtype):
    """chatglm3-6b's rotary on the first half of each head: the rotated
    half within 4 steps of the dtype at max(|y|, 1) of JAX's (float32 cos /
    sin of float32 angles differ in the last bit between the two libraries:
    1.84 float32 steps measured; bf16 rounds the float32 rotation once: no
    difference measured), the other half passed through bit for bit."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = rng.randint(0, 2000, (2, 7)).astype(np.int32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jy = np.asarray(JL.apply_rope(jx, jnp.asarray(pos), 1.0e4, 0.5)
                    .astype(jnp.float32))
    ty = TL.apply_rope(tx, torch.from_numpy(pos), 1.0e4, 0.5).float().numpy()
    np.testing.assert_array_equal(ty[..., 8:], jy[..., 8:])
    np.testing.assert_array_equal(ty[..., 8:], tx.float().numpy()[..., 8:])
    step = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
    limit = 4 * step * np.maximum(np.abs(jy[..., :8]), 1.0)
    assert (np.abs(ty[..., :8] - jy[..., :8]) <= limit).all()
    assert not np.array_equal(ty[..., :8], tx.float().numpy()[..., :8])


def test_quantized_weights_and_biases_match_jax(model):
    """The port's W8A8 conversion of the bridged float weights equals the
    JAX conversion bit for bit; biases stay float, untouched."""
    tq = model.tq
    mine = tquantize(model.tf, mode="w8a8")
    lay, ref = mine["layers"][1], tq["layers"][1]
    names = [("attn", k) for k in "qkvo"] + [("ffn", k) for k in
                                             ("gate", "up", "down")]
    for blk, name in names:
        for leaf in ("w_q", "scale", "b"):
            assert (leaf in lay[blk][name]) == (leaf in ref[blk][name])
            if leaf in ref[blk][name]:
                assert torch.equal(lay[blk][name][leaf],
                                   ref[blk][name][leaf]), (blk, name, leaf)
    has_bias = {n for b, n in names if "b" in ref[b][n]}
    assert has_bias == ({"q", "k", "v", "gate", "up", "down"}
                        if model.arch == "chatglm3-6b" else set())
    assert torch.equal(mine["lm_head"]["w_q"], tq["lm_head"]["w_q"])


def test_w8a8_linears_with_bias_are_bit_exact(model):
    """Every W8A8 linear of layer 0 (q/k/v/o and the gated FFN; chatglm3-6b's
    with their biases) on the same float32 activations.  The product is
    bit-exact against JAX's jitted ``_w8a8_matmul``, and the port's
    ``linear`` is that product plus the bias in one float32 add, as the JAX
    source writes it, bit for bit.  JAX's jitted ``linear`` itself lies
    within the product's rounding and the sum's: XLA's CPU backend contracts
    the product's last multiply and the bias add into one fused
    multiply-add (ROADMAP C10), skipping a rounding the source writes."""
    rng = np.random.RandomState(3)
    jlin, jmm = jax.jit(JL.linear), jax.jit(JL._w8a8_matmul)
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
            np.testing.assert_array_equal(ty, prod + np.asarray(jp["b"]),
                                          err_msg=name)
            jy = np.asarray(jlin(jp, jnp.asarray(x)))
            # the product's rounding, skipped by the fused add, and the sum's
            ulp = np.spacing(np.abs(prod)) + np.spacing(np.abs(jy))
            assert (np.abs(ty - jy) <= ulp).all(), name


def test_prefill_and_decode_logits_match_jax(model):
    """W8A8 ``prefill_into_slots`` of two prompts into a shuffled paged
    cache, then three ``decode_step_paged`` steps (one slot idle): the
    logits within 5e-3, the lengths equal."""
    jcfg, jq, tcfg, tq = model.jcfg, model.jq, model.tcfg, model.tq
    rng = np.random.RandomState(11)
    lens = np.array([5, 13], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, jcfg.vocab_size, n)
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
        p, jcfg, t, tl, c, s))(jq, toks, lens, jcache, slot_ids)
    tl, tcache = TM.prefill_into_slots(
        tq, tcfg, torch.from_numpy(toks), torch.from_numpy(lens), tcache,
        torch.from_numpy(slot_ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=W8A8_ATOL)
    jdecode = jax.jit(lambda p, t, c, a: JM.decode_step_paged(
        p, jcfg, t, c, a))
    active = np.array([True, False, True])
    nxt = np.zeros((SLOTS,), np.int32)
    nxt[slot_ids] = np.argmax(np.asarray(jl), -1)
    for step in range(3):
        jl, jcache = jdecode(jq, nxt, jcache, active)
        tl, tcache = TM.decode_step_paged(tq, tcfg, torch.from_numpy(nxt),
                                          tcache, torch.from_numpy(active))
        live = active.nonzero()[0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=0, atol=W8A8_ATOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_array_equal(tcache["lens"].numpy(),
                                      np.asarray(jcache["lens"]))
        nxt = np.where(active, np.argmax(np.asarray(jl), -1), 0
                       ).astype(np.int32)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=W8A8_ATOL)


def test_greedy_engine_streams_match_jax(model):
    """Margin-checked prompts through the JAX and the port's W8A8 engines
    (continuous paged mode, 3 slots, one request admitted while the others
    decode): every step's token events equal."""
    models = (model.jcfg, model.jq, model.tcfg, model.tq)
    prompts = _prompts(models, 4, 3, 20, 6, seed=4)
    trace = [(a, rid, p, 6) for rid, (a, p) in enumerate(zip((0, 0, 0, 2),
                                                             prompts))]
    (j, jsteps, jreqs), (t, tsteps, treqs) = _both(models, trace)
    assert tsteps == jsteps
    assert [treqs[r].out_tokens for r in treqs] == \
        [jreqs[r].out_tokens for r in jreqs]
    assert t.stats.prefills == j.stats.prefills > 1
