"""The port's hybrid (zamba2) and ssm (mamba2) model code and its serving
engine against the JAX package, on the same weights.

JAX initialises float32 params (``zamba2-7b.reduced()``: 2 groups of 2
Mamba layers, each followed by the shared attention block, then 1 tail
layer; ``mamba2-130m.reduced()``: 2 Mamba layers), optionally quantized;
``repro_torch.bridge`` carries them over bit for bit.  Compared: the
bridged and quantized trees, the paged prefill / decode logits with the
state pools, ``forward``, the slot-state checkpoint, and the engine's
event stream.

Tolerances, as tests/test_torch_model.py states them: float32 logits atol
1e-4 (float32 sums in another order); W8A8 atol 5e-3 (an activation at a
rounding tie can take the neighbouring int8 code).  W4A16 (the shared
block's linears and the lm_head W4A16, the Mamba layers W8A8, as the JAX
convert leaves them) takes W8A8's 5e-3: its Mamba layers are W8A8, and its
W4A16 products differ from JAX's only in float32 summation order.  The state pools
(float32) and conv windows follow the logits' tolerance.  Engine traces
use margin-checked prompts, through tests/test_torch_serving.py's
harness.
"""

import dataclasses

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
from repro_torch.quant.convert import quantize_params as tquantize
from repro_torch.serving.core import EngineCore as TEngine
# the engine-trace harness (margin-checked prompts, per-step events of both
# engines) is the dense family's, run here on the hybrid models
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_serving import _both, _prompts

SLOTS, MAX_SEQ, PAGE = 3, 32, 4
ATOL = {"float": 1e-4, "w8a8": 5e-3, "w4a16": 5e-3}


def _jax_params(arch, quant, seed=1):
    cfg = jget_arch(arch).reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32,
                            max_seq=64)
    if quant != "float":
        params = jquantize(params, mode=quant)
    return cfg, params


def _bridge(params):
    return params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module", params=["float", "w8a8", "w4a16"])
def case(request):
    jcfg, jparams = _jax_params("zamba2-7b", request.param)
    return request.param, jcfg, jparams, _bridge(jparams)


def _assert_same_tree(got, want, path="params"):
    """Same structure, dtypes and bits: ``want`` is the port's form of a
    JAX tree (lists where JAX stacks)."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=path)


def test_port_config_matches_jax():
    """zamba2-7b and mamba2-130m, full and reduced, field for field, and the
    derived SSM widths."""
    for arch in ("zamba2-7b", "mamba2-130m"):
        for full in (True, False):
            j = jget_arch(arch) if full else jget_arch(arch).reduced()
            t = get_arch(arch) if full else get_arch(arch).reduced()
            assert j.__dict__ == t.__dict__
            assert (t.d_inner, t.ssm_nheads) == (j.d_inner, j.ssm_nheads)
    full = get_arch("zamba2-7b")
    assert (full.d_inner, full.ssm_nheads, full.d_head) == (7168, 112, 112)
    assert TM._hybrid_layout(full) == (13, 6, 3)
    assert TM._hybrid_layout(full.reduced()) == (2, 2, 1)


def test_bridge_is_bit_exact_for_the_hybrid_tree(case):
    quant, jcfg, jparams, tparams = case
    n_groups, every, tail = TM._hybrid_layout(jcfg)
    assert len(tparams["groups"]) == n_groups
    assert all(len(g) == every for g in tparams["groups"])
    assert len(tparams["tail"]) == tail
    for gi in range(n_groups):
        for li in range(every):
            jl = jax.tree.map(lambda a: np.asarray(a[gi, li]),
                              jparams["groups"])
            for key in ("conv_w", "a_log", "d_skip", "norm"):
                np.testing.assert_array_equal(
                    tparams["groups"][gi][li][key].numpy(), jl[key])
            for key, val in jl["in_proj"].items():
                np.testing.assert_array_equal(
                    tparams["groups"][gi][li]["in_proj"][key].numpy(), val)
    for key, val in jparams["tail"]["out_proj"].items():
        np.testing.assert_array_equal(tparams["tail"][0]["out_proj"][key]
                                      .numpy(), np.asarray(val[0]))
    for key, val in jparams["shared"]["attn"]["q"].items():
        np.testing.assert_array_equal(tparams["shared"]["attn"]["q"][key]
                                      .numpy(), np.asarray(val))
    # a layer count that divides leaves tail=None on both sides
    six = jax.tree.map(np.asarray, {"groups": jparams["groups"],
                                    "tail": None})
    assert _bridge(six)["tail"] is None


@pytest.mark.parametrize("mode", ["w8a8", "w4a16"])
def test_quantize_params_matches_jax(mode):
    """Leaf for leaf: W8A8 everywhere under ``w8a8``; under ``w4a16`` the
    stacked groups / tail linears fall back to W8A8, the shared block and
    lm_head become W4A16, the Mamba vectors and conv taps stay float."""
    _, jparams = _jax_params("zamba2-7b", "float")
    want = _bridge(jquantize(jparams, mode=mode))
    got = tquantize(_bridge(jparams), mode=mode)
    _assert_same_tree(got, want)
    lin = {"w8a8": {"w_q", "scale"}, "w4a16": {"w_p4", "scale4"}}[mode]
    assert set(got["lm_head"]) == lin
    assert set(got["shared"]["ffn"]["up"]) == lin
    assert set(got["groups"][1][0]["in_proj"]) == {"w_q", "scale"}
    assert set(got["tail"][0]["out_proj"]) == {"w_q", "scale"}
    assert got["groups"][0][1]["conv_w"].dtype == torch.float32


def _prefill_inputs(cfg):
    rng = np.random.RandomState(11)
    lens = np.array([5, 13, 2], np.int32)   # 2 < K-1: a short conv window
    bucket = 16
    toks = np.zeros((4, bucket), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, cfg.vocab_size, n)
    toks[3] = toks[0]                       # the engine's group padding
    lens = np.append(lens, lens[0]).astype(np.int32)
    slot_ids = np.array([2, 0, 1, 2], np.int32)
    pps = MAX_SEQ // PAGE
    block = np.zeros((SLOTS, pps), np.int32)
    block[2, :4] = [7, 3, 9, 1]
    block[0, :5] = [2, 11, 4, 5, 6]
    block[1, :1] = [8]
    return toks, lens, slot_ids, block


def _caches(jcfg, tcfg, block):
    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, dtype=jnp.float32,
                                 page_size=PAGE)
    jcache["block"] = jnp.asarray(block)
    tcache = TM.init_paged_cache(tcfg, SLOTS, MAX_SEQ, dtype=torch.float32,
                                 page_size=PAGE, device="cpu")
    tcache["block"] = torch.from_numpy(block)
    return jcache, tcache


def _assert_cache_close(tcache, jcache, atol, what):
    for pool in ("mamba", "tail"):
        for k in jcache[pool]:
            np.testing.assert_allclose(
                tcache[pool][k].numpy(), np.asarray(jcache[pool][k]),
                rtol=0, atol=atol, err_msg=f"{what}: {pool}.{k}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=0, atol=atol, err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(tcache["lens"].numpy(),
                                  np.asarray(jcache["lens"]))


def test_prefill_and_decode_match_jax(case):
    """Logits, the shared-attention pages, the mamba and tail state pools
    and lens after a prefill (with a short row and a repeated padding row)
    and three decode steps with one lane inactive, whose state must not
    move."""
    quant, jcfg, jparams, tparams = case
    tcfg = get_arch("zamba2-7b").reduced()
    toks, lens, slot_ids, block = _prefill_inputs(jcfg)
    jcache, tcache = _caches(jcfg, tcfg, block)
    assert set(tcache) == set(jcache)
    jl, jcache = jax.jit(lambda p, t, tl, c, s: JM.prefill_into_slots(
        p, jcfg, t, tl, c, s))(jparams, toks, lens, jcache, slot_ids)
    tl, tcache = TM.prefill_into_slots(
        tparams, tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
        tcache, torch.from_numpy(slot_ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    _assert_cache_close(tcache, jcache, ATOL[quant], "prefill")

    jdecode = jax.jit(lambda p, t, c, a: JM.decode_step_paged(
        p, jcfg, t, c, a))
    active = np.array([True, False, True])
    frozen = {k: v[:, :, 1].clone() for k, v in tcache["mamba"].items()}
    nxt = np.zeros((SLOTS,), np.int32)
    nxt[slot_ids[:3]] = np.argmax(np.asarray(jl)[:3], -1)
    for step in range(3):
        jl, jcache = jdecode(jparams, nxt, jcache, active)
        tl, tcache = TM.decode_step_paged(
            tparams, tcfg, torch.from_numpy(nxt), tcache,
            torch.from_numpy(active))
        live = active.nonzero()[0]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=0, atol=ATOL[quant],
                                   err_msg=f"decode step {step}")
        _assert_cache_close(tcache, jcache, ATOL[quant], f"decode {step}")
        nxt = np.where(active, np.argmax(np.asarray(jl), -1), 0
                       ).astype(np.int32)
    for k, v in frozen.items():   # the inactive slot's state, bit for bit
        assert torch.equal(tcache["mamba"][k][:, :, 1], v)


def test_decode_promotes_conv_pools_as_jax():
    """A float32 model over a bf16 cache: JAX's decode step returns each
    conv window in the promoted dtype (float32), so its conv pools are
    float32 from the first decode step on; the port's pools follow, and the
    SSM state pools stay float32 on both sides."""
    jcfg, jparams = _jax_params("zamba2-7b", "float")
    tcfg = get_arch("zamba2-7b").reduced()
    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, page_size=PAGE)
    jcache["block"] = jnp.zeros((SLOTS, MAX_SEQ // PAGE), jnp.int32)
    tcache = TM.init_paged_cache(tcfg, SLOTS, MAX_SEQ, page_size=PAGE,
                                 device="cpu")
    tcache["block"] = torch.zeros((SLOTS, MAX_SEQ // PAGE),
                                  dtype=torch.int32)
    assert tcache["mamba"]["conv"].dtype == torch.bfloat16
    tok, active = np.array([1, 2, 3], np.int32), np.array([True] * 3)
    _, jcache = JM.decode_step_paged(jparams, jcfg, tok, jcache, active)
    _, tcache = TM.decode_step_paged(_bridge(jparams), tcfg,
                                     torch.from_numpy(tok), tcache,
                                     torch.from_numpy(active))
    for pool in ("mamba", "tail"):
        for k in ("conv", "state"):
            assert str(tcache[pool][k].dtype).split(".")[-1] == \
                str(jcache[pool][k].dtype) == "float32", (pool, k)


@pytest.mark.parametrize("arch,quant", [
    ("zamba2-7b", "float"), ("zamba2-7b", "w8a8"), ("zamba2-7b", "w4a16"),
    ("mamba2-130m", "float"), ("mamba2-130m", "w8a8")])
def test_forward_logits_match_jax(arch, quant):
    """Teacher-forced logits of the hybrid and ssm families (one SSD chunk:
    the model's 128 clipped to the 20 tokens)."""
    jcfg, jparams = _jax_params(arch, quant, seed=2)
    toks = np.random.RandomState(13).randint(0, jcfg.vocab_size, (2, 20)
                                             ).astype(np.int32)
    jl = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jparams, toks)
    tl = TM.forward(_bridge(jparams), get_arch(arch).reduced(),
                    torch.from_numpy(toks))
    assert tl.shape == (2, 20, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])


def test_slot_state_checkpoint_round_trip(case):
    """A checkpoint of one slot equals JAX's; restoring it after decode
    steps brings the slot's rows back bit for bit and leaves the other
    slots' rows as they are."""
    quant, jcfg, jparams, tparams = case
    tcfg = get_arch("zamba2-7b").reduced()
    toks, lens, slot_ids, block = _prefill_inputs(jcfg)
    jcache, tcache = _caches(jcfg, tcfg, block)
    _, jcache = JM.prefill_into_slots(jparams, jcfg, toks, lens, jcache,
                                      slot_ids)
    _, tcache = TM.prefill_into_slots(
        tparams, tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
        tcache, torch.from_numpy(slot_ids))
    jck = JM.checkpoint_slot_state(jcache, 0)
    ck = TM.checkpoint_slot_state(tcache, 0)
    for pool in ("mamba", "tail"):
        for k, v in jck[pool].items():
            np.testing.assert_allclose(ck[pool][k].numpy(), v, rtol=0,
                                       atol=ATOL[quant])
    tok = torch.tensor([3, 4, 5], dtype=torch.int32)
    for _ in range(2):
        _, tcache = TM.decode_step_paged(tparams, tcfg, tok, tcache,
                                         torch.tensor([True, True, True]))
    moved = TM.checkpoint_slot_state(tcache, 0)
    assert not torch.equal(moved["mamba"]["state"], ck["mamba"]["state"])
    other = TM.checkpoint_slot_state(tcache, 2)
    tcache = TM.restore_slot_state(tcache, 0, ck)
    back = TM.checkpoint_slot_state(tcache, 0)
    kept = TM.checkpoint_slot_state(tcache, 2)
    for pool in ("mamba", "tail"):
        for k in ck[pool]:
            assert torch.equal(back[pool][k], ck[pool][k])
            assert torch.equal(kept[pool][k], other[pool][k])
    assert TM.checkpoint_slot_state(
        TM.init_paged_cache(get_arch("llama2-7b").reduced(), 2, 16,
                            device="cpu"), 0) is None


def test_unported_families_raise():
    """Every family has a port branch now, the parallel-block dense model
    (command-r-plus-104b) the last to get one: it builds, runs ``forward``
    and pages.  The ssm
    and audio families serve in wave mode, as in JAX: the paged cache and
    continuous mode refuse them with JAX's ValueError, ``mode="auto"``
    picks wave, and whisper-small's ``init_params`` / ``forward`` run."""
    ssm = get_arch("mamba2-130m").reduced()
    params = TM.init_params(ssm, device="cpu", dtype=torch.float32)
    assert not TM.supports_paged(ssm) and TM.supports_paged(
        get_arch("zamba2-7b"))
    assert TM.has_slot_state(get_arch("zamba2-7b"))
    assert not TM.has_slot_state(ssm) and not TM.has_slot_state(
        get_arch("llama2-7b"))
    with pytest.raises(ValueError):
        TM.init_paged_cache(ssm, 2, 16, device="cpu")
    with pytest.raises(ValueError):
        TEngine(ssm, params, device="cpu", mode="continuous")
    assert TEngine(ssm, params, device="cpu").mode == "wave"
    audio = get_arch("whisper-small").reduced()
    aparams = TM.init_params(audio, device="cpu", dtype=torch.float32)
    frames = torch.zeros((1, audio.encoder_seq, audio.d_model))
    assert TM.forward(aparams, audio, torch.zeros((1, 2), dtype=torch.long),
                      {"frames": frames}).shape == (1, 2, audio.vocab_size)
    assert TEngine(audio, aparams, device="cpu").mode == "wave"
    with pytest.raises(ValueError):
        TM.init_paged_cache(audio, 2, 16, device="cpu")
    assert TM.supports_paged(get_arch("deepseek-v2-lite-16b"))  # ported
    assert TM.supports_paged(get_arch("qwen2-vl-72b"))          # ported
    cfg = get_arch("command-r-plus-104b").reduced()   # the parallel block
    assert cfg.parallel_block and TM.supports_paged(cfg)
    params = TM.init_params(cfg, device="cpu", dtype=torch.float32)
    assert TM.forward(params, cfg, torch.zeros((1, 2), dtype=torch.long)
                      ).shape == (1, 2, cfg.vocab_size)
    assert TM.init_paged_cache(cfg, 2, 16, device="cpu")["k"].shape[0] == \
        cfg.n_layers
    assert TEngine(cfg, params, device="cpu").mode == "continuous"
    with pytest.raises(NotImplementedError):   # still no such family
        TM.init_params(dataclasses.replace(cfg, family="retnet"),
                       device="cpu")


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float", "w8a8"])
def models(request):
    jcfg, jparams = _jax_params("zamba2-7b", request.param, seed=0)
    return jcfg, jparams, get_arch("zamba2-7b").reduced(), _bridge(jparams)


def test_engine_mixed_admission_matches_jax(models):
    """Arrivals while other slots decode (their Mamba state must survive
    the other rows' prefill), a prompt shorter than the conv window, and
    one running request aborted."""
    prompts = _prompts(models, 5, 3, 20, 8, seed=1)
    prompts[2] = _prompts(models, 1, 2, 3, 8, seed=4)[0]   # 2 tokens
    arrive = [0, 0, 1, 3, 6]
    max_new = [8, 4, 7, 6, 3]
    trace = [(a, rid, p, mn) for rid, (a, p, mn)
             in enumerate(zip(arrive, prompts, max_new))]
    (j, jsteps, jreqs), (t, tsteps, treqs) = _both(models, trace,
                                                   aborts=[(4, 3)])
    assert tsteps == jsteps
    assert treqs[3].finish_reason == "aborted"
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
    assert t.stats.prefills == j.stats.prefills > 1


@pytest.mark.parametrize("policy", ["requeue", "reject"])
def test_engine_exhaust_policies_match_jax(models, policy):
    """A 5-page pool under 3 slots: the same requests requeue (restart with
    the generated prefix folded in, re-prefilling the Mamba state) or are
    rejected, at the same steps."""
    prompts = _prompts(models, 4, 3, 8, 10, seed=2)
    trace = [(0, rid, p, 10) for rid, p in enumerate(prompts)]
    (j, jsteps, jreqs), (t, tsteps, treqs) = _both(
        models, trace, num_pages=6, exhaust_policy=policy)
    assert tsteps == jsteps
    for name in ("pool_exhausted", "rejected", "preemptions", "completed"):
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert t.stats.pool_exhausted > 0
    for rid in jreqs:
        assert treqs[rid].rejected == jreqs[rid].rejected
