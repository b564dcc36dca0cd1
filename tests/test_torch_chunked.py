"""The port's chunked prefill against the JAX package's, and its own
bit-identity contract.

Cases of tests/test_chunked_prefill.py, held in the port: prefilling a
prompt in chunks of any size (1 token at a time included) leaves every
valid K/V row, the first-token logits and every later decode logit equal,
bit for bit, to the single-chunk run (float32 weights and pools, as the
JAX test runs); the engine's chunked streams equal its one-shot streams;
a long prompt prefilling in chunks leaves a decoding slot one token every
step.  Against JAX (bridged weights, ``repro_torch.bridge``):
``chunk_spans`` / ``prefill_bucket`` exactly; ``paged_chunk_attention``,
``attn_prefill_chunk_paged`` and ``prefill_chunk_into_slot`` within
float32 summation noise (atol 1e-5 on attention outputs and pages, 1e-4
on logits, as tests/test_torch_model.py states for float32 logits; bf16
inputs within 2 bf16 steps of the output); and the engines' event streams
on margin-checked prompts (tests/test_torch_serving.py's method), W8A8,
synchronous and overlapped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro.serving.kv_cache import (chunk_spans as jchunk_spans,
                                    prefill_bucket as jprefill_bucket)
from repro.serving.scheduler import FCFSScheduler as JFCFS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.decode_attention.ops import paged_chunk_attention
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest
from repro_torch.serving.kv_cache import chunk_spans, prefill_bucket
from repro_torch.serving.scheduler import FCFSScheduler
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_serving import _drive, _prompts

PAGE = 8
ATTN_ATOL = 1e-5
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def f32():
    """(JAX cfg, JAX float32 params, port cfg, bridged params)."""
    jcfg = ASSIGNED_ARCHS["smollm-360m"].reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    return (jcfg, jparams, get_arch("smollm-360m").reduced(),
            params_from_numpy(jax.tree.map(np.asarray, jparams)))


def _prompt(cfg, n=13):
    return [int(t) for t in
            jax.random.randint(jax.random.PRNGKey(0), (n,), 0,
                               cfg.vocab_size)]


@pytest.mark.parametrize("n,budget", [(13, 4), (8, 8), (3, 100), (1, 1),
                                      (33, 8), (16, 3)])
def test_chunk_spans_and_buckets_match_jax(n, budget):
    assert chunk_spans(n, budget) == jchunk_spans(n, budget)
    for floor in (8, 16, 4):
        assert prefill_bucket(n, floor=floor) == jprefill_bucket(n, floor=floor)
    assert prefill_bucket(n) == jprefill_bucket(n)
    with pytest.raises(ValueError):
        chunk_spans(n, 0)


def _pool_pair(rng, n_pages, hkv, d, kv, dtype):
    """The same random page pool for JAX and the port: bf16 / float32
    arrays, or int8 (data, scale) pairs."""
    if kv == "int8":
        data = rng.randint(-127, 128, (n_pages, PAGE, hkv, d)).astype(np.int8)
        scale = (rng.rand(n_pages, PAGE, hkv) * 0.05 + 1e-3).astype(np.float32)
        return ((jnp.asarray(data), jnp.asarray(scale)),
                (torch.from_numpy(data), torch.from_numpy(scale)))
    x = rng.randn(n_pages, PAGE, hkv, d).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == jnp.bfloat16:   # both round once to bf16: 2 bf16 steps
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                   2.0 ** -126))) - 7)
        assert np.all(np.abs(got - want) <= 2 * step + ATTN_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_chunk_attention_matches_jax(dtype, kv):
    """Chunk queries at positions 5..20 of a slot whose pages are scattered
    over the pool, 4 heads on 2 kv heads, against the JAX formula; the port
    wrapper on a CPU tensor takes the same plain version."""
    rng = np.random.RandomState(3)
    c, h, hkv, d, n_pages = 16, 4, 2, 16, 9
    kp, tkp = _pool_pair(rng, n_pages, hkv, d, kv, dtype)
    vp, tvp = _pool_pair(rng, n_pages, hkv, d, kv, dtype)
    block = np.array([[4, 7, 1, 8]], np.int32)
    q = jnp.asarray(rng.randn(1, c, h, d).astype(np.float32), dtype)
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    pos = 5 + np.arange(c, dtype=np.int32)[None]
    want = JA.paged_chunk_attention(q, kp, vp, jnp.asarray(block),
                                    jnp.asarray(pos))
    got = TA.paged_chunk_attention(tq, tkp, tvp, torch.from_numpy(block),
                                   torch.from_numpy(pos))
    _close(got, want, dtype)
    via_op = paged_chunk_attention(tq[0], tkp, tvp, torch.from_numpy(block[0]),
                                   5, c)
    assert torch.equal(via_op, got[0])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_attn_prefill_chunk_paged_matches_jax(f32, dtype, kv):
    """One layer's chunk attention (q/k/v/o projections, rope, the
    scatter, the attend) and the pools it writes, 11 valid rows of a
    16-row bucket at start 6; padding rows land on the null page."""
    jcfg, jparams, tcfg, tparams = f32
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    tlp = tparams["layers"][0]["attn"]
    if dtype == jnp.bfloat16:
        jlp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jlp)
        tlp = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
               for k, v in tlp.items()}
    rng = np.random.RandomState(5)
    c, start, clen = 16, 6, 11
    x = rng.randn(1, c, jcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    shape = (6, PAGE, jcfg.n_kv_heads, jcfg.d_head)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    if kv == "int8":
        jk = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape[:-1], jnp.float32))
        jv = (jnp.zeros(shape, jnp.int8), jnp.zeros(shape[:-1], jnp.float32))
        tk = (torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:-1]))
        tv = (torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:-1]))
    else:
        jk = jv = jnp.zeros(shape, dtype)
        tk, tv = torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)
    row = np.array([3, 5, 2, 0], np.int32)
    valid = np.arange(c) < clen
    jout, jk, jv = JB.attn_prefill_chunk_paged(
        jlp, jx, jcfg, jk, jv, jnp.asarray(row),
        jnp.asarray(start + np.arange(c, dtype=np.int32))[None],
        jnp.asarray(valid))
    tout = TB.attn_prefill_chunk_paged(tlp, tx, tcfg, tk, tv,
                                       torch.from_numpy(row), start, clen)
    live = slice(0, clen)
    _close(tout[:, live], jout[:, live], dtype)
    rows = [(row[p // PAGE], p % PAGE) for p in range(start, start + clen)]
    for jpool, tpool in ((jk, tk), (jv, tv)):
        if kv == "int8":   # codes may sit on the other side of a rounding tie
            jd, js = (np.asarray(a) for a in jpool)
            for pid, off in rows:
                assert np.abs(tpool[0][pid, off].int().numpy()
                              - jd[pid, off].astype(np.int32)).max() <= 1
                np.testing.assert_allclose(tpool[1][pid, off].numpy(),
                                           js[pid, off], rtol=1e-5)
        else:
            for pid, off in rows:
                _close(tpool[pid, off], jpool[pid, off], dtype)


def _chunked_then_decode(cfg, params, prompt, budget, kv="bf16",
                         n_decode=5):
    """Prefill through prefill_chunk_into_slot in ``budget``-token chunks
    (the engine's buckets, floor = page size), then 5 greedy decode steps;
    returns (logits list, the slot's valid K/V rows)."""
    pc = TM.init_paged_cache(cfg, 2, 32, dtype=torch.float32, page_size=PAGE,
                             device="cpu", kv_dtype=kv)
    pps = 32 // PAGE
    pc["block"] = torch.zeros((2, pps), dtype=torch.int32)
    pc["block"][0] = torch.arange(1, pps + 1)
    for start, clen in chunk_spans(len(prompt), budget):
        cb = min(prefill_bucket(clen, floor=PAGE), pps * PAGE)
        toks = torch.zeros(cb, dtype=torch.int32)
        toks[:clen] = torch.tensor(prompt[start:start + clen])
        lg, pc = TM.prefill_chunk_into_slot(params, cfg, toks, start, clen,
                                            pc, 0)
    assert int(pc["lens"][0]) == len(prompt)
    n = len(prompt)
    rows = {k: pc[k][:, 1:].reshape(pc[k].shape[0], -1,
                                    *pc[k].shape[3:])[:, :n].clone()
            for k in TB.paged_pool_keys(pc)}
    logits = [lg.clone()]
    tok = torch.zeros(2, dtype=torch.int32)
    tok[0] = int(torch.argmax(lg))
    active = torch.tensor([True, False])
    for _ in range(n_decode):
        out, pc = TM.decode_step_paged(params, cfg, tok, pc, active)
        logits.append(out[0].clone())
        tok[0] = int(torch.argmax(out[0]))
    return logits, rows


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("budget", [1, 7, PAGE])
def test_chunked_prefill_bit_identical_to_one_shot(f32, budget, kv):
    """The port's own contract, float32: the valid K/V rows, the first
    token's logits and 5 decode logits equal the single-chunk run's, bit
    for bit, for budgets {1, 7, page} against {len}."""
    _, _, cfg, params = f32
    prompt = _prompt(cfg)
    one_shot, one_rows = _chunked_then_decode(cfg, params, prompt,
                                              len(prompt), kv)
    got, rows = _chunked_then_decode(cfg, params, prompt, budget, kv)
    for key in one_rows:
        assert torch.equal(rows[key], one_rows[key]), key
    for a, b in zip(one_shot, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_chunk_into_slot_matches_jax(f32, kv):
    """Chunks of 5, 9 and 3 tokens (buckets 8 and 16) into a slot whose
    pages are not in order: the logits of each chunk and the slot's pages
    against JAX's (int8: codes within one step, scales within 1e-5)."""
    jcfg, jparams, tcfg, tparams = f32
    rng = np.random.RandomState(7)
    jc = JM.init_paged_cache(jcfg, 2, 32, dtype=jnp.float32, page_size=PAGE,
                             kv_dtype=kv)
    block = np.array([[3, 1, 4, 2], [0, 0, 0, 0]], np.int32)
    jc["block"] = jnp.asarray(block)
    tc = TM.init_paged_cache(tcfg, 2, 32, dtype=torch.float32,
                             page_size=PAGE, device="cpu", kv_dtype=kv)
    tc["block"] = torch.from_numpy(block)
    jf = jax.jit(lambda p, t, s, n, c, sl: JM.prefill_chunk_into_slot(
        p, jcfg, t, s, n, c, sl))
    start = 0
    for clen in (5, 9, 3):
        toks = rng.randint(0, jcfg.vocab_size,
                           prefill_bucket(clen, floor=PAGE)).astype(np.int32)
        jl, jc = jf(jparams, toks, np.int32(start), np.int32(clen), jc,
                    np.int32(0))
        tl, tc = TM.prefill_chunk_into_slot(tparams, tcfg,
                                            torch.from_numpy(toks), start,
                                            clen, tc, 0)
        start += clen
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        assert int(tc["lens"][0]) == int(jc["lens"][0]) == start
    pages = block[0]
    for key in TB.paged_pool_keys(tc):
        got, want = tc[key][:, pages].numpy(), np.asarray(jc[key][:, pages])
        if key in ("k", "v") and kv == "int8":
            assert np.abs(got.astype(np.int32) - want).max() <= 1
        elif kv == "int8":
            np.testing.assert_allclose(got, want, rtol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_ATOL)


def test_chunked_prefill_matches_legacy_prefill(f32):
    """Cross-path: the chunked path against prefill_into_slots, which
    attends another buffer arrangement (allclose + greedy tokens)."""
    _, _, cfg, params = f32
    prompt = _prompt(cfg)
    chunked, _ = _chunked_then_decode(cfg, params, prompt, 7)
    pc = TM.init_paged_cache(cfg, 2, 32, dtype=torch.float32, page_size=PAGE,
                             device="cpu")
    pc["block"] = torch.zeros((2, 4), dtype=torch.int32)
    pc["block"][0] = torch.arange(1, 5)
    padded = torch.tensor([prompt + [0] * (16 - len(prompt))])
    lg, pc = TM.prefill_into_slots(params, cfg, padded,
                                   torch.tensor([len(prompt)]), pc,
                                   torch.tensor([0]))
    legacy = [lg[0]]
    tok = torch.zeros(2, dtype=torch.int32)
    tok[0] = int(torch.argmax(lg[0]))
    for _ in range(5):
        out, pc = TM.decode_step_paged(params, cfg, tok, pc,
                                       torch.tensor([True, False]))
        legacy.append(out[0])
        tok[0] = int(torch.argmax(out[0]))
    for a, b in zip(legacy, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
        assert int(torch.argmax(a)) == int(torch.argmax(b))


def test_chunked_prefill_rejects_unsupported_family():
    for arch in ("zamba2-7b", "mamba2-130m"):
        cfg = get_arch(arch).reduced()
        assert not TM.supports_chunked_prefill(cfg)
        with pytest.raises(ValueError):
            TM.prefill_chunk_into_slot({}, cfg, torch.zeros(8,
                                                            dtype=torch.int32),
                                       0, 1, {}, 0)


@pytest.fixture(scope="module")
def bf16():
    cfg = get_arch("smollm-360m").reduced()
    return cfg, TM.init_params(cfg, seed=0, max_seq=64, device="cpu")


def test_engine_chunked_outputs_match_one_shot(bf16):
    """One request served with budgets {1, 4, page} gives the one-shot
    run's tokens, with ceil(len / budget) chunks recorded."""
    cfg, params = bf16
    prompt = _prompt(cfg, 20)

    def serve(budget):
        req = TRequest(rid=0, prompt=list(prompt), max_new_tokens=6)
        eng = TEngine(cfg, params, max_batch=2, max_seq=48, eos_id=-1,
                      page_size=PAGE, device="cpu",
                      scheduler=FCFSScheduler(chunk_tokens=budget)
                      if budget else None)
        eng.add_request(req)
        eng.run()
        assert req.done and req.finish_reason == "length"
        return req

    base = serve(None)
    assert base.n_chunks == 0
    for budget in (1, 4, PAGE):
        req = serve(budget)
        assert req.out_tokens == base.out_tokens, budget
        assert req.n_chunks == -(-len(prompt) // budget)


def test_chunked_prefill_does_not_starve_decode(bf16):
    """While a long prompt prefills in chunks, the decoding slot emits one
    token on every engine step."""
    cfg, params = bf16
    short = TRequest(rid=1, prompt=[3, 1, 4], max_new_tokens=30)
    long_prompt = _prompt(cfg, 24)
    long = TRequest(rid=2, prompt=long_prompt, max_new_tokens=4)
    eng = TEngine(cfg, params, max_batch=2, max_seq=48, eos_id=-1,
                  page_size=PAGE, device="cpu",
                  scheduler=FCFSScheduler(chunk_tokens=4))
    eng.add_request(short)
    eng.step()
    eng.add_request(long)
    per_step = []
    while long.t_first_token == 0.0:
        evs = eng.step()
        per_step.append(sum(1 for e in evs
                            if e.rid == 1 and e.token is not None))
    assert long.n_chunks == -(-len(long_prompt) // 4)
    assert len(per_step) >= long.n_chunks
    assert all(n == 1 for n in per_step), per_step
    stats = eng.run()
    assert short.done and long.done
    assert stats.prefill_chunks == long.n_chunks
    assert "prefill_chunks=6" in stats.summary()


def test_hybrid_engine_with_a_budget_prefills_in_one_shot():
    """zamba2 has no chunked prefill: a budget is accepted and every prompt
    takes the group prefill, as the JAX engine's _chunk_ok makes it."""
    cfg = get_arch("zamba2-7b").reduced()
    params = TM.init_params(cfg, seed=0, max_seq=64, device="cpu")
    eng = TEngine(cfg, params, max_batch=2, max_seq=32, eos_id=-1,
                  page_size=4, device="cpu",
                  scheduler=FCFSScheduler(chunk_tokens=2))
    req = TRequest(rid=0, prompt=[5, 6, 7, 8, 9, 10], max_new_tokens=3)
    eng.add_request(req)
    stats = eng.run()
    assert req.done and len(req.out_tokens) == 3
    assert req.n_chunks == 0 and stats.prefill_chunks == 0
    assert stats.prefills == 1


@pytest.fixture(scope="module")
def w8a8():
    jcfg = ASSIGNED_ARCHS["smollm-360m"].reduced()
    jparams = jquantize(JM.init_params(jcfg, jax.random.PRNGKey(0),
                                       dtype=jnp.float32, max_seq=64),
                        mode="w8a8")
    return (jcfg, jparams, get_arch("smollm-360m").reduced(),
            params_from_numpy(jax.tree.map(np.asarray, jparams)))


@pytest.mark.parametrize("overlap,kv", [(False, "bf16"), (True, "bf16"),
                                        (True, "int8")],
                         ids=["sync", "overlap", "overlap-int8"])
def test_chunked_engine_matches_jax(w8a8, overlap, kv):
    """W8A8, budget 4, prompts of 3-19 tokens arriving while others decode:
    the port's and the JAX engine's events at every step, and the same
    chunk counts (bf16 pools, and int8 pools overlapped)."""
    jcfg, jparams, tcfg, tparams = w8a8
    prompts = _prompts(w8a8, 5, 3, 20, 6, seed=6)
    trace = [(a, rid, p, 6) for rid, (a, p)
             in enumerate(zip([0, 0, 1, 2, 4], prompts))]
    kw = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=PAGE,
              overlap=overlap, kv_dtype=kv)
    j = JEngine(jcfg, jparams, scheduler=JFCFS(chunk_tokens=4), **kw)
    t = TEngine(tcfg, tparams, scheduler=FCFSScheduler(chunk_tokens=4),
                device="cpu", **kw)
    jsteps, jreqs = _drive(j, JRequest, trace)
    tsteps, treqs = _drive(t, TRequest, trace)
    assert tsteps == jsteps
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
        assert treqs[rid].n_chunks == jreqs[rid].n_chunks
    assert t.stats.prefill_chunks == j.stats.prefill_chunks > 0
