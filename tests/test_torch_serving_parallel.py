"""The port's engine serving the parallel-block dense model
(command-r-plus-104b, reduced) against the JAX engine, and the engine
invariants of the other families' files run over its weights.

Against JAX, on bridged JAX weights (float32 init, optionally W8A8), the
events of every step equal in each mode the JAX engine has:

- synchronous continuous batching, arrivals while other slots decode
  (float32 and W8A8 weights);
- the overlapped loop (one fused decode + sample dispatch a step);
- chunked prefill (budget 4; synchronous and overlapped);
- int8 page pools;
- a prefix-caching trace (a cold admission, its resume hit, a partial hit
  whose suffix is chunked, its resume hit): the prefix counters too;
- the flash KV tier under a 5-page hot pool: preemptions, resumes and
  the spilled and prefetched pages too;
- a starved tiered replica beside an idle donor behind a router that
  migrates slots: the streams and the number of migrations;
- wave mode, synchronous and overlapped (test_torch_wave.py's check).

Greedy streams are compared only on margin-checked prompts: the port's
own greedy run of a prompt, over the same kind of pools, keeps the top-1 /
top-2 logit gap above MARGIN at every step (tests/test_quant_serving.py:
83-99).

Port invariants over the parallel block's weights (the port's own float32
init), collected from the other files: sync == overlapped (greedy,
sampled, eos at the lagged drain, a requeue, a slot at capacity, an
abort), tiered == all-resident and a bounded tier, resume hits == cold
runs, a partial hit prefilling only its suffix, shared pages through the
tier, a migrated slot == the unmigrated run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro.serving.router import Router as JRouter
from repro.serving.scheduler import FCFSScheduler as JFCFS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest
from repro_torch.serving.router import Router as TRouter
from repro_torch.serving.scheduler import FCFSScheduler
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_migrate import (  # noqa: F401  (collected here)
    _starved_pair, test_slot_migration_bit_identity)
from test_torch_overlap import (  # noqa: F401  (collected here)
    test_overlap_abort_mid_stream, test_overlap_bit_identical,
    test_overlap_capacity_identity, test_overlap_eos_lag_identity,
    test_overlap_requeue_identity)
from test_torch_prefix import (  # noqa: F401  (collected here)
    test_partial_hit_prefills_only_the_suffix,
    test_refcounted_release_parks_and_reclaims,
    test_resume_hit_bit_identity, test_resume_hit_one_token_request,
    test_tiered_spill_prefetch_shared_pages)
from test_torch_serving import _drive
from test_torch_tiered import (  # noqa: F401  (collected here)
    test_tiered_engine_bounded_flash_tier,
    test_tiered_engine_matches_all_resident)
from test_torch_wave import check_engine_against_jax

ARCH = "command-r-plus-104b"
MARGIN = 1e-2
ENG = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8)
PX_STATS = ("prefix_lookups", "prefix_hits", "prefix_hit_pages",
            "prefix_tokens_reused", "cow_copies", "prefills",
            "prefill_chunks")
TIER_STATS = ("preemptions", "resumes", "kv_spill_pages",
              "kv_prefetch_pages", "decode_steps", "pool_exhausted")


@pytest.fixture(scope="module")
def fam():
    """(family, port cfg, the port's own float32 weights): the other
    files' family cases run over them."""
    cfg = get_arch(ARCH).reduced()
    assert cfg.parallel_block
    return "dense", cfg, TM.init_params(cfg, seed=0, max_seq=64,
                                        device="cpu", dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _models(quant="float"):
    """(JAX cfg, JAX params, port cfg, bridged params), float32 init."""
    jcfg = jget_arch(ARCH).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    if quant != "float":
        jparams = jquantize(jparams, mode=quant)
    return (jcfg, jparams, get_arch(ARCH).reduced(),
            params_from_numpy(jax.tree.map(np.asarray, jparams)))


def _min_margin(cfg, params, prompt, n_new, kv="bf16") -> float:
    """Smallest top-1 / top-2 logit gap of the port's greedy run of
    ``prompt`` alone over ``kv`` pools."""
    cache = TM.init_paged_cache(cfg, 1, 64, dtype=torch.bfloat16,
                                page_size=8, device="cpu", kv_dtype=kv)
    cache["block"] = torch.arange(1, 9, dtype=torch.int32)[None]
    logits, cache = TM.prefill_into_slot(params, cfg, torch.tensor([prompt]),
                                         len(prompt), cache, 0)
    gaps = []
    for _ in range(n_new):
        top = torch.topk(logits, 2).values
        gaps.append(float(top[0] - top[1]))
        tok = torch.argmax(logits).reshape(1).to(torch.int32)
        logits, cache = TM.decode_step_paged(params, cfg, tok, cache,
                                             torch.tensor([True]))
        logits = logits[0]
    return min(gaps)


def _prompts(models, n, lo, hi, max_new, seed, kv="bf16"):
    _, _, cfg, params = models
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        p = rng.randint(0, cfg.vocab_size, rng.randint(lo, hi)).tolist()
        if _min_margin(cfg, params, p, max_new, kv) > MARGIN:
            out.append(p)
    return out


def _engines(models, chunk=0, **kw):
    """A JAX and a port engine on the same weights (``chunk``: a chunked
    prefill budget for both schedulers)."""
    jcfg, jparams, cfg, params = models
    jkw, tkw = dict(kw), dict(kw)
    if chunk:
        jkw["scheduler"] = JFCFS(chunk_tokens=chunk)
        tkw["scheduler"] = FCFSScheduler(chunk_tokens=chunk)
    return (JEngine(jcfg, jparams, **{**ENG, **jkw}),
            TEngine(cfg, params, **{**ENG, **tkw}, device="cpu"))


MODES = {"sync": {}, "overlap": dict(overlap=True),
         "chunked": dict(chunk=4), "chunked-overlap": dict(chunk=4,
                                                           overlap=True),
         "int8": dict(kv_dtype="int8")}


@pytest.mark.parametrize("quant", ["float", "w8a8"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_match_jax(mode, quant):
    """Arrivals while other slots decode: the same events at the same
    steps as the JAX engine, and the same chunk counts."""
    models = _models(quant)
    kw = MODES[mode]
    max_new = [8, 4, 7, 6, 5]
    prompts = _prompts(models, 5, 3, 20, 8, seed=3,
                       kv=kw.get("kv_dtype", "bf16"))
    trace = [(a, rid, p, mn) for rid, (a, p, mn)
             in enumerate(zip([0, 0, 1, 3, 4], prompts, max_new))]
    j, t = _engines(models, **kw)
    jsteps, jreqs = _drive(j, JRequest, trace)
    tsteps, treqs = _drive(t, TRequest, trace)
    assert tsteps == jsteps
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
        assert treqs[rid].n_chunks == jreqs[rid].n_chunks
    assert t.stats.prefills == j.stats.prefills
    assert t.stats.prefills + t.stats.prefill_chunks > 1
    assert t.stats.decode_dispatches == j.stats.decode_dispatches
    assert t.stats.prefill_chunks == j.stats.prefill_chunks
    assert (t.stats.prefill_chunks > 0) == ("chunk" in kw)
    assert t.kv_page_bytes == j.kv_page_bytes


def test_prefix_trace_matches_jax():
    """a, a, b, b through prefix-caching engines (b shares a's first 16
    tokens): two resume hits and a partial hit whose suffix goes through
    the chunk path; equal counters and streams."""
    models = _models()
    _, _, cfg, params = models
    rng = np.random.RandomState(11)
    while True:
        pfx = rng.randint(0, cfg.vocab_size, 16).tolist()
        a = pfx + rng.randint(0, cfg.vocab_size, 3).tolist()
        b = pfx + rng.randint(0, cfg.vocab_size, 5).tolist()
        if all(_min_margin(cfg, params, p, 6) > MARGIN for p in (a, b)):
            break
    j, t = _engines(models, prefix_cache=True)
    outs = {}
    for name, eng, req in (("port", t, TRequest), ("jax", j, JRequest)):
        outs[name] = []
        for i, p in enumerate((a, a, b, b)):
            r = req(rid=i, prompt=list(p), max_new_tokens=6)
            eng.add_request(r)
            eng.run()
            outs[name].append(list(r.out_tokens))
    for name in PX_STATS:
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == outs["port"][1]
    assert t.stats.prefix_hits == 3 and t.stats.prefill_chunks > 0


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_tiered_engine_matches_jax(overlap):
    """A 5-page hot pool over the flash tier: the same events, preemptions,
    resumes and spilled and prefetched pages."""
    models = _models()
    prompts = _prompts(models, 5, 3, 8, 14, seed=4)
    trace = [(0, rid, p, 10 + 2 * rid) for rid, p in enumerate(prompts)]
    j, t = _engines(models, num_pages=6, kv_tier="flash", overlap=overlap)
    jsteps, _ = _drive(j, JRequest, trace)
    tsteps, _ = _drive(t, TRequest, trace)
    assert tsteps == jsteps
    for name in TIER_STATS:
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert t.stats.kv_spill_pages > 0


def test_router_migration_matches_jax():
    """Every request piled on a starved tiered replica beside an idle donor
    (session affinity): both routers migrate slots off it the same number
    of times, and the streams equal the JAX router's."""
    jcfg, jparams, cfg, params = models = _models()
    prompts = _prompts(models, 4, 3, 7, 12, seed=8)

    def run(engine_cls, router_cls, req_cls, cfg_, params_, **extra):
        starved, donor, cores = _starved_pair(engine_cls, cfg_, params_,
                                              **extra)
        rt = router_cls(cores, policy="session_affinity", migrate=True)
        reqs = [req_cls(rid=i, prompt=list(p), max_new_tokens=12,
                        session="hot") for i, p in enumerate(prompts)]
        for r in reqs:
            assert rt.submit(r) is starved
        steps = 0
        while rt.has_work and steps < 500:
            rt.step()
            steps += 1
        assert donor.stats.migrated_in == rt.migrations
        return [r.out_tokens for r in reqs], rt.migrations

    tout, tmig = run(TEngine, TRouter, TRequest, cfg, params, device="cpu")
    jout, jmig = run(JEngine, JRouter, JRequest, jcfg, jparams)
    assert tout == jout
    assert tmig == jmig > 0


def test_wave_engine_matches_jax():
    check_engine_against_jax(ARCH)
