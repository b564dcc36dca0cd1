"""The port's prefix cache against the JAX package's.

Mirrors tests/test_prefix_cache.py.  ``PrefixIndex`` gives JAX's chain
and resume keys byte for byte and follows the same idle-LRU and resume-cap
ops (its index tests, :58 and :75); an exact-prompt resume hit admits with
zero prefill dispatches and emits the cold run's stream, greedy and
seed-pinned sampled, dense and hybrid (the Mamba state restored from the
resume point); a partial hit prefills only the suffix through the chunk
path and equals the cold run (float32 weights, where the CPU's one-shot
and chunk paths give the same bits), and int8 pools refuse partial hits
as JAX's do; ``prefix_hits``, ``prefix_hit_pages``,
``prefix_tokens_reused`` and ``cow_copies`` equal the JAX engine's on the
same trace, and so do the streams on bridged weights and margin-checked
prompts (tests/test_torch_serving.py's method); refcounts return to idle,
idle pages are reclaimed under pressure and spill to the flash tier and
come back; the router's ``session_affinity`` and ``least_loaded`` follow
the cache.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro.serving.kv_cache import (PrefixIndex as JIndex,
                                    ResumeEntry as JResume)
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest
from repro_torch.serving.kv_cache import (PrefixIndex as TIndex,
                                          ResumeEntry as TResume)
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_serving import _min_margin

ENG = dict(max_batch=2, max_seq=64, eos_id=-1, page_size=8)
PROMPT = list(range(1, 19))  # 18 tokens: 2 full pages + a 2-token tail
ARCHS = {"dense": "smollm-360m", "hybrid": "zamba2-7b",
         "moe": "qwen2-moe-a2.7b"}


@pytest.fixture(scope="module")
def f32():
    """(JAX cfg, JAX float32 params, port cfg, bridged params)."""
    jcfg = ASSIGNED_ARCHS["smollm-360m"].reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    return (jcfg, jparams, get_arch("smollm-360m").reduced(),
            params_from_numpy(jax.tree.map(np.asarray, jparams)))


@pytest.fixture(scope="module", params=sorted(ARCHS),
                ids=lambda f: f"fam_{f}")
def fam(request):
    cfg = get_arch(ARCHS[request.param]).reduced()
    return request.param, cfg, TM.init_params(
        cfg, seed=0, max_seq=64, device="cpu", dtype=torch.float32)


def _len0(cfg, prompt=PROMPT) -> int:
    """Cache length of a prompt: vlm prepends its vision rows (keyed by
    sentinels), as tests/test_prefix_cache.py:32 counts them."""
    return len(prompt) + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


def _sp(stochastic, seed=7):
    return (SamplingParams(temperature=0.8, top_k=20, seed=seed)
            if stochastic else None)


def _cold(cfg, params, prompts, max_new=6, sampling=None, **kw):
    """Streams with prefix caching off, each request on its own."""
    eng = TEngine(cfg, params, **{**ENG, **kw}, device="cpu")
    outs = []
    for i, p in enumerate(prompts):
        r = TRequest(rid=i, prompt=list(p), max_new_tokens=max_new,
                     sampling=sampling)
        eng.add_request(r)
        eng.run()
        outs.append(list(r.out_tokens))
    return outs


def _warm(engine, req_cls, prompts, max_new=6, sampling=None):
    """The same prompts one after another through one prefix-caching
    engine; returns the streams."""
    outs = []
    for i, p in enumerate(prompts):
        r = req_cls(rid=i, prompt=list(p), max_new_tokens=max_new,
                    sampling=sampling)
        engine.add_request(r)
        engine.run()
        outs.append(list(r.out_tokens))
    return outs


PX_STATS = ("prefix_lookups", "prefix_hits", "prefix_hit_pages",
            "prefix_tokens_reused", "cow_copies", "prefills",
            "prefill_chunks")


# ---------------------------------------------------------------- index
@pytest.mark.parametrize("index", [TIndex, JIndex], ids=["port", "jax"])
def test_prefix_index_chain_and_resume_keys(index):
    """tests/test_prefix_cache.py:58 on both indexes, and the port's keys
    are JAX's bytes."""
    px = index(page_size=4)
    a = px.page_keys([1, 2, 3, 4, 5, 6, 7, 8, 9])
    b = px.page_keys([1, 2, 3, 4, 5, 6, 7, 8])
    assert len(a) == 2 and a[:2] == b[:2]
    c = px.page_keys([9, 2, 3, 4, 5, 6, 7, 8])
    assert c[0] != a[0] and c[1] != a[1]
    r1 = px.resume_key([1, 2, 3, 4, 5, 6, 7, 8, 9])
    r2 = px.resume_key([1, 2, 3, 4, 5, 6, 7, 8])
    assert r1 != r2 and r2 not in (a + c)
    assert px.match(a) == 0
    px.insert(a[0], 5)
    assert px.match(a) == 1 and px.match(c) == 0
    rng = np.random.RandomState(2)
    for n in (0, 3, 8, 21, 64):
        toks = rng.randint(0, 1000, n).tolist()
        assert px.page_keys(toks) == JIndex(4).page_keys(toks)
        assert px.resume_key(toks) == JIndex(4).resume_key(toks)


@pytest.mark.parametrize("index,entry", [(TIndex, TResume), (JIndex, JResume)],
                         ids=["port", "jax"])
def test_prefix_index_idle_lru_and_resume_cap(index, entry):
    """tests/test_prefix_cache.py:75 on both indexes."""
    px = index(page_size=4, resume_cap=2)
    keys = px.page_keys(list(range(16)))
    for j, k in enumerate(keys):
        px.insert(k, j + 1)
    px.park(keys[0])
    px.park(keys[1])
    px.unpark(keys[0])
    assert px.n_idle == 1 and px.n_idle_hot == 1
    px.mark_cold(keys[1])
    assert px.n_idle_hot == 0 and px.cold_idle_keys(5) == [keys[1]]
    assert px.pop_idle_hot(5) == []
    px.mark_hot(keys[1], 9)
    assert px.n_idle == 0
    px.park(keys[2])
    assert px.pop_idle_hot(5) == [(keys[2], 3)]
    assert px.get(keys[2]) is None
    for i in range(3):
        px.put_resume(bytes([i]) * 32, entry(
            page_keys=[], tail=None, tail_len=0, logits=np.zeros(4),
            length=1))
    assert px.n_resume == 2 and px.peek_resume(bytes([0]) * 32) is None


# ------------------------------------------------------- exact-prompt hits
@pytest.mark.parametrize("sampling", ["greedy", "stochastic"])
def test_resume_hit_bit_identity(fam, sampling):
    """A resubmitted prompt admits with zero prefill dispatches and emits
    the cold run's stream; every full page shared, the tail copied."""
    family, cfg, params = fam
    sp = _sp(sampling == "stochastic")
    cold = _cold(cfg, params, [PROMPT, PROMPT], sampling=sp)
    assert cold[0] == cold[1]
    eng = TEngine(cfg, params, prefix_cache=True, **ENG, device="cpu")
    warm = _warm(eng, TRequest, [PROMPT], sampling=sp)
    prefills, chunks = eng.stats.prefills, eng.stats.prefill_chunks
    warm += _warm(eng, TRequest, [PROMPT], sampling=sp)
    assert warm == cold
    assert (eng.stats.prefills, eng.stats.prefill_chunks) == (prefills,
                                                              chunks)
    s, len0 = eng.stats, _len0(cfg)
    assert (s.prefix_hits, s.prefix_lookups, s.prefix_hit_pages,
            s.prefix_tokens_reused, s.cow_copies) == (
        1, 2, len0 // 8, len0, 1 if len0 % 8 else 0)


def test_resume_hit_one_token_request(fam):
    """A request finishing on its prefill-sampled token still leaves its
    pages and resume point behind."""
    family, cfg, params = fam
    cold = _cold(cfg, params, [PROMPT, PROMPT], max_new=1)
    eng = TEngine(cfg, params, prefix_cache=True, **ENG, device="cpu")
    assert _warm(eng, TRequest, [PROMPT, PROMPT], max_new=1) == cold
    assert eng.stats.prefix_hits == 1


# ------------------------------------------------------- partial hits
def test_partial_hit_prefills_only_the_suffix(fam):
    """A new continuation of a cached prefix maps the shared full pages and
    prefills the suffix through the chunk path (dense, moe); the hybrid
    family takes a clean miss.  Both equal the cold runs."""
    family, cfg, params = fam
    pfx = list(range(1, 17))
    a, b = pfx + [20, 21], pfx + [30, 31, 32, 33]
    cold = _cold(cfg, params, [a, b])
    eng = TEngine(cfg, params, prefix_cache=True, **ENG, device="cpu")
    warm = _warm(eng, TRequest, [a])
    prefills = eng.stats.prefills
    warm += _warm(eng, TRequest, [b])
    assert warm == cold
    s = eng.stats
    if family in ("dense", "moe"):
        assert (s.prefix_hits, s.prefix_hit_pages,
                s.prefix_tokens_reused) == (1, 2, 16)
        assert s.prefills == prefills and s.prefill_chunks == 1
    else:
        assert s.prefix_hits == 0


def test_int8_pools_refuse_partial_hits_keep_resume_hits(f32):
    """As in the JAX engine (its core.py:1240-1247): under int8 pools a
    partial hit is a miss, a resume hit still replays stored bits."""
    _, _, tcfg, tparams = f32
    pfx = list(range(1, 17))
    eng = TEngine(tcfg, tparams, prefix_cache=True, kv_dtype="int8", **ENG,
                  device="cpu")
    cold = _cold(tcfg, tparams, [pfx + [20, 21], pfx + [30, 31], PROMPT,
                                 PROMPT], kv_dtype="int8")
    assert _warm(eng, TRequest, [pfx + [20, 21], pfx + [30, 31], PROMPT,
                                 PROMPT]) == cold
    assert eng.stats.prefix_hits == 1
    assert eng.stats.prefix_tokens_reused == len(PROMPT)


def _margin_ok(f32, prompt, max_new):
    return _min_margin(f32[2], f32[3], prompt, max_new) > 1e-2


def _margin_prompts(f32, max_new=6):
    """Two prompts with a common 16-token prefix, both margin-checked."""
    rng = np.random.RandomState(11)
    vocab = f32[2].vocab_size
    while True:
        pfx = rng.randint(0, vocab, 16).tolist()
        a = pfx + rng.randint(0, vocab, 3).tolist()
        b = pfx + rng.randint(0, vocab, 5).tolist()
        if _margin_ok(f32, a, max_new) and _margin_ok(f32, b, max_new):
            return a, b


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefix_trace_matches_jax(f32, kv):
    """The same warm trace (a cold admission, its resume hit, a partial
    hit, a resume hit of that) through the port's and the JAX engines:
    equal prefix counters and equal streams."""
    jcfg, jparams, tcfg, tparams = f32
    a, b = _margin_prompts(f32)
    prompts = [a, a, b, b]
    t = TEngine(tcfg, tparams, prefix_cache=True, kv_dtype=kv, **ENG,
                device="cpu")
    j = JEngine(jcfg, jparams, prefix_cache=True, kv_dtype=kv, **ENG)
    tout = _warm(t, TRequest, prompts)
    jout = _warm(j, JRequest, prompts)
    for name in PX_STATS:
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert tout == jout
    assert t.stats.prefix_hits == (3 if kv == "bf16" else 2)


# -------------------------------------------------- release / reclamation
def test_refcounted_release_parks_and_reclaims(fam):
    """Finished slots decref their shared pages: the cached full pages
    stay allocated and idle (refcount 0), count as reclaimable, and
    ``clear_prefix_cache`` returns every page to the pool."""
    family, cfg, params = fam
    eng = TEngine(cfg, params, prefix_cache=True, **ENG, device="cpu")
    pool, n_full = eng.num_pages - 1, _len0(cfg) // 8
    first = _warm(eng, TRequest, [PROMPT])
    assert eng.allocator.available == pool - n_full
    assert eng._px_reclaimable == n_full
    assert all(eng.allocator.refcount(e.pid) == 0
               for e in eng._px._pages.values())
    assert eng.can_accept(eng.pages_per_slot)
    assert eng.clear_prefix_cache() == n_full
    assert eng.allocator.available == pool
    again = TRequest(rid=9, prompt=list(PROMPT), max_new_tokens=6)
    eng.add_request(again)
    eng.run()
    assert [again.out_tokens] == first
    assert eng.stats.prefix_hits == 0 and eng.stats.prefix_lookups == 2


def test_idle_cached_pages_reclaimed_under_pressure(f32):
    """A pool full of idle cached pages does not starve admission."""
    _, _, tcfg, tparams = f32
    prompts = [[10 + i] * 18 for i in range(3)]
    cold = _cold(tcfg, tparams, prompts)
    eng = TEngine(tcfg, tparams, prefix_cache=True, **{**ENG, "num_pages": 7},
                  device="cpu")
    assert _warm(eng, TRequest, prompts) == cold
    assert eng.allocator.available + eng._px_reclaimable == 6


def test_tiered_spill_prefetch_shared_pages(fam):
    """Idle shared pages spill to the flash tier under pressure and come
    back on the next hit; the streams equal the cold runs."""
    family, cfg, params = fam
    fillers = [[30 + i] * 18 for i in range(3)]
    prompts = [PROMPT] + fillers + [PROMPT]
    cold = _cold(cfg, params, prompts)
    per_req = -(-min(64, _len0(cfg) + 6) // 8)
    eng = TEngine(cfg, params, prefix_cache=True, kv_tier="flash",
                  **{**ENG, "num_pages": per_req + 3}, device="cpu")
    assert _warm(eng, TRequest, prompts) == cold
    s = eng.stats
    assert s.kv_spill_pages > 0 and s.kv_prefetch_pages > 0
    assert s.prefix_hits >= 1 and s.prefix_hit_pages >= 2


# ---------------------------------------------------------------- routing
def test_session_affinity_follows_the_cache(f32):
    _, _, tcfg, tparams = f32
    rt = Router.build(tcfg, tparams, replicas=2, policy="session_affinity",
                      prefix_cache=True, **ENG, device="cpu")
    sid = next(s for s in (f"s{i}" for i in range(64))
               if zlib.crc32(s.encode()) % 2 == 1)
    rt.cores[0].add_request(TRequest(rid=0, prompt=list(PROMPT),
                                     max_new_tokens=4))
    rt.cores[0].run()
    req = TRequest(rid=1, prompt=list(PROMPT), max_new_tokens=4, session=sid)
    assert rt.cores[0].prefix_hit_estimate(req) == len(PROMPT)
    assert rt.cores[1].prefix_hit_estimate(req) == 0
    assert rt.submit(req) is rt.cores[0]           # the cache beats the hash
    cold = TRequest(rid=2, prompt=[7, 8, 9], max_new_tokens=4, session=sid)
    assert rt.submit(cold) is rt.cores[1]          # nothing cached: the hash


def test_least_loaded_discounts_cached_prefix(f32):
    _, _, tcfg, tparams = f32
    rt = Router.build(tcfg, tparams, replicas=2, policy="least_loaded",
                      prefix_cache=True, **ENG, device="cpu")
    rt.cores[1].add_request(TRequest(rid=0, prompt=list(PROMPT),
                                     max_new_tokens=4))
    rt.cores[1].run()
    order = list(rt.cores[1]._px._resume)
    req = TRequest(rid=1, prompt=list(PROMPT), max_new_tokens=4)
    assert rt.submit(req) is rt.cores[1]
    assert list(rt.cores[1]._px._resume) == order   # scoring is LRU-neutral
