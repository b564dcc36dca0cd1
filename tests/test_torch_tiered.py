"""The port's flash KV tier against the JAX package's.

Mirrors tests/test_tiered_kv.py.  The allocators are driven by the op
sequences of its two property tests (``test_tiered_allocator_invariants_
property``, ``test_tiered_refcount_shared_cold_property``: residency,
refcounts, spill and prefetch), the JAX and the port allocator side by
side, every observation equal; ``swap_out_pages`` / ``swap_in_pages`` are
bit-exact against JAX's on the same bf16 and int8 pools and write the
port's pools in place (``data_ptr`` unchanged, which a captured decode
graph needs); the tiered engine's streams equal the all-resident
engine's, bit for bit, synchronous and overlapped, dense and hybrid (the
Mamba state checkpointed on suspend and written back on resume), and the
JAX tiered engine's events, spill, prefetch and preemption counts on the
same bridged float32 weights and margin-checked prompts
(tests/test_torch_serving.py's harness).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro.serving.kv_cache import (OutOfPages as JOutOfPages,
                                    TieredPageAllocator as JTiered)
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest
from repro_torch.serving.kv_cache import (OutOfPages as TOutOfPages,
                                          TieredPageAllocator as TTiered)
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_serving import _drive, _prompts

ENG = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8)
TIER = dict(num_pages=6, kv_tier="flash")
ARCHS = {"dense": "smollm-360m", "hybrid": "zamba2-7b"}


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
    """The port's own float32 weights (the bit-identity oracles)."""
    cfg = get_arch(ARCHS[request.param]).reduced()
    return request.param, cfg, TM.init_params(
        cfg, seed=0, max_seq=64, device="cpu", dtype=torch.float32)


# ------------------------------------------------------------ allocators
def _call(trace, fn, *args):
    """Record fn(*args)'s result, or the name of what it raised."""
    try:
        out = fn(*args)
    except (ValueError, KeyError) as e:
        trace.append(type(e).__name__)
        return None
    except (JOutOfPages, TOutOfPages):
        trace.append("OutOfPages")
        return None
    trace.append(out)
    return out


def _residency_trace(cls, num_pages, ops):
    """tests/test_tiered_kv.py:79's op sequence (alloc, mark evictable,
    spill the LRU candidate, prefetch, free), every result recorded."""
    a, trace = cls(num_pages), []
    hot, evictable, cold, next_key = {}, set(), set(), 0
    for op in ops:
        r = op % 5
        if r == 0:
            pid = _call(trace, a.alloc, 1)
            if pid is not None:
                hot[next_key] = pid[0]
                next_key += 1
        elif r == 1:
            cands = [k for k in hot if k not in evictable]
            if cands:
                k = cands[op % len(cands)]
                a.mark_evictable(k, hot[k])
                evictable.add(k)
                _call(trace, a.mark_evictable, k, hot[k])
        elif r == 2:
            for k, pid in _call(trace, a.pop_evictable, 1):
                a.store(k, ("payload", pid))
                a.free([pid])
                evictable.discard(k)
                del hot[k]
                cold.add(k)
                _call(trace, a.free, [pid])
        elif r == 3:
            if cold and a.available >= 1:
                k = sorted(cold)[op % len(cold)]
                _call(trace, a.fetch, k)
                cold.discard(k)
                hot[k] = _call(trace, a.alloc, 1)[0]
        else:
            cands = [k for k in hot if k not in evictable]
            if cands:
                k = cands[op % len(cands)]
                _call(trace, a.free, [hot.pop(k)])
        trace.append((a.available, a.cold_count, a.evictable_count,
                      a.flash_available))
    for k in list(hot):
        if k in evictable:
            a.unmark_slot(lambda key, k=k: key == k)
        a.free([hot.pop(k)])
    a.drop_slot(lambda key: True)
    trace.append((a.available, a.cold_count, a.evictable_count))
    return trace


def _refcount_trace(cls, num_pages, ops):
    """tests/test_tiered_kv.py:161's op sequence (alloc, incref, decref,
    free under sharers, spill idle pages, prefetch), every result
    recorded."""
    a, trace = cls(num_pages), []
    refs, hot, cold, next_key = {}, {}, set(), 0
    for op in ops:
        r = op % 6
        if r == 0:
            if a.available >= 1:
                hot[next_key] = _call(trace, a.alloc, 1)[0]
                refs[next_key] = 1
                next_key += 1
        elif r == 1:
            if hot:
                k = sorted(hot)[op % len(hot)]
                refs[k] = _call(trace, a.incref, hot[k])
        elif r == 2:
            cands = [k for k in hot if refs[k] > 0]
            if cands:
                k = cands[op % len(cands)]
                refs[k] = _call(trace, a.decref, hot[k])
            elif hot:
                _call(trace, a.decref, hot[sorted(hot)[op % len(hot)]])
        elif r == 3:
            if hot:
                k = sorted(hot)[op % len(hot)]
                _call(trace, a.free, [hot[k]])
                if refs[k] <= 1:
                    del hot[k], refs[k]
        elif r == 4:
            cands = [k for k in hot if refs[k] == 0]
            if cands:
                k = cands[op % len(cands)]
                _call(trace, a.store, ("px", k), ("payload", k))
                a.free([hot.pop(k)])
                del refs[k]
                cold.add(k)
        else:
            if cold and a.available >= 1:
                k = sorted(cold)[op % len(cold)]
                _call(trace, a.fetch, ("px", k))
                cold.discard(k)
                hot[k] = a.alloc(1)[0]
                refs[k] = _call(trace, a.decref, hot[k])
        trace.append((a.available, a.cold_count,
                      sorted((k, a.refcount(p)) for k, p in hot.items())))
    return trace


@pytest.mark.parametrize("trace", [_residency_trace, _refcount_trace],
                         ids=["residency", "refcounts"])
def test_tiered_allocator_matches_jax_on_property_ops(trace):
    rng = np.random.RandomState(0)
    top = 25 if trace is _residency_trace else 30
    for _ in range(40):
        num_pages = int(rng.randint(4, 25))
        ops = rng.randint(0, top, int(rng.randint(0, 61))).tolist()
        got = trace(TTiered, num_pages, ops)
        assert got == trace(JTiered, num_pages, ops), (num_pages, ops)


def test_tiered_allocator_flash_capacity_and_guards():
    """tests/test_tiered_kv.py's bounded-tier guards, held on the port."""
    a = TTiered(6, flash_pages=1)
    p = a.alloc(2)
    a.store(("s", 0), b"x")
    assert a.flash_available == 0
    with pytest.raises(TOutOfPages):
        a.store(("s", 1), b"y")
    with pytest.raises(ValueError):
        a.store(("s", 0), b"z")
    a.mark_evictable(("t", 0), p[0])
    with pytest.raises(ValueError):
        a.mark_evictable(("t", 0), p[0])
    assert TTiered(6).flash_available is None


# ------------------------------------------------------------ swap ops
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_swap_pages_match_jax_in_place(f32, kv):
    """The same pools in both packages: the gathered payloads are JAX's bit
    for bit; the zeroed source pages come back on other pids, the pools
    equal JAX's swap_in result, and no pool moved."""
    jcfg, _, tcfg, _ = f32
    jc = JM.init_paged_cache(jcfg, 2, 32, page_size=8, kv_dtype=kv)
    tc = TM.init_paged_cache(tcfg, 2, 32, page_size=8, device="cpu",
                             kv_dtype=kv)
    rng = np.random.RandomState(1)
    keys = TM.blocks.paged_pool_keys(tc)
    for key in keys:
        shape = tuple(tc[key].shape)
        if key.endswith("_scale"):
            x = rng.rand(*shape).astype(np.float32)
            jc[key], tc[key] = jnp.asarray(x), torch.from_numpy(x)
        elif kv == "int8":
            x = rng.randint(-127, 128, shape).astype(np.int8)
            jc[key], tc[key] = jnp.asarray(x), torch.from_numpy(x)
        else:
            jx = jnp.asarray(rng.randn(*shape).astype(np.float32),
                             jnp.bfloat16)
            jc[key] = jx
            tc[key] = torch.from_numpy(
                np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16)
    ptrs = [tc[k].data_ptr() for k in keys]
    src, dst = [1, 3, 4], [6, 2, 7]
    jout = JM.swap_out_pages(jc, jnp.asarray(src, jnp.int32))
    tout = TM.swap_out_pages(tc, torch.tensor(src))
    assert len(tout) == len(keys) == (4 if kv == "int8" else 2)
    for j, t in zip(jout, tout):
        want = np.asarray(j)
        got = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
               else t.numpy())
        np.testing.assert_array_equal(
            got, want.view(np.int16) if got.dtype == np.int16 else want)
    for key in keys:
        tc[key][:, src] = 0
    jc = JM.swap_in_pages(jc, jnp.asarray(dst, jnp.int32), *jout)
    TM.swap_in_pages(tc, torch.tensor(dst), *tout)
    assert [tc[k].data_ptr() for k in keys] == ptrs
    for key, t in zip(keys, tout):
        assert torch.equal(tc[key][:, dst], t)
        want = np.asarray(jc[key])
        got = tc[key]
        got = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
               else got.numpy())
        np.testing.assert_array_equal(
            got[:, dst], (want.view(np.int16) if got.dtype == np.int16
                          else want)[:, dst])


# ------------------------------------------------------------ engine
def _mk_reqs(n):
    return [TRequest(rid=i, prompt=[2 + i] * (3 + i),
                     max_new_tokens=12 + 2 * i) for i in range(n)]


def _run(cfg, params, reqs, **kw):
    eng = TEngine(cfg, params, **{**ENG, **kw}, device="cpu")
    for r in reqs:
        eng.add_request(r)
    eng.run()
    return eng


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_tiered_engine_matches_all_resident(fam, overlap):
    """tests/test_tiered_kv.py's conformance case in the port: the hot pool
    below the demand, every request's stream equals the unconstrained
    run's, pages really spilled and came back, nothing leaked; a hybrid
    slot's Mamba state is checkpointed and restored."""
    family, cfg, params = fam
    base = _mk_reqs(5)
    _run(cfg, params, base, overlap=overlap)
    tiered = _mk_reqs(5)
    eng = _run(cfg, params, tiered, overlap=overlap, **TIER)
    assert all(r.done and not r.rejected for r in tiered)
    for a, b in zip(base, tiered):
        assert a.out_tokens == b.out_tokens, a.rid
    s = eng.stats
    assert s.preemptions > 0 and s.resumes > 0 and s.kv_spill_pages > 0
    assert s.kv_prefetch_pages == s.kv_spill_pages
    assert s.kv_spill_bytes == s.kv_spill_pages * eng.kv_page_bytes
    assert eng.allocator.available == 5
    assert eng.allocator.cold_count == 0 == eng.allocator.evictable_count
    assert not any(eng.suspended) and eng.resume_order == []
    assert eng._ssm_ckpt == {}


def test_tiered_engine_bounded_flash_tier(fam):
    """A bounded cold tier degrades to restarts without leaking hot pids."""
    family, cfg, params = fam
    base = _mk_reqs(5)
    _run(cfg, params, base)
    reqs = _mk_reqs(5)
    eng = _run(cfg, params, reqs, flash_pages=2, **TIER)
    assert all(r.done and not r.rejected for r in reqs)
    for a, b in zip(base, reqs):
        assert a.out_tokens == b.out_tokens, a.rid
    assert eng.allocator.available == 5 and eng.allocator.cold_count == 0


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_tiered_engine_matches_jax(f32, overlap):
    """The port's and the JAX tiered engines on the same bridged weights and
    margin-checked prompts: the same events at the same steps, the same
    preemptions, resumes, spilled and prefetched pages."""
    jcfg, jparams, tcfg, tparams = f32
    prompts = _prompts(f32, 5, 3, 8, 14, seed=4)
    trace = [(0, rid, p, 10 + 2 * rid) for rid, p in enumerate(prompts)]
    kw = {**ENG, **TIER, "overlap": overlap}
    j = JEngine(jcfg, jparams, **kw)
    t = TEngine(tcfg, tparams, **kw, device="cpu")
    jsteps, _ = _drive(j, JRequest, trace)
    tsteps, _ = _drive(t, TRequest, trace)
    assert tsteps == jsteps
    for name in ("preemptions", "resumes", "kv_spill_pages",
                 "kv_prefetch_pages", "decode_steps", "pool_exhausted"):
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert t.stats.kv_spill_pages > 0
    assert t.kv_page_bytes == j.kv_page_bytes


def test_submit_rejects_request_larger_than_hot_pool(f32):
    _, _, tcfg, tparams = f32
    eng = TEngine(tcfg, tparams, max_batch=2, max_seq=48, eos_id=-1,
                  page_size=8, num_pages=3, kv_tier="flash", device="cpu")
    with pytest.raises(ValueError):  # needs 3 pages, pool has 2
        eng.add_request(TRequest(rid=0, prompt=[1] * 10, max_new_tokens=12))
