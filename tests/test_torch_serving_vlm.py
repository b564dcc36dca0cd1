"""The port's engine serving the vlm family (qwen2-vl-72b, reduced: 8
vision tokens, M-RoPE) against the JAX engine, and the engine invariants
of the other families' files run over the vlm weights.

Both engines feed the vision rows as the JAX engine does: zeros [B, 8, D]
bf16 (``serving.core._batch_extras``), prepended to every prompt, so a
slot's length, its pages and its prefix keys count them (a ``-1``
sentinel per vision row).  Against JAX, on bridged JAX weights:

- a mixed-arrival trace in continuous mode over bf16 pools (float32 and
  W8A8 weights) and int8 pools: the events of every step equal;
- the wave engine, synchronous and overlapped (test_torch_wave.py's
  check);
- a prefix-caching trace (a cold admission, its resume hit, a prompt
  sharing its first pages, its resume hit): the prefix counters and the
  streams equal; the shared prefix is a clean miss (vlm cannot chunk, as
  in JAX) and the resume hits chain over the sentinels;
- a snapshot's bytes: decoded by the JAX codec to the port's fields and
  pages (bf16 and int8 pools, ``expect_family="vlm"``), resumed on a port
  engine to the unmigrated stream;
- a loopback fleet losing a worker: the single engine's streams and the
  JAX fleet's counters.

Greedy streams are compared only on margin-checked prompts: the port's
own run of a prompt keeps the top-1 / top-2 logit gap above MARGIN at
every step (tests/test_quant_serving.py:83-99).  The int8 pools' streams
equal the bf16 pools' on prompts whose bf16 margin exceeds twice the int8
drift the check measures on the same run.

Port invariants over the vlm weights (the port's own float32 init): sync
== overlapped (greedy, sampled, eos at the lagged drain, a requeue, a
slot at capacity, an abort), tiered == all-resident and a bounded tier,
resume hits == cold runs, a partial hit taking a clean miss, shared pages
through the tier, a migrated slot == the unmigrated run, int8 pools
across the sync, overlapped and tiered paths.
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
from repro.serving.fleet import wire as jwire
from repro.serving.fleet.router import FleetRouter as JFleet
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.core import (EngineCore as TEngine,
                                      Request as TRequest, _batch_extras)
from repro_torch.serving.fleet import wire
from repro_torch.serving.fleet.router import FleetRouter
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_fleet import _counters, _drive as _drive_fleet, _kill, \
    _reqs as _fleet_reqs
from test_torch_migrate import (  # noqa: F401  (collected here)
    _same_fields, test_slot_migration_bit_identity)
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

ARCH = "qwen2-vl-72b"
MARGIN = 1e-2
ENG = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8)


@pytest.fixture(scope="module")
def fam():
    """(family, port cfg, the port's own float32 weights): the other
    files' family cases run over them."""
    cfg = get_arch(ARCH).reduced()
    return "vlm", cfg, TM.init_params(cfg, seed=0, max_seq=64, device="cpu",
                                      dtype=torch.float32)


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


def _greedy_logits(cfg, params, prompt, n_new, kv):
    """The port's greedy run of ``prompt`` alone over ``kv`` pools, with
    the engine's vision rows -> the logits of each generated token."""
    cache = TM.init_paged_cache(cfg, 1, 64, dtype=torch.bfloat16,
                                page_size=8, device="cpu", kv_dtype=kv)
    cache["block"] = torch.arange(1, 9, dtype=torch.int32)[None]
    logits, cache = TM.prefill_into_slots(
        params, cfg, torch.tensor([prompt]),
        torch.tensor([len(prompt) + cfg.n_vision_tokens]), cache,
        torch.tensor([0]), _batch_extras(cfg, 1, torch.device("cpu")))
    out = []
    for _ in range(n_new):
        out.append(logits[0])
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = TM.decode_step_paged(params, cfg, tok, cache,
                                             torch.tensor([True]))
    return out


def _gap(logits) -> float:
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _margin_prompts(cfg, params, n_new, kv, seed, lo=3, hi=20):
    """One margin-checked prompt per entry of ``n_new``."""
    rng = np.random.RandomState(seed)
    prompts = []
    while len(prompts) < len(n_new):
        p = rng.randint(0, cfg.vocab_size, rng.randint(lo, hi)).tolist()
        logits = _greedy_logits(cfg, params, p, n_new[len(prompts)], kv)
        if min(_gap(lg) for lg in logits) > MARGIN:
            prompts.append(p)
    return prompts


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant,kv", [("float", "bf16"), ("w8a8", "bf16"),
                                      ("float", "int8")])
def test_engine_streams_match_jax(quant, kv):
    """Arrivals while other slots decode: the same events at the same
    steps as the JAX engine."""
    jcfg, jparams, cfg, tparams = _models(quant)
    max_new = [8, 4, 7, 6, 5]
    prompts = _margin_prompts(cfg, tparams, max_new, kv, seed=3)
    arrive = [0, 0, 1, 3, 4]
    trace = [(a, rid, p, mn) for rid, (a, p, mn)
             in enumerate(zip(arrive, prompts, max_new))]
    j = JEngine(jcfg, jparams, **ENG, kv_dtype=kv)
    t = TEngine(cfg, tparams, **ENG, kv_dtype=kv, device="cpu")
    jsteps, jreqs = _drive(j, JRequest, trace)
    tsteps, treqs = _drive(t, TRequest, trace)
    assert tsteps == jsteps
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
    assert t.stats.prefills == j.stats.prefills > 1


def test_wave_engine_matches_jax():
    check_engine_against_jax(ARCH)


PX_STATS = ("prefix_lookups", "prefix_hits", "prefix_hit_pages",
            "prefix_tokens_reused", "cow_copies", "prefills",
            "prefill_chunks")


def test_prefix_trace_matches_jax():
    """a, a, b, b through prefix-caching port and JAX engines (b shares
    a's first 16 tokens, so its first three pages' keys, sentinels
    included, are a's): equal counters and streams; two resume hits, and
    b's shared pages a clean miss."""
    jcfg, jparams, cfg, tparams = _models()
    rng = np.random.RandomState(11)
    while True:
        pfx = rng.randint(0, cfg.vocab_size, 16).tolist()
        a = pfx + rng.randint(0, cfg.vocab_size, 3).tolist()
        b = pfx + rng.randint(0, cfg.vocab_size, 5).tolist()
        if all(min(_gap(lg) for lg in _greedy_logits(
                cfg, tparams, p, 6, "bf16")) > MARGIN for p in (a, b)):
            break
    t = TEngine(cfg, tparams, prefix_cache=True, **ENG, device="cpu")
    j = JEngine(jcfg, jparams, prefix_cache=True, **ENG)
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
    assert (t.stats.prefix_hits, t.stats.prefills) == (2, 2)
    keys = t._key_tokens(TRequest(rid=9, prompt=a, max_new_tokens=1))
    assert keys == [-1] * cfg.n_vision_tokens + a


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_snapshot_bytes_cross_decode(fam, kv):
    """A port snapshot of a vlm slot (vision rows in its first page)
    decodes in the JAX codec to its own fields and pages, and resumes on a
    port engine to the unmigrated stream."""
    _, cfg, params = fam
    eng_kw = dict(max_batch=2, max_seq=48, eos_id=-1, page_size=8,
                  kv_dtype=kv, device="cpu")
    sp = SamplingParams(temperature=0.8, top_k=20, seed=3)

    def req():
        return TRequest(rid=4, prompt=list(range(1, 12)), max_new_tokens=8,
                        sampling=sp)

    solo = TEngine(cfg, params, **eng_kw)
    r0 = req()
    solo.add_request(r0)
    solo.run()
    a = TEngine(cfg, params, **eng_kw)
    a.add_request(req())
    for _ in range(3):
        a.step()
    snap = a.snapshot_slot(4)
    assert snap.n_pages == -(-(cfg.n_vision_tokens + 11 + 3) // 8)
    data = snap.to_bytes()
    in_jax = jwire.snapshot_from_bytes(
        data, expect_family="vlm",
        expect_dtype="int8" if kv == "int8" else "bfloat16")
    _same_fields(in_jax, snap)
    back = wire.snapshot_from_bytes(data, expect_family="vlm",
                                    expect_page_size=8)
    b = TEngine(cfg, params, **eng_kw)
    b.inject_slot(back)
    b.run()
    assert back.req.out_tokens == r0.out_tokens


def test_loopback_fleet_kill_mid_decode_bit_identical():
    """Two workers and a spare over the vlm weights, checkpoints every 3
    steps, worker 0 killed at step 5: the single engine's streams bit for
    bit and the JAX fleet's counters."""
    jcfg, jparams, cfg, params = _models()
    kw = dict(max_batch=2, max_seq=48, eos_id=-1, page_size=8)
    solo = TEngine(cfg, params, **kw, device="cpu")
    reqs = _fleet_reqs(4)
    for r in reqs:
        solo.add_request(r)
    solo.run()
    ref = {r.rid: list(r.out_tokens) for r in reqs}
    fl = FleetRouter.build_loopback(cfg, params, workers=2, spares=1,
                                    checkpoint_every=3, **kw, device="cpu")
    jfl = JFleet.build_loopback(jcfg, jparams, workers=2, spares=1,
                                checkpoint_every=3, **kw)
    try:
        assert _drive_fleet(fl, _fleet_reqs(4), 5, _kill) == ref
        _drive_fleet(jfl, _fleet_reqs(4, jax_side=True), 5, _kill)
        assert fl.fleet.workers_lost == 1 and fl.fleet.failovers == 1
        assert _counters(fl) == _counters(jfl)
    finally:
        fl.close()
        jfl.close()


# ---------------------------------------------------------------------------
# int8 pools over the vlm weights
# ---------------------------------------------------------------------------


def _run(cfg, params, reqs, **kw):
    eng = TEngine(cfg, params, **{**ENG, **kw}, device="cpu")
    for r in reqs:
        eng.add_request(r)
    eng.run()
    assert all(r.done and not r.rejected for r in reqs)
    return [list(r.out_tokens) for r in reqs], eng


def _reqs(prompts, n_new, stochastic=False):
    return [TRequest(rid=i, prompt=list(p), max_new_tokens=n_new,
                     sampling=(SamplingParams(temperature=0.8, top_k=20,
                                              seed=50 + i)
                               if stochastic and i % 2 else None))
            for i, p in enumerate(prompts)]


def test_int8_kv_matches_bf16_greedy(fam):
    """The int8 engine's greedy streams equal the bf16 engine's on prompts
    whose bf16 top-1 margin exceeds twice the int8 pools' drift, both
    measured on the prompt's own greedy runs (the first 3 of a seeded
    draw that clear it)."""
    _, cfg, params = fam
    rng = np.random.RandomState(5)
    prompts, drawn = [], 0
    while len(prompts) < 3:
        p = rng.randint(0, cfg.vocab_size, size=5).tolist()
        drawn += 1
        ref = _greedy_logits(cfg, params, p, 8, "bf16")
        i8 = _greedy_logits(cfg, params, p, 8, "int8")
        drift = max(float((a - b).abs().max()) for a, b in zip(ref, i8))
        if min(_gap(lg) for lg in ref) > 2 * drift:
            prompts.append(p)
    assert drawn < 30
    want, _ = _run(cfg, params, _reqs(prompts, 8))
    got, _ = _run(cfg, params, _reqs(prompts, 8), kv_dtype="int8")
    assert got == want


def test_int8_kv_bit_identical_across_paths(fam):
    """Under int8 pools the streams (greedy and sampled) survive the
    overlapped loop and the flash tier's spill and prefetch bit for bit."""
    _, cfg, params = fam
    prompts = [[3 + i, 7, 11 + 2 * i, 5, 9] for i in range(3)]
    sync, _ = _run(cfg, params, _reqs(prompts, 6, True), kv_dtype="int8")
    olap, _ = _run(cfg, params, _reqs(prompts, 6, True), kv_dtype="int8",
                   overlap=True)
    assert olap == sync
    tiered, eng = _run(cfg, params, _reqs(prompts, 6, True),
                       kv_dtype="int8", kv_tier="flash", num_pages=5)
    assert tiered == sync
    assert eng.stats.kv_spill_pages > 0
