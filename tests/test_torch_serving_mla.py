"""The port's engine serving the mla_moe family (deepseek-v2-lite-16b,
reduced) against the JAX engine, and the engine invariants of the other
families' files run over the mla_moe weights.

Against JAX, on bridged JAX weights (the events of every step equal):

- a mixed-arrival trace in continuous mode over bf16 pools (float32 and
  W8A8 weights) and int8 pools (the compressed rows quantized per row);
- the wave engine, synchronous and overlapped (test_torch_wave.py's
  check).

Greedy streams are compared only on margin-checked prompts: the port's
own run of a prompt keeps the top-1 / top-2 logit gap above MARGIN and
every router k-th / (k+1)-th gap above it at every layer and step
(tests/test_quant_serving.py:83-99, tests/test_torch_moe.py).  The int8
pools' streams equal the bf16 pools' on prompts whose bf16 margin exceeds
twice the int8 drift the check measures on the same run (the reference's
own ``test_int8_kv_matches_bf16_greedy[fam_mla_moe]`` fails on its fixed
prompts, ROADMAP §C).

Port invariants over the mla_moe weights (the port's own float32 init):
sync == overlapped (greedy, sampled, eos at the lagged drain, a requeue, a
slot at capacity, an abort), tiered == all-resident and a bounded tier,
resume hits == cold runs, a partial hit taking a clean miss (mla_moe
cannot chunk, as in JAX), shared pages through the tier, a migrated slot
== the unmigrated run, int8 pools across the sync, overlapped and tiered
paths.
"""

import numpy as np
import pytest
import torch

from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_hybrid import _bridge, _jax_params
from test_torch_migrate import (  # noqa: F401  (collected here)
    test_slot_migration_bit_identity)
from test_torch_moe import _router_margins
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

ARCH = "deepseek-v2-lite-16b"
MARGIN = 1e-2
ENG = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8)


@pytest.fixture(scope="module")
def fam():
    """(family, port cfg, the port's own float32 weights): the other
    files' family cases run over them."""
    cfg = get_arch(ARCH).reduced()
    return "mla_moe", cfg, TM.init_params(cfg, seed=0, max_seq=64,
                                          device="cpu", dtype=torch.float32)


def _greedy_run(cfg, params, prompt, n_new, kv):
    """The port's greedy run of ``prompt`` alone over ``kv`` pools ->
    (logits of each generated token, smallest router gap)."""
    cache = TM.init_paged_cache(cfg, 1, 64, dtype=torch.bfloat16,
                                page_size=8, device="cpu", kv_dtype=kv)
    cache["block"] = torch.arange(1, 9, dtype=torch.int32)[None]
    out = []
    with _router_margins() as routes:
        logits, cache = TM.prefill_into_slots(
            params, cfg, torch.tensor([prompt]), torch.tensor([len(prompt)]),
            cache, torch.tensor([0]))
        for _ in range(n_new):
            out.append(logits[0])
            tok = torch.argmax(logits, -1).to(torch.int32)
            logits, cache = TM.decode_step_paged(params, cfg, tok, cache,
                                                 torch.tensor([True]))
    return out, min(float(m.min()) for m in routes)


def _gap(logits) -> float:
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def _margin_prompts(cfg, params, n_new, kv, seed, n=5):
    rng = np.random.RandomState(seed)
    prompts = []
    while len(prompts) < n:
        p = rng.randint(0, cfg.vocab_size, rng.randint(3, 20)).tolist()
        logits, route = _greedy_run(cfg, params, p, n_new[len(prompts)], kv)
        if min(min(_gap(lg) for lg in logits), route) > MARGIN:
            prompts.append(p)
    return prompts


@pytest.mark.parametrize("quant,kv", [("float", "bf16"), ("w8a8", "bf16"),
                                      ("float", "int8")])
def test_engine_streams_match_jax(quant, kv):
    """Arrivals while other slots decode: the same events at the same
    steps as the JAX engine."""
    jcfg, jparams = _jax_params(ARCH, quant)
    tparams, cfg = _bridge(jparams), get_arch(ARCH).reduced()
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


def test_wave_engine_matches_jax():
    check_engine_against_jax(ARCH)


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
        ref, _ = _greedy_run(cfg, params, p, 8, "bf16")
        i8, _ = _greedy_run(cfg, params, p, 8, "int8")
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
                       kv_dtype="int8", kv_tier="flash", num_pages=4)
    assert tiered == sync
    assert eng.stats.kv_spill_pages > 0
