"""The port's serving stack against the JAX serving stack.

Both engines get the same weights (JAX float32 init, optionally W8A8 or
W4A16, which on the dense family is a W4A16 lm_head over W8A8 layers,
carried over by ``repro_torch.bridge``) and the same trace of mixed-length
greedy requests, some admitted while others decode.  Every step's
RequestOutput events (rid, token, progress, finish reason) must be equal,
and so must the pool-pressure accounting under both exhaust policies.

Prompts are margin-checked, after the method of
tests/test_quant_serving.py:83-99: the two frameworks' logits differ by
~1e-6 (float32 sums in another order; an int8 activation code at a rounding
tie, see test_torch_model.py), so a prompt enters a trace only if the
port's own greedy run of it keeps the top-1 / top-2 logit margin above
MARGIN at every generated token.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.quant.convert import quantize_params as jquantize
from repro.serving.client import ServingClient as JClient
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.client import ServingClient as TClient
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest

MARGIN = 1e-2
ENG = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8)


@pytest.fixture(scope="module", params=["float", "w8a8", "w4a16"])
def models(request):
    jcfg = ASSIGNED_ARCHS["smollm-360m"].reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0),
                             dtype=jax.numpy.float32, max_seq=64)
    if request.param != "float":
        jparams = jquantize(jparams, mode=request.param)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_arch("smollm-360m").reduced(), tparams


def _min_margin(cfg, params, prompt, n_new) -> float:
    """Smallest top-1 / top-2 logit gap of the port's greedy run."""
    cache = TM.init_paged_cache(cfg, 1, 64, dtype=torch.bfloat16,
                                page_size=8, device="cpu")
    cache["block"] = torch.arange(1, 9, dtype=torch.int32)[None]
    logits, cache = TM.prefill_into_slots(
        params, cfg, torch.tensor([prompt]), torch.tensor([len(prompt)]),
        cache, torch.tensor([0]))
    gaps = []
    for _ in range(n_new):
        top = torch.topk(logits[0], 2).values
        gaps.append(float(top[0] - top[1]))
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = TM.decode_step_paged(params, cfg, tok, cache,
                                             torch.tensor([True]))
    return min(gaps)


def _prompts(models, n, lo, hi, max_new, seed):
    _, _, tcfg, tparams = models
    rng = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        p = rng.randint(0, tcfg.vocab_size, rng.randint(lo, hi)).tolist()
        if _min_margin(tcfg, tparams, p, max_new) > MARGIN:
            out.append(p)
    return out


def _drive(engine, req_cls, trace, aborts=()):
    """trace: [(arrival step, rid, prompt, max_new)]; aborts: [(step, rid)]
    -> per-step events."""
    steps, step = [], 0
    pending = sorted(trace)
    reqs = {}
    while pending or engine.has_work:
        while pending and pending[0][0] <= step:
            _, rid, prompt, max_new = pending.pop(0)
            reqs[rid] = req_cls(rid=rid, prompt=list(prompt),
                                max_new_tokens=max_new)
            engine.add_request(reqs[rid])
        for _, rid in [a for a in aborts if a[0] == step]:
            assert engine.abort_request(rid)
        steps.append([(e.rid, e.token, e.n_out, e.finished, e.finish_reason)
                      for e in engine.step()])
        step += 1
        assert step < 500, "engine did not drain"
    return steps, reqs


def _both(models, trace, aborts=(), **kw):
    jcfg, jparams, tcfg, tparams = models
    j = JEngine(jcfg, jparams, **{**ENG, **kw})
    t = TEngine(tcfg, tparams, **{**ENG, **kw}, device="cpu")
    jsteps, jreqs = _drive(j, JRequest, trace, aborts)
    tsteps, treqs = _drive(t, TRequest, trace, aborts)
    return (j, jsteps, jreqs), (t, tsteps, treqs)


def test_mixed_admission_trace_matches_jax(models):
    """Arrivals while other slots decode, and one running and one queued
    request aborted."""
    prompts = _prompts(models, 7, 3, 20, 10, seed=1)
    arrive = [0, 0, 1, 3, 3, 7, 7]
    max_new = [10, 4, 7, 9, 2, 6, 5]
    trace = [(a, rid, p, mn) for rid, (a, p, mn)
             in enumerate(zip(arrive, prompts, max_new))]
    aborts = [(5, 3), (7, 6)]   # rid 3 mid-decode, rid 6 still queued
    (j, jsteps, jreqs), (t, tsteps, treqs) = _both(models, trace, aborts)
    assert tsteps == jsteps
    assert treqs[3].finish_reason == treqs[6].finish_reason == "aborted"
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
        assert treqs[rid].finish_reason == jreqs[rid].finish_reason
    assert t.stats.prefills == j.stats.prefills > 1   # admission mid-stream
    assert t.stats.decode_steps == j.stats.decode_steps


@pytest.mark.parametrize("policy", ["requeue", "reject"])
def test_exhaust_policies_match_jax(models, policy):
    """A 5-page pool under 3 slots: the same requests requeue (restart with
    the generated prefix folded in) or are rejected, at the same steps."""
    prompts = _prompts(models, 5, 3, 8, 12, seed=2)
    trace = [(0, rid, p, 12) for rid, p in enumerate(prompts)]
    (j, jsteps, jreqs), (t, tsteps, treqs) = _both(
        models, trace, num_pages=6, exhaust_policy=policy)
    assert tsteps == jsteps
    for name in ("pool_exhausted", "rejected", "preemptions", "completed"):
        assert getattr(t.stats, name) == getattr(j.stats, name), name
    assert t.stats.pool_exhausted > 0   # the pool really ran dry
    for rid in jreqs:
        assert treqs[rid].rejected == jreqs[rid].rejected


def test_serving_client_matches_jax(models):
    """ServingClient -> Router (2 replicas, least_loaded) -> EngineCore."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(models, 5, 3, 16, 6, seed=3)
    kw = dict(replicas=2, route="least_loaded", migrate=False, **ENG)
    jc = JClient(jcfg, jparams, **kw)
    tc = TClient(tcfg, tparams, **kw, device="cpu")
    jh = [jc.submit(p, max_new_tokens=6) for p in prompts]
    th = [tc.submit(p, max_new_tokens=6) for p in prompts]
    jev = [(e.rid, e.token, e.finished) for e in jc.stream()]
    tev = [(e.rid, e.token, e.finished) for e in tc.stream()]
    assert tev == jev
    assert [h.result().out_tokens for h in th] == \
        [h.result().out_tokens for h in jh]
    assert sum(s.completed for s in tc.router.stats) == 5
    assert all(s.completed for s in tc.router.stats)   # both replicas


@pytest.mark.parametrize("deadline_s,t_done", [
    (None, 5.0),    # no deadline
    (2.0, 0.0),     # not finished
    (2.0, 2.5),     # met
    (2.0, 4.0),     # missed
    (2.0, 3.0),     # finished exactly at the deadline
])
def test_request_deadline_missed_matches_jax(deadline_s, t_done):
    """``Request.deadline_missed`` against the JAX property on the same
    timestamps (submitted at 1.0 s)."""
    reqs = [cls(rid=0, prompt=[1, 2], deadline_s=deadline_s)
            for cls in (JRequest, TRequest)]
    for r in reqs:
        r.t_submit, r.t_done = 1.0, t_done
    assert reqs[1].deadline_missed == reqs[0].deadline_missed
    assert reqs[1].deadline_missed is (deadline_s == 2.0 and t_done == 4.0)
