"""The port's overlapped decode loop: bit-identity with its synchronous
loop, and event streams equal to the JAX overlapped engine's.

The cases of tests/test_overlap.py that apply to the port (continuous
mode, the dense and hybrid families): the same requests through a
synchronous and an overlapped engine give identical ``out_tokens`` and
``finish_reason`` per request, greedy and seed-pinned stochastic, through
a lagged eos and requeue restarts; the synchronous loop pays 2 decode
dispatches a step, the overlapped one 1.  Weights are the port's own
float32 init (reduced configs), as the bit-identity oracles run in
float32.

Against JAX: both overlapped engines on the same bridged weights and
margin-checked greedy prompts (tests/test_torch_serving.py's harness, the
method of tests/test_quant_serving.py:83-99) must emit the same events at
the same steps.
"""

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore, Request
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_hybrid import _bridge, _jax_params
from test_torch_serving import _both, _prompts

ARCHS = {"dense": "smollm-360m", "hybrid": "zamba2-7b"}


@pytest.fixture(scope="module", params=sorted(ARCHS), ids=lambda f: f"fam_{f}")
def fam(request):
    cfg = get_arch(ARCHS[request.param]).reduced()
    params = TM.init_params(cfg, seed=0, max_seq=64, device="cpu",
                            dtype=torch.float32)
    return request.param, cfg, params


def _reqs(n=5, stochastic=False, max_new=8, plen=4):
    reqs = []
    for i in range(n):
        sp = (SamplingParams(temperature=0.8, seed=40 + i, top_k=20,
                             top_p=0.9)
              if stochastic and i % 2 else SamplingParams(temperature=0.0))
        reqs.append(Request(rid=i, prompt=[3 + i, 5, 7 + i, 2][:plen],
                            max_new_tokens=max_new, sampling=sp))
    return reqs


def _run_pair(cfg, params, make_reqs, eos_id=-1, **kw):
    """The same workload synchronous and overlapped: both (reqs, stats)."""
    out = []
    for overlap in (False, True):
        eng = EngineCore(cfg, params, eos_id=eos_id, overlap=overlap,
                         device="cpu", **kw)
        reqs = make_reqs()
        for r in reqs:
            eng.add_request(r)
        stats = eng.run()
        assert stats.tokens_out == sum(len(r.out_tokens) for r in reqs)
        out.append((reqs, stats))
    return out


def _assert_identical(sync, olap):
    (rs_s, st_s), (rs_o, st_o) = sync, olap
    for a, b in zip(rs_s, rs_o):
        assert a.out_tokens == b.out_tokens, \
            (a.rid, a.out_tokens, b.out_tokens)
        assert a.finish_reason == b.finish_reason, \
            (a.rid, a.finish_reason, b.finish_reason)
    assert st_s.decode_dispatches == 2 * st_s.decode_steps > 0
    assert st_o.decode_dispatches == st_o.decode_steps > 0


@pytest.mark.parametrize("sampling", ["greedy", "stochastic"])
def test_overlap_bit_identical(fam, sampling):
    family, cfg, params = fam
    pair = _run_pair(cfg, params,
                     lambda: _reqs(stochastic=(sampling == "stochastic")),
                     max_batch=2, max_seq=32, page_size=4)
    _assert_identical(*pair)
    if sampling == "stochastic":   # the draws really left the argmax
        greedy = _run_pair(cfg, params, _reqs, max_batch=2, max_seq=32,
                           page_size=4)[0][0]
        assert any(a.out_tokens != b.out_tokens
                   for a, b in zip(pair[0][0], greedy))


def test_overlap_eos_lag_identity(fam):
    """An eos is found only at the lagged drain; the speculative step the
    slot ran in between must leave no trace."""
    family, cfg, params = fam
    probe = _run_pair(cfg, params, _reqs, max_batch=2, max_seq=32,
                      page_size=4)[0][0]
    eos = probe[0].out_tokens[len(probe[0].out_tokens) // 2]
    pair = _run_pair(cfg, params, lambda: _reqs(max_new=12), eos_id=eos,
                     max_batch=2, max_seq=32, page_size=4)
    _assert_identical(*pair)
    assert any(r.finish_reason == "eos" for r in pair[1][0])


def test_overlap_requeue_identity(fam):
    """Requeue under pool exhaustion: an undrained token is dropped with
    the slot and drawn again, the same, after the folded-prefix restart."""
    family, cfg, params = fam
    pair = _run_pair(cfg, params,
                     lambda: _reqs(n=6, stochastic=True, max_new=10),
                     max_batch=3, max_seq=32, page_size=4, num_pages=9,
                     exhaust_policy="requeue")
    _assert_identical(*pair)
    assert pair[1][1].preemptions > 0


def test_overlap_capacity_identity(fam):
    """A slot that reaches max_seq finishes with "capacity" at the same
    token in both loops (predicted on the host one step ahead)."""
    family, cfg, params = fam
    pair = _run_pair(cfg, params, lambda: _reqs(n=3, max_new=40),
                     max_batch=2, max_seq=16, page_size=4)
    _assert_identical(*pair)
    assert all(r.finish_reason == "capacity" for r in pair[1][0])


def test_overlap_abort_mid_stream(fam):
    """Aborting a running request while its next token is in flight: the
    other streams stay identical and the aborted one ends once."""
    family, cfg, params = fam
    runs = []
    for overlap in (False, True):
        eng = EngineCore(cfg, params, eos_id=-1, overlap=overlap,
                         max_batch=2, max_seq=32, page_size=4, device="cpu")
        reqs = _reqs(n=3, stochastic=True, max_new=8)
        for r in reqs:
            eng.add_request(r)
        events = []
        for step in range(60):
            if step == 3:
                assert eng.abort_request(1)
            events += eng.step()
            if not eng.has_work:
                break
        runs.append((reqs, [e for e in events if e.rid == 1 and e.finished]))
    (rs_s, ab_s), (rs_o, ab_o) = runs
    for a, b in zip(rs_s, rs_o):
        if a.rid != 1:
            assert a.out_tokens == b.out_tokens
    assert len(ab_s) == len(ab_o) == 1
    assert ab_o[0].finish_reason == "aborted"


# ---------------------------------------------------------------- vs JAX
@pytest.fixture(scope="module", params=[("smollm-360m", "w8a8"),
                                        ("zamba2-7b", "float")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request):
    """(JAX cfg, JAX params, port cfg, bridged params) of a reduced
    config, in the form test_torch_serving's harness takes."""
    arch, quant = request.param
    jcfg, jparams = _jax_params(arch, quant)
    return jcfg, jparams, get_arch(arch).reduced(), _bridge(jparams)


def test_overlap_matches_jax_overlap(models):
    """Arrivals while other slots decode, through both overlapped engines:
    the same events at the same steps, one dispatch a decode step."""
    prompts = _prompts(models, 5, 3, 12, 8, seed=4)
    arrive = [0, 0, 1, 3, 4]
    max_new = [8, 3, 6, 5, 7]
    trace = [(a, rid, p, mn) for rid, (a, p, mn)
             in enumerate(zip(arrive, prompts, max_new))]
    (j, jsteps, jreqs), (t, tsteps, treqs) = _both(models, trace,
                                                   overlap=True)
    assert tsteps == jsteps
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
    assert t.stats.decode_steps == j.stats.decode_steps
    assert t.stats.decode_dispatches == j.stats.decode_dispatches \
        == t.stats.decode_steps
