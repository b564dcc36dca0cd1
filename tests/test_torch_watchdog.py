"""The port's straggler watchdog and sanitizer hook against the JAX engine's.

Watchdog: a watchdog that flags decode steps 1 and 3 of the synchronous
loop re-dispatches them from the state they started from (``lens`` and,
for the hybrid family, the Mamba state pools kept on the device), so the
streams equal the unwatched run's bit for bit, dense and hybrid (reduced
smollm-360m and zamba2-7b, JAX float32 weights bridged), and
``straggler_events`` equals a JAX engine's under the same watchdog.  With
``overlap=True`` a watchdog is refused, as tests/test_overlap.py:216.

Sanitizer (``REPRO_SANITIZE=1``, tests/test_analysis.py:440): an
overlapped + tiered + prefix-cache port engine with every rail armed
equals a plain synchronous one with zero reports and the rails run; a
planted mutation of a staged ``last_np`` between dispatch and drain is
reported; the wire manifest and the decode graph's capture budget are
checked through the same hooks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro.serving.scheduler import SamplingParams as JSampling
from repro_torch import _sanitize
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.serving.core import EngineCore, Request
from repro_torch.serving.fleet import wire
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)

ENG = dict(max_batch=2, max_seq=48, eos_id=-1, page_size=8)
ARCHS = {"dense": "smollm-360m", "hybrid": "zamba2-7b",
         "moe": "qwen2-moe-a2.7b"}


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = ASSIGNED_ARCHS[arch].reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    return (jcfg, jparams, get_arch(arch).reduced(),
            params_from_numpy(jax.tree.map(np.asarray, jparams)))


def _reqs(n, max_new=8, jax_side=False):
    R, S = (JRequest, JSampling) if jax_side else (Request, SamplingParams)
    return [R(rid=rid, prompt=[2 + rid, 5, 9 + rid, 4], max_new_tokens=max_new,
              sampling=(S(temperature=0.9, top_k=20, seed=100 + rid)
                        if rid % 2 else None))
            for rid in range(n)]


def _flag(steps):
    fired = set()

    def watchdog(step, dt):
        assert dt >= 0.0
        if step in steps and step not in fired:
            fired.add(step)
            return True
        return False
    return watchdog


def _serve(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("family", sorted(ARCHS), ids=lambda f: f"fam_{f}")
def test_watchdog_redispatch_gives_the_unwatched_bits(family):
    jcfg, jparams, cfg, params = _models(ARCHS[family])
    plain = _serve(EngineCore(cfg, params, **ENG, device="cpu"), _reqs(3))
    eng = EngineCore(cfg, params, **ENG, device="cpu",
                     watchdog=_flag({1, 3}))
    assert _serve(eng, _reqs(3)) == plain
    jeng = JEngine(jcfg, jparams, **ENG, watchdog=_flag({1, 3}))
    _serve(jeng, _reqs(3, jax_side=True))
    assert eng.stats.straggler_events == jeng.stats.straggler_events == 2
    assert eng.stats.decode_steps == jeng.stats.decode_steps


def test_redispatch_restores_the_step_state():
    """The kept state is what the step overwrote: a re-dispatch without
    the restore would advance ``lens`` (and the Mamba state) twice."""
    _, _, cfg, params = _models("zamba2-7b")
    eng = EngineCore(cfg, params, **ENG, device="cpu",
                     watchdog=lambda step, dt: False)
    eng.add_request(Request(rid=0, prompt=[3, 4, 5, 6], max_new_tokens=4))
    eng.step()
    kept = eng._keep_step_state()
    lens0 = eng.cache["lens"].clone()
    state0 = eng.cache["mamba"]["state"].clone()
    eng.step()
    assert not bool((eng.cache["lens"] == lens0).all())
    assert not bool((eng.cache["mamba"]["state"] == state0).all())
    eng._restore_step_state(kept)
    assert bool((eng.cache["lens"] == lens0).all())
    assert bool((eng.cache["mamba"]["state"] == state0).all())


def test_overlap_rejects_watchdog():
    _, _, cfg, params = _models("smollm-360m")
    with pytest.raises(ValueError, match="overlap"):
        EngineCore(cfg, params, overlap=True, device="cpu",
                   watchdog=lambda step, dt: False)


# -------------------------------------------------------------- sanitizer
@pytest.fixture
def san(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    mod = _sanitize.load()
    assert mod is not None
    mod.reset_counters()
    return mod


def _sanitized_serve(cfg, params, **kw):
    reqs = [Request(rid=i, prompt=[2 + i, 5, 7, 9 + i], max_new_tokens=6)
            for i in range(3)]
    eng = EngineCore(cfg, params, max_batch=2, max_seq=48, eos_id=-1,
                     page_size=4, device="cpu", **kw)
    return _serve(eng, reqs), eng


def test_sanitized_engine_matches_plain_engine(monkeypatch):
    _, _, cfg, params = _models("smollm-360m")
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    baseline, eng = _sanitized_serve(cfg, params)
    assert eng._san is None and not hasattr(eng.allocator, "_shadow")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    mod = _sanitize.load()
    mod.reset_counters()
    got, eng = _sanitized_serve(cfg, params, overlap=True, kv_tier="flash",
                                num_pages=4, prefix_cache=True)
    assert got == baseline
    assert eng.stats.kv_spill_pages > 0   # the tier's shadow ran too
    assert hasattr(eng.allocator, "_tier_shadow")
    assert hasattr(eng.allocator.hot, "_shadow")
    assert mod.report_count() == 0
    assert mod.check_count() > 0


def test_planted_mutation_between_dispatch_and_drain_is_reported(san):
    _, _, cfg, params = _models("smollm-360m")
    eng = EngineCore(cfg, params, **ENG, device="cpu", overlap=True)
    eng.add_request(Request(rid=0, prompt=[3, 4, 5], max_new_tokens=8))
    eng.step()
    eng.step()
    guard = eng._pending["san"]
    staged = dict((name, arr) for name, arr, _ in guard.entries)
    staged["last_np"][0] += 1   # the host rewrites a staged buffer
    with pytest.raises(san.SanitizerError, match="last_np"):
        eng.step()
    assert san.report_count() == 1


def test_wire_manifest_and_capture_budget_hooks(san):
    wire._TAG_OF.clear()
    wire._TYPE_OF.clear()
    wire._registry()   # the manifest check runs with the registry
    assert san.check_count() == 1
    _, _, cfg, params = _models("smollm-360m")
    eng = EngineCore(cfg, params, **ENG, device="cpu")
    assert eng.graph._cache_size() == 0   # the CPU captures nothing
    san.check_retrace(eng.graph, "decode_sample", budget=2)
    eng.graph._graphs.update({"sync": None, "fused": None,
                              "fused_greedy": None})
    with pytest.raises(san.SanitizerError, match="retrace budget"):
        san.check_retrace(eng.graph, "decode_sample", budget=2)
    eng.graph._graphs.clear()
