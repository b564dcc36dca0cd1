"""The port's wave mode (the shared-cursor cache and its engine) against
the JAX package's, for the dense, hybrid and ssm families.

JAX initialises the reduced configs (smollm-360m, zamba2-7b, mamba2-130m)
in float32, optionally W8A8; ``repro_torch.bridge`` carries the weights
over bit for bit.  Compared:

* ``init_cache`` / ``prefill`` (left-padded rows) / three ``decode_step``s:
  the logits at every step and the whole cache after them.  float32
  params: logits within ATOL (float 1e-4: float32 sums in another order;
  W8A8 5e-3: an activation at a rounding tie upstream of a linear can take
  the neighbouring int8 code, tests/test_torch_model.py); the float32
  Mamba states and conv windows within the same ATOL; the bf16 K/V cache
  within one bf16 step of the value plus ATOL.  bf16 params (W8A8): the
  port's distance from the JAX float32 run of the same weights (RMS over
  the logits) within BF16_RATIO of the JAX bf16 run's own distance from
  it, the model phase's yardstick on the card (chip_smoke.py MODEL_RATIO
  1.25) with room for the CPU's other rounding places.
* ``decode_and_sample`` against ``decode_step`` + ``sampler.sample_batch``.
* The engine in wave mode on margin-checked waves (the method of
  tests/test_quant_serving.py:83-99, applied to a whole left-padded wave):
  synchronous and overlapped event streams equal the JAX engine's, greedy
  and sampled rows (threefry) mixed; the port's overlapped tokens equal
  its synchronous ones; ``mode="auto"``; every refusal the JAX engine
  raises, with its type; a short mamba wave's ``ValueError``; the
  watchdog's re-dispatch.
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
from repro.serving import core as jcore
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro.serving.scheduler import SamplingParams as JSampling
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.serving import core as tcore, sampler
from repro_torch.serving.core import EngineCore, Request
from repro_torch.serving.scheduler import SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_watchdog import _flag

ARCHS = {"dense": "smollm-360m", "hybrid": "zamba2-7b", "ssm": "mamba2-130m",
         "moe": "qwen2-moe-a2.7b"}
ATOL = {"float": 1e-4, "w8a8": 5e-3}
BF16_RATIO = 1.5
BATCH, MAX_SEQ = 3, 32
MARGIN = 1e-2
ENG = dict(max_batch=BATCH, max_seq=MAX_SEQ, eos_id=-1, mode="wave")


@functools.lru_cache(maxsize=None)
def jax_params(arch, quant="float", dtype="f32"):
    """JAX reduced params: ``dtype`` "f32", "bf16", or "f32b" (the bf16
    init's values, quantized as bf16, in float32: the bf16 gate's
    reference)."""
    cfg = jget_arch(arch).reduced()
    if dtype == "f32b":
        _, params = jax_params(arch, quant, "bf16")
        return cfg, jax.tree.map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16
            else a, params)
    params = JM.init_params(cfg, jax.random.PRNGKey(1),
                            dtype=jnp.float32 if dtype == "f32"
                            else jnp.bfloat16, max_seq=64)
    if quant != "float":
        params = jquantize(params, mode=quant)
    return cfg, params


@functools.lru_cache(maxsize=None)
def port_params(arch, quant="float", dtype="f32"):
    _, params = jax_params(arch, quant, dtype)
    return params_from_numpy(jax.tree.map(np.asarray, params))


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def tokens(arch, seed=0, lens=(9, 6, 4)):
    """A left-padded wave of prompts (token 0 in front), as the engine
    builds it."""
    rng = np.random.RandomState(seed)
    vocab = get_arch(arch).reduced().vocab_size
    plen = max(lens)
    out = np.zeros((BATCH, plen), np.int32)
    for i, n in enumerate(lens):
        out[i, plen - n:] = rng.randint(0, vocab, n)
    return out


def extras(cfg, framework):
    """The engine's prefill extras (the audio family's zero frames, the vlm
    family's zero vision embeddings)."""
    if framework == "jax":
        return jcore._batch_extras(cfg, BATCH)
    return tcore._batch_extras(cfg, BATCH, torch.device("cpu"))


def run_jax(arch, quant="float", dtype="f32", n_steps=3):
    """(logits per step, final cache) of the JAX wave path (jitted, as the
    engine runs it), the decode tokens the argmax of the step before."""
    cfg, params = jax_params(arch, quant, dtype)
    ex = extras(cfg, "jax")
    cache = JM.init_cache(cfg, BATCH, MAX_SEQ)
    logits, cache = jax.jit(lambda p, t, c: JM.prefill(p, cfg, t, c, ex))(
        params, jnp.asarray(tokens(arch)), cache)
    out = [np32(logits)]
    step = jax.jit(lambda p, t, c: JM.decode_step(p, cfg, t, c))
    for _ in range(n_steps):
        tok = np.argmax(out[-1], -1).astype(np.int32)
        logits, cache = step(params, jnp.asarray(tok), cache)
        out.append(np32(logits))
    return out, cache


def run_port(arch, quant="float", dtype="f32", n_steps=3, feed=None):
    """The port's wave path on the CPU; ``feed``: the logits whose argmax
    gives each step's tokens (the JAX run's, so both sides decode the same
    tokens), else its own."""
    cfg = get_arch(arch).reduced()
    params = port_params(arch, quant, dtype)
    cache = TM.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    logits, cache = TM.prefill(params, cfg, torch.from_numpy(tokens(arch)),
                               cache, extras(cfg, "port"))
    out = [np32(logits)]
    for i in range(n_steps):
        src = feed[i] if feed is not None else out[-1]
        tok = torch.from_numpy(np.argmax(src, -1).astype(np.int32))
        logits, cache = TM.decode_step(params, cfg, tok, cache)
        out.append(np32(logits))
    return out, cache


def assert_cache_close(got: dict, want: dict, atol: float, path="cache"):
    """Every tensor of the JAX cache (port lists where JAX stacks: none in
    the wave cache) within atol; bf16 tensors within one bf16 step more."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for key, w in want.items():
        if w is None:
            assert got[key] is None, f"{path}.{key}"
        elif isinstance(w, dict):
            assert_cache_close(got[key], w, atol, f"{path}.{key}")
        else:
            g, wn = np32(got[key]), np32(w)
            assert g.shape == wn.shape, (f"{path}.{key}", g.shape, wn.shape)
            tol = atol
            if w.dtype == jnp.bfloat16:
                tol = atol + 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(wn), 2.0 ** -126))) - 7)
            assert (np.abs(g - wn) <= tol).all(), (
                f"{path}.{key}: max |err| {np.abs(g - wn).max():.3e}")


def check_model_against_jax(arch, quant):
    want, jcache = run_jax(arch, quant)
    got, tcache = run_port(arch, quant, feed=want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL[quant],
                                   err_msg=f"step {i}")
    assert int(tcache["len"]) == int(jcache["len"]) == \
        tokens(arch).shape[1] + 3
    assert_cache_close(tcache, dict(jcache), ATOL[quant])


def check_bf16_gate(arch):
    """bf16 W8A8: the port's RMS distance from the JAX float32 run of the
    same (bf16-valued) weights within BF16_RATIO x the JAX bf16 run's."""
    ref, _ = run_jax(arch, "w8a8", "f32b")
    jb, _ = run_jax(arch, "w8a8", "bf16")
    tb, _ = run_port(arch, "w8a8", "bf16", feed=ref)
    for i, (r, j, t) in enumerate(zip(ref, jb, tb)):
        d_jax = np.sqrt(np.mean((j - r) ** 2))
        d_port = np.sqrt(np.mean((t - r) ** 2))
        assert d_port <= BF16_RATIO * d_jax + 1e-6, (i, d_port, d_jax)


# ---------------------------------------------------------------------------
# the model's wave path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["float", "w8a8"])
@pytest.mark.parametrize("family", sorted(ARCHS), ids=lambda f: f"fam_{f}")
def test_wave_prefill_and_decode_match_jax(family, quant):
    check_model_against_jax(ARCHS[family], quant)


@pytest.mark.parametrize("family", sorted(ARCHS), ids=lambda f: f"fam_{f}")
def test_wave_bf16_within_the_rounding_gate(family):
    check_bf16_gate(ARCHS[family])


def test_init_cache_matches_jax_layout():
    """Keys, shapes and dtypes of the wave cache, every family."""
    for arch in list(ARCHS.values()) + ["whisper-small"]:
        want = JM.init_cache(jget_arch(arch).reduced(), 2, 24)
        got = TM.init_cache(get_arch(arch).reduced(), 2, 24, device="cpu")

        def walk(g, w, path):
            if isinstance(w, dict):
                assert set(g) == set(w), path
                for k in w:
                    walk(g[k], w[k], f"{path}.{k}")
            elif w is None:
                assert g is None, path
            else:
                assert tuple(g.shape) == w.shape, path
                assert str(g.dtype).split(".")[-1] == str(w.dtype), path
                assert not g.any(), path
        walk(got, dict(want), arch)


@pytest.mark.parametrize("family", sorted(ARCHS), ids=lambda f: f"fam_{f}")
def test_decode_and_sample_equals_decode_then_sample(family):
    check_decode_and_sample(ARCHS[family])


def check_decode_and_sample(arch):
    """The fused step's tokens (greedy rows and a sampled row) equal
    ``decode_step`` + ``sample_batch`` on the same cache; ``use_dev``
    picks the chained token per row."""
    cfg = get_arch(arch).reduced()
    params = port_params(arch)
    rows = (torch.tensor([0, 7, 9], dtype=torch.int32),
            torch.tensor([0, 3, 1], dtype=torch.int32),
            torch.tensor([0.0, 0.8, 1.1]),
            torch.tensor([0, 20, 0], dtype=torch.int32),
            torch.tensor([1.0, 0.9, 1.0]))
    tok_host = torch.tensor([5, 6, 7], dtype=torch.int32)
    tok_dev = torch.tensor([8, 9, 10], dtype=torch.int32)
    use_dev = torch.tensor([True, False, True])
    caches = []
    for _ in range(2):
        c = TM.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
        _, c = TM.prefill(params, cfg, torch.from_numpy(tokens(arch)), c,
                          extras(cfg, "port"))
        caches.append(c)
    fused, c0 = TM.decode_and_sample(
        params, cfg, tok_host, tok_dev, use_dev, caches[0],
        lambda lg: sampler.fused_sample(lg, *rows, greedy_only=False))
    logits, c1 = TM.decode_step(params, cfg, torch.where(
        use_dev, tok_dev, tok_host), caches[1])
    assert torch.equal(fused, sampler.sample_batch(logits, *rows))
    assert int(c0["len"]) == int(c1["len"])
    greedy, _ = TM.decode_and_sample(
        params, cfg, tok_host, tok_dev, use_dev, c1,
        lambda lg: sampler.fused_sample(lg, *rows, greedy_only=True))
    assert greedy.shape == (BATCH,)


# ---------------------------------------------------------------------------
# the engine in wave mode
# ---------------------------------------------------------------------------


def _wave_margins(arch, prompts, n_new) -> list[float]:
    """Smallest top-1 / top-2 logit gap of each row of the port's greedy
    run of one left-padded wave (zero rows up to BATCH)."""
    cfg = get_arch(arch).reduced()
    params = port_params(arch)
    plen = max(len(p) for p in prompts)
    toks = np.zeros((BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    cache = TM.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    logits, cache = TM.prefill(params, cfg, torch.from_numpy(toks), cache,
                               extras(cfg, "port"))
    gaps = [[] for _ in prompts]
    for _ in range(n_new):
        top = torch.topk(logits, 2, dim=-1).values
        for i in range(len(prompts)):
            gaps[i].append(float(top[i, 0] - top[i, 1]))
        logits, cache = TM.decode_step(
            params, cfg, torch.argmax(logits, -1).to(torch.int32), cache)
    return [min(g) for g in gaps]


def wave_prompts(arch, lens, n_new, seed):
    """Prompts of the given lengths, admitted in waves of BATCH, every row
    of every wave margin-checked; a failing row is redrawn at its length
    (the other rows' padding and values stay as they were)."""
    rng = np.random.RandomState(seed)
    vocab = get_arch(arch).reduced().vocab_size
    out = [rng.randint(0, vocab, n).tolist() for n in lens]
    for w0 in range(0, len(out), BATCH):
        for _ in range(200):
            wave = out[w0:w0 + BATCH]
            bad = [i for i, m in enumerate(_wave_margins(arch, wave, n_new))
                   if m <= MARGIN]
            if not bad:
                break
            for i in bad:
                out[w0 + i] = rng.randint(0, vocab, len(wave[i])).tolist()
        else:
            raise AssertionError("no margin-checked wave found")
    return out


def _reqs(prompts, n_new, jax_side=False):
    """Odd rids sampled (temperature 0.9, top-k 20, a pinned seed), even
    ones greedy."""
    R, S = (JRequest, JSampling) if jax_side else (Request, SamplingParams)
    return [R(rid=i, prompt=list(p), max_new_tokens=n_new,
              sampling=(S(temperature=0.9, top_k=20, seed=100 + i)
                        if i % 2 else S()))
            for i, p in enumerate(prompts)]


def drive(engine, reqs):
    """Submit every request, step to the end -> per-step events."""
    for r in reqs:
        engine.add_request(r)
    steps = []
    while engine.has_work:
        steps.append([(e.rid, e.token, e.n_out, e.finished, e.finish_reason)
                      for e in engine.step()])
        assert len(steps) < 400, "engine did not drain"
    return steps


def check_engine_against_jax(arch, n_new=6, lens=(7, 5, 9, 4, 6)):
    """Port and JAX wave engines, synchronous and overlapped, on the same
    margin-checked waves: the same events at the same steps."""
    jcfg, jparams = jax_params(arch)
    cfg, params = get_arch(arch).reduced(), port_params(arch)
    prompts = wave_prompts(arch, lens, n_new, seed=len(arch))
    runs = {}
    for overlap in (False, True):
        jreqs = _reqs(prompts, n_new, jax_side=True)
        treqs = _reqs(prompts, n_new)
        j = JEngine(jcfg, jparams, overlap=overlap, **ENG)
        t = EngineCore(cfg, params, overlap=overlap, device="cpu", **ENG)
        jsteps, tsteps = drive(j, jreqs), drive(t, treqs)
        assert tsteps == jsteps, f"overlap={overlap}"
        assert t.stats.decode_steps == j.stats.decode_steps
        assert t.stats.prefills == j.stats.prefills == 2
        assert t.stats.decode_dispatches == j.stats.decode_dispatches
        runs[overlap] = [r.out_tokens for r in treqs]
        assert all(len(o) == n_new for o in runs[overlap])
    assert runs[False] == runs[True]
    return runs[False]


@pytest.mark.parametrize("family", sorted(ARCHS), ids=lambda f: f"fam_{f}")
def test_wave_engine_matches_jax(family):
    check_engine_against_jax(ARCHS[family])


def test_auto_mode_and_refusals_match_jax():
    """``mode="auto"`` picks wave for ssm, continuous for dense and
    hybrid; wave with int8 KV, the flash tier or the prefix cache and
    continuous on ssm raise the JAX engine's ValueError."""
    for family, arch in ARCHS.items():
        jcfg, jparams = jax_params(arch)
        j = JEngine(jcfg, jparams, max_batch=2, max_seq=16)
        t = EngineCore(get_arch(arch).reduced(), port_params(arch),
                       max_batch=2, max_seq=16, device="cpu")
        assert t.mode == j.mode == ("wave" if family == "ssm"
                                    else "continuous")
    bad = [dict(mode="wave", kv_dtype="int8"),
           dict(mode="wave", kv_tier="flash"),
           dict(mode="wave", prefix_cache=True),
           dict(mode="auto", kv_dtype="int8")]
    for arch, kws in (("smollm-360m", bad[:3]), ("mamba2-130m", bad)):
        jcfg, jparams = jax_params(arch)
        for kw in kws + [dict(mode="continuous")] * (arch == "mamba2-130m"):
            with pytest.raises(ValueError):
                JEngine(jcfg, jparams, **kw)
            with pytest.raises(ValueError):
                EngineCore(get_arch(arch).reduced(), port_params(arch),
                           device="cpu", **kw)
    # a wave engine has no slot to snapshot, inject or migrate
    eng = EngineCore(get_arch("mamba2-130m").reduced(),
                     port_params("mamba2-130m"), device="cpu")
    assert (eng.free_pages, eng.page_starved, eng.migration_candidate(),
            eng.can_accept(1)) == (4, False, None, False)
    with pytest.raises(ValueError):
        eng.snapshot_slot(0)


def test_short_mamba_wave_raises():
    """A wave whose longest prompt is shorter than the conv window raises
    ValueError at admission (the JAX reference crashes on its first decode
    step); a short prompt in a wave with a longer one is served."""
    arch = "mamba2-130m"
    cfg, params = get_arch(arch).reduced(), port_params(arch)
    eng = EngineCore(cfg, params, device="cpu", **ENG)
    eng.add_request(Request(rid=0, prompt=[3, 4], max_new_tokens=2))
    with pytest.raises(ValueError, match="conv window"):
        eng.step()
    with pytest.raises(ValueError, match="conv window"):
        TM.prefill(params, cfg, torch.zeros((1, 2), dtype=torch.int32),
                   TM.init_cache(cfg, 1, 8, device="cpu"))
    eng = EngineCore(cfg, params, device="cpu", **ENG)
    reqs = [Request(rid=0, prompt=[3, 4], max_new_tokens=3),
            Request(rid=1, prompt=[5, 6, 7, 8], max_new_tokens=3)]
    for r in reqs:
        eng.add_request(r)
    eng.run()
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)


def test_wave_capacity_and_abort_match_jax():
    """The shared cursor at max_seq - 1 finishes every row on capacity,
    and an aborted row leaves the wave, in both engines."""
    arch = "mamba2-130m"
    jcfg, jparams = jax_params(arch)
    prompts = wave_prompts(arch, (6, 9, 4), 8, seed=3)
    kw = dict(ENG, max_seq=14)
    for overlap in (False, True):
        out = []
        for side in ("jax", "port"):
            eng = (JEngine(jcfg, jparams, overlap=overlap, **kw)
                   if side == "jax" else
                   EngineCore(get_arch(arch).reduced(), port_params(arch),
                              overlap=overlap, device="cpu", **kw))
            reqs = _reqs(prompts, 20, jax_side=side == "jax")
            for r in reqs:
                eng.add_request(r)
            steps = [eng.step(), eng.step()]
            assert eng.abort_request(1)
            while eng.has_work:
                steps.append(eng.step())
            out.append([[(e.rid, e.token, e.finished, e.finish_reason)
                         for e in s] for s in steps])
            reasons = [r.finish_reason for r in reqs]
            assert reasons == ["capacity", "aborted", "capacity"], reasons
        assert out[0] == out[1], f"overlap={overlap}"


@pytest.mark.parametrize("family", sorted(ARCHS), ids=lambda f: f"fam_{f}")
def test_wave_watchdog_redispatch_gives_the_unwatched_bits(family):
    check_watchdog(ARCHS[family])


def check_watchdog(arch):
    """A watchdog flagging decode steps 1 and 3 re-runs them from the
    state they started from (the cursor and the Mamba states copied back
    in place): the streams equal the unwatched run's, and the JAX engine
    counts the same events."""
    cfg, params = get_arch(arch).reduced(), port_params(arch)
    prompts = [[2 + i, 5, 9 + i, 4, 7] for i in range(4)]
    plain = EngineCore(cfg, params, device="cpu", **ENG)
    want = _reqs(prompts, 6)
    drive(plain, want)
    watched = EngineCore(cfg, params, device="cpu", watchdog=_flag({1, 3}),
                         **ENG)
    got = _reqs(prompts, 6)
    drive(watched, got)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    jcfg, jparams = jax_params(arch)
    j = JEngine(jcfg, jparams, watchdog=_flag({1, 3}), **ENG)
    drive(j, _reqs(prompts, 6, jax_side=True))
    assert watched.stats.straggler_events == j.stats.straggler_events == 2
