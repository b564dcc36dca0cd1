"""The port's int8 KV pools against the JAX package's.

``kv_dtype="int8"`` keeps each page pool as int8 codes beside float32
scale pools (one scale per row and kv head); rows quantize once at their
write.  Held here, as tests/test_quant_serving.py holds the JAX engine:

* ``quantize_rows`` bit-exact against ``jax.jit(quantize_rows)``, which
  is how the JAX engine runs it (C1: ``absmax * float32(1/127)``);
* the int8 cache's keys, dtypes and shapes and ``kv_page_bytes`` equal
  JAX's, for the dense and the hybrid layout;
* one decode step over an int8-paged cache within 0.05 of the bf16
  cache's logits (JAX ``test_int8_kv_decode_logits_close_to_bf16``);
* the port's int8 engine bit-identical to itself synchronous and
  overlapped, greedy and stochastic, dense and hybrid;
* the port's and the JAX int8 engines' event streams on margin-checked
  prompts (tests/test_torch_serving.py's method), W8A8: an activation or
  a K/V row at a rounding tie may take the neighbouring int8 code, which
  the 1e-2 top-1 margin covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest
from repro_torch.serving.scheduler import FCFSScheduler, SamplingParams
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_chunked import w8a8  # noqa: F401  (fixture)
from test_torch_serving import _drive, _prompts

DRIFT = 0.05   # int8 vs bf16 decode logits (the JAX test's bound)
JQUANT = jax.jit(JA.quantize_rows)   # as the JAX engine runs it


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_rows_bit_exact_against_jitted_jax(scale):
    """Codes and scales of 4,096 rows of 16-128 values, rows of zeros and
    rows with one outlier, against the jitted JAX function."""
    rng = np.random.RandomState(int(scale * 1000) % 97)
    for d in (16, 112, 128):
        x = (rng.randn(4096, d) * scale).astype(np.float32)
        x *= rng.rand(4096, 1).astype(np.float32)
        x[:8] = 0.0
        x[8:16, 3] *= 50.0
        qj, sj = JQUANT(jnp.asarray(x))
        qt, st = TA.quantize_rows(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        back = TA.dequantize_rows(qt, st).numpy()
        np.testing.assert_array_equal(
            back, np.asarray(JA.dequantize_rows(qj, sj)))
    # bf16 rows quantize from their float32 values
    xb = jnp.asarray(rng.randn(64, 128), jnp.bfloat16)
    qj, sj = JQUANT(xb)
    qt, st = TA.quantize_rows(torch.from_numpy(np.array(
        xb.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b", "llama2-7b"])
def test_int8_cache_layout_matches_jax(arch):
    """Keys, dtypes and shapes of the int8 (and bf16) caches, the pool
    keys that move with a page, and the page bytes, against JAX."""
    jcfg = jget_arch(arch).reduced()
    tcfg = get_arch(arch).reduced()
    for kv in ("int8", "bf16"):
        jc = JM.init_paged_cache(jcfg, 3, 40, page_size=8, kv_dtype=kv)
        tc = TM.init_paged_cache(tcfg, 3, 40, page_size=8, device="cpu",
                                 kv_dtype=kv)
        jflat = {k: v for k, v in jc.items() if k != "block"}
        assert sorted(tc) == sorted(jflat)
        for key in TB.paged_pool_keys(tc) + ("lens",):
            assert tuple(tc[key].shape) == jc[key].shape, key
            assert str(tc[key].dtype).split(".")[-1] == str(jc[key].dtype), key
        assert TB.paged_pool_keys(tc) == JB.paged_pool_keys(jc)
        assert TM.paged_kv_dtype(tc) == JM.paged_kv_dtype(jc) == kv
        tdt = TM.paged_pool_dtype(tc)
        jdt = JM.paged_pool_dtype(jc)
        for page in (8, 16):
            assert TM.kv_page_bytes(tcfg, page, tdt) == \
                JM.kv_page_bytes(jcfg, page, jdt)
    with pytest.raises(ValueError):
        TM.init_paged_cache(tcfg, 1, 8, device="cpu", kv_dtype="fp8")


def test_int8_kv_decode_logits_close_to_bf16():
    """One decode step over an int8-paged cache stays within quantization
    error of the bf16 cache's logits (the JAX test's prompt and bound)."""
    cfg = get_arch("smollm-360m").reduced()
    params = TM.init_params(cfg, seed=0, max_seq=64, device="cpu")
    toks = torch.tensor([[5, 9, 14, 3, 11, 7, 2, 6]], dtype=torch.int32)
    logits = {}
    for kv in ("bf16", "int8"):
        cache = TM.init_paged_cache(cfg, 1, 64, page_size=8, device="cpu",
                                    kv_dtype=kv)
        cache["block"] = torch.arange(1, 9, dtype=torch.int32)[None]
        lg, cache = TM.prefill_into_slots(params, cfg, toks,
                                          torch.tensor([8]), cache,
                                          torch.tensor([0]))
        step, cache = TM.decode_step_paged(
            params, cfg, torch.argmax(lg, -1).to(torch.int32), cache,
            torch.tensor([True]))
        logits[kv] = step.float()
    drift = (logits["int8"] - logits["bf16"]).abs().max().item()
    assert 0 < drift < DRIFT, drift


def _reqs(n=4, stochastic=False, max_new=8):
    out = []
    for rid in range(n):
        sp = (SamplingParams(temperature=0.9, top_k=20, seed=100 + rid)
              if stochastic and rid % 2 else None)
        out.append(TRequest(rid=rid, prompt=[3 + rid, 11, 7, 19, 2 + rid],
                            max_new_tokens=max_new, sampling=sp))
    return out


@pytest.mark.parametrize("chunk", [None, 3], ids=["one_shot", "chunk3"])
@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["greedy", "stochastic"])
@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b"])
def test_int8_kv_sync_equals_overlap(arch, stochastic, chunk):
    """The port's int8 engine, synchronous and overlapped: the same tokens
    and finish reasons, bit for bit, with and without a chunk budget of 3
    (the 5-token prompts prefill in two chunks on the dense model, in one
    shot on the hybrid one)."""
    cfg = get_arch(arch).reduced()
    params = TM.init_params(cfg, seed=0, max_seq=64, device="cpu",
                            dtype=torch.float32)
    runs = []
    for overlap in (False, True):
        eng = TEngine(cfg, params, max_batch=2, max_seq=48, eos_id=-1,
                      page_size=8, kv_dtype="int8", overlap=overlap,
                      scheduler=FCFSScheduler(chunk_tokens=chunk),
                      device="cpu")
        reqs = _reqs(stochastic=stochastic)
        for r in reqs:
            eng.add_request(r)
        eng.run()
        assert eng.cache["k"].dtype == torch.int8
        assert (eng.stats.prefill_chunks > 0) == (
            chunk is not None and arch == "smollm-360m")
        runs.append([(r.out_tokens, r.finish_reason) for r in reqs])
    assert runs[0] == runs[1]


def test_int8_kv_engine_matches_jax(w8a8):  # noqa: F811
    """W8A8 weights, int8 pools in both engines, arrivals while others
    decode: the same events at the same steps."""
    jcfg, jparams, tcfg, tparams = w8a8
    prompts = _prompts(w8a8, 5, 3, 16, 6, seed=8)
    trace = [(a, rid, p, 6) for rid, (a, p)
             in enumerate(zip([0, 0, 1, 3, 3], prompts))]
    kw = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8,
              kv_dtype="int8")
    j = JEngine(jcfg, jparams, **kw)
    t = TEngine(tcfg, tparams, device="cpu", **kw)
    jsteps, jreqs = _drive(j, JRequest, trace)
    tsteps, treqs = _drive(t, TRequest, trace)
    assert tsteps == jsteps
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
    assert t.kv_page_bytes == j.kv_page_bytes
