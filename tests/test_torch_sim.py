"""The port's performance model (``core/schedule.py``, ``core/planner.py``,
``sim/{engine,llm_perf,energy,baselines}.py``) against the JAX package's.

The modules are pure Python, copied into the port: for every ``ARCHS``
configuration and every ``FLASH_CONFIGS`` entry they must return the JAX
package's values exactly (Python floats compared with ``==``).  The cases
of tests/test_sim.py, tests/test_stream_sim.py and
tests/test_substrate.py's ``test_planner_streams_match_matrices`` are held
on the port, each value also equal to the JAX one.  Beside them: the
``ServingEngine`` shim against the JAX shim (tests/test_substrate.py's
serving cases) and the port's quickstart printing the JAX example's
step-4 figure, the simulator's Llama2-70B decode estimate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fallback, see _hypothesis_fallback.py
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import registry as jreg
from repro.core import hw as jhw
from repro.core import planner as jplanner
from repro.core import schedule as jschedule
from repro.core import tiling as jtiling
from repro.sim import baselines as jbase
from repro.sim import energy as jenergy
from repro.sim import engine as jengine
from repro.sim import llm_perf as jperf
from repro_torch.configs import registry as treg
from repro_torch.core import hw as thw
from repro_torch.core import planner as tplanner
from repro_torch.core import schedule as tschedule
from repro_torch.core import tiling as ttiling
from repro_torch.sim import baselines as tbase
from repro_torch.sim import energy as tenergy
from repro_torch.sim import engine as tengine
from repro_torch.sim import llm_perf as tperf

ARCH_NAMES = sorted(jreg.ARCHS)
FLASH = sorted(jhw.FLASH_CONFIGS)
PAGED = ("dense", "vlm", "moe", "mla_moe", "hybrid")


def _t(x):
    """A dataclass (or a tuple / list of them) as plain tuples."""
    if dataclasses.is_dataclass(x):
        return tuple(_t(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_t(v) for v in x)
    if hasattr(x, "value") and hasattr(x, "name"):   # an enum member
        return x.value
    return x


def test_registry_and_hardware_match_jax():
    assert sorted(treg.ARCHS) == ARCH_NAMES
    assert list(treg.ASSIGNED_ARCHS) == list(jreg.ASSIGNED_ARCHS)
    for name in ARCH_NAMES:
        assert treg.ARCHS[name].__dict__ == jreg.ARCHS[name].__dict__, name
    assert sorted(thw.FLASH_CONFIGS) == FLASH
    for k in FLASH:
        assert _t(thw.FLASH_CONFIGS[k]) == _t(jhw.FLASH_CONFIGS[k])
    assert _t(thw.DEFAULT_NPU) == _t(jhw.DEFAULT_NPU)
    assert [p.value for p in tschedule.Policy] == \
        [p.value for p in jschedule.Policy]
    assert tschedule.DEFAULT_SLICE_BYTES == jschedule.DEFAULT_SLICE_BYTES


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_planner_and_simulator_match_jax(arch):
    """model_matrices, the decode stream, each flash config's plan (stored
    and streamed bytes, the analytic token time, every matrix's channel
    workload under each policy), decode_token_time (W8A8 and W4A16 bytes),
    the flash-only ablation, the TTFT and KV tier pricing, the baselines
    and the energy model: the JAX package's values exactly."""
    jc, tc = jreg.ARCHS[arch], treg.ARCHS[arch]
    assert _t(tplanner.model_matrices(tc)) == \
        _t(jplanner.model_matrices(jc))
    stream = tplanner.decode_execution_stream(tc)
    assert stream == jplanner.decode_execution_stream(jc)
    assert sum(h * w for kind, *d in stream if kind == "gemv"
               for h, w in [d]) == sum(m.active_params for m in
                                       tplanner.model_matrices(tc))
    for seq in (1, 1000):
        assert tplanner.kv_cache_bytes(tc, seq, 2) == \
            jplanner.kv_cache_bytes(jc, seq, 2)
    for k in FLASH:
        jf, tf = jhw.FLASH_CONFIGS[k], thw.FLASH_CONFIGS[k]
        jp, tp = jplanner.plan_model(jc, jf), tplanner.plan_model(tc, tf)
        assert tp.stored_bytes == jp.stored_bytes
        assert tp.streamed_bytes_per_token == jp.streamed_bytes_per_token
        assert tp.analytic_token_time() == jp.analytic_token_time()
        for (_, jmp), (_, tmp) in zip(jp.plans, tp.plans):
            assert _t(tmp) == _t(jmp)
            assert _t(tschedule.channel_workload(tmp, tf)) == \
                _t(jschedule.channel_workload(jmp, jf))
        for bpe in (1.0, 0.5):
            assert _t(tperf.decode_token_time(tc, tf, bpe, seq_len=1000)) \
                == _t(jperf.decode_token_time(jc, jf, bpe, seq_len=1000))
        assert _t(tperf.flash_only_token_time(tc, tf)) == \
            _t(jperf.flash_only_token_time(jc, jf))
        assert tperf.prefill_ttft_s(tc, tf, 64, cached_tokens=16) == \
            jperf.prefill_ttft_s(jc, jf, 64, cached_tokens=16)
        if tc.family in PAGED:
            for kv in ("bf16", "int8"):
                assert tperf.family_kv_page_bytes(tc, 16, kv_dtype=kv) == \
                    jperf.family_kv_page_bytes(jc, 16, kv_dtype=kv)
            assert tperf.kv_page_cost_s(tc, tf) == \
                jperf.kv_page_cost_s(jc, jf)
        tt = tperf.decode_token_time(tc, tf, seq_len=1000)
        moved = (tt.channel_bytes, tt.flash_array_bytes,
                 tplanner.kv_cache_bytes(tc, 1000, 1))
        assert _t(tenergy.cambricon_per_token(tc, tf, *moved)) == \
            _t(jenergy.cambricon_per_token(jc, jf, *moved))
    kv = jplanner.kv_cache_bytes(jc, 1000, 1)
    assert _t(tenergy.flexgen_ssd_per_token(tc, kv)) == \
        _t(jenergy.flexgen_ssd_per_token(jc, kv))
    for fn in ("flexgen_ssd_tokens_per_s", "flexgen_dram_tokens_per_s",
               "mlc_llm_tokens_per_s", "mlc_llm_fits_dram"):
        assert getattr(tbase, fn)(tc) == getattr(jbase, fn)(jc), fn


# --- tests/test_sim.py on the port, each value equal to the JAX one -------
PAPER_POINTS = [
    ("opt-6.7b", "S", 3.56), ("opt-6.7b", "M", 10.96), ("opt-6.7b", "L", 36.34),
    ("opt-13b", "M", 4.68), ("opt-30b", "M", 2.50), ("opt-66b", "M", 1.15),
    ("llama2-7b", "S", 3.55), ("llama2-70b", "L", 3.44),
]


@pytest.mark.parametrize("model,cfg_name,target", PAPER_POINTS)
def test_end_to_end_vs_paper(model, cfg_name, target):
    tt = tperf.decode_token_time(treg.ARCHS[model],
                                 thw.FLASH_CONFIGS[cfg_name], seq_len=1000)
    assert tt.tokens_per_s == jperf.decode_token_time(
        jreg.ARCHS[model], jhw.FLASH_CONFIGS[cfg_name],
        seq_len=1000).tokens_per_s
    assert tt.tokens_per_s == pytest.approx(target, rel=0.25)


def test_min_interactive_rate_70b():
    tt = tperf.decode_token_time(treg.ARCHS["llama2-70b"],
                                 thw.CAMBRICON_LLM_L, seq_len=1000)
    assert tt.tokens_per_s >= 3.0


def test_host_dispatch_gap_pricing():
    cfg, flash = treg.ARCHS["opt-6.7b"], thw.CAMBRICON_LLM_S
    base = tperf.decode_token_time(cfg, flash, seq_len=1000)
    assert base.host_gap_s == 0.0
    gap = 1e-3
    kw = [dict(host_dispatch_s=gap, n_dispatches=2),
          dict(host_dispatch_s=gap, n_dispatches=1, overlap_dispatch=True),
          dict(host_dispatch_s=base.total + 0.5, n_dispatches=1,
               overlap_dispatch=True)]
    sync, olap, huge = (tperf.decode_token_time(cfg, flash, seq_len=1000,
                                                **k) for k in kw)
    for k, got in zip(kw, (sync, olap, huge)):
        assert _t(got) == _t(jperf.decode_token_time(
            jreg.ARCHS["opt-6.7b"], jhw.CAMBRICON_LLM_S, seq_len=1000, **k))
    assert sync.total == pytest.approx(base.total + 2 * gap)
    assert olap.total == pytest.approx(base.total) and olap.host_gap_s == 0.0
    assert huge.total == pytest.approx(base.total + 0.5)


def test_prefill_ttft_prefix_cache_pricing():
    cfg, flash = treg.ARCHS["opt-6.7b"], thw.CAMBRICON_LLM_S
    plen = 256
    ts = [tperf.prefill_ttft_s(cfg, flash, plen, cached_tokens=c)
          for c in (0, 64, 128, 255)]
    assert ts == [jperf.prefill_ttft_s(jreg.ARCHS["opt-6.7b"],
                                       jhw.CAMBRICON_LLM_S, plen,
                                       cached_tokens=c)
                  for c in (0, 64, 128, 255)]
    assert all(a > b for a, b in zip(ts, ts[1:]))
    one = tperf.decode_token_time(cfg, flash, seq_len=plen)
    assert ts[-1] == pytest.approx(one.total)
    assert tperf.prefill_ttft_s(cfg, flash, plen,
                                cached_tokens=10_000) == ts[-1]
    assert tperf.prefill_ttft_s(cfg, flash, plen, cached_tokens=-5) == ts[0]
    assert ts[0] == pytest.approx(one.total
                                  + (plen - 1) * one.npu_phase_time)
    with pytest.raises(ValueError):
        tperf.prefill_ttft_s(cfg, flash, 0)


def test_ablations_match_jax_and_the_paper():
    """Fig. 12 (slicing), Fig. 14 (tiling), Fig. 13 (tile size), Fig. 11
    (W4A16), Fig. 15 (channels, chips per channel)."""
    S, jS = thw.CAMBRICON_LLM_S, jhw.CAMBRICON_LLM_S

    def both(model, flash=S, jflash=jS, **kw):
        t = tperf.decode_token_time(treg.ARCHS[model], flash, **kw)
        jkw = {k: (jschedule.Policy(v.value) if k == "policy" else
                   jtiling.TileShape(v.h, v.w) if k == "tile_override"
                   else v) for k, v in kw.items()}
        j = jperf.decode_token_time(jreg.ARCHS[model], jflash, **jkw)
        assert _t(t) == _t(j), (model, kw)
        return t.total

    for model in ("opt-6.7b", "llama2-7b"):
        assert both(model, policy=tschedule.Policy.RC_UNSLICED) / both(
            model, policy=tschedule.Policy.RC_SLICED) > 1.25
    flash_only = tperf.flash_only_token_time(treg.ARCHS["opt-6.7b"], S).total
    assert 1.1 < flash_only / both("opt-6.7b") < 2.0
    t_opt = both("opt-6.7b")
    t_flat = both("opt-6.7b", tile_override=ttiling.TileShape(128, 4096))
    t_tall = both("opt-6.7b", tile_override=ttiling.TileShape(4096, 128))
    assert t_opt <= t_flat * 1.001 and t_opt <= t_tall * 1.001
    assert t_tall > t_opt * 1.05
    gain_small = both("opt-6.7b") / both("opt-6.7b", bytes_per_elem=0.5)
    assert gain_small > 1.3
    assert both("opt-66b") / both("opt-66b", bytes_per_elem=0.5) >= \
        gain_small * 0.9
    prev = None
    for ch in (4, 8, 16, 32):
        t = both("opt-6.7b", dataclasses.replace(S, channels=ch),
                 dataclasses.replace(jS, channels=ch))
        assert prev is None or t < prev * 1.02
        prev = t
    t8, t64 = (both("opt-6.7b", dataclasses.replace(S, chips_per_channel=c),
                    dataclasses.replace(jS, chips_per_channel=c))
               for c in (8, 64))
    assert t64 < t8 and t8 / t64 < 8


def test_channel_sim_conservation():
    kw = dict(n_tiles=10, rc_input_bytes=256, rc_result_bytes=256,
              n_reads=16, page_bytes=16384, t_r=30e-6, bw=1e9)
    w, jw = tschedule.ChannelWorkload(**kw), jschedule.ChannelWorkload(**kw)
    for pol in tschedule.Policy:
        res = tengine.simulate_channel(w, pol)
        assert _t(res) == _t(jengine.simulate_channel(
            jw, jschedule.Policy(pol.value)))
        assert res.time >= res.rc_done - 1e-12
        expected_reads = (0 if pol == tschedule.Policy.RC_ONLY
                          else 16 * 16384 / 1e9)
        assert res.bus_busy == pytest.approx(10 * 512 / 1e9 + expected_reads,
                                             rel=1e-6)
        assert 0 <= res.util <= 1.0


def test_baselines_match_paper_calibration():
    A = treg.ARCHS
    assert tbase.flexgen_ssd_tokens_per_s(A["opt-6.7b"]) == \
        pytest.approx(0.81, rel=0.2)
    assert tbase.flexgen_dram_tokens_per_s(A["opt-6.7b"]) == \
        pytest.approx(3.52, rel=0.2)
    assert tbase.mlc_llm_tokens_per_s(A["llama2-7b"]) == \
        pytest.approx(7.58, rel=0.25)
    assert tbase.mlc_llm_fits_dram(A["llama2-7b"])
    assert not tbase.mlc_llm_fits_dram(A["llama2-70b"])
    for model, lo in [("opt-66b", 15.0), ("opt-6.7b", 25.0)]:
        ours = tperf.decode_token_time(A[model],
                                       thw.CAMBRICON_LLM_L).tokens_per_s
        assert ours / tbase.flexgen_ssd_tokens_per_s(A[model]) > lo


def test_planner_streams_match_matrices():
    """tests/test_substrate.py's case on the port, every ARCHS config."""
    for name in ARCH_NAMES:
        cfg = treg.ARCHS[name]
        stream_params = sum(h * w for kind, *dims in
                            tplanner.decode_execution_stream(cfg)
                            if kind == "gemv" for h, w in [dims])
        assert stream_params == sum(m.active_params for m in
                                    tplanner.model_matrices(cfg)), name


# --- tests/test_stream_sim.py on the port, each result equal to JAX's ------
def _block(n_tiles, read_bytes, bw=1e9):
    return tengine.RCBlock(n_tiles=n_tiles, rc_input_bytes=256.0,
                           rc_result_bytes=256.0, read_bytes=float(read_bytes),
                           t_r=30e-6, bw=bw, page_bytes=16384.0)


streams = st.lists(
    st.one_of(
        st.builds(_block, st.integers(1, 12),
                  st.sampled_from([0, 8192, 65536, 262144])),
        st.builds(tengine.NpuPhase, st.floats(1e-6, 5e-4)),
    ),
    min_size=1, max_size=12)


def _jax_items(items):
    return [jengine.RCBlock(**dataclasses.asdict(it))
            if isinstance(it, tengine.RCBlock)
            else jengine.NpuPhase(**dataclasses.asdict(it)) for it in items]


def _sim(items, policy, **kw):
    """The port's simulate_stream, checked equal to the JAX one."""
    res = tengine.simulate_stream(items, policy, **kw)
    assert _t(res) == _t(jengine.simulate_stream(
        _jax_items(items), jschedule.Policy(policy.value), **kw))
    return res


@given(streams)
@settings(max_examples=40, deadline=None)
def test_stream_time_covers_all_work(items):
    res = _sim(items, tschedule.Policy.RC_SLICED)
    rc_lb = sum(it.n_tiles * it.t_r for it in items
                if isinstance(it, tengine.RCBlock))
    npu_lb = sum(it.duration for it in items
                 if isinstance(it, tengine.NpuPhase))
    bus = sum((it.n_tiles * (it.rc_input_bytes + it.rc_result_bytes)
               + it.read_bytes) / it.bw
              for it in items if isinstance(it, tengine.RCBlock))
    assert res.time >= max(rc_lb, npu_lb, bus) - 1e-12
    assert 0.0 <= res.util <= 1.0 + 1e-9
    assert abs(res.bus_busy - bus) < 1e-9


@given(streams)
@settings(max_examples=40, deadline=None)
def test_sliced_vs_unsliced_bounded(items):
    t_sliced = _sim(items, tschedule.Policy.RC_SLICED).time
    unsliced = _sim(items, tschedule.Policy.RC_UNSLICED)
    assert t_sliced <= unsliced.time * 1.35
    assert unsliced.time >= unsliced.bus_busy - 1e-12


@given(st.lists(st.integers(2, 12), min_size=1, max_size=8))
@settings(max_examples=30, deadline=None)
def test_sliced_wins_on_balanced_streams(tile_counts):
    items = [_block(n, int(n * 30e-6 * 1e9 * 0.8)) for n in tile_counts]
    t_sliced = _sim(items, tschedule.Policy.RC_SLICED,
                    prefetch_bytes=1e12).time
    t_unsliced = _sim(items, tschedule.Policy.RC_UNSLICED,
                      prefetch_bytes=1e12).time
    assert t_sliced <= t_unsliced * 1.0001
    assert _sim(items, tschedule.Policy.RC_SLICED,
                prefetch_bytes=1e12).stalled_on_reads == 0.0


@given(st.integers(1, 30), st.integers(0, 20))
@settings(max_examples=30, deadline=None)
def test_prefetch_window_nearly_monotone(n_tiles, n_pages):
    items = [_block(n_tiles, n_pages * 16384), tengine.NpuPhase(2e-4),
             _block(n_tiles, n_pages * 16384)]
    t_small = _sim(items, tschedule.Policy.RC_SLICED,
                   prefetch_bytes=16384.0).time
    t_big = _sim(items, tschedule.Policy.RC_SLICED,
                 prefetch_bytes=1e9).time
    assert t_big <= t_small * 1.7


# --- the ServingEngine shim and the quickstart ------------------------------
@pytest.fixture(scope="module")
def smollm():
    from repro.models import model as JM
    from repro_torch.bridge import params_from_numpy

    jcfg = jreg.ASSIGNED_ARCHS["smollm-360m"].reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    return (jcfg, jparams, treg.get_arch("smollm-360m").reduced(),
            params_from_numpy(jax.tree.map(np.asarray, jparams)))


@pytest.mark.parametrize("watchdog", [False, True])
def test_serving_engine_shim_matches_jax(smollm, watchdog):
    """tests/test_substrate.py's serving cases through both shims on the
    same weights: ``step()`` returns a bool, the streams and the stats
    equal JAX's, and (with a watchdog flagging decode step 1) one
    straggler re-dispatch each."""
    from repro.serving.engine import (Request as JRequest,
                                      ServingEngine as JShim)
    from repro_torch.serving import engine as tshim

    jcfg, jparams, cfg, params = smollm
    assert tshim.Request is tshim.EngineCore.__init__.__globals__["Request"]
    outs = []
    for shim, req, c, p, kw in ((JShim, JRequest, jcfg, jparams, {}),
                                (tshim.ServingEngine, tshim.Request, cfg,
                                 params, dict(device="cpu"))):
        fired = []

        def dog(step, dt):
            if watchdog and step == 1 and not fired:
                fired.append(step)
                return True
            return False
        eng = shim(c, p, max_batch=2, max_seq=48, eos_id=-1,
                   watchdog=dog, **kw)
        reqs = [req(rid=i, prompt=[3, 5, 7][: i + 1], max_new_tokens=5)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        assert eng.step() is True
        stats = eng.run()
        assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
        assert eng.step() is False          # nothing left
        outs.append(([r.out_tokens for r in reqs], stats.tokens_out,
                     stats.straggler_events))
    assert outs[1] == outs[0]
    assert outs[0][2] == int(watchdog)


def test_quickstart_prints_the_simulators_step_4(capsys):
    """The port's quickstart (reduced matrix, on the CPU) prints step 4,
    the Llama2-70B decode estimate on Cambricon-LLM-L, with the JAX
    example's figure and labelled as the simulator's."""
    from repro_torch.examples import quickstart

    quickstart.main(["--reduced", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    tt = jperf.decode_token_time(jreg.ARCHS["llama2-70b"],
                                 jhw.CAMBRICON_LLM_L, seq_len=1000)
    line = [ln for ln in out.splitlines() if "Llama2-70B" in ln]
    assert len(line) == 1
    assert (f"Llama2-70B INT8 on Cambricon-LLM-L: {tt.tokens_per_s:.2f} "
            f"tok/s (paper: 3.44), channel util {tt.channel_util:.0%}") \
        in line[0]
    assert "simulator" in line[0] and "not this card" in line[0]
